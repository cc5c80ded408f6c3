"""The port's benchmark: one run of one cell.

    python3 perfcells/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones, as BENCHMARK.json names them), `device`,
with `--trace 1` `breakdown`, and last `checks` (each compared number with
its limit; also the last lines of standard error). Exits non-zero with no
result when there is no card or fewer cards than the cell asks for, and
when a JAX module was loaded. Caches of its own go under perfcells/.cache;
the port builds its kernels into lightpycl_tpu_torch/build.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HOME = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HOME))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(HOME, ".cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank other than 0 of a cell on several cards (run.py starts them)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ports", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)

    import torch

    from perfcells.harness import catalog, driver

    bench = catalog.benchmark()
    chips = int(catalog.load_json("workloads", ns.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: {ns.workload} needs {chips} card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    args = (ns.workload, ns.seed, ns.seconds, bool(ns.trace))
    if ns.rank is not None:
        dist_port, store_port = map(int, ns.ports.split(","))
        driver.run_rank(*args, ns.rank, chips, dist_port, store_port,
                        t_start=T_START, bench=bench)
        return 0
    print(f"run: card and power limit: {driver.power_limit_line()}",
          file=sys.stderr, flush=True)
    if chips == 1:
        line = driver.run_cell(*args, device="cuda", t_start=T_START,
                               bench=bench)
    else:
        def argv_of_rank(rank, dist_port, store_port):
            return [sys.executable, os.path.abspath(__file__),
                    "--workload", ns.workload, "--seed", str(ns.seed),
                    "--seconds", str(ns.seconds), "--trace", str(ns.trace),
                    "--rank", str(rank), "--ports",
                    f"{dist_port},{store_port}"]
        line = driver.run_ranks(argv_of_rank, *args, chips, t_start=T_START,
                                bench=bench)
    bad = driver.forbidden_modules()
    if bad:
        print(f"run: modules of {bad} were loaded", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
