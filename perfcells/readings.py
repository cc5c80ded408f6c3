"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python3 perfcells/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--device cuda] [--mode device] \
        [--out file.jsonl]

In one process, set up the cell once; then for each seed run the calls a
run with that seed checks (the same entry calls, at the cell's sizes, one
after another as the closed loop sends them) and print the check's
numbers for the program; for each control seed also the numbers of the
control: the reference itself, computed in bfloat16 (the precision below
the configuration's float32), put in the program's place. One JSON line a
reading. `--mode` runs the entry in another mode of the configuration's
call (a cell on several cards, read on one: the control's numbers need
only the reference and the rays the launches were given).
"""

import argparse
import json
import os
import sys
import time

HOME = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HOME))


def readings(cell, seeds, control_seeds, device="cuda", out=None,
             mode=None):
    import torch

    from perfcells.harness import catalog, driver
    from perfcells.harness.scene import element_arrays
    from perfcells.harness.taps import Tap
    from perfcells.entries._common import kept as keep
    from perfcells.reference import trace as ref_trace

    wl = catalog.load_json("workloads", cell)
    config = catalog.load_json("configs", wl["config"])
    if mode is not None:
        config["call"]["mode"] = mode
    dev = torch.device(device)
    run = driver.Run(config, wl["load"], wl["check"], dev, 0,
                     element_arrays(config))
    entry = catalog.load_module("entries", config["entry"]).Entry(run)
    entry.warm()
    scene = ref_trace.scene_arrays(run.arrays, dev)
    lines = []
    for seed in seeds:
        run.seed = seed
        tap = Tap(seed, int(run.check["launch_rays"]))
        kept = {}
        with tap:
            for i in sorted(driver.checked_calls(seed, run.check)):
                tap.begin_call(True)
                kept[i] = keep(entry.call(i))
        t0 = time.perf_counter()
        wants = {}
        nums, judged = driver.check_numbers(entry, tap, kept, scene,
                                            wants=wants)
        line = {"cell": cell, "seed": seed, "side": "program",
                "judged_rays": judged, "check_s": time.perf_counter() - t0,
                **nums}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if seed in control_seeds:
            nums, judged = driver.check_numbers(
                entry, tap, kept, scene, dtype=torch.bfloat16,
                wants=wants)
            line = {"cell": cell, "seed": seed, "side": "control_bf16",
                    "judged_rays": judged, **nums}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if out:
        with open(out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode")
    ap.add_argument("--out")
    ns = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    readings(ns.workload, ints(ns.seeds), set(ints(ns.control_seeds)),
             ns.device, ns.out, ns.mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
