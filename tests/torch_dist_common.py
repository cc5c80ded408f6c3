"""Rank launcher of the port's sharded-path tests (tests/test_torch_parallel*).

`run_ranks(fn, world, tmp_path)` spawns `world` processes (torch.multiprocessing
spawn: fresh interpreters, so the ranks import no jax), joins each to one gloo
process group through a `file://` store under `tmp_path` (no port, so it is
safe under pytest-xdist's parallel workers), runs `fn(rank, world, *args)` on
every rank and returns the ranks' results, unpickled from files the ranks
write. A launch has a hard timeout: on expiry every rank is killed and the
test fails, so a collective that some rank never reaches fails one test and
does not hang the suite. A rank's exception fails the test with that rank's
traceback. `fn` must be importable by name from a module that does not import
jax (tests/torch_parallel_common.py holds the scenarios).
"""

import os
import pickle
import time
import traceback

import pytest
import torch.multiprocessing as mp

LAUNCH_TIMEOUT_S = 120


def _rank_main(fn, rank, world, store, out_dir, args):
    import torch

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        from lightpycl_tpu_torch.parallel.distributed import init_distributed

        init_distributed(f"file://{store}", num_processes=world,
                         process_id=rank, backend="gloo")
        result = ("ok", fn(rank, world, *args))
    except BaseException:  # reported to the parent, then re-raised
        result = ("error", traceback.format_exc())
        with open(path, "wb") as f:
            pickle.dump(result, f)
        raise
    with open(path, "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, timeout=LAUNCH_TIMEOUT_S):
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own spawned rank of a `world`-rank gloo group."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, out_dir, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        # until every rank is done, one failed (the others would wait for
        # it in a collective), or the time is up
        while (any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        failed = any(p.exitcode for p in procs)
        hung = ([] if failed else
                [r for r, p in enumerate(procs) if p.is_alive()])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            results.append(None)
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    errors = [(r, res[1]) for r, res in enumerate(results)
              if res is not None and res[0] == "error"]
    if errors:
        r, tb = errors[0]
        pytest.fail(f"rank {r} of {world} ({fn.__name__}) raised:\n{tb}",
                    pytrace=False)
    if hung:
        pytest.fail(f"ranks {hung} of {world} ({fn.__name__}) still running "
                    f"after {timeout} s: killed", pytrace=False)
    missing = [r for r, res in enumerate(results) if res is None]
    if missing:
        codes = [procs[r].exitcode for r in missing]
        pytest.fail(f"ranks {missing} of {world} ({fn.__name__}) ended "
                    f"without a result (exit codes {codes})", pytrace=False)
    return [res[1] for res in results]
