"""Find the benchmark's files by name.

* `configs/<config>.json`: a configuration (scene, source, entry, sizes);
* `workloads/<cell>.json`: a cell (its configuration, traffic, chips, why,
  the check's sample and limits, the traced sub-window);
* `entries/<entry>.py`: how a configuration's entry point is driven;
* `scenes/<kind>.py`: a mesh generator;
* `metrics/<metric>.py`: a reader of one metric, `read(ctx)`.

Everything is found relative to this file, so a copy of the folder works
from wherever it lies, and a file dropped in is found without edits.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent


def path(kind: str, name: str, suffix: str) -> Path:
    p = HOME / kind / f"{name}{suffix}"
    if not p.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({p})")
    return p


def load_json(kind: str, name: str) -> dict:
    with open(path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py`, loaded once by its path (names may
    hold dots, which an import statement cannot)."""
    key = f"perfcells.{kind}.{name.replace('.', '__')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path(kind, name,
                                                            ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with `workloads` only in those."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
