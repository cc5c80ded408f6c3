"""Example scripts through the port, on the CPU.

Each script is copied with its import root swapped (lightpycl_tpu ->
lightpycl_tpu_torch; examples/ is not touched) and run in this process at
examples/run_all.py's SMALL size, to its end with its own asserts
holding. The fixture `port_default_cpu` (tests/torch_port_common.py)
makes the port's default device the CPU for this module (the package
defaults to CUDA and has no switch for it). The reference's
test_reference_module_names (tests/test_compat.py) runs against the
port's reference-named modules.
"""

import os
import re
import runpy
import sys

import pytest
import torch

from torch_port_common import port_default_cpu  # noqa: F401

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
from run_all import SMALL  # noqa: E402

sys.path.remove(EXAMPLES)


def swapped_copy(name, dst_dir):
    with open(os.path.join(EXAMPLES, name)) as f:
        src = f.read()
    path = os.path.join(dst_dir, name)
    with open(path, "w") as f:
        f.write(re.sub(r"\blightpycl_tpu\b", "lightpycl_tpu_torch", src))
    return path


@pytest.mark.parametrize("name", ["example_field_sweep.py",
                                  "example_led_collimator.py",
                                  "example_codev.py", "example_zmx.py",
                                  "example_coating_design.py"])
def test_example_runs_on_the_port(name, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("LPCL_FORCE_CPU", raising=False)
    for k, v in SMALL[name].items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    path = swapped_copy(name, str(tmp_path))
    with open(path) as f:
        assert "lightpycl_tpu." not in f.read()
    runpy.run_path(path, run_name="__main__")
    # the script's own asserts held; it printed its report
    assert capsys.readouterr().out.strip()


def test_reference_module_names():
    # upstream scripts port by changing only the import root
    from lightpycl_tpu_torch.geo_optical_elements import (
        optical_elements as oe_f)
    from lightpycl_tpu_torch.iterative_tracer import CL_Tracer as Tr
    from lightpycl_tpu_torch.light_source import light_source as ls_f

    oe = oe_f(16, 6)
    tr = Tr("AMD", "CPU")
    res = tr.iterative_tracer(ls_f(power=1.0, ray_count=100),
                              [oe.hemisphere(2.0)], trace_iterations=2)
    assert res.ledger["measured"] == pytest.approx(1.0, rel=1e-5)
    assert res.device == "cpu"


def test_reference_named_modules_export_the_same_names():
    import lightpycl_tpu.geo_optical_elements as rg
    import lightpycl_tpu.iterative_tracer as ri
    import lightpycl_tpu.light_source as rl
    import lightpycl_tpu_torch.geo_optical_elements as pg
    import lightpycl_tpu_torch.iterative_tracer as pi
    import lightpycl_tpu_torch.light_source as pl

    for r, p in ((rg, pg), (ri, pi), (rl, pl)):
        assert r.__all__ == p.__all__
        assert all(hasattr(p, n) for n in p.__all__)
