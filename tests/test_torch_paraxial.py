"""The port's paraxial.py against the reference's: the same numpy code, so
every function returns the same bits on the same inputs (matrices by
np.array_equal, dicts and floats by ==), including its refusals."""

import numpy as np
import pytest

from lightpycl_tpu import paraxial as R
from lightpycl_tpu_torch import paraxial as Pp
from torch_port_common import assert_same

rng = np.random.default_rng(11)
RADII = [float(x) for x in rng.uniform(5.0, 60.0, 4) * [1, -1, 1, -1]]

CALLS = {
    "matrices": [
        ("propagation", (3.7,), {}), ("propagation", (2.0, 1.52), {}),
        ("refraction", (RADII[0], 1.0, 1.5168), {}),
        ("refraction", (None, 1.5, 1.0), {}),
        ("refraction", (np.inf, 1.0, 1.7), {}),
        ("thin_lens", (42.0,), {}),
        ("mirror", (RADII[1],), {}), ("mirror", (), {}),
        ("grin_rod", (2.5, 1.6, 0.3), {}), ("grin_rod", (1.0, 1.6, -0.2), {}),
        ("thick_lens", (RADII[0], RADII[1], 4.0, 1.5168), {}),
        ("thick_lens", (None, RADII[3], 2.0, 1.7), dict(n_env=1.33)),
    ],
    "systems": [
        ("compose", tuple(R.refraction(r, 1.0, 1.6) for r in RADII), {}),
        ("system_properties", (R.thick_lens(RADII[0], RADII[1], 4.0, 1.5),),
         {}),
        ("system_properties", (R.compose(R.refraction(RADII[2], 1.0, 1.5),
                                         R.propagation(3.0, 1.5),
                                         R.refraction(None, 1.5, 1.33)),),
         dict(n_out=1.33)),
        ("trace_ray", (R.thick_lens(RADII[0], RADII[1], 4.0, 1.5), 2.0,
                       0.01), {}),
        ("trace_ray", (R.grin_rod(2.5, 1.6, 0.3), 0.1, -0.02),
         dict(n_in=1.6)),
    ],
    "seidel": [
        ("seidel", ([1 / r for r in RADII], [4.0, 0.5, 2.5],
                    [1.0, 1.5168, 1.0, 1.62, 1.0]),
         dict(y=3.0, u=0.0, ybar=0.0, ubar=0.1)),
        ("seidel", ([1 / RADII[0], 1 / RADII[1]], [4.0], [1.0, 1.5, 1.0]),
         dict(y=2.0, u=-0.01, ybar=1.0, ubar=0.05,
              delta_n=[0.0, 0.008, 0.0])),
        ("seidel_singlet", (RADII[0], RADII[1], 4.0, 1.5168),
         dict(y=3.0, ubar=0.05)),
        ("seidel_singlet", (None, RADII[1], 4.0, 1.5), dict(y=1.0,
                                                            n_env=1.33)),
    ],
}


@pytest.mark.parametrize("family", sorted(CALLS))
def test_paraxial_bit_equal(family):
    for name, args, kw in CALLS[family]:
        assert_same(getattr(R, name)(*args, **kw),
                    getattr(Pp, name)(*args, **kw), name)


@pytest.mark.parametrize("call", [
    lambda m: m.system_properties(m.propagation(3.0)),
    lambda m: m.seidel_singlet(30.0, -30.0, 2.0, 1.5, y=1.0,
                               stop_at_lens=False),
    lambda m: m.seidel([0.1], [], [1.0, 1.5], y=1.0, u=0.0, ybar=0.0,
                       ubar=0.1, delta_n=[0.0]),
])
def test_paraxial_refusals_match(call):
    msgs = []
    for m in (R, Pp):
        with pytest.raises(ValueError) as e:
            call(m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_every_reference_function_is_ported():
    ref = {n for n in dir(R) if callable(getattr(R, n))
           and getattr(getattr(R, n), "__module__", "") == R.__name__}
    assert all(callable(getattr(Pp, n, None)) for n in ref), ref
