"""The port's `shade` (lightpycl_tpu_torch/tracer/step.py) against the JAX
package's under the surface-physics switches: metals, thin-film coatings,
gratings, the Stokes-Mueller path (polarizer, waveplate, beamsplitter, film
split), uniaxial crystals and path signatures, each alone and in the
combinations the reference's own tests use. One `shade` call per case on
identical scene, rays, hit and cfg; every ShadeOut field is compared
(tests/torch_port_common.py states the tolerances) and the step's power
balance must close to 1e-5."""

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
from lightpycl_tpu.sources import CollimatedSource, light_source
from torch_port_common import (assert_conserves, assert_shade_close,
                               shade_pair)

torch.set_num_threads(1)
oe = L.optical_elements(n_segments=16, n_radial=6)
LINEAR_45 = (0.0, 1.0, 0.0)
ELLIPTIC = (0.5, 0.4, 0.6)


def dome():
    return oe.hemisphere(6.0, name="dome")


def point(n=1500, **kw):
    return light_source(center=(0, 0, 0.3), direction=(0, 0, 1), power=1.0,
                        ray_count=n, seed=4, **kw)


def metal_bench(**mirror_kw):
    """A silver-like and an aluminium-like mirror, an ideal mirror and a
    lens under a point source: metal and non-metal lanes in one batch."""
    return [oe.rectangle(1.2, 1.2, center=(0.9, 0, 0.8), material="mirror",
                         reflectivity=0.97, metal_n=0.13, metal_k=3.9,
                         **mirror_kw).rotate((0, 1, 0), 0.5),
            oe.rectangle(1.2, 1.2, center=(-0.9, 0, 0.8), material="mirror",
                         metal_n=1.1, metal_k=6.8).rotate((0, 1, 0), -0.4),
            oe.disc(0.4, center=(0, 0.9, 0.9), material="mirror",
                    reflectivity=0.9),
            oe.biconvex_lens(1.0, 0.8, 0.3, ior=1.5, center=(0, 0, 1.2)),
            dome()]


def coated_bench():
    """A two-layer and a one-layer coated lens and a bare one: the stacks
    are padded to two layers, entered and (one bounce on) left."""
    return [oe.biconvex_lens(1.0, 0.8, 0.3, ior=1.5, center=(0, 0, 1.0),
                             coating=[(1.38, 0.10), (2.1, 0.05)]),
            oe.biconvex_lens(1.2, 0.6, 0.2, ior=1.7, center=(0.9, 0, 0.9),
                             coat_ior=1.38, coat_thickness=0.1),
            oe.biconvex_lens(1.2, 0.6, 0.2, ior=1.6, center=(-0.9, 0, 0.9)),
            dome()]


def grating_bench(order0=0.2, order=-1):
    """A grating of period 1 um lit by three wavelengths at 35 degrees:
    order -1 propagates at each of them, order +1 is evanescent."""
    gr = oe.rectangle(4.0, 4.0, material="grating", axis=(1, 0, 0),
                      grating_period=1.0, grating_order=order,
                      reflectivity=0.85, order0_fraction=order0)
    return [gr, oe.sphere(radius=5.0, material="measure", name="dome")]


def grating_source(**kw):
    a = np.deg2rad(35.0)
    return CollimatedSource(center=(-2 * np.sin(a), 0.0, 2 * np.cos(a)),
                            direction=(np.sin(a), 0.0, -np.cos(a)),
                            diameter=0.5, ray_count=900, seed=3,
                            wavelength=([0.45, 0.55, 0.65], [1, 1, 1]), **kw)


def optics_bench():
    """Polarizer, quarter-wave plate, beamsplitter, lens and mirror around
    a point source: every arm of the Stokes-Mueller path in one batch."""
    return [oe.disc(0.35, center=(-0.8, 0, 0.8), material="polarizer",
                    axis=(1.0, 0.3, 0.0)),
            oe.disc(0.35, center=(0, -0.8, 0.8), material="waveplate",
                    axis=(1.0, 1.0, 0.0), retardance=np.pi / 2),
            oe.rectangle(1.0, 1.0, center=(0.8, 0, 0.6),
                         material="beamsplitter", reflectivity=0.3),
            oe.biconvex_lens(1.0, 0.8, 0.3, ior=1.5, center=(0, 0, 1.0)),
            oe.disc(0.35, center=(0, 0.8, 0.8), material="mirror",
                    reflectivity=0.9),
            dome()]


def crystal_bench(axis=(1.0, 0.0, 1.0)):
    """A tilted calcite plate: entry splits o / e, exit transmits and
    reflects internally."""
    ax = np.asarray(axis, float) / np.linalg.norm(axis)
    plate = oe.cube(size=(3.0, 3.0, 0.6), center=(0, 0, 1.3),
                    material="birefringent", ior=1.658, ne=1.486,
                    axis=tuple(ax))
    plate.rotate((0, 1, 0), 0.3)
    return [plate, oe.sphere(radius=8.0, material="measure", name="world")]


def window_bench():
    window = oe.cube(0.8, material="refractive", ior=1.5)
    return [window, oe.disc(radius=1.2, center=(0, 0, 2.0),
                            material="measure", name="sensor"),
            oe.sphere(radius=6.0, material="terminator")]


def beam(**kw):
    return CollimatedSource(center=(0, 0, -2.0), direction=(0, 0, 1),
                            diameter=0.5, power=1.0, ray_count=600, seed=4,
                            **kw)


CASES = {
    # name: (elements, source, bounces, cfg overrides)
    "metals": (metal_bench, lambda: point(), 0, {}),
    "coatings-entry": (coated_bench, lambda: point(), 0, {}),
    "coatings-exit": (coated_bench, lambda: point(), 1, {}),
    "gratings-split": (grating_bench, grating_source, 0, {}),
    "gratings-no-split": (lambda: grating_bench(order0=0.0),
                          grating_source, 0, {}),
    "gratings-evanescent": (lambda: grating_bench(order=1),
                            grating_source, 0, {}),
    "polarization-optics": (optics_bench, lambda: point(stokes=ELLIPTIC),
                            0, dict(polarization=True)),
    "polarization-optics-bounce1": (optics_bench,
                                    lambda: point(stokes=ELLIPTIC), 1,
                                    dict(polarization=True)),
    "polarization-tir": (optics_bench, lambda: point(stokes=LINEAR_45), 2,
                         dict(polarization=True)),
    "polarization+coatings-entry": (coated_bench,
                                    lambda: point(stokes=ELLIPTIC), 0,
                                    dict(polarization=True)),
    "polarization+coatings-exit": (coated_bench,
                                   lambda: point(stokes=ELLIPTIC), 1,
                                   dict(polarization=True)),
    "polarization+metals": (metal_bench, lambda: point(stokes=LINEAR_45),
                            0, dict(polarization=True)),
    "polarization+gratings": (grating_bench,
                              lambda: grating_source(stokes=ELLIPTIC), 0,
                              dict(polarization=True)),
    "polarization+birefringence-entry": (
        crystal_bench, lambda: beam(stokes=LINEAR_45), 0,
        dict(polarization=True)),
    "polarization+birefringence-exit": (
        crystal_bench, lambda: beam(stokes=LINEAR_45), 1,
        dict(polarization=True)),
    "polarization+birefringence-axis-normal": (
        lambda: crystal_bench(axis=(0.0, 0.0, 1.0)),
        lambda: beam(stokes=ELLIPTIC), 1, dict(polarization=True)),
    "track_paths": (window_bench, lambda: beam(), 2,
                    dict(track_paths=True)),
    "track_paths-bounce3": (window_bench, lambda: beam(), 3,
                            dict(track_paths=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_shade_matches_reference(name):
    make_els, make_src, bounces, kw = CASES[name]
    ref, port, rays, pcfg = shade_pair(make_els(), make_src(), bounces, **kw)
    assert_shade_close(ref, port, rays)
    live = assert_conserves(port, rays)
    assert live > 0.01, "the case must carry power into this bounce"
    if "no-split" in name:
        assert not pcfg.allow_splitting
        assert port.child_power.shape[0] == rays.capacity
    if name.startswith("gratings"):
        diffracted = float(port.child_power[:rays.capacity].sum())
        assert (diffracted == 0.0) == ("evanescent" in name)
    if name.startswith("track_paths"):
        assert float(port.child_path.max()) > pcfg.path_base


def test_no_split_books_dropped_power():
    """Direct step use without the split buffer on a scene that splits:
    the second children's power (polarized transmission, the grating's
    0th order) is booked as dropped, as in the reference."""
    for make_els, make_src, kw in (
            (optics_bench, lambda: point(stokes=ELLIPTIC),
             dict(polarization=True)),
            (grating_bench, grating_source, {})):
        els = make_els()
        # the engine refuses this cfg for such scenes; resolve the flags
        # on a scene that does not split, then shade the real one
        ref, port, rays, _ = shade_pair(
            els, make_src(), 0, **kw, _no_split=True)
        assert_shade_close(ref, port, rays)
        assert_conserves(port, rays)
        assert float(port.policy_dropped) > 1e-3


def test_unpolarized_absorbs_stokes_elements():
    """Polarizer, waveplate and crystal hits in the unpolarized model
    (direct step use; the engine refuses it): absorbed, ledger exact."""
    els = optics_bench() + [crystal_bench()[0].translate((0, 0, 2.0))]
    ref, port, rays, _ = shade_pair(els, point(), 0, _unpolarized=True)
    assert_shade_close(ref, port, rays)
    assert_conserves(port, rays)
    assert float(port.absorbed) > 0.01
