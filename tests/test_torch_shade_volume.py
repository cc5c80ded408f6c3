"""The port's `shade` against the JAX package's under the random and the
volume switches: Lambertian scatterers, rough mirrors, turbid media,
fluorescence and gradient-index propagation (one step and the sub-step
loop), alone and with polarization / without the split buffer. The random
branches get the reference's own uniforms, drawn with the constants it
folds into the bounce key. Every ShadeOut field is compared
(tests/torch_port_common.py states the tolerances) and the step's power
balance must close to 1e-5."""

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger
from lightpycl_tpu_torch.tracer.scene import Scene
from torch_port_common import (CPU, assert_conserves, assert_shade_close,
                               both_cfg, port_batch, shade_pair)

torch.set_num_threads(1)
oe = L.optical_elements(n_segments=16, n_radial=6)
LINEAR_45 = (0.0, 1.0, 0.0)


def world(r=30.0):
    return oe.sphere(radius=r, material="measure", name="world")


def beam(n=1200, diameter=0.4, **kw):
    return CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                            diameter=diameter, power=1.0, ray_count=n,
                            seed=5, **kw)


def diffuse_bench():
    plate = oe.disc(radius=0.5, center=(0, 0, 2.0), material="diffuse",
                    reflectivity=0.7, name="plate")
    plate.rotate((1, 0, 0), np.pi)  # face the beam
    return [plate, world(6.0)]


def rough_bench(metal=False, tilt=0.3):
    kw = dict(material="mirror", reflectivity=0.9, roughness=0.03,
              roughness_lobe=0.7)
    if metal:
        kw.update(metal_n=0.2, metal_k=3.4)
    mirror = oe.rectangle(6.0, 6.0, center=(0, 0, 0), **kw)
    mirror.rotate((1.0, 0.0, 0.0), tilt).translate((0, 0, 2.0))
    smooth = oe.disc(0.3, center=(2.0, 0, 2.0), material="mirror",
                     reflectivity=0.8)
    return [mirror, smooth, world()]


def turbid_bench(ior=1.33, g=0.8, mu_a=0.1):
    slab = oe.cube((6.0, 6.0, 2.0), center=(0, 0, 2.0),
                   material="refractive", ior=ior, scattering=1.5,
                   scatter_g=g, absorption=mu_a)
    return [slab, world()]


def phosphor_bench(mu_s=0.5):
    slab = oe.cube((6.0, 6.0, 1.0), center=(0, 0, 1.5),
                   material="refractive", ior=1.2, fluorescence=1.5,
                   fluor_yield=0.8, fluor_emission=(0.60, 0.05),
                   fluor_edge=0.50, scattering=mu_s, absorption=0.05)
    clear = oe.cube((1.0, 1.0, 0.5), center=(0, 0, 4.0),
                    material="refractive", ior=1.5)
    return [slab, clear, world()]


def grin_bench(length=1.2):
    rod = oe.cube((1.2, 1.2, length), center=(0, 0, 1.0 + length / 2),
                  material="refractive", ior=1.6, grin_a=4.0,
                  axis=(0, 0, 1), grin_center=(0, 0, 1.0))
    screen = oe.rectangle(width=10.0, depth=10.0,
                          center=(0, 0, 1.0 + length + 5e-3),
                          material="measure", name="exit")
    return [rod, screen, world(20.0)]


def skew_beam(**kw):
    return CollimatedSource(center=(0.2, 0.1, 0), direction=(0.05, -0.1, 1),
                            diameter=0.5, power=1.0, ray_count=600, seed=6,
                            **kw)


PUMP = dict(wavelength=([0.45, 0.52], [3.0, 1.0]))

CASES = {
    # name: (elements, source, bounces, cfg overrides)
    "diffuse": (diffuse_bench, beam, 0, {}),
    "diffuse+polarization": (diffuse_bench,
                             lambda: beam(stokes=LINEAR_45), 0,
                             dict(polarization=True)),
    "roughness": (rough_bench, lambda: beam(diameter=5.0), 0, {}),
    "roughness+metals": (lambda: rough_bench(metal=True),
                         lambda: beam(diameter=5.0), 0, {}),
    "roughness+polarization": (lambda: rough_bench(metal=True),
                               lambda: beam(diameter=5.0,
                                            stokes=LINEAR_45), 0,
                               dict(polarization=True)),
    "roughness-no-split": (rough_bench, lambda: beam(diameter=5.0), 0,
                           dict(_no_split=True)),
    "scattering-enter": (turbid_bench, beam, 0, {}),
    "scattering-inside": (turbid_bench, beam, 1, {}),
    "scattering-deep": (turbid_bench, beam, 4, {}),
    "scattering-isotropic": (
        lambda: turbid_bench(ior=1.1, g=0.0, mu_a=0.0), beam, 2, {}),
    "scattering+polarization": (turbid_bench,
                                lambda: beam(stokes=LINEAR_45), 2,
                                dict(polarization=True)),
    "scattering+track_paths": (turbid_bench, beam, 2,
                               dict(track_paths=True)),
    "fluorescence-inside": (lambda: phosphor_bench(0.0),
                            lambda: beam(**PUMP), 1, {}),
    "fluorescence+scattering": (phosphor_bench, lambda: beam(**PUMP), 1,
                                {}),
    "fluorescence+scattering-deep": (phosphor_bench, lambda: beam(**PUMP),
                                     3, {}),
    "grin-enter": (grin_bench, skew_beam, 0, {}),
    "grin-step": (grin_bench, skew_beam, 1, {}),
    "grin-exit": (grin_bench, skew_beam, 10, dict(grin_step=0.15)),
    "grin-substeps": (grin_bench, skew_beam, 1, dict(grin_substeps=4)),
    "grin-substeps-exit": (grin_bench, skew_beam, 2,
                           dict(grin_substeps=8, grin_step=0.1)),
    "grin+polarization": (grin_bench, lambda: skew_beam(stokes=LINEAR_45),
                          3, dict(polarization=True)),
    "grin+polarization-substeps": (
        grin_bench, lambda: skew_beam(stokes=LINEAR_45), 2,
        dict(polarization=True, grin_substeps=3)),
    "grin+track_paths": (grin_bench, skew_beam, 2, dict(track_paths=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_shade_matches_reference(name):
    make_els, make_src, bounces, kw = CASES[name]
    ref, port, rays, _ = shade_pair(make_els(), make_src(), bounces,
                                       seed=11, **kw)
    lobes = name.startswith(("scattering", "fluorescence", "roughness"))
    assert_shade_close(ref, port, rays, lobes=lobes)
    live = assert_conserves(port, rays)
    assert live > 0.01, "the case must carry power into this bounce"
    C = rays.capacity
    if name.startswith("scattering") and "enter" not in name:
        # some lanes scattered mid-flight: slot A moved off the old line
        turned = (port.child_d[:C] * rays.d).sum(1) < 0.999999
        assert int((turned & port.child_alive[:C]).sum()) > 10
    if name.startswith("fluorescence"):
        converted = port.child_wavelength[:C] > 0.53
        assert int((converted & port.child_alive[:C]).sum()) > 10
    if name.startswith("grin") and "enter" not in name:
        assert float(port.child_ior[:C][port.child_alive[:C]].min()) < 1.6


@pytest.mark.parametrize("make", [diffuse_bench, rough_bench, turbid_bench,
                                  phosphor_bench])
def test_shade_without_uniforms_raises(make):
    """The random branches refuse to run without their uniforms."""
    els = make()
    _, pcfg = both_cfg(els)
    scene = Scene.from_reference(L.build_scene(els)[0], CPU)
    rays = port_batch(beam(n=64), pcfg)
    t = torch.full((64,), float("inf"))
    tri = torch.full((64,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="uniforms"):
        S.shade(scene, rays, t, tri, pcfg)
    with pytest.raises(ValueError, match="generator"):
        S.trace_step(scene, rays, DetectorState.zeros(4, 4, 1, device=CPU),
                     Ledger.start(1.0, CPU), pcfg)


def test_draw_shade_uniforms_streams():
    """Only the streams the cfg turns on are drawn, in a fixed order from
    one generator, so the same words give the same numbers."""
    from lightpycl_tpu_torch.tracer.config import TraceConfig
    cfg = TraceConfig(has_scattering=True, has_fluorescence=True,
                      has_diffuse=True, has_roughness=True)
    a = S.draw_shade_uniforms(cfg, 256, S.make_generator(CPU, 3, 1), CPU)
    b = S.draw_shade_uniforms(cfg, 256, S.make_generator(CPU, 3, 1), CPU)
    c = S.draw_shade_uniforms(cfg, 256, S.make_generator(CPU, 3, 2), CPU)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and not torch.equal(x, z)
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    assert float(a.free_path.min()) >= 1e-7
    assert a.scatter_dir.shape == (256, 2)
    only = S.draw_shade_uniforms(TraceConfig(has_roughness=True), 8,
                                 S.make_generator(CPU, 0), CPU)
    assert only.rough_lobe is not None and only.free_path is None \
        and only.lambertian is None and only.event_kind is None
