"""Whole traces of scenes that use the surface and volume physics, through
the port's Tracer on the CPU and through the JAX package's, host and device
mode: ledger terms abs 1e-6, detector totals against the reference's ledger,
measured rays as sets (positions abs 2e-5, directions abs 3e-6, Stokes
fractions abs 2e-5, path signatures equal as integers).

The random features (diffuse, rough, turbid, fluorescent) cannot share the
reference's stream through a whole trace, so they are held to it through
two trace steps with its own uniforms injected, and statistically, with the
bound stated from the ray count. Repeats and a resumed batched run must be
bit-identical."""

import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu import sources as ref_sources
from lightpycl_tpu.tracer import step as R
from lightpycl_tpu.tracer.rays import DetectorState as RefDet
from lightpycl_tpu.tracer.rays import Ledger as RefLedger
from lightpycl_tpu_torch import sources as port_sources
from lightpycl_tpu_torch.tracer import step as S
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger
from lightpycl_tpu_torch.tracer.scene import Scene
from torch_port_common import (CPU, both_cfg, bounce_key, port_batch,
                               ref_batch, reference_uniforms)

torch.set_num_threads(1)
N0, NE = 1.658, 1.486


def coated_polarized(M, S_):
    """A two-layer coated lens, a silver fold mirror and a dome under a
    linearly polarized beam."""
    oe = M.optical_elements(16, 6)
    lens = oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5, center=(0, 0, 1.0),
                            coating=[(1.38, 0.10), (2.1, 0.05)])
    fold = oe.rectangle(1.5, 1.5, center=(0, 0, 2.5), material="mirror",
                        reflectivity=0.98, metal_n=0.13, metal_k=3.9)
    fold.rotate((0, 1, 0), np.pi - 0.6, pivot=(0, 0, 2.5))
    els = [lens, fold, oe.sphere(radius=8.0, material="measure",
                                 name="dome")]
    src = S_.CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                              diameter=0.5, ray_count=600, seed=3,
                              stokes=(0.6, 0.8, 0.0))
    return els, src, dict(trace_iterations=6, capacity=4096,
                          polarization=True)


def spectrometer(M, S_):
    """A grating with a 0th-order leak under three wavelengths."""
    oe = M.optical_elements(16, 6)
    # the plane of diffraction is turned 17 degrees off the x axis, so no
    # order lands on an azimuth bin's edge (nor, at 33 degrees, the
    # specular one on a polar bin's)
    az = np.deg2rad(17.0)
    ux, uy = np.cos(az), np.sin(az)
    gr = oe.rectangle(4.0, 4.0, material="grating", axis=(ux, uy, 0),
                      grating_period=1.2, grating_order=-1,
                      reflectivity=0.85, order0_fraction=0.15)
    a = np.deg2rad(33.0)
    src = S_.CollimatedSource(center=(-2 * np.sin(a) * ux,
                                      -2 * np.sin(a) * uy, 2 * np.cos(a)),
                              direction=(np.sin(a) * ux, np.sin(a) * uy,
                                         -np.cos(a)),
                              diameter=0.5, ray_count=600, seed=3,
                              wavelength=([0.45, 0.55, 0.65], [1, 2, 1]))
    return ([gr, oe.sphere(radius=5.0, material="measure", name="dome")],
            src, dict(trace_iterations=3, capacity=2048,
                      hist_mode="direction"))


def malus_chain(M, S_):
    """Polarizer at 0, quarter-wave plate at 45 degrees, analyzer at 30
    degrees, detector: an unpolarized beam through the whole chain."""
    oe = M.optical_elements(16, 6)
    ang = np.deg2rad(30.0)
    els = [oe.disc(0.5, center=(0, 0, 1.0), material="polarizer",
                   axis=(1.0, 0.0, 0.0)),
           oe.disc(0.5, center=(0, 0, 1.5), material="waveplate",
                   axis=(1.0, 1.0, 0.0), retardance=np.pi / 2),
           oe.disc(0.5, center=(0, 0, 2.0), material="polarizer",
                   axis=(np.cos(ang), np.sin(ang), 0.0)),
           oe.disc(1.0, center=(0, 0, 3.0), material="measure", name="det")]
    src = S_.CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                              diameter=0.4, ray_count=500, seed=2)
    return els, src, dict(trace_iterations=5, polarization=True)


def calcite(M, S_):
    oe = M.optical_elements(16, 6)
    plate = oe.cube(size=(20.0, 20.0, 5.0), center=(0, 0, 3.5),
                    material="birefringent", ior=N0, ne=NE,
                    axis=(np.sin(0.8), 0.0, np.cos(0.8)))
    det = oe.rectangle(width=40.0, depth=40.0, center=(0, 0, 30.0),
                       material="measure", name="det")
    src = S_.CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                              diameter=0.5, ray_count=400, seed=5,
                              stokes=(0.0, 1.0, 0.0))
    return ([plate, det, oe.sphere(radius=60.0, material="terminator")],
            src, dict(trace_iterations=6, capacity=4096, polarization=True))


def grin_rod(M, S_, stokes=None, **kw):
    oe = M.optical_elements(16, 6)
    length = 1.5
    rod = oe.cube((1.2, 1.2, length), center=(0, 0, 1.0 + length / 2),
                  material="refractive", ior=1.6, grin_a=4.0,
                  axis=(0, 0, 1), grin_center=(0, 0, 1.0))
    screen = oe.rectangle(width=10.0, depth=10.0,
                          center=(0, 0, 1.0 + length + 5e-3),
                          material="measure", name="exit")
    src = S_.CollimatedSource(center=(0.1, 0, 0), direction=(0, 0.05, 1),
                              diameter=0.4, ray_count=200, seed=7,
                              stokes=stokes)
    cfg = dict(trace_iterations=40, capacity=1024)
    cfg.update(kw)
    return ([rod, screen, oe.sphere(radius=20.0, material="measure",
                                    name="world")], src, cfg)


def ghost_window(M, S_):
    oe = M.optical_elements(16, 6)
    window = oe.cube(0.8, material="refractive", ior=1.5)
    det = oe.disc(radius=1.2, center=(0, 0, 2.0), material="measure",
                  name="sensor")
    src = S_.CollimatedSource(center=(0, 0, -2.0), direction=(0, 0, 1),
                              diameter=0.5, ray_count=128, seed=4)
    return [window, det], src, dict(trace_iterations=6, capacity=4096,
                                    track_paths=True,
                                    dissipation_target=1.0)


# ledger terms abs 1e-6; the GRIN rods take 14 .. 40 bounces, each adding
# float32 sums to every term, and are held to 5e-6
LEDGER_ATOL = {"grin_rod": 5e-6, "grin_rod_substeps": 5e-6,
               "grin_rod_polarized": 5e-6}

SCENES = {
    "coated_polarized_metal": (coated_polarized, ("host", "device")),
    "grating_spectrometer": (spectrometer, ("host", "device")),
    "malus_chain": (malus_chain, ("host", "device")),
    "calcite_plate": (calcite, ("host", "device")),
    "grin_rod": (grin_rod, ("host", "device")),
    "grin_rod_substeps": (
        lambda M, S_: grin_rod(M, S_, grin_substeps=4, trace_iterations=14),
        ("host", "device")),
    "grin_rod_polarized": (
        lambda M, S_: grin_rod(M, S_, stokes=(0.6, 0.0, 0.8),
                               polarization=True), ("host",)),
    "ghost_paths": (ghost_window, ("host",)),
}
CASES = [(n, m) for n, (_, modes) in sorted(SCENES.items()) for m in modes]


def same_rows(a, b, atol):
    """Rows of a and b equal as sets, column k within atol[k]."""
    assert a.shape == b.shape
    if len(a) == 0:
        return
    dist = (np.abs(a[:, None, :] - b[None, :, :]) / atol).max(axis=2)
    nearest = dist.argmin(axis=0)
    assert dist[nearest, np.arange(len(b))].max() <= 1.0, \
        float(dist[nearest, np.arange(len(b))].max())
    assert len(np.unique(nearest)) == len(b)


@pytest.mark.parametrize("name,mode", CASES)
def test_trace_matches_reference(name, mode):
    make = SCENES[name][0]
    els, src, kw = make(L, ref_sources)
    ref = L.Tracer().trace(src, els, mode=mode, **kw)
    els, src, kw = make(P, port_sources)
    port = P.Tracer(device=CPU).trace(src, els, mode=mode, **kw)
    assert port.iterations_run == ref.iterations_run
    led_atol = LEDGER_ATOL.get(name, 1e-6)
    for k, v in ref.ledger.items():
        assert port.ledger[k] == pytest.approx(v, abs=led_atol), k
    assert port.power_conservation_error() < 1e-5
    assert port.final_live_power == pytest.approx(ref.final_live_power,
                                                  abs=led_atol)
    assert ref.ledger["measured"] > 0.05
    # per detector against the reference's ledger (its own per_detector is
    # a serial float32 scatter-add) and, loosely, against its bins
    assert float(port.per_detector.sum()) == pytest.approx(
        ref.ledger["measured"], abs=2 * led_atol)
    assert np.allclose(port.per_detector, ref.per_detector, rtol=0,
                       atol=2e-5)
    # (a bin holding most of the power carries the serial sum's error)
    assert np.allclose(port.hist, ref.hist, rtol=1e-5, atol=2e-6)
    if mode != "host":
        return
    assert len(port.measured_power) == len(ref.measured_power) > 0
    assert np.array_equal(np.sort(ref.measured_det),
                          np.sort(port.measured_det))
    cols = lambda r: np.concatenate(  # noqa: E731
        [r.measured_pos, r.measured_dir, r.measured_power[:, None],
         r.measured_stokes, r.measured_wavelength[:, None],
         r.measured_opl[:, None], r.measured_path[:, None]], axis=1)
    atol = np.array([2e-5] * 3 + [3e-6] * 3 + [1e-6] + [2e-5] * 3 + [1e-6]
                    + [1e-4] + [0.5])
    same_rows(cols(ref).astype(np.float64), cols(port).astype(np.float64),
              atol)
    if kw.get("track_paths"):
        assert np.array_equal(
            np.sort(ref.measured_path.astype(np.int64)),
            np.sort(port.measured_path.astype(np.int64)))
        assert len(np.unique(port.measured_path)) >= 2  # direct + ghost
    if kw.get("polarization"):
        assert np.abs(port.measured_stokes).max() > 0.1


def test_malus_law_through_the_chain():
    """Polarizer, quarter-wave plate at 45 degrees, analyzer: circular
    light after the plate, so the analyzer passes half of the polarizer's
    half whatever its angle."""
    els, src, kw = malus_chain(P, port_sources)
    res = P.Tracer(device=CPU).trace(src, els, mode="device", **kw)
    assert res.ledger["measured"] == pytest.approx(0.25, abs=1e-5)


def test_track_paths_needs_host_mode():
    els, src, kw = ghost_window(P, port_sources)
    with pytest.raises(ValueError, match="mode='host'"):
        P.Tracer(device=CPU).trace(src, els, mode="device", **kw)


def test_grin_step_is_derived_from_the_pitch():
    els, _, _ = grin_rod(P, port_sources)
    tr = P.Tracer(device=CPU)
    tr.set_elements(els)
    cfg = tr._check_polarization(P.TraceConfig())
    assert cfg.has_grin and cfg.grin_step == pytest.approx(
        2 * np.pi / np.sqrt(4.0) / 50.0)
    assert tr._check_polarization(
        P.TraceConfig(grin_step=0.3)).grin_step == 0.3


def test_fluorescence_refuses_coherent():
    oe = P.optical_elements(8, 4)
    slab = oe.cube(1.0, material="refractive", ior=1.2, fluorescence=1.0,
                   fluor_emission=0.6, fluor_edge=0.5)
    with pytest.raises(ValueError, match="fluorescence"):
        P.Tracer(device=CPU).trace(
            P.light_source(ray_count=8), [slab, oe.hemisphere(5.0)],
            coherent=True, image_bins=4)


# --------------------------------------------------------------------------
# the random features
# --------------------------------------------------------------------------

def diffuser(M):
    oe = M.optical_elements(16, 6)
    plate = oe.disc(radius=0.5, material="diffuse", reflectivity=0.7,
                    name="plate")
    return [plate, oe.hemisphere(radius=6.0, name="dome"),
            oe.disc(radius=6.0, center=(0, 0, -0.01), material="terminator")]


def rough_mirror(M):
    oe = M.optical_elements(16, 6)
    mirror = oe.rectangle(6.0, 6.0, center=(0, 0, 0), material="mirror",
                          reflectivity=0.9, roughness=0.03,
                          roughness_lobe=0.7)
    mirror.rotate((1.0, 0.0, 0.0), np.pi - 0.3).translate((0, 0, 2.0))
    return [mirror, oe.sphere(radius=30.0, material="measure", name="world")]


def turbid_phosphor(M, mu_s=1.0, mu_f=0.8, g=0.8, qy=0.8):
    oe = M.optical_elements(16, 6)
    slab = oe.cube((6.0, 6.0, 1.0), center=(0, 0, 1.5),
                   material="refractive", ior=1.2, fluorescence=mu_f,
                   fluor_yield=qy, fluor_emission=0.60, fluor_edge=0.50,
                   scattering=mu_s, scatter_g=g)
    return [slab, oe.sphere(radius=30.0, material="measure", name="world")]


def down_beam(S_, n=1000, **kw):
    return S_.CollimatedSource(center=(0, 0, 1.0), direction=(0, 0, -1),
                               diameter=0.5, ray_count=n, seed=1, **kw)


def up_beam(S_, n=1000, **kw):
    return S_.CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=0.4, ray_count=n, seed=1, **kw)


RANDOM = {
    "diffuse": (diffuser, down_beam, {}),
    "roughness": (rough_mirror, up_beam, {}),
    "scattering+fluorescence": (turbid_phosphor,
                                lambda S_: up_beam(S_, wavelength=0.45), {}),
    "diffuse+roulette": (diffuser, down_beam,
                         dict(roulette_threshold=2e-3)),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_two_steps_with_reference_uniforms(name):
    """Two bounces through trace_step on both sides, the port fed the
    reference's draws: same ledger, same live rays."""
    make, make_src, kw = RANDOM[name]
    els = make(L)
    rcfg, pcfg = both_cfg(els, seed=9, **kw)
    rs, _ = L.build_scene(els)
    ps = Scene.from_reference(rs, CPU)
    prays = port_batch(make_src(port_sources), pcfg, 4096)
    rrays = ref_batch(prays)
    rdet, rled = RefDet.zeros(36, 18, 2), RefLedger.start(1.0)
    pdet = DetectorState.zeros(36, 18, 2, device=CPU)
    pled = Ledger.start(1.0, CPU)
    for i in range(2):
        key = bounce_key(9, i)
        un, rr = reference_uniforms(key, pcfg, prays.capacity)
        rrays, rdet, rled, _ = R.trace_step_jit(rs, rrays, rdet, rled, rcfg,
                                                key)
        prays, pdet, pled, _ = S.trace_step(ps, prays, pdet, pled, pcfg,
                                            uniforms=un, roulette_u=rr)
        for f in RefLedger._fields:
            assert float(getattr(pled, f)) == pytest.approx(
                float(getattr(rled, f)), abs=1e-6), (i, f)
        ra, pa = np.asarray(rrays.alive), prays.alive.numpy()
        assert ra.sum() == pa.sum()
        rows = lambda b, lib, m: np.concatenate(  # noqa: E731
            [np.asarray(getattr(b, f)).reshape(len(m), -1) if lib == "r"
             else getattr(b, f).numpy().reshape(len(m), -1)
             for f in ("o", "d", "power", "wavelength")], axis=1)[m]
        # lobe directions: 5e-5 (torch_port_common.LOBE_DIRECTION)
        same_rows(rows(rrays, "r", ra).astype(np.float64),
                  rows(prays, "p", pa).astype(np.float64),
                  np.array([1e-4] * 3 + [5e-5] * 3 + [1e-6, 1e-6]))
    assert float(pled.measured + pled.absorbed) > 0.0


N_STAT = 20000


def test_lambertian_albedo_and_cosine_law():
    """Albedo 0.7: measured 0.7, absorbed 0.3 (exact, the split is
    deterministic); scattered directions follow the cosine law, mean
    cos(theta) = 2/3 with sigma = sqrt(1/18) / sqrt(N): 5 sigma."""
    res = P.Tracer(device=CPU).trace(
        down_beam(port_sources, N_STAT), diffuser(P), trace_iterations=4,
        hist_mode="direction", seed=3)
    assert res.ledger["absorbed"] == pytest.approx(0.3, abs=1e-5)
    assert res.ledger["measured"] == pytest.approx(0.7, abs=1e-5)
    cos = res.measured_dir[:, 2]
    assert abs(cos.mean() - 2.0 / 3.0) < 5 * np.sqrt(1 / 18 / N_STAT)


def test_rough_mirror_tis_and_lobe():
    """The specular / scattered split is the Rayleigh-Rice TIS (exact);
    the scattered lobe's mean cosine about the specular direction is that
    of a Henyey-Greenstein lobe of g = 0.7 folded at the mirror's horizon,
    drawn here independently in numpy (200,000 draws): 5 sigma of the
    20,000 traced rays, sigma = std / sqrt(N)."""
    els = rough_mirror(P)
    res = P.Tracer(device=CPU).trace(up_beam(port_sources, N_STAT), els,
                                     trace_iterations=3, seed=3,
                                     capacity=2 * N_STAT)
    cos_i = np.cos(0.3)
    tis = 1 - np.exp(-(4 * np.pi * 0.03 * cos_i / 0.5876) ** 2)
    n = np.array([0.0, -np.sin(0.3), -np.cos(0.3)])  # facing the beam
    spec = np.array([0, 0, 1.0]) - 2 * n[2] * n
    c = res.measured_dir @ spec
    is_spec = c > 1 - 1e-6
    p = res.measured_power
    # a lobe ray or two in 20,000 (1.4e-5 each) is folded back onto the
    # mirror and still in flight when the trace stops, or leaves within
    # 1e-6 of the specular direction and counts there
    assert p.sum() + res.final_live_power == pytest.approx(0.9, abs=1e-5)
    assert p[is_spec].sum() == pytest.approx(0.9 * (1 - tis), abs=1e-4)
    rng = np.random.default_rng(0)
    u, phi = rng.uniform(size=200000), rng.uniform(0, 2 * np.pi, 200000)
    g = 0.7
    ct = (1 + g * g - ((1 - g * g) / (1 + g - 2 * g * u)) ** 2) / (2 * g)
    st = np.sqrt(1 - ct ** 2)
    e1 = np.cross(spec, [1.0, 0, 0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(spec, e1)
    d = (st * np.cos(phi))[:, None] * e1 + (st * np.sin(phi))[:, None] * e2 \
        + ct[:, None] * spec
    d = d - 2 * np.minimum(d @ n, 0.0)[:, None] * n
    lobe = c[~is_spec]
    assert abs(lobe.mean() - (d @ spec).mean()) < 5 * lobe.std() / np.sqrt(
        len(lobe))


def test_turbid_slab_statistics():
    """Index-matched slab, mu_s = 1 over thickness 1, g = 0.8: the
    unscattered share is exp(-1) (binomial sigma over N rays: 5 sigma) and
    the first scatter's mean cosine is g (sigma <= 1 / sqrt(n): 5 sigma)."""
    oe = P.optical_elements(16, 6)
    slab = oe.cube((6.0, 6.0, 1.0), center=(0, 0, 1.5),
                   material="refractive", ior=1.0, scattering=1.0,
                   scatter_g=0.8)
    tr = P.Tracer(device=CPU)
    tr.set_elements([slab, oe.sphere(30.0, material="measure")])
    cfg = tr._check_polarization(tr._tune_splitting(P.TraceConfig(cull=False)))
    rays = port_batch(up_beam(port_sources, N_STAT), cfg, 2 * N_STAT)
    det = DetectorState.zeros(36, 18, 1, device=CPU)
    led = Ledger.start(1.0, CPU)
    # bounce 0 enters the slab (slot B); bounce 1 is the first flight inside
    rays, det, led, _ = S.trace_step(tr.scene, rays, det, led, cfg,
                                     gen=S.make_generator(CPU, 0, 0))
    inside = rays.alive & (rays.scat > 0)
    assert int(inside.sum()) == N_STAT
    before = rays
    rays, det, led, _ = S.trace_step(tr.scene, rays, det, led, cfg,
                                     gen=S.make_generator(CPU, 0, 1))
    # top-k compaction reorders: match children to parents by power order
    # is not possible, so read the event off the children themselves
    kids = rays.alive & (rays.scat > 0)       # still inside: scattered
    frac_scattered = float(kids.sum()) / N_STAT
    sigma = np.sqrt(np.exp(-1) * (1 - np.exp(-1)) / N_STAT)
    assert abs((1 - frac_scattered) - np.exp(-1)) < 5 * sigma
    cos = rays.d[kids][:, 2]                   # parents all flew along +z
    assert abs(float(cos.mean()) - 0.8) < 5 / np.sqrt(int(kids.sum()))
    assert float(before.d[inside][:, 2].min()) > 1 - 1e-6


def test_fluorescence_yield_times_stokes_ratio():
    """A pure phosphor (no elastic scatter) thick enough to convert every
    pump ray once: converted power = QY x (lambda_pump / lambda_em) of the
    pump, the rest absorbed; emission is above the edge, so it never
    converts again."""
    els = turbid_phosphor(P, mu_s=0.0, mu_f=40.0, qy=0.8)
    res = P.Tracer(device=CPU).trace(
        up_beam(port_sources, 4000, wavelength=0.45), els,
        trace_iterations=12, capacity=16384, seed=5,
        dissipation_target=1.0)
    assert res.power_conservation_error() < 1e-5
    # Fresnel loss at the entry face aside, every ray converts
    entered = 1.0 - ((1.2 - 1) / (1.2 + 1)) ** 2
    assert res.ledger["absorbed"] == pytest.approx(
        entered * (1 - 0.8 * 0.45 / 0.60), abs=2e-3)
    wl = res.measured_wavelength
    red = res.measured_power[wl > 0.55].sum()
    assert red == pytest.approx(entered * 0.8 * 0.45 / 0.60, abs=2e-3)


@pytest.mark.parametrize("name", sorted(RANDOM))
@pytest.mark.parametrize("mode", ["host", "device"])
def test_random_repeats_bit_identical(name, mode):
    make, make_src, kw = RANDOM[name]

    def run(seed):
        return P.Tracer(device=CPU).trace(
            make_src(port_sources), make(P), trace_iterations=4,
            capacity=4096, mode=mode, seed=seed, **kw)

    a, b, c = run(2), run(2), run(3)
    assert a.ledger == b.ledger and np.array_equal(a.hist, b.hist)
    assert np.array_equal(a.measured_dir, b.measured_dir)
    assert a.power_conservation_error() < 1e-5
    assert not np.array_equal(a.hist, c.hist)


def test_host_and_device_modes_share_the_stream():
    """Both modes seed bounce i from (seed, i): same ledger, same bins."""
    make, make_src, _ = RANDOM["scattering+fluorescence"]
    res = [P.Tracer(device=CPU).trace(make_src(port_sources), make(P),
                                      trace_iterations=5, capacity=4096,
                                      mode=m, seed=4, dissipation_target=1.0)
           for m in ("host", "device")]
    assert res[0].ledger == res[1].ledger
    assert np.array_equal(res[0].hist, res[1].hist)


def test_resumed_batched_diffuser_equals_uninterrupted(tmp_path):
    els = diffuser(P) + rough_mirror(P)[:1]
    src = down_beam(port_sources)
    kw = dict(elements=els, trace_iterations=4, seed=11)
    whole = P.Tracer(device=CPU).trace_batched(src, 4 * 512, 512, **kw)
    ck = str(tmp_path / "run")
    P.Tracer(device=CPU).trace_batched(src, 4 * 512, 512, max_batches=2,
                                       checkpoint_path=ck, **kw)
    resumed = P.Tracer(device=CPU).trace_batched(src, 4 * 512, 512,
                                                 checkpoint_path=ck, **kw)
    assert resumed.ledger == whole.ledger
    assert np.array_equal(resumed.hist, whole.hist)
    assert np.array_equal(resumed.per_batch_detector,
                          whole.per_batch_detector)
    assert whole.ledger["measured"] > 0.1
    assert whole.power_conservation_error() < 1e-5
