"""Spectral tracing of the port (lightpycl_tpu_torch.spectral and
Tracer.trace_spectral on the CPU) against the JAX package's, on the same
rays: one bounce of the shared-geometry step, whole shared traces on the
reference tests' scenes (tests/test_spectral.py), whole wavelength-batched
traces (a dispersive prism, a grating, a diffuse floor with roulette fed the
reference's own draws), the white-light Michelson's per-wavelength field
planes, and the engine's dispatch, refusals, compat upgrade and repeats."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu import spectral as RS
from lightpycl_tpu.materials import SF10
from lightpycl_tpu.sources import CollimatedSource as RefBeam
from lightpycl_tpu_torch import spectral as PS
from lightpycl_tpu_torch.compat import CL_Tracer
from lightpycl_tpu_torch.tracer.scene import Scene
from test_torch_batched import field_tol
from torch_port_common import (DIRECTION, LENGTH, LENGTH_REL, POWER,
                               both_cfg, bounce_key, reference_uniforms)

torch.set_num_threads(1)
CPU = torch.device("cpu")
WLS = [0.45, 0.50, 0.55, 0.60, 0.65]
WL3 = [0.40, 0.55, 0.70]
LEDGER = ("emitted", "measured", "absorbed", "escaped", "culled")
# the reference's batched ledger bins by serial float32 scatter-adds
# (.at[].add on the CPU), whose rounding leaves ~4e-6 in its absorbed and
# culled columns of a unit-power trace; the port sums by tree (nearer exact)
REF_SCATTER = 1e-5
# the per-column ledger closes to this (the reference test's own bound)
CLOSES = 2e-6
# the reference's per-detector spectra and maps: see
# test_shared_trace_matches_reference
REF_DRIFT = 5e-6


def coated_window(M):
    """tests/test_spectral.py:31: a quarter-wave AR-coated window between
    two measuring discs, in a terminating shell."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    return [oe.cube(size=(1.0, 1.0, 0.25), material="refractive", ior=1.52,
                    coat_ior=1.38, coat_thickness=0.55 / (4 * 1.38),
                    name="win"),
            oe.disc(radius=1.5, center=(0, 0, 2.0), material="measure",
                    name="fwd"),
            oe.disc(radius=1.5, center=(0, 0, -2.0), material="measure",
                    name="back"),
            oe.sphere(radius=8.0, material="terminator")]


def mirror_lens(M):
    """tests/test_spectral.py:112: an uncoated lens, a parabolic mirror
    facing it, a measuring dome."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    mirror = oe.parabolic_mirror(focus=0.5, diameter=2.0, reflectivity=0.9)
    mirror.translate((0, 0, 2.5)).rotate((1, 0, 0), np.pi, pivot=(0, 0, 2.5))
    return [oe.plano_convex_lens(0.8, 0.5, 0.12, ior=1.52), mirror,
            oe.sphere(radius=9.0, material="measure", name="dome")]


def step_scene(M):
    """For the one-bounce test: an exact plano-convex lens, a window with a
    two-layer stack, a silver fold mirror at 45 degrees, two detectors."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    fold = oe.rectangle(1.5, 1.5, center=(0, 0, 2.0), material="mirror",
                        reflectivity=0.98, metal_n=0.13, metal_k=3.9)
    fold.rotate((0, 1, 0), 0.75 * np.pi, pivot=(0, 0, 2.0))
    return [*M.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5),
            oe.cube(size=(1.0, 1.0, 0.1), center=(0, 0, 0.6),
                    material="refractive", ior=1.52,
                    coating=[(1.38, 0.1), (2.1, 0.05)], name="win"),
            fold,
            oe.disc(radius=1.5, center=(0, 0, -2.0), material="measure",
                    name="back"),
            oe.sphere(radius=8.0, material="measure", name="dome")]


def prism(M):
    """tests/test_spectral.py:232: an SF10 prism in a measuring dome."""
    a, b = SF10
    oe = M.optical_elements(n_segments=24, n_radial=8)
    pr = oe.prism(width=1.04, height=0.3, length=1.0, ior=a)
    pr.dispersion_b = b
    return [pr, oe.sphere(10.0, material="measure", name="dome")]


def grating(M):
    """tests/test_spectral.py:296: a reflection grating, a quarter of its
    reflected power left in order 0, in a measuring dome."""
    oe = M.optical_elements(n_segments=32, n_radial=12)
    gr = oe.rectangle(4.0, 4.0, material="grating", axis=(1, 0, 0),
                      grating_period=1.2, grating_order=1, reflectivity=0.9)
    gr.order0_fraction = 0.25
    return [gr, oe.sphere(radius=5.0, material="measure", name="dome")]


def diffuse_prism(M):
    """The prism over a diffusing floor (random directions: a batched scene
    that needs draws)."""
    oe = M.optical_elements(n_segments=24, n_radial=8)
    return [*prism(M)[:1],
            oe.disc(radius=3.0, center=(0, 0, -0.5), material="diffuse",
                    reflectivity=0.7, name="floor"),
            oe.sphere(10.0, material="measure", name="dome")]


def michelson(M, arm):
    """examples/example_michelson.py: a 50/50 beamsplitter at 45 degrees,
    two arm mirrors (one moved by `arm`), the output port's panel."""
    oe = M.optical_elements(n_segments=16, n_radial=6)
    return [oe.rectangle(2.0, 2.0, material="beamsplitter",
                         reflectivity=0.5).rotate((0, 1, 0), np.pi / 4),
            oe.rectangle(2.0, 2.0, material="mirror").rotate(
                (0, 1, 0), np.pi / 2).translate((-1.5 - arm, 0, 0)),
            oe.rectangle(2.0, 2.0, material="mirror").rotate(
                (0, 1, 0), np.pi).translate((0, 0, 1.5)),
            oe.rectangle(2.0, 2.0, material="measure", name="output").rotate(
                (0, 1, 0), -np.pi / 2).translate((1.5, 0, 0))]


MICHELSON_MAP = dict(coherent=True, image_bins=32,
                     image_center=(1.5, 0.0, 0.0),
                     image_normal=(1.0, 0.0, 0.0), image_halfwidth=0.6)


def beam_rays(n, seed, center=(0, 0, -1.0), direction=(0, 0, 1),
              diameter=0.5, sampling="random"):
    """A collimated bundle's numpy rays (the reference's sampler; the
    port's gives the same bits, tests/test_torch_host_layer.py)."""
    return RefBeam(center=center, direction=direction, diameter=diameter,
                   ray_count=n, power=1.0, seed=seed,
                   sampling=sampling).sample()


def prism_rays(n, seed=2):
    return beam_rays(n, seed, center=(0.3, -0.5, 0), direction=(0, 1, 0),
                     diameter=0.04)


def both_batches(o, d, p, capacity):
    return (L.RayBatch.from_arrays(o, d, p, capacity=capacity),
            P.RayBatch.from_arrays(o, d, p, capacity=capacity, device=CPU))


def close(a, b, atol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.isfinite(b))
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= atol, err


# ---- one bounce of spectral_step ------------------------------------------

def tie_permutation(ref, port):
    """Slot permutation of the port's SpectralRays onto the reference's:
    the identity, but for slots whose rows differ, each of which must find
    its row at another such slot whose row total ties with its own."""
    reach = np.linalg.norm(np.asarray(ref.o), axis=1)
    tol = np.concatenate([np.full((reach.size, ref.P.shape[1]), POWER),
                          np.full((reach.size, 3), DIRECTION),
                          (LENGTH + LENGTH_REL * reach)[:, None].repeat(4, 1),
                          np.zeros((reach.size, 3))], axis=1)

    def rows(sr):
        cols = [np.asarray(sr.P), np.asarray(sr.d), np.asarray(sr.o),
                np.asarray(sr.opl)[:, None], np.asarray(sr.ior)[:, None],
                np.asarray(sr.absorb)[:, None], np.asarray(sr.alive)[:, None]]
        return np.concatenate([c.astype(np.float64) for c in cols], axis=1)

    a, b = rows(ref), rows(port)
    key = np.asarray(ref.P, np.float32).sum(axis=1)
    perm = np.arange(len(a))
    bad = np.where(~np.all(np.abs(a - b) <= tol, axis=1))[0]
    for i in bad:
        ties = bad[np.abs(key[bad] - key[i])
                   <= 8 * np.spacing(np.float32(abs(key[i])))]
        found = [j for j in ties if np.all(np.abs(a[i] - b[j]) <= tol[i])]
        assert found, f"slot {i}: no tied slot holds the reference's child"
        perm[i] = found[0]
    assert len(set(perm[bad].tolist())) == len(bad)
    return torch.from_numpy(perm)


ref_step = jax.jit(RS.spectral_step, static_argnames=("cfg",))


@pytest.mark.parametrize("bounce", [0, 1, 3])
def test_spectral_step_matches_reference(bounce):
    """The state after `bounce` reference steps, stepped once by each
    package: every next-ray field, the (D, W) spectra, the detector maps and
    every ledger column."""
    wls = [0.45, 0.55, 0.65, 0.75]
    cfg0 = L.TraceConfig(cull=False, image_bins=8, image_halfwidth=1.5,
                         image_center=(0, 0, -2.0))
    rcfg, rscene, names, wl, w = RS._resolve_spectral(
        step_scene(L), cfg0, wls, None)
    assert rcfg.has_coatings and rcfg.has_metals and rcfg.has_analytic
    pcfg = P.TraceConfig(**dataclasses.asdict(rcfg))
    scene = Scene.from_reference(rscene, CPU)
    o, d, p = beam_rays(256, 4, center=(0, 0, -0.5), diameter=0.3)
    rays = L.RayBatch.from_arrays(o, d, p, capacity=1024)
    sr = RS.SpectralRays.from_batch(rays, w)
    D, W = len(names), len(wls)
    det = L.tracer.rays.DetectorState.zeros(36, 18, D, 8)
    per_det = jnp.zeros((D, W), jnp.float32)
    z = jnp.zeros((W,), jnp.float32)
    led = RS.SpectralLedger(jnp.sum(sr.P, axis=0), z, z, z, z)
    for _ in range(bounce):
        sr, det, per_det, led = ref_step(rscene, sr, det, per_det, led, wl,
                                         rcfg)

    def port(x):
        return type(x)(*(torch.from_numpy(np.array(a)) for a in x))

    p_in = PS.SpectralRays(*port(sr))
    r_out = ref_step(rscene, sr, det, per_det, led, wl, rcfg)
    p_out = PS.spectral_step(scene, p_in, P.tracer.DetectorState(
        *port(det)), torch.from_numpy(np.array(per_det)),
        PS.SpectralLedger(*port(led)), torch.from_numpy(np.array(wl)), pcfg)
    r_sr, r_det, r_pd, r_led = r_out
    p_sr, p_det, p_pd, p_led = p_out
    live = np.asarray(r_sr.alive)
    assert live.sum() > 0
    # slot order is the top-k's: children whose row totals tie (to a few
    # float32 ulps: the packages add the W columns in other orders) may
    # swap slots; match them, then hold every field slot by slot
    perm = tie_permutation(r_sr, p_sr)
    p_sr = PS.SpectralRays(*(a[perm] for a in p_sr))
    assert np.array_equal(live, p_sr.alive.numpy())
    assert np.array_equal(np.asarray(r_sr.ior), p_sr.ior.numpy())
    assert np.array_equal(np.asarray(r_sr.absorb), p_sr.absorb.numpy())
    close(r_sr.P, p_sr.P, POWER)
    close(r_sr.d, p_sr.d, DIRECTION)
    reach = np.linalg.norm(np.asarray(r_sr.o), axis=1)
    assert np.all(np.abs(np.asarray(r_sr.o) - p_sr.o.numpy())
                  <= LENGTH + LENGTH_REL * reach[:, None])
    assert np.all(np.abs(np.asarray(r_sr.opl) - p_sr.opl.numpy())
                  <= LENGTH + LENGTH_REL * reach)
    close(r_pd, p_pd, POWER)
    for f in ("hist", "per_detector", "image"):
        close(getattr(r_det, f), getattr(p_det, f).numpy(), POWER)
    for k in LEDGER:
        close(getattr(r_led, k), getattr(p_led, k).numpy(), POWER)


# ---- whole shared traces --------------------------------------------------

SHARED = {
    # name: (scene, wavelengths, rays, seed, capacity, bounces)
    "coated": (coated_window, WLS, 256, 3, 1024, 8),
    "ar_spectrum": (coated_window, WLS, 400, 5, 1600, 8),
    "mirror_lens": (mirror_lens, [0.45, 0.55, 0.65], 300, 11, 1200, 6),
}
MAPS = dict(hist_azimuth_bins=12, hist_polar_bins=10, image_bins=16,
            image_center=(0, 0, 2.0), image_halfwidth=1.5)
_RUNS = {}


def shared_runs(name):
    """(reference result, port result) of Tracer.trace_spectral, auto
    method, on the same rays; traced once per test run."""
    if name not in _RUNS:
        scene, wls, n, seed, cap, bounces = SHARED[name]
        o, d, p = beam_rays(n, seed)
        rr, pr = both_batches(o, d, p, cap)
        ref = L.Tracer().trace_spectral(None, wls, elements=scene(L),
                                        trace_iterations=bounces, rays=rr,
                                        **MAPS)
        port = P.Tracer(device=CPU).trace_spectral(
            None, wls, elements=scene(P), trace_iterations=bounces, rays=pr,
            **MAPS)
        _RUNS[name] = (ref, port)
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_trace_matches_reference(name):
    ref, port = shared_runs(name)
    assert port.rays_traced == ref.rays_traced  # the same method ran
    for k in LEDGER:
        close(ref.spectral_ledger[k], port.spectral_ledger[k], CLOSES)
        assert port.ledger[k] == pytest.approx(ref.ledger[k], abs=CLOSES)
    # the detector-summed spectrum against the reference's measured column:
    # its own (D, W) spectra add ray by ray in float32 (.at[].add on the
    # CPU) and drift up to 3.5e-6 from it on these scenes, the port's tree
    # sums by < 1e-7; so the spectra and the maps binned the same way are
    # held at REF_DRIFT
    close(ref.spectral_ledger["measured"],
          port.per_detector_spectrum.sum(axis=0), CLOSES)
    close(ref.per_detector_spectrum, port.per_detector_spectrum, REF_DRIFT)
    # (the reference's totals add W drifting columns)
    close(ref.per_detector, port.per_detector, 2 * REF_DRIFT)
    close(port.per_detector, port.per_detector_spectrum.sum(axis=1), 1e-6)
    close(ref.hist, port.hist, REF_DRIFT)
    close(ref.image, port.image, REF_DRIFT)
    assert port.image.sum() > 0.1


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_ledger_closes_per_column(name):
    scene, wls, n, seed, cap, bounces = SHARED[name]
    o, d, p = beam_rays(n, seed)
    _, led, _, sr, _ = PS.trace_spectral(
        scene(P), P.RayBatch.from_arrays(o, d, p, capacity=cap, device=CPU),
        wls, iterations=bounces)
    live = torch.sum(torch.where(sr.alive[:, None], sr.P, 0.0), dim=0)
    close(led.emitted.numpy(), (led.accounted() + live).numpy(), CLOSES)
    assert abs(float(led.emitted.sum()) - 1.0) < 1e-6
    _, port = shared_runs(name)
    assert port.power_conservation_error() < 1e-5
    assert port.final_live_power == pytest.approx(float(live.sum()),
                                                  abs=1e-7)


def test_ar_coating_spectrum_shape():
    _, port = shared_runs("ar_spectrum")
    fwd, back = (port.detector_spectrum(n) for n in ("fwd", "back"))
    # quarter-wave AR designed at 0.55 um: transmission peaks there,
    # residual reflection rises toward the band edges
    assert fwd.argmax() == WLS.index(0.55)
    assert back.argmin() == WLS.index(0.55)
    assert back[0] > back[2] and back[-1] > back[2]


def test_uncoated_columns_equal():
    _, port = shared_runs("mirror_lens")
    s = port.per_detector_spectrum
    assert np.allclose(s[:, 0], s[:, 1], rtol=1e-6)
    assert np.allclose(s[:, 1], s[:, 2], rtol=1e-6)


# ---- whole wavelength-batched traces --------------------------------------

def batched_pair(scene, o, d, p, cap, wls, bounces, seed=None, **kw):
    """(reference, port) returns of trace_spectral_dispersive on the same
    rays; with `seed` the scene draws random numbers and the port is fed
    the reference's own draws of every bounce."""
    rcfg, pcfg = both_cfg(scene(L), **kw)
    rr, pr = both_batches(o, d, p, cap)
    key = None if seed is None else jax.random.key(seed)
    ref = RS.trace_spectral_dispersive(scene(L), rr, wls, cfg=rcfg,
                                       iterations=bounces, key=key)
    draws = None
    if seed is not None:
        slots = len(wls) * cap
        # the cfg as trace_spectral_dispersive resolves it (the has_* flags
        # come from the same elements)
        def draws(i):
            return reference_uniforms(bounce_key(seed, i), pcfg, slots)
    port = PS.trace_spectral_dispersive(scene(P), pr, wls, cfg=pcfg,
                                        iterations=bounces, uniforms=draws)
    return ref, port


BATCHED = {
    "prism": lambda: batched_pair(prism, *prism_rays(128), 512, WL3, 6),
    "grating": lambda: batched_pair(
        grating, np.tile([0.0, 0.0, 2.0], (64, 1)),
        np.tile([0.0, 0.0, -1.0], (64, 1)), np.full(64, 1.0 / 64), 512,
        [0.45, 0.60, 0.75], 3),
    "diffuse_roulette": lambda: batched_pair(
        diffuse_prism, *prism_rays(96, seed=4), 384, WL3, 4, seed=7,
        roulette_threshold=2e-3),
}
_BATCHED = {}


def batched_runs(name):
    if name not in _BATCHED:
        _BATCHED[name] = BATCHED[name]()
    return _BATCHED[name]


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_trace_matches_reference(name):
    (r_pd, r_led, r_names, _, r_det, r_led_w, _), \
        (p_pd, p_led, p_names, _, p_det, p_led_w, _) = batched_runs(name)
    assert p_names == r_names
    close(r_pd, p_pd.numpy(), 2e-6)
    close(r_det.hist, p_det.hist.numpy(), 2e-6)
    for k in LEDGER:
        close(getattr(r_led_w, k), getattr(p_led_w, k).numpy(), REF_SCATTER)
        close(getattr(r_led, k), getattr(p_led, k).numpy(), REF_SCATTER)
    if name == "diffuse_roulette":
        assert float(r_led.measured) > 0.1  # the floor scattered into view


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_ledger_closes_per_column(name):
    _, (per_dw, led, _, rays_out, det, led_w, _) = batched_runs(name)
    wl = rays_out.wavelength.numpy()
    live = np.where(rays_out.alive.numpy(), rays_out.power.numpy(), 0.0)
    grid = np.asarray(WL3 if name != "grating" else [0.45, 0.60, 0.75],
                      np.float32)
    live_w = np.zeros(len(grid))
    np.add.at(live_w, np.abs(wl[:, None] - grid).argmin(1), live)
    acc_w = sum(getattr(led_w, k).numpy() for k in LEDGER[1:])
    close(led_w.emitted.numpy(), acc_w + live_w, CLOSES)
    for k in LEDGER:
        assert float(getattr(led_w, k).sum()) == pytest.approx(
            float(getattr(led, k)), abs=CLOSES)
    # the measured column is the detector-summed spectrum
    close(led_w.measured.numpy(), per_dw.numpy().sum(axis=0), 5e-6)
    assert float(det.hist.sum()) == pytest.approx(float(led.measured),
                                                  abs=1e-5)


# ---- white-light coherent planes ------------------------------------------

_MICHELSON = {}


def michelson_runs(arm):
    """(reference, port) engine results of the white-light Michelson at arm
    offset `arm`: 2,000 rays, 8x capacity, 6 wavelengths."""
    if arm not in _MICHELSON:
        o, d, p = beam_rays(2000, 1, center=(0, 0, -2.0))
        rr, pr = both_batches(o, d, p, 8 * 2000)
        wls = np.linspace(0.45, 0.60, 6)
        kw = dict(trace_iterations=6, **MICHELSON_MAP)
        ref = L.Tracer().trace_spectral(None, wls, elements=michelson(L, arm),
                                        rays=rr, **kw)
        port = P.Tracer(device=CPU).trace_spectral(
            None, wls, elements=michelson(P, arm), rays=pr, **kw)
        _MICHELSON[arm] = (ref, port)
    return _MICHELSON[arm]


@pytest.mark.parametrize("arm", [0.0, 0.25])
def test_white_light_planes_match_reference(arm):
    ref, port = michelson_runs(arm)
    a, b = ref.image_amp_spectral, port.image_amp_spectral
    assert b.shape == (6, 2, 32, 32)
    # OPLs below ~8 may differ by a few float32 ulps between the packages
    close(a, b, field_tol(8.0, a, wavelength=0.45))
    # the planes, not a single cross-wavelength one, are the coherent output
    assert port.image_amp is None
    assert np.array_equal(port.image_coherent,
                          (b[:, 0] ** 2 + b[:, 1] ** 2).sum(axis=0))
    close(ref.image_coherent, port.image_coherent,
          2 * field_tol(8.0, a, wavelength=0.45) * np.abs(a).max() * 6 * 4)
    assert port.detector_power("output") == pytest.approx(0.5, abs=2e-3)


def test_white_light_envelope_falls():
    # 0.25 is half a wave at 0.5 um: the fringes wash out against 0
    i0 = michelson_runs(0.0)[1].image_coherent.sum()
    i1 = michelson_runs(0.25)[1].image_coherent.sum()
    assert i1 < i0


# ---- the engine and the compat facade -------------------------------------

@pytest.mark.parametrize("scene,want", [
    (coated_window, "shared"), (mirror_lens, "shared"), (prism, "batched"),
    (grating, "batched"), (diffuse_prism, "batched"),
    (lambda M: [*M.analytic_plano_convex_lens(0.5, 0.4, 0.05, ior=1.5)],
     "shared")])
def test_auto_dispatch_as_reference(scene, want):
    o, d, p = beam_rays(32, 2)
    wls = [0.45, 0.55]
    res = {}
    for M, tracer in ((L, L.Tracer()), (P, P.Tracer(device=CPU))):
        rays = (L.RayBatch.from_arrays(o, d, p, capacity=128) if M is L else
                P.RayBatch.from_arrays(o, d, p, capacity=128, device=CPU))
        res[M] = tracer.trace_spectral(None, wls, elements=scene(M),
                                       trace_iterations=2, rays=rays)
    geom = 128 * 2 * (1 if want == "shared" else len(wls))
    assert res[P].rays_traced == res[L].rays_traced == geom
    assert res[P].spectral_ledger is not None


def refused_scenes(M):
    oe = M.optical_elements(n_segments=8, n_radial=4)
    disp = oe.cube(material="refractive", ior=1.52)
    disp.dispersion_b = 0.005
    disp_c = oe.cube(material="refractive", ior=1.52)
    disp_c.dispersion_c = 1e-4
    return {
        "dispersion_b": [disp], "dispersion_c": [disp_c],
        "grating": [oe.rectangle(1.0, 1.0, material="grating",
                                 axis=(1, 0, 0), grating_period=1.0)],
        "polarizer": [oe.disc(radius=1.0, material="polarizer",
                              axis=(1, 0, 0))],
        "waveplate": [oe.disc(radius=1.0, material="waveplate",
                              axis=(1, 0, 0), retardance=1.0)],
        "diffuse": [oe.disc(radius=1.0, material="diffuse")],
        "birefringent": [oe.cube(material="birefringent", ior=1.5,
                                 ne=1.6, axis=(0, 0, 1))],
        "scattering": [oe.cube(material="refractive", ior=1.2,
                               scattering=1.0)],
        "grin": [oe.cube(material="refractive", ior=1.6, grin_a=4.0,
                         axis=(0, 0, 1), grin_center=(0, 0, 0))],
        "fluorescence": [oe.cube(material="refractive", ior=1.2,
                                 fluorescence=2.0, fluor_emission=0.6,
                                 fluor_edge=0.5)],
    }


@pytest.mark.parametrize("case", sorted(refused_scenes(L)))
def test_validate_refusals_as_reference(case):
    msgs = []
    for M, mod in ((L, RS), (P, PS)):
        with pytest.raises(ValueError) as e:
            mod.validate_spectral_scene(refused_scenes(M)[case])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def engine_refusal(M, **kw):
    """The message of the ValueError Tracer.trace_spectral raises."""
    o, d, p = beam_rays(16, 1)
    if M is L:
        tracer, rays = L.Tracer(), L.RayBatch.from_arrays(o, d, p)
    else:
        tracer = P.Tracer(device=CPU)
        rays = P.RayBatch.from_arrays(o, d, p, device=CPU)
    els = kw.pop("els", None) or coated_window(M)
    with pytest.raises(ValueError) as e:
        tracer.trace_spectral(None, WL3, elements=els, rays=rays,
                              trace_iterations=2, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["coherent_shared", "coherent_no_image",
                                  "fluorescence", "method", "host_mode",
                                  "host_mode_batched"])
def test_engine_refusals_as_reference(case):
    def kw(M):
        return {
            "coherent_shared": dict(method="shared", **MICHELSON_MAP),
            "coherent_no_image": dict(coherent=True),
            "fluorescence": dict(els=refused_scenes(M)["fluorescence"]),
            "method": dict(method="fast"),
            "host_mode": dict(mode="host"),
            "host_mode_batched": dict(mode="host", els=prism(M)),
        }[case]

    assert engine_refusal(P, **kw(P)) == engine_refusal(L, **kw(L))


def test_multi_device_raises_naming_a7():
    """The multi-device spectral paths are ported (the name stays from
    when they raised). On the port's one-rank group (started in this
    process) against the reference's 8 virtual devices: the engine's
    multichip mode and the module's trace_spectral_multichip give the
    reference's spectra and ledger; a mesh= that is no mesh is not read in
    device mode (either package), so that run equals the plain one bit for
    bit; trace_spectral_dispersive reads its mesh and raises the
    reference's AttributeError on one that is no mesh."""
    o, d, p = beam_rays(64, 1)
    rr, pr = both_batches(o, d, p, 256)
    port_tr = P.Tracer(device=CPU)
    plain = port_tr.trace_spectral(None, WL3, elements=coated_window(P),
                                   rays=pr, trace_iterations=6)
    for kw in (dict(mode="multichip"), dict(mesh=object())):
        port = port_tr.trace_spectral(None, WL3, elements=coated_window(P),
                                      rays=pr, trace_iterations=6, **kw)
        ref = L.Tracer().trace_spectral(None, WL3, elements=coated_window(L),
                                        rays=rr, trace_iterations=6, **kw)
        for k in LEDGER:
            close(ref.spectral_ledger[k], port.spectral_ledger[k], CLOSES)
        close(ref.per_detector_spectrum, port.per_detector_spectrum,
              REF_DRIFT)
        close(ref.hist, port.hist, REF_DRIFT)
        assert port.final_live_power == pytest.approx(ref.final_live_power,
                                                      abs=CLOSES)
        if "mesh" in kw:
            assert np.array_equal(port.per_detector_spectrum,
                                  plain.per_detector_spectrum)
            assert port.ledger == plain.ledger
    with pytest.raises(AttributeError):
        PS.trace_spectral_dispersive(prism(P), pr, WL3, mesh=object())
    with pytest.raises(AttributeError):
        RS.trace_spectral_dispersive(prism(L), rr, WL3, mesh=object())
    per_det, led, names, _, _ = PS.trace_spectral_multichip(
        coated_window(P), pr, WL3, iterations=6)
    r_per_det, r_led, r_names, _, _ = RS.trace_spectral_multichip(
        coated_window(L), rr, WL3, iterations=6)
    assert names == r_names
    close(r_per_det, per_det.numpy(), REF_DRIFT)
    for k in LEDGER:
        close(getattr(r_led, k), getattr(led, k).numpy(), CLOSES)


def test_compat_wavelengths_equals_trace_spectral():
    src = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                             diameter=0.5, ray_count=200, power=1.0, seed=3)
    tracer = CL_Tracer(device=CPU)
    res = tracer.iterative_tracer(src, coated_window(P), trace_iterations=8,
                                  wavelengths=WLS, capacity=800,
                                  power_dissipated=0.5)
    want = P.Tracer(device=CPU).trace_spectral(
        src, WLS, elements=coated_window(P), trace_iterations=8,
        capacity=800)
    assert np.array_equal(res.per_detector_spectrum,
                          want.per_detector_spectrum)
    assert res.ledger == want.ledger
    assert res.detector_spectrum("back").argmin() == WLS.index(0.55)
    assert tracer.get_power_ledger()["measured"] > 0.9
    w = np.array([0.1, 0.2, 0.3, 0.2, 0.2])
    res_w = tracer.iterative_tracer(src, coated_window(P), trace_iterations=8,
                                    wavelengths=WLS, spectral_weights=w,
                                    capacity=800)
    close(res_w.spectral_ledger["emitted"], w, 1e-6)
    with pytest.raises(KeyError):
        res.detector_spectrum("nope")
    with pytest.raises(ValueError, match="not a spectral run"):
        P.Tracer(device=CPU).trace(src, coated_window(P),
                                   trace_iterations=2).detector_spectrum("fwd")


def test_repeat_runs_bit_identical():
    """Shared and batched (random floor, roulette, generator draws) runs
    repeat bit for bit."""
    def run(scene, **kw):
        o, d, p = prism_rays(64)
        return P.Tracer(device=CPU).trace_spectral(
            None, WL3, elements=scene(P), trace_iterations=4,
            rays=P.RayBatch.from_arrays(o, d, p, capacity=256, device=CPU),
            **kw)

    for scene, kw in ((coated_window, {}),
                      (diffuse_prism, dict(roulette_threshold=2e-3, seed=5))):
        a, b = run(scene, **kw), run(scene, **kw)
        assert a.ledger == b.ledger
        for f in ("per_detector_spectrum", "hist", "image"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        for k in LEDGER:
            assert np.array_equal(a.spectral_ledger[k],
                                  b.spectral_ledger[k]), k
    c = run(diffuse_prism, roulette_threshold=2e-3, seed=6)
    assert not np.array_equal(c.hist, a.hist)  # another seed, other draws


def test_spread_rays_lanes():
    o = np.random.default_rng(0).normal(size=(8, 3))
    rays = P.RayBatch.from_arrays(o, np.tile([0, 0, 1.0], (8, 1)),
                                  np.ones(8), device=CPU)
    big = PS.spread_rays_over_wavelengths(rays, [0.4, 0.6],
                                          torch.tensor([0.25, 0.75]))
    ref = RS.spread_rays_over_wavelengths(
        L.RayBatch.from_arrays(o, np.tile([0, 0, 1.0], (8, 1)), np.ones(8)),
        [0.4, 0.6], jnp.asarray([0.25, 0.75]))
    assert big.capacity == 16
    for f in L.RayBatch._fields:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(big, f).numpy()), f
