"""The shared spectral step's culled launch in octant, then Morton order
(lightpycl_tpu_torch.tracer.step.intersect_bounce with slot_order, as
spectral.spectral_step calls it) on the CPU, where the nearest hit is the
plain version with the cull mask.

* Launched by direction octant, then in the Morton order of the rays'
  origins, and scattered back, (t, tri) equal the slot-order launch's bit
  for bit, at the first bounce and at later ones (split, compacted rays),
  and that order keeps no more (block, tile) pairs of the mask than the
  slot order; a split bounce launches its live rays grouped by octant.
* Whole shared traces with the cull on and off, on the same scene, give the
  same bits in every spectrum, map, ledger column and live ray: the order
  of the launch changes nothing downstream (merge_analytic, the split and
  the top-k stay in slot order).
* The permutation is step.morton_order's over the scene's cull frame
  (shared with the scalar step's reorder), and with the cull off the rays
  launch in slot order.

test_torch_spectral.py holds the same traces against the JAX package."""

import numpy as np
import pytest
import torch

import lightpycl_tpu_torch as P
from lightpycl_tpu_torch import spectral as PS
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.tracer import step as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
WLS = [0.45, 0.55, 0.65]
N_RAYS = 1024


def coated_scene():
    """A two-layer coated window at an angle, a measuring disc behind it
    and one in front, a terminating shell: rays split, reflect and
    scatter over the scene, so later bounces mix the slots."""
    oe = P.optical_elements(n_segments=32, n_radial=12)
    win = oe.cube(size=(1.0, 1.0, 0.2), material="refractive", ior=1.52,
                  coating=[(1.38, 0.1), (2.1, 0.06)], name="win")
    win.rotate((1, 0, 0), 0.4, pivot=(0, 0, 0))
    return [win,
            oe.disc(radius=1.5, center=(0, 0, 2.0), material="measure",
                    name="fwd"),
            oe.disc(radius=1.5, center=(0, 0, -2.0), material="measure",
                    name="back"),
            oe.sphere(radius=8.0, material="terminator")]


def source_rays(seed=3):
    """The collimated beam at twice its capacity, as a RayBatch."""
    o, d, p = P.CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                                 diameter=0.8, ray_count=N_RAYS, power=1.0,
                                 seed=seed).sample()
    return P.RayBatch.from_arrays(o, d, p, capacity=2 * N_RAYS, device=CPU)


def start(seed=3):
    """(cfg with the cull on, scene sorted for it, wavelengths, the first
    bounce's SpectralRays)."""
    cfg, scene, names, wl, w = PS._resolve_spectral(
        coated_scene(), P.TraceConfig(cull=True), WLS, None, CPU)
    return (cfg, scene, names, wl,
            PS.SpectralRays.from_batch(source_rays(seed), w))


def after(bounces):
    """The state `bounces` culled steps into the trace."""
    cfg, scene, names, wl, sr = start()
    if bounces:
        sr, _, _, _ = PS.trace_spectral_loop(scene, sr, wl, cfg, bounces,
                                             len(names))
    return cfg, scene, sr


def launch_order(scene, sr):
    """The culled launch's slot permutation: octant, then Morton order over
    the box of the scene's cull frame."""
    frame = PI.cull_frame(scene)
    return S.morton_order(sr.o, sr.d, sr.alive, frame.lo, frame.hi)


def kept(scene, o, d, alive, cfg):
    """(ray, triangle) pairs in the (block, tile) pairs the mask keeps."""
    words = PI.block_tile_mask(PI.cull_frame(scene), o, d, cfg.max_ray_len,
                               alive=alive)
    bits = np.unpackbits(words.numpy().view(np.uint8), bitorder="little")
    return int(bits.sum()) * PI.RAY_BLOCK * PI.TRI_TILE


@pytest.mark.parametrize("bounces", [0, 1, 3])
def test_morton_launch_scattered_back_equals_slot_order(bounces):
    cfg, scene, sr = after(bounces)
    assert int(sr.alive.sum()) > 100
    _, t, tri = S.intersect_bounce(scene, sr, cfg, slot_order=True)
    t0, tri0 = PI.intersect(scene, sr.o, sr.d, cfg, alive=sr.alive)
    tb, trib = PI.intersect(scene, sr.o, sr.d, cfg.replace(cull=False),
                            alive=sr.alive)
    # every live ray (a dead one's result is the mask's business: the mask
    # is built from the live rays only, and the step never reads it)
    a = sr.alive
    for x, y in ((t, t0), (t, tb)):
        assert torch.equal(x[a].view(torch.int32), y[a].view(torch.int32))
    assert torch.equal(tri[a], tri0[a]) and torch.equal(tri[a], trib[a])
    assert int((a & (tri >= 0)).sum()) > 50  # hits to compare
    perm = launch_order(scene, sr)
    k_morton = kept(scene, sr.o[perm], sr.d[perm], sr.alive[perm], cfg)
    k_slot = kept(scene, sr.o, sr.d, sr.alive, cfg)
    assert 0 < k_morton <= k_slot


def test_the_launch_is_morton_ordered_only_under_cull(monkeypatch):
    cfg, scene, sr = after(1)
    seen = []
    monkeypatch.setattr(PI.intersect, "observer",
                        lambda sc, o, d, c, alive, mask: seen.append(
                            (o.clone(), d.clone(), alive.clone(), mask)))
    S.intersect_bounce(scene, sr, cfg, slot_order=True)
    S.intersect_bounce(scene, sr, cfg.replace(cull=False), slot_order=True)
    perm = launch_order(scene, sr)
    (o_cull, d_cull, a_cull, mask_cull), (o_brute, _, _, mask_brute) = seen
    assert torch.equal(o_cull, sr.o[perm]) and mask_cull is not None
    assert torch.equal(o_brute, sr.o) and mask_brute is None
    assert not torch.equal(perm, torch.arange(len(perm)))
    # the split bounce's live rays launch grouped by direction octant
    # (bit k: d[:, k] < 0), split children in more than one
    neg = (d_cull[a_cull] < 0).long()
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    assert bool((octant[1:] >= octant[:-1]).all())
    assert len(torch.unique(octant)) > 1


def test_whole_trace_culled_equals_brute_bit_for_bit():
    cfg, scene, names, wl, sr = start(seed=5)
    out = {}
    for cull in (True, False):
        out[cull] = PS.trace_spectral_loop(scene, sr, wl,
                                           cfg.replace(cull=cull), 6,
                                           len(names))
    (sr_c, det_c, pd_c, led_c), (sr_b, det_b, pd_b, led_b) = out[True], \
        out[False]
    for a, b in ((det_c, det_b), (led_c, led_b)):
        for x, y in zip(a, b):
            assert x is None and y is None or torch.equal(x, y)
    assert torch.equal(pd_c, pd_b)
    assert float(pd_c.sum()) > 0.1
    # the rays still live, field by field
    assert torch.equal(sr_c.alive, sr_b.alive) and int(sr_c.alive.sum()) > 0
    for x, y in zip(sr_c, sr_b):
        assert torch.equal(x[sr_c.alive], y[sr_c.alive])


@pytest.mark.parametrize("method", ["shared", "batched"])
def test_culled_spectral_loops_build_the_frame_once(monkeypatch, method):
    """The shared loop (`trace_spectral_loop`) and the wavelength-batched
    one (`_dispersive_loop`) build the scene's cull frame once for 4
    culled bounces, and launch every bounce with a mask from it."""
    calls, masks = [], []
    build = PI.cull_frame

    def counted(scene):
        calls.append(scene)
        return build(scene)

    for mod in (PI, S, PS):
        monkeypatch.setattr(mod, "cull_frame", counted)
    monkeypatch.setattr(PI.intersect, "observer",
                        lambda sc, o, d, c, alive, mask: masks.append(mask))
    if method == "shared":
        cfg, scene, names, wl, sr = start()
        PS.trace_spectral_loop(scene, sr, wl, cfg, 4, len(names))
    else:
        PS.trace_spectral_dispersive(coated_scene(), source_rays(), WLS,
                                     cfg=P.TraceConfig(cull=True),
                                     iterations=4)
    assert len(calls) == 1
    assert len(masks) == 4 and all(m is not None for m in masks)
