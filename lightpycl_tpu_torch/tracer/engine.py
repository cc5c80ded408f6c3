"""Host-side trace driver.

Port counterpart of lightpycl_tpu/tracer/engine.py: `TraceResult` (with the
coherent / flux / time maps and the per-batch statistics) and `Tracer` with
`set_elements`, `trace` in every mode of the reference (with its
`iterative_tracer` alias and `profile_logdir`, a torch.profiler trace),
`trace_batched`, `trace_spectral`, the cfg resolution and checks
(`_resolve_ray_len`, `_resolve_cull`, `_tune_splitting`, the has-flag
resolution of `_check_polarization`, `_check_flux_map`,
`_check_time_bins`), `_package` and `get_surface_flux`.

  * 'device': the multi-bounce loop runs on the device with one host sync
    after each bounce but the last (the early-exit test); detector
    histogram and ledger come back, individual measured rays do not.
  * 'host': the same steps, harvesting measured rays (and optionally ray
    segments) after every bounce: the reference's per-iteration semantics.
  * 'multichip': the rays shard over the "rays" axis of a torch DeviceMesh
    (`mesh=`, default every rank of the process group; a one-rank group is
    started when there is none) with the scene on every rank, and the
    detector state and ledger are summed over the axis
    (parallel/sharding.py).
  * 'mesh2d': the triangles also shard, over the "tris" axis of a
    ("tris", "rays") mesh (`mesh=make_mesh2d(n_tris, n_rays)`, required;
    parallel/mesh2d.py).
  * `trace_batched`: the mega-batch entry point; each batch is sampled on the
    device from a generator that depends only on (seed, batch), traced in
    device (or a sharded) mode, and summed into float64 host accumulators,
    with an optional checkpoint after every batch.

The sharded modes are SPMD by launch: every rank calls the same method with
the same arguments, and every rank returns the same TraceResult (its maps,
ledger and live power are summed over the mesh). The tracer's device must
be its rank's (`parallel.distributed.check_device`).

The tracer runs on an explicit `device` (default CUDA; the CPU only when
asked for). Every scene the reference's `trace` accepts is accepted here
(polarized, coated, metallic, diffracting, birefringent, diffuse, rough,
turbid, fluorescent, gradient-index and analytic elements, path tracking
in host mode), with the reference's refusals in mesh2d mode, and
`trace_spectral` (the shared-geometry and wavelength-batched methods of
spectral.py, device and multichip modes) accepts every scene the
reference's does. The reference's own quirks in `_resolve_ray_len` (an
explicit max_ray_len equal to the default counts as unset; the reach
includes dead padding slots' origins) are reproduced, not fixed.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from lightpycl_tpu_torch import analysis
from lightpycl_tpu_torch.geometry.mesh import GeoObject
from lightpycl_tpu_torch.io import checkpoint
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.parallel import distributed as pdist
from lightpycl_tpu_torch.parallel import mesh2d as mesh2d_mod
from lightpycl_tpu_torch.parallel import sharding
from lightpycl_tpu_torch.tracer import step as step_mod
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene, build_scene
from lightpycl_tpu_torch.utils.profiling import span, spanned, trace_profile

log = logging.getLogger("lightpycl_tpu_torch")

# DetectorState field -> its float64 accumulator's key in a trace_batched
# checkpoint (the reference's names, so either package resumes the other's)
_CKPT_KEYS = {"hist": "hist64", "per_detector": "per_det64",
              "image": "image64", "image_amp": "image_amp64",
              "tri_flux": "tri_flux64", "time_hist": "time64"}


def _check_replicated_scene(cfg: TraceConfig, mode: str,
                            modes: str) -> None:
    """The reference's mesh2d refusal: these scenes index tables by element,
    not by the sharded triangle columns."""
    if (cfg.has_fluorescence or cfg.has_grin
            or cfg.has_analytic) and mode == "mesh2d":
        raise ValueError(
            "fluorescent/GRIN/analytic-surface scenes need the scene "
            "replicated (their tables index by element, not by sharded "
            f"triangle column): use mode={modes}, not 'mesh2d'")


def _check_coherent(cfg: TraceConfig) -> None:
    if cfg.coherent and cfg.image_bins == 0:
        raise ValueError(
            "coherent=True accumulates the complex field on the image "
            "plane: set image_bins (and image_center/image_normal/"
            "image_halfwidth) too")


def _check_fluorescence(cfg: TraceConfig) -> None:
    if cfg.has_fluorescence and cfg.coherent:
        raise ValueError(
            "coherent field accumulation is undefined for "
            "fluorescence-converted light (spontaneous emission "
            "is incoherent with the source): disable coherent=True "
            "or remove the fluorescent element")


def _opl_edges(cfg: TraceConfig):
    """(time_bins + 1,) OPL bin edges of a time-resolved trace, else None."""
    if cfg.time_bins <= 0:
        return None
    return np.linspace(cfg.opl_min, cfg.opl_max, cfg.time_bins + 1)


def _no_measured_rays():
    """The eight empty measured-ray columns of a trace without a harvest."""
    return [np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0,), np.float32), np.zeros((0,), np.int32),
            np.zeros((0,), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0,), np.float32), np.zeros((0,), np.float32)]


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass
class TraceResult:
    """Everything a reference user gets after iterative_tracer(...)."""

    measured_pos: np.ndarray      # (M, 3) hit points on measure surfaces
    measured_dir: np.ndarray      # (M, 3) arrival directions
    measured_power: np.ndarray    # (M,)
    measured_det: np.ndarray      # (M,) detector ids
    measured_wavelength: np.ndarray  # (M,) vacuum wavelengths [um]
    measured_stokes: np.ndarray   # (M, 3) Stokes fractions
    measured_opl: np.ndarray      # (M,) optical path lengths
    measured_path: np.ndarray     # (M,) path signatures
    hist: np.ndarray              # (n_az, n_pol) power histogram
    per_detector: np.ndarray      # (D,)
    image: np.ndarray             # (image_bins, image_bins) planar map
    detector_names: list
    ledger: dict                  # emitted/measured/absorbed/escaped/culled
    iterations_run: int
    rays_traced: int              # capacity x iterations actually traced
    intersection_tests: int       # rays_traced x real triangle count
    wall_time: float
    segments: list                # [(starts, ends, alive)] if record_paths
    final_live_power: float
    # spectral runs only (Tracer.trace_spectral); None on scalar traces
    per_detector_spectrum: Optional[np.ndarray] = None  # (D, W)
    wavelengths: Optional[np.ndarray] = None            # (W,) [um]
    spectral_ledger: Optional[dict] = None  # each entry (W,) per-lambda
    # coherent runs only (TraceConfig.coherent): (2, nb, nb) re/im field
    # amplitude sums over measured rays
    image_amp: Optional[np.ndarray] = None
    # coherent spectral runs: (W, 2, nb, nb) per-wavelength field planes
    # (each wavelength interferes only with itself)
    image_amp_spectral: Optional[np.ndarray] = None
    # flux-map runs only: (T,) incident power per scene triangle, T the real
    # triangle count in scene order (spatially sorted when cull is on)
    tri_flux: Optional[np.ndarray] = None
    # time-resolved runs only: (D, nt) measured power by arrival optical
    # path length and the (nt + 1,) OPL bin edges (t = OPL / c)
    time_hist: Optional[np.ndarray] = None
    opl_edges: Optional[np.ndarray] = None
    # trace_batched runs only: (B, D) measured power per batch per detector
    per_batch_detector: Optional[np.ndarray] = None
    # trace_batched runs only: (B, 5) float64 ledger per batch, in Ledger
    # field order (emitted, measured, absorbed, escaped, culled); each
    # batch books the power still live at its end as culled. None when
    # resumed from a checkpoint that holds no such rows
    per_batch_ledger: Optional[np.ndarray] = None
    # trace_batched runs with an image only: (B, nb, nb) float64 image of
    # each batch, from the same readback (B x nb^2 float64 on the host).
    # None without an image, and when resumed from a checkpoint that holds
    # no such rows
    per_batch_image: Optional[np.ndarray] = None
    device: str = ""              # torch device the trace ran on

    @property
    def tests_per_second(self) -> float:
        return self.intersection_tests / max(self.wall_time, 1e-12)

    @property
    def rays_per_second(self) -> float:
        return self.rays_traced / max(self.wall_time, 1e-12)

    def measured_rays_for(self, name: str):
        """(positions, directions, powers) of measured rays on the named
        detector only (host-mode traces)."""
        if name not in self.detector_names:
            raise KeyError(f"unknown detector {name!r}; have {self.detector_names}")
        sel = self.measured_det == self.detector_names.index(name)
        return self.measured_pos[sel], self.measured_dir[sel], self.measured_power[sel]

    def detector_power(self, name: str) -> float:
        """Total measured power on the named measure surface."""
        if name not in self.detector_names:
            raise KeyError(f"unknown detector {name!r}; have {self.detector_names}")
        return float(self.per_detector[self.detector_names.index(name)])

    def detector_spectrum(self, name: str) -> np.ndarray:
        """(W,) per-wavelength measured power on the named detector
        (spectral runs only: Tracer.trace_spectral)."""
        if self.per_detector_spectrum is None:
            raise ValueError("not a spectral run: use Tracer.trace_spectral"
                             " (or iterative_tracer(..., wavelengths=...))")
        if name not in self.detector_names:
            raise KeyError(f"unknown detector {name!r}; have {self.detector_names}")
        return self.per_detector_spectrum[self.detector_names.index(name)]

    def detector_stderr(self, name: str) -> float:
        """Monte-Carlo standard error of detector_power(name) from the
        scatter of the per-batch totals (trace_batched runs with >= 2
        batches): SE(sum_b m_b) = sqrt(B) * std(m_b, ddof=1)."""
        if self.per_batch_detector is None:
            raise ValueError(
                "no per-batch statistics: run Tracer.trace_batched "
                "(single traces have no independent replicas to measure "
                "spread from)")
        if name not in self.detector_names:
            raise KeyError(f"unknown detector {name!r}; have {self.detector_names}")
        m = self.per_batch_detector[:, self.detector_names.index(name)]
        B = m.shape[0]
        if B < 2:
            raise ValueError(
                f"need >= 2 batches for a spread estimate, have {B}")
        return float(np.sqrt(B) * np.std(m, ddof=1))

    def detector_time_histogram(self, name: str):
        """(opl_edges (nt+1,), power (nt,)) time-of-flight histogram of the
        named detector (TraceConfig.time_bins runs)."""
        if self.time_hist is None:
            raise ValueError("not a time-resolved trace: set "
                             "TraceConfig(time_bins=..., opl_min=..., "
                             "opl_max=...)")
        if name not in self.detector_names:
            raise KeyError(f"unknown detector {name!r}; have {self.detector_names}")
        return self.opl_edges, self.time_hist[self.detector_names.index(name)]

    def power_conservation_error(self) -> float:
        l = self.ledger
        acc = l["measured"] + l["absorbed"] + l["escaped"] + l["culled"]
        return abs(l["emitted"] - acc - self.final_live_power) / max(l["emitted"], 1e-30)

    @property
    def image_complex(self) -> np.ndarray:
        """(nb, nb) complex field on the image plane (coherent runs)."""
        if self.image_amp is None:
            raise ValueError("not a coherent trace: set "
                             "TraceConfig(coherent=True, image_bins=...)")
        return self.image_amp[0] + 1j * self.image_amp[1]

    @property
    def image_coherent(self) -> np.ndarray:
        """(nb, nb) interference intensity per pixel, the fringe pattern
        (`image` stays the incoherent sum): |sum_rays sqrt(P) e^{i phi}|^2,
        or on a spectral run the per-wavelength intensities summed
        (wavelengths are mutually incoherent: the white-light pattern)."""
        if self.image_amp_spectral is not None:
            a = self.image_amp_spectral
            return (a[:, 0] ** 2 + a[:, 1] ** 2).sum(axis=0)
        a = self.image_complex
        return a.real ** 2 + a.imag ** 2


class Tracer:
    """Trace session on one torch device (default CUDA)."""

    def __init__(self, cfg: Optional[TraceConfig] = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or TraceConfig()
        self.device = resolve_device(device)
        self.scene: Optional[Scene] = None
        self.detector_names: list = []
        self.elements: list = []
        self.last_result: Optional[TraceResult] = None
        self._has_refractive = True  # until a scene says otherwise
        self._scene_sorted = False

    # -- scene -------------------------------------------------------------

    def set_elements(self, elements: Sequence[GeoObject],
                     spatial_sort: Optional[bool] = None):
        self.elements = list(elements)
        if spatial_sort is None:
            spatial_sort = bool(self.cfg.cull)
        self.scene, self.detector_names = build_scene(
            self.elements, spatial_sort=spatial_sort, device=self.device)
        self._scene_sorted = spatial_sort
        # "needs the 2C split buffer": dielectric/beamsplitter splits,
        # dual-order gratings and rough mirrors
        self._has_refractive = any(
            e.material in (Material.REFRACTIVE, Material.BEAMSPLITTER,
                           Material.BIREFRINGENT)
            or (e.material == Material.GRATING
                and getattr(e, "order0_fraction", 0.0) > 0.0)
            or getattr(e, "roughness", 0.0) > 0.0
            for e in self.elements
        )
        return self

    @property
    def num_triangles(self) -> int:
        return sum(e.num_triangles for e in self.elements)

    # -- tracing -------------------------------------------------------------

    @spanned("engine.call")
    def trace(self, source, elements: Optional[Sequence[GeoObject]] = None,
              trace_iterations: Optional[int] = None,
              capacity: Optional[int] = None, mode: str = "host",
              record_paths: bool = False, rays: Optional[RayBatch] = None,
              profile_logdir: Optional[str] = None, mesh=None,
              **cfg_overrides) -> TraceResult:
        """Run the iterative trace.

        `source` is a LightSource / CollimatedSource / AreaSource (or None
        if `rays` is given). Remaining kwargs override TraceConfig fields,
        mirroring the reference's iterative_tracer(...) signature.

        mode="multichip" shards the ray batch over the "rays" axis of
        `mesh` (a 1-D torch DeviceMesh; default every rank of the process
        group) with the scene replicated, and sums the detector state and
        ledger over it: every rank returns the same TraceResult, equal to a
        single-device run's up to the order of the sums. mode="mesh2d" also
        shards the TRIANGLES over the "tris" axis of a ("tris", "rays")
        mesh (`mesh=make_mesh2d(n_tris, n_rays)`, required). Both run the
        fixed depth (a shard stops when its rays are all dead);
        measured-ray lists and record_paths need mode="host"."""
        if mode not in ("host", "device", "multichip", "mesh2d"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        if trace_iterations is not None:
            cfg_overrides["trace_iterations"] = int(trace_iterations)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        if elements is not None:
            self.set_elements(elements)
        if self.scene is None:
            raise ValueError("no scene: pass `elements` or call set_elements()")
        _check_coherent(cfg)
        if cfg.track_paths:
            if mode != "host":
                raise ValueError(
                    "track_paths=True needs mode='host': the measured-ray "
                    "harvest is what carries the path signatures out")
            if cfg.path_base == 0:
                cfg = cfg.replace(path_base=2 * len(self.elements) + 1)
        cfg = self._tune_splitting(cfg)
        cfg = self._check_polarization(cfg)
        _check_replicated_scene(cfg, mode, "'host'/'device'/'multichip'")
        self._check_flux_map(cfg, mode)
        self._check_time_bins(cfg)
        _check_fluorescence(cfg)
        if rays is None:
            with span("engine.sample"):
                origins, dirs, powers = source.sample()
                wls = (source.sample_wavelengths()
                       if hasattr(source, "sample_wavelengths") else None)
                rays = RayBatch.from_arrays(
                    origins, dirs, powers, ior_env=cfg.ior_env,
                    capacity=capacity, wavelengths=wls,
                    stokes=getattr(source, "stokes", None),
                    device=self.device)
        with span("engine.resolve_ray_len"):
            cfg = self._resolve_ray_len(cfg, origins=rays.o.cpu().numpy())
        with span("engine.resolve_cull"):
            cfg = self._resolve_cull(cfg, mode, rays=rays)
        if cfg.cull and not self._scene_sorted:
            # spatially-sorted triangle tiles are what make the cull bite
            self.set_elements(self.elements, spatial_sort=True)
        if mode in ("multichip", "mesh2d"):
            mesh, n_ray_ranks = self._prepare_mesh(mode, mesh)
            rays = sharding.padded_for(rays, n_ray_ranks)
        C = rays.capacity
        emitted = float(torch.sum(torch.where(rays.alive, rays.power, 0.0)))
        det = self._detector_zeros(cfg)
        led = Ledger.start(emitted, device=self.device)
        if log.isEnabledFor(logging.INFO):  # the count reads the device
            log.info(
                "trace start: %d rays (capacity %d), %d triangles, %d "
                "iterations, mode=%s, device=%s", int(rays.alive.sum()), C,
                self.num_triangles, cfg.trace_iterations, mode, self.device)
        with trace_profile(profile_logdir):
            result = self._run(mode, rays, det, led, cfg, C, emitted,
                               record_paths, mesh=mesh)
        self.last_result = result
        log.info(
            "trace done: %.3fs, %.3g intersection tests/s, %.3g rays/s",
            result.wall_time, result.tests_per_second, result.rays_per_second)
        return result

    @spanned("engine.call")
    def trace_spectral(self, source, wavelengths, elements=None,
                       weights=None, trace_iterations=None,
                       capacity=None, mode: str = "device", mesh=None,
                       rays=None, method: str = "auto",
                       **cfg_overrides) -> TraceResult:
        """Spectral trace: the TraceResult has the angular histogram,
        per-detector totals, planar image and ledger of a scalar trace,
        plus `per_detector_spectrum` (D, W), `wavelengths` and the
        per-wavelength `spectral_ledger`. `weights` split each ray's power
        over the wavelengths (default uniform).

        `method`:
          * 'shared': ONE geometry pass carries W spectral samples per ray
            (spectral.trace_spectral). Needs achromatic geometry (no
            dispersive glass, gratings, polarization optics, diffuse).
          * 'batched': every wavelength gets a stamped copy of the rays and
            one trace of W x C rays runs the full scalar physics
            (spectral.trace_spectral_dispersive).
          * 'auto' (default): 'shared' where the scene qualifies, else
            'batched'. Coherent runs always take 'batched' (one field plane
            a wavelength).

        mode="multichip" shards the rays over a 1-D "rays" mesh exactly
        like Tracer.trace(mode="multichip"): for 'shared' the spectral rows
        shard, for 'batched' the wavelength-flattened W x C batch (round-
        robin interleaved; detector, spectra and ledger summed over the
        axis). rays_traced / intersection_tests count geometry passes: once
        for 'shared', W-fold for 'batched'."""
        from lightpycl_tpu_torch import spectral as spectral_mod

        cfg = self.cfg
        if trace_iterations is not None:
            cfg_overrides["trace_iterations"] = int(trace_iterations)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        if elements is not None:
            self.set_elements(elements)
        if self.scene is None:
            raise ValueError("no scene: pass `elements` or call set_elements()")
        if cfg.coherent:
            if cfg.image_bins == 0:
                raise ValueError(
                    "coherent=True accumulates the complex field on the "
                    "image plane: set image_bins too")
            if method == "shared":
                raise ValueError(
                    "coherent spectral tracing needs the wavelength-BATCHED "
                    "method (per-lambda field planes); use method='batched' "
                    "or 'auto'")
            method = "batched"
        if rays is None:
            with span("engine.sample"):
                origins, dirs, powers = source.sample()
                # a source's own spectrum would be overridden by the grid
                wl_attr = getattr(source, "wavelength", None)
                if isinstance(wl_attr, (tuple, list, np.ndarray)):
                    log.warning("trace_spectral ignores the source's own "
                                "wavelength spectrum; the `wavelengths` grid "
                                "+ `weights` define the spectral sampling")
                rays = RayBatch.from_arrays(origins, dirs, powers,
                                            ior_env=cfg.ior_env,
                                            capacity=capacity,
                                            device=self.device)
        if method not in ("auto", "shared", "batched"):
            raise ValueError(f"trace_spectral method must be 'auto', "
                             f"'shared' or 'batched', got {method!r}")
        with span("engine.resolve_ray_len"):
            cfg = self._resolve_ray_len(cfg, origins=rays.o.cpu().numpy())
        with span("engine.resolve_cull"):
            cfg = self._resolve_cull(cfg, mode, rays=rays)
        # flux and time maps are wavelength-integrated: the shared path
        # deposits row-total power, the batched path runs the scalar maps
        self._check_flux_map(cfg, mode)
        self._check_time_bins(cfg)
        if any(getattr(e, "fluorescence", 0.0) > 0.0 for e in self.elements):
            raise ValueError(
                "trace_spectral assumes wavelengths are conserved, but the "
                "scene fluoresces (conversion rewrites the carried "
                "wavelength, so per-lambda columns cannot close). Trace "
                "scalar with the source's wavelength instead: the measured-"
                "ray harvest carries per-ray wavelengths and "
                "analysis.spectral_power / cie_xyz bin the output spectrum")
        if method == "auto":
            try:
                spectral_mod.validate_spectral_scene(self.elements)
                method = "shared"
            except ValueError:
                method = "batched"
        if mode not in ("device", "multichip"):
            what = ("trace_spectral(method='batched') mode"
                    if method == "batched" else "trace_spectral mode")
            raise ValueError(f"{what} must be 'device' or 'multichip', "
                             f"got {mode!r}")
        mesh = (self._prepare_mesh(mode, mesh)[0] if mode == "multichip"
                else None)
        C = rays.capacity
        W = len(np.atleast_1d(np.asarray(wavelengths)))
        emitted_rows = float(torch.sum(torch.where(rays.alive, rays.power,
                                                   0.0)))
        log.info("spectral trace start: capacity %d, %d wavelengths, "
                 "%d triangles, %d iterations, device=%s, method=%s", C, W,
                 self.num_triangles, cfg.trace_iterations, self.device,
                 method)
        self._sync()
        t0 = time.perf_counter()
        if method == "batched":
            cfg_b = self._check_polarization(self._tune_splitting(cfg))
            per_det, led, det_names, rays_out, det, led_w, amp_w = (
                spectral_mod.trace_spectral_dispersive(
                    self.elements, rays, wavelengths, weights=weights,
                    cfg=cfg_b, iterations=cfg.trace_iterations, mesh=mesh))
            live = torch.sum(torch.where(rays_out.alive, rays_out.power,
                                         0.0))
            image_amp_spectral = amp_w if cfg.coherent else None
            geom_rays = W * C
        else:
            if mesh is None:
                per_det, led_w, det_names, sr, det = (
                    spectral_mod.trace_spectral(
                        self.elements, rays, wavelengths, weights=weights,
                        cfg=cfg, iterations=cfg.trace_iterations))
            else:
                per_det, led_w, det_names, sr, det = (
                    spectral_mod.trace_spectral_multichip(
                        self.elements, rays, wavelengths, weights=weights,
                        cfg=cfg, iterations=cfg.trace_iterations, mesh=mesh))
            live = torch.sum(torch.where(sr.alive[:, None], sr.P, 0.0))
            led = Ledger(*(torch.sum(x) for x in led_w))
            image_amp_spectral = None
            geom_rays = C
        if mesh is not None:
            live = self._sum_over_rays(live, mesh)
        # one transfer of the ledgers and the live power
        scalars = torch.cat([torch.stack(list(led)), live[None],
                             torch.stack(list(led_w)).reshape(-1)]).cpu()
        self._sync()
        wall = time.perf_counter() - t0
        scalars = scalars.numpy()
        ledger = dict(zip(Ledger._fields, scalars[:5].tolist()))
        spectral_ledger = dict(zip(Ledger._fields,
                                   scalars[6:].reshape(5, -1)))
        per_det = per_det.cpu().numpy()
        real_tris = self.num_triangles
        result = TraceResult(
            *_no_measured_rays(),
            hist=det.hist.cpu().numpy(),
            per_detector=per_det.sum(axis=1),
            image=det.image.cpu().numpy(),
            detector_names=list(det_names),
            ledger=ledger,
            iterations_run=cfg.trace_iterations,
            rays_traced=geom_rays * cfg.trace_iterations,
            intersection_tests=(geom_rays * cfg.trace_iterations
                                * real_tris),
            wall_time=wall,
            segments=[],
            final_live_power=float(scalars[5]),
            per_detector_spectrum=per_det,
            wavelengths=np.atleast_1d(np.asarray(wavelengths, np.float32)),
            spectral_ledger=spectral_ledger,
            image_amp_spectral=(None if image_amp_spectral is None
                                else image_amp_spectral.cpu().numpy()),
            tri_flux=(det.tri_flux.cpu().numpy()[:real_tris]
                      if det.tri_flux.shape[0] > 1 else None),
            time_hist=(det.time_hist.cpu().numpy()
                       if cfg.time_bins > 0 else None),
            opl_edges=_opl_edges(cfg),
            device=str(self.device))
        # the ledger's emitted power must be the rays' own
        if abs(ledger["emitted"] - emitted_rows) >= 1e-4 * max(emitted_rows,
                                                                1.0):
            raise RuntimeError(
                f"spectral ledger emitted {ledger['emitted']} != the rays' "
                f"{emitted_rows}")
        self.last_result = result
        log.info("spectral trace done (%s): %.3fs, %.3g tests/s",
                 method, wall, result.tests_per_second)
        return result

    def _detector_zeros(self, cfg: TraceConfig) -> DetectorState:
        return DetectorState.zeros(
            cfg.hist_azimuth_bins, cfg.hist_polar_bins,
            max(len(self.detector_names), 1), cfg.image_bins,
            coherent=cfg.coherent,
            n_tris=self.scene.num_triangles_padded if cfg.flux_map else 0,
            time_bins=cfg.time_bins, device=self.device)

    @spanned("engine.call")
    def trace_batched(self, source, total_rays: int, batch_size: int,
                      elements: Optional[Sequence[GeoObject]] = None,
                      checkpoint_path: Optional[str] = None,
                      seed: int = 0, max_batches: Optional[int] = None,
                      mode: str = "device", mesh=None,
                      capacity: Optional[int] = None,
                      **cfg_overrides) -> TraceResult:
        """Mega-batch trace (BASELINE configs[3]): stream `total_rays`
        through the device in `batch_size` chunks sampled on the device
        (`source.rays_on_device` / `wavelengths_on_device`, or its combined
        `batch_on_device`). Within a batch the accumulators are f32 on the
        device; across batches the detector maps and the ledger are summed
        on the host in float64. Batch b draws only from generators seeded
        from (seed, b), so with `checkpoint_path` (state saved after every
        batch) an interrupted run resumes at the next batch and ends with
        the same bits as an uninterrupted one. `max_batches` stops after
        that many batches of this call. The result keeps each batch's own
        detector totals and ledger (`per_batch_detector`,
        `per_batch_ledger`) and, with an image, its image
        (`per_batch_image`, B x nb^2 float64 on the host), from the
        readback the sums are made of. The checkpoint keeps the image rows
        in a side file beside it (`checkpoint.rows_path`), one row written
        a batch, so a save costs one row's nb^2 x 8 bytes more, not B of
        them.
        `capacity` (default batch_size) gives split-heavy scenes headroom,
        as in trace(capacity=...).

        mode="multichip" shards every batch over the "rays" axis of the
        mesh (default every rank of the process group) exactly like
        Tracer.trace(mode="multichip"); mode="mesh2d" also shards the
        triangles over the "tris" axis of a ("tris", "rays") mesh
        (required), placed once for the run. Every rank samples the same
        batch and keeps its interleaved share; bounce i of ray rank r of
        batch b draws from make_generator(device, seed, b, 0x5757, r, i).
        Each batch runs the fixed depth (a shard stops when its rays are
        all dead); leftover live power is culled into the ledger either
        way. Under a mesh the checkpoint is written by the mesh's first
        rank, and every rank then waits at a barrier, so no rank reads a
        checkpoint that is still being written; every rank reads it on
        resume."""
        if mode not in ("device", "multichip", "mesh2d"):
            raise ValueError(f"trace_batched mode must be 'device', "
                             f"'multichip' or 'mesh2d', got {mode!r}")
        cfg = self.cfg.replace(**cfg_overrides) if cfg_overrides else self.cfg
        if elements is not None:
            self.set_elements(elements)
        if self.scene is None:
            raise ValueError("no scene: pass `elements` or call set_elements()")
        _check_coherent(cfg)
        cfg = self._tune_splitting(cfg)
        cfg = self._check_polarization(cfg)
        _check_replicated_scene(cfg, mode, "'device'/'multichip'")
        self._check_flux_map(cfg, mode)
        self._check_time_bins(cfg)
        dev = self.device
        if cfg.cull is None:
            # auto-cull from a small device sample of the source's bundle
            with span("engine.resolve_cull"):
                _, d_s, _ = source.rays_on_device(
                    step_mod.make_generator(dev, seed ^ 0xC011),
                    min(2048, batch_size))
                cfg = self._resolve_cull(cfg, mode, dirs=d_s.cpu().numpy())
        center = getattr(source, "center", None)
        with span("engine.resolve_ray_len"):
            cfg = self._resolve_ray_len(
                cfg, origins=None if center is None else np.asarray(
                    center, np.float64).reshape(1, 3))
        if cfg.cull and not self._scene_sorted:
            self.set_elements(self.elements, spatial_sort=True)
        scene = self.scene
        if mode != "device":
            mesh, n_ray_ranks = self._prepare_mesh(mode, mesh)
            if mode == "mesh2d":
                # once, for every batch
                scene = mesh2d_mod.place_scene(self.scene, mesh)
        writes_checkpoint = mode == "device" or pdist.is_origin(mesh)
        n_batches = max(1, total_rays // batch_size)
        if total_rays != n_batches * batch_size:
            log.warning(
                "trace_batched: tracing %d rays (%d batches x %d), not the "
                "requested %d (make total_rays a multiple of batch_size)",
                n_batches * batch_size, n_batches, batch_size, total_rays)
        zeros = self._detector_zeros(cfg)
        acc = {f: np.zeros(tuple(getattr(zeros, f).shape))
               for f in DetectorState._fields}
        per_batch: list = []  # (D,) measured power per completed batch
        # (5,) ledger per completed batch; None once unknown (a resumed
        # checkpoint without them)
        per_batch_led: Optional[list] = []
        # (nb, nb) image per completed batch; None without an image, or
        # once unknown
        per_batch_img: Optional[list] = [] if cfg.image_bins > 0 else None
        led64 = np.zeros(5)  # emitted, measured, absorbed, escaped, culled
        start_batch = 0
        if checkpoint_path is not None:
            checkpoint_path = checkpoint.normalize_path(checkpoint_path)
            if os.path.exists(checkpoint_path):
                extra = checkpoint.load_state(checkpoint_path,
                                              device=dev)["extra"]
                for f, key in _CKPT_KEYS.items():
                    if key in extra:
                        acc[f] = np.asarray(extra[key])
                pb = extra.get("per_batch")
                if pb is not None and np.asarray(pb).size:
                    per_batch = [row for row in np.asarray(pb)]
                pbl = extra.get("per_batch_ledger")
                per_batch_led = ([row for row in np.asarray(pbl)]
                                 if pbl is not None
                                 and len(pbl) == len(per_batch) else None)
                n_img = extra.get("image_rows")
                if per_batch_img is not None:
                    rows = (None if n_img is None
                            or int(n_img) != len(per_batch)
                            else checkpoint.read_rows(
                                checkpoint_path, "per_batch_image",
                                len(per_batch), zeros.image.shape))
                    per_batch_img = None if rows is None else list(rows)
                led64 = np.asarray(extra["led64"])
                start_batch = int(extra.get("next_batch", 0))
                log.info("resuming batched trace at batch %d", start_batch)

        def assemble(b):
            gen_rays = step_mod.make_generator(dev, seed, b, 0)
            if hasattr(source, "batch_on_device"):
                # one draw gives index-coherent rays, wavelengths, Stokes
                o, d, p, wl, st = source.batch_on_device(gen_rays, batch_size)
            else:
                o, d, p = source.rays_on_device(gen_rays, batch_size)
                wl = (source.wavelengths_on_device(
                    step_mod.make_generator(dev, seed, b, 1), batch_size)
                    if hasattr(source, "wavelengths_on_device") else None)
                st = getattr(source, "stokes", None)
            return RayBatch.from_arrays(
                o, d, p * (1.0 / n_batches), ior_env=cfg.ior_env,
                wavelengths=wl, stokes=st, capacity=capacity, device=dev)

        def consume(b, det_b, led_b):
            # one transfer of every accumulator and the ledger
            parts = list(det_b) + [torch.stack(list(led_b))]
            host = torch.cat([a.reshape(-1) for a in parts]).cpu().numpy()
            host = np.split(host.astype(np.float64),
                            np.cumsum([a.numel() for a in parts])[:-1])
            for f, h in zip(DetectorState._fields, host):
                # broadcast as the reference's `+=` does (its mesh2d time
                # map is (1, 1): parallel/mesh2d.py)
                acc[f] += h.reshape(getattr(det_b, f).shape)
            per_batch.append(host[1])  # this batch's per_detector
            if per_batch_led is not None:
                per_batch_led.append(host[-1])
            if per_batch_img is not None:
                per_batch_img.append(host[2].reshape(det_b.image.shape))
            led64[:] += host[-1]
            if checkpoint_path is not None:
                if writes_checkpoint:
                    rows = ({} if per_batch_led is None else
                            {"per_batch_ledger": np.asarray(per_batch_led)})
                    if per_batch_img is not None:
                        # the image rows grow by nb^2 a batch: one row to
                        # the side file, its count to the npz
                        checkpoint.write_row(
                            checkpoint_path, "per_batch_image",
                            len(per_batch_img) - 1, per_batch_img[-1])
                        rows["image_rows"] = len(per_batch_img)
                    checkpoint.save_state(
                        checkpoint_path, **{key: acc[f]
                                            for f, key in _CKPT_KEYS.items()},
                        per_batch=np.asarray(per_batch), led64=led64,
                        next_batch=b + 1, **rows)
                if mode != "device":
                    pdist.barrier(mesh)
            log.info("batch %d/%d done", b + 1, n_batches)

        self._sync()
        t0 = time.perf_counter()
        done = 0
        batch_iters: list = []
        pending = None  # (b, det_b, led_b): read back once b + 1 is queued
        for b in range(start_batch, n_batches):
            if max_batches is not None and done >= max_batches:
                break
            done += 1
            with span("engine.batch"):
                with span("engine.assemble"):
                    rays = assemble(b)
                if mode == "device":
                    led_b = Ledger.start(torch.sum(rays.power * rays.alive),
                                         device=dev)
                    rays, det_b, led_b, iters_b = step_mod.trace_loop(
                        scene, rays, zeros, led_b, cfg, cfg.trace_iterations,
                        rng_words=(seed, b, 0x5757))
                    leftover = torch.sum(torch.where(rays.alive, rays.power,
                                                     0.0))
                else:
                    rays = sharding.padded_for(rays, n_ray_ranks)
                    _, det_b, led_b, leftover = self._trace_sharded(
                        mode, mesh, scene, rays, cfg, key=(seed, b, 0x5757))
                    iters_b = cfg.trace_iterations
                batch_iters.append(iters_b)
                # rays still alive when the batch retires are booked as
                # culled
                led_b = led_b._replace(culled=led_b.culled + leftover)
                if pending is not None:
                    with span("engine.readback"):
                        consume(*pending)
                pending = (b, det_b, led_b)
        if pending is not None:
            with span("engine.readback"):
                consume(*pending)
        wall = time.perf_counter() - t0
        slots = (capacity or batch_size) * sum(batch_iters)
        result = TraceResult(
            *_no_measured_rays(),
            hist=acc["hist"], per_detector=acc["per_detector"],
            image=acc["image"],
            detector_names=list(self.detector_names),
            ledger=dict(zip(Ledger._fields, led64.tolist())),
            iterations_run=max(batch_iters, default=0),
            rays_traced=slots,
            intersection_tests=slots * self.num_triangles,
            wall_time=wall, segments=[], final_live_power=0.0,
            image_amp=(acc["image_amp"] if acc["image_amp"].shape[1] > 1
                       else None),
            tri_flux=(acc["tri_flux"][:self.num_triangles]
                      if cfg.flux_map else None),
            time_hist=acc["time_hist"] if cfg.time_bins > 0 else None,
            opl_edges=_opl_edges(cfg),
            per_batch_detector=np.asarray(per_batch) if per_batch else None,
            per_batch_ledger=(np.asarray(per_batch_led)
                              if per_batch and per_batch_led is not None
                              else None),
            per_batch_image=(np.asarray(per_batch_img)
                             if per_batch and per_batch_img is not None
                             else None),
            device=str(dev))
        self.last_result = result
        return result

    # reference-shaped alias of trace (CL_Tracer.iterative_tracer adds the
    # per-iteration path record and the spectral upgrade)
    def iterative_tracer(self, light_source, meshes, trace_iterations=16,
                         max_ray_len=1e3, ior_env=1.0, **kw) -> TraceResult:
        return self.trace(
            light_source, elements=meshes, trace_iterations=trace_iterations,
            max_ray_len=float(max_ray_len), ior_env=float(ior_env), **kw
        )

    def _check_time_bins(self, cfg: TraceConfig) -> None:
        if cfg.time_bins > 0 and not (cfg.opl_max > cfg.opl_min):
            raise ValueError(
                "time_bins > 0 needs an OPL window: set opl_max > opl_min "
                "(OPL = sum n * length; t = OPL / c)")

    def _check_flux_map(self, cfg: TraceConfig, mode: str) -> None:
        """flux_map semantics are exact only when every intersect hit is a
        real surface arrival with global triangle indices (the reference's
        checks, worded as it words them)."""
        if not cfg.flux_map:
            return
        if mode == "mesh2d":
            raise ValueError(
                "flux_map=True needs global triangle indices (the scene "
                "replicated): use mode='host'/'device'/'multichip', not "
                "'mesh2d'")
        if cfg.has_scattering or cfg.has_fluorescence or cfg.has_grin:
            raise ValueError(
                "flux_map=True is undefined with volume events (scattering/"
                "fluorescence/GRIN): a ray that scatters mid-flight never "
                "arrives at the facet intersect() reported, so the "
                "per-facet incident flux would overcount")

    def _check_polarization(self, cfg: TraceConfig) -> TraceConfig:
        """The reference's has-flag resolution from the scene materials:
        each branch of `shade` runs exactly when the scene has an element
        that needs it, and grin_step left at 0 becomes 1/50 of the steepest
        profile's pitch (~25 steps per half pitch)."""
        needs = [e for e in self.elements
                 if e.material in (Material.POLARIZER, Material.WAVEPLATE,
                                   Material.BIREFRINGENT)]
        if needs and not cfg.polarization:
            raise ValueError(
                f"{needs[0].material.name} elements act on Stokes state: "
                "set TraceConfig(polarization=True) (and give the source a "
                "`stokes` tuple if the input is polarized)")
        els = self.elements
        flags = dict(
            has_gratings=any(e.material == Material.GRATING for e in els),
            has_metals=any(getattr(e, "metal_n", 0.0) > 0.0 for e in els),
            has_birefringence=any(e.material == Material.BIREFRINGENT
                                  for e in els),
            has_coatings=any(e.coating_layers() for e in els
                             if hasattr(e, "coating_layers")),
            has_diffuse=any(e.material == Material.DIFFUSE for e in els),
            has_scattering=any(getattr(e, "scattering", 0.0) > 0.0
                               for e in els),
            has_fluorescence=any(getattr(e, "fluorescence", 0.0) > 0.0
                                 for e in els),
            has_roughness=any(getattr(e, "roughness", 0.0) > 0.0
                              for e in els),
            has_analytic=any(getattr(e, "quad_abgd", None) is not None
                             for e in els),
        )
        grin_as = [abs(getattr(e, "grin_a", 0.0)) for e in els]
        flags["has_grin"] = any(a > 0.0 for a in grin_as)
        if flags["has_grin"] and cfg.grin_step <= 0.0:
            pitch = 2.0 * math.pi / math.sqrt(max(grin_as))
            flags["grin_step"] = pitch / 50.0
        return cfg.replace(**flags)

    def _resolve_ray_len(self, cfg: TraceConfig,
                         origins=None) -> TraceConfig:
        """Auto-expand the default miss horizon when the scene + source
        reach exceeds it: 2x that reach rounded up to a power of two. An
        explicitly set max_ray_len is respected (unless it equals the
        default, as in the reference)."""
        default = type(cfg).__dataclass_fields__["max_ray_len"].default
        if cfg.max_ray_len != default or not self.elements:
            return cfg
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for e in self.elements:
            v = np.asarray(e.vertices, np.float64)
            lo = np.minimum(lo, v.min(axis=0))
            hi = np.maximum(hi, v.max(axis=0))
        reach = float(np.linalg.norm(hi - lo))  # bounce-to-bounce bound
        if origins is not None:
            o = np.asarray(origins, np.float64).reshape(-1, 3)
            far = np.maximum(np.abs(o - lo), np.abs(o - hi))
            reach = max(reach, float(np.linalg.norm(far, axis=1).max()))
        if reach <= cfg.max_ray_len:
            return cfg
        val = float(2.0 ** np.ceil(np.log2(2.0 * reach)))
        log.info("max_ray_len auto-expanded %g -> %g (scene reach %.3g; "
                 "set TraceConfig(max_ray_len=...) to pin it)",
                 cfg.max_ray_len, val, reach)
        return cfg.replace(max_ray_len=val)

    # auto-cull coherence threshold: enable when every sampled direction
    # is within 60 degrees of the bundle mean (min cosine >= 0.5)
    _CULL_MIN_COS = 0.5

    def _resolve_cull(self, cfg: TraceConfig, mode: str,
                      rays=None, dirs=None, alive=None) -> TraceConfig:
        """Resolve cull=None (auto) to a concrete bool: on when the source
        bundle fits a tight direction cone. The cull mask never changes
        intersect results."""
        if cfg.cull is not None:
            return cfg
        if dirs is None and rays is not None:
            n = min(int(rays.capacity), 4096)
            dirs = rays.d[:n].cpu().numpy()
            alive = rays.alive[:n].cpu().numpy()
        if dirs is None:
            return cfg.replace(cull=False)
        d = np.asarray(dirs, np.float64)
        if alive is not None:
            d = d[np.asarray(alive, bool)]
        if d.shape[0] == 0:
            return cfg.replace(cull=False)
        m = d.mean(axis=0)
        nl = np.linalg.norm(m)
        if nl < 1e-9:
            return cfg.replace(cull=False)
        min_cos = float((d @ (m / nl)).min())
        on = min_cos >= self._CULL_MIN_COS
        if on:
            log.info("auto-cull ON (bundle min-cos %.3f >= %.2f)",
                     min_cos, self._CULL_MIN_COS)
        return cfg.replace(cull=on)

    def _tune_splitting(self, cfg: TraceConfig) -> TraceConfig:
        """Auto-disable the 2C split buffer + compaction when the scene has
        no refractive elements; refuse the unsafe opposite direction."""
        if self._has_refractive and not cfg.allow_splitting:
            raise ValueError(
                "allow_splitting=False would silently drop each ray's "
                "second child — the refracted branch of dielectrics/"
                "beamsplitters, a dual-order grating's specular "
                "0th-order leak, or a rough mirror's scattered share; "
                "remove the override"
            )
        if not self._has_refractive and cfg.allow_splitting:
            cfg = cfg.replace(allow_splitting=False)
        return cfg

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prepare_mesh(self, mode, mesh):
        """(mesh, its ray-rank count) of a sharded mode: multichip defaults
        to every rank of the process group, mesh2d needs its mesh and a
        padded triangle count that the "tris" axis divides (the
        reference's refusals); the tracer's device must be this rank's."""
        if mode == "multichip":
            if mesh is None:
                mesh = sharding.make_ray_mesh(device=self.device)
        else:
            if mesh is None:
                raise ValueError(
                    "mode='mesh2d' needs mesh=make_mesh2d(n_tris, n_rays)")
            n_tris = pdist.axis(mesh, mesh2d_mod.TRI_AXIS)[0]
            if self.scene.num_triangles_padded % n_tris:
                raise ValueError(
                    f"padded triangle count {self.scene.num_triangles_padded}"
                    f" not divisible by the {n_tris}-way triangle axis")
        n_ray_ranks = pdist.axis(mesh, sharding.RAY_AXIS)[0]
        pdist.check_device(mesh, self.device)
        return mesh, n_ray_ranks

    @staticmethod
    def _sum_over_rays(x, mesh):
        """x summed over the mesh's "rays" axis (x is replicated over any
        other axis)."""
        return pdist.all_reduce_packed(
            [x], pdist.axis(mesh, sharding.RAY_AXIS)[2])[0]

    def _trace_sharded(self, mode, mesh, scene, rays, cfg, key):
        """One sharded trace of the whole batch `rays` (every rank passes
        the same; `scene` is the whole scene, or this rank's triangle shard
        under mesh2d). Returns (this rank's final rays, the global
        DetectorState and Ledger, the global live power)."""
        fn = (sharding.trace_multichip if mode == "multichip"
              else mesh2d_mod.trace_mesh2d)
        rays_out, det, led = fn(
            scene, sharding.shard_rays(rays, mesh), cfg,
            cfg.trace_iterations, mesh,
            n_detectors=max(len(self.detector_names), 1),
            key=key if cfg.needs_rng else None)
        live = torch.sum(torch.where(rays_out.alive, rays_out.power, 0.0))
        return rays_out, det, led, self._sum_over_rays(live, mesh)

    def _run(self, mode, rays, det, led, cfg, C, emitted,
             record_paths, mesh=None) -> TraceResult:
        self._sync()
        t0 = time.perf_counter()
        if mode in ("multichip", "mesh2d"):
            if record_paths:
                log.warning("record_paths requires mode='host'; %s mode "
                            "returns no path segments", mode)
            scene = (mesh2d_mod.place_scene(self.scene, mesh)
                     if mode == "mesh2d" else self.scene)
            rays_out, det, led, live = self._trace_sharded(
                mode, mesh, scene, rays, cfg, key=cfg.seed)
            self._sync()
            wall = time.perf_counter() - t0
            return self._package(rays_out, det, led, [], [],
                                 cfg.trace_iterations, C, wall, cfg,
                                 live_power=live)
        if mode == "device":
            if record_paths:
                log.warning("record_paths requires mode='host'; device mode "
                            "returns no path segments")
            rays_out, det, led, iters = step_mod.trace_loop(
                self.scene, rays, det, led, cfg, cfg.trace_iterations)
            self._sync()
            wall = time.perf_counter() - t0
            return self._package(rays_out, det, led, [], [], iters, C, wall,
                                 cfg)
        harvested = []
        segments = []
        iters = 0
        frame = step_mod.cull_frame(self.scene) if cfg.cull else None
        for it in range(cfg.trace_iterations):
            gen = (step_mod.make_generator(self.device, cfg.seed, it)
                   if cfg.needs_rng else None)
            rays, det, led, aux = step_mod.trace_step(
                self.scene, rays, det, led, cfg, gen=gen, frame=frame)
            iters += 1
            # one transfer of the per-step scalars
            counts = torch.stack([aux.measured_count, aux.live_count]).cpu()
            m, live = int(counts[0]), int(counts[1])
            if m > 0:
                # only the measured prefix crosses to the host
                harvested.append(tuple(
                    a[:m].cpu().numpy() for a in (
                        aux.m_pos, aux.m_dir, aux.m_power, aux.m_det,
                        aux.m_wl, aux.m_stokes, aux.m_opl, aux.m_path)))
            if record_paths:
                segments.append((aux.start_point.cpu().numpy(),
                                 aux.hit_point.cpu().numpy(),
                                 aux.parent_alive.cpu().numpy()))
            led_vals = torch.stack(list(led)).cpu().numpy()
            accounted = float(led_vals[1:].sum())
            log.info("iter %d: live=%d accounted=%.4f/%.4f", it, live,
                     accounted, emitted)
            if live == 0 or accounted >= cfg.dissipation_target * emitted:
                break
        self._sync()
        wall = time.perf_counter() - t0
        return self._package(rays, det, led, harvested, segments, iters, C,
                             wall, cfg)

    def _package(self, rays, det, led, harvested, segments, iters, C,
                 wall, cfg, live_power=None) -> TraceResult:
        """The TraceResult of a trace; `live_power` (a sharded trace's,
        summed over the mesh) defaults to the live power of `rays`."""
        if harvested:
            cols = [np.concatenate([h[k] for h in harvested])
                    for k in range(8)]
        else:
            cols = _no_measured_rays()
        if live_power is None:
            live_power = torch.sum(torch.where(rays.alive, rays.power, 0.0))
        live_power = float(live_power)
        real_tris = self.num_triangles
        return TraceResult(
            *cols,
            hist=det.hist.cpu().numpy(),
            per_detector=det.per_detector.cpu().numpy(),
            image=det.image.cpu().numpy(),
            detector_names=list(self.detector_names),
            ledger=led.as_dict(),
            iterations_run=iters,
            rays_traced=C * iters,
            intersection_tests=C * iters * real_tris,
            wall_time=wall,
            segments=segments,
            final_live_power=live_power,
            image_amp=(det.image_amp.cpu().numpy()
                       if det.image_amp.shape[1] > 1 else None),
            # (1,) zeros = flux_map disabled; real runs are padded past 1
            tri_flux=(det.tri_flux.cpu().numpy()[:real_tris]
                      if det.tri_flux.shape[0] > 1 else None),
            time_hist=(det.time_hist.cpu().numpy()
                       if cfg.time_bins > 0 else None),
            opl_edges=_opl_edges(cfg),
            device=str(self.device),
        )

    # -- reference-shaped getters -------------------------------------------

    def get_measured_rays(self):
        """(positions, directions, powers) of all rays collected on measure
        surfaces."""
        r = self._require_result()
        return r.measured_pos, r.measured_dir, r.measured_power

    def get_detector_histogram(self):
        return self._require_result().hist

    def get_surface_flux(self):
        """Irradiance map of the last flux-map trace (analysis.surface_flux
        on TraceResult.tri_flux): per-facet incident power / irradiance and
        per-element totals. Needs TraceConfig(flux_map=True)."""
        r = self._require_result()
        if r.tri_flux is None:
            raise ValueError(
                "no flux map on the last trace: set "
                "TraceConfig(flux_map=True) (host/device/multichip modes)")
        names = [getattr(e, "name", None) or i
                 for i, e in enumerate(self.elements)]
        return analysis.surface_flux(r.tri_flux, self.scene,
                                     element_names=names)

    def get_power_ledger(self):
        return dict(self._require_result().ledger)

    def _require_result(self) -> TraceResult:
        if self.last_result is None:
            raise RuntimeError("run trace()/iterative_tracer() first")
        return self.last_result
