"""Host-side trace driver.

Port counterpart of lightpycl_tpu/tracer/engine.py: `TraceResult` and
`Tracer` with `set_elements`, `trace` in its two single-device modes, the
cfg resolution helpers (`_resolve_ray_len`, `_resolve_cull`,
`_tune_splitting`, the has-flag resolution of `_check_polarization`) and
`_package`.

  * 'device': the multi-bounce loop runs on the device with one host sync
    per bounce (the early-exit test); detector histogram and ledger come
    back, individual measured rays do not.
  * 'host': the same steps, harvesting measured rays (and optionally ray
    segments) after every bounce: the reference's per-iteration semantics.

The tracer runs on an explicit `device` (default CUDA; the CPU only when
asked for). Features outside the ported core raise NotImplementedError
naming the feature. The reference's own quirks in `_resolve_ray_len`
(an explicit max_ray_len equal to the default counts as unset; the reach
includes dead padding slots' origins) are reproduced, not fixed.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from lightpycl_tpu_torch.geometry.mesh import GeoObject
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.tracer import step as step_mod
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu_torch.tracer.scene import Scene, build_scene

log = logging.getLogger("lightpycl_tpu_torch")


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

    def power_conservation_error(self) -> float:
        l = self.ledger
        acc = l["measured"] + l["absorbed"] + l["escaped"] + l["culled"]
        return abs(l["emitted"] - acc - self.final_live_power) / max(l["emitted"], 1e-30)


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

    def trace(self, source, elements: Optional[Sequence[GeoObject]] = None,
              trace_iterations: Optional[int] = None,
              capacity: Optional[int] = None, mode: str = "host",
              record_paths: bool = False, rays: Optional[RayBatch] = None,
              profile_logdir: Optional[str] = None, mesh=None,
              **cfg_overrides) -> TraceResult:
        """Run the iterative trace (mode 'host' or 'device').

        `source` is a LightSource / CollimatedSource / AreaSource (or None
        if `rays` is given). Remaining kwargs override TraceConfig fields,
        mirroring the reference's iterative_tracer(...) signature."""
        if mode in ("multichip", "mesh2d"):
            raise NotImplementedError(
                f"mode={mode!r} is not ported to lightpycl_tpu_torch yet")
        if mode not in ("host", "device"):
            raise ValueError(f"unknown mode {mode!r}")
        if mesh is not None:
            raise NotImplementedError("device meshes (mesh=) are not ported")
        if profile_logdir is not None:
            raise NotImplementedError("profile_logdir is not ported")
        cfg = self.cfg
        if trace_iterations is not None:
            cfg_overrides["trace_iterations"] = int(trace_iterations)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        if elements is not None:
            self.set_elements(elements)
        if self.scene is None:
            raise ValueError("no scene: pass `elements` or call set_elements()")
        cfg = self._tune_splitting(cfg)
        cfg = self._check_polarization(cfg)
        step_mod.require_core(cfg)
        if rays is None:
            origins, dirs, powers = source.sample()
            wls = (source.sample_wavelengths()
                   if hasattr(source, "sample_wavelengths") else None)
            rays = RayBatch.from_arrays(origins, dirs, powers,
                                        ior_env=cfg.ior_env, capacity=capacity,
                                        wavelengths=wls,
                                        stokes=getattr(source, "stokes", None),
                                        device=self.device)
        cfg = self._resolve_ray_len(cfg, origins=rays.o.cpu().numpy())
        cfg = self._resolve_cull(cfg, mode, rays=rays)
        if cfg.cull and not self._scene_sorted:
            # spatially-sorted triangle tiles are what make the cull bite
            self.set_elements(self.elements, spatial_sort=True)
        C = rays.capacity
        emitted = float(torch.sum(torch.where(rays.alive, rays.power, 0.0)))
        det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                                  max(len(self.detector_names), 1),
                                  cfg.image_bins, device=self.device)
        led = Ledger.start(emitted, device=self.device)
        log.info(
            "trace start: %d rays (capacity %d), %d triangles, %d "
            "iterations, mode=%s, device=%s", int(rays.alive.sum()), C,
            self.num_triangles, cfg.trace_iterations, mode, self.device)
        result = self._run(mode, rays, det, led, cfg, C, emitted,
                           record_paths)
        self.last_result = result
        log.info(
            "trace done: %.3fs, %.3g intersection tests/s, %.3g rays/s",
            result.wall_time, result.tests_per_second, result.rays_per_second)
        return result

    def trace_spectral(self, *args, **kwargs):
        raise NotImplementedError(
            "trace_spectral is not ported to lightpycl_tpu_torch yet")

    def trace_batched(self, *args, **kwargs):
        raise NotImplementedError(
            "trace_batched is not ported to lightpycl_tpu_torch yet")

    def _check_polarization(self, cfg: TraceConfig) -> TraceConfig:
        """The reference's has-flag resolution from the scene materials
        (the flags that resolve True then raise in step.require_core)."""
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
            has_grin=any(abs(getattr(e, "grin_a", 0.0)) > 0.0 for e in els),
            has_analytic=any(getattr(e, "quad_abgd", None) is not None
                             for e in els),
        )
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

    def _run(self, mode, rays, det, led, cfg, C, emitted,
             record_paths) -> TraceResult:
        self._sync()
        t0 = time.perf_counter()
        if mode == "device":
            if record_paths:
                log.warning("record_paths requires mode='host'; device mode "
                            "returns no path segments")
            rays_out, det, led, iters = step_mod.trace_loop(
                self.scene, rays, det, led, cfg, cfg.trace_iterations)
            self._sync()
            wall = time.perf_counter() - t0
            return self._package(rays_out, det, led, [], [], iters, C, wall)
        harvested = []
        segments = []
        iters = 0
        for it in range(cfg.trace_iterations):
            rays, det, led, aux = step_mod.trace_step(
                self.scene, rays, det, led, cfg)
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
                             wall)

    def _package(self, rays, det, led, harvested, segments, iters, C,
                 wall) -> TraceResult:
        if harvested:
            cols = [np.concatenate([h[k] for h in harvested])
                    for k in range(8)]
        else:
            cols = [np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0,), np.float32), np.zeros((0,), np.int32),
                    np.zeros((0,), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0,), np.float32), np.zeros((0,), np.float32)]
        live_power = float(torch.sum(torch.where(rays.alive, rays.power,
                                                 0.0)))
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

    def get_power_ledger(self):
        return dict(self._require_result().ledger)

    def _require_result(self) -> TraceResult:
        if self.last_result is None:
            raise RuntimeError("run trace()/iterative_tracer() first")
        return self.last_result
