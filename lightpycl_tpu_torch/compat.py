"""Reference-shaped API facade.

Port counterpart of lightpycl_tpu/compat.py: `CL_Tracer` with
`iterative_tracer`, `get_measured_rays`, `get_detector_histogram`,
`get_power_ledger` and `get_trace_performance`. No getter of the reference
is fed only by the surface and volume physics (Stokes fractions and path
signatures come back in TraceResult.measured_stokes / measured_path). Its
plotting, directivity, beam statistics and DXF export need the analysis / io
layers and are not ported yet (ROADMAP A 8). `iterative_tracer(wavelengths=)`
is the one-keyword spectral upgrade of a script (Tracer.trace_spectral).

    from lightpycl_tpu_torch.compat import (CL_Tracer, optical_elements,
                                            light_source)
    oe = optical_elements()
    mirror = oe.parabolic_mirror(focus=1.0, diameter=2.0, reflectivity=0.98)
    ls = light_source(center=(0,0,1), direction=(0,0,-1), power=1.0,
                      ray_count=100000)
    tracer = CL_Tracer(platform_name="", device_type="GPU")
    tracer.iterative_tracer(ls, [mirror, detector], trace_iterations=8)
    pos, dirs, powers = tracer.get_measured_rays()
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from lightpycl_tpu_torch.geometry.primitives import (OpticalElements,
                                                     optical_elements)
from lightpycl_tpu_torch.sources import (CollimatedSource, LightSource,
                                         light_source)
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.engine import Tracer, TraceResult

log = logging.getLogger("lightpycl_tpu_torch.compat")

__all__ = [
    "CL_Tracer",
    "optical_elements",
    "OpticalElements",
    "light_source",
    "LightSource",
    "CollimatedSource",
]


class CL_Tracer(Tracer):
    """Reference-shaped tracer session. The reference's
    (platform_name, device_type) picked an OpenCL device; here both are
    accepted for one-to-one script porting and logged, and `device`
    (default CUDA) is the torch device that runs the trace."""

    def __init__(self, platform_name: str = "", device_type: str = "",
                 cfg: Optional[TraceConfig] = None,
                 device: torch.device | str = "cuda"):
        super().__init__(cfg=cfg, device=device)
        if platform_name or device_type:
            log.info("CL_Tracer(platform_name=%r, device_type=%r) ignored; "
                     "running on %s", platform_name, device_type,
                     self.device)
        self._record_paths_default = True

    def iterative_tracer(self, light_source, meshes, trace_iterations=16,
                         max_ray_len=1e3, ior_env=1.0, record_paths=None,
                         power_dissipated=None, wavelengths=None,
                         spectral_weights=None, **kw) -> TraceResult:
        """Run the full iterative trace (the reference's main entry
        point). Measured rays are harvested per iteration (host mode).
        `power_dissipated` is the reference's early-exit fraction (alias of
        dissipation_target).

        `wavelengths` (um) turns the same script spectral: one
        Tracer.trace_spectral run (device mode, no early exit, no per-ray
        harvest) whose TraceResult also carries per_detector_spectrum
        (D, W); `spectral_weights` splits the power over the wavelengths
        (default uniform)."""
        if power_dissipated is not None:
            kw.setdefault("dissipation_target", float(power_dissipated))
        if wavelengths is not None:
            kw.pop("dissipation_target", None)  # no early exit in spectral
            mode = kw.pop("mode", "device")
            return self.trace_spectral(
                light_source, wavelengths, elements=meshes,
                weights=spectral_weights,
                trace_iterations=int(trace_iterations),
                max_ray_len=float(max_ray_len), ior_env=float(ior_env),
                mode=mode, **kw)
        mode = kw.pop("mode", "host")
        if record_paths is None:
            record_paths = self._record_paths_default and mode == "host"
        return self.trace(
            light_source, elements=meshes,
            trace_iterations=int(trace_iterations),
            max_ray_len=float(max_ray_len), ior_env=float(ior_env),
            mode=mode, record_paths=record_paths, **kw,
        )

    def get_trace_performance(self) -> dict:
        r = self._require_result()
        return {
            "wall_time_s": r.wall_time,
            "rays_per_second": r.rays_per_second,
            "intersection_tests_per_second": r.tests_per_second,
            "iterations": r.iterations_run,
            "device": r.device,
        }
