"""lightpycl_tpu_torch — the geometric-optics ray tracer on PyTorch + CUDA.

A port of lightpycl_tpu (JAX/XLA/Pallas, the reference, which stays in the
repository unchanged) to PyTorch on an NVIDIA Hopper GPU. The module layout
mirrors the reference file for file and each module's docstring names its
counterpart. The ray x triangle nearest-hit kernel is hand-written CUDA C++
(csrc/intersect.cu, built with nvcc at first use); everything else is plain
torch. Importing this package needs neither jax nor lightpycl_tpu, and
builds nothing.

Ported so far: the single-device trace (`Tracer.trace(mode="host" |
"device")` and the `CL_Tracer.iterative_tracer` facade) with the whole
material model (polarization, coatings, metals, gratings, crystals,
diffuse and rough surfaces, turbid and fluorescent media, GRIN, path
tracking), the exact quadric surfaces, the optional detector maps and
roulette, and the batched mega-ray tracer `Tracer.trace_batched` with the
sources' device samplers, checkpoint / resume and ray-file replay
(`lightpycl_tpu_torch.io`), spectral tracing (`Tracer.trace_spectral`,
`lightpycl_tpu_torch.spectral`), and the host side: the float64 parity
oracle (`tracer.oracle`, `native`), `analysis`, `paraxial`, every `io`
format, `utils` and the reference-named modules (`iterative_tracer`,
`light_source`, `geo_optical_elements`), and differentiable design on
torch autograd (`lightpycl_tpu_torch.diff`: lens and coating design loops),
and the multi-device modes on torch.distributed
(`lightpycl_tpu_torch.parallel`: rays sharded over a "rays" mesh axis,
triangles over a "tris" axis, both at once; `mode="multichip"` and
`mode="mesh2d"` of trace, trace_batched and trace_spectral).
"""

from lightpycl_tpu_torch.materials import Material, glass
from lightpycl_tpu_torch.geometry.mesh import (GeoObject, instance_grid,
                                               instances, merge)
from lightpycl_tpu_torch.geometry.primitives import (OpticalElements,
                                                     optical_elements)
from lightpycl_tpu_torch.geometry.analytic import (
    AnalyticSurface, analytic_annulus, analytic_biconvex_lens, analytic_disc,
    analytic_lens, analytic_mirror, analytic_plano_convex_lens,
    analytic_sphere, conic_surface, cylinder_surface)
from lightpycl_tpu_torch.sources import (AreaSource, CollimatedSource,
                                         LightSource, light_source)
from lightpycl_tpu_torch.tracer.config import TraceConfig
from lightpycl_tpu_torch.tracer.scene import Scene, build_scene
from lightpycl_tpu_torch.tracer.rays import RayBatch
from lightpycl_tpu_torch.tracer.engine import Tracer, TraceResult
from lightpycl_tpu_torch.compat import CL_Tracer

__version__ = "0.1.0"

__all__ = [
    "Material",
    "glass",
    "GeoObject",
    "merge",
    "instances",
    "instance_grid",
    "OpticalElements",
    "optical_elements",
    "AnalyticSurface",
    "conic_surface",
    "cylinder_surface",
    "analytic_lens",
    "analytic_plano_convex_lens",
    "analytic_biconvex_lens",
    "analytic_mirror",
    "analytic_disc",
    "analytic_annulus",
    "analytic_sphere",
    "AreaSource",
    "CollimatedSource",
    "LightSource",
    "light_source",
    "TraceConfig",
    "Scene",
    "build_scene",
    "RayBatch",
    "Tracer",
    "TraceResult",
    "CL_Tracer",
]
