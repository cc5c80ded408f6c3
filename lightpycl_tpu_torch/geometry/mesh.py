"""Triangle-mesh optical elements and affine transforms.

Port counterpart of lightpycl_tpu/geometry/mesh.py: a jax-free copy, so the
PyTorch package imports without the JAX package. Kept line for line equal
to the reference below this paragraph (tests/test_torch_host_layer.py pins
the meshes it builds bit for bit).

Reference parity: `GeoObject` in geo_optical_elements.py (SURVEY.md §3
"GeoObject" [recalled]) — a triangle mesh plus material type and index of
refraction, with translate / rotate / scale transforms.

TPU-first design note: meshes are HOST-side numpy float64 during scene
construction (tessellation and transforms are cold-path; f64 keeps the
precomputed unit-triangle transforms accurate), and are flattened + cast to
f32 device arrays only by `tracer.scene.build_scene`. Transform methods
mutate in place AND return self (chainable), matching the reference's
imperative scripting style; `transformed()` offers the pure-functional
variant.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from lightpycl_tpu_torch.materials import Material

# vectorized error function (numpy has no erf; math.erf is exact)
_erf = np.frompyfunc(__import__("math").erf, 1, 1)


def rotation_matrix(axis, angle: float) -> np.ndarray:
    """3x3 rotation matrix about `axis` by `angle` radians (Rodrigues)."""
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        raise ValueError("rotation axis must be nonzero")
    x, y, z = axis / n
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


@dataclasses.dataclass
class GeoObject:
    """A triangle-mesh optical element.

    Attributes:
      vertices:     (V, 3) float64 vertex positions
      triangles:    (T, 3) int32 vertex indices, CCW winding = outward normal
      material:     Material (mirror / refractive / terminator / measure)
      ior:          index of refraction INSIDE the volume the outward normals
                    bound (used for Material.REFRACTIVE)
      reflectivity: mirror power reflectivity in [0, 1]
      name:         optional label (used for per-detector power reporting)
    """

    vertices: np.ndarray
    triangles: np.ndarray
    material: Material = Material.TERMINATOR
    ior: float = 1.0
    reflectivity: float = 1.0
    name: Optional[str] = None
    dispersion_b: float = 0.0  # Cauchy B [um^2]: n(wl) = ior + B / wl^2
    dispersion_c: float = 0.0  # extended-Cauchy C [um^4]: + C / wl^4 on
    #   top of the B term — lets real Sellmeier catalog glasses fit to
    #   ~1e-4 or better across the visible band
    #   (materials.glass_from_sellmeier)
    absorption: float = 0.0    # Beer-Lambert bulk absorption inside [1/len]
    axis: Optional[np.ndarray] = None  # polarizer transmission / waveplate
    #   fast axis (world frame, unit); rotates with the element
    retardance: float = 0.0    # waveplate retardance [rad]; pi/2 = quarter
    grating_period: float = 0.0  # groove period [um] (same units as
    #   wavelength); GRATING elements require > 0
    grating_order: int = 1     # fixed diffraction order m
    metal_n: float = 0.0       # complex-index metal mirror: real part n
    metal_k: float = 0.0       # and extinction k (n - i k). metal_n > 0 on
    #   a MIRROR element replaces the fixed `reflectivity` with the
    #   angle/polarization-dependent metallic Fresnel R (times
    #   `reflectivity` as an extra scalar factor, default 1); 1 - R is
    #   absorbed. metal_n = 0 (default) = the reference's ideal mirror
    order0_fraction: float = 0.0  # fraction of the reflected power leaking
    #   into the SPECULAR (0th) order instead of order m — real gratings
    #   are never 100% efficient; 0 = all light into order m (the original
    #   single-order model). Both children are traced (order m at slot i,
    #   0th at slot C+i)
    coat_ior: float = 0.0      # single-layer thin-film coating index
    coat_thickness: float = 0.0  # coating thickness [um]; 0 = uncoated.
    #   REFRACTIVE elements only: replaces the bare Fresnel split with the
    #   film's R(lambda, theta) (AR / HR coatings)
    coating: Optional[list] = None  # multilayer stack [(n, h_um), ...],
    #   outermost layer first; generalizes coat_ior/coat_thickness (do not
    #   set both). Lossless dielectric stack; R is side-independent
    ne: float = 0.0            # extraordinary principal index of a
    #   BIREFRINGENT (uniaxial crystal) element; `ior` is the ordinary
    #   index n_o and `axis` the optic axis (world frame, rotates with the
    #   element). Requires TraceConfig(polarization=True)
    scattering: float = 0.0    # volume scattering coefficient mu_s inside
    #   the element [1/len] (turbid/translucent media: fog cells, opal
    #   diffusers, biological tissue). REFRACTIVE elements only; free
    #   paths ~ Exp(mu_s), direction redrawn from the Henyey-Greenstein
    #   phase function; combine with `absorption` for full extinction
    scatter_g: float = 0.0     # Henyey-Greenstein anisotropy g in (-1, 1);
    #   0 = isotropic, +forward / -backward peaked
    fluorescence: float = 0.0  # phosphor conversion coefficient mu_f
    #   inside the element [1/len] (extension: wavelength-converting
    #   media — phosphor-in-matrix white LEDs, fluorophores, scintillator
    #   blocks). REFRACTIVE elements only. Rays with vacuum wavelength
    #   below `fluor_edge` draw conversion events with free paths
    #   ~ Exp(mu_f); at an event the ray re-emits isotropically at a
    #   wavelength drawn from `fluor_emission`, keeping quantum yield x
    #   Stokes-shift (lambda_abs / lambda_em) of its power — the
    #   remainder is absorbed. Composes with `scattering` (elastic) and
    #   `absorption` (non-radiative extinction)
    fluor_yield: float = 1.0   # quantum yield QY in [0, 1]: probability a
    #   converted photon survives (as a power factor)
    fluor_emission: object = None  # emission spectrum: a single vacuum
    #   wavelength [um] (monochromatic), a (mean_um, fwhm_um) tuple
    #   (Gaussian band), or an ascending sequence of >= 2 inverse-CDF
    #   wavelength knots at uniform quantiles (arbitrary shapes)
    fluor_edge: float = 0.0    # absorption band edge [um]: only rays with
    #   wavelength < fluor_edge convert (the Stokes shift is what keeps
    #   emitted light from being endlessly re-absorbed). Default 0 =
    #   the smallest emission knot
    roughness: float = 0.0     # RMS surface micro-roughness sigma [um]
    #   of a MIRROR element (incl. metal mirrors). Splits each reflection
    #   into a specular child x (1 - TIS) and a near-specular scattered
    #   child x TIS with the Rayleigh-Rice total integrated scatter
    #   TIS = 1 - exp(-(4 pi sigma cos(theta_i) n / lambda)^2) —
    #   the standard stray-light / veiling-glare surface model
    roughness_lobe: float = 0.9  # Henyey-Greenstein anisotropy of the
    #   scattered lobe about the specular direction, in [0, 1);
    #   0.9+ = polished-surface near-specular halo, 0 = quasi-Lambertian
    grin_a: float = 0.0        # gradient-index coefficient A [1/len^2] of
    #   the radial-parabolic (SELFOC) profile n(rho)^2 = ior^2 (1 - A
    #   rho^2) about the element's `axis` through `grin_center`; `ior` is
    #   the on-axis index n0. A > 0 focuses (pitch 2 pi / sqrt(A)),
    #   A < 0 diverges. REFRACTIVE elements only; rays inside advance by
    #   exact closed-form SELFOC steps of TraceConfig.grin_step. Cannot combine with
    #   scattering/fluorescence/dispersion on the same element
    grin_center: Optional[np.ndarray] = None  # (3,) point on the profile
    #   axis (world frame); follows translate/rotate/scale with the mesh.
    #   Required when grin_a != 0

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float64)
        self.triangles = np.ascontiguousarray(self.triangles, dtype=np.int32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 3:
            raise ValueError(f"vertices must be (V, 3), got {self.vertices.shape}")
        if self.triangles.ndim != 2 or self.triangles.shape[1] != 3:
            raise ValueError(f"triangles must be (T, 3), got {self.triangles.shape}")
        if self.triangles.size and self.triangles.max() >= len(self.vertices):
            raise ValueError("triangle index out of range")
        self.material = Material.from_any(self.material)
        if self.axis is not None:
            a = np.asarray(self.axis, np.float64)
            n = np.linalg.norm(a)
            if n <= 0:
                raise ValueError("axis must be a nonzero vector")
            self.axis = a / n
        elif self.material in (Material.POLARIZER, Material.WAVEPLATE,
                               Material.GRATING, Material.BIREFRINGENT):
            raise ValueError(
                f"{self.material.name} elements need an `axis` vector")
        if self.material == Material.BIREFRINGENT:
            if self.ne <= 0 or self.ior <= 0:
                raise ValueError(
                    "BIREFRINGENT elements need both principal indices: "
                    "ior = n_o > 0 and ne = n_e > 0 (e.g. ior, ne = "
                    "materials.CALCITE)")
        elif self.ne != 0.0:
            raise ValueError("`ne` applies to BIREFRINGENT elements only")
        if self.scattering < 0:
            raise ValueError("scattering (mu_s) must be >= 0")
        if self.scattering > 0 and self.material != Material.REFRACTIVE:
            raise ValueError(
                "volume scattering applies to REFRACTIVE elements only "
                "(the turbid BULK of a dielectric; for surface scatter "
                "use material='diffuse')")
        if not -1.0 < self.scatter_g < 1.0:
            raise ValueError("scatter_g must be in (-1, 1)")
        if self.fluorescence < 0:
            raise ValueError("fluorescence (mu_f) must be >= 0")
        if self.fluorescence > 0:
            if self.material != Material.REFRACTIVE:
                raise ValueError(
                    "fluorescence applies to REFRACTIVE elements only "
                    "(the phosphor-loaded BULK of a dielectric)")
            if not 0.0 <= self.fluor_yield <= 1.0:
                raise ValueError("fluor_yield (quantum yield) must be "
                                 "in [0, 1]")
            if self.fluor_emission is None:
                raise ValueError(
                    "fluorescent elements need fluor_emission: a single "
                    "wavelength [um], a (mean, fwhm) Gaussian band, or "
                    "ascending inverse-CDF wavelength knots")
            self.emission_knots()  # validate eagerly
        elif self.fluor_emission is not None:
            raise ValueError(
                "fluor_emission applies to fluorescent elements only "
                "(set fluorescence = mu_f > 0)")
        if self.roughness < 0:
            raise ValueError("roughness (RMS sigma) must be >= 0")
        if self.roughness > 0 and self.material != Material.MIRROR:
            raise ValueError(
                "surface roughness applies to MIRROR elements only "
                "(for bulk scatter in dielectrics use `scattering`; for "
                "a fully diffuse surface use material='diffuse')")
        if not 0.0 <= self.roughness_lobe < 1.0:
            raise ValueError("roughness_lobe must be in [0, 1)")
        if self.grin_a != 0.0:
            if self.material != Material.REFRACTIVE:
                raise ValueError(
                    "gradient-index profiles apply to REFRACTIVE "
                    "elements only")
            if self.axis is None:
                raise ValueError("GRIN elements need an `axis` vector "
                                 "(the profile axis direction)")
            if self.grin_center is None:
                raise ValueError("GRIN elements need `grin_center` (a "
                                 "point on the profile axis)")
            if (self.scattering > 0 or self.fluorescence > 0
                    or self.dispersion_b != 0.0
                    or self.dispersion_c != 0.0):
                raise ValueError(
                    "GRIN elements cannot also be turbid / fluorescent / "
                    "dispersive (one bulk model per element)")
        if self.grin_center is not None:
            if self.grin_a == 0.0:
                raise ValueError(
                    "grin_center applies to GRIN elements only "
                    "(set grin_a != 0)")
            self.grin_center = np.asarray(self.grin_center,
                                          np.float64).reshape(3)
        if self.coat_thickness > 0:
            if self.material != Material.REFRACTIVE:
                raise ValueError(
                    "thin-film coatings (coat_thickness > 0) apply to "
                    "REFRACTIVE elements only")
            if self.coat_ior <= 1e-6:
                raise ValueError(
                    "coated elements need coat_ior > 0 (the film index)")
            if self.coating:
                raise ValueError(
                    "set either the single-layer coat_ior/coat_thickness "
                    "shorthand or the multilayer `coating` list, not both")
        elif self.coat_thickness < 0:
            raise ValueError("coat_thickness must be >= 0")
        if self.coating:
            if self.material != Material.REFRACTIVE:
                raise ValueError(
                    "multilayer coatings apply to REFRACTIVE elements only")
            clean = []
            for layer in self.coating:
                n_l, h_l = float(layer[0]), float(layer[1])
                if h_l < 0:
                    raise ValueError("coating layer thickness must be >= 0")
                if h_l > 0:
                    if n_l <= 1e-6:
                        raise ValueError("coating layer index must be > 0")
                    clean.append((n_l, h_l))
            self.coating = clean or None
        if not 0.0 <= self.order0_fraction <= 1.0:
            raise ValueError("order0_fraction must be in [0, 1]")
        if self.metal_n < 0 or self.metal_k < 0:
            raise ValueError("metal_n / metal_k must be >= 0")
        if (self.metal_n > 0 or self.metal_k > 0) and \
                self.material != Material.MIRROR:
            raise ValueError("metal_n/metal_k apply to MIRROR elements only")
        if self.metal_k > 0 and self.metal_n <= 0:
            raise ValueError("metal_k > 0 needs metal_n > 0")
        if self.material == Material.GRATING:
            if self.grating_period <= 0:
                raise ValueError(
                    "GRATING elements need grating_period > 0 [um]")
            # an axis parallel to every face normal has no tangential
            # component: the grating would silently act as a mirror
            fn = self.face_normals()
            tang = self.axis - (fn @ self.axis)[:, None] * fn
            if len(fn) and np.linalg.norm(tang, axis=1).max() < 1e-6:
                raise ValueError(
                    "grating axis is parallel to the surface normal — it "
                    "must have a tangential (in-surface) component")

    def coating_layers(self) -> list:
        """Normalized coating stack [(n, h_um), ...], outermost first;
        empty list when uncoated. The single-layer coat_ior/coat_thickness
        shorthand is folded in."""
        if self.coating:
            return list(self.coating)
        if self.coat_thickness > 0:
            return [(float(self.coat_ior), float(self.coat_thickness))]
        return []

    def emission_knots(self, n_knots: int = 9) -> np.ndarray:
        """Fluorescence emission spectrum as (n_knots,) inverse-CDF
        wavelength knots at uniform quantiles (what the device sampler
        linearly interpolates). Empty array when not fluorescent.

        Accepted `fluor_emission` forms: a single wavelength (delta line),
        a (mean_um, fwhm_um) pair (Gaussian band, quantiles truncated at
        +-0.5% tails), or an ascending knot sequence of >= 2 wavelengths
        (resampled to n_knots by linear quantile interpolation)."""
        em = self.fluor_emission
        if self.fluorescence <= 0 or em is None:
            return np.zeros((0,), np.float64)
        if np.isscalar(em):
            lam = float(em)
            if lam <= 0:
                raise ValueError("fluor_emission wavelength must be > 0")
            return np.full((n_knots,), lam, np.float64)
        arr = np.asarray(em, np.float64)
        if arr.shape == (2,) and arr[1] < arr[0]:
            # (mean, fwhm) Gaussian band — fwhm < mean distinguishes it
            # from a 2-knot spectrum, which would be ascending
            mean, fwhm = arr
            sigma = fwhm / 2.35482
        elif arr.ndim == 1 and len(arr) >= 2 and np.all(np.diff(arr) >= 0):
            if arr[0] <= 0:
                raise ValueError("emission knots must be > 0")
            q_in = np.linspace(0.0, 1.0, len(arr))
            q_out = np.linspace(0.0, 1.0, n_knots)
            return np.interp(q_out, q_in, arr)
        else:
            raise ValueError(
                "fluor_emission must be a wavelength, a (mean, fwhm) "
                "Gaussian pair (fwhm < mean), or ascending wavelength "
                "knots")
        if mean <= 0 or fwhm <= 0:
            raise ValueError("fluor_emission (mean, fwhm) must be > 0")
        # Gaussian inverse CDF via the probit rational approximation is
        # overkill here: sample the CDF densely and invert numerically
        grid = np.linspace(mean - 4 * sigma, mean + 4 * sigma, 2001)
        cdf = (0.5 * (1.0 + _erf((grid - mean) / (sigma * np.sqrt(2.0)))
                      )).astype(np.float64)
        q = np.linspace(0.005, 0.995, n_knots)
        knots = np.interp(q, cdf, grid)
        if knots[0] <= 0:
            raise ValueError("fluor_emission Gaussian extends below zero "
                             "wavelength; narrow the fwhm")
        return knots

    def fluor_edge_um(self) -> float:
        """Effective absorption band edge: explicit `fluor_edge`, else the
        smallest emission knot (guaranteed Stokes shift)."""
        if self.fluorescence <= 0:
            return 0.0
        if self.fluor_edge > 0:
            return float(self.fluor_edge)
        return float(self.emission_knots()[0])

    # ---- transforms (in place, chainable — reference style) -------------

    def translate(self, offset) -> "GeoObject":
        self.vertices = self.vertices + np.asarray(offset, dtype=np.float64)
        if self.grin_center is not None:
            self.grin_center = self.grin_center + np.asarray(
                offset, np.float64)
        return self

    def rotate(self, axis, angle: float, pivot=(0.0, 0.0, 0.0)) -> "GeoObject":
        """Rotate about `axis` by `angle` (radians) around point `pivot`."""
        R = rotation_matrix(axis, angle)
        pivot = np.asarray(pivot, dtype=np.float64)
        self.vertices = (self.vertices - pivot) @ R.T + pivot
        if self.axis is not None:
            self.axis = R @ self.axis
        if self.grin_center is not None:
            self.grin_center = R @ (self.grin_center - pivot) + pivot
        return self

    def scale(self, factor) -> "GeoObject":
        """Scale by a scalar or per-axis (3,) factor about the origin.

        A negative/odd reflection flips triangle winding to keep outward
        normals outward.
        """
        f = np.asarray(factor, dtype=np.float64)
        if f.ndim == 0:
            f = np.full(3, float(f))
        self.vertices = self.vertices * f
        if self.axis is not None:
            a = self.axis * f
            self.axis = a / np.linalg.norm(a)
        if self.grin_center is not None:
            if not np.allclose(f, f[0]):
                raise ValueError("GRIN elements support UNIFORM scaling "
                                 "only (the radial profile would shear)")
            self.grin_center = self.grin_center * f
            self.grin_a = self.grin_a / float(f[0]) ** 2
        if np.prod(np.sign(f)) < 0:
            self.triangles = self.triangles[:, ::-1].copy()
        return self

    def transformed(self, matrix: np.ndarray, offset=(0.0, 0.0, 0.0)) -> "GeoObject":
        """Pure-functional affine transform: returns a NEW GeoObject."""
        out = self.copy()
        m = np.asarray(matrix, np.float64)
        out.vertices = out.vertices @ m.T + np.asarray(offset, np.float64)
        if out.axis is not None:
            a = m @ out.axis
            out.axis = a / np.linalg.norm(a)
        if out.grin_center is not None:
            s2 = (m @ m.T).diagonal()
            if not (np.allclose(m @ m.T, np.eye(3) * s2[0])):
                raise ValueError("GRIN elements support rigid/uniformly-"
                                 "scaled transforms only")
            out.grin_center = m @ out.grin_center + np.asarray(
                offset, np.float64)
            out.grin_a = out.grin_a / float(s2[0])
        if np.linalg.det(m) < 0:
            out.triangles = out.triangles[:, ::-1].copy()
        return out

    def copy(self) -> "GeoObject":
        # dataclasses.replace copies EVERY field (a hand-written
        # positional constructor call silently dropped fields added
        # after it was written — ne, scattering, fluorescence, ...);
        # deep-copy the mutable ones
        out = dataclasses.replace(self)
        out.vertices = self.vertices.copy()
        out.triangles = self.triangles.copy()
        if self.axis is not None:
            out.axis = self.axis.copy()
        if self.coating is not None:
            out.coating = list(self.coating)
        return out

    # ---- derived quantities ---------------------------------------------

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def triangle_vertices(self) -> np.ndarray:
        """(T, 3, 3) per-triangle vertex positions."""
        return self.vertices[self.triangles]

    def face_normals(self, normalized: bool = True) -> np.ndarray:
        """(T, 3) outward face normals (CCW winding)."""
        tv = self.triangle_vertices()
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        if normalized:
            ln = np.linalg.norm(n, axis=1, keepdims=True)
            n = n / np.where(ln > 0, ln, 1.0)
        return n

    def area(self) -> float:
        tv = self.triangle_vertices()
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        return float(0.5 * np.linalg.norm(n, axis=1).sum())

    def bounds(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


def instances(obj: GeoObject, offsets, rotations=None,
              **overrides) -> GeoObject:
    """Replicate an element at many placements, merged into ONE GeoObject
    (extension over the reference: lens/mirror arrays without re-tessellating
    per copy — the tracer's flat triangle soup makes instancing free at
    trace time, it is purely a build-time vertex transform).

    offsets:   (N, 3) per-instance translations
    rotations: optional list of (axis, angle) per instance (applied about
               the instance's own origin, before translation)
    """
    offsets = np.asarray(offsets, np.float64).reshape(-1, 3)
    if rotations is not None and len(rotations) != len(offsets):
        raise ValueError("rotations must match offsets length")
    copies = []
    for i, off in enumerate(offsets):
        c = obj.copy()
        if rotations is not None and rotations[i] is not None:
            axis, angle = rotations[i]
            c.rotate(axis, angle)
        copies.append(c.translate(off))
    return merge(copies, **overrides)


def instance_grid(obj: GeoObject, nx: int, ny: int, pitch,
                  plane: str = "xy", centered: bool = True,
                  **overrides) -> GeoObject:
    """nx x ny rectangular array of an element (microlens arrays, mirror
    facets). `pitch` is a scalar or (pitch_x, pitch_y); `plane` picks the
    array plane ('xy', 'xz', 'yz'); `centered` places the grid centroid at
    the prototype's position."""
    if nx < 1 or ny < 1:
        raise ValueError("grid needs nx, ny >= 1")
    p = np.broadcast_to(np.asarray(pitch, np.float64), (2,))
    ij = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                              indexing="ij"), axis=-1).reshape(-1, 2)
    uv = ij * p
    if centered:
        uv = uv - np.array([(nx - 1) * p[0], (ny - 1) * p[1]]) / 2.0
    axes = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}
    if plane not in axes:
        raise ValueError(f"plane must be one of {sorted(axes)}")
    offsets = np.zeros((len(uv), 3))
    a, b = axes[plane]
    offsets[:, a] = uv[:, 0]
    offsets[:, b] = uv[:, 1]
    return instances(obj, offsets, **overrides)


def merge(objects: Iterable[GeoObject], **overrides) -> GeoObject:
    """Concatenate meshes into one GeoObject (material etc. from the first
    unless overridden)."""
    objs = list(objects)
    if not objs:
        raise ValueError("merge() needs at least one object")
    verts, tris, off = [], [], 0
    for o in objs:
        verts.append(o.vertices)
        tris.append(o.triangles + off)
        off += len(o.vertices)
    base = dict(
        material=objs[0].material,
        ior=objs[0].ior,
        reflectivity=objs[0].reflectivity,
        name=objs[0].name,
        dispersion_b=objs[0].dispersion_b,
        dispersion_c=objs[0].dispersion_c,
        absorption=objs[0].absorption,
        axis=objs[0].axis,
        retardance=objs[0].retardance,
        grating_period=objs[0].grating_period,
        grating_order=objs[0].grating_order,
        metal_n=objs[0].metal_n,
        metal_k=objs[0].metal_k,
        order0_fraction=objs[0].order0_fraction,
        coat_ior=objs[0].coat_ior,
        coat_thickness=objs[0].coat_thickness,
        coating=(None if objs[0].coating is None else list(objs[0].coating)),
    )
    base.update(overrides)
    return GeoObject(np.concatenate(verts), np.concatenate(tris), **base)
