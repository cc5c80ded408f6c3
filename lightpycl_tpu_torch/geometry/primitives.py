"""Parametric tessellated optical-element primitives.

Port counterpart of lightpycl_tpu/geometry/primitives.py: a jax-free copy
(tests/test_torch_host_layer.py pins its vertices bit for bit); only the
import root differs.

Reference parity: the `optical_elements` factory of geo_optical_elements.py
(SURVEY.md §3 "Primitive mesh factory" [recalled]): parabolic mirror,
spherical lenses, sphere / hemisphere (detector dome), cube, cylinder,
planes / discs, prism. Meshing is host-side numpy (cold path, f64); the
tracer consumes the flattened f32 arrays.

Conventions: right-handed, optical axis = +z, CCW winding = outward normal.
"""

from __future__ import annotations

import numpy as np

from lightpycl_tpu_torch.geometry.mesh import GeoObject, merge
from lightpycl_tpu_torch.materials import Material

_FLAT = None  # sentinel accepted for "infinite radius" lens surfaces


def _grid_triangles(nu: int, nv: int, wrap_u: bool = False) -> np.ndarray:
    """Triangulate an (nu x nv) vertex grid (row-major: index = u * nv + v).

    Quads split into two CCW triangles; `wrap_u` closes the u direction
    (surfaces of revolution).
    """
    tris = []
    u_max = nu if wrap_u else nu - 1
    for u in range(u_max):
        un = (u + 1) % nu
        for v in range(nv - 1):
            a = u * nv + v
            b = un * nv + v
            c = un * nv + v + 1
            d = u * nv + v + 1
            tris.append((a, b, c))
            tris.append((a, c, d))
    return np.asarray(tris, dtype=np.int32).reshape(-1, 3)


def revolve_profile(profile_rz, n_segments: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Revolve an (M, 2) profile of (r, z) points about the z axis.

    Returns (vertices, triangles). Points with r == 0 become poles (fan
    triangulation); degenerate triangles are dropped. With the profile
    ordered so that increasing index runs from "bottom" to "top", the outward
    normal points away from the axis for a convex profile.
    """
    prof = np.asarray(profile_rz, dtype=np.float64)
    if prof.ndim != 2 or prof.shape[1] != 2:
        raise ValueError("profile must be (M, 2) of (r, z)")
    M = len(prof)
    phi = np.linspace(0.0, 2.0 * np.pi, n_segments, endpoint=False)
    # ring vertices for every profile row (poles duplicated then welded)
    verts = np.empty((n_segments, M, 3))
    verts[:, :, 0] = np.cos(phi)[:, None] * prof[None, :, 0]
    verts[:, :, 1] = np.sin(phi)[:, None] * prof[None, :, 0]
    verts[:, :, 2] = prof[None, :, 1]
    tris = _grid_triangles(n_segments, M, wrap_u=True)
    V = verts.reshape(-1, 3)
    # weld pole rings (r == 0) into single vertices and drop degenerate tris
    V, tris = _weld(V, tris)
    return V, tris


def _weld(V: np.ndarray, T: np.ndarray, tol: float = 1e-12) -> tuple[np.ndarray, np.ndarray]:
    """Merge coincident vertices and drop zero-area triangles."""
    key = np.round(V / max(tol, 1e-12)).astype(np.int64)
    _, first, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    Vw = V[np.sort(first)]
    # remap "first occurrence" ordering so vertex order is stable
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    Tw = rank[inverse][T]
    # drop triangles with repeated vertices or ~zero area
    ok = (Tw[:, 0] != Tw[:, 1]) & (Tw[:, 1] != Tw[:, 2]) & (Tw[:, 0] != Tw[:, 2])
    Tw = Tw[ok]
    tv = Vw[Tw]
    area2 = np.linalg.norm(np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1)
    Tw = Tw[area2 > 1e-16]
    return Vw, np.ascontiguousarray(Tw, dtype=np.int32)


def _asphere_sag(r, R, k: float = 0.0, coeffs=()):
    """Even-asphere sag (optical-design standard):

        z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) + a4 r^4 + a6 r^6 + ...

    with c = 1/R (signed like _cap_profile: R > 0 curves toward +z), conic
    constant k (0 sphere, -1 paraboloid, < -1 hyperboloid), and `coeffs`
    the even polynomial terms (a4, a6, ...). R None/inf -> flat."""
    r = np.asarray(r, np.float64)
    if R is _FLAT or R is None or np.isinf(R):
        z = np.zeros_like(r)
    else:
        c = 1.0 / float(R)
        disc = 1.0 - (1.0 + k) * c * c * r * r
        if np.any(disc <= 0.0):
            raise ValueError("aspheric surface undefined at the aperture rim "
                             "(reduce aperture or |curvature|)")
        z = c * r * r / (1.0 + np.sqrt(disc))
    for i, a in enumerate(coeffs):
        z = z + a * r ** (4 + 2 * i)
    return z


def _asphere_profile(R, aperture_radius: float, z_vertex: float,
                     n_radial: int, k: float = 0.0, coeffs=()):
    r = np.linspace(0.0, aperture_radius, n_radial + 1)
    return np.stack([r, z_vertex + _asphere_sag(r, R, k, coeffs)], axis=1)


def _cap_profile(R: float, aperture_radius: float, z_vertex: float, n_radial: int):
    """(r, z) profile of a spherical cap: curvature radius R (signed, center
    of curvature at z_vertex + R), vertex at (0, z_vertex), rim at
    aperture_radius. R == None/inf -> flat disc profile."""
    r = np.linspace(0.0, aperture_radius, n_radial + 1)
    if R is _FLAT or R is None or np.isinf(R):
        z = np.full_like(r, z_vertex)
    else:
        if abs(R) < aperture_radius:
            raise ValueError("curvature radius smaller than aperture radius")
        z = z_vertex + R - np.sign(R) * np.sqrt(R * R - r * r)
    return np.stack([r, z], axis=1)


class OpticalElements:
    """Factory for tessellated optical elements (reference: the
    `optical_elements` factory class, geo_optical_elements.py [recalled])."""

    def __init__(self, n_segments: int = 64, n_radial: int = 16):
        self.n_segments = int(n_segments)
        self.n_radial = int(n_radial)

    # -- basic solids ------------------------------------------------------

    def sphere(self, radius: float = 1.0, center=(0, 0, 0),
               material=Material.TERMINATOR, ior: float = 1.5, **kw) -> GeoObject:
        th = np.linspace(0.0, np.pi, self.n_radial + 1)
        prof = np.stack([radius * np.sin(th), -radius * np.cos(th)], axis=1)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def hemisphere(self, radius: float = 1.0, center=(0, 0, 0),
                   material=Material.MEASURE, ior: float = 1.0, **kw) -> GeoObject:
        """Dome over z >= 0 — the reference's detector surface
        (BASELINE.json configs[0]): a measurement hemisphere capturing
        everything radiated into the upper half space."""
        th = np.linspace(np.pi / 2.0, 0.0, self.n_radial + 1)
        prof = np.stack([radius * np.sin(th), radius * np.cos(th)], axis=1)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def cube(self, size=1.0, center=(0, 0, 0),
             material=Material.TERMINATOR, ior: float = 1.5, **kw) -> GeoObject:
        s = np.broadcast_to(np.asarray(size, np.float64), (3,)) / 2.0
        sx, sy, sz = s
        V = np.array(
            [[-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
             [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz]]
        )
        T = np.array(
            [[0, 2, 1], [0, 3, 2],            # bottom (-z)
             [4, 5, 6], [4, 6, 7],            # top (+z)
             [0, 1, 5], [0, 5, 4],            # -y
             [2, 3, 7], [2, 7, 6],            # +y
             [1, 2, 6], [1, 6, 5],            # +x
             [3, 0, 4], [3, 4, 7]],           # -x
            dtype=np.int32,
        )
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def cylinder(self, radius: float = 1.0, height: float = 1.0, center=(0, 0, 0),
                 capped: bool = True, material=Material.TERMINATOR,
                 ior: float = 1.5, **kw) -> GeoObject:
        h = height / 2.0
        if capped:
            prof = [(0.0, -h), (radius, -h), (radius, h), (0.0, h)]
        else:
            prof = [(radius, -h), (radius, h)]
        V, T = revolve_profile(np.asarray(prof), self.n_segments)
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def disc(self, radius: float = 1.0, center=(0, 0, 0),
             material=Material.TERMINATOR, ior: float = 1.0, **kw) -> GeoObject:
        """Disc in the z=0 plane, outward normal +z."""
        prof = np.stack(
            [np.linspace(0.0, radius, self.n_radial + 1),
             np.zeros(self.n_radial + 1)], axis=1)
        V, T = revolve_profile(prof[::-1], self.n_segments)  # reversed: +z normal
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def annulus(self, r_inner: float, r_outer: float, center=(0, 0, 0),
                material=Material.TERMINATOR, ior: float = 1.0, **kw) -> GeoObject:
        """Flat ring in the z=0 plane (aperture stop / obstruction),
        outward normal +z."""
        if not 0.0 < r_inner < r_outer:
            raise ValueError("need 0 < r_inner < r_outer")
        r = np.linspace(r_outer, r_inner, self.n_radial + 1)
        prof = np.stack([r, np.zeros_like(r)], axis=1)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def aperture_stop(self, r_open: float, r_outer: float, center=(0, 0, 0),
                      **kw) -> GeoObject:
        """Absorbing ring with a clear hole of radius `r_open` — the optical
        bench aperture stop."""
        return self.annulus(r_open, r_outer, center, Material.TERMINATOR, **kw)

    def rectangle(self, width: float = 1.0, depth: float = 1.0, center=(0, 0, 0),
                  material=Material.TERMINATOR, ior: float = 1.0, **kw) -> GeoObject:
        """Rectangular plane in z=0, outward normal +z."""
        w, d = width / 2.0, depth / 2.0
        V = np.array([[-w, -d, 0], [w, -d, 0], [w, d, 0], [-w, d, 0]], dtype=np.float64)
        T = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
        return GeoObject(V, T, material, ior, **kw).translate(center)

    def extrude(self, polygon_xy, length: float, center=(0, 0, 0),
                material=Material.TERMINATOR, ior: float = 1.5, **kw) -> GeoObject:
        """Extrude a CCW 2D polygon along +z by `length` (prism generator)."""
        poly = np.asarray(polygon_xy, dtype=np.float64)
        n = len(poly)
        lo = np.concatenate([poly, np.full((n, 1), -length / 2.0)], axis=1)
        hi = np.concatenate([poly, np.full((n, 1), length / 2.0)], axis=1)
        V = np.concatenate([lo, hi])
        tris = []
        for i in range(n):  # side walls
            j = (i + 1) % n
            tris += [(i, j, n + j), (i, n + j, n + i)]
        for i in range(1, n - 1):  # caps (fan; assumes convex polygon)
            tris += [(0, i + 1, i), (n, n + i, n + i + 1)]
        return GeoObject(V, np.asarray(tris, np.int32), material, ior, **kw).translate(center)

    def prism(self, width: float = 1.0, height: float = 1.0, length: float = 1.0,
              material=Material.REFRACTIVE, ior: float = 1.5, **kw) -> GeoObject:
        """Triangular (dispersion-style) prism: isoceles cross-section of
        base `width` and apex `height` in the xy plane, extruded along z."""
        poly = [(-width / 2.0, 0.0), (width / 2.0, 0.0), (0.0, height)]
        return self.extrude(poly, length, material=material, ior=ior, **kw)

    def cylindrical_lens(self, r: float, aperture: float = 1.0,
                         thickness: float = 0.2, length: float = 1.0,
                         ior: float = 1.5, center=(0, 0, 0),
                         **kw) -> GeoObject:
        """Plano-convex CYLINDRICAL lens (extension: line-focus optics —
        laser-sheet generators, anamorphic pairs, astigmatism demos).

        Powered in x only: flat entrance face in the z = 0 plane, circular-
        arc exit surface of radius `r` with vertex at z = `thickness`,
        extruded `length` along y (the unpowered axis). A collimated +z
        beam focuses to a LINE parallel to y at the plano-convex focal
        distance f = r / (n - 1) behind the exit vertex; the y extent is
        untouched. `aperture` is the full x width (chord), so r >= a/2.
        """
        a = aperture / 2.0
        if r <= a:
            raise ValueError("cylindrical_lens needs r > aperture/2")
        sag = r - np.sqrt(r * r - a * a)
        if sag >= thickness:
            raise ValueError(
                "edge thickness <= 0: increase `thickness` or `r`")
        # CCW cross-section in xy (y becomes the optical z after the
        # rotation below): flat base, then the FULL arc from +a back to -a
        # (arc already contains both rim corner points, at y > 0, so none
        # duplicate the base vertices)
        xs = np.linspace(a, -a, self.n_radial + 1)
        arc = [(x, thickness - (r - np.sqrt(r * r - x * x))) for x in xs]
        poly = [(-a, 0.0), (a, 0.0)] + arc
        obj = self.extrude(poly, length, material=Material.REFRACTIVE,
                           ior=ior, **kw)
        # rotate +90 deg about x: polygon y -> +z (flat entrance in the
        # z = 0 plane, arc vertex at z = +thickness), extrusion z -> -y
        # (symmetric, so the length stays centered)
        obj.rotate((1, 0, 0), np.pi / 2.0)
        return obj.translate(center)

    # -- optical surfaces ----------------------------------------------------

    def parabolic_mirror(self, focus: float = 1.0, diameter: float = 2.0,
                         reflectivity: float = 0.98, center=(0, 0, 0),
                         **kw) -> GeoObject:
        """Paraboloid z = r^2 / (4 f), dish opening toward +z, focal point at
        (0, 0, f). A point source at the focus collimates into +z — the
        reference's headline example (BASELINE.json configs[0])."""
        r = np.linspace(diameter / 2.0, 0.0, self.n_radial + 1)
        prof = np.stack([r, r * r / (4.0 * focus)], axis=1)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(
            V, T, Material.MIRROR, 1.0, reflectivity=reflectivity, **kw
        ).translate(center)

    def spherical_mirror(self, r: float, diameter: float,
                         reflectivity: float = 0.98, center=(0, 0, 0),
                         **kw) -> GeoObject:
        """Spherical cap mirror: vertex at the origin, center of
        curvature at (0, 0, r) — r > 0 is concave toward +z (paraxial
        focus at r/2, with the classic marginal-ray spherical
        aberration the Schmidt corrector exists to cancel —
        examples/example_schmidt.py)."""
        a = diameter / 2.0
        prof = _cap_profile(r, a, 0.0, self.n_radial)[::-1]
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, Material.MIRROR, 1.0,
                         reflectivity=reflectivity, **kw).translate(center)

    def conic_mirror(self, r, diameter: float, k: float = 0.0, coeffs=(),
                     hole_diameter: float = 0.0, reflectivity: float = 0.98,
                     center=(0, 0, 0), **kw) -> GeoObject:
        """Conic/even-asphere mirror z = _asphere_sag(rho; 1/r, k, coeffs):
        vertex at the origin, r signed like `spherical_mirror` (r > 0
        concave toward +z), conic k (0 sphere, -1 paraboloid, < -1
        hyperboloid — the Cassegrain secondary), optional even-asphere
        terms, and an optional central hole (`hole_diameter`) for
        catadioptric layouts where light passes through the primary
        (telescope `.zmx` import, io/zmx.py). r None/inf with a hole is
        the flat annular fold mirror."""
        a = diameter / 2.0
        r0 = hole_diameter / 2.0
        if not 0.0 <= r0 < a:
            raise ValueError("need 0 <= hole_diameter < diameter")
        rho = np.linspace(a, r0, self.n_radial + 1)
        if r0 == 0.0:
            rho[-1] = 0.0  # exact apex
        z = _asphere_sag(rho, r, k, coeffs)
        V, T = revolve_profile(np.stack([rho, z], axis=1), self.n_segments)
        return GeoObject(V, T, Material.MIRROR, 1.0,
                         reflectivity=reflectivity, **kw).translate(center)

    def spherical_lens(self, r1, r2, aperture: float, thickness: float,
                       ior: float = 1.5, center=(0, 0, 0), **kw) -> GeoObject:
        """Spherical lens on the z axis: front vertex at z=0, back vertex at
        z=thickness, aperture diameter `aperture`.

        Sign convention (lensmaker): r1 / r2 are the curvature radii of the
        front / back surface; the center of curvature sits at vertex + r.
        r = None or +/-inf means flat. Biconvex example: r1 > 0, r2 < 0.
        Thin-lens focal length: 1/f = (n-1) (1/r1 - 1/r2).
        """
        a = aperture / 2.0
        front = _cap_profile(r1, a, 0.0, self.n_radial)
        back = _cap_profile(r2, a, thickness, self.n_radial)
        z1, z2 = front[-1, 1], back[-1, 1]
        if z2 < z1 - 1e-12:
            raise ValueError("lens surfaces intersect: increase thickness")
        # z2 == z1 is a knife edge: rims coincide and weld shut
        # profile runs front vertex -> front rim -> (edge wall) -> back rim
        # -> back vertex; revolved CCW this makes normals point outward.
        prof = np.concatenate([front, back[::-1]], axis=0)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, Material.REFRACTIVE, ior, **kw).translate(center)

    def plano_convex_lens(self, r: float, aperture: float, thickness: float,
                          ior: float = 1.5, **kw) -> GeoObject:
        """Flat front, convex back (r2 = -r): BASELINE.json configs[1]."""
        return self.spherical_lens(_FLAT, -abs(r), aperture, thickness, ior, **kw)

    def biconvex_lens(self, r: float, aperture: float, thickness: float,
                      ior: float = 1.5, **kw) -> GeoObject:
        return self.spherical_lens(abs(r), -abs(r), aperture, thickness, ior, **kw)

    def aspheric_lens(self, r1, r2, aperture: float, thickness: float,
                      ior: float = 1.5, k1: float = 0.0, k2: float = 0.0,
                      coeffs1=(), coeffs2=(), center=(0, 0, 0),
                      **kw) -> GeoObject:
        """Even-asphere lens (extension beyond the reference's spherical
        factory — SURVEY.md §3 row 'Primitive mesh factory'): each surface is

            z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) + a4 r^4 + ...

        with the same signed-radius convention as spherical_lens (which this
        reduces to for k = 0 and no polynomial terms). k = -1 is a
        paraboloid; k = -n^2 on the exit surface of a plano-convex singlet
        (flat side toward a collimated beam) gives stigmatic (aberration-
        free) focus — tested in tests/test_asphere.py."""
        a = aperture / 2.0
        front = _asphere_profile(r1, a, 0.0, self.n_radial, k1, coeffs1)
        back = _asphere_profile(r2, a, thickness, self.n_radial, k2, coeffs2)
        z1, z2 = front[-1, 1], back[-1, 1]
        if z2 < z1 - 1e-12:
            raise ValueError("lens surfaces intersect: increase thickness")
        prof = np.concatenate([front, back[::-1]], axis=0)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, Material.REFRACTIVE, ior, **kw).translate(center)


    def fresnel_lens(self, r: float, aperture: float, thickness: float,
                     n_grooves: int = 8, ior: float = 1.5,
                     center=(0, 0, 0), **kw) -> GeoObject:
        """Plano-Fresnel lens: the collapse of a plano-convex singlet
        (flat front at z = 0, curvature radius `r` on the back) into
        `n_grooves` equal-width annular grooves cut into a slab of
        `thickness`. Each groove keeps the PARENT surface's exact local
        curvature — within zone j the back surface is

            z(rho) = thickness - (s(rho) - s(rho_j)),   s = |r| - sqrt(r^2 - rho^2)

        so every refracting facet bends rays exactly like the parent lens
        (thin-lens focal length f = |r| / (n - 1)); the vertical risers
        between zones are modeled too (they are the real stray-light
        mechanism of molded Fresnel optics). The slab must be thicker than
        the deepest groove: thickness > s(a) - s(a - a/n_grooves).

        Extension beyond the reference factory (SURVEY.md §3 'Primitive
        mesh factory' lists spherical lenses only)."""
        a = aperture / 2.0
        R = abs(r)
        if R < a:
            raise ValueError("curvature radius smaller than aperture radius")

        def sag(rho):
            return R - np.sqrt(np.maximum(R * R - rho * rho, 0.0))

        edges = np.linspace(0.0, a, n_grooves + 1)
        depth_max = float(np.max(sag(edges[1:]) - sag(edges[:-1])))
        if thickness <= depth_max * (1 + 1e-9):
            raise ValueError(
                f"thickness {thickness} does not clear the deepest groove "
                f"({depth_max:.4g}): thicken the slab or add grooves")
        # per-zone curved facet samples + a same-radius riser point back
        # up to the slab plane (two consecutive profile points at equal r
        # revolve into the vertical riser wall)
        n_sub = max(2, int(np.ceil((self.n_radial + 1) / n_grooves)))
        back = [(0.0, thickness)]
        for j in range(n_grooves):
            rho = np.linspace(edges[j], edges[j + 1], n_sub + 1)[1:]
            z = thickness - (sag(rho) - sag(edges[j]))
            back.extend(zip(rho, z))
            if j + 1 < n_grooves:
                back.append((edges[j + 1], thickness))  # riser
        back = np.asarray(back)
        front = np.stack([np.linspace(0.0, a, self.n_radial + 1),
                          np.zeros(self.n_radial + 1)], axis=1)
        # front vertex -> front rim -> (edge wall) -> back rim -> vertex,
        # the spherical_lens ordering that keeps normals outward
        prof = np.concatenate([front, back[::-1]], axis=0)
        V, T = revolve_profile(prof, self.n_segments)
        return GeoObject(V, T, Material.REFRACTIVE, ior, **kw).translate(center)

    def axicon(self, diameter: float, cone_angle: float,
               thickness: float = 0.1, ior: float = 1.5,
               center=(0, 0, 0), **kw) -> GeoObject:
        """Conical (axicon) lens: flat front disc at z = 0, conical back
        surface with base angle `cone_angle` [rad] rising to the apex on
        the axis at z = thickness + (diameter/2) tan(cone_angle).

        A collimated +z beam refracts toward the axis by the exact
        wedge deviation delta = asin(n sin a) - a (thin-axicon limit
        (n-1) a), crossing the axis over an extended LINE focus and
        forming the annular far field axicons exist for (Bessel-beam
        generators, ring illumination, corneal surgery optics)."""
        if not 0.0 < cone_angle < np.pi / 2:
            raise ValueError("cone_angle must be in (0, pi/2)")
        a = diameter / 2.0
        ta = np.tan(cone_angle)
        r_f = np.linspace(0.0, a, self.n_radial + 1)
        front = np.stack([r_f, np.zeros_like(r_f)], axis=1)
        r_b = np.linspace(a, 0.0, self.n_radial + 1)
        back = np.stack([r_b, thickness + (a - r_b) * ta], axis=1)
        V, T = revolve_profile(np.concatenate([front, back]),
                               self.n_segments)
        return GeoObject(V, T, Material.REFRACTIVE, ior,
                         **kw).translate(center)

    def corner_cube(self, size: float = 1.0, center=(0, 0, 0),
                    reflectivity: float = 1.0, **kw) -> GeoObject:
        """Hollow corner-cube retroreflector: three mutually
        perpendicular mirror squares (side `size`) meeting at the corner
        point, opening toward (+1, +1, +1). Any ray that strikes all
        three faces leaves EXACTLY anti-parallel to its arrival
        direction regardless of orientation — the survey-marker /
        lunar-ranging element (tests/test_retro_axicon.py)."""
        s = float(size)
        V = np.array([
            [0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s],   # x = 0 face
            [0, 0, 0], [s, 0, 0], [s, 0, s], [0, 0, s],   # y = 0 face
            [0, 0, 0], [s, 0, 0], [s, s, 0], [0, s, 0],   # z = 0 face
        ], np.float64)
        T = np.array([(0, 1, 2), (0, 2, 3), (4, 5, 6), (4, 6, 7),
                      (8, 9, 10), (8, 10, 11)], np.int32)
        return GeoObject(V, T, Material.MIRROR, 1.0,
                         reflectivity=reflectivity, **kw).translate(center)

    def zernike_mirror(self, aperture: float, coeffs: dict,
                       reflectivity: float = 0.98, center=(0, 0, 0),
                       **kw) -> GeoObject:
        """Freeform mirror: sag z(rho, theta) = sum_j c_j Z_j(rho/a, theta)
        over the circular aperture (radius a = aperture/2), with Z_j the
        Noll-indexed, Noll-NORMALIZED Zernike polynomials of
        analysis.zernike_value — the same convention analysis.zernike_fit
        recovers, so design and measurement speak one language.

        `coeffs` maps Noll index -> coefficient in scene length units
        (each coefficient IS its term's RMS surface deviation). Extension
        beyond the reference's rotationally-symmetric factory (SURVEY.md
        §3 'Primitive mesh factory'): freeform/off-axis optics.
        Example: {2: 1e-3} tilts the surface; {4: c} focuses at
        f = a^2 / (8 sqrt(3) c) (tests/test_freeform.py)."""
        a = aperture / 2.0
        sag = _zernike_sag_fn(coeffs, a)
        rows = [(r, sag) for r in np.linspace(a, 0.0, self.n_radial + 1)]
        V, T = _revolve_rows(rows, self.n_segments)
        return GeoObject(V, T, Material.MIRROR, 1.0,
                         reflectivity=reflectivity, **kw).translate(center)

    def zernike_plate(self, aperture: float, thickness: float,
                      coeffs: dict, ior: float = 1.5, center=(0, 0, 0),
                      **kw) -> GeoObject:
        """Refractive window with a flat front disc at z = 0 and a
        freeform back surface z = thickness + sum_j c_j Z_j(rho/a, theta)
        (Noll-normalized, like zernike_mirror). A thin plate imprints the
        wavefront error W ~= (n - 1) sag onto a transmitted beam, so
        analysis.zernike_fit on the traced OPL recovers (n-1) * coeffs —
        the closed design->trace->measure loop tests/test_freeform.py
        pins. Phase plates, corrector plates, deliberate-aberration test
        optics."""
        a = aperture / 2.0
        sag = _zernike_sag_fn(coeffs, a)
        phi_probe = np.linspace(0.0, 2.0 * np.pi, 256)
        rim = sag(a * np.cos(phi_probe), a * np.sin(phi_probe))
        if thickness + rim.min() <= 0.0:
            raise ValueError(
                "freeform back surface dips through the front plane at "
                "the rim: increase thickness or shrink the coefficients")
        front = [(r, 0.0) for r in np.linspace(0.0, a, self.n_radial + 1)]
        back = [(r, lambda x, y, r=r: thickness + sag(x, y))
                for r in np.linspace(a, 0.0, self.n_radial + 1)]
        V, T = _revolve_rows(front + back, self.n_segments)
        return GeoObject(V, T, Material.REFRACTIVE, ior,
                         **kw).translate(center)


def _zernike_sag_fn(coeffs: dict, a: float):
    """sag(x, y) = sum_j c_j Z_j(rho/a, theta) as a vectorized callable
    (Noll indices/normalization from analysis.zernike_value)."""
    from lightpycl_tpu_torch.analysis import zernike_value

    items = sorted((int(j), float(c)) for j, c in coeffs.items())
    if not items or items[0][0] < 1:
        raise ValueError("coeffs: {noll_index (>= 1): coefficient}")

    def sag(x, y):
        rho = np.hypot(x, y) / a
        theta = np.arctan2(y, x)
        z = np.zeros_like(rho)
        for j, c in items:
            z = z + c * zernike_value(j, rho, theta)
        return z

    return sag


def _revolve_rows(rows, n_segments: int):
    """Like revolve_profile, but each row's z may be a callable z(x, y)
    (freeform surfaces: z varies with azimuth). rows = [(r, z), ...]
    ordered like a revolve profile ("bottom to top" for outward
    normals); r == 0 rows weld to poles."""
    phi = np.linspace(0.0, 2.0 * np.pi, n_segments, endpoint=False)
    M = len(rows)
    verts = np.empty((n_segments, M, 3))
    for k, (r, z) in enumerate(rows):
        x, y = np.cos(phi) * r, np.sin(phi) * r
        verts[:, k, 0] = x
        verts[:, k, 1] = y
        verts[:, k, 2] = z(x, y) if callable(z) else z
    tris = _grid_triangles(n_segments, M, wrap_u=True)
    return _weld(verts.reshape(-1, 3), tris)


def optical_elements(n_segments: int = 64, n_radial: int = 16) -> OpticalElements:
    """Reference-shaped constructor (geo_optical_elements.optical_elements)."""
    return OpticalElements(n_segments=n_segments, n_radial=n_radial)


__all__ = ["OpticalElements", "optical_elements", "revolve_profile", "merge"]
