"""First-order (paraxial / ABCD) optics utilities.

Port counterpart of lightpycl_tpu/paraxial.py: a copy, plain numpy
(tests/test_torch_paraxial.py pins it to the reference).

Textbook ray-transfer matrices for the same parameterizations the
primitive factory uses (`geometry/primitives.py`), so a mesh-traced
system can be cross-checked against its Gaussian-optics prediction in a
microsecond: focal lengths, back/front focal distances, principal
planes, magnification, and cardinal points of arbitrary element stacks.

Extension over the reference (SURVEY.md lists no first-order tools —
the reference validates by plotting traced rays). The ray state is the
column vector (y, u) with u = n * dy/dz the REDUCED slope, so matrices
have unit determinant and compose by plain matrix products: the
convention of Gerrard & Burch. All functions are pure numpy/host — this
is design-time analysis, not a device path.

Conventions match `OpticalElements.spherical_lens`: light travels +z,
curvature radius R > 0 when the center of curvature lies AFTER the
vertex (so a biconvex lens is r1 > 0, r2 < 0), and n is the index AFTER
the surface.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "propagation", "refraction", "thin_lens", "mirror", "grin_rod",
    "thick_lens", "compose", "system_properties", "trace_ray",
    "seidel", "seidel_singlet",
]


def propagation(d: float, n: float = 1.0) -> np.ndarray:
    """Free propagation over axial distance d in a medium of index n
    (reduced-slope convention: the translation entry is d / n)."""
    return np.array([[1.0, d / n], [0.0, 1.0]])


def refraction(R: float, n1: float, n2: float) -> np.ndarray:
    """Refraction at a spherical interface of curvature radius R (signed;
    None / inf = flat) from index n1 into n2: power P = (n2 - n1) / R."""
    if R is None or np.isinf(R):
        P = 0.0
    else:
        P = (n2 - n1) / R
    return np.array([[1.0, 0.0], [-P, 1.0]])


def thin_lens(f: float) -> np.ndarray:
    """Ideal thin lens of focal length f."""
    return np.array([[1.0, 0.0], [-1.0 / f, 1.0]])


def mirror(R: float = None) -> np.ndarray:
    """Spherical mirror of curvature radius R (None/inf = flat), SIGNED:
    R > 0 = concave (converging, f = R/2), R < 0 = convex (diverging,
    f = R/2 < 0); power P = 2 n / R (n = 1 assumed around the mirror).
    Fold the path straight as usual in ABCD analysis, so subsequent
    propagation() runs in ordinary +z — this mirror-local sign convention
    is therefore distinct from refraction()'s center-after-vertex one."""
    if R is None or np.isinf(R):
        return np.eye(2)
    return np.array([[1.0, 0.0], [-2.0 / R, 1.0]])


def grin_rod(length: float, n0: float, a: float) -> np.ndarray:
    """SELFOC rod INTERIOR of `length` with profile
    n(rho)^2 = n0^2 (1 - a rho^2) (the GeoObject.grin_a parameterization;
    paraxial gradient constant g = sqrt(a)). Does NOT include the end-face
    refractions — compose with refraction(None, 1, n0) / (None, n0, 1)
    for a rod in air, exactly like the traced element."""
    g = np.sqrt(abs(a))
    gl = g * length
    if a > 0:
        c, s = np.cos(gl), np.sin(gl)
        return np.array([[c, s / (n0 * g)], [-n0 * g * s, c]])
    if a < 0:
        c, s = np.cosh(gl), np.sinh(gl)
        return np.array([[c, s / (n0 * g)], [n0 * g * s, c]])
    return propagation(length, n0)


def thick_lens(r1, r2, thickness: float, n: float,
               n_env: float = 1.0) -> np.ndarray:
    """Full thick-lens matrix, vertex to vertex — the exact paraxial
    model of `spherical_lens(r1, r2, aperture, thickness, ior=n)`."""
    return compose(
        refraction(r1, n_env, n),
        propagation(thickness, n),
        refraction(r2, n, n_env),
    )


def compose(*matrices: np.ndarray) -> np.ndarray:
    """Compose element matrices IN THE ORDER LIGHT MEETS THEM (first
    argument first): returns M_k ... M_2 M_1."""
    M = np.eye(2)
    for m in matrices:
        M = np.asarray(m) @ M
    return M


def system_properties(M: np.ndarray, n_in: float = 1.0,
                      n_out: float = 1.0) -> dict:
    """Cardinal points of a system matrix (input vertex -> output vertex).

    Returns dict with:
      'efl'  effective focal length (image side; f = -n_out / C)
      'bfd'  back focal distance: output vertex -> rear focal point
      'ffd'  front focal distance: front focal point -> input vertex
             (positive when the focal point lies BEFORE the vertex)
      'pp1'  front principal plane, measured from the input vertex (+z)
      'pp2'  rear principal plane, measured from the output vertex (+z)
      'power' n_out / efl

    Raises for afocal systems (C == 0)."""
    A, B = float(M[0, 0]), float(M[0, 1])
    C, D = float(M[1, 0]), float(M[1, 1])
    if abs(C) < 1e-15:
        raise ValueError("afocal system (C == 0): no finite focal length")
    efl = -n_out / C
    bfd = -n_out * A / C
    ffd = -n_in * D / C
    return {
        "efl": efl,
        "bfd": bfd,
        "ffd": ffd,
        "pp2": bfd - efl,            # rear principal plane vs output vertex
        # front principal plane vs input vertex: H1 = n_in (D - 1) / C,
        # i.e. front focal length (n_in/n_out) efl FORWARD from the front
        # focal point, which sits `ffd` BEFORE the vertex.
        "pp1": (n_in / n_out) * efl - ffd,
        "power": n_out / efl,
    }


def trace_ray(M: np.ndarray, y: float, slope: float,
              n_in: float = 1.0):
    """Push a paraxial ray (height y, GEOMETRIC slope dy/dz) through M;
    returns (y_out, reduced_slope_out). Divide by the exit index for the
    geometric slope."""
    y2, u2 = M @ np.array([y, n_in * slope])
    return float(y2), float(u2)


# -- third-order (Seidel) aberration sums ------------------------------------

def seidel(curvatures, spacings, indices, *, y, u, ybar, ubar,
           delta_n=None):
    """Seidel third-order aberration sums for a centered system of
    spherical refracting surfaces (extension: the reference has no
    aberration theory — SURVEY.md L5 lists only traced-spot analysis;
    this is the standard design-time complement, cross-checked against
    the exact tracer in tests/test_paraxial.py).

    Surface-by-surface refraction-invariant form (Welford, *Aberrations
    of Optical Systems*, ch. 8): a paraxial MARGINAL ray ``(y, u)`` and
    CHIEF ray ``(ybar, ubar)`` — heights and GEOMETRIC slopes dy/dz just
    before the first surface — are traced through the prescription, and
    each surface contributes

        A    = n (c y + u)            (refraction invariant, = n i)
        Abar = n (c ybar + ubar)
        S1_j = -A^2    y  d(u/n)      (spherical)
        S2_j = -A Abar y  d(u/n)      (coma)
        S3_j = -Abar^2 y  d(u/n)      (astigmatism)
        S4_j = -H^2    c  d(1/n)      (Petzval field curvature)
        S5_j = (Abar/A) (S3_j + S4_j) (distortion)

    with d(x) = x_after - x_before and the Lagrange invariant
    H = n (ubar y - u ybar) (constant through the system).

    Args:
      curvatures: per-surface curvature c = 1/R (0.0 for flat); R > 0
        when the center of curvature lies after the vertex, matching
        `refraction` and `OpticalElements.spherical_lens`.
      spacings: axial gaps AFTER each surface except the last
        (len = len(curvatures) - 1); pass [] for a single surface.
      indices: refractive indices [n_before_first, n_after_1, ...,
        n_after_last] (len = len(curvatures) + 1).
      y, u, ybar, ubar: marginal/chief ray state at the first surface.
      delta_n: optional per-space dispersions dn = n_F - n_C (same
        length/order as `indices`, 0.0 for air/vacuum). When given, the
        first-order chromatic sums are returned too:

            CL_j = A    y d(dn/n)     (axial / longitudinal color)
            CT_j = Abar y d(dn/n)     (lateral / transverse color)

        Longitudinal chromatic focal shift (F minus C, at the image):
        dz = -CL / (n_out u_out^2); lateral color image-height shift:
        dy = -CT / (n_out u_out). Thin lens in air: CL = y^2 phi / V
        with V the Abbe number — zero for an achromat (sum phi_i/V_i
        = 0; tests/test_paraxial.py::TestChromatic).

    Returns dict with 'S1'..'S5' (system sums), 'per_surface' ((5, k)
    array), 'H', and the exit marginal state 'y_out'/'u_out' (plus
    'CL'/'CT' when delta_n is given). Wavefront
    aberration at full aperture: W = S1/8 sigma^4 + ... (Welford eq.
    8.35); transverse marginal spherical at paraxial focus
    eps = S1 / (2 n_out u_out), longitudinal LSA = -S1 / (2 n_out
    u_out^2) (signed along +z: negative = marginal focus short, the
    undercorrected singlet case).

    NOTE on stop position: place the chief ray so ybar = 0 at the
    aperture stop. S1..S4 need any two independent rays; only S5 (and
    the split of S2/S3) depends on the stop through (ybar, ubar).

    MIRRORS use the standard folded convention: a reflection is a
    "refraction" into n' = -n (e.g. a first-surface concave mirror in
    air facing the incoming light is curvature +1/R with indices
    [1, -1]); spacings after an odd number of reflections are measured
    NEGATIVE. Anchors: the spherical mirror reproduces LSA = -y^2/(4R)
    and Petzval S4 = 2 H^2 / R, and a stop at the center of curvature
    zeros S2/S3/S5 exactly (the Schmidt-camera principle) —
    tests/test_paraxial.py::TestSeidelMirror.
    """
    c_arr = [0.0 if (r is None) else float(r) for r in curvatures]
    k = len(c_arr)
    if len(indices) != k + 1:
        raise ValueError(f"indices must have {k + 1} entries, got "
                         f"{len(indices)}")
    if len(spacings) != max(k - 1, 0):
        raise ValueError(f"spacings must have {k - 1} entries, got "
                         f"{len(spacings)}")
    if delta_n is not None and len(delta_n) != k + 1:
        raise ValueError(f"delta_n must have {k + 1} entries, got "
                         f"{len(delta_n)}")
    y, u, ybar, ubar = (float(v) for v in (y, u, ybar, ubar))
    n = float(indices[0])
    H = n * (ubar * y - u * ybar)
    per = np.zeros((5, k))
    CL = CT = 0.0
    for j in range(k):
        c, n2 = c_arr[j], float(indices[j + 1])
        A = n * (c * y + u)
        Abar = n * (c * ybar + ubar)
        u2 = A / n2 - c * y            # n' u' = n u - y c (n' - n)
        ubar2 = Abar / n2 - c * ybar
        d_un = u2 / n2 - u / n
        d_inv_n = 1.0 / n2 - 1.0 / n
        s1 = -A * A * y * d_un
        s2 = -A * Abar * y * d_un
        s3 = -Abar * Abar * y * d_un
        s4 = -H * H * c * d_inv_n
        s5 = (Abar / A) * (s3 + s4) if abs(A) > 1e-300 else 0.0
        per[:, j] = (s1, s2, s3, s4, s5)
        if delta_n is not None:
            d_dn = float(delta_n[j + 1]) / n2 - float(delta_n[j]) / n
            CL += A * y * d_dn
            CT += Abar * y * d_dn
        u, ubar, n = u2, ubar2, n2
        if j < k - 1:
            d = float(spacings[j])
            y += d * u
            ybar += d * ubar
    S = per.sum(axis=1)
    out = {
        "S1": float(S[0]), "S2": float(S[1]), "S3": float(S[2]),
        "S4": float(S[3]), "S5": float(S[4]),
        "per_surface": per, "H": H,
        "y_out": y, "u_out": u, "n_out": n,
    }
    if delta_n is not None:
        out["CL"], out["CT"] = CL, CT
    return out


def seidel_singlet(r1, r2, thickness: float, n: float, *, y: float,
                   n_env: float = 1.0, stop_at_lens: bool = True,
                   ubar: float = 0.0):
    """Seidel sums of the `spherical_lens(r1, r2, ..., thickness, ior=n)`
    singlet for a marginal ray parallel to the axis at height `y`
    (object at infinity). With stop_at_lens the chief ray crosses the
    axis at the front vertex with slope `ubar` (field angle)."""
    c1 = 0.0 if (r1 is None or np.isinf(r1)) else 1.0 / r1
    c2 = 0.0 if (r2 is None or np.isinf(r2)) else 1.0 / r2
    if not stop_at_lens:
        raise ValueError("only stop_at_lens=True is provided; call "
                         "seidel() directly for a remote stop")
    return seidel([c1, c2], [thickness], [n_env, n, n_env],
                  y=y, u=0.0, ybar=0.0, ubar=ubar)
