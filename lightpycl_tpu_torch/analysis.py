"""Post-processing & analysis: directivity binning, beam statistics, plots.

Port counterpart of lightpycl_tpu/analysis.py, the whole module: numpy
copies of the reference's functions (tests/test_torch_analysis_rest.py and
test_torch_spectral.py pin them bit for bit). The differences: the
functions that read a `Scene` (`surface_flux`, `plot_surface_flux`) take
its torch tensors to the host first, and `field_sweep` traces on the
port's `Tracer` on the device it is given (`device=`, default CUDA).
`TraceResult` fields are numpy in the port, so everything else runs
unchanged. matplotlib is imported lazily, so the core has no hard
plotting dependency.

Reference parity: the measured-ray getters, spherical directivity histogram,
3-D scene+ray plots, and beam statistics of iterative_tracer.py (SURVEY.md
§3 'Measurement & directivity analysis', §4.4). Binning runs in numpy on
harvested rays (matching reference semantics); the fast path is the
on-device histogram in tracer/step.py.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def spherical_angles(vectors: np.ndarray):
    """(azimuth [0, 2pi), polar [0, pi]) of (N, 3) vectors."""
    v = np.asarray(vectors, np.float64)
    n = np.linalg.norm(v, axis=1)
    n = np.where(n > 0, n, 1.0)
    az = np.arctan2(v[:, 1], v[:, 0])
    az = np.where(az < 0, az + 2 * np.pi, az)
    pol = np.arccos(np.clip(v[:, 2] / n, -1.0, 1.0))
    return az, pol


def directivity_histogram(vectors, powers, n_azimuth: int = 36, n_polar: int = 18,
                          solid_angle_normalize: bool = False):
    """Bin power over direction into an (n_azimuth, n_polar) histogram.

    `vectors` are hit positions (relative to the detector center) or ray
    directions. With solid_angle_normalize, values become intensity
    (power / steradian) — the reference's directivity quantity.
    Returns (hist, azimuth_edges, polar_edges).
    """
    az, pol = spherical_angles(vectors)
    az_edges = np.linspace(0.0, 2 * np.pi, n_azimuth + 1)
    pol_edges = np.linspace(0.0, np.pi, n_polar + 1)
    hist, _, _ = np.histogram2d(az, pol, bins=[az_edges, pol_edges],
                                weights=np.asarray(powers, np.float64))
    if solid_angle_normalize:
        dphi = az_edges[1] - az_edges[0]
        domega = dphi * (np.cos(pol_edges[:-1]) - np.cos(pol_edges[1:]))  # (n_polar,)
        hist = hist / np.maximum(domega[None, :], 1e-30)
    return hist, az_edges, pol_edges


def polar_directivity(vectors, powers, n_polar: int = 90,
                      solid_angle_normalize: bool = True):
    """Azimuth-integrated directivity I(polar) — the reference's headline
    polar plot. Returns (intensity (n_polar,), polar_bin_centers)."""
    _, pol = spherical_angles(vectors)
    edges = np.linspace(0.0, np.pi, n_polar + 1)
    hist, _ = np.histogram(pol, bins=edges, weights=np.asarray(powers, np.float64))
    if solid_angle_normalize:
        domega = 2 * np.pi * (np.cos(edges[:-1]) - np.cos(edges[1:]))
        hist = hist / np.maximum(domega, 1e-30)
    return hist, 0.5 * (edges[:-1] + edges[1:])


def spectral_power(wavelengths, powers, band_edges):
    """Total measured power per wavelength band (dispersion runs).

    band_edges: (B+1,) ascending wavelengths [um]. Returns ((B,) powers,
    (B,) band centers)."""
    edges = np.asarray(band_edges, np.float64)
    hist, _ = np.histogram(np.asarray(wavelengths, np.float64), bins=edges,
                           weights=np.asarray(powers, np.float64))
    return hist, 0.5 * (edges[:-1] + edges[1:])


# ---- colorimetry ---------------------------------------------------------
# CIE 1931 2-degree color-matching functions as the piecewise-Gaussian
# analytic fits of Wyman, Sloan & Shirley (JCGT 2013) — max error < 1% of
# peak, no lookup table to ship. Wavelengths in the framework's um.
# Accuracy note: the error bound is ABSOLUTE (fraction of peak), so
# broadband colorimetry (the use case: LED/phosphor spectra, CCT) is
# solid, but the chromaticity of a MONOCHROMATIC line deeper than
# ~650 nm drifts off the spectral locus (both CMFs are < 1% of peak
# there, so their ratio is fit-noise-dominated).

def _pw_gauss(lam_nm, mu, s1, s2):
    """exp(-(x-mu)^2 / 2 sigma^2) with sigma = s1 left of mu, s2 right."""
    t = (lam_nm - mu) / np.where(lam_nm < mu, s1, s2)
    return np.exp(-0.5 * t * t)


def cie_xyz_cmf(wavelengths_um):
    """CIE 1931 color-matching functions (x̄, ȳ, z̄) at the given vacuum
    wavelengths [um]. Returns an (N, 3) array."""
    lam = np.asarray(wavelengths_um, np.float64) * 1e3  # nm
    xb = (1.056 * _pw_gauss(lam, 599.8, 37.9, 31.0)
          + 0.362 * _pw_gauss(lam, 442.0, 16.0, 26.7)
          - 0.065 * _pw_gauss(lam, 501.1, 20.4, 26.2))
    yb = (0.821 * _pw_gauss(lam, 568.8, 46.9, 40.5)
          + 0.286 * _pw_gauss(lam, 530.9, 16.3, 31.1))
    zb = (1.217 * _pw_gauss(lam, 437.0, 11.8, 36.0)
          + 0.681 * _pw_gauss(lam, 459.0, 26.0, 13.8))
    return np.stack([xb, yb, zb], axis=-1)


def cie_xyz(wavelengths, powers):
    """Tristimulus (X, Y, Z) of a measured ray bundle: per-ray radiant
    power weighted by the CIE 1931 CMFs (so Y is luminous flux up to the
    683 lm/W constant). Feed `result.measured_wavelength` and
    `result.measured_power` from any spectral / dispersive / fluorescent
    trace."""
    cmf = cie_xyz_cmf(wavelengths)
    p = np.asarray(powers, np.float64)
    return tuple((cmf * p[:, None]).sum(axis=0))


def luminous_flux(wavelengths, powers):
    """Photometric flux [lm] of a measured bundle: 683 lm/W x the
    V(lambda)-weighted (CIE ybar) radiant power. The companion
    `luminous_efficacy` = lm per radiant watt (683 x ybar at 555 nm,
    ~100-350 lm/W for white LED spectra)."""
    _, Y, _ = cie_xyz(wavelengths, powers)
    return 683.002 * Y


def luminous_efficacy(wavelengths, powers):
    """Luminous efficacy of radiation [lm/W]: luminous_flux / radiant
    power (0 for an empty or zero-power bundle)."""
    total = float(np.asarray(powers, np.float64).sum())
    if total <= 0:
        return 0.0
    return luminous_flux(wavelengths, powers) / total


def chromaticity(wavelengths, powers):
    """CIE 1931 (x, y) chromaticity coordinates of a measured bundle."""
    X, Y, Z = cie_xyz(wavelengths, powers)
    s = X + Y + Z
    if s <= 0:
        return 0.0, 0.0
    return X / s, Y / s


def cct(x, y):
    """Correlated color temperature [K] from (x, y) via McCamy's cubic
    (accurate to ~±2% for 2000-12500 K near the Planckian locus)."""
    n = (x - 0.3320) / (0.1858 - y)
    return 449.0 * n**3 + 3525.0 * n**2 + 6823.3 * n + 5520.33


def srgb(wavelengths, powers, normalize=True):
    """Gamma-encoded sRGB triple of a measured bundle (D65 linear-sRGB
    matrix, components clipped to [0, 1]; `normalize` scales so the
    largest linear channel is 1 — color, not absolute level)."""
    X, Y, Z = cie_xyz(wavelengths, powers)
    m = np.array([[3.2406, -1.5372, -0.4986],
                  [-0.9689, 1.8758, 0.0415],
                  [0.0557, -0.2040, 1.0570]])
    rgb = m @ np.array([X, Y, Z], np.float64)
    if normalize and rgb.max() > 0:
        rgb = rgb / rgb.max()
    rgb = np.clip(rgb, 0.0, 1.0)
    return tuple(np.where(rgb <= 0.0031308, 12.92 * rgb,
                          1.055 * rgb ** (1 / 2.4) - 0.055))


def degree_of_polarization(stokes_fractions, powers=None):
    """Power-weighted degree of polarization of a measured bundle:
    |sum(S_vec)| / sum(S0), with stokes_fractions (N, 3) = S/S0 per ray."""
    s = np.asarray(stokes_fractions, np.float64)
    p = np.ones(len(s)) if powers is None else np.asarray(powers, np.float64)
    total = p.sum()
    if total <= 0 or len(s) == 0:
        return 0.0
    svec = (s * p[:, None]).sum(axis=0)
    return float(np.linalg.norm(svec) / total)


def beam_statistics(directions, powers) -> dict:
    """Power-weighted beam statistics of a measured ray bundle: mean
    direction, RMS divergence half-angle (radians), total power."""
    d = np.asarray(directions, np.float64)
    p = np.asarray(powers, np.float64)
    total = p.sum()
    if total <= 0 or len(d) == 0:
        return {"total_power": 0.0, "mean_direction": np.zeros(3),
                "rms_divergence": 0.0, "count": 0}
    mean = (d * p[:, None]).sum(axis=0) / total
    norm = np.linalg.norm(mean)
    mean_u = mean / norm if norm > 0 else np.array([0.0, 0.0, 1.0])
    cosang = np.clip(d @ mean_u, -1.0, 1.0)
    ang = np.arccos(cosang)
    rms = float(np.sqrt((p * ang**2).sum() / total))
    return {"total_power": float(total), "mean_direction": mean_u,
            "rms_divergence": rms, "count": int(len(d))}


def spot_diagram(positions, directions, z_plane: float, powers=None):
    """Transverse ray intersections with the plane z = z_plane (optical-
    design spot diagram; extension beyond the reference's directivity
    analysis). Rays are propagated analytically from their measured
    (position, direction); rays parallel to the plane are dropped.

    Returns dict with 'xy' (M, 2) intercepts, 'centroid' (2,), and
    power-weighted 'rms_radius' about the centroid."""
    pos = np.asarray(positions, np.float64)
    d = np.asarray(directions, np.float64)
    p = (np.ones(len(pos)) if powers is None
         else np.asarray(powers, np.float64))
    ok = np.abs(d[:, 2]) > 1e-12
    pos, d, p = pos[ok], d[ok], p[ok]
    t = (z_plane - pos[:, 2]) / d[:, 2]
    xy = pos[:, :2] + t[:, None] * d[:, :2]
    total = p.sum()
    if total <= 0 or len(xy) == 0:
        return {"xy": np.zeros((0, 2)), "centroid": np.zeros(2),
                "rms_radius": 0.0}
    c = (xy * p[:, None]).sum(axis=0) / total
    r2 = ((xy - c) ** 2).sum(axis=1)
    return {"xy": xy, "centroid": c,
            "rms_radius": float(np.sqrt((p * r2).sum() / total))}


def best_focus(positions, directions, powers=None, z_range=None,
               n_scan: int = 101, refine: int = 3):
    """Plane of minimum power-weighted RMS spot radius along z (coarse scan
    + golden-ratio-free bracket refinement). `z_range` defaults to the
    span of the ray z positions extended forward one span.

    Returns (z_best, rms_at_best)."""
    pos = np.asarray(positions, np.float64)
    if len(pos) == 0:
        raise ValueError("best_focus needs at least one ray (did a "
                         "direction/detector filter drop everything?)")
    if z_range is None:
        zlo, zhi = float(pos[:, 2].min()), float(pos[:, 2].max())
        span = max(zhi - zlo, 1.0)
        z_range = (zlo, zhi + span)
    lo, hi = map(float, z_range)
    for _ in range(refine):
        zs = np.linspace(lo, hi, n_scan)
        rms = np.array([spot_diagram(pos, directions, z, powers)["rms_radius"]
                        for z in zs])
        i = int(np.argmin(rms))
        lo = zs[max(i - 1, 0)]
        hi = zs[min(i + 1, n_scan - 1)]
    return float(zs[i]), float(rms[i])


def wavefront_error(opl, powers=None, wavelength=None):
    """RMS optical-path-difference of a measured bundle (extension): OPD is
    each ray's accumulated optical path length minus the power-weighted
    mean. For a stigmatic system sampled on a sphere centered at the focus,
    OPD -> 0 (Fermat); aberrations show up directly in length units.

    Returns dict with 'opd' (per-ray, mean-removed), 'rms' and 'pv'
    (peak-to-valley) in length units, plus 'rms_waves' when `wavelength`
    (same units) is given — the standard wavefront-error metric."""
    opl = np.asarray(opl, np.float64)
    p = (np.ones(len(opl)) if powers is None
         else np.asarray(powers, np.float64))
    total = p.sum()
    if total <= 0 or len(opl) == 0:
        return {"opd": np.zeros(0), "rms": 0.0, "pv": 0.0}
    opd = opl - (opl * p).sum() / total
    rms = float(np.sqrt((p * opd**2).sum() / total))
    out = {"opd": opd, "rms": rms,
           "pv": float(opd.max() - opd.min())}
    if wavelength is not None:
        out["rms_waves"] = rms / float(wavelength)
    return out


def opd_on_reference_sphere(positions, directions, opl, focus, radius=None,
                            ior_env: float = 1.0):
    """Optical path difference of measured rays evaluated on the reference
    sphere centered at `focus` (the standard wavefront-error reference
    surface). Each measured ray (position on the detector, direction,
    accumulated OPL) is propagated BACKWARD along its straight path to the
    sphere |x - focus| = radius; the OPL at that crossing, mean-removed, is
    the wavefront error. For a stigmatic bundle it vanishes identically
    (Fermat); aberrations appear in length units.

    radius defaults to the mean distance of the ray positions from focus.
    Returns (opd (N,), t (N,) signed back-propagation distances).
    """
    pos = np.asarray(positions, np.float64)
    d = np.asarray(directions, np.float64)
    opl = np.asarray(opl, np.float64)
    f = np.asarray(focus, np.float64)
    rel = pos - f
    if radius is None:
        radius = float(np.linalg.norm(rel, axis=1).mean())
    # |rel + t d|^2 = R^2, unit d: t^2 + 2 (d.rel) t + |rel|^2 - R^2 = 0
    b = (d * rel).sum(axis=1)
    c = (rel**2).sum(axis=1) - radius**2
    disc = np.maximum(b * b - c, 0.0)
    t = -b - np.sqrt(disc)  # upstream crossing (toward the pupil)
    opd = opl + ior_env * t
    return opd - opd.mean(), t


def noll_to_nm(j: int):
    """Noll index j (1-based) -> (n, m) Zernike orders. j=1 piston,
    2/3 tilt, 4 defocus, 5/6 astigmatism, 7/8 coma, 11 primary spherical."""
    if j < 1:
        raise ValueError("Noll index starts at 1")
    n = 0
    j1 = j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (-1) ** j * ((n % 2) + 2 * ((j1 + ((n + 1) % 2)) // 2))
    return n, m


def zernike_value(j: int, rho, theta):
    """Noll-normalized Zernike polynomial Z_j on the unit disc: the
    normalization makes each coefficient equal the RMS wavefront
    contribution of its term."""
    n, m = noll_to_nm(j)
    am = abs(m)
    rho = np.asarray(rho, np.float64)
    R = np.zeros_like(rho)
    from math import factorial

    for k in range((n - am) // 2 + 1):
        coef = ((-1) ** k * factorial(n - k)
                / (factorial(k) * factorial((n + am) // 2 - k)
                   * factorial((n - am) // 2 - k)))
        R = R + coef * rho ** (n - 2 * k)
    if m == 0:
        return np.sqrt(n + 1.0) * R
    ang = np.cos(am * theta) if m > 0 else np.sin(am * theta)
    return np.sqrt(2.0 * (n + 1.0)) * R * ang


#: human names for the low Noll orders
ZERNIKE_NAMES = {1: "piston", 2: "tilt x", 3: "tilt y", 4: "defocus",
                 5: "astigmatism 45", 6: "astigmatism 0", 7: "coma y",
                 8: "coma x", 9: "trefoil y", 10: "trefoil x",
                 11: "spherical"}


def zernike_fit(pupil_xy, opd, n_terms: int = 11, powers=None,
                radius=None):
    """Weighted least-squares Zernike decomposition of a wavefront.

    pupil_xy: (N, 2) transverse pupil coordinates of each ray; normalized
    by `radius` (default: max radial extent) onto the unit disc.
    opd:      (N,) wavefront error per ray (e.g. opd_on_reference_sphere).
    n_terms:  fit Noll terms 1..n_terms.

    Returns dict with 'coeffs' (n_terms,) — Noll-normalized, so each entry
    IS that term's RMS contribution — 'residual_rms', 'radius', and
    'names'. Extension over the reference (which has no wavefront
    analysis); standard optical-design practice (Noll, JOSA 66, 1976).
    """
    xy = np.asarray(pupil_xy, np.float64)
    opd = np.asarray(opd, np.float64)
    if len(xy) < n_terms:
        raise ValueError(f"need >= {n_terms} rays to fit {n_terms} terms")
    p = np.ones(len(xy)) if powers is None else np.asarray(powers, np.float64)
    r = np.linalg.norm(xy, axis=1)
    if radius is None:
        radius = float(r.max()) or 1.0
    rho = r / radius
    theta = np.arctan2(xy[:, 1], xy[:, 0])
    A = np.stack([zernike_value(j, rho, theta)
                  for j in range(1, n_terms + 1)], axis=1)
    w = np.sqrt(p / max(p.sum(), 1e-300))
    coeffs, *_ = np.linalg.lstsq(A * w[:, None], opd * w, rcond=None)
    resid = opd - A @ coeffs
    rms = float(np.sqrt((p * resid**2).sum() / max(p.sum(), 1e-300)))
    return {"coeffs": coeffs, "residual_rms": rms, "radius": radius,
            "names": [ZERNIKE_NAMES.get(j, f"Z{j}")
                      for j in range(1, n_terms + 1)]}


def geometric_mtf(xy, powers=None, freqs=None, axis=0):
    """Geometric (diffraction-free) modulation transfer function of a spot:
    |sum_k p_k exp(-2 pi i f x_k)| / sum_k p_k along the given axis — the
    modulus of the line-spread function's Fourier transform. Valid where
    geometric blur dominates diffraction. Returns (freqs, mtf).
    """
    xy = np.asarray(xy, np.float64)
    x = xy[:, axis] if xy.ndim == 2 else xy
    p = np.ones(len(x)) if powers is None else np.asarray(powers, np.float64)
    x = x - (x * p).sum() / max(p.sum(), 1e-300)
    if freqs is None:
        ext = max(float(np.abs(x).max()), 1e-12)
        freqs = np.linspace(0.0, 2.0 / ext, 64)
    freqs = np.asarray(freqs, np.float64)
    ph = np.exp(-2j * np.pi * freqs[:, None] * x[None, :])
    mtf = np.abs(ph @ p) / max(p.sum(), 1e-300)
    return freqs, mtf


def pupil_grid(pupil_xy, opd, powers=None, n_grid: int = 64, radius=None):
    """Bin traced rays onto a uniform pupil grid: per-cell amplitude
    A = sqrt(power) and mean OPD. Returns (A (G, G), opd_mean (G, G),
    cell pitch, radius); empty cells have A = 0. The sampling step from
    per-ray data to the physical-optics pupil function.

    Rays OUTSIDE the grid (|x| or |y| > radius — vignetted/ghost rays
    when an explicit design-pupil radius is passed) are DROPPED, not
    clipped into the rim cells: piling their power and OPD onto the
    boundary corrupts the pupil function (same floor+mask+drop binning as
    the detector image in tracer/step.accumulate_detector)."""
    xy = np.asarray(pupil_xy, np.float64)
    opd = np.asarray(opd, np.float64)
    p = np.ones(len(xy)) if powers is None else np.asarray(powers, np.float64)
    r = np.linalg.norm(xy, axis=1)
    if radius is None:
        radius = float(r.max()) or 1.0
    pitch = 2.0 * radius / n_grid
    ix = np.floor((xy[:, 0] + radius) / pitch).astype(int)
    iy = np.floor((xy[:, 1] + radius) / pitch).astype(int)
    inside = ((ix >= 0) & (ix < n_grid) & (iy >= 0) & (iy < n_grid))
    ix, iy, p, opd = ix[inside], iy[inside], p[inside], opd[inside]
    flat = ix * n_grid + iy
    psum = np.bincount(flat, weights=p, minlength=n_grid * n_grid)
    osum = np.bincount(flat, weights=p * opd, minlength=n_grid * n_grid)
    A = np.sqrt(psum).reshape(n_grid, n_grid)
    om = np.divide(osum, psum, out=np.zeros_like(osum),
                   where=psum > 0).reshape(n_grid, n_grid)
    return A, om, pitch, radius


def diffraction_psf(pupil_xy, opd, wavelength, powers=None, n_grid: int = 64,
                    pad: int = 4, focal_length=None, radius=None):
    """Physical-optics point-spread function from traced wavefront data
    (Fraunhofer/Fourier optics): the pupil function P = A exp(-2 pi i
    OPD / lambda) — amplitude from ray power, phase from the traced OPD
    (e.g. opd_on_reference_sphere) — is FFT'd to the image plane.
    Complements geometric_mtf/spot_diagram where blur is NEAR the
    diffraction limit and ray density alone misleads. Extension: the
    reference has no wavefront or diffraction analysis.

    All lengths share units (this package: um for wavelength, so pass
    pupil/focal lengths in um for physical image coordinates).

    Returns dict:
      psf (N, N)      intensity, normalized to the DIFFRACTION-LIMITED
                      on-axis peak of the same amplitude distribution.
                      psf.max() equals `strehl` only when the peak sits
                      at the reference focus — a tilted wavefront
                      displaces the peak (psf.max() ~ 1) while `strehl`
                      reports the reference point
      strehl          |sum A e^{i phi}|^2 / (sum A)^2 — exact pupil-sum
                      Strehl ratio at the reference focus
      x (N,)          image-plane coordinate axis (needs focal_length;
                      angular units of lambda/D otherwise)
      cutoff_freq     D / (lambda f) when focal_length is given
    """
    A, om, pitch, radius = pupil_grid(pupil_xy, opd, powers, n_grid, radius)
    wavelength = float(wavelength)
    phase = np.exp(-2j * np.pi * om / wavelength)
    P = A * phase
    N = pad * n_grid
    field = np.fft.fftshift(np.fft.fft2(P, s=(N, N)))
    psf = np.abs(field) ** 2
    ideal_peak = float(A.sum()) ** 2
    psf /= max(ideal_peak, 1e-300)
    strehl = float(np.abs(P.sum()) ** 2 / max(ideal_peak, 1e-300))
    # image-plane pitch: dx = lambda f / (N * pupil_pitch)
    if focal_length is not None:
        dx = wavelength * float(focal_length) / (N * pitch)
        cutoff = 2.0 * radius / (wavelength * float(focal_length))
    else:
        dx = wavelength / (N * pitch)      # angular [rad] per pixel
        cutoff = 2.0 * radius / wavelength
    x = (np.arange(N) - N // 2) * dx
    return {"psf": psf, "strehl": strehl, "x": x, "pixel": dx,
            "cutoff_freq": cutoff, "radius": radius}


def diffraction_mtf(pupil_xy, opd, wavelength, powers=None, n_grid: int = 64,
                    pad: int = 4, focal_length=None, radius=None,
                    n_freq: int = 48):
    """Radially-averaged diffraction MTF |OTF| from the traced wavefront:
    the PSF's Fourier modulus, normalized to OTF(0) = 1. For a perfect
    circular pupil this is the classic (2/pi)(acos v - v sqrt(1-v^2))
    curve, reaching zero at the cutoff D/(lambda f). Returns (freqs, mtf)
    with freqs in cycles per length unit when focal_length is given
    (cycles per radian otherwise)."""
    out = diffraction_psf(pupil_xy, opd, wavelength, powers, n_grid, pad,
                          focal_length, radius)
    psf = out["psf"]
    N = psf.shape[0]
    otf = np.abs(np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(psf))))
    otf /= max(otf[N // 2, N // 2], 1e-300)
    df = 1.0 / (N * out["pixel"])
    fx = (np.arange(N) - N // 2) * df
    FX, FY = np.meshgrid(fx, fx, indexing="ij")
    fr = np.hypot(FX, FY)
    freqs = np.linspace(0.0, out["cutoff_freq"], n_freq)
    half = 0.5 * (freqs[1] - freqs[0]) if n_freq > 1 else df
    mtf = np.array([otf[np.abs(fr - f) <= max(half, df)].mean()
                    for f in freqs])
    return freqs, mtf


def encircled_energy(positions, powers, center=None, radii=None,
                     plane_normal=(0, 0, 1)):
    """Fraction of total power within transverse radius r of `center`
    (default: power centroid), for each r in `radii` (default: 32 radii to
    the farthest ray). Returns (radii, fractions) — fractions are
    monotonically nondecreasing and reach 1.0 at the last radius."""
    pos = np.asarray(positions, np.float64)
    p = np.asarray(powers, np.float64)
    n = np.asarray(plane_normal, np.float64)
    n = n / np.linalg.norm(n)
    # transverse components: subtract the along-normal part
    tv = pos - np.outer(pos @ n, n)
    total = p.sum()
    if center is None:
        center = (tv * p[:, None]).sum(axis=0) / max(total, 1e-300)
    r = np.linalg.norm(tv - np.asarray(center, np.float64), axis=1)
    if radii is None:
        radii = np.linspace(0.0, float(r.max()) if len(r) else 1.0, 32)
    radii = np.asarray(radii, np.float64)
    frac = np.array([p[r <= rad].sum() for rad in radii]) / max(total, 1e-300)
    return radii, frac


def intensity_map(positions, powers, plane_normal=(0, 0, 1), plane_point=(0, 0, 0),
                  half_extent: float = 1.0, bins: int = 128):
    """2-D intensity map of hit positions projected onto a plane — the
    reference's focal-plane intensity map (BASELINE configs[1]).
    Returns (image (bins, bins), x_edges, y_edges)."""
    p = np.asarray(positions, np.float64) - np.asarray(plane_point, np.float64)
    w = np.asarray(plane_normal, np.float64)
    w = w / np.linalg.norm(w)
    a = np.array([1.0, 0, 0]) if abs(w[0]) < 0.9 else np.array([0.0, 1, 0])
    u = np.cross(a, w); u /= np.linalg.norm(u)
    v = np.cross(w, u)
    x, y = p @ u, p @ v
    edges = np.linspace(-half_extent, half_extent, bins + 1)
    img, _, _ = np.histogram2d(x, y, bins=[edges, edges],
                               weights=np.asarray(powers, np.float64))
    return img, edges, edges


def illuminance_map(positions, powers, wavelengths=None, lm_per_watt=None,
                    plane_normal=(0, 0, 1), plane_point=(0, 0, 0),
                    half_extent: float = 1.0, bins: int = 64):
    """Photometric illuminance [lux = lm/m^2] on a detector plane.

    The photometric companion of `intensity_map`: per-ray radiant power is
    converted to lumens (CIE V(lambda) weighting when `wavelengths` [um]
    are given, else a flat `lm_per_watt`, default 683.002 = powers treated
    as photopic watts) and divided by the pixel area — scene lengths are
    taken as meters (LM-63 units type 2, matching io/ies.py).
    Returns (lux (bins, bins), x_edges, y_edges)."""
    from lightpycl_tpu_torch.io.ies import _lumens_per_ray

    lm = _lumens_per_ray(powers, wavelengths, lm_per_watt)
    img, xe, ye = intensity_map(positions, lm, plane_normal=plane_normal,
                                plane_point=plane_point,
                                half_extent=half_extent, bins=bins)
    pixel_area = (xe[1] - xe[0]) * (ye[1] - ye[0])
    return img / pixel_area, xe, ye


# ---------------------------------------------------------------------------
# Plots (lazy matplotlib; reference: plot_measured_directivity /
# plot_elements_and_rays, SURVEY.md §3)
# ---------------------------------------------------------------------------

def fiber_coupling(field, halfwidth, mode_waist, center=(0.0, 0.0),
                   tilt=(0.0, 0.0), wavelength=None) -> float:
    """Power coupling efficiency into a single-mode fiber's LP01
    (Gaussian) mode from a coherent image-plane field:

        eta = |<psi, U>|^2 / (<U, U> <psi, psi>)

    field:      (B, B) complex field at the fiber face — a coherent
                trace's `TraceResult.image_complex`, sampled on the
                +-halfwidth pixel grid (the `image_*` plane).
    mode_waist: 1/e^2 AMPLITUDE radius w0 of the mode field (MFD / 2).
    center:     transverse mode offset (same units as halfwidth).
    tilt:       angular misalignment [rad] per transverse axis, applied
                as the mode's phase ramp (needs `wavelength`, same
                length units as the grid... wavelength in the SAME units
                as halfwidth).

    Analytic behavior (pinned in tests/test_fiber.py): matched Gaussian
    -> 1; lateral offset dx -> exp(-dx^2 / w0^2); waist mismatch
    (w_b, w0) -> (2 w_b w0 / (w_b^2 + w0^2))^2; tilt theta ->
    exp(-(pi w0 theta / lambda)^2). Extension over the reference (no
    wavefront/coupling analysis); standard fiber-optics overlap
    integral.

    NOTE on ray-sampled fields: the coherent accumulator bins
    sum sqrt(P_i) e^{i phi} per pixel, so the binned amplitude is
    (ray density) x sqrt(ray power). For the binned field to be
    proportional to the physical E(r), sample UNIFORM ray density and
    carry the beam profile in the POWERS — exactly what
    CollimatedSource(sampling='hexapolar', profile='gaussian') does —
    and keep >= ~10 rays per occupied pixel: at sparse occupancy the
    count x sqrt(P) binning inflates <U, U> by E[c^2]/E[c]^2 and biases
    eta low (measured: 0.83 instead of ~1 at one ray per pixel)."""
    U = np.asarray(field, np.complex128)
    B = U.shape[0]
    xs = (np.arange(B) + 0.5) / B * 2.0 * halfwidth - halfwidth
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    w0 = float(mode_waist)
    psi = np.exp(-((X - center[0]) ** 2 + (Y - center[1]) ** 2) / w0**2)
    if tilt[0] != 0.0 or tilt[1] != 0.0:
        if not wavelength:
            raise ValueError("tilt needs `wavelength` (same units as "
                             "the image grid)")
        k = 2.0 * np.pi / float(wavelength)
        psi = psi * np.exp(1j * k * (tilt[0] * X + tilt[1] * Y))
    num = np.abs(np.vdot(psi, U)) ** 2
    den = np.vdot(U, U).real * np.vdot(psi, psi).real
    if den <= 0.0:
        raise ValueError("empty field or degenerate mode")
    return float(num / den)


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_measured_directivity(vectors, powers, n_polar: int = 45, ax=None,
                              show: bool = False, path: str | None = None):
    """Polar directivity plot of measured rays (reference-shaped)."""
    plt = _plt()
    inten, centers = polar_directivity(vectors, powers, n_polar)
    if ax is None:
        _, ax = plt.subplots(subplot_kw={"projection": "polar"})
    ax.plot(centers, inten)
    ax.plot(-centers, inten)  # mirror for the traditional antenna-style plot
    ax.set_title("measured directivity (power / sr)")
    if path:
        ax.figure.savefig(path, dpi=120)
    if show:
        plt.show()
    return ax


def plot_directivity_3d(vectors, powers, n_azimuth: int = 36, n_polar: int = 18,
                        ax=None, show: bool = False, path: str | None = None):
    """3-D surface plot of the directivity distribution: radius proportional
    to intensity per direction (the reference's 3-D directivity figure,
    SURVEY.md §3 'Measurement & directivity analysis')."""
    plt = _plt()
    hist, az_edges, pol_edges = directivity_histogram(
        vectors, powers, n_azimuth, n_polar, solid_angle_normalize=True
    )
    az_c = 0.5 * (az_edges[:-1] + az_edges[1:])
    pol_c = 0.5 * (pol_edges[:-1] + pol_edges[1:])
    AZ, POL = np.meshgrid(az_c, pol_c, indexing="ij")
    R = hist / max(hist.max(), 1e-30)
    X = R * np.sin(POL) * np.cos(AZ)
    Y = R * np.sin(POL) * np.sin(AZ)
    Z = R * np.cos(POL)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    ax.plot_surface(X, Y, Z, cmap="viridis", linewidth=0)
    ax.set_title("directivity (normalized intensity surface)")
    if path:
        ax.figure.savefig(path, dpi=120)
    if show:
        plt.show()
    return ax


def plot_elements_and_rays(elements, segments, max_rays: int = 200, ax=None,
                           show: bool = False, path: str | None = None):
    """3-D wireframe of scene elements + traced ray segments.

    `segments` is TraceResult.segments: [(starts (C,3), ends (C,3),
    alive (C,))] per iteration (record_paths=True).
    """
    plt = _plt()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    for el in elements:
        if getattr(el, "quad_abgd", None) is not None:
            # analytic surface: draw a tessellation, not the placeholder
            el = el.to_mesh()
        tv = el.triangle_vertices()
        stride = max(1, len(tv) // 400)
        for tri in tv[::stride]:
            loop = np.vstack([tri, tri[:1]])
            ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], lw=0.3, color="gray")
    for starts, ends, alive in segments:
        idx = np.nonzero(alive)[0][:max_rays]
        for i in idx:
            ax.plot([starts[i, 0], ends[i, 0]], [starts[i, 1], ends[i, 1]],
                    [starts[i, 2], ends[i, 2]], lw=0.5, color="tab:orange")
    if path:
        ax.figure.savefig(path, dpi=120)
    if show:
        plt.show()
    return ax


# --------------------------------------------------------------------------
# Per-facet incident-flux / irradiance maps (TraceConfig.flux_map)
# --------------------------------------------------------------------------

def surface_flux(tri_flux, scene, element_names=None):
    """Turn a flux-map trace's per-triangle incident power into an
    irradiance map.

    Args:
      tri_flux: (T,) incident power per scene triangle
                (TraceResult.tri_flux of a TraceConfig(flux_map=True) run;
                T = real triangle count in the scene's triangle order).
      scene:    the traced Scene (tracer.scene): facet geometry (v0/e1/e2)
                and the per-triangle element index.
      element_names: optional list naming each element for `per_element`.

    Returns dict:
      'flux'       (T,) incident power per facet (the input, as numpy)
      'area'       (T,) facet areas
      'irradiance' (T,) flux / area  [power per area]
      'centroid'   (T, 3) facet centroids
      'element_id' (T,) owning element per facet
      'per_element' dict element -> total incident power

    A flux map is not a conservation ledger: a ray refracting through both
    faces of a lens deposits its arriving power on both. Analytic (quadric)
    surfaces' placeholder triangles get NaN irradiance (their power lands on
    a ~zero-area facet).
    """
    flux = np.asarray(_host(tri_flux), np.float64)
    T = flux.shape[0]
    v0 = np.asarray(_host(scene.v0), np.float64)[:T]
    e1 = np.asarray(_host(scene.e1), np.float64)[:T]
    e2 = np.asarray(_host(scene.e2), np.float64)[:T]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    centroid = v0 + (e1 + e2) / 3.0
    qt = getattr(scene, "quad_tri", None)
    if qt is not None:
        q = _host(qt).astype(np.int64)
        area[q[(q >= 0) & (q < T)]] = np.nan  # -> NaN irradiance below
    eid = _host(scene.element_id)[:T].astype(np.int64)
    n_el = int(eid.max()) + 1 if T else 0
    totals = np.zeros(max(n_el, 1))
    np.add.at(totals, np.clip(eid, 0, None), flux)
    if element_names is not None:
        per_element = {element_names[i] if i < len(element_names) else i:
                       float(totals[i]) for i in range(n_el)}
    else:
        per_element = {i: float(totals[i]) for i in range(n_el)}
    return {
        "flux": flux,
        "area": area,
        "irradiance": flux / np.maximum(area, 1e-30),
        "centroid": centroid,
        "element_id": eid,
        "per_element": per_element,
    }


def plot_surface_flux(tri_flux, scene, quantity: str = "irradiance",
                      ax=None, path=None, show=False, cmap="viridis",
                      log_scale=False):
    """3-D facet plot of a flux-map trace: each scene triangle colored by
    its incident flux or irradiance (matplotlib Poly3DCollection)."""
    plt = _plt()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    sf = surface_flux(tri_flux, scene)
    vals = sf[quantity]
    if log_scale:
        vals = np.log10(np.maximum(vals, 1e-30))
    T = len(vals)
    v0 = np.asarray(_host(scene.v0), np.float64)[:T]
    e1 = np.asarray(_host(scene.e1), np.float64)[:T]
    e2 = np.asarray(_host(scene.e2), np.float64)[:T]
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    if ax is None:
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
    norm = plt.Normalize(vals.min(), max(vals.max(), vals.min() + 1e-30))
    colors = plt.get_cmap(cmap)(norm(vals))
    coll = Poly3DCollection(verts, facecolors=colors, edgecolors="none")
    ax.add_collection3d(coll)
    lo = verts.reshape(-1, 3).min(axis=0)
    hi = verts.reshape(-1, 3).max(axis=0)
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_title(f"surface {quantity}")
    if path:
        ax.figure.savefig(path, dpi=120)
    if show:
        plt.show()
    return ax


# --------------------------------------------------------------------------
# Ghost / stray-light path analysis (TraceConfig.track_paths)
# --------------------------------------------------------------------------

def decode_path(signature: float, n_elements: int):
    """Decode one path signature into [(element_index, 'R'|'T'), ...] in
    bounce order. Inverse of the trace-side encoding (base 2 E + 1; slot-A
    children — reflected/continuing branch — carry digit 1 + 2 e, slot-B
    transmitted children 2 + 2 e). Only exact while
    (2 E + 1) ** bounces < 2**24 (TraceConfig.track_paths docs)."""
    base = 2 * n_elements + 1
    digits = []
    s = int(round(float(signature)))
    while s > 0:
        digits.append(s % base)
        s //= base
    out = []
    for d in reversed(digits):
        if d <= 0:
            continue
        out.append(((d - 1) // 2, "R" if (d - 1) % 2 == 0 else "T"))
    return out


def ghost_paths(result, elements=None, top: int = 10, detector=None):
    """Rank measured power by surface-interaction path (ghost analysis).

    `result` is a TraceResult from Tracer.trace(track_paths=True,
    mode='host'). Returns up to `top` dicts sorted by power:
    {'path': [(elem, 'R'|'T'), ...], 'label': 'L0:T -> L0:R -> ...',
     'power': float, 'count': int, 'fraction': power/measured_total}.
    `elements` (the traced scene list) supplies names for the label;
    `detector` restricts to one measure surface by name. The reference
    has no equivalent (kernels record only hit power) — ray provenance
    is free here because signatures ride the on-device ray state.
    """
    sig = np.asarray(result.measured_path)
    pw = np.asarray(result.measured_power)
    if sig.size == 0:
        raise ValueError("no measured rays with path signatures: run "
                         "Tracer.trace(track_paths=True, mode='host')")
    if detector is not None:
        sel = np.asarray(result.measured_det) == \
            result.detector_names.index(detector)
        sig, pw = sig[sel], pw[sel]
    n_el = len(elements) if elements is not None else None
    total = pw.sum()
    out = []
    uniq, inv = np.unique(sig, return_inverse=True)
    powers = np.zeros(len(uniq))
    np.add.at(powers, inv, pw)
    counts = np.bincount(inv, minlength=len(uniq))
    order = np.argsort(powers)[::-1][:top]
    for i in order:
        rec = {"signature": float(uniq[i]), "power": float(powers[i]),
               "count": int(counts[i]),
               "fraction": float(powers[i] / max(total, 1e-30))}
        if n_el is not None:
            chain = decode_path(uniq[i], n_el)
            rec["path"] = chain

            def _name(e):
                nm = getattr(elements[e], "name", None)
                return nm or f"elem{e}"

            rec["label"] = " -> ".join(f"{_name(e)}:{b}" for e, b in chain)
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# traced field analysis (extension beyond the reference's on-axis analysis:
# SURVEY.md §3 'Measurement & directivity analysis' row covers the detector
# surface; these sweep the FIELD — the other axis an imaging designer needs)


def line_foci(positions, directions, powers=None):
    """Astigmatic line foci of a traced bundle: the z planes minimizing
    the power-weighted lateral variance along each transverse axis,
    computed in closed form from the ray intercept/slope statistics
    (cov/var — no scan). For a bundle tilted in the y-z plane, the
    y-focus is the TANGENTIAL line focus and the x-focus the SAGITTAL.

    Returns (z_tangential, z_sagittal)."""
    p = np.asarray(positions, np.float64)
    d = np.asarray(directions, np.float64)
    w = (np.ones(len(p)) if powers is None
         else np.asarray(powers, np.float64))
    ok = np.abs(d[:, 2]) > 1e-12
    p, d, w = p[ok], d[ok], w[ok]
    if len(p) < 2:
        raise ValueError("line_foci needs >= 2 rays with dz != 0")
    sl = d[:, :2] / d[:, 2:3]            # lateral slope vs z
    c0 = p[:, :2] - sl * p[:, 2:3]       # lateral position at z = 0
    W = w / w.sum()
    foci = []
    for ax in (0, 1):
        a, b = c0[:, ax], sl[:, ax]
        am, bm = (W * a).sum(), (W * b).sum()
        cov = (W * (a - am) * (b - bm)).sum()
        var = (W * (b - bm) ** 2).sum()
        if var <= 0:
            raise ValueError("line_foci: bundle has no slope spread on "
                             f"axis {ax} (collimated output?)")
        foci.append(float(-cov / var))
    return foci[1], foci[0]


def field_sweep(elements, angles, *, beam_diameter, z_image, efl=None,
                source_dist=None, aim=(0.0, 0.0, 0.0), ray_count=1024,
                trace_iterations=4, capacity=None, config=None, seed=0,
                forward_min=0.5, sampling="hexapolar", device="cuda"):
    """Trace a collimated bundle at each field angle (tilted in the y-z
    plane, aimed at `aim` — put the aperture stop there) and return the
    traced field curves an imaging designer reads off a lens report:

      'theta'         the input angles [rad]
      'chief_height'  power-weighted y centroid at the z_image plane
      'z_tangential'/'z_sagittal'  astigmatic line foci (line_foci)
      'z_best', 'rms_best'         overall best focus per field
      'detected_power'             forward power reaching the detector
      'distortion_pct'  100 * (y - efl tan(theta)) / (efl tan(theta)),
                        present when `efl` is given (f-tan-theta
                        reference; 0 for a distortion-free lens,
                        pincushion > 0) — angles where |tan| < 1e-12
                        are NaN

    The scene must contain a measure surface past the optics (the image
    disc from `io.zmx_to_scene`, or an enclosing sphere). Works on both
    meshed and analytic-surface scenes. `sampling` defaults to the
    deterministic 'hexapolar' grid (the optical-design standard for
    field reports — noise-free, so +/-theta fields mirror exactly);
    pass 'random'/'halton' for Monte-Carlo bundles. The traces run on the
    port's Tracer on `device` (default CUDA)."""
    from lightpycl_tpu_torch.sources import CollimatedSource
    from lightpycl_tpu_torch.tracer.engine import Tracer

    angles = np.atleast_1d(np.asarray(angles, np.float64))
    aim = np.asarray(aim, np.float64)
    if source_dist is None:
        source_dist = max(float(z_image), 2.0 * beam_diameter)
    tracer = Tracer(config, device=device)
    cap = capacity or 8 * ray_count
    out = {k: [] for k in ("chief_height", "z_tangential", "z_sagittal",
                           "z_best", "rms_best", "detected_power")}
    for i, th in enumerate(angles):
        d = np.array([0.0, np.sin(th), np.cos(th)])
        src = CollimatedSource(center=tuple(aim - source_dist * d),
                               direction=tuple(d), diameter=beam_diameter,
                               power=1.0, ray_count=ray_count,
                               seed=seed + i, sampling=sampling)
        res = tracer.trace(src, list(elements),
                           trace_iterations=trace_iterations, capacity=cap)
        fwd = np.asarray(res.measured_dir[:, 2] > forward_min)
        if fwd.sum() < 2:
            raise ValueError(
                f"field angle {th:.4f} rad: {int(fwd.sum())} forward "
                "measured rays — beam misses the optics/detector "
                "(check aim/source_dist/beam_diameter)")
        p = np.asarray(res.measured_pos[fwd], np.float64)
        dd = np.asarray(res.measured_dir[fwd], np.float64)
        w = np.asarray(res.measured_power[fwd], np.float64)
        spot = spot_diagram(p, dd, float(z_image), w)
        try:
            z_t, z_s = line_foci(p, dd, w)
        except ValueError as e:
            if "slope spread" not in str(e):
                raise
            # A bundle that misses the optics entirely still lands
            # forward on an enclosing measure sphere — but collimated,
            # with no slope spread to focus. Same user error, same
            # diagnostic as the too-few-forward-rays case above.
            raise ValueError(
                f"field angle {th:.4f} rad: forward measured bundle is "
                "collimated — beam misses the optics (check "
                "aim/source_dist/beam_diameter)") from e
        # Bracket the focus scan around the astigmatic line foci and the
        # nominal image plane: best_focus's default range is the span of
        # the measured hit positions, which on an enclosing measure
        # sphere is the detector surface, not the focal region.
        zc = (z_t, z_s, float(z_image))
        dz = max(max(zc) - min(zc), 0.25 * abs(float(z_image)), 1e-3)
        z_b, rms_b = best_focus(p, dd, w,
                                z_range=(min(zc) - dz, max(zc) + dz))
        out["chief_height"].append(float(spot["centroid"][1]))
        out["z_tangential"].append(z_t)
        out["z_sagittal"].append(z_s)
        out["z_best"].append(z_b)
        out["rms_best"].append(rms_b)
        out["detected_power"].append(float(w.sum()))
    result = {"theta": angles}
    result.update({k: np.asarray(v) for k, v in out.items()})
    if efl is not None:
        ref = efl * np.tan(angles)
        with np.errstate(divide="ignore", invalid="ignore"):
            result["distortion_pct"] = np.where(
                np.abs(ref) > 1e-12,
                100.0 * (result["chief_height"] - ref) / ref, np.nan)
    return result
