"""Light sources: ray-batch generators.

Port counterpart of lightpycl_tpu/sources.py. `sample` / `sample_wavelengths`
draw on the host with numpy exactly as the reference does, so both packages
trace identical rays from the same seed. `rays_on_device(gen, n)` /
`wavelengths_on_device(gen, n)` draw a batch on the device of the
torch.Generator `gen` (Tracer.trace_batched): each is a draw of unit
uniforms (`_uniforms`, in the order of the reference's split keys k1..k4)
followed by a pure map (`_rays_from_uniforms`), so the map can be held
against the reference on the reference's own uniforms. torch's random
streams are not JAX's: the two packages draw different rays from the same
seed, with the same distribution. Halton and hexapolar streams are
deterministic and equal the reference's (the same rays in every batch).

A `directivity` callable is handed torch tensors on the device by
`LightSource.rays_on_device`; one written for numpy only fails there, as it
does under the reference's jit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

D_LINE_UM = 0.5876  # default wavelength [um]

_F32 = torch.float32


def _sample_wavelengths_np(rng, n, wavelength):
    """wavelength: scalar [um], or (wavelengths, weights) spectrum arrays."""
    if np.isscalar(wavelength):
        return np.full(n, float(wavelength))
    wls, wts = np.asarray(wavelength[0], float), np.asarray(wavelength[1], float)
    p = wts / wts.sum()
    return rng.choice(wls, size=n, p=p)


def _sample_wavelengths_dev(gen: torch.Generator, n: int, wavelength):
    """(n,) f32 wavelengths on the generator's device: a scalar [um], or a
    (wavelengths, weights) spectrum drawn by the inverse CDF of the weights
    on float64 unit uniforms."""
    dev = gen.device
    if np.isscalar(wavelength):
        return torch.full((n,), float(wavelength), dtype=_F32, device=dev)
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=dev)
    return _wavelengths_from_uniforms(u, wavelength)


def _wavelengths_from_uniforms(u: torch.Tensor, wavelength):
    """The spectrum line of each unit uniform u: line i with probability
    w_i / sum(w) (inverse CDF; zero-weight lines are never drawn)."""
    wls = torch.as_tensor(np.asarray(wavelength[0], np.float32),
                          device=u.device)
    cdf = np.cumsum(np.asarray(wavelength[1], np.float64))
    cdf /= cdf[-1]
    cdf[-1] = 1.0
    idx = torch.searchsorted(torch.as_tensor(cdf, device=u.device), u,
                             right=True)
    return wls[torch.clamp_max(idx, wls.shape[0] - 1)]


def _scaled(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """u * (hi - lo) + lo in f32 with one rounding, as the reference's
    jax.random.uniform(minval=lo, maxval=hi) compiles it (a fused
    multiply-add): the f32 product is exact in f64. Near the pole of a cone
    a separately rounded add moves a direction by several 1e-6."""
    lo = torch.as_tensor(lo, dtype=_F32)
    span = torch.as_tensor(hi, dtype=_F32) - lo
    return (u.double() * span.double() + lo.double()).to(_F32)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """sqrt of f32 x correctly rounded to f32, as numpy, XLA and CUDA's
    sqrtf give it (by way of f64, whose rounding to f32 is exact for a
    square root). Some CPU builds of torch round an f32 sqrt faithfully,
    not correctly, one ulp off for many inputs: where s = sqrt(1 - z z)
    cancels near the pole, that ulp of z moves s by eps / s."""
    return torch.sqrt(x.double()).to(_F32)


def _uniforms(gen: torch.Generator, n: int, k: int):
    """k independent (n,) f32 unit-uniform draws from `gen`, in order."""
    return [torch.rand((n,), generator=gen, dtype=_F32, device=gen.device)
            for _ in range(k)]


def _frame_rows(direction, device):
    """The rows u, v, w of `_frame(direction)` as f32 tensors."""
    F = torch.as_tensor(np.asarray(_frame(direction), np.float32),
                        device=device)
    return F[0], F[1], F[2]


def halton_sequence(n: int, base: int, offset: int = 1) -> np.ndarray:
    """First n points of the base-`base` Halton (radical-inverse)
    sequence, skipping `offset` initial terms (i=0 maps to 0.0 — skip
    it). Deterministic low-discrepancy stream: pairing coprime bases
    (2, 3) for a 2-D domain makes sample-mean errors shrink ~(log n)/n
    instead of the Monte Carlo 1/sqrt(n) — source option
    sampling='halton'."""
    i = np.arange(offset, offset + n, dtype=np.int64)
    out = np.zeros(n)
    f = 1.0 / base
    while i.max() > 0:
        out += (i % base) * f
        i //= base
        f /= base
    return out


def _frame(direction) -> np.ndarray:
    """Orthonormal frame (3, 3) whose third row is `direction`."""
    w = np.asarray(direction, dtype=np.float64)
    w = w / np.linalg.norm(w)
    a = np.array([1.0, 0.0, 0.0]) if abs(w[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    return np.stack([u, v, w])


def _cap_directions_np(rng, n, polar_max):
    """Uniform directions on the spherical cap polar <= polar_max about +z,
    returned with their (azimuth, polar) angles."""
    cos_min = np.cos(polar_max)
    z = rng.uniform(cos_min, 1.0, size=n)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    d = np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)
    return d, phi, np.arccos(np.clip(z, -1.0, 1.0))


@dataclasses.dataclass
class LightSource:
    """Point source with an angular directivity distribution.

    Args:
      center:       (3,) emission point
      direction:    (3,) principal emission axis (polar angle measured from it)
      directivity:  callable (azimuth, polar) -> relative intensity (>= 0),
                    vectorized over numpy arrays. None = isotropic.
      power:        total emitted power (sum of ray powers after normalization)
      ray_count:    number of rays to generate
      polar_max:    emission cone half-angle (default pi/2: hemisphere)
      mode:         'weighted' — uniform directions, power ∝ directivity
                    (the reference's scheme per SURVEY.md §3);
                    'sampled'  — rejection-sample directions from the
                    directivity, equal power per ray.
      seed:         RNG seed for reproducibility
    """

    center: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 1.0)
    directivity: Optional[Callable] = None
    power: float = 1.0
    ray_count: int = 1000
    polar_max: float = np.pi / 2.0
    mode: str = "weighted"
    seed: int = 0
    wavelength: object = D_LINE_UM  # um, or (wavelengths, weights) spectrum
    stokes: object = None  # (s1, s2, s3) fractions for polarized emission

    def sample(self, rng: Optional[np.random.Generator] = None):
        """Generate the ray batch host-side.

        Returns (origins (N,3) f64, directions (N,3) f64 unit, powers (N,) f64).
        """
        rng = rng or np.random.default_rng(self.seed)
        n = self.ray_count
        if self.mode == "weighted" or self.directivity is None:
            d, az, pol = _cap_directions_np(rng, n, self.polar_max)
            w = (
                np.ones(n)
                if self.directivity is None
                else np.maximum(0.0, np.asarray(self.directivity(az, pol), dtype=np.float64))
            )
        elif self.mode == "sampled":
            d, w = self._rejection_sample(rng, n)
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        total = w.sum()
        if total <= 0:
            raise ValueError("directivity integrates to zero over the emission cone")
        powers = w * (self.power / total)
        F = _frame(self.direction)  # rows u, v, w
        dirs = d @ F  # map local (+z = principal axis) into world
        origins = np.broadcast_to(np.asarray(self.center, np.float64), (n, 3)).copy()
        return origins, dirs, powers

    def _rejection_sample(self, rng, n):
        out = np.empty((0, 3))
        # probe the directivity maximum on a grid for the envelope
        az_g, pol_g = np.meshgrid(
            np.linspace(0, 2 * np.pi, 64), np.linspace(0, self.polar_max, 64)
        )
        m = float(np.max(self.directivity(az_g.ravel(), pol_g.ravel()))) * 1.1 + 1e-12
        while len(out) < n:
            k = max(n - len(out), 1) * 2
            d, az, pol = _cap_directions_np(rng, k, self.polar_max)
            vals = np.maximum(0.0, np.asarray(self.directivity(az, pol)))
            if vals.max() > m:
                # the grid probe under-covered a spike (sub-grid-cell peak);
                # accepting under a too-small envelope clips the density, so
                # raise the envelope and RESTART — already-accepted samples
                # are biased toward the clipped region
                m = float(vals.max()) * 1.1
                out = np.empty((0, 3))
                continue
            acc = rng.uniform(0.0, m, size=k) < vals
            out = np.concatenate([out, d[acc]])
        d = out[:n]
        return d, np.ones(n)

    def sample_wavelengths(self, rng: Optional[np.random.Generator] = None,
                           n: Optional[int] = None):
        rng = rng or np.random.default_rng(self.seed + 1)
        return _sample_wavelengths_np(rng, int(n or self.ray_count), self.wavelength)

    def rays_on_device(self, gen: torch.Generator, n: Optional[int] = None):
        """Device-side generation (uniform directions in the cone, weights
        from a directivity callable that accepts tensors). Returns
        (origins, dirs, powers) as f32 tensors of length n."""
        n = int(n or self.ray_count)
        return self._rays_from_uniforms(_uniforms(gen, n, 2), n, gen.device)

    def _rays_from_uniforms(self, u, n: int, device):
        """The map of rays_on_device from its unit uniforms u = [u1, u2]."""
        z = _scaled(u[0], torch.cos(torch.tensor(self.polar_max,
                                                 dtype=_F32)), 1.0)
        phi = _scaled(u[1], 0.0, 2.0 * math.pi)
        s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        if self.directivity is not None:
            w = torch.clamp_min(self.directivity(
                phi, torch.arccos(torch.clamp(z, -1.0, 1.0))), 0.0)
        else:
            w = torch.ones((n,), dtype=_F32, device=device)
        powers = w * (self.power / torch.clamp_min(torch.sum(w), 1e-30))
        fu, fv, fw = _frame_rows(self.direction, device)
        # elementwise frame combination, the local (+z = axis) to world map
        dirs = ((s * torch.cos(phi))[:, None] * fu
                + (s * torch.sin(phi))[:, None] * fv + z[:, None] * fw)
        origins = torch.as_tensor(np.asarray(self.center, np.float32),
                                  device=device).expand(n, 3)
        return (origins.contiguous(), dirs.to(_F32), powers.to(_F32))

    def wavelengths_on_device(self, gen: torch.Generator,
                              n: Optional[int] = None):
        return _sample_wavelengths_dev(gen, int(n or self.ray_count),
                                       self.wavelength)


@dataclasses.dataclass
class CollimatedSource:
    """Collimated bundle through a disc aperture (reference: the collimated
    variant in light_source.py [recalled]; also BASELINE configs[3]
    'directional source')."""

    center: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 1.0)
    diameter: float = 1.0
    power: float = 1.0
    ray_count: int = 1000
    seed: int = 0
    wavelength: object = D_LINE_UM  # um, or (wavelengths, weights) spectrum
    stokes: object = None  # (s1, s2, s3) fractions for polarized emission
    divergence: float = 0.0  # half-angle [rad]: directions uniform in a cone
    sampling: str = "random"  # or 'hexapolar': deterministic ring grid
    #   (chief ray + rings of 6k points at radii ~sqrt-spaced for equal
    #    area per point — the optical-design layout for spot diagrams);
    #   or 'halton': deterministic low-discrepancy (quasi-Monte Carlo)
    #   disc coverage — aperture-averaged quantities converge ~(log n)/n
    #   instead of 1/sqrt(n), and the divergence cone (if any) draws from
    #   the same Halton stream (bases 5, 7)
    profile: str = "uniform"  # or 'gaussian': TEM00 laser intensity
    #   exp(-2 r^2 / waist^2), truncated at the aperture. Equal-power
    #   rays with inverse-CDF radii under 'random'/'halton'; under
    #   'hexapolar' the grid positions stay and the POWERS carry the
    #   profile (spot-diagram layout with true apodization)
    waist: float = 0.0  # 1/e^2 intensity radius [len]; required > 0 for
    #   profile='gaussian'

    def _gauss_radii(self, r, xp):
        """Remap uniform-disc radii to the truncated-Gaussian profile by
        inverse CDF: P(<r) = (1 - e^{-2 r^2/w^2}) / (1 - e^{-2 a^2/w^2})."""
        if self.waist <= 0.0:
            raise ValueError("profile='gaussian' needs waist > 0")
        a = self.diameter / 2.0
        u = (r / a) ** 2                     # the underlying uniform variate
        # (xp.asarray: torch.exp takes no Python float; f32 under torch, as
        # the reference's jnp computes it)
        cap = 1.0 - xp.exp(xp.asarray(-2.0 * (a / self.waist) ** 2))
        return self.waist * xp.sqrt(-xp.log1p(-u * cap) / 2.0)

    def _hexapolar(self, n):
        """Deterministic (r, phi) hexapolar grid covering the aperture:
        ring j of 6j points; radii sqrt-spaced so each point covers equal
        area. Total points >= n; truncated to exactly n (outermost-last)."""
        rs, phis = [0.0], [0.0]
        j = 0
        while len(rs) < n:
            j += 1
            for i in range(6 * j):
                rs.append(j)
                phis.append(2.0 * np.pi * i / (6 * j) + (j % 2) * np.pi / (6 * j))
        rs = np.asarray(rs[:n], np.float64)
        phis = np.asarray(phis[:n], np.float64)
        # equal-area radial spacing: ring j -> R * sqrt(j (j+1)) / sqrt(J (J+1))
        rmax = rs.max() if rs.max() > 0 else 1.0
        r = (self.diameter / 2.0) * np.sqrt(rs * (rs + 1.0)) / np.sqrt(
            rmax * (rmax + 1.0))
        return r, phis

    def sample(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self.seed)
        n = self.ray_count
        if self.sampling == "hexapolar":
            r, phi = self._hexapolar(n)
        elif self.sampling == "halton":
            r = (self.diameter / 2.0) * np.sqrt(halton_sequence(n, 2))
            phi = 2.0 * np.pi * halton_sequence(n, 3)
        elif self.sampling == "random":
            r = (self.diameter / 2.0) * np.sqrt(rng.uniform(0.0, 1.0, n))
            phi = rng.uniform(0.0, 2.0 * np.pi, n)
        else:
            raise ValueError(f"unknown sampling {self.sampling!r}")
        powers = np.full(n, self.power / n)
        if self.profile == "gaussian":
            if self.sampling == "hexapolar":
                if self.waist <= 0.0:
                    raise ValueError("profile='gaussian' needs waist > 0")
                wgt = np.exp(-2.0 * r**2 / self.waist**2)
                powers = self.power * wgt / wgt.sum()
            else:
                r = self._gauss_radii(r, np)
        elif self.profile != "uniform":
            raise ValueError(f"unknown profile {self.profile!r}")
        F = _frame(self.direction)
        u, v, w = F
        origins = (
            np.asarray(self.center, np.float64)
            + r[:, None] * np.cos(phi)[:, None] * u
            + r[:, None] * np.sin(phi)[:, None] * v
        )
        if self.divergence > 0.0:
            if self.sampling == "halton":
                z = 1.0 - halton_sequence(n, 5) * (
                    1.0 - np.cos(self.divergence))
                ph = 2.0 * np.pi * halton_sequence(n, 7)
                sn = np.sqrt(np.maximum(0.0, 1.0 - z * z))
                dloc = np.stack([sn * np.cos(ph), sn * np.sin(ph), z], 1)
            else:
                dloc, _, _ = _cap_directions_np(rng, n, self.divergence)
            dirs = dloc @ F
        else:
            dirs = np.broadcast_to(w, (n, 3)).copy()
        return origins, dirs, powers

    def sample_wavelengths(self, rng: Optional[np.random.Generator] = None,
                           n: Optional[int] = None):
        rng = rng or np.random.default_rng(self.seed + 1)
        return _sample_wavelengths_np(rng, int(n or self.ray_count), self.wavelength)

    def wavelengths_on_device(self, gen: torch.Generator,
                              n: Optional[int] = None):
        return _sample_wavelengths_dev(gen, int(n or self.ray_count),
                                       self.wavelength)

    def rays_on_device(self, gen: torch.Generator, n: Optional[int] = None):
        """(origins, dirs, powers) f32 tensors of n rays on the generator's
        device. 'random' draws u1, u2 (aperture) and, with a divergence,
        u3, u4 (cone); 'halton' and 'hexapolar' draw nothing."""
        n = int(n or self.ray_count)
        k = 4 if self.divergence > 0.0 else 2
        u = (_uniforms(gen, n, k) if self.sampling == "random"
             else [None] * 4)
        return self._rays_from_uniforms(u, n, gen.device)

    def _rays_from_uniforms(self, u, n: int, device):
        """The map of rays_on_device from its unit uniforms u (u[0], u[1]
        the aperture's, u[2], u[3] the divergence cone's; unused by the
        deterministic samplings)."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        if self.sampling in ("hexapolar", "halton"):
            # deterministic streams, computed on the host as the reference
            if self.sampling == "hexapolar":
                r_np, phi_np = self._hexapolar(n)
            else:
                r_np = (self.diameter / 2.0) * np.sqrt(halton_sequence(n, 2))
                phi_np = 2.0 * np.pi * halton_sequence(n, 3)
            r, phi = f32(r_np), f32(phi_np)
        elif self.sampling == "random":
            r = (self.diameter / 2.0) * torch.sqrt(u[0])
            phi = _scaled(u[1], 0.0, 2.0 * math.pi)
        else:
            raise ValueError(f"unknown sampling {self.sampling!r}")
        powers = torch.full((n,), self.power / n, dtype=_F32, device=device)
        if self.profile == "gaussian":
            if self.sampling == "hexapolar":
                if self.waist <= 0.0:
                    raise ValueError("profile='gaussian' needs waist > 0")
                wgt = torch.exp(-2.0 * r * r / float(np.float32(
                    self.waist ** 2)))
                powers = self.power * wgt / torch.sum(wgt)
            else:
                r = self._gauss_radii(r, torch)
        elif self.profile != "uniform":
            raise ValueError(f"unknown profile {self.profile!r}")
        fu, fv, fw = _frame_rows(self.direction, device)
        origins = (f32(self.center) + r[:, None] * torch.cos(phi)[:, None] * fu
                   + r[:, None] * torch.sin(phi)[:, None] * fv)
        if self.divergence > 0.0:
            if self.sampling == "halton":
                z = f32(1.0 - halton_sequence(n, 5)
                        * (1.0 - np.cos(self.divergence)))
                ph = f32(2.0 * np.pi * halton_sequence(n, 7))
            else:
                z = _scaled(u[2], torch.cos(torch.tensor(
                    self.divergence, dtype=_F32)), 1.0)
                ph = _scaled(u[3], 0.0, 2.0 * math.pi)
            s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
            dirs = ((s * torch.cos(ph))[:, None] * fu
                    + (s * torch.sin(ph))[:, None] * fv + z[:, None] * fw)
        else:
            dirs = fw.expand(n, 3).contiguous()
        return origins.to(_F32), dirs.to(_F32), powers.to(_F32)


@dataclasses.dataclass
class AreaSource:
    """Extended (surface) emitter: a disc or rectangle radiating from every
    surface point — LED dies, diffuser exit ports, integrating-sphere
    ports, illumination sources. Extension over the reference (point +
    collimated sources only, SURVEY.md §3 'light_source').

    emission='lambertian': uniform radiance, emitted intensity
    proportional to cos(theta) — sampled cosine-weighted with EQUAL ray
    powers (the profile is encoded in the direction density, so detector
    statistics stay low-variance). emission='isotropic': uniform over the
    forward hemisphere.

    Geometry: a disc of `radius` in the plane through `center`
    perpendicular to `direction`, or a `width=(wx, wy)` rectangle in the
    same plane (axes = the frame's u, v).
    """

    center: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 1.0)
    radius: float = 0.5
    width: object = None        # (wx, wy) rectangle instead of the disc
    power: float = 1.0
    ray_count: int = 1000
    seed: int = 0
    wavelength: object = D_LINE_UM
    stokes: object = None
    emission: str = "lambertian"   # or 'isotropic'
    sampling: str = "random"       # or 'halton': 4-D low-discrepancy
    #   stream (bases 2, 3 over the surface; 5, 7 over the hemisphere) —
    #   illumination maps converge ~(log n)/n instead of 1/sqrt(n)

    def _directions_local(self, u1, u2, xp):
        phi = 2.0 * xp.pi * u2
        if self.emission == "lambertian":
            z = xp.sqrt(u1)                # pdf(z) = 2 z  ->  I ~ cos(theta)
        elif self.emission == "isotropic":
            z = u1
        else:
            raise ValueError(f"unknown emission {self.emission!r}")
        s = xp.sqrt(xp.maximum(0.0, 1.0 - z * z))
        return s * xp.cos(phi), s * xp.sin(phi), z

    def sample(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self.seed)
        n = self.ray_count
        F = _frame(self.direction)
        u, v, w = F
        if self.sampling == "halton":
            u1, u2 = halton_sequence(n, 2), halton_sequence(n, 3)
            u3, u4 = halton_sequence(n, 5), halton_sequence(n, 7)
        elif self.sampling == "random":
            u1, u2 = rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 1.0, n)
            u3, u4 = rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 1.0, n)
        else:
            raise ValueError(f"unknown sampling {self.sampling!r}")
        if self.width is not None:
            wx, wy = self.width
            a = wx * (u1 - 0.5)
            b = wy * (u2 - 0.5)
        else:
            r = self.radius * np.sqrt(u1)
            phi = 2.0 * np.pi * u2
            a, b = r * np.cos(phi), r * np.sin(phi)
        origins = (np.asarray(self.center, np.float64)
                   + a[:, None] * u + b[:, None] * v)
        dx, dy, dz = self._directions_local(u3, u4, np)
        dirs = dx[:, None] * u + dy[:, None] * v + dz[:, None] * w
        powers = np.full(n, self.power / n)
        return origins, dirs, powers

    def sample_wavelengths(self, rng: Optional[np.random.Generator] = None,
                           n: Optional[int] = None):
        rng = rng or np.random.default_rng(self.seed + 1)
        return _sample_wavelengths_np(rng, int(n or self.ray_count),
                                      self.wavelength)

    def wavelengths_on_device(self, gen: torch.Generator,
                              n: Optional[int] = None):
        return _sample_wavelengths_dev(gen, int(n or self.ray_count),
                                       self.wavelength)

    def rays_on_device(self, gen: torch.Generator, n: Optional[int] = None):
        """(origins, dirs, powers) f32 tensors of n rays on the generator's
        device; 'random' draws u1..u4 (surface, then hemisphere)."""
        n = int(n or self.ray_count)
        u = (_uniforms(gen, n, 4) if self.sampling == "random"
             else [None] * 4)
        return self._rays_from_uniforms(u, n, gen.device)

    def _rays_from_uniforms(self, u, n: int, device):
        """The map of rays_on_device from its unit uniforms u1..u4 (halton:
        the deterministic stream of bases 2, 3, 5, 7 instead)."""
        fu, fv, fw = _frame_rows(self.direction, device)
        if self.sampling == "halton":
            u = [torch.as_tensor(halton_sequence(n, b).astype(np.float32),
                                 device=device) for b in (2, 3, 5, 7)]
        elif self.sampling != "random":
            raise ValueError(f"unknown sampling {self.sampling!r}")
        if self.width is not None:
            wx, wy = self.width
            a = wx * (u[0] - 0.5)
            b = wy * (u[1] - 0.5)
        else:
            r = self.radius * torch.sqrt(u[0])
            phi = 2.0 * math.pi * u[1]
            a, b = r * torch.cos(phi), r * torch.sin(phi)
        center = torch.as_tensor(np.asarray(self.center, np.float32),
                                 device=device)
        origins = center + a[:, None] * fu + b[:, None] * fv
        # the local hemisphere direction, as _directions_local
        ph = 2.0 * math.pi * u[3]
        if self.emission == "lambertian":
            z = _sqrt_rn(u[2])  # pdf(z) = 2 z  ->  I ~ cos(theta)
        elif self.emission == "isotropic":
            z = u[2]
        else:
            raise ValueError(f"unknown emission {self.emission!r}")
        s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        dirs = ((s * torch.cos(ph))[:, None] * fu
                + (s * torch.sin(ph))[:, None] * fv + z[:, None] * fw)
        powers = torch.full((n,), self.power / n, dtype=_F32, device=device)
        return origins.to(_F32), dirs.to(_F32), powers


def light_source(center=(0, 0, 0), direction=(0, 0, 1), directivity=None,
                 power: float = 1.0, ray_count: int = 1000, **kw) -> LightSource:
    """Reference-shaped constructor (light_source.light_source, SURVEY.md §3)."""
    return LightSource(
        center=tuple(center), direction=tuple(direction),
        directivity=directivity, power=power, ray_count=ray_count, **kw
    )


def lambertian(azimuth, polar):
    """cos(polar) directivity — a common reference directivity choice
    (numpy arrays, or tensors under rays_on_device)."""
    if isinstance(polar, torch.Tensor):
        return torch.clamp_min(torch.cos(polar), 0.0)
    return np.maximum(0.0, np.cos(polar))
