"""Binary ray-file IO: a traced or measured ray set exported by one run and
re-emitted as a light source in another.

Port counterpart of lightpycl_tpu/io/rayfile.py. The LPR1 format is the
reference's, byte for byte (little-endian):

========  ==========  ====================================================
offset    type        field
========  ==========  ====================================================
0         4 bytes     magic ``b"LPR1"``
4         u32         flags: 1=wavelengths, 2=stokes, 4=opl
8         u64         n_rays
16        f64         total_power (denormalized checksum: sum of powers)
24        f32 (N,3)   origins
...       f32 (N,3)   unit directions
...       f32 (N,)    powers
...       f32 (N,)    wavelengths [um]           (present iff flags & 1)
...       f32 (N,3)   Stokes fractions s1,s2,s3  (present iff flags & 2)
...       f32 (N,)    accumulated optical path   (present iff flags & 4)
========  ==========  ====================================================

``RayFileSource`` satisfies the source protocol (``sample`` /
``sample_wavelengths`` / ``stokes`` on the host, ``rays_on_device`` and the
combined ``batch_on_device`` on the device). The device resampling draws
unit uniforms from a torch.Generator and maps them through the inverse CDF
of the stored powers (`searchsorted`): the distribution of the reference's
categorical draw, with an exact map.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np
import torch

from lightpycl_tpu_torch.geometry.mesh import rotation_matrix

_MAGIC = b"LPR1"
_F_WAVELENGTH = 1
_F_STOKES = 2
_F_OPL = 4


@dataclasses.dataclass
class RayFileData:
    """In-memory image of one ray file (all float32 numpy arrays)."""

    origins: np.ndarray               # (N, 3)
    directions: np.ndarray            # (N, 3) unit
    powers: np.ndarray                # (N,)
    wavelengths: Optional[np.ndarray] = None  # (N,) um
    stokes: Optional[np.ndarray] = None       # (N, 3) s1, s2, s3 fractions
    opl: Optional[np.ndarray] = None          # (N,) optical path length

    @property
    def n_rays(self) -> int:
        return int(self.origins.shape[0])

    @property
    def total_power(self) -> float:
        return float(np.sum(self.powers, dtype=np.float64))


def save_rayfile(path, origins, directions, powers, *, wavelengths=None,
                 stokes=None, opl=None) -> int:
    """Write an LPR1 ray file. Returns the number of rays written."""
    o = np.ascontiguousarray(origins, np.float32)
    d = np.ascontiguousarray(directions, np.float32)
    p = np.ascontiguousarray(powers, np.float32)
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or p.shape != (n,):
        raise ValueError(
            f"shape mismatch: origins {o.shape}, directions {d.shape}, "
            f"powers {p.shape} (want (N,3), (N,3), (N,))")
    flags = 0
    blocks = [o, d, p]
    if wavelengths is not None:
        w = np.ascontiguousarray(np.broadcast_to(
            np.asarray(wavelengths, np.float32), (n,)))
        flags |= _F_WAVELENGTH
        blocks.append(w)
    if stokes is not None:
        s = np.ascontiguousarray(stokes, np.float32)
        if s.shape == (3,):
            s = np.broadcast_to(s, (n, 3)).copy()
        if s.shape != (n, 3):
            raise ValueError(f"stokes shape {s.shape}, want (N,3) or (3,)")
        flags |= _F_STOKES
        blocks.append(s)
    if opl is not None:
        q = np.ascontiguousarray(np.broadcast_to(
            np.asarray(opl, np.float32), (n,)))
        flags |= _F_OPL
        blocks.append(q)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<IQd", flags, n,
                            float(np.sum(p, dtype=np.float64))))
        for b in blocks:
            f.write(b.tobytes())
    return n


def load_rayfile(path) -> RayFileData:
    """Read an LPR1 ray file back into host arrays."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an LPR1 ray file (bad magic)")
        flags, n, total = struct.unpack("<IQd", f.read(20))
        buf = np.fromfile(f, dtype="<f4")
    need = 7 * n
    if flags & _F_WAVELENGTH:
        need += n
    if flags & _F_STOKES:
        need += 3 * n
    if flags & _F_OPL:
        need += n
    if buf.size != need:
        raise ValueError(
            f"{path}: truncated ray file ({buf.size} f32 payload words, "
            f"header promises {need})")
    pos = 0

    def take(shape):
        nonlocal pos
        k = int(np.prod(shape))
        out = buf[pos:pos + k].reshape(shape)
        pos += k
        return out

    data = RayFileData(origins=take((n, 3)), directions=take((n, 3)),
                       powers=take((n,)))
    if flags & _F_WAVELENGTH:
        data.wavelengths = take((n,))
    if flags & _F_STOKES:
        data.stokes = take((n, 3))
    if flags & _F_OPL:
        data.opl = take((n,))
    got = float(np.sum(data.powers, dtype=np.float64))
    if not np.isclose(got, total, rtol=1e-5, atol=1e-12):
        raise ValueError(
            f"{path}: power checksum mismatch (header {total}, sum {got})")
    return data


def save_measured_rayfile(path, result, *, detector=None, flip=False) -> int:
    """Export a TraceResult's measured rays as an LPR1 ray file.

    ``detector`` restricts to one named measure surface. ``flip=True``
    negates the arrival directions, turning the detector into an emitter
    (trace up to an intermediate surface once, re-emit the recorded field
    many times downstream).
    """
    if detector is not None:
        pos, dirs, pw = result.measured_rays_for(detector)
        sel = result.measured_det == result.detector_names.index(detector)
    else:
        pos, dirs, pw = (result.measured_pos, result.measured_dir,
                         result.measured_power)
        sel = slice(None)
    if pos.shape[0] == 0:
        raise ValueError("no measured rays to export (host-mode trace with "
                         "a measure surface required)")

    def block(name):
        arr = getattr(result, name, None)
        return np.asarray(arr)[sel] if arr is not None and np.size(arr) else None

    st = block("measured_stokes")
    if st is not None and not np.any(st):
        st = None  # unpolarized trace: don't bloat the file with zeros
    return save_rayfile(path, pos, -dirs if flip else dirs, pw,
                        wavelengths=block("measured_wavelength"),
                        stokes=st, opl=block("measured_opl"))


@dataclasses.dataclass
class RayFileSource:
    """Re-emit a stored ray set as a light source.

    Args:
      data:       RayFileData or a path to an LPR1 file.
      ray_count:  None = replay every stored ray once (exact); an int
                  resamples that many rays with probability proportional to
                  stored power, each carrying equal power (unbiased photon
                  resampling).
      power:      None keeps the file's total power; a float rescales it.
      translate:  (3,) world offset applied to origins (after rotation).
      rotate:     optional (axis, angle_rad) rigid rotation about the file
                  frame's origin, applied to origins and directions.
      seed:       resampling RNG seed (host path).

    ``sample()`` -> ``sample_wavelengths()`` -> ``.stokes`` are
    index-coherent (the latter two reuse the indices drawn by the preceding
    ``sample``), and ``batch_on_device`` keeps the same coherence for
    ``trace_batched``.
    """

    data: object
    ray_count: Optional[int] = None
    power: Optional[float] = None
    translate: tuple = (0.0, 0.0, 0.0)
    rotate: Optional[tuple] = None
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.data, RayFileData):
            self.data = load_rayfile(self.data)
        if self.data.n_rays == 0:
            raise ValueError("ray file holds zero rays")
        if self.data.total_power <= 0:
            raise ValueError("ray file holds zero total power")
        self._R = (np.eye(3) if self.rotate is None
                   else rotation_matrix(*self.rotate))
        self._t = np.asarray(self.translate, np.float64)
        self._idx = None  # indices drawn by the last sample() call
        self._dev = {}  # device -> the tables of the device draw

    # -- shared helpers ---------------------------------------------------

    @property
    def _scale(self) -> float:
        return (1.0 if self.power is None
                else float(self.power) / self.data.total_power)

    def _transformed(self, o, d):
        R = self._R
        return o @ R.T + self._t, d @ R.T

    # -- host protocol ----------------------------------------------------

    def sample(self, rng: Optional[np.random.Generator] = None):
        """Return (origins, dirs, powers) f64 — replay or resample."""
        data = self.data
        n_src = data.n_rays
        if self.ray_count is None or int(self.ray_count) == n_src:
            self._idx = np.arange(n_src)
            p = data.powers.astype(np.float64) * self._scale
        else:
            n = int(self.ray_count)
            rng = rng or np.random.default_rng(self.seed)
            prob = data.powers.astype(np.float64)
            prob = prob / prob.sum()
            self._idx = rng.choice(n_src, size=n, replace=True, p=prob)
            total = (self.data.total_power if self.power is None
                     else float(self.power))
            p = np.full(n, total / n)
        o = data.origins[self._idx].astype(np.float64)
        d = data.directions[self._idx].astype(np.float64)
        o, d = self._transformed(o, d)
        return o, d, p

    def sample_wavelengths(self, rng=None, n: Optional[int] = None):
        """Wavelengths of the rays drawn by the preceding sample() call
        (None when the file carries no wavelength block)."""
        if self.data.wavelengths is None:
            return None
        idx = self._idx if self._idx is not None else np.arange(
            self.data.n_rays)
        return self.data.wavelengths[idx].astype(np.float64)

    @property
    def stokes(self):
        """Per-ray Stokes fraction rows for the last-sampled indices
        (None for an unpolarized file)."""
        if self.data.stokes is None:
            return None
        idx = self._idx if self._idx is not None else np.arange(
            self.data.n_rays)
        s = self.data.stokes[idx]
        return (s[:, 0], s[:, 1], s[:, 2])

    # -- device protocol (trace_batched) ----------------------------------

    def _device_tables(self, device: torch.device):
        if device not in self._dev:
            d = self.data
            cdf = np.cumsum(d.powers.astype(np.float64))
            cdf /= cdf[-1]
            cdf[-1] = 1.0  # every uniform in [0, 1) lands on a stored ray

            def f32(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a, np.float32)).to(device)

            self._dev[device] = dict(
                o=f32(d.origins @ self._R.T + self._t),
                d=f32(d.directions @ self._R.T),
                cdf=torch.from_numpy(cdf).to(device),
                wl=None if d.wavelengths is None else f32(d.wavelengths),
                s=None if d.stokes is None else f32(d.stokes),
            )
        return self._dev[device]

    def draw_indices(self, u: torch.Tensor, device: torch.device):
        """Stored-ray index of each unit uniform u (float64) by the inverse
        CDF of the stored powers: ray i is drawn with probability
        p_i / sum(p); zero-power rays never."""
        cdf = self._device_tables(device)["cdf"]
        idx = torch.searchsorted(cdf, u, right=True)
        return torch.clamp_max(idx, cdf.shape[0] - 1)

    def _draw(self, gen: torch.Generator, n: int):
        dev = gen.device
        tab = self._device_tables(dev)
        total = (self.data.total_power if self.power is None
                 else float(self.power))
        u = torch.rand((n,), generator=gen, dtype=torch.float64, device=dev)
        idx = self.draw_indices(u, dev)
        p = torch.full((n,), total / n, dtype=torch.float32, device=dev)
        return tab, idx, p

    def rays_on_device(self, gen: torch.Generator, n: Optional[int] = None):
        """(origins, dirs, powers) f32 tensors of n power-weighted draws
        from the stored rays, on the generator's device."""
        n = int(n or self.ray_count or self.data.n_rays)
        tab, idx, p = self._draw(gen, n)
        return tab["o"][idx], tab["d"][idx], p

    def batch_on_device(self, gen: torch.Generator, n: Optional[int] = None):
        """Engine hook: one draw yields index-coherent rays, wavelengths,
        and Stokes rows (wl / stokes may be None)."""
        n = int(n or self.ray_count or self.data.n_rays)
        tab, idx, p = self._draw(gen, n)
        wl = None if tab["wl"] is None else tab["wl"][idx]
        s = (None if tab["s"] is None
             else (tab["s"][idx, 0], tab["s"][idx, 1], tab["s"][idx, 2]))
        return tab["o"][idx], tab["d"][idx], p, wl, s
