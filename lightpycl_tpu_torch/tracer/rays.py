"""Ray-state SoA, detector state, and the power-conservation ledger.

Port counterpart of lightpycl_tpu/tracer/rays.py. The containers are the
same NamedTuples with the same fields, holding torch tensors instead of jax
arrays; "how many rays are real" is still carried by the `alive` mask, never
by array length. `from_reference` turns a reference batch (any object with
these NamedTuple fields, read through numpy) into the port's tensors field by
field, so tests can feed both packages identical bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# default vacuum wavelength in micrometers: the sodium d-line, the standard
# line refractive indices are quoted at
D_LINE_UM = 0.5876

_F32 = torch.float32


def tensor_from_array(a, device) -> torch.Tensor:
    """A private copy of any array-like (numpy, or a read-only array from
    another framework) as a tensor on `device`, dtype preserved."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis as sqrt(sum(v * v)), the
    reference's jnp.linalg.norm formulation."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def default_basis(d: torch.Tensor) -> torch.Tensor:
    """Default polarization frame: unit s-direction perpendicular to each
    ray direction (the horizontal-ish choice), as in the reference."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=_F32, device=d.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=_F32, device=d.device)
    a = torch.where(torch.abs(d[:, :1]) < 0.9, ex, ey)
    b = torch.linalg.cross(d, a)
    return b / torch.clamp_min(norm3(b)[:, None], 1e-20)


class RayBatch(NamedTuple):
    """SoA ray state, capacity C. Field meanings as in the reference."""

    o: torch.Tensor           # (C, 3) f32 origins
    d: torch.Tensor           # (C, 3) f32 unit directions
    power: torch.Tensor       # (C,)  f32
    ior: torch.Tensor         # (C,)  f32 current-medium IOR
    alive: torch.Tensor       # (C,)  bool
    wavelength: torch.Tensor  # (C,)  f32 vacuum wavelength [um]
    absorb: torch.Tensor      # (C,)  f32 current-medium absorption [1/len]
    s1: torch.Tensor          # (C,)  f32 Stokes fractions S1/S0, S2/S0,
    s2: torch.Tensor          # (C,)  S3/S0 in the `basis` frame (carried
    s3: torch.Tensor          # (C,)  always; TraceConfig.polarization acts)
    basis: torch.Tensor       # (C,3) f32 s-direction reference
    opl: torch.Tensor         # (C,)  f32 accumulated optical path length
    path: torch.Tensor        # (C,)  f32 path signature (track_paths)
    scat: torch.Tensor        # (C,)  f32 medium scattering coefficient
    scat_g: torch.Tensor      # (C,)  f32 medium HG anisotropy
    medium: torch.Tensor      # (C,)  f32 current-medium element id (-1 =
    #                           ambient; indexes the fluorescence and GRIN
    #                           tables)

    @property
    def capacity(self) -> int:
        return self.o.shape[0]

    @property
    def device(self) -> torch.device:
        return self.o.device

    def permuted(self, order: torch.Tensor) -> "RayBatch":
        """Every field gathered by the same slot permutation."""
        return RayBatch(*(a[order] for a in self))

    def padded_to(self, capacity: int) -> "RayBatch":
        """Grow the batch to `capacity` slots with dead rays."""
        pad = capacity - self.capacity
        if pad < 0:
            raise ValueError(f"capacity {capacity} < current {self.capacity}")
        if pad == 0:
            return self

        def ext(a, fill):
            return torch.cat(
                [a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                               dtype=a.dtype, device=a.device)])

        dev = self.device
        unit_z = torch.tensor([[0.0, 0.0, 1.0]], dtype=_F32,
                              device=dev).repeat(pad, 1)
        unit_x = torch.tensor([[1.0, 0.0, 0.0]], dtype=_F32,
                              device=dev).repeat(pad, 1)
        return RayBatch(
            o=ext(self.o, 0.0),
            d=torch.cat([self.d, unit_z]),
            power=ext(self.power, 0.0),
            ior=ext(self.ior, 1.0),
            alive=ext(self.alive, False),
            wavelength=ext(self.wavelength, D_LINE_UM),
            absorb=ext(self.absorb, 0.0),
            s1=ext(self.s1, 0.0),
            s2=ext(self.s2, 0.0),
            s3=ext(self.s3, 0.0),
            basis=torch.cat([self.basis, unit_x]),
            opl=ext(self.opl, 0.0),
            path=ext(self.path, 0.0),
            scat=ext(self.scat, 0.0),
            scat_g=ext(self.scat_g, 0.0),
            medium=ext(self.medium, -1.0),
        )

    @staticmethod
    def from_arrays(origins, dirs, powers, ior_env: float = 1.0,
                    capacity: int | None = None, wavelengths=None,
                    stokes=None,
                    device: torch.device | str = "cuda") -> "RayBatch":
        """Build a padded batch on `device` from host arrays (cast to f32
        on the host, exactly as the reference casts them) or from tensors
        (cast where they lie, then moved: the device samplers' path)."""
        device = torch.device(device)

        def f32(a):
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=_F32).contiguous()
            return tensor_from_array(np.asarray(a, np.float32), device)

        def broadcast(a, size):
            if isinstance(a, torch.Tensor):
                return f32(a.expand(size))
            return f32(np.broadcast_to(np.asarray(a, np.float32), (size,)))

        o, d, p = f32(origins), f32(dirs), f32(powers)
        n = o.shape[0]
        c = int(capacity or n)
        if c < n:
            raise ValueError(f"capacity {c} < ray count {n}")
        if wavelengths is None:
            w = torch.full((n,), D_LINE_UM, dtype=_F32, device=device)
        else:
            w = broadcast(wavelengths, n)
        pad = c - n
        if pad:
            o = torch.cat([o, torch.zeros((pad, 3), dtype=_F32,
                                          device=device)])
            d = torch.cat([d, torch.tensor([[0.0, 0.0, 1.0]], dtype=_F32,
                                           device=device).repeat(pad, 1)])
            p = torch.cat([p, torch.zeros((pad,), dtype=_F32,
                                          device=device)])
            w = torch.cat([w, torch.full((pad,), D_LINE_UM, dtype=_F32,
                                         device=device)])
        alive = (torch.arange(c, device=device) < n) & (p > 0)
        b = default_basis(d)
        if stokes is None:
            sf = [torch.zeros((c,), dtype=_F32, device=device)
                  for _ in range(3)]
        else:
            sf = []
            for x in stokes:
                if np.ndim(x) == 0:  # a scalar fills the padding slots too
                    sf.append(broadcast(x, c))
                else:
                    sf.append(torch.cat([
                        broadcast(x, n),
                        torch.zeros((pad,), dtype=_F32, device=device)]))

        def full(v):
            return torch.full((c,), v, dtype=_F32, device=device)

        return RayBatch(o, d, p, full(ior_env), alive, w, full(0.0),
                        sf[0], sf[1], sf[2], b, full(0.0), full(0.0),
                        full(0.0), full(0.0), full(-1.0))

    @staticmethod
    def from_reference(obj, device) -> "RayBatch":
        """The port's copy of a reference RayBatch, field by field."""
        return RayBatch(*(tensor_from_array(getattr(obj, f), device)
                          for f in RayBatch._fields))


class DetectorState(NamedTuple):
    """Measurement accumulators, as in the reference. The optional maps keep
    their disabled shapes unless switched on: image_amp (2, 1, 1) without
    TraceConfig.coherent, tri_flux (1,) without flux_map, time_hist (1, 1)
    without time_bins."""

    hist: torch.Tensor          # (n_azimuth, n_polar) f32 power histogram
    per_detector: torch.Tensor  # (D,) f32 total power per measure surface
    image: torch.Tensor         # (image_bins, image_bins) f32 planar map
    image_amp: torch.Tensor     # (2, nb, nb) f32 coherent field (re, im)
    tri_flux: torch.Tensor      # (T_pad,) f32 per-triangle incident power
    time_hist: torch.Tensor     # (D, time_bins) f32 power by arrival OPL

    @staticmethod
    def zeros(n_az: int, n_pol: int, n_detectors: int,
              image_bins: int = 0, coherent: bool = False,
              n_tris: int = 0, time_bins: int = 0,
              device: torch.device | str = "cuda") -> "DetectorState":
        nb = max(image_bins, 1)
        na = nb if (coherent and image_bins > 0) else 1
        nd_t = max(n_detectors, 1) if time_bins > 0 else 1

        def z(*shape):
            return torch.zeros(shape, dtype=_F32, device=device)

        return DetectorState(z(n_az, n_pol), z(max(n_detectors, 1)),
                             z(nb, nb), z(2, na, na), z(max(n_tris, 1)),
                             z(nd_t, max(time_bins, 1)))

    @staticmethod
    def from_reference(obj, device) -> "DetectorState":
        """The port's copy of a reference DetectorState, field by field."""
        return DetectorState(*(tensor_from_array(getattr(obj, f), device)
                               for f in DetectorState._fields))


class Ledger(NamedTuple):
    """Power-conservation ledger: emitted == measured + absorbed + escaped +
    culled + live at every step. 0-dim f32 tensors."""

    emitted: torch.Tensor
    measured: torch.Tensor
    absorbed: torch.Tensor
    escaped: torch.Tensor
    culled: torch.Tensor

    @staticmethod
    def start(emitted, device: torch.device | str = "cuda") -> "Ledger":
        """A fresh ledger; `emitted` is a number or a 0-dim tensor (a device
        tensor stays on the device: no host sync)."""
        def z():
            return torch.zeros((), dtype=_F32, device=device)

        return Ledger(torch.as_tensor(emitted, dtype=_F32, device=device),
                      z(), z(), z(), z())

    def accounted(self) -> torch.Tensor:
        return self.measured + self.absorbed + self.escaped + self.culled

    def as_dict(self) -> dict:
        vals = torch.stack(list(self)).cpu().numpy()  # one transfer
        return {k: float(v) for k, v in zip(self._fields, vals)}
