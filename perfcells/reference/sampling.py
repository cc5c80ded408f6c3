"""Frozen copies of the source samplers the cells use.

* `point_source_rays`: the port's `LightSource.sample` in 'weighted' mode
  (numpy, `default_rng(seed)`): directions uniform on the cap polar <=
  polar_max about the axis, powers proportional to the directivity.
* `collimated_uniforms` / `collimated_rays`: the port's device sampler of a
  `CollimatedSource` ('random' sampling, no divergence) under
  `trace_batched`: batch b draws two float32 unit uniforms per ray from a
  torch.Generator seeded from the words (seed, b, 0) through numpy's
  SeedSequence; the map to rays is done here in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DIRECTIVITY = {
    "isotropic": lambda az, pol: np.ones_like(pol),
    "cos_polar": lambda az, pol: np.cos(pol),
}


def frame(direction) -> np.ndarray:
    """Orthonormal rows (u, v, w), w along `direction`."""
    w = np.asarray(direction, dtype=np.float64)
    w = w / np.linalg.norm(w)
    a = (np.array([1.0, 0.0, 0.0]) if abs(w[0]) < 0.9
         else np.array([0.0, 1.0, 0.0]))
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    return np.stack([u, np.cross(w, u), w])


def point_source_rays(center, direction, directivity, power, ray_count,
                      seed, polar_max=math.pi / 2.0):
    """(origins, directions, powers) float64 of a weighted point source."""
    rng = np.random.default_rng(seed)
    n = int(ray_count)
    z = rng.uniform(np.cos(polar_max), 1.0, size=n)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    d = np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)
    pol = np.arccos(np.clip(z, -1.0, 1.0))
    w = np.maximum(0.0, np.asarray(DIRECTIVITY[directivity](phi, pol),
                                   np.float64))
    powers = w * (power / w.sum())
    origins = np.broadcast_to(np.asarray(center, np.float64), (n, 3)).copy()
    return origins, d @ frame(direction), powers


def generator(device, *words: int) -> torch.Generator:
    """A torch.Generator whose stream depends only on the integers
    `words`."""
    seed = np.random.SeedSequence(
        [int(w) & 0xFFFFFFFFFFFFFFFF for w in words]).generate_state(
            1, np.uint64)[0]
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return g


def collimated_uniforms(device, seed, batch, n):
    """The two (n,) float32 unit uniforms of batch `batch` of a job."""
    g = generator(device, seed, batch, 0)
    return [torch.rand((n,), generator=g, dtype=torch.float32, device=device)
            for _ in range(2)]


def collimated_rays(center, direction, diameter, power, u1, u2):
    """(origins, directions, powers) float64 of a collimated bundle
    through a disc aperture, from its unit uniforms; powers sum to
    `power` over the n rays drawn."""
    u1, u2 = u1.double(), u2.double()
    n = u1.shape[0]
    F = torch.as_tensor(frame(direction), dtype=torch.float64,
                        device=u1.device)
    r = 0.5 * diameter * torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    o = (torch.as_tensor(center, dtype=torch.float64, device=u1.device)
         + (r * torch.cos(phi))[:, None] * F[0]
         + (r * torch.sin(phi))[:, None] * F[1])
    d = F[2].expand(n, 3).clone()
    return o, d, torch.full((n,), power / n, dtype=torch.float64,
                            device=u1.device)
