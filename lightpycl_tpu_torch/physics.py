"""Scalar (unpolarized) ray-optics primitives on torch tensors.

Port counterpart of lightpycl_tpu/physics.py, core only: `dot`,
`normalize`, `orient_normal`, `reflect`, `refract_full`, `refract`,
`fresnel_unpolarized` and `snell_interaction`, with the reference's
operation order. The polarized, thin-film, metal, crystal, scattering and
GRIN primitives are not ported yet (ROADMAP.md).

Conventions (as in the reference):
  * direction vectors are unit length, shape (..., 3)
  * `normal` is the geometric unit normal oriented AGAINST the incoming ray
    (i.e. dot(d, n) <= 0); `orient_normal` produces it
  * n1 = IOR of the medium the ray travels in, n2 = IOR beyond the surface
"""

from __future__ import annotations

import torch

# Guard value keeping sqrt/div finite on masked-out lanes; results on those
# lanes are discarded by the caller.
_TINY = 1e-20


def dot(a, b):
    """Batched 3-vector dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


def normalize(v):
    """Unit vector along v (safe for ~zero vectors on masked lanes)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return (v * torch.where(n2 > _TINY, 1.0, 0.0)
            / torch.sqrt(torch.clamp_min(n2, _TINY)))


def orient_normal(d, n_geom):
    """Flip the geometric normal so it faces the incoming ray. Returns
    (n_oriented, entering); `entering` is True on front-face hits."""
    entering = dot(d, n_geom) < 0.0
    n = torch.where(entering[..., None], n_geom, -n_geom)
    return n, entering


def reflect(d, n):
    """Specular reflection of unit direction d about unit normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract_full(d, n, eta):
    """Snell refraction of unit direction d at a surface with normal n,
    eta = n1 / n2. Returns (t_dir, tir, cos_t); t_dir is garbage-but-finite
    where tir, cos_t is 0 there."""
    cos_i = -dot(d, n)  # >= 0 since n faces the ray
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    pos = 1.0 - sin2_t
    cos_t = torch.where(pos > 0.0,
                        torch.sqrt(torch.where(pos > 0.0, pos, 1.0)), 0.0)
    t = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(t), tir, torch.where(tir, 0.0, cos_t)


def refract(d, n, eta):
    """Snell refraction; returns (t_dir, tir). See refract_full."""
    t, tir, _ = refract_full(d, n, eta)
    return t, tir


def fresnel_unpolarized(cos_i, cos_t, n1, n2, tir):
    """Unpolarized Fresnel power reflectance R = (Rs + Rp) / 2; exactly 1.0
    where `tir`."""
    rs_num = n1 * cos_i - n2 * cos_t
    rs_den = n1 * cos_i + n2 * cos_t
    rp_num = n1 * cos_t - n2 * cos_i
    rp_den = n1 * cos_t + n2 * cos_i
    rs = (rs_num / torch.where(torch.abs(rs_den) > _TINY, rs_den, 1.0)) ** 2
    rp = (rp_num / torch.where(torch.abs(rp_den) > _TINY, rp_den, 1.0)) ** 2
    r = 0.5 * (rs + rp)
    return torch.where(tir, 1.0, torch.clamp(r, 0.0, 1.0))


def snell_interaction(d, n_geom, ray_ior, tri_ior, env_ior: float):
    """Full dielectric interaction at a surface (reference semantics:
    entering a dielectric sets the refracted child's IOR to the element's,
    exiting returns it to env_ior). Returns the reference's dict."""
    n, entering = orient_normal(d, n_geom)
    n1 = ray_ior
    n2 = torch.where(entering, tri_ior, env_ior)
    eta = n1 / torch.clamp_min(n2, _TINY)

    cos_i = -dot(d, n)
    refr_dir, tir, cos_t = refract_full(d, n, eta)
    R = fresnel_unpolarized(cos_i, cos_t, n1, n2, tir)
    refl_dir = reflect(d, n)
    new_ior = torch.where(tir, n1, n2)
    return {
        "refl_dir": refl_dir,
        "refr_dir": refr_dir,
        "R": R,
        "new_ior": new_ior,
        "entering": entering,
        "tir": tir,
        "n": n,
        "n1": n1,
        "n2": n2,
        "cos_i": cos_i,
        "cos_t": cos_t,
    }
