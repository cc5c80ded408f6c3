"""Float64 numpy golden tracer — the parity oracle.

Port counterpart of lightpycl_tpu/tracer/oracle.py: a jax-free copy (tests/
test_torch_oracle.py pins it bit for bit to the reference, on the native and
the numpy path). It reads the elements' host geometry only, so it runs
wherever the port runs, the card's machine included.

BASELINE.md: detected-power parity vs the PyOpenCL reference must be <=0.1%;
since no OpenCL runtime exists on this machine, parity is checked against
this independent float64 implementation of the same physics (classic
Möller–Trumbore, per-ray python-free numpy loops, host-side compaction —
structurally the reference's algorithm, SURVEY.md §6 "parity oracle").

Deliberately implemented with DIFFERENT math from the device path (direct
Möller–Trumbore vs unit-triangle transforms) so agreement is evidence of
correctness, not of shared bugs.
"""

from __future__ import annotations

import numpy as np

from lightpycl_tpu_torch.materials import Material


def _mt_nearest_hit(o, d, v0, e1, e2, eps, eps_b, t_max):
    """Möller–Trumbore nearest hit: o,d (N,3); v0,e1,e2 (T,3).
    Returns (t (N,), tri (N,)) with tri == -1 on miss. f64 throughout.

    Uses the native C++ core (lightpycl_tpu_torch/native/oracle.cpp) when a
    compiler is available — ~50x faster than the chunked-numpy fallback,
    which matters for config-4-scale parity runs."""
    try:
        from lightpycl_tpu_torch.native import mt_nearest_hit_native

        out = mt_nearest_hit_native(o, d, v0, e1, e2, eps, eps_b, t_max)
        if out is not None:
            return out
    except Exception:  # pragma: no cover - fall through to numpy
        pass
    N = len(o)
    best_t = np.full(N, np.inf)
    best_i = np.full(N, -1, np.int64)
    # chunk triangles to bound the (N, chunk) intermediates
    chunk = max(1, min(len(v0), max(1, int(4e7 // max(N, 1)))))
    for s in range(0, len(v0), chunk):
        V0, E1, E2 = v0[s:s + chunk], e1[s:s + chunk], e2[s:s + chunk]
        h = np.cross(d[:, None, :], E2[None, :, :])          # (N, K, 3)
        a = np.einsum("kj,nkj->nk", E1, h)                    # (N, K)
        ok = np.abs(a) > 1e-300
        f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
        sv = o[:, None, :] - V0[None, :, :]
        u = f * np.einsum("nkj,nkj->nk", sv, h)
        q = np.cross(sv, E1[None, :, :])
        v = f * np.einsum("nj,nkj->nk", d, q)
        t = f * np.einsum("kj,nkj->nk", E2, q)
        hit = (
            ok
            & (u >= -eps_b) & (v >= -eps_b) & (u + v <= 1.0 + eps_b)
            & (t > eps) & (t < t_max)
        )
        tt = np.where(hit, t, np.inf)
        i = np.argmin(tt, axis=1)
        tmin = tt[np.arange(N), i]
        better = tmin < best_t
        best_t = np.where(better, tmin, best_t)
        best_i = np.where(better, i + s, best_i)
    return best_t, best_i


def _reflect(d, n):
    return d - 2.0 * np.sum(d * n, axis=1, keepdims=True) * n


def _quadric_nearest_hit(o, d, quads, eps, eps_b, t_max):
    """f64 nearest hit over the analytic surfaces (geometry/analytic.py
    model: alpha (x^2+y^2) + beta z^2 + gamma z + delta = 0, bounded).

    Deliberately the PLAIN quadratic formula in float64 — a different
    formulation from the device path's recentered citardauq roots
    (ops/quadric.py), per this module's independence principle.

    Returns (t (N,), row (N,) attribute-row index or -1, normal (N, 3))."""
    N = len(o)
    best_t = np.full(N, np.inf)
    best_row = np.full(N, -1, np.int64)
    best_n = np.zeros((N, 3))
    for row, abgd, rlim, zlim, vertex, frame in quads:
        al, be, ga, de = abgd
        ol = (o - vertex) @ frame.T
        dl = d @ frame.T
        A = al * (dl[:, 0] ** 2 + dl[:, 1] ** 2) + be * dl[:, 2] ** 2
        B = (2.0 * al * (ol[:, 0] * dl[:, 0] + ol[:, 1] * dl[:, 1])
             + 2.0 * be * ol[:, 2] * dl[:, 2] + ga * dl[:, 2])
        Cq = (al * (ol[:, 0] ** 2 + ol[:, 1] ** 2) + be * ol[:, 2] ** 2
              + ga * ol[:, 2] + de)
        disc = B * B - 4.0 * A * Cq
        sq = np.sqrt(np.maximum(disc, 0.0))
        is_q = A != 0.0
        Asafe = np.where(is_q, A, 1.0)
        t0 = np.where(is_q & (disc >= 0.0), (-B - sq) / (2.0 * Asafe), np.inf)
        t1 = np.where(is_q & (disc >= 0.0), (-B + sq) / (2.0 * Asafe), np.inf)
        Bsafe = np.where(B != 0.0, B, 1.0)
        t_lin = np.where(~is_q & (B != 0.0), -Cq / Bsafe, np.inf)
        t0 = np.where(is_q, t0, t_lin)

        cand = np.full(N, np.inf)
        for tt in (t0, t1):
            fin = np.isfinite(tt)
            p = ol + np.where(fin, tt, 0.0)[:, None] * dl
            r2 = p[:, 0] ** 2 + p[:, 1] ** 2
            z = p[:, 2]
            ok = (fin & (tt > eps) & (tt < t_max)
                  & (r2 >= rlim[0] ** 2 * (1.0 - eps_b))
                  & (r2 <= rlim[1] ** 2 * (1.0 + eps_b) + eps_b)
                  & (z >= zlim[0] - eps_b * (1.0 + abs(zlim[0])))
                  & (z <= zlim[1] + eps_b * (1.0 + abs(zlim[1]))))
            cand = np.minimum(cand, np.where(ok, tt, np.inf))

        better = cand < best_t
        if better.any():
            pl = ol[better] + cand[better, None] * dl[better]
            grad = np.stack([2.0 * al * pl[:, 0], 2.0 * al * pl[:, 1],
                             2.0 * be * pl[:, 2] + ga], axis=1)
            nw = grad @ frame
            nw /= np.maximum(np.linalg.norm(nw, axis=1, keepdims=True),
                             1e-300)
            best_t[better] = cand[better]
            best_row[better] = row
            best_n[better] = nw
    return best_t, best_row, best_n


def _film_reflectance_matrix(cos_i, n1, stack_n, stack_h, n2, wl):
    """Unpolarized R of a lossless dielectric stack via the
    CHARACTERISTIC-MATRIX method (Abeles/Macleod), complex128 —
    deliberately a different formulation from the device path's bottom-up
    Airy recursion (physics.multilayer_rs_rp), per this module's
    independence principle.

    stack_n / stack_h: (N, L) per-ray layer indices/thicknesses, layer 0
    outermost.  [B, C]^T = (prod_k M_k) @ [1, eta_sub]^T with
    M_k = [[cos d_k, i sin d_k / eta_k], [i eta_k sin d_k, cos d_k]],
    d_k = 2 pi n_k h_k cos(theta_k) / wl;
    r = (eta_1 B - C) / (eta_1 B + C).
    Tilted admittances: eta_s = n cos(theta), eta_p = n / cos(theta).
    h = 0 layers give M = I exactly.
    """
    stack_n = np.atleast_2d(np.maximum(stack_n, 1e-9))
    stack_h = np.atleast_2d(stack_h)
    n2 = np.maximum(n2, 1e-9)
    sin2 = np.maximum(0.0, 1.0 - cos_i**2)
    n1s2 = n1**2 * sin2
    c2 = np.sqrt(1.0 - n1s2 / n2**2 + 0j)

    def _R(pol):
        # running [B, C] vector, initialized at the substrate
        eta2 = n2 * c2 if pol == "s" else n2 / c2
        B = np.ones_like(eta2)
        C = eta2.copy()
        for k in range(stack_n.shape[1] - 1, -1, -1):
            nf = stack_n[:, k]
            cf = np.sqrt(1.0 - n1s2 / nf**2 + 0j)
            etaf = nf * cf if pol == "s" else nf / cf
            d = 2.0 * np.pi * nf * stack_h[:, k] * cf / wl
            cd, sd = np.cos(d), np.sin(d)
            B, C = cd * B + 1j * sd / etaf * C, 1j * etaf * sd * B + cd * C
        eta1 = n1 * cos_i if pol == "s" else n1 / cos_i
        return np.abs((eta1 * B - C) / (eta1 * B + C)) ** 2

    return np.clip(0.5 * (_R("s") + _R("p")), 0.0, 1.0)


def trace_oracle(elements, origins, dirs, powers, *, trace_iterations=8,
                 max_ray_len=1e3, ior_env=1.0, eps=1e-4, eps_bary=1e-6,
                 power_cutoff=0.0, wavelengths=None):
    """Trace with dynamic host-side ray lists (rays genuinely split 2x).

    Returns dict with measured ray arrays, the power ledger, and per-detector
    totals — the quantities the parity tests compare.
    """
    v0s, e1s, e2s, mats, iors, refls, dets = [], [], [], [], [], [], []
    iorbs = []
    iorcs = []
    absorbs = []
    axes, mlps, g0s = [], [], []
    mns, mks = [], []
    coat_stacks = []
    det_names = []
    quads = []      # analytic surfaces: (attr row, abgd, rlim, zlim, vx, fr)
    n_tris = 0
    for el in elements:
        if el.material in (Material.POLARIZER, Material.WAVEPLATE,
                           Material.BIREFRINGENT):
            raise ValueError(
                "the f64 oracle is unpolarized scalar optics; polarizer/"
                "waveplate/birefringent scenes are validated against "
                "analytic Mueller / crystal-optics anchors instead "
                "(tests/test_polarizer.py, tests/test_birefringence.py)")
        if float(getattr(el, "scattering", 0.0)) > 0.0:
            raise ValueError(
                "the f64 oracle is deterministic; volume-scattering "
                "(turbid) media are validated by the Beer-Lambert "
                "ballistic-extinction and Henyey-Greenstein moment "
                "anchors instead (tests/test_scattering.py)")
        if float(getattr(el, "fluorescence", 0.0)) > 0.0:
            raise ValueError(
                "the f64 oracle is deterministic; fluorescent media are "
                "validated by the Beer-Lambert conversion-extinction, "
                "quantum-yield ledger, and emission-spectrum anchors "
                "instead (tests/test_fluorescence.py)")
        if float(getattr(el, "grin_a", 0.0)) != 0.0:
            raise ValueError(
                "the f64 oracle traces straight segments; GRIN media are "
                "validated by the SELFOC sinusoid / axial-invariant "
                "anchors instead (tests/test_grin.py)")
        if el.material == Material.DIFFUSE:
            raise ValueError(
                "the f64 oracle is deterministic; Lambertian scatterers are "
                "validated against analytic cosine-law statistics instead "
                "(tests/test_diffuse.py)")
        tv = el.triangle_vertices()
        t = len(tv)
        if t == 0:
            continue
        if getattr(el, "quad_abgd", None) is not None:
            # analytic surface (geometry/analytic.py): its placeholder
            # triangle gets ZERO edges so Möller–Trumbore can never hit it
            # (a = dot(e1, h) == 0); the exact f64 quadric pass below hits
            # the surface instead and reuses this attribute row
            quads.append((n_tris, np.asarray(el.quad_abgd, np.float64),
                          np.asarray(el.quad_rlim, np.float64),
                          np.asarray(el.quad_zlim, np.float64),
                          np.asarray(el.quad_vertex, np.float64),
                          np.asarray(el.quad_frame, np.float64)))
            v0s.append(tv[:, 0])
            e1s.append(np.zeros((t, 3)))
            e2s.append(np.zeros((t, 3)))
        else:
            v0s.append(tv[:, 0]); e1s.append(tv[:, 1] - tv[:, 0]); e2s.append(tv[:, 2] - tv[:, 0])
        n_tris += t
        mats.append(np.full(t, int(el.material)))
        iors.append(np.full(t, el.ior))
        iorbs.append(np.full(t, float(getattr(el, "dispersion_b", 0.0))))
        iorcs.append(np.full(t, float(getattr(el, "dispersion_c", 0.0))))
        absorbs.append(np.full(t, float(getattr(el, "absorption", 0.0))))
        refls.append(np.full(t, el.reflectivity))
        ax = (np.zeros(3) if getattr(el, "axis", None) is None
              else np.asarray(el.axis, np.float64))
        axes.append(np.tile(ax, (t, 1)))
        period = float(getattr(el, "grating_period", 0.0))
        mlps.append(np.full(t, (float(getattr(el, "grating_order", 1)) / period
                                if period > 0 else 0.0)))
        g0s.append(np.full(t, float(getattr(el, "order0_fraction", 0.0))
                           if period > 0 else 0.0))
        mns.append(np.full(t, float(getattr(el, "metal_n", 0.0))))
        mks.append(np.full(t, float(getattr(el, "metal_k", 0.0))))
        coat_stacks.append((t, el.coating_layers()
                            if hasattr(el, "coating_layers") else []))
        if el.material == Material.MEASURE:
            dets.append(np.full(t, len(det_names)))
            det_names.append(el.name or f"detector_{len(det_names)}")
        else:
            dets.append(np.full(t, -1))
    v0 = np.concatenate(v0s); e1 = np.concatenate(e1s); e2 = np.concatenate(e2s)
    mat = np.concatenate(mats); ior_in = np.concatenate(iors)
    ior_b = np.concatenate(iorbs)
    ior_c = np.concatenate(iorcs)
    tri_absorb = np.concatenate(absorbs)
    refl = np.concatenate(refls); det_id = np.concatenate(dets)
    g_axis = np.concatenate(axes); g_mlp = np.concatenate(mlps)
    g_g0 = np.concatenate(g0s)
    m_n = np.concatenate(mns); m_k = np.concatenate(mks)
    L_coat = max((len(ls) for _, ls in coat_stacks), default=0) or 1
    coat_n = np.concatenate([
        np.tile([n for n, _ in ls] + [1.0] * (L_coat - len(ls)), (t, 1))
        for t, ls in coat_stacks])
    coat_h = np.concatenate([
        np.tile([h for _, h in ls] + [0.0] * (L_coat - len(ls)), (t, 1))
        for t, ls in coat_stacks])
    n_geom = np.cross(e1, e2)
    n_geom /= np.maximum(np.linalg.norm(n_geom, axis=1, keepdims=True), 1e-300)

    o = np.asarray(origins, np.float64)
    d = np.asarray(dirs, np.float64)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    p = np.asarray(powers, np.float64)
    ior = np.full(len(o), float(ior_env))
    wl = (np.full(len(o), 0.5876) if wavelengths is None
          else np.asarray(wavelengths, np.float64))
    ab = np.zeros(len(o))
    opl = np.zeros(len(o))

    emitted = p.sum()
    measured_pos, measured_dir, measured_pow, measured_det = [], [], [], []
    measured_opl = []
    absorbed = escaped = culled = 0.0

    for _ in range(trace_iterations):
        if len(o) == 0:
            break
        t, ti = _mt_nearest_hit(o, d, v0, e1, e2, eps, eps_bary, max_ray_len)
        # per-ray geometric normal: the triangle's, overridden with the
        # exact quadric gradient where an analytic surface is nearer
        ng_ray = n_geom[np.maximum(ti, 0)]
        if quads:
            tq, qrow, qn = _quadric_nearest_hit(
                o, d, quads, eps, max(eps_bary, 1e-6), max_ray_len)
            use_q = tq < t
            t = np.where(use_q, tq, t)
            ti = np.where(use_q, qrow, ti)
            ng_ray = np.where(use_q[:, None], qn, ng_ray)
        hit = ti >= 0
        hp = o + np.where(hit, t, max_ray_len)[:, None] * d

        opl = opl + ior * np.where(hit, t, max_ray_len)

        # Beer-Lambert bulk attenuation over the segment just traveled
        atten = np.exp(-ab * np.where(hit, t, max_ray_len))
        absorbed += (p * (1.0 - atten)).sum()
        p = p * atten

        escaped += p[~hit].sum()

        m = np.where(hit, mat[np.maximum(ti, 0)], -1)
        is_mirror = m == int(Material.MIRROR)
        is_refr = m == int(Material.REFRACTIVE)
        is_term = m == int(Material.TERMINATOR)
        is_meas = m == int(Material.MEASURE)
        is_bs = m == int(Material.BEAMSPLITTER)
        is_gr = m == int(Material.GRATING)

        absorbed += p[is_term].sum()
        if is_meas.any():
            measured_pos.append(hp[is_meas])
            measured_dir.append(d[is_meas])
            measured_pow.append(p[is_meas])
            measured_det.append(det_id[ti[is_meas]])
            measured_opl.append(opl[is_meas])

        new_o, new_d, new_p, new_ior, new_wl, new_ab = [], [], [], [], [], []
        new_opl = []

        # mirrors: one reflected child
        if is_mirror.any():
            i = is_mirror
            ng = ng_ray[i]
            cos = np.sum(d[i] * ng, axis=1)
            n = np.where(cos[:, None] < 0, ng, -ng)
            r = refl[ti[i]]
            # complex-index metal mirrors (extension): R(theta) from the
            # complex Fresnel amplitudes in float64, physical branch of the
            # square root (decay into the metal)
            mn = m_n[ti[i]]
            if (mn > 0).any():
                mk = m_k[ti[i]]
                ci = np.abs(cos)
                nc = np.where(mn > 0, mn, 1.0) - 1j * mk
                s2 = (1.0 - ci**2) * (ior[i] / nc) ** 2
                ct = np.sqrt(1.0 - s2 + 0j)
                ct = np.where((nc * ct).real < 0, -ct, ct)
                rs = (ior[i] * ci - nc * ct) / (ior[i] * ci + nc * ct)
                rp = (nc * ci - ior[i] * ct) / (nc * ci + ior[i] * ct)
                Rm = 0.5 * (np.abs(rs) ** 2 + np.abs(rp) ** 2)
                r = r * np.where(mn > 0, Rm, 1.0)
            absorbed += (p[i] * (1.0 - r)).sum()
            new_o.append(hp[i]); new_d.append(_reflect(d[i], n))
            new_p.append(p[i] * r); new_ior.append(ior[i]); new_wl.append(wl[i])
            new_ab.append(ab[i]); new_opl.append(opl[i])

        # reflection gratings, computed in an explicit local orthonormal
        # frame (g, q, n) — a DIFFERENT construction from the device path's
        # projection-subtraction form, per this module's independence
        # principle: decompose d into frame components, shift the
        # g-component by m*lambda0/(n_medium*period) (conical diffraction
        # leaves the groove component untouched), re-assemble.
        if is_gr.any():
            i = is_gr
            ng = ng_ray[i]
            cos = np.sum(d[i] * ng, axis=1)
            n = np.where(cos[:, None] < 0, ng, -ng)
            g = np.cross(np.cross(n, g_axis[ti[i]]), n)   # tangential axis
            g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-300)
            q = np.cross(n, g)                            # groove direction
            alpha = np.sum(d[i] * g, axis=1)              # frame components
            beta = np.sum(d[i] * q, axis=1)
            alpha2 = alpha + wl[i] / ior[i] * g_mlp[ti[i]]
            s2 = alpha2**2 + beta**2
            prop = s2 <= 1.0
            gamma = np.sqrt(np.maximum(1.0 - s2, 0.0))    # reflected side
            dd = alpha2[:, None] * g + beta[:, None] * q + gamma[:, None] * n
            dd /= np.maximum(np.linalg.norm(dd, axis=1, keepdims=True), 1e-300)
            r = refl[ti[i]]
            g0v = g_g0[ti[i]]
            # (1 - r) always lost; an evanescent order m loses its
            # (1 - g0) share too. Order m child (power r (1 - g0)) plus
            # the specular 0th-order leak (power r g0) — matches the
            # device path's dual-order model (tracer/step.py).
            absorbed += (p[i] * (1.0 - r)).sum()
            absorbed += (p[i] * r * (1.0 - g0v) * ~prop).sum()
            new_o.append(hp[i]); new_d.append(dd)
            new_p.append(p[i] * np.where(prop, r * (1.0 - g0v), 0.0))
            new_ior.append(ior[i]); new_wl.append(wl[i]); new_ab.append(ab[i])
            new_opl.append(opl[i])
            if (g0v > 0).any():
                new_o.append(hp[i]); new_d.append(_reflect(d[i], n))
                new_p.append(p[i] * r * g0v)
                new_ior.append(ior[i]); new_wl.append(wl[i])
                new_ab.append(ab[i]); new_opl.append(opl[i])

        # beamsplitters: mirror-style reflected child (R) + straight-through
        # transmitted child (1 - R), no refraction or medium change
        if is_bs.any():
            i = is_bs
            ng = ng_ray[i]
            cos = np.sum(d[i] * ng, axis=1)
            n = np.where(cos[:, None] < 0, ng, -ng)
            r = refl[ti[i]]
            new_o.append(hp[i]); new_d.append(_reflect(d[i], n))
            new_p.append(p[i] * r); new_ior.append(ior[i]); new_wl.append(wl[i])
            new_ab.append(ab[i]); new_opl.append(opl[i])
            new_o.append(hp[i]); new_d.append(d[i])
            new_p.append(p[i] * (1.0 - r)); new_ior.append(ior[i])
            new_wl.append(wl[i]); new_ab.append(ab[i]); new_opl.append(opl[i])

        # dielectrics: Fresnel split into reflected + refracted children
        if is_refr.any():
            i = is_refr
            ng = ng_ray[i]
            cos_raw = np.sum(d[i] * ng, axis=1)
            entering = cos_raw < 0
            n = np.where(entering[:, None], ng, -ng)
            n1 = ior[i]
            # (extended-)Cauchy dispersion: n = A + B/wl^2 + C/wl^4
            n_tri = (ior_in[ti[i]] + ior_b[ti[i]] / wl[i] ** 2
                     + ior_c[ti[i]] / wl[i] ** 4)
            n2 = np.where(entering, n_tri, ior_env)
            eta = n1 / n2
            cos_i = -np.sum(d[i] * n, axis=1)
            sin2_t = eta**2 * np.maximum(0.0, 1.0 - cos_i**2)
            tir = sin2_t > 1.0
            cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin2_t))
            rs = ((n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)) ** 2
            rp = ((n1 * cos_t - n2 * cos_i) / (n1 * cos_t + n2 * cos_i)) ** 2
            R = np.where(tir, 1.0, 0.5 * (rs + rp))
            # thin-film coating stack overrides the bare Fresnel R; exiting
            # rays see the layer order reversed (h = 0 pads are inert)
            ch = coat_h[ti[i]]             # (M, L)
            if (ch > 0).any():
                cn_ = coat_n[ti[i]]
                ent_col = entering[:, None]
                cn_use = np.where(ent_col, cn_, cn_[:, ::-1])
                ch_use = np.where(ent_col, ch, ch[:, ::-1])
                Rf = _film_reflectance_matrix(
                    np.maximum(cos_i, 1e-12), n1, cn_use, ch_use, n2,
                    wl[i])
                coated = ch.max(axis=1) > 0
                R = np.where(coated, np.where(tir, 1.0, Rf), R)
            # reflected child
            new_o.append(hp[i]); new_d.append(_reflect(d[i], n))
            new_p.append(p[i] * R); new_ior.append(n1); new_wl.append(wl[i])
            new_ab.append(ab[i]); new_opl.append(opl[i])
            # refracted child (zero power under TIR)
            tdir = eta[:, None] * d[i] + (eta * cos_i - cos_t)[:, None] * n
            tlen = np.maximum(np.linalg.norm(tdir, axis=1, keepdims=True), 1e-300)
            new_o.append(hp[i]); new_d.append(tdir / tlen)
            new_p.append(p[i] * (1.0 - R)); new_ior.append(np.where(tir, n1, n2))
            new_wl.append(wl[i])
            new_ab.append(np.where(tir, ab[i],
                                   np.where(entering, tri_absorb[ti[i]], 0.0)))
            new_opl.append(opl[i])

        if not new_o:
            o = np.zeros((0, 3)); d = np.zeros((0, 3))
            p = np.zeros(0); ior = np.zeros(0); wl = np.zeros(0); ab = np.zeros(0)
            opl = np.zeros(0)
            continue
        o = np.concatenate(new_o); d = np.concatenate(new_d)
        p = np.concatenate(new_p); ior = np.concatenate(new_ior)
        wl = np.concatenate(new_wl)
        ab = np.concatenate(new_ab)
        opl = np.concatenate(new_opl)
        keep = p > power_cutoff
        culled += p[~keep].sum()
        o, d, p, ior, wl, ab, opl = (o[keep], d[keep], p[keep], ior[keep],
                                     wl[keep], ab[keep], opl[keep])

    live = p.sum() if len(p) else 0.0
    return {
        "measured_pos": np.concatenate(measured_pos) if measured_pos else np.zeros((0, 3)),
        "measured_dir": np.concatenate(measured_dir) if measured_dir else np.zeros((0, 3)),
        "measured_power": np.concatenate(measured_pow) if measured_pow else np.zeros(0),
        "measured_det": np.concatenate(measured_det) if measured_det else np.zeros(0, np.int64),
        "measured_opl": np.concatenate(measured_opl) if measured_opl else np.zeros(0),
        "detector_names": det_names,
        "emitted": emitted,
        "measured": float(sum(x.sum() for x in measured_pow)) if measured_pow else 0.0,
        "absorbed": float(absorbed),
        "escaped": float(escaped),
        "culled": float(culled),
        "live": float(live),
    }
