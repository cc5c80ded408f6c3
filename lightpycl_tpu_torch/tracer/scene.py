"""Scene flattening: GeoObjects -> device triangle-soup tensors.

Port counterpart of lightpycl_tpu/tracer/scene.py. `build_scene` does the
reference's float64 numpy work line for line (triangle soup, per-triangle
attribute columns, optional Morton `spatial_sort`, the world -> unit-triangle
affine rows wu/wv/ww, all-zero padding rows up to `pad_to`) and only then
casts every column to a float32 / int32 tensor on the requested device, so
both packages trace identical input bits (tests/test_torch_host_layer.py).

Hit test the rows serve (see the reference module for the derivation):
q = OW / DW, u = OU - q DU, v = OV - q DV, hit iff q < -eps,
u >= -eps_b, v >= -eps_b and u + v <= 1 + eps_b; padding rows give
DW == 0 -> NaN or inf -> every compare false.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from lightpycl_tpu_torch.geometry.mesh import GeoObject
from lightpycl_tpu_torch.materials import Material
from lightpycl_tpu_torch.tracer.rays import tensor_from_array
from lightpycl_tpu_torch.utils.profiling import count, span, spanned


class Scene(NamedTuple):
    """Flattened device scene (all per-triangle columns padded to T_pad).
    Same fields as the reference Scene; see it for each column's meaning."""

    v0: torch.Tensor            # (T_pad, 3) f32
    e1: torch.Tensor            # (T_pad, 3) f32
    e2: torch.Tensor            # (T_pad, 3) f32
    normal: torch.Tensor        # (T_pad, 3) f32 unit outward normal
    wu: torch.Tensor            # (T_pad, 4) f32 unit-transform row u
    wv: torch.Tensor            # (T_pad, 4) f32 row v
    ww: torch.Tensor            # (T_pad, 4) f32 row w (plane row)
    mat: torch.Tensor           # (T_pad,) i32 Material code
    ior: torch.Tensor           # (T_pad,) f32 Cauchy A
    ior_b: torch.Tensor         # (T_pad,) f32 Cauchy B [um^2]
    absorb: torch.Tensor        # (T_pad,) f32 bulk absorption [1/len]
    reflectivity: torch.Tensor  # (T_pad,) f32
    detector_id: torch.Tensor   # (T_pad,) i32, -1 off measure surfaces
    axis: torch.Tensor          # (T_pad, 3) f32
    retardance: torch.Tensor    # (T_pad,) f32
    grating_mlp: torch.Tensor   # (T_pad,) f32
    grating_g0: torch.Tensor    # (T_pad,) f32
    metal_n: torch.Tensor       # (T_pad,) f32
    metal_k: torch.Tensor       # (T_pad,) f32
    coat_ior: torch.Tensor      # (T_pad, L) f32
    coat_thickness: torch.Tensor  # (T_pad, L) f32
    ior_c: torch.Tensor = None      # (T_pad,) f32 Cauchy C [um^4]
    bire_ne: torch.Tensor = None
    scat_mu: torch.Tensor = None
    scat_g: torch.Tensor = None
    rough_sigma: torch.Tensor = None
    rough_g: torch.Tensor = None
    element_id: torch.Tensor = None  # (T_pad,) i32, -1 on padding
    fluor_mu: torch.Tensor = None
    fluor_qy: torch.Tensor = None
    fluor_edge: torch.Tensor = None
    fluor_icdf: torch.Tensor = None
    grin_a: torch.Tensor = None
    grin_n0: torch.Tensor = None
    grin_center: torch.Tensor = None
    grin_axis: torch.Tensor = None
    grin_wu: torch.Tensor = None
    grin_wv: torch.Tensor = None
    grin_ww: torch.Tensor = None
    quad_abgd: torch.Tensor = None
    quad_rlim: torch.Tensor = None
    quad_zlim: torch.Tensor = None
    quad_vertex: torch.Tensor = None
    quad_frame: torch.Tensor = None
    quad_tri: torch.Tensor = None

    @property
    def num_triangles_padded(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    @staticmethod
    def from_reference(obj, device) -> "Scene":
        """The port's copy of a reference Scene, field by field (absent or
        None fields stay None)."""
        vals = {}
        for f in Scene._fields:
            a = getattr(obj, f, None)
            vals[f] = None if a is None else tensor_from_array(a, device)
        return Scene(**vals)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _morton3_np(q: np.ndarray) -> np.ndarray:
    """Interleave 3x10-bit quantized coords into 30-bit Morton codes."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    q = q.astype(np.uint32)
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


@spanned("scene.build")
def build_scene(objects: Sequence[GeoObject], pad_to: int = 256,
                spatial_sort: bool = False,
                device: torch.device | str = "cuda"
                ) -> tuple[Scene, list[str]]:
    """Flatten optical elements into a Scene on `device`.

    Returns (scene, detector_names) where detector_names[i] labels the
    measure surface with detector_id == i. Padding triangles are degenerate
    (all-zero transform rows -> DW == 0 -> never hit). spatial_sort orders
    triangles by the Morton code of their centroids (compact triangle tiles
    for the cull mask); physics is order-independent.
    """
    if not objects:
        raise ValueError("scene needs at least one optical element")
    count("scene.builds", 1)
    tv_list, mat_list, ior_list, refl_list, det_list = [], [], [], [], []
    iorb_list = []
    iorc_list = []
    absorb_list = []
    axis_list, ret_list, gr_list, g0_list = [], [], [], []
    mn_list, mk_list = [], []
    bire_list = []
    smu_list, sg_list = [], []
    rsig_list, rg_list = [], []
    coat_stacks = []  # (t, [(n, h), ...]) per element; widths equalized below
    detector_names: list[str] = []
    elem_list = []
    for i_obj, obj in enumerate(objects):
        t = obj.num_triangles
        if t == 0:
            continue
        elem_list.append(np.full(t, i_obj, np.int32))
        tv_list.append(obj.triangle_vertices())  # (t, 3, 3) f64
        mat_list.append(np.full(t, int(obj.material), np.int32))
        ior_list.append(np.full(t, float(obj.ior), np.float64))
        iorb_list.append(np.full(t, float(getattr(obj, "dispersion_b", 0.0)),
                                 np.float64))
        iorc_list.append(np.full(t, float(getattr(obj, "dispersion_c", 0.0)),
                                 np.float64))
        absorb_list.append(np.full(t, float(getattr(obj, "absorption", 0.0)),
                                   np.float64))
        refl_list.append(np.full(t, float(obj.reflectivity), np.float64))
        ax = (np.zeros(3) if getattr(obj, "axis", None) is None
              else np.asarray(obj.axis, np.float64))
        axis_list.append(np.tile(ax, (t, 1)))
        ret_list.append(np.full(t, float(getattr(obj, "retardance", 0.0)),
                                np.float64))
        period = float(getattr(obj, "grating_period", 0.0))
        mlp = (float(getattr(obj, "grating_order", 1)) / period
               if period > 0 else 0.0)
        gr_list.append(np.full(t, mlp, np.float64))
        g0_list.append(np.full(t, float(getattr(obj, "order0_fraction", 0.0))
                               if period > 0 else 0.0, np.float64))
        mn_list.append(np.full(t, float(getattr(obj, "metal_n", 0.0)),
                               np.float64))
        mk_list.append(np.full(t, float(getattr(obj, "metal_k", 0.0)),
                               np.float64))
        bire_list.append(np.full(t, float(getattr(obj, "ne", 0.0)),
                                 np.float64))
        smu_list.append(np.full(t, float(getattr(obj, "scattering", 0.0)),
                                np.float64))
        sg_list.append(np.full(t, float(getattr(obj, "scatter_g", 0.0)),
                               np.float64))
        rsig_list.append(np.full(t, float(getattr(obj, "roughness", 0.0)),
                                 np.float64))
        rg_list.append(np.full(t, float(getattr(obj, "roughness_lobe", 0.9)),
                               np.float64))
        layers = (obj.coating_layers() if hasattr(obj, "coating_layers")
                  else [])
        coat_stacks.append((t, layers))
        if obj.material == Material.MEASURE:
            det_id = len(detector_names)
            detector_names.append(obj.name or f"detector_{det_id}")
            det_list.append(np.full(t, det_id, np.int32))
        else:
            det_list.append(np.full(t, -1, np.int32))

    tv = np.concatenate(tv_list)              # (T, 3, 3)
    mat_np = np.concatenate(mat_list)
    ior_np = np.concatenate(ior_list)
    iorb_np = np.concatenate(iorb_list)
    iorc_np = np.concatenate(iorc_list)
    absorb_np = np.concatenate(absorb_list)
    refl_np = np.concatenate(refl_list)
    det_np = np.concatenate(det_list)
    axis_np = np.concatenate(axis_list)
    ret_np = np.concatenate(ret_list)
    gr_np = np.concatenate(gr_list)
    g0_np = np.concatenate(g0_list)
    mn_np = np.concatenate(mn_list)
    mk_np = np.concatenate(mk_list)
    bire_np = np.concatenate(bire_list)
    smu_np = np.concatenate(smu_list)
    sg_np = np.concatenate(sg_list)
    rsig_np = np.concatenate(rsig_list)
    rg_np = np.concatenate(rg_list)
    elem_np = np.concatenate(elem_list)
    # coating stacks, width-equalized to the scene's deepest stack (h = 0
    # padding layers are exactly inert)
    L_coat = max((len(layers) for _, layers in coat_stacks), default=0) or 1
    cior_np = np.concatenate([
        np.tile([n for n, _ in layers] + [1.0] * (L_coat - len(layers)),
                (t, 1))
        for t, layers in coat_stacks])
    cth_np = np.concatenate([
        np.tile([h for _, h in layers] + [0.0] * (L_coat - len(layers)),
                (t, 1))
        for t, layers in coat_stacks])
    if spatial_sort:
        with span("scene.morton_sort"):
            c = tv.mean(axis=1)
            lo, hi = c.min(axis=0), c.max(axis=0)
            qn = np.clip((c - lo) / np.maximum(hi - lo, 1e-30) * 1023.0,
                         0, 1023)
            order = np.argsort(_morton3_np(qn), kind="stable")
            tv = tv[order]
            mat_np, ior_np, iorb_np = (mat_np[order], ior_np[order],
                                       iorb_np[order])
            iorc_np = iorc_np[order]
            absorb_np, refl_np, det_np = (absorb_np[order], refl_np[order],
                                          det_np[order])
            axis_np, ret_np = axis_np[order], ret_np[order]
            gr_np = gr_np[order]
            g0_np = g0_np[order]
            mn_np, mk_np = mn_np[order], mk_np[order]
            bire_np = bire_np[order]
            smu_np, sg_np = smu_np[order], sg_np[order]
            rsig_np, rg_np = rsig_np[order], rg_np[order]
            cior_np, cth_np = cior_np[order], cth_np[order]
            elem_np = elem_np[order]
    T = len(tv)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = np.cross(e1, e2)
    n_len = np.linalg.norm(n, axis=1, keepdims=True)
    ok = (n_len[:, 0] > 1e-30)
    n_unit = n / np.where(n_len > 0, n_len, 1.0)

    # unit-triangle transform rows, f64 for conditioning, then cast f32
    A = np.stack([e1, e2, n], axis=2)         # (T, 3, 3) columns e1|e2|n
    rows = np.zeros((T, 3, 4))
    if ok.any():
        A_inv = np.linalg.inv(A[ok])
        b = -np.einsum("tij,tj->ti", A_inv, v0[ok])
        rows[ok, :, :3] = A_inv
        rows[ok, :, 3] = b

    # analytic quadric surfaces: zero their placeholder triangles' transform
    # rows (never hit) and record which attribute row each surface owns
    quad_objs = [(i, o) for i, o in enumerate(objects)
                 if getattr(o, "quad_abgd", None) is not None]
    quad_tri_np = None
    if quad_objs:
        quad_tri_np = np.array(
            [int(np.nonzero(elem_np == i)[0][0]) for i, _ in quad_objs],
            np.int32)
        rows[quad_tri_np] = 0.0

    T_pad = _round_up(max(T, 1), pad_to)
    pad = T_pad - T

    def _p(a, fill=0.0):
        a = np.asarray(a)
        if pad == 0:
            return a
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)])

    def f32(a):
        return tensor_from_array(np.asarray(a, np.float32), device)

    def i32(a):
        return tensor_from_array(np.asarray(a, np.int32), device)

    cols = dict(
        v0=f32(_p(v0)),
        e1=f32(_p(e1)),
        e2=f32(_p(e2)),
        normal=f32(_p(n_unit)),
        wu=f32(_p(rows[:, 0])),
        wv=f32(_p(rows[:, 1])),
        ww=f32(_p(rows[:, 2])),
        mat=i32(_p(mat_np, fill=int(Material.TERMINATOR))),
        ior=f32(_p(ior_np, fill=1.0)),
        ior_b=f32(_p(iorb_np, fill=0.0)),
        ior_c=f32(_p(iorc_np, fill=0.0)),
        absorb=f32(_p(absorb_np, fill=0.0)),
        reflectivity=f32(_p(refl_np, fill=0.0)),
        detector_id=i32(_p(det_np, fill=-1)),
        axis=f32(_p(axis_np, fill=0.0)),
        retardance=f32(_p(ret_np, fill=0.0)),
        grating_mlp=f32(_p(gr_np, fill=0.0)),
        grating_g0=f32(_p(g0_np, fill=0.0)),
        metal_n=f32(_p(mn_np, fill=0.0)),
        metal_k=f32(_p(mk_np, fill=0.0)),
        coat_ior=f32(_p(cior_np, fill=0.0)),
        coat_thickness=f32(_p(cth_np, fill=0.0)),
        bire_ne=f32(_p(bire_np, fill=0.0)),
        scat_mu=f32(_p(smu_np, fill=0.0)),
        scat_g=f32(_p(sg_np, fill=0.0)),
        rough_sigma=f32(_p(rsig_np, fill=0.0)),
        rough_g=f32(_p(rg_np, fill=0.0)),
        element_id=i32(_p(elem_np, fill=-1)),
    )
    if quad_objs:
        for f in ("quad_abgd", "quad_rlim", "quad_zlim", "quad_vertex",
                  "quad_frame"):
            cols[f] = f32(np.stack([getattr(o, f) for _, o in quad_objs]))
        cols["quad_tri"] = i32(quad_tri_np)
    # per-element fluorescence tables (indexed by a ray's medium id, not
    # by triangle: spatial_sort does not touch them)
    if any(float(getattr(o, "fluorescence", 0.0)) > 0.0 for o in objects):
        E = len(objects)
        knot_rows = [o.emission_knots() if getattr(o, "fluorescence", 0.0) > 0
                     else np.zeros((0,)) for o in objects]
        K = max(len(r) for r in knot_rows)
        icdf = np.zeros((E, K), np.float64)
        for i, r in enumerate(knot_rows):
            if len(r):
                icdf[i] = np.interp(np.linspace(0, 1, K),
                                    np.linspace(0, 1, len(r)), r)
        cols.update(
            fluor_mu=f32([float(getattr(o, "fluorescence", 0.0))
                          for o in objects]),
            fluor_qy=f32([float(getattr(o, "fluor_yield", 1.0))
                          for o in objects]),
            fluor_edge=f32([o.fluor_edge_um() if hasattr(o, "fluor_edge_um")
                            else 0.0 for o in objects]),
            fluor_icdf=f32(icdf),
        )
    if any(float(getattr(o, "grin_a", 0.0)) != 0.0 for o in objects):
        E = len(objects)
        ga = np.zeros((E,)); gn = np.ones((E,))
        gc = np.zeros((E, 3)); gx = np.tile([0.0, 0.0, 1.0], (E, 1))
        for i, o in enumerate(objects):
            if float(getattr(o, "grin_a", 0.0)) != 0.0:
                ga[i] = float(o.grin_a)
                gn[i] = float(o.ior)
                gc[i] = np.asarray(o.grin_center, np.float64)
                gx[i] = np.asarray(o.axis, np.float64)
        # compact unit-transform rows of only the GRIN elements' triangles
        eid = _p(elem_np, fill=-1)
        is_grin_tri = np.zeros(eid.shape, bool)
        for i, o in enumerate(objects):
            if float(getattr(o, "grin_a", 0.0)) != 0.0:
                is_grin_tri |= eid == i
        gw = [np.asarray(_p(rows[:, k]), np.float32)[is_grin_tri]
              for k in range(3)]
        pad_g = _round_up(max(len(gw[0]), 1), 128) - len(gw[0])
        if pad_g:
            z = np.zeros((pad_g, 4), np.float32)  # zero rows never hit
            gw = [np.concatenate([a, z]) for a in gw]
        cols.update(grin_a=f32(ga), grin_n0=f32(gn), grin_center=f32(gc),
                    grin_axis=f32(gx), grin_wu=f32(gw[0]), grin_wv=f32(gw[1]),
                    grin_ww=f32(gw[2]))
    return Scene(**cols), detector_names
