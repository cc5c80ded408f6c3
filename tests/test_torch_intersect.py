"""The port's nearest-hit (lightpycl_tpu_torch/ops/intersect.py) against the
JAX package's: the plain torch version vs step.intersect_jnp and the Pallas
kernel in interpret mode, the cull mask vs the reference `_cull_mask`, and
the CUDA kernel's build contract. The kernel itself runs only on the card
(tests marked `cuda`, and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightpycl_tpu as L
import lightpycl_tpu_torch as P
from lightpycl_tpu.ops.intersect_pallas import (_cull_mask, intersect_pallas,
                                                pack_aabbs)
from lightpycl_tpu.tracer.step import intersect_jnp
from lightpycl_tpu_torch.ops import _build
from lightpycl_tpu_torch.ops import intersect as PI
from lightpycl_tpu_torch.tracer.scene import Scene as PortScene

torch.set_num_threads(1)
CPU = torch.device("cpu")
REF_CFG = L.TraceConfig()
CFG = P.TraceConfig()


def random_rays(rng, n, span=1.5):
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def intersect_scene():
    """The tests/test_intersect.py scene, built by the reference and copied
    bit for bit into the port."""
    oe = L.optical_elements(16, 6)
    els = [
        oe.parabolic_mirror(0.5, 2.0),
        oe.hemisphere(4.0),
        oe.cube(0.4, center=(0.6, 0.1, 0.8), material="refractive", ior=1.5),
        oe.biconvex_lens(1.0, 0.8, 0.2, center=(-0.5, 0, 1.0)),
    ]
    rs, _ = L.build_scene(els)
    return rs, PortScene.from_reference(rs, CPU)


def port_hit(ps, o, d, cfg=CFG):
    t, i = PI.intersect(ps, torch.from_numpy(o), torch.from_numpy(d), cfg)
    return t.numpy(), i.numpy()


@pytest.mark.parametrize("n", [300, 77])
@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
def test_plain_matches_reference(rng, n, ref):
    rs, ps = intersect_scene()
    o, d = random_rays(rng, n)
    if ref == "jnp":
        t1, i1 = map(np.asarray, intersect_jnp(rs, jnp.asarray(o),
                                               jnp.asarray(d), REF_CFG))
    else:
        t1, i1 = map(np.asarray, intersect_pallas(
            rs, jnp.asarray(o), jnp.asarray(d), REF_CFG, ray_block=128,
            tri_tile=256, interpret=True))
    t2, i2 = port_hit(ps, o, d)
    assert (i1 == i2).all()
    assert np.array_equal(np.isfinite(t1), np.isfinite(t2))
    both = np.isfinite(t1)
    assert np.allclose(t1[both], t2[both], atol=1e-5)
    assert t2.dtype == np.float32 and i2.dtype == np.int32


def test_chunking_does_not_change_bits(rng):
    _, ps = intersect_scene()
    o, d = (torch.from_numpy(a) for a in random_rays(rng, 300))
    args = (ps.wu, ps.wv, ps.ww, 1e-4, 1e-6, 1e3)
    t0, i0 = PI.nearest_hit_torch(o, d, *args)
    t1, i1 = PI.nearest_hit_torch(o, d, *args, ray_block=7, tri_chunk=33)
    assert torch.equal(i0, i1) and torch.equal(t0, t1)


class TestSingleTriangle:
    def setup_method(self):
        tri = P.GeoObject(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
                          np.array([[0, 1, 2]]))
        self.scene, _ = P.build_scene([tri], device=CPU)

    def _hit(self, o, d, cfg=CFG):
        t, i = port_hit(self.scene, np.asarray([o], np.float32),
                        np.asarray([d], np.float32), cfg)
        return float(t[0]), int(i[0])

    def test_direct_hit(self):
        t, i = self._hit([0.2, 0.2, 1.0], [0, 0, -1])
        assert i == 0 and t == pytest.approx(1.0, abs=1e-6)

    def test_miss_outside(self):
        t, i = self._hit([0.9, 0.9, 1.0], [0, 0, -1])
        assert i == -1 and np.isinf(t) and t > 0

    def test_parallel_miss(self):
        assert self._hit([0.2, 0.2, 1.0], [1, 0, 0])[1] == -1

    def test_behind_miss(self):
        assert self._hit([0.2, 0.2, -1.0], [0, 0, -1])[1] == -1

    def test_eps_guard_self_hit(self):
        assert self._hit([0.2, 0.2, 0.0], [0, 0, -1])[1] == -1

    def test_beyond_max_len(self):
        t, i = self._hit([0.2, 0.2, 1.0], [0, 0, -1],
                         CFG.replace(max_ray_len=0.5))
        assert i == -1 and np.isinf(t)


def test_padding_rows_never_hit(rng):
    # one real triangle, 255 all-zero padding rows; rays through the origin
    # and everywhere else must never report a padding index
    tri = P.GeoObject(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
                      np.array([[0, 1, 2]]))
    scene, _ = P.build_scene([tri], device=CPU)
    assert scene.num_triangles_padded == 256
    o, d = random_rays(rng, 500, span=0.5)
    t, i = port_hit(scene, o, d)
    assert set(np.unique(i)) <= {-1, 0}
    assert np.isinf(t[i == -1]).all()


def test_coincident_triangles_lowest_index():
    # two identical rectangles (4 coincident pairs): every hit reports the
    # first copy, also when the tie spans two chunks of the plain version
    a = P.optical_elements(8, 4).rectangle(1, 1, center=(0, 0, 1))
    b = P.optical_elements(8, 4).rectangle(1, 1, center=(0, 0, 1))
    scene, _ = P.build_scene([a, b], device=CPU)
    o = torch.tensor([[0.1, 0.2, 0.0], [-0.3, 0.1, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    for chunk in (1, 2, 256):
        t, i = PI.nearest_hit_torch(o, d, scene.wu, scene.wv, scene.ww,
                                    1e-4, 1e-6, 1e3, tri_chunk=chunk)
        assert (i < a.num_triangles).all() and (i >= 0).all()
        assert torch.allclose(t, torch.ones(2))


def cull_scene():
    fine = L.optical_elements(64, 32)
    els = [fine.sphere(5.0, material="measure"),
           L.optical_elements(32, 12).parabolic_mirror(0.5, 2.0)]
    rs, _ = L.build_scene(els, spatial_sort=True)
    return rs, PortScene.from_reference(rs, CPU)


def bundle(rng, n, off=(2.0, 2.0)):
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = off[0] + rng.uniform(-0.3, 0.3, n)
    o[:, 1] = off[1] + rng.uniform(-0.3, 0.3, n)
    o[:, 2] = -10.0
    d = np.tile([0, 0, 1.0], (n, 1)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("R,K", [(128, 256), (PI.RAY_BLOCK, PI.TRI_TILE)])
def test_cull_mask_matches_reference(rng, R, K):
    rs, ps = cull_scene()
    o, d = bundle(rng, 2 * R)
    o[:R // 2] = rng.uniform(-6, 6, (R // 2, 3))  # one incoherent half-block
    alive = np.ones(2 * R, bool)
    alive[-R // 4:] = False
    o4 = np.concatenate([o, np.ones((2 * R, 1), np.float32)], axis=1)
    d4 = np.concatenate([d, np.zeros((2 * R, 1), np.float32)], axis=1)
    lo, hi = pack_aabbs(rs, K)
    ref_mask = jax.jit(_cull_mask, static_argnames=("R", "t_max"))
    ref = np.asarray(ref_mask(jnp.asarray(o4), jnp.asarray(d4), lo, hi,
                              R=R, t_max=1e3, alive=jnp.asarray(alive)))
    plo, phi = PI.pack_aabbs(ps, K)
    assert np.array_equal(np.asarray(lo), plo.numpy())
    assert np.array_equal(np.asarray(hi), phi.numpy())
    port = PI.cull_mask(torch.from_numpy(o), torch.from_numpy(d), plo, phi,
                        R, 1e3, alive=torch.from_numpy(alive)).numpy()
    assert port.dtype == np.int32
    assert np.array_equal(ref, port)
    assert 0 < port.mean() < 1


def test_mask_bit_packing_layout():
    m = torch.zeros((2, 40), dtype=torch.int32)
    m[0, 0] = m[0, 31] = m[0, 33] = m[1, 39] = 1
    words = PI.pack_mask_bits(m).numpy().view(np.uint32)
    assert words.tolist() == [1 | (1 << 31), 1 << 1, 0, 1 << 7]


@pytest.mark.parametrize("kind", ["bundle", "random"])
def test_culled_equals_brute(rng, kind):
    _, ps = cull_scene()
    if kind == "bundle":
        o, d = bundle(rng, 600)
    else:
        o, d = random_rays(rng, 600, span=6.0)
    t0, i0 = port_hit(ps, o, d, CFG.replace(cull=False))
    t1, i1 = port_hit(ps, o, d, CFG.replace(cull=True))
    assert np.array_equal(i0, i1)
    assert np.array_equal(t0, t1)
    if kind == "bundle":
        assert (i0 >= 0).any()


def test_cull_mask_skips_tiles_for_coherent_bundle(rng):
    _, ps = cull_scene()
    o, d = bundle(rng, 2 * PI.RAY_BLOCK)
    lo, hi = PI.pack_aabbs(ps)
    m = PI.cull_mask(torch.from_numpy(o), torch.from_numpy(d), lo, hi,
                     PI.RAY_BLOCK, 1e3)
    assert m.shape == (2, -(-ps.num_triangles_padded // PI.TRI_TILE))
    assert m.float().mean() < 1.0


def test_cpu_never_launches_the_kernel(rng):
    _, ps = intersect_scene()
    before = PI.nearest_hit_cuda.launches
    port_hit(ps, *random_rays(rng, 50))
    port_hit(ps, *random_rays(rng, 50), CFG.replace(cull=True))
    assert PI.nearest_hit_cuda.launches == before


def test_cuda_backend_refuses_cpu_tensors(rng):
    _, ps = intersect_scene()
    with pytest.raises(ValueError, match="CUDA"):
        port_hit(ps, *random_rays(rng, 5), CFG.replace(backend="cuda"))
    with pytest.raises(ValueError, match="backend"):
        port_hit(ps, *random_rays(rng, 5), CFG.replace(backend="pallas"))


def test_build_command_flags():
    cmd = _build.build_command("intersect.cu", dict(PI._DEFINES),
                               _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert f"-DLPCL_RAY_BLOCK={PI.RAY_BLOCK}" in cmd
    assert f"-DLPCL_TRI_TILE={PI.TRI_TILE}" in cmd
    # one design: the defines carry only the block shape the cull mask is
    # laid out for; the kernel's other shape constants are compiled in
    assert sorted(k for k, _ in PI._DEFINES) == ["LPCL_RAY_BLOCK",
                                                 "LPCL_TRI_TILE"]
    assert sum(c.startswith("-D") for c in cmd) == 2
    # the kernel's static checks: whole warps of 4 rays a thread, whole
    # 64-triangle chunks a tile
    assert PI.RAY_BLOCK % (32 * 4) == 0 and PI.TRI_TILE % 64 == 0
    assert PI.REJECT_DELTA == 2.0 ** -16
    assert cmd[-1].endswith("csrc/intersect.cu")
    # the library name follows the source and the flags
    p = _build.library_path("intersect.cu", dict(PI._DEFINES))
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p != _build.library_path("intersect.cu", {"LPCL_TRI_TILE": 512})


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    rs, _ = intersect_scene()
    ps = PortScene.from_reference(rs, "cuda")
    o, d = (torch.from_numpy(a).cuda() for a in random_rays(rng, 3000))
    for cull in (False, True):
        cfg = CFG.replace(cull=cull)
        before = PI.nearest_hit_cuda.launches
        t1, i1 = PI.intersect(ps, o, d, cfg.replace(backend="cuda"))
        assert PI.nearest_hit_cuda.launches == before + 1
        t0, i0 = PI.intersect(ps, o, d, cfg.replace(backend="torch"))
        torch.cuda.synchronize()
        assert torch.equal(i0, i1) and torch.equal(t0, t1)
