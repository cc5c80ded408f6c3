// Ray x triangle nearest hit, hand-written for Hopper (sm_90a).
//
// Replaces lightpycl_tpu/ops/intersect_pallas.py::_kernel / _kernel_body
// (driven there by _intersect_pallas_impl), in both of its modes: brute
// force, and cull, where (ray block x triangle tile) pairs that a
// conservative reachability mask rules out are skipped.
//
// What it computes, per ray, exactly as the TPU kernel's 'qspace' epilogue:
//   OU = ox*ux + oy*uy + oz*uz + uw      DU = dx*ux + dy*uy + dz*uz
//   (likewise OV/DV from row v, OW/DW from row w)
//   q = OW / DW,  u = OU - q*DU,  v = OV - q*DV
//   hit iff q < -eps, u >= -eps_b, v >= -eps_b, u + v <= 1 + eps_b
//   nearest hit = running max of q; t = -q, kept only if finite and
//   t < t_max, else (t, tri) = (inf, -1).
// Triangles are visited in ascending index and the best is replaced only
// on a strict q > best, so the lowest index wins a tie, as in the
// reference. Padding rows (all zero) and DW == 0 give NaN or +-inf, which
// every compare rejects; the barycentric test is written as two separate
// compares, not fminf (fminf(NaN, x) returns x).
//
// Numerics: built without --use_fast_math and with -fmad=false, so every
// * and + is a separately rounded IEEE operation in the order written and
// the division is IEEE round-to-nearest. The plain torch version
// (ops/intersect.py::nearest_hit_torch) performs the same sequence, so the
// two agree bit for bit.
//
// What bounds it on the card: FP32 issue. A (ray, triangle) pair costs
// about 25 flops plus an IEEE divide; the triangle's 48 bytes come from
// shared memory as three broadcast 16-byte loads shared by the whole warp.
// The simple design: one thread per ray, LPCL_RAY_BLOCK rays per CTA, the
// triangle rows staged cooperatively in shared memory one tile of
// LPCL_TRI_TILE triangles at a time (3 x 16 B x 1024 = 48 KB static), the
// running best q and index in registers. In cull mode each CTA reads one
// mask bit per tile and skips the tile's staging and compute together
// (a block-uniform branch). Register blocking over several rays per thread
// and cp.async / TMA streaming of the triangle tiles are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#ifndef LPCL_RAY_BLOCK
#define LPCL_RAY_BLOCK 256
#endif
#ifndef LPCL_TRI_TILE
#define LPCL_TRI_TILE 1024
#endif

static_assert(3 * 16 * LPCL_TRI_TILE <= 48 * 1024,
              "triangle tile exceeds the static shared-memory limit");

__global__ void __launch_bounds__(LPCL_RAY_BLOCK)
nearest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int n_rays,
                   const float4* __restrict__ wu,
                   const float4* __restrict__ wv,
                   const float4* __restrict__ ww, int n_tris,
                   const unsigned int* __restrict__ mask, int n_words,
                   float neg_eps, float neg_eps_b, float one_eps_b,
                   float t_max, float* __restrict__ t_out,
                   int* __restrict__ tri_out) {
  __shared__ float4 s_u[LPCL_TRI_TILE];
  __shared__ float4 s_v[LPCL_TRI_TILE];
  __shared__ float4 s_w[LPCL_TRI_TILE];

  const int ray = blockIdx.x * LPCL_RAY_BLOCK + threadIdx.x;
  const bool live = ray < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (live) {
    ox = o[3 * ray + 0];
    oy = o[3 * ray + 1];
    oz = o[3 * ray + 2];
    dx = d[3 * ray + 0];
    dy = d[3 * ray + 1];
    dz = d[3 * ray + 2];
  }
  float best = -CUDART_INF_F;
  int best_i = -1;

  const int n_tiles = (n_tris + LPCL_TRI_TILE - 1) / LPCL_TRI_TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (mask != nullptr) {
      // same word for the whole CTA: the branch is block-uniform, so the
      // __syncthreads below are reached by all threads or by none
      const unsigned int word = mask[blockIdx.x * n_words + (tile >> 5)];
      if (((word >> (tile & 31)) & 1u) == 0u) continue;
    }
    const int base = tile * LPCL_TRI_TILE;
    const int n = min(LPCL_TRI_TILE, n_tris - base);
    __syncthreads();  // the previous tile's readers are done
    for (int k = threadIdx.x; k < n; k += LPCL_RAY_BLOCK) {
      s_u[k] = wu[base + k];
      s_v[k] = wv[base + k];
      s_w[k] = ww[base + k];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 a = s_u[k];
      const float4 b = s_v[k];
      const float4 c = s_w[k];
      const float OU = ox * a.x + oy * a.y + oz * a.z + a.w;
      const float OV = ox * b.x + oy * b.y + oz * b.z + b.w;
      const float OW = ox * c.x + oy * c.y + oz * c.z + c.w;
      const float DU = dx * a.x + dy * a.y + dz * a.z;
      const float DV = dx * b.x + dy * b.y + dz * b.z;
      const float DW = dx * c.x + dy * c.y + dz * c.z;
      const float q = OW / DW;
      const float u = OU - q * DU;
      const float v = OV - q * DV;
      const bool hit = (q < neg_eps) && (u >= neg_eps_b) &&
                       (v >= neg_eps_b) && (u + v <= one_eps_b);
      if (hit && q > best) {
        best = q;
        best_i = base + k;
      }
    }
  }
  if (live) {
    const float t = -best;
    const bool valid = isfinite(t) && (t < t_max);
    t_out[ray] = valid ? t : CUDART_INF_F;
    tri_out[ray] = valid ? best_i : -1;
  }
}

// Plain C entry point (bound with ctypes). `mask` may be null (brute
// force); otherwise it holds n_words 32-bit words per ray block, bit
// (tile % 32) of word (block * n_words + tile / 32) set when the block may
// reach the tile. ray_block / tri_tile must equal the compiled block shape
// (the caller's mask is laid out for it). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int lpcl_nearest_hit(const float* o, const float* d, int n_rays,
                                const float* wu, const float* wv,
                                const float* ww, int n_tris,
                                const int* mask, int n_words, int ray_block,
                                int tri_tile, float neg_eps, float neg_eps_b,
                                float one_eps_b, float t_max, float* t_out,
                                int* tri_out, void* stream) {
  if (ray_block != LPCL_RAY_BLOCK || tri_tile != LPCL_TRI_TILE ||
      n_rays <= 0 || n_tris <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = (n_rays + LPCL_RAY_BLOCK - 1) / LPCL_RAY_BLOCK;
  nearest_hit_kernel<<<n_blocks, LPCL_RAY_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, n_rays, reinterpret_cast<const float4*>(wu),
      reinterpret_cast<const float4*>(wv), reinterpret_cast<const float4*>(ww),
      n_tris, reinterpret_cast<const unsigned int*>(mask), n_words, neg_eps,
      neg_eps_b, one_eps_b, t_max, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}
