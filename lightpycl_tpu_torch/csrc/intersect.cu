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
// Numerics of the reported result: built without --use_fast_math and with
// -fmad=false, so every * and + written in the exact path is a separately
// rounded IEEE operation in the order written and the division is IEEE
// round-to-nearest. The plain torch version
// (ops/intersect.py::nearest_hit_torch) performs the same sequence, so the
// two agree bit for bit. __fmaf_rn appears only in the reject test below,
// whose result decides whether a pair is skipped and never reaches (t, tri).
//
// What bounds it on the card: FP32 issue. Run on every pair (unfused,
// with the divide's reciprocal, Newton steps and slow-path check, one ray
// per thread) the sequence above costs 39 flops and issues ~55-60
// instructions a pair. The reject test below needs 29 flops a pair (12
// FMAs, 3 multiplies, 2 adds; 17 FP32 instructions), so at 67 TFLOP/s
// 524,288 rays x 130,560 triangles take at least ~30 ms; the exact lines
// run only for the few pairs a ray that the test keeps.
//
// The design:
// 1. A division-free reject on every pair, in FMA; the exact lines only
//    for the pairs it keeps. With a, b, c the rows u, v, w, let
//      U' = OU*DW - OW*DU,  V' = OV*DW - OW*DV,  W' = DW - U' - V'
//    (u, v and 1 - u - v scaled by DW). By Lagrange's identity
//      U' = (a x c) . (o x d) + (a_w c - c_w a) . d
//    and likewise V' with b, so with the ray's moment o x d formed once
//    per ray and each triangle's "Plücker record" (a x c, a_w c - c_w a,
//    b x c, b_w c - c_w b, c) formed once per chunk, U' and V' cost six
//    FMAs each and DW three. A hit has U', V', W' all of DW's sign (up to
//    eps_b), so a pair is skipped only when
//      min(U', V', W') < -M  and  max(U', V', W') > M,
//    M a margin per triangle, for the CTA's rays, that bounds the gap
//    between this fused evaluation and the exact one (see "The margin").
//    No sign of DW and no grazing guard are needed: whatever DW's sign, a
//    hit keeps all three values on one side of the margin. The kept pairs
//    run the exact lines unchanged, behind a warp-uniform branch
//    (__any_sync, one vote per two triangles), so they are issued only
//    when some lane needs them; a ray line crosses few triangles, so the
//    branch is rare, and it reads the rows from global memory (L2).
// 2. Register blocking: each thread carries kRPT = 4 rays (ray j of
//    thread t is ray block*RAY_BLOCK + j*threads + t), so one broadcast
//    of a record from shared memory feeds that many independent pairs;
//    the next two records are loaded while two are tested.
// 3. A pipeline over chunks of kChunk = 64 triangles with one
//    __syncthreads per chunk: while chunk i is tested, the rows of chunk
//    i+1 (landed) become its records and the rows of chunk i+2 are copied
//    in with cp.async. Two row and two record buffers in static shared
//    memory (14 KB at the committed shape).
// 4. Cull mode: the mask holds one bit per (RAY_BLOCK rays, TRI_TILE
//    triangles); the pipeline walks only the chunks of kept tiles (a
//    block-uniform choice), so skipped tiles are neither copied nor tested.
//
// The margin. Let u = 2^-24 (f32 unit roundoff); to first order in u.
// Per ray m_o = max|o_i|, m_d = max|d_i|; per row r of a triangle
// L_r = |r_x| + |r_y| + |r_z| and B_r = |r_w|, so Mo_r = m_o*L_r + B_r
// bounds the terms of the row's O-dot and Nd_r = m_d*L_r those of its
// D-dot; with _ab the larger of rows a and b,
//   S = Mo_ab*Nd_c + Mo_c*Nd_ab = m_d*(2*m_o*L_ab*L_c + B_ab*L_c + B_c*L_ab)
// bounds |OU*DW| + |OW*DU| and the terms of the Plücker form of U', and
// likewise for V'.
// a. Fused vs real: o x d, the records' cross terms and a_w c - c_w a are
//    one product and one fma each (2u of their terms), the dot rounds six
//    times: |U'f - U'| <= (6 + 2 + 2)u*S = 10uS; |DWf - DW| <= 3uNd_c;
//    W'f = (DWf - U'f) - V'f rounds twice, by <= 3uS + 2uNd_c, so
//    |W'f - W'| <= 23uS + 5uNd_c.
// b. Exact vs real: the unfused O-dot errs by <= 4uMo_r, the D-dot by
//    <= 3uNd_r, so U'e = OUe*DWe - OWe*DUe is within 7uS of U' (V'e too).
// c. The exact test: a hit has q finite and DWe != 0 (an infinite q makes
//    u or v NaN or infinite, which the compares reject). q = OWe/DWe(1+e1)
//    and u = (OUe - q*DUe(1+e2))(1+e3) give |u*DWe - U'e| <= 3uS. With
//    s = sign(DWe), A = |DWe| <= Nd_c(1+3u), e_b = |-eps_b as f32|:
//      u >= -e_b          gives  s*U'e >= -e_b*A - 3uS,
//      u + v <= 1 + e_b   gives  s*W'e >= -(e_b + 2u)*A - 6uS
//    (u + v rounds once; 1 + eps_b is rounded to f32).
// d. So a hit has s*U'f, s*V'f >= -e_b*A - 20uS and, W'e being within
//    3uNd_c + 14uS of W', s*W'f >= -(e_b + 2u)*A - 43uS - 8uNd_c. Any
//    M >= e_b*(1+3u)*Nd_c + 10u*Nd_c + 43u*S keeps the hit: with s = +1
//    the min is >= -M, with s = -1 the max is <= M.
//    The kernel takes, with m_o and m_d the largest over the CTA's rays
//    (which only widens it), M = m_d*(m_o*alpha + beta) + 2^-60,
//      alpha = delta*2*L_ab*L_c,
//      beta = delta*(B_ab*L_c + B_c*L_ab + L_c) + e_b*(1 + 2^-10)*L_c,
//    once per triangle and chunk, into the record, so M >= delta*S +
//    delta*Nd_c + e_b*(1 + 2^-10)*Nd_c, with delta = 2^-16 = 256u
//    (ops/intersect.py::REJECT_DELTA, passed in as an argument): six times
//    the 43u needed, which covers the O(u^2) terms, the few u by which
//    alpha, beta and M themselves round low, and the double rounding of
//    the float64 emulation of fmaf in tests/test_torch_intersect_reject.py.
// e. Range: a pair may be skipped only when every |o_i| and |d_i| of the
//    ray and every L_r and B_r of the triangle is <= 2^30 (false for NaN).
//    Otherwise the ray's moment is NaN, so all its fused values are NaN,
//    or the triangle's M is +inf; every compare is then false and the pair
//    runs the exact path. In range every fused term is below 2^122, so no
//    fused value overflows or is NaN, and fminf/fmaxf see finite numbers.
//    Underflow adds at most 2^-150 per product; scaled by the factors that
//    follow it stays below 2^-80, inside the 2^-60 term, or (the quotient
//    q) is scaled by Nd_c and stays inside delta*Nd_c.
// f. Padding rows (all zero) give U' = V' = W' = 0 and M = 2^-60, never
//    skipped; the exact path meets DW = 0 and rejects them as before.
// So no pair that the exact path accepts as a hit is ever skipped, and
// the reported (t, tri) are those of the exact sequence, bit for bit.
// tests/test_torch_intersect_reject.py mirrors the test in plain torch.
// The record transform with its margin, the record layout, the constants
// and the cp.async helpers live in nearest_hit_common.cuh, which
// csrc/intersect_variants.cu shares.

#include "nearest_hit_common.cuh"

#ifndef LPCL_RAY_BLOCK
#define LPCL_RAY_BLOCK 256
#endif
#ifndef LPCL_TRI_TILE
#define LPCL_TRI_TILE 256
#endif
constexpr int kRPT = 4;        // rays per thread
constexpr int kChunk = 64;     // triangles per pipeline stage
constexpr int kMinBlocks = 8;  // __launch_bounds__: resident CTAs per SM
constexpr int kThreads = LPCL_RAY_BLOCK / kRPT;
constexpr int kWarps = kThreads / 32;
constexpr int kChunksPerTile = LPCL_TRI_TILE / kChunk;
constexpr int kTV = 2;  // triangles tested between two votes
static_assert(kTV * kRPT <= 32, "one 32-bit keep mask per step");

// two row buffers, two record buffers, the warps' ray scales
constexpr int kSmemBytes =
    2 * kChunk * static_cast<int>(sizeof(Rows) + sizeof(Record)) +
    kWarps * static_cast<int>(sizeof(float2));

static_assert(LPCL_RAY_BLOCK % (32 * kRPT) == 0,
              "RAY_BLOCK must be whole warps of kRPT rays");
static_assert(LPCL_TRI_TILE % kChunk == 0 && kChunk % 32 == 0,
              "TRI_TILE must be whole chunks, a chunk whole warps");
static_assert(kSmemBytes <= 48 * 1024,
              "chunk buffers exceed the static shared-memory limit");

// The first chunk after `c` whose tile the mask keeps (every chunk without
// a mask); n_chunks when none is left. Block-uniform.
__device__ __forceinline__ int next_chunk(int c, int n_chunks,
                                          const unsigned int* mask_row) {
  ++c;
  if (mask_row == nullptr) return min(c, n_chunks);
  while (c < n_chunks) {
    const int tile = c / kChunksPerTile;
    if ((mask_row[tile >> 5] >> (tile & 31)) & 1u) return c;
    c = (tile + 1) * kChunksPerTile;
  }
  return n_chunks;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
nearest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int n_rays,
                   const float4* __restrict__ wu,
                   const float4* __restrict__ wv,
                   const float4* __restrict__ ww, int n_tris,
                   const unsigned int* __restrict__ mask, int n_words,
                   float neg_eps, float neg_eps_b, float one_eps_b,
                   float t_max, float delta, float* __restrict__ t_out,
                   int* __restrict__ tri_out) {
  __shared__ Rows s_rows[2 * kChunk];
  __shared__ Record s_rec[2 * kChunk];
  __shared__ float2 s_ray_scale[kWarps];

  // the thread's rays. Padding rays past n_rays get o = 0, d = (0, 0, 1):
  // a zero moment, which only widens the CTA's m_o, m_d. A ray out of
  // range gets a NaN moment, so that every fused value of the ray is NaN
  // and none of its pairs is skipped
  const int ray0 = blockIdx.x * LPCL_RAY_BLOCK + threadIdx.x;
  float dx[kRPT], dy[kRPT], dz[kRPT], lx[kRPT], ly[kRPT], lz[kRPT];
  float best[kRPT];
  int best_i[kRPT];
  float mo_max = 0.f, md_max = 0.f;  // over the thread's in-range rays
#pragma unroll
  for (int j = 0; j < kRPT; ++j) {
    const int ray = ray0 + j * kThreads;
    float ox = 0.f, oy = 0.f, oz = 0.f;
    dx[j] = dy[j] = 0.f;
    dz[j] = 1.f;
    if (ray < n_rays) {
      ox = o[3 * ray + 0];
      oy = o[3 * ray + 1];
      oz = o[3 * ray + 2];
      dx[j] = d[3 * ray + 0];
      dy[j] = d[3 * ray + 1];
      dz[j] = d[3 * ray + 2];
    }
    const bool in_range = (fabsf(ox) <= kRange) & (fabsf(oy) <= kRange) &
                          (fabsf(oz) <= kRange) & (fabsf(dx[j]) <= kRange) &
                          (fabsf(dy[j]) <= kRange) & (fabsf(dz[j]) <= kRange);
    // the ray's moment o x d
    lx[j] = in_range ? cross_term(oy, dz[j], oz, dy[j]) : CUDART_NAN_F;
    ly[j] = in_range ? cross_term(oz, dx[j], ox, dz[j]) : CUDART_NAN_F;
    lz[j] = in_range ? cross_term(ox, dy[j], oy, dx[j]) : CUDART_NAN_F;
    if (in_range) {
      mo_max = fmaxf(mo_max, fmaxf(fabsf(ox), fmaxf(fabsf(oy), fabsf(oz))));
      md_max = fmaxf(md_max,
                     fmaxf(fabsf(dx[j]), fmaxf(fabsf(dy[j]), fabsf(dz[j]))));
    }
    best[j] = -CUDART_INF_F;
    best_i[j] = -1;
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    mo_max = fmaxf(mo_max, __shfl_xor_sync(0xffffffffu, mo_max, sh));
    md_max = fmaxf(md_max, __shfl_xor_sync(0xffffffffu, md_max, sh));
  }
  if ((threadIdx.x & 31) == 0)
    s_ray_scale[threadIdx.x >> 5] = make_float2(mo_max, md_max);
  const float eb = fabsf(neg_eps_b) * kEbUp;
  float mo_blk = 0.f, md_blk = 0.f;  // the CTA's, after the first barrier

  const unsigned int* mask_row =
      mask == nullptr ? nullptr : mask + blockIdx.x * n_words;
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;

  // copy chunk ci's rows into row buffer `slot` (cp.async, no wait)
  auto stage = [&](int ci, int slot) {
    const int base = ci * kChunk;
    const int n = min(kChunk, n_tris - base);
    Rows* dst = s_rows + slot * kChunk;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      cp_async16(&dst[k].u, wu + base + k);
      cp_async16(&dst[k].v, wv + base + k);
      cp_async16(&dst[k].w, ww + base + k);
    }
    cp_async_commit();
  };
  // chunk ci's landed rows -> its records, each with its margin M for the
  // CTA's rays (see "The margin")
  auto transform = [&](int ci, int slot) {
    const int n = min(kChunk, n_tris - ci * kChunk);
    const Rows* src = s_rows + slot * kChunk;
    Record* dst = s_rec + slot * kChunk;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      dst[k] = plucker_record(src[k].u, src[k].v, src[k].w, mo_blk, md_blk,
                              delta, eb);
    }
  };

  // the walk: chunk c is tested from record buffer `slot` while the next
  // chunk's records go to the other one and the rows of the one after
  // that land in row buffer `slot`
  int c = next_chunk(-1, n_chunks, mask_row);
  int cn = next_chunk(c, n_chunks, mask_row);
  int cl = next_chunk(cn, n_chunks, mask_row);
  if (c < n_chunks) {
    stage(c, 0);
    cp_async_wait_all();
    __syncthreads();  // also publishes each warp's ray scales
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mo_blk = fmaxf(mo_blk, s_ray_scale[w].x);
      md_blk = fmaxf(md_blk, s_ray_scale[w].y);
    }
    if (cn < n_chunks) stage(cn, 1);
    transform(c, 0);
  }
  int slot = 0;
  while (c < n_chunks) {
    cp_async_wait_all();  // this thread's copies of chunk cn have landed
    __syncthreads();      // everyone's have, chunk c's records are written,
                          // and the previous chunk is done with
    if (cl < n_chunks) stage(cl, slot);  // overlaps the work below
    if (cn < n_chunks) transform(cn, slot ^ 1);

    const int base = c * kChunk;
    const int n = min(kChunk, n_tris - base);
    const Record* __restrict__ rec = s_rec + slot * kChunk;
    // kTV triangles a step, one vote a step; the next step's records are
    // loaded while this one's are tested
    Record cur[kTV];
#pragma unroll
    for (int t = 0; t < kTV; ++t) cur[t] = rec[t];
#pragma unroll 1
    for (int k = 0; k < n; k += kTV) {
      Record nxt[kTV];
      const int kn = min(k + kTV, kChunk - kTV);
#pragma unroll
      for (int t = 0; t < kTV; ++t) nxt[t] = rec[kn + t];
      // bit t*kRPT + j: (triangle k + t, ray j) runs the exact path
      unsigned int keep = 0u;
#pragma unroll
      for (int t = 0; t < kTV; ++t) {
        const Record& r = cur[t];
#pragma unroll
        for (int j = 0; j < kRPT; ++j) {
          // fused evaluation: decides only whether the pair is skipped
          const float U = __fmaf_rn(r.r0.x, lx[j], __fmaf_rn(r.r0.y, ly[j],
                          __fmaf_rn(r.r0.z, lz[j], __fmaf_rn(r.r0.w, dx[j],
                          __fmaf_rn(r.r1.x, dy[j], r.r1.y * dz[j])))));
          const float V = __fmaf_rn(r.r1.z, lx[j], __fmaf_rn(r.r1.w, ly[j],
                          __fmaf_rn(r.r2.x, lz[j], __fmaf_rn(r.r2.y, dx[j],
                          __fmaf_rn(r.r2.z, dy[j], r.r2.w * dz[j])))));
          const float DW = __fmaf_rn(r.r3.x, dx[j],
                           __fmaf_rn(r.r3.y, dy[j], r.r3.z * dz[j]));
          const float W = (DW - U) - V;
          const float lo = fminf(U, fminf(V, W));
          const float hi = fmaxf(U, fmaxf(V, W));
          const bool skip = (lo < -r.r3.w) & (hi > r.r3.w);
          keep |= skip ? 0u : (1u << (t * kRPT + j));
        }
      }
      const int nv = min(kTV, n - k);  // triangles of this step in the chunk
      if (nv < kTV) keep &= (1u << (nv * kRPT)) - 1u;
      // rare: a warp-uniform branch, so the exact lines (and their IEEE
      // divide) are issued only when some lane of the warp needs them
      if (__any_sync(0xffffffffu, keep != 0u)) {
#pragma unroll
        for (int t = 0; t < kTV; ++t) {
          if (t >= nv) break;
          const int tri = base + k + t;
          const float4 a = __ldg(wu + tri);
          const float4 b = __ldg(wv + tri);
          const float4 c4 = __ldg(ww + tri);
#pragma unroll
          for (int j = 0; j < kRPT; ++j) {
            if (keep & (1u << (t * kRPT + j))) {
              const int ray = ray0 + j * kThreads;
              const float ox = ray < n_rays ? o[3 * ray + 0] : 0.f;
              const float oy = ray < n_rays ? o[3 * ray + 1] : 0.f;
              const float oz = ray < n_rays ? o[3 * ray + 2] : 0.f;
              // the exact sequence, unchanged (-fmad=false keeps it
              // unfused)
              const float OU = ox * a.x + oy * a.y + oz * a.z + a.w;
              const float OV = ox * b.x + oy * b.y + oz * b.z + b.w;
              const float OW = ox * c4.x + oy * c4.y + oz * c4.z + c4.w;
              const float DU = dx[j] * a.x + dy[j] * a.y + dz[j] * a.z;
              const float DV = dx[j] * b.x + dy[j] * b.y + dz[j] * b.z;
              const float DWe = dx[j] * c4.x + dy[j] * c4.y + dz[j] * c4.z;
              const float q = OW / DWe;
              const float u = OU - q * DU;
              const float v = OV - q * DV;
              const bool hit = (q < neg_eps) && (u >= neg_eps_b) &&
                               (v >= neg_eps_b) && (u + v <= one_eps_b);
              if (hit && q > best[j]) {
                best[j] = q;
                best_i[j] = tri;
              }
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kTV; ++t) cur[t] = nxt[t];
    }
    c = cn;
    cn = cl;
    cl = next_chunk(cl, n_chunks, mask_row);
    slot ^= 1;
  }

#pragma unroll
  for (int j = 0; j < kRPT; ++j) {
    const int ray = ray0 + j * kThreads;
    if (ray < n_rays) {
      const float t = -best[j];
      const bool valid = isfinite(t) && (t < t_max);
      t_out[ray] = valid ? t : CUDART_INF_F;
      tri_out[ray] = valid ? best_i[j] : -1;
    }
  }
}

// Plain C entry point (bound with ctypes). `mask` may be null (brute
// force); otherwise it holds n_words 32-bit words per ray block, bit
// (tile % 32) of word (block * n_words + tile / 32) set when the block may
// reach the tile. ray_block / tri_tile must equal the compiled block shape
// (the caller's mask is laid out for it). `delta` is the reject margin
// (ops/intersect.py::REJECT_DELTA). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int lpcl_nearest_hit(const float* o, const float* d, int n_rays,
                                const float* wu, const float* wv,
                                const float* ww, int n_tris,
                                const int* mask, int n_words, int ray_block,
                                int tri_tile, float neg_eps, float neg_eps_b,
                                float one_eps_b, float t_max, float delta,
                                float* t_out, int* tri_out, void* stream) {
  if (ray_block != LPCL_RAY_BLOCK || tri_tile != LPCL_TRI_TILE ||
      n_rays <= 0 || n_tris <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = (n_rays + LPCL_RAY_BLOCK - 1) / LPCL_RAY_BLOCK;
  nearest_hit_kernel<<<n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, n_rays, reinterpret_cast<const float4*>(wu),
      reinterpret_cast<const float4*>(wv), reinterpret_cast<const float4*>(ww),
      n_tris, reinterpret_cast<const unsigned int*>(mask), n_words, neg_eps,
      neg_eps_b, one_eps_b, t_max, delta, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel's resources, for the record (chip_smoke.py):
// registers per thread, shared memory per CTA, local (spill) bytes per
// thread, threads per CTA and resident CTAs per SM.
// Returns the first CUDA error, else 0.
extern "C" int lpcl_nearest_hit_resources(int* regs, int* smem_bytes,
                                          int* local_bytes, int* threads,
                                          int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, nearest_hit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, nearest_hit_kernel, kThreads, 0);
  return static_cast<int>(err);
}
