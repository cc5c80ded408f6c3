// Epilogue variants of the brute-force ray x triangle nearest hit, for
// Hopper (sm_90a), on the design of csrc/intersect.cu.
//
// Replaces the Pallas kernels of benchmarks/micro_variants.py (make_kernel,
// called at :163 and :173) and benchmarks/epilogue_variants.py (kernel :68,
// called at :120): the same nearest hit as intersect.cu computes, in the
// reference's first, direct formulation, with the epilogue written several
// ways that are timed against each other:
//
//   OU = ox*ux + oy*uy + oz*uz + uw      DU = dx*ux + dy*uy + dz*uz
//   (likewise OV/DV from row v, OW/DW from row w)
//   t = -OW / DW,  u = OU + t*DU,  v = OV + t*DV
//   hit iff t > eps, t < t_max, u >= -eps_b, v >= -eps_b, u + v <= 1 + eps_b
//   nearest hit = the strict minimum of t over the hits, visited in
//   ascending triangle index, so the lowest index wins a tie; (inf, -1)
//   when there is none.
//
// What bounds it on the card: FP32 issue, as intersect.cu. Every pair needs
// intersect.cu's division-free reject test (reject_pair below), 29 flops
// (12 FMAs, 3 multiplies, 2 adds), so at 67 TFLOP/s 524,288 rays x 130,560
// triangles take at least 29.63 ms. The exact lines (39 flops with an IEEE
// divide and its slow-path check, ~55-60 instructions a pair) run only for
// the pairs the test keeps.
//
// The design (intersect.cu's, one templated kernel):
// 1. Each thread forms its rays' moments o x d once; each CTA forms the
//    stage's Plücker records, with the margin M for its rays, once per
//    stage; every pair runs the reject test; the pairs it keeps run the
//    variant's exact lines behind one warp-uniform __any_sync branch a step
//    of kTV triangles (the rows are read there from global memory, L2).
// 2. Register blocking: RPT rays a thread (ray j of thread t is ray
//    block*ray_block + j*R + t % R, R = ray_block / RPT), so one broadcast
//    of a record from shared memory feeds RPT pairs; with RPT > 1 the next
//    step's records are loaded while this one's are tested.
// 3. Stages of NSUB x 32 triangles, double-buffered with cp.async: while
//    stage i is tested, the rows of stage i+1 land, each triangle's rows u,
//    v, w in the first three float4 of the record slot they become; after
//    its tests each thread turns the rows it copied itself into records in
//    place, so one __syncthreads a stage suffices and no row buffer is
//    needed: two record buffers, 2 x NSUB x 32 x 64 B (64 KB at NSUB = 16),
//    in dynamic shared memory, which the entry point opens once per
//    instantiation with cudaFuncSetAttribute. That buffer, not the
//    registers, sets the CTAs an SM holds at NSUB >= 8.
// 4. A ray block of one warp (32 rays at RPT 1, 64 at RPT 2, 128 at RPT 4)
//    would give an SM as many warps as CTAs, and at NSUB = 16 only three
//    CTAs fit its shared memory: three warps, too few to issue from all
//    four schedulers. So such a CTA holds its rays `split` times over, in
//    warp slices that share the stage (4, at most NSUB: one a tile): slice
//    w tests tiles w, w + split, ... of each stage and keeps its own slice
//    of the accumulator, and at the end slice 0 takes the smallest t over
//    the slices, the lowest index on a tie: the same nearest hit. The
//    wrapper picks `split` (ops/intersect_variants.py::stage_split); 1 for
//    a ray block of several warps.
//
// The template parameters keep their meaning on that schedule:
//   DENOM   the variant's own division (its "epilogue"), op for op as the
//           reference kernel: kGuard  |DW| > 1e-30 selects DW or 1,
//           t = -OW / safe, and the guard is one more term of `hit` ("base");
//           kRecip the same with t = -OW * (1 / safe) ("recip"); kIeee no
//           guard: DW == 0 gives +-inf or NaN, which every compare below
//           rejects ("ieee").
//   NOTMAX  drop `t < t_max` from the pair test and filter the ray's
//           nearest hit once at the end: the minimum over hits is monotone,
//           so the result is the same ("notmax").
//   MIN2    (u >= -e) & (v >= -e) becomes fminf(u, v) >= -e ("min2").
//   NSUB    triangles a pipeline stage, NSUB x 32 (32 to 512): the barrier,
//           the copy and the transform are paid once a stage ("2tile", ...).
//   REG     where the running best lives: in registers, merged into the
//           slice's accumulator (shared memory, as the reference's VMEM
//           output block) once a stage; without it, the exact branch's best
//           of each 32-triangle tile is merged into the accumulator after
//           every tile, which is read and written there (volatile, so the
//           cost is real).
//   RPT     rays a thread, chosen by the wrapper from `ray_block` (the rays
//           of a CTA, any multiple of 32 in [32, 1024], the reference's
//           `rb`): 4 where it divides by 128, else 2 where it divides by
//           64, else 1; each variant is instantiated for the three.
// Every variant returns the same (t, tri) as its plain torch version
// (ops/intersect_variants.py::nearest_hit_variant_torch), bit for bit, and
// but for `recip` the same as intersect.cu.
//
// The margin, for these exact lines. intersect.cu's header ("The margin",
// steps (a) to (f)) proves that no pair its exact lines accept is skipped,
// for q = OW / DW, u = OU - q*DU, v = OV - q*DV, hit iff q < -eps,
// u >= -e_b, v >= -e_b, u + v <= 1 + e_b. Here:
// - ieee: t = -OW / DW is -q bit for bit (negation is exact and IEEE
//   division rounds symmetrically), so t*DU = -(q*DU) exactly and
//   OU + t*DU == OU - q*DU bit for bit; t > eps is q < -eps. The same hits.
//   A hit has t finite: an infinite t makes u or v infinite or NaN, and the
//   compares reject it.
// - guard: one more condition of `hit`; where it holds, t is ieee's. It
//   only removes hits.
// - notmax: the skip decision does not read t_max, so no pair that the
//   test without `t < t_max` accepts is skipped; the filter moves.
// - min2: fminf(u, v) >= -e_b is the two compares when neither is NaN. With
//   one NaN, fminf returns the other, but u + v is NaN and its compare
//   rejects the pair. The same hits.
// - recip: t = -OW * rcp(DW) rounds twice, so q' = OW/DW (1 + e1)(1 + e1')
//   takes the place of q. Step (c)'s |u*DW - U'e| <= 3uS becomes 4uS, the
//   bound on s*W'e grows from 6uS to 8uS, and step (d)'s worst gap from
//   20uS to 21uS (U', V') and from 43uS to 45uS (W'), still inside
//   delta = 2^-16 = 256u: M is unchanged.
// tests/test_torch_intersect_variants_reject.py mirrors each variant's exact
// lines against the test and the schedule against the plain version.
//
// Built as intersect.cu is: sm_90a, no fast math and -fmad=false, so each *
// and + in the exact lines is a separately rounded IEEE operation in the
// order written and the division is IEEE; __fmaf_rn appears only in the
// reject test and the records and moments it reads, which decide only
// whether a pair is skipped.

#include "nearest_hit_common.cuh"

constexpr int kTile = 32;      // triangles a tile (NSUB tiles a stage)
constexpr int kTV = 2;         // triangles tested between two votes
constexpr int kMaxWarps = 32;  // 1024 threads
enum Denom { kGuard = 0, kRecip = 1, kIeee = 2 };

// intersect.cu's lines, as functions:
// the ray's moment o x d into (lx, ly, lz). A ray with a component beyond
// kRange gets a NaN moment, so that every fused value of the ray is NaN and
// none of its pairs is skipped; returns whether it is in range.
__device__ __forceinline__ bool ray_moment(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float& lx, float& ly, float& lz) {
  const bool in_range = (fabsf(ox) <= kRange) & (fabsf(oy) <= kRange) &
                        (fabsf(oz) <= kRange) & (fabsf(dx) <= kRange) &
                        (fabsf(dy) <= kRange) & (fabsf(dz) <= kRange);
  lx = in_range ? cross_term(oy, dz, oz, dy) : CUDART_NAN_F;
  ly = in_range ? cross_term(oz, dx, ox, dz) : CUDART_NAN_F;
  lz = in_range ? cross_term(ox, dy, oy, dx) : CUDART_NAN_F;
  return in_range;
}

// intersect.cu's reject test of one pair: true when the pair may be
// skipped, i.e. the fused U', V', W' = DW - U' - V' straddle the record's
// margin (min < -M and max > M). It decides only whether the exact lines
// run.
__device__ __forceinline__ bool reject_pair(const Record& r, float lx,
                                            float ly, float lz, float dx,
                                            float dy, float dz) {
  const float U = __fmaf_rn(r.r0.x, lx, __fmaf_rn(r.r0.y, ly,
                  __fmaf_rn(r.r0.z, lz, __fmaf_rn(r.r0.w, dx,
                  __fmaf_rn(r.r1.x, dy, r.r1.y * dz)))));
  const float V = __fmaf_rn(r.r1.z, lx, __fmaf_rn(r.r1.w, ly,
                  __fmaf_rn(r.r2.x, lz, __fmaf_rn(r.r2.y, dx,
                  __fmaf_rn(r.r2.z, dy, r.r2.w * dz)))));
  const float DW = __fmaf_rn(r.r3.x, dx,
                   __fmaf_rn(r.r3.y, dy, r.r3.z * dz));
  const float W = (DW - U) - V;
  const float lo = fminf(U, fminf(V, W));
  const float hi = fmaxf(U, fmaxf(V, W));
  return (lo < -r.r3.w) & (hi > r.r3.w);
}

// A CTA's dynamic shared memory: two record buffers of a stage, the warps'
// ray scales, and the accumulator, (t, tri) of each of its rays in each of
// its `split` warp slices
constexpr int variant_smem_bytes(int n_sub, int ray_block, int split) {
  return 2 * n_sub * kTile * static_cast<int>(sizeof(Record)) +
         kMaxWarps * static_cast<int>(sizeof(float2)) +
         split * ray_block * 8;
}

// __launch_bounds__: 1024 / RPT threads at most (ray_block 1024 at RPT 4
// and 2, 992 at RPT 1, which caps RPT 1 at 64 registers); RPT 4 asks for
// two such CTAs an SM, which caps it at 128 registers, as intersect.cu's 64
// threads x 8 CTAs
template <int DENOM, bool NOTMAX, bool MIN2, int NSUB, bool REG, int RPT>
__global__ void __launch_bounds__(1024 / RPT, RPT == 4 ? 2 : 1)
variant_kernel(const float* __restrict__ o, const float* __restrict__ d,
               int n_rays, int ray_block, const float4* __restrict__ wu,
               const float4* __restrict__ wv, const float4* __restrict__ ww,
               int n_tris, float eps, float neg_eps_b, float one_eps_b,
               float t_max, float delta, float* __restrict__ t_out,
               int* __restrict__ tri_out) {
  constexpr int kStage = NSUB * kTile;
  constexpr bool kPrefetch = RPT > 1;  // RPT 1 has 64 registers
  static_assert(kTV * RPT <= 32 && kTile % kTV == 0, "one keep mask a step");
  extern __shared__ float4 s_dyn[];
  Record* s_rec = reinterpret_cast<Record*>(s_dyn);  // [2][kStage]
  float2* s_ray_scale = reinterpret_cast<float2*>(s_rec + 2 * kStage);
  // the threads that hold the CTA's rays, `split` times over: slice w
  // tests tiles w, w + split, ... of each stage (warp-uniform)
  const int ray_threads = ray_block / RPT;
  const int split = blockDim.x / ray_threads;
  const int lane = threadIdx.x % ray_threads;
  const int slice = threadIdx.x / ray_threads;
  volatile float* s_bt =
      reinterpret_cast<volatile float*>(s_ray_scale + kMaxWarps);
  volatile int* s_bi =
      reinterpret_cast<volatile int*>(s_bt + split * ray_block);
  volatile float* my_bt = s_bt + slice * ray_block;  // this slice's
  volatile int* my_bi = s_bi + slice * ray_block;

  // the thread's rays. Padding rays past n_rays get o = 0, d = (0, 0, 1):
  // a zero moment, which only widens the CTA's m_o, m_d
  const int ray0 = blockIdx.x * ray_block + lane;
  float dx[RPT], dy[RPT], dz[RPT], lx[RPT], ly[RPT], lz[RPT];
  float best[RPT];  // the best since the last merge into the accumulator
  int best_i[RPT];
  float mo_max = 0.f, md_max = 0.f;  // over the thread's in-range rays
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int ray = ray0 + j * ray_threads;
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
    if (ray_moment(ox, oy, oz, dx[j], dy[j], dz[j], lx[j], ly[j], lz[j])) {
      mo_max = fmaxf(mo_max, fmaxf(fabsf(ox), fmaxf(fabsf(oy), fabsf(oz))));
      md_max = fmaxf(md_max,
                     fmaxf(fabsf(dx[j]), fmaxf(fabsf(dy[j]), fabsf(dz[j]))));
    }
    best[j] = CUDART_INF_F;
    best_i[j] = -1;
    // each thread touches only its own accumulator slots until the end
    my_bt[j * ray_threads + lane] = CUDART_INF_F;
    my_bi[j * ray_threads + lane] = -1;
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
  const int n_stages = (n_tris + kStage - 1) / kStage;

  // copy stage si's rows into record buffer `buf` (cp.async, no wait):
  // triangle k's rows u, v, w into r0, r1, r2 of record k. Thread t copies
  // triangles t, t + blockDim.x, ..., and later transforms the same ones
  auto stage = [&](int si, int buf) {
    const int base = si * kStage;
    const int n = min(kStage, n_tris - base);
    Record* dst = s_rec + buf * kStage;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      cp_async16(&dst[k].r0, wu + base + k);
      cp_async16(&dst[k].r1, wv + base + k);
      cp_async16(&dst[k].r2, ww + base + k);
    }
    cp_async_commit();
  };
  // the thread's own landed rows of stage si -> their records, in place,
  // each with its margin M for the CTA's rays
  auto transform = [&](int si, int buf) {
    const int n = min(kStage, n_tris - si * kStage);
    Record* rec = s_rec + buf * kStage;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const Record r = rec[k];
      rec[k] = plucker_record(r.r0, r.r1, r.r2, mo_blk, md_blk, delta, eb);
    }
  };
  // the best since the last merge -> this slice of the CTA's accumulator
  // (strict: the earlier triangles keep a tie)
  auto merge = [&]() {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int s = j * ray_threads + lane;
      if (best[j] < my_bt[s]) {
        my_bt[s] = best[j];
        my_bi[s] = best_i[j];
      }
      best[j] = CUDART_INF_F;
    }
  };

  stage(0, 0);
  cp_async_wait_all();
  __syncthreads();  // publishes each warp's ray scales
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
    mo_blk = fmaxf(mo_blk, s_ray_scale[w].x);
    md_blk = fmaxf(md_blk, s_ray_scale[w].y);
  }
  transform(0, 0);

  int buf = 0;
  for (int si = 0; si < n_stages; ++si) {
    __syncthreads();  // stage si's records are written, and everyone is
                      // done with the other buffer (stage si - 1)
    const bool more = si + 1 < n_stages;
    if (more) stage(si + 1, buf ^ 1);  // lands while this stage is tested

    const int base = si * kStage;
    const int n = min(kStage, n_tris - base);
    const Record* __restrict__ rec = s_rec + buf * kStage;
#pragma unroll 1
    for (int t0 = slice * kTile; t0 < n; t0 += split * kTile) {
      const int end = min(t0 + kTile, n);  // this tile's triangles
      Record cur[kTV];
      if constexpr (kPrefetch) {
#pragma unroll
        for (int t = 0; t < kTV; ++t) cur[t] = rec[t0 + t];
      }
#pragma unroll 1
      for (int k = t0; k < end; k += kTV) {
        Record nxt[kTV];
        if constexpr (kPrefetch) {
          const int kn = min(k + kTV, t0 + kTile - kTV);
#pragma unroll
          for (int t = 0; t < kTV; ++t) nxt[t] = rec[kn + t];
        } else {
#pragma unroll
          for (int t = 0; t < kTV; ++t) cur[t] = rec[k + t];
        }
        // bit t*RPT + j: (triangle k + t, ray j) runs the exact lines
        unsigned int keep = 0u;
#pragma unroll
        for (int t = 0; t < kTV; ++t) {
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const bool skip = reject_pair(cur[t], lx[j], ly[j], lz[j],
                                          dx[j], dy[j], dz[j]);
            keep |= skip ? 0u : (1u << (t * RPT + j));
          }
        }
        const int nv = min(kTV, end - k);  // triangles of this step
        if (nv < kTV) keep &= (1u << (nv * RPT)) - 1u;
        // rare: a warp-uniform branch, so the exact lines (and their
        // divide) are issued only when some lane of the warp needs them
        if (__any_sync(0xffffffffu, keep != 0u)) {
#pragma unroll
          for (int t = 0; t < kTV; ++t) {
            if (t >= nv) break;
            const int tri = base + k + t;
            const float4 a = __ldg(wu + tri);
            const float4 b = __ldg(wv + tri);
            const float4 c = __ldg(ww + tri);
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
              if (keep & (1u << (t * RPT + j))) {
                const int ray = ray0 + j * ray_threads;
                const float ox = ray < n_rays ? o[3 * ray + 0] : 0.f;
                const float oy = ray < n_rays ? o[3 * ray + 1] : 0.f;
                const float oz = ray < n_rays ? o[3 * ray + 2] : 0.f;
                // the variant's exact lines, unchanged (-fmad=false keeps
                // them unfused)
                const float OU = ox * a.x + oy * a.y + oz * a.z + a.w;
                const float DU = dx[j] * a.x + dy[j] * a.y + dz[j] * a.z;
                const float OV = ox * b.x + oy * b.y + oz * b.z + b.w;
                const float DV = dx[j] * b.x + dy[j] * b.y + dz[j] * b.z;
                const float OW = ox * c.x + oy * c.y + oz * c.z + c.w;
                const float DW = dx[j] * c.x + dy[j] * c.y + dz[j] * c.z;
                float tt;
                bool hit = true;
                if (DENOM == kIeee) {
                  tt = -OW / DW;
                } else {
                  hit = fabsf(DW) > 1e-30f;
                  const float safe = hit ? DW : 1.f;
                  tt = DENOM == kRecip ? -OW * __frcp_rn(safe) : -OW / safe;
                }
                const float u = OU + tt * DU;
                const float v = OV + tt * DV;
                hit = hit && (tt > eps);
                if (!NOTMAX) hit = hit && (tt < t_max);
                if (MIN2) {
                  hit = hit && (fminf(u, v) >= neg_eps_b);
                } else {
                  hit = hit && (u >= neg_eps_b) && (v >= neg_eps_b);
                }
                hit = hit && (u + v <= one_eps_b);
                if (hit && tt < best[j]) {  // strict: the first index
                  best[j] = tt;             // keeps a tie
                  best_i[j] = tri;
                }
              }
            }
          }
        }
        if constexpr (kPrefetch) {
#pragma unroll
          for (int t = 0; t < kTV; ++t) cur[t] = nxt[t];
        }
      }
      if (!REG) merge();
    }
    if (REG) merge();
    if (more) {
      cp_async_wait_all();  // this thread's copies of stage si + 1
      transform(si + 1, buf ^ 1);
    }
    buf ^= 1;
  }

  __syncthreads();  // every slice of the accumulator is final
  if (slice == 0) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int ray = ray0 + j * ray_threads;
      if (ray < n_rays) {
        const int s = j * ray_threads + lane;
        float bt = s_bt[s];
        int bi = s_bi[s];
        for (int w = 1; w < split; ++w) {  // the lowest index wins a tie
          const float t = s_bt[w * ray_block + s];
          const int i = s_bi[w * ray_block + s];
          if (t < bt || (t == bt && i < bi)) {
            bt = t;
            bi = i;
          }
        }
        if (NOTMAX && !(bt < t_max)) {  // the filter moved out of the test
          bt = CUDART_INF_F;
          bi = -1;
        }
        t_out[ray] = bt;
        tri_out[ray] = bi;
      }
    }
  }
}

typedef void (*VariantKernel)(const float*, const float*, int, int,
                              const float4*, const float4*, const float4*,
                              int, float, float, float, float, float, float*,
                              int*);

struct Variant {
  int denom, notmax, min2, n_sub, reg, rpt;
  VariantKernel kernel;
  unsigned int opened;  // devices whose dynamic shared memory is opened
};

#define LPCL_VARIANT_RPT(D, NM, M2, NS, RG, R) \
  { D, NM, M2, NS, RG, R, variant_kernel<D, NM, M2, NS, RG, R>, 0u }
#define LPCL_VARIANT(D, NM, M2, NS, RG)        \
  LPCL_VARIANT_RPT(D, NM, M2, NS, RG, 4),      \
      LPCL_VARIANT_RPT(D, NM, M2, NS, RG, 2),  \
      LPCL_VARIANT_RPT(D, NM, M2, NS, RG, 1)

// the variants the two reference scripts time, each at 4, 2 and 1 rays a
// thread
static Variant kVariants[] = {
    LPCL_VARIANT(kGuard, false, false, 1, false),  // base
    LPCL_VARIANT(kRecip, false, false, 1, false),  // recip
    LPCL_VARIANT(kIeee, false, false, 1, false),   // ieee
    LPCL_VARIANT(kGuard, false, false, 2, false),  // 2tile
    LPCL_VARIANT(kIeee, false, false, 2, false),   // 2t_ieee
    LPCL_VARIANT(kIeee, false, false, 4, false),   // 4t_ieee
    LPCL_VARIANT(kIeee, false, false, 8, false),   // 8t_ieee
    LPCL_VARIANT(kIeee, false, false, 4, true),    // 4t_reg
    LPCL_VARIANT(kIeee, false, false, 8, true),    // 8t_reg
    LPCL_VARIANT(kIeee, false, false, 16, false),  // the tuned base
    LPCL_VARIANT(kIeee, true, false, 16, false),   // notmax
    LPCL_VARIANT(kIeee, false, true, 16, false),   // min2
    LPCL_VARIANT(kIeee, true, true, 16, false),    // min2_notmax
};

// The instantiation with these parameters, its dynamic shared memory opened
// on the current device to the most any ray_block needs (once a device);
// null with *err set when there is none or the attribute call fails.
static Variant* find_variant(int denom, int notmax, int min2, int n_sub,
                             int reg, int rpt, cudaError_t* err) {
  *err = cudaErrorInvalidValue;
  for (Variant& v : kVariants) {
    if (v.denom != denom || v.notmax != notmax || v.min2 != min2 ||
        v.n_sub != n_sub || v.reg != reg || v.rpt != rpt) {
      continue;
    }
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err != cudaSuccess) return nullptr;
    const unsigned int bit = 1u << (dev & 31);
    if (!(v.opened & bit)) {
      *err = cudaFuncSetAttribute(v.kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  variant_smem_bytes(n_sub, 1024, 1));
      if (*err != cudaSuccess) return nullptr;
      v.opened |= bit;
    }
    return &v;
  }
  return nullptr;
}

// ray_block rays a CTA at rpt rays a thread, its stage tiles shared by
// `split` slices of ray_block / rpt threads: whole warps, at most the
// kernel's 1024 / rpt threads
static bool valid_block(int ray_block, int rpt, int split) {
  return ray_block >= 32 && ray_block <= 1024 &&
         (rpt == 1 || rpt == 2 || rpt == 4) && ray_block % (32 * rpt) == 0 &&
         split >= 1 && ray_block / rpt * split <= 1024 / rpt;
}

// Plain C entry point (bound with ctypes). Launches the instantiation with
// these parameters on `stream`: ray_block rays a CTA, rays_per_thread of
// them a thread, its stage tiles shared by `split` slices, so
// ray_block / rays_per_thread * split threads, and smem_bytes (which must
// be variant_smem_bytes(n_sub, ray_block, split)) of dynamic shared memory;
// `delta` is the reject margin (ops/intersect.py::REJECT_DELTA). Does not
// synchronise. Returns the error of the shared-memory attribute call, else
// cudaGetLastError(); cudaErrorInvalidValue when no such instantiation
// exists or a size is out of range.
extern "C" int lpcl_nearest_hit_variant(
    const float* o, const float* d, int n_rays, const float* wu,
    const float* wv, const float* ww, int n_tris, int denom, int notmax,
    int min2, int n_sub, int reg, int ray_block, int rays_per_thread,
    int split, int smem_bytes, float eps, float neg_eps_b, float one_eps_b,
    float t_max, float delta, float* t_out, int* tri_out, void* stream) {
  if (n_rays <= 0 || n_tris <= 0 ||
      !valid_block(ray_block, rays_per_thread, split) ||
      smem_bytes != variant_smem_bytes(n_sub, ray_block, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const Variant* v =
      find_variant(denom, notmax, min2, n_sub, reg, rays_per_thread, &err);
  if (v == nullptr) return static_cast<int>(err);
  const int n_blocks = (n_rays + ray_block - 1) / ray_block;
  v->kernel<<<n_blocks, ray_block / rays_per_thread * split, smem_bytes,
              static_cast<cudaStream_t>(stream)>>>(
      o, d, n_rays, ray_block, reinterpret_cast<const float4*>(wu),
      reinterpret_cast<const float4*>(wv),
      reinterpret_cast<const float4*>(ww), n_tris, eps, neg_eps_b, one_eps_b,
      t_max, delta, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation's resources at `ray_block` and `split`, for the record
// (chip_smoke.py): registers per thread, static shared memory, local
// (spill) bytes per thread, threads per CTA, dynamic shared memory per CTA
// and resident CTAs per SM. Returns the first CUDA error, else 0.
extern "C" int lpcl_nearest_hit_variant_resources(
    int denom, int notmax, int min2, int n_sub, int reg, int ray_block,
    int rays_per_thread, int split, int* regs, int* static_smem_bytes,
    int* local_bytes, int* threads, int* dyn_smem_bytes, int* ctas_per_sm) {
  if (!valid_block(ray_block, rays_per_thread, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const Variant* v =
      find_variant(denom, notmax, min2, n_sub, reg, rays_per_thread, &err);
  if (v == nullptr) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, v->kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = ray_block / rays_per_thread * split;
  *dyn_smem_bytes = variant_smem_bytes(n_sub, ray_block, split);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, v->kernel, *threads, *dyn_smem_bytes);
  return static_cast<int>(err);
}
