// Epilogue variants of the brute-force ray x triangle nearest hit, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of benchmarks/micro_variants.py (make_kernel,
// called at :163 and :173) and benchmarks/epilogue_variants.py (kernel :68,
// called at :120): the same nearest hit as csrc/intersect.cu computes, in
// the reference's first, direct formulation, with the epilogue written
// several ways that are timed against each other:
//
//   OU = ox*ux + oy*uy + oz*uz + uw      DU = dx*ux + dy*uy + dz*uz
//   (likewise OV/DV from row v, OW/DW from row w)
//   t = -OW / DW,  u = OU + t*DU,  v = OV + t*DV
//   hit iff t > eps, t < t_max, u >= -eps_b, v >= -eps_b, u + v <= 1 + eps_b
//   per tile of kTile triangles: t_tile = min over hits, i_tile = the first
//   index that attains it; the tile's pair replaces the ray's running best
//   only on a strict t_tile < best, so the lowest index wins a tie.
//
// The ways (template parameters):
//   Denom  kGuard  |DW| > 1e-30 selects DW or 1, t = -OW / safe, and the
//                  guard is one more term of `hit`           ("base")
//          kRecip  the same with t = -OW * (1 / safe)        ("recip")
//          kIeee   no guard: DW == 0 gives +-inf or NaN, and every compare
//                  below is then false                       ("ieee")
//   NotMax drop `t < t_max` from the pair test and filter the ray's nearest
//          hit once at the end: the minimum over hits is monotone, so the
//          result is the same                                ("notmax")
//   Min2   (u >= -e) & (v >= -e) becomes min(u, v) >= -e     ("min2")
//   NSub   triangle tiles a step: one step stages NSub tiles into shared
//          memory between two barriers, so the barriers, the copy loop and
//          the step bookkeeping are paid once for NSub tiles ("2tile", ...)
//   Reg    the running best lives in registers over a step's tiles and is
//          merged into the block's accumulator once a step; without it the
//          accumulator (shared memory, as the reference's VMEM output
//          block) is read and written after every tile       ("4t_reg", ...)
// The ray block (threads a CTA, one ray a thread) is a launch parameter,
// as the reference's `rb`.
//
// Every variant returns the same (t, tri) as the guarded base, bit for bit
// (the reference's own claim, checked by the callers). fminf drops a NaN
// operand where the reference's minimum keeps it; with one of u, v NaN the
// sum u + v is NaN and its compare rejects the pair, so Min2 still agrees.
//
// Built as intersect.cu is: no fast math and -fmad=false, so each * and +
// is a separately rounded IEEE operation in the order written and the
// division is IEEE; the plain torch version (ops/intersect_variants.py::
// nearest_hit_variant_torch) runs the same sequence and agrees bit for bit.
// A simple design: one ray a thread, every pair runs the full sequence
// (the reject test and register blocking of intersect.cu are not here;
// these kernels exist to compare epilogues with each other).

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int kTile = 32;  // triangles a tile
enum Denom { kGuard = 0, kRecip = 1, kIeee = 2 };

template <int DENOM, bool NOTMAX, bool MIN2, int NSUB, bool REG>
__global__ void variant_kernel(const float* __restrict__ o,
                               const float* __restrict__ d, int n_rays,
                               const float4* __restrict__ wu,
                               const float4* __restrict__ wv,
                               const float4* __restrict__ ww, int n_tris,
                               float eps, float neg_eps_b, float one_eps_b,
                               float t_max, float* __restrict__ t_out,
                               int* __restrict__ tri_out) {
  // [NSUB tiles][rows u, v, w][kTile] float4, then the block's accumulator
  extern __shared__ float4 s_rows[];
  // (volatile, so that the reads and writes after every tile are really
  // made and the Reg variants have something to save)
  volatile float* s_bt =
      reinterpret_cast<volatile float*>(s_rows + NSUB * 3 * kTile);
  volatile int* s_bi = reinterpret_cast<volatile int*>(s_bt + blockDim.x);

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (ray < n_rays) {
    ox = o[3 * ray + 0];
    oy = o[3 * ray + 1];
    oz = o[3 * ray + 2];
    dx = d[3 * ray + 0];
    dy = d[3 * ray + 1];
    dz = d[3 * ray + 2];
  }
  // each thread touches only its own accumulator slot: no barrier needed
  s_bt[threadIdx.x] = CUDART_INF_F;
  s_bi[threadIdx.x] = -1;

  constexpr int kStep = NSUB * kTile;
  const int n_steps = (n_tris + kStep - 1) / kStep;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int step = 0; step < n_steps; ++step) {
    __syncthreads();  // the previous step's tiles are done with
    for (int k = threadIdx.x; k < kStep; k += blockDim.x) {
      const int tri = step * kStep + k;
      const bool real = tri < n_tris;  // padding rows are all zero
      float4* dst = s_rows + (k / kTile) * 3 * kTile + (k % kTile);
      dst[0] = real ? wu[tri] : zero;
      dst[kTile] = real ? wv[tri] : zero;
      dst[2 * kTile] = real ? ww[tri] : zero;
    }
    __syncthreads();

    float t_run = CUDART_INF_F;
    int i_run = -1;
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
      const float4* __restrict__ rows = s_rows + s * 3 * kTile;
      float t_tile = CUDART_INF_F;
      int i_tile = 0;
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        const float4 a = rows[k], b = rows[kTile + k], c = rows[2 * kTile + k];
        const float OU = ox * a.x + oy * a.y + oz * a.z + a.w;
        const float DU = dx * a.x + dy * a.y + dz * a.z;
        const float OV = ox * b.x + oy * b.y + oz * b.z + b.w;
        const float DV = dx * b.x + dy * b.y + dz * b.z;
        const float OW = ox * c.x + oy * c.y + oz * c.z + c.w;
        const float DW = dx * c.x + dy * c.y + dz * c.z;
        float t;
        bool hit = true;
        if (DENOM == kIeee) {
          t = -OW / DW;
        } else {
          hit = fabsf(DW) > 1e-30f;
          const float safe = hit ? DW : 1.f;
          t = DENOM == kRecip ? -OW * __frcp_rn(safe) : -OW / safe;
        }
        const float u = OU + t * DU;
        const float v = OV + t * DV;
        hit = hit && (t > eps);
        if (!NOTMAX) hit = hit && (t < t_max);
        if (MIN2) {
          hit = hit && (fminf(u, v) >= neg_eps_b);
        } else {
          hit = hit && (u >= neg_eps_b) && (v >= neg_eps_b);
        }
        hit = hit && (u + v <= one_eps_b);
        const float tt = hit ? t : CUDART_INF_F;
        if (tt < t_tile) {  // strict: the first index keeps a tie
          t_tile = tt;
          i_tile = k;
        }
      }
      const int i_glob = i_tile + (step * NSUB + s) * kTile;
      if (REG) {
        if (t_tile < t_run) {
          t_run = t_tile;
          i_run = i_glob;
        }
      } else if (t_tile < s_bt[threadIdx.x]) {
        s_bt[threadIdx.x] = t_tile;
        s_bi[threadIdx.x] = i_glob;
      }
    }
    if (REG && t_run < s_bt[threadIdx.x]) {
      s_bt[threadIdx.x] = t_run;
      s_bi[threadIdx.x] = i_run;
    }
  }

  if (ray < n_rays) {
    float bt = s_bt[threadIdx.x];
    int bi = s_bi[threadIdx.x];
    if (NOTMAX && !(bt < t_max)) {  // the filter moved out of the pair test
      bt = CUDART_INF_F;
      bi = -1;
    }
    t_out[ray] = bt;
    tri_out[ray] = bi;
  }
}

typedef void (*VariantKernel)(const float*, const float*, int, const float4*,
                              const float4*, const float4*, int, float, float,
                              float, float, float*, int*);

struct Variant {
  int denom, notmax, min2, n_sub, reg;
  VariantKernel kernel;
};

#define LPCL_VARIANT(D, NM, M2, NS, RG) \
  { D, NM, M2, NS, RG, variant_kernel<D, NM, M2, NS, RG> }

// the instantiations the two reference scripts time
static const Variant kVariants[] = {
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

// Plain C entry point (bound with ctypes). Launches the instantiation with
// these parameters on `stream` with `ray_block` threads a CTA, does not
// synchronise, and returns cudaGetLastError(); cudaErrorInvalidValue when
// no such instantiation exists or a size is out of range.
extern "C" int lpcl_nearest_hit_variant(
    const float* o, const float* d, int n_rays, const float* wu,
    const float* wv, const float* ww, int n_tris, int denom, int notmax,
    int min2, int n_sub, int reg, int ray_block, float eps, float neg_eps_b,
    float one_eps_b, float t_max, float* t_out, int* tri_out, void* stream) {
  if (n_rays <= 0 || n_tris <= 0 || ray_block < 32 || ray_block > 1024 ||
      ray_block % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const Variant& v : kVariants) {
    if (v.denom != denom || v.notmax != notmax || v.min2 != min2 ||
        v.n_sub != n_sub || v.reg != reg) {
      continue;
    }
    const int n_blocks = (n_rays + ray_block - 1) / ray_block;
    const size_t smem = static_cast<size_t>(n_sub) * 3 * kTile *
                            sizeof(float4) +
                        static_cast<size_t>(ray_block) * 8;
    v.kernel<<<n_blocks, ray_block, smem,
               static_cast<cudaStream_t>(stream)>>>(
        o, d, n_rays, reinterpret_cast<const float4*>(wu),
        reinterpret_cast<const float4*>(wv),
        reinterpret_cast<const float4*>(ww), n_tris, eps, neg_eps_b,
        one_eps_b, t_max, t_out, tri_out);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
