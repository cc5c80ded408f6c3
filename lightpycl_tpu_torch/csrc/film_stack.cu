// Unpolarized reflectance of a lossless dielectric film stack, by the Airy
// recursion, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes this function as
// XLA-fused jnp (lightpycl_tpu/physics.py:450 multilayer_rs_rp and :660
// multilayer_reflectance). The port's plain version is
// lightpycl_tpu_torch/ops/film_stack.py::film_stack_torch
// (physics.multilayer_reflectance and the two selects below), which eager
// torch runs as dozens of separate complex64 passes over a (C, W) surface.
//
// What it computes, for every ray c and wavelength w (torch's operations in
// torch's order, see "Numerics"):
//   ci = max(cos_i, 1e-6); n1s2 = (n1 n1) max(1 - ci ci, 0)
//   c(n) = sqrt(1 - n1s2 / (n n)) on the principal branch, exactly 0 where
//          |1 - n1s2 / (n n)|^2 <= 1e-12 (n clamped to >= 1e-20)
//   eta_s(n) = n c(n), eta_p(n) = n / c(n)
//   rho = (eta_a - eta_b) / (eta_a + eta_b) at each interface, from the
//         substrate up; r = rho of the lowest interface, then per layer
//         r <- (rho + r e) / (1 + rho r e), e = exp(2i x_k c_k),
//         x_k = (2 pi n_k h_k) / max(wl, 1e-20): a phase factor that decays
//         for an evanescent layer and is 1 for h = 0 (the layer drops out)
//   R = clamp(0.5 (|rs|^2 + |rp|^2), 0, 1)
// Every complex division's divisor is replaced by 1 where its modulus is
// <= 1e-20. The caller flips the stack for exiting rays. Then the surface
// the trace uses: R where the ray's triangle is coated (1 under substrate
// TIR), the bare Fresnel R_fresnel of the ray where it is not; uncoated and
// TIR rays skip the recursion.
//
// Numerics: the result is meant to equal the plain version on the card bit
// for bit, so each operation is the one torch's CUDA kernel runs:
// c10::complex<float>'s product (a c - b d, a d + b c) and its division
// (numpy's scaled form), with the multiply-adds that nvcc fuses in torch's
// build fused here by __fmaf_rn; torch.abs as hypotf; libc++'s sqrt and exp
// (see csqrt_cxx), with the libdevice sqrtf, atan2f, expf, sinf, cosf (no
// fast intrinsics); a real operand promoted to (x, +0) and add / sub as
// a + b * (+-1, 0), as torch's AddFunctor does, so that even the signs of
// zeros agree (they pick the branch of a sqrt). Everything else is built
// with -fmad=false: each * and + written is one IEEE operation.
//
// Where this file computes one of those operations by another sequence, it
// is one that gives the same bits for every input, Inf, NaN and signed
// zeros included (each says why): the division without its branch (its
// second side as the first on rotated operands), the sum with a promoted
// (+-1, 0) in two operations, the modulus test without hypotf where the
// sum of the parts' moduli settles it (film_stack_modulus.cuh).
//
// What bounds it on the card. Per (ray, wavelength) and layer the function
// needs one phase factor (a division, exp, sin, cos and four products) and
// two Moebius steps (two complex products, a complex division, a modulus
// and three additions each), ~60 operations
// (ops/film_stack.py::FLOPS_PER_ENTRY_LAYER), while it reads (2 L + 5) x 4
// bytes a ray and writes 4 bytes an entry. At 1,048,576 rays x 32
// wavelengths x 6 layers that is ~12 GFLOP (0.18 ms at 67 TFLOP/s) against
// ~0.2 GB (0.06 ms at 3.35 TB/s). The kernel issues about 190
// instructions an entry and layer on its common path (libdevice's expf and
// sincosf, three IEEE divisions and two reciprocals with the checks that
// guard their slow paths, the selects of the branch-free division;
// chip_smoke phase 2 counts them in the SASS), so the rate at which a warp
// scheduler issues, not the FP32 peak, bounds it (PERF.md).
//
// The design: a block of kThreads threads takes `rays` rays
// (rays_per_block: at most kEntriesPerThread entries a thread, 64 rays at
// W = 32, where a warp walks the 32 wavelengths of one ray). Phase 1: one
// thread a ray computes everything that depends on the ray alone (per
// layer the complex cosine c_k, the interface coefficients rho_s, rho_p
// and 2 pi n_k h_k, and the top interface) into a ray-major record in
// shared memory, skipping uncoated and TIR rays, read back as
// float4 (broadcast within the warp when it walks one ray). Phase 2: the
// block walks its rays x W entries in the output's own order (neighbouring
// threads write neighbouring words), each thread running the recursion for
// its entry in registers; nothing intermediate goes to device memory. The
// division, the modulus test and exp run without data-dependent branches
// (but for their rare slow paths), so a warp's 32 wavelengths stay
// converged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "film_stack_modulus.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kEntriesPerThread = 16;
// record words: per layer (c_k, rho_s) and (rho_p, x0, -); the top
// interface (ts, tp)
constexpr int kLayerWords = 8;
constexpr int kTopWords = 4;

// ---------------------------------------------------------------- complex

// c10::complex<float>::operator*= as nvcc compiles it in torch's build:
// real_ = a*c - b*d and imag_ = a*d + b*c, each with its first product
// fused into the add (probed on the card: every bit of torch's complex64
// product on 2^20 random pairs)
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  const float a = x.x, b = x.y, c = y.x, d = y.y;
  return make_float2(__fmaf_rn(a, c, -(b * d)), __fmaf_rn(a, d, b * c));
}

// c10::complex<float>::operator/= (numpy's scaled division), each
// multiply-add fused as in torch's build, without its branch on
// |c| >= |d|: where |d| > |c|, x / y = (x (-i)) / (y (-i)) = (b, -a) /
// (d, -c), and the |c| >= |d| side run on those operands performs the
// other side's operations exactly (negation is exact and rounding to
// nearest is symmetric: (-c) / d = -(c / d), (-a)(-r) = a r), so four
// selects of the operands give the same bits, and a warp no longer
// splits. Its third case, c = d = 0, never arrives: every divisor here has
// passed unit_where_tiny, which leaves only a modulus > 1e-20. A NaN part
// fails the compare and takes the second side, as it did.
__device__ __forceinline__ float2 cdiv(float2 x, float2 y) {
  const bool first = fabsf(y.x) >= fabsf(y.y);
  const float a = first ? x.x : x.y, b = first ? x.y : -x.x;
  const float c = first ? y.x : y.y, d = first ? y.y : -y.x;
  const float rat = d / c;
  const float scl = 1.0f / __fmaf_rn(d, rat, c);
  return make_float2(__fmaf_rn(b, rat, a) * scl, __fmaf_rn(-a, rat, b) * scl);
}

// torch.add(x, y, alpha = +-1) on complex, AddFunctor's x + y * (alpha, 0):
// y * (1, 0) = (fma(y.x, 1, -(y.y 0)), fma(y.x, 0, y.y 1)) is y up to a
// zero added to each part (y.y * -0 and y.x * 0: a signed zero, or NaN
// where the other part is infinite or NaN). For any a, b and such a z,
// a + (b + z) == (a + b) + z in round-to-nearest (z leaves a non-zero sum
// alone, and the sign of a zero sum is the same in either order), so each
// part is one addition and one multiply-add by a zero, not a product, a
// multiply-add and an addition.
__device__ __forceinline__ float2 cadd1(float2 x, float2 y) {
  return make_float2(__fmaf_rn(y.y, -0.0f, x.x + y.x),
                     __fmaf_rn(y.x, 0.0f, x.y + y.y));
}

// alpha = -1: y * (-1, 0) = (fma(y.x, -1, -(y.y 0)), fma(y.x, 0, -y.y))
__device__ __forceinline__ float2 csub1(float2 x, float2 y) {
  return make_float2(__fmaf_rn(y.y, -0.0f, x.x - y.x),
                     __fmaf_rn(y.x, 0.0f, x.y - y.y));
}

__device__ __forceinline__ float2 real_c(float x) {
  return make_float2(x, 0.0f);
}

// _unit_where_tiny: 1 in place of a divisor of modulus <= 1e-20
__device__ __forceinline__ float2 unit_where(float2 z, bool keep) {
  return keep ? z : make_float2(1.0f, 0.0f);
}

__device__ __forceinline__ float2 unit_where_tiny(float2 z) {
  return unit_where(z, modulus_exceeds_tiny(z.x, z.y));
}

// torch's complex sqrt and exp on the card are jiterated (compiled at run
// time from a copy of libc++'s <complex>), not thrust's: sqrt is
// polar(sqrt(|z|), arg(z) / 2), so a negative real z = (-a, +0) gives
// (sqrt(a) cos(pi/2), sqrt(a)) with cos(float(pi) / 2) = -4.4e-8, not an
// exact 0 real part; exp is (e^x cos y, e^x sin y) with libc++'s special
// cases.
__device__ float2 polar(float rho, float theta) {
  if (isnan(rho) || signbit(rho)) return make_float2(NAN, NAN);
  if (isnan(theta)) {
    if (isinf(rho)) return make_float2(rho, theta);
    return make_float2(theta, theta);
  }
  if (isinf(theta)) {
    if (isinf(rho)) return make_float2(rho, NAN);
    return make_float2(NAN, NAN);
  }
  float x = rho * cosf(theta);
  if (isnan(x)) x = 0.0f;
  float y = rho * sinf(theta);
  if (isnan(y)) y = 0.0f;
  return make_float2(x, y);
}

__device__ float2 csqrt_cxx(float2 z) {
  const float a = z.x, b = z.y;
  if (isinf(b)) return make_float2(INFINITY, b);
  if (isinf(a)) {
    if (a > 0.0f) return make_float2(a, isnan(b) ? b : copysignf(0.0f, b));
    return make_float2(isnan(b) ? b : 0.0f, copysignf(a, b));
  }
  return polar(sqrtf(hypotf(a, b)), atan2f(b, a) / 2.0f);
}

// libc++'s exp: (e^x, y) for y == +-0; for x = -inf and y not finite, y
// becomes 1; for x = +inf and y not finite, (x, NaN or y). The infinite
// real part is the only branch (rare); the rest is selects.
__device__ __forceinline__ float2 cexp_cxx(float2 z) {
  float y = z.y;
  if (isinf(z.x) && !isfinite(y)) {
    if (z.x > 0.0f) return make_float2(z.x, isinf(y) ? NAN : y);
    y = 1.0f;
  }
  const float e = expf(z.x);
  // sincosf gives sinf's and cosf's bits (on every float32, on the card:
  // csrc/film_stack_checks.cu, chip_smoke phase 19) and shares their
  // argument reduction
  float s, c;
  sincosf(y, &s, &c);
  return y == 0.0f ? make_float2(e, copysignf(0.0f, y))
                   : make_float2(e * c, e * s);
}

// ------------------------------------------------------- the film physics

// torch.clamp_min / clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// _stack_cos: the complex cosine in a layer of index n, given n1^2 sin^2
__device__ float2 stack_cos(float n1s2, float n) {
  const float nn = clamp_min(n, 1e-20f);
  const float q = n1s2 / (nn * nn);
  // 1.0 - complex(q): torch.rsub, i.e. 1 + (q, 0) * (-1, 0)
  const float2 z = csub1(real_c(1.0f), real_c(q));
  // _branch_safe_sqrt
  const bool zsafe = (z.x * z.x + z.y * z.y) > 1e-12f;
  return zsafe ? csqrt_cxx(z) : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float2 fresnel_iface(float2 ea, float2 eb) {
  return cdiv(csub1(ea, eb), unit_where_tiny(cadd1(ea, eb)));
}

// One layer of the recursion for both polarizations, which share the
// phase factor: r <- (rho + r e) / (1 + rho r e). The two divisors' modulus
// tests go first, so that one rare branch (hypotf) serves both and the
// two divisions can interleave.
__device__ __forceinline__ void moebius2(float2 rho_s, float2 rho_p,
                                         float2 phase, float2& r_s,
                                         float2& r_p) {
  const float2 num_s = cadd1(rho_s, cmul(r_s, phase));
  const float2 num_p = cadd1(rho_p, cmul(r_p, phase));
  // 1.0 + t: torch.add(t, 1.0), t + (1, 0) * (1, 0) = (t.x + 1, t.y + 0)
  const float2 t_s = cmul(cmul(rho_s, r_s), phase);
  const float2 t_p = cmul(cmul(rho_p, r_p), phase);
  const float2 den_s = make_float2(t_s.x + 1.0f, t_s.y + 0.0f);
  const float2 den_p = make_float2(t_p.x + 1.0f, t_p.y + 0.0f);
  const ModulusTest m_s = settle_modulus(den_s);
  const ModulusTest m_p = settle_modulus(den_p);
  bool keep_s = m_s.keep, keep_p = m_p.keep;
  if (!(m_s.settled && m_p.settled)) {
    keep_s = m_s.settled ? keep_s : hypot_exceeds_tiny(den_s);
    keep_p = m_p.settled ? keep_p : hypot_exceeds_tiny(den_p);
  }
  r_s = cdiv(num_s, unit_where(den_s, keep_s));
  r_p = cdiv(num_p, unit_where(den_p, keep_p));
}

// exp(2j * complex(x) * c), x = x0 / max(wl, 1e-20) (wlc: wl clamped)
__device__ __forceinline__ float2 phase_factor(float x0, float wlc,
                                               float2 ck) {
  const float x = x0 / wlc;
  // (x, +0) * (0, 2) = (fma(x, 0, -(0 2)), fma(x, 2, 0 0)); x 0 + -0 is
  // x 0 for every x
  const float2 x2i = make_float2(x * 0.0f, __fmaf_rn(x, 2.0f, 0.0f));
  return cexp_cxx(cmul(x2i, ck));
}

__global__ void __launch_bounds__(kThreads)
    film_stack_kernel(const float* __restrict__ cos_i,
                      const float* __restrict__ n1v,
                      const float* __restrict__ n_subv,
                      const float* __restrict__ layers_n,
                      const float* __restrict__ layers_h,
                      const float* __restrict__ wl,
                      const unsigned char* __restrict__ tir,
                      const unsigned char* __restrict__ coated,
                      const float* __restrict__ r_fresnel, int n_rays, int L,
                      int W, int wl_per_ray, int rays,
                      float* __restrict__ out) {
  extern __shared__ float4 sm4[];
  const int stride4 = (L * kLayerWords + kTopWords) / 4;  // float4 a ray
  float4* rec = sm4;
  // a ray's output when it skips the recursion, and whether it does
  float* fixed = reinterpret_cast<float*>(sm4 + rays * stride4);
  int* skip = reinterpret_cast<int*>(fixed + rays);
  const long long ray0 = static_cast<long long>(blockIdx.x) * rays;
  const int nr = static_cast<int>(
      min(static_cast<long long>(rays), n_rays - ray0));

  // ---- phase 1: the terms that depend on the ray alone
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const long long c = ray0 + r;
    const bool on = coated[c] != 0;
    const bool forced = on && tir[c] != 0;
    skip[r] = !on || forced;
    fixed[r] = on ? 1.0f : r_fresnel[c];
    if (!on || forced) continue;
    float4* rr = rec + r * stride4;
    const float ci = clamp_min(cos_i[c], 1e-6f);
    const float n1 = n1v[c];
    const float sin2 = clamp_min(1.0f - ci * ci, 0.0f);
    const float n1s2 = (n1 * n1) * sin2;
    // etas(n, c) = (n * c, n / unit(c)) with n promoted to (n, +0)
    const float n_sub = n_subv[c];
    const float2 cs = stack_cos(n1s2, n_sub);
    float2 prev_s = cmul(real_c(n_sub), cs);
    float2 prev_p = cdiv(real_c(n_sub), unit_where_tiny(cs));
    for (int k = L - 1; k >= 0; --k) {
      const float nk = layers_n[c * L + k];
      const float hk = layers_h[c * L + k];
      const float2 ck = stack_cos(n1s2, nk);
      const float2 eks = cmul(real_c(nk), ck);
      const float2 ekp = cdiv(real_c(nk), unit_where_tiny(ck));
      const float2 rs = fresnel_iface(eks, prev_s);
      const float2 rp = fresnel_iface(ekp, prev_p);
      // 2.0 * math.pi * nk * hk: the Python float 2 pi rounded to f32
      const float x0 = (6.283185307179586f * nk) * hk;
      rr[2 * k] = make_float4(ck.x, ck.y, rs.x, rs.y);
      rr[2 * k + 1] = make_float4(rp.x, rp.y, x0, 0.0f);
      prev_s = eks;
      prev_p = ekp;
    }
    const float2 c1 = real_c(ci);
    const float2 e1s = cmul(real_c(n1), c1);
    const float2 e1p = cdiv(real_c(n1), unit_where_tiny(c1));
    const float2 ts = fresnel_iface(e1s, prev_s);
    const float2 tp = fresnel_iface(e1p, prev_p);
    rr[2 * L] = make_float4(ts.x, ts.y, tp.x, tp.y);
  }
  __syncthreads();

  // ---- phase 2: the recursion for every (ray, wavelength) entry
  const int entries = nr * W;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int r = e / W;
    const int w = e - r * W;
    if (skip[r]) {
      out[ray0 * W + e] = fixed[r];
      continue;
    }
    const float4* rr = rec + r * stride4;
    const float wlc = clamp_min(wl_per_ray ? wl[ray0 + r] : wl[w], 1e-20f);
    float4 a = rr[2 * (L - 1)], b = rr[2 * (L - 1) + 1];
    float2 r_s = make_float2(a.z, a.w);
    float2 r_p = make_float2(b.x, b.y);
    float2 phase = phase_factor(b.z, wlc, make_float2(a.x, a.y));
    for (int k = L - 2; k >= 0; --k) {
      a = rr[2 * k];
      b = rr[2 * k + 1];
      moebius2(make_float2(a.z, a.w), make_float2(b.x, b.y), phase, r_s,
               r_p);
      phase = phase_factor(b.z, wlc, make_float2(a.x, a.y));
    }
    const float4 top = rr[2 * L];
    moebius2(make_float2(top.x, top.y), make_float2(top.z, top.w), phase,
             r_s, r_p);
    // 0.5 * (|rs|^2 + |rp|^2), clamped to [0, 1]
    const float as = hypotf(r_s.x, r_s.y);
    const float ap = hypotf(r_p.x, r_p.y);
    const float R = 0.5f * (as * as + ap * ap);
    out[ray0 * W + e] = isnan(R) ? R : fminf(fmaxf(R, 0.0f), 1.0f);
  }
}

size_t smem_bytes(int L, int rays) {
  return static_cast<size_t>(rays) *
         ((L * kLayerWords + kTopWords) * sizeof(float) + sizeof(float) +
          sizeof(int));
}

// rays a block: at most kEntriesPerThread entries a thread, at least one
// ray, at most one a thread; halved while the records pass 48 KB
int rays_per_block(int L, int W) {
  int rays = max(1, min(kThreads, kThreads * kEntriesPerThread / W));
  while (rays > 1 && smem_bytes(L, rays) > 48 * 1024) rays /= 2;
  return rays;
}

}  // namespace

// R (C, W) of C rays against a wavelength row wl (W,) (wl_per_ray = 0), or
// R (C,) of one wavelength a ray wl (C,) (wl_per_ray = 1, W = 1). Layer
// columns layers_n, layers_h are (C, L) row-major, layer 0 next to the
// incident medium. tir, coated (C,) bytes 0 / 1 and r_fresnel (C,): an
// uncoated ray's entries are r_fresnel, a coated one's under TIR 1. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int lpcl_film_stack(const float* cos_i, const float* n1,
                               const float* n_sub, const float* layers_n,
                               const float* layers_h, const float* wl,
                               const unsigned char* tir,
                               const unsigned char* coated,
                               const float* r_fresnel, int n_rays, int L,
                               int W, int wl_per_ray, float* out,
                               void* stream) {
  if (n_rays <= 0 || L <= 0 || W <= 0 || (wl_per_ray && W != 1) ||
      tir == nullptr || coated == nullptr || r_fresnel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rays = rays_per_block(L, W);
  const size_t smem = smem_bytes(L, rays);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        film_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rays + rays - 1) / rays;
  film_stack_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      cos_i, n1, n_sub, layers_n, layers_h, wl, tir, coated, r_fresnel,
      n_rays, L, W, wl_per_ray, rays, out);
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel's resources, for the record (chip_smoke.py):
// registers per thread, static shared memory, local (spill) bytes per
// thread, threads per CTA. Returns the first CUDA error, else 0.
extern "C" int lpcl_film_stack_resources(int* regs, int* smem_bytes,
                                         int* local_bytes, int* threads) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, film_stack_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = kThreads;
  return 0;
}
