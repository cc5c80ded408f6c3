// Unpolarized reflectance of a lossless dielectric film stack, by the Airy
// recursion, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes this function as
// XLA-fused jnp (lightpycl_tpu/physics.py:450 multilayer_rs_rp and :660
// multilayer_reflectance). The port's plain version is
// lightpycl_tpu_torch/physics.py::multilayer_reflectance, which eager torch
// runs as dozens of separate complex64 passes over a (C, W) surface; on the
// shared spectral path that was the trace's largest cost (PERF.md).
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
// <= 1e-20. The caller flips the stack for exiting rays, forces R = 1 under
// substrate TIR and picks coated lanes.
//
// Numerics: the result is meant to equal the plain version on the card bit
// for bit, so each operation is the one torch's CUDA kernel runs:
// c10::complex<float>'s product (a c - b d, a d + b c) and its division
// (numpy's scaled form), with the multiply-adds that nvcc fuses in torch's
// build fused here by __fmaf_rn; torch.abs as hypotf; libc++'s sqrt and exp
// (see csqrt_cxx), with the libdevice sqrtf, atan2f, expf, sinf, cosf (no
// fast intrinsics); a real operand promoted to (x, +0) and
// add / sub as a + b * (+-1, 0), as torch's AddFunctor does, so that even
// the signs of zeros agree (they pick the branch of a sqrt). Everything
// else is built with -fmad=false: each * and + written is one IEEE
// operation.
//
// What bounds it on the card: FP32 work. Per (ray, wavelength) and layer
// the function needs one phase factor (a division, exp, sin, cos and four
// products) and two Moebius steps (two complex products, a complex
// division, a modulus and three additions each), ~60 operations
// (ops/film_stack.py::FLOPS_PER_ENTRY_LAYER), while it reads (2 L + 3) x 4
// bytes a ray and writes 4 bytes an entry. At phase 19's 1,048,576 slots x
// 32 wavelengths x 6 layers that is ~12 GFLOP (0.18 ms at 67 TFLOP/s)
// against ~0.2 GB (0.06 ms at 3.35 TB/s). The kernel itself issues more:
// it repeats torch's products by the zero parts of promoted reals, and
// expf / sinf / cosf are a few dozen instructions each.
//
// The design: a block of kThreads threads takes `rays` rays. Phase 1: one
// thread a ray computes everything that depends on the ray alone (per
// layer the complex cosine c_k, the interface coefficients rho_s, rho_p and
// 2 pi n_k h_k, and the top interface) into shared memory. Phase 2: the
// block walks its rays x W entries in the output's own order (neighbouring
// threads write neighbouring words), each thread running the recursion for
// its entry in registers; nothing intermediate goes to device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFields = 7;  // per layer: c (2), rho_s (2), rho_p (2), x0

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
// multiply-add fused as in torch's build (probed likewise; the divisor here
// is never 0, unit_where_tiny replaces it first)
__device__ __forceinline__ float2 cdiv(float2 x, float2 y) {
  const float a = x.x, b = x.y, c = y.x, d = y.y;
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) {
      return make_float2(a / abs_c, b / abs_d);
    }
    const float rat = d / c;
    const float scl = 1.0f / __fmaf_rn(d, rat, c);
    return make_float2(__fmaf_rn(b, rat, a) * scl,
                       __fmaf_rn(-a, rat, b) * scl);
  }
  const float rat = c / d;
  const float scl = 1.0f / __fmaf_rn(c, rat, d);
  return make_float2(__fmaf_rn(a, rat, b) * scl, __fmaf_rn(b, rat, -a) * scl);
}

// torch.add(x, y, alpha) on complex: AddFunctor's x + y * alpha
__device__ __forceinline__ float2 cadd(float2 x, float2 y, float alpha) {
  const float2 t = cmul(y, make_float2(alpha, 0.0f));
  return make_float2(x.x + t.x, x.y + t.y);
}

__device__ __forceinline__ float2 real_c(float x) {
  return make_float2(x, 0.0f);
}

// _unit_where_tiny: 1 in place of a divisor of modulus <= 1e-20
__device__ __forceinline__ float2 unit_where_tiny(float2 z) {
  return hypotf(z.x, z.y) > 1e-20f ? z : make_float2(1.0f, 0.0f);
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

__device__ float2 cexp_cxx(float2 z) {
  float y = z.y;
  if (y == 0.0f) return make_float2(expf(z.x), copysignf(0.0f, y));
  if (isinf(z.x)) {
    if (z.x < 0.0f) {
      if (!isfinite(y)) y = 1.0f;
    } else if (!isfinite(y)) {
      return make_float2(z.x, isinf(y) ? NAN : y);
    }
  }
  const float e = expf(z.x);
  return make_float2(e * cosf(y), e * sinf(y));
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
  const float2 z = cadd(real_c(1.0f), real_c(q), -1.0f);
  // _branch_safe_sqrt
  const bool zsafe = (z.x * z.x + z.y * z.y) > 1e-12f;
  return zsafe ? csqrt_cxx(z) : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float2 fresnel_iface(float2 ea, float2 eb) {
  return cdiv(cadd(ea, eb, -1.0f), unit_where_tiny(cadd(ea, eb, 1.0f)));
}

__device__ __forceinline__ float2 moebius(float2 rho, float2 r,
                                          float2 phase) {
  const float2 num = cadd(rho, cmul(r, phase), 1.0f);
  // 1.0 + t: torch.add(t, 1.0), i.e. t + (1, 0) * (1, 0)
  const float2 den = cadd(cmul(cmul(rho, r), phase), real_c(1.0f), 1.0f);
  return cdiv(num, unit_where_tiny(den));
}

__device__ __forceinline__ float2 phase_factor(float x0, float wl,
                                               float2 ck) {
  const float x = x0 / clamp_min(wl, 1e-20f);
  // exp(2j * complex(x) * c)
  const float2 arg = cmul(cmul(real_c(x), make_float2(0.0f, 2.0f)), ck);
  return cexp_cxx(arg);
}

// Phase 1 output, per ray: fields [k * kFields + j] for layer k (0 = next
// to the incident medium), then the top interface at [L * kFields + 0..3].
__device__ __forceinline__ float& field(float* sm, int rays, int f, int r) {
  return sm[f * rays + r];
}

__global__ void __launch_bounds__(kThreads)
    film_stack_kernel(const float* __restrict__ cos_i,
                      const float* __restrict__ n1v,
                      const float* __restrict__ n_subv,
                      const float* __restrict__ layers_n,
                      const float* __restrict__ layers_h,
                      const float* __restrict__ wl, int n_rays, int L, int W,
                      int wl_per_ray, int rays, float* __restrict__ out) {
  extern __shared__ float sm[];
  const long long ray0 = static_cast<long long>(blockIdx.x) * rays;
  const int nr = static_cast<int>(
      min(static_cast<long long>(rays), n_rays - ray0));

  // ---- phase 1: the terms that depend on the ray alone
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const long long c = ray0 + r;
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
      const int f = k * kFields;
      field(sm, rays, f + 0, r) = ck.x;
      field(sm, rays, f + 1, r) = ck.y;
      field(sm, rays, f + 2, r) = rs.x;
      field(sm, rays, f + 3, r) = rs.y;
      field(sm, rays, f + 4, r) = rp.x;
      field(sm, rays, f + 5, r) = rp.y;
      field(sm, rays, f + 6, r) = x0;
      prev_s = eks;
      prev_p = ekp;
    }
    const float2 c1 = real_c(ci);
    const float2 e1s = cmul(real_c(n1), c1);
    const float2 e1p = cdiv(real_c(n1), unit_where_tiny(c1));
    const float2 ts = fresnel_iface(e1s, prev_s);
    const float2 tp = fresnel_iface(e1p, prev_p);
    const int f = L * kFields;
    field(sm, rays, f + 0, r) = ts.x;
    field(sm, rays, f + 1, r) = ts.y;
    field(sm, rays, f + 2, r) = tp.x;
    field(sm, rays, f + 3, r) = tp.y;
  }
  __syncthreads();

  // ---- phase 2: the recursion for every (ray, wavelength) entry
  const int entries = nr * W;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int r = e / W;
    const int w = e - r * W;
    const float wlv = wl_per_ray ? wl[ray0 + r] : wl[w];
    int f = (L - 1) * kFields;
    float2 ck = make_float2(field(sm, rays, f + 0, r),
                            field(sm, rays, f + 1, r));
    float2 r_s = make_float2(field(sm, rays, f + 2, r),
                             field(sm, rays, f + 3, r));
    float2 r_p = make_float2(field(sm, rays, f + 4, r),
                             field(sm, rays, f + 5, r));
    float2 phase = phase_factor(field(sm, rays, f + 6, r), wlv, ck);
    for (int k = L - 2; k >= 0; --k) {
      f = k * kFields;
      ck = make_float2(field(sm, rays, f + 0, r), field(sm, rays, f + 1, r));
      const float2 rho_s = make_float2(field(sm, rays, f + 2, r),
                                       field(sm, rays, f + 3, r));
      const float2 rho_p = make_float2(field(sm, rays, f + 4, r),
                                       field(sm, rays, f + 5, r));
      r_s = moebius(rho_s, r_s, phase);
      r_p = moebius(rho_p, r_p, phase);
      phase = phase_factor(field(sm, rays, f + 6, r), wlv, ck);
    }
    f = L * kFields;
    r_s = moebius(make_float2(field(sm, rays, f + 0, r),
                              field(sm, rays, f + 1, r)), r_s, phase);
    r_p = moebius(make_float2(field(sm, rays, f + 2, r),
                              field(sm, rays, f + 3, r)), r_p, phase);
    // 0.5 * (|rs|^2 + |rp|^2), clamped to [0, 1]
    const float as = hypotf(r_s.x, r_s.y);
    const float ap = hypotf(r_p.x, r_p.y);
    const float R = 0.5f * (as * as + ap * ap);
    out[ray0 * W + e] = isnan(R) ? R : fminf(fmaxf(R, 0.0f), 1.0f);
  }
}

int rays_per_block(int L) {
  // the per-ray record must fit the shared memory of one block
  const int record = (L * kFields + 4) * static_cast<int>(sizeof(float));
  return record * kThreads <= 48 * 1024 ? kThreads : 32;
}

}  // namespace

// R (C, W) of C rays against a wavelength row wl (W,) (wl_per_ray = 0), or
// R (C,) of one wavelength a ray wl (C,) (wl_per_ray = 1, W = 1). Layer
// columns layers_n, layers_h are (C, L) row-major, layer 0 next to the
// incident medium. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int lpcl_film_stack(const float* cos_i, const float* n1,
                               const float* n_sub, const float* layers_n,
                               const float* layers_h, const float* wl,
                               int n_rays, int L, int W, int wl_per_ray,
                               float* out, void* stream) {
  if (n_rays <= 0 || L <= 0 || W <= 0 || (wl_per_ray && W != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rays = rays_per_block(L);
  const size_t smem =
      static_cast<size_t>(L * kFields + 4) * rays * sizeof(float);
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
      cos_i, n1, n_sub, layers_n, layers_h, wl, n_rays, L, W, wl_per_ray,
      rays, out);
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
