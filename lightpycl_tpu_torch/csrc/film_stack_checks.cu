// Two checks, on the card, of what csrc/film_stack.cu computes by a
// shorter sequence than torch's: its modulus test against hypotf, and
// sincosf against sinf and cosf. Built and run by chip_smoke.py (phase
// 19) only; the trace never loads this library. Same flags as every
// kernel of the port (ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>

#include "film_stack_modulus.cuh"

namespace {

// mismatch[0] += the pairs (x[i], y[i]) where modulus_exceeds_tiny
// differs from hypotf(x, y) > 1e-20f
__global__ void modulus_test_kernel(const float* __restrict__ x,
                                    const float* __restrict__ y, int n,
                                    unsigned long long* mismatch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (modulus_exceeds_tiny(x[i], y[i]) != (hypotf(x[i], y[i]) > 1e-20f)) {
    atomicAdd(mismatch, 1ull);
  }
}

// sincosf(x) against sinf(x) and cosf(x) on every float32 bit pattern:
// mismatch[0] += the x where the sines differ in a bit, mismatch[1] += the
// cosines
__global__ void sincos_test_kernel(unsigned long long* mismatch) {
  const unsigned int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float x = __uint_as_float(i);
  float s, c;
  sincosf(x, &s, &c);
  if (__float_as_uint(s) != __float_as_uint(sinf(x))) {
    atomicAdd(mismatch, 1ull);
  }
  if (__float_as_uint(c) != __float_as_uint(cosf(x))) {
    atomicAdd(mismatch + 1, 1ull);
  }
}

}  // namespace

// Each returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for n <= 0).
extern "C" int lpcl_film_modulus_test(const float* x, const float* y, int n,
                                      unsigned long long* mismatch,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  modulus_test_kernel<<<(n + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, y, n,
                                                             mismatch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lpcl_film_sincos_test(unsigned long long* mismatch,
                                     void* stream) {
  sincos_test_kernel<<<1u << 24, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(mismatch);
  return static_cast<int>(cudaGetLastError());
}
