// The film-stack kernel's modulus test, |z| > 1e-20 (torch.abs(z) > 1e-20
// on complex64, i.e. hypotf), shared by csrc/film_stack.cu and the card's
// check of it against hypotf, csrc/film_stack_checks.cu.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// hypotf(x, y) > 1e-20f, settled without hypotf where the sum of the
// parts' moduli does it: hypotf is within 3 ulp (CUDA's documented bound)
// of sqrt(x^2 + y^2), which lies between (|x| + |y|) / 2 and |x| + |y|. So a
// sum (rounded) of at least 2.9e-20 gives true, one below 9.9e-21 false;
// the band between and a NaN part (the sum is NaN: both compares fail)
// leave it to hypotf. Never in that band on real stacks, and tested on the
// card against hypotf (chip_smoke phase 19).
struct ModulusTest {
  bool keep;     // the answer, where settled
  bool settled;  // false: ask hypotf
};

__device__ __forceinline__ ModulusTest settle_modulus(float2 z) {
  const float s = fabsf(z.x) + fabsf(z.y);
  const bool big = s >= 2.9e-20f;
  return {big, big || s < 9.9e-21f};
}

// the band's answer, out of line: its operands stay off the common path
__device__ __noinline__ bool hypot_exceeds_tiny(float2 z) {
  return hypotf(z.x, z.y) > 1e-20f;
}

__device__ __forceinline__ bool modulus_exceeds_tiny(float x, float y) {
  const ModulusTest m = settle_modulus(make_float2(x, y));
  return m.settled ? m.keep : hypot_exceeds_tiny(make_float2(x, y));
}

}  // namespace
