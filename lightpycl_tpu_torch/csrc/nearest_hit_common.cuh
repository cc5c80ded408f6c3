// The pieces that the nearest-hit kernels share: csrc/intersect.cu (B1
// brute, B2 cull) and csrc/intersect_variants.cu (the epilogue variants).
//
// Each (ray, triangle) pair first meets a division-free reject test in FMA
// on the Plücker form of the barycentric numerators; only the pairs it keeps
// run the kernel's exact, unfused lines. The design, the test and the
// derivation of its margin M (why no pair that the exact lines accept as a
// hit is ever skipped) are written out in intersect.cu's header, steps (a)
// to (f); intersect_variants.cu's header extends the proof to its exact
// lines. tests/test_torch_intersect_reject.py and
// tests/test_torch_intersect_variants_reject.py mirror the test in plain
// torch.
//
// Everything here is __forceinline__ and does what intersect.cu did inline:
// __fmaf_rn appears only in the reject test and in the records and moments
// it reads, never in the exact lines that decide (t, tri). The ray's moment
// and the test itself stay written out in intersect.cu's kernel body (as
// calls they move its instruction schedule); intersect_variants.cu has the
// same lines as functions.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

struct __align__(16) Rows {
  float4 u, v, w;  // a triangle's unit-transform rows
};
// (a x c, Qa.x) (Qa.y, Qa.z, (b x c).xy) ((b x c).z, Qb) (c.xyz, M), with
// Qa = a_w c - c_w a, Qb = b_w c - c_w b and M the pair margin for the
// CTA's rays
struct __align__(16) Record {
  float4 r0, r1, r2, r3;
};

constexpr float kEta = 0x1p-60f;
constexpr float kRange = 0x1p30f;
constexpr float kEbUp = 0x1.004p0f;  // 1 + 2^-10

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a x c and a_w c - c_w a, each component one product and one fma
__device__ __forceinline__ float cross_term(float p, float q, float r,
                                            float s) {
  return __fmaf_rn(p, q, -(r * s));
}

// A triangle's rows (a, b, c4 = rows u, v, w) -> its record, with the margin
// M for a CTA whose in-range rays have max|o_i| <= mo_blk and max|d_i| <=
// md_blk; `delta` is the margin's relative width (ops/intersect.py::
// REJECT_DELTA) and eb = |-eps_b as f32| * kEbUp. See "The margin" in
// intersect.cu: M = md_blk*(mo_blk*alpha + beta) + 2^-60, or +inf for a
// triangle out of range.
__device__ __forceinline__ Record plucker_record(float4 a, float4 b,
                                                 float4 c4, float mo_blk,
                                                 float md_blk, float delta,
                                                 float eb) {
  const float la = fabsf(a.x) + fabsf(a.y) + fabsf(a.z);
  const float lb = fabsf(b.x) + fabsf(b.y) + fabsf(b.z);
  const float lc = fabsf(c4.x) + fabsf(c4.y) + fabsf(c4.z);
  const float l_ab = fmaxf(la, lb);
  const float b_ab = fmaxf(fabsf(a.w), fabsf(b.w));
  const bool in_range = (la <= kRange) & (lb <= kRange) & (lc <= kRange) &
                        (fabsf(a.w) <= kRange) & (fabsf(b.w) <= kRange) &
                        (fabsf(c4.w) <= kRange);
  const float alpha = delta * ((l_ab + l_ab) * lc);
  const float beta =
      delta * ((b_ab * lc + fabsf(c4.w) * l_ab) + lc) + eb * lc;
  Record r;
  r.r0 = make_float4(cross_term(a.y, c4.z, a.z, c4.y),
                     cross_term(a.z, c4.x, a.x, c4.z),
                     cross_term(a.x, c4.y, a.y, c4.x),
                     cross_term(a.w, c4.x, c4.w, a.x));
  r.r1 = make_float4(cross_term(a.w, c4.y, c4.w, a.y),
                     cross_term(a.w, c4.z, c4.w, a.z),
                     cross_term(b.y, c4.z, b.z, c4.y),
                     cross_term(b.z, c4.x, b.x, c4.z));
  r.r2 = make_float4(cross_term(b.x, c4.y, b.y, c4.x),
                     cross_term(b.w, c4.x, c4.w, b.x),
                     cross_term(b.w, c4.y, c4.w, b.y),
                     cross_term(b.w, c4.z, c4.w, b.z));
  r.r3 = make_float4(
      c4.x, c4.y, c4.z,
      in_range ? __fmaf_rn(md_blk, __fmaf_rn(mo_blk, alpha, beta), kEta)
               : CUDART_INF_F);
  return r;
}
