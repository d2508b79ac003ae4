// Float32-accurate products on Hopper's tensor cores: 3xTF32 with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//
// A float32 x is split into hi = cvt.rna.tf32.f32(x) (10 mantissa bits,
// rounded to nearest, ties away from zero) and lo = cvt.rna.tf32.f32(x - hi);
// x - hi is exact in float32, and hi + lo carries about 21 of x's 24
// significand bits. A product a * b is then lo(a) hi(b) + hi(a) lo(b) +
// hi(a) hi(b), the small terms first, each into a float32 accumulator (the
// dropped lo(a) lo(b) is below 2^-21 of |a b|). That is CUTLASS's
// OpMultiplyAddFastF32. A product of two TF32 values is exact in float32, so
// the result differs from a float32 FMA chain by about as much as two such
// chains in another order do. One plain TF32 product keeps only 10 bits
// and misses the flash kernels' float32 tolerances.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4; PTX ISA, "Matrix
// Fragments for mma.m16n8k8" with .tf32):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1)
// The reduction index k of one step may be permuted at will, as long as A
// and B agree: a caller can load the pair k = t, t + 4 from any two rows.
//
// Used by the dQ and dK/dV passes of flash_attention.cu and by the four
// contractions of ssd_scan.cu.
#pragma once

#include <stdint.h>

namespace tf32x3 {

// One operand element split in two: its tf32 bits (low 13 bits zero).
struct Split {
  uint32_t hi, lo;
};

// cvt.rna.tf32.f32 (round the magnitude to 10 mantissa bits, ties away
// from zero) as two integer operations: a float32 is sign and magnitude, so
// adding half a tf32 ulp to the bits and clearing the low 13 rounds the
// magnitude, with the carry into the exponent, and infinities stay. It
// gives cvt.rna's bits for every value but NaN (whose lo part, x - hi, is
// NaN, so a NaN still reaches the product); ptxas emits cvt.rna.tf32.f32
// on sm_90a as four instructions, an inf/NaN guard among them.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// d += a b, one TF32 tensor-core product.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// An A fragment (four elements) and a B fragment (two), split.
struct FragA {
  Split x[4];
};
struct FragB {
  Split x[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  return {{split(a0), split(a1), split(a2), split(a3)}};
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  return {{split(b0), split(b1)}};
}

// small += lo(a) hi(b) + hi(a) lo(b); big += hi(a) hi(b). Two accumulators,
// so that consecutive steps of one product do not wait on each other's
// result; the caller adds small into big once, at the end.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const FragA& a, const FragB& b) {
  mma(small, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, b.x[0].hi,
      b.x[1].hi);
  mma(small, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].lo,
      b.x[1].lo);
  mma(big, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].hi, b.x[1].hi);
}

// d += lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), in that order, into one
// accumulator (where the caller has enough independent accumulators).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma3(d, d, a, b);
}

}  // namespace tf32x3
