// fp32-accurate matrix products on Hopper's TF32 tensor cores ("3xTF32"),
// shared by K3 (pruned_matmul.cu), K1 (block_sparse_attention.cu), K2a and
// K2b (block_sparse_attention_bwd.cu).
//
// One TF32 pass keeps 10 of fp32's 23 mantissa bits.  3xTF32 splits each
// fp32 operand x into
//   hi = tf32(x)        (round to nearest, ties away from zero, as
//                        cvt.rna.tf32.f32 does)
//   lo = tf32(x - hi)   (x - hi is exact in fp32)
// so that |x - hi - lo| <= 2^-22 |x|, and accumulates
//   a·b ≈ hi_a·hi_b + (hi_a·lo_b + lo_a·hi_b)
// dropping lo_a·lo_b (2^-22 relative).  Each TF32 product is exact in the
// tensor core, so the products carry fp32-level error at a third of the
// TF32 rate (495 / 3 = 165 TFLOP/s dense on an H100 SXM), 2.5x the fp32
// CUDA-core peak (67).  What is not fp32-level is the tensor core's own
// fp32 accumulation, which truncates: summed over K = 2048 in the
// accumulator it lands 3-7x further from a float64 product than an fp32
// FMA chain (measured on an H100), so K3 sums each 64-deep chunk in the
// tensor cores from zero and adds the chunk sums in fp32 (see there).
// bf16 values are exact in TF32 (7 mantissa bits): a bf16 operand has
// lo = 0 and takes one pass.  The plain model of this arithmetic is
// repro_torch/kernels/tf32x3.py.
//
// The rounding is two integer operations on the bits (add half a TF32
// unit, cut 13 bits): exact for every finite x up to TF32_MAX (0x7f7fefff;
// above it hi rounds to inf) and for inf; a NaN's payload can carry into
// the sign.  So the split takes finite operands only.  For every other x
// (inf, NaN, |x| > TF32_MAX) x - hi is inf or NaN, which the four-argument
// split() folds into `check` with one FMA; K3 sums a tile that saw one
// again in plain fp32.  The attention kernels' operands (q, k, v, dout,
// the probabilities and dS) are finite.
//
// The MMA is mma.sync m16n8k8 (row.col, tf32 in, fp32 accumulate).  Its
// fragments, with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix Fragments
// for mma.m16n8k8" with .tf32):
//   A 16 x 8:  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B 8 x 8:   b0 (k t, n g)  b1 (k t + 4, n g)
//   C 16 x 8:  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// The k order inside one MMA is free as long as A and B agree on it.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (nearest, ties away from zero), for finite x
__device__ __forceinline__ float rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// hi / lo halves of one finite fp32 operand element
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(rna(x - h));
}

// the same, and `check` = NaN when x is inf or NaN or |x| > TF32_MAX
// (then x - hi is inf or NaN; for every other x it is finite)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo,
                                      float& check) {
  const float h = rna(x), r = x - h;
  hi = __float_as_uint(h);
  lo = __float_as_uint(rna(r));
  check = fmaf(r, 0.f, check);
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// SPLIT: fp32 operands (three passes); otherwise bf16-exact values (one).
// `check`, when given, collects split()'s test of every element.
template <bool SPLIT>
__device__ __forceinline__ void make_a(FragA& f, float a0, float a1,
                                       float a2, float a3,
                                       float* check = nullptr) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (SPLIT) {
      if (check)
        split(v[i], f.hi[i], f.lo[i], *check);
      else
        split(v[i], f.hi[i], f.lo[i]);
    } else {
      f.hi[i] = __float_as_uint(v[i]);
      f.lo[i] = 0u;
      if (check) *check = fmaf(v[i], 0.f, *check);
    }
  }
}

template <bool SPLIT>
__device__ __forceinline__ void make_b(FragB& f, float b0, float b1,
                                       float* check = nullptr) {
  if (SPLIT) {
    if (check) {
      split(b0, f.hi[0], f.lo[0], *check);
      split(b1, f.hi[1], f.lo[1], *check);
    } else {
      split(b0, f.hi[0], f.lo[0]);
      split(b1, f.hi[1], f.lo[1]);
    }
  } else {
    if (check) {
      *check = fmaf(b0, 0.f, *check);
      *check = fmaf(b1, 0.f, *check);
    }
    f.hi[0] = __float_as_uint(b0);
    f.hi[1] = __float_as_uint(b1);
    f.lo[0] = f.lo[1] = 0u;
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big += hi_a·hi_b; small += hi_a·lo_b + lo_a·hi_b (the small terms
// first).  Passing one accumulator as both sums everything in it, in
// CUTLASS's order; SPLIT false issues the one hi·hi pass.
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const FragA& a, const FragB& b) {
  if (SPLIT) {
    mma(small, a.hi, b.lo);
    mma(small, a.lo, b.hi);
  }
  mma(big, a.hi, b.hi);
}

// -- cp.async: 16-byte global -> shared copies, zero-filled past `bytes` --
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tf32x3
