// Shared-memory tiles of the block-sparse attention kernels on the TF32
// tensor cores, SHARED by the forward (K1, block_sparse_attention.cu) and
// both backward sweeps (K2a dq, K2b dk/dv, block_sparse_attention_bwd.cu),
// and the two products K1 and K2a are built from: S = A·Bᵀ over d
// (qk_tile) and P·B over a kv tile (pv_tile), with their order of
// accumulation.
//
// A tile holds 64 rows of a [rows][D] operand (q, k, v or dout) as fp32,
// row pitch max(D, 32) floats, with the 16-byte pieces of row r stored
// XOR-swizzled by (r & 7).  An mma.sync m16n8k8 fragment (g = lane / 4,
// t = lane % 4) reads a tile in two ways, both free of bank conflicts:
//   K-major    rows g (+ 8 j), columns kk + t and kk + t + 4: the operand
//              whose d is the MMA's k (Q, dO as A; K, V as B of S, dP);
//   row pairs  rows 2t, 2t + 1 (+ 8 j), column g (+ 8 n): the operand
//              whose kv or q rows are the MMA's k (V of P·V, K of dS·K,
//              Q and dO of K2b's dK, dV).
#pragma once

#include "common.cuh"
#include "tf32x3.cuh"

namespace bsa {

constexpr int TILE_ROWS = 64;

template <int D>
struct Tile {
  static constexpr int LD = D < 32 ? 32 : D;  // row pitch, floats
  static constexpr int FLOATS = TILE_ROWS * LD;
};

// float offset of element (r, c) in a swizzled tile: 16-byte piece
// (c / 4) of row r is stored at piece (c / 4) ^ (r & 7)
template <int LD>
__device__ __forceinline__ int sw(int r, int c) {
  return r * LD + (c ^ ((r & 7) << 2));
}

// rows [r0, r0 + 64) of a [rows][D] operand (row pitch `row` elements,
// rows at or past `n` zero) into a swizzled fp32 tile by the block's NT
// threads; fp32 through cp.async (16-byte aligned rows; the caller commits
// and waits), bf16 converted through registers
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* sm, const T* __restrict__ g,
                                          long long row, int r0, int n) {
  constexpr int LD = Tile<D>::LD, PIECES = TILE_ROWS * D / 4;
  static_assert(PIECES % NT == 0, "whole pieces per thread");
#pragma unroll
  for (int j = 0; j < PIECES / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < n;
    const T* src = g + (ok ? (long long)(r0 + r) * row + c : 0);
    float* dst = sm + sw<LD>(r, c);
    if constexpr (sizeof(T) == 4) {
      tf32x3::cp_async16(dst, src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = ok ? rt_to_f32(src[e]) : 0.f;
    }
  }
}

// S (16 x 64 a warp) = A·Bᵀ over d, A's fragments from `a_frag(f, kk)`
// (rows g, g + 8 of the warp's 16, columns kk + t, kk + t + 4), B's 64
// rows from a swizzled tile (K-major reads): each 64-deep chunk of d summed
// from zero in the tensor cores with the hi·hi pass and the two small
// passes in separate accumulators (the tensor core truncates every add to
// the running sum, so a small term added to the large sum loses up to a
// unit in its last place), the two and the chunks added in fp32
template <bool SPLIT, int D, typename AFrag>
__device__ __forceinline__ void qk_tile(float (&out)[8][4], AFrag a_frag,
                                        const float* B, int g, int t) {
  constexpr int LD = Tile<D>::LD, KC = D < 64 ? D : 64;
#pragma unroll
  for (int c = 0; c < D; c += KC) {
    float big[8][4], small[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < KC / 8; ++i) {
      const int kk = c + 8 * i;
      tf32x3::FragA a;
      a_frag(a, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tf32x3::FragB b;
        const int br = j * 8 + g;
        tf32x3::make_b<SPLIT>(b, B[sw<LD>(br, kk + t)],
                              B[sw<LD>(br, kk + t + 4)]);
        tf32x3::mma3<SPLIT>(big[j], small[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float part = big[j][e] + small[j][e];
        out[j][e] = c == 0 ? part : out[j][e] + part;
      }
  }
}

// the A fragment at d = kk of rows r, r + 8 of a swizzled tile
template <bool SPLIT, int D>
__device__ __forceinline__ void tile_frag(tf32x3::FragA& f, const float* A,
                                          int r, int kk, int t) {
  constexpr int LD = Tile<D>::LD;
  tf32x3::make_a<SPLIT>(f, A[sw<LD>(r, kk + t)], A[sw<LD>(r + 8, kk + t)],
                        A[sw<LD>(r, kk + t + 4)],
                        A[sw<LD>(r + 8, kk + t + 4)]);
}

// out (16 x D a warp) = P·B summed from zero over the 64 rows of a
// swizzled tile B (row-pair reads), P the 16 x 64 accumulator fragments of
// an S-shaped product: the accumulator's columns (2t, 2t + 1) of block j
// are the MMA's k slots (t, t + 4), so P never touches shared memory; P is
// always split (fp32 values), B when SPLIT
template <bool SPLIT, int D>
__device__ __forceinline__ void pv_tile(float (&out)[D / 8][4],
                                        const float (&p)[8][4],
                                        const float* B, int g, int t) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    tf32x3::FragA a;
    tf32x3::make_a<true>(a, p[j][0], p[j][2], p[j][1], p[j][3]);
    const int br = j * 8 + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      tf32x3::FragB b;
      const int dc = n * 8 + g;
      tf32x3::make_b<SPLIT>(b, B[sw<LD>(br, dc)], B[sw<LD>(br + 1, dc)]);
      tf32x3::mma3<true>(out[n], out[n], a, b);
    }
  }
}

// two consecutive outputs of one row (8-byte aligned fp32, 4-byte bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace bsa
