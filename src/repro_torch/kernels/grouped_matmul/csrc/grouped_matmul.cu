// Grouped (ragged) expert matmul and its weight gradient — CUDA C++ for
// sm_90a.
//
// K4 replaces the TPU kernel
//   src/repro/kernels/grouped_matmul/grouped_matmul.py::grouped_matmul_p
//   (Pallas body `_gm_kernel`).
// Same function: x [G * cap, K] holds G groups of cap rows each (group g =
// batch row b, physical expert p: g = b * E + p); rows at or past counts[g]
// are dead.  out[g] = x[g] @ w[wmap[g % E]] accumulated in fp32, output in
// x's dtype, dead rows 0.  A row tile whose first row reaches counts[g]
// does no work and writes zeros, as the TPU kernel's `_finish` writes its
// zero accumulator.  Live tiles load dead rows as zeros, so the kernel
// itself enforces "rows past the count are dead", whatever those rows hold.
// counts (and wmap) are read on the device: no host sync per call.
// `wmap` (nullable: identity) is the inverse expert placement (physical
// group -> logical expert): the reference gathers the weights through it
// (`p["ewg"][inv]`, a full copy of every expert's weights per call); here
// the placement is folded into the weight index, the same values with no
// copy.  w is read through its (expert, row, column) strides, so dx
// (grouped_matmul/backward.py: g @ w[e]^T) is a launch of this kernel on
// the transposed view w.transpose(1, 2) — a stride swap, no copy.
//
// K5 replaces
//   src/repro/kernels/grouped_matmul/grouped_matmul.py::grouped_matmul_dw_p
//   (Pallas body `_gm_dw_kernel`).
// dw[e] = sum over batch rows b of x_{b,e}^T @ g_{b,e}, where (b, e) is
// group b * E + gmap[e] (gmap: logical expert -> physical group, nullable:
// identity); dead rows count as zero in x and g.  The TPU kernel carries
// the sum over its sequential innermost grid axis r; blocks here run in no
// order, so one block per (expert, k tile, n tile) loops over every
// (batch row, live 16-row chunk) of its expert itself: the sum stays in
// registers, no atomics, the same bits every run and under every
// placement.  Output fp32 or bf16 (the caller's w dtype), rounded once
// from the fp32 sum.
//
// What bounds both on an H100: operations.  At the training shapes
// (5120 routed rows, K / N = 4096 / 14336) a call does ~0.5 TFLOP on a
// few hundred MB; the path's bf16 or fp32 operands are widened to fp32 and
// multiplied on the CUDA cores (67 TFLOP/s peak), fp32 accumulation as in
// the reference.  Design: K3's register-blocked SGEMM — 256 threads per
// tile, 16-deep chunks staged through shared memory, each thread an
// RM x 8 sub-tile in registers.  K4's row tile is 128 (RM 8), or 16 (RM 1)
// when a group holds at most 16 rows (decode: cap 4, padded to 8), so a
// decode call does not multiply 120 zero rows per live one; the count is
// the semantics (row granularity), the tile is free.  Ragged K / N / cap
// edges are bounds-checked, so the wrapper pads nothing but the reference's
// 8-row group padding.  wgmma, TMA and bf16 tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int BN = 128, BKC = 16, NT = 256;

// row of a (16 * RM)-row tile held by thread row ty in register row i;
// for RM >= 4 two 4-row groups 64 apart, as in K3 (conflict-free reads)
template <int RM>
__device__ __forceinline__ int tile_row(int ty, int i) {
  return RM >= 4 ? (i / 4) * 64 + ty * 4 + (i % 4) : ty * RM + i;
}

__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * 64 + tx * 4 + (j % 4);
}

// K4: one block per (n tile, row tile of a group, group)
template <typename T, int RM>
__global__ void __launch_bounds__(NT) gm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ wmap,
    T* __restrict__ out, int cap, int K, int N, int E, long long se,
    long long sk, long long sn) {
  constexpr int BM = 16 * RM;
  __shared__ float As[BKC][BM + 1];  // x chunk, transposed
  __shared__ float Bs[BKC][BN + 1];  // w chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * BM;  // first row of the tile inside group g
  const int n0 = blockIdx.x * BN;
  const int cnt = min(counts[g], cap);
  const long long base = (long long)g * cap;  // group g's first row

  if (r0 >= cnt) {  // no live row in the tile: zeros, no work
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = r0 + i / BN, c = n0 + i % BN;
      if (r < cap && c < N) out[(base + r) * N + c] = rt_from_f32<T>(0.f);
    }
    return;
  }
  const int e = wmap ? wmap[g % E] : g % E;
  const T* we = w + (long long)e * se;
  const bool wn = sn == 1;  // walk w's unit-stride axis fastest

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKC) {
    for (int i = tid; i < BM * BKC; i += NT) {
      const int r = i / BKC, kk = i % BKC;  // x is row-major: k fastest
      const int gr = r0 + r, gk = k0 + kk;
      As[kk][r] = (gr < cnt && gk < K) ? rt_to_f32(x[(base + gr) * K + gk])
                                       : 0.f;
    }
    for (int i = tid; i < BKC * BN; i += NT) {
      const int kk = wn ? i / BN : i % BKC;
      const int c = wn ? i % BN : i / BKC;
      const int gk = k0 + kk, gn = n0 + c;
      Bs[kk][c] = (gk < K && gn < N) ? rt_to_f32(we[gk * sk + gn * sn])
                                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKC; ++kk) {
      float a[RM], b[8];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][tile_row<RM>(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tile_col(tx, j)];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + tile_row<RM>(ty, i);
    if (r >= cap) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tile_col(tx, j);
      if (c < N) out[(base + r) * N + c] = rt_from_f32<T>(acc[i][j]);
    }
  }
}

// K5: one block per (n tile, k tile, logical expert); the loop over the
// expert's (batch row, live row chunk) pairs is the TPU's grid axis r
template <typename T, typename TO>
__global__ void __launch_bounds__(NT) gm_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ gmap,
    TO* __restrict__ dw, int nb, int cap, int K, int N, int E) {
  constexpr int BM = 128;
  __shared__ float As[BKC][BM + 1];  // x chunk: row (reduction) x k
  __shared__ float Bs[BKC][BN + 1];  // g chunk: row (reduction) x n
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, e = blockIdx.z;
  const int p = gmap ? gmap[e] : e;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int bi = 0; bi < nb; ++bi) {
    const int grp = bi * E + p;
    const int cnt = min(counts[grp], cap);
    const long long base = (long long)grp * cap;
    for (int r0 = 0; r0 < cnt; r0 += BKC) {  // dead chunks are skipped
      for (int i = tid; i < BKC * BM; i += NT) {
        const int rr = i / BM, c = i % BM;  // k fastest: coalesced
        const int gr = r0 + rr, gk = k0 + c;
        As[rr][c] = (gr < cnt && gk < K) ? rt_to_f32(x[(base + gr) * K + gk])
                                         : 0.f;
      }
      for (int i = tid; i < BKC * BN; i += NT) {
        const int rr = i / BN, c = i % BN;
        const int gr = r0 + rr, gn = n0 + c;
        Bs[rr][c] = (gr < cnt && gn < N) ? rt_to_f32(g[(base + gr) * N + gn])
                                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < BKC; ++rr) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[rr][tile_row<8>(ty, i)];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[rr][tile_col(tx, j)];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + tile_row<8>(ty, i);
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tx, j);
      if (n < N) dw[((long long)e * K + k) * N + n] = rt_from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const T* x, const T* w, const int32_t* counts,
                       const int32_t* wmap, T* out, int G, int cap, int K,
                       int N, int E, long long se, long long sk, long long sn,
                       cudaStream_t st) {
  if (cap <= 16) {
    dim3 grid((N + BN - 1) / BN, (cap + 15) / 16, G);
    return rt_launch(gm_kernel<T, 1>, grid, dim3(NT), 0, st, x, w, counts,
                     wmap, out, cap, K, N, E, se, sk, sn);
  }
  dim3 grid((N + BN - 1) / BN, (cap + 127) / 128, G);
  return rt_launch(gm_kernel<T, 8>, grid, dim3(NT), 0, st, x, w, counts,
                   wmap, out, cap, K, N, E, se, sk, sn);
}

template <typename T, typename TO>
cudaError_t launch_dw(const T* x, const T* g, const int32_t* counts,
                      const int32_t* gmap, TO* dw, int G, int cap, int K,
                      int N, int E, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (K + 127) / 128, E);
  return rt_launch(gm_dw_kernel<T, TO>, grid, dim3(NT), 0, st, x, g, counts,
                   gmap, dw, G / E, cap, K, N, E);
}

}  // namespace

// K4.  x [G * cap, K] and out [G * cap, N] row-major (one dtype); w
// addressed as w[e * se + k * sk + n * sn] (any strides); counts int32
// [G]; wmap int32 [E] or null (identity).  G must be a multiple of E.
extern "C" int gm_fwd(const void* x, const void* w, const void* counts,
                      const void* wmap, void* out, int G, int cap, int K,
                      int N, int E, long long se, long long sk, long long sn,
                      int dtype, void* stream) {
  if (E <= 0 || G % E != 0 || cap < 0 || K < 0 || N < 0)
    return cudaErrorInvalidValue;
  if (G == 0 || cap == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return launch_fwd((const float*)x, (const float*)w,
                      (const int32_t*)counts, (const int32_t*)wmap,
                      (float*)out, G, cap, K, N, E, se, sk, sn, st);
  if (dtype == RT_BF16)
    return launch_fwd((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                      (const int32_t*)counts, (const int32_t*)wmap,
                      (__nv_bfloat16*)out, G, cap, K, N, E, se, sk, sn, st);
  return cudaErrorInvalidValue;
}

// K5.  x [G * cap, K] and g [G * cap, N] row-major (one dtype), counts
// int32 [G], gmap int32 [E] or null (identity); dw [E, K, N] row-major in
// out_dtype (fp32 or bf16).
extern "C" int gm_dw(const void* x, const void* g, const void* counts,
                     const void* gmap, void* dw, int G, int cap, int K, int N,
                     int E, int dtype, int out_dtype, void* stream) {
  if (E <= 0 || G % E != 0 || cap < 0 || K < 0 || N < 0)
    return cudaErrorInvalidValue;
  if (K == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)counts;
  const int32_t* m = (const int32_t*)gmap;
  if (dtype == RT_F32 && out_dtype == RT_F32)
    return launch_dw((const float*)x, (const float*)g, c, m, (float*)dw, G,
                     cap, K, N, E, st);
  if (dtype == RT_F32 && out_dtype == RT_BF16)
    return launch_dw((const float*)x, (const float*)g, c, m,
                     (__nv_bfloat16*)dw, G, cap, K, N, E, st);
  if (dtype == RT_BF16 && out_dtype == RT_F32)
    return launch_dw((const __nv_bfloat16*)x, (const __nv_bfloat16*)g, c, m,
                     (float*)dw, G, cap, K, N, E, st);
  if (dtype == RT_BF16 && out_dtype == RT_BF16)
    return launch_dw((const __nv_bfloat16*)x, (const __nv_bfloat16*)g, c, m,
                     (__nv_bfloat16*)dw, G, cap, K, N, E, st);
  return cudaErrorInvalidValue;
}
