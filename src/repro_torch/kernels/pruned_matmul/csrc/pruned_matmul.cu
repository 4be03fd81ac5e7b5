// Block-pruned matmul — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/pruned_matmul/pruned_matmul.py::pruned_matmul_p
//   (Pallas bodies `_kernel_mask_n`, `_kernel_mask_k`).
// Same function: out[M, N] = x[M, K] @ w[K, N] accumulated in fp32 under a
// 0/1 block mask.  mask_axis "n" (mask [N / mblk]): an output tile whose
// column blocks are all pruned does no work and is written as zeros, and
// pruned columns of a live tile are zeroed.  mask_axis "k" (mask
// [K / mblk]): pruned reduction blocks are not accumulated — a 16-deep k
// chunk whose blocks are all pruned is skipped, and inside a partly live
// chunk the pruned rows enter as zeros.  The mask block (PRUNE_BLOCK = 128 on
// the main path) is the semantics; the 128 x 128 CUDA tile is free.
//
// What bounds it on an H100: operations.  The SwiGLU projections at prefill
// (M = 4096 rows, K = 960 or 2560) do hundreds of FMAs per byte; they run in
// fp32 on the CUDA cores (67 TFLOP/s peak) because the path's activations
// and weights are fp32 and TF32 would break the reference's tolerance.
// Design: a classic register-blocked SGEMM — one block of 256 threads per
// 128 x 128 output tile, 16-deep k chunks staged through shared memory,
// each thread an 8 x 8 sub-tile (two 4-wide row and column groups 64 apart,
// so its shared loads are conflict-free), fp32 accumulators in registers.
// Ragged M / N / K edges are bounds-checked in the loads and stores, so the
// wrapper pads nothing (the TPU wrapper pads K = 960 to 1024).
// Every operand is read, and the output written, through a (row, column)
// stride pair, so the backward's four products (src/repro/kernels/
// pruned_matmul/backward.py::pruned_matmul_bwd_p: g·wᵀ and xᵀ·g, and
// (gᵀ·x)ᵀ for a mask over K) are launches of this same kernel on transposed
// views — a stride swap, no copy; each load loop walks the operand's
// unit-stride axis fastest, so global reads stay coalesced either way.
// When x, w and out are all contiguous (the forward) a second
// instantiation addresses them through K and N alone, as the forward-only
// kernel did: the strided kernel ran the forward at 1.10 ms against 0.79
// (M 4096, K 960, N 2560; PERF.md).
// Double buffering, wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BKC = 16, NT = 256;

// GEN: operands and output addressed through their strides; otherwise all
// three are contiguous and only K and N address them
template <typename T, bool GEN>
__global__ void __launch_bounds__(NT) pm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ mask, T* __restrict__ out, int M, int K,
    int N, int mask_n, int mblk, long long xr, long long xc, long long wr,
    long long wc, long long orow, long long ocol) {
  __shared__ float As[BKC][BM + 1];  // x tile, transposed (padded rows)
  // GEN pads rows by 1 so a transposed w's column-wise stores hit 16
  // banks (a pad of 4 ran the backward products slower; PERF.md)
  __shared__ __align__(16) float Bs[BKC][GEN ? BN + 1 : BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (mask_n) {
    const int n_last = min(n0 + BN, N) - 1;
    bool live = false;
    for (int j = n0 / mblk; j <= n_last / mblk && !live; ++j)
      live = mask[j] > 0;
    if (!live) {  // a fully pruned output tile: zeros, no work
      for (int i = tid; i < BM * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        if (m0 + r < M && n0 + c < N)
          out[GEN ? (m0 + r) * orow + (n0 + c) * ocol
                  : (long long)(m0 + r) * N + n0 + c] = rt_from_f32<T>(0.f);
      }
      return;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKC) {
    if (!mask_n) {  // uniform over the block
      const int k_last = min(k0 + BKC, K) - 1;
      bool live = false;
      for (int j = k0 / mblk; j <= k_last / mblk && !live; ++j)
        live = mask[j] > 0;
      if (!live) continue;
    }
    for (int i = tid; i < BM * BKC; i += NT) {
      // walk x's unit-stride axis fastest (k for x, m for a transposed x)
      const bool xk = !GEN || xc == 1;
      const int r = xk ? i / BKC : i % BM;
      const int kk = xk ? i % BKC : i / BM;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K && (mask_n || mask[gk / mblk] > 0);
      As[kk][r] = ok ? rt_to_f32(x[GEN ? gm * xr + gk * xc
                                       : (long long)gm * K + gk])
                     : 0.f;
    }
    for (int i = tid; i < BKC * BN; i += NT) {
      const bool wn = !GEN || wc == 1;
      const int kk = wn ? i / BN : i % BKC;
      const int c = wn ? i % BN : i / BKC;
      const int gk = k0 + kk, gn = n0 + c;
      const bool ok = gk < K && gn < N && (mask_n || mask[gk / mblk] > 0);
      Bs[kk][c] = ok ? rt_to_f32(w[GEN ? gk * wr + gn * wc
                                       : (long long)gk * N + gn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKC; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        a[i + 4] = As[kk][64 + ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
        b[i + 4] = Bs[kk][64 + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn >= N) continue;
      float val = acc[i][j];
      if (mask_n && mask[gn / mblk] <= 0) val = 0.f;
      out[GEN ? gm * orow + gn * ocol : (long long)gm * N + gn] =
          rt_from_f32<T>(val);
    }
  }
}

// the contiguous instantiation when every operand is contiguous
template <typename T>
cudaError_t launch_layout(const T* x, const T* w, const int32_t* mask,
                          T* out, int M, int K, int N, int mask_n, int mblk,
                          long long xr, long long xc, long long wr,
                          long long wc, long long orow, long long ocol,
                          dim3 grid, cudaStream_t st) {
  const bool contiguous = xc == 1 && xr == K && wc == 1 && wr == N &&
                          ocol == 1 && orow == N;
  if (contiguous)
    return rt_launch(pm_kernel<T, false>, grid, dim3(NT), 0, st, x, w,
                     mask, out, M, K, N, mask_n, mblk, xr, xc, wr, wc, orow,
                     ocol);
  return rt_launch(pm_kernel<T, true>, grid, dim3(NT), 0, st, x, w, mask,
                   out, M, K, N, mask_n, mblk, xr, xc, wr, wc, orow, ocol);
}

}  // namespace

// x [M, K], w [K, N], out [M, N] (one dtype), each addressed through its
// (row, column) element strides: x[m * xr + k * xc], w[k * wr + n * wc],
// out[m * orow + n * ocol]; mask int32 over N / mblk column blocks
// (mask_n = 1) or K / mblk reduction blocks (0).
extern "C" int pm_fwd(const void* x, const void* w, const void* mask,
                      void* out, int M, int K, int N, int mask_n, int mblk,
                      long long xr, long long xc, long long wr, long long wc,
                      long long orow, long long ocol, int dtype,
                      void* stream) {
  if (mblk <= 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return launch_layout((const float*)x, (const float*)w,
                         (const int32_t*)mask, (float*)out, M, K, N, mask_n,
                         mblk, xr, xc, wr, wc, orow, ocol, grid, st);
  if (dtype == RT_BF16)
    return launch_layout((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                         (const int32_t*)mask, (__nv_bfloat16*)out, M, K, N,
                         mask_n, mblk, xr, xc, wr, wc, orow, ocol, grid, st);
  return cudaErrorInvalidValue;
}
