// Block-pruned matmul — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/pruned_matmul/pruned_matmul.py::pruned_matmul_p
//   (Pallas bodies `_kernel_mask_n`, `_kernel_mask_k`), and its backward
//   use in src/repro/kernels/pruned_matmul/backward.py::pruned_matmul_bwd_p.
// Same function: out[M, N] = x[M, K] @ w[K, N] accumulated in fp32 under a
// 0/1 block mask.  mask_axis "n" (mask [N / mblk]): pruned output columns
// are zero and a wholly pruned output tile does no work.  mask_axis "k"
// (mask [K / mblk]): pruned reduction blocks are not accumulated.  The mask
// block (PRUNE_BLOCK = 128 on the main path) is the semantics; the CUDA
// tile is free.  Every operand is read, and the output written, through a
// (row, column) stride pair, so the backward's four products (g·wᵀ, xᵀ·g,
// and (gᵀ·x)ᵀ for a mask over K) are launches on transposed views — a
// stride swap, no copy.
//
// What bounds it on an H100: operations.  The SwiGLU projections (M 2048
// to 4096 rows, K and N 960 or 2560) do hundreds of FLOPs per byte, and
// the training path is fp32: 0.30 ms for the 20.1 GFLOP of one forward on
// the fp32 CUDA cores (67 TFLOP/s).  One TF32 tensor-core pass would keep
// only 10 mantissa bits; 3xTF32 (tf32x3.cuh) keeps fp32-level products at
// a third of the TF32 rate, 165 TFLOP/s, a 0.12 ms bound for the same
// work.
//
// Two variants, chosen per call by ops.pm_variant from shapes and strides:
//   pm_fwd_tc — the tensor-core variant.  A 128 x 128 output tile per
//     block of 8 warps, each warp 64 x 32 as 4 x 4 mma.sync m16n8k8 TF32
//     tiles, three MMAs per tile (hi·lo, lo·hi, hi·hi), one for bf16.
//     - Operands: a 3-stage ring of 64-deep k chunks filled by cp.async
//       (16-byte pieces along each operand's unit-stride axis, zero-filled
//       past the ragged edge), two chunks in flight while the MMAs run.
//       Each tile is stored as it lies in memory, K-major ([rows][k]) or
//       MN-major ([k][rows]), with pitches that keep the fragment reads
//       free of bank conflicts; mma.sync reads either, which wgmma's tf32
//       form (both operands K-major) would not: the forward's w and both
//       operands of dw are MN-major.  An MMA's k slots t and t + 4 take
//       the physical k 2t and 2t + 1, so a K-major fragment pair is one
//       load; an M-major A tile gives the MMA's rows g and g + 8 the tile
//       rows 2g and 2g + 1 (undone in the epilogue), one load again.
//       Each element is split into hi and lo in registers as it is read
//       (two integer operations per rounding); splitting each chunk once
//       into a (hi, lo) copy in shared memory ran slower on the H100
//       (0.62 against 0.40 ms at the forward's shape).
//     - Sums: the tensor core's fp32 accumulation truncates, so a K-long
//       sum in the accumulator lands 3-7x further from float64 than
//       torch.matmul's fp32 (measured on the H100).  Each chunk therefore
//       accumulates from zero in the tensor cores and is added to the
//       running sum in fp32 (round to nearest): K3 lands 4-5x closer to
//       float64 than torch.matmul at the main shapes.
//     - Mask: per chunk or per tile.  The chunk (64) divides the mask
//       block, so a chunk is wholly live or dead and dead chunks are never
//       loaded; the n tile (128) divides it, so a dead tile writes zeros
//       and stops.  No per-element lookup.
//     - Non-finite operands: the split carries finite values up to
//       TF32_MAX (tf32x3.cuh).  A tile that reads anything else is summed
//       again in plain fp32, so inf and NaN come out as fp32 gives them.
//     - Grid: one tile a SM (the registers of two-level sums).  A grid
//       whose last wave would be mostly idle is cut along K
//       (ops.pm_splits: dw of the backward, 160 tiles on 132 SMs, into 4):
//       each range sums into an fp32 slice and pm_sum_kernel adds the
//       slices in order — deterministic, no atomics.
//     - Epilogue: through the output's strides, staged through shared
//       memory when the output is a transposed view (the mask-k
//       backward's dw.T), so stores run along the unit-stride axis.
//   pm_fwd — the SIMT kernel kept for what the tensor-core variant does
//     not take: a mask block that is not a multiple of its chunk or tile
//     (48, 64), and strides cp.async cannot read (no unit-stride axis, a
//     pitch off 16 bytes).  One block of 256 threads per 128 x 128 tile,
//     16-deep k chunks, an 8 x 8 register sub-tile per thread, per-element
//     mask lookups.
#include "common.cuh"
#include "tf32x3.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core variant (3xTF32 mma.sync on a cp.async ring)
// ---------------------------------------------------------------------------
constexpr int TBM = 128, TBN = 128, TBK = 64, TNT = 256, STAGES = 3;
constexpr int WM = 4, WN = 4;  // m16 x n8 MMA tiles of a warp (64 x 32)
constexpr int CLD = TBM + 4;   // pitch of the staged transposed output

// The ring's tiles keep each operand as it lies in memory: K-major
// ([rows][k], pitch 72) or MN-major ([k][rows], pitch 132 fp32 / 136
// bf16, rows 16-byte aligned).  An MMA's k slots t and t + 4 take the
// physical k 2t and 2t + 1 (for A and B alike), so a K-major fragment
// pair is one 8-byte (fp32) or 4-byte (bf16) load; with these pitches
// every fragment read is free of bank conflicts.
template <typename T>
struct TcLayout {
  static constexpr int VEC = 16 / sizeof(T);  // elements in one cp.async
  static constexpr int LDK = TBK + 8;
  static constexpr int LDM = TBM + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int TILE = TBM * LDK > TBK * LDM ? TBM * LDK : TBK * LDM;
  static constexpr size_t RING = sizeof(T) * 2 * TILE * STAGES;
  // the transposed-output epilogue reuses the ring as [TBN][CLD] floats
  static constexpr size_t SMEM =
      RING > sizeof(float) * TBN * CLD ? RING : sizeof(float) * TBN * CLD;
};

// Copy one [ROWS][COLS] tile (COLS the unit-stride axis) of an operand
// whose element (o, i) lies at g[o * ostride + i], rows [o0, o0 + ROWS)
// and columns [i0, i0 + COLS), zero past (on, in), into smem at pitch LD.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
                                          long long ostride, int o0, int on,
                                          int i0, int in) {
  constexpr int VEC = TcLayout<T>::VEC, PER_ROW = COLS / VEC;
  static_assert(ROWS * PER_ROW % TNT == 0, "whole pieces per thread");
#pragma unroll
  for (int q = 0; q < ROWS * PER_ROW / TNT; ++q) {
    const int p = threadIdx.x + q * TNT;
    const int r = p / PER_ROW, c = (p % PER_ROW) * VEC;
    const int o = o0 + r, i = i0 + c;
    const int n = (o < on) ? min(max(in - i, 0), VEC) : 0;
    const T* src = n > 0 ? g + (long long)o * ostride + i : g;
    tf32x3::cp_async16(sm + r * LD + c, src, n * (int)sizeof(T));
  }
}

// A_KM: x tile stored K-major (x's k axis has unit stride), else M-major;
// B_KM: w tile stored K-major (w's k axis has unit stride), else N-major.
// 8 warps, each a 64 x 32 block of the 128 x 128 output tile.
template <typename T, bool A_KM, bool B_KM>
__global__ void __launch_bounds__(TNT, 1) pm_tc_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ mask, T* __restrict__ out, int M, int K,
    int N, int mask_n, int mblk, long long xr, long long xc, long long wr,
    long long wc, long long orow, long long ocol, long long zstride) {
  using L = TcLayout<T>;
  constexpr bool SPLIT = sizeof(T) == 4;  // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const bool out_t = orow == 1 && ocol != 1;  // a transposed output view
  // split over K: block z sums chunks [c_begin, c_end) into slice z
  const int nch = (K + TBK - 1) / TBK, z = blockIdx.z;
  const int c_begin = z * nch / gridDim.z, c_end = (z + 1) * nch / gridDim.z;
  out += z * zstride;

  if (mask_n && mask[n0 / mblk] <= 0) {  // the tile lies in one dead block
    const int rows = min(TBM, M - m0), cols = min(TBN, N - n0);
    for (int i = tid; i < rows * cols; i += TNT) {
      const int r = out_t ? i % rows : i / cols;
      const int c = out_t ? i / rows : i % cols;
      out[(m0 + r) * orow + (n0 + c) * ocol] = rt_from_f32<T>(0.f);
    }
    return;
  }
  auto next_live = [&](int c) {
    if (!mask_n)
      while (c < c_end && mask[(c * TBK) / mblk] <= 0) ++c;
    return c;
  };
  auto load = [&](int stage, int c) {
    T* as = sm + stage * 2 * L::TILE;
    T* bs = as + L::TILE;
    const int k0 = c * TBK;
    if (A_KM)
      load_tile<T, TBM, TBK, L::LDK>(as, x, xr, m0, M, k0, K);
    else
      load_tile<T, TBK, TBM, L::LDM>(as, x, xc, k0, K, m0, M);
    if (B_KM)
      load_tile<T, TBN, TBK, L::LDK>(bs, w, wc, n0, N, k0, K);
    else
      load_tile<T, TBK, TBN, L::LDM>(bs, w, wr, k0, K, n0, N);
  };
  // Two-level sums: each 32-deep chunk accumulates in the tensor cores
  // from zero (`part`), then adds into `acc` in fp32 (round to nearest),
  // so the tensor core's truncating adds act on chunk sums only.
  float acc[WM][WN][4], part[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // `check` turns NaN once an element the split cannot carry (inf, NaN,
  // or so close to FLT_MAX that hi rounds to inf) is read: x - hi is then
  // inf or NaN, and it is finite for every other element
  float check = 0.f;

  int c_load = next_live(c_begin);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (c_load < c_end) {
      load(s, c_load);
      c_load = next_live(c_load + 1);
    }
    tf32x3::cp_async_commit();
  }
  int it = 0;
  for (int c = next_live(c_begin); c < c_end; c = next_live(c + 1), ++it) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk `it` visible; stage it - 1 free for reuse
    if (c_load < c_end) {
      load((it + STAGES - 1) % STAGES, c_load);
      c_load = next_live(c_load + 1);
    }
    tf32x3::cp_async_commit();
    const T* as = sm + (it % STAGES) * 2 * L::TILE;
    const T* bs = as + L::TILE;
    // the elements at physical k and k + 1 of row m (A) / column n (B)
    auto pair = [&](const T* tile, bool kmajor, int r, int k) {
      float2 v;
      if (kmajor)
        v = rt_to_f32x2(tile + r * L::LDK + k);
      else
        v = make_float2(rt_to_f32(tile[k * L::LDM + r]),
                        rt_to_f32(tile[(k + 1) * L::LDM + r]));
      return v;
    };
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 8) {
      tf32x3::FragB fb[WN];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const float2 b = pair(bs, B_KM, wn + j * 8 + g, kk + 2 * t);
        tf32x3::make_b<SPLIT>(fb[j], b.x, b.y, &check);
      }
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        tf32x3::FragA fa;
        if (A_KM) {  // rows g and g + 8, each a (2t, 2t + 1) pair
          const int m = wm + i * 16 + g;
          const float2 a0 = pair(as, true, m, kk + 2 * t);
          const float2 a1 = pair(as, true, m + 8, kk + 2 * t);
          tf32x3::make_a<SPLIT>(fa, a0.x, a1.x, a0.y, a1.y, &check);
        } else {  // M-major: the MMA's rows g, g + 8 are rows 2g, 2g + 1
          const int m = wm + i * 16 + 2 * g, k = kk + 2 * t;
          const float2 p0 = rt_to_f32x2(as + k * L::LDM + m);
          const float2 p1 = rt_to_f32x2(as + (k + 1) * L::LDM + m);
          tf32x3::make_a<SPLIT>(fa, p0.x, p0.y, p1.x, p1.y, &check);
        }
#pragma unroll
        for (int j = 0; j < WN; ++j)
          tf32x3::mma3<SPLIT>(part[i][j], part[i][j], fa, fb[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  tf32x3::cp_async_wait<0>();
  // the tile row of accumulator element e (rows g, g + 8 of the MMA)
  auto row = [&](int e) {
    return A_KM ? g + (e >= 2 ? 8 : 0) : 2 * g + (e >= 2 ? 1 : 0);
  };

  // An operand of this tile held an element the split cannot carry: the
  // whole tile is summed again in plain fp32, so inf and NaN come out as
  // fp32 gives them (a slow path; finite inputs never take it).
  if (__syncthreads_or(!(check == 0.f))) {
#pragma unroll 1
    for (int i = tid; i < TBM * TBN; i += TNT) {
      const int m = m0 + (out_t ? i % TBM : i / TBN);
      const int n = n0 + (out_t ? i / TBM : i % TBN);
      if (m >= M || n >= N) continue;
      float sum = 0.f;
#pragma unroll 1
      for (int k = c_begin * TBK; k < min(c_end * TBK, K); ++k)
        if (mask_n || mask[k / mblk] > 0)
          sum = fmaf(rt_to_f32(x[m * xr + k * xc]),
                     rt_to_f32(w[k * wr + n * wc]), sum);
      out[m * orow + n * ocol] = rt_from_f32<T>(sum);
    }
    return;
  }
  if (out_t) {  // stage [n][m] and store along m, the unit-stride axis
    float* cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wm + i * 16 + row(e);
          const int n = wn + j * 8 + 2 * t + (e & 1);
          cs[n * CLD + m] = acc[i][j][e];
        }
    __syncthreads();
    const int rows = min(TBM, M - m0), cols = min(TBN, N - n0);
    for (int i = tid; i < TBM * TBN; i += TNT) {
      const int n = i / TBM, m = i % TBM;
      if (m < rows && n < cols)
        out[(m0 + m) + (long long)(n0 + n) * ocol] =
            rt_from_f32<T>(cs[n * CLD + m]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + row(e);
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N)
          out[m * orow + n * ocol] = rt_from_f32<T>(acc[i][j][e]);
      }
}

// out[m * orow + n * ocol] = the sum over z of part[z][m][n] (part laid
// out [N][M] when out's m axis has unit stride), in z order
template <typename T>
__global__ void __launch_bounds__(256) pm_sum_kernel(
    const float* __restrict__ part, int splits, T* __restrict__ out, int M,
    int N, long long orow, long long ocol) {
  const bool out_t = orow == 1 && ocol != 1;
  const long long MN = (long long)M * N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < MN;
       i += 256LL * gridDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[z * MN + i];
    const long long a = i / (out_t ? M : N), b = i % (out_t ? M : N);
    out[out_t ? b + a * ocol : a * orow + b * ocol] = rt_from_f32<T>(sum);
  }
}

// `splits` > 1 (fp32 only): the K axis is cut into that many ranges of
// chunks, each summed into its own fp32 slice of `part` (splits x M x N),
// and a second kernel adds the slices in order into out
template <typename T>
cudaError_t launch_tc(const T* x, const T* w, const int32_t* mask, T* out,
                      int M, int K, int N, int mask_n, int mblk,
                      long long xr, long long xc, long long wr, long long wc,
                      long long orow, long long ocol, float* part,
                      int splits, cudaStream_t st) {
  constexpr int VEC = TcLayout<T>::VEC;
  constexpr size_t smem = TcLayout<T>::SMEM;
  if (mask_n ? mblk % TBN : mblk % TBK) return cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)w % 16) return cudaErrorInvalidValue;
  const bool a_km = xc == 1 && xr % VEC == 0;
  const bool a_mm = !a_km && xr == 1 && xc % VEC == 0;
  const bool b_nm = wc == 1 && wr % VEC == 0;
  const bool b_km = !b_nm && wr == 1 && wc % VEC == 0;
  if (!(a_km || a_mm) || !(b_nm || b_km)) return cudaErrorInvalidValue;
  if (splits < 1 || (splits > 1 && (sizeof(T) != 4 || part == nullptr)))
    return cudaErrorInvalidValue;
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, splits);
  const bool out_t = orow == 1 && ocol != 1;
  T* dst = splits > 1 ? reinterpret_cast<T*>(part) : out;
  const long long drow = splits > 1 ? (out_t ? 1 : N) : orow;
  const long long dcol = splits > 1 ? (out_t ? M : 1) : ocol;
  const long long zstride = (long long)M * N;
  cudaError_t e;
#define PM_TC(AK, BK)                                                       \
  e = rt_launch(pm_tc_kernel<T, AK, BK>, grid, dim3(TNT), smem, st, x, w,  \
                mask, dst, M, K, N, mask_n, mblk, xr, xc, wr, wc, drow,    \
                dcol, zstride)
  if (a_km && b_km)
    PM_TC(true, true);
  else if (a_km)
    PM_TC(true, false);
  else if (b_km)
    PM_TC(false, true);
  else
    PM_TC(false, false);
#undef PM_TC
  if (e != cudaSuccess || splits == 1) return e;
  return rt_launch(pm_sum_kernel<T>, dim3(4 * 132), dim3(256), 0, st, part,
                   splits, out, M, N, orow, ocol);
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

// The tensor-core variant: the same arguments and function as pm_fwd, for
// a mask block that is a multiple of 128 (mask over N) or 64 (over K), x
// and w 16-byte aligned, each with a unit-stride axis and the other pitch
// a multiple of 16 bytes (ops.pm_variant); anything else is refused.
// `splits` cuts K into that many ranges (ops.pm_splits; fp32 only), their
// sums kept in `part` (fp32, splits x M x N) and added in order.
extern "C" int pm_fwd_tc(const void* x, const void* w, const void* mask,
                         void* out, int M, int K, int N, int mask_n,
                         int mblk, long long xr, long long xc, long long wr,
                         long long wc, long long orow, long long ocol,
                         void* part, int splits, int dtype, void* stream) {
  if (mblk <= 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return launch_tc((const float*)x, (const float*)w, (const int32_t*)mask,
                     (float*)out, M, K, N, mask_n, mblk, xr, xc, wr, wc,
                     orow, ocol, (float*)part, splits, st);
  if (dtype == RT_BF16)
    return launch_tc((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                     (const int32_t*)mask, (__nv_bfloat16*)out, M, K, N,
                     mask_n, mblk, xr, xc, wr, wc, orow, ocol, nullptr,
                     splits, st);
  return cudaErrorInvalidValue;
}
