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
// 8-row group padding.  These SIMT kernels serve the fp32 calls, the decode
// tile and odd strides; bf16 calls go to the tensor-core variant at the end
// of this file (ops.gm_variant decides).
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

// ===========================================================================
// Tensor-core variant (bf16 operands, cap > 16, K and N multiples of 8; the
// dispatch is ops.gm_variant).  Same functions as gm_kernel / gm_dw_kernel
// above, on Hopper's warpgroup MMA (hopper.cuh): fp32 accumulators, one
// rounding to the output type.
//
// One CTA = a 128 x 256 output tile: two consumer warpgroups (64 rows each,
// m64n256k16 MMAs, 128 fp32 accumulators a thread) and one producer warp
// whose lane 0 keeps a ring of 4 shared-memory stages filled by TMA; a
// stage holds a BK = 64 deep slice of both operands (64 bf16 = 128 bytes:
// the 128-byte swizzle), 48 KB.  A full barrier per stage counts
// the TMA bytes, an empty barrier the 8 consumer warps that have finished
// reading it.  The consumers keep one stage's MMAs in flight while the next
// is issued (wait_group 1) and release a stage when its MMAs are done.
//
// K4 (gm_tc_kernel): A = x rows through a 3-D tensor map [G, cap, K] (box
// {64, 128, 1}): a tile never reads the next group's rows, TMA fills rows
// past cap and columns past K with zeros, and rows in [count, cap) (which
// may hold anything) only reach their own output rows, which the epilogue
// writes as 0.  B = w[wmap[p]] through a tensor map built from w's strides:
// N-contiguous (the forward, w [E, K, N]: MN-major B, boxes {64 n, 64 k})
// or K-contiguous (dx, the view w.transpose(1, 2): K-major B, box {64 k,
// BN n}); the expert index read on the device is the map's third
// coordinate, so a placement copies no weights.  Grid: (batch row x row
// tile) fastest, then the n tile, then the physical group, so the CTAs in
// flight share one expert's weight columns (read about once from device
// memory) and its few row tiles (kept in L2).  A row tile at or past
// counts[g] writes zeros and loads nothing.
//
// K5 (gm_dw_tc_kernel): one CTA per (n tile, k tile, expert) walks the
// expert's (batch row, live 64-row chunk) pairs in order, the sum in the
// accumulators: no atomics, the same bits every run and under every
// placement.  A = x^T (the x tile [64 rows][k] is M-major: transpose bit),
// B = g (N-contiguous: MN-major).  The reduction runs over rows, so dead
// rows of a group's last chunk are zeroed in shared memory (both tiles)
// before the MMAs read them.
//
// Bound on an H100: operations at the train shapes (K4 481 GFLOP over
// ~0.2 GB: 0.49 ms at 989 TFLOP/s); K5 with an fp32 output is bound by its
// 1.9 GB of dw (0.61 ms).  Measured (H100 SXM, 700 W): a stage's MMAs run
// at ~800 TFLOP/s.  K4 loses most of the rest to the partial last row tile
// of each group (a group of 257 to 320 live rows multiplies three 128-row
// tiles).  K5's time is its dw stores plus its chunks: the
// stores do not overlap the next tile's MMAs.  A persistent walk (one CTA
// per SM, the next tile's loads under this tile's epilogue) measured slower
// and is not used; an epilogue through shared memory and a TMA store,
// drained while the next tile runs, is the next lever.
// ===========================================================================
#include "hopper.cuh"

namespace tc {

constexpr int BM = 128;                   // output rows: two warpgroups
constexpr int BN = 256;                   // output columns
constexpr int BK = 64;                    // reduction depth of a stage
constexpr int STAGES = 4;                 // 4 x 48 KB of shared memory
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int BOX = 64 * 64 * 2;          // one [64][64] bf16 box, 8 KB
constexpr int A_BYTES = BM * BK * 2;      // 16 KB
constexpr int STAGE = A_BYTES + BK * BN * 2;
// stages, full and empty barriers, and slack to align the base to 1024
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;

// the swizzle pattern is a function of the shared address: tiles start on
// 1024-byte boundaries
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// the ring's barriers, initialised by thread 0 before any use
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Writes row half H (fragment rows lane / 4 + 8 H) of a warpgroup's 64 x BN
// accumulators as bf16 to `row` (null: not written), columns n0 .. N - 1;
// `live` false writes zeros.  A thread holds two columns of each 8-column
// block; the four threads of a row trade halves so that each writes 8
// contiguous bytes and a warp's store covers whole 32-byte sectors (16-byte
// pieces cost the memory a read-modify-write each).
template <int H>
__device__ __forceinline__ void store_row_bf16(__nv_bfloat16* row,
                                               const float (&acc)[BN / 2],
                                               bool live, int n0, int N,
                                               int lane) {
  const int q = lane % 4, src = (lane & ~3) + 2 * (q % 2);
#pragma unroll
  for (int c = 0; c < BN / 8; c += 2) {
    const uint32_t p0 = live ? pack_bf16(acc[4 * c + 2 * H],
                                         acc[4 * c + 2 * H + 1]) : 0u;
    const uint32_t p1 = live ? pack_bf16(acc[4 * c + 4 + 2 * H],
                                         acc[4 * c + 4 + 2 * H + 1]) : 0u;
    const uint32_t a0 = __shfl_sync(0xffffffffu, p0, src);
    const uint32_t a1 = __shfl_sync(0xffffffffu, p1, src);
    const uint32_t b0 = __shfl_sync(0xffffffffu, p0, src + 1);
    const uint32_t b1 = __shfl_sync(0xffffffffu, p1, src + 1);
    const int col = n0 + 8 * c + 4 * q;  // columns col .. col + 3
    if (row && col < N)
      *reinterpret_cast<uint2*>(row + col) =
          q < 2 ? make_uint2(a0, b0) : make_uint2(a1, b1);
  }
}

// K4: out[g] = x[g] @ w[wmap[g % E]]; WK: w is K-contiguous (the dx view)
template <bool WK>
__global__ void __launch_bounds__(THREADS, 1) gm_tc_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ wmap,
    __nv_bfloat16* __restrict__ out, int cap, int N, int E, int nk,
    int row_tiles) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bi = blockIdx.x / row_tiles, r0 = (blockIdx.x % row_tiles) * BM;
  const int n0 = blockIdx.y * BN, p = blockIdx.z, g = bi * E + p;
  const int cnt = min(counts[g], cap);
  const long long base = (long long)g * cap;

  if (r0 >= cnt) {  // no live row in the tile: zeros, no loads, no MMAs
    const int rows = min(BM, cap - r0), c8 = min(BN, N - n0) / 8;
    for (int i = tid; i < rows * c8; i += THREADS) {
      const int r = r0 + i / c8, c = n0 + (i % c8) * 8;
      *reinterpret_cast<uint4*>(out + (base + r) * N + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty);

  if (warp == CONSUMERS / 32) {  // producer: lane 0 issues every load
    if (lane != 0) return;
    const int e = wmap ? wmap[p] : p;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) hopper::mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
      uint8_t* a = smem + s * STAGE;
      uint8_t* b = a + A_BYTES;
      hopper::mbar_arrive_expect_tx(&full[s], STAGE);
      hopper::tma_load_3d(a, &tx, &full[s], kt * BK, r0, g);
      if (WK) {
        hopper::tma_load_3d(b, &tw, &full[s], kt * BK, n0, e);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_3d(b + j * BOX, &tw, &full[s], n0 + j * 64,
                              kt * BK, e);
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a = hopper::smem_u32(smem + s * STAGE) + wg * 64 * 128;
    const uint32_t b = hopper::smem_u32(smem + s * STAGE + A_BYTES);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = hopper::sw128_desc(a + kk * 32, 16, 1024);
      const uint64_t db = WK ? hopper::sw128_desc(b + kk * 32, 16, 1024)
                             : hopper::sw128_desc(b + kk * 2048, BOX, 1024);
      hopper::wgmma_m64n256k16<0, WK ? 0 : 1>(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait<1>();  // the previous stage's MMAs are done
    hopper::fence_regs(acc);
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // epilogue: rows at or past the count are dead and written as 0; rows
  // past cap belong to the next group and are not written
  const int row = r0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  store_row_bf16<0>(row < cap ? out + (base + row) * N : nullptr, acc,
                    row < cnt, n0, N, lane);
  store_row_bf16<1>(row + 8 < cap ? out + (base + row + 8) * N : nullptr, acc,
                    row + 8 < cnt, n0, N, lane);
}

// row half H of a warpgroup's accumulators as fp32: a thread's two columns
// are 8 contiguous bytes, a warp's store whole 32-byte sectors
template <int H>
__device__ __forceinline__ void store_row(float* row,
                                          const float (&acc)[BN / 2], int n0,
                                          int N, int lane) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * (lane % 4);
    if (row && col < N)
      *reinterpret_cast<float2*>(row + col) =
          make_float2(acc[4 * c + 2 * H], acc[4 * c + 2 * H + 1]);
  }
}
template <int H>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&acc)[BN / 2], int n0,
                                          int N, int lane) {
  store_row_bf16<H>(row, acc, true, n0, N, lane);
}

// K5: dw[e] = sum over batch rows b of x_{b, gmap[e]}^T g_{b, gmap[e]}
template <typename TO>
__global__ void __launch_bounds__(THREADS, 1) gm_dw_tc_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tg,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ gmap,
    TO* __restrict__ dw, int nb, int cap, int K, int N, int E) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, e = blockIdx.z;
  const int p = gmap ? gmap[e] : e;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty);

  if (warp == CONSUMERS / 32) {  // producer: the same walk as the consumers
    if (lane != 0) return;
    int it = 0;
    for (int bi = 0; bi < nb; ++bi) {
      const int grp = bi * E + p, cnt = min(counts[grp], cap);
      for (int r0 = 0; r0 < cnt; r0 += BK, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) hopper::mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        uint8_t* a = smem + s * STAGE;
        uint8_t* b = a + A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE);
#pragma unroll
        for (int j = 0; j < BM / 64; ++j)
          hopper::tma_load_3d(a + j * BOX, &tx, &full[s], k0 + j * 64, r0,
                              grp);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_3d(b + j * BOX, &tg, &full[s], n0 + j * 64, r0,
                              grp);
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: dw rows k0 + 64 wg ..
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int bi = 0; bi < nb; ++bi) {
    const int grp = bi * E + p, cnt = min(counts[grp], cap);
    for (int r0 = 0; r0 < cnt; r0 += BK, ++it) {
      const int s = it % STAGES;
      uint8_t* st = smem + s * STAGE;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const int live = cnt - r0;
      if (live < BK) {  // the group's last chunk: zero its dead rows
        const int dead16 = (BK - live) * 8;  // 16-byte pieces per box
        for (int i = tid; i < (STAGE / BOX) * dead16; i += CONSUMERS) {
          const int bx = i / dead16, q = i % dead16;
          *reinterpret_cast<uint4*>(st + bx * BOX + live * 128 + q * 16) =
              make_uint4(0, 0, 0, 0);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier(1, CONSUMERS);
      }
      const uint32_t a = hopper::smem_u32(st) + wg * BOX;
      const uint32_t b = hopper::smem_u32(st + A_BYTES);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_m64n256k16<1, 1>(
            acc, hopper::sw128_desc(a + kk * 2048, BOX, 1024),
            hopper::sw128_desc(b + kk * 2048, BOX, 1024));
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (it > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int k = k0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  TO* rows = dw + ((long long)e * K + k) * N;
  store_row<0>(k < K ? rows : nullptr, acc, n0, N, lane);
  store_row<1>(k + 8 < K ? rows + 8LL * N : nullptr, acc, n0, N, lane);
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a 3-D bf16 tensor map: dims d0 (contiguous), d1, d2 with byte strides s1,
// s2; box {64, box1, 1}; 128-byte swizzle; zeros out of range
bool bf16_map(CUtensorMap* m, const void* ptr, long long d0, long long d1,
              long long d2, long long s1, long long s2, int box1) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_fwd(const void* x, const void* w, const int32_t* counts,
                       const int32_t* wmap, __nv_bfloat16* out, int G,
                       int cap, int K, int N, int E, long long se,
                       long long sk, long long sn, cudaStream_t st) {
  const bool wk = sk == 1;  // the dx view: w K-contiguous
  CUtensorMap tx, tw;
  if (!bf16_map(&tx, x, K, cap, G, 2LL * K, 2LL * cap * K, BM) ||
      !(wk ? bf16_map(&tw, w, K, N, E, 2 * sn, 2 * se, BN)
           : bf16_map(&tw, w, N, K, E, 2 * sk, 2 * se, 64)))
    return cudaErrorInvalidValue;
  // (batch row x row tile) fastest, then the n tile, then the physical
  // group: the CTAs in flight share one expert's weight columns
  const int row_tiles = (cap + BM - 1) / BM, nk = (K + BK - 1) / BK;
  const dim3 grid(G / E * row_tiles, (N + BN - 1) / BN, E);
  if (wk)
    return rt_launch(gm_tc_kernel<true>, grid, dim3(THREADS), SMEM, st, tx,
                     tw, counts, wmap, out, cap, N, E, nk, row_tiles);
  return rt_launch(gm_tc_kernel<false>, grid, dim3(THREADS), SMEM, st, tx, tw,
                   counts, wmap, out, cap, N, E, nk, row_tiles);
}

template <typename TO>
cudaError_t launch_dw(const void* x, const void* g, const int32_t* counts,
                      const int32_t* gmap, TO* dw, int G, int cap, int K,
                      int N, int E, cudaStream_t st) {
  CUtensorMap tx, tg;
  if (!bf16_map(&tx, x, K, cap, G, 2LL * K, 2LL * cap * K, 64) ||
      !bf16_map(&tg, g, N, cap, G, 2LL * N, 2LL * cap * N, 64))
    return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  return rt_launch(gm_dw_tc_kernel<TO>, grid, dim3(THREADS), SMEM, st, tx, tg,
                   counts, gmap, dw, G / E, cap, K, N, E);
}

bool tc_shapes_ok(int G, int cap, int K, int N, int E) {
  return E > 0 && G > 0 && G % E == 0 && cap > 16 && K > 0 && N > 0 &&
         K % 8 == 0 && N % 8 == 0;
}

}  // namespace tc

// K4, tensor-core variant: x [G * cap, K] and out [G * cap, N] bf16
// row-major; w bf16 addressed as w[e * se + k * sk + n * sn] with sn == 1
// (forward) or sk == 1 (dx view), the other strides multiples of 8; counts
// int32 [G]; wmap int32 [E] or null (identity).
extern "C" int gm_fwd_tc(const void* x, const void* w, const void* counts,
                         const void* wmap, void* out, int G, int cap, int K,
                         int N, int E, long long se, long long sk,
                         long long sn, void* stream) {
  if (!tc::tc_shapes_ok(G, cap, K, N, E) || (sn != 1 && sk != 1))
    return cudaErrorInvalidValue;
  return tc::launch_fwd(x, w, (const int32_t*)counts, (const int32_t*)wmap,
                        (__nv_bfloat16*)out, G, cap, K, N, E, se, sk, sn,
                        (cudaStream_t)stream);
}

// K5, tensor-core variant: x [G * cap, K] and g [G * cap, N] bf16
// row-major, counts int32 [G], gmap int32 [E] or null; dw [E, K, N]
// row-major in out_dtype (fp32 or bf16).
extern "C" int gm_dw_tc(const void* x, const void* g, const void* counts,
                        const void* gmap, void* dw, int G, int cap, int K,
                        int N, int E, int out_dtype, void* stream) {
  if (!tc::tc_shapes_ok(G, cap, K, N, E)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)counts;
  const int32_t* m = (const int32_t*)gmap;
  if (out_dtype == RT_F32)
    return tc::launch_dw(x, g, c, m, (float*)dw, G, cap, K, N, E, st);
  if (out_dtype == RT_BF16)
    return tc::launch_dw(x, g, c, m, (__nv_bfloat16*)dw, G, cap, K, N, E, st);
  return cudaErrorInvalidValue;
}
