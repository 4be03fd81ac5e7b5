// Block-sparse flash attention, backward — CUDA C++ for sm_90a.
//
// Replaces the two TPU kernels of
//   src/repro/kernels/block_sparse_attention/backward.py
//   ::block_sparse_attention_bwd_p
//   K2a  the dq sweep    (Pallas body `_dq_kernel`,  pallas_call at :144)
//   K2b  the dk/dv sweep (Pallas body `_dkv_kernel`, pallas_call at :164)
// Same function: recompute-from-lse flash backward.  For every live element
// (the predicate of bsa_mask.cuh, shared with the forward K1)
//   p  = exp(q·kᵀ·scale − lse)   (0 where lse <= -1e30/4: fully masked row)
//   ds = p · (dout·vᵀ − delta) · scale,  delta = rowsum(dout ⊙ out)
//   dq = Σ_k ds·k        dk = Σ_q dsᵀ·q        dv = Σ_q pᵀ·dout
// in fp32, with delta computed outside the kernel (as the reference does).
// Tiles whose covering mask blocks are all dead, or that lie wholly above
// the causal diagonal, do no work in either sweep — the same tiles K1 skips.
//
// What bounds it on an H100: operations.  Per live (q, k) pair the two
// sweeps do five d-long products (s and dp twice, dq, dk, dv) against a
// handful of bytes: at b2 s1024 hq15 d64, causal, K2b's four products are
// 8.06 GFLOP, 0.120 ms on the fp32 CUDA cores (67 TFLOP/s) and 0.049 ms
// through 3xTF32 on the tensor cores (tf32x3.cuh: fp32-level error at
// 165 TFLOP/s).
//
// K2a: blocks of 256 threads, 64 x 64 tiles, each thread a 4 x 4 patch of
//   the score tile and a 4 x D/16 slice of dq; one block per (batch, q
//   head, 64-row q tile); Q and dO stay in shared memory, the loop walks
//   the live kv tiles (the TPU grid's sequential kv axis), dS goes through
//   shared memory into dq; fp32 on the CUDA cores.
// K2b: the TPU kernel walks, for one kv tile, every q tile of one q head
//   in its sequential grid axis.  One block per (batch, kv head, kv tile)
//   walking the whole GQA group gave 160 blocks on 132 SMs with the
//   longest 1.9x the mean (the causal kv tile 0 sees every q tile).  Here
//   the work is cut into items — a run of (q head of the group, q tile)
//   steps of one kv tile — by ops.dkv_schedule from the shapes and
//   causality alone: about a thousand near-equal items at the main shape
//   (several waves of 2 blocks an SM), run longest first.  Each item keeps
//   its K and V tile in shared memory, double-buffers the Q / dO tiles of
//   its steps through cp.async, skips steps whose tile the mask kills
//   (bsa_tile_live), and writes fp32 partial dk, dv to a scratch buffer;
//   a second kernel sums each kv tile's partials in the schedule's fixed
//   order and writes dk, dv in k's dtype — no atomics, so a repeat is
//   bitwise equal.  The four products run on mma.sync m16n8k8 TF32, three
//   passes (one for bf16), one accumulator (small terms first): 4 warps,
//   each 16 kv rows of the 64 x 64 tile.  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ come
//   out in accumulator fragments; P and dS are formed there and fed
//   straight back as the A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q (the
//   accumulator's columns 2t, 2t+1 become the MMA's k slots t, t+4, and
//   dO / Q are read at the same rows), so they never touch shared memory.
//   The element predicate runs only on tiles the diagonal or a partial
//   mask block cuts.  Tiles are stored with row pitch max(D, 32) floats
//   and the 16-byte pieces of row r XOR-swizzled by (r & 7): the K-major
//   reads (Sᵀ, dPᵀ) and the row-pair reads (dV, dK) are both free of bank
//   conflicts.
// Ragged edges are bounds-checked (zero-filled) in the loads and stores;
// nothing is padded.
#include "common.cuh"
#include "bsa_mask.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // threads: 16 x 16, each 4 x 4 of a tile
constexpr int PS = BK + 4;  // padded row stride of the P / dS tiles

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int Hq, int Hkv, int block, int nkb, long long mask_sb,
    long long mask_sh, int causal, float scale) {
  constexpr int DC = D / 16;  // dq columns per thread
  constexpr int QS = D + 1;   // padded row stride of the Q/dO/K/V tiles
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* Os = Qs + BQ * QS;    // [BQ][QS]  dout
  float* Ks = Os + BQ * QS;    // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][QS]
  float* Ss = Vs + BK * QS;    // [BQ][PS]  ds

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long q_row = (long long)Hq * D;    // token stride of q / dout
  const long long kv_row = (long long)Hkv * D;  // token stride of k / v
  const long long qoff = ((long long)b * Sq * Hq + h) * D;
  const T* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  const int32_t* mb = mask + b * mask_sb + h * mask_sh;
  const long long row_base = ((long long)b * Hq + h) * Sq;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const bool ok = q0 + r < Sq;
    const long long off = qoff + (long long)(q0 + r) * q_row + d;
    Qs[r * QS + d] = ok ? rt_to_f32(q[off]) : 0.f;
    Os[r * QS + d] = ok ? rt_to_f32(dout[off]) : 0.f;
  }
  float l_r[4], dl_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    l_r[i] = row < Sq ? lse[row_base + row] : RT_NEG_INF;
    dl_r[i] = row < Sq ? delta[row_base + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const bool uniform = (block % BQ == 0) && (block % BK == 0);
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BK;
    const int c_last = min(c0 + BK, Sk) - 1;
    if (!bsa_tile_live(mb, nkb, block, q0, q_last, c0, c_last, causal))
      continue;
    __syncthreads();  // previous tile's K/V/dS reads done; Q/dO visible
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const bool ok = c0 + c < Sk;
      const long long off = (long long)(c0 + c) * kv_row + d;
      Ks[c * QS + d] = ok ? rt_to_f32(kb[off]) : 0.f;
      Vs[c * QS + d] = ok ? rt_to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * QS + kk];
        g[i] = Os[(ty * 4 + i) * QS + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * QS + kk];
        bv[j] = Vs[(tx + 16 * j) * QS + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool live = bsa_elem_live(mb, nkb, block, row, col, Sq, Sk,
                                        causal, uniform) &&
                          l_r[i] > RT_NEG_INF / 4;
        const float p = live ? expf(s[i][j] * scale - l_r[i]) : 0.f;
        Ss[(ty * 4 + i) * PS + tx + 16 * j] =
            p * (dp[i][j] - dl_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = Ks[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* drow = dq + qoff + (long long)row * q_row;
#pragma unroll
    for (int j = 0; j < DC; ++j) drow[tx + 16 * j] = rt_from_f32<T>(acc[i][j]);
  }
}


// ---------------------------------------------------------------------------
// K2b: dk, dv partials per work item, then their fixed-order sum
// ---------------------------------------------------------------------------
constexpr int NT2 = 128;  // 4 warps, each 16 kv rows of the 64-row tile

template <int D>
struct DkvLayout {
  static constexpr int LD = D < 32 ? 32 : D;  // row pitch, floats
  static constexpr int TILE = 64 * LD;
  // K, V, then two stages of (Q, dO, lse, delta)
  static constexpr size_t SMEM =
      sizeof(float) * (2 * TILE + 2 * (2 * TILE + 2 * BQ));
};

// float offset of element (r, c) in a swizzled tile: 16-byte piece
// (c / 4) of row r is stored at piece (c / 4) ^ (r & 7)
template <int LD>
__device__ __forceinline__ int sw(int r, int c) {
  return r * LD + (c ^ ((r & 7) << 2));
}

// rows [r0, r0 + 64) of a [rows][D] operand (row pitch `row` elements,
// rows past `n` zero) into a swizzled fp32 tile; fp32 through cp.async,
// bf16 converted through registers
template <typename T, int D>
__device__ __forceinline__ void dkv_load(float* sm, const T* __restrict__ g,
                                         long long row, int r0, int n) {
  constexpr int LD = DkvLayout<D>::LD, PIECES = 64 * D / 4;
  static_assert(PIECES % NT2 == 0, "whole pieces per thread");
#pragma unroll
  for (int j = 0; j < PIECES / NT2; ++j) {
    const int i = threadIdx.x + j * NT2;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT2) bsa_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int4* __restrict__ items,
    float* __restrict__ pdk, float* __restrict__ pdv, int Sq, int Sk,
    int Hq, int Hkv, int block, int nkb, long long mask_sb,
    long long mask_sh, int causal, float scale) {
  using L = DkvLayout<D>;
  constexpr int LD = L::LD, ND = D / 8;  // d tiles of 8 columns
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem_dkv[];
  float* Ks = smem_dkv;
  float* Vs = Ks + L::TILE;
  float* stage_base = Vs + L::TILE;  // 2 x [Q, dO, lse, delta]
  constexpr int STAGE = 2 * L::TILE + 2 * BQ;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, R0 = warp * 16;
  const int4 item = items[blockIdx.x];  // (kv tile id, s0, s1, slot)
  const int n_kt = (Sk + BK - 1) / BK;
  const int kt = item.x % n_kt, hk = (item.x / n_kt) % Hkv;
  const int b = item.x / (n_kt * Hkv);
  const int c0 = kt * BK, c_last = min(c0 + BK, Sk) - 1;
  const int rep = Hq / Hkv, n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? min(c0 / BQ, n_qt) : 0, nq = n_qt - qt0;
  const long long q_row = (long long)Hq * D, kv_row = (long long)Hkv * D;
  const bool uniform = (block % BQ == 0) && (block % BK == 0);

  auto step_live = [&](int s) {
    const int h = hk * rep + s / nq, q0 = (qt0 + s % nq) * BQ;
    return bsa_tile_live(mask + b * mask_sb + h * mask_sh, nkb, block, q0,
                         min(q0 + BQ, Sq) - 1, c0, c_last, causal);
  };
  auto next_live = [&](int s) {
    while (s < item.z && !step_live(s)) ++s;
    return s;
  };
  auto load_step = [&](int s, int stage) {
    const int h = hk * rep + s / nq, q0 = (qt0 + s % nq) * BQ;
    const long long qoff = ((long long)b * Sq * Hq + h) * D;
    float* st = stage_base + stage * STAGE;
    dkv_load<T, D>(st, q + qoff, q_row, q0, Sq);
    dkv_load<T, D>(st + L::TILE, dout + qoff, q_row, q0, Sq);
    if (tid < BQ) {  // +inf lse: p = 0 for rows past Sq or fully masked
      const long long rb = ((long long)b * Hq + h) * Sq + q0 + tid;
      const bool ok = q0 + tid < Sq;
      const float l = ok ? lse[rb] : RT_NEG_INF;
      st[2 * L::TILE + tid] = l > RT_NEG_INF / 4 ? l : INFINITY;
      st[2 * L::TILE + BQ + tid] = ok ? delta[rb] : 0.f;
    }
  };

  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;
  dkv_load<T, D>(Ks, k + kvoff, kv_row, c0, Sk);
  dkv_load<T, D>(Vs, v + kvoff, kv_row, c0, Sk);
  int s = next_live(item.y);
  if (s < item.z) load_step(s, 0);
  tf32x3::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; s < item.z; ++it) {
    const int stage = it & 1;
    const int s_next = next_live(s + 1);
    if (s_next < item.z) load_step(s_next, stage ^ 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // this step's tiles (and K, V) landed
    __syncthreads();
    const float* Qs = stage_base + stage * STAGE;
    const float* Os = Qs + L::TILE;
    const float* Ls = Os + L::TILE;
    const float* Dl = Ls + BQ;
    const int h = hk * rep + s / nq, q0 = (qt0 + s % nq) * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 kv rows x 64 q columns per warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      tf32x3::FragA ak, av;
      const int r = R0 + g;
      tf32x3::make_a<SPLIT>(ak, Ks[sw<LD>(r, kk + t)],
                            Ks[sw<LD>(r + 8, kk + t)],
                            Ks[sw<LD>(r, kk + t + 4)],
                            Ks[sw<LD>(r + 8, kk + t + 4)]);
      tf32x3::make_a<SPLIT>(av, Vs[sw<LD>(r, kk + t)],
                            Vs[sw<LD>(r + 8, kk + t)],
                            Vs[sw<LD>(r, kk + t + 4)],
                            Vs[sw<LD>(r + 8, kk + t + 4)]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tf32x3::FragB bq, bo;
        const int qr = j * 8 + g;
        tf32x3::make_b<SPLIT>(bq, Qs[sw<LD>(qr, kk + t)],
                              Qs[sw<LD>(qr, kk + t + 4)]);
        tf32x3::make_b<SPLIT>(bo, Os[sw<LD>(qr, kk + t)],
                              Os[sw<LD>(qr, kk + t + 4)]);
        tf32x3::mma3<SPLIT>(st[j], st[j], ak, bq);
        tf32x3::mma3<SPLIT>(dpt[j], dpt[j], av, bo);
      }
    }

    // P and dS in place; the element predicate only where the diagonal
    // or a partial mask block cuts the tile
    const bool whole = uniform && (!causal || q0 >= c_last);
    const int32_t* mb = mask + b * mask_sb + h * mask_sh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        const int kv = c0 + R0 + g + (e >= 2 ? 8 : 0);
        const bool live =
            whole || bsa_elem_live(mb, nkb, block, q0 + ql, kv, Sq, Sk,
                                   causal, uniform);
        const float p = live ? expf(st[j][e] * scale - Ls[ql]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dl[ql]) * scale;
      }

    // dV += Pᵀ·dO, dK += dSᵀ·Q over the 64 q rows: accumulator columns
    // (2t, 2t + 1) of q block j are the MMA's k slots (t, t + 4)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tf32x3::FragA ap, as;
      tf32x3::make_a<true>(ap, st[j][0], st[j][2], st[j][1], st[j][3]);
      tf32x3::make_a<true>(as, dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3]);
      const int qa = j * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        tf32x3::FragB bo, bq;
        const int dc = n * 8 + g;
        tf32x3::make_b<SPLIT>(bo, Os[sw<LD>(qa, dc)], Os[sw<LD>(qa + 1, dc)]);
        tf32x3::make_b<SPLIT>(bq, Qs[sw<LD>(qa, dc)], Qs[sw<LD>(qa + 1, dc)]);
        tf32x3::mma3<true>(dv[n], dv[n], ap, bo);
        tf32x3::mma3<true>(dk[n], dk[n], as, bq);
      }
    }
    __syncthreads();  // every warp is done with this stage
    s = s_next;
  }
  tf32x3::cp_async_wait<0>();

  // this item's partial dk, dv rows: [slot][64][D] fp32
  const long long base = (long long)item.w * BK * D;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const long long off =
          base + (long long)(R0 + g + 8 * hlf) * D + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(pdk + off) =
          make_float2(dk[n][2 * hlf], dk[n][2 * hlf + 1]);
      *reinterpret_cast<float2*>(pdv + off) =
          make_float2(dv[n][2 * hlf], dv[n][2 * hlf + 1]);
    }
}

// dk, dv of kv tile blockIdx.x: the sum of its partials offsets[tile] ..
// offsets[tile + 1] - 1, in that order; rows with none are zero
template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_dkv_sum_kernel(
    const float* __restrict__ pdk, const float* __restrict__ pdv,
    const int32_t* __restrict__ offsets, T* __restrict__ dk,
    T* __restrict__ dv, int Sk, int Hkv) {
  const int n_kt = (Sk + BK - 1) / BK, tile = blockIdx.x;
  const int kt = tile % n_kt, hk = (tile / n_kt) % Hkv;
  const int b = tile / (n_kt * Hkv), c0 = kt * BK;
  const int p0 = offsets[tile], p1 = offsets[tile + 1];
  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;
  const long long kv_row = (long long)Hkv * D;
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, d = i % D;
    if (c0 + r >= Sk) break;
    float sk = 0.f, sv = 0.f;
    for (int p = p0; p < p1; ++p) {
      sk += pdk[(long long)p * BK * D + i];
      sv += pdv[(long long)p * BK * D + i];
    }
    const long long off = kvoff + (long long)(c0 + r) * kv_row + d;
    dk[off] = rt_from_f32<T>(sk);
    dv[off] = rt_from_f32<T>(sv);
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, block, nkb;
  long long mask_sb, mask_sh;
  int causal;
  float scale;
};

// K2b's schedule: int4 items (kv tile, first step, end step, slot), the
// kv tiles' slot offsets, and the fp32 partial buffers [slots][64][D]
struct Sched {
  const void *items, *offsets;
  void *pdk, *pdv;
  int n_items;
};

template <typename T, int D>
cudaError_t run(const Args& a, const Sched* sc, cudaStream_t st) {
  constexpr int QS = D + 1;
  if (sc == nullptr) {
    const size_t smem = sizeof(float) * (4 * BQ * QS + BQ * PS);
    dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    return rt_launch(bsa_dq_kernel<T, D>, grid, dim3(NT), smem, st,
                     (const T*)a.q, (const T*)a.k, (const T*)a.v,
                     (const int32_t*)a.mask, (const T*)a.dout,
                     (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
                     a.Sq, a.Sk, a.Hq, a.Hkv, a.block, a.nkb, a.mask_sb,
                     a.mask_sh, a.causal, a.scale);
  }
  if (sc->n_items > 0) {
    cudaError_t e = rt_launch(
        bsa_dkv_tc_kernel<T, D>, dim3(sc->n_items), dim3(NT2),
        DkvLayout<D>::SMEM, st, (const T*)a.q, (const T*)a.k,
        (const T*)a.v, (const int32_t*)a.mask, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const int4*)sc->items,
        (float*)sc->pdk, (float*)sc->pdv, a.Sq, a.Sk, a.Hq, a.Hkv, a.block,
        a.nkb, a.mask_sb, a.mask_sh, a.causal, a.scale);
    if (e != cudaSuccess) return e;
  }
  const int tiles = a.B * a.Hkv * ((a.Sk + BK - 1) / BK);
  return rt_launch(bsa_dkv_sum_kernel<T, D>, dim3(tiles), dim3(NT), 0, st,
                   (const float*)sc->pdk, (const float*)sc->pdv,
                   (const int32_t*)sc->offsets, (T*)a.dk, (T*)a.dv, a.Sk,
                   a.Hkv);
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, const Sched* sc,
                       cudaStream_t st) {
  switch (D) {
    case 16: return run<T, 16>(a, sc, st);
    case 32: return run<T, 32>(a, sc, st);
    case 64: return run<T, 64>(a, sc, st);
    case 128: return run<T, 128>(a, sc, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int D, int dtype, const Sched* sc,
                     void* stream) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.block <= 0)
    return cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == RT_F32) return dispatch_d<float>(D, a, sc, st);
  if (dtype == RT_BF16) return dispatch_d<__nv_bfloat16>(D, a, sc, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D] (contiguous, one dtype);
// mask int32 addressed as in bsa_fwd; lse, delta float32 [B, Hq, Sq].
// K2a writes dq like q.
extern "C" int bsa_bwd_dq(const void* q, const void* k, const void* v,
                          const void* mask, const void* dout,
                          const void* lse, const void* delta, void* dq,
                          int B, int Sq, int Sk, int Hq, int Hkv, int D,
                          int block, int nkb, long long mask_sb,
                          long long mask_sh, int causal, float scale,
                          int dtype, void* stream) {
  Args a{q, k, v, mask, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk,
         Hq, Hkv, block, nkb, mask_sb, mask_sh, causal, scale};
  return dispatch(a, D, dtype, nullptr, stream);
}

// Same inputs, plus K2b's schedule (ops.dkv_schedule): `items` int32
// [n_items, 4] (kv tile, first step, end step, slot), `offsets` int32
// [tiles + 1], and fp32 scratch pdk, pdv [slots, 64, D] for the partials.
// Writes dk, dv like k (every row, zeros where no live pair reaches it).
extern "C" int bsa_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* mask, const void* dout,
                           const void* lse, const void* delta, void* dk,
                           void* dv, const void* items, const void* offsets,
                           void* pdk, void* pdv, int n_items, int B, int Sq,
                           int Sk, int Hq, int Hkv, int D, int block,
                           int nkb, long long mask_sb, long long mask_sh,
                           int causal, float scale, int dtype,
                           void* stream) {
  Args a{q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, Hq,
         Hkv, block, nkb, mask_sb, mask_sh, causal, scale};
  Sched sc{items, offsets, pdk, pdv, n_items};
  return dispatch(a, D, dtype, &sc, stream);
}
