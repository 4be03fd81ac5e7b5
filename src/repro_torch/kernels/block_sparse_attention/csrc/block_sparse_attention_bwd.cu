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
// handful of bytes: at b2 s1024 hq15 d64, causal, K2a's three products are
// 6.05 GFLOP, 0.090 ms on the fp32 CUDA cores (67 TFLOP/s) and 0.037 ms
// through 3xTF32 on the tensor cores (tf32x3.cuh: fp32-level error from
// three TF32 passes at 495 TFLOP/s); K2b's four are 8.06 GFLOP, 0.120 and
// 0.049 ms.
//
// Both sweeps run every product on mma.sync m16n8k8 TF32, three passes
// (one for bf16 operands, whose lo is 0), 4 warps of 16 rows a block, the
// operand tiles stored swizzled (bsa_tile.cuh) so that the K-major and the
// row-pair fragment reads are free of bank conflicts.  The tensor core's
// own fp32 sums truncate, so each accumulator runs over at most 64 terms
// and fp32 adds the rest.
// K2a: one block per (q head, batch, 64-row q tile), the q tiles last first
//   (the causal tiles with the most kv tiles start first); 4 warps, each 16
//   q rows.  Q and dO stay in swizzled tiles for the whole block; the live
//   kv tiles (bsa_tile_live; dead ones are never loaded) stream through a
//   two-stage cp.async buffer of K and V.  Per kv tile a warp forms S =
//   Q·Kᵀ, then dP = dO·Vᵀ (16 x 64, each 64-deep chunk of d from zero,
//   the hi·hi pass and the two small passes in separate accumulators added
//   in fp32: with one accumulator, dq landed more than twice as far from
//   float64 as the fp32 plain version's) in accumulator fragments, P and
//   dS there from the row's lse and delta —
//   the element predicate only on tiles the diagonal, a partial mask block
//   or Sk cuts — and feeds dS straight back as the A fragment of dS·K (the
//   accumulator's columns 2t, 2t + 1 are the MMA's k slots t, t + 4, and K
//   is read at the same kv rows), so dS never touches shared memory.  Each
//   kv tile's dS·K is summed from zero in the tensor cores and added to dq
//   in fp32.  dq has no cross-block sum: a repeat is bitwise equal.
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
//   bitwise equal.  4 warps, each 16 kv rows of the 64 x 64 tile.  Sᵀ =
//   K·Qᵀ and dPᵀ = V·dOᵀ come out in accumulator fragments, formed as K2a
//   forms S and dP (the hi·hi and the small passes in separate
//   accumulators, added in fp32); P and dS are formed there and fed
//   straight back as the A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q (dO /
//   Q read at the same q rows), so they never touch shared memory.  Each
//   step's dV and dK are summed from zero in the tensor cores and added to
//   the item's sums in fp32: with one accumulator over the item's steps
//   and over d, dk landed 4.3x as far from float64 as the fp32 plain
//   version's at b2 s1024 h32 d64 causal (measured on an H100).
// Ragged edges are bounds-checked (zero-filled) in the loads and stores;
// nothing is padded.
#include "common.cuh"
#include "bsa_mask.cuh"
#include "bsa_tile.cuh"
#include "tf32x3.cuh"

// the launch arguments: in a named namespace, so that the variants of
// several translation units (RT_UNIT) share the type
namespace bsa_bwd {

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

}  // namespace bsa_bwd

namespace {

using bsa_bwd::Args;
using bsa_bwd::Sched;

using bsa::sw;


constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // kv rows per tile
constexpr int NT = 128;      // K2a, K2b: 4 warps, each 16 rows of a tile
constexpr int NT_SUM = 256;  // K2b's partial sum

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------
template <int D>
struct DqLayout {
  static constexpr int TILE = bsa::Tile<D>::FLOATS;
  // Q, dO, then two stages of (K, V)
  static constexpr size_t SMEM = sizeof(float) * 6 * TILE;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int Hq, int Hkv, int block, int nkb, long long mask_sb,
    long long mask_sh, int causal, float scale) {
  constexpr int TILE = DqLayout<D>::TILE;
  constexpr int ND = D / 8;               // 8-wide blocks of d
  constexpr bool SPLIT = sizeof(T) == 4;  // fp32 operands: three passes
  extern __shared__ __align__(16) float smem_dq[];
  float* Qs = smem_dq;
  float* Os = Qs + TILE;        // dout
  float* stages = Os + TILE;    // 2 x [K, V]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, R0 = warp * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (Hq / Hkv);
  const long long q_row = (long long)Hq * D;    // token stride of q / dout
  const long long kv_row = (long long)Hkv * D;  // token stride of k / v
  const long long qoff = ((long long)b * Sq * Hq + h) * D;
  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;
  const int32_t* mb = mask + b * mask_sb + h * mask_sh;
  const long long row_base = ((long long)b * Hq + h) * Sq;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const bool uniform = (block % BQ == 0) && (block % BK == 0);

  auto next_live = [&](int kt) {
    while (kt < n_tiles &&
           !bsa_tile_live(mb, nkb, block, q0, q_last, kt * BK,
                          min(kt * BK + BK, Sk) - 1, causal))
      ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    float* st = stages + stage * 2 * TILE;
    bsa::load_tile<T, D, NT>(st, k + kvoff, kv_row, kt * BK, Sk);
    bsa::load_tile<T, D, NT>(st + TILE, v + kvoff, kv_row, kt * BK, Sk);
  };

  bsa::load_tile<T, D, NT>(Qs, q + qoff, q_row, q0, Sq);
  bsa::load_tile<T, D, NT>(Os, dout + qoff, q_row, q0, Sq);
  tf32x3::cp_async_commit();
  int kt = next_live(0);
  if (kt < n_tiles) load_kv(kt, 0);
  tf32x3::cp_async_commit();

  // this thread's rows: R0 + g (fragment elements 0, 1) and R0 + g + 8
  // (elements 2, 3); +inf lse gives p = 0 for rows past Sq or fully masked
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + R0 + g + 8 * r;
    const bool ok = row < Sq;
    const float l = ok ? lse[row_base + row] : RT_NEG_INF;
    L[r] = l > RT_NEG_INF / 4 ? l : INFINITY;
    Dl[r] = ok ? delta[row_base + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; kt < n_tiles; ++it) {
    const int stage = it & 1;
    const int kt_next = next_live(kt + 1);
    if (kt_next < n_tiles) load_kv(kt_next, stage ^ 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // this tile's K and V (and Q, dO) landed
    __syncthreads();
    const float* Ks = stages + stage * 2 * TILE;
    const float* Vs = Ks + TILE;
    const int c0 = kt * BK, c_last = min(c0 + BK, Sk) - 1;

    // P = exp(S·scale − lse) from S = Q·Kᵀ, then dS = P·(dP − delta)·scale
    // from dP = dO·Vᵀ (16 q rows x 64 kv columns a warp), in the
    // accumulator fragments; the element predicate only where the
    // diagonal, a partial mask block or Sk cuts the tile
    const bool whole =
        uniform && c0 + BK <= Sk && (!causal || q0 >= c_last);
    float p[8][4], ds[8][4];
    bsa::qk_tile<SPLIT, D>(
        p, [&](tf32x3::FragA& f, int kk) {
          bsa::tile_frag<SPLIT, D>(f, Qs, R0 + g, kk, t);
        }, Ks, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + R0 + g + (e >= 2 ? 8 : 0);
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        const bool live =
            whole || bsa_elem_live(mb, nkb, block, row, col, Sq, Sk, causal,
                                   uniform);
        p[j][e] = live ? expf(p[j][e] * scale - L[e >> 1]) : 0.f;
      }
    bsa::qk_tile<SPLIT, D>(
        ds, [&](tf32x3::FragA& f, int kk) {
          bsa::tile_frag<SPLIT, D>(f, Os, R0 + g, kk, t);
        }, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - Dl[e >> 1]) * scale;

    // dq += dS·K over the tile's 64 kv rows, summed from zero, added in
    // fp32
    float part[ND][4];
    bsa::pv_tile<SPLIT, D>(part, ds, Ks, g, t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    __syncthreads();  // every warp is done with this stage
    kt = kt_next;
  }
  tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + R0 + g + 8 * r;
    if (row >= Sq) continue;
    T* drow = dq + qoff + (long long)row * q_row;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      bsa::store2(drow + n * 8 + 2 * t, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}


// ---------------------------------------------------------------------------
// K2b: dk, dv partials per work item, then their fixed-order sum
// ---------------------------------------------------------------------------
template <int D>
struct DkvLayout {
  static constexpr int LD = bsa::Tile<D>::LD;  // row pitch, floats
  static constexpr int TILE = bsa::Tile<D>::FLOATS;
  // K, V, then two stages of (Q, dO, lse, delta)
  static constexpr size_t SMEM =
      sizeof(float) * (2 * TILE + 2 * (2 * TILE + 2 * BQ));
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int4* __restrict__ items,
    float* __restrict__ pdk, float* __restrict__ pdv, int Sq, int Sk,
    int Hq, int Hkv, int block, int nkb, long long mask_sb,
    long long mask_sh, int causal, float scale) {
  using L = DkvLayout<D>;
  constexpr int ND = D / 8;  // d tiles of 8 columns
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
    bsa::load_tile<T, D, NT>(st, q + qoff, q_row, q0, Sq);
    bsa::load_tile<T, D, NT>(st + L::TILE, dout + qoff, q_row, q0, Sq);
    if (tid < BQ) {  // +inf lse: p = 0 for rows past Sq or fully masked
      const long long rb = ((long long)b * Hq + h) * Sq + q0 + tid;
      const bool ok = q0 + tid < Sq;
      const float l = ok ? lse[rb] : RT_NEG_INF;
      st[2 * L::TILE + tid] = l > RT_NEG_INF / 4 ? l : INFINITY;
      st[2 * L::TILE + BQ + tid] = ok ? delta[rb] : 0.f;
    }
  };

  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;
  bsa::load_tile<T, D, NT>(Ks, k + kvoff, kv_row, c0, Sk);
  bsa::load_tile<T, D, NT>(Vs, v + kvoff, kv_row, c0, Sk);
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

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 kv rows x 64 q columns per warp, each
    // 64-deep chunk of d from zero with the hi·hi pass and the small
    // passes in separate accumulators added in fp32 (bsa::qk_tile, as K2a
    // forms S and dP)
    float st[8][4], dpt[8][4];
    bsa::qk_tile<SPLIT, D>(
        st, [&](tf32x3::FragA& f, int kk) {
          bsa::tile_frag<SPLIT, D>(f, Ks, R0 + g, kk, t);
        }, Qs, g, t);
    bsa::qk_tile<SPLIT, D>(
        dpt, [&](tf32x3::FragA& f, int kk) {
          bsa::tile_frag<SPLIT, D>(f, Vs, R0 + g, kk, t);
        }, Os, g, t);

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

    // dV += Pᵀ·dO, then dK += dSᵀ·Q over the step's 64 q rows
    // (bsa::pv_tile: the accumulator's columns (2t, 2t + 1) of q block j
    // are the MMA's k slots (t, t + 4)), each summed from zero in the
    // tensor cores and added to the item's sums in fp32
    float part[ND][4];
    bsa::pv_tile<SPLIT, D>(part, st, Os, g, t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] += part[n][e];
    bsa::pv_tile<SPLIT, D>(part, dpt, Qs, g, t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += part[n][e];
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
__global__ void __launch_bounds__(NT_SUM) bsa_dkv_sum_kernel(
    const float* __restrict__ pdk, const float* __restrict__ pdv,
    const int32_t* __restrict__ offsets, T* __restrict__ dk,
    T* __restrict__ dv, int Sk, int Hkv) {
  const int n_kt = (Sk + BK - 1) / BK, tile = blockIdx.x;
  const int kt = tile % n_kt, hk = (tile / n_kt) % Hkv;
  const int b = tile / (n_kt * Hkv), c0 = kt * BK;
  const int p0 = offsets[tile], p1 = offsets[tile + 1];
  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;
  const long long kv_row = (long long)Hkv * D;
  for (int i = threadIdx.x; i < BK * D; i += NT_SUM) {
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

template <typename T, int D>
cudaError_t run_dq(const Args& a, cudaStream_t st) {
  dim3 grid(a.Hq, a.B, (a.Sq + BQ - 1) / BQ);
  return rt_launch(bsa_dq_tc_kernel<T, D>, grid, dim3(NT), DqLayout<D>::SMEM,
                   st, (const T*)a.q, (const T*)a.k, (const T*)a.v,
                   (const int32_t*)a.mask, (const T*)a.dout,
                   (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
                   a.Sq, a.Sk, a.Hq, a.Hkv, a.block, a.nkb, a.mask_sb,
                   a.mask_sh, a.causal, a.scale);
}

template <typename T, int D>
cudaError_t run_dkv(const Args& a, const Sched& sc, cudaStream_t st) {
  if (sc.n_items > 0) {
    cudaError_t e = rt_launch(
        bsa_dkv_tc_kernel<T, D>, dim3(sc.n_items), dim3(NT),
        DkvLayout<D>::SMEM, st, (const T*)a.q, (const T*)a.k,
        (const T*)a.v, (const int32_t*)a.mask, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const int4*)sc.items,
        (float*)sc.pdk, (float*)sc.pdv, a.Sq, a.Sk, a.Hq, a.Hkv, a.block,
        a.nkb, a.mask_sb, a.mask_sh, a.causal, a.scale);
    if (e != cudaSuccess) return e;
  }
  const int tiles = a.B * a.Hkv * ((a.Sk + BK - 1) / BK);
  return rt_launch(bsa_dkv_sum_kernel<T, D>, dim3(tiles), dim3(NT_SUM), 0, st,
                   (const float*)sc.pdk, (const float*)sc.pdv,
                   (const int32_t*)sc.offsets, (T*)a.dk, (T*)a.dv, a.Sk,
                   a.Hkv);
}

}  // namespace

// Each sweep of each (dtype, D) variant is a function of its own, in one
// translation unit (common.cuh's RT_UNIT): variant v = 4 * dtype +
// log2(D / 16).
namespace bsa_bwd {

#define BSA_BWD_DECLARE(v)                                            \
  cudaError_t dq_v##v(const Args&, cudaStream_t);                     \
  cudaError_t dkv_v##v(const Args&, const Sched&, cudaStream_t);
BSA_BWD_DECLARE(0) BSA_BWD_DECLARE(1) BSA_BWD_DECLARE(2) BSA_BWD_DECLARE(3)
BSA_BWD_DECLARE(4) BSA_BWD_DECLARE(5) BSA_BWD_DECLARE(6) BSA_BWD_DECLARE(7)
#undef BSA_BWD_DECLARE

#define BSA_BWD_DQ(v, T, D)                                           \
  cudaError_t dq_v##v(const Args& a, cudaStream_t st) {               \
    return run_dq<T, D>(a, st);                                       \
  }
#define BSA_BWD_DKV(v, T, D)                                          \
  cudaError_t dkv_v##v(const Args& a, const Sched& sc,                \
                       cudaStream_t st) {                             \
    return run_dkv<T, D>(a, sc, st);                                  \
  }
// the units, by compile time (scripts/torch_build_times.py times them):
// the head dim 128 sweeps are the slowest, the fp32 ones most of all, so
// each fp32 one has a unit of its own
#if RT_UNIT(0)
BSA_BWD_DQ(3, float, 128)
#endif
#if RT_UNIT(1)
BSA_BWD_DKV(3, float, 128)
#endif
#if RT_UNIT(2)
BSA_BWD_DQ(7, __nv_bfloat16, 128)
BSA_BWD_DKV(7, __nv_bfloat16, 128)
#endif
#if RT_UNIT(3)
BSA_BWD_DQ(2, float, 64)
BSA_BWD_DKV(2, float, 64)
BSA_BWD_DQ(6, __nv_bfloat16, 64)
BSA_BWD_DKV(6, __nv_bfloat16, 64)
#endif
#if RT_UNIT(4)
BSA_BWD_DQ(0, float, 16)
BSA_BWD_DKV(0, float, 16)
BSA_BWD_DQ(1, float, 32)
BSA_BWD_DKV(1, float, 32)
BSA_BWD_DQ(4, __nv_bfloat16, 16)
BSA_BWD_DKV(4, __nv_bfloat16, 16)
BSA_BWD_DQ(5, __nv_bfloat16, 32)
BSA_BWD_DKV(5, __nv_bfloat16, 32)
#endif
#undef BSA_BWD_DQ
#undef BSA_BWD_DKV

}  // namespace bsa_bwd

#if RT_INTERFACE
namespace {

cudaError_t dispatch(const Args& a, int D, int dtype, const Sched* sc,
                     void* stream) {
  using namespace bsa_bwd;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.block <= 0)
    return cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int d = D == 16 ? 0 : D == 32 ? 1 : D == 64 ? 2 : D == 128 ? 3 : -1;
  if (d < 0 || (dtype != RT_F32 && dtype != RT_BF16))
    return cudaErrorInvalidValue;
  using Dq = cudaError_t (*)(const Args&, cudaStream_t);
  using Dkv = cudaError_t (*)(const Args&, const Sched&, cudaStream_t);
  static const Dq dq[8] = {dq_v0, dq_v1, dq_v2, dq_v3,
                           dq_v4, dq_v5, dq_v6, dq_v7};
  static const Dkv dkv[8] = {dkv_v0, dkv_v1, dkv_v2, dkv_v3,
                             dkv_v4, dkv_v5, dkv_v6, dkv_v7};
  const int v = 4 * (dtype == RT_BF16) + d;
  return sc == nullptr ? dq[v](a, st) : dkv[v](a, *sc, st);
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
#endif  // RT_INTERFACE
