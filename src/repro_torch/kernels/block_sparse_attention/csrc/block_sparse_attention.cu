// Block-sparse flash attention, forward (K1) — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/block_sparse_attention/block_sparse_attention.py
//   ::block_sparse_attention_p (Pallas body `_kernel`, pallas_call at :143).
// Same function: out = softmax(q·kᵀ·scale, masked) · v with the online
// softmax in fp32, fully masked rows -> zeros and lse ≈ -1e30; an element
// (row r, col c) is live iff mask[r/block, c/block] > 0, c < Sk and (causal)
// r >= c (the predicate of bsa_mask.cuh, shared with the backward sweeps).
// A 64x64 tile whose covering mask blocks are all 0 — or that lies
// wholly above the causal diagonal or past Sk — does no work, exactly the
// tiles the TPU kernel's `tile_active` skips (the mask block, 128 or 512, is
// coarser than the tile and is expanded over it).
//
// What bounds it on an H100: operations.  Two d-long products (S = q·kᵀ,
// P·v) per live (q, k) pair against a few bytes per token: at b4 s1024
// hq15 hkv5 d64, causal, 8.06 GFLOP, 0.120 ms on the fp32 CUDA cores (67
// TFLOP/s) and 0.049 ms through 3xTF32 on the tensor cores (three TF32
// passes at 495 TFLOP/s), against 42 MB, 0.013 ms of HBM traffic.
//
// Design: 3xTF32 mma.sync m16n8k8 (tf32x3.cuh: hi = tf32(x), lo =
// tf32(x − hi), hi·hi + (hi·lo + lo·hi), fp32-level error; a bf16 operand
// has lo = 0 and its product takes one pass).  One block of 4 warps owns
// one (q head, batch, 64-row q tile), each warp 16 q rows; the grid walks
// the q tiles last first, so the causal tiles with the most kv tiles start
// first.  Q is loaded once into a swizzled tile (bsa_tile.cuh) and, for
// D <= 64, its (hi, lo) A fragments stay in registers for the whole block
// (D = 128 remakes them from the tile).  The live kv tiles (bsa_tile_live;
// dead ones are never loaded) stream through a two-stage cp.async buffer
// of K and V tiles.  Per kv tile a warp forms S (16 x 64) in accumulator
// fragments, applies scale, mask and causal there — the element predicate
// only on tiles the diagonal, a partial mask block or Sk cuts — and runs
// the online softmax on its rows with quad shuffles.  P goes straight
// back as the A fragment of P·V (the accumulator's columns 2t, 2t + 1 are
// the MMA's k slots t, t + 4, and V is read at the same kv rows), so it
// never touches shared memory.
// Accumulation order: the tensor core's own fp32 sums truncate, so no
// tensor-core accumulator runs over more than 64 terms.  S sums each 64-
// deep chunk of d from zero, the hi·hi pass in one accumulator and the two
// small passes in another (in one accumulator each small term loses up to
// a unit in the last place of the large running sum, and S's error is
// multiplied into P by the exp: with one accumulator the output landed
// more than twice as far from float64 as the fp32 plain version's); the
// two and, for D = 128, the chunks are added in fp32.  Each kv tile's P·V
// is summed from zero in one accumulator and added to the running output
// in fp32 as o = o·corr + pv, the online softmax's rescale step.
// GQA reads the kv head h / (Hq/Hkv) directly; ragged q / kv edges are
// zero-filled in the loads and masked — no padding copies.
#include "common.cuh"
#include "bsa_mask.cuh"
#include "bsa_tile.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv rows per tile
constexpr int NT = 128;  // 4 warps, each 16 q rows

template <int D>
struct FwdLayout {
  static constexpr int TILE = bsa::Tile<D>::FLOATS;
  // Q, then two stages of (K, V)
  static constexpr size_t SMEM = sizeof(float) * 5 * TILE;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int Hq,
    int Hkv, int block, int nkb, long long mask_sb, long long mask_sh,
    int causal, float scale) {
  constexpr int TILE = FwdLayout<D>::TILE;
  constexpr int ND = D / 8;               // 8-wide blocks of d
  constexpr bool SPLIT = sizeof(T) == 4;  // fp32 operands: three passes
  constexpr bool QREG = D <= 64;          // Q's fragments in registers
  extern __shared__ __align__(16) float smem_fwd[];
  float* Qs = smem_fwd;
  float* stages = Qs + TILE;  // 2 x [K, V]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, R0 = warp * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (Hq / Hkv);
  const long long q_row = (long long)Hq * D;    // token stride of q / out
  const long long kv_row = (long long)Hkv * D;  // token stride of k / v
  const long long qoff = ((long long)b * Sq * Hq + h) * D;
  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;
  const int32_t* mb = mask + b * mask_sb + h * mask_sh;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  // a tile inside one mask block needs no per-element mask lookup
  const bool uniform = (block % BQ == 0) && (block % BK == 0);

  // uniform over the block: same inputs everywhere
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
  tf32x3::cp_async_commit();
  int kt = next_live(0);
  if (kt < n_tiles) load_kv(kt, 0);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<1>();  // Q landed
  __syncthreads();

  // Q's A fragments (rows R0 + g, R0 + g + 8), kept in registers for D <= 64
  tf32x3::FragA qa[QREG ? ND : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      bsa::tile_frag<SPLIT, D>(qa[i], Qs, R0 + g, i * 8, t);
  }
  auto q_frag = [&](tf32x3::FragA& f, int kk) {
    if constexpr (QREG)
      f = qa[kk / 8];
    else
      bsa::tile_frag<SPLIT, D>(f, Qs, R0 + g, kk, t);
  };

  // this thread's rows: R0 + g (fragment elements 0, 1) and R0 + g + 8
  // (elements 2, 3); output columns n * 8 + 2t, 2t + 1
  float o[ND][4], m_r[2] = {RT_NEG_INF, RT_NEG_INF}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; kt < n_tiles; ++it) {
    const int stage = it & 1;
    const int kt_next = next_live(kt + 1);
    if (kt_next < n_tiles) load_kv(kt_next, stage ^ 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // this tile's K and V landed
    __syncthreads();
    const float* Ks = stages + stage * 2 * TILE;
    const float* Vs = Ks + TILE;
    const int c0 = kt * BK, c_last = min(c0 + BK, Sk) - 1;

    // S = Q·Kᵀ: 16 q rows x 64 kv columns a warp
    float s[8][4];
    bsa::qk_tile<SPLIT, D>(s, q_frag, Ks, g, t);

    // scale and mask in the fragment; the element predicate only where
    // the diagonal, a partial mask block or Sk cuts the tile
    const bool whole =
        uniform && c0 + BK <= Sk && (!causal || q0 >= c_last);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + R0 + g + (e >= 2 ? 8 : 0);
        const int col = c0 + j * 8 + 2 * t + (e & 1);
        const bool keep =
            whole || bsa_elem_live(mb, nkb, block, row, col, Sq, Sk, causal,
                                   uniform);
        s[j][e] = keep ? s[j][e] * scale : RT_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    // online softmax: the row max and sum over the quad sharing a row
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_r[r] - mx[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row with no live entry yet keeps p = 0 (l stays 0)
        const float m = mx[e >> 1];
        const float p = m <= RT_NEG_INF / 2 ? 0.f : expf(s[j][e] - m);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_r[r] = l_r[r] * corr[r] + rs[r];
      m_r[r] = mx[r];
    }

    // P·V over the tile's 64 kv rows, summed from zero, then added to the
    // rescaled output in fp32
    float pv[ND][4];
    bsa::pv_tile<SPLIT, D>(pv, s, Vs, g, t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = o[n][e] * corr[e >> 1] + pv[n][e];
    __syncthreads();  // every warp is done with this stage
    kt = kt_next;
  }
  tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + R0 + g + 8 * r;
    if (row >= Sq) continue;
    const float l = l_r[r];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + qoff + (long long)row * q_row;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      bsa::store2(orow + n * 8 + 2 * t, l > 0.f ? o[n][2 * r] * inv : 0.f,
                  l > 0.f ? o[n][2 * r + 1] * inv : 0.f);
    if (t == 0)
      lse[((long long)b * Hq + h) * Sq + row] =
          m_r[r] + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* mask,
                void* out, void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                int block, int nkb, long long mask_sb, long long mask_sh,
                int causal, float scale, cudaStream_t stream) {
  dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  return rt_launch(bsa_fwd_tc_kernel<T, D>, grid, dim3(NT),
                   FwdLayout<D>::SMEM, stream, (const T*)q, (const T*)k,
                   (const T*)v, (const int32_t*)mask, (T*)out, (float*)lse,
                   Sq, Sk, Hq, Hkv, block, nkb, mask_sb, mask_sh, causal,
                   scale);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int Sq,
                       int Sk, int Hq, int Hkv, int block, int nkb,
                       long long mask_sb, long long mask_sh, int causal,
                       float scale, cudaStream_t stream) {
#define RT_BSA_CASE(DD)                                                     \
  case DD:                                                                  \
    return run<T, DD>(q, k, v, mask, out, lse, B, Sq, Sk, Hq, Hkv, block,   \
                      nkb, mask_sb, mask_sh, causal, scale, stream);
  switch (D) {
    RT_BSA_CASE(16)
    RT_BSA_CASE(32)
    RT_BSA_CASE(64)
    RT_BSA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_BSA_CASE
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], out like q (all contiguous, one
// dtype, fp32 rows 16-byte aligned); mask int32 [.., .., nqb, nkb]
// addressed as mask[b*mask_sb + h*mask_sh + qb*nkb + kb] (a stride of 0
// broadcasts); lse float32 [B, Hq, Sq].
extern "C" int bsa_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int Sq,
                       int Sk, int Hq, int Hkv, int D, int block, int nkb,
                       long long mask_sb, long long mask_sh, int causal,
                       float scale, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || block <= 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return dispatch_d<float>(D, q, k, v, mask, out, lse, B, Sq, Sk, Hq, Hkv,
                             block, nkb, mask_sb, mask_sh, causal, scale, st);
  if (dtype == RT_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, mask, out, lse, B, Sq, Sk,
                                     Hq, Hkv, block, nkb, mask_sb, mask_sh,
                                     causal, scale, st);
  return cudaErrorInvalidValue;
}
