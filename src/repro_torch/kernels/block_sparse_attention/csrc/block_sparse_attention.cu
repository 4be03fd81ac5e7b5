// Block-sparse flash attention, forward — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/block_sparse_attention/block_sparse_attention.py
//   ::block_sparse_attention_p (Pallas body `_kernel`).
// Same function: out = softmax(q·kᵀ·scale, masked) · v with the online
// softmax in fp32, fully masked rows -> zeros and lse ≈ -1e30; an element
// (row r, col c) is live iff mask[r/block, c/block] > 0, c < Sk and (causal)
// r >= c (the predicate of bsa_mask.cuh, shared with the backward sweeps).
// A 64x64 tile whose covering mask blocks are all 0 — or that lies
// wholly above the causal diagonal or past Sk — does no work, exactly the
// tiles the TPU kernel's `tile_active` skips (the mask block, 128 or 512, is
// coarser than the tile and is expanded over it).
//
// What bounds it on an H100: operations.  Prefill attention at s = 1024 does
// ~128 fp32 FMAs per byte it must read; the work runs on the CUDA cores in
// fp32 (67 TFLOP/s peak), not the tensor cores, because the path's
// activations are fp32 and TF32 would break the reference's tolerance.
// Design: one block of 256 threads owns one (batch, head, 64-row q tile) and
// loops over the kv tiles (the TPU grid's sequential kv axis becomes this
// loop).  Q, the current K/V tile and P live in shared memory; each thread
// keeps a 4x4 block of scores and a 4 x D/16 slice of the output
// accumulator in registers, and the running max / sum of its rows (reduced
// with warp shuffles over the 16 threads that share a row).  GQA reads the
// kv head h / (Hq/Hkv) directly instead of materialising the repeat, and
// ragged q / kv edges are bounds-checked in the loads — no padding copies.
// wgmma/TMA pipelining is later work.
#include "common.cuh"
#include "bsa_mask.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv columns per tile
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 4 columns
constexpr int PS = BK + 4;  // padded row stride of P (bank-conflict free)

template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int Hq,
    int Hkv, int block, int nkb, long long mask_sb, long long mask_sh,
    int causal, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int QS = D + 1;   // padded row stride of Q and K tiles
  extern __shared__ float smem[];
  float* Qs = smem;           // [BQ][QS]
  float* Ks = Qs + BQ * QS;   // [BK][QS]
  float* Vs = Ks + BK * QS;   // [BK][D]
  float* Ps = Vs + BK * D;    // [BQ][PS]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long q_row = (long long)Hq * D;    // token stride of q / out
  const long long kv_row = (long long)Hkv * D;  // token stride of k / v
  const T* qb = q + ((long long)b * Sq * Hq + h) * D;
  const T* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  const int32_t* mb = mask + b * mask_sb + h * mask_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[r * QS + d] =
        (q0 + r < Sq) ? rt_to_f32(qb[(long long)(q0 + r) * q_row + d]) : 0.f;
  }

  float m_i[4], l_i[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = RT_NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  // a tile inside one mask block needs no per-element mask lookup
  const bool uniform = (block % BQ == 0) && (block % BK == 0);
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BK;
    const int c_last = min(c0 + BK, Sk) - 1;
    // uniform over the block: same inputs everywhere
    if (!bsa_tile_live(mb, nkb, block, q0, q_last, c0, c_last, causal))
      continue;

    __syncthreads();  // previous tile's K/V/P reads done; Q stores visible
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const bool ok = c0 + c < Sk;
      const long long off = (long long)(c0 + c) * kv_row + d;
      Ks[c * QS + d] = ok ? rt_to_f32(kb[off]) : 0.f;
      Vs[c * D + d] = ok ? rt_to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * QS + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float rmax = RT_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool keep = bsa_elem_live(mb, nkb, block, row, col, Sq, Sk,
                                        causal, uniform);
        s[i][j] = keep ? s[i][j] * scale : RT_NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_i[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a row with no live entry yet keeps p = 0 (l stays 0)
        const float p =
            (m_new <= RT_NEG_INF / 2) ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + rsum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) o[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l = l_i[i];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + ((long long)b * Sq + row) * q_row + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      orow[tx + 16 * j] = rt_from_f32<T>(l > 0.f ? o[i][j] * inv : 0.f);
    if (tx == 0)
      lse[((long long)b * Hq + h) * Sq + row] =
          m_i[i] + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* mask,
                void* out, void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                int block, int nkb, long long mask_sb, long long mask_sh,
                int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  return rt_launch(bsa_fwd_kernel<T, D>, grid, dim3(NT), smem, stream,
                   (const T*)q, (const T*)k, (const T*)v,
                   (const int32_t*)mask, (T*)out, (float*)lse, Sq, Sk, Hq,
                   Hkv, block, nkb, mask_sb, mask_sh, causal, scale);
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
// dtype); mask int32 [.., .., nqb, nkb] addressed as
// mask[b*mask_sb + h*mask_sh + qb*nkb + kb] (a stride of 0 broadcasts);
// lse float32 [B, Hq, Sq].
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
