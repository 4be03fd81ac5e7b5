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
// handful of bytes; they run in fp32 on the CUDA cores (67 TFLOP/s peak),
// not the tensor cores, because the training path is fp32 and TF32 would
// break the reference's tolerance.
// Design, as K1: blocks of 256 threads, 64 x 64 tiles, each thread a 4 x 4
// patch of the score tile and a 4 x D/16 slice of its accumulators.
//   K2a: one block per (batch, q head, 64-row q tile); Q and dO stay in
//        shared memory, the loop walks the live kv tiles (the TPU grid's
//        sequential kv axis), dS goes through shared memory into dq.
//   K2b: one block per (batch, kv head, 64-row kv tile); K and V stay in
//        shared memory, the loop walks the Hq/Hkv q heads of the GQA group
//        and their live q tiles, so the group sum the reference gets from
//        the transpose of jnp.repeat happens in registers — deterministic,
//        no atomics, no repeated kv copy.  Pᵀ and dSᵀ go through shared
//        memory into dv and dk.
// Ragged edges are bounds-checked in the loads and stores; nothing is
// padded.  wgmma/TMA pipelining is later work.
#include "common.cuh"
#include "bsa_mask.cuh"

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
// K2b: dk, dv
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) bsa_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int Hq, int Hkv, int block, int nkb, long long mask_sb,
    long long mask_sh, int causal, float scale) {
  constexpr int DC = D / 16;
  constexpr int QS = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][QS]
  float* Qs = Vs + BK * QS;    // [BQ][QS]
  float* Os = Qs + BQ * QS;    // [BQ][QS]  dout
  float* Ps = Os + BQ * QS;    // [BK][PS]  pᵀ
  float* Ss = Ps + BK * PS;    // [BK][PS]  dsᵀ
  float* Ls = Ss + BK * PS;    // [BQ]      lse
  float* Dl = Ls + BQ;         // [BQ]      delta

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const long long q_row = (long long)Hq * D;
  const long long kv_row = (long long)Hkv * D;
  const long long kvoff = ((long long)b * Sk * Hkv + hk) * D;

  for (int i = tid; i < BK * D; i += NT) {
    const int c = i / D, d = i % D;
    const bool ok = c0 + c < Sk;
    const long long off = kvoff + (long long)(c0 + c) * kv_row + d;
    Ks[c * QS + d] = ok ? rt_to_f32(k[off]) : 0.f;
    Vs[c * QS + d] = ok ? rt_to_f32(v[off]) : 0.f;
  }
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int c_last = min(c0 + BK, Sk) - 1;
  const bool uniform = (block % BQ == 0) && (block % BK == 0);
  const int n_qt = (Sq + BQ - 1) / BQ;
  // causal: q tiles ending above this kv tile's first column are dead
  const int qt0 = causal ? min(c0 / BQ, n_qt) : 0;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const int32_t* mb = mask + b * mask_sb + h * mask_sh;
    const long long qoff = ((long long)b * Sq * Hq + h) * D;
    const long long row_base = ((long long)b * Hq + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      const int q_last = min(q0 + BQ, Sq) - 1;
      if (!bsa_tile_live(mb, nkb, block, q0, q_last, c0, c_last, causal))
        continue;
      __syncthreads();  // previous tile's Q/dO/P/dS reads done
      for (int i = tid; i < BQ * D; i += NT) {
        const int r = i / D, d = i % D;
        const bool ok = q0 + r < Sq;
        const long long off = qoff + (long long)(q0 + r) * q_row + d;
        Qs[r * QS + d] = ok ? rt_to_f32(q[off]) : 0.f;
        Os[r * QS + d] = ok ? rt_to_f32(dout[off]) : 0.f;
      }
      if (tid < BQ) {
        const bool ok = q0 + tid < Sq;
        Ls[tid] = ok ? lse[row_base + q0 + tid] : RT_NEG_INF;
        Dl[tid] = ok ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed score tile: i indexes kv rows (ty), j q rows (tx)
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        float a[4], av[4], bq[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Ks[(ty * 4 + i) * QS + kk];
          av[i] = Vs[(ty * 4 + i) * QS + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = Qs[(tx + 16 * j) * QS + kk];
          bo[j] = Os[(tx + 16 * j) * QS + kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(a[i], bq[j], st[i][j]);
            dpt[i][j] = fmaf(av[i], bo[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float l = Ls[r];
          const bool live = bsa_elem_live(mb, nkb, block, q0 + r, col, Sq,
                                          Sk, causal, uniform) &&
                            l > RT_NEG_INF / 4;
          const float p = live ? expf(st[i][j] * scale - l) : 0.f;
          Ps[(ty * 4 + i) * PS + r] = p;
          Ss[(ty * 4 + i) * PS + r] = p * (dpt[i][j] - Dl[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float qv[DC], ov[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          qv[j] = Qs[r * QS + tx + 16 * j];
          ov[j] = Os[r * QS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty * 4 + i) * PS + r];
          const float ds = Ss[(ty * 4 + i) * PS + r];
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dv_acc[i][j] = fmaf(p, ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= Sk) continue;
    const long long off = kvoff + (long long)c * kv_row;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[off + tx + 16 * j] = rt_from_f32<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = rt_from_f32<T>(dv_acc[i][j]);
    }
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

template <typename T, int D>
cudaError_t run(const Args& a, bool dkv, cudaStream_t st) {
  constexpr int QS = D + 1;
  if (!dkv) {
    const size_t smem = sizeof(float) * (4 * BQ * QS + BQ * PS);
    dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    return rt_launch(bsa_dq_kernel<T, D>, grid, dim3(NT), smem, st,
                     (const T*)a.q, (const T*)a.k, (const T*)a.v,
                     (const int32_t*)a.mask, (const T*)a.dout,
                     (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
                     a.Sq, a.Sk, a.Hq, a.Hkv, a.block, a.nkb, a.mask_sb,
                     a.mask_sh, a.causal, a.scale);
  }
  const size_t smem = sizeof(float) * (4 * BQ * QS + 2 * BK * PS + 2 * BQ);
  dim3 grid((a.Sk + BK - 1) / BK, a.Hkv, a.B);
  return rt_launch(bsa_dkv_kernel<T, D>, grid, dim3(NT), smem, st,
                   (const T*)a.q, (const T*)a.k, (const T*)a.v,
                   (const int32_t*)a.mask, (const T*)a.dout,
                   (const float*)a.lse, (const float*)a.delta, (T*)a.dk,
                   (T*)a.dv, a.Sq, a.Sk, a.Hq, a.Hkv, a.block, a.nkb,
                   a.mask_sb, a.mask_sh, a.causal, a.scale);
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, bool dkv, cudaStream_t st) {
  switch (D) {
    case 16: return run<T, 16>(a, dkv, st);
    case 32: return run<T, 32>(a, dkv, st);
    case 64: return run<T, 64>(a, dkv, st);
    case 128: return run<T, 128>(a, dkv, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int D, int dtype, bool dkv,
                     void* stream) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.block <= 0)
    return cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == RT_F32) return dispatch_d<float>(D, a, dkv, st);
  if (dtype == RT_BF16) return dispatch_d<__nv_bfloat16>(D, a, dkv, st);
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
  return dispatch(a, D, dtype, false, stream);
}

// Same inputs; K2b writes dk, dv like k (every row, zeros where no live
// pair reaches it).
extern "C" int bsa_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* mask, const void* dout,
                           const void* lse, const void* delta, void* dk,
                           void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                           int D, int block, int nkb, long long mask_sb,
                           long long mask_sh, int causal, float scale,
                           int dtype, void* stream) {
  Args a{q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, Hq,
         Hkv, block, nkb, mask_sb, mask_sh, causal, scale};
  return dispatch(a, D, dtype, true, stream);
}
