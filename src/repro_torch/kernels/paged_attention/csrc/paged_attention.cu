// Paged decode attention — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py
//   ::paged_attention_fwd (Pallas body `_kernel`).
// Same function: single-token attention of q [b, n_q, hd] over a block pool
// kp/vp [pool+1, page, n_kv, hd] addressed through page_table [b, J]
// (-1 = unmapped); logical page j of lane i is live iff
// j*page < cache_len[i] and page_table[i, j] >= 0, positions >= cache_len
// are masked inside the tail page, GQA is grouped (q head h reads kv head
// h / (n_q/n_kv), K is never repeated), the softmax is online in fp32 and a
// lane with no live position gets zeros.
//
// What bounds it on an H100: bytes.  Each live K/V page is read once per kv
// head and used for n_q/n_kv dot products of length hd, ~1-2 FLOP per byte.
// Design: one block per (kv head, lane), which reads the lane's page-table
// row and cache_len itself (no scalar prefetch on Hopper) and loops over
// live pages only.  One warp per q head of the group; the block's warps
// form `nsplit` groups that take interleaved pages, each with its own
// running max / sum / accumulator, merged once at the end — so up to eight
// pages are in flight per block instead of one.  A page's K/V slice is
// staged in shared memory as fp32 (the pool is bf16), lanes of a warp take
// tokens for the scores and head dims for the P·V product.  More blocks per
// lane (split-K across SMs) is later work.
#include "common.cuh"

namespace {

template <typename TQ, typename TKV, int HD>
__global__ void paged_attn_kernel(const TQ* __restrict__ q,
                                  const TKV* __restrict__ kp,
                                  const TKV* __restrict__ vp,
                                  const int32_t* __restrict__ page_table,
                                  const int32_t* __restrict__ cache_len,
                                  TQ* __restrict__ out, int n_q, int n_kv,
                                  int page, int J, int nsplit, float sqrt_d) {
  constexpr int DL = (HD + 31) / 32;  // head dims per lane in P·V
  constexpr int KS = HD + 1;          // padded row stride of the K page
  const int G = n_q / n_kv;
  const int nwarps = G * nsplit;
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = warp / G, hg = warp % G;

  extern __shared__ float smem[];
  float* Ks = smem + (size_t)split * page * (KS + HD);  // [page][KS]
  float* Vs = Ks + page * KS;                           // [page][HD]
  float* Qs = smem + (size_t)nsplit * page * (KS + HD); // [G][HD]
  float* Ps = Qs + G * HD;                              // [nwarps][page]
  float* Cm = Ps + nwarps * page;                       // [nwarps]
  float* Cl = Cm + nwarps;                              // [nwarps]
  float* Ca = Cl + nwarps;                              // [nwarps][HD]

  const TQ* qb = q + ((long long)bi * n_q + (long long)kvh * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x)
    Qs[i] = rt_to_f32(qb[i]);

  const int cl = cache_len[bi];
  const int n_pages = max(0, min(J, (cl + page - 1) / page));
  const int rounds = (n_pages + nsplit - 1) / nsplit;
  const int sthreads = G * 32, stid = threadIdx.x - split * sthreads;
  float* Pw = Ps + warp * page;
  float m = RT_NEG_INF, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    const int j = r * nsplit + split;
    const int blk = j < n_pages ? page_table[(long long)bi * J + j] : -1;
    const bool live = blk >= 0;  // j < n_pages already means j*page < cl
    if (live) {
      for (int i = stid; i < page * HD; i += sthreads) {
        const int t = i / HD, d = i % HD;
        const long long off =
            (((long long)blk * page + t) * n_kv + kvh) * HD + d;
        Ks[t * KS + d] = rt_to_f32(kp[off]);
        Vs[t * HD + d] = rt_to_f32(vp[off]);
      }
    }
    __syncthreads();
    if (live) {
      float pmax = RT_NEG_INF;
      for (int t = lane; t < page; t += 32) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          s = fmaf(Qs[hg * HD + d], Ks[t * KS + d], s);
        s = (j * page + t < cl) ? s / sqrt_d : RT_NEG_INF;  // tail mask
        Pw[t] = s;
        pmax = fmaxf(pmax, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      const float m_new = fmaxf(m, pmax);
      float psum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(Pw[t] - m_new);
        Pw[t] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m - m_new);
      l = l * corr + psum;
      m = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        float a = acc[i] * corr;
        if (d < HD)
          for (int t = 0; t < page; ++t) a = fmaf(Pw[t], Vs[t * HD + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  // merge the split groups' partial softmax states (exact for nsplit = 1)
  if (lane == 0) {
    Cm[warp] = m;
    Cl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (lane + 32 * i < HD) Ca[warp * HD + lane + 32 * i] = acc[i];
  __syncthreads();
  if (split != 0) return;
  float mx = RT_NEG_INF;
  for (int g = 0; g < nsplit; ++g) mx = fmaxf(mx, Cm[g * G + hg]);
  float lt = 0.f, o[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) o[i] = 0.f;
  for (int g = 0; g < nsplit; ++g) {
    const int w2 = g * G + hg;
    const float f = expf(Cm[w2] - mx);
    lt += Cl[w2] * f;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      if (lane + 32 * i < HD) o[i] += Ca[w2 * HD + lane + 32 * i] * f;
  }
  TQ* ob = out + ((long long)bi * n_q + (long long)kvh * G + hg) * HD;
  const float div = lt > 0.f ? lt : 1.f;
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (lane + 32 * i < HD) ob[lane + 32 * i] = rt_from_f32<TQ>(o[i] / div);
}

size_t smem_bytes(int HD, int G, int page, int nsplit) {
  const size_t nw = (size_t)G * nsplit;
  return sizeof(float) * ((size_t)nsplit * page * (2 * HD + 1) + G * HD +
                          nw * page + nw * (2 + HD));
}

template <typename TQ, typename TKV, int HD>
cudaError_t run(const void* q, const void* kp, const void* vp, const void* pt,
                const void* cl, void* out, int b, int n_q, int n_kv,
                int page, int J, float sqrt_d, cudaStream_t stream) {
  const int G = n_q / n_kv;
  int nsplit = 8;
  while (nsplit > 1 && (32 * G * nsplit > 1024 ||
                        smem_bytes(HD, G, page, nsplit) > 160 * 1024))
    nsplit /= 2;
  const size_t smem = smem_bytes(HD, G, page, nsplit);
  if (32 * G > 1024 || smem > 227 * 1024) return cudaErrorInvalidValue;
  return rt_launch(paged_attn_kernel<TQ, TKV, HD>, dim3(n_kv, b),
                   dim3(32 * G * nsplit), smem, stream, (const TQ*)q,
                   (const TKV*)kp, (const TKV*)vp, (const int32_t*)pt,
                   (const int32_t*)cl, (TQ*)out, n_q, n_kv, page, J, nsplit,
                   sqrt_d);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const void* pt, const void* cl, void* out, int b,
                        int n_q, int n_kv, int page, int J, float sqrt_d,
                        cudaStream_t st) {
#define RT_PA_CASE(HH)                                                     \
  case HH:                                                                 \
    return run<TQ, TKV, HH>(q, kp, vp, pt, cl, out, b, n_q, n_kv, page, J, \
                            sqrt_d, st);
  switch (hd) {
    RT_PA_CASE(16)
    RT_PA_CASE(32)
    RT_PA_CASE(64)
    RT_PA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_PA_CASE
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, int hd, const void* q, const void* kp,
                        const void* vp, const void* pt, const void* cl,
                        void* out, int b, int n_q, int n_kv, int page, int J,
                        float sqrt_d, cudaStream_t st) {
  if (kv_dtype == RT_F32)
    return dispatch_hd<TQ, float>(hd, q, kp, vp, pt, cl, out, b, n_q, n_kv,
                                  page, J, sqrt_d, st);
  if (kv_dtype == RT_BF16)
    return dispatch_hd<TQ, __nv_bfloat16>(hd, q, kp, vp, pt, cl, out, b, n_q,
                                          n_kv, page, J, sqrt_d, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, n_q, hd] and out (same dtype); kp/vp [pool+1, page, n_kv, hd];
// page_table int32 [b, J]; cache_len int32 [b]; all contiguous.
extern "C" int paged_attn_fwd(const void* q, const void* kp, const void* vp,
                              const void* page_table, const void* cache_len,
                              void* out, int b, int n_q, int n_kv, int hd,
                              int page, int J, float sqrt_d, int q_dtype,
                              int kv_dtype, void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || page <= 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == RT_F32)
    return dispatch_kv<float>(kv_dtype, hd, q, kp, vp, page_table, cache_len,
                              out, b, n_q, n_kv, page, J, sqrt_d, st);
  if (q_dtype == RT_BF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, hd, q, kp, vp, page_table,
                                      cache_len, out, b, n_q, n_kv, page, J,
                                      sqrt_d, st);
  return cudaErrorInvalidValue;
}
