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
// What bounds it on an H100: bytes.  Each live K/V row is read once per kv
// head and used for G = n_q/n_kv dot products of length hd (~3 FLOP per
// byte at G = 3, two orders of magnitude under the card's ridge), so the
// only lever is memory-level parallelism: many SMs, many bytes in flight on
// each, wide loads.  The design:
// - Split (flash-decoding).  The grid is (kv head x head chunk, lane,
//   split).  A lane's live pages n = min(J, ceil(cache_len / page)) are cut
//   on the device into contiguous ranges of ceil(n / splits) pages, so
//   lanes of any length spread evenly; `splits` comes from the static
//   shapes (ops.pa_splits: about 200 blocks on the 132 SMs).  A head chunk
//   is the G q heads of one kv head when G <= 4, else up to 8 of them.
// - Stream.  A block stages its split's slice of the page-table row in
//   shared memory once, then walks its token range in stages of 256 / LPT
//   rows: each of the 256 threads owns one 16-byte chunk (LPT chunks make
//   a row of hd elements) of one K row and the same chunk of the V row,
//   fetched with `cp.async` (zero-filled when the row is dead) into a
//   4-stage ring, so up to 24 KB a block are in flight while a stage is
//   scored.  A thread reads back only the bytes it fetched itself, so the
//   ring needs no barrier.  Scores: the thread's chunk of K (bf16 -> fp32
//   in registers) against its chunk of each q head (in registers), summed
//   over the LPT lanes of the row with shuffles; every lane of every warp
//   is busy.  Each row keeps its own online-softmax state (m, l, acc over
//   its chunk); the rows of a warp merge by an xor tree of shuffles, the
//   warps in warp order through shared memory.
//   Once split, the loop is bound by latency, not bandwidth: what a stage
//   costs is the chain of dependent instructions a thread runs, so it
//   carries no integer division (a thread steps its row's page and offset),
//   no branch, and two exp2f per q head (q is pre-scaled by log2(e) /
//   sqrt(hd), so the scores are in log2 units).
// - Combine.  With one split the block writes the output.  Otherwise each
//   split writes (m, l, acc[hd]) per q head to an fp32 workspace; the last
//   block of a (lane, head chunk) to finish (a __threadfence and an
//   atomicAdd on a counter that it resets to 0) merges the splits in the
//   order 0, 1, ..., n-1 and writes the output.  So K6 is one launch per
//   call and a repeat is bitwise equal whatever order the blocks finish
//   in.  An empty split writes the empty state (m = -1e30, l = 0, acc = 0).
//   The counters are one buffer per device (ops._counters), so two K6
//   launches must never run at the same time: the caller issues them on one
//   stream, one after another.
#include "common.cuh"
#include "tf32x3.cuh"  // the 16-byte cp.async helpers

namespace {

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_STAGES = 4;
constexpr float PA_LOG2E = 1.4426950408889634f;

// the 16-byte chunk at `p` as fp32
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[4], const float*) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[8],
                                           const __nv_bfloat16*) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// q and the output are fp32 or bf16 (`bf16`), read and written once
__device__ __forceinline__ float load_q(const void* q, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}
__device__ __forceinline__ void store_out(void* o, long long i, float x,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(o)[i] = x;
}

template <typename TKV, int HD, int GM>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attn_kernel(const void* __restrict__ q, const TKV* __restrict__ kp,
                      const TKV* __restrict__ vp,
                      const int32_t* __restrict__ page_table,
                      const int32_t* __restrict__ cache_len,
                      void* __restrict__ out, float* __restrict__ ws,
                      int32_t* __restrict__ counters, int n_q, int n_kv,
                      int page, int J, int splits, int work_bytes,
                      float qscale, int q_bf16) {
  constexpr int VEC = 16 / (int)sizeof(TKV);  // elements in a 16-byte chunk
  constexpr int LPT = HD / VEC;                // threads per K/V row
  constexpr int NTG = PA_THREADS / LPT;        // rows per stage
  static_assert(LPT >= 2 && LPT <= 32 && 32 % LPT == 0, "row of 2-32 chunks");
  const int G = n_q / n_kv, nhc = (G + GM - 1) / GM;
  const int kvh = blockIdx.x / nhc, hc = blockIdx.x % nhc;
  const int bi = blockIdx.y, split = blockIdx.z;
  const int h0 = kvh * G + hc * GM, gn = min(GM, G - hc * GM);
  const int tid = threadIdx.x, row = tid / LPT, ch = tid % LPT;
  const int warp = tid / 32, lane = tid % 32;
  const long long hbase = (long long)bi * n_q + h0;  // first q head's row

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* pt_s = reinterpret_cast<int32_t*>(smem + work_bytes);

  // this split's live pages [p0, p1) and token range [t0, t1)
  const int cl = cache_len[bi];
  const int n_pages = max(0, min(J, (cl + page - 1) / page));
  const int pps = (n_pages + splits - 1) / splits;
  const int p0 = min(n_pages, split * pps), p1 = min(n_pages, p0 + pps);
  for (int i = tid; i < p1 - p0; i += PA_THREADS)
    pt_s[i] = page_table[(long long)bi * J + p0 + i];
  float qr[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      qr[g][v] = g < gn ? qscale * load_q(q, (hbase + g) * HD + ch * VEC + v,
                                          q_bf16)
                        : 0.f;
  __syncthreads();
  const int t0 = p0 * page, t1 = min(p1 * page, cl);
  const int nst = t1 > t0 ? (t1 - t0 + NTG - 1) / NTG : 0;

  // fetch cursor: this thread's row of the next stage to fetch (position,
  // page relative to p0, offset in the page), stepped without a division
  int ipos = t0 + row, ipg = row / page, ioff = row % page;
  const int dpg = NTG / page, doff = NTG % page;
  uint32_t live_bits = 0;  // bit st % PA_STAGES: the row of stage st is live
  auto slot = [&](int st) {
    return smem + ((size_t)(st % PA_STAGES) * 2 * PA_THREADS + tid) * 16;
  };
  auto fetch = [&](int st) {  // stages in order 0, 1, ...
    const int blk = ipos < t1 ? pt_s[ipg] : -1;
    const long long off =
        blk >= 0
            ? (((long long)blk * page + ioff) * n_kv + kvh) * HD + ch * VEC
            : 0;
    unsigned char* d = slot(st);
    tf32x3::cp_async16(d, kp + off, blk >= 0 ? 16 : 0);
    tf32x3::cp_async16(d + PA_THREADS * 16, vp + off, blk >= 0 ? 16 : 0);
    const uint32_t bit = 1u << (st % PA_STAGES);
    live_bits = blk >= 0 ? (live_bits | bit) : (live_bits & ~bit);
    ipos += NTG;
    ipg += dpg;
    ioff += doff;
    if (ioff >= page) {
      ioff -= page;
      ++ipg;
    }
  };

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = RT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[g][v] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < PA_STAGES - 1; ++s) {
    if (s < nst) fetch(s);
    tf32x3::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    if (st + PA_STAGES - 1 < nst) fetch(st + PA_STAGES - 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<PA_STAGES - 1>();  // stage st landed
    const bool live = (live_bits >> (st % PA_STAGES)) & 1u;
    float kf[VEC], vf[VEC];
    load_chunk(slot(st), kf, kp);
    load_chunk(slot(st) + PA_THREADS * 16, vf, vp);
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float a = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) a = fmaf(qr[g][v], kf[v], a);
      s[g] = a;
    }
#pragma unroll
    for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
#pragma unroll
    for (int g = 0; g < GM; ++g) {  // online softmax over this row's token
      const float mn = live ? fmaxf(m[g], s[g]) : m[g];
      const float corr = exp2f(m[g] - mn);
      const float p = live ? exp2f(s[g] - mn) : 0.f;
      l[g] = fmaf(l[g], corr, p);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[g][v] = fmaf(acc[g][v], corr, p * vf[v]);
      m[g] = mn;
    }
  }
  tf32x3::cp_async_wait<0>();

  // merge the rows of each warp (xor tree over the lanes that hold the same
  // chunk), then the PA_WARPS warps in warp order through shared memory
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float fa = exp2f(m[g] - mn), fb = exp2f(mo - mn);
      l[g] = fmaf(l[g], fa, lo * fb);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[g][v] = fmaf(acc[g][v], fa,
                         __shfl_xor_sync(0xffffffffu, acc[g][v], off) * fb);
      m[g] = mn;
    }
  __syncthreads();  // the ring becomes the merge area
  // red [PA_WARPS][GM][HD] acc, then [PA_WARPS][GM] m, l, factors; [GM] M, L
  float* red = reinterpret_cast<float*>(smem);
  float* rm = red + PA_WARPS * GM * HD;
  float* rl = rm + PA_WARPS * GM;
  float* rf = rl + PA_WARPS * GM;
  float* bm = rf + PA_WARPS * GM;
  float* bl = bm + GM;
  if (lane < LPT) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int v = 0; v < VEC; v += 4)
        *reinterpret_cast<float4*>(red + (warp * GM + g) * HD + ch * VEC +
                                   v) =
            make_float4(acc[g][v], acc[g][v + 1], acc[g][v + 2],
                        acc[g][v + 3]);
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        rm[warp * GM + g] = m[g];
        rl[warp * GM + g] = l[g];
      }
  }
  __syncthreads();
  if (tid < gn) {
    float mx = RT_NEG_INF, lt = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) mx = fmaxf(mx, rm[w * GM + tid]);
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) {
      const float f = exp2f(rm[w * GM + tid] - mx);
      rf[w * GM + tid] = f;
      lt = fmaf(rl[w * GM + tid], f, lt);
    }
    bm[tid] = mx;
    bl[tid] = lt;
  }
  __syncthreads();
  for (int i = tid; i < gn * HD; i += PA_THREADS) {
    const int g = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w)
      a = fmaf(red[(w * GM + g) * HD + d], rf[w * GM + g], a);
    if (splits == 1) {
      const float lt = bl[g];
      store_out(out, (hbase + g) * HD + d, a / (lt > 0.f ? lt : 1.f), q_bf16);
    } else {
      ws[((hbase + g) * splits + split) * HD + d] = a;
    }
  }
  if (splits == 1) return;

  // fixed-order combine by the last split of this (lane, head chunk)
  float* ws_ml = ws + (long long)gridDim.y * n_q * splits * HD;  // [.., 2]
  if (tid < gn) {
    ws_ml[((hbase + tid) * splits + split) * 2] = bm[tid];
    ws_ml[((hbase + tid) * splits + split) * 2 + 1] = bl[tid];
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    int32_t* c = counters + (long long)bi * gridDim.x + blockIdx.x;
    last = atomicAdd(c, 1) == splits - 1;
    if (last) *c = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every split's (m, l) at once, then the factors and L per q head, then
  // the accumulators, eight splits' loads in flight at a time; the sums run
  // in split order
  float* cm = red;                   // [GM][splits] m, l, factors; [GM] L
  float* cl_s = cm + GM * splits;
  float* cf = cl_s + GM * splits;
  float* lsum = cf + GM * splits;
  const float2* ml2 = reinterpret_cast<const float2*>(ws_ml) + hbase * splits;
  for (int i = tid; i < gn * splits; i += PA_THREADS) {
    const float2 x = __ldcg(ml2 + i);
    cm[i] = x.x;
    cl_s[i] = x.y;
  }
  __syncthreads();
  if (tid < gn) {
    float mx = RT_NEG_INF, lt = 0.f;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, cm[tid * splits + s]);
    for (int s = 0; s < splits; ++s) {
      const float f = exp2f(cm[tid * splits + s] - mx);
      cf[tid * splits + s] = f;
      lt = fmaf(cl_s[tid * splits + s], f, lt);
    }
    lsum[tid] = lt;
  }
  __syncthreads();
  for (int i = tid; i < gn * HD; i += PA_THREADS) {
    const int g = i / HD, d = i % HD;
    const float* a_s = ws + (hbase + g) * splits * HD + d;
    float a = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = s0 + u < splits ? __ldcg(a_s + (long long)(s0 + u) * HD) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < splits) a = fmaf(x[u], cf[g * splits + s0 + u], a);
    }
    const float lt = lsum[g];
    store_out(out, (hbase + g) * HD + d, a / (lt > 0.f ? lt : 1.f), q_bf16);
  }
}

template <typename TKV, int HD, int GM>
cudaError_t run(const void* q, const void* kp, const void* vp, const void* pt,
                const void* cl, void* out, void* ws, void* counters, int b,
                int n_q, int n_kv, int page, int J, int splits, float sqrt_d,
                int q_bf16, cudaStream_t stream) {
  const int nhc = (n_q / n_kv + GM - 1) / GM;
  // the ring, or the merge area / the combine's factors that reuse it
  const size_t ring = (size_t)PA_STAGES * 2 * PA_THREADS * 16;
  const size_t merge =
      sizeof(float) * ((size_t)PA_WARPS * GM * (HD + 3) + 2 * GM);
  const size_t comb = sizeof(float) * (size_t)GM * (3 * splits + 1);
  size_t work = ring > merge ? ring : merge;
  work = ((work > comb ? work : comb) + 15) / 16 * 16;
  const size_t smem = work + sizeof(int32_t) * (size_t)((J + splits - 1) /
                                                        splits);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return rt_launch(paged_attn_kernel<TKV, HD, GM>,
                   dim3(n_kv * nhc, b, splits), dim3(PA_THREADS), smem,
                   stream, q, (const TKV*)kp, (const TKV*)vp,
                   (const int32_t*)pt, (const int32_t*)cl, out, (float*)ws,
                   (int32_t*)counters, n_q, n_kv, page, J, splits, (int)work,
                   PA_LOG2E / sqrt_d, q_bf16);
}

// a block serves G q heads of one kv head when G <= 4, else chunks of 8
template <typename TKV, int HD>
cudaError_t dispatch_g(int G, const void* q, const void* kp, const void* vp,
                       const void* pt, const void* cl, void* out, void* ws,
                       void* cnt, int b, int n_q, int n_kv, int page, int J,
                       int splits, float sqrt_d, int q_bf16,
                       cudaStream_t st) {
#define RT_PA_G(GG)                                                          \
  return run<TKV, HD, GG>(q, kp, vp, pt, cl, out, ws, cnt, b, n_q, n_kv,    \
                          page, J, splits, sqrt_d, q_bf16, st);
  switch (G) {
    case 1:
      RT_PA_G(1)
    case 2:
      RT_PA_G(2)
    case 3:
      RT_PA_G(3)
    case 4:
      RT_PA_G(4)
    default:
      RT_PA_G(8)
  }
#undef RT_PA_G
}

template <typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const void* pt, const void* cl, void* out, void* ws,
                        void* cnt, int b, int n_q, int n_kv, int page, int J,
                        int splits, float sqrt_d, int q_bf16,
                        cudaStream_t st) {
#define RT_PA_CASE(HH)                                                      \
  case HH:                                                                  \
    return dispatch_g<TKV, HH>(n_q / n_kv, q, kp, vp, pt, cl, out, ws, cnt, \
                               b, n_q, n_kv, page, J, splits, sqrt_d,       \
                               q_bf16, st);
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

}  // namespace

// q [b, n_q, hd] and out (same dtype); kp/vp [pool+1, page, n_kv, hd],
// 16-byte aligned; page_table int32 [b, J]; cache_len int32 [b]; all
// contiguous.  With splits > 1: ws fp32 [b * n_q * splits * (hd + 2)] and
// counters int32 [b * n_kv * ceil(G / chunk)] (chunk G if G <= 4, else 8),
// all 0 (the kernel leaves them 0 again).
extern "C" int paged_attn_fwd(const void* q, const void* kp, const void* vp,
                              const void* page_table, const void* cache_len,
                              void* out, void* ws, void* counters, int b,
                              int n_q, int n_kv, int hd, int page, int J,
                              int splits, float sqrt_d, int q_dtype,
                              int kv_dtype, void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || page <= 0 || splits < 1 ||
      (q_dtype != RT_F32 && q_dtype != RT_BF16) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (b == 0 || n_q == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int q_bf16 = q_dtype == RT_BF16;
  if (kv_dtype == RT_F32)
    return dispatch_hd<float>(hd, q, kp, vp, page_table, cache_len, out, ws,
                              counters, b, n_q, n_kv, page, J, splits, sqrt_d,
                              q_bf16, st);
  if (kv_dtype == RT_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, kp, vp, page_table, cache_len,
                                      out, ws, counters, b, n_q, n_kv, page,
                                      J, splits, sqrt_d, q_bf16, st);
  return cudaErrorInvalidValue;
}
