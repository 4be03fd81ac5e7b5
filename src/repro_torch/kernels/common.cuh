// Shared helpers of the port's CUDA kernels (built for sm_90a by
// repro_torch/kernels/_build.py, bound with ctypes through a plain C
// interface: every launcher returns cudaGetLastError()).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_NEG_INF (-1e30f)  // the reference's NEG_INF sentinel

// A source builds as one translation unit, or as REPRO_UNITS of them
// compiled in parallel and linked into one library (kernels/_build.py,
// Kernel.units; -DREPRO_UNITS=n -DREPRO_UNIT=u): the code under
// `#if RT_UNIT(u)` goes into unit u (every unit's, built as one), the C
// interface into unit 0 (RT_INTERFACE).
#ifdef REPRO_UNITS
#define RT_UNIT(u) ((u) % REPRO_UNITS == REPRO_UNIT)
#define RT_INTERFACE (REPRO_UNIT == 0)
#else
#define RT_UNIT(u) 1
#define RT_INTERFACE 1
#endif

// element-type codes passed from Python (kernels/_build.py::dtype_code)
enum RtDtype { RT_F32 = 0, RT_BF16 = 1 };

__device__ __forceinline__ float rt_to_f32(float x) { return x; }
__device__ __forceinline__ float rt_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two consecutive elements (8-byte aligned fp32, 4-byte aligned bf16)
__device__ __forceinline__ float2 rt_to_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 rt_to_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ T rt_from_f32(float x);
template <>
__device__ __forceinline__ float rt_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 rt_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// launch a kernel that needs `smem` bytes of dynamic shared memory (opting
// in above the 48 KB default), then report the launch status
template <typename Kern, typename... Args>
static cudaError_t rt_launch(Kern kern, dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}
