// The small helpers every kernel source uses: kNegInf, float32 loads and
// stores of either dtype (to_f32, store_f32), warp reductions, allow_smem,
// dispatch_dtypes and the C error-string entry. The serving attention
// kernels' device code is paged_attention.cuh (both cache layouts), the
// full-sequence flash kernels' flash_mma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise the CTA's dynamic shared-memory limit where a launch needs more
// than the default 48 KB.
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

// Call launcher.run<TQ, TKV>() with the element types that q_bf16 / kv_bf16
// select: bfloat16 (1) or float32 (0) for q/out and for the cache.
template <typename Launcher>
inline void dispatch_dtypes(int q_bf16, int kv_bf16,
                            const Launcher& launcher) {
  if (q_bf16 && kv_bf16)
    launcher.template run<__nv_bfloat16, __nv_bfloat16>();
  else if (q_bf16)
    launcher.template run<__nv_bfloat16, float>();
  else if (kv_bf16)
    launcher.template run<float, __nv_bfloat16>();
  else
    launcher.template run<float, float>();
}

}  // namespace repro_attn

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
