// Fused RMSNorm on Hopper: y = x · rsqrt(mean(x²) + eps) · w over the rows
// of an (R, D) matrix, float32 statistics, the result cast back to x's
// dtype (float32 or bfloat16; w float32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm,
// which took row blocks of 256 into VMEM and asserted R % row_block == 0.
// Here one warp owns one row: each lane reads every 32nd element (the warp
// reads consecutive addresses), squares and sums in registers, the warp
// reduces by shuffles, and each lane then reads its elements again (from
// L1, where the row still lies) to scale them. 8 rows per CTA; warps past
// the last row return at once, so R may be anything (no divisor assert).
//
// Bound: bytes — x read once and y written once (the weight is D floats,
// cached); at R = 4096, D = 2048 in float32 that is 67 MB, 20 µs at
// 3.35 TB/s. Scalar 4-byte loads keep it simple; 16-byte vector loads are
// the step that brings it nearer the bound.
#include "attention.cuh"

namespace {

using repro_attn::store_f32;
using repro_attn::to_f32;
using repro_attn::warp_sum;

constexpr int kRowsPerCta = 8;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ w,
                               T* __restrict__ out, long long R, int D,
                               float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * D;
  T* yr = out + row * D;
  float ss = 0.f;
  for (int e = lane; e < D; e += 32) {
    const float xv = to_f32(xr[e]);
    ss = fmaf(xv, xv, ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int e = lane; e < D; e += 32)
    store_f32(yr + e, to_f32(xr[e]) * inv * w[e]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_bf16 selects bfloat16 (1) or float32 (0) for x and out.
extern "C" int rmsnorm(const void* x, const void* w, void* out, long long R,
                       int D, float eps, int x_bf16, void* stream) {
  const unsigned grid =
      static_cast<unsigned>((R + kRowsPerCta - 1) / kRowsPerCta);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    rmsnorm_kernel<__nv_bfloat16><<<grid, 32 * kRowsPerCta, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), R, D, eps);
  else
    rmsnorm_kernel<float><<<grid, 32 * kRowsPerCta, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}
