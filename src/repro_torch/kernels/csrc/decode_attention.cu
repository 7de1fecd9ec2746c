// Flash-decode on Hopper against the contiguous KV cache: one query token
// per batch row, with RoPE fused at position lengths-1 and the row masked
// to its first `lengths` positions.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention. The TPU wrapper
// relaid the whole cache out head-major and padded S up to its s_block on
// every call, and its grid walked a row's blocks in order on one core. Here
// the kernel reads the model-layout cache (B, S, KV, d) in place through
// its strides, with no copy and no padding, and the body is the paged
// decode's (paged_attention.cuh, decode_split) over a strided addressing:
// the grid is (B, KV, kSplit) in clusters of (1, 1, kSplit), the kSplit
// CTAs of a cluster take contiguous runs of the row's 32-position tiles
// (each CTA holds the G query heads of its KV head, one warp each, and
// issues all its copies at once), and the cluster combines the partial
// softmaxes through distributed shared memory in rank order.
//
// Bound: latency at the serving shapes, bytes on a long cache. Per row the
// kernel must read 2 * length * d cache values per KV head and does
// 4 * length * d flops per query head — about 2 flops per byte for a bf16
// cache at G = 8, far below the card's ridge; at 256 positions the bytes
// take 0.1 us, below a launch. A CTA per (b, KV head) walking the row's
// tiles in series (this kernel's first design) paid one memory round trip
// a tile; eight CTAs a row, each with its copies in flight together, pay
// about one, and at 2,065 positions each takes 9 of the 65 tiles.
//
// Layouts: q (B, H, d) with row strides (sqb, sqh) in elements and unit
// stride along d; k/v (B, KV, S, d) with strides (skb, skh, sks) shared by
// both and unit stride along d; lengths (B,) int32; out (B, H, d)
// contiguous in q's dtype.
#include "paged_attention.cuh"

namespace {

using paged_attn::DecodeTiles;
using paged_attn::kSplit;
using paged_attn::StridedRows;

struct Params {
  const void* q;
  long long sqb, sqh;
  const void *k, *v;
  long long skb, skh, sks;
  const int32_t* lengths;
  const float* inv_freq;
  void* out;
  int H, KV, S, D, cb;
  float scale;
};

// One CTA an SM is enough: without the 1, ptxas caps registers as for two
// CTAs of 1024 threads an SM, and spills.
template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(1024, 1) decode_kernel(Params p) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.KV;
  const int length = p.lengths[b];
  const StridedRows rows{b * p.skb + kvh * p.skh, p.sks};
  paged_attn::decode_split<TQ, TKV, DP>(
      static_cast<const TQ*>(p.q) + b * p.sqb + kvh * G * p.sqh, p.sqh,
      static_cast<TQ*>(p.out) + (static_cast<size_t>(b) * p.H + kvh * G) * p.D,
      static_cast<const TKV*>(p.k), static_cast<const TKV*>(p.v), rows,
      max(0, min(length, p.S)), length - 1, p.D, p.cb, p.inv_freq, p.scale);
}

struct Launcher {
  Params p;
  int B;
  cudaStream_t stream;
  cudaError_t* status;

  template <typename TQ, typename TKV>
  void run() const {
    flash::dispatch_dp(p.D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      const int G = p.H / p.KV;
      const size_t smem = DecodeTiles<TKV, DP>::smem(G);
      auto kernel = decode_kernel<TQ, TKV, DP>;
      flash::allow_smem(kernel, smem);
      *status = paged_attn::launch_clusters(kernel, dim3(B, p.KV, kSplit),
                                            32 * G, smem, kSplit, stream, p);
    });
  }
};

}  // namespace

// Launches on `stream` and returns the launch's CUDA error (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and cache.
extern "C" int decode_attention(const void* q, long long sqb, long long sqh,
                                const void* k, const void* v, long long skb,
                                long long skh, long long sks,
                                const void* lengths, const void* inv_freq,
                                void* out, int B, int H, int KV, int S, int D,
                                int q_bf16, int kv_bf16, float scale,
                                void* stream) {
  const Params p{q, sqb, sqh, k, v, skb, skh, sks,
                 static_cast<const int32_t*>(lengths),
                 static_cast<const float*>(inv_freq), out, H, KV, S, D,
                 flash::copy_bytes(kv_bf16 ? 2 : 4, D, {k, v},
                                   {skb, skh, sks}),
                 scale};
  cudaError_t status = cudaSuccess;
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{p, B, static_cast<cudaStream_t>(stream), &status});
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(status != cudaSuccess ? status : last);
}

// The dynamic shared memory of one CTA (paged_attn::decode_smem).
extern "C" long long decode_attention_smem(int G, int D, int kv_bf16) {
  return paged_attn::decode_smem(G, D, kv_bf16);
}
