// Flash-decode on Hopper against the contiguous KV cache: one query token
// per batch row, with RoPE fused at position lengths-1 and the row masked
// to its first `lengths` positions.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention. The TPU wrapper
// relaid the whole cache out head-major and padded S up to its s_block on
// every call; here the kernel reads the model-layout cache (B, S, KV, d) in
// place through its strides, with no copy and no padding: the last tile is
// cut at S. One CTA per (b, kv head) walks the row's positions in tiles of
// 32 with one warp per query head of the GQA group (G = H/KV warps), so
// the group reads each tile once — the walk of attention.cuh with a
// contiguous address for each position.
//
// Bound: bytes. Per row the kernel must read 2 * length * d cache values
// per KV head and does 4 * length * d flops per query head — about 2 flops
// per byte for a bf16 cache at G = 8, far below the card's ridge. Only
// tiles below the row's length are read. At serving batch sizes the
// (B, KV) grid fills few of the 132 SMs; splitting the positions across a
// cluster, as paged_attention.cuh does for the paged pool, is the next
// step.
//
// Layouts: q (B, H, d) with row strides (sqb, sqh) in elements and unit
// stride along d; k/v (B, KV, S, d) with strides (skb, skh, sks) shared by
// both and unit stride along d; lengths (B,) int32; out (B, H, d)
// contiguous in q's dtype.
#include "attention.cuh"

namespace {

using repro_attn::attend;
using repro_attn::ContiguousAddr;
using repro_attn::kContiguousTile;

template <typename TQ, typename TKV>
__global__ void decode_kernel(const TQ* __restrict__ q, long long sqb,
                              long long sqh, const TKV* __restrict__ k,
                              const TKV* __restrict__ v, long long skb,
                              long long skh, long long sks,
                              const int32_t* __restrict__ lengths,
                              const float* __restrict__ inv_freq,
                              TQ* __restrict__ out, int H, int KV, int S,
                              int D, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int h = kvh * G + (threadIdx.x >> 5);
  const int qpos = lengths[b] - 1;
  const ContiguousAddr addr{b * skb + kvh * skh, sks, S, kContiguousTile};
  attend<TQ, TKV>(q + b * sqb + h * sqh,
                  out + (static_cast<size_t>(b) * H + h) * D, true, qpos,
                  qpos, k, v, addr, D, inv_freq, scale);
}

struct Launcher {
  const void *q;
  long long sqb, sqh;
  const void *k, *v;
  long long skb, skh, sks;
  const void *lengths, *inv_freq;
  void* out;
  int B, H, KV, S, D;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const int G = H / KV;
    const size_t smem =
        repro_attn::smem_floats(G, kContiguousTile, D) * sizeof(float);
    auto kernel = decode_kernel<TQ, TKV>;
    repro_attn::allow_smem(kernel, smem);
    kernel<<<dim3(B, KV), dim3(32 * G), smem, stream>>>(
        static_cast<const TQ*>(q), sqb, sqh, static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), skb, skh, sks,
        static_cast<const int32_t*>(lengths),
        static_cast<const float*>(inv_freq), static_cast<TQ*>(out), H, KV, S,
        D, scale);
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and cache.
extern "C" int decode_attention(const void* q, long long sqb, long long sqh,
                                const void* k, const void* v, long long skb,
                                long long skh, long long sks,
                                const void* lengths, const void* inv_freq,
                                void* out, int B, int H, int KV, int S, int D,
                                int q_bf16, int kv_bf16, float scale,
                                void* stream) {
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{q, sqb, sqh, k, v, skb, skh, sks, lengths, inv_freq, out, B, H,
               KV, S, D, scale, static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
