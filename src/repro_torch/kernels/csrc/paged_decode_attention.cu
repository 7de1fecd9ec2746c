// Paged flash-decode on Hopper: one query token per batch row against the
// paged KV pool, with RoPE fused at position lengths-1.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention.
// The TPU grid (B, KV, nb) ran its page axis in order on one core and
// carried the online softmax in VMEM scratch. Here the grid is
// (B, KV, kSplit) in clusters of (1, 1, kSplit): the kSplit CTAs of a
// cluster split one row's positions into contiguous runs of 32-position
// tiles (gathered across pages), each CTA holds the G query heads of its KV
// head (one warp each) and keeps a partial softmax, and the cluster
// combines the partials through distributed shared memory in rank order
// (paged_attention.cuh, decode_split).
//
// Bound: latency. Per row the kernel must read its valid positions of K
// and V (2 * length * d elements per KV head) and does 4 * length * d
// flops per query head: at the serving shapes 0.11 us of bytes, far below
// a launch. What costs is the chain of dependent steps — block table,
// page copies, arithmetic, combine — so the design puts 8 CTAs on each
// (b, KV head) instead of one, issues every copy of a CTA at once (one
// memory round trip instead of one a page) and keeps the combine on chip.
//
// Layouts: q (B, H, d) with row strides (sqb, sqh) in elements and unit
// stride along d; pools (P, page, KV, d) contiguous; block_tables (B, nb)
// int32; lengths (B,) int32; out (B, H, d) contiguous in q's dtype.
#include "paged_attention.cuh"

namespace {

using paged_attn::DecodeTiles;
using paged_attn::kSplit;
using paged_attn::PagedRows;

struct Params {
  const void* q;
  long long sqb, sqh;
  const void *k, *v;
  const int32_t* block_tables;
  const int32_t* lengths;
  const float* inv_freq;
  void* out;
  int H, KV, D, page, nb, cb;
  float scale;
};

// One CTA an SM is enough: without the 1, ptxas caps registers as for two
// CTAs of 1024 threads an SM, and spills.
template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(1024, 1) paged_decode_kernel(Params p) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.KV;
  const int length = p.lengths[b];
  const PagedRows rows{p.block_tables + static_cast<size_t>(b) * p.nb,
                       p.page, static_cast<long long>(p.KV) * p.D,
                       static_cast<long long>(kvh) * p.D};
  paged_attn::decode_split<TQ, TKV, DP>(
      static_cast<const TQ*>(p.q) + b * p.sqb + kvh * G * p.sqh, p.sqh,
      static_cast<TQ*>(p.out) + (static_cast<size_t>(b) * p.H + kvh * G) * p.D,
      static_cast<const TKV*>(p.k), static_cast<const TKV*>(p.v), rows,
      max(0, min(length, p.nb * p.page)), length - 1, p.D, p.cb, p.inv_freq,
      p.scale);
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
      auto kernel = paged_decode_kernel<TQ, TKV, DP>;
      flash::allow_smem(kernel, smem);
      *status = paged_attn::launch_clusters(kernel, dim3(B, p.KV, kSplit),
                                            32 * G, smem, kSplit, stream, p);
    });
  }
};

}  // namespace

// Launches on `stream` and returns the launch's CUDA error (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and pools.
extern "C" int paged_decode_attention(
    const void* q, long long sqb, long long sqh, const void* k_pages,
    const void* v_pages, const void* block_tables, const void* lengths,
    const void* inv_freq, void* out, int B, int H, int KV, int D, int page,
    int nb, int q_bf16, int kv_bf16, float scale, void* stream) {
  const Params p{q, sqb, sqh, k_pages, v_pages,
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(lengths),
                 static_cast<const float*>(inv_freq), out, H, KV, D, page, nb,
                 flash::copy_bytes(kv_bf16 ? 2 : 4, D, {k_pages, v_pages},
                                   {static_cast<long long>(KV) * D, D}),
                 scale};
  cudaError_t status = cudaSuccess;
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{p, B, static_cast<cudaStream_t>(stream), &status});
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(status != cudaSuccess ? status : last);
}

// The dynamic shared memory of one CTA (paged_attn::decode_smem).
extern "C" long long paged_decode_attention_smem(int G, int D, int kv_bf16) {
  return paged_attn::decode_smem(G, D, kv_bf16);
}
