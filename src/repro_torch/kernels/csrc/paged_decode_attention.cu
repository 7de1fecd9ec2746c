// Paged flash-decode on Hopper: one query token per batch row against the
// paged KV pool, with RoPE fused at position lengths-1.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention.
// The TPU grid (B, KV, nb) ran its page axis in order on one core and
// carried the online softmax in VMEM scratch; here one CTA per (b, kv head)
// walks the row's pages in a loop instead, with one warp per query head of
// the GQA group (G = H/KV warps), so the group reads each page once.
//
// Bound: bytes. Per row the kernel must read its valid pages of K and V
// (2 * length * d elements per KV head) and does 4 * length * d flops per
// query head — about 2 flops per byte for bf16 pools at G = 8, far below
// the card's ridge. The design keeps the pool in place (no gathered copy)
// and reads only pages below the row's length. At serving batch sizes the
// (B, KV) grid fills few of the 132 SMs; splitting the page loop across
// CTAs (split-K with a combine pass) is the next step.
//
// Layouts: q (B, H, d) with row strides (sqb, sqh) in elements and unit
// stride along d; pools (P, page, KV, d) contiguous; block_tables (B, nb)
// int32; lengths (B,) int32; out (B, H, d) contiguous in q's dtype.
#include "attention.cuh"

namespace {

using repro_attn::attend;
using repro_attn::PagedAddr;

template <typename TQ, typename TKV>
__global__ void paged_decode_kernel(const TQ* __restrict__ q, long long sqb,
                                    long long sqh,
                                    const TKV* __restrict__ k_pages,
                                    const TKV* __restrict__ v_pages,
                                    const int32_t* __restrict__ block_tables,
                                    const int32_t* __restrict__ lengths,
                                    const float* __restrict__ inv_freq,
                                    TQ* __restrict__ out, int H, int KV,
                                    int D, int page, int nb, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int h = kvh * G + (threadIdx.x >> 5);
  const int qpos = lengths[b] - 1;
  const PagedAddr addr{block_tables + static_cast<size_t>(b) * nb, nb, page,
                       static_cast<long long>(KV) * D,
                       static_cast<long long>(kvh) * D};
  attend<TQ, TKV>(q + b * sqb + h * sqh,
                  out + (static_cast<size_t>(b) * H + h) * D, true, qpos,
                  qpos, k_pages, v_pages, addr, D, inv_freq, scale);
}

struct Launcher {
  const void *q;
  long long sqb, sqh;
  const void *k_pages, *v_pages, *block_tables, *lengths, *inv_freq;
  void* out;
  int B, H, KV, D, page, nb;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const int G = H / KV;
    const size_t smem = repro_attn::smem_floats(G, page, D) * sizeof(float);
    auto kernel = paged_decode_kernel<TQ, TKV>;
    repro_attn::allow_smem(kernel, smem);
    kernel<<<dim3(B, KV), dim3(32 * G), smem, stream>>>(
        static_cast<const TQ*>(q), sqb, sqh, static_cast<const TKV*>(k_pages),
        static_cast<const TKV*>(v_pages),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(lengths),
        static_cast<const float*>(inv_freq), static_cast<TQ*>(out), H, KV, D,
        page, nb, scale);
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and pools.
extern "C" int paged_decode_attention(
    const void* q, long long sqb, long long sqh, const void* k_pages,
    const void* v_pages, const void* block_tables, const void* lengths,
    const void* inv_freq, void* out, int B, int H, int KV, int D, int page,
    int nb, int q_bf16, int kv_bf16, float scale, void* stream) {
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{q, sqb, sqh, k_pages, v_pages, block_tables, lengths,
               inv_freq, out, B, H, KV, D, page, nb, scale,
               static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
