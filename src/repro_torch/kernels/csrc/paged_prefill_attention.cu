// Paged prefill-chunk attention on Hopper: a C-token chunk per batch row
// against the paged KV pool (which already holds the chunk's own K/V), with
// a per-row causal horizon and RoPE fused at each row's position.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_prefill_attention.py::paged_prefill_attention.
// Query rows are flattened as r = c*G + g (chunk token c, query head g of
// the KV group), as on the TPU: row r sits at position start_len + r/G,
// rotates there, and attends cache positions <= start_len + r/G. The TPU
// kernel held all C*G rows of a (b, kv head) in one grid step; here a CTA
// of 8 warps takes 8 consecutive rows (one warp per row), so the grid is
// (B, KV, ceil(C*G / 8)) and a CTA stops at the last page its own rows
// can see.
//
// Bound: bytes at the serving shapes (C = 16, cache <= 256 tokens): per
// (b, kv head) the kernel must read the pages up to start_len + C once and
// does 4 * d flops per (row, visible position). The CTAs of one (b, kv
// head) each stage the same pages, so the pool is read ceil(C*G/8) times
// from L2 rather than once; a tensor-core (mma / wgmma) tile over all C*G
// rows is the step that removes both that and the scalar FMA loop.
//
// Layouts: q (B, H, C, d) with strides (sqb, sqh, sqc) in elements and unit
// stride along d; pools (P, page, KV, d) contiguous; block_tables (B, nb)
// int32; start_len (B,) int32; out (B, H, C, d) contiguous in q's dtype.
#include "attention.cuh"

namespace {

using repro_attn::attend;
using repro_attn::PagedAddr;

constexpr int kRowsPerCta = 8;

template <typename TQ, typename TKV>
__global__ void paged_prefill_kernel(
    const TQ* __restrict__ q, long long sqb, long long sqh, long long sqc,
    const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ start_len, const float* __restrict__ inv_freq,
    TQ* __restrict__ out, int H, int KV, int C, int D, int page, int nb,
    float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int rows = C * G;
  const int r0 = blockIdx.z * kRowsPerCta;
  const int r = r0 + (threadIdx.x >> 5);
  const int last = min(r0 + kRowsPerCta, rows) - 1;
  const int start = start_len[b];
  const bool has_row = r < rows;
  const int c = has_row ? r / G : 0;
  const int h = kvh * G + (has_row ? r % G : 0);
  const PagedAddr addr{block_tables + static_cast<size_t>(b) * nb, nb, page,
                       static_cast<long long>(KV) * D,
                       static_cast<long long>(kvh) * D};
  attend<TQ, TKV>(q + b * sqb + h * sqh + c * sqc,
                  out + ((static_cast<size_t>(b) * H + h) * C + c) * D,
                  has_row, start + c, start + last / G, k_pages, v_pages,
                  addr, D, inv_freq, scale);
}

struct Launcher {
  const void *q;
  long long sqb, sqh, sqc;
  const void *k_pages, *v_pages, *block_tables, *start_len, *inv_freq;
  void* out;
  int B, H, KV, C, D, page, nb;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const int G = H / KV;
    const dim3 grid(B, KV, (C * G + kRowsPerCta - 1) / kRowsPerCta);
    const size_t smem =
        repro_attn::smem_floats(kRowsPerCta, page, D) * sizeof(float);
    auto kernel = paged_prefill_kernel<TQ, TKV>;
    repro_attn::allow_smem(kernel, smem);
    kernel<<<grid, dim3(32 * kRowsPerCta), smem, stream>>>(
        static_cast<const TQ*>(q), sqb, sqh, sqc,
        static_cast<const TKV*>(k_pages), static_cast<const TKV*>(v_pages),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(start_len),
        static_cast<const float*>(inv_freq), static_cast<TQ*>(out), H, KV, C,
        D, page, nb, scale);
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and pools.
extern "C" int paged_prefill_attention(
    const void* q, long long sqb, long long sqh, long long sqc,
    const void* k_pages, const void* v_pages, const void* block_tables,
    const void* start_len, const void* inv_freq, void* out, int B, int H,
    int KV, int C, int D, int page, int nb, int q_bf16, int kv_bf16,
    float scale, void* stream) {
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{q, sqb, sqh, sqc, k_pages, v_pages, block_tables, start_len,
               inv_freq, out, B, H, KV, C, D, page, nb, scale,
               static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
