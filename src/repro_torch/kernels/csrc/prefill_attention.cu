// Prefill-chunk attention on Hopper against the contiguous KV cache: a
// C-token chunk per batch row (whose own K/V the cache already holds), with
// a per-row causal horizon and RoPE fused at each row's position.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/prefill_attention.py::prefill_attention. Query rows are
// flattened as r = c*G + g (chunk token c, query head g of the KV group),
// as on the TPU: row r sits at position start_len + r/G, rotates there, and
// attends cache positions <= start_len + r/G. The TPU wrapper relaid the
// cache out head-major and padded S up to its s_block on every call; here
// the kernel reads the model-layout cache (B, S, KV, d) in place through
// its strides, with the last tile cut at S, so a horizon past S (a padded
// or inactive row near the end of its slot) reads nothing out of range. A
// CTA of 8 warps takes 8 consecutive rows (one warp per row): the grid is
// (B, KV, ceil(C*G / 8)) and a CTA stops at the last tile its own rows can
// see — the walk of attention.cuh with a contiguous address for each
// position.
//
// Bound: bytes at the serving shapes (C = 16, cache <= 256 tokens): per
// (b, kv head) the kernel must read the positions up to start_len + C once
// and does 4 * d flops per (row, visible position). The CTAs of one (b, kv
// head) each stage the same tiles, so the cache is read ceil(C*G/8) times
// from L2 rather than once; a tensor-core tile over 64 rows, as
// paged_attention.cuh has for the paged pool, removes both that and the
// scalar FMA loop.
//
// Layouts: q (B, H, C, d) with strides (sqb, sqh, sqc) in elements and unit
// stride along d; k/v (B, KV, S, d) with strides (skb, skh, sks) shared by
// both and unit stride along d; start_len (B,) int32; out (B, H, C, d)
// contiguous in q's dtype.
#include "attention.cuh"

namespace {

using repro_attn::attend;
using repro_attn::ContiguousAddr;
using repro_attn::kContiguousTile;

constexpr int kRowsPerCta = 8;

template <typename TQ, typename TKV>
__global__ void prefill_kernel(const TQ* __restrict__ q, long long sqb,
                               long long sqh, long long sqc,
                               const TKV* __restrict__ k,
                               const TKV* __restrict__ v, long long skb,
                               long long skh, long long sks,
                               const int32_t* __restrict__ start_len,
                               const float* __restrict__ inv_freq,
                               TQ* __restrict__ out, int H, int KV, int C,
                               int S, int D, float scale) {
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
  const ContiguousAddr addr{b * skb + kvh * skh, sks, S, kContiguousTile};
  attend<TQ, TKV>(q + b * sqb + h * sqh + c * sqc,
                  out + ((static_cast<size_t>(b) * H + h) * C + c) * D,
                  has_row, start + c, start + last / G, k, v, addr, D,
                  inv_freq, scale);
}

struct Launcher {
  const void *q;
  long long sqb, sqh, sqc;
  const void *k, *v;
  long long skb, skh, sks;
  const void *start_len, *inv_freq;
  void* out;
  int B, H, KV, C, S, D;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const int G = H / KV;
    const dim3 grid(B, KV, (C * G + kRowsPerCta - 1) / kRowsPerCta);
    const size_t smem =
        repro_attn::smem_floats(kRowsPerCta, kContiguousTile, D) *
        sizeof(float);
    auto kernel = prefill_kernel<TQ, TKV>;
    repro_attn::allow_smem(kernel, smem);
    kernel<<<grid, dim3(32 * kRowsPerCta), smem, stream>>>(
        static_cast<const TQ*>(q), sqb, sqh, sqc, static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), skb, skh, sks,
        static_cast<const int32_t*>(start_len),
        static_cast<const float*>(inv_freq), static_cast<TQ*>(out), H, KV, C,
        S, D, scale);
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and cache.
extern "C" int prefill_attention(const void* q, long long sqb, long long sqh,
                                 long long sqc, const void* k, const void* v,
                                 long long skb, long long skh, long long sks,
                                 const void* start_len, const void* inv_freq,
                                 void* out, int B, int H, int KV, int C,
                                 int S, int D, int q_bf16, int kv_bf16,
                                 float scale, void* stream) {
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{q, sqb, sqh, sqc, k, v, skb, skh, sks, start_len, inv_freq,
               out, B, H, KV, C, S, D, scale,
               static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
