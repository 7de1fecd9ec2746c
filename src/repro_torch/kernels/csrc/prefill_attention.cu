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
// its strides, and every horizon is clipped to S - 1, so a padded or
// inactive row near the end of its slot reads nothing past S. The body is
// the paged prefill's (paged_attention.cuh, prefill_rows) over a strided
// addressing: a CTA of 4 warps holds 64 of a (b, kv head)'s C*G rows (one
// m-tile of 16 a warp), a cluster of kPrefillSplit CTAs splits their
// positions, so the grid is (B, KV, kPrefillSplit * ceil(C*G / 64)); each
// CTA streams its run of 32-position tiles through a cp.async ring, with
// both products on the tensor cores, and the cluster combines the partial
// softmaxes on chip.
//
// Bound: at the serving shapes (C = 16, G = 8, cache <= 256 tokens) the
// kernel must read the positions up to start_len + C once per (b, kv head)
// and does 4 * d flops per (row, visible position): about 1.6 MB, 0.47 us
// of bytes — below a launch, so latency decides. One CTA stages each tile
// for 64 rows (this kernel's first design, a warp a row, staged it once
// per 8 rows as float32), a CTA's copies are all issued at once, the
// longest horizon is split four ways, and the products run on the tensor
// cores: mma.sync bf16 when q and the cache are both bfloat16, else TF32
// with each float32 operand split big + small (two products for q float32
// against a bfloat16 cache, three against a float32 one).
//
// Layouts: q (B, H, C, d) with strides (sqb, sqh, sqc) in elements and unit
// stride along d; k/v (B, KV, S, d) with strides (skb, skh, sks) shared by
// both and unit stride along d; start_len (B,) int32; out (B, H, C, d)
// contiguous in q's dtype.
#include "paged_attention.cuh"

namespace {

using paged_attn::kPrefillRows;
using paged_attn::kPrefillSplit;
using paged_attn::kPrefillThreads;
using paged_attn::PrefillTiles;
using paged_attn::StridedRows;

struct Params {
  const void* q;
  long long sqb, sqh, sqc;
  const void *k, *v;
  long long skb, skh, sks;
  const int32_t* start_len;
  const float* inv_freq;
  void* out;
  int H, KV, C, S, D, cbq, cb;
  float scale;
};

template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(kPrefillThreads, 1)
    prefill_kernel(Params p) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.KV;
  const StridedRows rows{b * p.skb + kvh * p.skh, p.sks};
  paged_attn::prefill_rows<TQ, TKV, DP>(
      static_cast<const TQ*>(p.q) + b * p.sqb + kvh * G * p.sqh, p.sqh, p.sqc,
      static_cast<TQ*>(p.out) +
          (static_cast<size_t>(b) * p.H + kvh * G) * p.C * p.D,
      static_cast<const TKV*>(p.k), static_cast<const TKV*>(p.v), rows,
      p.start_len[b], p.C, G, p.S, p.D, p.cbq, p.cb, p.inv_freq, p.scale);
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
      const size_t smem = PrefillTiles<TQ, TKV, DP>::kSmem;
      auto kernel = prefill_kernel<TQ, TKV, DP>;
      flash::allow_smem(kernel, smem);
      const int G = p.H / p.KV;
      const int blocks = (p.C * G + kPrefillRows - 1) / kPrefillRows;
      *status = paged_attn::launch_clusters(
          kernel, dim3(B, p.KV, blocks * kPrefillSplit), kPrefillThreads,
          smem, kPrefillSplit, stream, p);
    });
  }
};

}  // namespace

// Launches on `stream` and returns the launch's CUDA error (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and cache.
extern "C" int prefill_attention(const void* q, long long sqb, long long sqh,
                                 long long sqc, const void* k, const void* v,
                                 long long skb, long long skh, long long sks,
                                 const void* start_len, const void* inv_freq,
                                 void* out, int B, int H, int KV, int C,
                                 int S, int D, int q_bf16, int kv_bf16,
                                 float scale, void* stream) {
  const Params p{q, sqb, sqh, sqc, k, v, skb, skh, sks,
                 static_cast<const int32_t*>(start_len),
                 static_cast<const float*>(inv_freq), out, H, KV, C, S, D,
                 flash::copy_bytes(q_bf16 ? 2 : 4, D, {q}, {sqb, sqh, sqc}),
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

// The dynamic shared memory of one CTA (paged_attn::prefill_smem).
extern "C" long long prefill_attention_smem(int D, int q_bf16, int kv_bf16) {
  return paged_attn::prefill_smem(D, q_bf16, kv_bf16);
}
