// Paged prefill-chunk attention on Hopper: a C-token chunk per batch row
// against the paged KV pool (which already holds the chunk's own K/V), with
// a per-row causal horizon and RoPE fused at each row's position.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_prefill_attention.py::paged_prefill_attention.
// Query rows are flattened as r = c*G + g (chunk token c, query head g of
// the KV group), as on the TPU: row r sits at position start_len + r/G,
// rotates there, and attends cache positions <= start_len + r/G. The TPU
// kernel held all C*G rows of a (b, kv head) in one grid step and walked
// the pages in order; here a CTA of 4 warps holds 64 of those rows (one
// m-tile of 16 a warp) and a cluster of kPrefillSplit CTAs splits their
// positions, so the grid is (B, KV, kPrefillSplit * ceil(C*G / 64)). Each
// CTA walks its run of 32-position tiles, gathered across pages, through a
// cp.async ring, with both products on the tensor cores, and the cluster
// combines the partial softmaxes on chip (paged_attention.cuh,
// prefill_rows).
//
// Bound: at the serving shapes (C = 16, G = 8, cache <= 256 tokens) the
// kernel must read the positions up to start_len + C once per (b, kv head)
// and does 4 * d flops per (row, visible position): about 1.6 MB and 63
// MFLOP, 0.47 us of bytes — below a launch, so latency decides. One CTA
// stages each tile for 64 rows (a warp a row would stage it for 8, and
// as a float32 copy), a CTA's copies are
// all issued at once, the longest horizon is split four ways, and the
// products run on the tensor cores (two TF32 MMAs a product for q float32
// against a bfloat16 pool).
//
// Layouts: q (B, H, C, d) with strides (sqb, sqh, sqc) in elements and unit
// stride along d; pools (P, page, KV, d) contiguous; block_tables (B, nb)
// int32; start_len (B,) int32; out (B, H, C, d) contiguous in q's dtype.
#include "paged_attention.cuh"

namespace {

using paged_attn::kPrefillRows;
using paged_attn::kPrefillThreads;
using paged_attn::kPrefillSplit;
using paged_attn::kTableCache;
using paged_attn::PagedRows;
using paged_attn::PrefillTiles;

struct Params {
  const void* q;
  long long sqb, sqh, sqc;
  const void *k, *v;
  const int32_t* block_tables;
  const int32_t* start_len;
  const float* inv_freq;
  void* out;
  int H, KV, C, D, page, nb, cbq, cb;
  float scale;
};

template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(kPrefillThreads, 1)
    paged_prefill_kernel(Params p) {
  __shared__ int32_t table[kTableCache];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.KV;
  const int start = p.start_len[b];
  // the table entries the CTA's rows can reach, staged once in shared
  // memory (where they fit), so that no tile copy waits on a global load
  const int32_t* bt_row = p.block_tables + static_cast<size_t>(b) * p.nb;
  const int blk = static_cast<int>(blockIdx.z) / kPrefillSplit;
  const int last = min((blk + 1) * kPrefillRows, p.C * G) - 1;
  const int need = min(p.nb, (start + last / G) / p.page + 1);
  if (need <= kTableCache) {
    for (int i = threadIdx.x; i < need; i += blockDim.x) table[i] = bt_row[i];
    __syncthreads();
    bt_row = table;
  }
  const PagedRows rows{bt_row, p.page, static_cast<long long>(p.KV) * p.D,
                       static_cast<long long>(kvh) * p.D};
  paged_attn::prefill_rows<TQ, TKV, DP>(
      static_cast<const TQ*>(p.q) + b * p.sqb + kvh * G * p.sqh, p.sqh, p.sqc,
      static_cast<TQ*>(p.out) +
          (static_cast<size_t>(b) * p.H + kvh * G) * p.C * p.D,
      static_cast<const TKV*>(p.k), static_cast<const TKV*>(p.v), rows,
      start, p.C, G, p.nb * p.page, p.D, p.cbq, p.cb, p.inv_freq, p.scale);
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
      auto kernel = paged_prefill_kernel<TQ, TKV, DP>;
      // the static table cache counts against the default 48 KB too
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
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
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and pools.
extern "C" int paged_prefill_attention(
    const void* q, long long sqb, long long sqh, long long sqc,
    const void* k_pages, const void* v_pages, const void* block_tables,
    const void* start_len, const void* inv_freq, void* out, int B, int H,
    int KV, int C, int D, int page, int nb, int q_bf16, int kv_bf16,
    float scale, void* stream) {
  const Params p{q, sqb, sqh, sqc, k_pages, v_pages,
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(start_len),
                 static_cast<const float*>(inv_freq), out, H, KV, C, D, page,
                 nb, flash::copy_bytes(q_bf16 ? 2 : 4, D, {q}, {sqb, sqh, sqc}),
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

// The shared memory of one CTA: the dynamic (paged_attn::prefill_smem)
// and the static table cache (common.paged_prefill_smem mirrors it).
extern "C" long long paged_prefill_attention_smem(int D, int q_bf16,
                                                  int kv_bf16) {
  return paged_attn::prefill_smem(D, q_bf16, kv_bf16) +
         static_cast<long long>(kTableCache * sizeof(int32_t));
}
