// Full-sequence flash attention on Hopper: the forward pass of training,
// eval and whole-prompt prefill. GQA, causal or not, q float32 or bfloat16.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention. It computes what
// the TPU kernel's body computes (flash_attention.py:27-68): an online
// softmax over KV tiles with a float32 running max m, sum l and
// accumulator; the causal mask kpos <= qpos with BOTH positions counted
// from 0, also when Sq != Skv; KV tiles wholly above the diagonal are not
// read; the output is acc / max(l, 1e-30) in q's dtype. On request it also
// writes lse = m + log(l) per query row (float32, (B, H, Sq)), which the
// backward kernel (flash_attention_bwd.cu) recomputes the probabilities
// from.
//
// The TPU kernel picks the largest block that divides S (a sequential grid
// carries m, l, acc in VMEM). Here a causal full-sequence pass is a prefill
// chunk with no history — start 0, C = Sq — so the walk is the contiguous
// prefill kernel's (attention.cuh): query rows flattened as r = c*G + g
// (query position c, head g of the KV group), one warp per row, 8 rows per
// CTA, the K/V tiles of 32 positions staged once in shared memory for all
// of the CTA's rows; the ragged last tile is cut at Skv (no divisor search,
// no padding). RoPE is not fused: attention_block rotates q before the
// call. Non-causal rows see every position (qpos = horizon = INT_MAX).
//
// Bound: operations. At the training shapes (B = 4, H = 32, S = 1024-2048,
// d = 64, causal) the work is 2·B·H·S²·d flops against ~50 MB of bytes, far
// above the float32 ridge. This kernel runs the dot products as scalar FMAs
// from shared memory (two shared loads per FMA), so it sits well below even
// the float32 SIMT peak; tensor-core (mma / wgmma) tiles over a block of
// query rows are the step that moves it.
//
// Layouts: q (B, H, Sq, d) with strides (sqb, sqh, sqs) in elements and unit
// stride along d; k/v (B, KV, Skv, d) with strides (skb, skh, sks) shared by
// both and unit stride along d; out (B, H, Sq, d) contiguous in q's dtype;
// lse (B, H, Sq) contiguous float32, or null.
#include <climits>

#include "attention.cuh"

namespace {

using repro_attn::attend;
using repro_attn::ContiguousAddr;
using repro_attn::kContiguousTile;

constexpr int kRowsPerCta = 8;

template <typename TQ, typename TKV>
__global__ void flash_fwd_kernel(const TQ* __restrict__ q, long long sqb,
                                 long long sqh, long long sqs,
                                 const TKV* __restrict__ k,
                                 const TKV* __restrict__ v, long long skb,
                                 long long skh, long long sks,
                                 TQ* __restrict__ out, float* __restrict__ lse,
                                 int H, int KV, int Sq, int Skv, int D,
                                 int causal, float scale) {
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerCta;
  const long long r = r0 + (threadIdx.x >> 5);
  const long long end = r0 + kRowsPerCta < rows ? r0 + kRowsPerCta : rows;
  const long long last = end - 1;
  const bool has_row = r < rows;
  const int c = has_row ? static_cast<int>(r / G) : 0;
  const int h = kvh * G + (has_row ? static_cast<int>(r % G) : 0);
  const ContiguousAddr addr{b * skb + kvh * skh, sks, Skv, kContiguousTile};
  const int qpos = causal ? c : INT_MAX;
  const int horizon = causal ? static_cast<int>(last / G) : INT_MAX;
  const size_t row_out = (static_cast<size_t>(b) * H + h) * Sq + c;
  attend<TQ, TKV>(q + b * sqb + h * sqh + c * sqs, out + row_out * D,
                  has_row, qpos, horizon, k, v, addr, D, nullptr, scale,
                  lse == nullptr ? nullptr : lse + row_out);
}

struct Launcher {
  const void* q;
  long long sqb, sqh, sqs;
  const void *k, *v;
  long long skb, skh, sks;
  void* out;
  float* lse;
  int B, H, KV, Sq, Skv, D, causal;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const long long rows = static_cast<long long>(Sq) * (H / KV);
    const dim3 grid(static_cast<unsigned>((rows + kRowsPerCta - 1) /
                                          kRowsPerCta),
                    KV, B);
    const size_t smem =
        repro_attn::smem_floats(kRowsPerCta, kContiguousTile, D) *
        sizeof(float);
    auto kernel = flash_fwd_kernel<TQ, TKV>;
    repro_attn::allow_smem(kernel, smem);
    kernel<<<grid, dim3(32 * kRowsPerCta), smem, stream>>>(
        static_cast<const TQ*>(q), sqb, sqh, sqs, static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), skb, skh, sks, static_cast<TQ*>(out), lse,
        H, KV, Sq, Skv, D, causal, scale);
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for q/out and k/v;
// lse may be null (no log-sum-exp written).
extern "C" int flash_attention(const void* q, long long sqb, long long sqh,
                               long long sqs, const void* k, const void* v,
                               long long skb, long long skh, long long sks,
                               void* out, void* lse, int B, int H, int KV,
                               int Sq, int Skv, int D, int causal, int q_bf16,
                               int kv_bf16, float scale, void* stream) {
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{q, sqb, sqh, sqs, k, v, skb, skh, sks, out,
               static_cast<float*>(lse), B, H, KV, Sq, Skv, D, causal, scale,
               static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
