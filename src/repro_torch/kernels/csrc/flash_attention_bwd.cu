// Backward pass of full-sequence flash attention on Hopper: dq, dk, dv of
// softmax(q kᵀ / sqrt(d)) v, GQA, causal or not, float32 or bfloat16.
//
// No TPU kernel to replace: the JAX package cannot differentiate its Pallas
// flash kernel and trains on its jnp lowering instead
// (src/repro/models/transformer.py:123-126). On the card the port's
// attention in training IS the forward kernel (flash_attention.cu), so its
// gradient is this hand-written kernel, called from the autograd wrapper in
// repro_torch/kernels/flash_attention.py.
//
// Three entries, launched in order on one stream:
//   1. preprocess — delta = rowsum(dO ∘ O), float32 (B, H, Sq);
//   2. dK/dV — one CTA per (batch, KV head, tile of 32 key positions). It
//      keeps its K and V tiles in shared memory and walks, for each of the
//      G query heads of its group, the query tiles that can see them,
//      recomputing P = exp(q·k·scale − lse) and dS = P ∘ (dO·vᵀ − delta);
//      dV += Pᵀ dO and dK += dSᵀ (q·scale) accumulate in registers;
//   3. dQ — one CTA per (batch, head, tile of 32 query rows), walking the
//      key tiles up to its diagonal: dQ += dS K, times scale at the end.
// Every output element is owned by exactly one thread of one CTA and summed
// in a fixed order: no atomics, so the gradient is deterministic and
// repeated runs compare like with like. Causal tiles above the diagonal are
// skipped as in the forward; the ragged last tile of Sq or Skv is masked.
//
// Bound: operations, as in the forward — 2.5× its flops (q kᵀ again, dO vᵀ,
// Pᵀ dO, dSᵀ q, dS k: 10·d per visible (query, key) pair against the
// forward's 4·d). Like the forward it runs scalar FMAs from shared memory
// (rows padded to d+1 against bank conflicts; each thread holds 4 rows ×
// d/32 columns of its accumulators); the dK/dV CTA recomputes what the dQ
// CTA recomputes, the price of having no atomics. Tensor-core tiles are the
// step that moves it.
//
// Layouts: q, dO (B, H, Sq, d) and k, v (B, KV, Skv, d), each with its own
// (batch, head, position) strides in elements and unit stride along d; o
// (B, H, Sq, d) and lse (B, H, Sq) contiguous as the forward wrote them;
// dq (B, H, Sq, d) in q's dtype and dk, dv (B, KV, Skv, d) in k's dtype,
// contiguous.
#include "attention.cuh"

namespace {

using repro_attn::store_f32;
using repro_attn::to_f32;
using repro_attn::warp_sum;

constexpr int kTile = 32;                    // query rows / key positions
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kTile / kWarps;                   // 4
constexpr int kColsPerLane = repro_attn::kMaxHeadDim / 32;       // 8
constexpr int kLdP = kTile + 1;

struct Strides {
  long long b, h, s;
};

// Rows [0, n) of a tile of kTile rows, row t at src + t * row_stride, into
// float32 shared memory with row pitch D + 1, times `mul`; rows >= n are 0.
template <typename T>
__device__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                          long long row_stride, int n, int D, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
    const int t = i / D;
    const int e = i - t * D;
    dst[t * (D + 1) + e] =
        t < n ? to_f32(src[t * row_stride + e]) * mul : 0.f;
  }
}

// For the (i, j) pairs of this thread — key column j = lane, query rows
// i = warp + kWarps·m — the probability p = exp(s − lse_i) of the scaled
// logit s = (q·scale)·k (masked pairs: 0) and dS = p (dO·v − delta_i).
// Q holds q·scale. P may be null (the dQ pass needs only dS).
__device__ void scores_tile(const float* __restrict__ Q,
                            const float* __restrict__ dO,
                            const float* __restrict__ K,
                            const float* __restrict__ V,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ P, float* __restrict__ dS,
                            int q0, int k0, int nq, int nk, int causal,
                            int D) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ld = D + 1;
  const int j = lane;
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int i = warp + kWarps * m;
    const float* qr = Q + i * ld;
    const float* dr = dO + i * ld;
    const float* kr = K + j * ld;
    const float* vr = V + j * ld;
    float s = 0.f;
    float dp = 0.f;
    for (int e = 0; e < D; ++e) {
      s = fmaf(qr[e], kr[e], s);
      dp = fmaf(dr[e], vr[e], dp);
    }
    const bool valid = i < nq && j < nk && (!causal || k0 + j <= q0 + i);
    const float p = valid ? expf(s - lse[i]) : 0.f;
    if (P != nullptr) P[i * kLdP + j] = p;
    dS[i * kLdP + j] = p * (dp - delta[i]);
  }
}

// ------------------------------------------------------------ 1. delta
template <typename TQ>
__global__ void bwd_preprocess(const TQ* __restrict__ o,
                               const TQ* __restrict__ dout, Strides sd,
                               float* __restrict__ delta, int H, int Sq,
                               int D, long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const TQ* orow = o + r * D;
  const TQ* drow = dout + b * sd.b + h * sd.h + s * sd.s;
  float acc = 0.f;
  for (int e = lane; e < D; e += 32)
    acc = fmaf(to_f32(orow[e]), to_f32(drow[e]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[r] = acc;
}

// ------------------------------------------------------------ 2. dK, dV
template <typename TQ, typename TKV>
__global__ void bwd_dkdv(const TQ* __restrict__ q, Strides sq,
                         const TKV* __restrict__ k, const TKV* __restrict__ v,
                         Strides skv, const TQ* __restrict__ dout, Strides sd,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         TKV* __restrict__ dk, TKV* __restrict__ dv, int H,
                         int KV, int Sq, int Skv, int D, int causal,
                         float scale) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int nk = min(kTile, Skv - k0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kTile * ld;
  float* Ps = dOs + kTile * ld;
  float* dSs = Ps + kTile * kLdP;
  float* lse_s = dSs + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const long long kv_off = b * skv.b + kvh * skv.h + k0 * skv.s;
  load_tile(Ks, k + kv_off, skv.s, nk, D, 1.f);
  load_tile(Vs, v + kv_off, skv.s, nk, D, 1.f);

  float dk_acc[kRowsPerThread][kColsPerLane];
  float dv_acc[kRowsPerThread][kColsPerLane];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int n = 0; n < kColsPerLane; ++n) dk_acc[m][n] = dv_acc[m][n] = 0.f;

  // with kpos <= qpos, query rows before k0 see nothing of this tile
  const int first_qt = causal ? k0 / kTile : 0;
  const int nqt = (Sq + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = first_qt; qt < nqt; ++qt) {
      const int q0 = qt * kTile;
      const int nq = min(kTile, Sq - q0);
      const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq + q0;
      __syncthreads();  // the previous tile's Q, dO, P, dS are consumed
      load_tile(Qs, q + b * sq.b + h * sq.h + q0 * sq.s, sq.s, nq, D, scale);
      load_tile(dOs, dout + b * sd.b + h * sd.h + q0 * sd.s, sd.s, nq, D,
                1.f);
      if (threadIdx.x < kTile) {
        const bool in = static_cast<int>(threadIdx.x) < nq;
        lse_s[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.f;
        delta_s[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      scores_tile(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, nq, nk,
                  causal, D);
      __syncthreads();
      // key row j = warp + kWarps·m, column e = lane + 32·n
      for (int i = 0; i < nq; ++i) {
        float qe[kColsPerLane];
        float de[kColsPerLane];
#pragma unroll
        for (int n = 0; n < kColsPerLane; ++n) {
          const int e = lane + 32 * n;
          qe[n] = e < D ? Qs[i * ld + e] : 0.f;
          de[n] = e < D ? dOs[i * ld + e] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int j = warp + kWarps * m;
          const float p = Ps[i * kLdP + j];
          const float ds = dSs[i * kLdP + j];
#pragma unroll
          for (int n = 0; n < kColsPerLane; ++n) {
            dv_acc[m][n] = fmaf(p, de[n], dv_acc[m][n]);
            dk_acc[m][n] = fmaf(ds, qe[n], dk_acc[m][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int j = warp + kWarps * m;
    if (j >= nk) continue;
    const size_t row = (static_cast<size_t>(b) * KV + kvh) * Skv + k0 + j;
#pragma unroll
    for (int n = 0; n < kColsPerLane; ++n) {
      const int e = lane + 32 * n;
      if (e < D) {
        store_f32(dk + row * D + e, dk_acc[m][n]);
        store_f32(dv + row * D + e, dv_acc[m][n]);
      }
    }
  }
}

// ------------------------------------------------------------------ 3. dQ
template <typename TQ, typename TKV>
__global__ void bwd_dq(const TQ* __restrict__ q, Strides sq,
                       const TKV* __restrict__ k, const TKV* __restrict__ v,
                       Strides skv, const TQ* __restrict__ dout, Strides sd,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, TQ* __restrict__ dq,
                       int H, int KV, int Sq, int Skv, int D, int causal,
                       float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nq = min(kTile, Sq - q0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ld = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* dSs = Vs + kTile * ld;
  float* lse_s = dSs + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const size_t row0 = (static_cast<size_t>(b) * H + h) * Sq + q0;
  load_tile(Qs, q + b * sq.b + h * sq.h + q0 * sq.s, sq.s, nq, D, scale);
  load_tile(dOs, dout + b * sd.b + h * sd.h + q0 * sd.s, sd.s, nq, D, 1.f);
  if (threadIdx.x < kTile) {
    const bool in = static_cast<int>(threadIdx.x) < nq;
    lse_s[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.f;
    delta_s[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.f;
  }

  float acc[kRowsPerThread][kColsPerLane];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int n = 0; n < kColsPerLane; ++n) acc[m][n] = 0.f;

  // with kpos <= qpos, the tile's last row sees positions < q0 + nq
  const int limit = causal ? min(Skv, q0 + nq) : Skv;
  const int nkt = (limit + kTile - 1) / kTile;
  const long long kv_base = b * skv.b + kvh * skv.h;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Skv - k0);
    __syncthreads();  // the previous tile's K, V, dS are consumed
    load_tile(Ks, k + kv_base + k0 * skv.s, skv.s, nk, D, 1.f);
    load_tile(Vs, v + kv_base + k0 * skv.s, skv.s, nk, D, 1.f);
    __syncthreads();
    scores_tile(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0, nq,
                nk, causal, D);
    __syncthreads();
    // query row i = warp + kWarps·m, column e = lane + 32·n
    for (int j = 0; j < nk; ++j) {
      float ke[kColsPerLane];
#pragma unroll
      for (int n = 0; n < kColsPerLane; ++n) {
        const int e = lane + 32 * n;
        ke[n] = e < D ? Ks[j * ld + e] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const float ds = dSs[(warp + kWarps * m) * kLdP + j];
#pragma unroll
        for (int n = 0; n < kColsPerLane; ++n)
          acc[m][n] = fmaf(ds, ke[n], acc[m][n]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int i = warp + kWarps * m;
    if (i >= nq) continue;
#pragma unroll
    for (int n = 0; n < kColsPerLane; ++n) {
      const int e = lane + 32 * n;
      if (e < D) store_f32(dq + (row0 + i) * D + e, acc[m][n] * scale);
    }
  }
}

struct Launcher {
  const void* q;
  Strides sq;
  const void *k, *v;
  Strides skv;
  const void *o, *lse, *dout;
  Strides sd;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, KV, Sq, Skv, D, causal;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const long long rows = static_cast<long long>(B) * H * Sq;
    bwd_preprocess<TQ><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                         kThreads, 0, stream>>>(
        static_cast<const TQ*>(o), static_cast<const TQ*>(dout), sd, delta, H,
        Sq, D, rows);
    const size_t tile = static_cast<size_t>(kTile) * (D + 1);
    const size_t tail = static_cast<size_t>(kTile) * kLdP;
    const size_t smem_dkdv = (4 * tile + 2 * tail + 2 * kTile) * sizeof(float);
    auto dkdv = bwd_dkdv<TQ, TKV>;
    repro_attn::allow_smem(dkdv, smem_dkdv);
    dkdv<<<dim3((Skv + kTile - 1) / kTile, KV, B), kThreads, smem_dkdv,
           stream>>>(
        static_cast<const TQ*>(q), sq, static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), skv, static_cast<const TQ*>(dout), sd,
        static_cast<const float*>(lse), delta, static_cast<TKV*>(dk),
        static_cast<TKV*>(dv), H, KV, Sq, Skv, D, causal, scale);
    const size_t smem_dq = (4 * tile + tail + 2 * kTile) * sizeof(float);
    auto dqk = bwd_dq<TQ, TKV>;
    repro_attn::allow_smem(dqk, smem_dq);
    dqk<<<dim3((Sq + kTile - 1) / kTile, H, B), kThreads, smem_dq, stream>>>(
        static_cast<const TQ*>(q), sq, static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), skv, static_cast<const TQ*>(dout), sd,
        static_cast<const float*>(lse), delta, static_cast<TQ*>(dq), H, KV,
        Sq, Skv, D, causal, scale);
  }
};

}  // namespace

// Launches the three entries on `stream` and returns cudaGetLastError() (0
// on success). q_bf16 / kv_bf16 select bfloat16 (1) or float32 (0) for
// q/o/dO/dq and for k/v/dk/dv. `delta` is float32 scratch of B·H·Sq.
extern "C" int flash_attention_bwd(
    const void* q, long long sqb, long long sqh, long long sqs, const void* k,
    const void* v, long long skb, long long skh, long long sks, const void* o,
    const void* lse, const void* dout, long long sdb, long long sdh,
    long long sds, void* delta, void* dq, void* dk, void* dv, int B, int H,
    int KV, int Sq, int Skv, int D, int causal, int q_bf16, int kv_bf16,
    float scale, void* stream) {
  repro_attn::dispatch_dtypes(
      q_bf16, kv_bf16,
      Launcher{q, Strides{sqb, sqh, sqs}, k, v, Strides{skb, skh, sks}, o,
               lse, dout, Strides{sdb, sdh, sds}, static_cast<float*>(delta),
               dq, dk, dv, B, H, KV, Sq, Skv, D, causal, scale,
               static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
