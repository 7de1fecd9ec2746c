// Full-sequence flash attention on Hopper: the forward pass of training,
// eval and whole-prompt prefill. GQA, causal or not, q and k/v each float32
// or bfloat16.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention. It computes what
// the TPU kernel's body computes (flash_attention.py:27-68): an online
// softmax over KV tiles with a float32 running max m, sum l and
// accumulator; the causal mask kpos <= qpos with BOTH positions counted
// from 0, also when Sq != Skv; KV tiles wholly above the diagonal are not
// read; masked logits are -1e30; the output is acc / max(l, 1e-30) in q's
// dtype. On request it also writes lse = m + log(l) per query row (float32,
// (B, H, Sq)), from which the backward kernel (flash_attention_bwd.cu)
// recomputes the probabilities.
//
// Bound: operations. At the training and prefill shapes (B = 4, H = 32,
// KV = 4, d = 64, S = 1024-2048, causal) the work is 4·d flops a visible
// (query, key) pair against ~50-100 MB of bytes: far above the ridge of
// every route, and at d = 64 the exp of each pair (3.9e12 a second on the
// special-function units) costs about what the bf16 products cost. So the
// products run on the tensor cores (flash_mma.cuh):
//   * q and k/v bfloat16 — mma.sync m16n8k16 bf16, fragments by ldmatrix,
//     P rounded to bfloat16 in registers: the C fragment of S becomes the A
//     fragment of P·V (bound: 989 TFLOP/s);
//   * any float32 operand — 3xTF32 (big·big + big·small + small·big,
//     mma.sync m16n8k8), float32-accurate, so the float32 tolerance holds;
//     P stays in registers through the slot permutation of gemm_pv (bound:
//     494.7 / 3 TFLOP/s). A bfloat16 operand has no small part, and its
//     terms are not issued. The tensor cores truncate as they accumulate,
//     so each tile's P·V goes into a fresh fragment added to o in float32.
// The softmax works on raw logits: the running max is of q·k, and each
// probability is one FMA (log2(e)·scale folded in) and one ex2.approx.
//
// Design. One CTA of 4 warps per (query block, head, batch): grid
// (ceil(Sq/BM), H, B). Up to d = 64 a warp owns two m-tiles (32 rows,
// BM = 128), so every K and V fragment it loads (and, in 3xTF32, splits)
// serves two MMAs; wider heads take one (BM = 64), where 32 rows of
// accumulators would spill. The online softmax runs on the accumulator
// fragments (each thread holds two rows of each m-tile, row max and sum
// over a quad by shuffles). The query block is staged once; K/V tiles of
// 64 keys (32 at DP = 256, for shared memory) stream through a ring of two
// stages by cp.async with one barrier a tile — the next tile's copy is in
// flight while the current tile's products run. Rows are padded by 16
// bytes, so fragment loads are free of bank conflicts. 16-byte copies
// where every row's base and stride allow them, else 8, 4 (or 2 for a
// misaligned bfloat16 row): a launch-time choice inside this one kernel.
// The head dim is padded to DP in {32, 64, 96, 128, 160, 256}; columns
// past d are zero in shared memory and never stored, so every even d <= 256
// runs. Under the causal mask the query blocks with the most visible tiles
// are launched first (blockIdx.x reversed), so the long CTAs do not form
// the tail. A KV head's K and V are shared by its G query heads through L2
// (16.8 MB at S = 2048 float32, within the 50 MB L2); the heads are not
// packed into M.
//
// Layouts: q (B, H, Sq, d) with strides (sqb, sqh, sqs) in elements and unit
// stride along d; k/v (B, KV, Skv, d) with strides (skb, skh, sks) shared by
// both and unit stride along d; out (B, H, Sq, d) contiguous in q's dtype;
// lse (B, H, Sq) contiguous float32, or null.
#include "flash_mma.cuh"

namespace {

using flash::bf16;
using flash::kIsBf16;
using flash::pitch;

constexpr int kThreads = 128;  // 4 warps
// K/V tiles in flight: the copy of tile j + 1 overlaps tile j's products
// (three stages measured no faster in bf16, where they fit)
constexpr int kStages = 2;

template <typename TQ, typename TKV, int DP>
struct Tiles {
  // m-tiles of 16 query rows a warp: two up to d = 64 (each K and V
  // fragment then serves 32 rows), one above, where the accumulators of
  // 32 rows would spill
  static constexpr int kMT = DP <= 64 ? 2 : 1;
  // CTAs an SM should hold: the register budget ptxas gets (shared memory
  // allows 2 in float32 at DP = 64, 4 in bf16)
  static constexpr int kMinBlocks =
      kIsBf16<TQ> && kIsBf16<TKV> && DP <= 64 ? 3 : 1;
  static constexpr int kBM = 64 * kMT;  // query rows a CTA
  static constexpr int kBN = DP <= 160 ? 64 : 32;  // keys a K/V tile
  static constexpr int kPQ = pitch<TQ, DP>();
  static constexpr int kPK = pitch<TKV, DP>();
  static constexpr size_t kQBytes = size_t{kBM} * kPQ * sizeof(TQ);
  static constexpr size_t kKVBytes = size_t{kBN} * kPK * sizeof(TKV);
  // the query block, then the stages of K, then those of V
  static constexpr size_t kSmem = kQBytes + 2 * kStages * kKVBytes;
};

struct Params {
  const void* q;
  long long sqb, sqh, sqs;
  const void *k, *v;
  long long skb, skh, sks;
  void* out;
  float* lse;
  int H, KV, Sq, Skv, D, causal, cbq, cbkv;
  float scale;
};

template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(kThreads, (Tiles<TQ, TKV, DP>::kMinBlocks))
    flash_fwd_kernel(Params p) {
  using T = Tiles<TQ, TKV, DP>;
  constexpr bool kBf16 = kIsBf16<TQ> && kIsBf16<TKV>;
  constexpr int MT = T::kMT;
  constexpr int BM = T::kBM;
  constexpr int BN = T::kBN;
  constexpr int NT = BN / 8;   // n-tiles of S
  constexpr int NO = DP / 8;   // n-tiles of the output
  // n-tiles of the output per P·V product (its fresh fragment)
  constexpr int NC = NO % 8 != 0 || MT > 1 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);
  TKV* ks = reinterpret_cast<TKV*>(smem + T::kQBytes);
  constexpr int ST = kStages;
  TKV* vs = ks + ST * BN * T::kPK;

  const int qb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int nq = min(BM, p.Sq - q0);
  // keys [0, limit) can be visible to some row of the block
  const int limit = p.causal ? min(p.Skv, q0 + nq) : p.Skv;
  const int ntiles = (limit + BN - 1) / BN;
  const TQ* qg = static_cast<const TQ*>(p.q) + b * p.sqb + h * p.sqh +
                 static_cast<long long>(q0) * p.sqs;
  const long long kv_off = b * p.skb + kvh * p.skh;
  const TKV* kg = static_cast<const TKV*>(p.k) + kv_off;
  const TKV* vg = static_cast<const TKV*>(p.v) + kv_off;

  // K/V tile j into stage j % ST; one commit group a tile (empty past the
  // last), so "tile j has landed" is always "ST - 2 groups pending"
  auto load_kv = [&](int j) {
    if (j < ntiles) {
      const int n = min(BN, p.Skv - j * BN);
      const long long off = static_cast<long long>(j) * BN * p.sks;
      const int st = j % ST;
      flash::load_rows<BN, DP>(ks + st * BN * T::kPK, kg + off, p.sks, n,
                               p.D, p.cbkv);
      flash::load_rows<BN, DP>(vs + st * BN * T::kPK, vg + off, p.sks, n,
                               p.D, p.cbkv);
    }
    flash::cp_async_commit();
  };
  flash::load_rows<BM, DP>(qs, qg, p.sqs, nq, p.D, p.cbq);
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) load_kv(j);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = q0 + warp * 16 * MT;  // the warp's first query position
  const int wlast = wrow + 16 * MT - 1;
  const float sl2 = p.scale * flash::kLog2e;

  float o[MT][NO][4];
  flash::zero(o);
  // per row (m-tile m, half i): running max of the raw logits and this
  // thread's share of the sum (the quad's sum at the end)
  float m[MT][2];
  float l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    m[mt][0] = m[mt][1] = flash::kNegInf, l[mt][0] = l[mt][1] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % ST;
    flash::cp_async_wait<ST - 2>();
    // tile j is in, and every warp is done with tile j - 1, whose stage
    // the copy issued next refills
    __syncthreads();
    load_kv(j + ST - 1);
    const int k0 = j * BN;
    // a tile wholly above this warp's diagonal adds nothing to its rows
    if (!(p.causal && k0 > wlast)) {
      float s[MT][NT][4];
      flash::zero(s);
      flash::gemm_nt<kBf16, MT, NT, DP>(s, qs + warp * 16 * MT * T::kPQ,
                                        ks + st * BN * T::kPK);
      // masks on raw logits, and only where the tile crosses the diagonal
      // or the end of the keys
      if (k0 + BN > p.Skv || (p.causal && k0 + BN - 1 > wrow)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * n + 2 * t + (e & 1);
              const int row = wrow + 16 * mt + g + 8 * (e >> 1);
              if (key >= p.Skv || (p.causal && key > row))
                s[mt][n][e] = flash::kNegInf;
            }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float alpha[2];
        float ms[2];  // the new max, scaled to log2 units
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          ms[i] = mx[i] * sl2;
          alpha[i] = flash::fast_exp2(fmaf(m[mt][i], sl2, -ms[i]));
          m[mt][i] = mx[i];
          l[mt][i] *= alpha[i];
        }
        // p = 2^(s·scale·log2(e) − max·scale·log2(e)): one FMA and one exp
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = flash::fast_exp2(
                fmaf(s[mt][n][e], sl2, -ms[e >> 1]));
            s[mt][n][e] = pe;
            l[mt][e >> 1] += pe;
          }
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[e >> 1];
      }
      if constexpr (kBf16) {
        // bf16 route: straight into o (its tolerance is bf16's)
        flash::gemm_pv<kBf16, MT, NT, NO, DP>(o, s, vs + st * BN * T::kPK, 0);
      } else {
      // this tile's P·V in a fresh fragment, added to o in float32: the
      // tensor cores truncate as they accumulate, which over a 2048-key sum
      // would drift past the float32 tolerance
#pragma unroll
      for (int c0 = 0; c0 < NO; c0 += NC) {
        float pv[MT][NC][4];
        flash::zero(pv);
        flash::gemm_pv<kBf16, MT, NT, NC, DP>(pv, s, vs + st * BN * T::kPK,
                                              8 * c0);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][c0 + n][e] += pv[mt][n][e];
      }
      }
    }
  }

  TQ* out = static_cast<TQ*>(p.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = wrow + 16 * mt + g + 8 * i;
      if (row >= p.Sq) continue;
      const size_t r = (static_cast<size_t>(b) * p.H + h) * p.Sq + row;
      const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < p.D)
          flash::store2(out + r * p.D + col, o[mt][n][2 * i] * inv,
                        o[mt][n][2 * i + 1] * inv);
      }
      if (p.lse != nullptr && t == 0)
        p.lse[r] = m[mt][i] * p.scale + logf(li);
    }
}

struct Launcher {
  Params p;
  int B;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    flash::dispatch_dp(p.D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      const size_t smem = Tiles<TQ, TKV, DP>::kSmem;
      auto kernel = flash_fwd_kernel<TQ, TKV, DP>;
      flash::allow_smem(kernel, smem);
      constexpr int BM = Tiles<TQ, TKV, DP>::kBM;
      const dim3 grid((p.Sq + BM - 1) / BM, p.H, B);
      kernel<<<grid, kThreads, smem, stream>>>(p);
    });
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
  const int eq = q_bf16 ? 2 : 4;
  const int ekv = kv_bf16 ? 2 : 4;
  const Params p{q, sqb, sqh, sqs, k, v, skb, skh, sks, out,
                 static_cast<float*>(lse), H, KV, Sq, Skv, D, causal,
                 flash::copy_bytes(eq, D, {q}, {sqb, sqh, sqs}),
                 flash::copy_bytes(ekv, D, {k, v}, {skb, skh, sks}), scale};
  flash::dispatch_dtypes(q_bf16, kv_bf16,
                         Launcher{p, B, static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
