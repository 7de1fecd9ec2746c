// Backward pass of full-sequence flash attention on Hopper: dq, dk, dv of
// softmax(q kᵀ / sqrt(d)) v, GQA, causal or not, q and k/v each float32 or
// bfloat16.
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
//   2. dK/dV — one CTA per (batch, KV head, 64 keys). Its K and V stay in
//      shared memory; it walks, for each of the G query heads of its group,
//      the query tiles that can see its keys, with Q, dO, lse and delta
//      double-buffered by cp.async. Per tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ,
//      Pᵀ = exp(Sᵀ·scale − lse), dSᵀ = Pᵀ ∘ (dPᵀ − delta), then dV += Pᵀ·dO
//      and dK += dSᵀ·Q — the probabilities never leave registers;
//   3. dQ — one CTA per (batch, head, 64 query rows), Q, dO, lse and delta
//      resident, walking the key tiles up to its diagonal, double-buffered:
//      S = Q·Kᵀ, dP = dO·Vᵀ, dQ += dS·K.
// dK and dQ are multiplied by scale once, at the store.
//
// Bound: operations — 10·d flops a visible (query, key) pair in the five
// products (this kernel recomputes S and dP in both passes: 14·d, the price
// of having no atomics), one exp a pair. All products run on the tensor
// cores in the forward's two routes (flash_mma.cuh): bf16 mma.sync when q
// and k/v are both bfloat16 (P and dS rounded to bfloat16 as they enter a
// product), 3xTF32 when any operand is float32 (float32-accurate, so the
// float32 tolerance holds). In 3xTF32 every tile's dV, dK or dQ product
// goes into a fresh fragment added to the sums in float32, and dP keeps
// the small terms apart (the tensor cores truncate as they accumulate, and
// dP − delta cancels); the bf16 route accumulates in place.
//
// Design. A warp owns 16 rows (keys in pass 2, queries in pass 3): its S
// and dP fragments are 16 × BQ, its accumulators 16 × CW. Up to d = 64 one
// warp keeps all columns (4 warps); wider heads split the columns over 2
// or 4 warps that share the rows and each recompute the rows' S and dP
// (d = 96-160: 8 warps; 256: 16), so the accumulators stay in registers.
// The streamed tile is BQ = 64 rows up to d = 128, 32 at 160 and 16 at 256,
// so the stages fit the 227 KB of shared memory. The dK/dV pass has few
// CTAs (B·KV·Skv/64: 256 at the training shape) and the one of the first
// keys walks every query tile of all G heads, so up to d = 64 its CTA holds
// two groups of 4 warps that walk the two halves of the (head, query tile)
// list side by side, each with its own stages and named barrier, and add
// their sums in a fixed order at the end. Every output element is owned by
// one thread of one CTA and summed in a fixed order: no atomics, so the
// gradient is deterministic and two runs are bitwise equal. Causal tiles
// above the diagonal are skipped, the ragged last tile of Sq or Skv is
// masked (pairs are tested only in tiles that cross the diagonal or an
// end), and nothing past Sq or Skv is read.
//
// Layouts: q, dO (B, H, Sq, d) and k, v (B, KV, Skv, d), each with its own
// (batch, head, position) strides in elements and unit stride along d; o
// (B, H, Sq, d) and lse (B, H, Sq) contiguous as the forward wrote them;
// dq (B, H, Sq, d) in q's dtype and dk, dv (B, KV, Skv, d) in k's dtype,
// contiguous.
#include "flash_mma.cuh"

namespace {

using flash::bf16;
using flash::kIsBf16;
using flash::pitch;
using flash::to_f32;
using flash::zero;

constexpr int kRows = 64;  // keys (dK/dV) or query rows (dQ) a CTA

template <typename TQ, typename TKV, int DP>
struct Tiles {
  static constexpr int kBQ = DP <= 128 ? 64 : (DP <= 160 ? 32 : 16);
  static constexpr int kSplit = DP <= 64 ? 1 : (DP <= 160 ? 2 : 4);
  static constexpr int kCW = DP / kSplit;  // accumulator columns a warp
  static constexpr int kThreads = 128 * kSplit;
  // dK/dV: groups of kThreads that walk halves of the (head, query tile)
  // list side by side (two up to d = 64, where the registers allow it)
  static constexpr int kGroups = DP <= 64 ? 2 : 1;
  static constexpr int kPQ = pitch<TQ, DP>();
  static constexpr int kPK = pitch<TKV, DP>();
  // the Q, dO, lse and delta stages of one group
  static constexpr size_t kStageBytes =
      2 * (2 * size_t{kBQ} * kPQ * sizeof(TQ) + 2 * kBQ * sizeof(float));
  // dK/dV: K, V (64 rows), then each group's stages
  static constexpr size_t kDkdvSmem =
      2 * size_t{kRows} * kPK * sizeof(TKV) + kGroups * kStageBytes;
  // dQ: Q, dO (64 rows), lse, delta; two stages of K, V (BQ rows)
  static constexpr size_t kDqSmem = 2 * size_t{kRows} * kPQ * sizeof(TQ) +
                                    2 * kRows * sizeof(float) +
                                    2 * 2 * size_t{kBQ} * kPK * sizeof(TKV);
};

struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  Strides sq;
  const void *k, *v;
  Strides skv;
  const void *o, *lse, *dout;
  Strides sd;
  float* delta;
  void *dq, *dk, *dv;
  int H, KV, Sq, Skv, D, causal, cbq, cbkv, cbd;
  float scale;
};

// p = exp(s·scale − lse) for a visible pair, else 0; dp <- p (dp − delta).
// s, dp: C fragments of 16 rows × 8·N columns; row position of element e is
// rpos[e >> 1], column position cpos0 + 8n + 2t + (e & 1). lse2 (log2 units)
// and delta of a pair come from lse2_of / delta_of(row half, column).
// masked: whether any pair of the tile may be masked (the warp's tile
// crosses the diagonal or a ragged end); if not, no pair is tested.
template <int N, typename Lse, typename Delta>
__device__ __forceinline__ void probs(float (&s)[N][4], float (&dp)[N][4],
                                      int Sq, int Skv, int causal,
                                      float scale, bool key_rows,
                                      bool masked, const int (&rpos)[2],
                                      int cpos0, Lse lse2_of,
                                      Delta delta_of) {
  const int t = threadIdx.x & 3;
  const float sl2 = scale * flash::kLog2e;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * t + (e & 1);
      const int r = rpos[e >> 1];
      const int cpos = cpos0 + c;
      const int qpos = key_rows ? cpos : r;
      const int kpos = key_rows ? r : cpos;
      const bool valid = !masked || (qpos < Sq && kpos < Skv &&
                                     (!causal || kpos <= qpos));
      const float pr =
          valid ? flash::fast_exp2(fmaf(s[n][e], sl2, -lse2_of(e >> 1, c)))
                : 0.f;
      s[n][e] = pr;
      dp[n][e] = pr * (dp[n][e] - delta_of(e >> 1, c));
    }
  }
}

// Rows row0 + {g, g + 8} (those < nrows) of a C fragment of 16 × 8·N,
// columns col0 + 8n + 2t (those < d), times mul, into a contiguous
// (…, d) tensor at dst (row 0).
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&c)[N][4],
                                           int row0, int nrows, int col0,
                                           int d, float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int col = col0 + 8 * n + 2 * t;
      if (col < d)
        flash::store2(dst + static_cast<size_t>(r) * d + col,
                      c[n][2 * i] * mul, c[n][2 * i + 1] * mul);
    }
  }
}

// ------------------------------------------------------------ 1. delta
template <typename TQ>
__global__ void bwd_preprocess(const TQ* __restrict__ o,
                               const TQ* __restrict__ dout, Strides sd,
                               float* __restrict__ delta, int H, int Sq,
                               int D, long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
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
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ------------------------------------------------------------ 2. dK, dV
template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__((Tiles<TQ, TKV, DP>::kThreads *
                                   Tiles<TQ, TKV, DP>::kGroups))
    bwd_dkdv(Params p) {
  using T = Tiles<TQ, TKV, DP>;
  constexpr bool kBf16 = kIsBf16<TQ> && kIsBf16<TKV>;
  constexpr int BQ = T::kBQ;
  constexpr int NS = BQ / 8;        // n-tiles of Sᵀ, dPᵀ
  constexpr int NO = T::kCW / 8;    // n-tiles of the warp's dK, dV columns
  constexpr int NT = T::kThreads;   // threads of a group
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ks = reinterpret_cast<TKV*>(smem);
  TKV* vs = ks + kRows * T::kPK;
  const int grp_id = threadIdx.x / NT;
  const int tid = threadIdx.x - grp_id * NT;
  unsigned char* stages =
      reinterpret_cast<unsigned char*>(vs + kRows * T::kPK);
  TQ* qs = reinterpret_cast<TQ*>(stages + grp_id * T::kStageBytes);
  TQ* dos = qs + 2 * BQ * T::kPQ;                        // 2 stages each
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * T::kPQ);
  float* delta_s = lse_s + 2 * BQ;

  const int k0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int nk = min(kRows, p.Skv - k0);
  const long long kv_off = b * p.skv.b + kvh * p.skv.h +
                           static_cast<long long>(k0) * p.skv.s;
  flash::load_rows<kRows, DP>(ks, static_cast<const TKV*>(p.k) + kv_off,
                              p.skv.s, nk, p.D, p.cbkv);
  flash::load_rows<kRows, DP>(vs, static_cast<const TKV*>(p.v) + kv_off,
                              p.skv.s, nk, p.D, p.cbkv);

  // with kpos <= qpos, query rows before k0 see nothing of these keys
  const int first_qt = p.causal ? k0 / BQ : 0;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int per_head = max(nqt - first_qt, 0);
  const int iters = G * per_head;
  // this group's share of the (head, query tile) list
  const int it0 = grp_id * iters / T::kGroups;
  const int it1 = (grp_id + 1) * iters / T::kGroups;
  // the Q, dO, lse, delta tiles of iteration it into stage st
  auto stage = [&](int it, int st) {
    const int h = kvh * G + it / per_head;
    const int q0 = (first_qt + it % per_head) * BQ;
    const int nq = min(BQ, p.Sq - q0);
    const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.Sq + q0;
    flash::load_rows<BQ, DP>(
        qs + st * BQ * T::kPQ,
        static_cast<const TQ*>(p.q) + b * p.sq.b + h * p.sq.h +
            static_cast<long long>(q0) * p.sq.s,
        p.sq.s, nq, p.D, p.cbq, tid, NT);
    flash::load_rows<BQ, DP>(
        dos + st * BQ * T::kPQ,
        static_cast<const TQ*>(p.dout) + b * p.sd.b + h * p.sd.h +
            static_cast<long long>(q0) * p.sd.s,
        p.sd.s, nq, p.D, p.cbd, tid, NT);
    flash::load_vec(lse_s + st * BQ, static_cast<const float*>(p.lse) + row0,
                    nq, BQ, tid, NT);
    flash::load_vec(delta_s + st * BQ, p.delta + row0, nq, BQ, tid, NT);
  };
  if (it0 < it1) stage(it0, 0);
  flash::cp_async_commit();
  // K and V come from every thread's copies: wait for all, CTA-wide, once
  flash::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int grp = warp & 3;          // rows 16·grp.. of the 64 keys
  const int col0 = (warp >> 2) * T::kCW;
  const int lane = threadIdx.x & 31;
  const int kfirst = k0 + grp * 16;
  const int rpos[2] = {kfirst + (lane >> 2), kfirst + (lane >> 2) + 8};

  float dk[NO][4];
  float dv[NO][4];
  zero(dk);
  zero(dv);

  for (int it = it0; it < it1; ++it) {
    const int st = (it - it0) & 1;
    if (it + 1 < it1) {
      stage(it + 1, st ^ 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    flash::sync_group(1 + grp_id, NT);
    const int q0 = (first_qt + it % per_head) * BQ;
    // a tile whose queries all precede this warp's keys adds nothing
    if (!(p.causal && kfirst > q0 + BQ - 1)) {
      const TQ* qt = qs + st * BQ * T::kPQ;
      const TQ* dot = dos + st * BQ * T::kPQ;
      const float* ls = lse_s + st * BQ;
      const float* dl = delta_s + st * BQ;
      float s[NS][4];
      float dp[NS][4];
      zero(s);
      zero(dp);
      flash::gemm_nt<kBf16, NS, DP>(s, ks + grp * 16 * T::kPK, qt);
      flash::gemm_nt<kBf16, NS, DP, true>(dp, vs + grp * 16 * T::kPK, dot);
      // keys kfirst..+15 against queries q0..q0+BQ-1
      const bool masked = q0 + BQ > p.Sq || kfirst + 16 > p.Skv ||
                          (p.causal && kfirst + 15 > q0);
      probs(s, dp, p.Sq, p.Skv, p.causal, p.scale, true, masked, rpos, q0,
            [&](int, int c) { return ls[c] * flash::kLog2e; },
            [&](int, int c) { return dl[c]; });
      if constexpr (kBf16) {  // bf16 route: straight into the sums
        flash::gemm_pv<kBf16, NS, NO, DP>(dv, s, dot, col0);
        flash::gemm_pv<kBf16, NS, NO, DP>(dk, dp, qt, col0);
      } else {  // a fresh fragment a tile, added in float32
        float part[NO][4];
        zero(part);
        flash::gemm_pv<kBf16, NS, NO, DP>(part, s, dot, col0);
        flash::add_to(dv, part);
        zero(part);
        flash::gemm_pv<kBf16, NS, NO, DP>(part, dp, qt, col0);
        flash::add_to(dk, part);
      }
    }
    flash::sync_group(1 + grp_id, NT);  // the stage is refilled next
  }

  if constexpr (T::kGroups > 1) {
    // group 0's sums plus group 1's, in that order, through the (now free)
    // stages: element i of thread tid at red[i·NT + tid]
    float* red = reinterpret_cast<float*>(stages);
    __syncthreads();
    if (grp_id == 1) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(4 * n + e) * NT + tid] = dk[n][e];
          red[(4 * (NO + n) + e) * NT + tid] = dv[n][e];
        }
    }
    __syncthreads();
    if (grp_id == 1) return;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] += red[(4 * n + e) * NT + tid];
        dv[n][e] += red[(4 * (NO + n) + e) * NT + tid];
      }
  }

  const size_t base = (static_cast<size_t>(b) * p.KV + kvh) * p.Skv;
  store_rows(static_cast<TKV*>(p.dk) + base * p.D, dk, kfirst, p.Skv, col0,
             p.D, p.scale);
  store_rows(static_cast<TKV*>(p.dv) + base * p.D, dv, kfirst, p.Skv, col0,
             p.D, 1.f);
}

// ------------------------------------------------------------------ 3. dQ
template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(Tiles<TQ, TKV, DP>::kThreads)
    bwd_dq(Params p) {
  using T = Tiles<TQ, TKV, DP>;
  constexpr bool kBf16 = kIsBf16<TQ> && kIsBf16<TKV>;
  constexpr int BK = T::kBQ;
  constexpr int NS = BK / 8;
  constexpr int NO = T::kCW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);
  TQ* dos = qs + kRows * T::kPQ;
  float* lse_s = reinterpret_cast<float*>(dos + kRows * T::kPQ);
  float* delta_s = lse_s + kRows;
  TKV* ks = reinterpret_cast<TKV*>(delta_s + kRows);  // 2 stages
  TKV* vs = ks + 2 * BK * T::kPK;                      // 2 stages

  // under the causal mask the query blocks that walk the most key tiles
  // are the last ones: launched first, they do not form the tail
  const int q0 = (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int nq = min(kRows, p.Sq - q0);
  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.Sq + q0;
  flash::load_rows<kRows, DP>(
      qs, static_cast<const TQ*>(p.q) + b * p.sq.b + h * p.sq.h +
              static_cast<long long>(q0) * p.sq.s,
      p.sq.s, nq, p.D, p.cbq);
  flash::load_rows<kRows, DP>(
      dos, static_cast<const TQ*>(p.dout) + b * p.sd.b + h * p.sd.h +
               static_cast<long long>(q0) * p.sd.s,
      p.sd.s, nq, p.D, p.cbd);
  flash::load_vec(lse_s, static_cast<const float*>(p.lse) + row0, nq, kRows);
  flash::load_vec(delta_s, p.delta + row0, nq, kRows);

  // with kpos <= qpos, the block's last row sees keys < q0 + nq
  const int limit = p.causal ? min(p.Skv, q0 + nq) : p.Skv;
  const int nkt = (limit + BK - 1) / BK;
  const long long kv_base = b * p.skv.b + kvh * p.skv.h;
  auto stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    const long long off = kv_base + static_cast<long long>(k0) * p.skv.s;
    const int n = min(BK, p.Skv - k0);
    flash::load_rows<BK, DP>(ks + st * BK * T::kPK,
                             static_cast<const TKV*>(p.k) + off, p.skv.s, n,
                             p.D, p.cbkv);
    flash::load_rows<BK, DP>(vs + st * BK * T::kPK,
                             static_cast<const TKV*>(p.v) + off, p.skv.s, n,
                             p.D, p.cbkv);
  };
  stage(0, 0);
  flash::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int grp = warp & 3;
  const int col0 = (warp >> 2) * T::kCW;
  const int lane = threadIdx.x & 31;
  const int qfirst = q0 + grp * 16;
  const int rpos[2] = {qfirst + (lane >> 2), qfirst + (lane >> 2) + 8};
  const int lr[2] = {grp * 16 + (lane >> 2), grp * 16 + (lane >> 2) + 8};
  float lse2[2];
  float dl[2];

  float dq[NO][4];
  zero(dq);

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nkt) {
      stage(kt + 1, st ^ 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse2[i] = lse_s[lr[i]] * flash::kLog2e;
        dl[i] = delta_s[lr[i]];
      }
    }
    const int k0 = kt * BK;
    // a tile wholly above this warp's diagonal adds nothing to its rows
    if (!(p.causal && k0 > qfirst + 15)) {
      const TKV* kt_s = ks + st * BK * T::kPK;
      float s[NS][4];
      float dp[NS][4];
      zero(s);
      zero(dp);
      flash::gemm_nt<kBf16, NS, DP>(s, qs + grp * 16 * T::kPQ, kt_s);
      flash::gemm_nt<kBf16, NS, DP, true>(dp, dos + grp * 16 * T::kPQ,
                                          vs + st * BK * T::kPK);
      // queries qfirst..+15 against keys k0..k0+BK-1
      const bool masked = qfirst + 16 > p.Sq || k0 + BK > p.Skv ||
                          (p.causal && k0 + BK - 1 > qfirst);
      probs(s, dp, p.Sq, p.Skv, p.causal, p.scale, false, masked, rpos, k0,
            [&](int i, int) { return lse2[i]; },
            [&](int i, int) { return dl[i]; });
      if constexpr (kBf16) {  // bf16 route: straight into the sum
        flash::gemm_pv<kBf16, NS, NO, DP>(dq, dp, kt_s, col0);
      } else {  // a fresh fragment a tile, added in float32
        float part[NO][4];
        zero(part);
        flash::gemm_pv<kBf16, NS, NO, DP>(part, dp, kt_s, col0);
        flash::add_to(dq, part);
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }

  store_rows(static_cast<TQ*>(p.dq) + row0 * p.D, dq, grp * 16, nq, col0,
             p.D, p.scale);
}

struct Launcher {
  Params p;
  int B;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  void run() const {
    const long long rows = static_cast<long long>(B) * p.H * p.Sq;
    bwd_preprocess<TQ><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                         stream>>>(
        static_cast<const TQ*>(p.o), static_cast<const TQ*>(p.dout), p.sd,
        p.delta, p.H, p.Sq, p.D, rows);
    flash::dispatch_dp(p.D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      using T = Tiles<TQ, TKV, DP>;
      auto dkdv = bwd_dkdv<TQ, TKV, DP>;
      flash::allow_smem(dkdv, T::kDkdvSmem);
      dkdv<<<dim3((p.Skv + kRows - 1) / kRows, p.KV, B),
             T::kThreads * T::kGroups, T::kDkdvSmem, stream>>>(p);
      auto dqk = bwd_dq<TQ, TKV, DP>;
      flash::allow_smem(dqk, T::kDqSmem);
      dqk<<<dim3((p.Sq + kRows - 1) / kRows, p.H, B), T::kThreads,
            T::kDqSmem, stream>>>(p);
    });
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
  const int eq = q_bf16 ? 2 : 4;
  const int ekv = kv_bf16 ? 2 : 4;
  const Params p{q, Strides{sqb, sqh, sqs}, k, v, Strides{skb, skh, sks}, o,
                 lse, dout, Strides{sdb, sdh, sds},
                 static_cast<float*>(delta), dq, dk, dv, H, KV, Sq, Skv, D,
                 causal, flash::copy_bytes(eq, D, {q}, {sqb, sqh, sqs}),
                 flash::copy_bytes(ekv, D, {k, v}, {skb, skh, sks}),
                 flash::copy_bytes(eq, D, {dout}, {sdb, sdh, sds}), scale};
  flash::dispatch_dtypes(q_bf16, kv_bf16,
                         Launcher{p, B, static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
