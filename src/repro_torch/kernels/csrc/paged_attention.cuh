// Device code of the serving attention kernels on Hopper: decode split
// across a thread-block cluster, and chunk prefill on the tensor cores.
// Both read the KV cache in place, in the model's layout, through an
// addressing functor `rows` — rows(p) is the element offset of position
// p's head vector (d contiguous values) in the K and V arrays — so one body
// serves every cache layout: PagedRows is the paged pool's
// (paged_decode_attention.cu, paged_prefill_attention.cu), StridedRows the
// contiguous cache's (decode_attention.cu, prefill_attention.cu).
//
// Contracts carried over from the JAX package:
//   * fused RoPE in float32, split halves, q rotated at the row's position;
//     1/sqrt(d) applied to the logits;
//   * a row at position qpos attends positions <= qpos (decode: < length);
//   * masked logits are -1e30; the output is acc / max(l, 1e-30), so a
//     decode row of length 0 gives 0;
//   * no position at or past a row's horizon is read: such rows of a tile
//     are zero-filled by cp.async, so stale pool contents (the sentinel
//     page 0, unmapped table entries) never reach the arithmetic.
//
// A tile is a run of consecutive positions gathered across page
// boundaries, so any page size fills it. Tiles are staged with cp.async in
// the cache's own dtype (bfloat16 or float32; flash_mma.cuh's copy-width
// choice and row pitch), never converted to a float32 copy.
//
// decode_split — one query token per batch row. The CTA owns the G query
// heads of one KV head (one warp each); the kSplit CTAs of a cluster take
// contiguous runs of the row's 32-position tiles, issue all of their
// copies at once (a ring of kStages tiles where the run is longer), and
// each keep a partial (m, l, acc) per head. Lanes split a tile's
// positions for the scores (16-byte shared loads of a K row, conflict-free
// under the 16-byte row pad) and the head dim for P·V. After a cluster
// barrier every rank combines 1/kSplit of the G·d outputs from all ranks'
// partials through distributed shared memory (mapa + ld.shared::cluster),
// in rank order: deterministic, one launch, no global scratch, no atomics.
//
// prefill_rows — a C-token chunk of one batch row against the cache. A CTA
// of 4 warps holds 64 of the C·G query rows of one (b, KV head), flattened
// r = c·G + g; each warp one m-tile of 16. The kPrefillSplit CTAs of a
// cluster split the rows' positions as the decode does and combine the
// same way. q is copied in with cp.async and rotated once in shared memory
// (the angles tabled per position, since G rows share each); 32-position
// K/V tiles stream through a 2-4 stage cp.async ring;
// S = Q·Kᵀ and O += P·V run on the tensor cores through flash_mma.cuh's
// gemm_nt / gemm_pv: mma.sync bf16 when q and the cache are both bfloat16,
// else TF32 with each float32 operand split big + small (a bfloat16
// operand is exact in TF32: two MMAs a product with q float32 and a
// bfloat16 cache, three with a float32 cache). Each tile's P·V goes into a
// fresh fragment added in float32 (the tensor cores truncate as they
// accumulate). Rows mask at start + r/G; a warp skips tiles past its last
// row's horizon, and the CTA loads none past its own.
#pragma once

#include "flash_mma.cuh"

namespace paged_attn {

using flash::bf16;
using flash::kIsBf16;
using flash::pitch;
using repro_attn::kNegInf;
using repro_attn::to_f32;

// dynamic shared memory a Hopper CTA may use
constexpr size_t kSmemLimit = 232448;

// -------------------------------------------------------------- addressing
// Position p of a batch row lives in page bt_row[p / page] of the pool
// (P, page, KV, d), at slot p % page; `head` is the KV head's offset.
struct PagedRows {
  const int32_t* bt_row;
  int page;
  long long stride;  // KV * d: between slots of a page
  long long head;    // kvh * d
  __device__ __forceinline__ long long operator()(int p) const {
    const int j = p / page;
    return (static_cast<long long>(bt_row[j]) * page + (p - j * page)) *
               stride + head;
  }
};

// Position p of one (batch row, KV head) of the contiguous cache, seen as
// (B, KV, S, d) with any strides (unit along d): row = b·skb + kvh·skh,
// stride = sks. The launcher clips every horizon to S, so the spare drop
// position at S and everything past it stay unread.
struct StridedRows {
  long long row;
  long long stride;
  __device__ __forceinline__ long long operator()(int p) const {
    return row + static_cast<long long>(p) * stride;
  }
};

// ---------------------------------------------------------------- clusters
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster: shared-memory writes before it
// are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The float at p (this CTA's shared memory) in the CTA of cluster rank r.
__device__ __forceinline__ float ld_rank(const float* p, int r) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(s), "r"(r));
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x)
               : "r"(remote)
               : "memory");
  return x;
}

// The float pair at p (8-byte aligned) in the CTA of cluster rank r.
__device__ __forceinline__ float2 ld_rank2(const float* p, int r) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(s), "r"(r));
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(remote)
               : "memory");
  return x;
}

// ----------------------------------------------------------------- staging
// Rows [0, n) of a ROWS × DP tile, row r at src + off(r), columns [0, d),
// into shared memory with row pitch pitch<T, DP>(); every other element is
// zeroed (rows past n, columns past d). CB bytes a copy, as
// flash::load_rows_cb, whose rows lie at one stride.
template <int CB, int ROWS, int DP, typename T, typename Off>
__device__ __forceinline__ void copy_rows_cb(T* dst, const T* src,
                                             const Off& off, int n, int d) {
  constexpr int E = CB / static_cast<int>(sizeof(T));
  constexpr int P = pitch<T, DP>();
  constexpr int CPR = DP / E;
  for (int i = threadIdx.x; i < ROWS * CPR; i += blockDim.x) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * E;
    const bool in = r < n && c < d;
    const T* s = in ? src + off(r) + c : src;
    if constexpr (CB >= 4)
      flash::cp_async<CB>(dst + r * P + c, s, in);
    else
      dst[r * P + c] = in ? *s : __float2bfloat16(0.f);
  }
}

template <int ROWS, int DP, typename T, typename Off>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          const Off& off, int n, int d,
                                          int cb) {
  if (cb == 16)
    copy_rows_cb<16, ROWS, DP>(dst, src, off, n, d);
  else if (cb == 8)
    copy_rows_cb<8, ROWS, DP>(dst, src, off, n, d);
  else if constexpr (sizeof(T) == 4)
    copy_rows_cb<4, ROWS, DP>(dst, src, off, n, d);
  else if (cb == 4)
    copy_rows_cb<4, ROWS, DP>(dst, src, off, n, d);
  else
    copy_rows_cb<2, ROWS, DP>(dst, src, off, n, d);
}

// Positions p0 .. p0 + n - 1 (n <= ROWS) of K and V into two tiles.
template <int ROWS, int DP, typename T, typename Rows>
__device__ __forceinline__ void gather(T* ks, T* vs, const T* k, const T* v,
                                       const Rows& rows, int p0, int n,
                                       int d, int cb) {
  const auto off = [&](int r) { return rows(p0 + r); };
  copy_rows<ROWS, DP>(ks, k, off, n, d, cb);
  copy_rows<ROWS, DP>(vs, v, off, n, d, cb);
}

// The pair (x1, x2) of columns i and i + d/2 rotated by the angle whose
// sine and cosine are sn, cs (split-halves RoPE).
__device__ __forceinline__ void rotate_pair(float& x1, float& x2, float sn,
                                            float cs) {
  const float r1 = x1 * cs - x2 * sn;
  const float r2 = x1 * sn + x2 * cs;
  x1 = r1;
  x2 = r2;
}

// The same at position pos with inv_freq (none if null).
__device__ __forceinline__ void rope_pair(float& x1, float& x2, int pos,
                                          const float* inv_freq, int i) {
  if (inv_freq == nullptr) return;
  float sn;
  float cs;
  sincosf(static_cast<float>(pos) * inv_freq[i], &sn, &cs);
  rotate_pair(x1, x2, sn, cs);
}

// ------------------------------------------------------------------ decode
constexpr int kSplit = 8;         // CTAs of a decode cluster: the portable
                                  // maximum
constexpr int kDecodeTile = 32;   // positions a tile: one a lane

template <typename TKV, int DP>
struct DecodeTiles {
  static constexpr int kP = pitch<TKV, DP>();
  // one ring stage: a K tile, then a V tile
  static constexpr size_t kStageBytes =
      size_t{2} * kDecodeTile * kP * sizeof(TKV);
  // the rotated queries of at most 32 heads, float32
  static constexpr size_t kQMax = size_t{32} * DP * sizeof(float);
  static constexpr int kStages =
      4 * kStageBytes + kQMax <= kSmemLimit ? 4 : 2;
  // the partials (m, l, acc of G heads) reuse the ring once it is drained
  static_assert(kStages * kStageBytes >= (size_t{2} + DP) * 32 * 4,
                "partials fit the ring");
  static size_t smem(int G) {
    return kStages * kStageBytes + static_cast<size_t>(G) * DP * sizeof(float);
  }
};

// q·k over DP columns: q float32 in shared memory (broadcast to the warp),
// k one staged row, read 16 bytes at a time.
template <int DP>
__device__ __forceinline__ float dot_row(const float* q, const bf16* k) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < DP; e += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + e);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 qa = *reinterpret_cast<const float4*>(q + e);
    const float4 qb = *reinterpret_cast<const float4*>(q + e + 4);
    const float2 k0 = __bfloat1622float2(h[0]);
    const float2 k1 = __bfloat1622float2(h[1]);
    const float2 k2 = __bfloat1622float2(h[2]);
    const float2 k3 = __bfloat1622float2(h[3]);
    s = fmaf(qa.x, k0.x, s);
    s = fmaf(qa.y, k0.y, s);
    s = fmaf(qa.z, k1.x, s);
    s = fmaf(qa.w, k1.y, s);
    s = fmaf(qb.x, k2.x, s);
    s = fmaf(qb.y, k2.y, s);
    s = fmaf(qb.z, k3.x, s);
    s = fmaf(qb.w, k3.y, s);
  }
  return s;
}

template <int DP>
__device__ __forceinline__ float dot_row(const float* q, const float* k) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < DP; e += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(k + e);
    const float4 qv = *reinterpret_cast<const float4*>(q + e);
    s = fmaf(qv.x, kv.x, s);
    s = fmaf(qv.y, kv.y, s);
    s = fmaf(qv.z, kv.z, s);
    s = fmaf(qv.w, kv.w, s);
  }
  return s;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One batch row's decode for the G heads of one KV head (blockDim = 32·G),
// this CTA's share being cluster rank cluster_rank() of kSplit.
//   q      — head 0 of the group (d values, unit stride); head g at g·sqh
//   out    — G rows of d values, contiguous
//   len    — positions to attend, clipped to those the addressing holds:
//            [0, len)
//   qpos   — the RoPE position (length - 1)
//   cb     — the copy width for k/v rows (flash::copy_bytes)
template <typename TQ, typename TKV, int DP, typename Rows>
__device__ void decode_split(const TQ* __restrict__ q, long long sqh,
                             TQ* __restrict__ out, const TKV* __restrict__ k,
                             const TKV* __restrict__ v, const Rows& rows,
                             int len, int qpos, int d, int cb,
                             const float* __restrict__ inv_freq,
                             float scale) {
  using T = DecodeTiles<TKV, DP>;
  constexpr int NS = T::kStages;
  constexpr int P = T::kP;
  constexpr int TT = kDecodeTile;
  constexpr int NPAIR = (DP + 63) / 64;  // column pairs a lane in P·V
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + NS * T::kStageBytes);
  const int G = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = cluster_rank();

  // this rank's run of tiles: [t0, t0 + mine)
  const int ntiles = (len + TT - 1) / TT;
  const int per = (ntiles + kSplit - 1) / kSplit;
  const int t0 = rank * per;
  const int mine = max(0, min(per, ntiles - t0));
  auto load = [&](int j) {
    if (j < mine) {
      const int p0 = (t0 + j) * TT;
      TKV* ks = ring + (j % NS) * 2 * TT * P;
      gather<TT, DP>(ks, ks + TT * P, k, v, rows, p0, min(TT, len - p0), d,
                     cb);
    }
    flash::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) load(j);

  // this warp's head, rotated and scaled, while the copies fly
  float* qw = q_s + warp * DP;
  {
    const TQ* qr = q + warp * sqh;
    const int half = d / 2;
    for (int i = lane; i < half; i += 32) {
      float x1 = to_f32(qr[i]);
      float x2 = to_f32(qr[i + half]);
      rope_pair(x1, x2, qpos, inv_freq, i);
      qw[i] = x1 * scale;
      qw[i + half] = x2 * scale;
    }
    for (int i = d + lane; i < DP; i += 32) qw[i] = 0.f;
  }
  __syncwarp();

  float m = kNegInf;
  float l = 0.f;
  float acc[NPAIR][2];
  flash::zero(acc);
  for (int j = 0; j < mine; ++j) {
    flash::cp_async_wait<NS - 1>();
    __syncthreads();  // tile j is in for every warp
    const TKV* ks = ring + (j % NS) * 2 * TT * P;
    const TKV* vs = ks + TT * P;
    // lane = position of the tile; the run holds at least one valid one,
    // so m_new is finite and a masked position's probability is 0
    const int p = (t0 + j) * TT + lane;
    float s = dot_row<DP>(qw, ks + lane * P);
    s = p < len ? s : kNegInf;
    const float m_new = fmaxf(m, repro_attn::warp_max(s));
    const float pr = expf(s - m_new);
    const float alpha = expf(m - m_new);
    l = l * alpha + repro_attn::warp_sum(pr);
    m = m_new;
#pragma unroll
    for (int i = 0; i < NPAIR; ++i) acc[i][0] *= alpha, acc[i][1] *= alpha;
#pragma unroll 8
    for (int t = 0; t < TT; ++t) {
      const float pt = __shfl_sync(0xffffffffu, pr, t);
#pragma unroll
      for (int i = 0; i < NPAIR; ++i) {
        const int col = 2 * lane + 64 * i;
        if (col < DP) {
          const float2 vv = load2(vs + t * P + col);
          acc[i][0] = fmaf(pt, vv.x, acc[i][0]);
          acc[i][1] = fmaf(pt, vv.y, acc[i][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    load(j + NS);
  }
  flash::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: the partials take its place

  float* pm = reinterpret_cast<float*>(smem);  // [G]
  float* pl = pm + G;                          // [G]
  float* pa = pl + G;                          // [G][DP]
  if (lane == 0) pm[warp] = m, pl[warp] = l;
#pragma unroll
  for (int i = 0; i < NPAIR; ++i) {
    const int col = 2 * lane + 64 * i;
    if (col < DP) {
      pa[warp * DP + col] = acc[i][0];
      pa[warp * DP + col + 1] = acc[i][1];
    }
  }
  cluster_sync();

  // this rank's share of the G·d outputs, each from all ranks' partials in
  // rank order (an empty rank has m = -1e30, l = 0, acc = 0: weight 0, or
  // 1 of nothing when every rank is empty)
  const int total = G * d;
  const int share = (total + kSplit - 1) / kSplit;
  const int e1 = min(total, (rank + 1) * share);
  for (int e = rank * share + threadIdx.x; e < e1; e += blockDim.x) {
    const int g = e / d;
    const int c = e - g * d;
    float mr[kSplit];
    float lr[kSplit];
    float ar[kSplit];
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      mr[r] = ld_rank(pm + g, r);
      lr[r] = ld_rank(pl + g, r);
      ar[r] = ld_rank(pa + g * DP + c, r);
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < kSplit; ++r) mx = fmaxf(mx, mr[r]);
    float lsum = 0.f;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float w = expf(mr[r] - mx);
      lsum = fmaf(lr[r], w, lsum);
      o = fmaf(ar[r], w, o);
    }
    repro_attn::store_f32(out + e, o / fmaxf(lsum, 1e-30f));
  }
  cluster_sync();  // no CTA leaves while another reads its partials
}

// ----------------------------------------------------------------- prefill
constexpr int kPrefillRows = 64;   // query rows a CTA: 4 warps × 16
constexpr int kPrefillTile = 32;   // positions a K/V tile
constexpr int kPrefillThreads = 128;
// CTAs of a prefill cluster: at the serving shapes 32 clusters of 4 fill
// the 132 SMs in one wave (of 8, two CTAs an SM would not all fit at once)
constexpr int kPrefillSplit = 4;
// entries of an addressing's lookup table a CTA may stage in static shared
// memory (the paged block table; 4 KB). The ring's depth below is chosen
// with it reserved for every instance; the contiguous cache's, which stages
// no table, loses no stage to it at any head width the wrappers take.
constexpr int kTableCache = 1024;
// (sin, cos) pairs of the RoPE angles of a CTA's distinct positions
constexpr int kRopePairs = 1024;

template <typename TQ, typename TKV, int DP>
struct PrefillTiles {
  static constexpr int kPQ = pitch<TQ, DP>();
  static constexpr int kPK = pitch<TKV, DP>();
  static constexpr size_t kQBytes = size_t{kPrefillRows} * kPQ * sizeof(TQ);
  // the RoPE inverse frequencies (d/2 <= 128 floats), then the (sin, cos)
  // table of the CTA's positions
  static constexpr size_t kInvBytes =
      128 * sizeof(float) + kRopePairs * sizeof(float2);
  static constexpr size_t kStageBytes =
      size_t{2} * kPrefillTile * kPK * sizeof(TKV);
  static constexpr size_t kFixed =
      kQBytes + kInvBytes + kTableCache * sizeof(int32_t);
  // K/V tiles in flight: 4, or 3 or 2 where 4 do not fit. A rank's run at
  // the serving shapes is 1-2 tiles, so all its copies are issued up
  // front; a deeper ring measured no faster, and with float32 pools its
  // CTAs no longer fit two an SM (the clusters then take a second wave).
  static constexpr int kStages = kFixed + 4 * kStageBytes <= kSmemLimit ? 4
                                 : kFixed + 3 * kStageBytes <= kSmemLimit
                                     ? 3
                                     : 2;
  // dynamic shared memory: the query rows, the frequencies, the ring; once
  // the ring is drained, the partials (m, l, acc of 64 rows) take its place
  static constexpr size_t kSmem = kQBytes + kInvBytes + kStages * kStageBytes;
  static_assert(kSmem >= (size_t{2} + DP) * kPrefillRows * sizeof(float),
                "partials fit");
};

// Query rows [64·blk, +64) of one batch row's chunk for the G heads of one
// KV head (blockDim = 128), blk = blockIdx.z / kPrefillSplit: the
// kPrefillSplit CTAs of a cluster take contiguous runs of the rows'
// 32-position tiles and combine their partials as decode_split does, each
// rank 1/kPrefillSplit of the rows.
//   q     — (head 0 of the group, chunk token 0); head g, token c at
//           g·sqh + c·sqc (unit stride along d)
//   out   — (G, C, d) contiguous: head g, token c at (g·C + c)·d
//   start — the chunk's first position; row r sits at start + r/G
//   lim   — positions the addressing holds (nb · page; S when contiguous)
//   cbq   — the copy width for q rows, cb for k/v rows (flash::copy_bytes)
template <typename TQ, typename TKV, int DP, typename Rows>
__device__ void prefill_rows(const TQ* __restrict__ q, long long sqh,
                             long long sqc, TQ* __restrict__ out,
                             const TKV* __restrict__ k,
                             const TKV* __restrict__ v, const Rows& rows,
                             int start, int C, int G, int lim, int d, int cbq,
                             int cb, const float* __restrict__ inv_freq,
                             float scale) {
  using T = PrefillTiles<TQ, TKV, DP>;
  constexpr bool kBf16 = kIsBf16<TQ> && kIsBf16<TKV>;
  constexpr int ST = T::kStages;
  constexpr int BN = kPrefillTile;
  constexpr int NT = BN / 8;   // n-tiles of S
  constexpr int NO = DP / 8;   // n-tiles of the output
  constexpr int NC = NO % 8 != 0 ? 4 : 8;  // n-tiles a fresh P·V fragment
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);
  float* inv_s = reinterpret_cast<float*>(smem + T::kQBytes);
  TKV* ks = reinterpret_cast<TKV*>(smem + T::kQBytes + T::kInvBytes);
  TKV* vs = ks + ST * BN * T::kPK;
  const int rank = cluster_rank();

  const int r0 = (blockIdx.z / kPrefillSplit) * kPrefillRows;
  const int nrows = min(kPrefillRows, C * G - r0);
  const int last = r0 + nrows - 1;       // the CTA's last row
  // positions [0, npos) are visible to some row of the CTA; this rank's
  // run of their tiles is [t0, t0 + mine)
  const int npos = min(start + last / G + 1, lim);
  const int ntiles = (npos + BN - 1) / BN;
  const int per = (ntiles + kPrefillSplit - 1) / kPrefillSplit;
  const int t0 = rank * per;
  const int mine = max(0, min(per, ntiles - t0));

  auto load_kv = [&](int j) {
    if (j < mine) {
      const int st = j % ST;
      const int p0 = (t0 + j) * BN;
      gather<BN, DP>(ks + st * BN * T::kPK, vs + st * BN * T::kPK, k, v,
                     rows, p0, min(BN, npos - p0), d, cb);
    }
    flash::cp_async_commit();
  };
  // the CTA's query rows (rows past the chunk and columns past d are 0) and
  // the frequencies, then the first K/V tiles: every copy in flight at once
  copy_rows<kPrefillRows, DP>(
      qs, q,
      [&](int row) {
        const int r = r0 + row;
        const int c = r / G;
        return (r - c * G) * sqh + c * sqc;
      },
      nrows, d, cbq);
  if (inv_freq != nullptr) flash::load_vec(inv_s, inv_freq, d / 2, d / 2);
  flash::cp_async_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) load_kv(j);

  // rotated in place at each row's position (in q's dtype: a bfloat16 q is
  // rounded after RoPE, as the plain version does). The angles depend on
  // the position and the column only: G rows share each, so they are
  // tabled once for the CTA's positions where the table holds them.
  if (inv_freq != nullptr) {
    float2* rope_s = reinterpret_cast<float2*>(inv_s + 128);
    flash::cp_async_wait<ST - 1>();
    __syncthreads();
    const int half = d / 2;
    const int pos0 = start + r0 / G;
    const int npq = start + last / G - pos0 + 1;
    const bool tabled = npq * half <= kRopePairs;
    if (tabled) {
      for (int i = threadIdx.x; i < npq * half; i += blockDim.x) {
        const int pi = i / half;
        const int col = i - pi * half;
        float sn;
        float cs;
        sincosf(static_cast<float>(pos0 + pi) * inv_s[col], &sn, &cs);
        rope_s[i] = make_float2(sn, cs);
      }
      __syncthreads();
    }
    if (tabled) {
      // a fixed count of (row, column) slots a thread, unrolled by 4, so
      // that the loads of four are in flight together
      constexpr int kCols = DP / 2;
#pragma unroll 4
      for (int i0 = 0; i0 < kPrefillRows * kCols; i0 += kPrefillThreads) {
        const int row = (i0 + threadIdx.x) / kCols;
        const int col = (i0 + threadIdx.x) % kCols;
        const bool in = row < nrows && col < half;
        TQ* qr = qs + row * T::kPQ;
        float x1 = to_f32(qr[col]);
        float x2 = to_f32(qr[col + half]);
        const float2 sc =
            rope_s[in ? (start + (r0 + row) / G - pos0) * half + col : 0];
        rotate_pair(x1, x2, sc.x, sc.y);
        if (in) {
          repro_attn::store_f32(qr + col, x1);
          repro_attn::store_f32(qr + col + half, x2);
        }
      }
    } else {
      for (int i = threadIdx.x; i < nrows * half; i += blockDim.x) {
        const int row = i / half;
        const int col = i - row * half;
        TQ* qr = qs + row * T::kPQ;
        float x1 = to_f32(qr[col]);
        float x2 = to_f32(qr[col + half]);
        rope_pair(x1, x2, start + (r0 + row) / G, inv_s, col);
        repro_attn::store_f32(qr + col, x1);
        repro_attn::store_f32(qr + col + half, x2);
      }
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int wr = r0 + warp * 16;   // the warp's first row
  const bool active = wr <= last;
  // horizons (last visible position) of the warp's first and last rows and
  // of this thread's two; a row past the chunk stands in for the last real
  // one, and no horizon reaches past the positions the table holds
  auto horizon = [&](int r) { return min(start + min(r, last) / G, lim - 1); };
  const int wlo = horizon(wr);
  const int whi = horizon(wr + 15);
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = horizon(wr + g8 + 8 * i);
  const float sl2 = scale * flash::kLog2e;

  float o[NO][4];
  flash::zero(o);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < mine; ++j) {
    const int st = j % ST;
    flash::cp_async_wait<ST - 2>();
    // tile j is in (and the query rows stored), and every warp is done
    // with tile j - 1, whose stage the copy issued next refills
    __syncthreads();
    load_kv(j + ST - 1);
    const int k0 = (t0 + j) * BN;
    if (!active || k0 > whi) continue;
    float s[NT][4];
    flash::zero(s);
    // the small terms of a float32 q in a sum of their own: half the
    // chain of dependent MMAs
    flash::gemm_nt<kBf16, NT, DP, true>(s, qs + warp * 16 * T::kPQ,
                                        ks + st * BN * T::kPK);
    if (k0 + BN - 1 > wlo) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          if (key > qp[e >> 1]) s[n][e] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
    float ms[2];  // the new max, scaled to log2 units
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row that has seen no visible position yet (its horizon lies
      // before this rank's run) keeps probabilities 0, not 2^0
      ms[i] = mx[i] == kNegInf ? 0.f : mx[i] * sl2;
      alpha[i] = flash::fast_exp2(fmaf(m[i], sl2, -ms[i]));
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = flash::fast_exp2(fmaf(s[n][e], sl2, -ms[e >> 1]));
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    // this tile's P·V in a fresh fragment, added to o in float32
#pragma unroll
    for (int c0 = 0; c0 < NO; c0 += NC) {
      float pv[NC][4];
      flash::zero(pv);
      flash::gemm_pv<kBf16, NT, NC, DP>(pv, s, vs + st * BN * T::kPK,
                                        8 * c0);
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c0 + n][e] += pv[n][e];
    }
  }
  flash::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: the partials take its place

  // partials of the CTA's 64 rows: m, l (the quad's sum) and acc, float32
  float* pm = reinterpret_cast<float*>(smem);  // [64]
  float* pl = pm + kPrefillRows;               // [64]
  float* pa = pl + kPrefillRows;               // [64][DP]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = warp * 16 + g8 + 8 * i;
    if (t4 == 0) pm[row] = m[i], pl[row] = li;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(pa + row * DP + 8 * n + 2 * t4) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
  }
  cluster_sync();

  // this rank's rows, each column pair from all ranks' partials in rank
  // order (rank 0 holds position 0, which every row sees)
  // (every slot is read, a fixed count a thread, unrolled by 4: the remote
  // loads of four in flight together; only real rows and columns are
  // stored)
  constexpr int kRowsPerRank = kPrefillRows / kPrefillSplit;
  constexpr int kPairs = DP / 2;
  static_assert(kRowsPerRank * kPairs % kPrefillThreads == 0, "slots");
#pragma unroll 4
  for (int i0 = 0; i0 < kRowsPerRank * kPairs; i0 += kPrefillThreads) {
    const int row = rank * kRowsPerRank + (i0 + threadIdx.x) / kPairs;
    const int col = 2 * ((i0 + threadIdx.x) % kPairs);
    float mr[kPrefillSplit];
    float lr[kPrefillSplit];
    float2 ar[kPrefillSplit];
#pragma unroll
    for (int r = 0; r < kPrefillSplit; ++r) {
      mr[r] = ld_rank(pm + row, r);
      lr[r] = ld_rank(pl + row, r);
      ar[r] = ld_rank2(pa + row * DP + col, r);
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < kPrefillSplit; ++r) mx = fmaxf(mx, mr[r]);
    float lsum = 0.f;
    float ox = 0.f;
    float oy = 0.f;
#pragma unroll
    for (int r = 0; r < kPrefillSplit; ++r) {
      const float w = flash::fast_exp2((mr[r] - mx) * sl2);
      lsum = fmaf(lr[r], w, lsum);
      ox = fmaf(ar[r].x, w, ox);
      oy = fmaf(ar[r].y, w, oy);
    }
    const int r = r0 + row;
    const int c = r / G;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (r <= last && col < d)
      flash::store2(
          out + (static_cast<long long>(r - c * G) * C + c) * d + col,
          ox * inv, oy * inv);
  }
  cluster_sync();  // no CTA leaves while another reads its partials
}

// ---------------------------------------------------------------- launches
// kernel(p) on `grid` in clusters of (1, 1, cz) CTAs of `threads` threads
// and `smem` bytes of dynamic shared memory, through cudaLaunchKernelEx;
// returns the launch's own status.
template <typename Kernel, typename P>
inline cudaError_t launch_clusters(Kernel kernel, dim3 grid, int threads,
                                   size_t smem, int cz, cudaStream_t stream,
                                   const P& p) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The dynamic shared memory of a decode CTA for G query heads a KV head,
// head dim D and the cache bfloat16 (1) or float32 (0): what the decode
// launchers' C entries report (common.decode_smem mirrors it).
inline long long decode_smem(int G, int D, int kv_bf16) {
  long long bytes = 0;
  flash::dispatch_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    bytes = static_cast<long long>(kv_bf16 ? DecodeTiles<bf16, DP>::smem(G)
                                           : DecodeTiles<float, DP>::smem(G));
  });
  return bytes;
}

template <int DP>
struct PrefillSmemOf {
  long long* bytes;
  template <typename TQ, typename TKV>
  void run() const {
    *bytes = static_cast<long long>(PrefillTiles<TQ, TKV, DP>::kSmem);
  }
};

// The dynamic shared memory of a prefill CTA for head dim D and q and the
// cache bfloat16 (1) or float32 (0) (common.prefill_smem mirrors it).
inline long long prefill_smem(int D, int q_bf16, int kv_bf16) {
  long long bytes = 0;
  flash::dispatch_dp(D, [&](auto dp) {
    repro_attn::dispatch_dtypes(q_bf16, kv_bf16,
                                PrefillSmemOf<decltype(dp)::value>{&bytes});
  });
  return bytes;
}

}  // namespace paged_attn
