// Mamba2 SSD intra-chunk scan on Hopper: for each (batch·chunk m, head h)
//
//   y[i, p]     = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x[j, p]
//   state[p, n] = sum_q x[q, p] * exp(cum_last - cum_q) * dt_q * B[q, n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_scan (its oracle: repro/kernels/ref.py::ssd_chunk_ref). The
// inter-chunk recurrence stays outside, as in the JAX package.
//
// Grid: one CTA of 8 warps per (row m, block of kHeads = 2 heads, slice of
// PS of the P columns), as the TPU kernel's grid (m, H / hb) with P split
// as well; the last block of an odd H holds one head. C·Bᵀ does not
// depend on the head: a CTA forms each 16 × 16 tile of it once and applies
// it to both heads of its block. The wrapper (kernels/ssd_scan.py::plan)
// takes the widest PS in {64, 32, 16} that gives 1.5 CTAs an SM for a
// chunk staged whole, half a CTA an SM for a longer one, the fastest of a
// sweep over (head block, PS) on an H100 at mamba2-1.3b's widths (H 64, P 64, N 128): Q = 16 takes PS 32 at
// M = 4 (256 CTAs, two an SM overlap one's staging with the other's
// stores) and PS 16 at M = 1 (a one-row prefill chunk, 128 CTAs); Q = 256
// takes PS 64 at M = 4 (128 CTAs: a narrower slice forms C·Bᵀ, a third
// of a CTA's products, in twice the CTAs).
//
// Products on the tensor cores, mma.sync m16n8k8 TF32 in 3xTF32 (every
// operand is float32: big·big + big·small + small·big, flash_mma.cuh):
//   * C·Bᵀ — 16 × 16 tiles at or below the diagonal only, depth N; its
//     small terms in two sums of their own by the parity of the k-step;
//   * y_h += S_h · x_h — the scores S_h = cb ⊙ exp(cum_i - cum_j) ⊙ dt_j
//     (SIMT, the exp on the special-function unit and evaluated only where
//     j <= i: above the diagonal it overflows at Q = 256, and inf · 0 is
//     NaN) enter the product from a
//     C·Bᵀ fragment of C layout, read as the A layout with the reduction
//     index permuted, as flash_mma.cuh's gemm_pv does;
//   * state_h += (x_h ⊙ w_h)ᵀ · B — depth Q in tiles of 16 positions,
//     w_q = exp(cum_last - cum_q) · dt_q, 0 past Q.
// The tensor cores truncate as they accumulate, so every tile's product
// goes into a fresh fragment added to the running sum in float32.
//
// Positions come in tiles of 16 (Q = 16 pads nothing; Q = 13 or 1 pad to
// 16 with zeros that are never stored). Two kernels:
//   * ssd_resident, a chunk of up to 4 tiles (Q <= 64): staged whole by
//     one round of cp.async. Four warps form the C·Bᵀ tiles into shared
//     memory and then run the y tasks; the other four start on the state
//     tasks at once (the state needs no C·Bᵀ, and its write is the bound)
//     from a queue that the first four join when done.
//   * ssd_streamed, a longer chunk (Q = 256: B and C alone are 128 KB each
//     in float32): blocks of 8 i-tiles with their C rows, the j-tiles up to
//     the block streamed through a ring of 4 (3 in flight ahead of the one
//     in use), each warp forming its C·Bᵀ tile once for both heads; then
//     the state, a rectangle (both heads) a warp, the tiles streamed once
//     a round of 8 rectangles.
// Per-warp timer stamps in a copy of the kernel, on an H100, showed the
// resident kernel's state tasks and the streamed kernel's y steps bound
// by their instruction streams — TF32 splits, fragment loads, exps and
// address arithmetic around each MMA — at 8 to 16 warps an SM, not by the
// tensor cores.
//
// Stores: y and the state straight from the accumulator fragments, 8 bytes
// a lane (float2), four lanes on 32 contiguous bytes.
//
// Bound: bytes at the serving shape. The state output alone is
// H·P·N·4 = 2 MB per row m (8.4 MB at M = 4, 2.5 µs at 3.35 TB/s),
// against Q·(H·P + 2H + 2N)·4 bytes of input and Q·H·P·4 of y. At Q = 256
// the 3xTF32 products (three TF32 products each) bound it.
//
// Layouts, all float32 and contiguous: x (M, Q, H, P); dt, cum (M, Q, H);
// B, C (M, Q, N) (ngroups = 1); y (M, Q, H, P); state (M, H, P, N).
// Limits (checked by the wrapper): N <= 256 (shared memory); any M, Q, H,
// P >= 1.
#include "flash_mma.cuh"

namespace {

using flash::add_to;
using flash::cp_async;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::Frag;
using flash::mma3;
using flash::store2;
using flash::zero;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;          // positions a tile
constexpr int kHeads = 2;          // heads a CTA (the last: H - h0)
constexpr int kResidentTiles = 4;  // chunks up to 64 positions: staged whole
constexpr int kRing = 4;           // a longer chunk's ring of tiles (or 2)
constexpr int kMaxSplit = 4;       // C·Bᵀ depth split of a short chunk
constexpr int kCbWarps = 4;        // a short chunk's C·Bᵀ and y warps
constexpr long long kMaxSmem = 232448;

// Parts the depth N of a short chunk's C·Bᵀ tiles is split into, so that
// its (tile pair, n-half, part) units keep the C·Bᵀ warps busy: 2 for one
// tile of positions (Q <= 16), 1 from three tile pairs on.
__host__ __device__ inline int cb_split(int nt) {
  const int units = nt * (nt + 1);  // tile pairs at or below the diagonal, x2
  int kc = 1;
  while (kc < kMaxSplit && units * kc * 2 <= kCbWarps) kc *= 2;
  return kc;
}

// Shared memory, in floats: C rows (16 · min(tiles, 8) of pitch NP + 4),
// then `stages` tiles of 16 positions, each B (16 × (NP + 4)), x of the
// kHeads heads (kHeads × 16 × (PS + 4)), cum and dt (kHeads × 16 each), then (a staged
// chunk only) the C·Bᵀ fragments: per tile pair at or below the diagonal,
// per half of its 16 columns and part of the depth, 32 lanes × 4 floats.
// NP is N padded to 8. Pitches of 4 mod 8 words put the 32 lanes of every
// fragment read on 32 banks, the position-major reads included (rows 2t
// and 2t + 1). A chunk of up to 4 tiles stages all of them; a longer one a
// ring of 4, or of 2 where 4 would not fit.
struct Layout {
  int nt, np, ldn, ldp, crows, stage, kc, cb, stages;
  bool resident;
  __host__ __device__ Layout(int Q, int ps, int N)
      : nt((Q + kTile - 1) / kTile),
        np((N + 7) / 8 * 8),
        ldn(np + 4),
        ldp(ps + 4),
        crows(kTile * (nt < kWarps ? nt : kWarps)),
        stage(kTile * ldn + kHeads * kTile * ldp + 2 * kHeads * kTile),
        kc(cb_split(nt)),
        cb(nt <= kResidentTiles ? nt * (nt + 1) * kc * 128 : 0),
        stages(nt <= kResidentTiles ? nt
               : 4LL * (static_cast<long long>(crows) * ldn +
                        static_cast<long long>(kRing) * stage) <= kMaxSmem
                   ? kRing
                   : 2),
        resident(nt <= kResidentTiles) {}
  __host__ __device__ long long floats() const {
    return static_cast<long long>(crows) * ldn +
           static_cast<long long>(stages) * stage + cb;
  }
};

struct Args {
  const float* x;
  const float* dt;
  const float* cum;
  const float* b;
  const float* c;
  float* y;
  float* state;
  int Q, H, P, N;
  int vec;  // 16-byte copies of x, B and C (else 4-byte)
};

// Rows [0, rows) of `width` floats, row r at src + r·stride, into dst
// (pitch ld); rows past n_rows and columns past d are zero-filled. 16-byte
// copies where vec (then width and d are multiples of 4), else 4-byte.
// Thread tid takes copies tid, tid + kThreads, ...; its row and column
// step by the quotient and remainder of kThreads by the copies a row,
// without a division a copy.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int stride,
                                           int rows, int n_rows, int width,
                                           int d, bool vec) {
  const int e = vec ? 4 : 1;  // floats a copy
  const int cpr = width / e;  // copies a row
  const int dr = kThreads / cpr, dc = kThreads % cpr;
  int r = threadIdx.x / cpr;
  int c = threadIdx.x - r * cpr;
  for (; r < rows; r += dr, c += dc) {
    if (c >= cpr) c -= cpr, ++r;
    if (r >= rows) break;
    const bool in = r < n_rows && c * e < d;
    const float* from = in ? src + r * stride + c * e : src;
    if (vec)
      cp_async<16>(dst + r * ld + c * e, from, in);
    else
      cp_async<4>(dst + r * ld + c, from, in);
  }
}

// e^x on the special-function unit (ex2.approx of x·log2 e, as the flash
// kernels take their exps): 2 instructions where expf takes about ten,
// relative error ~6e-8·|x| + 2^-22 — under 1e-6 wherever e^x is not
// negligible beside 1 — and results below 2^-126 flushed to 0.
__device__ __forceinline__ float exp_sfu(float x) {
  return flash::fast_exp2(x * flash::kLog2e);
}

// Two floats at dst (8 bytes where `pair`, else one or two 4-byte stores;
// `two`: the second lies inside the row).
__device__ __forceinline__ void store_pair(float* dst, float v0, float v1,
                                           bool two, bool pair) {
  if (two && pair) {
    store2(dst, v0, v1);
  } else {
    dst[0] = v0;
    if (two) dst[1] = v1;
  }
}

// Runs body(jt, slot) for the tiles jt in [0, n), each staged beforehand
// by issue(jt, slot) into a ring of `stages` slots (2 or kRing), with
// stages - 1 tiles in flight ahead of the one in use. `first` is issued
// with tile 0. Every thread of the CTA calls it.
template <typename First, typename Issue, typename Body>
__device__ __forceinline__ void stream_tiles(int n, int stages, First first,
                                             Issue issue, Body body) {
  __syncthreads();  // every warp is done with the ring (and C)
  first();
  for (int k = 0; k < stages - 1; ++k) {
    if (k < n) issue(k, k);
    cp_async_commit();
  }
  for (int jt = 0; jt < n; ++jt) {
    if (stages == kRing)
      cp_async_wait<kRing - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tile jt landed; slot (jt - 1) % stages is free
    const int next = jt + stages - 1;
    if (next < n) issue(next, next % stages);
    cp_async_commit();
    body(jt, jt % stages);
  }
}

// What both kernels share: the CTA's share of the problem, its shared
// memory, the staging and the state product, in rectangles of MTW x NTW
// m16n8 tiles of the state.
template <int PS, int NTW_>
struct Cta {
  static constexpr int MTW = PS >= 32 ? 2 : 1;
  static constexpr int NTW = NTW_;
  const Args a;
  const Layout L;
  float* const smem;
  int m, h0, nh, p0, pw, warp, g, t;
  long long mq;

  __device__ Cta(const Args& args, int splits, float* s)
      : a(args), L(args.Q, PS, args.N), smem(s) {
    // blockIdx.x = (m · head blocks + head block) · splits + split
    const int blocks = ((a.H + kHeads - 1) / kHeads) * splits;
    m = blockIdx.x / blocks;
    const int rest = blockIdx.x - m * blocks;
    const int hblock = rest / splits;
    h0 = hblock * kHeads;
    nh = min(kHeads, a.H - h0);
    p0 = (rest - hblock * splits) * PS;
    pw = min(PS, a.P - p0);
    warp = threadIdx.x >> 5;
    g = (threadIdx.x & 31) >> 2;
    t = threadIdx.x & 3;
    mq = static_cast<long long>(m) * a.Q;
  }
  __device__ float* c_s() const { return smem; }
  __device__ float* base(int s) const {
    return smem + L.crows * L.ldn + s * L.stage;
  }
  __device__ float* x_at(int s, int hh) const {
    return base(s) + kTile * L.ldn + hh * kTile * L.ldp;
  }
  __device__ float* cum_at(int s, int hh) const {
    return base(s) + kTile * L.ldn + kHeads * kTile * L.ldp + hh * kTile;
  }
  __device__ float* dt_at(int s, int hh) const {
    return cum_at(s, hh) + kHeads * kTile;
  }
  __device__ float* cb_s() const {
    return smem + L.crows * L.ldn + L.stages * L.stage;
  }
  __device__ float cum_last(int hh) const {
    return a.cum[(mq + a.Q - 1) * a.H + h0 + hh];
  }

  // C rows of i-tiles [it0, it0 + n) into c_s
  __device__ void stage_c(int it0, int n) const {
    const int i0 = it0 * kTile;
    stage_rows(c_s(), L.ldn, a.c + (mq + i0) * a.N, a.N, n * kTile,
               min(n * kTile, a.Q - i0), L.np, a.N, a.vec != 0);
  }

  // j-tile jt into slot s: B, and x, cum, dt of heads [hlo, hhi)
  __device__ void issue(int jt, int s, int hlo, int hhi) const {
    const int q0 = jt * kTile;
    const int nq = min(kTile, a.Q - q0);
    const bool vec = a.vec != 0;
    stage_rows(base(s), L.ldn, a.b + (mq + q0) * a.N, a.N, kTile, nq, L.np,
               a.N, vec);
    for (int hh = hlo; hh < hhi; ++hh)
      stage_rows(x_at(s, hh), L.ldp,
                 a.x + ((mq + q0) * a.H + h0 + hh) * a.P + p0, a.H * a.P,
                 kTile, nq, PS, pw, vec);
    for (int i = threadIdx.x; i < kTile * (hhi - hlo); i += kThreads) {
      const int hh = hlo + i / kTile;
      const int j = i % kTile;
      const bool in = j < nq;
      const long long off = (mq + q0 + (in ? j : 0)) * a.H + h0 + hh;
      cp_async<4>(cum_at(s, hh) + j, a.cum + off, in);
      cp_async<4>(dt_at(s, hh) + j, a.dt + off, in);
    }
  }

  // cb += C rows (ca: this lane's row g, column t) · Bᵀ of NT blocks of 8
  // B rows (bb, the same for row g of the first) over columns [k0, k1):
  // big·big into cb, the small terms in two sums by the parity of the
  // k-step (shorter dependent chains of MMAs), added at the end
  template <int NT>
  __device__ void cb_tile(const float* ca, const float* bb, int k0, int k1,
                          float (&cb)[NT][4]) const {
    float cs[2][NT][4];
    zero(cs);
    auto step = [&](int k, float (&sum)[NT][4]) {
      Frag<4, true> fa;
      fa.set(0, ca[k]);
      fa.set(1, ca[8 * L.ldn + k]);
      fa.set(2, ca[k + 4]);
      fa.set(3, ca[8 * L.ldn + k + 4]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        Frag<2, true> fb;
        fb.set(0, bb[8 * n * L.ldn + k]);
        fb.set(1, bb[8 * n * L.ldn + k + 4]);
        mma3(cb[n], sum[n], fa, fb);
      }
    };
    int k = k0;
    for (; k + 8 < k1; k += 16) {
      step(k, cs[0]);
      step(k + 8, cs[1]);
    }
    if (k < k1) step(k, cs[0]);
    add_to(cs[0], cs[1]);
    add_to(cb, cs[0]);
  }

  // part += S · x over the 8 positions of column block nn of j-tile jt,
  // i-tile it: the scores S = cb ⊙ exp(cum_i - cum_j) ⊙ dt_j in the C
  // layout of cb (row g + 8·(e / 2), column 2t + e % 2), masked to j <= i
  // < Q, enter as the A fragment with slot t <-> position 2t, t + 4 <->
  // 2t + 1; xs points at x's row nn·8 + 2t, column g of the first of NO
  // blocks of 8 columns.
  template <int NO>
  __device__ void y_step(const float (&cb)[4], int it, int jt, int nn,
                         const float (&cum_i)[2], const float* cj,
                         const float* dj, const float* xs,
                         float (&part)[NO][4]) const {
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = it * kTile + g + 8 * (e >> 1);
      const int jl = nn * 8 + 2 * t + (e & 1);
      float v = 0.f;
      if (jt * kTile + jl <= i && i < a.Q)
        v = cb[e] * exp_sfu(cum_i[e >> 1] - cj[jl]) * dj[jl];
      sc[e] = v;
    }
    Frag<4, true> fa;
    fa.set(0, sc[0]);
    fa.set(1, sc[2]);
    fa.set(2, sc[1]);
    fa.set(3, sc[3]);
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      Frag<2, true> fb;
      fb.set(0, xs[8 * o]);
      fb.set(1, xs[L.ldp + 8 * o]);
      mma3(part[o], part[o], fa, fb);
    }
  }

  // Rectangles of the state: MTW m-tiles (16 columns of P) by NTW
  // n-tiles (8 of N).
  __device__ int n_rects() const {
    return (PS / 16 / MTW) * ((L.np / 8 + NTW - 1) / NTW);
  }

  // acc[hh] += (x_h ⊙ w_h)ᵀ B over tile qt (in slot s), rectangle rc of
  // the state, for the block's heads hh < nh, each through a fresh
  // fragment; the B fragments are loaded and split once for both heads
  __device__ void rect_tile(int rc, int qt, int s,
                            const float (&cum_last)[kHeads],
                            float (&acc)[kHeads][MTW][NTW][4]) const {
    const int ntn = L.np / 8;
    const int nrn = (ntn + NTW - 1) / NTW;
    const int mt0 = (rc / nrn) * MTW;
    const int nt0 = (rc % nrn) * NTW;
    float part[kHeads][MTW][NTW][4];
    zero(part);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int j = ks * 8 + 2 * t;  // slot t <-> j, t + 4 <-> j + 1
      const int q = qt * kTile + j;
      Frag<4, true> fa[kHeads][MTW];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh >= nh) break;
        const float* cq = cum_at(s, hh);
        const float* dq = dt_at(s, hh);
        const float w0 =
            q < a.Q ? exp_sfu(cum_last[hh] - cq[j]) * dq[j] : 0.f;
        const float w1 =
            q + 1 < a.Q ? exp_sfu(cum_last[hh] - cq[j + 1]) * dq[j + 1]
                        : 0.f;
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          const float* xr = x_at(s, hh) + j * L.ldp + (mt0 + mt) * 16 + g;
          fa[hh][mt].set(0, xr[0] * w0);
          fa[hh][mt].set(1, xr[8] * w0);
          fa[hh][mt].set(2, xr[L.ldp] * w1);
          fa[hh][mt].set(3, xr[L.ldp + 8] * w1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        if (nt0 + nt >= ntn) break;
        const float* br = base(s) + j * L.ldn + (nt0 + nt) * 8 + g;
        Frag<2, true> fb;
        fb.set(0, br[0]);
        fb.set(1, br[L.ldn]);
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          if (hh >= nh) break;
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt)
            mma3(part[hh][mt][nt], part[hh][mt][nt], fa[hh][mt], fb);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) add_to(acc[hh][mt], part[hh][mt]);
  }

  // rectangle rc of the block's states from their accumulators
  __device__ void rect_store(int rc,
                             const float (&acc)[kHeads][MTW][NTW][4]) const {
    const int ntn = L.np / 8;
    const int nrn = (ntn + NTW - 1) / NTW;
    const int mt0 = (rc / nrn) * MTW;
    const int nt0 = (rc % nrn) * NTW;
    const bool pair_n = (a.N & 1) == 0;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= nh) break;
      float* st = a.state +
                  (static_cast<long long>(m * a.H + h0 + hh) * a.P + p0) * a.N;
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = (mt0 + mt) * 16 + g + 8 * half;
            const int n = (nt0 + nt) * 8 + 2 * t;
            if (nt0 + nt < ntn && p < pw && n < a.N)
              store_pair(st + static_cast<long long>(p) * a.N + n,
                         acc[hh][mt][nt][2 * half],
                         acc[hh][mt][nt][2 * half + 1], n + 1 < a.N, pair_n);
          }
    }
  }
};

// A chunk of up to 4 tiles (Q <= 64), staged whole by one round of
// cp.async. Then the warps split by role:
//   * warps 0-3 form the C·Bᵀ tiles at or below the diagonal as units of
//     (tile pair, half of its 16 columns, part of the depth N), each a
//     fragment of C layout written to shared memory as 32 lanes × 4 floats;
//     after a barrier of their own they run the y tasks (head, i-tile, 16
//     columns of P), longest first: each sums a C·Bᵀ fragment's depth
//     parts in a fixed order, forms its scores and multiplies them into x_h;
//   * warps 4-7 start on the state tasks (a rectangle of the state, both
//     heads) at once — the state needs no C·Bᵀ — taking them from a
//     queue in shared memory, which warps 0-3 join when their y tasks are
//     done.
// The state write is the bound, and it starts as soon as the chunk lands.
template <int PS>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_resident(const Args a, int splits) {
  extern __shared__ __align__(16) float smem[];
  using St = Cta<PS, 2>;  // rectangles of 2 n-tiles: two heads' sums fit
  const St c(a, splits, smem);
  const Layout& L = c.L;
  const int g = c.g, t = c.t, lane = threadIdx.x & 31;
  __shared__ int next_task;  // the state tasks' queue
  const float cum_last[kHeads] = {c.cum_last(0),
                                  c.nh > 1 ? c.cum_last(1) : 0.f};
  if (threadIdx.x == 0) next_task = 0;
  c.stage_c(0, L.nt);
  for (int jt = 0; jt < L.nt; ++jt) c.issue(jt, jt, 0, c.nh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (c.warp < kCbWarps) {
    // -------------------------------------------------- C·Bᵀ fragments
    const int ksteps = L.np / 8;
    const int units = L.nt * (L.nt + 1) * L.kc;
    for (int u = c.warp; u < units; u += kCbWarps) {
      const int pair = u / (2 * L.kc);
      const int nn = (u / L.kc) & 1;
      const int part = u % L.kc;
      int it = 0;
      while ((it + 1) * (it + 2) / 2 <= pair) ++it;
      const int jt = pair - it * (it + 1) / 2;
      float cb[1][4];
      zero(cb);
      c.cb_tile(c.c_s() + (it * kTile + g) * L.ldn + t,
                c.base(jt) + (nn * 8 + g) * L.ldn + t,
                part * ksteps / L.kc * 8, (part + 1) * ksteps / L.kc * 8,
                cb);
      *reinterpret_cast<float4*>(c.cb_s() + u * 128 + lane * 4) =
          make_float4(cb[0][0], cb[0][1], cb[0][2], cb[0][3]);
    }
    flash::sync_group(1, kCbWarps * 32);

    // ------------------------------------------------------- y tasks
    constexpr int G = PS / 16;  // y tasks a (head, i-tile): 16 columns
    const bool pair_p = (a.P & 1) == 0;
    for (int task = c.warp; task < c.nh * L.nt * G; task += kCbWarps) {
      const int it = L.nt - 1 - task / (c.nh * G);
      const int hh = (task / G) % c.nh;
      const int col = (task % G) * 16;
      const float* ci = c.cum_at(it, hh);
      const float cum_i[2] = {ci[g], ci[g + 8]};
      float acc[2][4];
      zero(acc);
      for (int jt = 0; jt <= it; ++jt) {
        const float* cj = c.cum_at(jt, hh);
        const float* dj = c.dt_at(jt, hh);
        const int pair = it * (it + 1) / 2 + jt;
        float part[2][4];
        zero(part);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          // the C·Bᵀ fragment, its depth parts summed in a fixed order
          float cv[4] = {0.f, 0.f, 0.f, 0.f};
          for (int q = 0; q < L.kc; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(
                c.cb_s() + ((pair * 2 + nn) * L.kc + q) * 128 + lane * 4);
            cv[0] += v.x, cv[1] += v.y, cv[2] += v.z, cv[3] += v.w;
          }
          c.y_step(cv, it, jt, nn, cum_i, cj, dj,
                   c.x_at(jt, hh) + (nn * 8 + 2 * t) * L.ldp + col + g,
                   part);
        }
        add_to(acc, part);
      }
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = it * kTile + g + 8 * half;
          const int p = col + 8 * o + 2 * t;
          if (i < a.Q && p < c.pw)
            store_pair(
                a.y + ((c.mq + i) * a.H + c.h0 + hh) * a.P + c.p0 + p,
                acc[o][2 * half], acc[o][2 * half + 1], p + 1 < c.pw,
                pair_p);
        }
    }
  }

  // --------------------------------------- state tasks: a rectangle each
  for (;;) {
    int task = 0;
    if (lane == 0) task = atomicAdd(&next_task, 1);
    task = __shfl_sync(0xffffffffu, task, 0);
    if (task >= c.n_rects()) break;
    float acc[kHeads][St::MTW][St::NTW][4];
    zero(acc);
    for (int qt = 0; qt < L.nt; ++qt)
      c.rect_tile(task, qt, qt, cum_last, acc);
    c.rect_store(task, acc);
  }
}

// A longer chunk: blocks of 8 i-tiles (warp w on tile ib + w) with their C
// rows, the j-tiles up to the block streamed through the ring, each warp
// forming its C·Bᵀ tile once and applying it to both heads; then the
// state, a rectangle (both heads) a warp, a pass over the tiles a round of
// 8 rectangles.
template <int PS>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_streamed(const Args a, int splits) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NO = PS / 8;  // y's n-tiles
  using St = Cta<PS, 4>;
  const St c(a, splits, smem);
  const Layout& L = c.L;
  const int g = c.g, t = c.t, warp = c.warp, nh = c.nh;
  const bool pair_p = (a.P & 1) == 0;
  for (int ib = 0; ib < L.nt; ib += kWarps) {
    const int nib = min(kWarps, L.nt - ib);
    const int it = ib + warp;  // this warp's i-tile
    const bool mine = warp < nib;
    float yacc[kHeads][NO][4];
    zero(yacc);
    float cum_i[kHeads][2];    // cum at this lane's rows g, g + 8
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = it * kTile + g + 8 * half;
        cum_i[hh][half] = mine && hh < nh && i < a.Q
                              ? a.cum[(c.mq + i) * a.H + c.h0 + hh]
                              : 0.f;
      }
    auto y_tile = [&](int jt, int s) {
      float cb[2][4];  // C(it) · B(jt)ᵀ, depth N
      zero(cb);
      c.cb_tile(c.c_s() + ((it - ib) * kTile + g) * L.ldn + t,
                c.base(s) + g * L.ldn + t, 0, L.np, cb);
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh >= nh) break;
        float part[NO][4];  // S · x_h(jt)
        zero(part);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          c.y_step(cb[n], it, jt, n, cum_i[hh], c.cum_at(s, hh),
                   c.dt_at(s, hh), c.x_at(s, hh) + (8 * n + 2 * t) * L.ldp + g,
                   part);
        add_to(yacc[hh], part);
      }
    };
    stream_tiles(
        ib + nib, L.stages, [&] { c.stage_c(ib, nib); },
        [&](int jt, int s) { c.issue(jt, s, 0, nh); },
        [&](int jt, int s) {
          if (mine && jt <= it) y_tile(jt, s);
        });
    if (mine) {
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh >= nh) break;
#pragma unroll
        for (int o = 0; o < NO; ++o)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = it * kTile + g + 8 * half;
            const int p = 8 * o + 2 * t;
            if (i < a.Q && p < c.pw)
              store_pair(a.y + ((c.mq + i) * a.H + c.h0 + hh) * a.P +
                             c.p0 + p,
                         yacc[hh][o][2 * half], yacc[hh][o][2 * half + 1],
                         p + 1 < c.pw, pair_p);
          }
      }
    }
  }
  // the state: a rectangle (both heads) a warp, a round of 8 rectangles a
  // pass over the tiles
  const int rects = c.n_rects();
  const float cum_last[kHeads] = {c.cum_last(0), nh > 1 ? c.cum_last(1) : 0.f};
  for (int r0 = 0; r0 < rects; r0 += kWarps) {
    const int rc = r0 + warp;
    float acc[kHeads][St::MTW][St::NTW][4];
    zero(acc);
    stream_tiles(
        L.nt, L.stages, [] {},
        [&](int qt, int s) { c.issue(qt, s, 0, nh); },
        [&](int qt, int s) {
          if (rc < rects) c.rect_tile(rc, qt, s, cum_last, acc);
        });
    if (rc < rects) c.rect_store(rc, acc);
  }
}

template <int PS>
int launch(const Args& a, int M, void* stream) {
  const Layout L(a.Q, PS, a.N);
  const size_t smem = L.floats() * sizeof(float);
  const int splits = (a.P + PS - 1) / PS;
  const unsigned grid = static_cast<unsigned>(
      static_cast<long long>(M) * ((a.H + kHeads - 1) / kHeads) * splits);
  auto s = static_cast<cudaStream_t>(stream);
  if (L.resident) {
    repro_attn::allow_smem(ssd_resident<PS>, smem);
    ssd_resident<PS><<<grid, kThreads, smem, s>>>(a, splits);
  } else {
    repro_attn::allow_smem(ssd_streamed<PS>, smem);
    ssd_streamed<PS><<<grid, kThreads, smem, s>>>(a, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes (kernels/common.py ssd_smem
// mirrors it).
extern "C" long long ssd_chunk_scan_smem(int Q, int ps, int N) {
  return Layout(Q, ps, N).floats() * static_cast<long long>(sizeof(float));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a P slice outside the kernel's instances (the
// wrapper's plan never asks for one).
extern "C" int ssd_chunk_scan(const void* x, const void* dt, const void* cum,
                              const void* b, const void* c, void* y,
                              void* state, int M, int Q, int H, int P, int N,
                              int ps, void* stream) {
  if ((ps != 16 && ps != 32 && ps != 64) || M < 1 || Q < 1 || H < 1 ||
      P < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  Args a{static_cast<const float*>(x),   static_cast<const float*>(dt),
         static_cast<const float*>(cum), static_cast<const float*>(b),
         static_cast<const float*>(c),   static_cast<float*>(y),
         static_cast<float*>(state),     Q, H, P, N,
         (P % 4 == 0 && N % 4 == 0 && bits % 16 == 0) ? 1 : 0};
  switch (ps) {
    case 16:
      return launch<16>(a, M, stream);
    case 32:
      return launch<32>(a, M, stream);
    default:
      return launch<64>(a, M, stream);
  }
}
