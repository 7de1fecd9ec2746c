// Skinny float32 GEMM on Hopper: Y (M, N) = X (M, K) · W (K, N) for at most
// 16 rows of X, with W row-major (N contiguous, any row stride), the layout
// every projection of the model step already has: wq (d, h·e), wk/wv
// (d, kv·e), wo (h·e, d), w_gate/w_up (d, F), w_down (F, d), lm_head (d, V).
// Exact float32 FMAs: no TF32, no weight in another type or layout, no
// copy of a weight; only the order of summation differs from cuBLAS's.
//
// Replaces no TPU kernel: the JAX package leaves its projections to XLA
// (the einsums of src/repro/models/transformer.py and layers.py). It was
// added because a serving decode step multiplies a few rows (one a slot)
// against every float32 weight of the model, 16 flops for every 4 bytes
// read: twenty times below the card's float32 ridge, so the only aim is to
// keep HBM streaming. cuBLAS's split-K SIMT GEMM streamed such a product at
// ~60% of HBM, and the einsum of wo's (h, e, d) view copied the whole
// weight first.
//
// Bound: bytes. Every weight is read once: K · N · 4 bytes at 3.35 TB/s
// (chameleon-34b's FFN, 3 × 8192 × 22016 floats, 0.646 ms a layer; its
// 8192 × 8192 wo 0.080 ms); X (at most 16 rows) and Y are small beside it.
//
// Design. A CTA owns a tile of kBN = 128 columns (4 a lane) and a slice of
// K; the K slices of one column tile are the `split` CTAs of one cluster.
//   * The warps of a CTA take the slice's groups of 4 rows in turn (a gated
//     launch: four warps a weight). Each warp streams its groups through a
//     ring of kStages shared-memory stages of its own with cp.async: a
//     lane copies its 4 columns of the group's 4 rows (16 bytes each; a
//     warp, 512 contiguous bytes a row), and lanes below M copy X's 4
//     matching floats of their row beside them. kStages - 1 groups stay in
//     flight while the warp sums the oldest, 96 KB an SM at two CTAs an SM:
//     enough to cover HBM's latency at the full rate, and the copies hold
//     no registers. (Loads straight into registers streamed at 80-86% of
//     HBM at one row and lost a tenth more at 8 and half at 16: the sums
//     left too few loads in flight. A ring of bulk copies, one 512-byte
//     copy a row for the whole CTA, streamed at 40-75% however deep: the
//     copies' issue set the pace.)
//   * A lane keeps M × 4 float32 sums in registers: 16 FMAs for every
//     16-byte row of W and of X it reads back from the stage; a warp waits
//     only for its own copies (the ring is its own: no CTA barrier).
//   * The warps' sums meet in shared memory in warp order, then the
//     cluster's CTAs combine their partials through distributed shared
//     memory in rank order, each CTA a share of the outputs: one launch does
//     the whole product with no atomics, no scratch and no second pass, and
//     the same inputs give the same bits.
//   * One launch serves up to three weights read against the same X, each
//     its own output (wq, wk, wv: their column tiles one after another), or
//     two of one width as gate and up, whose epilogue writes silu(g) · u
//     alone.
// The wrapper (kernels/skinny_gemm.py, plan) derives the split from K, the
// column tiles and the card's SM count; the kernel takes it.
//
// Alignment: X's rows, W's rows and the outputs start on 16 bytes, and K,
// N and the row strides are multiples of 4 floats (16-byte loads); the
// wrapper routes anything else elsewhere.
#include "attention.cuh"

namespace {

constexpr int kBN = 128;             // columns a CTA: 4 a lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;           // a warp's ring: groups of 4 rows
constexpr int kMaxSegs = 3;
constexpr int kMaxSplit = 8;         // CTAs a cluster (the portable limit)
constexpr int kMaxDevices = 64;      // devices whose smem limit is kept

struct Seg {
  const float* w;
  long long ldw;                     // W's row stride, in floats
  float* y;                          // (M, n) contiguous
  int n;
  int tile0;                         // the segment's first column tile
};

struct Params {
  const float* x;
  long long ldx;                     // X's row stride, in floats
  int M, K;
  Seg seg[kMaxSegs];
  int nseg;                          // gated: 2 (gate, up), one output
  int kslice;                        // rows of K a CTA, a multiple of 4
  int split;                         // CTAs a cluster, along K
};

// ------------------------------------------------------------- clusters
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The float4 at p (this CTA's shared memory, 16-byte aligned) in the CTA of
// cluster rank r.
__device__ __forceinline__ float4 ld_rank4(const float* p, int r) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(r));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// 16 bytes from global `src` to shared `dst`, both 16-byte aligned, cached
// in L2 only; counted in the thread's current cp.async group.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Segment i of p, selected by value: a dynamic index into the parameters
// would copy them to local memory.
__device__ __forceinline__ Seg seg_at(const Params& p, int i) {
  return i == 0 ? p.seg[0] : i == 1 ? p.seg[1] : p.seg[2];
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

// Floats of one stage of a warp's ring: the group's 4 rows of the tile,
// then X's 4 floats of each of the MP rows.
template <int MP>
__host__ __device__ constexpr int stage_floats() {
  return 4 * kBN + 4 * MP;
}

// MP: M rounded up to 1, 2, 4, 8 or 16 (rows of sums a lane keeps; rows at
// or past M sum zeros and are never stored). NW: weights a CTA reads, 1,
// or 2 for gate and up.
template <int MP, int NW>
__global__ void __launch_bounds__(kThreads, 2)
    skinny_gemm_kernel(const Params p) {
  // the warps' rings; once drained, the warps' sums (kWarps × MP × kBN)
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarpsPerW = kWarps / NW;
  constexpr int kStage = stage_floats<MP>();

  const int rank = static_cast<int>(cluster_rank());
  const int tile = blockIdx.x / p.split;
  int s = 0;
  if (NW == 1)
    while (s + 1 < p.nseg && tile >= seg_at(p, s + 1).tile0) ++s;
  const Seg out_seg = seg_at(p, s);    // gated: gate, and the output
  const int n0 = (tile - out_seg.tile0) * kBN;
  const int ncols = min(kBN, out_seg.n - n0);
  const int k_begin = min(p.K, rank * p.kslice);
  const int groups = (min(p.K, k_begin + p.kslice) - k_begin) / 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = warp / kWarpsPerW;     // the weight this warp reads
  const int wi = warp % kWarpsPerW;
  const Seg sw = NW == 1 ? out_seg : (g == 0 ? p.seg[0] : p.seg[1]);
  const bool on = 4 * lane < ncols;
  const long long ldw = sw.ldw;
  const float* wp = sw.w + k_begin * ldw + n0 + 4 * lane;
  const float* xp = p.x + k_begin + lane * p.ldx;     // lanes below M
  // this warp's groups: wi, wi + kWarpsPerW, ...
  const int count = groups > wi ? (groups - wi - 1) / kWarpsPerW + 1 : 0;
  float* ring = smem + warp * kStages * kStage;

  // X's rows at or past M read zeros: lanes M..MP-1 clear theirs once
  if (lane >= p.M && lane < MP) {
#pragma unroll
    for (int t = 0; t < kStages; ++t)
      *reinterpret_cast<float4*>(ring + t * kStage + 4 * kBN + 4 * lane) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // group t of this warp into its stage; one cp.async group a call, empty
  // past the last
  auto issue = [&](int t) {
    if (t < count) {
      const int j = wi + t * kWarpsPerW;
      float* st = ring + (t % kStages) * kStage;
      if (on) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          copy16(st + i * kBN + 4 * lane, wp + (4 * j + i) * ldw);
      }
      if (lane < p.M) copy16(st + 4 * kBN + 4 * lane, xp + 4 * j);
    }
    commit_group();
  };

  float acc[MP][4];
#pragma unroll
  for (int m = 0; m < MP; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < count; ++t) {
    issue(t + kStages - 1);
    wait_groups<kStages - 1>();        // this lane's copies of group t
    __syncwarp();                      // and every lane's (X's rows)
    const float* st = ring + (t % kStages) * kStage;
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = *reinterpret_cast<const float4*>(st + i * kBN + 4 * lane);
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      const float4 xv =
          *reinterpret_cast<const float4*>(st + 4 * kBN + 4 * m);
      acc[m][0] = fmaf(xv.x, w4[0].x, acc[m][0]);
      acc[m][1] = fmaf(xv.x, w4[0].y, acc[m][1]);
      acc[m][2] = fmaf(xv.x, w4[0].z, acc[m][2]);
      acc[m][3] = fmaf(xv.x, w4[0].w, acc[m][3]);
      acc[m][0] = fmaf(xv.y, w4[1].x, acc[m][0]);
      acc[m][1] = fmaf(xv.y, w4[1].y, acc[m][1]);
      acc[m][2] = fmaf(xv.y, w4[1].z, acc[m][2]);
      acc[m][3] = fmaf(xv.y, w4[1].w, acc[m][3]);
      acc[m][0] = fmaf(xv.z, w4[2].x, acc[m][0]);
      acc[m][1] = fmaf(xv.z, w4[2].y, acc[m][1]);
      acc[m][2] = fmaf(xv.z, w4[2].z, acc[m][2]);
      acc[m][3] = fmaf(xv.z, w4[2].w, acc[m][3]);
      acc[m][0] = fmaf(xv.w, w4[3].x, acc[m][0]);
      acc[m][1] = fmaf(xv.w, w4[3].y, acc[m][1]);
      acc[m][2] = fmaf(xv.w, w4[3].z, acc[m][2]);
      acc[m][3] = fmaf(xv.w, w4[3].w, acc[m][3]);
    }
    __syncwarp();                      // the stage is read: refill it
  }
  wait_groups<0>();
  __syncthreads();                     // every ring drained
  float* red = smem;

  // The warps' sums, red[warp][m][col], meet in warp order into the CTA's
  // partial, part[g][m][col] (in place: red's first NW planes; each thread
  // reads and writes its own elements only)
#pragma unroll
  for (int m = 0; m < MP; ++m)
    *reinterpret_cast<float4*>(red + (warp * MP + m) * kBN + lane * 4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int e = threadIdx.x; e < p.M * kBN; e += kThreads) {
    float part[NW];
#pragma unroll
    for (int gg = 0; gg < NW; ++gg) {
      float sum = red[(gg * kWarpsPerW) * MP * kBN + e];
#pragma unroll
      for (int w = gg * kWarpsPerW + 1; w < (gg + 1) * kWarpsPerW; ++w)
        sum += red[w * MP * kBN + e];
      part[gg] = sum;
    }
#pragma unroll
    for (int gg = 0; gg < NW; ++gg) red[gg * MP * kBN + e] = part[gg];
  }

  // the cluster's partials, rank by rank, a share of the float4s of
  // outputs a CTA
  cluster_sync();
  const int total = p.M * (kBN / 4);
  const int share = (total + p.split - 1) / p.split;
  const int e1 = min(total, (rank + 1) * share);
  float* y = out_seg.y;
  const int ldy = out_seg.n;
  for (int e = rank * share + threadIdx.x; e < e1; e += kThreads) {
    const int m = e / (kBN / 4);
    const int c = 4 * (e % (kBN / 4));
    if (c >= ncols) continue;
    float4 v[NW];
#pragma unroll
    for (int gg = 0; gg < NW; ++gg) {
      const float* at = red + gg * MP * kBN + m * kBN + c;
      v[gg] = ld_rank4(at, 0);
      for (int r = 1; r < p.split; ++r) {
        const float4 o = ld_rank4(at, r);
        v[gg].x += o.x;
        v[gg].y += o.y;
        v[gg].z += o.z;
        v[gg].w += o.w;
      }
    }
    float4 out = v[0];
    if (NW == 2)
      out = make_float4(silu(v[0].x) * v[NW - 1].x,
                        silu(v[0].y) * v[NW - 1].y,
                        silu(v[0].z) * v[NW - 1].z,
                        silu(v[0].w) * v[NW - 1].w);
    *reinterpret_cast<float4*>(y + static_cast<long long>(m) * ldy + n0 + c) =
        out;
  }
  cluster_sync();  // no CTA leaves while another reads its partials
}

// The warps' rings, which the warps' sums (kWarps × MP × kBN floats) take
// over once drained: whichever is larger.
constexpr size_t smem_bytes(int mp) {
  const int rings = kWarps * kStages * (4 * kBN + 4 * mp);
  const int sums = kWarps * mp * kBN;
  return 4 * static_cast<size_t>(rings > sums ? rings : sums);
}

template <int MP, int NW>
cudaError_t launch(const Params& p, int tiles, cudaStream_t stream) {
  auto kernel = skinny_gemm_kernel<MP, NW>;
  // The smem limit is an attribute of the current device's function: set
  // once an instance and device (every launch on a device past the table),
  // so that a process that launches on several cards raises it on each.
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(MP)));
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(MP);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

template <int NW>
cudaError_t dispatch_m(const Params& p, int tiles, cudaStream_t stream) {
  if (p.M <= 1) return launch<1, NW>(p, tiles, stream);
  if (p.M <= 2) return launch<2, NW>(p, tiles, stream);
  if (p.M <= 4) return launch<4, NW>(p, tiles, stream);
  if (p.M <= 8) return launch<8, NW>(p, tiles, stream);
  return launch<16, NW>(p, tiles, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Y_i (M, n_i) = X (M, K) · W_i (K, n_i) for the nseg (1-3) segments, or,
// gated (nseg 2, n0 == n1), Y_0 = silu(X · W_0) · (X · W_1). Launches on
// `stream` in clusters of `split` (1-8) CTAs and returns the launch's CUDA
// error (0 on success); operands outside the kernel's reach (M outside
// 1-16, K, n or a stride not a multiple of 4, a pointer off 16 bytes, a
// stride below its row) are refused with cudaErrorInvalidValue.
extern "C" int skinny_gemm(const void* x, long long ldx, int M, int K,
                           const void* w0, long long ldw0, int n0, void* y0,
                           const void* w1, long long ldw1, int n1, void* y1,
                           const void* w2, long long ldw2, int n2, void* y2,
                           int nseg, int gated, int split, void* stream) {
  const void* ws[kMaxSegs] = {w0, w1, w2};
  void* ys[kMaxSegs] = {y0, y1, y2};
  const long long lds[kMaxSegs] = {ldw0, ldw1, ldw2};
  const int ns[kMaxSegs] = {n0, n1, n2};
  bool ok = M >= 1 && M <= 16 && K >= 4 && K % 4 == 0 && ldx >= K &&
            ldx % 4 == 0 && aligned16(x) && nseg >= 1 && nseg <= kMaxSegs &&
            (!gated || (nseg == 2 && n0 == n1)) && split >= 1 &&
            split <= kMaxSplit;
  Params p{};
  p.x = static_cast<const float*>(x);
  p.ldx = ldx;
  p.M = M;
  p.K = K;
  p.nseg = nseg;
  p.split = split;
  const int per = (K + split - 1) / split;
  p.kslice = (per + 3) / 4 * 4;
  int tiles = 0;
  for (int i = 0; i < nseg && ok; ++i) {
    ok = ns[i] >= 4 && ns[i] % 4 == 0 && lds[i] >= ns[i] &&
         lds[i] % 4 == 0 && aligned16(ws[i]) && aligned16(ys[i]);
    p.seg[i] = Seg{static_cast<const float*>(ws[i]), lds[i],
                   static_cast<float*>(ys[i]), ns[i], tiles};
    if (!gated || i == 0) tiles += (ns[i] + kBN - 1) / kBN;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t status =
      gated ? dispatch_m<2>(p, tiles, s) : dispatch_m<1>(p, tiles, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(status != cudaSuccess ? status : last);
}
