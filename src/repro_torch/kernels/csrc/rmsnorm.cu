// Fused RMSNorm on Hopper: y = x · rsqrt(mean(x²) + eps) · w over the rows
// of an (R, D) matrix, float32 statistics, the result cast back to x's
// dtype (float32 or bfloat16; w float32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm,
// which took row blocks of 256 into VMEM and asserted R % row_block == 0.
//
// Bound: bytes — x read once and y written once (the weight is D floats);
// at R = 4096, D = 2048 in float32 that is 67 MB, 20 µs at 3.35 TB/s. So
// the design is about keeping enough bytes in flight and reading x once:
//
//   * register variant (D <= 8 · 2048): a team of `team_warps` warps owns
//     a row (one warp up to 2048 elements, 64 a lane). Every lane issues
//     all its copies of the row (VB bytes each: 16, 8, 4 or 2, the widest
//     that x's and out's base pointers and D · the element size allow,
//     chosen by the wrapper's plan) before it uses any, keeps them in registers
//     through the sum of squares (warp shuffles, then across the team's
//     warps through shared memory in a fixed order) and scales them from
//     there: x is read once. Stores are VB bytes too. The grid is
//     persistent (as many CTAs as fit on the SMs at once), each walking
//     rows with a stride; the weight is staged in shared memory once per
//     CTA while the first row's copies are in flight, and the next row's
//     are in flight while a row is summed, scaled and stored: in a second
//     register set where a lane's copies of a row take at most 32
//     registers (bfloat16 with 16-byte copies), else issued copy by copy
//     into the registers of this row's as they are stored; two CTAs of 8
//     warps an SM with 16-byte copies. Where x and the output together
//     outgrow the card's L2 (50 MB on an H100; the wrapper's plan) the
//     copies are evict-first.
//   * streaming variant (longer rows): one CTA of 1024 threads a row, VB
//     bytes a copy; x is read twice (the second pass mostly from L2) and
//     the weight from L2 each row.
//
// Measured on an H100 (chip_smoke.py, PERF.md): 4096 x 2048 float32 in
// ~0.0254 ms, 79% of the bound and ~6% under F.rms_norm. The read-once
// row alone left it behind F.rms_norm; the evict-first copies (the rows
// the call streams once go first from the L2) and the next row in flight
// while a row is stored, at two CTAs an SM, brought it ahead.
//
// Any R >= 1 and D >= 1: lanes past a row's end idle, CTAs past the last
// row return.
#include "attention.cuh"

namespace {

using repro_attn::warp_sum;

constexpr int kWarpElems = 2048;   // elements a warp keeps in registers
constexpr int kMaxTeamWarps = 8;   // register variant: D <= 16384
constexpr int kThreads = 256;      // register variant, one warp a row
constexpr int kStreamThreads = 1024;

// A load or store of a V, plain or evict-first (ld/st.global.cs: lines
// that the L2 drops first, for a call that moves more than the L2 holds).
template <bool kEvict, typename V>
__device__ __forceinline__ V ld(const void* p) {
  if constexpr (kEvict)
    return __ldcs(static_cast<const V*>(p));
  else
    return *static_cast<const V*>(p);
}
template <bool kEvict, typename V>
__device__ __forceinline__ void st(void* p, V v) {
  if constexpr (kEvict)
    __stcs(static_cast<V*>(p), v);
  else
    *static_cast<V*>(p) = v;
}

// VB bytes of x as 32-bit words (one 16-bit word for VB = 2).
template <int VB>
struct Words {
  static constexpr int W = VB >= 4 ? VB / 4 : 1;
  uint32_t w[W];
  template <bool kEvict>
  __device__ __forceinline__ void load(const void* p) {
    if constexpr (VB == 16) {
      const uint4 v = ld<kEvict, uint4>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (VB == 8) {
      const uint2 v = ld<kEvict, uint2>(p);
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (VB == 4) {
      w[0] = ld<kEvict, unsigned int>(p);
    } else {
      w[0] = ld<kEvict, unsigned short>(p);
    }
  }
  template <bool kEvict>
  __device__ __forceinline__ void store(void* p) const {
    if constexpr (VB == 16)
      st<kEvict>(p, make_uint4(w[0], w[1], w[2], w[3]));
    else if constexpr (VB == 8)
      st<kEvict>(p, make_uint2(w[0], w[1]));
    else if constexpr (VB == 4)
      st<kEvict>(p, static_cast<unsigned int>(w[0]));
    else
      st<kEvict>(p, static_cast<unsigned short>(w[0]));
  }
  // element i as float32; T is float or bfloat16 (element 2k in the low
  // half of word k)
  template <typename T>
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[i]);
    else if constexpr (VB == 2)
      return __uint_as_float(w[0] << 16);
    else
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xFFFF0000u)
                                     : (w[i >> 1] << 16));
  }
  template <typename T>
  __device__ __forceinline__ void set(int i, float v) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(v);
    } else {
      const uint32_t u = __bfloat16_as_ushort(__float2bfloat16(v));
      if constexpr (VB == 2)
        w[0] = u;
      else if (i & 1)
        w[i >> 1] = (w[i >> 1] & 0xFFFFu) | (u << 16);
      else
        w[i >> 1] = (w[i >> 1] & 0xFFFF0000u) | u;
    }
  }
};

// E weights from shared memory, from element i·E (16-byte aligned reads
// where E >= 4).
template <int E>
__device__ __forceinline__ void weights(const float* w_s, int i,
                                        float (&wv)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w_s + i * E + k);
      wv[k] = v.x, wv[k + 1] = v.y, wv[k + 2] = v.z, wv[k + 3] = v.w;
    }
  } else if constexpr (E == 2) {
    const float2 v = *reinterpret_cast<const float2*>(w_s + i * E);
    wv[0] = v.x, wv[1] = v.y;
  } else {
    wv[0] = w_s[i];
  }
}

// Two CTAs an SM (at most 128 registers a thread) where a lane holds at
// most 16 copies of a row; one where it holds 32 or 64 (copies of 8 bytes
// or less), whose copies alone would fill 128 registers.
template <typename T, int VB>
constexpr int kRegsCtas = kWarpElems / 32 / (VB / sizeof(T)) <= 16 ? 2 : 1;

template <typename T, int VB, bool kEvict>
__global__ void __launch_bounds__(kThreads, (kRegsCtas<T, VB>))
    rmsnorm_regs(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ out, long long R, int D, float eps,
                 int team_warps) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  constexpr int K = kWarpElems / 32 / E;  // copies a lane can hold
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                        // D weights
  float* red = smem + ((D + 3) & ~3);       // 2 x kMaxTeamWarps partials
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tpr = 32 * team_warps;          // threads a row
  const int teams = blockDim.x / tpr;       // rows a CTA holds at once
  const int team = warp / team_warps;
  const int tt = threadIdx.x - team * tpr;
  const int nvec = D / E;
  const long long stride = static_cast<long long>(gridDim.x) * teams;
  auto row_ptr = [&](long long row) {
    return reinterpret_cast<const char*>(x + row * D);
  };
  // The row's sum of squares (across the team's warps through shared
  // memory in a fixed order, where a row has more than one warp).
  int parity = 0;
  auto row_inv = [&](const Words<VB> (&v)[K]) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (tt + k * tpr < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float f = v[k].template get<T>(e);
          ss = fmaf(f, f, ss);
        }
      }
    }
    ss = warp_sum(ss);
    if (team_warps > 1) {  // one team a CTA: the barrier is uniform
      if (lane == 0) red[parity * kMaxTeamWarps + warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < team_warps; ++i)
        ss += red[parity * kMaxTeamWarps + i];
      parity ^= 1;
    }
    return rsqrtf(ss / static_cast<float>(D) + eps);
  };
  // Copy k of the row at xr into v[k], and v[k] scaled into the row at yr.
  auto load = [&](Words<VB>& v, const char* xr, int k) {
    const int i = tt + k * tpr;
    if (i < nvec) v.template load<kEvict>(xr + static_cast<size_t>(i) * VB);
  };
  auto scale_store = [&](Words<VB>& v, char* yr, int k, float inv) {
    const int i = tt + k * tpr;
    float wv[E];
    weights<E>(w_s, i, wv);
#pragma unroll
    for (int e = 0; e < E; ++e)
      v.template set<T>(e, v.template get<T>(e) * inv * wv[e]);
    v.template store<kEvict>(yr + static_cast<size_t>(i) * VB);
  };
  auto out_ptr = [&](long long row) {
    return reinterpret_cast<char*>(out + row * D);
  };

  // Rows row, row + stride, ...; the first row's copies are in flight
  // while the weight is staged, and the next row's while a row is summed,
  // scaled and stored. Where a lane's copies of a row take at most 32
  // registers the rows take turns in two register sets; else there is one
  // set, and each copy of the next row is issued into the registers of
  // this row's as soon as they are stored.
  long long row = static_cast<long long>(blockIdx.x) * teams + team;
  Words<VB> a[K];
  if (row < R) {
#pragma unroll
    for (int k = 0; k < K; ++k) load(a[k], row_ptr(row), k);
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) w_s[i] = w[i];
  __syncthreads();
  if constexpr (K * Words<VB>::W <= 32) {
    Words<VB> b[K];
    for (; row < R; row += 2 * stride) {
      const long long next = row + stride;
      if (next < R) {
#pragma unroll
        for (int k = 0; k < K; ++k) load(b[k], row_ptr(next), k);
      }
      float inv = row_inv(a);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (tt + k * tpr < nvec) scale_store(a[k], out_ptr(row), k, inv);
      if (next >= R) break;
      if (next + stride < R) {
#pragma unroll
        for (int k = 0; k < K; ++k) load(a[k], row_ptr(next + stride), k);
      }
      inv = row_inv(b);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (tt + k * tpr < nvec) scale_store(b[k], out_ptr(next), k, inv);
    }
  } else {
    for (; row < R; row += stride) {
      const float inv = row_inv(a);
      const bool more = row + stride < R;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (tt + k * tpr < nvec) {
          scale_store(a[k], out_ptr(row), k, inv);
          if (more) load(a[k], row_ptr(row + stride), k);
        }
      }
    }
  }
}

// The CTA's sum of one float per thread, in a fixed order (warps, then
// warp 0 over the 32 partials); every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is free for the next row
  return v;
}

template <typename T, int VB>
__global__ void __launch_bounds__(kStreamThreads)
    rmsnorm_stream(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, long long R, int D, float eps) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  __shared__ float red[33];
  const int nvec = D / E;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const char* xr = reinterpret_cast<const char*>(x + row * D);
    char* yr = reinterpret_cast<char*>(out + row * D);
    float ss = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      Words<VB> v;
      v.template load<false>(xr + static_cast<size_t>(i) * VB);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float f = v.template get<T>(e);
        ss = fmaf(f, f, ss);
      }
    }
    const float inv =
        rsqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      Words<VB> v;
      v.template load<false>(xr + static_cast<size_t>(i) * VB);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v.template set<T>(e, v.template get<T>(e) * inv * __ldg(w + i * E + e));
      v.template store<false>(yr + static_cast<size_t>(i) * VB);
    }
  }
}

template <typename T, int VB, bool kEvict>
int launch(const void* x, const void* w, void* out, long long R, int D,
           float eps, int team_warps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (team_warps == 0) {
    const long long grid = R < 16LL * sms ? R : 16LL * sms;
    rmsnorm_stream<T, VB><<<static_cast<unsigned>(grid), kStreamThreads, 0,
                            s>>>(xt, wt, ot, R, D, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = team_warps > 1 ? 32 * team_warps : kThreads;
  const int rows_per_cta = threads / (32 * team_warps);
  const size_t smem = (((D + 3) & ~3) + 2 * kMaxTeamWarps) * sizeof(float);
  auto kernel = rmsnorm_regs<T, VB, kEvict>;
  repro_attn::allow_smem(kernel, smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long need = (R + rows_per_cta - 1) / rows_per_cta;
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<static_cast<unsigned>(need < fit ? need : fit), threads, smem,
           s>>>(xt, wt, ot, R, D, eps, team_warps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kEvict>
int dispatch_vb(int vb, const void* x, const void* w, void* out, long long R,
                int D, float eps, int team_warps, cudaStream_t s) {
  switch (vb) {
    case 16:
      return launch<T, 16, kEvict>(x, w, out, R, D, eps, team_warps, s);
    case 8:
      return launch<T, 8, kEvict>(x, w, out, R, D, eps, team_warps, s);
    case 4:
      return launch<T, 4, kEvict>(x, w, out, R, D, eps, team_warps, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<T, 2, kEvict>(x, w, out, R, D, eps, team_warps, s);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int vb, int evict, const void* x, const void* w, void* out,
             long long R, int D, float eps, int team_warps, cudaStream_t s) {
  return evict ? dispatch_vb<T, true>(vb, x, w, out, R, D, eps, team_warps, s)
               : dispatch_vb<T, false>(vb, x, w, out, R, D, eps, team_warps,
                                       s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_bf16 selects bfloat16 (1) or float32 (0) for x and out; vb is the copy
// width in bytes, team_warps the warps a row (0: the streaming variant) and
// evict (1) the evict-first loads and stores of the register variant, all
// as the wrapper's plan (kernels/rmsnorm.py) chose them for these pointers
// and this row. A width outside 2-16 bytes or below an element, or a team
// too small for the row, is refused with cudaErrorInvalidValue.
extern "C" int rmsnorm(const void* x, const void* w, void* out, long long R,
                       int D, float eps, int x_bf16, int vb, int team_warps,
                       int evict, void* stream) {
  const int elt = x_bf16 ? 2 : 4;
  if (R < 1 || D < 1 || vb < elt || vb > 16 || (vb & (vb - 1)) ||
      team_warps < 0 || team_warps > kMaxTeamWarps ||
      (team_warps > 0 && static_cast<long long>(team_warps) * kWarpElems < D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(vb, evict, x, w, out, R, D, eps,
                                   team_warps, s);
  return dispatch<float>(vb, evict, x, w, out, R, D, eps, team_warps, s);
}
