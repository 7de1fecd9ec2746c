// Device code shared by the contiguous-cache serving attention kernels
// (decode_attention.cu, prefill_attention.cu), and the small helpers every
// kernel source uses (kNegInf, to_f32, allow_smem, dispatch_dtypes, the C
// error-string entry). The paged kernels have their own device code since
// their Hopper redesign (paged_attention.cuh), and the full-sequence flash
// kernels theirs (flash_mma.cuh).
//
// attend computes softmax(q k^T / sqrt(d)) v for query rows against a KV
// cache read in place, in the model's layout, by pointer arithmetic —
// never through a gathered or transposed copy. The walk is templated on
// the addressing; ContiguousAddr is the one instance: a row's positions lie
// at a fixed stride in its own slot of a (B, S, KV, d) cache (any strides,
// unit along d); tiles of kContiguousTile positions, the last one cut at S.
// Nothing at or past S is read: the serving cache's spare drop position
// stays unseen.
//
// One warp owns one query row. The CTA's warps share one (batch row, KV
// head) and therefore the same tiles: each tile's K and V slabs are staged
// once in shared memory (float32, rows padded to d+1 so that lanes reading
// one column of different rows hit different banks) and consumed by every
// warp. Per tile, lanes split the tile's tokens for the scores and the head
// dimension for the P·V product; the softmax is online (running max m,
// running sum l, accumulator acc in float32), as in the Pallas kernels.
//
// Contracts carried over from the JAX package:
//   * fused RoPE in float32, split halves (x1 = first d/2, x2 = second d/2),
//     q rotated at the row's position, then scaled by 1/sqrt(d);
//   * a row at position qpos attends cache positions <= qpos; a tile whose
//     first position lies beyond every row of the CTA is not read at all;
//   * masked logits are -1e30 and the output is acc / max(l, 1e-30), so a
//     row that reads no tile (decode length 0) yields 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;
constexpr int kAccPerLane = kMaxHeadDim / 32;
// one score per lane per tile
constexpr int kContiguousTile = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Position t of tile j sits at element tile_base(j) + t * stride (element 0
// of its head vector); count(j) of the tile's `tile` positions exist.
struct ContiguousAddr {
  long long row;     // b * stride_b + kvh * stride_kv
  long long stride;  // between positions
  int s;             // positions the kernel may read
  int tile;
  __device__ int tiles() const { return (s + tile - 1) / tile; }
  __device__ int count(int j) const { return min(tile, s - j * tile); }
  __device__ long long tile_base(int j) const {
    return row + static_cast<long long>(j) * tile * stride;
  }
};

// Dynamic shared memory of one CTA, in floats: the K and V tile slabs
// (tile x (d+1) each), then per warp its rotated query row (d) and its
// score/probability row (tile).
inline size_t smem_floats(int nwarps, int tile, int d) {
  return 2 * static_cast<size_t>(tile) * (d + 1) +
         static_cast<size_t>(nwarps) * (d + tile);
}

// Attend this warp's query row (if has_row) over the tiles of one batch
// row. Every warp of the CTA calls this with the same horizon and addr,
// since the tile loop holds CTA-wide barriers.
//   q_row    — d query values of this row (unit stride)
//   o_row    — d output values, written as acc / max(l, 1e-30)
//   qpos     — the row's absolute position: RoPE angle and causal horizon
//   horizon  — the largest qpos of the CTA's rows; tiles past it are skipped
//   inv_freq — d/2 RoPE inverse frequencies, or nullptr for no RoPE
template <typename TQ, typename TKV, typename Addr>
__device__ void attend(const TQ* __restrict__ q_row, TQ* __restrict__ o_row,
                       bool has_row, int qpos, int horizon,
                       const TKV* __restrict__ k, const TKV* __restrict__ v,
                       const Addr& addr, int d,
                       const float* __restrict__ inv_freq, float scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ld = d + 1;
  const int tile = addr.tile;
  float* k_s = smem;
  float* v_s = k_s + tile * ld;
  float* q_s = v_s + tile * ld + warp * d;
  float* p_s = v_s + tile * ld + nwarps * d + warp * tile;

  if (has_row) {
    const int half = d / 2;
    for (int i = lane; i < half; i += 32) {
      float x1 = to_f32(q_row[i]);
      float x2 = to_f32(q_row[i + half]);
      if (inv_freq != nullptr) {
        const float ang = static_cast<float>(qpos) * inv_freq[i];
        const float sn = sinf(ang);
        const float cs = cosf(ang);
        const float r1 = x1 * cs - x2 * sn;
        const float r2 = x1 * sn + x2 * cs;
        x1 = r1;
        x2 = r2;
      }
      q_s[i] = x1 * scale;
      q_s[i + half] = x2 * scale;
    }
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kAccPerLane];
#pragma unroll
  for (int i = 0; i < kAccPerLane; ++i) acc[i] = 0.f;

  const int ntiles = addr.tiles();
  for (int j = 0; j < ntiles && j * tile <= horizon; ++j) {
    const long long first = addr.tile_base(j);
    const int n = addr.count(j);
    __syncthreads();  // the previous tile's slabs are consumed
    for (int i = threadIdx.x; i < tile * d; i += blockDim.x) {
      const int t = i / d;
      const int e = i - t * d;
      float kx = 0.f;
      float vx = 0.f;
      if (t < n) {
        const long long off = first + t * addr.stride + e;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[t * ld + e] = kx;
      v_s[t * ld + e] = vx;
    }
    __syncthreads();
    if (!has_row) continue;

    float mt = kNegInf;
    for (int t = lane; t < tile; t += 32) {
      const float* kr = k_s + t * ld;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(q_s[e], kr[e], s);
      s = (t < n && j * tile + t <= qpos) ? s : kNegInf;
      p_s[t] = s;
      mt = fmaxf(mt, s);
    }
    mt = warp_max(mt);
    const float m_new = fmaxf(m, mt);
    float ls = 0.f;
    for (int t = lane; t < tile; t += 32) {
      const float p = expf(p_s[t] - m_new);
      p_s[t] = p;
      ls += p;
    }
    ls = warp_sum(ls);
    const float alpha = expf(m - m_new);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // every lane's probabilities are in p_s
#pragma unroll
    for (int i = 0; i < kAccPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < d) {
        float pv = 0.f;
        for (int t = 0; t < tile; ++t) pv = fmaf(p_s[t], v_s[t * ld + e], pv);
        acc[i] = acc[i] * alpha + pv;
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  if (has_row) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kAccPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < d) store_f32(o_row + e, acc[i] / denom);
    }
  }
}

// Raise the CTA's dynamic shared-memory limit where a launch needs more
// than the default 48 KB.
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

// Call launcher.run<TQ, TKV>() with the element types that q_bf16 / kv_bf16
// select: bfloat16 (1) or float32 (0) for q/out and for the cache.
template <typename Launcher>
inline void dispatch_dtypes(int q_bf16, int kv_bf16,
                            const Launcher& launcher) {
  if (q_bf16 && kv_bf16)
    launcher.template run<__nv_bfloat16, __nv_bfloat16>();
  else if (q_bf16)
    launcher.template run<__nv_bfloat16, float>();
  else if (kv_bf16)
    launcher.template run<float, __nv_bfloat16>();
  else
    launcher.template run<float, float>();
}

}  // namespace repro_attn

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
