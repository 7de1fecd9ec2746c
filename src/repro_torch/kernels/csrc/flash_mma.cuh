// Device code shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): staging tiles with cp.async, and warp
// tile products on the tensor cores (mma.sync) in two precision routes.
//
//   * bf16 route — q and k/v both bfloat16: mma.sync.m16n8k16 bf16 with
//     float32 accumulators; fragments come from shared memory by ldmatrix
//     (rows padded by 16 bytes, so the eight row addresses of a phase fall
//     in eight distinct bank groups); probabilities and dS are rounded to
//     bfloat16 where they enter a product, as on every bf16 flash kernel.
//   * 3xTF32 route — any float32 operand: each float32 value x is split
//     into big = tf32(x) and small = x - big, and a product is
//     big·big + big·small + small·big with mma.sync.m16n8k8 TF32, summed in
//     float32 (CUTLASS's float32-accurate route on tensor cores; the
//     dropped small·small term is ~2^-22 of the product). A bfloat16
//     operand is exact in TF32, so its small part is 0 and its terms are
//     not issued. Fragments are plain 32-bit shared loads (rows padded by
//     16 bytes: the eight rows × four columns of a fragment hit 32 banks).
//
// The tensor cores truncate as they accumulate (each mma.sync rounds its
// sum toward zero), so a sum over thousands of keys or queries kept in one
// MMA accumulator drifts by up to an ulp of the running total a step. Each
// tile's product therefore goes into a fresh fragment, which is added to
// the running total in float32 (add_to); within a product the 3xTF32 small
// terms have a sum of their own (gemm_pv always, gemm_nt for dP).
//
// Products come in two shapes:
//   gemm_nt — C[16·MT × 8·NT] += A[16·MT rows] · B[8·NT rows]ᵀ over DP
//             columns, A and B both row-major tiles in shared memory (q·kᵀ,
//             k·qᵀ, dO·vᵀ, v·dOᵀ);
//   gemm_pv — C[16·MT × 8·NO] += P · B[8·NK rows][col0, col0 + 8·NO), where
//             P is a C fragment (16·MT × 8·NK) held in registers and B a
//             row-major tile whose rows are the reduction index (p·v,
//             pᵀ·dO, dSᵀ·q, dS·k). In the bf16 route the C fragment of two
//             n-tiles is the A fragment of one k16 step. In the TF32 route
//             the C layout (row g, columns 2t, 2t+1) differs from the A
//             layout (row g, columns t, t+4); since a product sums over
//             its reduction index in any order, A slot t is taken to be
//             key 2t and slot t+4 key 2t+1, and B's rows are read in the
//             same order — no shuffle and no shared-memory round trip.
#pragma once

#include <initializer_list>
#include <type_traits>
#include <utility>

// kNegInf, to_f32, allow_smem, dispatch_dtypes and the C error-string entry
#include "attention.cuh"

namespace flash {

using bf16 = __nv_bfloat16;
using repro_attn::allow_smem;
using repro_attn::dispatch_dtypes;
using repro_attn::kNegInf;
using repro_attn::to_f32;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// Row pitch, in elements, of a staged tile of DP columns: 16 bytes of pad.
template <typename T, int DP>
__host__ __device__ constexpr int pitch() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ staging
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? CB : 0;  // 0 bytes read: the destination is zeroed
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(CB), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a ROWS × DP tile, row r at src + r·stride, columns
// [0, d), into shared memory with row pitch pitch<T, DP>(); every other
// element is zeroed (rows past a ragged end, columns past d). CB bytes per
// copy: 16, 8 or 4 by cp.async, or 2 (bfloat16 rows that are not 4-byte
// aligned) by a plain load and store. Threads tid of nthr share the copy.
template <int CB, int ROWS, int DP, typename T>
__device__ __forceinline__ void load_rows_cb(T* dst, const T* src,
                                             long long stride, int n, int d,
                                             int tid, int nthr) {
  constexpr int E = CB / static_cast<int>(sizeof(T));
  constexpr int P = pitch<T, DP>();
  constexpr int CPR = DP / E;
  for (int i = tid; i < ROWS * CPR; i += nthr) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * E;
    const bool in = r < n && c < d;
    const T* s = in ? src + r * stride + c : src;
    if constexpr (CB >= 4)
      cp_async<CB>(dst + r * P + c, s, in);
    else
      dst[r * P + c] = in ? *s : __float2bfloat16(0.f);
  }
}

// The same, with the copy width the launcher chose for these operands
// (copy_bytes below): one kernel, one branch per tile, taken alike by
// every thread.
template <int ROWS, int DP, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int n, int d,
                                          int cb, int tid, int nthr) {
  if (cb == 16)
    load_rows_cb<16, ROWS, DP>(dst, src, stride, n, d, tid, nthr);
  else if (cb == 8)
    load_rows_cb<8, ROWS, DP>(dst, src, stride, n, d, tid, nthr);
  else if constexpr (sizeof(T) == 4)
    load_rows_cb<4, ROWS, DP>(dst, src, stride, n, d, tid, nthr);
  else if (cb == 4)
    load_rows_cb<4, ROWS, DP>(dst, src, stride, n, d, tid, nthr);
  else
    load_rows_cb<2, ROWS, DP>(dst, src, stride, n, d, tid, nthr);
}

template <int ROWS, int DP, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int n, int d,
                                          int cb) {
  load_rows<ROWS, DP>(dst, src, stride, n, d, cb, threadIdx.x, blockDim.x);
}

// n float32 values (a row's lse or delta) into shared memory, zero past n.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n,
                                         int rows, int tid, int nthr) {
  for (int i = tid; i < rows; i += nthr)
    cp_async<4>(dst + i, i < n ? src + i : src, i < n);
}

__device__ __forceinline__ void load_vec(float* dst, const float* src, int n,
                                         int rows) {
  load_vec(dst, src, n, rows, threadIdx.x, blockDim.x);
}

// A barrier for the nthr threads (whole warps) that share barrier id (1-15;
// 0 is __syncthreads').
__device__ __forceinline__ void sync_group(int id, int nthr) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthr) : "memory");
}

// The widest copy (16, 8 or 4 bytes; 2 for a bfloat16 row that is not
// 4-byte aligned) that every row of these operands allows: base address,
// every stride and the row's d elements all divisible by it.
inline int copy_bytes(int elt, int d, std::initializer_list<const void*> ptrs,
                      std::initializer_list<long long> strides) {
  unsigned long long bits = static_cast<unsigned long long>(d) * elt;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  for (long long s : strides)
    bits |= static_cast<unsigned long long>(s) * static_cast<unsigned>(elt);
  for (int cb : {16, 8, 4})
    if ((bits & (cb - 1)) == 0) return cb;
  return elt == 2 ? 2 : 4;
}

__device__ __forceinline__ void zero(float& x) { x = 0.f; }

// Every float of a fragment (any nesting of arrays) to 0.
template <typename T, int N>
__device__ __forceinline__ void zero(T (&frag)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) zero(frag[i]);
}

// acc += part, element by element, in float32 adds.
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// ------------------------------------------------------------ tensor cores
// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// half of the 13 dropped bits added to the magnitude, then cleared. Two
// integer instructions; cvt.rna.tf32.f32 adds a test for inf and NaN,
// which attention operands never hold, and costs twice as many.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// N registers of a TF32 operand fragment: big parts, and small parts when
// kSplit (a float32 source; a bfloat16 value is exact in TF32). small is
// the remainder x - big, exact in float32; the tensor cores read its top
// 19 bits (as CUTLASS's fast float32 route does), so x is carried to
// 2^-21 of |x| (ref.tf32_split).
template <int N, bool kSplit>
struct Frag {
  uint32_t big[N];
  uint32_t small[kSplit ? N : 1];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (kSplit) {
      big[i] = tf32_rna(x);
      small[i] = __float_as_uint(x - __uint_as_float(big[i]));
    } else {
      big[i] = __float_as_uint(x);
    }
  }
};

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a·b in 3xTF32 (the tensor cores truncate each sum toward zero, an ulp of
// the running value a step): big·big into c; the small terms into cs, when
// cs is not c a separate sum ~2^-11 of c whose own truncation is
// negligible, so that c pays one truncation a k-step rather than three.
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float* c, float* cs,
                                     const Frag<4, SA>& a,
                                     const Frag<2, SB>& b) {
  if constexpr (SA) mma_tf32(cs, a.small, b.big);
  if constexpr (SB) mma_tf32(cs, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C[16·MT × 8·NT] += A · Bᵀ over DP columns; a and b point at row 0 of the
// warp's 16·MT A rows (MT m-tiles, each B fragment serving all of them) and
// of the 8·NT B rows (row pitch pitch<T, DP>()). kSmallSum: the 3xTF32
// small terms get a sum of their own (mma3) — for dP, whose dP − delta
// cancels; the logits go without.
template <bool kBf16, int MT, int NT, int DP, bool kSmallSum = false,
          typename TA, typename TB>
__device__ __forceinline__ void gemm_nt(float (&c)[MT][NT][4],
                                        const TA* __restrict__ a,
                                        const TB* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  if constexpr (kBf16) {
    static_assert(kIsBf16<TA> && kIsBf16<TB> && NT % 2 == 0, "bf16 route");
    constexpr int P = pitch<bf16, DP>();
    const int mi = lane >> 3;
    const int ri = lane & 7;
    const bf16* pa = a + (ri + (mi & 1) * 8) * P + (mi >> 1) * 8;
    const bf16* pb = b + (ri + (mi >> 1) * 8) * P + (mi & 1) * 8;
#pragma unroll
    for (int k = 0; k < DP; k += 16) {
      uint32_t fa[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldmatrix_x4(fa[m], pa + 16 * m * P + k);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t fb[4];
        ldmatrix_x4(fb, pb + 8 * n * P + k);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(c[m][n], fa[m], fb);
          mma_bf16(c[m][n + 1], fa[m], fb + 2);
        }
      }
    }
  } else {
    constexpr int PA = pitch<TA, DP>();
    constexpr int PB = pitch<TB, DP>();
    const int g = lane >> 2;
    const int t = lane & 3;
    const TA* pa = a + g * PA + t;
    const TB* pb = b + g * PB + t;
    float cs[MT][kSmallSum ? NT : 1][4];
    zero(cs);
#pragma unroll
    for (int k = 0; k < DP; k += 8) {
      Frag<4, !kIsBf16<TA>> fa[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const TA* r = pa + 16 * m * PA + k;
        fa[m].set(0, to_f32(r[0]));
        fa[m].set(1, to_f32(r[8 * PA]));
        fa[m].set(2, to_f32(r[4]));
        fa[m].set(3, to_f32(r[8 * PA + 4]));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        Frag<2, !kIsBf16<TB>> fb;
        fb.set(0, to_f32(pb[8 * n * PB + k]));
        fb.set(1, to_f32(pb[8 * n * PB + k + 4]));
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma3(c[m][n], kSmallSum ? cs[m][n] : c[m][n], fa[m], fb);
      }
    }
    if constexpr (kSmallSum) {
#pragma unroll
      for (int m = 0; m < MT; ++m) add_to(c[m], cs[m]);
    }
  }
}

template <bool kBf16, int NT, int DP, bool kSmallSum = false, typename TA,
          typename TB>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4],
                                        const TA* __restrict__ a,
                                        const TB* __restrict__ b) {
  gemm_nt<kBf16, 1, NT, DP, kSmallSum>(
      reinterpret_cast<float(&)[1][NT][4]>(c), a, b);
}

// C[16·MT × 8·NO] += P · B[0, 8·NK)[col0, col0 + 8·NO): p is a C fragment
// of MT m-tiles × NK n-tiles (float32), b points at row 0 of the tile
// (pitch pitch<TB, DP>()). The 3xTF32 small terms get a sum of their own.
template <bool kBf16, int MT, int NK, int NO, int DP, typename TB>
__device__ __forceinline__ void gemm_pv(float (&c)[MT][NO][4],
                                        const float (&p)[MT][NK][4],
                                        const TB* __restrict__ b, int col0) {
  const int lane = threadIdx.x & 31;
  if constexpr (kBf16) {
    static_assert(kIsBf16<TB> && NK % 2 == 0 && NO % 2 == 0, "bf16 route");
    constexpr int P = pitch<bf16, DP>();
    const int mi = lane >> 3;
    const int ri = lane & 7;
    const bf16* pb = b + (ri + (mi & 1) * 8) * P + col0 + (mi >> 1) * 8;
#pragma unroll
    for (int j = 0; j < NK; j += 2) {
      uint32_t fa[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        fa[m][0] = pack_bf16(p[m][j][0], p[m][j][1]);
        fa[m][1] = pack_bf16(p[m][j][2], p[m][j][3]);
        fa[m][2] = pack_bf16(p[m][j + 1][0], p[m][j + 1][1]);
        fa[m][3] = pack_bf16(p[m][j + 1][2], p[m][j + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, pb + 8 * j * P + 8 * n);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(c[m][n], fa[m], fb);
          mma_bf16(c[m][n + 1], fa[m], fb + 2);
        }
      }
    }
  } else {
    constexpr int PB = pitch<TB, DP>();
    const int g = lane >> 2;
    const int t = lane & 3;
    // A slot t <-> row 2t of the k-step, slot t+4 <-> row 2t+1
    const TB* pb = b + 2 * t * PB + col0 + g;
    float cs[MT][NO][4];
    zero(cs);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      Frag<4, true> fa[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        fa[m].set(0, p[m][j][0]);
        fa[m].set(1, p[m][j][2]);
        fa[m].set(2, p[m][j][1]);
        fa[m].set(3, p[m][j][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        Frag<2, !kIsBf16<TB>> fb;
        fb.set(0, to_f32(pb[8 * j * PB + 8 * n]));
        fb.set(1, to_f32(pb[(8 * j + 1) * PB + 8 * n]));
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(c[m][n], cs[m][n], fa[m], fb);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) add_to(c[m], cs[m]);
  }
}

template <bool kBf16, int NK, int NO, int DP, typename TB>
__device__ __forceinline__ void gemm_pv(float (&c)[NO][4],
                                        const float (&p)[NK][4],
                                        const TB* __restrict__ b, int col0) {
  gemm_pv<kBf16, 1, NK, NO, DP>(reinterpret_cast<float(&)[1][NO][4]>(c),
                                reinterpret_cast<const float(&)[1][NK][4]>(p),
                                b, col0);
}

// 2^x on the special-function unit (ex2.approx, relative error ~2^-22;
// results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The padded head width a kernel is instantiated for: the least of 32,
// 64, 96, 128, 160, 256 that holds d. f(std::integral_constant<int, DP>).
template <typename F>
inline void dispatch_dp(int d, F&& f) {
  if (d <= 32)
    f(std::integral_constant<int, 32>{});
  else if (d <= 64)
    f(std::integral_constant<int, 64>{});
  else if (d <= 96)
    f(std::integral_constant<int, 96>{});
  else if (d <= 128)
    f(std::integral_constant<int, 128>{});
  else if (d <= 160)
    f(std::integral_constant<int, 160>{});
  else
    f(std::integral_constant<int, 256>{});
}

}  // namespace flash
