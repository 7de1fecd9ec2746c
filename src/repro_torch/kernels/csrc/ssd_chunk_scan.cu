// Mamba2 SSD intra-chunk scan on Hopper: for each (batch·chunk m, head h)
//
//   y[i, p]     = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x[j, p]
//   state[p, n] = sum_q x[q, p] * exp(cum_last - cum_q) * dt_q * B[q, n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_scan (its oracle: repro/kernels/ref.py::ssd_chunk_ref). The
// inter-chunk recurrence stays outside, as in the JAX package.
//
// Grid: one CTA of 256 threads per (head h, row m) — H x M CTAs, 256 at the
// serving shapes (64 heads, 4 rows), two waves on the 132 SMs. C·Bᵀ does
// not depend on the head, so a CTA per head block could share it; per head
// it costs Q(Q+1)/2·N multiply-adds, the same as the head's y product at
// N = 2P, and at the serving chunk (Q = 16) both are small beside the
// state's Q·P·N. One CTA per head keeps the kernel simple and every CTA
// independent; sharing C·Bᵀ across a head block is the step to take once Q
// is large.
//
// Tiling, so that any Q in 1..256 fits shared memory (C and B alone are
// 128 KB each in float32 at Q = 256, N = 128):
//   * y: row tiles of kTi positions i; for each, column tiles of kTj
//     positions j up to the tile's last row (the upper triangle beyond it
//     is never visited). A column tile stages B (kTj x N) and x (kTj x P);
//     the CTA forms the kTi x kTj scores, then accumulates scores · x in
//     registers (kTi·P / 256 outputs a thread).
//   * state: tiles of kTj positions q stage B and x·w (w = exp(cum_last -
//     cum_q) * dt_q); each thread keeps P·N / 256 outputs in registers.
// exp(cum_i - cum_j) is evaluated only where i >= j: above the diagonal it
// can overflow to inf, and inf * 0 is NaN (the JAX code masks with a
// `where` after the exp; a product is not a mask).
//
// Bound: bytes at the serving shapes. The state output alone is
// H·P·N·4 = 2 MB per row m (8 MB at M = 4), against Q·(H·P + 2H + 2N)·4
// bytes of input and Q·H·P·4 of y, and about 2·Q·P·N + Q²·(N + P) flops
// per head — about 1 flop per byte at Q = 16.
//
// Layouts, all float32 and contiguous: x (M, Q, H, P); dt, cum (M, Q, H);
// B, C (M, Q, N) (ngroups = 1); y (M, Q, H, P); state (M, H, P, N).
// Limits (checked by the wrapper): P <= 128, N <= 256, P·N <= 8192.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTi = 32;
constexpr int kTj = 32;
constexpr int kMaxP = 128;
constexpr int kYAcc = kTi * kMaxP / kThreads;  // 16
constexpr int kStateAcc = 32;                  // P·N <= 8192

// Shared memory in floats: C rows (kTi x (N+1)), B rows (kTj x (N+1)), x
// rows (kTj x P), scores (kTi x kTj), cum at the row tile, cum and dt at
// the column tile. B rows are padded to N+1 so that lanes reading one
// column of consecutive rows hit different banks.
inline size_t smem_floats(int P, int N) {
  return static_cast<size_t>(kTi + kTj) * (N + 1) +
         static_cast<size_t>(kTj) * P + kTi * kTj + kTi + 2 * kTj;
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ state, int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int ldn = N + 1;
  float* c_s = smem;
  float* b_s = c_s + kTi * ldn;
  float* x_s = b_s + kTj * ldn;
  float* s_s = x_s + kTj * P;
  float* ci_s = s_s + kTi * kTj;
  float* cj_s = ci_s + kTi;
  float* dj_s = cj_s + kTj;

  const size_t row_x = static_cast<size_t>(m) * Q * H * P;
  const float* xm = x + row_x + static_cast<size_t>(h) * P;  // + q*H*P + p
  const float* dtm = dt + static_cast<size_t>(m) * Q * H + h;  // + q*H
  const float* cm = cum + static_cast<size_t>(m) * Q * H + h;  // + q*H
  const float* bm = Bm + static_cast<size_t>(m) * Q * N;
  const float* ccm = Cm + static_cast<size_t>(m) * Q * N;
  float* ym = y + row_x + static_cast<size_t>(h) * P;
  const size_t hp = static_cast<size_t>(H) * P;

  // ------------------------------------------------------------------ y
  for (int i0 = 0; i0 < Q; i0 += kTi) {
    const int ni = min(kTi, Q - i0);
    float acc[kYAcc];
#pragma unroll
    for (int k = 0; k < kYAcc; ++k) acc[k] = 0.f;
    __syncthreads();  // the previous row tile's C and scores are consumed
    for (int idx = tid; idx < kTi * N; idx += kThreads) {
      const int i = idx / N;
      const int n = idx - i * N;
      c_s[i * ldn + n] = i < ni ? ccm[static_cast<size_t>(i0 + i) * N + n]
                                : 0.f;
    }
    if (tid < kTi) ci_s[tid] = tid < ni ? cm[(i0 + tid) * H] : 0.f;

    for (int j0 = 0; j0 < i0 + ni; j0 += kTj) {
      const int nj = min(kTj, Q - j0);
      __syncthreads();  // the previous column tile is consumed
      for (int idx = tid; idx < kTj * N; idx += kThreads) {
        const int j = idx / N;
        const int n = idx - j * N;
        b_s[j * ldn + n] = j < nj ? bm[static_cast<size_t>(j0 + j) * N + n]
                                  : 0.f;
      }
      for (int idx = tid; idx < kTj * P; idx += kThreads) {
        const int j = idx / P;
        const int p = idx - j * P;
        x_s[idx] = j < nj ? xm[(j0 + j) * hp + p] : 0.f;
      }
      if (tid < kTj) {
        cj_s[tid] = tid < nj ? cm[(j0 + tid) * H] : 0.f;
        dj_s[tid] = tid < nj ? dtm[(j0 + tid) * H] : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < kTi * kTj; idx += kThreads) {
        const int i = idx / kTj;
        const int j = idx - i * kTj;
        float sc = 0.f;
        if (i < ni && j < nj && j0 + j <= i0 + i) {
          const float* cr = c_s + i * ldn;
          const float* br = b_s + j * ldn;
          float cb = 0.f;
          for (int n = 0; n < N; ++n) cb = fmaf(cr[n], br[n], cb);
          sc = cb * expf(ci_s[i] - cj_s[j]) * dj_s[j];
        }
        s_s[idx] = sc;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kYAcc; ++k) {
        const int idx = tid + k * kThreads;
        if (idx < kTi * P) {
          const int i = idx / P;
          const int p = idx - i * P;
          const float* sr = s_s + i * kTj;
          float a = acc[k];
          for (int j = 0; j < kTj; ++j) a = fmaf(sr[j], x_s[j * P + p], a);
          acc[k] = a;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kYAcc; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < kTi * P) {
        const int i = idx / P;
        const int p = idx - i * P;
        if (i < ni) ym[(i0 + i) * hp + p] = acc[k];
      }
    }
  }

  // -------------------------------------------------------------- state
  const float cum_last = cm[(Q - 1) * H];
  float sacc[kStateAcc];
#pragma unroll
  for (int k = 0; k < kStateAcc; ++k) sacc[k] = 0.f;
  for (int q0 = 0; q0 < Q; q0 += kTj) {
    const int nq = min(kTj, Q - q0);
    __syncthreads();  // the previous tile (or the y phase) is consumed
    if (tid < kTj)
      dj_s[tid] = tid < nq ? expf(cum_last - cm[(q0 + tid) * H]) *
                                 dtm[(q0 + tid) * H]
                           : 0.f;
    for (int idx = tid; idx < kTj * N; idx += kThreads) {
      const int j = idx / N;
      const int n = idx - j * N;
      b_s[j * ldn + n] = j < nq ? bm[static_cast<size_t>(q0 + j) * N + n]
                                : 0.f;
    }
    __syncthreads();  // the weights are in dj_s
    for (int idx = tid; idx < kTj * P; idx += kThreads) {
      const int j = idx / P;
      const int p = idx - j * P;
      x_s[idx] = j < nq ? xm[(q0 + j) * hp + p] * dj_s[j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStateAcc; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < P * N) {
        const int p = idx / N;
        const int n = idx - p * N;
        float a = sacc[k];
        for (int j = 0; j < kTj; ++j)
          a = fmaf(x_s[j * P + p], b_s[j * ldn + n], a);
        sacc[k] = a;
      }
    }
  }
  float* st = state + (static_cast<size_t>(m) * H + h) * P * N;
#pragma unroll
  for (int k = 0; k < kStateAcc; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < P * N) st[idx] = sacc[k];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ssd_chunk_scan(const void* x, const void* dt, const void* cum,
                              const void* b, const void* c, void* y,
                              void* state, int M, int Q, int H, int P, int N,
                              void* stream) {
  const size_t smem = smem_floats(P, N) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ssd_chunk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  ssd_chunk_kernel<<<dim3(H, M), dim3(kThreads), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(state), Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
