// Soft-DTW forward (R matrix) and backward (E matrix) for Hopper (sm_90a).
//
// Replace the Pallas kernels dualvar_tpu/ops/soft_dtw.py:_fwd_kernel and
// :_bwd_kernel and compute the same functions. For P independent pairs with a
// cost matrix D (N, M) each:
//
//   forward   R[i,j] = D[i-1,j-1] + softmin_gamma(R[i-1,j-1], R[i-1,j],
//             R[i,j-1]) for 1 <= i <= N, 1 <= j <= M, with R[0,0] = 0 and the
//             rest of row 0 and column 0 +inf; the value is R[N,M];
//   backward  E[i,j] = E[i+1,j] a + E[i,j+1] b + E[i+1,j+1] c over the cells
//             in reverse order, a = exp((R[i+1,j] - R[i,j] - D[i+1,j]) /
//             gamma) and likewise b, c; dD = E * g with g the incoming
//             gradient of the pair's value.
//
// With a Sakoe-Chiba band (bandwidth > 0) the cells with |i - j| > bandwidth
// keep +inf in R and 0 in E.
//
// Layout, shared by both kernels: D, R and dD are (P, N, M) float32, row
// major, contiguous; R holds the INTERIOR cells only (R[p, i-1, j-1] is the
// recurrence's R[i,j]); its border is constant and is never stored.
//
// Bound: bytes at the sizes the models use (N = M = 2: 16 bytes read and 20
// written a pair forward against 3 exp + 1 log a cell); the exp/log count
// takes over only on a much slower special-function unit than the card has.
//
// Design. The work is 10^5 to 10^6 tiny independent recurrences (N, M <= 16),
// so the parallel axis is the pair: one THREAD per pair, no shared memory and
// no barriers. A thread walks its cells in row-major order (reverse row-major
// in the backward), which respects the recurrence's dependencies without a
// wavefront, and keeps one row of R (or E) in a small per-thread array. At
// N = M = 2 a thread's D is 16 contiguous bytes, so a warp reads 512
// contiguous bytes; at larger sizes a thread consumes its own 32-byte sectors
// over successive steps out of L1.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing. Built without fast-math: expf,
// logf and the division by gamma are full precision.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLen = 16;  // largest N or M; the wrapper refuses more

// -gamma * log(sum_k exp(-x_k / gamma)) over three values; any of them may be
// +inf, and all three +inf give +inf (never NaN)
__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float gamma) {
  const float r0 = -a / gamma, r1 = -b / gamma, r2 = -c / gamma;
  const float rmax = fmaxf(fmaxf(r0, r1), r2);
  if (rmax == -CUDART_INF_F) return CUDART_INF_F;
  // expf(-inf) is 0, and rmax is finite here, so no inf - inf arises
  const float ex = expf(r0 - rmax) + expf(r1 - rmax) + expf(r2 - rmax);
  return -gamma * (logf(ex) + rmax);
}

__device__ __forceinline__ bool in_band(int i, int j, float bandwidth) {
  return !(bandwidth > 0.0f) || fabsf((float)(i - j)) <= bandwidth;
}

__global__ void __launch_bounds__(kThreads)
soft_dtw_fwd_kernel(const float* __restrict__ D, float* __restrict__ R,
                    float* __restrict__ value, int P, int N, int M,
                    float gamma, float bandwidth) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t base = (size_t)p * N * M;
  const float* d = D + base;
  float* r_out = R + base;

  // row[j] holds R[i-1, j] until cell (i, j+1) has read it, then R[i, j]
  float row[kMaxLen + 1];
  row[0] = 0.0f;
  for (int j = 1; j <= M; ++j) row[j] = CUDART_INF_F;

  float last = CUDART_INF_F;
  for (int i = 1; i <= N; ++i) {
    float diag = row[0];         // R[i-1, 0]
    float left = CUDART_INF_F;   // R[i, 0]
    for (int j = 1; j <= M; ++j) {
      const float up = row[j];   // R[i-1, j]
      float r = CUDART_INF_F;
      if (in_band(i, j, bandwidth))
        r = softmin3(diag, up, left, gamma) + d[(i - 1) * M + (j - 1)];
      row[j - 1] = left;
      diag = up;
      left = r;
      r_out[(i - 1) * M + (j - 1)] = r;
    }
    row[M] = left;
    last = left;
  }
  value[p] = last;
}

__global__ void __launch_bounds__(kThreads)
soft_dtw_bwd_kernel(const float* __restrict__ D, const float* __restrict__ R,
                    const float* __restrict__ g, float* __restrict__ dD,
                    int P, int N, int M, float gamma, float bandwidth) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t base = (size_t)p * N * M;
  const float* d = D + base;
  const float* r = R + base;
  float* out = dD + base;
  const float grad = g[p];
  const float inv_gamma = 1.0f / gamma;
  const float r_end = r[N * M - 1];  // R[N, M]

  // The backward's view of R: +inf becomes -inf, row N+1 and column M+1 are
  // -inf except the corner, which holds R[N, M]; D is 0 outside the interior.
  auto r_at = [&](int i, int j) -> float {
    if (i > N || j > M) {
      if (i > N && j > M) return isinf(r_end) ? -CUDART_INF_F : r_end;
      return -CUDART_INF_F;
    }
    const float v = r[(i - 1) * M + (j - 1)];
    return isinf(v) ? -CUDART_INF_F : v;
  };
  auto d_at = [&](int i, int j) -> float {
    return (i > N || j > M) ? 0.0f : d[(i - 1) * M + (j - 1)];
  };

  // below[j] holds E[i+1, j] until cell (i, j-1) has read it, then E[i, j]
  float below[kMaxLen + 2];
  for (int j = 1; j <= M; ++j) below[j] = 0.0f;
  below[M + 1] = 1.0f;  // E[N+1, M+1]

  for (int i = N; i >= 1; --i) {
    float diag = below[M + 1];  // E[i+1, M+1]
    float right = 0.0f;         // E[i, M+1]
    for (int j = M; j >= 1; --j) {
      const float down = below[j];  // E[i+1, j]
      float e = 0.0f;
      // an out-of-band cell is skipped, not masked afterwards: its R is
      // -inf here and -inf - (-inf) would be NaN
      if (in_band(i, j, bandwidth)) {
        const float rij = r_at(i, j);
        const float a =
            expf((r_at(i + 1, j) - rij - d_at(i + 1, j)) * inv_gamma);
        const float b =
            expf((r_at(i, j + 1) - rij - d_at(i, j + 1)) * inv_gamma);
        const float c =
            expf((r_at(i + 1, j + 1) - rij - d_at(i + 1, j + 1)) * inv_gamma);
        e = down * a + right * b + diag * c;
      }
      below[j + 1] = right;
      diag = down;
      right = e;
      out[(i - 1) * M + (j - 1)] = e * grad;
    }
    // below[M + 1] was overwritten at j == M with E[i, M+1] = 0: only the
    // corner of column M+1 is 1
    below[1] = right;
  }
}

inline int blocks_for(int P) { return (P + kThreads - 1) / kThreads; }

}  // namespace

// D (P,N,M) f32 -> R (P,N,M) f32 interior cells, value (P,) f32 = R[N,M].
// Contiguous device pointers, 1 <= N, M <= 16. Returns cudaGetLastError() of
// the launch (0 = success).
extern "C" int soft_dtw_fwd_launch(const void* D, void* R, void* value, int P,
                                   int N, int M, float gamma, float bandwidth,
                                   void* stream) {
  if (P <= 0) return 0;
  if (N < 1 || M < 1 || N > kMaxLen || M > kMaxLen)
    return (int)cudaErrorInvalidValue;
  soft_dtw_fwd_kernel<<<blocks_for(P), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)D, (float*)R, (float*)value, P, N, M, gamma, bandwidth);
  return (int)cudaGetLastError();
}

// D, R (P,N,M) f32 as above, g (P,) f32 -> dD (P,N,M) f32 = E * g.
extern "C" int soft_dtw_bwd_launch(const void* D, const void* R, const void* g,
                                   void* dD, int P, int N, int M, float gamma,
                                   float bandwidth, void* stream) {
  if (P <= 0) return 0;
  if (N < 1 || M < 1 || N > kMaxLen || M > kMaxLen)
    return (int)cudaErrorInvalidValue;
  soft_dtw_bwd_kernel<<<blocks_for(P), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)D, (const float*)R, (const float*)g, (float*)dD, P, N, M,
      gamma, bandwidth);
  return (int)cudaGetLastError();
}
