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
// Bound. Bytes at every bucket: forward 8 bytes a cell (D in, R out) plus 4 a
// pair, backward 12 (D, R in, dD out) plus 4. At 3.35 TB/s that is 2.4 ps
// (forward) / 3.6 ps (backward) a cell, against 4 (forward: 3 exp, 1 log) or
// 3 (backward: 3 exp) special functions a cell at 16 a clock an SM, 1.0 /
// 0.7 ps. Full-precision expf / logf are several instructions each besides
// their one special-function op, so issue comes close to the bytes at 16x16
// and only coalesced, register-resident work lets the bytes bind. Measured
// on an H100 with the data out of L2 (PERF.md): at 2x2 the 2x2 route takes
// 1.35-1.8x less time than the rows route would, and is near the launch
// floor at the models' 131,080 pairs; at 16x16 what is left to the bound is
// the rows route's I/O (a staged row is 64 bytes, 1 KB from the next
// pair's): the kernels with the recurrence taken out take as long as with
// it, without the copies 2/3 (forward) and 2/5 (backward) as long.
//
// Design. The work is 1e5 to 1e6 tiny independent recurrences (N, M <= 16):
// one THREAD a pair, walking its cells row by row (reverse in the backward),
// which respects the recurrence's dependencies without a wavefront.
//
// - Registers. Each kernel is a template on a column bucket kM in {2, 4, 8,
//   16}, which the caller chooses (ops/soft_dtw.py:_column_bucket: the
//   smallest that holds M) and the entry points run, refusing one that does
//   not hold M. Every loop over a row's columns
//   is unrolled to kM with j < M guards, so the row of R (forward) and the
//   rows of E, R and D (backward) are registers: no local memory.
// - Coalesced I/O, two routes:
//   * 2x2 (the models' shape, 16-byte aligned tensors): a pair is one
//     16-byte vector; a thread loads D (and R) with one float4 each and
//     stores R (or dD) with one float4, so a warp moves 512 contiguous bytes
//     an instruction.
//   * rows (every other shape): a warp owns 32 pairs and stages their row i
//     (backward: D and R) through shared memory with cp.async, 16-byte
//     copies where M % 4 == 0 and the pointers allow (at 16 columns with a
//     128-byte L2 prefetch, which brings the pair's next row too), 8- or
//     4-byte copies at a ragged M. Two buffers a warp: row i+1 (i-1
//     backward) is in flight while row i is computed. A thread reads its
//     pair's staged row as 16-byte vectors; the per-pair stride (2, 4, 12
//     or 20 floats) keeps each quarter-warp's vector reads on distinct
//     banks. The thread writes its row of R (dD) over the staged D in
//     place, and the warp copies the row out with the same wide,
//     neighbouring stores. Warps never wait for each other: only
//     __syncwarp, no block barrier.
// - Arithmetic in full precision as the plain version does it (no
//   fast-math: expf, logf, IEEE adds), except that the forward multiplies by
//   1/gamma, computed once, where the plain version divides by gamma three
//   times a cell (each quotient moves by at most an ulp).
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kMaxLen = 16;          // largest N or M; the wrapper refuses more
constexpr int kWarps = 4;            // warps a block, rows route
constexpr int kDirectThreads = 256;  // threads a block, 2x2 route

// floats between two pairs' staged rows in shared memory: a multiple of the
// read width, and 3 or 5 16-byte units at 8 / 16 columns so that the 8
// threads of a quarter-warp read 8 distinct bank groups
template <int kM>
constexpr int kStageStride = kM == 2 ? 2 : kM == 4 ? 4 : kM + 4;

// -gamma * log(sum_k exp(-x_k / gamma)) over three values; any of them may be
// +inf, and all three +inf give +inf (never NaN)
__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float gamma, float inv_gamma) {
  const float r0 = -a * inv_gamma, r1 = -b * inv_gamma, r2 = -c * inv_gamma;
  const float rmax = fmaxf(fmaxf(r0, r1), r2);
  if (rmax == -kInf) return kInf;
  // expf(-inf) is 0, and rmax is finite here, so no inf - inf arises
  const float ex = expf(r0 - rmax) + expf(r1 - rmax) + expf(r2 - rmax);
  return -gamma * (logf(ex) + rmax);
}

// cells i, j 0-indexed: the band compares i - j whatever the origin
__device__ __forceinline__ bool in_band(int i, int j, float bandwidth) {
  return !(bandwidth > 0.0f) || fabsf((float)(i - j)) <= bandwidth;
}

// Forward row i (0-indexed) of one pair. row[j] holds R[i-1][j] on entry
// (+inf for i == 0) and R[i][j] on exit; columns j >= M are left alone.
// Returns R[i][M-1].
template <int kM>
__device__ __forceinline__ float fwd_row(float (&row)[kM], const float (&d)[kM],
                                        int i, int M, float gamma,
                                        float inv_gamma, float bandwidth) {
  float diag = i == 0 ? 0.0f : kInf;  // R[i-1][-1]: only the origin is 0
  float left = kInf;                  // R[i][-1]
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    if (j < M) {
      const float up = row[j];
      float r = kInf;
      if (in_band(i, j, bandwidth))
        r = softmin3(diag, up, left, gamma, inv_gamma) + d[j];
      diag = up;
      left = r;
      row[j] = r;
    }
  }
  return left;
}

// Backward row i of one pair, in the backward's view of R (+inf is -inf).
// e[j] holds E[i+1][j] on entry and E[i][j] on exit; rn, dn are R and D of
// row i+1 (-inf and 0 for the row past the last), rc, dc those of row i.
// Column M (past the last) is E 0, R -inf, D 0, except in the row past the
// last, where it is the corner: E 1 and R[N-1][M-1] (e_corner, r_corner).
template <int kM>
__device__ __forceinline__ void bwd_row(float (&e)[kM], const float (&rn)[kM],
                                        const float (&dn)[kM],
                                        const float (&rc)[kM],
                                        const float (&dc)[kM], float e_corner,
                                        float r_corner, int i, int M,
                                        float inv_gamma, float bandwidth) {
  float right_e = 0.0f, right_r = -kInf, right_d = 0.0f;  // [i][j+1]
  float diag_e = e_corner, diag_r = r_corner, diag_d = 0.0f;  // [i+1][j+1]
#pragma unroll
  for (int j = kM - 1; j >= 0; --j) {
    if (j < M) {
      const float down_e = e[j], down_r = rn[j], down_d = dn[j];
      float v = 0.0f;
      // an out-of-band cell is skipped, not masked afterwards: its R is
      // -inf here and -inf - (-inf) would be NaN
      if (in_band(i, j, bandwidth)) {
        const float rij = rc[j];
        const float a = expf((down_r - rij - down_d) * inv_gamma);
        const float b = expf((right_r - rij - right_d) * inv_gamma);
        const float c = expf((diag_r - rij - diag_d) * inv_gamma);
        v = down_e * a + right_e * b + diag_e * c;
      }
      e[j] = v;
      diag_e = down_e;
      diag_r = down_r;
      diag_d = down_d;
      right_e = v;
      right_r = rc[j];
      right_d = dc[j];
    }
  }
}

__device__ __forceinline__ float backward_view(float r) {
  return isinf(r) ? -kInf : r;
}

// ---------------------------------------------------------------- 2x2 route

__global__ void __launch_bounds__(kDirectThreads)
soft_dtw_fwd_2x2(const float4* __restrict__ D, float4* __restrict__ R,
                 float* __restrict__ value, int P, float gamma,
                 float bandwidth) {
  const int p = blockIdx.x * kDirectThreads + threadIdx.x;
  if (p >= P) return;
  const float inv_gamma = 1.0f / gamma;
  const float4 d = D[p];
  float row[2] = {kInf, kInf};
  const float d0[2] = {d.x, d.y}, d1[2] = {d.z, d.w};
  float4 out;
  fwd_row<2>(row, d0, 0, 2, gamma, inv_gamma, bandwidth);
  out.x = row[0];
  out.y = row[1];
  fwd_row<2>(row, d1, 1, 2, gamma, inv_gamma, bandwidth);
  out.z = row[0];
  out.w = row[1];
  R[p] = out;
  value[p] = row[1];
}

__global__ void __launch_bounds__(kDirectThreads)
soft_dtw_bwd_2x2(const float4* __restrict__ D, const float4* __restrict__ R,
                 const float* __restrict__ g, float4* __restrict__ dD, int P,
                 float gamma, float bandwidth) {
  const int p = blockIdx.x * kDirectThreads + threadIdx.x;
  if (p >= P) return;
  const float inv_gamma = 1.0f / gamma;
  const float4 d = D[p], r = R[p];
  const float grad = g[p];
  const float r1[2] = {backward_view(r.z), backward_view(r.w)};
  const float r0[2] = {backward_view(r.x), backward_view(r.y)};
  const float d1[2] = {d.z, d.w}, d0[2] = {d.x, d.y};
  const float none_r[2] = {-kInf, -kInf}, none_d[2] = {0.0f, 0.0f};
  float e[2] = {0.0f, 0.0f};
  float4 out;
  bwd_row<2>(e, none_r, none_d, r1, d1, 1.0f, r1[1], 1, 2, inv_gamma,
             bandwidth);
  out.z = e[0] * grad;
  out.w = e[1] * grad;
  bwd_row<2>(e, r1, d1, r0, d0, 0.0f, -kInf, 0, 2, inv_gamma, bandwidth);
  out.x = e[0] * grad;
  out.y = e[1] * grad;
  dD[p] = out;
}

// --------------------------------------------------------------- rows route

// kLine: a 16-byte copy also asks L2 for the rest of its 128-byte line. At
// 16 columns that line is two rows of a pair, so every other row's copy hits
// L2 instead of DRAM (measured: 8 % off the forward, 16 % off the backward
// at (524320,16,16); at 8 columns, or with 256-byte lines, it was slower)
template <bool kLine>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         int width) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (width == 4 && kLine)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::
                     "r"(s), "l"(gmem));
  else if (width == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else if (width == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Row `row` of the warp's np pairs, M floats each at src + (pair*N + row)*M,
// into shared memory at stage + pair*stride: neighbouring lanes take
// neighbouring `width`-float pieces of a pair's row
template <bool kLine>
__device__ __forceinline__ void stage_row(float* stage, int stride,
                                          const float* src, int np, int N,
                                          int M, int row, int width,
                                          int lane) {
  const int pieces = M / width;
  for (int c = lane; c < np * pieces; c += 32) {
    const int pair = c / pieces, k = (c - pair * pieces) * width;
    cp_async<kLine>(stage + pair * stride + k,
                    src + ((size_t)pair * N + row) * M + k, width);
  }
}

// the staged row back out, the same pieces the other way
__device__ __forceinline__ void unstage_row(float* dst, const float* stage,
                                            int stride, int np, int N, int M,
                                            int row, int width, int lane) {
  const int pieces = M / width;
  for (int c = lane; c < np * pieces; c += 32) {
    const int pair = c / pieces, k = (c - pair * pieces) * width;
    const float* s = stage + pair * stride + k;
    float* g = dst + ((size_t)pair * N + row) * M + k;
    if (width == 4)
      *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(s);
    else if (width == 2)
      *reinterpret_cast<float2*>(g) = *reinterpret_cast<const float2*>(s);
    else
      *g = *s;
  }
}

// a thread's staged row to registers and back, in 16-byte (8 at kM = 2)
// vectors
template <int kM>
__device__ __forceinline__ void load_row(float (&v)[kM], const float* s) {
  if constexpr (kM == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int k = 0; k < kM; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + k);
      v[k] = x.x;
      v[k + 1] = x.y;
      v[k + 2] = x.z;
      v[k + 3] = x.w;
    }
  }
}

template <int kM>
__device__ __forceinline__ void store_row(float* s, const float (&v)[kM],
                                          float scale) {
  if constexpr (kM == 2) {
    *reinterpret_cast<float2*>(s) = make_float2(v[0] * scale, v[1] * scale);
  } else {
#pragma unroll
    for (int k = 0; k < kM; k += 4)
      *reinterpret_cast<float4*>(s + k) =
          make_float4(v[k] * scale, v[k + 1] * scale, v[k + 2] * scale,
                      v[k + 3] * scale);
  }
}

template <int kM>
__global__ void __launch_bounds__(kWarps * 32)
soft_dtw_fwd_rows(const float* __restrict__ D, float* __restrict__ R,
                  float* __restrict__ value, int P, int N, int M, float gamma,
                  float bandwidth, int width) {
  constexpr int S = kStageStride<kM>;
  constexpr bool kLine = kM == 16;  // see cp_async
  __shared__ __align__(16) float stage[kWarps][2][32 * S];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = (blockIdx.x * kWarps + warp) * 32;
  if (p0 >= P) return;  // the whole warp
  const int np = min(32, P - p0);
  const bool active = lane < np;
  const size_t pair_floats = (size_t)N * M;
  const float* d_src = D + p0 * pair_floats;
  float* r_dst = R + p0 * pair_floats;
  const float inv_gamma = 1.0f / gamma;

  stage_row<kLine>(stage[warp][0], S, d_src, np, N, M, 0, width, lane);
  cp_async_commit();
  if (N > 1)
    stage_row<kLine>(stage[warp][1], S, d_src, np, N, M, 1, width, lane);
  cp_async_commit();

  float row[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) row[j] = kInf;
  float last = kInf;  // R[i][M-1]
  for (int i = 0; i < N; ++i) {
    float* buf = stage[warp][i & 1];
    cp_async_wait_all_but_one();
    __syncwarp();
    if (active) {
      float* mine = buf + lane * S;
      float d[kM];
      load_row<kM>(d, mine);
      last = fwd_row<kM>(row, d, i, M, gamma, inv_gamma, bandwidth);
      store_row<kM>(mine, row, 1.0f);  // R over the staged D
    }
    __syncwarp();
    unstage_row(r_dst, buf, S, np, N, M, i, width, lane);
    __syncwarp();  // every lane has read the buffer before it is refilled
    if (i + 2 < N)
      stage_row<kLine>(buf, S, d_src, np, N, M, i + 2, width, lane);
    cp_async_commit();  // an empty group keeps the count of groups uniform
  }
  if (active) value[p0 + lane] = last;
}

template <int kM>
__global__ void __launch_bounds__(kWarps * 32)
soft_dtw_bwd_rows(const float* __restrict__ D, const float* __restrict__ R,
                  const float* __restrict__ g, float* __restrict__ dD, int P,
                  int N, int M, float gamma, float bandwidth, int width) {
  constexpr int S = kStageStride<kM>;
  constexpr bool kLine = kM == 16;  // see cp_async
  __shared__ __align__(16) float stage_d[kWarps][2][32 * S];
  __shared__ __align__(16) float stage_r[kWarps][2][32 * S];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = (blockIdx.x * kWarps + warp) * 32;
  if (p0 >= P) return;  // the whole warp
  const int np = min(32, P - p0);
  const bool active = lane < np;
  const size_t pair_floats = (size_t)N * M;
  const float* d_src = D + p0 * pair_floats;
  const float* r_src = R + p0 * pair_floats;
  float* out = dD + p0 * pair_floats;
  const float inv_gamma = 1.0f / gamma;
  const float grad = active ? g[p0 + lane] : 0.0f;

  // step t handles row N-1-t from buffer t & 1
  stage_row<kLine>(stage_d[warp][0], S, d_src, np, N, M, N - 1, width, lane);
  stage_row<kLine>(stage_r[warp][0], S, r_src, np, N, M, N - 1, width, lane);
  cp_async_commit();
  if (N > 1) {
    stage_row<kLine>(stage_d[warp][1], S, d_src, np, N, M, N - 2, width, lane);
    stage_row<kLine>(stage_r[warp][1], S, r_src, np, N, M, N - 2, width, lane);
  }
  cp_async_commit();

  // E, R, D of row i+1: first the row past the last
  float e[kM], rn[kM], dn[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    e[j] = 0.0f;
    rn[j] = -kInf;
    dn[j] = 0.0f;
  }
  float e_corner = 1.0f, r_corner = -kInf;
  for (int t = 0; t < N; ++t) {
    const int i = N - 1 - t;
    float* dbuf = stage_d[warp][t & 1];
    float* rbuf = stage_r[warp][t & 1];
    cp_async_wait_all_but_one();
    __syncwarp();
    if (active) {
      float dc[kM], rc[kM];
      load_row<kM>(dc, dbuf + lane * S);
      load_row<kM>(rc, rbuf + lane * S);
#pragma unroll
      for (int j = 0; j < kM; ++j) rc[j] = backward_view(rc[j]);
      // R[N-1][M-1], read at a runtime column from shared memory: indexing
      // the register row by M would move it to local memory
      if (t == 0) r_corner = backward_view(rbuf[lane * S + M - 1]);
      bwd_row<kM>(e, rn, dn, rc, dc, e_corner, r_corner, i, M, inv_gamma,
                  bandwidth);
      store_row<kM>(dbuf + lane * S, e, grad);  // dD over the staged D
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        rn[j] = rc[j];
        dn[j] = dc[j];
      }
      e_corner = 0.0f;
      r_corner = -kInf;
    }
    __syncwarp();
    unstage_row(out, dbuf, S, np, N, M, i, width, lane);
    __syncwarp();  // every lane has read the buffer before it is refilled
    if (i >= 2) {
      stage_row<kLine>(dbuf, S, d_src, np, N, M, i - 2, width, lane);
      stage_row<kLine>(rbuf, S, r_src, np, N, M, i - 2, width, lane);
    }
    cp_async_commit();
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// floats a cp.async piece can carry for rows of M floats at these pointers
inline int copy_width(int M, const void* a, const void* b, const void* c) {
  if (M % 4 == 0 && aligned(a, 16) && aligned(b, 16) && aligned(c, 16))
    return 4;
  if (M % 2 == 0 && aligned(a, 8) && aligned(b, 8) && aligned(c, 8)) return 2;
  return 1;
}

inline int rows_blocks(int P) {
  return (P + kWarps * 32 - 1) / (kWarps * 32);
}

// a bucket is one of the instantiations and holds the row's M columns
inline bool bad_shape(int N, int M, int bucket) {
  return N < 1 || M < 1 || N > kMaxLen || M > bucket ||
         (bucket != 2 && bucket != 4 && bucket != 8 && bucket != 16);
}

}  // namespace

// D (P,N,M) f32 -> R (P,N,M) f32 interior cells, value (P,) f32 = R[N,M].
// Contiguous device pointers, 1 <= N, M <= 16; `bucket` (2, 4, 8 or 16, at
// least M; any other is refused) picks the instantiation of the rows route.
// Returns cudaGetLastError() of the launch (0 = success).
extern "C" int soft_dtw_fwd_launch(const void* D, void* R, void* value, int P,
                                   int N, int M, float gamma, float bandwidth,
                                   int bucket, void* stream) {
  if (P <= 0) return 0;
  if (bad_shape(N, M, bucket)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)D;
  float* r = (float*)R;
  float* v = (float*)value;
  if (N == 2 && M == 2 && aligned(D, 16) && aligned(R, 16)) {
    soft_dtw_fwd_2x2<<<(P + kDirectThreads - 1) / kDirectThreads,
                       kDirectThreads, 0, s>>>((const float4*)D, (float4*)R,
                                               v, P, gamma, bandwidth);
    return (int)cudaGetLastError();
  }
  const int width = copy_width(M, D, R, R);
  const int blocks = rows_blocks(P), threads = kWarps * 32;
  switch (bucket) {
    case 2:
      soft_dtw_fwd_rows<2><<<blocks, threads, 0, s>>>(d, r, v, P, N, M, gamma,
                                                      bandwidth, width);
      break;
    case 4:
      soft_dtw_fwd_rows<4><<<blocks, threads, 0, s>>>(d, r, v, P, N, M, gamma,
                                                      bandwidth, width);
      break;
    case 8:
      soft_dtw_fwd_rows<8><<<blocks, threads, 0, s>>>(d, r, v, P, N, M, gamma,
                                                      bandwidth, width);
      break;
    default:  // 16
      soft_dtw_fwd_rows<16><<<blocks, threads, 0, s>>>(d, r, v, P, N, M,
                                                       gamma, bandwidth, width);
  }
  return (int)cudaGetLastError();
}

// D, R (P,N,M) f32 as above, g (P,) f32 -> dD (P,N,M) f32 = E * g.
extern "C" int soft_dtw_bwd_launch(const void* D, const void* R, const void* g,
                                   void* dD, int P, int N, int M, float gamma,
                                   float bandwidth, int bucket, void* stream) {
  if (P <= 0) return 0;
  if (bad_shape(N, M, bucket)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)D;
  const float* r = (const float*)R;
  const float* gp = (const float*)g;
  float* out = (float*)dD;
  if (N == 2 && M == 2 && aligned(D, 16) && aligned(R, 16) &&
      aligned(dD, 16)) {
    soft_dtw_bwd_2x2<<<(P + kDirectThreads - 1) / kDirectThreads,
                       kDirectThreads, 0, s>>>(
        (const float4*)D, (const float4*)R, gp, (float4*)dD, P, gamma,
        bandwidth);
    return (int)cudaGetLastError();
  }
  const int width = copy_width(M, D, R, dD);
  const int blocks = rows_blocks(P), threads = kWarps * 32;
  switch (bucket) {
    case 2:
      soft_dtw_bwd_rows<2><<<blocks, threads, 0, s>>>(d, r, gp, out, P, N, M,
                                                      gamma, bandwidth, width);
      break;
    case 4:
      soft_dtw_bwd_rows<4><<<blocks, threads, 0, s>>>(d, r, gp, out, P, N, M,
                                                      gamma, bandwidth, width);
      break;
    case 8:
      soft_dtw_bwd_rows<8><<<blocks, threads, 0, s>>>(d, r, gp, out, P, N, M,
                                                      gamma, bandwidth, width);
      break;
    default:  // 16
      soft_dtw_bwd_rows<16><<<blocks, threads, 0, s>>>(
          d, r, gp, out, P, N, M, gamma, bandwidth, width);
  }
  return (int)cudaGetLastError();
}
