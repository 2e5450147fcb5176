// Per-channel float32 sums (sum a, sum a*b) for Hopper (sm_90a).
//
// Replaces the Pallas kernel dualvar_tpu/ops/bn_stats.py:_sums_kernel
// (reached through _channel_sums_2d and channel_sums) and computes the same
// function: for two tensors of one shape, viewed as (outer, C, inner),
//
//   s1[c] = sum over (o, i) of a[o, c, i]
//   s2[c] = sum over (o, i) of a[o, c, i] * b[o, c, i]
//
// in float32, from float32 or bfloat16 inputs. The batch norm's forward
// statistics are (sum x, sum x*x) (a = b = x: x is read once); its backward
// sums are (sum g, sum g*x). One design covers both memory layouts of a
// (N, C, T, H, W) map: NCDHW is (N, C, T*H*W) and channels_last_3d is
// (N*T*H*W, C, 1).
//
// Bound: bytes. Every input element is read once and is used by one or two
// float operations; the outputs are 8*C bytes.
//
// Design. The TPU kernel carries its sums across a sequential grid in VMEM
// scratch; blocks of this card run in no order, so each block writes its own
// partial sums and a second kernel adds the partials of a channel in a fixed
// order. No atomics: the result is the same from run to run.
//
//   - planar (inner > 1): a block owns one channel and a range of rows and
//     of the inner axis; its threads stride over the contiguous inner run of
//     every row with 16-byte loads where the run is aligned;
//   - channel-contiguous (inner == 1): a block owns a range of rows and up to
//     256 vector columns of channels; each thread keeps VEC channels' sums in
//     registers over its rows, and the block adds them by channel in shared
//     memory;
//   - finish: one block a channel adds that channel's partials, strided and
//     then by a tree, both in a fixed order.
//
// The wrapper (ops/bn_stats.py) picks the grid so that about a thousand
// blocks fill the 132 SMs at every map size of the R3D step, layer 4
// included. Plain C interface (loaded with ctypes); launches on the caller's
// stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC consecutive elements as floats, from one 16-byte load when VEC * size
// is 16, else element by element
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f(p[k]);
  }
}

// sum of v over the block, in a fixed order; every thread gets the result
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) total += scratch[w];
  return total;
}

// planar layout: grid (osplit * isplit, C). Block (x, c) adds rows
// [os * rows_per_block, ...) and inner vectors [is * ichunk, ...) of channel
// c. partial is (2, C, nsplit), nsplit = osplit * isplit.
template <typename T, int VEC, bool SAME>
__global__ void __launch_bounds__(kThreads)
sums_planar_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ partial, int64_t outer, int C,
                   int64_t inner, int rows_per_block, int64_t ichunk,
                   int isplit) {
  __shared__ float scratch[kThreads / 32];
  const int c = blockIdx.y;
  const int os = blockIdx.x / isplit, is = blockIdx.x % isplit;
  const int64_t o0 = (int64_t)os * rows_per_block;
  const int64_t o1 = min(outer, o0 + rows_per_block);
  const int64_t nvec = inner / VEC;
  const int64_t v0 = (int64_t)is * ichunk;
  const int64_t v1 = min(nvec, v0 + ichunk);
  float s1 = 0.0f, s2 = 0.0f;
  for (int64_t o = o0; o < o1; ++o) {
    const int64_t base = (o * C + c) * inner;
    for (int64_t v = v0 + threadIdx.x; v < v1; v += kThreads) {
      float av[VEC], bv[VEC];
      load_vec<T, VEC>(a + base + v * VEC, av);
      if constexpr (!SAME) load_vec<T, VEC>(b + base + v * VEC, bv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1 += av[k];
        s2 = fmaf(av[k], SAME ? av[k] : bv[k], s2);
      }
    }
  }
  const int nsplit = gridDim.x;
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    partial[(int64_t)c * nsplit + blockIdx.x] = s1;
    partial[((int64_t)C + c) * nsplit + blockIdx.x] = s2;
  }
}

// channel-contiguous layout (rows of C): grid (nsplit, column groups).
// Thread t of the block handles vector column cg * 256 + t % cols_blk and
// rows r0 + t / cols_blk, stepping by rows_per_iter = 256 / cols_blk.
template <typename T, int VEC, bool SAME>
__global__ void __launch_bounds__(kThreads)
sums_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ partial, int64_t rows, int C,
                 int64_t rows_per_block) {
  __shared__ float red[2][kThreads * VEC];
  const int cols = C / VEC;
  const int col0 = blockIdx.y * kThreads;
  const int cols_blk = min(kThreads, cols - col0);
  const int rows_per_iter = kThreads / cols_blk;
  const int t = threadIdx.x;
  const int col = t % cols_blk, rsub = t / cols_blk;
  const bool active = rsub < rows_per_iter;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.0f;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(rows, r0 + rows_per_block);
  if (active) {
    for (int64_t r = r0 + rsub; r < r1; r += rows_per_iter) {
      const int64_t off = r * C + (int64_t)(col0 + col) * VEC;
      float av[VEC], bv[VEC];
      load_vec<T, VEC>(a + off, av);
      if constexpr (!SAME) load_vec<T, VEC>(b + off, bv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += av[k];
        s2[k] = fmaf(av[k], SAME ? av[k] : bv[k], s2[k]);
      }
    }
  }
  // red[.][rsub * cols_blk * VEC + col * VEC + k]: the block's rows of sums
  if (active) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[0][(rsub * cols_blk + col) * VEC + k] = s1[k];
      red[1][(rsub * cols_blk + col) * VEC + k] = s2[k];
    }
  }
  __syncthreads();
  // one thread a channel of the block's columns adds its rows in order
  const int nsplit = gridDim.x;
  for (int j = t; j < cols_blk * VEC; j += kThreads) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int s = 0; s < rows_per_iter; ++s) {
      t1 += red[0][s * cols_blk * VEC + j];
      t2 += red[1][s * cols_blk * VEC + j];
    }
    const int64_t c = (int64_t)col0 * VEC + j;
    partial[c * nsplit + blockIdx.x] = t1;
    partial[((int64_t)C + c) * nsplit + blockIdx.x] = t2;
  }
}

// grid (C, 2): block (c, k) adds partial[k, c, :] into out_k[c]
__global__ void __launch_bounds__(kThreads)
sums_finish_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                   float* __restrict__ s2, int C, int nsplit) {
  __shared__ float scratch[kThreads / 32];
  const int c = blockIdx.x, k = blockIdx.y;
  const float* p = partial + ((int64_t)k * C + c) * nsplit;
  float v = 0.0f;
  for (int s = threadIdx.x; s < nsplit; s += kThreads) v += p[s];
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) (k == 0 ? s1 : s2)[c] = v;
}

template <typename T, int VEC, bool SAME>
void launch_typed(const void* a, const void* b, float* partial, int64_t outer,
                  int C, int64_t inner, int p0, int64_t p1, int isplit,
                  int nsplit, int ncolgroups, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (inner == 1) {
    sums_rows_kernel<T, VEC, SAME>
        <<<dim3(nsplit, ncolgroups), kThreads, 0, stream>>>(
            ta, tb, partial, outer, C, p1);
  } else {
    sums_planar_kernel<T, VEC, SAME>
        <<<dim3(nsplit, C), kThreads, 0, stream>>>(
            ta, tb, partial, outer, C, inner, p0, p1, isplit);
  }
}

template <typename T, int VEC>
void launch_vec(const void* a, const void* b, bool same, float* partial,
                int64_t outer, int C, int64_t inner, int p0, int64_t p1,
                int isplit, int nsplit, int ncolgroups, cudaStream_t stream) {
  if (same)
    launch_typed<T, VEC, true>(a, b, partial, outer, C, inner, p0, p1, isplit,
                               nsplit, ncolgroups, stream);
  else
    launch_typed<T, VEC, false>(a, b, partial, outer, C, inner, p0, p1,
                                isplit, nsplit, ncolgroups, stream);
}

}  // namespace

// a, b: (outer, C, inner) contiguous, same dtype (0 float32, 1 bfloat16);
// b == a reads the input once. vec: elements a load (1, or 16 bytes' worth,
// chosen by the wrapper from the alignment). Planar (inner > 1): p0 rows a
// block, p1 inner vectors a block, isplit inner splits. Rows (inner == 1):
// p1 rows a block, ncolgroups groups of 256 vector columns. partial: float32
// (2, C, nsplit) scratch. s1, s2: float32 (C,). Returns cudaGetLastError().
extern "C" int channel_sums_launch(const void* a, const void* b, int dtype,
                                   int vec, float* partial, float* s1,
                                   float* s2, int64_t outer, int C,
                                   int64_t inner, int p0, int64_t p1,
                                   int isplit, int nsplit, int ncolgroups,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool same = a == b;
  if (dtype == 0) {
    if (vec == 4)
      launch_vec<float, 4>(a, b, same, partial, outer, C, inner, p0, p1,
                           isplit, nsplit, ncolgroups, stream);
    else
      launch_vec<float, 1>(a, b, same, partial, outer, C, inner, p0, p1,
                           isplit, nsplit, ncolgroups, stream);
  } else {
    if (vec == 8)
      launch_vec<__nv_bfloat16, 8>(a, b, same, partial, outer, C, inner, p0,
                                   p1, isplit, nsplit, ncolgroups, stream);
    else
      launch_vec<__nv_bfloat16, 1>(a, b, same, partial, outer, C, inner, p0,
                                   p1, isplit, nsplit, ncolgroups, stream);
  }
  sums_finish_kernel<<<dim3(C, 2), kThreads, 0, stream>>>(partial, s1, s2, C,
                                                          nsplit);
  return (int)cudaGetLastError();
}
