// 3x3x3 stride-1 SAME convolution with per-channel sum(y) and sum(y*y) in
// its epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dualvar_tpu/ops/conv_fused.py:_kernel (reached
// through _fused_fwd and conv3d_bn_stats) and computes the same function:
//
//   y[n,t,h,w,o] = sum over (dt,dh,dw,c) of x[n,t+dt-1,h+dh-1,w+dw-1,c] *
//                  w[dt,dh,dw,c,o]   (zero outside x), rounded to x's dtype
//   s1[o] = sum of y[...,o],  s2[o] = sum of y[...,o]^2   (float32)
//
// with x (N, T, H, W, C) and y (N, T, H, W, Co) channels-last, w (3, 3, 3, C,
// Co) used in x's dtype, float32 accumulation, and the sums taken from y
// AFTER it is rounded to the output dtype, as the TPU kernel does.
//
// Bound: operations (2*27*C*Co per output position; at the R3D layer-1 shape
// (16, 16, 56, 56, 64) that is 1.78e11 against 206 MB of x and y).
//
// Design: simple and right first; it runs on the CUDA cores in float32, far
// from the tensor-core bound (wgmma and TMA are later work).
//   - a block owns one (n, t), HT output rows of h, all of w and a tile of
//     up to 64 output channels; a thread owns 4 neighbouring w and 8
//     neighbouring output channels of one row, 32 float32 accumulators;
//   - the input channels go in chunks of 8: the block stages the chunk's
//     3 x (HT+2) x (W+2) halo of x and its 27 x 8 x 64 weights in shared
//     memory as float32 (zeros outside x), then every thread does 27 x 8
//     steps of 4 + 2 x 16-byte shared loads and 32 fused multiply-adds;
//   - epilogue: y is rounded, stored 8 channels at a time, and the thread's
//     partial sum(y) and sum(y^2) are taken from the ROUNDED values.
// The statistics are where the TPU kernel went wrong (revisited-output
// accumulation across its 2-D grid). Here nothing is accumulated across
// blocks: each block writes its per-channel partials to its own slot, and a
// second kernel adds a channel's partials in a fixed order, so the result is
// the same from run to run and does not depend on how blocks are scheduled.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 4;   // output w positions a thread
constexpr int kTC = 8;   // output channels a thread
constexpr int kCI = 8;   // input channels a shared-memory chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive values of T stored from one (bf16) or two (float) 16-byte
// stores; p is 16-byte aligned
template <typename T>
__device__ __forceinline__ void store8(T* p, const T* v) {
  static_assert(sizeof(T) * kTC % 16 == 0, "");
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) * kTC / 16); ++k)
    reinterpret_cast<uint4*>(p)[k] = reinterpret_cast<const uint4*>(v)[k];
}

// grid (N * T * nht, Co / co_tile); dynamic shared memory: the weight chunk
// (27, kCI, co_tile) then the x halo (3, HT + 2, kCI, Wp), both float32, Wp =
// 4 * ceil(W / 4) + 2; reused for the per-thread sums at the end.
// partial: (2, Co, gridDim.x) float32.
template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
conv3d_bn_stats_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                       T* __restrict__ y, float* __restrict__ partial, int N,
                       int Tn, int H, int W, int C, int Co, int HT,
                       int co_tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nht = (H + HT - 1) / HT;
  const int nwg = (W + kTW - 1) / kTW;
  const int Wp = nwg * kTW + 2;
  const int ncg = co_tile / kTC;
  float* w_s = smem;                          // (27, kCI, co_tile)
  float* x_s = smem + 27 * kCI * co_tile;     // (3, HT + 2, kCI, Wp)

  const int blk = blockIdx.x;
  const int ht = blk % nht;
  const int t = (blk / nht) % Tn;
  const int n = blk / (nht * Tn);
  const int h0 = ht * HT;
  const int co0 = blockIdx.y * co_tile;

  const int tid = threadIdx.x;
  const int items = HT * nwg * ncg;
  const bool active = tid < items;
  const int cg = tid % ncg;
  const int wg = (tid / ncg) % nwg;
  const int hr = tid / (ncg * nwg);
  const int w0 = wg * kTW;

  float acc[kTW][kTC];
#pragma unroll
  for (int k = 0; k < kTW; ++k)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[k][j] = 0.0f;

  const int x_elems = 3 * (HT + 2) * Wp * kCI;
  const int w_elems = 27 * kCI * co_tile;
  for (int c0 = 0; c0 < C; c0 += kCI) {
    __syncthreads();  // the previous chunk is no longer read
    // x halo, channel fastest in the read (8 neighbouring channels of a
    // position are contiguous in x)
    for (int e = tid; e < x_elems; e += kThreads) {
      const int ci = e % kCI;
      int rest = e / kCI;
      const int ww = rest % Wp;
      rest /= Wp;
      const int hh = rest % (HT + 2);
      const int dt = rest / (HT + 2);
      const int tt = t + dt - 1, hx = h0 + hh - 1, wx = ww - 1, c = c0 + ci;
      float v = 0.0f;
      if (tt >= 0 && tt < Tn && hx >= 0 && hx < H && wx >= 0 && wx < W &&
          c < C)
        v = to_f(x[((((int64_t)n * Tn + tt) * H + hx) * W + wx) * C + c]);
      x_s[((dt * (HT + 2) + hh) * kCI + ci) * Wp + ww] = v;
    }
    // weights of the chunk, rounded to x's dtype as the convolution uses them
    for (int e = tid; e < w_elems; e += kThreads) {
      const int co = e % co_tile;
      const int rest = e / co_tile;
      const int ci = rest % kCI;
      const int tap = rest / kCI;
      const int c = c0 + ci;
      float v = 0.0f;
      if (c < C)
        v = to_f(from_f<T>(to_f(w[((int64_t)tap * C + c) * Co + co0 + co])));
      w_s[e] = v;
    }
    __syncthreads();
    if (active) {
      for (int tap = 0; tap < 27; ++tap) {
        const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
        const float* xrow = x_s + (dt * (HT + 2) + hr + dh) * kCI * Wp + w0 + dw;
        const float* wrow = w_s + tap * kCI * co_tile + cg * kTC;
#pragma unroll
        for (int ci = 0; ci < kCI; ++ci) {
          float xv[kTW];
#pragma unroll
          for (int k = 0; k < kTW; ++k) xv[k] = xrow[ci * Wp + k];
          const float4 wa = *reinterpret_cast<const float4*>(wrow + ci * co_tile);
          const float4 wb =
              *reinterpret_cast<const float4*>(wrow + ci * co_tile + 4);
          const float wv[kTC] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int k = 0; k < kTW; ++k)
#pragma unroll
            for (int j = 0; j < kTC; ++j)
              acc[k][j] = fmaf(xv[k], wv[j], acc[k][j]);
        }
      }
    }
  }

  // epilogue: round, store, and sum the rounded values
  float s1[kTC], s2[kTC];
#pragma unroll
  for (int j = 0; j < kTC; ++j) s1[j] = s2[j] = 0.0f;
  const int h = h0 + hr;
  if (active && h < H) {
#pragma unroll
    for (int k = 0; k < kTW; ++k) {
      if (w0 + k >= W) continue;
      alignas(16) T out[kTC];
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        out[j] = from_f<T>(acc[k][j]);
        const float r = to_f(out[j]);
        s1[j] += r;
        s2[j] = fmaf(r, r, s2[j]);
      }
      store8(y + ((((int64_t)n * Tn + t) * H + h) * W + w0 + k) * Co + co0 +
                 cg * kTC,
             out);
    }
  }
  __syncthreads();  // the chunk buffers are free
  float* red = smem;  // (2, kThreads, kTC)
#pragma unroll
  for (int j = 0; j < kTC; ++j) {
    red[tid * kTC + j] = s1[j];
    red[(kThreads + tid) * kTC + j] = s2[j];
  }
  __syncthreads();
  // one thread a channel of the tile adds the threads of its channel group
  // (tid % ncg == cg) in order
  if (tid < co_tile) {
    const int g = tid / kTC, j = tid % kTC;
    float t1 = 0.0f, t2 = 0.0f;
    for (int i = g; i < kThreads; i += ncg) {
      t1 += red[i * kTC + j];
      t2 += red[(kThreads + i) * kTC + j];
    }
    const int64_t c = co0 + tid;
    partial[c * gridDim.x + blk] = t1;
    partial[((int64_t)Co + c) * gridDim.x + blk] = t2;
  }
}

// sum of v over the block in a fixed order
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < (int)(blockDim.x / 32); ++i) total += scratch[i];
  return total;
}

// grid (Co, 2): block (c, k) adds partial[k, c, :] into out_k[c]
__global__ void __launch_bounds__(kThreads)
stats_finish_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                    float* __restrict__ s2, int Co, int nblk) {
  __shared__ float scratch[kThreads / 32];
  const int c = blockIdx.x, k = blockIdx.y;
  const float* p = partial + ((int64_t)k * Co + c) * nblk;
  float v = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) v += p[i];
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) (k == 0 ? s1 : s2)[c] = v;
}

template <typename T, typename TW>
int launch_typed(const void* x, const void* w, void* y, float* partial,
                 float* s1, float* s2, int N, int Tn, int H, int W, int C,
                 int Co, int HT, int co_tile, size_t smem,
                 cudaStream_t stream) {
  auto kernel = conv3d_bn_stats_kernel<T, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nht = (H + HT - 1) / HT;
  const dim3 grid((unsigned)((int64_t)N * Tn * nht), Co / co_tile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<T*>(y),
      partial, N, Tn, H, W, C, Co, HT, co_tile);
  stats_finish_kernel<<<dim3(Co, 2), kThreads, 0, stream>>>(
      partial, s1, s2, Co, (int)grid.x);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, T, H, W, C) and y (N, T, H, W, Co) contiguous, x_dtype 0 float32 /
// 1 bfloat16 (y alike); w (3, 3, 3, C, Co) contiguous, w_dtype likewise.
// HT rows a block, co_tile output channels a block (8, 16, 32 or 64,
// dividing Co), chosen by the wrapper with HT * ceil(W/4) * co_tile / 8 <=
// 256 threads; smem bytes of dynamic shared memory. partial: float32
// (2, Co, N * T * ceil(H / HT)) scratch; s1, s2: float32 (Co,). Returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int conv3d_bn_stats_launch(const void* x, const void* w, void* y,
                                      float* partial, float* s1, float* s2,
                                      int x_dtype, int w_dtype, int N, int Tn,
                                      int H, int W, int C, int Co, int HT,
                                      int co_tile, int64_t smem,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = (size_t)smem;
  if (x_dtype == 0) {
    if (w_dtype == 0)
      return launch_typed<float, float>(x, w, y, partial, s1, s2, N, Tn, H, W,
                                        C, Co, HT, co_tile, bytes, stream);
    return launch_typed<float, __nv_bfloat16>(x, w, y, partial, s1, s2, N, Tn,
                                              H, W, C, Co, HT, co_tile, bytes,
                                              stream);
  }
  if (w_dtype == 0)
    return launch_typed<__nv_bfloat16, float>(x, w, y, partial, s1, s2, N, Tn,
                                              H, W, C, Co, HT, co_tile, bytes,
                                              stream);
  return launch_typed<__nv_bfloat16, __nv_bfloat16>(
      x, w, y, partial, s1, s2, N, Tn, H, W, C, Co, HT, co_tile, bytes,
      stream);
}
