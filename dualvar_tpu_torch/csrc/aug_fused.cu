// Fused clip augmentation for Hopper (sm_90a).
//
// Replaces the Pallas kernel dualvar_tpu/ops/aug_fused.py:_aug_kernel and
// computes the same function: per clip, uint8 -> float32 / 255; the four
// torchvision-semantics colour-jitter ops (brightness, contrast, saturation,
// hue) in the clip's own order with clip-consistent factors; a gated
// separable 13-tap Gaussian blur with edge replication (W pass, then H pass);
// ImageNet normalisation; cast to float32 or bfloat16.
//
// Bound: bytes. Per clip the function must read 3*T*S*S bytes and write
// 3*T*S*S*sizeof(out); the arithmetic (about 150 flops a pixel with hue and
// blur) is far below the card's float32 rate at that traffic.
//
// Design. The only coupling across pixels is (a) the per-frame gray mean in
// the contrast op and (b) the blur; nothing couples the frames of a clip,
// because the factors are clip-consistent scalars. So the unit of work is one
// FRAME: a grid of N*T blocks, each holding the frame's three float32 planes
// in shared memory (3*S*S*4 bytes) plus one scratch plane for the separable
// blur. Each frame is read from device memory once and written once:
//   phase 1  load u8, apply the pointwise ops that precede contrast in this
//            clip's order, stage r,g,b in shared memory, block-reduce gray;
//   phase 2  contrast with the frame mean and the ops after it; without blur
//            normalise and store straight from registers;
//   phase 3  (blur clips only) per channel: W pass plane -> scratch, H pass
//            scratch -> normalise -> store.
// A thread owns the same pixels in phases 1 and 2, so only the reduction and
// the stencil passes need block barriers.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTaps = 13;
constexpr int kRadius = kTaps / 2;

// torchvision rgb_to_grayscale weights
constexpr float kGrayR = 0.2989f, kGrayG = 0.587f, kGrayB = 0.114f;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float blend(float x, float other, float f) {
  return clip01(x * f + other * (1.0f - f));
}

__device__ __forceinline__ float gray(float r, float g, float b) {
  return kGrayR * r + kGrayG * g + kGrayB * b;
}

// floored modulo by 1: the hue shift makes h + fh negative, where fmodf
// would return a negative value
__device__ __forceinline__ float mod1(float x) { return x - floorf(x); }

__device__ __forceinline__ void hue(float& r, float& g, float& b, float fh) {
  // maxc/minc come from the very registers the sector compares test, so
  // the exact == below picks the same branch as the plain version
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const bool eqc = maxc == minc;
  const float cr = maxc - minc;
  const float s = cr / (eqc ? 1.0f : maxc);
  const float cr_div = eqc ? 1.0f : cr;
  const float rc = (maxc - r) / cr_div;
  const float gc = (maxc - g) / cr_div;
  const float bc = (maxc - b) / cr_div;
  const float hr = (maxc == r) ? bc - gc : 0.0f;
  const float hg = (maxc == g && maxc != r) ? 2.0f + rc - bc : 0.0f;
  const float hb = (maxc != g && maxc != r) ? 4.0f + gc - rc : 0.0f;
  float h = mod1((hr + hg + hb) / 6.0f + 1.0f);
  h = mod1(h + fh);
  const float h6 = h * 6.0f;
  const float vs = maxc * s;
  // n + h6 >= 1 > 0, so fmodf is the floored modulo here
  const float k5 = fmodf(5.0f + h6, 6.0f);
  const float k3 = fmodf(3.0f + h6, 6.0f);
  const float k1 = fmodf(1.0f + h6, 6.0f);
  r = maxc - vs * clip01(fminf(k5, 4.0f - k5));
  g = maxc - vs * clip01(fminf(k3, 4.0f - k3));
  b = maxc - vs * clip01(fminf(k1, 4.0f - k1));
}

// One pointwise jitter op (0 brightness, 2 saturation, 3 hue). Contrast (1)
// needs the frame mean and is applied by the caller.
__device__ __forceinline__ void pointwise_op(int op, const float* f, float& r,
                                             float& g, float& b) {
  if (op == 0) {
    r = blend(r, 0.0f, f[0]);
    g = blend(g, 0.0f, f[0]);
    b = blend(b, 0.0f, f[0]);
  } else if (op == 2) {
    const float gr = gray(r, g, b);
    r = blend(r, gr, f[2]);
    g = blend(g, gr, f[2]);
    b = blend(b, gr, f[2]);
  } else if (op == 3) {
    hue(r, g, b, f[3]);
  }
}

__device__ __forceinline__ void store(float* out, size_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16(v);  // round to nearest even
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
aug_fused_kernel(const uint8_t* __restrict__ in,
                 const int32_t* __restrict__ orders,
                 const float* __restrict__ factors,
                 const float* __restrict__ blur, OutT* __restrict__ out,
                 int T, int S, int normalize) {
  extern __shared__ float smem[];
  const int P = S * S;
  float* plane[3] = {smem, smem + P, smem + 2 * P};
  float* scratch = smem + 3 * P;
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float taps[kTaps];
  __shared__ float frame_mean;

  const int n = blockIdx.x / T;
  const int t = blockIdx.x % T;
  const int tid = threadIdx.x;

  int order[4];
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    order[k] = orders[n * 4 + k];
    f[k] = factors[n * 4 + k];
  }
  const float sigma = blur[n * 2 + 0];
  const bool blur_on = blur[n * 2 + 1] > 0.0f;
  // slot of the contrast op in this clip's order
  int c_slot = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (order[k] == 1) c_slot = k;

  // plane (n, c, t) of the planar (N, 3, T, S, S) layout
  size_t base[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    base[c] = ((size_t)(n * 3 + c) * T + t) * (size_t)P;

  float scale[3] = {1.0f, 1.0f, 1.0f}, bias[3] = {0.0f, 0.0f, 0.0f};
  if (normalize) {
    // ImageNet mean / std
    scale[0] = (float)(1.0 / 0.229);
    scale[1] = (float)(1.0 / 0.224);
    scale[2] = (float)(1.0 / 0.225);
    bias[0] = (float)(-0.485 / 0.229);
    bias[1] = (float)(-0.456 / 0.224);
    bias[2] = (float)(-0.406 / 0.225);
  }

  // phase 1: load, ops before contrast, stage, partial gray sums
  float gsum = 0.0f;
  for (int i = tid; i < P; i += kThreads) {
    float r = (float)in[base[0] + i] * (1.0f / 255.0f);
    float g = (float)in[base[1] + i] * (1.0f / 255.0f);
    float b = (float)in[base[2] + i] * (1.0f / 255.0f);
    for (int k = 0; k < c_slot; ++k) pointwise_op(order[k], f, r, g, b);
    plane[0][i] = r;
    plane[1][i] = g;
    plane[2][i] = b;
    gsum += gray(r, g, b);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = gsum;
  if (blur_on && tid < kTaps) {
    const float x = (float)(tid - kRadius) / fmaxf(sigma, 1e-6f);
    taps[tid] = expf(-0.5f * x * x);
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    frame_mean = total * (1.0f / (float)P);
    if (blur_on) {
      float ksum = 0.0f;
      for (int j = 0; j < kTaps; ++j) ksum += taps[j];
      for (int j = 0; j < kTaps; ++j) taps[j] /= ksum;
    }
  }
  __syncthreads();
  const float m = frame_mean;

  // phase 2: contrast and the ops after it, on this thread's own pixels
  for (int i = tid; i < P; i += kThreads) {
    float r = plane[0][i], g = plane[1][i], b = plane[2][i];
    if (c_slot < 4) {
      r = blend(r, m, f[1]);
      g = blend(g, m, f[1]);
      b = blend(b, m, f[1]);
    }
    for (int k = c_slot + 1; k < 4; ++k) pointwise_op(order[k], f, r, g, b);
    if (blur_on) {
      plane[0][i] = r;
      plane[1][i] = g;
      plane[2][i] = b;
    } else {
      store(out, base[0] + i, r * scale[0] + bias[0]);
      store(out, base[1] + i, g * scale[1] + bias[1]);
      store(out, base[2] + i, b * scale[2] + bias[2]);
    }
  }
  if (!blur_on) return;  // uniform across the block: blur is per clip

  // phase 3: separable blur with clamped neighbours, W pass then H pass
  float k[kTaps];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTaps; ++j) k[j] = taps[j];
  for (int c = 0; c < 3; ++c) {
    const float* src = plane[c];
    for (int i = tid; i < P; i += kThreads) {
      const int y = i / S, x = i - y * S;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const int xx = min(max(x - kRadius + j, 0), S - 1);
        acc += k[j] * src[y * S + xx];
      }
      scratch[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < P; i += kThreads) {
      const int y = i / S, x = i - y * S;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const int yy = min(max(y - kRadius + j, 0), S - 1);
        acc += k[j] * scratch[yy * S + x];
      }
      store(out, base[c] + i, acc * scale[c] + bias[c]);
    }
    __syncthreads();  // scratch is reused by the next channel
  }
}

template <typename OutT>
int launch(const void* in, const void* orders, const void* factors,
           const void* blur, void* out, int N, int T, int S, int normalize,
           cudaStream_t stream) {
  const size_t smem = (size_t)4 * S * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      aug_fused_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  aug_fused_kernel<OutT><<<N * T, kThreads, smem, stream>>>(
      (const uint8_t*)in, (const int32_t*)orders, (const float*)factors,
      (const float*)blur, (OutT*)out, T, S, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// in (N,3,T,S,S) u8; orders (N,4) i32; factors (N,4) f32; blur (N,2) f32
// (sigma, on>0); out (N,3,T,S,S) f32 (out_bf16 == 0) or bf16. All contiguous
// device pointers. Returns cudaGetLastError() of the launch (0 = success).
extern "C" int aug_fused_launch(const void* in, const void* orders,
                                const void* factors, const void* blur,
                                void* out, int N, int T, int S, int out_bf16,
                                int normalize, void* stream) {
  if (N <= 0) return 0;
  if (out_bf16)
    return launch<__nv_bfloat16>(in, orders, factors, blur, out, N, T, S,
                                 normalize, (cudaStream_t)stream);
  return launch<float>(in, orders, factors, blur, out, N, T, S, normalize,
                       (cudaStream_t)stream);
}
