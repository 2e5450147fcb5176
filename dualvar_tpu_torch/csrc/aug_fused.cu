// Fused clip augmentation for Hopper (sm_90a).
//
// Replaces the Pallas kernel dualvar_tpu/ops/aug_fused.py:_aug_kernel and
// computes the same function: per clip, uint8 -> float32 / 255; the four
// torchvision-semantics colour-jitter ops (brightness, contrast, saturation,
// hue) in the clip's own order with clip-consistent factors; a gated
// separable 13-tap Gaussian blur with edge replication (W pass, then H pass);
// ImageNet normalisation; cast to float32 or bfloat16.
//
// Two compute routes, as the JAX kernel's compute_dtype: float32 planes,
// or bfloat16 planes (compute_bf16), where every plane value is a bfloat16
// number and each op of the JAX kernel's bfloat16 mode is rounded where it
// rounds: the u8 / 255 plane; each factor once an op (fac()); the blend's
// x*f, other*(1-f), their sum; the gray's three products and two sums
// (python-float weights, bfloat16 by JAX's weak typing); the contrast mean,
// summed in float32 and rounded once; hue in float32 on the bfloat16
// planes, its result rounded; the blur's float32 passes, rounded once; the
// normalisation's product and sum. That route evaluates hue and the blur
// op by op as the plain PyTorch version does on the card (true divisions,
// no contracted multiply-adds), so the two differ only where the contrast
// mean's float32 sum order or the blur's tap sum moves a rounding.
//
// Bound: bytes. Per clip the function must read 3*T*S*S bytes and write
// 3*T*S*S*sizeof(out); the arithmetic (about 150 flops a pixel with hue and
// blur) is far below the card's float32 rate at that traffic.
//
// Design. The only couplings across pixels are (a) the per-frame gray mean
// of the contrast op and (b) the blur; nothing couples the frames of a clip,
// because the factors are clip-consistent scalars. A frame is cut into
// bands of rows (8 bands of 14 rows at S = 112), one block a band, and the
// bands of a frame form one thread-block cluster, so a frame's work spreads
// over 8 small blocks (several resident on an SM) instead of one block that
// fills an SM's shared memory:
//   phase 1  each block loads its rows, 4 pixels a thread and channel in
//            one 4-byte load, applies the pointwise ops that precede
//            contrast in the clip's order, stages r, g, b in shared memory
//            and sums the gray of its rows in a fixed order;
//   exchange after a cluster barrier the blocks read the 8 band sums
//            through distributed shared memory (one lane a band) and add
//            them in band order, so all 8 see the same frame mean;
//   phase 2  contrast with that mean and the ops after it; without blur
//            normalise and store with 16-byte stores;
//   phase 3  (blurred clips only) the W pass of the band's rows, in place;
//            a cluster barrier; the H pass of the band's rows, reading the
//            6 rows above and below (edge-replicated) from the blocks that
//            own them, through distributed shared memory; normalise,
//            16-byte stores.
// A block does not leave while another block of its cluster may still read
// its shared memory.
//
// Two designs were measured before this one (NVIDIA H100 80GB HBM3, 700 W,
// N=24, T=16, S=112, float32 out): 16-pixel units with 16-byte u8 loads
// left 98 threads a block busy at 121 registers (0.50 ms); 4-pixel units
// with each block recomputing the colour chain on 6 halo rows above and
// below instead of reading its neighbours' W pass ran at 0.18 ms, the halo
// nearly doubling a blurred clip's work.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBandRows = 32;  // rows a band at most: S <= 256
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

// round to the nearest bfloat16 (ties to even), kept as a float
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the route's rounding of a plane op's result: none on the float32 route
template <bool kBf>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf) {
    return bf(x);
  } else {
    return x;
  }
}

// A clip's factors as each route takes them: f as given (float32); on the
// bfloat16 route fb = bf16(f) for brightness, contrast and saturation and
// omf = bf16(1 - fb), as the JAX kernel's fac() and _blend make them
struct Factors {
  float f[4];
  float fb[3];
  float omf[3];
};

// blend with the factor of op k (0 brightness, 1 contrast, 2 saturation)
template <bool kBf>
__device__ __forceinline__ float blend_t(float x, float other,
                                         const Factors& F, int k) {
  if constexpr (kBf) {
    return clip01(bf(bf(x * F.fb[k]) + bf(other * F.omf[k])));
  } else {
    return blend(x, other, F.f[k]);
  }
}

template <bool kBf>
__device__ __forceinline__ float gray_t(float r, float g, float b) {
  if constexpr (kBf) {
    return bf(bf(bf(bf(kGrayR) * r) + bf(bf(kGrayG) * g)) +
              bf(bf(kGrayB) * b));
  } else {
    return gray(r, g, b);
  }
}

// floored modulo by 1: the hue shift makes h + fh negative, where fmodf
// would return a negative value
__device__ __forceinline__ float mod1(float x) { return x - floorf(x); }

// x mod 6 for x in [0, 12)
__device__ __forceinline__ float mod6(float x) {
  return x >= 6.0f ? x - 6.0f : x;
}

__device__ __forceinline__ void hue(float& r, float& g, float& b, float fh) {
  // maxc/minc come from the very registers the sector compares test, so
  // the exact == below picks the same branch as the plain version
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const bool eqc = maxc == minc;
  const float cr = maxc - minc;
  const float s = cr / (eqc ? 1.0f : maxc);
  // one correctly rounded reciprocal for the three quotients and a product
  // for the division by 6: each differs from the plain version's division
  // by an ulp at most, which moves no output by more than about 1e-7 (the
  // error of a quotient comes back multiplied by cr)
  const float inv = 1.0f / (eqc ? 1.0f : cr);
  const float rc = (maxc - r) * inv;
  const float gc = (maxc - g) * inv;
  const float bc = (maxc - b) * inv;
  const float hr = (maxc == r) ? bc - gc : 0.0f;
  const float hg = (maxc == g && maxc != r) ? 2.0f + rc - bc : 0.0f;
  const float hb = (maxc != g && maxc != r) ? 4.0f + gc - rc : 0.0f;
  float h = mod1((hr + hg + hb) * (1.0f / 6.0f) + 1.0f);
  h = mod1(h + fh);
  const float h6 = h * 6.0f;
  const float vs = maxc * s;
  // n + h6 lies in [1, 12): its floored modulo by 6 is one exact
  // subtraction (Sterbenz) where it is >= 6, as fmodf would give
  const float k5 = mod6(5.0f + h6);
  const float k3 = mod6(3.0f + h6);
  const float k1 = mod6(1.0f + h6);
  r = maxc - vs * clip01(fminf(k5, 4.0f - k5));
  g = maxc - vs * clip01(fminf(k3, 4.0f - k3));
  b = maxc - vs * clip01(fminf(k1, 4.0f - k1));
}

// hue on the bfloat16 route: the plain version's operations on the card
// one by one (true divisions, the division by 6 a product with the float32
// reciprocal as ATen's division by a scalar computes it, nothing
// contracted), each rounded once; the caller rounds the result to bfloat16
__device__ __forceinline__ void hue_rn(float& r, float& g, float& b,
                                       float fh) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const bool eqc = maxc == minc;
  const float cr = __fsub_rn(maxc, minc);
  const float s = __fdiv_rn(cr, eqc ? 1.0f : maxc);
  const float crd = eqc ? 1.0f : cr;
  const float rc = __fdiv_rn(__fsub_rn(maxc, r), crd);
  const float gc = __fdiv_rn(__fsub_rn(maxc, g), crd);
  const float bc = __fdiv_rn(__fsub_rn(maxc, b), crd);
  const float hr = (maxc == r) ? __fsub_rn(bc, gc) : 0.0f;
  const float hg =
      (maxc == g && maxc != r) ? __fsub_rn(__fadd_rn(2.0f, rc), bc) : 0.0f;
  const float hb =
      (maxc != g && maxc != r) ? __fsub_rn(__fadd_rn(4.0f, gc), rc) : 0.0f;
  float h = mod1(__fadd_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(hr, hg), hb), 1.0f / 6.0f), 1.0f));
  h = mod1(__fadd_rn(h, fh));
  const float h6 = __fmul_rn(h, 6.0f);
  const float vs = __fmul_rn(maxc, s);
  const float k5 = mod6(__fadd_rn(5.0f, h6));
  const float k3 = mod6(__fadd_rn(3.0f, h6));
  const float k1 = mod6(__fadd_rn(1.0f, h6));
  r = __fsub_rn(maxc,
                __fmul_rn(vs, clip01(fminf(k5, __fsub_rn(4.0f, k5)))));
  g = __fsub_rn(maxc,
                __fmul_rn(vs, clip01(fminf(k3, __fsub_rn(4.0f, k3)))));
  b = __fsub_rn(maxc,
                __fmul_rn(vs, clip01(fminf(k1, __fsub_rn(4.0f, k1)))));
}

// One pointwise jitter op (0 brightness, 2 saturation, 3 hue) on the V
// pixels of a unit: the op is decoded once a unit and the pixels' chains
// are independent. Contrast (1) needs the frame mean: the caller applies it.
template <int V, bool kBf>
__device__ __forceinline__ void pointwise_op(int op, const Factors& F,
                                             float (&px)[3][V]) {
  if (op == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c][i] = blend_t<kBf>(px[c][i], 0.0f, F, 0);
  } else if (op == 2) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gr = gray_t<kBf>(px[0][i], px[1][i], px[2][i]);
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c][i] = blend_t<kBf>(px[c][i], gr, F, 2);
    }
  } else if (op == 3) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (kBf) {
        hue_rn(px[0][i], px[1][i], px[2][i], F.f[3]);
#pragma unroll
        for (int c = 0; c < 3; ++c) px[c][i] = bf(px[c][i]);
      } else {
        hue(px[0][i], px[1][i], px[2][i], F.f[3]);
      }
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address of ``local`` (an address in this block's
// shared memory) in block ``rank`` of the cluster: the same offset in that
// block's shared memory (distributed shared memory)
__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// 16-byte aligned
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// V consecutive u8 of a row (4-byte aligned when V == 4) as floats / 255
template <int V>
__device__ __forceinline__ void load_u8(const uint8_t* p, float* v) {
  if constexpr (V == 4) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (float)((q >> (8 * i)) & 0xFFu) * (1.0f / 255.0f);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (float)p[i] * (1.0f / 255.0f);
  }
}

// V consecutive outputs; p is 16-byte aligned when V * sizeof(out) is a
// multiple of 16 (8-byte for 4 bf16)
template <int V>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}
template <int V>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  if constexpr (V % 4 == 0) {
    // round to nearest even, pairs packed low element first
#pragma unroll
    for (int i = 0; i < V; i += 8 > V ? V : 8) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int j = 0; j < (V < 8 ? V : 8) / 2; ++j)
        h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
      if constexpr (V >= 8)
        *reinterpret_cast<uint4*>(p + i) = *reinterpret_cast<const uint4*>(h);
      else
        *reinterpret_cast<uint2*>(p + i) = *reinterpret_cast<const uint2*>(h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

// grid: N * T * nbands blocks in clusters of nbands, block b of a cluster
// owns frame rows b * band_rows .. (b + 1) * band_rows - 1 (fewer in the
// last band). Dynamic shared memory: 3 planes of band_rows rows of S floats:
// r, g, b, which hold the W pass the cluster's blocks read for the blur's
// H pass. kVec:
// S % 4 == 0 and a 4-byte aligned input (4-pixel units, 16-byte float32
// stores, float4 shared-memory traffic). kBf: the bfloat16 compute route
// (see the top of the file).
// 5 blocks an SM: the register cap this asks for (48, a few bytes spilled)
// buys more resident warps than 64 registers at 4 blocks, which the
// colour chain's latency needs more
template <typename OutT, bool kVec, bool kBf>
__global__ void __launch_bounds__(kThreads, 5)
aug_band_kernel(const uint8_t* __restrict__ in,
                const int32_t* __restrict__ orders,
                const float* __restrict__ factors,
                const float* __restrict__ blur, OutT* __restrict__ out, int T,
                int S, int band_rows, int nbands, int normalize) {
  constexpr int V = kVec ? 4 : 1;  // pixels a unit
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float taps[kTaps];
  __shared__ float band_sum;  // read by every block of the cluster
  __shared__ float frame_mean;
  // H pass: for own row r and tap j, the shared::cluster address of the
  // W-pass row it reads (channel 0; the other channels' planes follow at
  // the same stride in every block)
  __shared__ uint32_t hsrc[kMaxBandRows * kTaps];

  const int band = blockIdx.x % nbands;  // the block's rank in its cluster
  const int frame = blockIdx.x / nbands;
  const int n = frame / T, t = frame % T;
  const int tid = threadIdx.x;
  const int P = S * S;
  const int y0 = band * band_rows;
  const int rows = min(band_rows, S - y0);

  // the op order packed 2 bits a slot: a register, not a local array
  int order = 0;
  Factors f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    order |= (orders[n * 4 + k] & 3) << (2 * k);
    f.f[k] = factors[n * 4 + k];
  }
  if constexpr (kBf) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f.fb[k] = bf(f.f[k]);
      f.omf[k] = bf(1.0f - f.fb[k]);
    }
  }
  const float sigma = blur[n * 2 + 0];
  const bool blur_on = blur[n * 2 + 1] > 0.0f;  // the same in the cluster
  // slot of the contrast op in this clip's order
  int c_slot = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (((order >> (2 * k)) & 3) == 1) c_slot = k;

  const int plane_size = band_rows * S;
  float* plane[3] = {smem, smem + plane_size, smem + 2 * plane_size};

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
  if constexpr (kBf) {
    // python floats in the JAX kernel's bfloat16 ops: rounded once
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      scale[c] = bf(scale[c]);
      bias[c] = bf(bias[c]);
    }
  }

  // phase 1: load, ops before contrast, stage, gray sum of the band
  const int upr = S / V;  // units a row
  const int units = rows * upr;
  float gsum = 0.0f;
  for (int u = tid; u < units; u += kThreads) {
    const int r = u / upr, x0 = (u - r * upr) * V;
    float px[3][V];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_u8<V>(in + base[c] + (size_t)(y0 + r) * S + x0, px[c]);
    if constexpr (kBf) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) px[c][i] = bf(px[c][i]);
    }
    for (int k = 0; k < c_slot; ++k)
      pointwise_op<V, kBf>((order >> (2 * k)) & 3, f, px);
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) plane[c][r * S + x0 + i] = px[c][i];
      gsum += gray_t<kBf>(px[0][i], px[1][i], px[2][i]);
    }
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
    band_sum = total;
  }
  // exchange: every band sum of the frame is written
  cluster_arrive();
  cluster_wait();
  if (tid < 32) {
    // lane b reads band b's sum; every lane adds them in band order
    const float mine =
        tid < nbands ? ld_cluster(cluster_addr(&band_sum, tid)) : 0.0f;
    float total = 0.0f;
    for (int b = 0; b < nbands; ++b)
      total += __shfl_sync(0xffffffffu, mine, b);
    if (tid == 0) {
      frame_mean = rnd<kBf>(total * (1.0f / (float)P));
      if (blur_on) {
        float ksum = 0.0f;
        for (int j = 0; j < kTaps; ++j) ksum += taps[j];
        for (int j = 0; j < kTaps; ++j) taps[j] /= ksum;
      }
    }
  }
  // without blur this block reads no other block's shared memory from here
  // on: arrive now, wait for the others before exiting
  if (!blur_on) cluster_arrive();
  __syncthreads();
  const float m = frame_mean;

  // phase 2: contrast and the ops after it, on this thread's own units
  for (int u = tid; u < units; u += kThreads) {
    const int r = u / upr, x0 = (u - r * upr) * V;
    float px[3][V];
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        px[c][i] = plane[c][r * S + x0 + i];
        if (c_slot < 4) px[c][i] = blend_t<kBf>(px[c][i], m, f, 1);
      }
    for (int k = c_slot + 1; k < 4; ++k)
      pointwise_op<V, kBf>((order >> (2 * k)) & 3, f, px);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (blur_on) {
#pragma unroll
        for (int i = 0; i < V; ++i) plane[c][r * S + x0 + i] = px[c][i];
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          px[c][i] = kBf ? bf(bf(px[c][i] * scale[c]) + bias[c])
                         : px[c][i] * scale[c] + bias[c];
        store_out<V>(out + base[c] + (size_t)(y0 + r) * S + x0, px[c]);
      }
    }
  }

  if (blur_on) {
    // phase 3: separable blur. W pass of the band's rows in place, with
    // clamped neighbours in the row, in rounds of whole rows: a thread
    // computes one unit of each channel into registers, the block waits
    // until every read of the round's rows is done, then writes back
    float k[kTaps];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTaps; ++j) k[j] = taps[j];
    const int round_rows = kThreads / upr;  // >= 1: S <= kThreads
    for (int r0 = 0; r0 < rows; r0 += round_rows) {
      const int u = tid;
      const int r = r0 + u / upr, x0 = (u % upr) * V;
      const bool mine = u < round_rows * upr && r < rows;
      float acc[3][V];
      if (mine) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* row = plane[c] + r * S;
          float v[V + 2 * kRadius];
          if (V == 4 && x0 >= 8 && x0 + 12 <= S) {
            // away from the row's ends: 5 aligned float4 loads
            float4 q[5];
#pragma unroll
            for (int i = 0; i < 5; ++i)
              q[i] = *reinterpret_cast<const float4*>(row + x0 - 8 + 4 * i);
            const float* qf = reinterpret_cast<const float*>(q);
#pragma unroll
            for (int i = 0; i < V + 2 * kRadius; ++i) v[i] = qf[i + 2];
          } else {
#pragma unroll
            for (int i = 0; i < V + 2 * kRadius; ++i)
              v[i] = row[min(max(x0 - kRadius + i, 0), S - 1)];
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[c][e] = 0.0f;
#pragma unroll
            for (int j = 0; j < kTaps; ++j) {
              if constexpr (kBf) {
                acc[c][e] = __fadd_rn(acc[c][e], __fmul_rn(k[j], v[e + j]));
              } else {
                acc[c][e] += k[j] * v[e + j];
              }
            }
          }
        }
      }
      __syncthreads();
      if (mine) {
#pragma unroll
        for (int c = 0; c < 3; ++c) store_out<V>(plane[c] + r * S + x0, acc[c]);
      }
      __syncthreads();
    }
    // tap j of frame row y reads the W pass of frame row clamp(y - 6 + j),
    // in the block that owns it
    for (int e = tid; e < rows * kTaps; e += kThreads) {
      const int r = e / kTaps, j = e - r * kTaps;
      const int yy = min(max(y0 + r - kRadius + j, 0), S - 1);
      const int owner = yy / band_rows;
      hsrc[e] = cluster_addr(plane[0] + (yy - owner * band_rows) * S, owner);
    }
    // every band's W pass is written (and every band sum read)
    cluster_arrive();
    cluster_wait();
    // H pass of the band's rows, through distributed shared memory
    const uint32_t cstride = (uint32_t)plane_size * sizeof(float);
    for (int u = tid; u < units; u += kThreads) {
      const int r = u / upr, x0 = (u - r * upr) * V;
      uint32_t src[kTaps];
#pragma unroll
      for (int j = 0; j < kTaps; ++j)
        src[j] = hsrc[r * kTaps + j] + (uint32_t)x0 * sizeof(float);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.0f;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          float q[V];
          if constexpr (V == 4) {
            const float4 q4 = ld_cluster4(src[j] + c * cstride);
            q[0] = q4.x;
            q[1] = q4.y;
            q[2] = q4.z;
            q[3] = q4.w;
          } else {
            q[0] = ld_cluster(src[j] + c * cstride);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if constexpr (kBf) {
              acc[e] = __fadd_rn(acc[e], __fmul_rn(k[j], q[e]));
            } else {
              acc[e] += k[j] * q[e];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = kBf ? bf(bf(bf(acc[e]) * scale[c]) + bias[c])
                       : acc[e] * scale[c] + bias[c];
        store_out<V>(out + base[c] + (size_t)(y0 + r) * S + x0, acc);
      }
    }
    cluster_arrive();  // this block reads no other block's memory any more
  }
  cluster_wait();  // nor does any other block read this one's
}

template <typename OutT, bool kVec, bool kBf>
int launch(const void* in, const void* orders, const void* factors,
           const void* blur, void* out, int N, int T, int S, int band_rows,
           int nbands, int normalize, cudaStream_t stream) {
  auto kernel = aug_band_kernel<OutT, kVec, kBf>;
  const size_t smem = (size_t)3 * band_rows * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * T * nbands));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nbands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)in,
                           (const int32_t*)orders, (const float*)factors,
                           (const float*)blur, (OutT*)out, T, S, band_rows,
                           nbands, normalize);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename OutT, bool kBf>
int launch_vec(const void* in, const void* orders, const void* factors,
               const void* blur, void* out, int N, int T, int S,
               int band_rows, int nbands, int vec, int normalize,
               cudaStream_t stream) {
  if (vec)
    return launch<OutT, true, kBf>(in, orders, factors, blur, out, N, T, S,
                                   band_rows, nbands, normalize, stream);
  return launch<OutT, false, kBf>(in, orders, factors, blur, out, N, T, S,
                                  band_rows, nbands, normalize, stream);
}

template <typename OutT>
int launch_out(const void* in, const void* orders, const void* factors,
               const void* blur, void* out, int N, int T, int S,
               int band_rows, int nbands, int vec, int compute_bf16,
               int normalize, cudaStream_t stream) {
  if (compute_bf16)
    return launch_vec<OutT, true>(in, orders, factors, blur, out, N, T, S,
                                  band_rows, nbands, vec, normalize, stream);
  return launch_vec<OutT, false>(in, orders, factors, blur, out, N, T, S,
                                 band_rows, nbands, vec, normalize, stream);
}

}  // namespace

// in (N,3,T,S,S) u8; orders (N,4) i32; factors (N,4) f32; blur (N,2) f32
// (sigma, on>0); out (N,3,T,S,S) f32 (out_bf16 == 0) or bf16. All contiguous
// device pointers. band_rows rows a block, nbands = ceil(S / band_rows) <= 8
// blocks a frame (one cluster); vec != 0 when S % 4 == 0 and in is 4-byte
// aligned (4-pixel units); compute_bf16 != 0 takes the bfloat16 compute
// route. Returns the launch's CUDA error (0 = success).
extern "C" int aug_fused_launch(const void* in, const void* orders,
                                const void* factors, const void* blur,
                                void* out, int N, int T, int S, int band_rows,
                                int nbands, int vec, int out_bf16,
                                int compute_bf16, int normalize,
                                void* stream) {
  if (N <= 0 || T <= 0) return 0;
  if (out_bf16)
    return launch_out<__nv_bfloat16>(in, orders, factors, blur, out, N, T, S,
                                     band_rows, nbands, vec, compute_bf16,
                                     normalize, (cudaStream_t)stream);
  return launch_out<float>(in, orders, factors, blur, out, N, T, S,
                           band_rows, nbands, vec, compute_bf16, normalize,
                           (cudaStream_t)stream);
}
