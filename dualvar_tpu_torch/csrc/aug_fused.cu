// Fused clip augmentation for Hopper (sm_90a).
//
// Replaces the Pallas kernel dualvar_tpu/ops/aug_fused.py:_aug_kernel and
// computes the same function: per clip, uint8 -> float32 / 255; the four
// torchvision-semantics colour-jitter ops (brightness, contrast, saturation,
// hue) in the clip's own order with clip-consistent factors; a gated
// separable 13-tap Gaussian blur with edge replication (W pass, then H pass);
// ImageNet normalisation; cast to float32 or bfloat16.
//
// Two compute routes, as the JAX kernel's compute_dtype: float32 planes
// (aug_band_kernel), or bfloat16 planes (aug_bf16_band_kernel), where every
// plane value is a bfloat16 number and each op of the JAX kernel's bfloat16
// mode is rounded where it rounds: the u8 / 255 plane; each factor once an
// op; the blend's x*f, other*(1-f), their sum; the gray's three products
// and two sums (python-float weights, bfloat16 by JAX's weak typing); the
// contrast mean, summed in float32 and rounded once; hue in float32 on the
// bfloat16 planes, its result rounded; the blur's float32 passes, rounded
// once; the normalisation's product and sum. The bfloat16 route holds its
// planes as pairs of bfloat16 in one register and runs the colour chain,
// the gray and the normalisation as packed pair ops (mul.rn.bf16x2,
// add.rn.bf16x2, never an FMA): each rounds the exact result once, as the
// float32 op followed by the round to bfloat16 does. Before this design the
// route rounded every op one float at a time (a float32 op, then a
// round trip through bfloat16): 1.65x the float32 route's time, all of the
// excess in the chain and the normalisation (NVIDIA H100 80GB HBM3, 700 W:
// 0.150 against 0.091 ms at N=24, 16x112x112; the blur cost both the same).
// It stages the planes of the contrast mean in shared memory as bfloat16; a
// blurred clip's planes go to float32 planes, where the blur runs as on the
// float32 route (its W pass is float32). It evaluates hue and the blur op by
// op as the plain PyTorch version does on the card (true divisions, no
// contracted multiply-adds), so the two differ only where the contrast
// mean's float32 sum order or the blur's tap sum moves a rounding. What
// is left of its time over the float32 route's grows with the blur, whose
// taps are unfused here: 0.008 ms at N=24 with no clip blurred, 0.017
// with every other, 0.021 with all (same card, chip_smoke.py --aug-study).
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
// contracted), each rounded once; the caller rounds the result to bfloat16.
// The plain version divides all three of maxc - r, maxc - g, maxc - b by
// the chroma and keeps the two the channel holding the maximum needs (hr,
// hg or hb; the other two terms are 0, which its sum adds exactly): here
// the two numerators are chosen first and only they are divided, the same
// quotients and the same bits with one true division fewer
__device__ __forceinline__ void hue_rn(float& r, float& g, float& b,
                                       float fh) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const bool eqc = maxc == minc;
  const float cr = __fsub_rn(maxc, minc);
  const float s = __fdiv_rn(cr, eqc ? 1.0f : maxc);
  const float crd = eqc ? 1.0f : cr;
  // hr = bc - gc, hg = (2 + rc) - bc, hb = (4 + gc) - rc
  const bool is_r = maxc == r, is_g = !is_r && maxc == g;
  const float na = is_r ? b : (is_g ? r : g);
  const float nb = is_r ? g : (is_g ? b : r);
  const float base = is_r ? 0.0f : (is_g ? 2.0f : 4.0f);
  const float qa = __fdiv_rn(__fsub_rn(maxc, na), crd);
  const float qb = __fdiv_rn(__fsub_rn(maxc, nb), crd);
  float h = mod1(__fadd_rn(
      __fmul_rn(__fsub_rn(__fadd_rn(base, qa), qb), 1.0f / 6.0f), 1.0f));
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
template <int V>
__device__ __forceinline__ void pointwise_op(int op, const float (&f)[4],
                                             float (&px)[3][V]) {
  if (op == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c][i] = blend(px[c][i], 0.0f, f[0]);
  } else if (op == 2) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gr = gray(px[0][i], px[1][i], px[2][i]);
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c][i] = blend(px[c][i], gr, f[2]);
    }
  } else if (op == 3) {
#pragma unroll
    for (int i = 0; i < V; ++i) hue(px[0][i], px[1][i], px[2][i], f[3]);
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

// After phase 1, in every block of a frame's cluster: the block's gray sum
// (gsum, one a thread) reduced in a fixed order into band_sum, the blur's
// taps drawn (blurred clips); after a cluster barrier, lane b reads band
// b's sum through distributed shared memory and every lane adds them in
// band order, so all bands see the same frame mean; the taps normalised.
// Without blur the block reads no other block's shared memory after this:
// it arrives at the cluster barrier here and waits for the others before
// exiting. Returns the frame mean, the same in every block.
__device__ __forceinline__ float exchange_frame_mean(
    float gsum, float* warp_sums, float* taps, float* band_sum,
    float* frame_mean, float sigma, bool blur_on, int nbands, int P) {
  const int tid = threadIdx.x;
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
    *band_sum = total;
  }
  // exchange: every band sum of the frame is written
  cluster_arrive();
  cluster_wait();
  if (tid < 32) {
    const float mine =
        tid < nbands ? ld_cluster(cluster_addr(band_sum, tid)) : 0.0f;
    float total = 0.0f;
    for (int b = 0; b < nbands; ++b)
      total += __shfl_sync(0xffffffffu, mine, b);
    if (tid == 0) {
      *frame_mean = total * (1.0f / (float)P);
      if (blur_on) {
        float ksum = 0.0f;
        for (int j = 0; j < kTaps; ++j) ksum += taps[j];
        for (int j = 0; j < kTaps; ++j) taps[j] /= ksum;
      }
    }
  }
  if (!blur_on) cluster_arrive();
  __syncthreads();
  return *frame_mean;
}

// one tap of the blur: each product and sum rounded apart (kRn, the
// bfloat16 route, as its plain version on the card) or contracted
template <bool kRn>
__device__ __forceinline__ float tap(float acc, float k, float v) {
  if constexpr (kRn)
    return __fadd_rn(acc, __fmul_rn(k, v));
  else
    return acc + k * v;
}

// Phase 3 of a blurred clip: the separable blur of the band's rows on the
// float32 planes. The W pass in place, with clamped neighbours in the row,
// in rounds of whole rows: a thread computes one unit of each channel into
// registers, the block waits until every read of the round's rows is done,
// then writes back. A cluster barrier. The H pass of the band's rows, tap
// j of frame row y reading the W pass of frame row clamp(y - 6 + j) in the
// block that owns it, through distributed shared memory (hsrc: its
// shared::cluster address a row and tap, channel 0; the other channels'
// planes follow at the same stride in every block); each unit and channel
// goes to store(c, r, x0, acc). The block then arrives at the cluster
// barrier: it reads no other block's memory any more.
template <int V, bool kRn, typename Store>
__device__ __forceinline__ void blur_band(float* const (&plane)[3],
                                          const float* taps, uint32_t* hsrc,
                                          int S, int y0, int rows,
                                          int band_rows, Store store) {
  const int tid = threadIdx.x;
  const int upr = S / V;  // units a row
  const int units = rows * upr;
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
          for (int j = 0; j < kTaps; ++j)
            acc[c][e] = tap<kRn>(acc[c][e], k[j], v[e + j]);
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
  for (int e = tid; e < rows * kTaps; e += kThreads) {
    const int r = e / kTaps, j = e - r * kTaps;
    const int yy = min(max(y0 + r - kRadius + j, 0), S - 1);
    const int owner = yy / band_rows;
    hsrc[e] = cluster_addr(plane[0] + (yy - owner * band_rows) * S, owner);
  }
  // every band's W pass is written (and every band sum read)
  cluster_arrive();
  cluster_wait();
  const uint32_t cstride = (uint32_t)(band_rows * S) * sizeof(float);
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
        for (int e = 0; e < V; ++e) acc[e] = tap<kRn>(acc[e], k[j], q[e]);
      }
      store(c, r, x0, acc);
    }
  }
  cluster_arrive();
}

// grid: N * T * nbands blocks in clusters of nbands, block b of a cluster
// owns frame rows b * band_rows .. (b + 1) * band_rows - 1 (fewer in the
// last band). Dynamic shared memory: 3 planes of band_rows rows of S floats:
// r, g, b, which hold the W pass the cluster's blocks read for the blur's
// H pass. kVec:
// S % 4 == 0 and a 4-byte aligned input (4-pixel units, 16-byte float32
// stores, float4 shared-memory traffic). The float32 compute route.
// 5 blocks an SM: the register cap this asks for (48, a few bytes spilled)
// buys more resident warps than 64 registers at 4 blocks, which the
// colour chain's latency needs more
template <typename OutT, bool kVec>
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
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    order |= (orders[n * 4 + k] & 3) << (2 * k);
    f[k] = factors[n * 4 + k];
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
    for (int k = 0; k < c_slot; ++k)
      pointwise_op<V>((order >> (2 * k)) & 3, f, px);
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) plane[c][r * S + x0 + i] = px[c][i];
      gsum += gray(px[0][i], px[1][i], px[2][i]);
    }
  }
  const float m = exchange_frame_mean(gsum, warp_sums, taps, &band_sum,
                                      &frame_mean, sigma, blur_on, nbands, P);

  // phase 2: contrast and the ops after it, on this thread's own units
  for (int u = tid; u < units; u += kThreads) {
    const int r = u / upr, x0 = (u - r * upr) * V;
    float px[3][V];
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        px[c][i] = plane[c][r * S + x0 + i];
        if (c_slot < 4) px[c][i] = blend(px[c][i], m, f[1]);
      }
    for (int k = c_slot + 1; k < 4; ++k)
      pointwise_op<V>((order >> (2 * k)) & 3, f, px);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (blur_on) {
#pragma unroll
        for (int i = 0; i < V; ++i) plane[c][r * S + x0 + i] = px[c][i];
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          px[c][i] = px[c][i] * scale[c] + bias[c];
        store_out<V>(out + base[c] + (size_t)(y0 + r) * S + x0, px[c]);
      }
    }
  }

  if (blur_on) {
    // phase 3: the blur; the H pass normalises and stores
    auto store = [&](int c, int r, int x0, float (&acc)[V]) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = acc[e] * scale[c] + bias[c];
      store_out<V>(out + base[c] + (size_t)(y0 + r) * S + x0, acc);
    };
    blur_band<V, false>(plane, taps, hsrc, S, y0, rows, band_rows, store);
  }
  cluster_wait();  // no other block reads this one's shared memory any more
}

// ---------------------------------------------------------------------------
// bfloat16 compute route
// ---------------------------------------------------------------------------

// two bfloat16 numbers in one register, the lower half first
typedef uint32_t bf2;
constexpr bf2 kOne2 = 0x3F803F80u;  // (1, 1)

// the pair ops of the chain, each result rounded once to the nearest
// bfloat16 (ties to even). The product or sum of two bfloat16 numbers is
// exact in float32 wherever the two roundings could differ, so each equals
// the JAX kernel's float32 op followed by its rounding to bfloat16. mul.rn
// and add.rn are never contracted into an FMA, where the JAX kernel rounds
// the product and the sum apart.
__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) {
  bf2 d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) {
  bf2 d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ bf2 clip01_2(bf2 x) {
  bf2 d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(0u));
  asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(d), "r"(kOne2));
  return d;
}
// (lo, hi), each rounded to the nearest bfloat16 (ties to even)
__device__ __forceinline__ bf2 pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const bf2*>(&v);
}
__device__ __forceinline__ float lo_f(bf2 p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(bf2 p) {
  return __uint_as_float(p & 0xFFFF0000u);
}

// a clip's factors as the bfloat16 route takes them: the JAX kernel's fac()
// rounds brightness, contrast and saturation once (fb) and _blend takes 1 -
// fb in bfloat16 (omf); hue's factor stays float32
struct PairFactors {
  bf2 fb[3], omf[3];
  bf2 gw[3];  // the gray's weights
  float fh;
};

__device__ __forceinline__ bf2 blend2(bf2 x, bf2 other, bf2 fb, bf2 omf) {
  return clip01_2(add2(mul2(x, fb), mul2(other, omf)));
}

// torchvision's gray on bfloat16 planes: three products and two sums, each
// rounded (the weights are python floats: bfloat16 by JAX's weak typing)
__device__ __forceinline__ bf2 gray2(const PairFactors& F, bf2 r, bf2 g,
                                     bf2 b) {
  return add2(add2(mul2(F.gw[0], r), mul2(F.gw[1], g)), mul2(F.gw[2], b));
}

// One pointwise op (0 brightness, 2 saturation, 3 hue) on a unit's NP
// pairs. Brightness blends with zeros: bf16(x fb) + 0 * omf is bf16(x fb),
// so the pair route takes the product alone. Hue runs in float32 on the
// pair's two pixels (kBoth: the upper half holds a pixel), its result
// rounded.
template <int NP, bool kBoth>
__device__ __forceinline__ void pointwise_op2(int op, const PairFactors& F,
                                              bf2 (&px)[3][NP]) {
  if (op == 0) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c][i] = clip01_2(mul2(px[c][i], F.fb[0]));
  } else if (op == 2) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bf2 gr = gray2(F, px[0][i], px[1][i], px[2][i]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        px[c][i] = blend2(px[c][i], gr, F.fb[2], F.omf[2]);
    }
  } else if (op == 3) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float r0 = lo_f(px[0][i]), g0 = lo_f(px[1][i]), b0 = lo_f(px[2][i]);
      hue_rn(r0, g0, b0, F.fh);
      if constexpr (kBoth) {
        float r1 = hi_f(px[0][i]), g1 = hi_f(px[1][i]), b1 = hi_f(px[2][i]);
        hue_rn(r1, g1, b1, F.fh);
        px[0][i] = pack2(r0, r1);
        px[1][i] = pack2(g0, g1);
        px[2][i] = pack2(b0, b1);
      } else {
        px[0][i] = pack2(r0, 0.0f);
        px[1][i] = pack2(g0, 0.0f);
        px[2][i] = pack2(b0, 0.0f);
      }
    }
  }
}

// a unit's NP pairs of one channel to the output, as float32 or bfloat16
template <int NP, bool kBoth>
__device__ __forceinline__ void store_pairs(float* p, const bf2 (&v)[NP]) {
  if constexpr (kBoth) {
#pragma unroll
    for (int i = 0; i < NP; i += 2)
      *reinterpret_cast<float4*>(p + 2 * i) =
          make_float4(lo_f(v[i]), hi_f(v[i]), lo_f(v[i + 1]), hi_f(v[i + 1]));
  } else {
    p[0] = lo_f(v[0]);
  }
}
template <int NP, bool kBoth>
__device__ __forceinline__ void store_pairs(__nv_bfloat16* p,
                                            const bf2 (&v)[NP]) {
  if constexpr (kBoth) {
#pragma unroll
    for (int i = 0; i < NP; i += 2)
      *reinterpret_cast<uint2*>(p + 2 * i) = make_uint2(v[i], v[i + 1]);
  } else {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)(v[0] & 0xFFFFu);
  }
}

// a unit's NP pairs of one channel in a bfloat16 plane of shared memory
template <int NP, bool kBoth>
__device__ __forceinline__ void load_plane(const __nv_bfloat16* p,
                                           bf2 (&v)[NP]) {
  if constexpr (kBoth) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}
template <int NP, bool kBoth>
__device__ __forceinline__ void store_plane(__nv_bfloat16* p,
                                            const bf2 (&v)[NP]) {
  if constexpr (kBoth) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)(v[0] & 0xFFFFu);
  }
}

// The bfloat16 compute route: the float32 route's bands, cluster and
// phases, with every plane value a bfloat16 number held in pairs. A unit's
// 4 pixels (kVec) are 2 pairs a channel, and the colour chain, the gray and
// the normalisation are pair ops (mul2, add2, clip01_2): one instruction
// for two pixels where the float32 chain rounded each op's result back to
// bfloat16 one value at a time. The planes staged for the contrast mean
// are bfloat16 (plane_b); a blurred clip's chain result goes to plane_f as
// float32, where the blur runs as on the float32 route, its W pass in place
// and its H pass reading the cluster's rows; both passes and hue run in
// float32 op by op as the plain version does on the card (__fmul_rn /
// __fadd_rn, true divisions).
// Without kVec a unit is one pixel in the lower half of a pair.
// Dynamic shared memory: plane_b, 3 planes of band_rows x S bfloat16, then
// plane_f, 3 planes of band_rows x S floats (16-byte aligned): 28.2 KB a
// block at 14 x 112 against the float32 route's 18.8 KB, since the size is
// the launch's and plane_f is there for every block, blurred or not. With
// the static arrays (1.8 KB) and the 1 KB the card reserves a block, 6
// blocks take 186 KB of an SM's 228 KB: the registers, not the shared
// memory, set how many blocks reside.
// 6 blocks an SM (40 registers, some spilled), chosen over 5 (48) and 4
// (64, no spills) by timing each on an H100: the chain's latency wants
// resident warps
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads, 6)
aug_bf16_band_kernel(const uint8_t* __restrict__ in,
                     const int32_t* __restrict__ orders,
                     const float* __restrict__ factors,
                     const float* __restrict__ blur, OutT* __restrict__ out,
                     int T, int S, int band_rows, int nbands, int normalize) {
  constexpr int V = kVec ? 4 : 1;  // pixels a unit
  constexpr int NP = kVec ? 2 : 1;  // pairs a unit and channel
  extern __shared__ float4 smem4[];
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float taps[kTaps];
  __shared__ float band_sum;  // read by every block of the cluster
  __shared__ float frame_mean;
  __shared__ uint32_t hsrc[kMaxBandRows * kTaps];

  const int band = blockIdx.x % nbands;  // the block's rank in its cluster
  const int frame = blockIdx.x / nbands;
  const int n = frame / T, t = frame % T;
  const int tid = threadIdx.x;
  const int P = S * S;
  const int y0 = band * band_rows;
  const int rows = min(band_rows, S - y0);

  int order = 0;
  PairFactors F;
#pragma unroll
  for (int k = 0; k < 4; ++k) order |= (orders[n * 4 + k] & 3) << (2 * k);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f = factors[n * 4 + k];
    F.fb[k] = pack2(f, f);
    const float omf = 1.0f - lo_f(F.fb[k]);
    F.omf[k] = pack2(omf, omf);
  }
  F.fh = factors[n * 4 + 3];
  F.gw[0] = pack2(kGrayR, kGrayR);
  F.gw[1] = pack2(kGrayG, kGrayG);
  F.gw[2] = pack2(kGrayB, kGrayB);
  const float sigma = blur[n * 2 + 0];
  const bool blur_on = blur[n * 2 + 1] > 0.0f;  // the same in the cluster
  int c_slot = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (((order >> (2 * k)) & 3) == 1) c_slot = k;

  const int plane_size = band_rows * S;
  __nv_bfloat16* plane_b[3];
  float* plane_f[3];
  {
    __nv_bfloat16* b0 = reinterpret_cast<__nv_bfloat16*>(smem4);
    float* f0 = reinterpret_cast<float*>(
        reinterpret_cast<uint8_t*>(smem4) +
        ((3 * plane_size * sizeof(__nv_bfloat16) + 15) & ~(size_t)15));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      plane_b[c] = b0 + c * plane_size;
      plane_f[c] = f0 + c * plane_size;
    }
  }

  size_t base[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    base[c] = ((size_t)(n * 3 + c) * T + t) * (size_t)P;

  // ImageNet mean / std as python floats in bfloat16 ops: rounded once
  bf2 scale[3], bias[3];
  {
    const float sc[3] = {(float)(1.0 / 0.229), (float)(1.0 / 0.224),
                         (float)(1.0 / 0.225)};
    const float bi[3] = {(float)(-0.485 / 0.229), (float)(-0.456 / 0.224),
                         (float)(-0.406 / 0.225)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      scale[c] = normalize ? pack2(sc[c], sc[c]) : kOne2;
      bias[c] = normalize ? pack2(bi[c], bi[c]) : 0u;
    }
  }

  // phase 1: load, ops before contrast, stage, gray sum of the band
  const int upr = S / V;  // units a row
  const int units = rows * upr;
  float gsum = 0.0f;
  for (int u = tid; u < units; u += kThreads) {
    const int r = u / upr, x0 = (u - r * upr) * V;
    bf2 px[3][NP];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v[V];
      load_u8<V>(in + base[c] + (size_t)(y0 + r) * S + x0, v);
      if constexpr (kVec) {
        px[c][0] = pack2(v[0], v[1]);
        px[c][1] = pack2(v[2], v[3]);
      } else {
        px[c][0] = pack2(v[0], 0.0f);
      }
    }
    for (int k = 0; k < c_slot; ++k)
      pointwise_op2<NP, kVec>((order >> (2 * k)) & 3, F, px);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      store_plane<NP, kVec>(plane_b[c] + r * S + x0, px[c]);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bf2 g = gray2(F, px[0][i], px[1][i], px[2][i]);
      gsum += lo_f(g);
      if constexpr (kVec) gsum += hi_f(g);
    }
  }
  // the mean rounded once to bfloat16
  const float mean = exchange_frame_mean(gsum, warp_sums, taps, &band_sum,
                                         &frame_mean, sigma, blur_on, nbands,
                                         P);
  const bf2 m = pack2(mean, mean);

  // phase 2: contrast and the ops after it, on this thread's own units
  for (int u = tid; u < units; u += kThreads) {
    const int r = u / upr, x0 = (u - r * upr) * V;
    bf2 px[3][NP];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      load_plane<NP, kVec>(plane_b[c] + r * S + x0, px[c]);
      if (c_slot < 4)
#pragma unroll
        for (int i = 0; i < NP; ++i)
          px[c][i] = blend2(px[c][i], m, F.fb[1], F.omf[1]);
    }
    for (int k = c_slot + 1; k < 4; ++k)
      pointwise_op2<NP, kVec>((order >> (2 * k)) & 3, F, px);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (blur_on) {
        store_pairs<NP, kVec>(plane_f[c] + r * S + x0, px[c]);
      } else {
#pragma unroll
        for (int i = 0; i < NP; ++i)
          px[c][i] = add2(mul2(px[c][i], scale[c]), bias[c]);
        store_pairs<NP, kVec>(out + base[c] + (size_t)(y0 + r) * S + x0,
                              px[c]);
      }
    }
  }

  if (blur_on) {
    // phase 3: the blur in float32 on plane_f, as the float32 route runs
    // it, each tap's product and sum rounded apart; the H pass rounds its
    // result to bfloat16 and normalises it as pairs
    auto store = [&](int c, int r, int x0, float (&acc)[V]) {
      bf2 px[NP];
      if constexpr (kVec) {
        px[0] = pack2(acc[0], acc[1]);
        px[1] = pack2(acc[2], acc[3]);
      } else {
        px[0] = pack2(acc[0], 0.0f);
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
        px[i] = add2(mul2(px[i], scale[c]), bias[c]);
      store_pairs<NP, kVec>(out + base[c] + (size_t)(y0 + r) * S + x0, px);
    };
    blur_band<V, true>(plane_f, taps, hsrc, S, y0, rows, band_rows, store);
  }
  cluster_wait();
}

// dynamic shared memory a block of the bfloat16 route: plane_b, then
// plane_f 16-byte aligned
size_t bf16_smem(int band_rows, int S) {
  const size_t plane = (size_t)band_rows * S;
  return ((3 * plane * sizeof(__nv_bfloat16) + 15) & ~(size_t)15) +
         3 * plane * sizeof(float);
}

template <typename OutT, bool kVec, bool kBf>
int launch(const void* in, const void* orders, const void* factors,
           const void* blur, void* out, int N, int T, int S, int band_rows,
           int nbands, int normalize, cudaStream_t stream) {
  auto kernel = kBf ? aug_bf16_band_kernel<OutT, kVec>
                    : aug_band_kernel<OutT, kVec>;
  const size_t smem = kBf ? bf16_smem(band_rows, S)
                          : (size_t)3 * band_rows * S * sizeof(float);
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
