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
// with x (N, T, H, W, C) and y (N, T, H, W, Co) channels-last, w used in x's
// dtype, float32 accumulation, and the sums taken from y AFTER it is rounded
// to the output dtype, as the TPU kernel does.
//
// Bound: operations (2*27*C*Co per output position; at the R3D layer-1 shape
// (16, 16, 56, 56, 64) that is 1.78e11 against 206 MB of x and y in bf16):
// on the bf16 tensor cores for bf16 x, and three times that on the TF32
// tensor cores for float32 x (below).
//
// Two routes, chosen by the wrapper (ops/conv_fused.py) from x's dtype:
//
// bfloat16 x: an implicit GEMM on the tensor cores (conv3d_bn_stats_tc_*).
//   M = output channels (a block's 64), N = output positions, K = 27 * C.
//   The GEMM is computed transposed (D[co][position] = W . X^T) so that one
//   wgmma m64n256k16 covers 4 output rows x 64 w of a warpgroup: each
//   instruction reads 2 KB of weights and 8 KB of x from shared memory for
//   0.5 MFLOP, where the m64n64 shape of the untransposed product would read
//   as much shared memory as the tensor cores can consume.
//   - a block owns 8 output rows (h) x 64 w of one (n, t) and 64 output
//     channels; warpgroups 0 and 1 each hold a 64 x 256 float32 accumulator
//     (128 registers a thread), warpgroup 2 is the producer;
//   - a K-step is one (64-channel chunk, dt, dw): ONE tiled TMA load of x
//     fetches the band and its halo, 10 h rows x 64 w x 64 channels with the
//     128-byte swizzle, at (c0, w0 + dw - 1, h0 - 1, t + dt - 1, n); TMA
//     fills coordinates outside x with zeros, so SAME padding needs no
//     padded copy. The three dh taps are offsets of whole h rows (8 KB) into
//     that box, which keeps the swizzle atoms aligned: 9 loads feed 27 taps.
//     Taps of frames outside the clip are skipped. A second TMA load brings
//     the weights of the three (dt, dh, dw) taps from the wrapper's packed
//     bf16 (27, Co_pad, C_pad) weight, taps ordered (dt, dw, dh);
//   - a ring of 2 stages of 104 KB with full / empty mbarriers; a consumer
//     waits for its 12 wgmma of a stage before it frees the stage, while the
//     other consumer's keep the tensor cores busy;
//   - epilogue: the accumulators are rounded to bf16 into a shared-memory
//     tile, y is stored with 16-byte stores (positions w >= W, h >= H and
//     channels >= Co masked), and the block's per-channel sums of the
//     ROUNDED values go to its own partial slot in a fixed order.
//   What bounds it: the box and weights come from L2 once a (chunk, dt, dw)
//   (104 KB for 8 x 64 x 64 x 27 x 64 x 2 operations), which at the card's
//   L2 rate is close to the tensor cores' time; x itself is read from device
//   memory about once.
//
// float32 x: split TF32 on the tensor cores (conv3d_bn_stats_f32_*), the
//   same implicit GEMM untransposed (D[position][co] = X . W^T, M = 64 w of
//   an output row, N = 64 output channels, K = 27 * C). One TF32 product
//   keeps 11 bits, which over K = 1728 terms puts y about 1e-3 from a
//   float32 conv, ten times the float32 tolerance; so each operand is split
//   into two tf32 numbers, hi = nearest tf32 and lo = nearest tf32 of the
//   rest, and y accumulates x_lo w_hi + x_hi w_lo + x_hi w_hi (the lo * lo
//   term is below float32's precision): about 22 bits a product, at three
//   times bf16's operations on a tensor-core rate half of bf16's. The
//   wrapper splits and packs the weight once a call (hi taps, then lo taps);
//   x is split in registers, so it is wgmma's register operand (A), and the
//   weight the shared-memory one:
//   - a block owns 4 output rows x 64 w of one (n, t) and 64 output
//     channels; warpgroups 0 and 1 each own 2 rows (two 64 x 64 float32
//     accumulators, 64 registers a thread), warpgroup 2 is the producer;
//   - a K-step is one (32-channel chunk, dt, dw): one TMA box of x, 6 h rows
//     x 64 w x 32 channels (128 bytes a position, the 128-byte swizzle; zero
//     fill for SAME padding and a ragged C), and the hi and lo weights of
//     the three dh taps; a ring of 2 stages of 96 KB;
//   - per half chunk and output row, the consumer loads its three box rows
//     into A fragments with 16-byte shared loads, splits them, and runs 18
//     wgmma m64n64k8 into a fresh accumulator, small products first, which
//     it then adds to the row's accumulator (see the kernel for why);
//   - epilogue: y stored as pairs of channels straight from the
//     accumulators (8-byte stores, positions w >= W, h >= H masked), the
//     block's per-channel sums of y in a fixed order.
//   Why not the bf16 route's shape (x as the shared-memory operand, 8 rows a
//   block): the tf32 operands from shared memory would need x_lo beside the
//   box, 208 KB a stage at 8 rows, one stage only.
//
// The statistics are where the TPU kernel went wrong (revisited-output
// accumulation across its 2-D grid). Here nothing is accumulated across
// blocks: each block writes its per-channel partials to its own slot, and a
// second kernel adds a channel's partials in a fixed order, so the result is
// the same from run to run and does not depend on how blocks are scheduled.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing.

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the statistics kernel

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

// ---------------------------------------------------------------------------
// bfloat16 route: the implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcC = 64;     // input channels a K-step: 128 bytes, one swizzle row
constexpr int kTcW = 64;     // output w positions of a band row
constexpr int kTcCo = 64;    // output channels a block: the wgmma M
constexpr int kTcRowsWG = 4; // output rows a consumer warpgroup: wgmma N = 256
constexpr int kTcConsumers = 2;
constexpr int kTcRows = kTcRowsWG * kTcConsumers;  // output rows a block: 8
constexpr int kTcStages = 2;
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kRowBytes = kTcW * kTcC * 2;            // one h row of a box
constexpr int kXBytes = (kTcRows + 2) * kRowBytes;    // the box: band + halo
constexpr int kWTapBytes = kTcCo * kTcC * 2;          // one tap's weights
constexpr int kWBytes = 3 * kWTapBytes;               // the three dh taps
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kTcSmem = kTcStages * kStageBytes + 1024;  // + 1024-B alignment
// the epilogue's bf16 tile, (kTcRows * kTcW positions, kTcCo channels),
// rows padded to 72 values so that a warp's stores spread over the banks
constexpr int kTileStride = kTcCo + 8;
static_assert(kTcRows * kTcW * kTileStride * 2 <= kStageBytes,
              "the epilogue tile reuses stage 0");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity ``parity`` of the barrier has completed. A
// wait of more than about 4e9 cycles (seconds) can only be a fault (a load
// that never lands): trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// TMA tiled loads into shared memory, completing on ``bar``; coordinates
// innermost first, negative or past the end -> zeros
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes (64 bf16 of K), 8-row groups 1024
// bytes apart. Advancing K by 16 values inside the row adds 32 bytes to the
// start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset: 8 rows
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x 256, float32) += a (64 x 16) * b (256 x 16)^T, both bf16 K-major
// in shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// One block: output channels co0..co0+63 of rows h0..h0+7, w0..w0+63 of one
// (n, t). Warpgroups 0 and 1 consume (rows 4g..4g+3 each), warpgroup 2 is
// the producer (one thread issues the TMA loads).
//
// K-steps, in the same order on both sides: for each 64-channel chunk c0,
// each dt whose frame t + dt - 1 exists, each dw: ONE box of x, rows h0 - 1
// .. h0 + 8 (10 h rows) x w0 + dw - 1 .. w0 + dw + 62 x 64 channels, and the
// weights of the three taps (dt, dh, dw), dh = 0, 1, 2, which are adjacent
// in the packed weight (taps ordered (dt, dw, dh)). Output row r with tap dh
// reads box row r + dh: an offset of whole 8192-byte rows, so the 128-byte
// swizzle atoms (1024 bytes) stay aligned and one descriptor per (dh, k16)
// serves all 256 positions of the warpgroup's 4 rows.
//
// partial: (2, Co, gridDim.x) float32, this block's per-channel sums of the
// rounded y over its valid positions.
__global__ void __launch_bounds__(kTcThreads, 1)
conv3d_bn_stats_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          __nv_bfloat16* __restrict__ y,
                          float* __restrict__ partial, int Tn, int H, int W,
                          int Co, int nchunk) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kTcStages];
  __shared__ __align__(8) uint64_t empty_bar[kTcStages];
  __shared__ float red[2][4][kTcCo];
  // stages of (box, weights), 1024-byte aligned for the swizzle
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);

  const int nwt = (W + kTcW - 1) / kTcW;
  const int nhb = (H + kTcRows - 1) / kTcRows;
  int blk = blockIdx.x;
  const int wt = blk % nwt;
  blk /= nwt;
  const int hb = blk % nhb;
  blk /= nhb;
  const int t = blk % Tn;
  const int n = blk / Tn;
  const int h0 = hb * kTcRows, w0 = wt * kTcW, co0 = blockIdx.y * kTcCo;
  // frames t + dt - 1 outside the clip contribute zeros: skip their taps
  const int dt_lo = t == 0 ? 1 : 0;
  const int dt_hi = t == Tn - 1 ? 1 : 2;
  const int ndt = dt_hi - dt_lo + 1;
  const int nsteps = nchunk * ndt * 3;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kTcConsumers * 4);  // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kTcConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == kTcConsumers * 128) {
      for (int s = 0; s < nsteps; ++s) {
        const int stage = s % kTcStages;
        mbar_wait(&empty_bar[stage], ((s / kTcStages) & 1) ^ 1);
        const int dw = s % 3;
        const int dt = dt_lo + (s / 3) % ndt;
        const int c0 = (s / (3 * ndt)) * kTcC;
        uint8_t* xs = smem + stage * kStageBytes;
        mbar_expect_tx(&full_bar[stage], kStageBytes);
        tma_load_5d(xs, &xmap, &full_bar[stage], c0, w0 + dw - 1, h0 - 1,
                    t + dt - 1, n);
        tma_load_3d(xs + kXBytes, &wmap, &full_bar[stage], c0, co0,
                    (dt * 3 + dw) * 3);
      }
    }
  } else {
    // consumers: warpgroup wg owns output rows h0 + 4 wg .. h0 + 4 wg + 3
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int s = 0; s < nsteps; ++s) {
      const int stage = s % kTcStages;
      mbar_wait(&full_bar[stage], (s / kTcStages) & 1);
      const uint32_t xs =
          smem_u32(smem + stage * kStageBytes) + wg * kTcRowsWG * kRowBytes;
      const uint32_t ws = smem_u32(smem + stage * kStageBytes + kXBytes);
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int k = 0; k < kTcC / 16; ++k)
          wgmma_m64n256k16(acc, sw128_desc(ws + dh * kWTapBytes + k * 32),
                           sw128_desc(xs + dh * kRowBytes + k * 32));
      wgmma_commit();
      // this stage's products are done before the next K-step: its buffers
      // may refill while the other consumer keeps the tensor cores busy.
      // (Keeping one group in flight across iterations, wait_group 1, lost
      // the last K-step's products: the compiler copied the accumulators
      // before the asynchronous write landed.)
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
      if (tid % 32 == 0) mbar_arrive(&empty_bar[stage]);
    }

    // epilogue. Every load has landed and every product is done once both
    // consumers are here, so stage 0 holds the rounded tile.
    asm volatile("bar.sync 1, %0;" ::"n"(kTcConsumers * 128) : "memory");
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
    const int warp = (tid / 32) % 4, lane = tid % 32;
    // accumulator i of this thread: channel 16 warp + lane / 4 + 8 (i / 2 %
    // 2), position 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 256
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const int co = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int p = wg * 256 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      tile[p * kTileStride + co] = __float2bfloat16_rn(acc[i]);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kTcConsumers * 128) : "memory");

    // y: 16-byte stores of 8 channels, positions w < W and h < H only
    const int ctid = tid;  // 0 .. 255
    for (int e = ctid; e < kTcRows * kTcW * (kTcCo / 8);
         e += kTcConsumers * 128) {
      const int p = e / (kTcCo / 8), ch = e % (kTcCo / 8);
      const int h = h0 + p / kTcW, w = w0 + p % kTcW, co = co0 + ch * 8;
      if (h < H && w < W && co < Co)
        *reinterpret_cast<uint4*>(
            y + ((((int64_t)n * Tn + t) * H + h) * W + w) * Co + co) =
            *reinterpret_cast<const uint4*>(tile + p * kTileStride + ch * 8);
    }
    // per-channel sums of the rounded values, in a fixed order: four
    // quarters of the positions, then the quarters in order
    const int c = ctid % kTcCo, q = ctid / kTcCo;
    float t1 = 0.0f, t2 = 0.0f;
    const int per_q = kTcRows * kTcW / 4;
    for (int p = q * per_q; p < (q + 1) * per_q; ++p) {
      const int h = h0 + p / kTcW, w = w0 + p % kTcW;
      if (h < H && w < W) {
        const float r = __bfloat162float(tile[p * kTileStride + c]);
        t1 += r;
        t2 = fmaf(r, r, t2);
      }
    }
    red[0][q][c] = t1;
    red[1][q][c] = t2;
    asm volatile("bar.sync 1, %0;" ::"n"(kTcConsumers * 128) : "memory");
    if (ctid < kTcCo && co0 + ctid < Co) {
      const int64_t ch = co0 + ctid;
      partial[ch * gridDim.x + blockIdx.x] =
          red[0][0][ctid] + red[0][1][ctid] + red[0][2][ctid] + red[0][3][ctid];
      partial[((int64_t)Co + ch) * gridDim.x + blockIdx.x] =
          red[1][0][ctid] + red[1][1][ctid] + red[1][2][ctid] + red[1][3][ctid];
    }
  }
}

// ---------------------------------------------------------------------------
// float32 route: split-TF32 implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kFC = 32;        // input channels a K-step: 128 bytes, one swizzle row
constexpr int kFW = 64;        // output w positions of a box row: the wgmma M
constexpr int kFCo = 64;       // output channels a block: the wgmma N
constexpr int kFRowsWG = 2;    // output rows a consumer warpgroup
constexpr int kFConsumers = 2;
constexpr int kFRows = kFRowsWG * kFConsumers;  // output rows a block: 4
constexpr int kFStages = 2;
constexpr int kFThreads = 128 * (kFConsumers + 1);
constexpr int kFRowBytes = kFW * kFC * 4;             // one h row of a box
constexpr int kFXBytes = (kFRows + 2) * kFRowBytes;   // the box: band + halo
constexpr int kFWTapBytes = kFCo * kFC * 4;           // one tap's weights
constexpr int kFWBytes = 2 * 3 * kFWTapBytes;         // 3 dh taps, hi and lo
constexpr int kFStageBytes = kFXBytes + kFWBytes;
constexpr int kFSmem = kFStages * kFStageBytes + 1024;  // + 1024-B alignment
static_assert(kFSmem <= 232448, "two stages fit a block's shared memory");

// the tf32 number nearest to x (ties away from zero), as a float32 bit
// pattern with its 13 low mantissa bits zero: the bit rule the wrapper's
// split of the weight uses too (ops/conv_fused.py:_tf32)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 64, float32) = a (64 x 8, tf32 in registers) * b (64 x 8)^T (tf32,
// K-major in shared memory) + (scale_d ? d : 0). a: this thread's a0..a3,
// rows 16 warp + lane/4 (+8 for a1, a3), columns lane%4 (+4 for a2, a3) of
// the warpgroup's tile
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// One block: output channels co0..co0+63 of rows h0..h0+3, w0..w0+63 of one
// (n, t). Warpgroups 0 and 1 consume (rows 2g, 2g+1 each), warpgroup 2 is
// the producer (one thread issues the TMA loads).
//
// K-steps, in the same order on both sides: for each 32-channel chunk c0,
// each dt whose frame t + dt - 1 exists, each dw: ONE box of x, rows h0 - 1
// .. h0 + 4 (6 h rows) x w0 + dw - 1 .. w0 + dw + 62 x 32 channels, and the
// hi and lo weights of the three taps (dt, dh, dw), dh = 0, 1, 2. Output row
// r with tap dh reads box row r + dh.
//
// x is the register operand: for each half of a stage's chunk (two K-steps
// of 8) and each of its output rows, a consumer reads the row's three box
// rows straight into wgmma's A layout (two 16-byte loads a row and thread),
// splits each value into x_hi = tf32_rna(x) and x_lo = tf32_rna(x - x_hi)
// in registers, and runs one chain of wgmma into a fresh accumulator
// ``part``: the 12 small products (x_lo w_hi, x_hi w_lo) of the two K-steps
// and three dh taps first, then the 6 large ones (x_hi w_hi). ``part`` is
// then added to the row's accumulator on the CUDA cores. The tensor cores
// add each product group to their accumulator with truncation toward zero,
// so 648 chained groups (K = 1728) drifted y by up to 7e-5 and its sum of
// squares by 1e-5 relative; a chain of 18 whose small terms come first
// truncates only against the half-chunk's partial sum, which the float32
// add then rounds to nearest. A thread's 16-byte load covers channels 8
// (lane % 4) + 4 half .. + 3 of one position, so K-step k8 = 2 half + s of a
// chunk takes channel 8 j + 2 k8 into column j < 4 and 8 (j - 4) + 2 k8 + 1
// into column j >= 4: the wrapper packs the weight's channels in that order
// (ops/conv_fused.py:_f32_k_order), so the products are the convolution's.
// With the 128-byte swizzle, the eight lanes of each quarter-warp load hit
// eight different 16-byte bank groups.
//
// partial: (2, Co, gridDim.x) float32, this block's per-channel sums of y
// over its valid positions.
__global__ void __launch_bounds__(kFThreads, 1)
conv3d_bn_stats_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           float* __restrict__ y, float* __restrict__ partial,
                           int Tn, int H, int W, int Co, int nchunk) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kFStages];
  __shared__ __align__(8) uint64_t empty_bar[kFStages];
  __shared__ float red[2][kFConsumers * 4][kFCo];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);

  const int nwt = (W + kFW - 1) / kFW;
  const int nhb = (H + kFRows - 1) / kFRows;
  int blk = blockIdx.x;
  const int wt = blk % nwt;
  blk /= nwt;
  const int hb = blk % nhb;
  blk /= nhb;
  const int t = blk % Tn;
  const int n = blk / Tn;
  const int h0 = hb * kFRows, w0 = wt * kFW, co0 = blockIdx.y * kFCo;
  const int dt_lo = t == 0 ? 1 : 0;
  const int dt_hi = t == Tn - 1 ? 1 : 2;
  const int ndt = dt_hi - dt_lo + 1;
  const int nsteps = nchunk * ndt * 3;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kFConsumers * 4);  // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kFConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == kFConsumers * 128) {
      for (int s = 0; s < nsteps; ++s) {
        const int stage = s % kFStages;
        mbar_wait(&empty_bar[stage], ((s / kFStages) & 1) ^ 1);
        const int dw = s % 3;
        const int dt = dt_lo + (s / 3) % ndt;
        const int c0 = (s / (3 * ndt)) * kFC;
        uint8_t* xs = smem + stage * kFStageBytes;
        const int tap = (dt * 3 + dw) * 3;
        mbar_expect_tx(&full_bar[stage], kFStageBytes);
        tma_load_5d(xs, &xmap, &full_bar[stage], c0, w0 + dw - 1, h0 - 1,
                    t + dt - 1, n);
        tma_load_3d(xs + kFXBytes, &wmap, &full_bar[stage], c0, co0, tap);
        tma_load_3d(xs + kFXBytes + 3 * kFWTapBytes, &wmap, &full_bar[stage],
                    c0, co0, 27 + tap);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows h0 + 2 wg, h0 + 2 wg + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int p0 = 16 * warp + g;  // positions p0 and p0 + 8 of the box row
  float acc[kFRowsWG][32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    part[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < kFRowsWG; ++r) acc[r][i] = 0.0f;
  }

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s % kFStages;
    mbar_wait(&full_bar[stage], (s / kFStages) & 1);
    const uint32_t xs = smem_u32(smem + stage * kFStageBytes) +
                        wg * kFRowsWG * kFRowBytes;
    const uint32_t ws = smem_u32(smem + stage * kFStageBytes + kFXBytes);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t chunk = (uint32_t)(((2 * q + half) ^ g) << 4);
#pragma unroll
      for (int r = 0; r < kFRowsWG; ++r) {
        // A fragments of box rows r + dh for K-steps 2 half and 2 half + 1
        uint32_t hi[3][2][4], lo[3][2][4];
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const uint32_t row = xs + (r + dh) * kFRowBytes + chunk;
          const float4 v0 = lds128(row + p0 * 128);
          const float4 v1 = lds128(row + (p0 + 8) * 128);
          const float v[2][4] = {{v0.x, v1.x, v0.y, v1.y},
                                 {v0.z, v1.z, v0.w, v1.w}};
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              hi[dh][k][i] = tf32_rna(v[k][i]);
              lo[dh][k][i] =
                  tf32_rna(v[k][i] - __uint_as_float(hi[dh][k][i]));
            }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(part[i]);
        wgmma_fence();
        // part = this (row, half)'s 24 K terms: the small products first,
        // from zero, then the large ones
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const uint32_t koff = (uint32_t)(2 * half + k) * 32;
            wgmma_tf32_m64n64k8(part, lo[dh][k],
                                sw128_desc(ws + dh * kFWTapBytes + koff),
                                k + dh > 0);
            wgmma_tf32_m64n64k8(part, hi[dh][k],
                                sw128_desc(ws + (3 + dh) * kFWTapBytes + koff),
                                1);
          }
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const uint32_t koff = (uint32_t)(2 * half + k) * 32;
            wgmma_tf32_m64n64k8(part, hi[dh][k],
                                sw128_desc(ws + dh * kFWTapBytes + koff), 1);
          }
        wgmma_commit();
        // the fragments are read and the products done before the
        // registers are reused (see the bfloat16 kernel on keeping a group
        // in flight)
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(part[i]);
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fence_operand(hi[dh][k][i]);
              fence_operand(lo[dh][k][i]);
            }
        // the tensor cores add a product group to their accumulator with
        // truncation; summed into the row's accumulator here, each group's
        // sum is rounded to nearest once
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[r][i] += part[i];
      }
    }
    if (lane == 0) mbar_arrive(&empty_bar[stage]);
  }

  // epilogue: accumulator i of this thread is position p0 + 8 ((i >> 1) &
  // 1), channel 8 (i >> 2) + 2 q + (i & 1); pairs of channels are stored as
  // 8-byte stores, and summed in a fixed order
  float s1[16], s2[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s1[j] = s2[j] = 0.0f;
#pragma unroll
  for (int r = 0; r < kFRowsWG; ++r) {
    const int h = h0 + wg * kFRowsWG + r;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int w = w0 + p0 + 8 * ((i >> 1) & 1);
      const int co = co0 + 8 * (i >> 2) + 2 * q;
      if (h < H && w < W && co < Co) {
        const float a = acc[r][i], b = acc[r][i + 1];
        *reinterpret_cast<float2*>(
            y + ((((int64_t)n * Tn + t) * H + h) * W + w) * Co + co) =
            make_float2(a, b);
        const int j = 2 * (i >> 2);
        s1[j] += a;
        s2[j] = fmaf(a, a, s2[j]);
        s1[j + 1] += b;
        s2[j + 1] = fmaf(b, b, s2[j + 1]);
      }
    }
  }
  // the 8 lanes of a channel group (same q) in a fixed tree, then the
  // warps of both consumers in order
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
    }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * (j >> 1) + 2 * q + (j & 1);
      red[0][wg * 4 + warp][c] = s1[j];
      red[1][wg * 4 + warp][c] = s2[j];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kFConsumers * 128) : "memory");
  if (tid < kFCo && co0 + tid < Co) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int k = 0; k < kFConsumers * 4; ++k) {
      t1 += red[0][k][tid];
      t2 += red[1][k][tid];
    }
    const int64_t ch = co0 + tid;
    partial[ch * gridDim.x + blockIdx.x] = t1;
    partial[((int64_t)Co + ch) * gridDim.x + blockIdx.x] = t2;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// this library need not link libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// tensor map of ``dtype`` with the 128-byte swizzle; dims and box innermost
// first, strides in bytes of dims 1.. ; returns its CUresult
CUresult encode_map(CUtensorMap* map, CUtensorMapDataType dtype,
                    const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// bfloat16 route. x (N, T, H, W, C) bf16 contiguous, 16-byte aligned, C % 8
// == 0; wp the packed weight, bf16 (27, co_pad, 64 * nchunk) contiguous,
// taps ordered (dt, dw, dh), zero where c >= C or o >= Co; y (N, T, H, W,
// Co) bf16, Co % 8 == 0; co_pad a multiple of 64. partial: float32 (2, Co,
// N * T * ceil(H / 8) * ceil(W / 64)) scratch; s1, s2: float32 (Co,).
// Returns 0, a CUDA runtime error, or 100000 + the CUresult of
// encoding a tensor map.
extern "C" int conv3d_bn_stats_tc_launch(const void* x, const void* wp,
                                         void* y, float* partial, float* s1,
                                         float* s2, int N, int Tn, int H,
                                         int W, int C, int Co, int co_pad,
                                         int nchunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CUtensorMap xmap, wmap;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t xdims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)Tn, (cuuint64_t)N};
  const cuuint64_t xstrides[4] = {e * C, e * C * W, e * C * W * H,
                                  e * C * W * H * Tn};
  const cuuint32_t xbox[5] = {kTcC, kTcW, kTcRows + 2, 1, 1};
  CUresult r = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 5, xdims, xstrides, xbox);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;
  const cuuint64_t cpad = (cuuint64_t)nchunk * kTcC;
  const cuuint64_t wdims[3] = {cpad, (cuuint64_t)co_pad, 27};
  const cuuint64_t wstrides[2] = {e * cpad, e * cpad * co_pad};
  const cuuint32_t wbox[3] = {kTcC, kTcCo, 3};
  r = encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wp, 3, wdims, wstrides, wbox);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;

  cudaError_t err = cudaFuncSetAttribute(
      conv3d_bn_stats_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const int nwt = (W + kTcW - 1) / kTcW, nhb = (H + kTcRows - 1) / kTcRows;
  const dim3 grid((unsigned)((int64_t)N * Tn * nhb * nwt), co_pad / kTcCo);
  conv3d_bn_stats_tc_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), partial, Tn, H, W, Co,
      nchunk);
  stats_finish_kernel<<<dim3(Co, 2), kThreads, 0, stream>>>(
      partial, s1, s2, Co, (int)grid.x);
  return (int)cudaGetLastError();
}

// float32 route. x (N, T, H, W, C) float32 contiguous, 16-byte aligned, C %
// 4 == 0; wp the packed split weight, float32 (54, co_pad, 32 * nchunk)
// contiguous: taps ordered (dt, dw, dh), the tf32 hi parts at 0..26 and the
// lo parts at 27..53, each 32-channel chunk in the kernel's K order, zero
// where c >= C or o >= Co; y (N, T, H, W, Co) float32, Co % 8 == 0; co_pad
// a multiple of 64. partial: float32 (2, Co, N * T * ceil(H / 4) *
// ceil(W / 64)) scratch; s1, s2: float32 (Co,). Returns 0, a CUDA runtime
// error, or 100000 + the CUresult of encoding a tensor map.
extern "C" int conv3d_bn_stats_f32_launch(const void* x, const void* wp,
                                          void* y, float* partial, float* s1,
                                          float* s2, int N, int Tn, int H,
                                          int W, int C, int Co, int co_pad,
                                          int nchunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CUtensorMap xmap, wmap;
  const cuuint64_t e = 4;  // bytes of a float32
  const cuuint64_t xdims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)Tn, (cuuint64_t)N};
  const cuuint64_t xstrides[4] = {e * C, e * C * W, e * C * W * H,
                                  e * C * W * H * Tn};
  const cuuint32_t xbox[5] = {kFC, kFW, kFRows + 2, 1, 1};
  CUresult r = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 5, xdims,
                          xstrides, xbox);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;
  const cuuint64_t cpad = (cuuint64_t)nchunk * kFC;
  const cuuint64_t wdims[3] = {cpad, (cuuint64_t)co_pad, 54};
  const cuuint64_t wstrides[2] = {e * cpad, e * cpad * co_pad};
  const cuuint32_t wbox[3] = {kFC, kFCo, 3};
  r = encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wp, 3, wdims,
                 wstrides, wbox);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;

  cudaError_t err = cudaFuncSetAttribute(
      conv3d_bn_stats_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFSmem);
  if (err != cudaSuccess) return (int)err;
  const int nwt = (W + kFW - 1) / kFW, nhb = (H + kFRows - 1) / kFRows;
  const dim3 grid((unsigned)((int64_t)N * Tn * nhb * nwt), co_pad / kFCo);
  conv3d_bn_stats_f32_kernel<<<grid, kFThreads, kFSmem, stream>>>(
      xmap, wmap, static_cast<float*>(y), partial, Tn, H, W, Co, nchunk);
  stats_finish_kernel<<<dim3(Co, 2), kThreads, 0, stream>>>(
      partial, s1, s2, Co, (int)grid.x);
  return (int)cudaGetLastError();
}
