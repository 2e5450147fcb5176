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
// sums are (sum g, sum g*x). NCDHW is (N, C, T*H*W); channels_last_3d is
// (N*T*H*W, C, 1).
//
// Bound: bytes. Every input element is read once and takes one or two float
// operations; the outputs are 8*C bytes. A batch norm's maps run from a few
// KB to a hundred MB, so a small call is bound by its launch and one DRAM
// round trip, a large one by DRAM.
//
// Design. The TPU kernel carries its sums across a sequential grid in VMEM
// scratch. Blocks of this card run in no order, so the work is cut into
// blocks whose partial sums are combined inside the same launch:
//
//   - one launch a call (an earlier design ran a second kernel to add the
//     partial sums). A channel of one block writes its sums directly. A
//     channel of several blocks (a channels-last column group too) writes
//     its partial sums to a workspace, fences, and counts itself done on an
//     integer counter (atomicInc, which wraps back to 0 on the last block,
//     ready for the next call); the block that sees the count reach the
//     number of blocks adds all the partials in a fixed order and writes
//     the result. No float atomics: the result is the same bits from run to
//     run, whichever block finishes last. (A thread-block cluster that added
//     2 to 8 blocks through distributed shared memory was measured against
//     the counter and won nothing, so the counter serves every split.)
//   - the blocks are sized by bytes (ops/bn_stats.py:_plan). In a small map
//     a channel of up to two batches of loads (a batch: kUnroll loads a
//     thread, 16 KB of bf16 a block) is one block, one or two DRAM round
//     trips and no combining, and a longer one takes blocks of one batch; a
//     large map gets one wave of about 528 blocks (four an SM), each
//     streaming its share, so that no half-empty last wave trails it.
//   - planar (inner > 1): a block's threads take consecutive slots of one
//     channel's flattened (row, chunk) index, a chunk being the 16 bytes of
//     one aligned load, whatever the run length: a short run (98, 18) keeps
//     every thread busy. A run that is no multiple of 16 bytes, or data
//     that starts off a 16-byte boundary, still reads only aligned 16-byte
//     chunks: the chunk at each end of a run, shared with the neighbouring
//     channel, is read whole and only the run's elements in it are added.
//   - channels-last (inner == 1): a block covers a range of rows and up to
//     256 vector columns of channels. Each thread keeps its columns' sums in
//     registers; the block adds them by channel in shared memory in a fixed
//     order.
//   - each thread issues kUnroll independent loads (of each input) before it
//     adds any of them, so enough bytes are in flight to cover DRAM's
//     latency.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// does not synchronise and allocates nothing. The workspace (counters, then
// partial sums) is the wrapper's, one a device, zeroed once: calls on one
// device must be ordered on one stream, or they mix their partial sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// counters at the head of the workspace, partial sums after them (as in
// ops/bn_stats.py)
constexpr int kCounters = 1 << 16;

// VEC elements of T from one load: 16 bytes, or one element when VEC is 1
template <typename T, int VEC>
struct Chunk;
template <>
struct Chunk<float, 4> {
  uint4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void floats(float* f) const {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a bfloat16 is the top half of the float it stands for
  __device__ __forceinline__ void floats(float* f) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<float, 1> {
  float raw;
  __device__ __forceinline__ void load(const float* p) { raw = __ldg(p); }
  __device__ __forceinline__ void floats(float* f) const { f[0] = raw; }
};
template <>
struct Chunk<__nv_bfloat16, 1> {
  unsigned short raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void floats(float* f) const {
    f[0] = __uint_as_float((unsigned)raw << 16);
  }
};

// the elements of a chunk whose bit is set in mask, in order
template <typename T, int VEC, bool SAME, bool MASKED>
__device__ __forceinline__ void add_chunk(const Chunk<T, VEC>& ca,
                                          const Chunk<T, VEC>& cb,
                                          unsigned mask, float& s1,
                                          float& s2) {
  float fa[VEC], fb[VEC];
  ca.floats(fa);
  if constexpr (!SAME) cb.floats(fb);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (!MASKED || (mask >> k & 1u)) {
      s1 += fa[k];
      s2 = fmaf(fa[k], SAME ? fa[k] : fb[k], s2);
    }
  }
}

// lane 0 gets the sum of v over the warp, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// thread 0 gets the sums of (s1, s2) over the block: each warp's tree, then
// the warps in order
__device__ __forceinline__ float2 block_sum(float s1, float s2,
                                           float2* scratch) {
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  __syncthreads();  // scratch may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = make_float2(s1, s2);
  __syncthreads();
  float2 total = make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      total.x += scratch[w].x;
      total.y += scratch[w].y;
    }
  }
  return total;
}

// Planar layout (outer, C, inner), inner > 1. Block w = c * nsplit + s
// adds slots [s * per, min(nslots, (s + 1) * per)) of channel c. Slot j is
// chunk k = j % nch of row o = j / nch, whose run of inner elements starts
// at (o * C + c) * inner; thread t takes slots j0 + t, j0 + t + kThreads,
// ..., kUnroll of them a batch. ALIGNED: every run starts on a 16-byte
// boundary and is a multiple of VEC long, so chunk k is elements
// [k * VEC, (k + 1) * VEC) of the run. Else chunk k is the k-th aligned
// chunk that meets the run (mis: elements from the data's start back to
// the 16-byte boundary before it; nch counts the most chunks a run meets),
// read whole, and only its elements inside the run are added. An aligned
// 16-byte chunk that holds any element of the tensor lies inside one page
// (and inside the allocator's 512-byte-aligned block), so reading it
// whole cannot fault. A channel of several blocks combines through
// counters (one a channel) and partial: (C, nsplit) pairs.
template <typename T, int VEC, bool SAME, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
channel_sums_planar_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           float* __restrict__ out,
                           unsigned* __restrict__ counters,
                           float2* __restrict__ partial, int C, int64_t inner,
                           int mis, unsigned nch, unsigned nslots,
                           unsigned per, int nsplit) {
  __shared__ float2 scratch[kWarps];
  __shared__ unsigned is_last;
  const int c = blockIdx.x / nsplit, s = blockIdx.x - c * nsplit;
  const unsigned j0 = (unsigned)s * per;
  const unsigned j1 = min(nslots, j0 + per);
  float s1 = 0.0f, s2 = 0.0f;
  for (unsigned base = j0; base < j1; base += kThreads * kUnroll) {
    Chunk<T, VEC> ca[kUnroll], cb[kUnroll];
    unsigned mask[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned j = base + u * kThreads + threadIdx.x;
      mask[u] = 0u;
      if (j < j1) {
        const unsigned o = j / nch, k = j - o * nch;
        const int64_t run = ((int64_t)o * C + c) * inner;
        int64_t q;  // first element of the chunk
        if constexpr (ALIGNED) {
          q = run + (int64_t)k * VEC;
          mask[u] = 1u;
        } else {
          q = (run + mis) / VEC * VEC - mis + (int64_t)k * VEC;
          // the chunk's elements [lo, hi) inside the run
          const int lo = (int)max((int64_t)0, run - q);
          const int hi = (int)min((int64_t)VEC, run + inner - q);
          if (lo < hi) mask[u] = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
        }
        if (mask[u]) {
          ca[u].load(a + q);
          if constexpr (!SAME) cb[u].load(b + q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (mask[u])
        add_chunk<T, VEC, SAME, !ALIGNED>(ca[u], cb[u], mask[u], s1, s2);
  }
  float2 total = block_sum(s1, s2, scratch);
  if (nsplit == 1) {
    if (threadIdx.x == 0) {
      out[c] = total.x;
      out[C + c] = total.y;
    }
    return;
  }
  if (threadIdx.x == 0) {
    partial[(int64_t)c * nsplit + s] = total;
    __threadfence();
    is_last = atomicInc(&counters[c], nsplit - 1) == (unsigned)(nsplit - 1);
  }
  __syncthreads();
  if (!is_last) return;
  // the channel's last block: thread t adds partials t, t + kThreads, ...
  // in order, then the block's fixed tree
  __threadfence();
  float t1 = 0.0f, t2 = 0.0f;
  const float2* p = partial + (int64_t)c * nsplit;
  for (int i = threadIdx.x; i < nsplit; i += kThreads) {
    const float2 v = __ldcg(p + i);
    t1 += v.x;
    t2 += v.y;
  }
  total = block_sum(t1, t2, scratch);
  if (threadIdx.x == 0) {
    out[c] = total.x;
    out[C + c] = total.y;
  }
}

// Channels-last layout (rows, C), inner == 1: grid (nsplit, column groups).
// Thread t of block (s, g) handles vector column g * kThreads + t % cols_blk
// and rows s * per + t / cols_blk + i * rpi, rpi = kThreads / cols_blk.
// partial: (nsplit, 2, C); counters: one a column group.
template <typename T, int VEC, bool SAME>
__global__ void __launch_bounds__(kThreads)
channel_sums_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         float* __restrict__ out,
                         unsigned* __restrict__ counters,
                         float* __restrict__ partial, int64_t rows, int C,
                         int64_t per) {
  __shared__ float red[2][kThreads * VEC];
  __shared__ unsigned is_last;
  const int nsplit = gridDim.x;
  const int cols = C / VEC;
  const int col0 = blockIdx.y * kThreads;
  const int cols_blk = min(kThreads, cols - col0);
  const int rpi = kThreads / cols_blk;
  const int t = threadIdx.x;
  const int col = t % cols_blk, rsub = t / cols_blk;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.0f;
  const int64_t r0 = (int64_t)blockIdx.x * per;
  const int64_t r1 = min(rows, r0 + per);
  if (rsub < rpi) {
    const int64_t off0 = (int64_t)(col0 + col) * VEC;
    for (int64_t r = r0 + rsub; r < r1; r += (int64_t)rpi * kUnroll) {
      Chunk<T, VEC> ca[kUnroll], cb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = r + (int64_t)u * rpi;
        if (rr < r1) {
          ca[u].load(a + rr * C + off0);
          if constexpr (!SAME) cb[u].load(b + rr * C + off0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + (int64_t)u * rpi < r1) {
          float fa[VEC], fb[VEC];
          ca[u].floats(fa);
          if constexpr (!SAME) cb[u].floats(fb);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            s1[k] += fa[k];
            s2[k] = fmaf(fa[k], SAME ? fa[k] : fb[k], s2[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[0][(rsub * cols_blk + col) * VEC + k] = s1[k];
      red[1][(rsub * cols_blk + col) * VEC + k] = s2[k];
    }
  }
  __syncthreads();
  // one thread a (sum, channel) of the group adds the block's rows in order
  const int ng = cols_blk * VEC;  // channels of the group
  const int64_t c0 = (int64_t)col0 * VEC;
  for (int v = t; v < 2 * ng; v += kThreads) {
    const int k = v / ng, j = v - k * ng;
    float acc = 0.0f;
    for (int q = 0; q < rpi; ++q) acc += red[k][q * ng + j];
    if (nsplit == 1)
      out[k * C + c0 + j] = acc;
    else
      partial[((int64_t)blockIdx.x * 2 + k) * C + c0 + j] = acc;
  }
  if (nsplit == 1) return;
  __threadfence();
  __syncthreads();
  if (t == 0)
    is_last = atomicInc(&counters[blockIdx.y], nsplit - 1) ==
              (unsigned)(nsplit - 1);
  __syncthreads();
  if (!is_last) return;
  // the group's last block: tps threads a (sum, channel), each over the
  // splits sub, sub + tps, ... in order, then their sums in order
  __threadfence();
  const int slots = 2 * ng;
  int tps = 1;
  while (2 * tps * slots <= kThreads) tps *= 2;
  const int lanes = kThreads / tps;  // slots a pass
  const int sub = t / lanes;
  float* comb = red[0];
  for (int v0 = 0; v0 < slots; v0 += lanes) {
    const int v = v0 + t % lanes;
    const int k = v / ng, j = v - k * ng;
    float acc = 0.0f;
    if (v < slots) {
      const float* p = partial + (int64_t)k * C + c0 + j;
      for (int q = sub; q < nsplit; q += tps)
        acc += __ldcg(p + (int64_t)q * 2 * C);
    }
    __syncthreads();  // comb is free again
    comb[t] = acc;
    __syncthreads();
    if (sub == 0 && v < slots) {
      float total = 0.0f;
      for (int q = 0; q < tps; ++q) total += comb[q * lanes + t];
      out[k * C + c0 + j] = total;
    }
  }
}

template <typename T, int VEC, bool SAME>
void launch_typed(const void* a, const void* b, bool aligned, float* out,
                 unsigned* counters, float* partial, int64_t outer, int C,
                 int64_t inner, int mis, int64_t nch, int64_t per, int nsplit,
                 cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (inner == 1) {
    const int cols = C / VEC;
    const int groups = (cols + kThreads - 1) / kThreads;
    channel_sums_rows_kernel<T, VEC, SAME>
        <<<dim3(nsplit, groups), kThreads, 0, stream>>>(
            ta, tb, out, counters, partial, outer, C, per);
    return;
  }
  const unsigned nslots = (unsigned)(outer * nch);
  float2* p2 = reinterpret_cast<float2*>(partial);
  // one element a chunk is aligned whatever the data
  auto kernel = channel_sums_planar_kernel<T, VEC, SAME, true>;
  if constexpr (VEC > 1)
    if (!aligned) kernel = channel_sums_planar_kernel<T, VEC, SAME, false>;
  kernel<<<(unsigned)(C * nsplit), kThreads, 0, stream>>>(
      ta, tb, out, counters, p2, C, inner, mis, (unsigned)nch, nslots,
      (unsigned)per, nsplit);
}

template <typename T, int VEC>
void launch_vec(const void* a, const void* b, bool aligned, float* out,
                unsigned* counters, float* partial, int64_t outer, int C,
                int64_t inner, int mis, int64_t nch, int64_t per, int nsplit,
                cudaStream_t stream) {
  if (a == b)
    launch_typed<T, VEC, true>(a, b, aligned, out, counters, partial, outer,
                               C, inner, mis, nch, per, nsplit, stream);
  else
    launch_typed<T, VEC, false>(a, b, aligned, out, counters, partial, outer,
                                C, inner, mis, nch, per, nsplit, stream);
}

}  // namespace

// a, b: (outer, C, inner) in memory, same dtype (and, with wide chunks,
// the same offset from a 16-byte boundary); b == a reads the input once.
// kind: dtype (0 float32, 1 bfloat16) + 2 * wide (16-byte chunks, else one
// element a chunk) + 4 * aligned (planar runs on 16-byte boundaries, a
// whole number of chunks). out: float32 (2, C), sums of a in row 0, of a*b
// in row 1. workspace: the wrapper's, 1 << 16 counters (zero between
// calls) then partial sums. Planar (inner > 1): mis, nch, per, nsplit as
// for channel_sums_planar_kernel. Rows (inner == 1): per rows a block,
// nsplit blocks a column group. Returns cudaGetLastError() after the
// launch.
extern "C" int channel_sums_launch(const void* a, const void* b, int kind,
                                   float* out, void* workspace, int64_t outer,
                                   int C, int64_t inner, int mis, int64_t nch,
                                   int64_t per, int nsplit, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned* counters = static_cast<unsigned*>(workspace);
  float* partial = reinterpret_cast<float*>(counters + kCounters);
  const bool wide = kind & 2, aligned = kind & 4;
  if ((kind & 1) == 0) {
    if (wide)
      launch_vec<float, 4>(a, b, aligned, out, counters, partial, outer, C,
                           inner, mis, nch, per, nsplit, stream);
    else
      launch_vec<float, 1>(a, b, aligned, out, counters, partial, outer, C,
                           inner, mis, nch, per, nsplit, stream);
  } else {
    if (wide)
      launch_vec<__nv_bfloat16, 8>(a, b, aligned, out, counters, partial,
                                   outer, C, inner, mis, nch, per, nsplit,
                                   stream);
    else
      launch_vec<__nv_bfloat16, 1>(a, b, aligned, out, counters, partial,
                                   outer, C, inner, mis, nch, per, nsplit,
                                   stream);
  }
  return (int)cudaGetLastError();
}
