// Pointwise (1x1, stride 1) convolution, f32 and bf16 — hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pw_fwd_kernel` of
// src/repro/kernels/conv2d_pointwise.py (:56, pallas_call :211), out =
// act(x @ w + b) + r.  Layouts are the paper's blocked ones:
//
//   x   [N, Ci/Cib, H, W, Cib]       g, z, out, r  [N, Co/Cob, H, W, Cob]
//   w   [Co/Cob, Ci/Cib, 1, 1, Cib, Cob]            b  [Co/Cob, Cob]
//
// A 1x1 stride-1 conv has no halo: for one (image, channel block) the
// H*W*Cb slab is contiguous, so the conv is a matrix product over channel
// pencils at every position.  The forward is one GEMM tile,
// `pointwise_tile_kernel`:
//
//   out[n, ob, p, o] = sum_{kb, k} x[n, kb, p, k] * w[ob][kb][k][o]
//
// The backward is not built here.  The dgrad (`_pw_dgrad_kernel`, :87, dx =
// dz @ w^T) launches the dense dgrad's TMA-fed tile at a 1x1 filter
// (direct_conv2d_bwd.cu `dgrad_kernel`), whose B operand, the weight as
// stored, is K-major already and which timed faster than this tile with the
// weight read transposed.  The wgrad (`_pw_wgrad_kernel`, :114, dw = sum
// over positions of x^T dz) launches the dense wgrad's tile at a 1x1 filter
// (direct_conv2d_bwd.cu `wgrad_kernel`, wgrad_tile.cuh), whose rows are then
// the Cib channels.  Both form dz = g * act'(z) as g is staged.
//
// The tile, on the tensor cores.  A CTA owns `rows` = 64 x (consumer
// warpgroups) consecutive positions of one image (M; tiles never straddle
// images, so GAP sums stay per image, and only an image's last tile is
// ragged) by N lanes of one output block (a 128-lane block may split in two
// CTAs of 64 where that fills the card), and contracts K = (input block,
// channel) `chunk` channels a stage: wgmma m64nNk8 in TF32 with f32
// accumulators, A (the staged input rows) read from shared memory into
// registers, B (the weight chunk) from shared memory in the core-matrix
// order [chunk/4][N][4] that TF32 wgmma's K-major operand takes.
//
// f32 accuracy from TF32 (3xTF32), as the dense dgrad and wgrad tiles
// (dgrad_tile.cuh): each operand splits into big + small TF32 halves and
// the three products small*big + big*small + big*big go into one f32
// accumulator.  A splits as it is loaded, B once a stage.
//
// Warp roles.  A CTA is `wgs` consumer warpgroups (the first threads) and
// one producer warpgroup.  A stage's copies are cp.async (16 bytes where
// the pencils are multiples of 4, else 4; zero-filled past the map's end
// and past a pencil), issued by the producer's 128 threads a stage ahead
// into a two-slot ring of input rows and raw weight chunks: a launch
// encodes nothing on the host, and every pencil width takes the one path.
// The producer then writes the weight chunk, staged raw, in core-matrix
// order split into its halves: the weight [k][o] is N-contiguous (MN
// major), which TF32 wgmma does not take, so the producer transposes it on
// that pass.  Named barriers hand a slot to the consumers and back.  No
// atomics: every sum runs in a fixed order, and two runs give identical
// bits.
//
// Epilogue: the forward's is the reference's (+ b, activation, + r, one
// store); with GAP each CTA writes its tile's sums of the stored values,
// the rows of a warp summed by shuffles and the consumer warps in order,
// and the last CTA of an (image, output block) adds the image's tiles in
// order into the pooled features (split_sum.cuh), in the same launch.
//
// What bounds it on this card.  Per output element the forward does 2*Ci
// FLOPs against 4 bytes written and 4*Ci/Co bytes read: 32 to 512 FLOP/byte
// on MobileNet's legs.  As three TF32 products on the tensor cores (495
// TFLOP/s) that is near or under the H100's ridge (~150 FLOP/byte), so the
// legs are bound by bytes and operations alike at batch 8, by operations at
// batch 32's larger maps; the f32 FMA rate (67 TFLOP/s) that bound the
// earlier kernel is printed beside it.  In practice the 7x7 and 14x14 maps
// give few CTAs (the N split doubles them) and short contractions give few
// stages to hide a stage's copies behind.
//
// The bf16 build (`pointwise_tile_kernel_bf16`, namespace `pwbf16` below)
// is the same tile on bf16 operands, the reference's forward under BF16.
//
// C interface for ctypes: pointers and the stream as void*, ints as int (the
// tile's plan as one int array, built once per shape); each entry point
// returns cudaGetLastError() after its launch (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dgrad_tile.cuh"
#include "split_sum.cuh"

namespace {

namespace dt = dgrad_tile;

constexpr int kMaxDevices = 64;

constexpr int kActRelu = 1;
constexpr int kActGelu = 2;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) {
    return v < 0.0f ? 0.0f : v;
  }
  if (act == kActGelu) {
    // jax.nn.gelu default (approximate=True): tanh form
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// ---------------------------------------------------------------------------
// forward: the tensor-core tile
// ---------------------------------------------------------------------------

constexpr int kWarpgroup = dt::kWarpgroup;
constexpr int kMaxConsumers = 3;
constexpr int kTileThreads = kWarpgroup * (kMaxConsumers + 1);
constexpr int kRows = 64;           // rows of one wgmma tile
// ring slots: a stage's copies are issued a stage ahead of its use
constexpr int kSlots = 2;
// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;                   // + slot: the stage is ready
constexpr int kBarEmpty = kBarFull + kSlots;  // + slot: consumed
constexpr int kBarProducer = kBarEmpty + kSlots;  // the producer's own
constexpr int kBarGap = kBarProducer + 1;     // the consumers', GAP sums

// The tile's launch geometry, passed by value; its fields are the int array
// the host builds once per shape (conv2d_pointwise_tile).
struct Geometry {
  int kblk, kw;      // the contraction: input blocks of kw channels
  int oblk, ow;      // the output: blocks of ow lanes
  int hw;            // positions of one image
  int rows;          // positions of a tile: 64 x consumer warpgroups
  int nsplit;        // CTAs an output block's lanes split into, N each
  int chunk;         // channels a stage contracts (a multiple of 8)
  int act;
  int gap;           // 1: the forward writes the tile's GAP sums
};
constexpr int kGeometryInts = sizeof(Geometry) / sizeof(int);

__host__ __device__ inline int kpad(const Geometry& g) {
  return (g.kw + 7) / 8 * 8;
}

// floats from one staged input row to the next: the chunk and 4 more, so
// that the eight rows of a warp's A load fall on eight distinct bank quads
__host__ __device__ inline int row_floats(const Geometry& g) {
  return g.chunk + 4;
}

// Dynamic shared memory of one CTA (core/blocking.py pointwise_smem_bytes):
// 128 bytes to align the base; per ring slot the input rows, the raw weight
// chunk [chunk][N] and its big and small halves; the k8 steps' A shifts;
// the consumer warps' GAP sums.
__host__ inline size_t smem_bytes(const Geometry& g, int n, int wgs) {
  const size_t rows = (size_t)g.rows * row_floats(g);
  return 128 + 4 * (kSlots * (rows + 3 * (size_t)g.chunk * n)
                    + g.chunk / 8 + (g.gap ? (size_t)4 * wgs * n : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kSlots - 2 of this thread's copy groups are in flight:
// the stage about to be processed has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kSlots - 2) : "memory");
}

// Copy `count` runs of `len` floats, run r from src + r * src_stride (valid
// while r < valid_runs, and float e of it while e < valid_len) to dst + r *
// dst_stride, by `tid` of 128 producer threads; 16-byte copies when `vec`
// (len, the strides and the bases multiples of 4 floats).
__device__ __forceinline__ void copy_runs(float* dst, int dst_stride,
                                          const float* src, int src_stride,
                                          int count, int len, int valid_runs,
                                          int valid_len, bool vec, int tid) {
  const int unit = vec ? 4 : 1;
  const int units = len / unit;
  for (int i = tid; i < count * units; i += kWarpgroup) {
    const int r = i / units;
    const int e = (i - r * units) * unit;
    const bool ok = r < valid_runs && e < valid_len;
    const float* s = ok ? src + (size_t)r * src_stride + e : src;
    if (vec) {
      cp_async16(dst + r * dst_stride + e, s, ok);
    } else {
      cp_async4(dst + r * dst_stride + e, s, ok);
    }
  }
}

// The shared-memory carve-up of one CTA (smem_bytes): kSlots slots of
// `slot` floats each, [input rows | big | small | raw] a slot, then the
// shifts and the GAP sums.  A slot's buffers are reached by
// offset, so that a slot index known only at run time costs no local
// memory.
struct Smem {
  float* base;
  int slot;            // floats of one slot
  int big, small, raw;   // offsets inside a slot
  int* shifts;         // [chunk / 8]
  float* red;          // [4 * wgs][N] the consumer warps' GAP sums

  __device__ float* rows_of(int s) const { return base + s * slot; }
  __device__ float* big_of(int s) const { return base + s * slot + big; }
  __device__ float* small_of(int s) const { return base + s * slot + small; }
  __device__ float* raw_of(int s) const { return base + s * slot + raw; }
};

template <int N>
__device__ inline Smem carve(float* smem, const Geometry& g) {
  Smem m;
  m.base = smem + ((128 - (dt::smem_u32(smem) & 127)) & 127) / 4;
  m.big = g.rows * row_floats(g);
  m.small = m.big + g.chunk * N;
  m.raw = m.small + g.chunk * N;
  m.slot = m.raw + g.chunk * N;
  float* p = m.base + kSlots * m.slot;
  m.shifts = reinterpret_cast<int*>(p);
  m.red = p + g.chunk / 8;
  return m;
}

// Issue stage s's copies (the producer's 128 threads, `tid`; the caller
// commits them as one group): the tile's input rows [rows][chunk] of
// channels [c0, c0 + chunk) of input block kb, and the raw weight chunk.
template <int N>
__device__ inline void issue_stage(const Smem& m, int slot,
                                   const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const Geometry& g, int n, int o_b, int o0,
                                   int kb, int c0, int p0, int tid) {
  const int ld = row_floats(g);
  const bool vx = g.kw % 4 == 0;
  const size_t slab = ((size_t)(n * g.kblk + kb) * g.hw + p0) * g.kw + c0;
  const int valid_rows = min(g.rows, g.hw - p0);
  const int valid_k = min(g.chunk, g.kw - c0);
  copy_runs(m.rows_of(slot), ld, x + slab, g.kw, g.rows, g.chunk, valid_rows,
            valid_k, vx, tid);
  // w[o_b][kb][c0 + k][o0 + n]: chunk runs of N lanes
  const int valid_n = min(N, g.ow - o0);
  const float* wb = w + ((size_t)(o_b * g.kblk + kb) * g.kw + c0) * g.ow + o0;
  copy_runs(m.raw_of(slot), N, wb, g.ow, g.chunk, N, valid_k, valid_n,
            g.ow % 4 == 0, tid);
}

// The raw weight chunk [chunk][N] into the core-matrix order
// [chunk/4][N][4], transposed and split into TF32 halves: unit (q, n) is
// B[4q .. 4q + 3][n] (the producer's threads, neighbouring threads on
// neighbouring n).
template <int N>
__device__ inline void split_weights(const Smem& m, int slot,
                                     const Geometry& g, int tid) {
  auto split = [](float v, float& s) {
    const float h = __uint_as_float(dt::tf32_bits(v));
    s = __uint_as_float(dt::tf32_bits(v - h));
    return h;
  };
  for (int u = tid; u < g.chunk / 4 * N; u += kWarpgroup) {
    const int q = u / N;
    const int n = u - q * N;
    const float* r = m.raw_of(slot) + 4 * q * N + n;
    float4 v = make_float4(r[0], r[N], r[2 * N], r[3 * N]);
    float4 lo;
    v.x = split(v.x, lo.x);
    v.y = split(v.y, lo.y);
    v.z = split(v.z, lo.z);
    v.w = split(v.w, lo.w);
    reinterpret_cast<float4*>(m.big_of(slot))[u] = v;
    reinterpret_cast<float4*>(m.small_of(slot))[u] = lo;
  }
}

// N: the wgmma width (the output lanes a CTA owns, padded up).
template <int N>
__global__ void __launch_bounds__(kTileThreads, 1)
pointwise_tile_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ residual,
                      float* __restrict__ out, float* partials,
                      float* __restrict__ pooled, int* counters,
                      Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y / g.nsplit;
  const int o0 = blockIdx.y % g.nsplit * N;
  const int n = blockIdx.z;
  const int p0 = tile * g.rows;
  const int nth = blockDim.x;
  const int consumers = nth - kWarpgroup;
  const Smem m = carve<N>(smem, g);
  const int per_block = kpad(g) / g.chunk;
  const int stages = g.kblk * per_block;
  const int steps = g.chunk / 8;
  for (int j = threadIdx.x; j < steps; j += nth) m.shifts[j] = 8 * j;
  __syncthreads();

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    auto issue = [&](int s) {
      issue_stage<N>(m, s % kSlots, x, w, g, n, o_b, o0, s / per_block,
                     s % per_block * g.chunk, p0, tid);
    };
    // one copy group a stage, committed even when empty, so that the
    // group of stage s is the oldest in flight when s is processed
    for (int s = 0; s < kSlots - 1; ++s) {
      if (s < stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      const int slot = s % kSlots;
      cp_async_wait_ring();
      dt::bar_sync(kBarProducer, kWarpgroup);   // every thread's copies
      split_weights<N>(m, slot, g, tid);
      dt::fence_proxy_async();
      dt::bar_arrive(kBarFull + slot, nth);
      // stage s + kSlots - 1 refills the slot of stage s - 1 once the
      // consumers are done with it and every producer thread has split
      // its raw chunk
      const int next = s + kSlots - 1;
      if (next < stages) {
        if (s >= 1) dt::bar_sync(kBarEmpty + (s - 1) % kSlots, nth);
        issue(next);
      }
      cp_async_commit();
    }
    return;
  }

  // a consumer thread: rows r and r + 8 of its warpgroup's m-tile
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / kWarpgroup * kRows
                + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ld = row_floats(g);
  const int off[2] = {r * ld + lane % 4, (r + 8) * ld + lane % 4};
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % kSlots;
    dt::bar_sync(kBarFull + slot, nth);
    dt::mma_stage<N>(acc, m.rows_of(slot), off, m.shifts, steps,
                     m.big_of(slot), m.small_of(slot));
    if (s + kSlots < stages) dt::bar_arrive(kBarEmpty + slot, nth);
  }

  // the epilogue; acc keeps the stored values, zero where nothing is
  // stored, for the GAP sums
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.ow % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + r + 8 * h;
    const bool row_ok = p < g.hw;
    const size_t base = ((size_t)(n * g.oblk + o_b) * g.hw + p) * g.ow + o0;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      float v[2] = {acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]};
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = row_ok && o0 + col + e < g.ow;
        if (ok[e]) {
          const int o = o0 + col + e;
          v[e] = activate(v[e] + (bias != nullptr
                                      ? __ldg(bias + o_b * g.ow + o) : 0.0f),
                          g.act);
          if (residual != nullptr) v[e] += __ldg(residual + base + col + e);
        }
        acc[4 * jj + 2 * h + e] = ok[e] ? v[e] : 0.0f;
      }
      if (pairs && ok[1]) {
        *reinterpret_cast<float2*>(out + base + col) = make_float2(v[0], v[1]);
      } else {
        if (ok[0]) out[base + col] = v[0];
        if (ok[1]) out[base + col + 1] = v[1];
      }
    }
  }

  if (g.gap) {
    // the tile's sums of the stored values: a thread's two rows, the eight
    // row groups of a warp by shuffles, then the consumer warps in order
    const int wid = threadIdx.x / 32;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[4 * jj + e] + acc[4 * jj + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) m.red[wid * N + 8 * jj + col0 + e] = s;
      }
    }
    dt::bar_sync(kBarGap, consumers);
    const int c = threadIdx.x;
    if (c < N && o0 + c < g.ow) {
      float s = 0.0f;
      for (int q = 0; q < consumers / 32; ++q) s += m.red[q * N + c];
      partials[((size_t)(n * g.oblk + o_b) * gridDim.x + tile) * g.ow + o0
               + c] = s;
    }
    // the last CTA of (n, o_b), both lane halves: the image's tiles in
    // order, times the f32 reciprocal of H * W
    split_sum::gap_fold(partials, pooled, counters, n * g.oblk + o_b,
                        gridDim.x, gridDim.x * g.nsplit, g.ow, g.hw,
                        reinterpret_cast<int*>(m.red), kBarGap, consumers);
  }
}

// ---------------------------------------------------------------------------
// the bf16 build of the tile
// ---------------------------------------------------------------------------
//
// `pointwise_tile_kernel_bf16<N>`: the tile above on bf16 operands, the
// reference's fused inference forward under BF16 (src/repro/kernels/
// conv2d_pointwise.py `_pwconv`, :351: x, w and the residual cast to bf16;
// the wrapper casts the f32 master weights once a call).  What differs:
// * One bf16 wgmma (m64nNk16) a k16 step, one product a MAC: no TF32 split,
//   so the producer neither splits nor transposes the weights.  The weight
//   chunk [chunk][N] is N-contiguous (MN-major), which wgmma reads for
//   16-bit types through its transpose bit: the producer copies each 8-lane
//   run of a channel (16 bytes) by cp.async straight into the core-matrix
//   order [N/8][chunk][8] the descriptor reads (fwd_tile.cuh's bf16 weight
//   order at one tap), or, where Cob is not a multiple of 8, each cell by a
//   2-byte load and store.  A (the input rows, K-contiguous) is read from
//   shared memory into registers as bf16 pairs.
// * The chunk is a multiple of 16 (k16 steps) and Cib pads to 16 with
//   zero-filled cells; a staged row is chunk + 8 bf16 (16 bytes never read),
//   so that the eight rows a warp loads fall on distinct bank quads.  Row
//   copies are 16 bytes where Cib is a multiple of 8, 4 where it is even,
//   else 2-byte loads and stores (cp.async has no 2-byte copy).
// * One f32 accumulator over the whole contraction, as the f32 tile keeps
//   (MobileNet's K is at most 1024).  The epilogue is act(acc + b) with an
//   f32 bias, then + r (bf16, in f32), then one rounding to bf16 at the
//   store; the GAP sums the stored bf16 values in f32, and the pooled
//   features leave as bf16 (split_sum.cuh's fold of the f32 partials).
namespace pwbf16 {

using bf = __nv_bfloat16;

// Cib rounded up to the k16 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return (g.kw + 15) / 16 * 16;
}

__host__ __device__ inline int row_elems(const Geometry& g) {
  return g.chunk + 8;
}

// Dynamic shared memory of one CTA (core/blocking.py pointwise_smem_bytes
// at op_bytes 2): 128 bytes to align the base; per ring slot the input rows
// [rows][chunk + 8] and the weight chunk [N/8][chunk][8], bf16; with GAP
// the consumer warps' f32 sums.
__host__ inline size_t smem_bytes(const Geometry& g, int n, int wgs) {
  return 128 + 2 * (size_t)kSlots * ((size_t)g.rows * row_elems(g)
                                     + (size_t)g.chunk * n)
         + (g.gap ? (size_t)16 * wgs * n : 0);
}

// The carve-up of one CTA (smem_bytes): kSlots slots of [rows | weights],
// each 128-byte aligned, then the GAP sums.
struct Smem {
  char* base;
  int slot;            // bytes of one slot
  int wts;             // the weights' offset in a slot, in bytes
  float* red;          // [4 * wgs][N] the consumer warps' GAP sums

  __device__ bf* rows_of(int s) const {
    return reinterpret_cast<bf*>(base + s * slot);
  }
  __device__ bf* wts_of(int s) const {
    return reinterpret_cast<bf*>(base + s * slot + wts);
  }
};

template <int N>
__device__ inline Smem carve(char* smem, const Geometry& g) {
  Smem m;
  m.base = smem + ((128 - (dt::smem_u32(smem) & 127)) & 127);
  m.wts = 2 * g.rows * row_elems(g);
  m.slot = m.wts + 2 * g.chunk * N;
  m.red = reinterpret_cast<float*>(m.base + kSlots * m.slot);
  return m;
}

// Issue stage s's copies (the producer's 128 threads, `tid`; the caller
// commits them as one group): the tile's input rows [rows][chunk] of
// channels [c0, c0 + chunk) of input block kb, zero past the map and past
// Cib, and the weight chunk as [N/8][chunk][8], zero past Cib and Cob.
template <int N>
__device__ inline void issue_stage(const Smem& m, int slot,
                                   const bf* __restrict__ x,
                                   const bf* __restrict__ w,
                                   const Geometry& g, int n, int o_b, int o0,
                                   int kb, int c0, int p0, int tid) {
  const int unit = g.kw % 8 == 0 ? 8 : (g.kw % 2 == 0 ? 2 : 1);
  const int per_row = g.chunk / unit;
  const int ld = row_elems(g);
  const size_t slab = ((size_t)(n * g.kblk + kb) * g.hw + p0) * g.kw + c0;
  const int valid_rows = min(g.rows, g.hw - p0);
  const int valid_k = min(g.chunk, g.kw - c0);
  bf* rows = m.rows_of(slot);
  for (int i = tid; i < g.rows * per_row; i += kWarpgroup) {
    const int r = i / per_row;
    const int e = (i - r * per_row) * unit;
    const bool ok = r < valid_rows && e < valid_k;
    const bf* src = ok ? x + slab + (size_t)r * g.kw + e : x;
    bf* dst = rows + r * ld + e;
    if (unit == 8) {
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(src), ok);
    } else if (unit == 2) {
      cp_async4(reinterpret_cast<float*>(dst),
                reinterpret_cast<const float*>(src), ok);
    } else {
      *reinterpret_cast<unsigned short*>(dst) =
          ok ? __ldg(reinterpret_cast<const unsigned short*>(src))
             : (unsigned short)0;
    }
  }
  // w[o_b][kb][c0 + k][o0 + 8q + e] at (q, k, e)
  const int valid_n = min(N, g.ow - o0);
  const bf* wb = w + ((size_t)(o_b * g.kblk + kb) * g.kw + c0) * g.ow + o0;
  bf* wts = m.wts_of(slot);
  if (g.ow % 8 == 0) {
    for (int u = tid; u < N / 8 * g.chunk; u += kWarpgroup) {
      const int q = u / g.chunk;
      const int k = u - q * g.chunk;
      const bool ok = k < valid_k && 8 * q < valid_n;
      const bf* src = ok ? wb + (size_t)k * g.ow + 8 * q : w;
      cp_async16(reinterpret_cast<float*>(wts + (size_t)u * 8),
                 reinterpret_cast<const float*>(src), ok);
    }
  } else {
    const unsigned short* ws = reinterpret_cast<const unsigned short*>(wb);
    unsigned short* d = reinterpret_cast<unsigned short*>(wts);
    for (int i = tid; i < N * g.chunk; i += kWarpgroup) {
      const int k = (i >> 3) % g.chunk;
      const int l = (i >> 3) / g.chunk * 8 + (i & 7);
      const bool ok = k < valid_k && l < valid_n;
      d[i] = ok ? __ldg(ws + (size_t)k * g.ow + l) : (unsigned short)0;
    }
  }
}

// A of one k16 step at `shift` elements from each row's offset: rows r and
// r + 8 at columns 2 (lane % 4), + 1, and the same 8 columns on.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf* rows,
                                       const int (&off)[2], int shift) {
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(rows + off[0]
                                                         + shift);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(rows + off[1]
                                                         + shift);
  a[0] = r0[0];
  a[1] = r1[0];
  a[2] = r0[4];
  a[3] = r1[4];
}

// One landed stage into a consumer's m-tile: its `steps` k16 steps into the
// accumulator, A loaded one step ahead into the register set the wgmma two
// steps back has released.  B is read MN-major through the transpose bit:
// interleaved core matrices of 8 lanes x 8 channels (128 bytes), a step's
// two channel halves 128 bytes apart (the leading byte offset), the 8-lane
// groups chunk * 16 bytes apart (the stride byte offset), step j 256 j
// bytes on (16 j in the descriptor's address field).  Returns with every
// wgmma complete.
template <int N>
__device__ void mma_stage(float (&acc)[N / 2], const bf* rows,
                          const int (&off)[2], int steps, const bf* wts,
                          int chunk) {
  const uint64_t desc0 = dt::kmajor_desc(dt::smem_u32(wts), 128, chunk * 16);
  auto step = [&](const uint32_t (&a)[4], int j) {
    dt::wgmma_fence();
    dt::wgmma_bf16<N, 1>(acc, a, desc0 + (uint64_t)(16 * j));
    dt::wgmma_commit();
  };
  uint32_t a0[4], a1[4];
  load_a(a0, rows, off, 0);
  for (int j = 0; j < steps; j += 2) {
    step(a0, j);
    if (j + 1 < steps) {
      dt::wgmma_wait<1>();            // step j - 1 has released a1
      load_a(a1, rows, off, 16 * (j + 1));
      step(a1, j + 1);
    }
    if (j + 2 < steps) {
      dt::wgmma_wait<1>();            // step j has released a0
      load_a(a0, rows, off, 16 * (j + 2));
    }
  }
  dt::wgmma_wait<0>();
  dt::fence_regs<N / 2>(acc);
}

}  // namespace pwbf16

// N: the wgmma width (the output lanes a CTA owns, padded up).  x, w, the
// residual, out and pooled bf16; the bias and the partials f32.
template <int N>
__global__ void __launch_bounds__(kTileThreads, 1)
pointwise_tile_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ residual,
                           __nv_bfloat16* __restrict__ out, float* partials,
                           __nv_bfloat16* __restrict__ pooled, int* counters,
                           Geometry g) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) char smem_raw[];
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y / g.nsplit;
  const int o0 = blockIdx.y % g.nsplit * N;
  const int n = blockIdx.z;
  const int p0 = tile * g.rows;
  const int nth = blockDim.x;
  const int consumers = nth - kWarpgroup;
  const pwbf16::Smem m = pwbf16::carve<N>(smem_raw, g);
  const int per_block = pwbf16::kpad(g) / g.chunk;
  const int stages = g.kblk * per_block;

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    auto issue = [&](int s) {
      pwbf16::issue_stage<N>(m, s % kSlots, x, w, g, n, o_b, o0,
                             s / per_block, s % per_block * g.chunk, p0, tid);
    };
    for (int s = 0; s < kSlots - 1; ++s) {
      if (s < stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      const int slot = s % kSlots;
      cp_async_wait_ring();
      dt::bar_sync(kBarProducer, kWarpgroup);   // every thread's copies
      dt::fence_proxy_async();    // the landed weights, for wgmma
      dt::bar_arrive(kBarFull + slot, nth);
      const int next = s + kSlots - 1;
      if (next < stages) {
        if (s >= 1) dt::bar_sync(kBarEmpty + (s - 1) % kSlots, nth);
        issue(next);
      }
      cp_async_commit();
    }
    return;
  }

  // a consumer thread: rows r and r + 8 of its warpgroup's m-tile
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / kWarpgroup * kRows
                + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ld = pwbf16::row_elems(g);
  const int off[2] = {r * ld + 2 * (lane % 4), (r + 8) * ld + 2 * (lane % 4)};
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % kSlots;
    dt::bar_sync(kBarFull + slot, nth);
    pwbf16::mma_stage<N>(acc, m.rows_of(slot), off, g.chunk / 16,
                         m.wts_of(slot), g.chunk);
    if (s + kSlots < stages) dt::bar_arrive(kBarEmpty + slot, nth);
  }

  // the epilogue in f32, one rounding to bf16 at the store; acc keeps the
  // stored (rounded) values, zero where nothing is stored, for the GAP
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.ow % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + r + 8 * h;
    const bool row_ok = p < g.hw;
    const size_t base = ((size_t)(n * g.oblk + o_b) * g.hw + p) * g.ow + o0;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      bf v[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = row_ok && o0 + col + e < g.ow;
        float f = acc[4 * jj + 2 * h + e];
        if (ok[e]) {
          const int o = o0 + col + e;
          f = activate(f + (bias != nullptr
                                ? __ldg(bias + o_b * g.ow + o) : 0.0f),
                       g.act);
          if (residual != nullptr) {
            f += __bfloat162float(residual[base + col + e]);
          }
        }
        v[e] = __float2bfloat16_rn(f);
        acc[4 * jj + 2 * h + e] = ok[e] ? __bfloat162float(v[e]) : 0.0f;
      }
      if (pairs && ok[1]) {
        __nv_bfloat162 pr;
        pr.x = v[0];
        pr.y = v[1];
        *reinterpret_cast<__nv_bfloat162*>(out + base + col) = pr;
      } else {
        if (ok[0]) out[base + col] = v[0];
        if (ok[1]) out[base + col + 1] = v[1];
      }
    }
  }

  if (g.gap) {
    // the tile's sums of the stored values, as the f32 tile sums them
    const int wid = threadIdx.x / 32;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[4 * jj + e] + acc[4 * jj + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) m.red[wid * N + 8 * jj + col0 + e] = s;
      }
    }
    dt::bar_sync(kBarGap, consumers);
    const int c = threadIdx.x;
    if (c < N && o0 + c < g.ow) {
      float s = 0.0f;
      for (int q = 0; q < consumers / 32; ++q) s += m.red[q * N + c];
      partials[((size_t)(n * g.oblk + o_b) * gridDim.x + tile) * g.ow + o0
               + c] = s;
    }
    split_sum::gap_fold(partials, pooled, counters, n * g.oblk + o_b,
                        gridDim.x, gridDim.x * g.nsplit, g.ow, g.hw,
                        reinterpret_cast<int*>(m.red), kBarGap, consumers);
  }
}

// The instance of a build (0: f32, 1: bf16) at wgmma width `lanes`.
void* pick_tile(int lanes, bool bf16) {
  switch (lanes) {
    case 8: return bf16 ? (void*)pointwise_tile_kernel_bf16<8>
                        : (void*)pointwise_tile_kernel<8>;
    case 16: return bf16 ? (void*)pointwise_tile_kernel_bf16<16>
                         : (void*)pointwise_tile_kernel<16>;
    case 32: return bf16 ? (void*)pointwise_tile_kernel_bf16<32>
                         : (void*)pointwise_tile_kernel<32>;
    case 64: return bf16 ? (void*)pointwise_tile_kernel_bf16<64>
                         : (void*)pointwise_tile_kernel<64>;
    case 128: return bf16 ? (void*)pointwise_tile_kernel_bf16<128>
                          : (void*)pointwise_tile_kernel<128>;
  }
  return nullptr;
}

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device);
// `slot` names the instance (five f32 widths, then five bf16).
cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
  static int allowed[kMaxDevices][10];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int& have = allowed[device][slot];
  if (bytes <= have || bytes <= 48 * 1024) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// The launch of the f32 tile or (bf16) its bf16 build on the plan's int
// array; the shared memory must be that build's smem_bytes.
int launch_tile(bool bf16, const void* x, const void* w, const void* bias,
                const void* residual, void* out, void* partials,
                void* pooled, void* counters, const int* plan,
                void* stream) {
  Geometry g;
  int* fields = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kGeometryInts; ++i) fields[i] = plan[i];
  const int* more = plan + kGeometryInts;
  const int lanes = more[0], wgs = more[1];
  const int tiles = more[2], n = more[3], smem = more[4];
  const void* kernel = pick_tile(lanes, bf16);
  const int kstep = bf16 ? 16 : 8;
  const int padded = bf16 ? pwbf16::kpad(g) : kpad(g);
  const size_t need = bf16 ? pwbf16::smem_bytes(g, lanes, wgs)
                           : smem_bytes(g, lanes, wgs);
  if (kernel == nullptr || wgs < 1 || wgs > kMaxConsumers
      || g.rows != kRows * wgs || g.chunk % kstep != 0 || g.chunk < kstep
      || padded % g.chunk != 0 || g.nsplit < 1
      || (g.nsplit - 1) * lanes >= g.ow || g.nsplit * lanes < g.ow
      || tiles != (g.hw + g.rows - 1) / g.rows || (size_t)smem != need
      || (g.gap && (!partials || !pooled || !counters))) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles == 0 || n == 0) return 0;
  int slot = bf16 ? 5 : 0;
  for (int l = lanes; l > 8; l /= 2) ++slot;
  cudaError_t err = allow_smem(kernel, slot, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x, &w, &bias, &residual, &out, &partials, &pooled,
                  &counters, &g};
  err = cudaLaunchKernel(kernel, dim3(tiles, g.oblk * g.nsplit, n),
                         dim3(kWarpgroup * (wgs + 1)), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The compiled geometry, for the wrapper's blocking model: the threads of
// the largest CTA, its consumer warpgroups and the rows of an m-tile.
void conv2d_pointwise_geometry(int* threads, int* consumers, int* rows) {
  *threads = kTileThreads;
  *consumers = kMaxConsumers;
  *rows = kRows;
}

// The forward: x, w, the bias and residual (null where absent) into out;
// where the plan asks for GAP, the tiles' sums into partials and the pooled
// features into pooled ([N, Co]), with two zeroed int32 counters an (image,
// output block).  plan: the Geometry fields in order, then the wgmma width,
// the consumer warpgroups, an image's tiles, the images and the dynamic
// shared memory (which must be smem_bytes's).
int conv2d_pointwise_tile(const void* x, const void* w, const void* bias,
                          const void* residual, void* out, void* partials,
                          void* pooled, void* counters, const int* plan,
                          void* stream) {
  return launch_tile(false, x, w, bias, residual, out, partials, pooled,
                     counters, plan, stream);
}

// The bf16 build of the forward: the same arguments, x, w, the residual,
// out and pooled bf16, the bias and partials f32; the plan's chunk a
// multiple of 16 and its shared memory pwbf16::smem_bytes's.
int conv2d_pointwise_tile_bf16(const void* x, const void* w,
                               const void* bias, const void* residual,
                               void* out, void* partials, void* pooled,
                               void* counters, const int* plan,
                               void* stream) {
  return launch_tile(true, x, w, bias, residual, out, partials, pooled,
                     counters, plan, stream);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
