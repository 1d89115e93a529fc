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
// is the same function on bf16 operands, the reference's forward under
// BF16, in a design of its own: the dense forward's Hopper design
// (fwd_tile.cuh, bf16) at 1x1, on m-tiles that run across images.
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
#include "fwd_tile.cuh"
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
constexpr int kBarBias = kBarGap + 1;   // the bf16 build's bias rows

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
// the bf16 build
// ---------------------------------------------------------------------------
//
// `pointwise_tile_kernel_bf16<N>`: the same function on bf16 operands, the
// reference's `_pw_fwd_kernel` under BF16 (src/repro/kernels/
// conv2d_pointwise.py:56, pallas_call :211, the casts in `_pwconv` :352): x,
// w and the residual bf16 (the wrapper casts the f32 master weights once a
// call), the sums f32 on bf16 wgmma (m64nNk16, one product a MAC), the
// epilogue act(acc + b) with an f32 bias, then + r in f32, rounded once to
// bf16 at the store; the GAP sums the stored bf16 values in f32 and the
// pooled features leave as bf16.  The dense forward's Hopper design
// (fwd_tile.cuh, bf16) at 1x1, on the flattened (image, position) rows:
//
// * m-tiles that run across images.  The GEMM's rows are the N x H*W
//   positions in (image, position) order; an item is `rows` = 64 x
//   consumers consecutive rows of it by N lanes of one output block (half
//   of a 128-lane block where `nsplit` is 2), so a small map pads only the
//   last m-tile of the whole batch (7x7 at batch 8: 392 rows, 448 issued)
//   rather than each image to whole tiles, and one weight stage serves the
//   positions of several images.  A consumer whose m-tile lies past the
//   last row issues no wgmma.
// * A from shared memory by descriptor.  A row of A is one position's
//   channels [c0, c0 + chunk): one row of a K-major operand in the 128-,
//   64- or 32-byte swizzle at 64, 32 or 16 channels; a chunk of 128 is two
//   such rows (two halves of a slot, each its own swizzled operand).  The
//   rows land by TMA from a map over x [N, Ci/Cib, H*W, Cib] in boxes of
//   `brows` rows of one image, each at its row's place in the slot: for
//   each image an item touches, its run [a, b) of rows in boxes at a, a +
//   brows, ..., the last moved back to end at b (boxes that overlap bring
//   the same bytes), or where the run is shorter than a box one box that
//   ends at the image's end or starts at its first row, reaching into the
//   slot's spare rows before or after the item (`front`, `brows`).  No box
//   reaches past its image, so no two boxes write one cell with other
//   bytes.  Every box lands on a 128-byte line: the kernel takes TMA for x
//   only where H*W and `brows` are whole lines of cells (any H*W at chunk
//   64 or 128; chunk 16 or 32 at an odd H*W such as 49 takes the copies
//   below).  An m-tile is 64 consecutive rows from `front` + 64 c, the same
//   place in every item.
// * B as the dense forward lands it (fwd_tile.cuh b_lanes, b_desc): the
//   chunk's weights [chunk][N], Cob contiguous, read MN-major through the
//   transpose bit, as rows of nin = min(N, 64) lanes in the swizzle of nin *
//   2 bytes, one TMA box a stage.  A stage's x boxes and its weight box
//   complete one mbarrier (`full`); the consumers free the slot through
//   another (`empty`).
// * One wait a stage, one accumulator.  A stage is one wgmma fence, its
//   chunk / 16 k16 steps at the full N width into the one f32 accumulator
//   (straight-line code: S a template argument), and one commit; the
//   consumer then waits for the stage before (wait<1>) and frees its slot.
//   Every descriptor is built from values the compiler knows are uniform
//   (kernel parameters, the warpgroup index read with __shfl_sync).  At 128
//   lanes the accumulator is 64 registers, so a CTA takes three consumers
//   at every width.  Over MobileNet's longest contraction (K = 1024: 64 k16
//   slices added rounding toward zero) the sum drifts by at most 64 f32 ulps
//   of its running magnitude, inside the dgrad's stated bound
//   (dgrad_tile.cuh, bf16).
// * A persistent grid and a deep ring.  As many CTAs as the card holds at
//   once (dgrad_tile::bf16::resident_ctas) walk the items (row item fastest,
//   then output block x lane split); the ring of 2-4 slots (`ring`, chosen
//   with the tiles to fit 232,448 bytes) runs on across items, so the next
//   item's first stages land while this item's last wgmmas and its epilogue
//   run.  Warp 0 of the producer issues every TMA copy in the consumers'
//   order; its other warps leave.
// * The copies path, for correctness where TMA cannot take the strides (Cib
//   or Cob not a multiple of 8, Cob not whole nin-lane rows) or the box
//   alignment (above): the producer's 128 threads write the same swizzled
//   cells, x a 16-byte piece a thread by 2-byte loads, the weights by
//   2-byte loads and stores, zeros past the last row, past Cib and past
//   Cob.  None of MobileNet's legs takes it.
// * The epilogue and the GAP as the dense forward's (fwd_tile.cuh bf16
//   store_out): the activation, the residual and the GAP compile-time
//   choices (the GAP a template argument of the kernel: its 128-lane
//   epilogue takes two consumers at most, at three it spilled), a quad's
//   column pairs turned into 16-byte stores; each bias pair read once, from
//   a row of shared memory that the consumers fill by cp.async at the
//   item's start (read at the epilogue from global memory it cost the tile
//   15 %, the parts probe `no_bias`); a row f is position f % (H*W) of
//   image f / (H*W).  With GAP each item writes, for each image it touches,
//   the sums of its stored values in that image's rows (a thread's two
//   rows, a warp's row groups by shuffles, the consumer warps in order)
//   into the image's partial slot (the item's place among the items that touch the
//   image); the image's last item zeroes its unused slots; then, after one
//   fence for all of the item's images, the last of an image's arrivals
//   folds its slots in order (split_sum.cuh's protocol, `gap_arrive`), the
//   sum conv2d_common.gap_finalize takes of the partials.  No sum depends
//   on the order CTAs run in: two runs give identical bits.
//
// What bounds it on this card: at MobileNet's legs at batch 8 the work is
// 0.01-0.41 G MACs a leg, under 2 us of tensor-core time at 989 TFLOP/s,
// so the time is latency: the contraction's stages through the ring (1-16
// of them; without its copies the tile keeps 70 % of its time), an item's
// end (without its epilogue, 76 %; launch/separable_parts_ab.py, PERF.md).
// What was tried and not kept: the bias prefetched into L1 (no gain); the
// geometry passed by reference to `gap_arrive` (a stack frame: every wgmma
// waited for at 8-32 lanes); the first bf16 build (A loaded into registers
// at every k16 step with a wait between consecutive steps, the weights by
// 16-byte cp.async in 8-lane runs into interleaved core matrices, x rows by
// the producer's cp.async into padded rows, two slots and a CTA an (image
// tile, output block) whose tiles never straddled images: 0.3309 ms over
// the 13 legs at batch 8 as CUDA graphs against cuDNN bf16's 0.1548).
namespace pwbf16 {

using bf = __nv_bfloat16;
namespace db = dgrad_tile::bf16;
namespace fb = fwd_tile::bf16;

constexpr int kAtom = db::kAtom;          // the 128-byte swizzle's period
constexpr int kMaxRing = 4;               // ring slots at most
constexpr int kBarBytes = 8 * 2 * kMaxRing;   // full and empty a slot
constexpr int kSmemBlock = db::kSmemBlock;
constexpr int kMaxBox = 256;              // a TMA box's extent at most
constexpr int kHalf = 64;                 // channels of a 128-byte row
constexpr int kLoadBatch = fb::kLoadBatch;

// The launch geometry, passed by value; its fields are the int array the
// host builds once per shape (core/blocking.py pointwise_plan_ints).
struct Geometry {
  int kblk, kw;      // the contraction: input blocks of kw channels
  int oblk, ow;      // the output: blocks of ow lanes
  int hw, n;         // positions of an image, images
  int rows;          // rows of an item: 64 x consumer warpgroups
  int nsplit;        // columns an output block's lanes split into, N each
  int chunk;         // channels a stage contracts: 16, 32, 64 or 128
  int act;
  int gap;           // 1: the forward folds the GAP
  int ring;          // ring slots, 2-4
  int brows;         // rows of one TMA box of x
  int slots;         // GAP partial slots an image: the most items on one
};
constexpr int kGeometryInts = sizeof(Geometry) / sizeof(int);

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Cib rounded up to the k16 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.kw, 16) * 16;
}

__host__ __device__ inline int stages(const Geometry& g) {
  return g.kblk * (kpad(g) / g.chunk);
}

__host__ __device__ inline int wgs(const Geometry& g) {
  return g.rows / kRows;
}

// threads of the largest CTA (the launch bound): three consumers, but two
// at 128 lanes with GAP, whose epilogue spilled at three (128 registers a
// thread)
__host__ __device__ constexpr int max_threads(int lanes, bool gap) {
  return lanes == 128 && gap ? kWarpgroup * 3 : kTileThreads;
}

// a slot's A halves (a chunk of 128 is two 128-byte rows a position), the
// channels of one, and the bytes of its rows
__host__ __device__ inline int half_elems(const Geometry& g) {
  return g.chunk < kHalf ? g.chunk : kHalf;
}
__host__ __device__ inline int halves(const Geometry& g) {
  return g.chunk / half_elems(g);
}
__host__ __device__ inline int cell_bytes(const Geometry& g) {
  return 2 * half_elems(g);
}

// rows of one 128-byte line
__host__ __device__ inline int line_cells(const Geometry& g) {
  return 128 / cell_bytes(g);
}

// the spare rows before an item's first (a box may reach back as far as
// brows - 1 rows), in whole lines; a slot's rows: the spare, the item's
// and as many spare after
__host__ __device__ inline int front(const Geometry& g) {
  return ceil_div(g.brows, line_cells(g)) * line_cells(g);
}
__host__ __device__ inline int slot_rows(const Geometry& g) {
  return front(g) + g.rows + g.brows;
}

__host__ __device__ inline int round_atom(int bytes) {
  return ceil_div(bytes, kAtom) * kAtom;
}

// bytes of one A half, of the weights, of a stage's slot, in whole swizzle
// periods
__host__ __device__ inline int half_bytes(const Geometry& g) {
  return round_atom(slot_rows(g) * cell_bytes(g));
}
__host__ __device__ inline int weight_bytes(const Geometry& g, int lanes) {
  return round_atom(2 * g.chunk * lanes);
}
__host__ __device__ inline int stage_bytes(const Geometry& g, int lanes) {
  return halves(g) * half_bytes(g) + weight_bytes(g, lanes);
}

// with GAP, the consumer warps' f32 sums [4 * wgs][lanes] and the last
// arrival's flag
__host__ __device__ inline int gap_bytes(const Geometry& g, int lanes) {
  return g.gap ? 16 * wgs(g) * lanes + 16 : 0;
}

// Dynamic shared memory of one CTA (core/blocking.py pointwise_smem_bytes
// at op_bytes 2): a swizzle period to align the base, the ring's slots,
// the mbarriers, two bias rows, the GAP sums.
__host__ inline size_t smem_bytes(const Geometry& g, int lanes) {
  return (size_t)kAtom + (size_t)g.ring * stage_bytes(g, lanes) + kBarBytes
         + 8 * lanes + gap_bytes(g, lanes);
}

// TMA needs global strides of whole 16 bytes (x where Cib is a multiple of
// 8, the weights where Cob is, and a whole number of nin-lane rows), and
// x's boxes land on whole 128-byte lines
__host__ __device__ inline bool tma_x(const Geometry& g) {
  return g.kw % 8 == 0 && g.hw % line_cells(g) == 0
         && g.brows % line_cells(g) == 0 && g.brows <= g.hw;
}
__host__ __device__ inline bool tma_w(const Geometry& g, int lanes) {
  return g.ow % 8 == 0 && g.ow % fb::b_lanes(lanes) == 0;
}
__host__ __device__ inline bool tma(const Geometry& g, int lanes) {
  return tma_x(g) && tma_w(g, lanes);
}

// the items a launch walks: the row items, then each output column's
__host__ __device__ inline int row_items(const Geometry& g) {
  return ceil_div(g.n * g.hw, g.rows);
}

// the row items that touch image k: [first, last]
__host__ __device__ inline int first_item(const Geometry& g, int k) {
  return k * g.hw / g.rows;
}
__host__ __device__ inline int last_item(const Geometry& g, int k) {
  return ((k + 1) * g.hw - 1) / g.rows;
}

// The most row items that touch one image (the count repeats every `rows`
// images: image k + rows starts hw items on).
__host__ inline int gap_slots(const Geometry& g) {
  int most = 0;
  for (int k = 0; k < std::min(g.n, g.rows); ++k) {
    most = std::max(most, last_item(g, k) - first_item(g, k) + 1);
  }
  return most;
}

// Whether the kernel takes this geometry at wgmma width `lanes` (the
// chooser's rules, core/blocking.py _pointwise_bf16_candidates).
__host__ inline bool valid(const Geometry& g, int lanes) {
  return (lanes == 8 || lanes == 16 || lanes == 32 || lanes == 64
          || lanes == 128)
         && g.rows % kRows == 0 && wgs(g) >= 1
         && wgs(g) <= kMaxConsumers
         && (g.chunk == 16 || g.chunk == 32 || g.chunk == 64
             || g.chunk == 128)
         && kpad(g) % g.chunk == 0 && g.kblk >= 1 && g.kw >= 1
         && g.oblk >= 1 && g.ow >= 1 && g.hw >= 1 && g.n >= 0
         && (long long)g.n * g.hw < (1ll << 30) && g.nsplit >= 1
         && (g.nsplit - 1) * lanes < g.ow && g.nsplit * lanes >= g.ow
         && g.act >= 0 && g.act <= kActGelu && g.ring >= 2
         && g.ring <= kMaxRing && g.brows >= 1 && g.brows <= kMaxBox
         && (g.gap == 0 || g.gap == 1)
         && kWarpgroup * (wgs(g) + 1) <= max_threads(lanes, g.gap)
         && (g.gap == 0 || g.n == 0 || g.slots == gap_slots(g))
         && smem_bytes(g, lanes) <= (size_t)kSmemBlock;
}

// What a launch runs (core/blocking.py pointwise_plan at op_bytes 2):
// out[0] the items, out[1] the function's MACs, out[2] the tensor-core MACs
// the items issue (every m-tile that holds a row, by `lanes` over Cib
// padded to k16 slices, one product each), out[3] a CTA's shared memory,
// out[4] its ring slots, out[5] the GAP slots an image.
__host__ inline void plan(const Geometry& g, int lanes, long long* out) {
  const long long rows = (long long)g.n * g.hw;
  out[0] = (long long)row_items(g) * g.oblk * g.nsplit;
  out[1] = rows * g.kblk * g.kw * g.oblk * g.ow;
  out[2] = (rows + kRows - 1) / kRows * kRows * g.oblk * g.nsplit * lanes
           * g.kblk * kpad(g);
  out[3] = (long long)smem_bytes(g, lanes);
  out[4] = g.ring;
  out[5] = g.gap ? g.slots : 0;
}

// The carve-up of one CTA (smem_bytes): the ring's slots ([A halves |
// weights] each), the mbarriers, two bias rows, then with GAP the consumer
// warps' sums and a flag.
struct Smem {
  char* slot0;
  uint64_t* full;      // [kMaxRing]
  uint64_t* empty;     // [kMaxRing]
  float* bias;         // [2][N] the items' bias rows
  float* red;          // [4 * wgs][N]
  int* flag;
  int stage, a_bytes;
};

template <int N>
__device__ inline Smem carve(char* raw, const Geometry& g) {
  Smem m;
  m.slot0 = raw + ((kAtom - (dt::smem_u32(raw) & (kAtom - 1))) & (kAtom - 1));
  m.stage = stage_bytes(g, N);
  m.a_bytes = halves(g) * half_bytes(g);
  m.full = reinterpret_cast<uint64_t*>(m.slot0 + g.ring * m.stage);
  m.empty = m.full + kMaxRing;
  m.bias = reinterpret_cast<float*>(m.empty + kMaxRing);
  m.red = m.bias + 2 * N;
  m.flag = reinterpret_cast<int*>(m.red + 4 * wgs(g) * N);
  return m;
}

// A work item of the persistent grid: row item `ri` (rows [f0, f1) of the
// flattened (image, position) axis) of output column (block o_b, lane
// split `split`).
struct Item {
  int ri, o_b, split, f0, f1;
};

__device__ __forceinline__ Item item_of(const Geometry& g, int i) {
  Item it;
  const int ritems = row_items(g);
  it.ri = i % ritems;
  const int col = i / ritems;
  it.o_b = col / g.nsplit;
  it.split = col - it.o_b * g.nsplit;
  it.f0 = it.ri * g.rows;
  it.f1 = min(it.f0 + g.rows, g.n * g.hw);
  return it;
}

// Visit the TMA boxes that land an item's rows: for each image k it
// touches, its run [a, b) of rows in boxes of brows rows inside the image
// (see the header), `visit(k, q)` with q the box's first row in the image;
// -> the boxes' count.
template <typename Visit>
__device__ __forceinline__ int for_boxes(const Geometry& g, const Item& it,
                                         Visit visit) {
  const int bb = g.brows;
  int count = 0;
  for (int k = it.f0 / g.hw; k * g.hw < it.f1; ++k) {
    const int a = max(it.f0 - k * g.hw, 0);
    const int b = min(it.f1 - k * g.hw, g.hw);
    const int nb = b - a > bb ? ceil_div(b - a, bb) : 1;
    for (int j = 0; j < nb; ++j, ++count) {
      const int q = j < nb - 1 ? a + j * bb
                               : (b - a >= bb ? b - bb : min(a, g.hw - bb));
      visit(k, q);
    }
  }
  return count;
}

// Issue stage (kb, c0)'s x boxes of an item (lane `lane` of 32 taking
// every 32nd box) into the slot's A halves at `a`.
__device__ void issue_x(const CUtensorMap* tmx, char* a, uint64_t* bar,
                        const Geometry& g, const Item& it, int kb, int c0,
                        int lane) {
  const int cb = cell_bytes(g);
  const int hb = half_bytes(g);
  const int base = front(g) - it.f0;
  int idx = 0;
  for_boxes(g, it, [&](int k, int q) {
    if (idx++ % 32 != lane) return;
    char* dst = a + (base + k * g.hw + q) * cb;
    for (int h = 0; h < halves(g); ++h) {
      dt::tma_load_4d(dst + h * hb, tmx, bar, c0 + h * kHalf, q, kb, k);
    }
  });
}

// The same cells by copies (`tid` of the producer's kWarpgroup): the
// item's rows [f0, f0 + rows), a 16-byte piece a thread a pass, its 8
// channels by 2-byte loads, zeros past the last row and past Cib, stored at
// its swizzled place.
__device__ void copy_x(const bf* __restrict__ x, char* a, const Geometry& g,
                       const Item& it, int kb, int c0, int tid) {
  const int cb = cell_bytes(g);
  const int hb = half_bytes(g);
  const int per_half = half_elems(g) / 8;
  const int pieces = g.chunk / 8;
  const int total = g.n * g.hw;
  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(x);
  const uint32_t base = dt::smem_u32(a) + front(g) * cb;
  for (int i = tid; i < g.rows * pieces; i += kWarpgroup) {
    const int r = i / pieces;
    const int p = i - r * pieces;
    const int f = it.f0 + r;
    const int k = f < total ? f / g.hw : 0;
    const int valid = f < total ? min(g.kw - c0 - 8 * p, 8) : 0;
    const unsigned short* src =
        x16 + ((size_t)(k * g.kblk + kb) * g.hw + (f - k * g.hw)) * g.kw
        + c0 + 8 * p;
    unsigned short v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = e < valid ? __ldg(src + e) : (unsigned short)0;
    }
    uint32_t words[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      words[e] = (uint32_t)v[2 * e] | ((uint32_t)v[2 * e + 1] << 16);
    }
    const uint32_t at = base + (p / per_half) * hb + r * cb
                        + 16 * (p % per_half);
    fb::st_v4(db::swizzled(at, cb), words);
  }
}

// The byte of weight (lane l, channel k) in a slot's weights at `base`, as
// the TMA box lands it: [N / nin][chunk][nin], rows of nin lanes in the
// swizzle of nin * 2 bytes (none at nin 8).
template <int N>
__device__ __forceinline__ uint32_t weight_at(uint32_t base,
                                              const Geometry& g, int l,
                                              int k) {
  constexpr int nin = fb::b_lanes(N);
  const uint32_t at = base + ((l / nin) * g.chunk + k) * nin * 2
                      + (l % nin) * 2;
  return nin >= 16 ? db::swizzled(at, nin * 2) : at;
}

// The stage's weights by 2-byte loads, kLoadBatch in flight, and stores
// (`tid` of the producer's kWarpgroup), zeros past Cib and past Cob.
template <int N>
__device__ void copy_w(const bf* __restrict__ w, char* dst, const Geometry& g,
                       int o_b, int kb, int c0, int o0, int tid) {
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w)
      + ((size_t)(o_b * g.kblk + kb) * g.kw + c0) * g.ow + o0;
  const uint32_t base = dt::smem_u32(dst);
  const int total = N * g.chunk;
  for (int i0 = tid; i0 < total; i0 += kWarpgroup * kLoadBatch) {
    unsigned short v[kLoadBatch];
    uint32_t at[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int i = i0 + b * kWarpgroup;
      const int l = i % N;                      // (k, l), lanes fastest
      const int k = i / N;
      const bool ok = i < total && c0 + k < g.kw && o0 + l < g.ow;
      v[b] = ok ? __ldg(wb + (size_t)k * g.ow + l) : (unsigned short)0;
      at[b] = weight_at<N>(base, g, l, k);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      if (i0 + b * kWarpgroup < total) db::st_u16(at[b], v[b]);
    }
  }
}

// One landed stage into the accumulator as one wgmma group: its S = chunk
// / 16 k16 steps, A's 32 bytes apart within a half (a chunk of 128: steps
// 4-7 in the second half, `hb` on), B's 32 nin bytes apart.  Straight-line
// code (S a template argument).
template <int N, int S>
__device__ __forceinline__ void mma_stage(float (&acc)[N / 2], uint32_t a,
                                          uint32_t b, uint32_t hb,
                                          uint64_t adesc, uint64_t bdesc) {
  dt::wgmma_fence();
#pragma unroll
  for (int k = 0; k < S; ++k) {
    db::wgmma_ss<N, 1>(acc, db::desc_at(adesc, a + (k / 4) * hb
                                                   + 32 * (k % 4)),
                       db::desc_at(bdesc, b + 32 * fb::b_lanes(N) * k));
  }
  dt::wgmma_commit();
}

template <int N>
__device__ __forceinline__ void mma_any(float (&acc)[N / 2], int chunk,
                                        uint32_t a, uint32_t b, uint32_t hb,
                                        uint64_t adesc, uint64_t bdesc) {
  if (chunk == 64) {
    mma_stage<N, 4>(acc, a, b, hb, adesc, bdesc);
  } else if (chunk == 128) {
    mma_stage<N, 8>(acc, a, b, hb, adesc, bdesc);
  } else if (chunk == 32) {
    mma_stage<N, 2>(acc, a, b, hb, adesc, bdesc);
  } else {
    mma_stage<N, 1>(acc, a, b, hb, adesc, bdesc);
  }
}

// The GAP's arrivals of an item's images [k0, k1] once every consumer
// thread has stored its partials (split_sum.cuh's protocol, one fence for
// all the images): thread 0 arrives on each image's counter, 32 images a
// round, and the last of an image's arrivals (every item and lane split
// that touches it) sums its slots in order into `pooled`, times the f32
// reciprocal of H * W.  Out of line, so that none of its values is hoisted
// into the main loop; its arguments are scalars (a Geometry passed by
// reference took a stack frame, and ptxas then waited for every wgmma at
// 8-32 lanes).
__device__ __noinline__ void gap_arrive(const float* partials, bf* pooled,
                                        int* counters, int hw, int rows,
                                        int oblk, int nsplit, int ow,
                                        int slots, int o_b, int k0, int k1,
                                        int* flag, int consumers) {
  __threadfence();                // this thread's partials, to the card
  for (int kk = k0; kk <= k1; kk += 32) {
    const int kn = min(k1, kk + 31);
    // every thread's partials (and the last round's flag read)
    dt::bar_sync(kBarGap, consumers);
    if (threadIdx.x == 0) {
      unsigned last = 0;
      for (int k = kk; k <= kn; ++k) {
        // the items that touch image k, every lane split's
        const int arrivals =
            (((k + 1) * hw - 1) / rows - k * hw / rows + 1) * nsplit;
        int* counter = counters + k * oblk + o_b;
        if (atomicAdd(counter, 1) == arrivals - 1) {
          atomicExch(counter, 0);
          last |= 1u << (k - kk);
        }
      }
      if (last) __threadfence();  // the other arrivals' rows, visible here
      *flag = (int)last;
    }
    dt::bar_sync(kBarGap, consumers);
    const unsigned last = (unsigned)*flag;
    for (int k = kk; k <= kn; ++k) {
      if ((last >> (k - kk)) & 1u) {
        const size_t column = (size_t)k * oblk + o_b;
        split_sum::sum_rows(partials + column * slots * ow, ow, slots,
                            pooled + column * ow, ow,
                            __frcp_rn((float)hw), threadIdx.x, consumers);
      }
    }
  }
}

// The epilogue of consumer c's m-tile in f32, one rounding to bf16 at the
// store: m-tile row q is flattened row f = f0 + 64 c + q, position f % H*W
// of image f / H*W, stored where f lies below N x H*W.  With GAP, for each
// image the item touches, the sums of the stored values in its rows into
// that image's partial slot, and the image's last arrival's fold into
// `pooled`.  `brow`: the item's N bias lanes in shared memory (0 past
// Cob), or null.
template <int N, int kAct, bool kGap>
__device__ __forceinline__ void store_out(float (&acc)[N / 2],
                                          const Geometry& g, const Item& it,
                                          int c, const Smem& m,
                                          const float* brow,
                                          const bf* __restrict__ residual,
                                          bf* __restrict__ out,
                                          float* partials,
                                          bf* __restrict__ pooled,
                                          int* counters) {
  const int lane = threadIdx.x % 32;
  const int local = threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int total = g.n * g.hw;
  const int o0 = it.split * N;
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.ow % 2 == 0;
  bool row_ok[2];
  int img[2];
  size_t base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = it.f0 + c * kRows + local + 8 * h;
    row_ok[h] = f < total;
    img[h] = row_ok[h] ? f / g.hw : 0;
    const int p = f - img[h] * g.hw;
    base[h] = ((size_t)(img[h] * g.oblk + it.o_b) * g.hw + p) * g.ow + o0;
  }
  // A quad of lanes (t = lane % 4) holds a row's 8-column groups, a column
  // pair a lane; four groups at a time are turned among the quad by
  // shuffles so that lane t stores group 4q + t's 16 bytes in one store,
  // where Cob is a multiple of 8.
  constexpr int kGJ = N / 8 < 4 ? N / 8 : 4;       // groups turned at once
  const bool vec = kGJ == 4 && g.ow % 8 == 0;
  const int t = lane % 4;
#pragma unroll
  for (int q = 0; q < N / 8 / kGJ; ++q) {
    uint32_t pk[2][kGJ];        // each row's bf16 pair of each group
    bool cok[kGJ][2];           // the pair's columns below Cob
#pragma unroll
    for (int u = 0; u < kGJ; ++u) {
      const int jj = q * kGJ + u;
      const int col = 8 * jj + col0;
      // the column pair's bias, once for both rows (0 past Cob)
      float bv[2] = {0.0f, 0.0f};
      if (brow != nullptr) {
        const float2 b2 = *reinterpret_cast<const float2*>(brow + col);
        bv[0] = b2.x;
        bv[1] = b2.y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) cok[u][e] = o0 + col + e < g.ow;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row_ok[h] && cok[u][e];
          float v32 = activate(acc[4 * jj + 2 * h + e] + bv[e], kAct);
          if (residual != nullptr && ok) {
            v32 += __bfloat162float(residual[base[h] + col + e]);
          }
          v[e] = __float2bfloat16_rn(v32);
          if (kGap) {
            acc[4 * jj + 2 * h + e] = ok ? __bfloat162float(v[e]) : 0.0f;
          }
        }
        pk[h][u] = (uint32_t)__bfloat16_as_ushort(v[0])
                   | ((uint32_t)__bfloat16_as_ushort(v[1]) << 16);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kGJ == 4) {
        if (vec) {
          // lane t gathers group 4q + t's pair from each lane s of its
          // quad into word s
          auto pick = [&](int i) {
            return i == 0 ? pk[h][0]
                          : (i == 1 ? pk[h][1] : (i == 2 ? pk[h][2]
                                                          : pk[h][3]));
          };
          uint32_t w[4];
          const uint32_t own = pick(t);
#pragma unroll
          for (int s = 0; s < 4; ++s) w[s] = s == t ? own : 0u;
#pragma unroll
          for (int k = 1; k < 4; ++k) {
            const uint32_t got = __shfl_xor_sync(0xffffffffu, pick(t ^ k),
                                                 k);
#pragma unroll
            for (int s = 0; s < 4; ++s) w[s] = s == (t ^ k) ? got : w[s];
          }
          const int col8 = 8 * (4 * q + t);
          if (row_ok[h] && o0 + col8 < g.ow) {
            asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n"
                         :: "l"(out + base[h] + col8), "r"(w[0]), "r"(w[1]),
                            "r"(w[2]), "r"(w[3])
                         : "memory");
          }
          continue;
        }
      }
#pragma unroll
      for (int u = 0; u < kGJ; ++u) {
        const int col = 8 * (q * kGJ + u) + col0;
        if (!row_ok[h]) continue;
        if (pairs && cok[u][1]) {
          *reinterpret_cast<uint32_t*>(out + base[h] + col) = pk[h][u];
        } else {
          if (cok[u][0]) {
            out[base[h] + col] =
                __ushort_as_bfloat16((unsigned short)(pk[h][u] & 0xFFFF));
          }
          if (cok[u][1]) {
            out[base[h] + col + 1] =
                __ushort_as_bfloat16((unsigned short)(pk[h][u] >> 16));
          }
        }
      }
    }
  }
  if (!kGap) return;
  // for each image of the item: a thread's two rows of that image, a
  // warp's eight row groups by shuffles, then the consumer warps in order
  const int consumers = wgs(g) * kWarpgroup;
  const int wid = threadIdx.x / 32;
  const int k0 = it.f0 / g.hw, k1 = (it.f1 - 1) / g.hw;
  for (int k = k0; k <= k1; ++k) {
    if (k > k0) dt::bar_sync(kBarGap, consumers);   // red read: reuse it
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = (img[0] == k ? acc[4 * jj + e] : 0.0f)
                  + (img[1] == k ? acc[4 * jj + 2 + e] : 0.0f);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) m.red[wid * N + 8 * jj + col0 + e] = s;
      }
    }
    dt::bar_sync(kBarGap, consumers);
    const int first = first_item(g, k);
    const int count = last_item(g, k) - first + 1;
    const int slot = it.ri - first;
    const int cl = threadIdx.x;
    if (cl < N && o0 + cl < g.ow) {
      float s = 0.0f;
      for (int w = 0; w < consumers / 32; ++w) s += m.red[w * N + cl];
      float* part = partials + (size_t)(k * g.oblk + it.o_b) * g.slots * g.ow
                    + o0 + cl;
      part[(size_t)slot * g.ow] = s;
      // the image's last item: its unused slots hold 0
      if (slot == count - 1) {
        for (int z = count; z < g.slots; ++z) part[(size_t)z * g.ow] = 0.0f;
      }
    }
  }
  gap_arrive(partials, pooled, counters, g.hw, g.rows, g.oblk, g.nsplit,
             g.ow, g.slots, it.o_b, k0, k1, m.flag, consumers);
}

// store_out at the geometry's activation, a compile-time constant of its
// own copy, and the kernel's GAP.
template <int N, bool kGap>
__device__ __forceinline__ void store_any(float (&acc)[N / 2],
                                          const Geometry& g, const Item& it,
                                          int c, const Smem& m,
                                          const float* brow,
                                          const bf* __restrict__ residual,
                                          bf* __restrict__ out,
                                          float* partials,
                                          bf* __restrict__ pooled,
                                          int* counters) {
#define PW_STORE(act)                                                      \
  store_out<N, act, kGap>(acc, g, it, c, m, brow, residual, out, partials,  \
                          pooled, counters)
  if (g.act == kActRelu) {
    PW_STORE(kActRelu);
  } else if (g.act == kActGelu) {
    PW_STORE(kActGelu);
  } else {
    PW_STORE(0);
  }
#undef PW_STORE
}

// x's tensor map: [N][Ci/Cib][H*W][Cib] bf16 with a box of {half_elems,
// brows, 1, 1}, landing brows rows in the half's swizzle, where tma_x.
inline bool encode_x(CUtensorMap* tmx, const void* x, const Geometry& g) {
  const long long kw = g.kw;
  const long long dims[4] = {kw, g.hw, g.kblk, g.n};
  const long long strides[3] = {kw * 2, (long long)g.hw * kw * 2,
                                (long long)g.kblk * g.hw * kw * 2};
  const int box[4] = {half_elems(g), g.brows, 1, 1};
  return db::encode_swizzled(tmx, x, 4, dims, strides, box, cell_bytes(g));
}

// The weights' tensor map: [blocks][Cib][Cob / nin][nin] bf16 with a box of
// {nin, chunk, lanes / nin, 1} (landing [lanes / nin][chunk][nin] in the
// swizzle of nin * 2 bytes), where tma_w.
inline bool encode_w(CUtensorMap* tmw, const void* w, const Geometry& g,
                     int lanes) {
  const int nin = fb::b_lanes(lanes);
  const long long ow = g.ow;
  const long long dims[4] = {nin, g.kw, ow / nin,
                             (long long)g.oblk * g.kblk};
  const long long strides[3] = {ow * 2, nin * 2, g.kw * ow * 2};
  const int box[4] = {nin, g.chunk, lanes / nin, 1};
  if (nin == 8) {
    return dt::encode(tmw, w, 4, dims, strides, box,
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  }
  return db::encode_swizzled(tmw, w, 4, dims, strides, box, nin * 2);
}

}  // namespace pwbf16

// N: the wgmma width (the output lanes an item owns, padded up).  x, w, the
// residual, out and pooled bf16; the bias and the partials f32.  A
// persistent CTA walks the items blockIdx.x, blockIdx.x + gridDim.x, ...
// (pwbf16::item_of).  A stage (input block, chunk) lands its x rows and its
// weights in a slot of the ring: the slot's `full` mbarrier completes as
// its TMA copies land (or once the producer's copies have), its `empty` one
// once every consumer thread's wgmmas of the stage are done.  With GAP:
// `partials` [N, Co/Cob, slots, Cob] f32, `pooled` [N, Co] bf16,
// `counters` an int32 an (image, output block), zeroed.
template <int N, bool kGap>
__global__ void __launch_bounds__(pwbf16::max_threads(N, kGap), 1)
pointwise_tile_kernel_bf16(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmw,
                           const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ residual,
                           __nv_bfloat16* __restrict__ out, float* partials,
                           __nv_bfloat16* __restrict__ pooled, int* counters,
                           pwbf16::Geometry g) {
  namespace pb = pwbf16;
  extern __shared__ __align__(16) char smem_raw[];
  const int consumers = pb::wgs(g) * kWarpgroup;
  const pb::Smem m = pb::carve<N>(smem_raw, g);
  const int ring = g.ring;
  const int per_block = pb::kpad(g) / g.chunk;
  const int count = pb::stages(g);
  const int items = pb::row_items(g) * g.oblk * g.nsplit;
  const bool tma = pb::tma(g, N);
  if (threadIdx.x == 0) {
    for (int i = 0; i < pb::kMaxRing; ++i) {
      dt::mbar_init(&m.full[i], tma ? 1 : kWarpgroup);
      dt::mbar_init(&m.empty[i], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {             // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    // TMA needs warp 0 alone; copies every producer thread
    if (tma && tid >= 32) return;
    if (tma && tid == 0) {      // the maps into the TMA unit's cache
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tmw)) : "memory");
    }
    const int cb = pb::cell_bytes(g);
    int gs = 0;                               // stages so far
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const pb::Item it = pb::item_of(g, i);
      const int o0 = it.split * N;
      const int boxes = tma ? pb::for_boxes(g, it, [](int, int) {}) : 0;
      for (int s = 0; s < count; ++s, ++gs) {
        const int kb = s / per_block;
        const int c0 = (s - kb * per_block) * g.chunk;
        const int slot = gs % ring;
        if (gs >= ring) dt::mbar_wait(&m.empty[slot], ((gs / ring) & 1) ^ 1);
        char* a = m.slot0 + slot * m.stage;
        char* b = a + m.a_bytes;
        if (tma) {
          if (tid == 0) {
            dt::mbar_expect_tx(&m.full[slot],
                               boxes * pb::halves(g) * g.brows * cb
                                   + 2 * g.chunk * N);
          }
          __syncwarp();
          pb::issue_x(&tmx, a, &m.full[slot], g, it, kb, c0, tid);
          if (tid == 0) {
            dt::tma_load_4d(b, &tmw, &m.full[slot], 0, c0,
                            o0 / fwd_tile::bf16::b_lanes(N),
                            it.o_b * g.kblk + kb);
          }
        } else {
          pb::copy_x(x, a, g, it, kb, c0, tid);
          pb::copy_w<N>(w, b, g, it.o_b, kb, c0, o0, tid);
          dt::fence_proxy_async();    // the stores, for wgmma's reads
          pb::db::mbar_arrive(&m.full[slot]);
        }
      }
    }
    return;
  }

  // a consumer: rows 64c.. of each item, its index read warp-uniform so
  // that the descriptors are uniform
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const uint32_t cb = pb::cell_bytes(g);
  const uint32_t hb = pb::half_bytes(g);
  const uint32_t arow = (pb::front(g) + c * kRows) * cb;
  const uint64_t adesc = pb::db::desc_of(cb);
  const uint64_t bdesc = fwd_tile::bf16::b_desc<N>(g.chunk);
  const uint32_t slot0 = dt::smem_u32(m.slot0);
  const int total = g.n * g.hw;
  int gs = 0, walked = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++walked) {
    const pb::Item it = pb::item_of(g, i);
    // an m-tile past the last row issues nothing
    const bool live = it.f0 + c * kRows < total;
    // the item's bias, a lane a thread, copied into one of two rows of
    // shared memory (by the items' parity) while its stages run, 0 past
    // Cob; a thread rewrites a row only past the barrier of the item after
    // the one that read it
    const int cl = threadIdx.x;
    float* brow = bias != nullptr ? m.bias + (walked & 1) * N : nullptr;
    if (brow != nullptr && cl < N) {
      const int o = it.split * N + cl;
      cp_async4(brow + cl, bias + it.o_b * g.ow + min(o, g.ow - 1),
                o < g.ow);
      cp_async_commit();
    }
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;
    for (int s = 0; s < count; ++s, ++gs) {
      const int slot = gs % ring;
      dt::mbar_wait(&m.full[slot], (gs / ring) & 1);
      const uint32_t a = slot0 + slot * m.stage;
      if (live) {
        pb::mma_any<N>(acc, g.chunk, a + arow, a + m.a_bytes, hb, adesc,
                       bdesc);
      }
      if (s > 0) {
        dt::wgmma_wait<1>();      // the stage before is done: free its slot
        pb::db::mbar_arrive(&m.empty[(gs - 1) % ring]);
      }
    }
    dt::wgmma_wait<0>();
    if (count > 0) pb::db::mbar_arrive(&m.empty[(gs - 1) % ring]);
    dt::fence_regs<N / 2>(acc);
    if (brow != nullptr) {              // the bias row, landed and shared
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      dt::bar_sync(kBarBias, consumers);
    }
    pb::store_any<N, kGap>(acc, g, it, c, m, brow, residual, out, partials,
                           pooled, counters);
  }
}

// The f32 tile's instance at wgmma width `lanes`.
void* pick_tile(int lanes) {
  switch (lanes) {
    case 8: return (void*)pointwise_tile_kernel<8>;
    case 16: return (void*)pointwise_tile_kernel<16>;
    case 32: return (void*)pointwise_tile_kernel<32>;
    case 64: return (void*)pointwise_tile_kernel<64>;
    case 128: return (void*)pointwise_tile_kernel<128>;
  }
  return nullptr;
}

// The bf16 build's instance at wgmma width `lanes`.
void* pick_tile_bf16(int lanes, bool gap) {
#define PW_TILE(n)                                                         \
  (gap ? (void*)pointwise_tile_kernel_bf16<n, true>                        \
       : (void*)pointwise_tile_kernel_bf16<n, false>)
  switch (lanes) {
    case 8: return PW_TILE(8);
    case 16: return PW_TILE(16);
    case 32: return PW_TILE(32);
    case 64: return PW_TILE(64);
    case 128: return PW_TILE(128);
  }
#undef PW_TILE
  return nullptr;
}

// Raise an f32 instance's dynamic shared-memory limit once per device to the
// most any launch has asked of it (the attribute is the kernel's, per
// device); `slot` names the instance.
cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
  static int allowed[kMaxDevices][5];
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

// The launch of the f32 tile on the plan's int array; the shared memory
// must be smem_bytes's.
int launch_tile(const void* x, const void* w, const void* bias,
                const void* residual, void* out, void* partials,
                void* pooled, void* counters, const int* plan,
                void* stream) {
  Geometry g;
  int* fields = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kGeometryInts; ++i) fields[i] = plan[i];
  const int* more = plan + kGeometryInts;
  const int lanes = more[0], wgs = more[1];
  const int tiles = more[2], n = more[3], smem = more[4];
  const void* kernel = pick_tile(lanes);
  if (kernel == nullptr || wgs < 1 || wgs > kMaxConsumers
      || g.rows != kRows * wgs || g.chunk % 8 != 0 || g.chunk < 8
      || kpad(g) % g.chunk != 0 || g.nsplit < 1
      || (g.nsplit - 1) * lanes >= g.ow || g.nsplit * lanes < g.ow
      || tiles != (g.hw + g.rows - 1) / g.rows
      || (size_t)smem != smem_bytes(g, lanes, wgs)
      || (g.gap && (!partials || !pooled || !counters))) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles == 0 || n == 0) return 0;
  int slot = 0;
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

// A bf16 plan's int array read: the pwbf16::Geometry fields in order, then
// the wgmma width and the dynamic shared memory -> whether the kernel takes
// it (and the shared memory is the kernel's carve-up).
bool read_plan_bf16(const int* plan, pwbf16::Geometry* g, int* lanes) {
  int* fields = reinterpret_cast<int*>(g);
  for (int i = 0; i < pwbf16::kGeometryInts; ++i) fields[i] = plan[i];
  *lanes = plan[pwbf16::kGeometryInts];
  const int smem = plan[pwbf16::kGeometryInts + 1];
  return pick_tile_bf16(*lanes, g->gap) != nullptr
         && pwbf16::valid(*g, *lanes)
         && (size_t)smem == pwbf16::smem_bytes(*g, *lanes);
}

// The bf16 build's launch: the tensor maps of x and w where the kernel
// takes TMA, then one persistent grid of as many CTAs as the card holds at
// once (or as there are items).
int launch_tile_bf16(const void* x, const void* w, const void* bias,
                     const void* residual, void* out, void* partials,
                     void* pooled, void* counters, const int* plan,
                     void* stream) {
  pwbf16::Geometry g;
  int lanes = 0;
  if (!read_plan_bf16(plan, &g, &lanes)
      || (g.gap && (!partials || !pooled || !counters))) {
    return (int)cudaErrorInvalidValue;
  }
  if (g.n == 0) return 0;
  const void* kernel = pick_tile_bf16(lanes, g.gap);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx, tmw;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmw, 0, sizeof(tmw));
  if (pwbf16::tma(g, lanes) && (!pwbf16::encode_x(&tmx, x, g)
                                || !pwbf16::encode_w(&tmw, w, g, lanes))) {
    return (int)cudaErrorNotSupported;     // the encoder refused a map
  }
  const int threads = kWarpgroup * (pwbf16::wgs(g) + 1);
  const size_t smem = pwbf16::smem_bytes(g, lanes);
  int ctas = 0;
  err = dt::bf16::resident_ctas(kernel, device, threads, smem, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (long long)pwbf16::row_items(g) * g.oblk * g.nsplit;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  void* args[] = {&tmx, &tmw, &x, &w, &bias, &residual, &out, &partials,
                  &pooled, &counters, &g};
  err = cudaLaunchKernel(kernel,
                         dim3((unsigned)std::min<long long>(items, ctas)),
                         dim3(threads), args, smem, (cudaStream_t)stream);
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
  return launch_tile(x, w, bias, residual, out, partials, pooled, counters,
                     plan, stream);
}

// The bf16 build of the forward: the same arguments, x, w, the residual,
// out and pooled bf16, the bias and partials ([N, Co/Cob, slots, Cob]) f32;
// plan: the pwbf16::Geometry fields in order, then the wgmma width and the
// dynamic shared memory (which must be pwbf16::smem_bytes's).
int conv2d_pointwise_tile_bf16(const void* x, const void* w,
                               const void* bias, const void* residual,
                               void* out, void* partials, void* pooled,
                               void* counters, const int* plan,
                               void* stream) {
  return launch_tile_bf16(x, w, bias, residual, out, partials, pooled,
                          counters, plan, stream);
}

// What conv2d_pointwise_tile_bf16 runs with the same plan (pwbf16::plan):
// out[0] the items, out[1] the function's MACs, out[2] the tensor-core MACs
// issued, out[3] a CTA's shared memory, out[4] its ring slots, out[5] the
// GAP slots an image; or cudaErrorInvalidValue where the kernel refuses
// the plan.
int conv2d_pointwise_plan_bf16(const int* plan, long long* out) {
  pwbf16::Geometry g;
  int lanes = 0;
  if (!read_plan_bf16(plan, &g, &lanes)) return (int)cudaErrorInvalidValue;
  pwbf16::plan(g, lanes, out);
  return 0;
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
