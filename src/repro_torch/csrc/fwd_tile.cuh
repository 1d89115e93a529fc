// Dense forward tile on Hopper tensor cores (sm_90a): the device core that
// the window forward (direct_conv2d_fwd.cu, `fwd_kernel`) and the streamed
// forward (conv2d_stream.cu, `stream_fwd_kernel`) share, in f32 (3xTF32)
// and, in namespace `bf16` below, on bf16 operands (`fwd_kernel_bf16`,
// `stream_fwd_kernel_bf16`).
//
// The function, on the paper's blocked layouts:
//
//   x        [N, Ci/Cib, Hi, Wi, Cib]     unpadded; pads are zero-filled copies
//   w        [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]
//   bias     [Co/Cob, Cob]                or null
//   residual [N, Co/Cob, Ho, Wo, Cob]     or null, added after the activation
//   out      [N, Co/Cob, Ho, Wo, Cob]
//   partials [N, Co/Cob, tiles, Cob]      per-tile GAP sums, or null
//
//   out = act(sum_{ci, dh, dw} x[s*cell + (dh - pt, dw - pl), ci]
//                              * w[dh, dw, ci, co] + b) + r
//
// The implicit GEMM.  A CTA owns a tile of th x tw output positions of one
// image (rows M, row-major; a tile never straddles images, so GAP sums stay
// per image; the map's last tiles may overhang it), N lanes of one output
// block (the whole block padded up to a compiled wgmma width, or half of it:
// `nsplit`), and contracts K = (input block, channel of a chunk, tap)
// `chunk` channels of one input block a stage, in one fixed order: the
// stages in (block, chunk) order, in a stage the k8 steps tap by tap and
// eight channels a step.
//
//   A[m, (tap, k)] = x[s*cell(m) + (dh - pt, dw - pl), c0 + k]  (the window)
//   B[(tap, k), n] = w[o_b, i_b, dh, dw, c0 + k, o0 + n]
//
// A is read from the staged halo window into registers at each row's own
// offset, so stride 2 is only an offset and the window needs no im2col
// copy: the tap's shift is added to the row's offset.  B, the weight as
// stored, is N-contiguous (MN-major), which TF32 wgmma does not take: the
// producer stages the stage's raw weights and writes them transposed into
// the core-matrix order [taps * chunk / 4][N][4] as it splits them (as the
// pointwise tile, conv2d_pointwise.cu, does).  No transposed copy of the
// weights exists in device memory.
//
// f32 accuracy from TF32 (3xTF32), as the dgrad and wgrad tiles: each
// operand splits into big + small TF32 halves and big*small + small*big +
// big*big go into one f32 accumulator (dgrad_tile.cuh `issue`).  A splits
// as it is loaded, B once a stage.  The tensor cores add each k8 slice into
// their accumulator rounding toward zero, which over VGG-16's K = 4608
// drifts a sum by ~3e-5 of itself; so each stage runs into a fresh
// accumulator that is then added to the running f32 sum (`mma_stage`).
// At 128 lanes that takes two consumers at most (the running sum and the
// stage's 64-lane accumulator, 96 registers a thread).
//
// Warp roles and stages.  A CTA is `wgs` consumer warpgroups (the first
// threads) and one producer warpgroup.  A stage ahead, the producer brings
// the stage's weight block by one TMA copy (where Cob is a multiple of 4,
// else by cp.async) into one raw buffer, and its window rows by cp.async
// (16 bytes where the pencils are multiples of 4 channels, 4 bytes
// otherwise, e.g. Cib = 3; zero-filled outside the map, past the pencil and
// past Cob) into a two-slot ring; it then splits the weights into the
// slot's B halves and hands the slot to the consumers through named
// barriers; the consumers hand it back through another.  A stage's window
// is `strips` copy groups: the window kernel's one, the streamed kernel's
// one a strip (strip 0's rows, then each later strip's fresh rows), so
// strip k computes while strip k + 1's rows are in flight and each halo row
// comes from device memory once a stage.  (Asking for a stage's weights as
// soon as the raw buffer is free, a stage before its rows, timed slower:
// 5.53 against 5.14 ms over VGG-16's 13 layers at batch 8, on an H100
// 80GB HBM3 at 700 W.)
//
// Consumers.  The window kernel's warpgroup c holds rows 64c .. 64c + 63 of
// the tile's one m-tile (mstride = 64 * wgs); the streamed kernel's band is
// `strips` strips of hso x tw positions, warpgroup c the one m-tile of strip
// c (mstride = hso * tw).  Rows past the tile or the map are computed on
// position 0 and never stored.
//
// Window layout, in floats from a 128-byte aligned slot: hwin rows of rf
// floats; a row's columns de-interleaved by their phase against the stride
// (column j at cell (j % s) * wph + j / s, wph = ceil(wwin / s)), so that
// consecutive output positions read consecutive cells at any stride; a cell
// is `chunk + 4` floats (the 4 never read), so the eight rows of a warp's A
// load fall on eight distinct bank quads.
//
// Epilogue: the reference's order (+ b, activation, + r, one store); with
// GAP each CTA writes its tile's sums of the stored values (a thread's two
// rows, a warp's eight row groups by shuffles, then the consumer warps in
// order) into `partials`, and the last CTA of an (image, output block) adds
// its tiles in tile order and scales them into the pooled features
// (split_sum.cuh).  No sum depends on the order CTAs run in: two runs give
// identical bits, and where the window and the streamed kernels take the
// same chunk they sum in the same order.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "dgrad_tile.cuh"
#include "split_sum.cuh"

namespace fwd_tile {
// Internal to each library that includes it: the host helpers keep a
// function-local cache (allow_smem), and an inline function exported by two
// libraries loaded into one process would bind both to one copy.
namespace {

namespace dt = dgrad_tile;

constexpr int kWarpgroup = dt::kWarpgroup;
constexpr int kMaxConsumers = 3;
constexpr int kMaxThreads = kWarpgroup * (kMaxConsumers + 1);
// at 128 lanes a consumer holds a 64-register running sum beside a stage's
// 32-register accumulator: two consumers at most, so that a thread may
// take 168 registers
constexpr int kWideLanes = 128;
constexpr int kWideConsumers = 2;

constexpr int kRows = 64;             // rows of one wgmma tile
constexpr int kSlots = 2;             // ring slots
constexpr int kMaxGroups = kMaxConsumers;   // copy groups of a stage
constexpr int kMaxDevices = 64;
// named barriers (0 is __syncthreads): group g of slot s landed, slot s
// consumed, the producer warpgroup's own, the consumers' GAP sums
constexpr int kBarFull = 1;           // + s * kMaxGroups + g
constexpr int kBarEmpty = kBarFull + kSlots * kMaxGroups;   // + s
constexpr int kBarProducer = kBarEmpty + kSlots;
constexpr int kBarGap = kBarProducer + 1;
static_assert(kBarGap < 16, "16 named barriers");
constexpr int kActRelu = 1;
constexpr int kActGelu = 2;

// threads of the largest CTA at wgmma width `lanes` (the launch bound)
__host__ __device__ constexpr int max_threads(int lanes) {
  return kWarpgroup * ((lanes >= kWideLanes ? kWideConsumers
                                            : kMaxConsumers) + 1);
}

// The launch geometry, passed by value; its fields are the int array the
// host builds once per shape (core/blocking.py FwdBlocking, the wrappers'
// plans).
struct Geometry {
  int ciblk, cib, hi, wi;           // x: [N, ciblk, hi, wi, cib]
  int coblk, cob, ho, wo;           // out: [N, coblk, ho, wo, cob]
  int hf, wf, stride, pad_top, pad_left;
  int th, tw;                       // output rows x columns of a CTA's tile
  int wgs;                          // consumer warpgroups
  int strips;                       // copy groups a stage: 1, or wgs strips
  int nsplit;                       // CTAs an output block's lanes split into
  int chunk;                        // Cib channels a stage (8, 16, ... 128)
  int act;                          // 0 linear, 1 relu, 2 gelu
  int gap;                          // 1: write the tile's GAP sums
};
constexpr int kGeometryInts = sizeof(Geometry) / sizeof(int);

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int taps(const Geometry& g) { return g.hf * g.wf; }

// Cib rounded up to the k8 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cib, 8) * 8;
}

__host__ __device__ inline int stages(const Geometry& g) {
  return g.ciblk * (kpad(g) / g.chunk);
}

__host__ __device__ inline int hso(const Geometry& g) {
  return g.th / g.strips;
}

// positions from one m-tile to the next: the window tile's one m-tile of
// 64 * wgs rows, or a strip
__host__ __device__ inline int mstride(const Geometry& g) {
  return g.strips == 1 ? kRows * g.wgs : hso(g) * g.tw;
}

__host__ __device__ inline int hwin(const Geometry& g) {
  return (g.th - 1) * g.stride + g.hf;
}

__host__ __device__ inline int wwin(const Geometry& g) {
  return (g.tw - 1) * g.stride + g.wf;
}

// cells of one column phase of a window row
__host__ __device__ inline int wph(const Geometry& g) {
  return ceil_div(wwin(g), g.stride);
}

__host__ __device__ inline int cell_floats(const Geometry& g) {
  return g.chunk + 4;
}

__host__ __device__ inline int row_floats(const Geometry& g) {
  return g.stride * wph(g) * cell_floats(g);
}

// a window slot, rounded up to 128 bytes
__host__ __device__ inline int window_floats(const Geometry& g) {
  return ceil_div(hwin(g) * row_floats(g), 32) * 32;
}

__host__ __device__ inline int weight_floats(const Geometry& g, int lanes) {
  return taps(g) * g.chunk * lanes;
}

// k8 steps of a stage: taps x chunk / 8
__host__ __device__ inline int steps(const Geometry& g) {
  return taps(g) * g.chunk / 8;
}

__host__ __device__ inline int tiles(const Geometry& g) {
  return ceil_div(g.ho, g.th) * ceil_div(g.wo, g.tw);
}

// Dynamic shared memory of one CTA (core/blocking.py fwd_smem_bytes): 128
// bytes to align the base; per ring slot the window and the B halves; the
// raw weight buffer; an int a k8 step (rounded up to an even count); the
// weights' 8-byte mbarrier; with GAP the consumer warps' sums.
__host__ inline size_t smem_bytes(const Geometry& g, int lanes) {
  const size_t w = weight_floats(g, lanes);
  return 128 + 8
         + 4 * (kSlots * (window_floats(g) + 2 * w) + w
                + ceil_div(steps(g), 2) * 2
                + (g.gap ? (size_t)4 * g.wgs * lanes : 0));
}

// The weights come by one TMA copy a stage where Cob is a multiple of 4
// (the tensor map's strides are whole 16 bytes), else by cp.async.
__host__ __device__ inline bool tma_weights(const Geometry& g) {
  return g.cob % 4 == 0;
}

// What a launch at wgmma width `lanes` runs over n images (core/blocking.py
// `fwd_plan` is its Python twin): out[0] the grid's tiles (an image's, a
// lane split's), out[1] the function's MACs (positions x taps x Ci x Co),
// out[2] the tensor-core MACs the tiles issue: every CTA's 64 * wgs rows by
// `lanes` over every tap and Cib padded to k8 slices, three products each.
__host__ inline void plan(const Geometry& g, int n, int lanes,
                          long long* out) {
  const long long t = tiles(g);
  out[0] = t;
  out[1] = (long long)n * g.ho * g.wo * taps(g) * g.ciblk * g.cib * g.coblk
           * g.cob;
  out[2] = (long long)n * t * g.coblk * g.nsplit * kRows * g.wgs * lanes
           * taps(g) * g.ciblk * kpad(g) * 3;
}

// ---------------------------------------------------------------------------
// the producer's copies and passes
// ---------------------------------------------------------------------------

// cp.async: `valid` false copies no byte and zero-fills the destination
// (src-size 0); `src` must still be a global address.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0-2) of this thread's copy groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// The shared-memory carve-up of one CTA (smem_bytes): kSlots slots of
// [window | big | small], then the raw weights, the A shifts and the GAP
// sums.  A slot's buffers are reached by offset, so a slot index known only
// at run time costs no local memory.
struct Smem {
  float* base;
  int slot;                   // floats of one slot
  int big, small;             // offsets inside a slot
  float* raw;                 // [taps * chunk][N]
  int* shifts;                // [steps]
  uint64_t* wbar;             // the raw weights' TMA copy has landed
  float* red;                 // [4 * wgs][N]

  __device__ float* win_of(int s) const { return base + s * slot; }
  __device__ float* big_of(int s) const { return base + s * slot + big; }
  __device__ float* small_of(int s) const { return base + s * slot + small; }
};

template <int N>
__device__ inline Smem carve(float* smem, const Geometry& g) {
  Smem m;
  m.base = smem + ((128 - (dt::smem_u32(smem) & 127)) & 127) / 4;
  const int w = weight_floats(g, N);
  m.big = window_floats(g);
  m.small = m.big + w;
  m.slot = m.small + w;
  m.raw = m.base + kSlots * m.slot;
  m.shifts = reinterpret_cast<int*>(m.raw + w);
  m.wbar = reinterpret_cast<uint64_t*>(m.shifts + ceil_div(steps(g), 2) * 2);
  m.red = reinterpret_cast<float*>(m.wbar + 1);
  return m;
}

// The cell of window column j: its stride phase's cells together.
__device__ __forceinline__ int cell_of(const Geometry& g, int j, int ph) {
  if (g.stride == 1) return j;
  if (g.stride == 2) return (j & 1) * ph + (j >> 1);
  return (j % g.stride) * ph + j / g.stride;
}

// Issue window rows [lo, hi) for channels [c0, c0 + chunk) of input block
// i_b of image n: window row r is input row h0 + r, column j input column
// w0 + j (the tile's origin times the stride, less the leading pads), each
// cell landing at its column phase's place (the producer's 128 threads,
// `tid`).  A cell's copies (the chunk, a power of two, in units of 4 or 1
// floats) divide 128, so a thread keeps one channel offset and steps its
// (row, column) by a fixed stride, with no division a copy.
__device__ inline void issue_rows(float* win, const float* __restrict__ x,
                                  const Geometry& g, int n, int i_b, int c0,
                                  int h0, int w0, int lo, int hi, int tid) {
  const bool vec = g.cib % 4 == 0;
  const int unit = vec ? 4 : 1;
  const int per_cell = g.chunk / unit;          // divides 128
  const int ww = wwin(g);
  const int ld = cell_floats(g);
  const int rf = row_floats(g);
  const int ph = wph(g);
  const int valid_c = min(g.chunk, g.cib - c0);
  const int cells = (hi - lo) * ww;
  const float* xb = x + (size_t)(n * g.ciblk + i_b) * g.hi * g.wi * g.cib
                    + c0;
  const int step = kWarpgroup / per_cell;       // cells a pass
  const int dr = step / ww, dj = step - dr * ww;
  const int e = tid % per_cell * unit;
  int c = tid / per_cell;
  int r = lo + c / ww, j = c % ww;
  for (; c < cells; c += step) {
    const int ih = h0 + r;
    const int iw = w0 + j;
    const bool ok = ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi
                    && e < valid_c;
    const float* src = ok ? xb + ((size_t)ih * g.wi + iw) * g.cib + e : x;
    cp_async(win + r * rf + cell_of(g, j, ph) * ld + e, src, ok, vec);
    r += dr;
    j += dj;
    if (j >= ww) {
      j -= ww;
      ++r;
    }
  }
}

// Issue the stage's raw weights: raw[(tap * chunk + k) * N + l] = w[o_b,
// i_b, tap, c0 + k, o0 + l], zero past Cib and past Cob.  With a tensor map
// one TMA copy of the box [taps][chunk][N] (thread 0, onto m.wbar); else
// cp.async, a thread keeping one lane offset (a row's copies divide 128)
// and walking taps and channels.
template <int N>
__device__ inline void issue_weights(const Smem& m, const CUtensorMap* tmw,
                                     const float* __restrict__ w,
                                     const Geometry& g, int o_b, int i_b,
                                     int c0, int o0, int tid) {
  if (tma_weights(g)) {
    if (tid == 0) {
      dt::mbar_expect_tx(m.wbar, weight_floats(g, N) * 4);
      dt::tma_load_4d(m.raw, tmw, m.wbar, o0, c0, 0, o_b * g.ciblk + i_b);
    }
    return;
  }
  float* raw = m.raw;
  const bool vec = false;
  const int unit = vec ? 4 : 1;
  const int per_row = N / unit;
  const int step = kWarpgroup / per_row;        // rows a pass
  const int l = tid % per_row * unit;
  const int valid_k = min(g.chunk, g.cib - c0);
  const bool lane_ok = l < min(N, g.cob - o0);
  const float* wb = w + ((size_t)(o_b * g.ciblk + i_b) * taps(g) * g.cib
                         + c0) * g.cob + o0 + l;
  for (int tap = 0; tap < taps(g); ++tap) {
    for (int k = tid / per_row; k < g.chunk; k += step) {
      const bool ok = lane_ok && k < valid_k;
      const float* src = ok ? wb + ((size_t)tap * g.cib + k) * g.cob : w;
      cp_async(raw + (tap * g.chunk + k) * N + l, src, ok, vec);
    }
  }
}

// The raw weights [taps * chunk][N] into the core-matrix order [taps * chunk
// / 4][N][4], transposed and split into TF32 halves: unit (q, l) is B[4q ..
// 4q + 3][l] (neighbouring threads on neighbouring lanes).
template <int N>
__device__ inline void split_weights(const Smem& m, int slot,
                                     const Geometry& g, int tid) {
  auto split = [](float v, float& s) {
    const float h = __uint_as_float(dt::tf32_bits(v));
    s = __uint_as_float(dt::tf32_bits(v - h));
    return h;
  };
  float4* big = reinterpret_cast<float4*>(m.big_of(slot));
  float4* small = reinterpret_cast<float4*>(m.small_of(slot));
  for (int u = tid; u < taps(g) * g.chunk / 4 * N; u += kWarpgroup) {
    const int q = u / N;
    const int l = u - q * N;
    const float* r = m.raw + 4 * q * N + l;
    float4 v = make_float4(r[0], r[N], r[2 * N], r[3 * N]);
    float4 lo;
    v.x = split(v.x, lo.x);
    v.y = split(v.y, lo.y);
    v.z = split(v.z, lo.z);
    v.w = split(v.w, lo.w);
    big[u] = v;
    small[u] = lo;
  }
}

// The A shift of each k8 step j (slice j % slices of tap j / slices), in
// floats from the row's offset (every thread of the CTA).
__device__ inline void step_shifts(int* shifts, const Geometry& g) {
  const int slices = g.chunk / 8;
  const int rf = row_floats(g);
  const int ld = cell_floats(g);
  const int ph = wph(g);
  for (int j = threadIdx.x; j < steps(g); j += blockDim.x) {
    const int tap = j / slices;
    const int dh = tap / g.wf;
    const int dw = tap - dh * g.wf;
    shifts[j] = dh * rf + ((dw % g.stride) * ph + dw / g.stride) * ld
                + (j - tap * slices) * 8;
  }
}

// Window rows of copy group k: the window kernel's one group takes all of
// them; the streamed kernel's strip 0 takes its own rows, each later strip
// the rows the strip before does not share.
__device__ __forceinline__ void group_rows(const Geometry& g, int k, int& lo,
                                           int& hi) {
  const int h = hso(g);
  auto end = [&](int strip) { return (strip * h + h - 1) * g.stride + g.hf; };
  if (g.strips == 1) {
    lo = 0;
    hi = hwin(g);
    return;
  }
  lo = k == 0 ? 0 : max(end(k - 1), k * h * g.stride);
  hi = end(k);
}

// The producer warpgroup: every stage's copies a stage ahead, the weight
// split, the hand-over of each copy group to its consumers.
template <int N>
__device__ void produce(const Smem& m, const CUtensorMap* tmw,
                        const float* __restrict__ x,
                        const float* __restrict__ w, const Geometry& g, int n,
                        int o_b, int o0, int h0, int w0) {
  const int tid = threadIdx.x - g.wgs * kWarpgroup;
  const int nth = blockDim.x;
  const int pair = g.strips == 1 ? nth : 2 * kWarpgroup;
  const int per_block = kpad(g) / g.chunk;
  const int count = stages(g);
  auto issue = [&](int s) {
    const int i_b = s / per_block;
    const int c0 = (s - i_b * per_block) * g.chunk;
    float* win = m.win_of(s % kSlots);
    for (int k = 0; k < g.strips; ++k) {
      if (k == 0) issue_weights<N>(m, tmw, w, g, o_b, i_b, c0, o0, tid);
      int lo, hi;
      group_rows(g, k, lo, hi);
      issue_rows(win, x, g, n, i_b, c0, h0, w0, lo, hi, tid);
      cp_async_commit();
    }
  };
  issue(0);
  for (int s = 0; s < count; ++s) {
    const int slot = s % kSlots;
    for (int k = 0; k < g.strips; ++k) {
      cp_async_wait(g.strips - 1 - k);
      dt::bar_sync(kBarProducer, kWarpgroup);   // every thread's copies
      if (k == 0 && tma_weights(g)) dt::mbar_wait(m.wbar, s & 1);
      if (k == 0) split_weights<N>(m, slot, g, tid);
      dt::fence_proxy_async();
      dt::bar_arrive(kBarFull + slot * kMaxGroups + k, pair);
    }
    if (s + 1 < count) {
      // the raw buffer is free once every producer thread has split it;
      // the other slot once the consumers are done with stage s - 1
      if (s >= 1) {
        dt::bar_sync(kBarEmpty + (slot ^ 1), nth);
      } else {
        dt::bar_sync(kBarProducer, kWarpgroup);
      }
      issue(s + 1);
    }
  }
}

// This consumer thread's two rows (q0 + 16*warp + lane/4 (+8) of m-tile mt)
// as window offsets of tap (0, 0) plus the column lane % 4; a row past the
// m-tile or the tile reads position 0 and is never stored.
__device__ __forceinline__ void row_offsets(int (&off)[2], const Geometry& g,
                                            int mt, int q0) {
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ms = mstride(g);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    int p = mt * ms + q;
    if (q >= ms || p >= g.th * g.tw) p = 0;
    off[h] = (p / g.tw) * g.stride * row_floats(g)
             + (p % g.tw) * cell_floats(g) + lane % 4;
  }
}

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

// One landed stage into a consumer's m-tile: the stage's k8 steps into a
// fresh accumulator, NW lanes (a wgmma's width) of the N-lane B at a time,
// each part then added into the running sum `total` in f32 (round to
// nearest).  The tensor cores add each k8 slice into their accumulator
// rounding toward zero; over VGG-16's K = 9 * 512 that drifts a sum by
// ~3e-5 of itself toward zero, which a fresh accumulator a stage keeps to
// the stage's own magnitude.  NW = 64 at N = 128 keeps `total` and the
// stage's accumulator within a thread's 128 registers.  A is loaded one
// step ahead into the register pair the wgmma two steps back has released.
// Returns with every wgmma complete.
template <int N, int NW>
__device__ void mma_stage(float (&total)[N / 2], const float* win,
                          const int (&off)[2], const int* shifts, int steps,
                          const float* b_big, const float* b_small) {
#pragma unroll
  for (int part = 0; part < N / NW; ++part) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    // B [k/4][N][4]: the part's 8-lane groups start NW * 16 bytes on
    const uint32_t big_base = dt::smem_u32(b_big) + part * NW * 16;
    const uint32_t small_base = dt::smem_u32(b_small) + part * NW * 16;
    auto step = [&](const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                    int j) {
      dt::issue<NW>(acc, a_big, a_small,
                    dt::kmajor_desc(big_base + j * N * 32, N * 16, 128),
                    dt::kmajor_desc(small_base + j * N * 32, N * 16, 128));
    };
    uint32_t big0[4], small0[4], big1[4], small1[4];
    dt::load_a(big0, small0, win, off, shifts[0]);
    for (int j = 0; j < steps; j += 2) {
      step(big0, small0, j);
      if (j + 1 < steps) {
        dt::wgmma_wait<1>();          // step j - 1 has released big1/small1
        dt::load_a(big1, small1, win, off, shifts[j + 1]);
        step(big1, small1, j + 1);
      }
      if (j + 2 < steps) {
        dt::wgmma_wait<1>();          // step j has released big0/small0
        dt::load_a(big0, small0, win, off, shifts[j + 2]);
      }
    }
    dt::wgmma_wait<0>();
    dt::fence_regs<NW / 2>(acc);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) total[part * NW / 2 + i] += acc[i];
  }
}

// The whole CTA: grid (tiles, Co blocks x nsplit, images), `wgs` consumer
// warpgroups and the producer.  With GAP: `partials` [N, Co/Cob, tiles,
// Cob], `pooled` [N, Co], `counters` two zeroed int32 an (image, output
// block).
template <int N>
__device__ void run(float* smem, const CUtensorMap* tmw,
                    const float* __restrict__ x,
                    const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ residual,
                    float* __restrict__ out, float* partials,
                    float* __restrict__ pooled, int* counters,
                    const Geometry& g) {
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y / g.nsplit;
  const int o0 = blockIdx.y % g.nsplit * N;
  const int n = blockIdx.z;
  const int across = ceil_div(g.wo, g.tw);
  const int oh0 = tile / across * g.th;
  const int ow0 = tile % across * g.tw;
  const int nth = blockDim.x;
  const int consumers = g.wgs * kWarpgroup;
  const Smem m = carve<N>(smem, g);
  step_shifts(m.shifts, g);
  if (threadIdx.x == 0) {
    dt::mbar_init(m.wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    produce<N>(m, tmw, x, w, g, n, o_b, o0, oh0 * g.stride - g.pad_top,
               ow0 * g.stride - g.pad_left);
    return;
  }

  const int wg = threadIdx.x / kWarpgroup;
  const bool streamed = g.strips > 1;
  const int group = streamed ? wg : 0;
  const int pair = streamed ? 2 * kWarpgroup : nth;
  const int mt = streamed ? wg : 0;
  const int q0 = streamed ? 0 : kRows * wg;
  int off[2];
  row_offsets(off, g, mt, q0);
  const int count = stages(g);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < count; ++s) {
    const int slot = s % kSlots;
    dt::bar_sync(kBarFull + slot * kMaxGroups + group, pair);
    mma_stage<N, (N > 64 ? 64 : N)>(acc, m.win_of(slot), off, m.shifts,
                                    steps(g), m.big_of(slot),
                                    m.small_of(slot));
    if (s + kSlots < count) dt::bar_arrive(kBarEmpty + slot, nth);
  }

  // the epilogue; acc keeps the stored values, zero where nothing is
  // stored, for the GAP sums
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ms = mstride(g);
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.cob % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    const int p = mt * ms + q;
    const int oh = oh0 + p / g.tw;
    const int ow = ow0 + p % g.tw;
    const bool row_ok = q < ms && p < g.th * g.tw && oh < g.ho && ow < g.wo;
    const size_t base =
        (((size_t)(n * g.coblk + o_b) * g.ho + oh) * g.wo + ow) * g.cob + o0;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      float v[2] = {acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]};
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = row_ok && o0 + col + e < g.cob;
        if (ok[e]) {
          const int o = o0 + col + e;
          v[e] = activate(
              v[e] + (bias != nullptr ? __ldg(bias + o_b * g.cob + o) : 0.0f),
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
    if (c < N && o0 + c < g.cob) {
      float s = 0.0f;
      for (int q = 0; q < consumers / 32; ++q) s += m.red[q * N + c];
      partials[((size_t)(n * g.coblk + o_b) * gridDim.x + tile) * g.cob + o0
               + c] = s;
    }
    // the last CTA of (n, o_b), both lane halves: its tiles in order, times
    // the f32 reciprocal of Ho * Wo
    split_sum::gap_fold(partials, pooled, counters, n * g.coblk + o_b,
                        gridDim.x, gridDim.x * g.nsplit, g.cob, g.ho * g.wo,
                        reinterpret_cast<int*>(m.red), kBarGap, consumers);
  }
}

// ---------------------------------------------------------------------------
// the bf16 build
// ---------------------------------------------------------------------------
//
// The same tile on bf16 operands: the reference's fused inference forward
// under BF16 (src/repro/kernels/direct_conv2d.py:667-672).  x, w and the
// residual are bf16 (the wrapper casts the f32 master weights once a
// call); each stage's k16 steps run on bf16 wgmma (m64nNk16) into a fresh
// f32 accumulator that is added to the running f32 sum, as in the f32 tile
// (the tensor cores' truncating adds drift the same way at K = 4608).  The
// epilogue is act(acc + b) with an f32 bias, then + r in f32, then one
// rounding to bf16 at the store; the GAP sums the stored bf16 values in
// f32, and the pooled features leave as bf16.
//
// What differs from the f32 tile:
// * No split.  A is the window's bf16 pairs, loaded as they lie.  B, the
//   weights, is N-contiguous, and wgmma reads a 16-bit B MN-major through
//   its transpose bit, so the producer neither transposes nor splits it:
//   one TMA copy a stage (a 5-D box over [blocks][taps][Cib][Cob/8][8])
//   lands the chunk as [taps][N/8][chunk][8] in the slot the wgmma reads:
//   the core matrices of 8 lanes by 8 channels of the interleaved MN-major
//   layout.  Where Cob is not a multiple of 8 (TMA's 16-byte strides) the
//   producer copies the same cells by 2-byte loads and stores.
// * The chunk is a multiple of 16 (k16 steps), and Cib pads to 16.  A
//   window cell is chunk + 8 bf16 (16 bytes never read), so that the eight
//   rows a warp loads fall on distinct bank quads.
// * Window copies are 16 bytes where Cib is a multiple of 8, 4 where it is
//   even, else 2-byte loads and stores (Cib = 3: a pixel's three channels
//   are 6 bytes, so half the cells start off 4-byte alignment).  No padded
//   copy of x exists.
// * Each slot has its own mbarrier for its weights (the next stage's
//   weights land in the other slot while this one computes); the consumers
//   wait on it as well before their wgmmas read what the copy wrote.
namespace bf16 {

using bf = __nv_bfloat16;

// Cib rounded up to the k16 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cib, 16) * 16;
}

__host__ __device__ inline int stages(const Geometry& g) {
  return g.ciblk * (bf16::kpad(g) / g.chunk);
}

__host__ __device__ inline int cell_elems(const Geometry& g) {
  return g.chunk + 8;
}

__host__ __device__ inline int row_elems(const Geometry& g) {
  return g.stride * wph(g) * cell_elems(g);
}

// a window slot, rounded up to 128 bytes
__host__ __device__ inline int window_elems(const Geometry& g) {
  return ceil_div(hwin(g) * row_elems(g), 64) * 64;
}

__host__ __device__ inline int weight_elems(const Geometry& g, int lanes) {
  return taps(g) * g.chunk * lanes;
}

// k16 steps of a stage: taps x chunk / 16
__host__ __device__ inline int steps(const Geometry& g) {
  return taps(g) * g.chunk / 16;
}

// Dynamic shared memory of one CTA (core/blocking.py fwd_smem_bytes at
// op_bytes 2): 128 bytes to align the base; per ring slot the window and
// the weights; two ints a k16 step (its A and B offsets); an mbarrier a
// slot; with GAP the consumer warps' f32 sums.
__host__ inline size_t smem_bytes(const Geometry& g, int lanes) {
  return 128 + 2 * (size_t)kSlots * (window_elems(g) + weight_elems(g, lanes))
         + 8 * (size_t)bf16::steps(g) + 8 * kSlots
         + (g.gap ? (size_t)16 * g.wgs * lanes : 0);
}

// The weights come by one TMA copy a stage where Cob is a multiple of 8
// (the map's strides are whole 16 bytes), else by 2-byte copies.
__host__ __device__ inline bool tma_weights(const Geometry& g) {
  return g.cob % 8 == 0;
}

// What a launch runs (the f32 tile's plan at one bf16 product a MAC, Cib
// padded to k16 slices).
__host__ inline void plan(const Geometry& g, int n, int lanes,
                          long long* out) {
  const long long t = tiles(g);
  out[0] = t;
  out[1] = (long long)n * g.ho * g.wo * taps(g) * g.ciblk * g.cib * g.coblk
           * g.cob;
  out[2] = (long long)n * t * g.coblk * g.nsplit * kRows * g.wgs * lanes
           * taps(g) * g.ciblk * bf16::kpad(g);
}

// The carve-up of one CTA (smem_bytes): kSlots slots of [window | weights],
// then the steps' A and B offsets, the slots' mbarriers and the GAP sums.
struct Smem {
  char* base;
  int slot;                   // bytes of one slot
  int wts;                    // the weights' offset in a slot, in bytes
  int* shifts;                // [2][steps]
  uint64_t* bar;              // [kSlots] the slot's weights have landed
  float* red;                 // [4 * wgs][N]

  __device__ bf* win_of(int s) const {
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
  m.wts = 2 * window_elems(g);
  m.slot = m.wts + 2 * weight_elems(g, N);
  m.shifts = reinterpret_cast<int*>(m.base + kSlots * m.slot);
  m.bar = reinterpret_cast<uint64_t*>(m.shifts + 2 * bf16::steps(g));
  m.red = reinterpret_cast<float*>(m.bar + kSlots);
  return m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Issue window rows [lo, hi) for channels [c0, c0 + chunk) of input block
// i_b of image n, as the f32 tile's issue_rows does: 8-channel (16-byte)
// cp.async units where Cib is a multiple of 8, 2-channel (4-byte) ones
// where it is even, else one channel by a 2-byte load and store; zeros
// outside the map and past the pencil.
__device__ inline void issue_rows(bf* win, const bf* __restrict__ x,
                                  const Geometry& g, int n, int i_b, int c0,
                                  int h0, int w0, int lo, int hi, int tid) {
  const int unit = g.cib % 8 == 0 ? 8 : (g.cib % 2 == 0 ? 2 : 1);
  const int per_cell = g.chunk / unit;          // divides 128
  const int ww = wwin(g);
  const int ld = cell_elems(g);
  const int rf = row_elems(g);
  const int ph = wph(g);
  const int valid_c = min(g.chunk, g.cib - c0);
  const int cells = (hi - lo) * ww;
  const bf* xb = x + (size_t)(n * g.ciblk + i_b) * g.hi * g.wi * g.cib + c0;
  const int step = kWarpgroup / per_cell;       // cells a pass
  const int dr = step / ww, dj = step - dr * ww;
  const int e = tid % per_cell * unit;
  int c = tid / per_cell;
  int r = lo + c / ww, j = c % ww;
  for (; c < cells; c += step) {
    const int ih = h0 + r;
    const int iw = w0 + j;
    const bool ok = ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi
                    && e < valid_c;
    const bf* src = ok ? xb + ((size_t)ih * g.wi + iw) * g.cib + e : x;
    bf* dst = win + r * rf + cell_of(g, j, ph) * ld + e;
    if (unit == 8) {
      cp_async16(dst, src, ok);
    } else if (unit == 2) {
      cp_async4(dst, src, ok);
    } else {
      *reinterpret_cast<unsigned short*>(dst) =
          ok ? __ldg(reinterpret_cast<const unsigned short*>(src))
             : (unsigned short)0;
    }
    r += dr;
    j += dj;
    if (j >= ww) {
      j -= ww;
      ++r;
    }
  }
}

// Issue the stage's weights into slot `slot` as [taps][N/8][chunk][8]:
// element (tap, q, k, e) = w[o_b, i_b, tap, c0 + k, o0 + 8q + e], zero past
// Cib and past Cob.  With the tensor map one TMA copy (thread 0, onto the
// slot's mbarrier); else 2-byte loads and stores.
template <int N>
__device__ inline void issue_weights(const Smem& m, int slot,
                                     const CUtensorMap* tmw,
                                     const bf* __restrict__ w,
                                     const Geometry& g, int o_b, int i_b,
                                     int c0, int o0, int tid) {
  bf* dst = m.wts_of(slot);
  if (bf16::tma_weights(g)) {
    if (tid == 0) {
      dt::mbar_expect_tx(m.bar + slot, weight_elems(g, N) * 2);
      dt::tma_load_5d(dst, tmw, m.bar + slot, 0, c0, o0 / 8, 0,
                      o_b * g.ciblk + i_b);
    }
    return;
  }
  const int valid_k = min(g.chunk, g.cib - c0);
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w)
      + ((size_t)(o_b * g.ciblk + i_b) * taps(g) * g.cib + c0) * g.cob + o0;
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  for (int i = tid; i < weight_elems(g, N); i += kWarpgroup) {
    const int e = i & 7;
    const int k = (i >> 3) % g.chunk;
    const int rest = (i >> 3) / g.chunk;        // tap * (N / 8) + q
    const int tap = rest / (N / 8);
    const int l = (rest - tap * (N / 8)) * 8 + e;
    const bool ok = k < valid_k && o0 + l < g.cob;
    d[i] = ok ? __ldg(wb + ((size_t)tap * g.cib + k) * g.cob + l)
              : (unsigned short)0;
  }
}

// The offsets of each k16 step j (slice j % slices of tap j / slices),
// every thread of the CTA: shifts[j], A's in elements from the row's
// offset; shifts[steps + j], B's in 16-byte units from the weights' part
// (the descriptor's address field).
template <int N>
__device__ inline void step_shifts(int* shifts, const Geometry& g) {
  const int slices = g.chunk / 16;
  const int rf = row_elems(g);
  const int ld = cell_elems(g);
  const int ph = wph(g);
  const int count = bf16::steps(g);
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int tap = j / slices;
    const int sl = j - tap * slices;
    const int dh = tap / g.wf;
    const int dw = tap - dh * g.wf;
    shifts[j] = dh * rf + ((dw % g.stride) * ph + dw / g.stride) * ld
                + sl * 16;
    shifts[count + j] = tap * (N / 8) * g.chunk + sl * 16;
  }
}

// The producer warpgroup: every stage's copies a stage ahead and the
// hand-over of each copy group to its consumers (the f32 tile's produce,
// with the weights landing in the slot itself).
template <int N>
__device__ void produce(const Smem& m, const CUtensorMap* tmw,
                        const bf* __restrict__ x, const bf* __restrict__ w,
                        const Geometry& g, int n, int o_b, int o0, int h0,
                        int w0) {
  const int tid = threadIdx.x - g.wgs * kWarpgroup;
  const int nth = blockDim.x;
  const int pair = g.strips == 1 ? nth : 2 * kWarpgroup;
  const int per_block = bf16::kpad(g) / g.chunk;
  const int count = bf16::stages(g);
  auto issue = [&](int s) {
    const int i_b = s / per_block;
    const int c0 = (s - i_b * per_block) * g.chunk;
    const int slot = s % kSlots;
    bf* win = m.win_of(slot);
    for (int k = 0; k < g.strips; ++k) {
      if (k == 0) issue_weights<N>(m, slot, tmw, w, g, o_b, i_b, c0, o0, tid);
      int lo, hi;
      group_rows(g, k, lo, hi);
      bf16::issue_rows(win, x, g, n, i_b, c0, h0, w0, lo, hi, tid);
      cp_async_commit();
    }
  };
  issue(0);
  for (int s = 0; s < count; ++s) {
    const int slot = s % kSlots;
    for (int k = 0; k < g.strips; ++k) {
      cp_async_wait(g.strips - 1 - k);
      dt::bar_sync(kBarProducer, kWarpgroup);   // every thread's copies
      if (k == 0 && bf16::tma_weights(g)) {
        dt::mbar_wait(m.bar + slot, s / kSlots & 1);
      }
      dt::fence_proxy_async();    // the 2-byte weight stores, for wgmma
      dt::bar_arrive(kBarFull + slot * kMaxGroups + k, pair);
    }
    // the other slot is free once the consumers are done with stage s - 1
    if (s + 1 < count) {
      if (s >= 1) dt::bar_sync(kBarEmpty + (slot ^ 1), nth);
      issue(s + 1);
    }
  }
}

// This consumer thread's two rows as window offsets of tap (0, 0) plus the
// columns 2 (lane % 4) and + 1 (the f32 tile's row_offsets, in elements).
__device__ __forceinline__ void row_offsets(int (&off)[2], const Geometry& g,
                                            int mt, int q0) {
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ms = mstride(g);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    int p = mt * ms + q;
    if (q >= ms || p >= g.th * g.tw) p = 0;
    off[h] = (p / g.tw) * g.stride * row_elems(g)
             + (p % g.tw) * cell_elems(g) + 2 * (lane % 4);
  }
}

// A for one k16 step at `shift` elements from each row's offset: rows r
// and r + 8 at columns 2 (lane % 4), + 1, and the same 8 columns on.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf* win,
                                       const int (&off)[2], int shift) {
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(win + off[0] + shift);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(win + off[1] + shift);
  a[0] = r0[0];
  a[1] = r1[0];
  a[2] = r0[4];
  a[3] = r1[4];
}

// B of a k16 step: interleaved MN-major core matrices (8 lanes x 8
// channels, 128 bytes), the step's two channel halves 128 bytes apart (the
// leading byte offset: the K direction, as for a K-major operand), the
// 8-lane groups `chunk * 16` bytes apart (the stride byte offset).  The
// descriptor's fields pack as the K-major one's.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, int chunk) {
  return dt::kmajor_desc(addr, 128, chunk * 16);
}

// D[64 x N] += A[64 x 16] B[16 x N], bf16 in, f32 accumulators; A from
// registers (the f32 tile's fragment, two bf16 a register), B MN-major
// (the transpose bit).
template <int N>
__device__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float* d, const uint32_t* a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, const uint32_t* a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, const uint32_t* a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One landed stage into a consumer's m-tile: its k16 steps into a fresh
// accumulator, NW lanes of the N-lane B at a time, each part then added
// into the running f32 sum `total` (the f32 tile's mma_stage at one
// product a step).  A is loaded one step ahead into the register set the
// wgmma two steps back has released.  Returns with every wgmma complete.
template <int N, int NW>
__device__ void mma_stage(float (&total)[N / 2], const bf* win,
                          const int (&off)[2], const int* shifts, int steps,
                          const bf* wts, int chunk) {
#pragma unroll
  for (int part = 0; part < N / NW; ++part) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    // the descriptor of step 0 at the part's first 8-lane group; a step's
    // B offset adds to its address field
    const uint64_t desc0 =
        mn_desc(dt::smem_u32(wts) + part * NW / 8 * chunk * 16, chunk);
    auto step = [&](const uint32_t (&a)[4], int j) {
      dt::wgmma_fence();
      wgmma_bf16<NW>(acc, a, desc0 + (uint64_t)shifts[steps + j]);
      dt::wgmma_commit();
    };
    uint32_t a0[4], a1[4];
    load_a(a0, win, off, shifts[0]);
    for (int j = 0; j < steps; j += 2) {
      step(a0, j);
      if (j + 1 < steps) {
        dt::wgmma_wait<1>();          // step j - 1 has released a1
        load_a(a1, win, off, shifts[j + 1]);
        step(a1, j + 1);
      }
      if (j + 2 < steps) {
        dt::wgmma_wait<1>();          // step j has released a0
        load_a(a0, win, off, shifts[j + 2]);
      }
    }
    dt::wgmma_wait<0>();
    dt::fence_regs<NW / 2>(acc);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) total[part * NW / 2 + i] += acc[i];
  }
}

// The whole CTA (the f32 tile's run): grid (tiles, Co blocks x nsplit,
// images).  With GAP: `partials` [N, Co/Cob, tiles, Cob] f32, `pooled` [N,
// Co] bf16, `counters` two zeroed int32 an (image, output block).
template <int N>
__device__ void run(char* smem, const CUtensorMap* tmw,
                    const bf* __restrict__ x, const bf* __restrict__ w,
                    const float* __restrict__ bias,
                    const bf* __restrict__ residual, bf* __restrict__ out,
                    float* partials, bf* __restrict__ pooled, int* counters,
                    const Geometry& g) {
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y / g.nsplit;
  const int o0 = blockIdx.y % g.nsplit * N;
  const int n = blockIdx.z;
  const int across = ceil_div(g.wo, g.tw);
  const int oh0 = tile / across * g.th;
  const int ow0 = tile % across * g.tw;
  const int nth = blockDim.x;
  const int consumers = g.wgs * kWarpgroup;
  const Smem m = carve<N>(smem, g);
  bf16::step_shifts<N>(m.shifts, g);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) dt::mbar_init(m.bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    produce<N>(m, tmw, x, w, g, n, o_b, o0, oh0 * g.stride - g.pad_top,
               ow0 * g.stride - g.pad_left);
    return;
  }

  const int wg = threadIdx.x / kWarpgroup;
  const bool streamed = g.strips > 1;
  const int group = streamed ? wg : 0;
  const int pair = streamed ? 2 * kWarpgroup : nth;
  const int mt = streamed ? wg : 0;
  const int q0 = streamed ? 0 : kRows * wg;
  int off[2];
  bf16::row_offsets(off, g, mt, q0);
  const int count = bf16::stages(g);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < count; ++s) {
    const int slot = s % kSlots;
    dt::bar_sync(kBarFull + slot * kMaxGroups + group, pair);
    if (bf16::tma_weights(g)) dt::mbar_wait(m.bar + slot, s / kSlots & 1);
    mma_stage<N, (N > 64 ? 64 : N)>(acc, m.win_of(slot), off, m.shifts,
                                    bf16::steps(g), m.wts_of(slot), g.chunk);
    if (s + kSlots < count) dt::bar_arrive(kBarEmpty + slot, nth);
  }

  // the epilogue in f32, one rounding to bf16 at the store; acc keeps the
  // stored (rounded) values, zero where nothing is stored, for the GAP
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ms = mstride(g);
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.cob % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    const int p = mt * ms + q;
    const int oh = oh0 + p / g.tw;
    const int ow = ow0 + p % g.tw;
    const bool row_ok = q < ms && p < g.th * g.tw && oh < g.ho && ow < g.wo;
    const size_t base =
        (((size_t)(n * g.coblk + o_b) * g.ho + oh) * g.wo + ow) * g.cob + o0;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      bf v[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = row_ok && o0 + col + e < g.cob;
        float f = acc[4 * jj + 2 * h + e];
        if (ok[e]) {
          const int o = o0 + col + e;
          f = activate(
              f + (bias != nullptr ? __ldg(bias + o_b * g.cob + o) : 0.0f),
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
    if (c < N && o0 + c < g.cob) {
      float s = 0.0f;
      for (int q = 0; q < consumers / 32; ++q) s += m.red[q * N + c];
      partials[((size_t)(n * g.coblk + o_b) * gridDim.x + tile) * g.cob + o0
               + c] = s;
    }
    split_sum::gap_fold(partials, pooled, counters, n * g.coblk + o_b,
                        gridDim.x, gridDim.x * g.nsplit, g.cob, g.ho * g.wo,
                        reinterpret_cast<int*>(m.red), kBarGap, consumers);
  }
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device);
// `slot` names the kernel among a library's instances (five f32, then
// five bf16).
inline cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
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

// The wgmma widths a library compiles, and a width's instance index.
inline int lane_slot(int lanes) {
  switch (lanes) {
    case 8: return 0;
    case 16: return 1;
    case 32: return 2;
    case 64: return 3;
    case 128: return 4;
  }
  return -1;
}

// Whether the tiles of `g` at wgmma width `lanes` are ones the kernels
// take: `streamed` asks for bands of two or three strips of at most 64
// positions, else one m-tile of 64 * wgs rows holding the tile; `kstep` is
// the wgmma's k-slice (8: the f32 tile, 16: its bf16 build), which the
// chunk and Cib's padding are multiples of.
__host__ inline bool valid(const Geometry& g, int lanes, bool streamed,
                           int kstep = 8) {
  if (lane_slot(lanes) < 0 || g.wgs < 1
      || kWarpgroup * (g.wgs + 1) > max_threads(lanes)
      || g.chunk < kstep || (g.chunk & (g.chunk - 1)) != 0
      || ceil_div(g.cib, kstep) * kstep % g.chunk != 0
      || g.th < 1 || g.tw < 1 || g.stride < 1 || g.hf < 1 || g.wf < 1
      || g.nsplit < 1 || (g.nsplit - 1) * lanes >= g.cob
      || g.nsplit * lanes < g.cob || g.act < 0 || g.act > kActGelu)
    return false;
  if (streamed) {
    return g.strips == g.wgs && g.wgs >= 2 && g.th % g.strips == 0
           && hso(g) * g.tw <= kRows;
  }
  return g.strips == 1 && g.th * g.tw <= kRows * g.wgs;
}

// The operand type a plan names (its last int): the f32 tile, or its bf16
// build.
constexpr int kOperandF32 = 0;
constexpr int kOperandBf16 = 1;

// A plan's int array read: the Geometry fields in order, then the wgmma
// width, the images, the dynamic shared memory and the operand type.
struct Plan {
  Geometry g;
  int lanes, n, smem, operand;
};

// Read `ints` into `p` -> whether the kernels of that operand type take its
// tiles.
inline bool read_plan(const int* ints, bool streamed, Plan* p) {
  int* fields = reinterpret_cast<int*>(&p->g);
  for (int i = 0; i < kGeometryInts; ++i) fields[i] = ints[i];
  const int* more = ints + kGeometryInts;
  p->lanes = more[0];
  p->n = more[1];
  p->smem = more[2];
  p->operand = more[3];
  return (p->operand == kOperandF32 || p->operand == kOperandBf16)
         && valid(p->g, p->lanes, streamed,
                  p->operand == kOperandBf16 ? 16 : 8);
}

__host__ inline size_t smem_of(const Plan& p) {
  return p.operand == kOperandBf16 ? bf16::smem_bytes(p.g, p.lanes)
                                   : smem_bytes(p.g, p.lanes);
}

// The weights' tensor map: f32 [blocks][taps][Cib][Cob] with a box of one
// block's [taps][chunk][lanes]; bf16 [blocks][taps][Cib][Cob/8][8] with a
// box of [taps][chunk][lanes/8][8], where Cob is a multiple of 8.  -> false
// where the encoder refuses it.
inline bool encode_weights(CUtensorMap* tmw, const void* w, const Plan& p) {
  const Geometry& g = p.g;
  const long long cob = g.cob, blocks = (long long)g.coblk * g.ciblk;
  if (p.operand == kOperandBf16) {
    const long long dims[5] = {8, g.cib, cob / 8, taps(g), blocks};
    const long long strides[4] = {cob * 2, 16, g.cib * cob * 2,
                                  taps(g) * g.cib * cob * 2};
    const int box[5] = {8, g.chunk, p.lanes / 8, taps(g), 1};
    return dt::encode(tmw, w, 5, dims, strides, box,
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  }
  const long long dims[4] = {cob, g.cib, taps(g), blocks};
  const long long strides[3] = {cob * 4, g.cib * cob * 4,
                                taps(g) * g.cib * cob * 4};
  const int box[4] = {p.lanes, g.chunk, taps(g), 1};
  return dt::encode(tmw, w, 4, dims, strides, box);
}

// Launch `kernels[operand][lane_slot(lanes)]` on the plan's int array (Plan
// above; the shared memory must be smem_bytes's of that build): x, w,
// residual, out and pooled at the operand type, the bias and the partials
// f32.  Grid: (tiles, Co blocks x nsplit, images).
inline int launch(const void* const* const* kernels, bool streamed,
                  const void* x, const void* w, const void* bias,
                  const void* residual, void* out, void* partials,
                  void* pooled, void* counters, const int* ints,
                  cudaStream_t stream) {
  Plan p;
  if (!read_plan(ints, streamed, &p) || (size_t)p.smem != smem_of(p)
      || (p.g.gap && (partials == nullptr || pooled == nullptr
                      || counters == nullptr))
      || p.n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n == 0) return 0;
  const int slot = lane_slot(p.lanes);
  const void* kernel = kernels[p.operand][slot];
  cudaError_t err = allow_smem(kernel, 5 * p.operand + slot, p.smem);
  if (err != cudaSuccess) return (int)err;
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread
  CUtensorMap tmw;
  memset(&tmw, 0, sizeof(tmw));
  if (p.operand == kOperandBf16 ? bf16::tma_weights(p.g)
                                : tma_weights(p.g)) {
    int device = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!encode_weights(&tmw, w, p)) {
      return (int)cudaErrorNotSupported;   // the encoder refused the map
    }
  }
  void* args[] = {&tmw, &x, &w, &bias, &residual, &out, &partials, &pooled,
                  &counters, &p.g};
  err = cudaLaunchKernel(kernel, dim3(tiles(p.g), p.g.coblk * p.g.nsplit,
                                      p.n),
                         dim3(kWarpgroup * (p.g.wgs + 1)), args, p.smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What a launch of the same plan runs (`plan` and bf16::plan): 0, or
// cudaErrorInvalidValue where the kernels refuse the tiles.
inline int plan_of(bool streamed, const int* ints, long long* out) {
  Plan p;
  if (!read_plan(ints, streamed, &p)) return (int)cudaErrorInvalidValue;
  if (p.operand == kOperandBf16) {
    bf16::plan(p.g, p.n, p.lanes, out);
  } else {
    plan(p.g, p.n, p.lanes, out);
  }
  out[3] = (long long)smem_of(p);
  return 0;
}

}  // namespace
}  // namespace fwd_tile
