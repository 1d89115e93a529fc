// Dense forward tile on Hopper tensor cores (sm_90a): the device core that
// the window forward (direct_conv2d_fwd.cu, `fwd_kernel`) and the streamed
// forward (conv2d_stream.cu, `stream_fwd_kernel`) share, in f32 (3xTF32)
// and, in namespace `bf16` below, on bf16 operands (`fwd_kernel_bf16`,
// `stream_fwd_kernel_bf16`: a design of its own, described there; what
// follows here is the f32 tile's).
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
// Grouped and dilated geometry, both builds (the reference's
// `_forward_windowed`, src/repro/kernels/direct_conv2d.py:286-358).  With
// `groups` > 1 the weight is [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob], and
// output block o_b contracts its group's cigblk = (Ci/Cib) / groups input
// blocks alone: stage i_b reads x's block (o_b / cogblk) * cigblk + i_b
// (`x_block`) against weight block o_b * cigblk + i_b.  Cross-group blocks
// are never staged, so the tiles issue the grouped function's MACs (1 /
// groups of the dense count; `plan`).  Dilation (dil_h, dil_w) widens the
// window to the filter's dilated reach, (th - 1) s + (hf - 1) dil_h + 1
// rows, and starts tap (dh, dw) dh dil_h rows and dw dil_w columns on: the
// f32 tile adds that to each k8 step's A shift (`step_shifts`); the bf16
// build reads tap t of a filter row (column) in phase plane (t d) % s,
// (t d) / s plane rows (cells) on (`tap_phase`, `tap_shift`), so stride 2
// with an even dilation reads one row and column phase only.  At stride 1
// the bf16 window is one plane of th + (hf - 1) dil_h rows by tw + (wf - 1)
// dil_w cells.  The other design, which would land each of the d x d
// output phases' inputs as an undilated window through TMA's element
// stride (d <= 8; not at DeepLab-LargeFOV's fc6, d = 12), was not built:
// this one serves both, and at fc6 two thirds of its window's cells are
// read by no tap (PERF.md, PR 31).  Where a stage's weights of every tap do
// not fit one CTA (AlexNet's 11x11 conv1), the f32 tile's stages take
// `frows` filter rows each, and the window the rows they reach.  The
// streamed kernels stay dense-only: their C entry refuses such a plan.
// What bounds the new widths on this card (H100 80GB HBM3 at 700 W,
// PERF.md, PR 31): Cob 48 and 96 take no 64-lane TMA row, so the bf16
// chooser splits them 3 x 16 and 3 x 32 lanes, whose rows land by TMA (the
// two-way splits' 2-byte weight copies ran 1.3x and 2.6x slower); the f32
// tile issues 12.4x conv1's MACs (Cib 3 padded to 8, 48 lanes to 64, a
// stage a filter row).  The bf16 build takes Cib 3 (conv1) on the narrow
// rows (`run_narrow`, narrow_rows.cuh), which stage no phase plane: a run
// of a filter row is contiguous in the unphased input row.
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
#include "narrow_rows.cuh"
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
  int groups;                       // channel groups (1: dense)
  int dil_h, dil_w;                 // filter dilation
  int frows;                        // filter rows a stage (f32 tile; hf
                                    // unless a stage's taps do not fit)
  int narrow;                       // the bf16 build's narrow rows (a
                                    // filter row's run a 128-byte row)
};
constexpr int kGeometryInts = sizeof(Geometry) / sizeof(int);

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int taps(const Geometry& g) { return g.hf * g.wf; }

// The grouped map: an output block contracts its group's cigblk input
// blocks alone, x's block (o_b / cogblk) * cigblk + i_b against the weight
// block (o_b, i_b) of [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob].
__host__ __device__ inline int cigblk(const Geometry& g) {
  return g.ciblk / g.groups;
}
__host__ __device__ inline int x_block(const Geometry& g, int o_b, int i_b) {
  return o_b / (g.coblk / g.groups) * cigblk(g) + i_b;
}

// The dilated reach of the filter along H and W: tap (dh, dw) reads input
// (s oh + dh dil_h - pt, s ow + dw dil_w - pl).
__host__ __device__ inline int hreach(const Geometry& g) {
  return (g.hf - 1) * g.dil_h + 1;
}
__host__ __device__ inline int wreach(const Geometry& g) {
  return (g.wf - 1) * g.dil_w + 1;
}

// Whether the grouped and dilated fields make sense.
__host__ inline bool valid_map(const Geometry& g) {
  return g.groups >= 1 && g.ciblk % g.groups == 0 && g.coblk % g.groups == 0
         && g.dil_h >= 1 && g.dil_w >= 1 && g.frows >= 1
         && g.hf % g.frows == 0;
}

// The f32 tile's taps a stage: `frows` filter rows of wf taps (all of them
// unless a stage's weights would not fit, AlexNet's 11x11 conv1), and the
// stages a (block, chunk) takes for the whole filter.
__host__ __device__ inline int stage_taps(const Geometry& g) {
  return g.frows * g.wf;
}
__host__ __device__ inline int row_groups(const Geometry& g) {
  return g.hf / g.frows;
}

// Cib rounded up to the k8 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cib, 8) * 8;
}

__host__ __device__ inline int stages(const Geometry& g) {
  return cigblk(g) * (kpad(g) / g.chunk) * row_groups(g);
}

__host__ __device__ inline int hso(const Geometry& g) {
  return g.th / g.strips;
}

// positions from one m-tile to the next: the window tile's one m-tile of
// 64 * wgs rows, or a strip
__host__ __device__ inline int mstride(const Geometry& g) {
  return g.strips == 1 ? kRows * g.wgs : hso(g) * g.tw;
}

// a stage's window: the rows its frows filter rows reach, the columns the
// whole filter reaches
__host__ __device__ inline int hwin(const Geometry& g) {
  return (g.th - 1) * g.stride + (g.frows - 1) * g.dil_h + 1;
}

__host__ __device__ inline int wwin(const Geometry& g) {
  return (g.tw - 1) * g.stride + wreach(g);
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
  return stage_taps(g) * g.chunk * lanes;
}

// k8 steps of a stage: its taps x chunk / 8
__host__ __device__ inline int steps(const Geometry& g) {
  return stage_taps(g) * g.chunk / 8;
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
// lane split's), out[1] the function's MACs (positions x taps x Cig x Co:
// a grouped conv's are 1/groups of the dense count), out[2] the
// tensor-core MACs the tiles issue: every CTA's 64 * wgs rows by `lanes`
// over every tap and its group's Cib padded to k8 slices, three products
// each.
__host__ inline void plan(const Geometry& g, int n, int lanes,
                          long long* out) {
  const long long t = tiles(g);
  out[0] = t;
  out[1] = (long long)n * g.ho * g.wo * taps(g) * cigblk(g) * g.cib * g.coblk
           * g.cob;
  out[2] = (long long)n * t * g.coblk * g.nsplit * kRows * g.wgs * lanes
           * taps(g) * cigblk(g) * kpad(g) * 3;
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

// Issue window rows [lo, hi) for channels [c0, c0 + chunk) of x's input
// block x_b of image n: window row r is input row h0 + r, column j input
// column w0 + j (the tile's origin times the stride, less the leading pads,
// plus the stage's first filter row's dilated offset), each
// cell landing at its column phase's place (the producer's 128 threads,
// `tid`).  A cell's copies (the chunk, a power of two, in units of 4 or 1
// floats) divide 128, so a thread keeps one channel offset and steps its
// (row, column) by a fixed stride, with no division a copy.
__device__ inline void issue_rows(float* win, const float* __restrict__ x,
                                  const Geometry& g, int n, int x_b, int c0,
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
  const float* xb = x + (size_t)(n * g.ciblk + x_b) * g.hi * g.wi * g.cib
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
// i_b, t0 + tap, c0 + k, o0 + l] (t0 the stage's first tap), zero past Cib
// and past Cob.  With a tensor map one TMA copy of the box [stage
// taps][chunk][N] (thread 0, onto m.wbar); else cp.async, a thread keeping
// one lane offset (a row's copies divide 128) and walking taps and
// channels.
template <int N>
__device__ inline void issue_weights(const Smem& m, const CUtensorMap* tmw,
                                     const float* __restrict__ w,
                                     const Geometry& g, int o_b, int i_b,
                                     int c0, int o0, int t0, int tid) {
  const int wblk = o_b * cigblk(g) + i_b;
  if (tma_weights(g)) {
    if (tid == 0) {
      dt::mbar_expect_tx(m.wbar, weight_floats(g, N) * 4);
      dt::tma_load_4d(m.raw, tmw, m.wbar, o0, c0, t0, wblk);
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
  const float* wb = w + (((size_t)wblk * taps(g) + t0) * g.cib + c0) * g.cob
                   + o0 + l;
  for (int tap = 0; tap < stage_taps(g); ++tap) {
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
  for (int u = tid; u < stage_taps(g) * g.chunk / 4 * N; u += kWarpgroup) {
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

// The A shift of each k8 step j (slice j % slices of the stage's tap j /
// slices), in floats from the row's offset (every thread of the CTA): tap
// (dh, dw) of the stage's filter rows starts dh dil_h window rows and dw
// dil_w columns on, the column at its stride phase's cell.
__device__ inline void step_shifts(int* shifts, const Geometry& g) {
  const int slices = g.chunk / 8;
  const int rf = row_floats(g);
  const int ld = cell_floats(g);
  const int ph = wph(g);
  for (int j = threadIdx.x; j < steps(g); j += blockDim.x) {
    const int tap = j / slices;
    const int dh = tap / g.wf;
    const int col = (tap - dh * g.wf) * g.dil_w;
    shifts[j] = dh * g.dil_h * rf
                + ((col % g.stride) * ph + col / g.stride) * ld
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
  const int rgs = row_groups(g);
  const int per_block = kpad(g) / g.chunk * rgs;
  const int count = stages(g);
  // stage s: (input block, chunk, filter rows), the filter rows fastest
  auto issue = [&](int s) {
    const int i_b = s / per_block;
    const int rem = s - i_b * per_block;
    const int c0 = rem / rgs * g.chunk;
    const int r0 = rem % rgs * g.frows;
    float* win = m.win_of(s % kSlots);
    for (int k = 0; k < g.strips; ++k) {
      if (k == 0) {
        issue_weights<N>(m, tmw, w, g, o_b, i_b, c0, o0, r0 * g.wf, tid);
      }
      int lo, hi;
      group_rows(g, k, lo, hi);
      issue_rows(win, x, g, n, x_block(g, o_b, i_b), c0, h0 + r0 * g.dil_h,
                 w0, lo, hi, tid);
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

// The wgmma widths a library compiles, and a width's instance index.
__host__ __device__ inline int lane_slot(int lanes) {
  switch (lanes) {
    case 8: return 0;
    case 16: return 1;
    case 32: return 2;
    case 64: return 3;
    case 128: return 4;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// the bf16 build
// ---------------------------------------------------------------------------
//
// The same function on bf16 operands: the reference's `_fwd_kernel` under
// BF16 (src/repro/kernels/direct_conv2d.py:102, pallas_call :351, casts
// :660-672), and its streamed form `_stream_conv_kernel`
// (src/repro/kernels/conv2d_stream.py:78, pallas_call :238).  x, w and the
// residual are bf16 (the wrapper casts the f32 master weights once a call),
// the sums f32 on bf16 wgmma (m64nNk16, one product a MAC), the epilogue
// act(acc + b) with an f32 bias, then + r in f32, rounded once to bf16 at
// the store; the GAP sums the stored bf16 values in f32 and the pooled
// features leave as bf16.  `run` is both kernels' body (`fwd_kernel_bf16`,
// `stream_fwd_kernel_bf16`), the dgrad's Hopper design (dgrad_tile.cuh,
// bf16) carried over:
//
// * A persistent grid.  As many CTAs as the card holds at once (asked of
//   the runtime once per kernel and size, dgrad_tile::bf16::resident_ctas)
//   walk the items (tile, output block x lane split, image), tile fastest,
//   and both rings run on across items, so that an item's first copies land
//   while the one before computes and stores.
// * A from shared memory by descriptor.  A cell (one window position's
//   `chunk` channels, 16, 32 or 64) is one row of a K-major operand in the
//   32-, 64- or 128-byte swizzle.  The window lands in that swizzle, its
//   cells flattened row-major, `wpitch` cells a window row (the window
//   kernel's plane width; the streamed kernel's rounded up to whole 128
//   bytes, where a strip's boxes land).  An m-tile is 64 consecutive cells:
//   row f is output position (f / wpitch, f % wpitch) of the tile, and tap
//   (dh, dw) is the same descriptor started dh * wpitch + dw cells on.  Rows
//   whose column falls past the tile's tw are computed and not stored; the
//   reads past the window's cells fall on the slot's spare cells
//   (`window_cells`), which only such rows read.
// * Stride s as s x s phase planes.  An output at stride s reads input (s
//   oh + dh - pt, s ow + dw - pl); the window is staged as s x s planes,
//   plane (ph, pw) holding the window's rows ph, ph + s, ... and columns
//   pw, pw + s, ..., so tap (dh, dw) reads plane (dh % s, dw % s) as a
//   stride-1 correlation, at (dh / s) * wpitch + dw / s cells on: again one
//   shifted descriptor.  Each plane lands by one TMA box a copy group that
//   traverses H and W at stride s (the map's element strides), so the
//   planes cost no pass and no more bytes than the window; a plane is
//   th + ceil(hf / s) - 1 rows of tw + ceil(wf / s) - 1 columns, so at 3x3
//   stride 2 the odd planes carry a row or column no tap reads (a 2x2 tile's
//   window of 5x5 cells is staged as 36).
// * B, the weights of one filter row (its wf taps), read MN-major through
//   the transpose bit as they lie (Cob contiguous, no transpose): a tap is
//   [N / nin][chunk][nin] bf16, rows of nin = min(N, 64) lanes in the
//   swizzle of their nin * 2 bytes, one TMA box a row.  (A box of 8-lane,
//   16-byte runs, the interleaved core matrices of the first bf16 build,
//   held the producer to a few bytes a cycle.)
//   The rows pass through a ring of 2-4 weight slots while the stage's
//   window stays in one of 2-4 window slots (`window_slots`, `row_slots`),
//   so chunk 64 fits at 3x3 and 128 lanes.
// * Straight-line rows, one accumulator.  A filter row is one wgmma fence,
//   its wf x chunk / 16 k16 steps at the full N width into the one f32
//   accumulator (straight-line code for rows of up to 3 taps, `mma_row`),
//   and one commit; the consumer then waits for the row before (wait<1>)
//   and frees its weight slot, and with a stage's first row the window
//   slot of the stage before.  Every descriptor is built from values the
//   compiler knows are uniform (kernel parameters, the item, the warpgroup
//   index read with __shfl_sync): a per-thread value there made the
//   compiler wait for each HGMMA (wgrad_tile.cuh, bf16).  With one
//   accumulator a 128-lane consumer holds 64 registers, so a CTA takes
//   three consumers at every width (`max_threads`).
// * The narrow rows (`run_narrow`, the kernel fwd_kernel_bf16_narrow;
//   narrow_rows.cuh), where a filter row's run of wf Cib values fits a
//   128-byte row at dilation 1 (Cib 3 at 11x11 and 3x3): A is a row a
//   position of the tile and group of r filter rows, K the group's packed
//   (dh, dw, c), a run of Lp lanes each, padded to k16 slices (3 slices a
//   group at conv1, where the per-tap tile ran 11 at a chunk of 16 for 3
//   channels); B the group's weight rows, a TMA box of L rows a run as they
//   lie in [taps * Cib][Cob].  The producer stages the item's input rows by
//   16-byte copies into a ring of 2-3 raw buffers (the window slots; 6-byte
//   pixels take no TMA, and AlexNet's 227-wide rows start 2 bytes
//   aligned), clears their pads, and builds each group's rows into a weight
//   slot beside its weights; A's values past the runs and its rows past the
//   tile stay the slot's zeros, so the next filter row's weights in B's
//   padding meet zeros.  Both are read as the bf16 build reads its cells
//   and weights (K-major A, MN-major B), one wgmma group a filter-row
//   group into the one accumulator, the same epilogue (`pitch` tw).
// * Warp roles.  One producer warpgroup: where x's and w's pencils are
//   multiples of 8 channels (TMA's 16-byte strides), its warp 0 issues
//   every TMA copy in the consumers' order and its other warps leave; else
//   every producer thread writes the same cells into the same swizzled
//   rows (a cell a thread: its valid channels by 2-byte loads, eight in
//   flight, then 16-byte stores: Cib 3 is a 6-byte pixel; a copy an element
//   with its own index arithmetic ran conv1_1 at 0.27 ms) and the weights
//   into the same order by 2-byte copies (where Cob is not
//   a multiple of 8 and of nin), zeros outside the map, past the pencil and
//   past Cob.  The streamed kernel's window lands as a copy
//   group a strip (strip 0's rows, then each later strip's fresh ones), so
//   strip k computes while strip k + 1's rows are in flight, each halo row
//   from device memory once a stage.
// * The epilogue and the GAP as the f32 tile's, on the flattened rows: a
//   consumer thread's rows are cells (f / wpitch, f % wpitch), which
//   conv2d_common.gap_replay follows from the blocking's `pitch`.  The GAP
//   partial of each item's tile, then the last item of an (image, output
//   block) to arrive sums its tiles in tile order (split_sum::gap_fold): no
//   sum depends on which CTA ran first, two runs give identical bits, and
//   where the window and the streamed kernels take the same chunk they sum
//   in the same order (stages, filter rows, taps, k16 slices).
//
// One accumulator over the whole contraction: the tensor cores add each
// k16 slice rounding toward zero, so over VGG-16's longest contraction (9 x
// 512: 288 k16 slices) the f32 sum drifts by at most 288 f32 ulps of its
// running magnitude (3.4e-5 relative), about 1 % of the half-ulp at which
// the output rounds to bf16; tests/test_torch_bf16_fwd.py emulates it.
//
// What bounds it on this card (launch/fwd_parts_ab.py --dtype bf16, on an
// H100 80GB HBM3 at 700 W, PERF.md): the consumers, not the copies (over
// VGG-16's 13 layers at batch 8 the kernel keeps 90 % of its time without
// its copies, 62 % without its wgmmas); and of the consumers' time, an
// item's end: its last rows drained (wait<0>) while the tensor cores idle,
// every consumer at once (without the epilogue the kernel takes 49 % of
// its time; with the accumulator only tested, 75 %).  Every tap's weights
// of a stage come again from L2 for every item.  What was tried and not
// kept: the first bf16 build (A loaded into registers at each k16 step, a
// wait between consecutive steps, a per-thread step table in shared
// memory, two 64-lane parts into a fresh accumulator a stage at 128 lanes,
// two consumers at 128 lanes, a CTA a tile; 2.265 ms as a CUDA graph);
// weight boxes of 8-lane, 16-byte runs (1.90 ms: the producer bound it); a
// copy an element on the Cib-3 path (conv1_1 0.27 ms, now 0.10); two
// accumulators at up to 64 lanes, an item's epilogue under the next item's
// first row (ptxas then waited after every wgmma, spilled the
// accumulators at 32 and 64 lanes, and the sums came out wrong); the
// activation and the GAP tested an element, a bias load an element and
// row, a store a column pair (1.30 ms; now 1.03).
namespace bf16 {

using bf = __nv_bfloat16;
namespace db = dgrad_tile::bf16;

// the dgrad's rings: a swizzle period's alignment, 2-4 window slots and
// 2-4 weight slots, their mbarriers after the slots (full (TMA landed) and
// ready (the copies' pass done) per window slot and copy group, empty per
// window slot; full and empty per weight slot)
constexpr int kAtom = db::kAtom;
constexpr int kMaxWindows = db::kMaxWindows;
constexpr int kMaxRows = db::kMaxRows;
constexpr int kBarBytes = db::kBarBytes;
constexpr int kSmemBlock = db::kSmemBlock;
constexpr int kMaxStride = 8;          // a TMA map's element stride at most
constexpr int kNarrowRaw = 3;          // the narrow rows' raw buffers at most

// threads of the largest CTA (the launch bound): three consumers at every
// width, the accumulator 64 registers at 128 lanes
__host__ __device__ constexpr int max_threads(int) { return kMaxThreads; }

// Cib rounded up to the k16 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cib, 16) * 16;
}

__host__ __device__ inline int stages(const Geometry& g) {
  return cigblk(g) * (bf16::kpad(g) / g.chunk);
}

// A filter row's weights lie as w does, Cob contiguous (MN-major): a tap's
// block is [N / nin][chunk][nin] bf16, rows of nin = min(N, 64) lanes in
// the swizzle of their nin * 2 bytes (none at 8 lanes: the interleaved
// core matrices), so that a TMA box lands them in runs of up to 128 bytes.
__host__ __device__ constexpr int b_lanes(int lanes) {
  return lanes < 64 ? lanes : 64;
}

// TMA needs global strides of whole 16 bytes: the window where Cib is a
// multiple of 8, the weights where Cob is, and a whole number of nin-lane
// runs
__host__ __device__ inline bool tma_window(const Geometry& g) {
  return g.cib % 8 == 0;
}
__host__ __device__ inline bool tma_weights(const Geometry& g, int lanes) {
  return g.cob % 8 == 0 && g.cob % b_lanes(lanes) == 0;
}

// bytes of a cell: one swizzled row of `chunk` channels
__host__ __device__ inline int cell_bytes(const Geometry& g) {
  return 2 * g.chunk;
}

__host__ __device__ inline bool streamed(const Geometry& g) {
  return g.strips > 1;
}

// The narrow rows (narrow_rows.cuh, `run_narrow`): the window kernel's A a
// 128-byte row an output position and filter-row group, K the group's
// packed (dh, dw, c), padded to k16 slices (`nkpad`).
__host__ __device__ inline bool narrow(const Geometry& g) {
  return g.narrow != 0;
}
__host__ __device__ inline int nkpad(const Geometry& g) {
  return narrow_rows::kpad(g.hf, g.wf, g.cib);
}

__host__ __device__ inline int planes(const Geometry& g) {
  return g.stride * g.stride;
}

// the plane rows (columns) from a plane's first tap to its farthest, plus
// one: the dilated reach over the stride
__host__ __device__ inline int mh(const Geometry& g) {
  return (hreach(g) - 1) / g.stride + 1;
}
__host__ __device__ inline int mw(const Geometry& g) {
  return (wreach(g) - 1) / g.stride + 1;
}

// Where tap t of a filter row (column) at dilation d lands in the phase
// planes: plane phase (t d) % s, (t d) / s plane rows (cells) on.
__host__ __device__ inline int tap_phase(const Geometry& g, int t, int d) {
  return t * d % g.stride;
}
__host__ __device__ inline int tap_shift(const Geometry& g, int t, int d) {
  return t * d / g.stride;
}

// a plane's rows and columns: the tile's and the taps' reach
__host__ __device__ inline int plane_rows(const Geometry& g) {
  return g.th + mh(g) - 1;
}
__host__ __device__ inline int plane_cols(const Geometry& g) {
  return g.tw + mw(g) - 1;
}

// cells of one 128-byte line
__host__ __device__ inline int line_cells(const Geometry& g) {
  return cell_bytes(g) < 128 ? 128 / cell_bytes(g) : 1;
}

// cells from one plane row to the next: the plane's width, or where a
// strip's boxes land at each row, rounded up to whole 128 bytes (a TMA
// destination's alignment).  The layout helpers below take the narrow
// rows' layout as a compile-time kNarrow (run_narrow's), so that the
// per-tap kernels' code tests no `narrow` field; the host's dispatch on
// it (`smem_bytes`, `valid`, `plan`).
template <bool kNarrow = false>
__host__ __device__ inline int wpitch(const Geometry& g) {
  if (kNarrow) return g.tw;               // a row a position of the tile
  const int per = line_cells(g);
  return streamed(g) ? ceil_div(plane_cols(g), per) * per : plane_cols(g);
}

// cells of a plane, in whole 128-byte lines, so that each plane's box lands
// aligned
__host__ __device__ inline int plane_cells(const Geometry& g) {
  const int per = line_cells(g);
  return ceil_div(plane_rows(g) * wpitch(g), per) * per;
}

__host__ __device__ inline int hso(const Geometry& g) {
  return g.th / g.strips;
}

// plane rows a TMA box of window rows brings: the window kernel's whole
// plane, a strip's rows in the streamed kernel
__host__ __device__ inline int box_rows(const Geometry& g) {
  return streamed(g) ? bf16::hso(g) : plane_rows(g);
}

// the first window cell (m-tile row) of consumer c: 64 rows a consumer of
// the window kernel's one m-tile, a strip's hso plane rows in the streamed
// band
__host__ __device__ inline int first_row(const Geometry& g, int c) {
  return streamed(g) ? c * bf16::hso(g) * wpitch(g) : c * kRows;
}

// cells from an m-tile row to its read at the farthest tap of a plane
__host__ __device__ inline int tap_reach(const Geometry& g) {
  return (mh(g) - 1) * wpitch(g) + mw(g) - 1;
}

// cells of a window slot: the planes', and past the last as far as the last
// consumer's 64 rows read at the farthest tap
__host__ __device__ inline int window_cells(const Geometry& g) {
  const int read = first_row(g, g.wgs - 1) + kRows + tap_reach(g);
  return (planes(g) - 1) * plane_cells(g)
         + (read > plane_cells(g) ? read : plane_cells(g));
}

__host__ __device__ inline int round_atom(int bytes) {
  return ceil_div(bytes, kAtom) * kAtom;
}

// bytes of a window slot and of a weight slot (one filter row's wf taps x N
// lanes), each in whole swizzle periods
// The narrow rows: a window slot is a raw buffer of the tile's input rows
// (the producer's alone, two of them), a weight slot a group's weights
// (nkpad rows of `lanes`) and the group's A rows (64 a consumer).
template <bool kNarrow = false>
__host__ __device__ inline int window_bytes(const Geometry& g) {
  if (kNarrow) {
    return round_atom(narrow_rows::raw_bytes(hwin(g), g.cib, wwin(g)));
  }
  return round_atom(window_cells(g) * cell_bytes(g));
}
template <bool kNarrow = false>
__host__ __device__ inline int row_weight_bytes(const Geometry& g,
                                                int lanes) {
  if (kNarrow) {
    return round_atom(nkpad(g) * lanes * 2)
           + kRows * g.wgs * narrow_rows::kRowBytes;
  }
  return round_atom(g.wf * lanes * cell_bytes(g));
}

// with GAP, the consumer warps' f32 sums [4 * wgs][lanes] and the last
// arrival's flag
__host__ __device__ inline int gap_bytes(const Geometry& g, int lanes) {
  return g.gap ? 16 * g.wgs * lanes + 16 : 0;
}

// The two rings (core/blocking.py fwd_bf16_layout): as many weight slots
// as fit beside two window slots, up to kMaxRows, then as many window slots
// as fit beside them, up to kMaxWindows.
__host__ __device__ inline int room(const Geometry& g, int lanes) {
  return kSmemBlock - kAtom - kBarBytes - gap_bytes(g, lanes);
}
template <bool kNarrow = false>
__host__ __device__ inline int row_slots(const Geometry& g, int lanes) {
  const int left = room(g, lanes) - 2 * window_bytes<kNarrow>(g);
  const int fit = left > 0 ? left / row_weight_bytes<kNarrow>(g, lanes) : 0;
  return fit < kMaxRows ? fit : kMaxRows;
}
template <bool kNarrow = false>
__host__ __device__ inline int window_slots(const Geometry& g, int lanes) {
  const int left = room(g, lanes) - row_slots<kNarrow>(g, lanes)
                                        * row_weight_bytes<kNarrow>(g, lanes);
  const int fit = left > 0 ? left / window_bytes<kNarrow>(g) : 0;
  // the narrow rows' raw buffers: two or three
  const int most = kNarrow ? kNarrowRaw : kMaxWindows;
  return fit < most ? fit : most;
}

// Dynamic shared memory of one CTA (core/blocking.py fwd_smem_bytes at
// op_bytes 2): a swizzle period to align the base, the window slots, the
// weight slots, the mbarriers, the GAP sums.
template <bool kNarrow>
__host__ inline size_t smem_bytes_of(const Geometry& g, int lanes) {
  return (size_t)kAtom
         + (size_t)window_slots<kNarrow>(g, lanes) * window_bytes<kNarrow>(g)
         + (size_t)row_slots<kNarrow>(g, lanes)
               * row_weight_bytes<kNarrow>(g, lanes)
         + kBarBytes + gap_bytes(g, lanes);
}
__host__ inline size_t smem_bytes(const Geometry& g, int lanes) {
  return narrow(g) ? smem_bytes_of<true>(g, lanes)
                   : smem_bytes_of<false>(g, lanes);
}

// Whether the kernels take this geometry at wgmma width `lanes` (the
// chooser's rules, core/blocking.py _fwd_bf16_candidates): the window
// kernel's tile in its one m-tile of 64 * wgs rows, the streamed kernel's
// strips of th / wgs plane rows each in its 64-row m-tile, a chunk of one
// swizzle row dividing the padded Cib, boxes within TMA's 256 elements an
// index, two slots or more in each ring.
__host__ inline bool valid(const Geometry& g, int lanes) {
  if (narrow(g)
      && (streamed(g) || lanes < 16 || g.cob % 8 != 0
          || !narrow_rows::fits(g.hf, g.wf, g.cib, g.dil_h, g.dil_w))) {
    return false;
  }
  if (!valid_map(g) || g.frows != g.hf || lane_slot(lanes) < 0 || g.wgs < 1
      || g.wgs > kMaxConsumers
      || (g.chunk != 16 && g.chunk != 32 && g.chunk != 64)
      || bf16::kpad(g) % g.chunk != 0 || g.th < 1 || g.tw < 1
      || g.stride < 1 || g.stride > kMaxStride || g.hf < 1 || g.wf < 1
      || g.nsplit < 1 || (g.nsplit - 1) * lanes >= g.cob
      || g.nsplit * lanes < g.cob || g.act < 0 || g.act > kActGelu
      || g.stride * (narrow(g) ? wpitch<true>(g) : wpitch(g)) > 256
      || g.wf > 256) {
    return false;
  }
  if (narrow(g)) {
    if (g.strips != 1 || (g.th - 1) * wpitch<true>(g) + g.tw > kRows * g.wgs
        || row_slots<true>(g, lanes) < 2 || window_slots<true>(g, lanes) < 2) {
      return false;
    }
  } else if (streamed(g)) {
    if (g.strips != g.wgs || g.wgs < 2 || g.th % g.strips != 0
        || (bf16::hso(g) - 1) * wpitch(g) + g.tw > kRows) {
      return false;
    }
  } else if (g.strips != 1
             || (g.th - 1) * wpitch(g) + g.tw > kRows * g.wgs) {
    return false;
  }
  return g.stride * box_rows(g) <= 256
         && (narrow(g) || (row_slots(g, lanes) >= 2
                           && window_slots(g, lanes) >= 2))
         && bf16::smem_bytes(g, lanes) <= (size_t)kSmemBlock;
}

// What a launch runs (core/blocking.py fwd_plan at op_bytes 2): out[0] an
// image's tiles, out[1] the function's MACs (a grouped conv's: over its
// group's Cig), out[2] the tensor-core MACs the items issue (every
// consumer's 64 m-tile rows by `lanes` over every tap and the group's Cib
// padded to k16 slices, one product each; on the narrow rows over every
// filter-row group's packed K padded to k16 slices), out[3] a CTA's shared
// memory, out[4] and out[5] its window and weight slots.
__host__ inline void plan(const Geometry& g, int n, int lanes,
                          long long* out) {
  const long long t = tiles(g);
  out[0] = t;
  out[1] = (long long)n * g.ho * g.wo * taps(g) * cigblk(g) * g.cib * g.coblk
           * g.cob;
  out[2] = (long long)n * t * g.coblk * g.nsplit * kRows * g.wgs * lanes
           * (narrow(g) ? (long long)narrow_rows::groups(g.hf, g.wf, g.cib)
                              * nkpad(g)
                        : (long long)taps(g) * bf16::kpad(g))
           * cigblk(g);
  out[3] = (long long)bf16::smem_bytes(g, lanes);
  out[4] = narrow(g) ? window_slots<true>(g, lanes) : window_slots(g, lanes);
  out[5] = narrow(g) ? row_slots<true>(g, lanes) : row_slots(g, lanes);
}

// The carve-up of one CTA (smem_bytes): the window slots, the weight
// slots, the mbarriers, then with GAP the consumer warps' sums and a flag.
struct Smem {
  char* win0;
  char* row0;
  uint64_t* wfull;     // [kMaxWindows][kMaxGroups]
  uint64_t* wready;    // [kMaxWindows][kMaxGroups]
  uint64_t* wempty;    // [kMaxWindows]
  uint64_t* rfull;     // [kMaxRows]
  uint64_t* rempty;    // [kMaxRows]
  float* red;          // [4 * wgs][N]
  int* flag;
  int wslot, rslot, nw, nr;
};

template <int N, bool kNarrow = false>
__device__ inline Smem carve(char* raw, const Geometry& g) {
  Smem m;
  m.win0 = raw + ((kAtom - (dt::smem_u32(raw) & (kAtom - 1))) & (kAtom - 1));
  m.wslot = window_bytes<kNarrow>(g);
  m.rslot = row_weight_bytes<kNarrow>(g, N);
  m.nw = window_slots<kNarrow>(g, N);
  m.nr = row_slots<kNarrow>(g, N);
  m.row0 = m.win0 + m.nw * m.wslot;
  m.wfull = reinterpret_cast<uint64_t*>(m.row0 + m.nr * m.rslot);
  m.wready = m.wfull + kMaxWindows * kMaxGroups;
  m.wempty = m.wready + kMaxWindows * kMaxGroups;
  m.rfull = m.wempty + kMaxWindows;
  m.rempty = m.rfull + kMaxRows;
  m.red = reinterpret_cast<float*>(m.rempty + kMaxRows);
  m.flag = reinterpret_cast<int*>(m.red + 4 * g.wgs * N);
  return m;
}

// Bytes the boxes of plane rows [lo, hi) bring, every plane's.
__device__ __forceinline__ int group_bytes(const Geometry& g, int lo,
                                           int hi) {
  return planes(g) * ceil_div(hi - lo, box_rows(g)) * box_rows(g)
         * wpitch(g) * cell_bytes(g);
}

// Issue plane rows [lo, hi) of every plane for channels [c0, c0 + chunk) of
// x's input block x_b of image n (lane `lane` of `lanes` taking every
// lanes-th box): plane (ph, pw) row r is input row h0 + ph + s r from
// column w0 + pw, every s-th column, wpitch of them; boxes of box_rows
// rows, the last moved back to end at `hi`.
__device__ void issue_window(const CUtensorMap* tmx, char* win, uint64_t* bar,
                             const Geometry& g, int n, int x_b, int c0,
                             int h0, int w0, int lo, int hi, int lane,
                             int lanes) {
  const int br = box_rows(g);
  const int boxes = ceil_div(hi - lo, br);
  const int pb = plane_cells(g) * cell_bytes(g);
  const int rb = wpitch(g) * cell_bytes(g);
  for (int i = lane; i < planes(g) * boxes; i += lanes) {
    const int p = i / boxes;
    const int r = min(lo + (i - p * boxes) * br, hi - br);
    dt::tma_load_5d(win + p * pb + r * rb, tmx, bar, c0,
                    w0 + p % g.stride, h0 + p / g.stride + g.stride * r, x_b,
                    n);
  }
}

// 2-byte loads a producer thread has in flight before it stores them
constexpr int kLoadBatch = 8;

__device__ __forceinline__ void st_v4(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// The same cells by copies (`tid` of the producer's kWarpgroup), a cell a
// thread a pass: its pixel's valid channels by 2-byte loads (a 16-byte
// piece's eight in flight at once), zeros outside the map and past the
// pencil, the cell stored as its 16-byte pieces at their swizzled places.
__device__ void copy_window(const bf* __restrict__ x, char* win,
                            const Geometry& g, int n, int x_b, int c0,
                            int h0, int w0, int lo, int hi, int tid) {
  const int cb = cell_bytes(g);
  const int wp = wpitch(g);
  const int pb = plane_cells(g) * cb;
  const int per_plane = (hi - lo) * wp;
  const int valid_c = min(g.chunk, g.cib - c0);
  const size_t map = (size_t)(n * g.ciblk + x_b) * g.hi * g.wi;
  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(x);
  const uint32_t base = dt::smem_u32(win);
  for (int i = tid; i < planes(g) * per_plane; i += kWarpgroup) {
    const int p = i / per_plane;
    const int rem = i - p * per_plane;
    const int r = rem / wp;
    const int col = rem - r * wp;
    const int ih = h0 + p / g.stride + g.stride * (lo + r);
    const int iw = w0 + p % g.stride + g.stride * col;
    const int valid = ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi
                      ? valid_c : 0;
    const unsigned short* src =
        x16 + ((map + (size_t)(valid > 0 ? ih : 0) * g.wi
                + (valid > 0 ? iw : 0)) * g.cib + c0);
    const uint32_t at = base + p * pb + ((lo + r) * wp + col) * cb;
    for (int q = 0; q < g.chunk / 8; ++q) {     // the cell's 16-byte pieces
      unsigned short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = 8 * q + e < valid ? __ldg(src + 8 * q + e)
                                 : (unsigned short)0;
      }
      uint32_t words[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        words[e] = (uint32_t)v[2 * e] | ((uint32_t)v[2 * e + 1] << 16);
      }
      st_v4(db::swizzled(at + 16 * q, cb), words);
    }
  }
}

// Issue the weights of filter row dh of a stage (thread 0): one TMA box of
// [wf][N / nin][chunk][nin] (b_lanes), element (j, q, k, e) = w[o_b, i_b,
// dh, j, c0 + k, o0 + nin q + e], zeros past Cib; the weight's input blocks
// are its group's, Cig/Cib of them.
template <int N>
__device__ __forceinline__ void issue_row_weights(const CUtensorMap* tmw,
                                                  char* dst, uint64_t* bar,
                                                  const Geometry& g, int o_b,
                                                  int i_b, int dh, int c0,
                                                  int o0) {
  dt::tma_load_5d(dst, tmw, bar, 0, c0, o0 / b_lanes(N), dh * g.wf,
                  o_b * cigblk(g) + i_b);
}

// The byte of weight (tap j, lane l, channel k) in a row slot at `base`, as
// the TMA box lands it.
template <int N>
__device__ __forceinline__ uint32_t weight_at(uint32_t base,
                                              const Geometry& g, int j,
                                              int l, int k) {
  constexpr int nin = b_lanes(N);
  const uint32_t a = base + ((j * (N / nin) + l / nin) * g.chunk + k) * nin * 2
                     + (l % nin) * 2;
  return nin >= 16 ? db::swizzled(a, nin * 2) : a;
}

// The same row by 2-byte loads, kLoadBatch in flight, and stores (`tid` of
// the producer's kWarpgroup), zeros past Cib and past Cob.
template <int N>
__device__ void copy_row_weights(const bf* __restrict__ w, char* dst,
                                 const Geometry& g, int o_b, int i_b, int dh,
                                 int c0, int o0, int tid) {
  const int valid_k = min(g.chunk, g.cib - c0);
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w)
      + ((size_t)((o_b * cigblk(g) + i_b) * taps(g) + dh * g.wf) * g.cib
         + c0) * g.cob + o0;
  const uint32_t base = dt::smem_u32(dst);
  const int total = g.wf * N * g.chunk;
  for (int i0 = tid; i0 < total; i0 += kWarpgroup * kLoadBatch) {
    unsigned short v[kLoadBatch];
    uint32_t at[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int i = i0 + b * kWarpgroup;
      const int l = i % N;                      // (j, k, l), lanes fastest
      const int k = i / N % g.chunk;
      const int j = i / N / g.chunk;
      const bool ok = i < total && k < valid_k && o0 + l < g.cob;
      v[b] = ok ? __ldg(wb + ((size_t)j * g.cib + k) * g.cob + l)
                : (unsigned short)0;
      at[b] = weight_at<N>(base, g, j, l, k);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      if (i0 + b * kWarpgroup < total) db::st_u16(at[b], v[b]);
    }
  }
}

// B of a k16 step less its address, MN-major (read through the transpose
// bit): at 8 lanes the interleaved core matrices (8 lanes x 8 channels, 128
// bytes; the leading byte offset 128, the step's two channel halves; the
// stride byte offset chunk * 16, the 8-lane groups), else rows of nin lanes
// in their swizzle (the leading byte offset chunk * nin * 2, the nin-lane
// blocks; the stride byte offset 8 rows, the 8-channel groups).  A k16 step
// starts 16 rows (32 nin bytes) on.
template <int N>
__device__ __forceinline__ uint64_t b_desc(int chunk) {
  constexpr int nin = b_lanes(N);
  if (nin == 8) return dt::kmajor_desc(0, 128, chunk * 16);
  const uint64_t layout = nin == 64 ? 1 : (nin == 32 ? 2 : 3);
  return ((uint64_t)((chunk * nin * 2 >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((8 * nin * 2) >> 4) << 32) | (layout << 62);
}

// Issue filter row `r`'s CT taps of a landed stage into `acc` as one wgmma
// group: tap j reads the m-tile's cells from `a` plus its offset (0, t1,
// t2: the next tap's plane or cell) against its weights from `b`, its S =
// chunk / 16 steps 32 bytes (A) and 32 nin bytes (B) apart.  Straight-line
// code (CT and S template arguments): a branch between two wgmmas made the
// compiler fence before each one and close a group after it.
template <int N, int S, int CT>
__device__ __forceinline__ void mma_row(float (&acc)[N / 2], uint32_t a,
                                        uint32_t b, uint32_t t1, uint32_t t2,
                                        uint64_t adesc, uint64_t bdesc) {
  dt::wgmma_fence();
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const uint32_t aj = a + (j == 0 ? 0u : (j == 1 ? t1 : t2));
#pragma unroll
    for (int k = 0; k < S; ++k) {
      db::wgmma_ss<N, 1>(acc, db::desc_at(adesc, aj + 32 * k),
                         db::desc_at(bdesc, b + j * N * 32 * S
                                                + 32 * b_lanes(N) * k));
    }
  }
  dt::wgmma_commit();
}

// The same for any tap count (a filter wider than 3 taps): a loop over the
// row's taps, S straight-line steps a tap; tap j at plane (j dil_w) % s,
// cell (j dil_w) / s.
template <int N, int S>
__device__ __forceinline__ void mma_row_any(float (&acc)[N / 2], uint32_t a,
                                            uint32_t b, const Geometry& g,
                                            uint32_t pb, uint64_t adesc,
                                            uint64_t bdesc) {
  constexpr int cb = 32 * S;
  dt::wgmma_fence();
  for (int j = 0; j < g.wf; ++j) {
    const uint32_t aj = a + tap_phase(g, j, g.dil_w) * pb
                        + tap_shift(g, j, g.dil_w) * cb;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      db::wgmma_ss<N, 1>(acc, db::desc_at(adesc, aj + 32 * k),
                         db::desc_at(bdesc, b + j * N * cb
                                                + 32 * b_lanes(N) * k));
    }
  }
  dt::wgmma_commit();
}

template <int N, int S>
__device__ __forceinline__ void mma_row_of(float (&acc)[N / 2], uint32_t a,
                                           uint32_t b, const Geometry& g,
                                           uint32_t t1, uint32_t t2,
                                           uint32_t pb, uint64_t adesc,
                                           uint64_t bdesc) {
  if (g.wf == 3) {
    mma_row<N, S, 3>(acc, a, b, t1, t2, adesc, bdesc);
  } else if (g.wf == 2) {
    mma_row<N, S, 2>(acc, a, b, t1, t2, adesc, bdesc);
  } else if (g.wf == 1) {
    mma_row<N, S, 1>(acc, a, b, t1, t2, adesc, bdesc);
  } else {
    mma_row_any<N, S>(acc, a, b, g, pb, adesc, bdesc);
  }
}

template <int N>
__device__ __forceinline__ void mma_filter_row(float (&acc)[N / 2],
                                               uint32_t a, uint32_t b,
                                               const Geometry& g, uint32_t t1,
                                               uint32_t t2, uint32_t pb,
                                               uint64_t adesc,
                                               uint64_t bdesc) {
  if (g.chunk == 64) {
    mma_row_of<N, 4>(acc, a, b, g, t1, t2, pb, adesc, bdesc);
  } else if (g.chunk == 32) {
    mma_row_of<N, 2>(acc, a, b, g, t1, t2, pb, adesc, bdesc);
  } else {
    mma_row_of<N, 1>(acc, a, b, g, t1, t2, pb, adesc, bdesc);
  }
}

// A work item of the persistent grid: item i is tile i % tiles of output
// column (block x lane split) i / tiles % (Co/Cob x nsplit) of image i /
// (tiles x Co/Cob x nsplit).
struct Item {
  int tile, o_b, split, n, oh0, ow0;
};

__device__ __forceinline__ Item item_of(const Geometry& g, int tiles, int i) {
  Item it;
  const int cols = g.coblk * g.nsplit;
  const int across = ceil_div(g.wo, g.tw);
  it.tile = i % tiles;
  const int col = i / tiles % cols;
  it.o_b = col / g.nsplit;
  it.split = col - it.o_b * g.nsplit;
  it.n = i / tiles / cols;
  it.oh0 = it.tile / across * g.th;
  it.ow0 = it.tile % across * g.tw;
  return it;
}

// The epilogue of consumer c's m-tile in f32, one rounding to bf16 at the
// store: m-tile row q is window cell f = first_row(c) + q, output position
// (f / wpitch, f % wpitch) of the tile, stored where that lies in the tile
// (in the streamed band, in strip c) and the map.  With GAP, the tile's sums
// of the stored values into `partials` and the (image, output block)'s last
// item's fold into `pooled`.
template <int N, int kAct, bool kGap, bool kNarrow>
__device__ __forceinline__ void store_out(float (&acc)[N / 2],
                                          const Geometry& g, const Item& it,
                                          int c, int tiles, const Smem& m,
                                          const float* __restrict__ bias,
                                          const bf* __restrict__ residual,
                                          bf* __restrict__ out,
                                          float* partials,
                                          bf* __restrict__ pooled,
                                          int* counters) {
  const int lane = threadIdx.x % 32;
  const int local = threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int wp = wpitch<kNarrow>(g);
  const int strip = streamed(g) ? bf16::hso(g) * wp : kRows;
  const int o0 = it.split * N;
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.cob % 2 == 0;
  bool row_ok[2];
  size_t base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    const int f = first_row(g, c) + q;
    const int a = f / wp;
    const int b = f - a * wp;
    const int oh = it.oh0 + a;
    const int ow = it.ow0 + b;
    row_ok[h] = q < strip && a < g.th && b < g.tw && oh < g.ho && ow < g.wo;
    base[h] = (((size_t)(it.n * g.coblk + it.o_b) * g.ho + oh) * g.wo + ow)
              * g.cob + o0;
  }
  const float* bias_row =
      bias != nullptr ? bias + it.o_b * g.cob + o0 : nullptr;
  // a column pair's bias by one 8-byte load where it lies on 8 bytes
  const bool bias_pairs =
      pairs && (reinterpret_cast<uintptr_t>(bias_row) & 7) == 0;
  // A quad of lanes (t = lane % 4) holds a row's 8-column groups, a column
  // pair a lane; four groups at a time are turned among the quad by
  // shuffles so that lane t stores group 4q + t's 16 bytes in one store,
  // where Cob is a multiple of 8 (a store a pair stored a row in 16-byte
  // pieces: 0.29 ms over VGG-16's layers).
  constexpr int kGJ = N / 8 < 4 ? N / 8 : 4;       // groups turned at once
  const bool vec = kGJ == 4 && g.cob % 8 == 0;
  const int t = lane % 4;
#pragma unroll
  for (int q = 0; q < N / 8 / kGJ; ++q) {
    uint32_t pk[2][kGJ];        // each row's bf16 pair of each group
    bool cok[kGJ][2];           // the pair's columns below Cob
#pragma unroll
    for (int u = 0; u < kGJ; ++u) {
      const int jj = q * kGJ + u;
      const int col = 8 * jj + col0;
      // the column pair's bias, once for both rows
      float bv[2] = {0.0f, 0.0f};
      if (bias_row != nullptr) {
        if (bias_pairs && o0 + col + 1 < g.cob) {
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias_row
                                                                  + col));
          bv[0] = b2.x;
          bv[1] = b2.y;
        } else {
          if (o0 + col < g.cob) bv[0] = __ldg(bias_row + col);
          if (o0 + col + 1 < g.cob) bv[1] = __ldg(bias_row + col + 1);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) cok[u][e] = o0 + col + e < g.cob;
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
          if (row_ok[h] && o0 + col8 < g.cob) {
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
  // a thread's two rows, a warp's eight row groups by shuffles, then the
  // consumer warps in order
  const int consumers = g.wgs * kWarpgroup;
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
  const int column = it.n * g.coblk + it.o_b;
  if ((int)threadIdx.x < N && o0 + (int)threadIdx.x < g.cob) {
    float s = 0.0f;
    for (int w = 0; w < consumers / 32; ++w) s += m.red[w * N + threadIdx.x];
    partials[((size_t)column * tiles + it.tile) * g.cob + o0 + threadIdx.x] =
        s;
  }
  // the last item of (n, o_b), both lane halves: its tiles in order, times
  // the f32 reciprocal of Ho * Wo
  split_sum::gap_fold(partials, pooled, counters, column, tiles,
                      tiles * g.nsplit, g.cob, g.ho * g.wo, m.flag, kBarGap,
                      consumers);
}

// store_out at the geometry's activation and GAP, each a compile-time
// constant of its own copy (a runtime test an element cost the epilogue,
// which the tensor cores wait out).
template <int N, bool kNarrow = false>
__device__ __forceinline__ void store_any(float (&acc)[N / 2],
                                          const Geometry& g, const Item& it,
                                          int c, int tiles, const Smem& m,
                                          const float* __restrict__ bias,
                                          const bf* __restrict__ residual,
                                          bf* __restrict__ out,
                                          float* partials,
                                          bf* __restrict__ pooled,
                                          int* counters) {
#define FWD_STORE(act, gap)                                                \
  store_out<N, act, gap, kNarrow>(acc, g, it, c, tiles, m, bias, residual, \
                                  out, partials, pooled, counters)
  if (g.gap) {
    if (g.act == kActRelu) {
      FWD_STORE(kActRelu, true);
    } else if (g.act == kActGelu) {
      FWD_STORE(kActGelu, true);
    } else {
      FWD_STORE(0, true);
    }
  } else if (g.act == kActRelu) {
    FWD_STORE(kActRelu, false);
  } else if (g.act == kActGelu) {
    FWD_STORE(kActGelu, false);
  } else {
    FWD_STORE(0, false);
  }
#undef FWD_STORE
}

// Both kernels' body: a persistent CTA walks the items blockIdx.x,
// blockIdx.x + gridDim.x, ... of `n_images` images (item_of); the streamed
// band (a copy group and a 64-row m-tile a strip) or the window tile (one
// group, one m-tile of 64 rows a consumer).  A stage (input block, chunk)
// lands its window in a ring of nw window slots and the weights of each
// filter row in turn in a ring of nr weight slots; the window stays while
// the stage's rows pass through the weight ring.  A window slot's `full`
// mbarriers complete as its TMA copies land, its `ready` ones once the
// producer's copies have, its `empty` one once every consumer thread's
// wgmmas of the stage's last row are done; a weight slot's `full` one as
// its copy lands, its `empty` one once the wgmmas of its row are done.
// With GAP: `partials` [N, Co/Cob, tiles, Cob] f32, `pooled` [N, Co] bf16,
// `counters` an int32 an (image, output block), zeroed.
template <int N>
__device__ __forceinline__ void run(char* raw, const CUtensorMap* tmw,
                                    const CUtensorMap* tmx,
                                    const bf* __restrict__ x,
                                    const bf* __restrict__ w,
                                    const float* __restrict__ bias,
                                    const bf* __restrict__ residual,
                                    bf* __restrict__ out, float* partials,
                                    bf* __restrict__ pooled, int* counters,
                                    const Geometry& g, int n_images) {
  const int nth = blockDim.x;
  const int consumers = g.wgs * kWarpgroup;
  const int groups = streamed(g) ? g.wgs : 1;
  const Smem m = carve<N>(raw, g);
  const int nw = m.nw, nr = m.nr;
  const int per_block = bf16::kpad(g) / g.chunk;
  const int count = bf16::stages(g);
  const int tiles = fwd_tile::tiles(g);
  const int items = tiles * g.coblk * g.nsplit * n_images;
  const int h = bf16::hso(g);
  const int mh1 = mh(g) - 1;
  const bool twin = tma_window(g);
  const bool twts = bf16::tma_weights(g, N);
  // plane rows of copy group k: strip 0's all, a later strip's fresh ones
  auto lo_of = [&](int k) { return k == 0 ? 0 : k * h + mh1; };
  auto hi_of = [&](int k) { return (k + 1) * h + mh1; };
  auto win = [&](int slot) { return m.win0 + slot * m.wslot; };
  auto wrow = [&](int slot) { return m.row0 + slot * m.rslot; };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxWindows * kMaxGroups; ++i) {
      dt::mbar_init(&m.wfull[i], 1);
      dt::mbar_init(&m.wready[i], kWarpgroup);
    }
    for (int i = 0; i < kMaxWindows; ++i) {
      dt::mbar_init(&m.wempty[i], consumers);
    }
    for (int i = 0; i < kMaxRows; ++i) {
      dt::mbar_init(&m.rfull[i], twts ? 1 : kWarpgroup);
      dt::mbar_init(&m.rempty[i], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {             // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    // TMA alone needs warp 0; copies need every producer thread
    if (twin && twts && tid >= 32) return;
    int gw = 0, gr = 0;       // stages and filter rows so far
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item_of(g, tiles, i);
      const int h0 = it.oh0 * g.stride - g.pad_top;
      const int w0 = it.ow0 * g.stride - g.pad_left;
      for (int s = 0; s < count; ++s, ++gw) {
        const int i_b = s / per_block;
        const int c0 = (s - i_b * per_block) * g.chunk;
        const int ws = gw % nw;
        if (gw >= nw) dt::mbar_wait(&m.wempty[ws], ((gw / nw) & 1) ^ 1);
        if (twin) {                   // warp 0: TMA, a group a strip
          if (tid < 32) {
            uint64_t* full = &m.wfull[ws * kMaxGroups];
            if (tid == 0) {
              for (int k = 0; k < groups; ++k) {
                dt::mbar_expect_tx(&full[k],
                                   group_bytes(g, lo_of(k), hi_of(k)));
              }
            }
            __syncwarp();
            for (int k = 0; k < groups; ++k) {
              issue_window(tmx, win(ws), &full[k], g, it.n,
                           x_block(g, it.o_b, i_b), c0, h0, w0, lo_of(k),
                           hi_of(k), tid, 32);
            }
          }
        } else {                      // every producer thread copies
          copy_window(x, win(ws), g, it.n, x_block(g, it.o_b, i_b), c0, h0,
                      w0, 0, hi_of(groups - 1), tid);
          dt::fence_proxy_async();    // the stores, for wgmma's reads
          for (int k = 0; k < groups; ++k) {
            db::mbar_arrive(&m.wready[ws * kMaxGroups + k]);
          }
        }
        for (int r = 0; r < g.hf; ++r, ++gr) {
          const int rs = gr % nr;
          if (gr >= nr) dt::mbar_wait(&m.rempty[rs], ((gr / nr) & 1) ^ 1);
          if (twts) {
            if (tid == 0) {
              dt::mbar_expect_tx(&m.rfull[rs], g.wf * N * cell_bytes(g));
              issue_row_weights<N>(tmw, wrow(rs), &m.rfull[rs], g, it.o_b,
                                   i_b, r, c0, it.split * N);
            }
          } else {
            copy_row_weights<N>(w, wrow(rs), g, it.o_b, i_b, r, c0,
                                it.split * N, tid);
            dt::fence_proxy_async();
            db::mbar_arrive(&m.rfull[rs]);
          }
        }
      }
    }
    return;
  }

  // a consumer: the window tile's rows 64c.. or the streamed band's strip
  // c, its index read warp-uniform so that the descriptors are uniform
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int group = streamed(g) ? c : 0;
  const uint32_t cb = cell_bytes(g);
  const uint32_t pb = plane_cells(g) * cb;
  const uint32_t rb = wpitch(g) * cb;
  // the offsets of taps 1 and 2 of a filter row: dil_w and 2 dil_w columns
  // on, each in its column phase's plane
  const uint32_t t1 = tap_phase(g, 1, g.dil_w) * pb
                      + tap_shift(g, 1, g.dil_w) * cb;
  const uint32_t t2 = tap_phase(g, 2, g.dil_w) * pb
                      + tap_shift(g, 2, g.dil_w) * cb;
  const uint32_t row0 = first_row(g, c) * cb;
  const uint64_t adesc = db::desc_of(cb);
  const uint64_t bdesc = b_desc<N>(g.chunk);
  int gw = 0, gr = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_of(g, tiles, i);
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;
    for (int s = 0; s < count; ++s, ++gw) {
      const int ws = gw % nw;
      const int wpar = (gw / nw) & 1;
      if (twin) {           // the copies the wgmmas read have landed
        for (int k = 0; k <= group; ++k) {
          dt::mbar_wait(&m.wfull[ws * kMaxGroups + k], wpar);
        }
      } else {
        dt::mbar_wait(&m.wready[ws * kMaxGroups + group], wpar);
      }
      const uint32_t a0 = dt::smem_u32(win(ws)) + row0;
      for (int r = 0; r < g.hf; ++r, ++gr) {
        const int rs = gr % nr;
        dt::mbar_wait(&m.rfull[rs], (gr / nr) & 1);
        // filter row r reads row phase (r dil_h) % s, (r dil_h) / s plane
        // rows on
        mma_filter_row<N>(acc,
                          a0 + tap_phase(g, r, g.dil_h) * g.stride * pb
                              + tap_shift(g, r, g.dil_h) * rb,
                          dt::smem_u32(wrow(rs)), g, t1, t2, pb, adesc,
                          bdesc);
        if (s > 0 || r > 0) {
          dt::wgmma_wait<1>();    // the row before is done: free its slots
          db::mbar_arrive(&m.rempty[(gr - 1) % nr]);
          if (r == 0) db::mbar_arrive(&m.wempty[(gw - 1) % nw]);
        }
      }
    }
    dt::wgmma_wait<0>();
    if (count > 0) {
      db::mbar_arrive(&m.rempty[(gr - 1) % nr]);
      db::mbar_arrive(&m.wempty[(gw - 1) % nw]);
    }
    dt::fence_regs<N / 2>(acc);
    store_any<N>(acc, g, it, c, tiles, m, bias, residual, out, partials,
                 pooled, counters);
  }
}

// A filter-row group of the narrow rows: one wgmma group of `steps` k16
// slices (1-4, the group's packed K), A the group's rows of this consumer's
// 64 positions, K-major in the 128-byte swizzle, B its weights' rows as
// they lie.
template <int N>
__device__ __forceinline__ void mma_narrow(float (&acc)[N / 2], uint32_t a,
                                           uint32_t b, int steps,
                                           uint64_t adesc, uint64_t bdesc) {
  if (steps == 4) {
    mma_row<N, 4, 1>(acc, a, b, 0, 0, adesc, bdesc);
  } else if (steps == 3) {
    mma_row<N, 3, 1>(acc, a, b, 0, 0, adesc, bdesc);
  } else if (steps == 2) {
    mma_row<N, 2, 1>(acc, a, b, 0, 0, adesc, bdesc);
  } else {
    mma_row<N, 1, 1>(acc, a, b, 0, 0, adesc, bdesc);
  }
}

// The window kernel on the narrow rows (`fwd_kernel_bf16_narrow`;
// narrow_rows.cuh): the same persistent walk of items and the same
// epilogue, a stage an input block of the group.  A stage ahead the
// producer stages the item's input rows into one of two raw buffers (the
// window slots, its own) and clears their pads; then for each filter-row
// group j it waits for a weight slot, lands the group's weight rows there
// by TMA (a box of L rows (j r + k) L .. of the block's [taps * Cib][Cob] a
// run k, at row k Lp) and builds the group's A rows beside them, one
// 128-byte row a position of the tile;
// the slot's `full` mbarrier completes with the box and the producer's 128
// arrivals.  A consumer runs each group's k16 slices into its one
// accumulator and frees the group before (wait<1>), as `run` frees rows.
// B's rows in a run's gap and past the group's runs are the slots' zeros
// (zeroed once, never written), as are A's rows past the tile.
template <int N>
__device__ __forceinline__ void run_narrow(char* raw,
                                           const CUtensorMap* tmw,
                                           const bf* __restrict__ x,
                                           const float* __restrict__ bias,
                                           const bf* __restrict__ residual,
                                           bf* __restrict__ out,
                                           float* partials,
                                           bf* __restrict__ pooled,
                                           int* counters, const Geometry& g,
                                           int n_images) {
  const int nth = blockDim.x;
  const int consumers = g.wgs * kWarpgroup;
  const Smem m = carve<N, true>(raw, g);
  const int nr = m.nr;
  const int count = cigblk(g);
  const int ng = narrow_rows::groups(g.hf, g.wf, g.cib);
  const int kp = nkpad(g);
  const int bbytes = round_atom(kp * N * 2);
  const int tiles = fwd_tile::tiles(g);
  const int items = tiles * g.coblk * g.nsplit * n_images;
  {
    uint4* p = reinterpret_cast<uint4*>(m.row0);
    const int n16 = nr * m.rslot / 16;
    for (int i = threadIdx.x; i < n16; i += nth) p[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxRows; ++i) {
      dt::mbar_init(&m.rfull[i], kWarpgroup + 1);
      dt::mbar_init(&m.rempty[i], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  dt::fence_proxy_async();      // the zeros, before TMA and wgmma see them
  __syncthreads();

  if (threadIdx.x >= consumers) {             // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    const int hw = hwin(g), ww = wwin(g);
    const int L = narrow_rows::run_values(g.wf, g.cib);
    const int Lp = narrow_rows::run_pad(g.wf, g.cib);
    const int r = narrow_rows::rows_a_group(g.hf, g.wf, g.cib);
    constexpr int nin = b_lanes(N);
    // the CTA's stages (items x input blocks); stage q's rows go to raw
    // buffer q % nw, nw - 1 stages ahead, one copy group a stage (empty
    // past the last)
    const int total = blockIdx.x < items
        ? ((items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * count : 0;
    auto stage_raw = [&](int q) {
      if (q < total) {
        const Item it = item_of(g, tiles, blockIdx.x + q / count * gridDim.x);
        narrow_rows::stage(m.win0 + q % m.nw * m.wslot,
                           x + (size_t)(it.n * g.ciblk
                                        + x_block(g, it.o_b, q % count))
                                   * g.hi * g.wi * g.cib,
                           g.hi, g.wi, g.cib, it.oh0 * g.stride - g.pad_top,
                           it.ow0 * g.stride - g.pad_left, hw, ww, tid);
      }
      narrow_rows::cp_async_commit();
    };
    for (int q = 0; q < m.nw - 1; ++q) stage_raw(q);
    int gq = 0, gr = 0;       // stages and groups so far
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item_of(g, tiles, i);
      for (int s = 0; s < count; ++s, ++gq) {
        stage_raw(gq + m.nw - 1);           // later stages' rows in flight
        narrow_rows::cp_async_wait(m.nw - 1);
        dt::bar_sync(kBarProducer, kWarpgroup);   // stage gq's rows landed
        char* rows = m.win0 + gq % m.nw * m.wslot;
        narrow_rows::clear(rows, hw, ww, g.cib, tid);
        dt::bar_sync(kBarProducer, kWarpgroup);
        for (int j = 0; j < ng; ++j, ++gr) {
          const int rs = gr % nr;
          if (gr >= nr) dt::mbar_wait(&m.rempty[rs], ((gr / nr) & 1) ^ 1);
          char* slot = m.row0 + rs * m.rslot;
          if (tid == 0) {
            // a box of L weight rows a run of the group, at row k Lp
            const int live = min(r, g.hf - j * r);
            dt::mbar_expect_tx(&m.rfull[rs], live * L * N * 2);
            for (int k = 0; k < live; ++k) {
              for (int b = 0; b < N / nin; ++b) {
                db::tma_load_3d(slot + (b * kp + k * Lp) * nin * 2, tmw,
                                &m.rfull[rs], it.split * N + b * nin,
                                (j * r + k) * L, it.o_b * cigblk(g) + s);
              }
            }
          }
          narrow_rows::build(dt::smem_u32(slot) + bbytes, rows, hw, ww,
                             g.cib, g.stride, g.hf, g.wf, j, g.tw,
                             g.th * g.tw, tid);
          dt::fence_proxy_async();    // the rows, for wgmma's reads
          db::mbar_arrive(&m.rfull[rs]);
        }
        dt::bar_sync(kBarProducer, kWarpgroup);   // its raw rows all read
      }
    }
    return;
  }

  // a consumer: rows 64c.. of the tile, its index read warp-uniform so
  // that the descriptors are uniform
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const uint32_t row0 = bbytes + c * kRows * narrow_rows::kRowBytes;
  const uint64_t adesc = db::desc_of(narrow_rows::kRowBytes);
  const uint64_t bdesc = b_desc<N>(kp);
  const int steps = kp / 16;
  int gr = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_of(g, tiles, i);
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;
    for (int s = 0; s < count; ++s) {
      for (int j = 0; j < ng; ++j, ++gr) {
        const int rs = gr % nr;
        dt::mbar_wait(&m.rfull[rs], (gr / nr) & 1);
        const uint32_t b = dt::smem_u32(m.row0 + rs * m.rslot);
        mma_narrow<N>(acc, b + row0, b, steps, adesc, bdesc);
        if (s > 0 || j > 0) {
          dt::wgmma_wait<1>();    // the group before is done: free its slot
          db::mbar_arrive(&m.rempty[(gr - 1) % nr]);
        }
      }
    }
    dt::wgmma_wait<0>();
    if (count > 0) db::mbar_arrive(&m.rempty[(gr - 1) % nr]);
    dt::fence_regs<N / 2>(acc);
    store_any<N, true>(acc, g, it, c, tiles, m, bias, residual, out,
                 partials, pooled, counters);
  }
}

// The weights' tensor map: [blocks][taps][Cib][Cob / nin][nin] bf16 with a
// box of one filter row, [wf][chunk][lanes / nin][nin] (landing [wf][lanes /
// nin][chunk][nin] in the swizzle of nin * 2 bytes), where tma_weights.  ->
// false where the encoder refuses it.
inline bool encode_weights(CUtensorMap* tmw, const void* w, const Geometry& g,
                           int lanes) {
  const int nin = b_lanes(lanes);
  const long long cob = g.cob, blocks = (long long)g.coblk * cigblk(g);
  const long long dims[5] = {nin, g.cib, cob / nin, taps(g), blocks};
  const long long strides[4] = {cob * 2, nin * 2, g.cib * cob * 2,
                                taps(g) * g.cib * cob * 2};
  const int box[5] = {nin, g.chunk, lanes / nin, g.wf, 1};
  if (nin == 8) {
    return dt::encode(tmw, w, 5, dims, strides, box,
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  }
  return db::encode_swizzled(tmw, w, 5, dims, strides, box, nin * 2);
}

// The narrow rows' weights: [blocks][taps * Cib][Cob] bf16 with a box of
// {nin, L, 1} (a run's L rows, `nin` lanes of them, landing [L][nin] in the
// swizzle of nin * 2 bytes at row k Lp of the group's [nkpad][nin]; lanes
// past Cob land as zeros), where Cob is a multiple of 8.
inline bool encode_weights_narrow(CUtensorMap* tmw, const void* w,
                                  const Geometry& g, int lanes) {
  const int nin = b_lanes(lanes);
  const long long cob = g.cob, blocks = (long long)g.coblk * cigblk(g);
  const long long dims[3] = {cob, (long long)taps(g) * g.cib, blocks};
  const long long strides[2] = {cob * 2, taps(g) * g.cib * cob * 2};
  const int box[3] = {nin, narrow_rows::run_values(g.wf, g.cib), 1};
  return db::encode_swizzled(tmw, w, 3, dims, strides, box, nin * 2);
}

// x's tensor map: [N][Ci/Cib][Hi][Wi][Cib] bf16 with a box of {chunk, s
// wpitch, s box_rows} traversed at stride s along W and H, landing box_rows
// plane rows of wpitch cells in the chunk's swizzle, where Cib is a multiple
// of 8.
inline bool encode_window(CUtensorMap* tmx, const void* x, const Geometry& g,
                          int n) {
  const long long cib = g.cib;
  const long long dims[5] = {cib, g.wi, g.hi, g.ciblk, n};
  const long long strides[4] = {cib * 2, g.wi * cib * 2,
                                (long long)g.hi * g.wi * cib * 2,
                                (long long)g.ciblk * g.hi * g.wi * cib * 2};
  const int box[5] = {g.chunk, g.stride * wpitch(g), g.stride * box_rows(g),
                      1, 1};
  const int steps[5] = {1, g.stride, g.stride, 1, 1};
  return db::encode_swizzled(tmx, x, 5, dims, strides, box, cell_bytes(g),
                             steps);
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device);
// `slot` names the kernel among a library's five f32 instances.
inline cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
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

// Whether the f32 tile takes the tiles of `g` at wgmma width `lanes`:
// `streamed` asks for bands of two or three strips of at most 64 positions,
// else one m-tile of 64 * wgs rows holding the tile.
__host__ inline bool valid(const Geometry& g, int lanes, bool streamed) {
  if (!valid_map(g) || stage_taps(g) > 256 || lane_slot(lanes) < 0
      || g.wgs < 1
      || kWarpgroup * (g.wgs + 1) > max_threads(lanes)
      || g.chunk < 8 || (g.chunk & (g.chunk - 1)) != 0
      || kpad(g) % g.chunk != 0
      || g.th < 1 || g.tw < 1 || g.stride < 1 || g.hf < 1 || g.wf < 1
      || g.nsplit < 1 || (g.nsplit - 1) * lanes >= g.cob
      || g.nsplit * lanes < g.cob || g.act < 0 || g.act > kActGelu)
    return false;
  if (streamed) {
    return g.strips == g.wgs && g.wgs >= 2 && g.th % g.strips == 0
           && hso(g) * g.tw <= kRows && g.frows == g.hf;
  }
  return g.strips == 1 && g.th * g.tw <= kRows * g.wgs;
}

// The operand type a plan names (its last int): the f32 tile, or its bf16
// build.
constexpr int kOperandF32 = 0;
constexpr int kOperandBf16 = 1;
// the bf16 narrow rows' kernels, a third table (the window library's)
constexpr int kOperandNarrow = 2;

// A plan's int array read: the Geometry fields in order, then the wgmma
// width, the images, the dynamic shared memory and the operand type.
struct Plan {
  Geometry g;
  int lanes, n, smem, operand;
};

// Read `ints` into `p` -> whether the kernels of that operand type (the
// streamed ones where `streamed`) take its tiles.
inline bool read_plan(const int* ints, bool streamed, Plan* p) {
  int* fields = reinterpret_cast<int*>(&p->g);
  for (int i = 0; i < kGeometryInts; ++i) fields[i] = ints[i];
  const int* more = ints + kGeometryInts;
  p->lanes = more[0];
  p->n = more[1];
  p->smem = more[2];
  p->operand = more[3];
  if (p->operand == kOperandBf16) {
    return bf16::streamed(p->g) == streamed && bf16::valid(p->g, p->lanes);
  }
  return p->operand == kOperandF32 && valid(p->g, p->lanes, streamed);
}

__host__ inline size_t smem_of(const Plan& p) {
  return p.operand == kOperandBf16 ? bf16::smem_bytes(p.g, p.lanes)
                                   : smem_bytes(p.g, p.lanes);
}

// The f32 weights' tensor map: [blocks][taps][Cib][Cob] with a box of one
// block's [taps][chunk][lanes].  -> false where the encoder refuses it.
inline bool encode_weights(CUtensorMap* tmw, const void* w, const Plan& p) {
  const Geometry& g = p.g;
  const long long cob = g.cob, blocks = (long long)g.coblk * cigblk(g);
  const long long dims[4] = {cob, g.cib, taps(g), blocks};
  const long long strides[3] = {cob * 4, g.cib * cob * 4,
                                taps(g) * g.cib * cob * 4};
  const int box[4] = {p.lanes, g.chunk, stage_taps(g), 1};
  return dt::encode(tmw, w, 4, dims, strides, box);
}

// The bf16 build's launch: the tensor maps of w and x where their pencils
// take TMA, then one persistent grid of as many CTAs as the card holds at
// once (or as there are items).
inline int launch_bf16(const void* kernel, const Plan& p, const void* x,
                       const void* w, const void* bias, const void* residual,
                       void* out, void* partials, void* pooled,
                       void* counters, cudaStream_t stream) {
  const Geometry& g = p.g;
  const long long items =
      (long long)tiles(g) * g.coblk * g.nsplit * p.n;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmw, tmx;
  memset(&tmw, 0, sizeof(tmw));
  memset(&tmx, 0, sizeof(tmx));
  if (bf16::narrow(g)) {
    // the narrow rows copy x by 16-byte chunks from its aligned start
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (!bf16::encode_weights_narrow(&tmw, w, g, p.lanes))
      return (int)cudaErrorNotSupported;
  } else if ((bf16::tma_weights(g, p.lanes)
              && !bf16::encode_weights(&tmw, w, g, p.lanes))
             || (bf16::tma_window(g)
                 && !bf16::encode_window(&tmx, x, g, p.n))) {
    return (int)cudaErrorNotSupported;     // the encoder refused a map
  }
  const int threads = kWarpgroup * (g.wgs + 1);
  int ctas = 0;
  err = dt::bf16::resident_ctas(kernel, device, threads, (size_t)p.smem,
                                &ctas);
  if (err != cudaSuccess) return (int)err;
  int n = p.n;
  Geometry geo = g;
  void* args[] = {&tmw, &tmx, &x, &w, &bias, &residual, &out, &partials,
                  &pooled, &counters, &geo, &n};
  err = cudaLaunchKernel(kernel,
                         dim3((unsigned)std::min<long long>(items, ctas)),
                         dim3(threads), args, p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch `kernels[operand][lane_slot(lanes)]` on the plan's int array (Plan
// above; the shared memory must be smem_bytes's of that build): x, w,
// residual, out and pooled at the operand type, the bias and the partials
// f32.  The f32 tile's grid: (tiles, Co blocks x nsplit, images); the bf16
// build's: persistent (launch_bf16).
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
  // the bf16 narrow rows' kernels: the window library's third table
  const void* kernel =
      kernels[p.operand == kOperandBf16 && bf16::narrow(p.g) ? kOperandNarrow
                                                             : p.operand]
             [slot];
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (p.operand == kOperandBf16) {
    return launch_bf16(kernel, p, x, w, bias, residual, out, partials,
                       pooled, counters, stream);
  }
  cudaError_t err = allow_smem(kernel, slot, p.smem);
  if (err != cudaSuccess) return (int)err;
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread
  CUtensorMap tmw;
  memset(&tmw, 0, sizeof(tmw));
  if (tma_weights(p.g)) {
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

// What a launch of the same plan runs (`plan` and bf16::plan): out[0..3],
// and out[4], out[5] the window and weight slots (the f32 tile's one ring
// holds both in each of its kSlots); or cudaErrorInvalidValue where the
// kernels refuse the tiles.
inline int plan_of(bool streamed, const int* ints, long long* out) {
  Plan p;
  if (!read_plan(ints, streamed, &p)) return (int)cudaErrorInvalidValue;
  if (p.operand == kOperandBf16) {
    bf16::plan(p.g, p.n, p.lanes, out);
    return 0;
  }
  plan(p.g, p.n, p.lanes, out);
  out[3] = (long long)smem_of(p);
  out[4] = kSlots;
  out[5] = kSlots;
  return 0;
}

}  // namespace
}  // namespace fwd_tile
