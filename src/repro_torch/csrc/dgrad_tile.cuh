// Phase-split dgrad tile on Hopper tensor cores (sm_90a): the device core
// that the window dgrad (direct_conv2d_bwd.cu, `dgrad_kernel`) and the
// streamed dgrad (conv2d_stream.cu, `stream_dgrad_kernel`) share.
//
// The function, on the paper's blocked layouts:
//
//   g, z  [N, Co/Cob, Ho, Wo, Cob]   raw cotangent, saved pre-activation
//   w     [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]
//   dx    [N, Ci/Cib, Hi, Wi, Cib]   at the forward's unpadded input shape
//
//   dx[n,i,j,c] = sum_{co,dh,dw} dz[n, (i+pt-dh)/s, (j+pl-dw)/s, co]
//                                * w[dh,dw,c,co],   dz = g * act'(z)
//
// where a term counts only if both divisions are exact and the cotangent
// cell lies in the map.
//
// Stride phases.  The dx rows with (i + pt) % s == ph take exactly the taps
// dh = ph + s*t (t = 0, 1, ...; dh < Hf), from cotangent row q - t, where
// i + pt = s*q + ph.  So each phase (ph, pw) of dx is a stride-1
// correlation of dz with the taps it can reach: at 3x3 stride 2 the four
// phases take 4, 2, 2 and 1 taps, 9 in all, and no tap reads a stride hole.
// At stride 1 there is one phase with every tap.  `phase_axis` lists one
// axis of a phase; core/blocking.py `dgrad_phase_axes` is its Python twin.
//
// Dilated taps.  At dilation d tap dh sits dh*d rows from its origin, so it
// reaches the phase ph = (dh*d) % s.  With g = gcd(d, s) a phase whose ph
// g does not divide takes no tap: its tiles stage nothing and write zeros,
// so dx is still written whole (d 2 at stride 2: the odd phases).  Else its
// taps are dh = tap0 + (s/g) t from the least solution tap0, and tap t
// reads cotangent row q0 + a - (d/g) t, with q0 = (first + pad - tap0 d) /
// s (exact, and negative where the first taps read above the map: the
// copies land zeros there).  At d = 1 this is dh = ph + s t from row q0 +
// a - t.  A tile's window is th + (T - 1)(d/g) rows (T the most taps a
// phase takes, ceil(Hf / (s/g))), and the same in columns; each tap's A
// shift steps (d/g) rows or cells (`step_shifts`, bf16 `tap_shift`).
// Dilation 12 at stride 1 widens a 3x3 window by 24 rows and columns; where
// a tile's th rows are fewer than the d/g rows between two taps' reads, the
// f32 tile stages only the T bands of th rows the taps read, band u the
// window rows u (d/g) + [0, th), one TMA box a row (`gather_h`): at th 1
// three of fc6's 25 rows.
//
// Grouped maps (Cig > 1; w [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob]).  Ci block
// ci_b of group ci_b / cigblk contracts only its group's cogblk cotangent
// blocks, (ci_b / cigblk) cogblk + co for co < cogblk, against weight block
// ((ci_b / cigblk) cogblk + co, ci_b % cigblk) (`w_block`): the stages of a
// CTA walk cogblk Co blocks, not Co/Cob, and no cross-group block is staged.
//
// The implicit GEMM.  A CTA owns a tile of th x tw positions of one phase
// of one image (rows M, row-major), all Cib lanes (columns N, padded up to
// the compiled wgmma width), and contracts K = (reachable tap, Cob
// channel), `chunk` channels of one Co block a stage:
//
//   A[m, (tap, k)] = dz[cell(m) - shift(tap), k]   (the staged window)
//   B[(tap, k), n] = w[co_b, ci_b, dh, dw, n, c0 + k]
//
// B needs no transpose: w's [Cib, Cob] block with Cob contiguous is the
// K-major operand that TF32 wgmma requires.  A is read from shared memory
// into registers at each row's own shifted offset, so a 64-row tile takes
// any tap without a swizzle that would have to follow the shift.
//
// f32 accuracy from TF32 (3xTF32).  Each operand is split as a = big +
// small, both TF32 (cvt.rna; small is the rounded remainder), and the
// three products big*small + small*big + big*big go into one f32
// accumulator: wgmma m64nNk8.f32.tf32.tf32, A (big, small) in registers, B
// (big, small) in shared memory.  The dropped small*small term is below
// 2^-22 of a product.  B is split once per stage, A per load.
//
// Warp roles and stages.  A CTA is `wgs` consumer warpgroups (the first
// threads) and one producer warpgroup.  The producer's first warp issues a
// stage's copies as TMA tensor copies (one per tap of weights, and boxes
// of `box_rows` window rows of g and of z: the window kernel's whole
// window in one; cells outside the map, channels past Cob and lanes past
// Cib land as zeros) into a two-slot ring, tracked by an mbarrier per slot
// and copy group.  TMA needs global strides of whole 16 bytes, so where Cob
// is not a multiple of 4 the producer's 128 threads copy the same cells by
// 4-byte cp.async instead (zero-filled where TMA would land zeros, the
// weights written straight into the order the TMA box gives), one commit
// group per copy group, and meet at a barrier of their own once a group's
// copies have landed.  The producer's threads then round the weights to big
// (in place) and small, form dz = g * act'(z) in place on the window, once
// per staged element and not once per tap, and release the slot to the
// consumers through a named barrier.  The consumers run the stage's wgmmas
// meanwhile on the other slot, and free it through another named barrier.
// No dz, dilated or padded tensor exists in device memory.  Rows of dx past
// the dgrad extents read only zero cells and come out exactly 0.  No
// atomics: the sums run in a fixed order, and two runs give identical bits.
//
// Shared memory, in floats, from a 128-byte aligned base: big weights
// [2][T * chunk * N], their small halves [2][T * chunk * N], the window
// [2][hwin * row] and with the prologue z beside it [2][hwin * row], the A
// shift of each k8 step, and the mbarriers; T = ceil(Hf/s) * ceil(Wf/s)
// taps, the most a phase takes.  Weights per stage and tap: [chunk / 4][N]
// [4], so each 8 x 4 block is a wgmma core matrix (8 lanes x 16 bytes) and
// the descriptor steps N * 16 bytes between a k8 slice's two K halves and
// 128 bytes between 8-lane groups; it is the box order of a 4-D TMA copy.
// A window cell is `ld = chunk + 4` floats (the TMA box takes 4 channels
// past the chunk, never read), so eight consecutive cells of a warp's A
// load fall on eight distinct bank quads.  A box lands on 128 bytes: rows
// copied one by one are padded to 128 bytes; a box of several rows lands
// them unpadded, so several such boxes need rows of whole 128-byte lines.
//
// A consumer thread holds rows q0 + 16*warp + lane/4 (+8) of its m-tile:
// the window kernel's warpgroup c has rows q0 = 64c of the tile's one
// m-tile, the streamed kernel's has the 64 rows of strip c.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <algorithm>
#include <mutex>
#include <stdint.h>

namespace dgrad_tile {

constexpr int kWarpgroup = 128;     // threads of one warpgroup
constexpr int kMaxConsumers = 3;    // consumer warpgroups of a CTA
constexpr int kMaxThreads = kWarpgroup * (kMaxConsumers + 1);
constexpr int kRows = 64;           // rows of one wgmma tile (m64)
constexpr int kSlots = 2;           // ring slots
constexpr int kMaxGroups = kMaxConsumers;   // copy groups of a stage
// named barriers (0 is __syncthreads): group g of slot s filled, slot s
// consumed, and the producer warpgroup's own
constexpr int kBarFull = 1;         // + s * kMaxGroups + g
constexpr int kBarEmpty = kBarFull + kSlots * kMaxGroups;   // + s
constexpr int kBarProducer = kBarEmpty + kSlots;
static_assert(kBarProducer < 16, "16 named barriers");
constexpr int kActRelu = 1;
constexpr int kActGelu = 2;
// The longest contraction one accumulator runs (VGG-16's, 9 x 512; a
// grouped conv's is its group's, cogblk x Cob x a phase's taps): wgmma
// rounds each add toward zero, and past it the drift passes the plain
// version's tolerance (9 x 1000 drifted to 3.4e-4 of outputs of ~1 on an
// H100).  A longer one is launched a Co block at a time, each launch after
// the first adding its sums into dx in f32 (`launch`, store_dx's `add`).
constexpr int kMaxTruncatingK = 9 * 512;

// The launch's geometry, passed by value.
struct Geometry {
  int coblk, cob, ho, wo;           // g, z: [N, coblk, ho, wo, cob]
  int ciblk, cib, hi, wi;           // dx: [N, ciblk, hi, wi, cib]
  int hf, wf, stride, pad_top, pad_left;
  int th, tw;                       // phase rows x columns of a tile
  int mstride;                      // tile positions from one m-tile to the next
  int chunk;                        // Cob channels a stage contracts (k8 multiple)
  int act;                          // 0 linear, 1 relu, 2 gelu
  int prologue;                     // 1: z is staged and dz formed
  int box_rows;                     // window rows one TMA copy brings
  int co_first, co_count;           // the Co blocks of a group this launch
                                    // contracts (from the group's first)
  int groups;                       // channel groups (1: dense)
  int dil_h, dil_w;                 // filter dilation
  // set on the host from the stride and the dilation (`with_steps`): the
  // taps that reach one phase are tstep apart, and each reads qstep
  // cotangent rows (columns) before the one before it.  Kept as fields so
  // that no device code takes a gcd: the bf16 build's wgmma descriptors
  // derive from them, and a loop there made the compiler wait after every
  // wgmma.
  int tstep_h, tstep_w, qstep_h, qstep_w;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// TMA copies take global strides of whole 16 bytes: Cob a multiple of 4;
// else the producer copies by cp.async.
__host__ __device__ inline bool tma_copies(const Geometry& g) {
  return g.cob % 4 == 0;
}

__host__ inline int gcd(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// The taps that reach one phase at stride s and dilation d are tap_step
// apart, and each reads q_step cotangent rows before the one before it.
__host__ inline int tap_step(int s, int d) { return s / gcd(d, s); }
__host__ inline int q_step(int s, int d) { return d / gcd(d, s); }

// The geometry with its steps set from its stride and dilation.
__host__ inline Geometry with_steps(Geometry g) {
  g.tstep_h = tap_step(g.stride, g.dil_h);
  g.tstep_w = tap_step(g.stride, g.dil_w);
  g.qstep_h = q_step(g.stride, g.dil_h);
  g.qstep_w = q_step(g.stride, g.dil_w);
  return g;
}

// The most taps one phase reaches along each axis (phase 0 always reaches
// tap 0), and the cotangent rows (columns) from a phase row's last tap's
// read to its first's.
__host__ __device__ inline int taps_h(const Geometry& g) {
  return ceil_div(g.hf, g.tstep_h);
}
__host__ __device__ inline int taps_w(const Geometry& g) {
  return ceil_div(g.wf, g.tstep_w);
}
__host__ __device__ inline int reach_h(const Geometry& g) {
  return (taps_h(g) - 1) * g.qstep_h;
}
__host__ __device__ inline int reach_w(const Geometry& g) {
  return (taps_w(g) - 1) * g.qstep_w;
}

// The grouped map: Ci block ci_b contracts its group's cogblk Co blocks,
// Co block (ci_b / cigblk) cogblk + co against the weight block (that Co
// block, ci_b % cigblk) of [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob].
__host__ __device__ inline int cigblk(const Geometry& g) {
  return g.ciblk / g.groups;
}
__host__ __device__ inline int cogblk(const Geometry& g) {
  return g.coblk / g.groups;
}
__host__ __device__ inline int co_base(const Geometry& g, int ci_b) {
  return ci_b / cigblk(g) * cogblk(g);
}
__host__ __device__ inline int w_block(const Geometry& g, int co_b,
                                       int ci_b) {
  return co_b * cigblk(g) + ci_b % cigblk(g);
}

// Whether the grouped and dilated fields make sense.
__host__ inline bool valid_map(const Geometry& g) {
  return g.groups >= 1 && g.ciblk % g.groups == 0 && g.coblk % g.groups == 0
         && g.dil_h >= 1 && g.dil_w >= 1 && g.stride >= 1
         && g.tstep_h == tap_step(g.stride, g.dil_h)
         && g.tstep_w == tap_step(g.stride, g.dil_w)
         && g.qstep_h == q_step(g.stride, g.dil_h)
         && g.qstep_w == q_step(g.stride, g.dil_w);
}

__host__ __device__ inline int hwin(const Geometry& g) {
  return g.th + reach_h(g);
}

__host__ __device__ inline int wwin(const Geometry& g) {
  return g.tw + reach_w(g);
}

// The f32 tile's staged rows (the bf16 build stages the hwin rows whole):
// where the th rows of a tile are fewer than the q_step rows between two
// taps' reads, only the taps_h bands of th rows the taps read (`gather_h`),
// band u at window row u q_step; `row_step` staged rows lie between two
// taps' reads, and staged row r is window row `win_row`.
__host__ __device__ inline bool gather_h(const Geometry& g) {
  return taps_h(g) > 1 && g.th < g.qstep_h;
}
__host__ __device__ inline int row_step(const Geometry& g) {
  return gather_h(g) ? g.th : g.qstep_h;
}
__host__ __device__ inline int win_rows(const Geometry& g) {
  return gather_h(g) ? taps_h(g) * g.th : hwin(g);
}
__host__ __device__ inline int win_row(const Geometry& g, int r) {
  return gather_h(g) ? r / g.th * g.qstep_h + r % g.th : r;
}

// The f32 window kernel's geometry: the whole window one TMA box, or, where
// its rows are gathered, a box a row.
__host__ __device__ inline Geometry f32_window(Geometry g) {
  g.box_rows = gather_h(g) ? 1 : hwin(g);
  return g;
}

__host__ __device__ inline int cell_floats(const Geometry& g) {
  return g.chunk + 4;
}

// floats from one window row to the next: a row's cells, padded to 128 bytes
// where each row lands by a TMA copy of its own (box_rows 1); a box of
// several rows lands them unpadded
__host__ __device__ inline int row_floats(const Geometry& g) {
  const int row = wwin(g) * cell_floats(g);
  return g.box_rows == 1 ? ceil_div(row, 32) * 32 : row;
}

// Cob rounded up to the k8 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cob, 8) * 8;
}

__host__ __device__ inline int weight_floats(const Geometry& g, int lanes) {
  return taps_h(g) * taps_w(g) * g.chunk * lanes;
}

// a window slot, rounded up to 128 bytes (a TMA destination's alignment)
__host__ __device__ inline int window_floats(const Geometry& g) {
  return ceil_div(win_rows(g) * row_floats(g), 32) * 32;
}

// k8 steps of a stage, at most: taps x chunk / 8
__host__ __device__ inline int max_steps(const Geometry& g) {
  return taps_h(g) * taps_w(g) * g.chunk / 8;
}

// Dynamic shared memory of one CTA (core/blocking.py dgrad_smem_bytes):
// 128 bytes to align the base, per ring slot the big and small weights, the
// window and with the prologue z, the A shift of each k8 step, and an
// 8-byte mbarrier per slot and copy group.
__host__ inline size_t smem_bytes(const Geometry& g, int lanes) {
  return 128
         + 4 * ((size_t)kSlots * (2 * weight_floats(g, lanes)
                                  + (g.prologue ? 2 : 1) * window_floats(g))
                + ceil_div(max_steps(g), 2) * 2)
         + 8 * kSlots * kMaxGroups;
}

// One axis of the stride phase `ph` of an input of `extent` rows at filter
// dilation d: its first row, its row count, the cotangent row q0 of its
// first row's tap t = 0, the taps it reaches (dh = tap0 + tap_step t, tap t
// at row q0 + a - q_step t) and the first of them.
struct Axis {
  int first, extent, q0, taps, tap0;
};

__host__ __device__ inline Axis phase_axis(int ph, int extent, int f, int s,
                                           int pad, int d, int step) {
  Axis a;
  a.first = ((ph - pad) % s + s) % s;
  a.extent = a.first < extent ? ceil_div(extent - a.first, s) : 0;
  int t0 = -1;                      // the least dh with dh d = ph (mod s)
  for (int k = 0; k < step && t0 < 0; ++k) {
    if (k * d % s == ph) t0 = k;
  }
  a.taps = t0 >= 0 && t0 < f ? (f - 1 - t0) / step + 1 : 0;
  a.tap0 = t0 >= 0 ? t0 : 0;
  a.q0 = (a.first + pad - a.tap0 * d) / s;    // exact, maybe negative
  return a;
}

// The tile a CTA owns: its phase and its first phase row and column.
struct Tile {
  int ph, pw;
  Axis r, c;
  int a0, b0;
};

__host__ __device__ inline int phase_tiles(const Geometry& g, int p, Axis* r,
                                           Axis* c) {
  *r = phase_axis(p / g.stride, g.hi, g.hf, g.stride, g.pad_top, g.dil_h,
                  g.tstep_h);
  *c = phase_axis(p % g.stride, g.wi, g.wf, g.stride, g.pad_left, g.dil_w,
                  g.tstep_w);
  return ceil_div(r->extent, g.th) * ceil_div(c->extent, g.tw);
}

// Tiles of all phases, phase by phase: the grid's x extent.
__host__ inline int grid_tiles(const Geometry& g) {
  int total = 0;
  for (int p = 0; p < g.stride * g.stride; ++p) {
    Axis r, c;
    total += phase_tiles(g, p, &r, &c);
  }
  return total;
}

// What a launch of `wgs` consumer warpgroups at wgmma width `lanes` runs
// over n images (core/blocking.py `dgrad_plan` is its Python twin): out[0]
// the grid's tiles, out[1] the function's MACs as the phases split them
// (positions x reachable taps x Cib x the group's Co: a grouped conv's are
// 1/groups of the dense count), out[2] the tensor-core MACs the tiles
// issue: each consumer's whole m64 tile over its phase's taps, Cob padded
// to k8 slices in each of the group's Co blocks, `lanes` wide, three
// products each;
// out[3] a CTA's shared memory, out[4] and out[5] its ring's slots (a slot
// holds a stage's window and weights).
__host__ inline void plan(const Geometry& g, int n, int wgs, int lanes,
                          long long* out) {
  long long tiles = 0, cells = 0, tile_taps = 0;
  for (int p = 0; p < g.stride * g.stride; ++p) {
    Axis r, c;
    const long long k = phase_tiles(g, p, &r, &c);
    const long long taps = (long long)r.taps * c.taps;
    tiles += k;
    cells += (long long)r.extent * c.extent * taps;
    tile_taps += k * taps;
  }
  const long long images = (long long)n * g.ciblk;
  out[0] = tiles;
  out[1] = images * cells * g.cib * cogblk(g) * g.cob;
  out[2] = images * tile_taps * kRows * wgs * lanes * cogblk(g) * kpad(g) * 3;
  out[3] = (long long)smem_bytes(g, lanes);
  out[4] = kSlots;
  out[5] = kSlots;
}

__device__ inline Tile tile_of(const Geometry& g, int idx) {
  Tile t;
  for (int p = 0;; ++p) {
    const int n = phase_tiles(g, p, &t.r, &t.c);
    if (idx < n) {
      const int across = ceil_div(t.c.extent, g.tw);
      t.ph = p / g.stride;
      t.pw = p % g.stride;
      t.a0 = (idx / across) * g.th;
      t.b0 = (idx % across) * g.tw;
      return t;
    }
    idx -= n;
  }
}

// ---------------------------------------------------------------------------
// element-wise pieces
// ---------------------------------------------------------------------------

// dz = g * act'(z), as the reference's cotangent prologue: relu' = 1/2 at
// z == 0 (jnp.maximum's VJP), gelu the tanh form
__device__ __forceinline__ float prologue(float g, float z, int act) {
  if (act == kActRelu) {
    return z > 0.0f ? g : (z == 0.0f ? 0.5f * g : 0.0f);
  }
  if (act == kActGelu) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    const float a = 0.044715f;
    const float z2 = z * z;
    const float t = tanhf(k * (z + a * z2 * z));
    return g * (0.5f * (1.0f + t)
                + 0.5f * z * (1.0f - t * t) * k * (1.0f + 3.0f * a * z2));
  }
  return g;
}

// round to TF32 (nearest, ties away), as bits with the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// make this thread's shared-memory stores visible to wgmma's operand reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA copies and their mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the barrier's phase `parity` to complete.  A wait that lasts
// 2^34 clocks (some 9 s) traps: a lost copy fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// The shared-memory carve-up of one CTA (smem_bytes).
struct Smem {
  float* big;          // [kSlots][wst]
  float* small;        // [kSlots][wst]
  float* win;          // [kSlots][cst]
  float* zwin;         // [kSlots][cst] with the prologue
  int* shifts;         // [max_steps]
  uint64_t* bars;      // [kSlots][kMaxGroups]
  int wst, cst;
};

template <int N>
__device__ inline Smem carve(float* raw, const Geometry& g) {
  Smem m;
  const uint32_t a = smem_u32(raw);
  float* base = raw + ((128 - (a & 127)) & 127) / 4;
  m.wst = weight_floats(g, N);
  m.cst = window_floats(g);
  m.big = base;
  m.small = m.big + kSlots * m.wst;
  m.win = m.small + kSlots * m.wst;
  m.zwin = m.win + kSlots * m.cst;
  m.shifts = reinterpret_cast<int*>(m.zwin + (g.prologue ? kSlots * m.cst
                                                          : 0));
  m.bars = reinterpret_cast<uint64_t*>(m.shifts
                                       + ceil_div(max_steps(g), 2) * 2);
  return m;
}

// Bytes the weights of a stage bring: the tile's phase taps x chunk x N.
template <int N>
__device__ __forceinline__ int weight_bytes(const Geometry& g, const Tile& t) {
  return t.r.taps * t.c.taps * g.chunk * N * 4;
}

// TMA boxes of box_rows rows that bring window rows [lo, hi): from lo in
// steps of box_rows, the last one ending at hi (it may overlap the one
// before, bringing the same rows twice).
__device__ __forceinline__ int row_boxes(const Geometry& g, int lo, int hi) {
  return ceil_div(hi - lo, g.box_rows);
}

// Bytes the boxes of window rows [lo, hi) bring, of g and (with the
// prologue) z.
__device__ __forceinline__ int row_bytes(const Geometry& g, int lo, int hi) {
  return row_boxes(g, lo, hi) * g.box_rows * wwin(g) * cell_floats(g) * 4
         * (g.prologue ? 2 : 1);
}

// Filter tap (dh, dw) of phase tap `tap` of the tile's phase, row-major
// over its r.taps x c.taps.
__device__ __forceinline__ int tap_index(const Geometry& g, const Tile& t,
                                         int tap) {
  const int dh = t.r.tap0 + g.tstep_h * (tap / t.c.taps);
  const int dw = t.c.tap0 + g.tstep_w * (tap % t.c.taps);
  return dh * g.wf + dw;
}

// Issue stage s's weights (one TMA copy per phase tap: Cob channels [c0,
// c0 + chunk) by N lanes of Co block co_b against Ci block ci_b,
// `w_block`) onto `bar`, lane `lane` of `lanes` taking every lanes-th tap.
template <int N>
__device__ void issue_weights(const CUtensorMap* tmw, float* dst,
                              uint64_t* bar, const Geometry& g,
                              const Tile& t, int co_b, int ci_b, int c0,
                              int lane, int lanes) {
  const int blk = w_block(g, co_b, ci_b) * g.hf * g.wf;
  for (int tap = lane; tap < t.r.taps * t.c.taps; tap += lanes) {
    tma_load_4d(dst + tap * g.chunk * N, tmw, bar, 0, 0, c0 / 4,
                blk + tap_index(g, t, tap));
  }
}

// Issue staged rows [lo, hi) of g (and z) for channels [c0, c0 + chunk +
// 4) of block (n, co_b) as row_boxes boxes: staged row r is cotangent row
// o_h + win_row(r) from column o_w (a gathered window's boxes are a row
// each); lane `lane` of `lanes` takes every lanes-th box.
__device__ void issue_rows(const CUtensorMap* tmg, const CUtensorMap* tmz,
                           float* win, float* zwin, uint64_t* bar,
                           const Geometry& g, int n, int co_b, int c0,
                           int o_h, int o_w, int lo, int hi, int lane,
                           int lanes) {
  const int rf = row_floats(g);
  for (int b = lane; b < row_boxes(g, lo, hi); b += lanes) {
    const int r = min(lo + b * g.box_rows, hi - g.box_rows);
    const int oh = o_h + win_row(g, r);
    tma_load_5d(win + r * rf, tmg, bar, c0, o_w, oh, co_b, n);
    if (g.prologue) {
      tma_load_5d(zwin + r * rf, tmz, bar, c0, o_w, oh, co_b, n);
    }
  }
}

// ---------------------------------------------------------------------------
// cp.async copies (Cob % 4 != 0)
// ---------------------------------------------------------------------------

// cp.async: `valid` false copies no byte and zero-fills the destination
// (src-size 0); `src` must still be a global address.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0, 1 or 2) of this thread's groups pend
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// Stage s's weights by cp.async (`tid` of the producer's kWarpgroup): what
// issue_weights's TMA boxes land, [chunk / 4][N][4] a tap, zeros for lanes
// past Cib and channels past Cob.
template <int N>
__device__ void copy_weights(const float* __restrict__ w, float* dst,
                             const Geometry& g, const Tile& t, int co_b,
                             int ci_b, int c0, int tid) {
  const int blk = w_block(g, co_b, ci_b) * g.hf * g.wf;
  const int per_tap = g.chunk * N;
  for (int i = tid; i < t.r.taps * t.c.taps * per_tap; i += kWarpgroup) {
    const int tap = i / per_tap;
    const int e = i - tap * per_tap;          // (k / 4, lane, k % 4)
    const int k = e / (4 * N) * 4 + (e & 3);
    const int lane = e / 4 % N;
    const bool ok = lane < g.cib && c0 + k < g.cob;
    const float* src =
        ok ? w + ((size_t)(blk + tap_index(g, t, tap)) * g.cib + lane)
                         * g.cob + c0 + k
           : w;
    cp_async4(dst + i, src, ok);
  }
}

// Window rows [lo, hi) of g (and z) by cp.async (`tid` of the producer's
// kWarpgroup): what issue_rows's boxes land, channels [c0, c0 + chunk + 4)
// of cotangent row o_h + r from column o_w, zeros outside the map and past
// Cob.
__device__ void copy_rows(const float* __restrict__ gg,
                          const float* __restrict__ zz, float* win,
                          float* zwin, const Geometry& g, int n, int co_b,
                          int c0, int o_h, int o_w, int lo, int hi, int tid) {
  const int rf = row_floats(g);
  const int ld = cell_floats(g);
  const int per_row = wwin(g) * ld;
  const size_t map = (size_t)(n * g.coblk + co_b) * g.ho * g.wo;
  for (int i = tid; i < (hi - lo) * per_row; i += kWarpgroup) {
    const int r = i / per_row;
    const int rem = i - r * per_row;
    const int col = rem / ld;
    const int c = rem - col * ld;
    const int oh = o_h + win_row(g, lo + r);
    const int ow = o_w + col;
    const bool ok = oh >= 0 && oh < g.ho && ow >= 0 && ow < g.wo
                    && c0 + c < g.cob;
    const size_t off = ok ? (map + (size_t)oh * g.wo + ow) * g.cob + c0 + c
                          : 0;
    const int at = (lo + r) * rf + col * ld + c;
    cp_async4(win + at, gg + off, ok);
    if (g.prologue) cp_async4(zwin + at, zz + off, ok);
  }
}

// dz = g * act'(z) in place over window rows [lo, hi), a float4 at a time
// over whole rows (`tid` of `nth`): the 4 channels past the chunk in each
// cell and a row's padding are transformed too, and never read.
__device__ void prologue_rows(float* win, const float* zwin,
                              const Geometry& g, int lo, int hi, int tid,
                              int nth) {
  const int rf = row_floats(g);
  float4* w4 = reinterpret_cast<float4*>(win + lo * rf);
  const float4* z4 = reinterpret_cast<const float4*>(zwin + lo * rf);
#pragma unroll 4
  for (int i = tid; i < (hi - lo) * rf / 4; i += nth) {
    float4 v = w4[i];
    const float4 zz = z4[i];
    v.x = prologue(v.x, zz.x, g.act);
    v.y = prologue(v.y, zz.y, g.act);
    v.z = prologue(v.z, zz.z, g.act);
    v.w = prologue(v.w, zz.w, g.act);
    w4[i] = v;
  }
}

// big = tf32(v) in place, small = tf32(v - big), a float4 at a time
// (`tid` of `nth`; count is a multiple of 4)
__device__ void split_weights(float* big, float* small, int count, int tid,
                              int nth) {
  auto split = [](float v, float& s) {
    const float h = __uint_as_float(tf32_bits(v));
    s = __uint_as_float(tf32_bits(v - h));
    return h;
  };
#pragma unroll 4
  for (int i = tid; i < count / 4; i += nth) {
    float4 v = reinterpret_cast<const float4*>(big)[i];
    float4 lo;
    v.x = split(v.x, lo.x);
    v.y = split(v.y, lo.y);
    v.z = split(v.z, lo.z);
    v.w = split(v.w, lo.w);
    reinterpret_cast<float4*>(big)[i] = v;
    reinterpret_cast<float4*>(small)[i] = lo;
  }
}

// The A shift of each k8 step j of the tile's phase, in floats from tap
// (0, 0): slice j % slices of tap j / slices, phase tap (t_h, t_w)
// row_step rows and q_step cells before tap 0's (every thread of the CTA).
__device__ void step_shifts(int* shifts, const Geometry& g, const Tile& t) {
  const int slices = g.chunk / 8;
  const int rf = row_floats(g) * row_step(g);
  const int ld = cell_floats(g) * g.qstep_w;
  for (int j = threadIdx.x; j < t.r.taps * t.c.taps * slices;
       j += blockDim.x) {
    const int tap = j / slices;
    shifts[j] = (j % slices) * 8
                - ((tap / t.c.taps) * rf + tap % t.c.taps * ld);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// A K-major operand without swizzle: `lbo` bytes between the core matrices
// of a k8 slice's two K halves, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed wgmma groups pend
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// After wgmma_wait: the accumulators are live up to here and read after.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x N] += A[64 x 8] B[8 x N], TF32 in, f32 accumulators.  A from
// registers: thread (warp w, lane l) holds a[0..3] = A[16w + l/4 (+8)][l%4
// (+4)] (row +8 in a[1], a[3]; column +4 in a[2], a[3]).  D: d[4j .. 4j+3]
// = rows 16w + l/4 (+8), columns 8j + 2(l%4) (+1).  B from shared memory
// through a K-major descriptor.
template <int N>
__device__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (N 80: the f32 flash kernel's P @ V at head dim 80, flash_attention.cu)
template <>
__device__ __forceinline__ void wgmma_tf32<80>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// the tile's products (consumer warpgroups)
// ---------------------------------------------------------------------------

// This consumer thread's two rows of m-tile mt0 of the tile: rows q0 +
// 16*warp + lane/4 (+8) of the m-tile, warp and lane within the warpgroup,
// as window offsets in floats of tap (0, 0) plus the column lane % 4; a row
// past the m-tile or the tile reads tile position 0 and is never stored.
__device__ __forceinline__ void row_offsets(int (&off)[2], const Geometry& g,
                                            int mt0, int q0) {
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int rf = row_floats(g);
  const int ld = cell_floats(g);
  const int mh = (taps_h(g) - 1) * row_step(g);
  const int mw = reach_w(g);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    int p = mt0 * g.mstride + q;
    if (q >= g.mstride || p >= g.th * g.tw) p = 0;
    off[h] = (p / g.tw + mh) * rf + (p % g.tw + mw) * ld + lane % 4;
  }
}

// Load A for one k8 step at `shift` floats from each row's offset and
// split it: big = tf32(a), small = tf32(a - big).
__device__ __forceinline__ void load_a(uint32_t (&big)[4],
                                       uint32_t (&small)[4], const float* win,
                                       const int (&off)[2], int shift) {
  const float v[4] = {win[off[0] + shift], win[off[1] + shift],
                      win[off[0] + shift + 4], win[off[1] + shift + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = tf32_bits(v[i]);
    small[i] = tf32_bits(v[i] - __uint_as_float(big[i]));
  }
}

// One k8 step: the three products into the accumulator, one commit group.
template <int N>
__device__ __forceinline__ void issue(float (&acc)[N / 2],
                                      const uint32_t (&big)[4],
                                      const uint32_t (&small)[4],
                                      uint64_t b_big, uint64_t b_small) {
  wgmma_fence();
  wgmma_tf32<N>(acc, small, b_big);
  wgmma_tf32<N>(acc, big, b_small);
  wgmma_tf32<N>(acc, big, b_big);
  wgmma_commit();
}

// Contract one landed stage into a warpgroup's 64-row accumulator: `steps`
// k8 steps (the phase's taps x chunk / 8), A loaded one step ahead into the
// register pair the wgmma two steps back has released.  Returns with every
// wgmma complete.
template <int N>
__device__ void mma_stage(float (&acc)[N / 2], const float* win,
                          const int (&off)[2], const int* shifts, int steps,
                          const float* b_big, const float* b_small) {
  if (steps == 0) return;
  const uint32_t big_base = smem_u32(b_big);
  const uint32_t small_base = smem_u32(b_small);
  auto desc = [&](uint32_t base, int j) {
    return kmajor_desc(base + j * N * 32, N * 16, 128);
  };
  uint32_t big0[4], small0[4], big1[4], small1[4];
  load_a(big0, small0, win, off, shifts[0]);
  for (int j = 0; j < steps; j += 2) {
    issue<N>(acc, big0, small0, desc(big_base, j), desc(small_base, j));
    if (j + 1 < steps) {
      wgmma_wait<1>();              // step j - 1 has released big1/small1
      load_a(big1, small1, win, off, shifts[j + 1]);
      issue<N>(acc, big1, small1, desc(big_base, j + 1),
               desc(small_base, j + 1));
    }
    if (j + 2 < steps) {
      wgmma_wait<1>();              // step j has released big0/small0
      load_a(big0, small0, win, off, shifts[j + 2]);
    }
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
}

// Store a consumer's rows of m-tile mt0 (as row_offsets) into dx, lanes <
// Cib, or with `add` add them to what this thread stored there before; rows
// past the phase's extents (a tile may overhang them) are not.
template <int N>
__device__ void store_dx(float* __restrict__ dx, const float (&acc)[N / 2],
                         const Geometry& g, const Tile& t, int n, int ci_b,
                         int mt0, int q0, bool add = false) {
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.cib % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    const int p = mt0 * g.mstride + q;
    if (q >= g.mstride || p >= g.th * g.tw) continue;
    const int a = t.a0 + p / g.tw;
    const int b = t.b0 + p % g.tw;
    if (a >= t.r.extent || b >= t.c.extent) continue;
    const int i = t.r.first + g.stride * a;
    const int j = t.c.first + g.stride * b;
    float* out = dx + (((size_t)(n * g.ciblk + ci_b) * g.hi + i) * g.wi + j)
                 * g.cib;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      const float v0 = acc[4 * jj + 2 * h];
      const float v1 = acc[4 * jj + 2 * h + 1];
      if (pairs && col + 1 < g.cib) {
        float2* o2 = reinterpret_cast<float2*>(out + col);
        const float2 was = add ? *o2 : make_float2(0.0f, 0.0f);
        *o2 = add ? make_float2(was.x + v0, was.y + v1) : make_float2(v0, v1);
      } else {
        if (col < g.cib) out[col] = add ? out[col] + v0 : v0;
        if (col + 1 < g.cib) out[col + 1] = add ? out[col + 1] + v1 : v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const float*, const float*,
                        const float*, float*, Geometry);

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map over `rank` indices of `type` (f32 unless given), innermost
// first: `dims`, byte `strides` of indices 1.., `box`; no swizzle, zeros
// outside the bounds (negative coordinates included).
inline bool encode(CUtensorMap* map, const void* base, int rank,
                   const long long* dims, const long long* strides,
                   const int* box, CUtensorMapDataType type =
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    gbox[i] = (cuuint32_t)box[i];
    estride[i] = 1;
  }
  for (int i = 1; i < rank; ++i) gstride[i - 1] = (cuuint64_t)strides[i - 1];
  return fn(map, type, (cuuint32_t)rank,
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Check the launch against what the kernels take, encode its tensor maps
// where Cob is a multiple of 4 (w as [rows, Cob/4, Cib, 4] with a box of
// chunk/4 x lanes; g and z as [N, Co/Cob, Ho, Wo, Cob] with a box of one
// window row, chunk + 4 channels; else the kernel copies by cp.async from
// the pointers), size its shared memory and launch grids over every
// phase's tiles: (tiles, Ci/Cib, N) CTAs of `wgs` consumer warpgroups and
// the producer, one grid unless the contraction passes kMaxTruncatingK;
// `*launches` is how many grids were launched.
inline int launch(Kernel kernel, const float* g, const float* z,
                  const float* w, float* dx, int n, const Geometry& geo,
                  int wgs, int lanes, cudaStream_t stream, int* launches) {
  *launches = 0;
  if (kernel == nullptr || !valid_map(geo) || wgs < 1 || wgs > kMaxConsumers
      || lanes < geo.cib || geo.chunk % 8 != 0 || kpad(geo) % geo.chunk != 0
      || (gather_h(geo) && geo.box_rows != 1)
      || geo.mstride < 1 || geo.mstride > kRows * wgs
      || geo.th < 1 || geo.tw < 1 || geo.stride < 1
      || (geo.prologue != 0) != (z != nullptr)
      // a box must land on 128 bytes: several boxes of several rows need
      // rows of a multiple of 128 bytes (cp.async copies have no such rule)
      || (tma_copies(geo) && geo.box_rows > 1 && geo.box_rows < win_rows(geo)
          && wwin(geo) * cell_floats(geo) % 32 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = grid_tiles(geo);
  if (tiles == 0 || n == 0) return 0;
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread (autograd runs the backward on a thread of its own, which may
  // not have made it current yet)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmw = {}, tmg = {}, tmz = {};
  const long long cob = geo.cob;
  const long long wdims[4] = {4, geo.cib, cob / 4,
                              (long long)geo.coblk * cigblk(geo) * geo.hf
                                  * geo.wf};
  const long long wstr[3] = {cob * 4, 16, geo.cib * cob * 4};
  const int wbox[4] = {4, lanes, geo.chunk / 4, 1};
  const long long gdims[5] = {cob, geo.wo, geo.ho, geo.coblk, n};
  const long long gstr[4] = {cob * 4, geo.wo * cob * 4,
                             (long long)geo.ho * geo.wo * cob * 4,
                             (long long)geo.coblk * geo.ho * geo.wo * cob * 4};
  const int gbox[5] = {geo.chunk + 4, wwin(geo), geo.box_rows, 1, 1};
  if (tma_copies(geo)
      && (!encode(&tmw, w, 4, wdims, wstr, wbox)
          || !encode(&tmg, g, 5, gdims, gstr, gbox)
          || !encode(&tmz, z != nullptr ? z : g, 5, gdims, gstr, gbox))) {
    return (int)cudaErrorNotSupported;     // the encoder refused a map
  }
  const size_t smem = smem_bytes(geo, lanes);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, geo.ciblk, n);
  // every Co block of a group in one launch, or where that contraction is
  // longer than kMaxTruncatingK one launch a Co block, each after the first
  // adding into dx: launches of four Co-1000 blocks (9 x 512 rows, as
  // VGG-16's longest) drifted to 1.35e-4 of outputs of ~0.07 on an H100,
  // past the plain version's tolerance, where one block a launch holds it
  const bool whole = (long long)cogblk(geo) * kpad(geo) * taps_h(geo)
                         * taps_w(geo)
                     <= kMaxTruncatingK;
  const int blocks = whole ? cogblk(geo) : 1;
  Geometry part = geo;
  for (part.co_first = 0; part.co_first < cogblk(geo);
       part.co_first += part.co_count) {
    part.co_count = std::min(blocks, cogblk(geo) - part.co_first);
    kernel<<<grid, kWarpgroup * (wgs + 1), smem, stream>>>(tmw, tmg, tmz, g,
                                                           z, w, dx, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// bf16 wgmma with A from registers (the forward tiles' bf16 builds:
// fwd_tile.cuh, conv2d_pointwise.cu)
// ---------------------------------------------------------------------------

// D[64 x N] += A[64 x 16] B[16 x N], bf16 in, f32 accumulators.  A from
// registers: thread (warp w, lane l) holds a[0..3], each two bf16 of one
// row: rows 16w + l/4 (+8 in a[1], a[3]), columns 2(l%4), +1 (+8 in a[2],
// a[3]); the lower half of a register is the lower column.  D as the TF32
// form's.  B from shared memory through a descriptor, MN-major through the
// transpose bit (TB 1: the forward tiles' weights).
template <int N, int TB>
__device__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8, 1>(float* d, const uint32_t* a,
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
__device__ __forceinline__ void wgmma_bf16<16, 1>(float* d, const uint32_t* a,
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
__device__ __forceinline__ void wgmma_bf16<32, 1>(float* d, const uint32_t* a,
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
__device__ __forceinline__ void wgmma_bf16<64, 1>(float* d, const uint32_t* a,
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

template <>
__device__ __forceinline__ void wgmma_bf16<128, 1>(float* d, const uint32_t* a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// dz = g * act'(z) on bf16 g and z, as the reference's cotangent prologue
// under BF16: act' in f32, the product rounded once to bf16
__device__ __forceinline__ __nv_bfloat16 prologue_bf16(__nv_bfloat16 g,
                                                       __nv_bfloat16 z,
                                                       int act) {
  return __float2bfloat16_rn(
      prologue(__bfloat162float(g), __bfloat162float(z), act));
}

// ---------------------------------------------------------------------------
// the bf16 build
// ---------------------------------------------------------------------------
//
// The same phase-split correlation on bf16 operands: the reference's
// `_dgrad_kernel` under BF16 (bf16 g, z and w; the f32 sums rounded once to
// bf16 dx, src/repro/kernels/direct_conv2d.py:498-506), on bf16 wgmma
// (m64nNk16, one product a MAC) whose operands both come from shared memory
// by descriptor.  `run` is both kernels' body: the window kernel's tile is
// one m-tile of 64 * wgs rows (one copy group a stage), the streamed
// kernel's band `wgs` strips of one 64-row m-tile each (a copy group a
// strip).  The grid is persistent: a CTA walks (tile, Ci block, image)
// items, and its rings run on across them, so that an item's
// first copies land while the item before computes (a CTA a tile spent
// most of a short item, 2 stages at Co 64, waiting for its first copies).
//
// A, the cotangent window.  A cell (one window position's `chunk` channels)
// is one row of a swizzled K-major operand: chunk 64 is 128 bytes in the
// 128-byte swizzle, chunk 32 and 16 are 64 and 32 bytes in the 64- and
// 32-byte swizzles.  The window lands by TMA in that swizzle (boxes of
// {chunk, wpitch, rows}), its cells flattened row-major with `wpitch`
// cells a window row (wwin; in the streamed kernel rounded up so that each
// row, where a strip's box lands, starts on 128 bytes).  An m-tile's 64
// rows are consecutive cells: row f is dx position (f / wpitch, f %
// wpitch) of the tile, and tap (t_h, t_w) of the phase reads cell f +
// (mh - t_h) * wpitch + (mw - t_w) (mh, mw: the most taps a phase takes
// along each axis, less one), so every tap is the same descriptor started
// that many rows on.  The base-offset field stays 0 at any start: the card
// swizzles by the address's own bits (wgrad_tile.cuh, bf16).  Rows whose
// column f % wpitch falls past the tile's tw columns are computed and not
// stored; the last tap's reads past the window's cells fall on the slot's
// spare cells (`window_cells`), which only such rows read.
//
// B, the weights: per tap w's [Cib, Cob] block, Cob contiguous, is K-major
// with the lanes as rows: one TMA box {chunk, N} a tap lands [N][chunk] in
// the same swizzle.  A k16 step of a cell advances both descriptors by 32
// bytes within the swizzled row.
//
// A stage (Co block, chunk) lands its window once in a ring of 2-4 window
// slots, and the weights of each filter row of its phase in turn in a ring
// of 2-4 weight slots (`window_slots`, `row_slots`): a row's weights are
// 16 KB at chunk 64 and 128 lanes, so chunk 64 (the 128-byte swizzle)
// fits at 3x3, where a stage of every tap's weights fitted only chunk 32.
// Each filter row is one wgmma fence, its k16 steps (its taps x chunk / 16,
// each the full N-lane m64nNk16 into the one f32 accumulator, straight-line
// code for rows of up to 3 taps) and one commit; the consumer then waits
// for the row before (wait<1>) and frees its weight slot, and with a
// stage's last row its window slot, so a row's wgmmas queue behind the one
// before without a wait between them.
// Every descriptor is built from values the compiler knows are uniform
// (kernel parameters, the item from blockIdx, the warpgroup index read
// with __shfl_sync): a per-thread value there made the compiler wait for
// each HGMMA (wgrad_tile.cuh, bf16).
//
// What bounds it on this card: the bf16 tensor-core rate over the m-tile
// rows it issues; in practice both its wgmmas (one consumer keeps the
// tensor cores about half busy, three about 80 %; splitting a 128-lane
// step into two independent 64-lane chains did not help) and its copies (a
// CTA restages every tap's weights of its Ci block for each tile, from
// L2), each near the kernel's time without the other
// (launch/dgrad_parts_ab.py).
//
// One accumulator over the whole contraction: the tensor cores add each k16
// slice rounding toward zero, so over VGG-16's longest contraction (9 x
// 512: 288 k16 slices) the f32 sum drifts by at most 288 f32 ulps of its
// running magnitude (3.4e-5 relative), about 1 % of the half-ulp at which dx
// rounds to bf16; tests/test_torch_bf16_train.py emulates it.  At 128 lanes
// the accumulator takes 64 registers a thread, so a CTA takes three
// consumers at every width (`max_threads`).
//
// * The chunk is 16, 32 or 64 channels (k16 steps, one swizzle row), Cob
//   pads to 16; the chooser takes 16 only where Cob pads to 16.
// * TMA needs global strides of whole 16 bytes: Cob a multiple of 8.  Else
//   the producer writes the same cells into the same swizzled rows, zeros
//   outside the map and past Cob: 4-byte cp.async of channel pairs (Cob
//   even) or 2-byte loads and stores (Cob odd: 125), the weights by 2-byte
//   loads and stores.
// * The prologue forms dz = g * act'(z) in place over a landed window, 16
//   bytes at a time (g and z share the swizzled layout): act' in f32, the
//   product rounded once to bf16 (`prologue_bf16`).
// * The consumers wait on their copy groups' TMA mbarriers as well before
//   their wgmmas read what TMA wrote.
// * dx leaves as bf16, each f32 sum rounded once.
namespace bf16 {

using bf = __nv_bfloat16;

constexpr int kAtom = 1024;     // bytes of the 128-byte swizzle's period
constexpr int kMaxWindows = 4;  // window ring slots at most
constexpr int kMaxRows = 4;     // weight ring slots (filter rows) at most
// the mbarriers after the slots: full (TMA landed) and ready (the
// producer's pass done) per window slot and copy group, empty (consumed)
// per window slot; full and empty per weight slot
constexpr int kBarBytes =
    8 * (kMaxWindows * (2 * kMaxGroups + 1) + 2 * kMaxRows);
constexpr int kSmemBlock = 232448;   // a CTA's shared memory on an H100

// Cob rounded up to the k16 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cob, 16) * 16;
}

// threads of the largest CTA (the launch bound): three consumers at every
// width, the accumulator 64 registers at 128 lanes
__host__ __device__ constexpr int max_threads(int) { return kMaxThreads; }

__host__ __device__ inline bool tma_copies(const Geometry& g) {
  return g.cob % 8 == 0;
}

// bytes of a cell: one swizzled row of `chunk` channels
__host__ __device__ inline int cell_bytes(const Geometry& g) {
  return g.chunk * 2;
}

// the streamed kernel lands its window in boxes of a strip's rows, the
// window kernel in one box
__host__ __device__ inline bool streamed(const Geometry& g) {
  return g.box_rows < hwin(g);
}

// cells from one window row to the next: wwin, or where boxes of rows land
// at each strip, rounded up to whole 128 bytes (a TMA destination's
// alignment)
__host__ __device__ inline int wpitch(const Geometry& g) {
  const int per = cell_bytes(g) < 128 ? 128 / cell_bytes(g) : 1;
  return streamed(g) ? ceil_div(wwin(g), per) * per : wwin(g);
}

// cells from an m-tile row to its read at tap (t_h, t_w) of the phase: the
// window's reach less q_step rows (cells) a tap
__host__ __device__ inline int tap_shift(const Geometry& g, int t_h,
                                         int t_w) {
  return (reach_h(g) - t_h * g.qstep_h) * wpitch(g)
         + reach_w(g) - t_w * g.qstep_w;
}

// the first window cell (m-tile row) of consumer c: 64 rows a consumer of
// the window kernel's one m-tile, a strip's mstride of the streamed band's
__host__ __device__ inline int first_row(const Geometry& g, int c) {
  return streamed(g) ? c * g.mstride : c * kRows;
}

// cells of a window slot: the window's, or as far as the last of `wgs`
// consumers' 64 rows read at the largest shift
__host__ __device__ inline int window_cells(const Geometry& g, int wgs) {
  const int read = first_row(g, wgs - 1) + kRows + tap_shift(g, 0, 0);
  const int cells = hwin(g) * wpitch(g);
  return read > cells ? read : cells;
}

__host__ __device__ inline int round_atom(int bytes) {
  return ceil_div(bytes, kAtom) * kAtom;
}

// bytes of a weight slot (the taps of one filter row of a phase, at most,
// x N lanes) and of one window, each in whole swizzle periods
__host__ __device__ inline int row_weight_bytes(const Geometry& g,
                                                int lanes) {
  return round_atom(taps_w(g) * lanes * cell_bytes(g));
}
__host__ __device__ inline int window_bytes(const Geometry& g, int wgs) {
  return round_atom(window_cells(g, wgs) * cell_bytes(g));
}
// a window slot: the window, and z's beside it with the prologue
__host__ __device__ inline int window_slot_bytes(const Geometry& g,
                                                 int wgs) {
  return (g.prologue ? 2 : 1) * window_bytes(g, wgs);
}

// The two rings (core/blocking.py dgrad_bf16_rings): as many weight slots
// as fit beside two window slots, up to kMaxRows, then as many window slots
// as fit beside them, up to kMaxWindows.
__host__ __device__ inline int row_slots(const Geometry& g, int lanes,
                                         int wgs) {
  const int room = kSmemBlock - kAtom - kBarBytes
                   - 2 * window_slot_bytes(g, wgs);
  const int fit = room > 0 ? room / row_weight_bytes(g, lanes) : 0;
  return fit < kMaxRows ? fit : kMaxRows;
}
__host__ __device__ inline int window_slots(const Geometry& g, int lanes,
                                            int wgs) {
  const int fit = (kSmemBlock - kAtom - kBarBytes
                   - row_slots(g, lanes, wgs) * row_weight_bytes(g, lanes))
                  / window_slot_bytes(g, wgs);
  return fit < kMaxWindows ? fit : kMaxWindows;
}

// Dynamic shared memory of one CTA of `wgs` consumers (core/blocking.py
// dgrad_bf16_smem_bytes): a swizzle period to align the base, the window
// slots, the weight slots, the mbarriers.
__host__ inline size_t smem_bytes(const Geometry& g, int lanes, int wgs) {
  return (size_t)kAtom
         + (size_t)window_slots(g, lanes, wgs) * window_slot_bytes(g, wgs)
         + (size_t)row_slots(g, lanes, wgs) * row_weight_bytes(g, lanes)
         + kBarBytes;
}

// Whether the kernels take this geometry at `wgs` consumers and wgmma width
// `lanes` (the chooser's rules, core/blocking.py _dgrad_bf16_candidates):
// the window kernel's tile in its one m-tile of 64 * wgs rows, the streamed
// kernel's strips of th / wgs rows each in its 64-row m-tile (mstride
// wpitch cells a strip row apart), a chunk of one swizzle row dividing the
// padded Cob, every Co block of a group in one grid, two slots or more in
// each ring.
__host__ inline bool valid(const Geometry& g, int wgs, int lanes) {
  if (!valid_map(g) || wgs < 1 || wgs > kMaxConsumers || lanes < g.cib
      || g.th < 1 || g.tw < 1 || g.stride < 1 || g.hf < 1 || g.wf < 1
      || (g.chunk != 16 && g.chunk != 32 && g.chunk != 64)
      || bf16::kpad(g) % g.chunk != 0 || g.co_first != 0
      || g.co_count != cogblk(g)
      || g.box_rows < 1 || g.box_rows > hwin(g) || wpitch(g) > 256
      || hwin(g) > 256) {
    return false;
  }
  if (streamed(g)) {
    const int hso = g.th / wgs;
    if (wgs < 2 || hso * wgs != g.th || g.box_rows != hso
        || g.mstride != hso * wpitch(g)
        || (hso - 1) * wpitch(g) + g.tw > kRows) {
      return false;
    }
  } else if (g.box_rows != hwin(g) || g.mstride != kRows * wgs
             || (g.th - 1) * wpitch(g) + g.tw > kRows * wgs) {
    return false;
  }
  return row_slots(g, lanes, wgs) >= 2 && window_slots(g, lanes, wgs) >= 2
         && bf16::smem_bytes(g, lanes, wgs) <= kSmemBlock;
}

// dgrad_tile::plan at one bf16 product a MAC, Cob padded to k16 slices;
// out[3] the CTA's shared memory, out[4] and out[5] its window and weight
// slots.
__host__ inline void plan(const Geometry& g, int n, int wgs, int lanes,
                          long long* out) {
  dgrad_tile::plan(g, n, wgs, lanes, out);
  out[2] = out[2] / (3 * dgrad_tile::kpad(g)) * bf16::kpad(g);
  out[3] = (long long)bf16::smem_bytes(g, lanes, wgs);
  out[4] = window_slots(g, lanes, wgs);
  out[5] = row_slots(g, lanes, wgs);
}

// The carve-up of one CTA (smem_bytes): the window slots (each the window
// and with the prologue z's), the weight slots, then the mbarriers.
struct Smem {
  char* win0;
  char* row0;
  uint64_t* wfull;     // [kMaxWindows][kMaxGroups]
  uint64_t* wready;    // [kMaxWindows][kMaxGroups]
  uint64_t* wempty;    // [kMaxWindows]
  uint64_t* rfull;     // [kMaxRows]
  uint64_t* rempty;    // [kMaxRows]
  int cbytes, wslot, rslot, nw, nr;
};

template <int N>
__device__ inline Smem carve(char* raw, const Geometry& g, int wgs) {
  Smem m;
  m.win0 = raw + ((kAtom - (smem_u32(raw) & (kAtom - 1))) & (kAtom - 1));
  m.cbytes = window_bytes(g, wgs);
  m.wslot = window_slot_bytes(g, wgs);
  m.rslot = row_weight_bytes(g, N);
  m.nw = window_slots(g, N, wgs);
  m.nr = row_slots(g, N, wgs);
  m.row0 = m.win0 + m.nw * m.wslot;
  m.wfull = reinterpret_cast<uint64_t*>(m.row0 + m.nr * m.rslot);
  m.wready = m.wfull + kMaxWindows * kMaxGroups;
  m.wempty = m.wready + kMaxWindows * kMaxGroups;
  m.rfull = m.wempty + kMaxWindows;
  m.rempty = m.rfull + kMaxRows;
  return m;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// The shared address `a` of a byte of a cell row, as the `cb`-byte swizzle
// places it: its 16-byte chunk XORed with address bits 7.. (7-9 at 128
// bytes, 7-8 at 64, 7 at 32), as TMA lands it.
__device__ __forceinline__ uint32_t swizzled(uint32_t a, int cb) {
  return a ^ (((a >> 7) & (cb / 16 - 1)) << 4);
}

// A K-major wgmma operand in the `cb`-byte swizzle less its start address:
// 8-row groups 8 * cb bytes apart, the leading offset unused (1).
__device__ __forceinline__ uint64_t desc_of(int cb) {
  const uint64_t layout = cb == 128 ? 1 : (cb == 64 ? 2 : 3);
  return (1ull << 16) | ((uint64_t)((8 * cb) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t addr) {
  return desc | ((addr & 0x3FFFF) >> 4);
}

// D[64 x N] += A[64 x 16] B[16 x N], bf16 in, f32 accumulators, both
// operands in shared memory: A K-major (transpose bit 0), B K-major (TB 0:
// the dgrad's weights) or MN-major through the transpose bit (TB 1: the
// forward's weights as they lie, fwd_tile.cuh bf16).  D's fragments as
// wgmma_bf16's.  A struct, so that the width can be specialized with the
// transpose bit left open.
template <int N, int TB>
struct Ss;

template <int TB>
struct Ss<8, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, %7;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
};

template <int TB>
struct Ss<16, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
};

template <int TB>
struct Ss<32, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
};

template <int TB>
struct Ss<64, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
        "%35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
};

template <int TB>
struct Ss<128, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
};

template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b) {
  Ss<N, TB>::run(d, a, b);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Bytes the boxes of window rows [lo, hi) bring, of g and (with the
// prologue) z.
__device__ __forceinline__ int row_bytes(const Geometry& g, int lo, int hi) {
  return row_boxes(g, lo, hi) * g.box_rows * wpitch(g) * cell_bytes(g)
         * (g.prologue ? 2 : 1);
}

// The first tap of phase tap row `r` of the tile's phase (its filter row's
// tap t.c.tap0) in the weight block of Co block co_b against Ci block ci_b.
__device__ __forceinline__ int row_tap(const Geometry& g, const Tile& t,
                                       int r, int co_b, int ci_b) {
  return w_block(g, co_b, ci_b) * g.hf * g.wf
         + (t.r.tap0 + g.tstep_h * r) * g.wf + t.c.tap0;
}

// Issue the weights of filter row `r` of a stage's phase (one TMA box a
// tap: Cob channels [c0, c0 + chunk) by N lanes of Co block co_b against
// Ci block ci_b, landing as [N][chunk] in the swizzle) onto `bar`, lane
// `lane` of `lanes` taking every lanes-th tap.
template <int N>
__device__ void issue_row_weights(const CUtensorMap* tmw, char* dst,
                                  uint64_t* bar, const Geometry& g,
                                  const Tile& t, int r, int co_b, int ci_b,
                                  int c0, int lane, int lanes) {
  const int blk = row_tap(g, t, r, co_b, ci_b);
  const int step = g.tstep_w;
  for (int j = lane; j < t.c.taps; j += lanes) {
    tma_load_3d(dst + j * N * cell_bytes(g), tmw, bar, c0, 0,
                blk + step * j);
  }
}

// Issue window rows [lo, hi) of g (and z) for channels [c0, c0 + chunk) as
// row_boxes boxes of {chunk, wpitch, box_rows}: row r is cotangent row o_h
// + r from column o_w.
__device__ void issue_rows(const CUtensorMap* tmg, const CUtensorMap* tmz,
                           char* win, char* zwin, uint64_t* bar,
                           const Geometry& g, int n, int co_b, int c0,
                           int o_h, int o_w, int lo, int hi, int lane,
                           int lanes) {
  const int rb = wpitch(g) * cell_bytes(g);
  for (int b = lane; b < row_boxes(g, lo, hi); b += lanes) {
    const int r = min(lo + b * g.box_rows, hi - g.box_rows);
    tma_load_5d(win + r * rb, tmg, bar, c0, o_w, o_h + r, co_b, n);
    if (g.prologue) {
      tma_load_5d(zwin + r * rb, tmz, bar, c0, o_w, o_h + r, co_b, n);
    }
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void st_u16(uint32_t dst, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst), "h"(v) : "memory");
}

// Filter row r's weights by 2-byte loads and stores (`tid` of the
// producer's kWarpgroup): what issue_row_weights's boxes land, zeros for
// lanes past Cib and channels past Cob.
template <int N>
__device__ void copy_row_weights(const bf* __restrict__ w, char* dst,
                                 const Geometry& g, const Tile& t, int r,
                                 int co_b, int ci_b, int c0, int tid) {
  const int blk = row_tap(g, t, r, co_b, ci_b);
  const int step = g.tstep_w;
  const int cb = cell_bytes(g);
  const int per_tap = g.chunk * N;
  const uint32_t base = smem_u32(dst);
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
  for (int i = tid; i < t.c.taps * per_tap; i += kWarpgroup) {
    const int j = i / per_tap;
    const int e = i - j * per_tap;            // (lane, k)
    const int lane = e / g.chunk;
    const int k = e - lane * g.chunk;
    const bool ok = lane < g.cib && c0 + k < g.cob;
    st_u16(swizzled(base + (j * N + lane) * cb + 2 * k, cb),
           ok ? __ldg(w16 + ((size_t)(blk + step * j) * g.cib + lane) * g.cob
                          + c0 + k)
              : (unsigned short)0);
  }
}

// Window rows [lo, hi) of g (and z) by copies (`tid` of the producer's
// kWarpgroup): what issue_rows's boxes land, channels [c0, c0 + chunk) of
// wpitch cells a row, zeros outside the map and past Cob; 4-byte cp.async
// of channel pairs where Cob is even, else 2-byte loads and stores.
__device__ void copy_rows(const bf* __restrict__ gg, const bf* __restrict__ zz,
                          char* win, char* zwin, const Geometry& g, int n,
                          int co_b, int c0, int o_h, int o_w, int lo, int hi,
                          int tid) {
  const int cb = cell_bytes(g);
  const int wp = wpitch(g);
  const int unit = g.cob % 2 == 0 ? 2 : 1;
  const int per_cell = g.chunk / unit;
  const int per_row = wp * per_cell;
  const size_t map = (size_t)(n * g.coblk + co_b) * g.ho * g.wo;
  const unsigned short* g16 = reinterpret_cast<const unsigned short*>(gg);
  const unsigned short* z16 = reinterpret_cast<const unsigned short*>(zz);
  const uint32_t wbase = smem_u32(win);
  const uint32_t zbase = smem_u32(zwin);
  for (int i = tid; i < (hi - lo) * per_row; i += kWarpgroup) {
    const int r = i / per_row;
    const int rem = i - r * per_row;
    const int col = rem / per_cell;
    const int c = (rem - col * per_cell) * unit;
    const int oh = o_h + lo + r;
    const int ow = o_w + col;
    const bool ok = oh >= 0 && oh < g.ho && ow >= 0 && ow < g.wo
                    && c0 + c < g.cob;
    const size_t off = ok ? (map + (size_t)oh * g.wo + ow) * g.cob + c0 + c
                          : 0;
    const int at = ((lo + r) * wp + col) * cb + 2 * c;
    if (unit == 2) {
      cp_async4(swizzled(wbase + at, cb), g16 + off, ok);
      if (g.prologue) cp_async4(swizzled(zbase + at, cb), z16 + off, ok);
    } else {
      st_u16(swizzled(wbase + at, cb), ok ? __ldg(g16 + off)
                                          : (unsigned short)0);
      if (g.prologue) {
        st_u16(swizzled(zbase + at, cb), ok ? __ldg(z16 + off)
                                            : (unsigned short)0);
      }
    }
  }
}

// dz = g * act'(z) in place over window rows [lo, hi), eight channels at a
// time (`tid` of `nth`): the two windows share their swizzled layout.
__device__ void prologue_rows(char* win, const char* zwin, const Geometry& g,
                              int lo, int hi, int tid, int nth) {
  const int rb = wpitch(g) * cell_bytes(g);
  uint4* w8 = reinterpret_cast<uint4*>(win + lo * rb);
  const uint4* z8 = reinterpret_cast<const uint4*>(zwin + lo * rb);
#pragma unroll 2
  for (int i = tid; i < (hi - lo) * rb / 16; i += nth) {
    uint4 v = w8[i];
    const uint4 zz = z8[i];
    bf* vb = reinterpret_cast<bf*>(&v);
    const bf* zb = reinterpret_cast<const bf*>(&zz);
#pragma unroll
    for (int e = 0; e < 8; ++e) vb[e] = prologue_bf16(vb[e], zb[e], g.act);
    w8[i] = v;
  }
}

// Issue filter row `i` of a landed stage into `acc` as one wgmma group:
// the row's CT taps, each the m-tile's rows at the tap's shift from `a0`
// against its weights from `b0`, its S = chunk / 16 steps 32 bytes apart.
// The steps are straight-line code (CT and S template arguments): a branch
// between two wgmmas made the compiler fence before each one
// (WARPGROUP.ARRIVE) and close a group after it.
template <int N, int S, int CT>
__device__ __forceinline__ void mma_row(float (&acc)[N / 2], uint32_t a0,
                                        uint32_t b0, const Geometry& g,
                                        int i, uint64_t desc) {
  constexpr int cb = 32 * S;
  const uint32_t a = a0 + tap_shift(g, i, 0) * cb;
  const uint32_t step = g.qstep_w * cb;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < CT; ++j) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      wgmma_ss<N>(acc, desc_at(desc, a - j * step + 32 * k),
                  desc_at(desc, b0 + j * N * cb + 32 * k));
    }
  }
  wgmma_commit();
}

// The same for any tap count (a filter past 3x3 at its stride): a loop over
// the row's taps, S straight-line steps a tap.
template <int N, int S>
__device__ __forceinline__ void mma_row_any(float (&acc)[N / 2],
                                            uint32_t a0, uint32_t b0,
                                            const Geometry& g, int i, int ct,
                                            uint64_t desc) {
  constexpr int cb = 32 * S;
  const uint32_t a = a0 + tap_shift(g, i, 0) * cb;
  const uint32_t step = g.qstep_w * cb;
  wgmma_fence();
  for (int j = 0; j < ct; ++j) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      wgmma_ss<N>(acc, desc_at(desc, a - j * step + 32 * k),
                  desc_at(desc, b0 + j * N * cb + 32 * k));
    }
  }
  wgmma_commit();
}

template <int N, int S>
__device__ __forceinline__ void mma_row_of(float (&acc)[N / 2], uint32_t a0,
                                           uint32_t b0, const Geometry& g,
                                           int i, int ct, uint64_t desc) {
  if (ct == 3) {
    mma_row<N, S, 3>(acc, a0, b0, g, i, desc);
  } else if (ct == 2) {
    mma_row<N, S, 2>(acc, a0, b0, g, i, desc);
  } else if (ct == 1) {
    mma_row<N, S, 1>(acc, a0, b0, g, i, desc);
  } else {
    mma_row_any<N, S>(acc, a0, b0, g, i, ct, desc);
  }
}

template <int N>
__device__ __forceinline__ void mma_filter_row(float (&acc)[N / 2],
                                               uint32_t a0, uint32_t b0,
                                               const Geometry& g, int i,
                                               int ct, uint64_t desc) {
  if (g.chunk == 64) {
    mma_row_of<N, 4>(acc, a0, b0, g, i, ct, desc);
  } else if (g.chunk == 32) {
    mma_row_of<N, 2>(acc, a0, b0, g, i, ct, desc);
  } else {
    mma_row_of<N, 1>(acc, a0, b0, g, i, ct, desc);
  }
}

// Store a consumer's rows of m-tile mt0 into dx as bf16, each f32 sum
// rounded once: m-tile row q (< mstride) is window cell f = mt0 * mstride +
// q, dx position (f / wpitch, f % wpitch) of the tile, stored where that
// lies in the tile's th x tw and the phase.
template <int N>
__device__ void store_dx(bf* __restrict__ dx, const float (&acc)[N / 2],
                         const Geometry& g, const Tile& t, int n, int ci_b,
                         int mt0, int q0) {
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int wp = wpitch(g);
  const bool pairs = g.cib % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    if (q >= g.mstride) continue;
    const int f = mt0 * g.mstride + q;
    if (f / wp >= g.th || f % wp >= g.tw) continue;
    const int a = t.a0 + f / wp;
    const int b = t.b0 + f % wp;
    if (a >= t.r.extent || b >= t.c.extent) continue;
    const int i = t.r.first + g.stride * a;
    const int j = t.c.first + g.stride * b;
    bf* out = dx + (((size_t)(n * g.ciblk + ci_b) * g.hi + i) * g.wi + j)
              * g.cib;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      const bf v0 = __float2bfloat16_rn(acc[4 * jj + 2 * h]);
      const bf v1 = __float2bfloat16_rn(acc[4 * jj + 2 * h + 1]);
      if (pairs && col + 1 < g.cib) {
        __nv_bfloat162 pr;
        pr.x = v0;
        pr.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(out + col) = pr;
      } else {
        if (col < g.cib) out[col] = v0;
        if (col + 1 < g.cib) out[col + 1] = v1;
      }
    }
  }
}

// The phases' tiles of one image and Ci block (grid_tiles on the device).
__device__ __forceinline__ int tiles_of(const Geometry& g) {
  int total = 0;
  for (int p = 0; p < g.stride * g.stride; ++p) {
    Axis r, c;
    total += phase_tiles(g, p, &r, &c);
  }
  return total;
}

// A work item of the persistent grid: item i is tile i % tiles of Ci block
// i / tiles % Ci/Cib of image i / (tiles * Ci/Cib), its phase's stages (the
// group's Co blocks by chunks; none where no tap reaches the phase).
struct Item {
  Tile t;
  int ci_b, n, stages;
};

__device__ __forceinline__ Item item_of(const Geometry& g, int tiles,
                                        int per_block, int i) {
  Item it;
  it.t = tile_of(g, i % tiles);
  it.ci_b = i / tiles % g.ciblk;
  it.n = i / tiles / g.ciblk;
  it.stages = it.t.r.taps * it.t.c.taps > 0 ? cogblk(g) * per_block : 0;
  return it;
}

// Both kernels' body: a persistent CTA walks the items blockIdx.x,
// blockIdx.x + gridDim.x, ... of `n` images' (tile, Ci block) pairs; the
// streamed band (`kStream`: a copy group and a 64-row m-tile a strip) or
// the window tile (one group, one m-tile of 64 rows a consumer).  A stage
// (Co block, chunk) lands its window in a ring of nw window slots and the
// weights of each filter row of its phase in a ring of nr weight slots; the
// window stays while the stage's rows pass through the weight ring, and
// both rings run on across items, so that one item's first copies land
// while the item before computes.  A window slot's `full` mbarriers
// complete as its TMA copies land, its `ready` ones once the producer's
// pass (the prologue, or the copies' completion) is done, and its `empty`
// one once every consumer thread's wgmmas of the stage's last row are; a
// weight slot's `full` one as its copies land, its `empty` one once the
// wgmmas of its row are.  With TMA, warp 0 of the producer issues every
// copy in the consumers' order and its other warps run the prologue; with
// copies, the whole producer copies one slot at a time.
template <int N, bool kStream>
__device__ __forceinline__ void run(char* raw, const CUtensorMap* tmw,
                                    const CUtensorMap* tmg,
                                    const CUtensorMap* tmz,
                                    const bf* __restrict__ g,
                                    const bf* __restrict__ z,
                                    const bf* __restrict__ w,
                                    bf* __restrict__ dx,
                                    const Geometry& geo, int n_images) {
  const int nth = blockDim.x;
  const int wgs = nth / kWarpgroup - 1;
  const int groups = kStream ? wgs : 1;
  const Smem m = carve<N>(raw, geo, wgs);
  const int nw = m.nw, nr = m.nr;
  const int per_block = bf16::kpad(geo) / geo.chunk;
  const int tiles = tiles_of(geo);
  const int items = tiles * geo.ciblk * n_images;
  const int mh = reach_h(geo);
  const int mw = reach_w(geo);
  const int hso = geo.th / groups;
  const bool tma = bf16::tma_copies(geo);
  // the producer's pass over a landed window before the consumers read it:
  // the prologue, or the copies' completion
  const bool pass = geo.prologue || !tma;
  // window rows of copy group k: strip 0's all, a later strip's fresh ones
  auto lo_of = [&](int k) { return k == 0 ? 0 : k * hso + mh; };
  auto hi_of = [&](int k) { return (k + 1) * hso + mh; };
  auto win = [&](int slot) { return m.win0 + slot * m.wslot; };
  auto zwin = [&](int slot) { return win(slot) + m.cbytes; };
  auto wrow = [&](int slot) { return m.row0 + slot * m.rslot; };
  if (threadIdx.x == 0) {
    // the prologue's pass with TMA is the producer's warps 1-3
    const int passers = tma ? kWarpgroup - 32 : kWarpgroup;
    for (int i = 0; i < kMaxWindows * kMaxGroups; ++i) {
      mbar_init(&m.wfull[i], 1);
      mbar_init(&m.wready[i], passers);
    }
    for (int i = 0; i < kMaxWindows; ++i) {
      mbar_init(&m.wempty[i], nth - kWarpgroup);
    }
    for (int i = 0; i < kMaxRows; ++i) {
      mbar_init(&m.rfull[i], tma ? 1 : kWarpgroup);
      mbar_init(&m.rempty[i], nth - kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= wgs * kWarpgroup) {      // the producer warpgroup
    const int tid = threadIdx.x - wgs * kWarpgroup;
    if (tma && tid >= 32 && !geo.prologue) return;
    int gw = 0, gr = 0;       // window stages and filter rows so far
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item_of(geo, tiles, per_block, i);
      const Tile& t = it.t;
      const int o_h = t.r.q0 + t.a0 - mh;
      const int o_w = t.c.q0 + t.b0 - mw;
      for (int s = 0; s < it.stages; ++s, ++gw) {
        const int co_b = co_base(geo, it.ci_b) + s / per_block;
        const int c0 = (s % per_block) * geo.chunk;
        const int ws = gw % nw;
        const int wpar = (gw / nw) & 1;
        if (tma && tid >= 32) {         // the prologue over landed rows
          for (int k = 0; k < groups; ++k) {
            mbar_wait(&m.wfull[ws * kMaxGroups + k], wpar);
            prologue_rows(win(ws), zwin(ws), geo, lo_of(k), hi_of(k),
                          tid - 32, kWarpgroup - 32);
            fence_proxy_async();
            mbar_arrive(&m.wready[ws * kMaxGroups + k]);
          }
          continue;
        }
        if (gw >= nw) mbar_wait(&m.wempty[ws], wpar ^ 1);
        if (tma) {                      // warp 0: TMA, a group a strip
          uint64_t* full = &m.wfull[ws * kMaxGroups];
          if (tid == 0) {
            for (int k = 0; k < groups; ++k) {
              mbar_expect_tx(&full[k], bf16::row_bytes(geo, lo_of(k),
                                                       hi_of(k)));
            }
          }
          __syncwarp();
          for (int k = 0; k < groups; ++k) {
            issue_rows(tmg, tmz, win(ws), zwin(ws), &full[k], geo, it.n,
                       co_b, c0, o_h, o_w, lo_of(k), hi_of(k), tid, 32);
          }
        } else {                        // every producer thread copies
          copy_rows(g, z, win(ws), zwin(ws), geo, it.n, co_b, c0, o_h, o_w,
                    0, hi_of(groups - 1), tid);
          cp_async_commit();
          cp_async_wait(0);
          if (geo.prologue) {
            bar_sync(kBarProducer, kWarpgroup);
            prologue_rows(win(ws), zwin(ws), geo, 0, hi_of(groups - 1), tid,
                          kWarpgroup);
          }
          fence_proxy_async();
          for (int k = 0; k < groups; ++k) {
            mbar_arrive(&m.wready[ws * kMaxGroups + k]);
          }
        }
        for (int r = 0; r < t.r.taps; ++r, ++gr) {
          const int rs = gr % nr;
          if (gr >= nr) mbar_wait(&m.rempty[rs], ((gr / nr) & 1) ^ 1);
          if (tma) {
            if (tid == 0) {
              mbar_expect_tx(&m.rfull[rs], t.c.taps * N * cell_bytes(geo));
            }
            __syncwarp();
            issue_row_weights<N>(tmw, wrow(rs), &m.rfull[rs], geo, t, r,
                                 co_b, it.ci_b, c0, tid, 32);
          } else {
            copy_row_weights<N>(w, wrow(rs), geo, t, r, co_b, it.ci_b, c0,
                                tid);
            fence_proxy_async();
            mbar_arrive(&m.rfull[rs]);
          }
        }
      }
    }
    return;
  }

  // a consumer: the window tile's rows 64c.. or the streamed band's strip
  // c, its index read warp-uniform so that the descriptors are uniform
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int group = kStream ? c : 0;
  const int mt0 = kStream ? c : 0;
  const int q0 = kStream ? 0 : c * kRows;
  const uint32_t row0 = first_row(geo, c) * cell_bytes(geo);
  const uint64_t desc = desc_of(cell_bytes(geo));
  int gw = 0, gr = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_of(geo, tiles, per_block, i);
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;
    for (int s = 0; s < it.stages; ++s, ++gw) {
      const int ws = gw % nw;
      const int wpar = (gw / nw) & 1;
      if (tma) {            // the copies the wgmmas read have landed
        for (int k = 0; k <= group; ++k) {
          mbar_wait(&m.wfull[ws * kMaxGroups + k], wpar);
        }
      }
      if (pass) mbar_wait(&m.wready[ws * kMaxGroups + group], wpar);
      for (int r = 0; r < it.t.r.taps; ++r, ++gr) {
        const int rs = gr % nr;
        mbar_wait(&m.rfull[rs], (gr / nr) & 1);
        mma_filter_row<N>(acc, smem_u32(win(ws)) + row0,
                          smem_u32(wrow(rs)), geo, r, it.t.c.taps, desc);
        if (s > 0 || r > 0) {
          wgmma_wait<1>();      // the row before is done: free its slots
          mbar_arrive(&m.rempty[(gr - 1) % nr]);
          if (r == 0) mbar_arrive(&m.wempty[(gw - 1) % nw]);
        }
      }
    }
    wgmma_wait<0>();
    if (it.stages > 0) {
      mbar_arrive(&m.rempty[(gr - 1) % nr]);
      mbar_arrive(&m.wempty[(gw - 1) % nw]);
    }
    fence_regs<N / 2>(acc);
    store_dx<N>(dx, acc, geo, it.t, it.n, it.ci_b, mt0, q0);
  }
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const bf*, const bf*, const bf*,
                        bf*, Geometry, int);

// A bf16 tensor map over `rank` indices, innermost first: `dims`, byte
// `strides` of indices 1.., `box`; the `swizzle`-byte swizzle (32, 64 or
// 128), zeros outside the bounds (negative coordinates included).  With
// `steps`, a box traverses index i at every steps[i]-th element (1-8; index
// 0 at 1), landing box[i] / steps[i] of them.
inline bool encode_swizzled(CUtensorMap* map, const void* base, int rank,
                            const long long* dims, const long long* strides,
                            const int* box, int swizzle,
                            const int* steps = nullptr) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    gbox[i] = (cuuint32_t)box[i];
    estride[i] = steps != nullptr ? (cuuint32_t)steps[i] : 1;
  }
  for (int i = 1; i < rank; ++i) gstride[i - 1] = (cuuint64_t)strides[i - 1];
  const CUtensorMapSwizzle sw =
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The CTAs of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that `device` holds at once, the kernel's shared-memory limit
// raised to `smem` on the way: asked of the runtime once per (kernel,
// device, threads, smem), then read from a table, so that a launch makes no
// query of its own.  The limit is only ever raised, so that every size in
// the table stays launchable.
inline cudaError_t resident_ctas(const void* kernel, int device,
                                 int threads, size_t smem, int* ctas) {
  struct Entry {
    const void* kernel;
    int device, threads;
    size_t smem;
    int ctas;
  };
  constexpr int kEntries = 256;
  static Entry table[kEntries];
  static int used = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  size_t allowed = 48 * 1024;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.kernel != kernel || e.device != device) continue;
    if (e.threads == threads && e.smem == smem) {
      *ctas = e.ctas;
      return cudaSuccess;
    }
    allowed = std::max(allowed, e.smem);
  }
  cudaError_t err = cudaSuccess;
  if (smem > allowed || used == kEntries) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)std::max(allowed, smem));
  }
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return err;
  *ctas = sms * (per_sm > 0 ? per_sm : 1);
  if (used < kEntries) table[used++] = {kernel, device, threads, smem, *ctas};
  return cudaSuccess;
}

// dgrad_tile::launch for the bf16 build: w as [rows, Cib, Cob] with a box
// of {chunk, lanes, 1}, g and z with a box of {chunk, wpitch, box_rows},
// all in the chunk's swizzle, where Cob is a multiple of 8; every Co block
// in one persistent grid of as many CTAs as the card holds at once (or as
// there are items).
inline int launch(Kernel kernel, const bf* g, const bf* z, const bf* w,
                  bf* dx, int n, const Geometry& geo, int wgs, int lanes,
                  cudaStream_t stream, int* launches) {
  *launches = 0;
  if (kernel == nullptr || !bf16::valid(geo, wgs, lanes)
      || (geo.prologue != 0) != (z != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = grid_tiles(geo);
  if (tiles == 0 || n == 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmw = {}, tmg = {}, tmz = {};
  const long long cob = geo.cob;
  const long long wdims[3] = {cob, geo.cib,
                              (long long)geo.coblk * cigblk(geo) * geo.hf
                                  * geo.wf};
  const long long wstr[2] = {cob * 2, geo.cib * cob * 2};
  const int wbox[3] = {geo.chunk, lanes, 1};
  const long long gdims[5] = {cob, geo.wo, geo.ho, geo.coblk, n};
  const long long gstr[4] = {cob * 2, geo.wo * cob * 2,
                             (long long)geo.ho * geo.wo * cob * 2,
                             (long long)geo.coblk * geo.ho * geo.wo * cob * 2};
  const int gbox[5] = {geo.chunk, wpitch(geo), geo.box_rows, 1, 1};
  const int sw = cell_bytes(geo);
  if (bf16::tma_copies(geo)
      && (!encode_swizzled(&tmw, w, 3, wdims, wstr, wbox, sw)
          || !encode_swizzled(&tmg, g, 5, gdims, gstr, gbox, sw)
          || !encode_swizzled(&tmz, z != nullptr ? z : g, 5, gdims, gstr,
                              gbox, sw))) {
    return (int)cudaErrorNotSupported;     // the encoder refused a map
  }
  const size_t smem = bf16::smem_bytes(geo, lanes, wgs);
  // a persistent grid: as many CTAs as the card holds at once, or items
  int ctas = 0;
  err = resident_ctas(reinterpret_cast<const void*>(kernel), device,
                      kWarpgroup * (wgs + 1), smem, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)tiles * geo.ciblk * n;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(items, ctas);
  kernel<<<grid, kWarpgroup * (wgs + 1), smem, stream>>>(
      tmw, tmg, tmz, g, z, w, dx, geo, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launches = 1;
  return 0;
}

}  // namespace bf16


}  // namespace dgrad_tile
