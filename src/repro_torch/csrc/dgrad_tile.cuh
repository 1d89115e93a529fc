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
// The longest contraction one accumulator runs (VGG-16's, 9 x 512): wgmma
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
  int co_first, co_count;           // the Co blocks this launch contracts
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// TMA copies take global strides of whole 16 bytes: Cob a multiple of 4;
// else the producer copies by cp.async.
__host__ __device__ inline bool tma_copies(const Geometry& g) {
  return g.cob % 4 == 0;
}

// The most taps one phase reaches along an axis of a filter f at stride s.
__host__ __device__ inline int max_taps(int f, int s) { return ceil_div(f, s); }

__host__ __device__ inline int hwin(const Geometry& g) {
  return g.th + max_taps(g.hf, g.stride) - 1;
}

__host__ __device__ inline int wwin(const Geometry& g) {
  return g.tw + max_taps(g.wf, g.stride) - 1;
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
  return max_taps(g.hf, g.stride) * max_taps(g.wf, g.stride) * g.chunk * lanes;
}

// a window slot, rounded up to 128 bytes (a TMA destination's alignment)
__host__ __device__ inline int window_floats(const Geometry& g) {
  return ceil_div(hwin(g) * row_floats(g), 32) * 32;
}

// k8 steps of a stage, at most: taps x chunk / 8
__host__ __device__ inline int max_steps(const Geometry& g) {
  return max_taps(g.hf, g.stride) * max_taps(g.wf, g.stride) * g.chunk / 8;
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

// One axis of the stride phase `ph` of an input of `extent` rows: its first
// row, its row count, the cotangent row q0 of its first row's tap t = 0, and
// the taps it reaches (dh = ph + s*t).
struct Axis {
  int first, extent, q0, taps;
};

__host__ __device__ inline Axis phase_axis(int ph, int extent, int f, int s,
                                           int pad) {
  Axis a;
  a.first = ((ph - pad) % s + s) % s;
  a.extent = a.first < extent ? ceil_div(extent - a.first, s) : 0;
  a.q0 = (a.first + pad - ph) / s;
  a.taps = ph < f ? (f - 1 - ph) / s + 1 : 0;
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
  *r = phase_axis(p / g.stride, g.hi, g.hf, g.stride, g.pad_top);
  *c = phase_axis(p % g.stride, g.wi, g.wf, g.stride, g.pad_left);
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
// (positions x reachable taps x Cib x Co), out[2] the tensor-core MACs the
// tiles issue: each consumer's whole m64 tile over its phase's taps, Cob
// padded to k8 slices in every Co block, `lanes` wide, three products each.
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
  out[1] = images * cells * g.cib * g.coblk * g.cob;
  out[2] = images * tile_taps * kRows * wgs * lanes * g.coblk * kpad(g) * 3;
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

// Issue stage s's weights (one TMA copy per phase tap: Cob channels [c0,
// c0 + chunk) by N lanes of block (co_b, ci_b)) onto `bar`, lane `lane` of
// `lanes` taking every lanes-th tap.
template <int N>
__device__ void issue_weights(const CUtensorMap* tmw, float* dst,
                              uint64_t* bar, const Geometry& g,
                              const Tile& t, int co_b, int ci_b, int c0,
                              int lane, int lanes) {
  const int blk = (co_b * g.ciblk + ci_b) * g.hf * g.wf;
  for (int tap = lane; tap < t.r.taps * t.c.taps; tap += lanes) {
    const int dh = t.ph + g.stride * (tap / t.c.taps);
    const int dw = t.pw + g.stride * (tap % t.c.taps);
    tma_load_4d(dst + tap * g.chunk * N, tmw, bar, 0, 0, c0 / 4,
                blk + dh * g.wf + dw);
  }
}

// Issue window rows [lo, hi) of g (and z) for channels [c0, c0 + chunk + 4)
// of block (n, co_b) as row_boxes boxes: row r is cotangent row o_h + r
// from column o_w; lane `lane` of `lanes` takes every lanes-th box.
__device__ void issue_rows(const CUtensorMap* tmg, const CUtensorMap* tmz,
                           float* win, float* zwin, uint64_t* bar,
                           const Geometry& g, int n, int co_b, int c0,
                           int o_h, int o_w, int lo, int hi, int lane,
                           int lanes) {
  const int rf = row_floats(g);
  for (int b = lane; b < row_boxes(g, lo, hi); b += lanes) {
    const int r = min(lo + b * g.box_rows, hi - g.box_rows);
    tma_load_5d(win + r * rf, tmg, bar, c0, o_w, o_h + r, co_b, n);
    if (g.prologue) {
      tma_load_5d(zwin + r * rf, tmz, bar, c0, o_w, o_h + r, co_b, n);
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
  const int blk = (co_b * g.ciblk + ci_b) * g.hf * g.wf;
  const int per_tap = g.chunk * N;
  for (int i = tid; i < t.r.taps * t.c.taps * per_tap; i += kWarpgroup) {
    const int tap = i / per_tap;
    const int e = i - tap * per_tap;          // (k / 4, lane, k % 4)
    const int k = e / (4 * N) * 4 + (e & 3);
    const int lane = e / 4 % N;
    const int dh = t.ph + g.stride * (tap / t.c.taps);
    const int dw = t.pw + g.stride * (tap % t.c.taps);
    const bool ok = lane < g.cib && c0 + k < g.cob;
    const float* src =
        ok ? w + ((size_t)(blk + dh * g.wf + dw) * g.cib + lane) * g.cob + c0
                 + k
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
    const int oh = o_h + lo + r;
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
// (0, 0): slice j % slices of tap j / slices (every thread of the CTA).
__device__ void step_shifts(int* shifts, const Geometry& g, const Tile& t) {
  const int slices = g.chunk / 8;
  const int rf = row_floats(g);
  const int ld = cell_floats(g);
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
  const int mh = max_taps(g.hf, g.stride) - 1;
  const int mw = max_taps(g.wf, g.stride) - 1;
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
  if (kernel == nullptr || wgs < 1 || wgs > kMaxConsumers || lanes < geo.cib
      || geo.chunk % 8 != 0 || kpad(geo) % geo.chunk != 0
      || geo.mstride < 1 || geo.mstride > kRows * wgs
      || geo.th < 1 || geo.tw < 1 || geo.stride < 1
      || (geo.prologue != 0) != (z != nullptr)
      // a box must land on 128 bytes: several boxes of several rows need
      // rows of a multiple of 128 bytes (cp.async copies have no such rule)
      || (tma_copies(geo) && geo.box_rows > 1 && geo.box_rows < hwin(geo)
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
                              (long long)geo.coblk * geo.ciblk * geo.hf
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
  // every Co block in one launch, or where that contraction is longer than
  // kMaxTruncatingK one launch a Co block, each after the first adding
  // into dx: launches of four Co-1000 blocks (9 x 512 rows, as VGG-16's
  // longest) drifted to 1.35e-4 of outputs of ~0.07 on an H100, past the
  // plain version's tolerance, where one block a launch holds it
  const bool whole = (long long)geo.coblk * kpad(geo)
                         * max_taps(geo.hf, geo.stride)
                         * max_taps(geo.wf, geo.stride)
                     <= kMaxTruncatingK;
  const int blocks = whole ? geo.coblk : 1;
  Geometry part = geo;
  for (part.co_first = 0; part.co_first < geo.coblk;
       part.co_first += part.co_count) {
    part.co_count = std::min(blocks, geo.coblk - part.co_first);
    kernel<<<grid, kWarpgroup * (wgs + 1), smem, stream>>>(tmw, tmg, tmz, g,
                                                           z, w, dx, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// bf16 wgmma (shared by the bf16 builds of this tile, wgrad_tile.cuh and
// fwd_tile.cuh)
// ---------------------------------------------------------------------------

// D[64 x N] += A[64 x 16] B[16 x N], bf16 in, f32 accumulators.  A from
// registers: thread (warp w, lane l) holds a[0..3], each two bf16 of one
// row: rows 16w + l/4 (+8 in a[1], a[3]), columns 2(l%4), +1 (+8 in a[2],
// a[3]); the lower half of a register is the lower column.  D as the TF32
// form's.  B from shared memory through a descriptor: K-major (TB 0) or,
// through the transpose bit, MN-major (TB 1).
template <int N, int TB>
__device__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8, 0>(float* d, const uint32_t* a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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
__device__ __forceinline__ void wgmma_bf16<16, 0>(float* d, const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
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
__device__ __forceinline__ void wgmma_bf16<32, 0>(float* d, const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
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
__device__ __forceinline__ void wgmma_bf16<64, 0>(float* d, const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
__device__ __forceinline__ void wgmma_bf16<128, 0>(float* d, const uint32_t* a,
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
// The same phase-split tile on bf16 operands: the reference's `_dgrad_kernel`
// under BF16 (bf16 g, z and w; the f32 sums rounded once to bf16 dx,
// src/repro/kernels/direct_conv2d.py:498-506).  Each stage's k16 steps run on
// bf16 wgmma (m64nNk16, one product a MAC) into a fresh f32 accumulator
// that is then added to the consumer's running f32 sum (the tensor cores
// add each k16 slice rounding toward zero, and a fresh accumulator a stage
// keeps that to the stage's own magnitude), so no contraction is long
// enough to need a launch a Co block: one grid always.  At 128 lanes the
// running sum takes 64 registers a thread and the stage's accumulator 32
// more, in 64-lane parts: two consumers at most (`max_threads`, a
// 384-thread CTA's 168 registers; under 512 threads' 128 that spilled, and
// so did one 128-lane accumulator under 168).
//
// What differs from the f32 tile:
// * No split.  B, the weights, is w's [Cib, Cob] block with Cob contiguous:
//   K-major for bf16 too, in core matrices of 8 lanes x 16 bytes (8 bf16),
//   [chunk / 8][N][8] a tap, the box order of a 4-D TMA copy ([rows][Cob /
//   8][Cib][8] over w) that lands it where the wgmma reads it.  The
//   producer's only pass is the prologue.
// * A is the dz window's bf16 pairs: a register's two values are channels
//   k, k + 1 of one cell, one 4-byte load at each row's own shift.  A cell
//   is chunk + 8 bf16 (the TMA box takes 8 channels past the chunk, never
//   read): at chunk 16, 32 and 64 eight consecutive cells then start 12,
//   20 and 36 words apart, eight distinct bank quads.  A row copied as a
//   box of its own is padded to 128 bytes (64 bf16); a box of several rows
//   lands them unpadded, so several such boxes need rows of whole 128-byte
//   lines: wwin * (chunk + 8) a multiple of 64, i.e. wwin a multiple of 8.
// * The chunk is a multiple of 16 (k16 steps), Cob pads to 16.
// * TMA needs global strides of whole 16 bytes: Cob a multiple of 8.  Else
//   the producer copies the same cells by 4-byte cp.async (Cob even) or by
//   2-byte loads and stores (Cob odd: 125), and the weights by 2-byte loads
//   and stores straight into the box's order.
// * The prologue forms dz = g * act'(z) in place, eight channels at a time:
//   act' in f32, the product rounded once to bf16 (`prologue_bf16`).
// * The consumers wait on the slot's weight mbarrier as well before their
//   wgmmas read what the copy wrote.
// * dx leaves as bf16, each f32 sum rounded once.
namespace bf16 {

using bf = __nv_bfloat16;

// Cob rounded up to the k16 slices of the contraction.
__host__ __device__ inline int kpad(const Geometry& g) {
  return ceil_div(g.cob, 16) * 16;
}

// threads of the largest CTA at wgmma width `lanes` (the launch bound)
__host__ __device__ constexpr int max_threads(int lanes) {
  return kWarpgroup * ((lanes >= 128 ? 2 : kMaxConsumers) + 1);
}

__host__ __device__ inline bool tma_copies(const Geometry& g) {
  return g.cob % 8 == 0;
}

__host__ __device__ inline int cell_elems(const Geometry& g) {
  return g.chunk + 8;
}

// elements from one window row to the next: padded to 128 bytes where each
// row lands by a TMA copy of its own (box_rows 1)
__host__ __device__ inline int row_elems(const Geometry& g) {
  const int row = wwin(g) * cell_elems(g);
  return g.box_rows == 1 ? ceil_div(row, 64) * 64 : row;
}

__host__ __device__ inline int weight_elems(const Geometry& g, int lanes) {
  return max_taps(g.hf, g.stride) * max_taps(g.wf, g.stride) * g.chunk * lanes;
}

// a window slot, rounded up to 128 bytes
__host__ __device__ inline int window_elems(const Geometry& g) {
  return ceil_div(hwin(g) * row_elems(g), 64) * 64;
}

// k16 steps of a stage, at most
__host__ __device__ inline int max_steps(const Geometry& g) {
  return max_taps(g.hf, g.stride) * max_taps(g.wf, g.stride) * g.chunk / 16;
}

// Dynamic shared memory of one CTA (core/blocking.py dgrad_smem_bytes at
// op_bytes 2): 128 bytes to align the base, per slot the weights, the
// window and with the prologue z, an int a k16 step (an even count) and an
// 8-byte mbarrier per slot and copy group.
__host__ inline size_t smem_bytes(const Geometry& g, int lanes) {
  return 128
         + 2 * (size_t)kSlots * (weight_elems(g, lanes)
                                 + (g.prologue ? 2 : 1) * window_elems(g))
         + 4 * ceil_div(bf16::max_steps(g), 2) * 2 + 8 * kSlots * kMaxGroups;
}

// dgrad_tile::plan at one bf16 product a MAC, Cob padded to k16 slices.
__host__ inline void plan(const Geometry& g, int n, int wgs, int lanes,
                          long long* out) {
  dgrad_tile::plan(g, n, wgs, lanes, out);
  out[2] = out[2] / (3 * dgrad_tile::kpad(g)) * bf16::kpad(g);
}

struct Smem {
  bf* wts;             // [kSlots][wst]
  bf* win;             // [kSlots][cst]
  bf* zwin;            // [kSlots][cst] with the prologue
  int* shifts;         // [max_steps]
  uint64_t* bars;      // [kSlots][kMaxGroups]
  int wst, cst;
};

template <int N>
__device__ inline Smem carve(char* raw, const Geometry& g) {
  Smem m;
  const uint32_t a = smem_u32(raw);
  char* base = raw + ((128 - (a & 127)) & 127);
  m.wst = weight_elems(g, N);
  m.cst = window_elems(g);
  m.wts = reinterpret_cast<bf*>(base);
  m.win = m.wts + kSlots * m.wst;
  m.zwin = m.win + kSlots * m.cst;
  m.shifts = reinterpret_cast<int*>(m.zwin + (g.prologue ? kSlots * m.cst
                                                          : 0));
  m.bars = reinterpret_cast<uint64_t*>(m.shifts
                                       + ceil_div(bf16::max_steps(g), 2) * 2);
  return m;
}

template <int N>
__device__ __forceinline__ int weight_bytes(const Geometry& g, const Tile& t) {
  return t.r.taps * t.c.taps * g.chunk * N * 2;
}

__device__ __forceinline__ int row_bytes(const Geometry& g, int lo, int hi) {
  return row_boxes(g, lo, hi) * g.box_rows * wwin(g) * cell_elems(g) * 2
         * (g.prologue ? 2 : 1);
}

// Issue stage s's weights (one TMA copy per phase tap: Cob channels [c0,
// c0 + chunk) by N lanes of block (co_b, ci_b), landing as [chunk / 8][N]
// [8]) onto `bar`, lane `lane` of `lanes` taking every lanes-th tap.
template <int N>
__device__ void issue_weights(const CUtensorMap* tmw, bf* dst, uint64_t* bar,
                              const Geometry& g, const Tile& t, int co_b,
                              int ci_b, int c0, int lane, int lanes) {
  const int blk = (co_b * g.ciblk + ci_b) * g.hf * g.wf;
  for (int tap = lane; tap < t.r.taps * t.c.taps; tap += lanes) {
    const int dh = t.ph + g.stride * (tap / t.c.taps);
    const int dw = t.pw + g.stride * (tap % t.c.taps);
    tma_load_4d(dst + tap * g.chunk * N, tmw, bar, 0, 0, c0 / 8,
                blk + dh * g.wf + dw);
  }
}

// Issue window rows [lo, hi) of g (and z) for channels [c0, c0 + chunk + 8)
// as row_boxes boxes (dgrad_tile::issue_rows, in bf16).
__device__ void issue_rows(const CUtensorMap* tmg, const CUtensorMap* tmz,
                           bf* win, bf* zwin, uint64_t* bar,
                           const Geometry& g, int n, int co_b, int c0,
                           int o_h, int o_w, int lo, int hi, int lane,
                           int lanes) {
  const int rf = row_elems(g);
  for (int b = lane; b < row_boxes(g, lo, hi); b += lanes) {
    const int r = min(lo + b * g.box_rows, hi - g.box_rows);
    tma_load_5d(win + r * rf, tmg, bar, c0, o_w, o_h + r, co_b, n);
    if (g.prologue) {
      tma_load_5d(zwin + r * rf, tmz, bar, c0, o_w, o_h + r, co_b, n);
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Stage s's weights by 2-byte loads and stores (`tid` of the producer's
// kWarpgroup): what issue_weights's boxes land, zeros for lanes past Cib
// and channels past Cob.
template <int N>
__device__ void copy_weights(const bf* __restrict__ w, bf* dst,
                             const Geometry& g, const Tile& t, int co_b,
                             int ci_b, int c0, int tid) {
  const int blk = (co_b * g.ciblk + ci_b) * g.hf * g.wf;
  const int per_tap = g.chunk * N;
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
  unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
  for (int i = tid; i < t.r.taps * t.c.taps * per_tap; i += kWarpgroup) {
    const int tap = i / per_tap;
    const int e = i - tap * per_tap;          // (k / 8, lane, k % 8)
    const int k = e / (8 * N) * 8 + (e & 7);
    const int lane = e / 8 % N;
    const int dh = t.ph + g.stride * (tap / t.c.taps);
    const int dw = t.pw + g.stride * (tap % t.c.taps);
    const bool ok = lane < g.cib && c0 + k < g.cob;
    d16[i] = ok ? __ldg(w16 + ((size_t)(blk + dh * g.wf + dw) * g.cib + lane)
                                  * g.cob + c0 + k)
                : (unsigned short)0;
  }
}

// Window rows [lo, hi) of g (and z) by copies (`tid` of the producer's
// kWarpgroup): what issue_rows's boxes land, channels [c0, c0 + chunk + 8),
// zeros outside the map and past Cob; 4-byte cp.async of channel pairs
// where Cob is even, else 2-byte loads and stores.
__device__ void copy_rows(const bf* __restrict__ gg, const bf* __restrict__ zz,
                          bf* win, bf* zwin, const Geometry& g, int n,
                          int co_b, int c0, int o_h, int o_w, int lo, int hi,
                          int tid) {
  const int rf = row_elems(g);
  const int ld = cell_elems(g);
  const int unit = g.cob % 2 == 0 ? 2 : 1;
  const int per_row = wwin(g) * ld / unit;
  const size_t map = (size_t)(n * g.coblk + co_b) * g.ho * g.wo;
  const unsigned short* g16 = reinterpret_cast<const unsigned short*>(gg);
  const unsigned short* z16 = reinterpret_cast<const unsigned short*>(zz);
  unsigned short* w16 = reinterpret_cast<unsigned short*>(win);
  unsigned short* y16 = reinterpret_cast<unsigned short*>(zwin);
  for (int i = tid; i < (hi - lo) * per_row; i += kWarpgroup) {
    const int r = i / per_row;
    const int rem = (i - r * per_row) * unit;
    const int col = rem / ld;
    const int c = rem - col * ld;
    const int oh = o_h + lo + r;
    const int ow = o_w + col;
    const bool ok = oh >= 0 && oh < g.ho && ow >= 0 && ow < g.wo
                    && c0 + c < g.cob;
    const size_t off = ok ? (map + (size_t)oh * g.wo + ow) * g.cob + c0 + c
                          : 0;
    const int at = (lo + r) * rf + col * ld + c;
    if (unit == 2) {
      cp_async4(w16 + at, g16 + off, ok);
      if (g.prologue) cp_async4(y16 + at, z16 + off, ok);
    } else {
      w16[at] = ok ? __ldg(g16 + off) : (unsigned short)0;
      if (g.prologue) y16[at] = ok ? __ldg(z16 + off) : (unsigned short)0;
    }
  }
}

// dz = g * act'(z) in place over window rows [lo, hi), eight channels at a
// time over whole rows (`tid` of `nth`)
__device__ void prologue_rows(bf* win, const bf* zwin, const Geometry& g,
                              int lo, int hi, int tid, int nth) {
  const int rf = row_elems(g);
  uint4* w8 = reinterpret_cast<uint4*>(win + lo * rf);
  const uint4* z8 = reinterpret_cast<const uint4*>(zwin + lo * rf);
#pragma unroll 2
  for (int i = tid; i < (hi - lo) * rf / 8; i += nth) {
    uint4 v = w8[i];
    const uint4 zz = z8[i];
    bf* vb = reinterpret_cast<bf*>(&v);
    const bf* zb = reinterpret_cast<const bf*>(&zz);
#pragma unroll
    for (int e = 0; e < 8; ++e) vb[e] = prologue_bf16(vb[e], zb[e], g.act);
    w8[i] = v;
  }
}

// The A shift of each k16 step j of the tile's phase, in elements from tap
// (0, 0) (every thread of the CTA).
__device__ void step_shifts(int* shifts, const Geometry& g, const Tile& t) {
  const int slices = g.chunk / 16;
  const int rf = row_elems(g);
  const int ld = cell_elems(g);
  for (int j = threadIdx.x; j < t.r.taps * t.c.taps * slices;
       j += blockDim.x) {
    const int tap = j / slices;
    shifts[j] = (j % slices) * 16
                - ((tap / t.c.taps) * rf + tap % t.c.taps * ld);
  }
}

// This consumer thread's two rows as window offsets, in elements, of tap
// (0, 0) plus the column 2 (lane % 4) (dgrad_tile::row_offsets).
__device__ __forceinline__ void row_offsets(int (&off)[2], const Geometry& g,
                                            int mt0, int q0) {
  const int lane = threadIdx.x % 32;
  const int local = q0 + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int rf = row_elems(g);
  const int ld = cell_elems(g);
  const int mh = max_taps(g.hf, g.stride) - 1;
  const int mw = max_taps(g.wf, g.stride) - 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = local + 8 * h;
    int p = mt0 * g.mstride + q;
    if (q >= g.mstride || p >= g.th * g.tw) p = 0;
    off[h] = (p / g.tw + mh) * rf + (p % g.tw + mw) * ld + 2 * (lane % 4);
  }
}

// A for one k16 step at `shift` elements from each row's offset.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf* win,
                                       const int (&off)[2], int shift) {
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(win + off[0] + shift);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(win + off[1] + shift);
  a[0] = r0[0];
  a[1] = r1[0];
  a[2] = r0[4];
  a[3] = r1[4];
}

// Contract one landed stage into a consumer's running sum `total`: the
// stage's k16 steps into a fresh accumulator, NW lanes of the N-lane B at a
// time, each part then added into `total` in f32.  A is loaded one step
// ahead into the register set the wgmma two steps back has released.
// Returns with every wgmma complete.
template <int N, int NW>
__device__ void mma_stage(float (&total)[N / 2], const bf* win,
                          const int (&off)[2], const int* shifts, int steps,
                          const bf* wts) {
  if (steps == 0) return;
#pragma unroll
  for (int part = 0; part < N / NW; ++part) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    // B [k/8][N][8]: a k16 step's two K halves N * 16 bytes apart, 8-lane
    // groups 128 bytes apart; the part's first group NW * 16 bytes on
    const uint32_t base = smem_u32(wts) + part * NW * 16;
    auto step = [&](const uint32_t (&a)[4], int j) {
      wgmma_fence();
      wgmma_bf16<NW, 0>(acc, a, kmajor_desc(base + j * N * 32, N * 16, 128));
      wgmma_commit();
    };
    uint32_t a0[4], a1[4];
    load_a(a0, win, off, shifts[0]);
    for (int j = 0; j < steps; j += 2) {
      step(a0, j);
      if (j + 1 < steps) {
        wgmma_wait<1>();              // step j - 1 has released a1
        load_a(a1, win, off, shifts[j + 1]);
        step(a1, j + 1);
      }
      if (j + 2 < steps) {
        wgmma_wait<1>();              // step j has released a0
        load_a(a0, win, off, shifts[j + 2]);
      }
    }
    wgmma_wait<0>();
    fence_regs<NW / 2>(acc);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) total[part * NW / 2 + i] += acc[i];
  }
}

// Store a consumer's rows of m-tile mt0 into dx as bf16, each f32 sum
// rounded once (dgrad_tile::store_dx).
template <int N>
__device__ void store_dx(bf* __restrict__ dx, const float (&acc)[N / 2],
                         const Geometry& g, const Tile& t, int n, int ci_b,
                         int mt0, int q0) {
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

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const bf*, const bf*, const bf*,
                        bf*, Geometry);

// dgrad_tile::launch for the bf16 build: w as [rows, Cob/8, Cib, 8] with a
// box of chunk/8 x lanes, g and z with a box of chunk + 8 channels, where
// Cob is a multiple of 8; every Co block in one grid.
inline int launch(Kernel kernel, const bf* g, const bf* z, const bf* w,
                  bf* dx, int n, const Geometry& geo, int wgs, int lanes,
                  cudaStream_t stream, int* launches) {
  *launches = 0;
  if (kernel == nullptr || wgs < 1
      || kWarpgroup * (wgs + 1) > bf16::max_threads(lanes)
      || lanes < geo.cib
      || geo.chunk % 16 != 0 || bf16::kpad(geo) % geo.chunk != 0
      || geo.mstride < 1 || geo.mstride > kRows * wgs
      || geo.th < 1 || geo.tw < 1 || geo.stride < 1
      || geo.co_first != 0 || geo.co_count != geo.coblk
      || (geo.prologue != 0) != (z != nullptr)
      || (bf16::tma_copies(geo) && geo.box_rows > 1
          && geo.box_rows < hwin(geo)
          && wwin(geo) * cell_elems(geo) % 64 != 0)) {
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
  const long long wdims[4] = {8, geo.cib, cob / 8,
                              (long long)geo.coblk * geo.ciblk * geo.hf
                                  * geo.wf};
  const long long wstr[3] = {cob * 2, 16, geo.cib * cob * 2};
  const int wbox[4] = {8, lanes, geo.chunk / 8, 1};
  const long long gdims[5] = {cob, geo.wo, geo.ho, geo.coblk, n};
  const long long gstr[4] = {cob * 2, geo.wo * cob * 2,
                             (long long)geo.ho * geo.wo * cob * 2,
                             (long long)geo.coblk * geo.ho * geo.wo * cob * 2};
  const int gbox[5] = {geo.chunk + 8, wwin(geo), geo.box_rows, 1, 1};
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (bf16::tma_copies(geo)
      && (!encode(&tmw, w, 4, wdims, wstr, wbox, type)
          || !encode(&tmg, g, 5, gdims, gstr, gbox, type)
          || !encode(&tmz, z != nullptr ? z : g, 5, gdims, gstr, gbox,
                     type))) {
    return (int)cudaErrorNotSupported;     // the encoder refused a map
  }
  const size_t smem = bf16::smem_bytes(geo, lanes);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, geo.ciblk, n), kWarpgroup * (wgs + 1), smem,
           stream>>>(tmw, tmg, tmz, g, z, w, dx, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launches = 1;
  return 0;
}

}  // namespace bf16


}  // namespace dgrad_tile
