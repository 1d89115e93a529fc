// Weight-gradient tile on Hopper tensor cores (sm_90a): the device core that
// the window wgrad (direct_conv2d_bwd.cu, `wgrad_kernel`) and the streamed
// wgrad (conv2d_stream.cu, `stream_wgrad_kernel`) share.
//
// The function, on the paper's blocked layouts:
//
//   x     [N, Ci/Cib, Hi, Wi, Cib]   the forward's unpadded input
//   g, z  [N, Co/Cob, Ho, Wo, Cob]   raw cotangent, saved pre-activation
//   dw[co_b, ci_b, dh, dw, c, co] = sum_{n,oh,ow} x[n, ci_b, oh*s+dh-pt,
//                                   ow*s+dw-pl, c] * dz[n, co_b, oh, ow, co]
//   db[co_b, co] = sum dz,           dz = g * act'(z)
//
// The implicit GEMM.  For one (Ci block, Co block) the rows M are the (tap,
// c) pairs, tap-major (Hf * Wf * Cib of them, in m-tiles of 64), the
// columns N are Cob padded up to the compiled wgmma width, and K runs over
// output positions:
//
//   A[(tap, c), p] = x_window[cell(p) + shift(tap)][c]
//   B[p, co]       = dz[p][co]
//
// A is read from the staged x window into registers at each row's own
// offset (tap shift + channel) plus each column's position offset, so one
// staged window serves every tap and no swizzle has to follow the shift.
// TF32 wgmma reads B from shared memory only K-major, and dz arrives with
// Cob contiguous: the producer forms dz, splits it and writes it transposed
// as [K/4][N][4], so each 8 x 4 block is a core matrix (the dgrad's weight
// order, dgrad_tile.cuh), with zeros past Cob and past the stage's
// positions.  f32 accuracy from TF32 as in the dgrads (3xTF32): big * big +
// big * small + small * big into one f32 accumulator.
//
// A stage is one tile of th x tw output positions of one image (K = th * tw
// rounded up to 8).  A CTA holds `wgs` consumer warpgroups of `mpw` m-tiles
// each, so its m-tile group shares every staged window and dz tile among
// wgs * mpw * 64 (tap, c) rows; `groups` CTAs cover the m-tiles.  It walks a
// contiguous share of the tiles (`splits` shares), its sums going to its
// share's row of an f32 workspace [splits, |dw| + |db|]; the CTAs of one
// (m-tile group, Ci block, Co block) are a column of split_sum.cuh, whose
// last to arrive sums its rows in split order into dw and db.  No
// sum depends on the order the CTAs run in: two runs give identical bits.
//
// Warp roles.  The consumer warpgroups (the first threads) run the wgmmas;
// the producer warpgroup feeds a two-slot ring, by TMA where the global
// strides are multiples of 16 bytes (a box a window row, `ld` channels a
// cell, and a box of the tile's g and of its z, each group onto an mbarrier
// of its slot; cells outside the map and channels past Cib land as zeros,
// so no padded copy exists), else by 4-byte cp.async copies with the same
// zero fill (Cib = 3, Cob not a multiple of 4).  g and z run two stages
// ahead (only the producer reads them); a stage's x window is issued once
// the consumers have freed its slot, and while it lands the producer forms
// dz = g * act'(z) from the staged g and z once per element, splits it and
// writes B.  The window form copies each tile's whole x window; the
// streamed form walks the tiles column by column and, where the next tile
// continues the column, moves the halo rows it shares from the other slot
// and copies only its fresh rows.  db: the producer of the CTAs of Ci block
// 0 and m-tile group 0 sums dz per Cob lane as it forms it (the reference's
// `ci == 0` pass), in a fixed order.
//
// Grouped maps and dilated taps (the reference's `_wgrad_windowed`,
// src/repro/kernels/direct_conv2d.py:585-650).  With `groups` > 1, dw is
// [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob]: the grid's Ci axis runs over the
// group's cigblk = (Ci/Cib) / groups input blocks, and CTA (co_b, ci_b)
// stages x's block (co_b / cogblk) cigblk + ci_b (`x_block`), writing dw
// block co_b cigblk + ci_b; cross-group blocks are never staged, so the
// tiles issue 1 / groups of the dense MACs.  db is still summed by the CTAs
// of ci_b 0, once a Co block.  At dilation (dil_h, dil_w) the x window is
// (th - 1) s + (hf - 1) dil_h + 1 rows by the same in columns, and tap (dh,
// dw) reads it dh dil_h rows and dw dil_w cells on.  Where a tap's band of
// the window, (th - 1) s + 1 rows, is shorter than the dilation, most rows
// are read by no tap (DeepLab-LargeFOV's fc6, dilation 12: 22 of a 3x3
// window's 25 rows and columns at th 1), and the f32 tile stages the hf
// bands alone, band dh the input rows dh dil_h + [0, band) (`gather_h`),
// and the same in columns, a TMA box a (row, band) each 128 bytes apart
// (`gather_w`); tap (dh, dw) then starts band dh's first row and band dw's
// first cell on.  At dilation 1 the bands overlap and the window is whole,
// as before.  The bf16 build stages min(s, (wf - 1) dil_w + 1) column phases
// of tw + ((wf - 1) dil_w) / s cells, and tap (dh, dw) reads phase (dw
// dil_w) % s from cell (dw dil_w) / s of window row dh dil_h (`abase`): at
// stride 2 with an even dilation every tap reads phase 0, and phase 1 is
// staged and never read.
//
// Shared memory, in floats, from a 128-byte aligned base, per slot: the x
// window [hwin][rf] (a row's wwin cells of ld floats, padded to 128 bytes;
// ld = Cib padded so that four positions a stride apart fall on four
// distinct 8-bank groups of an A load), g and with the prologue z [K][Cob],
// B big and small [K/4][N][4]; then the position offsets [kMaxPositions],
// the db partials [kWarpgroup] and an mbarrier a slot.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dgrad_tile.cuh"
#include "narrow_rows.cuh"
#include "split_sum.cuh"

namespace wgrad_tile {

namespace dt = dgrad_tile;
using dt::ceil_div;

constexpr int kWarpgroup = 128;     // threads of one warpgroup
constexpr int kMaxConsumers = 3;    // consumer warpgroups of a CTA
constexpr int kMaxThreads = kWarpgroup * (kMaxConsumers + 1);
constexpr int kRows = 64;           // rows of one wgmma tile (m64)
constexpr int kSlots = 2;           // ring slots
constexpr int kMaxPositions = 64;   // output positions of one stage
constexpr int kSmemBlock = 232448;  // the most one CTA may use
// named barriers (0 is __syncthreads): slot s filled, slot s consumed, and
// the producer warpgroup's own
constexpr int kBarFull = 1;         // + s
constexpr int kBarEmpty = kBarFull + kSlots;
constexpr int kBarProducer = kBarEmpty + kSlots;

// The launch's geometry, passed by value.
struct Geometry {
  int n;                            // images
  int ciblk, cib, hi, wi;           // x: [n, ciblk, hi, wi, cib]
  int coblk, cob, ho, wo;           // g, z: [n, coblk, ho, wo, cob]
  int hf, wf, stride, pad_top, pad_left;
  int th, tw;                       // output positions of a stage
  int lanes;                        // wgmma width N (Cob padded up)
  int wgs, mpw;                     // consumer warpgroups, m-tiles each
  int splits;                       // position shares
  int act;                          // 0 linear, 1 relu, 2 gelu
  int prologue;                     // 1: z is staged and dz formed
  int with_db;
  int streamed;                     // 1: column by column, halo rows kept
  int groups;                       // channel groups (1: dense; `groups()`
                                    // below counts m-tile groups)
  int dil_h, dil_w;                 // filter dilation
  int narrow;                       // the bf16 build's narrow rows (a
                                    // filter row's run a 128-byte row)
};

__host__ __device__ inline int tiles_h(const Geometry& g) {
  return ceil_div(g.ho, g.th);
}
__host__ __device__ inline int tiles_w(const Geometry& g) {
  return ceil_div(g.wo, g.tw);
}
__host__ __device__ inline int kpos(const Geometry& g) {
  return ceil_div(g.th * g.tw, 8) * 8;
}
__host__ __device__ inline int hwin(const Geometry& g) {
  return (g.th - 1) * g.stride + (g.hf - 1) * g.dil_h + 1;
}
__host__ __device__ inline int wwin(const Geometry& g) {
  return (g.tw - 1) * g.stride + (g.wf - 1) * g.dil_w + 1;
}

// The grouped map: the grid's Ci axis runs over a group's cigblk input
// blocks; Co block co_b against its ci_b reads x's block x_block and
// writes dw's block dw_block of [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob].
__host__ __device__ inline int cigblk(const Geometry& g) {
  return g.ciblk / g.groups;
}
__host__ __device__ inline int x_block(const Geometry& g, int co_b,
                                       int ci_b) {
  return co_b / (g.coblk / g.groups) * cigblk(g) + ci_b;
}
__host__ __device__ inline int dw_block(const Geometry& g, int co_b,
                                        int ci_b) {
  return co_b * cigblk(g) + ci_b;
}

// Whether the grouped and dilated fields make sense.
__host__ inline bool valid_map(const Geometry& g) {
  return g.groups >= 1 && g.ciblk % g.groups == 0 && g.coblk % g.groups == 0
         && g.dil_h >= 1 && g.dil_w >= 1;
}

// Floats of one staged x cell: Cib rounded up to 4, then up to the first
// value whose stride multiple is 8 mod 16 floats, so an A load's four
// positions s cells apart start on four distinct 8-bank groups (kept at
// Cib rounded up to 4 where no such value exists, as at stride 4).
__host__ __device__ inline int x_ld(int cib, int stride) {
  const int base = ceil_div(cib, 4) * 4;
  for (int ld = base; ld < base + 32; ld += 4) {
    if (stride * ld % 16 == 8) return ld;
  }
  return base;
}

__host__ __device__ inline int round32(int n) { return ceil_div(n, 32) * 32; }

// The f32 tile's staged window (the bf16 build stages hwin x wph phase
// cells): where a tap's band of rows (columns), the tile's (th - 1) s + 1,
// is shorter than the dilation, only the hf (wf) bands the taps read, band
// dh at input row dh dil_h (`gather_h`, `gather_w`), else the whole span.
__host__ __device__ inline int band_h(const Geometry& g) {
  return (g.th - 1) * g.stride + 1;
}
__host__ __device__ inline int band_w(const Geometry& g) {
  return (g.tw - 1) * g.stride + 1;
}
__host__ __device__ inline bool gather_h(const Geometry& g) {
  return g.hf > 1 && band_h(g) < g.dil_h;
}
__host__ __device__ inline bool gather_w(const Geometry& g) {
  return g.wf > 1 && band_w(g) < g.dil_w;
}
// staged rows, and the input row (from the tile's first) of staged row r
__host__ __device__ inline int x_rows(const Geometry& g) {
  return gather_h(g) ? g.hf * band_h(g) : hwin(g);
}
__host__ __device__ inline int x_row(const Geometry& g, int r) {
  return gather_h(g) ? r / band_h(g) * g.dil_h + r % band_h(g) : r;
}
// a TMA box of a row: the row's cells, or a band's
__host__ __device__ inline int box_cells(const Geometry& g) {
  return gather_w(g) ? band_w(g) : wwin(g);
}
// floats from one band of a row to the next, padded to 128 bytes, where
// its box lands
__host__ __device__ inline int band_floats(const Geometry& g) {
  return round32(box_cells(g) * x_ld(g.cib, g.stride));
}
// floats from one window row to the next: its boxes, each padded to 128
// bytes
__host__ __device__ inline int row_floats(const Geometry& g) {
  return (gather_w(g) ? g.wf : 1) * band_floats(g);
}
// the window offset, in floats, of tap (dh, dw)'s first cell
__host__ __device__ inline int tap_floats(const Geometry& g, int dh, int dw) {
  const int ld = x_ld(g.cib, g.stride);
  return (gather_h(g) ? dh * band_h(g) : dh * g.dil_h) * row_floats(g)
         + (gather_w(g) ? dw * band_floats(g) : dw * g.dil_w * ld);
}
// x and g / z arrive by TMA where their global strides are multiples of 16
// bytes, else by cp.async
__host__ __device__ inline bool tma_x(const Geometry& g) {
  return g.cib % 4 == 0;
}
__host__ __device__ inline bool tma_d(const Geometry& g) {
  return g.cob % 4 == 0;
}
__host__ __device__ inline int x_floats(const Geometry& g) {
  return round32(x_rows(g) * row_floats(g));
}
__host__ __device__ inline int raw_floats(const Geometry& g) {
  return round32(kpos(g) * g.cob);
}
__host__ __device__ inline int b_floats(const Geometry& g) {
  return kpos(g) * g.lanes;
}
__host__ __device__ inline int slot_floats(const Geometry& g) {
  return x_floats(g) + (g.prologue ? 2 : 1) * raw_floats(g) + 2 * b_floats(g);
}
// m-tiles of the (tap, c) rows, and CTAs that cover them
__host__ __device__ inline int mtiles(const Geometry& g) {
  return ceil_div(g.hf * g.wf * g.cib, kRows);
}
__host__ __device__ inline int groups(const Geometry& g) {
  return ceil_div(mtiles(g), g.wgs * g.mpw);
}
__host__ __device__ inline long long tiles(const Geometry& g) {
  return (long long)g.n * tiles_h(g) * tiles_w(g);
}
// columns of split_sum.cuh: one per (m-tile group, Ci block of the group,
// Co block)
__host__ __device__ inline int columns(const Geometry& g) {
  return groups(g) * cigblk(g) * g.coblk;
}

// Dynamic shared memory of one CTA (core/blocking.py wgrad_smem_bytes): 128
// bytes to align the base, the two slots, the position offsets, the db
// partials and two mbarriers a slot.
__host__ inline size_t smem_bytes(const Geometry& g) {
  return 128 + 4 * ((size_t)kSlots * slot_floats(g) + kMaxPositions
                    + kWarpgroup)
         + 8 * 2 * kSlots;
}

// What a launch runs (core/blocking.py `wgrad_plan` is its Python twin):
// out[0] the stages of all CTAs of one m-tile group, Ci and Co block (the
// position tiles), out[1] the function's MACs (positions x taps x Cig x
// Co: a grouped conv's are 1/groups of the dense count), out[2] the
// tensor-core MACs the tiles issue: every tile's K positions over every
// m-tile, N wide, three products, in every (Ci of the group, Co) block;
// out[3] the dynamic shared memory of a CTA.
__host__ inline void plan(const Geometry& g, long long* out) {
  out[0] = tiles(g);
  out[1] = (long long)g.n * g.ho * g.wo * g.hf * g.wf * g.cib * cigblk(g)
           * g.cob * g.coblk;
  out[2] = (long long)cigblk(g) * g.coblk * tiles(g) * kpos(g) * mtiles(g)
           * kRows * g.lanes * 3;
  out[3] = (long long)smem_bytes(g);
}

// The tile a stage owns: its image and first output row and column.
struct Tile {
  int n, oh0, ow0;
};

// Tile t in a CTA's walk: image-major; within an image row by row (window),
// or column by column (streamed), so that a streamed share's next tile
// mostly continues the column.
__host__ __device__ inline Tile tile_of(const Geometry& g, long long t) {
  const int th = tiles_h(g), tw = tiles_w(g);
  Tile r;
  r.n = (int)(t / (th * tw));
  const int rem = (int)(t % (th * tw));
  const int a = g.streamed ? rem % th : rem / tw;
  const int b = g.streamed ? rem / th : rem % tw;
  r.oh0 = a * g.th;
  r.ow0 = b * g.tw;
  return r;
}

// Round to TF32 (nearest, ties away from zero) as bits with the low 13 bits
// zero: for finite values the bits cvt.rna.tf32.f32 gives, on the integer
// pipe (the conversion's throughput held the kernels' TF32 split back).
__device__ __forceinline__ uint32_t tf32_round(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

// cp.async: `valid` false copies no byte and zero-fills the destination
// (src-size 0); `src` must still be a global address.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The shared-memory carve-up of one CTA (smem_bytes).
struct Smem {
  float* x[kSlots];
  float* g[kSlots];
  float* z[kSlots];
  float* big[kSlots];
  float* small[kSlots];
  int* posoff;          // [kMaxPositions]
  float* db;            // [kWarpgroup]
  uint64_t* bar_x;      // [kSlots] the x windows landed
  uint64_t* bar_d;      // [kSlots] g and z landed
};

__device__ inline Smem carve(float* raw, const Geometry& g) {
  Smem m;
  float* p = raw + ((128 - (dt::smem_u32(raw) & 127)) & 127) / 4;
  for (int s = 0; s < kSlots; ++s) {
    m.x[s] = p;
    m.g[s] = m.x[s] + x_floats(g);
    m.z[s] = m.g[s] + (g.prologue ? raw_floats(g) : 0);
    m.big[s] = m.z[s] + raw_floats(g);
    m.small[s] = m.big[s] + b_floats(g);
    p = m.small[s] + b_floats(g);
  }
  m.posoff = reinterpret_cast<int*>(p);
  m.db = p + kMaxPositions;
  m.bar_x = reinterpret_cast<uint64_t*>(m.db + kWarpgroup);
  m.bar_d = m.bar_x + kSlots;
  return m;
}

// Issue a stage's x window onto `bar` (`tid` of the producer's kWarpgroup
// threads), staged rows [lo, x_rows) of tile `t` of x's block `x_b`, as TMA
// boxes of a row (or of a band of one) each (`ld` floats a cell, so
// channels past Cib land as zeros) or, where Cib is not a multiple of 4, as
// 4-byte cp.async copies of one group; rows [0, lo) are moved from
// `xprev`, the previous stage's window, whose rows [hwin - lo, hwin) they
// are (the streamed walk, whose windows are whole).  Cells outside the map
// land as zeros.
__device__ void issue_x(const CUtensorMap* tmx, const float* __restrict__ x,
                        const Geometry& g, const Tile& t, int x_b, float* xs,
                        const float* xprev, uint64_t* bar, int lo, int tid) {
  const int ld = x_ld(g.cib, g.stride);
  const int rf = row_floats(g);
  const int hw = x_rows(g);
  const int bands = gather_w(g) ? g.wf : 1;
  const int bc = box_cells(g);
  const int bf = band_floats(g);
  const int ih0 = t.oh0 * g.stride - g.pad_top;
  const int iw0 = t.ow0 * g.stride - g.pad_left;
  if (tid < 32) {                       // warp 0: the TMA copies
    if (tid == 0) {
      dt::mbar_expect_tx(bar, tma_x(g) ? (hw - lo) * bands * bc * ld * 4
                                       : 0);
    }
    __syncwarp();
    if (tma_x(g)) {
      for (int i = lo * bands + tid; i < hw * bands; i += 32) {
        const int r = i / bands;
        const int q = i - r * bands;
        dt::tma_load_5d(xs + r * rf + q * bf, tmx, bar, 0,
                        iw0 + q * g.dil_w, ih0 + x_row(g, r), x_b, t.n);
      }
    }
  }
  if (lo > 0) {                         // the kept rows, while those land
    const float4* src = reinterpret_cast<const float4*>(xprev + (hw - lo) * rf);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int i = tid; i < lo * rf / 4; i += kWarpgroup) dst[i] = src[i];
  }
  if (!tma_x(g)) {                      // Cib = 3: 4-byte copies
    const float* xb = x + (size_t)(t.n * g.ciblk + x_b) * g.hi * g.wi
                      * g.cib;
    const int per_row = bands * bc * g.cib;
    for (int i = tid; i < (hw - lo) * per_row; i += kWarpgroup) {
      const int r = i / per_row;
      const int rem = i - r * per_row;
      const int cell = rem / g.cib;
      const int c = rem - cell * g.cib;
      const int q = cell / bc;
      const int col = cell - q * bc;
      const int ih = ih0 + x_row(g, lo + r);
      const int iw = iw0 + q * g.dil_w + col;
      const bool ok = ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi;
      const float* src = ok ? xb + ((size_t)ih * g.wi + iw) * g.cib + c : xb;
      cp_async4(xs + (lo + r) * rf + q * bf + col * ld + c, src, ok);
    }
    cp_async_commit();
  }
}

// Issue the th x tw positions of g (and z) of tile `t`, Co block co_b, onto
// `bar`: one TMA box each (positions outside the map land as zeros) or,
// where Cob is not a multiple of 4, 4-byte cp.async copies of one group.
__device__ void issue_d(const CUtensorMap* tmg, const CUtensorMap* tmz,
                        const float* __restrict__ gg,
                        const float* __restrict__ zz, const Geometry& g,
                        const Tile& t, int co_b, float* rg, float* rz,
                        uint64_t* bar, int tid) {
  if (tid == 0) {
    dt::mbar_expect_tx(bar, tma_d(g) ? g.th * g.tw * g.cob * 4
                                           * (g.prologue ? 2 : 1)
                                     : 0);
    if (tma_d(g)) {
      dt::tma_load_5d(rg, tmg, bar, 0, t.ow0, t.oh0, co_b, t.n);
      if (g.prologue) dt::tma_load_5d(rz, tmz, bar, 0, t.ow0, t.oh0, co_b, t.n);
    }
  }
  if (!tma_d(g)) {                      // Cob not a multiple of 4
    const size_t map = (size_t)(t.n * g.coblk + co_b) * g.ho * g.wo * g.cob;
    for (int i = tid; i < g.th * g.tw * g.cob; i += kWarpgroup) {
      const int p = i / g.cob;
      const int c = i - p * g.cob;
      const int oh = t.oh0 + p / g.tw;
      const int ow = t.ow0 + p % g.tw;
      const bool ok = oh < g.ho && ow < g.wo;
      const size_t off = ok ? map + ((size_t)oh * g.wo + ow) * g.cob + c : 0;
      cp_async4(rg + i, gg + off, ok);
      if (g.prologue) cp_async4(rz + i, zz + off, ok);
    }
    cp_async_commit();
  }
}

// Form dz from a landed stage's g (and z), split it into TF32 halves and
// write B as [K/4][N][4] (`tid` of kWarpgroup; thread tid keeps Cob lane
// tid % N, since N divides kWarpgroup); positions past the tile and lanes
// past Cob are 0.  Returns `db` plus this thread's dz, added in order.
template <int N>
__device__ float transform(const float* rg, const float* rz, float* big,
                           float* small, const Geometry& g, int tid,
                           float db) {
  static_assert(kWarpgroup % N == 0, "a thread keeps one Cob lane");
  const int live = g.th * g.tw;
  const int co = tid % N;
  const bool on = co < g.cob;
  for (int q = tid; q < kpos(g) / 4 * N; q += kWarpgroup) {
    const int p0 = q / N * 4;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // loads without a branch, clamped into the staged cells (rz is rg
      // without the prologue), then the lanes and positions outside set 0
      const int p = p0 + k;
      const int at = min(p, live - 1) * g.cob + min(co, g.cob - 1);
      const float gv = rg[at];
      const float zv = rz[at];
      const float d = g.prologue ? dt::prologue(gv, zv, g.act) : gv;
      v[k] = on && p < live ? d : 0.0f;
      db += v[k];
    }
    float h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __uint_as_float(tf32_round(v[k]));
      l[k] = __uint_as_float(tf32_round(v[k] - h[k]));
    }
    reinterpret_cast<float4*>(big)[q] = make_float4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<float4*>(small)[q] = make_float4(l[0], l[1], l[2], l[3]);
  }
  return db;
}

// ---------------------------------------------------------------------------
// the products (consumer warpgroups)
// ---------------------------------------------------------------------------

// Contract one landed stage (`steps` k8 slices of positions) into a
// warpgroup's MPW accumulators: per slice the two position offsets of this
// thread's columns (l % 4, + 4), then per m-tile A loaded at each row's
// offset `ro` and split, one step ahead into the register set the wgmma two
// units back has released.  m-tiles that are `off` issue nothing.  Returns
// with every wgmma complete.
template <int N, int MPW>
__device__ void mma_stage(float (&acc)[MPW][N / 2], const float* win,
                          const int (&ro)[MPW][2], const bool (&on)[MPW],
                          const int* posoff, int steps, const float* b_big,
                          const float* b_small) {
  const uint32_t big_base = dt::smem_u32(b_big);
  const uint32_t small_base = dt::smem_u32(b_small);
  auto desc = [&](uint32_t base, int j) {
    return dt::kmajor_desc(base + j * N * 32, N * 16, 128);
  };
  const int l4 = threadIdx.x % 4;
  auto load = [&](uint32_t (&hb)[4], uint32_t (&hs)[4], int t, int p0,
                  int p1) {
    const float v[4] = {win[ro[t][0] + p0], win[ro[t][1] + p0],
                        win[ro[t][0] + p1], win[ro[t][1] + p1]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hb[i] = tf32_round(v[i]);
      hs[i] = tf32_round(v[i] - __uint_as_float(hb[i]));
    }
  };
  uint32_t hb[2][4], hs[2][4];
  int p0 = posoff[l4];
  int p1 = posoff[l4 + 4];
  if (on[0]) load(hb[0], hs[0], 0, p0, p1);
  for (int j = 0; j < steps; j += 2) {
#pragma unroll
    for (int u = 0; u < 2 * MPW; ++u) {
      const int jj = j + u / MPW;
      const int t = u % MPW;
      if (jj >= steps) break;
      if (on[t]) {
        dt::issue<N>(acc[t], hb[u & 1], hs[u & 1], desc(big_base, jj),
                     desc(small_base, jj));
      }
      const int un = u + 1;
      const int jn = j + un / MPW;
      const int tn = un % MPW;
      if (jn < steps) {
        if (tn == 0) {
          p0 = posoff[8 * jn + l4];
          p1 = posoff[8 * jn + l4 + 4];
        }
        // unit u - 1 used this set: the group before the last where unit
        // u issued one, else the last
        if (on[t]) {
          dt::wgmma_wait<1>();
        } else {
          dt::wgmma_wait<0>();
        }
        if (on[tn]) load(hb[un & 1], hs[un & 1], tn, p0, p1);
      }
    }
  }
  dt::wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < MPW; ++t) dt::fence_regs<N / 2>(acc[t]);
}

// Store a consumer's rows of its m-tiles into its share's workspace row:
// m-tile mt0 + t, rows 16 * warp + lane / 4 (+ 8) of it, each (tap, c)
// row's lanes < Cob, in dw block (co_b, ci_b) of the group's.
template <int N, int MPW>
__device__ void store_dw(float* __restrict__ row,
                         const float (&acc)[MPW][N / 2], const Geometry& g,
                         int ci_b, int co_b, int mt0) {
  const int lane = threadIdx.x % 32;
  const int rows = g.hf * g.wf * g.cib;
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt0 + t) * kRows + threadIdx.x % kWarpgroup / 32 * 16
                    + lane / 4 + 8 * h;
      if (m >= rows) continue;
      const int tap = m / g.cib;
      const int c = m - tap * g.cib;
      float* out = row + (((size_t)dw_block(g, co_b, ci_b) * g.hf * g.wf
                           + tap) * g.cib + c) * g.cob;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + col0;
        if (col < g.cob) out[col] = acc[t][4 * jj + 2 * h];
        if (col + 1 < g.cob) out[col + 1] = acc[t][4 * jj + 2 * h + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel body
// ---------------------------------------------------------------------------

// The consumer warpgroups of `run`: their m-tiles' wgmmas over the CTA's
// stages, then their rows of the share's workspace row.
template <int N, int MPW>
__device__ __forceinline__ void consume(const Smem& m, const Geometry& geo,
                                        int group, int stages, float* row,
                                        int ci_b, int co_b) {
  const int nth = blockDim.x;
  const int mt0 = (group * geo.wgs + threadIdx.x / kWarpgroup) * MPW;
  const int rows = geo.hf * geo.wf * geo.cib;
  int ro[MPW][2];
  bool on[MPW];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
    on[t] = mt0 + t < mtiles(geo);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (mt0 + t) * kRows + threadIdx.x % kWarpgroup / 32 * 16
                    + threadIdx.x % 32 / 4 + 8 * h;
      const int tap = r / geo.cib;
      ro[t][h] = r < rows ? tap_floats(geo, tap / geo.wf, tap % geo.wf)
                                + (r - tap * geo.cib)
                          : 0;
    }
  }
  float acc[MPW][N / 2];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.0f;
  }
  for (int s = 0; s < stages; ++s) {
    const int slot = s & 1;
    dt::bar_sync(kBarFull + slot, nth);
    mma_stage<N, MPW>(acc, m.x[slot], ro, on, m.posoff, kpos(geo) / 8,
                      m.big[slot], m.small[slot]);
    if (s + kSlots < stages) dt::bar_arrive(kBarEmpty + slot, nth);
  }
  store_dw<N, MPW>(row, acc, geo, ci_b, co_b, mt0);
}

// One CTA: m-tile group blockIdx.x % groups, share blockIdx.x / groups, Ci
// block blockIdx.y of the Co block's group, Co block blockIdx.z; `wgs`
// consumer warpgroups of MPW m-tiles each and one producer warpgroup.  Its sums go to its share's row
// of `ws` ([splits, |dw| + |db|]); the column's last CTA sums the rows into
// `out` ([|dw| + |db|]).
template <int N, int MPW>
__device__ void run(float* smem, const CUtensorMap* tmx,
                    const CUtensorMap* tmg, const CUtensorMap* tmz,
                    const float* __restrict__ x,
                    const float* __restrict__ gg,
                    const float* __restrict__ zz, float* ws, float* out,
                    int* counters, const Geometry& geo) {
  const int ngroups = groups(geo);
  const int group = blockIdx.x % ngroups;
  const int split = blockIdx.x / ngroups;
  const int ci_b = blockIdx.y;
  const int co_b = blockIdx.z;
  const long long total = tiles(geo);
  const long long first = total * split / geo.splits;
  const int stages = (int)(total * (split + 1) / geo.splits - first);
  const int nth = blockDim.x;
  const int consumers = nth - kWarpgroup;
  const Smem m = carve(smem, geo);
  const int ld = x_ld(geo.cib, geo.stride);
  const int rf = row_floats(geo);
  for (int p = threadIdx.x; p < kMaxPositions; p += nth) {
    m.posoff[p] = p < geo.th * geo.tw
                      ? (p / geo.tw) * geo.stride * rf
                            + (p % geo.tw) * geo.stride * ld
                      : 0;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      dt::mbar_init(&m.bar_x[i], 1);
      dt::mbar_init(&m.bar_d[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t dw_size = (size_t)geo.coblk * cigblk(geo) * geo.hf * geo.wf
                         * geo.cib * geo.cob;
  const size_t cols = dw_size + (geo.with_db ? geo.coblk * geo.cob : 0);
  float* row = ws + (size_t)split * cols;

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    const int keep = max(0, hwin(geo) - geo.th * geo.stride);
    auto issue_g = [&](int s) {
      issue_d(tmg, tmz, gg, zz, geo, tile_of(geo, first + s), co_b,
              m.g[s & 1], m.z[s & 1], &m.bar_d[s & 1], tid);
    };
    // g and z run two stages ahead of the x windows: only the producer
    // reads them, so their slot is free once their stage is transformed
    for (int s = 0; s < min(stages, kSlots); ++s) issue_g(s);
    float db = 0.0f;
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      const int parity = (s >> 1) & 1;
      // x and B of slot `slot` once the consumers are done with stage s - 2
      if (s >= kSlots) dt::bar_sync(kBarEmpty + slot, nth);
      // the streamed walk's next tile continues the column: keep the rows
      // the two windows share
      const bool more = geo.streamed && s > 0
                        && (first + s) % tiles_h(geo) != 0;
      // rows of stage s - 1 that other threads copied by cp.async have
      // landed (TMA's are, once this thread has waited on their mbarrier)
      if (more && !tma_x(geo)) dt::bar_sync(kBarProducer, kWarpgroup);
      issue_x(tmx, x, geo, tile_of(geo, first + s), x_block(geo, co_b, ci_b),
              m.x[slot], m.x[slot ^ 1], &m.bar_x[slot], more ? keep : 0,
              tid);
      if (!tma_d(geo)) cp_async_wait_all();
      dt::mbar_wait(&m.bar_d[slot], parity);
      dt::bar_sync(kBarProducer, kWarpgroup);   // g and z of s landed
      db = transform<N>(m.g[slot], m.z[slot], m.big[slot], m.small[slot],
                        geo, tid, db);
      dt::bar_sync(kBarProducer, kWarpgroup);   // g and z of s read
      if (s + kSlots < stages) issue_g(s + kSlots);
      if (!tma_x(geo)) cp_async_wait_all();
      dt::mbar_wait(&m.bar_x[slot], parity);
      dt::fence_proxy_async();
      dt::bar_arrive(kBarFull + slot, nth);
    }
    if (geo.with_db && ci_b == 0 && group == 0) {
      m.db[tid] = db;
      dt::bar_sync(kBarProducer, kWarpgroup);
      if (tid < geo.cob) {
        float sum = 0.0f;
        for (int k = 0; k < kWarpgroup / N; ++k) sum += m.db[k * N + tid];
        row[dw_size + co_b * geo.cob + tid] = sum;
      }
    }
  } else {
    consume<N, MPW>(m, geo, group, stages, row, ci_b, co_b);
  }

  // the column's last CTA sums its rows in split order: the (tap, c) rows
  // of the group's m-tiles, and db where the column has it
  const int column = dw_block(geo, co_b, ci_b) * ngroups + group;
  if (!split_sum::arrive(counters + column, geo.splits,
                         reinterpret_cast<int*>(m.db), 0, nth,
                         threadIdx.x == 0)) {
    return;
  }
  const int span = geo.wgs * geo.mpw * kRows;
  const int m_lo = group * span;
  const int m_hi = min(geo.hf * geo.wf * geo.cib, m_lo + span);
  const size_t base = (size_t)dw_block(geo, co_b, ci_b) * geo.hf * geo.wf
                          * geo.cib * geo.cob
                      + (size_t)m_lo * geo.cob;
  split_sum::sum_rows(ws + base, cols, geo.splits, out + base,
                      (m_hi - m_lo) * geo.cob, 1.0f, threadIdx.x, nth);
  if (geo.with_db && ci_b == 0 && group == 0) {
    const size_t db = dw_size + (size_t)co_b * geo.cob;
    split_sum::sum_rows(ws + db, cols, geo.splits, out + db, geo.cob, 1.0f,
                        threadIdx.x, nth);
  }
}

// ---------------------------------------------------------------------------
// the bf16 build
// ---------------------------------------------------------------------------
//
// The same GEMM on bf16 operands: the reference's `_wgrad_kernel` under
// BF16 (bf16 x and dz; dw leaves in f32, src/repro/kernels/
// direct_conv2d.py:638, `out_dtype=jnp.float32`).  It takes dz, formed once
// a layer by the dz pass (direct_conv2d_bwd.cu `dz_kernel_bf16`, which
// also sums db), and nothing else of the cotangent: no z, no prologue, no
// db.  Both operands of every wgmma come from shared memory by descriptor,
// as TMA lands them:
//
// * An m-tile is one tap x 64 channels (a "half" of the Ci block: Cib 128
//   has two, Cib <= 64 one, its rows past Cib zero).  The x window of a
//   stage is staged once for every tap, a half at a time, as 128-byte rows
//   of 64 channels, one row a cell, in TMA's 128-byte swizzle.  A is the
//   window read MN-major (channels contiguous) through wgmma's transpose
//   bit: the descriptor of a k16 step starts at the tap's cell plus the
//   step's first position, 128 bytes a cell, its two 8-position groups
//   `sbo` bytes apart.  Each group must be 8 consecutive cells: tw is a
//   multiple of 8 (columns past Wo meet zero dz), except at 1x1 stride 1,
//   where the window is the tile and positions run on across row breaks.
//   A start off a 1024-byte atom takes no base offset: the card swizzles by
//   the address bits themselves (on the H100 a one-tap unit launch read a
//   start at any row and any gap right with the field 0, and wrong with
//   it (addr >> 7) & 7; `probe` holds the tile's descriptors so).
// * At stride s the window is staged in s column phases, each by a TMA box
//   that traverses W at element stride s (the forward's boxes, fwd_tile.cuh
//   `encode_window`), from column iw0 + phase on (negative columns, the
//   pads, land as zeros), so any width takes it (AlexNet's conv2 and conv3
//   are 27 and 13 wide at stride 2): tap (dh, dw) reads phase dw % s at
//   column offset dw / s, and its positions are consecutive cells there.
// * B, the dz tile [K][Cob], lands the same way, a box per 64 lanes (Cob
//   128 is two 64-lane blocks `kpos * 128` bytes apart), MN-major through
//   the transpose bit.  K (positions) pads to 16; the padding rows are
//   zeroed once and never written, positions outside the map land as TMA's
//   zeros.
// * Where TMA cannot take a stride (Cib or Cob not a multiple of 8, or a
//   box past 256 elements) the producer copies the same cells into the same
//   swizzled rows: 4-byte cp.async of channel pairs where the pencil is
//   even, 2-byte loads and stores where it is odd (Cib 3, Cb 3; Cob 6 and
//   125 take the pairs).
// * The narrow rows (`run_narrow`, the kernel wgrad_kernel_bf16_narrow;
//   narrow_rows.cuh), where a filter row's run of wf Cib values fits a
//   128-byte row at dilation 1 (Cib 3 at 11x11 and 3x3): an m-tile of 64
//   lanes is a group of r filter rows, (dh, dw, c) packed a run of Lp
//   lanes each (one m-tile, not one a tap: conv1's 121 become 11, VGG-16's
//   and MobileNet's 9 become 1), and its A is a 128-byte row a position of
//   the tile, built by the producer from the tile's input rows (staged by
//   16-byte copies a stage ahead into two raw buffers, their pads cleared),
//   read MN-major as the window is; positions run on across row breaks, so
//   any tile width takes it.  A CTA's `ntpg` groups each hold their own K
//   rows of the slot; B (dz) lands by TMA as above.  The rows past a run's
//   values, past the filter and K's padding are zeros: no NaN of a stale
//   slot meets a zero of B, and the rows past a group's runs are not stored.
//   One m-tile a warpgroup at 64 lanes (the first layers' Cob is 64 or
//   less; the wider instances spilled).
//
// A stage holds up to kMaxPositions positions in a ring of 2-4 slots (as
// many as fit); consumers wait on the slot's mbarrier, run every k16 step
// of each of their m-tiles into a fresh f32 accumulator (the tensor cores'
// adds truncate; a fresh accumulator a stage keeps that to the stage's own
// magnitude), add it into the m-tile's running f32 sum and release the slot.
// A CTA holds `wgs` consumer warpgroups of `mpw` m-tiles: `span` m-tiles of
// one half's taps, or, where span covers a half's taps, whole halves (1x1);
// `groups` CTAs cover the m-tiles.  At 128 lanes the running sum and the
// stage's accumulator take 128 registers a thread: two consumers at most
// (`max_threads`).  The workspace and its fold (split_sum.cuh) stay f32.
namespace bf16 {

using bf = __nv_bfloat16;

constexpr int kLanes = 64;              // channels (lanes) of a 128-byte row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;        // 8 rows: the swizzle's period
constexpr int kMaxPositions = 256;      // output positions of one stage
constexpr int kMaxSteps = kMaxPositions / 16;
constexpr int kUnroll = 4;              // k16 steps a pass of the issue loop
constexpr int kMaxSlots = 4;
constexpr int kMinSlots = 2;
// the slots' mbarriers and a flag, after the slots
constexpr int kTableBytes = 256;
// named barriers (0 is __syncthreads): slot s consumed, the producer's own
constexpr int kBarEmpty = 1;            // + s
constexpr int kBarProducer = kBarEmpty + kMaxSlots;

__host__ __device__ inline int kpos(const Geometry& g) {
  return ceil_div(g.th * g.tw, 16) * 16;
}

// threads of the largest CTA of the instance (N, MPW) (the launch bound)
__host__ __device__ constexpr int max_threads(int lanes, int mpw) {
  return kWarpgroup * ((lanes * mpw >= 128 ? 2 : kMaxConsumers) + 1);
}

__host__ __device__ inline int taps(const Geometry& g) {
  return g.hf * g.wf;
}
// 64-channel halves of the Ci block, and the m-tiles (half, tap)
__host__ __device__ inline int halves(const Geometry& g) {
  return ceil_div(g.cib, kLanes);
}
__host__ __device__ inline int mtiles(const Geometry& g) {
  return halves(g) * taps(g);
}
// column phases of the staged window (the stride's, or the filter's dilated
// reach where that is shorter), and cells of a phase's row
__host__ __device__ inline int phases(const Geometry& g) {
  const int reach = (g.wf - 1) * g.dil_w + 1;
  return g.stride < reach ? g.stride : reach;
}
__host__ __device__ inline int wph(const Geometry& g) {
  return g.tw + (g.wf - 1) * g.dil_w / g.stride;
}
// 1x1 at stride 1: the window is the tile, positions consecutive cells
__host__ __device__ inline bool flat(const Geometry& g) {
  return g.hf == 1 && g.wf == 1 && g.stride == 1;
}
// A CTA's m-tiles: taps a group (`tpg`, of one half), groups a half's taps
// take, halves a group, halves a CTA stages; groups
__host__ __device__ inline int tpg(const Geometry& g) {
  const int span = g.wgs * g.mpw;
  return span < taps(g) ? span : taps(g);
}
__host__ __device__ inline int gph(const Geometry& g) {
  return ceil_div(taps(g), tpg(g));
}
__host__ __device__ inline int hpg(const Geometry& g) {
  const int h = g.wgs * g.mpw / tpg(g);
  return h > 1 ? h : 1;
}
__host__ __device__ inline int staged(const Geometry& g) {
  return hpg(g) < halves(g) ? hpg(g) : halves(g);
}
__host__ __device__ inline int groups(const Geometry& g) {
  return ceil_div(halves(g), hpg(g)) * gph(g);
}

// bytes of one (half, phase) window: its cells (and the K padding's reads
// past a flat tile), 128 bytes each, in whole swizzle atoms
__host__ __device__ inline int region_bytes(const Geometry& g) {
  const int cells = hwin(g) * wph(g);
  const int padded = ceil_div(g.th * g.tw, 8) * 8;
  return ceil_div((cells > padded ? cells : padded) * kRowBytes, kAtomBytes)
         * kAtomBytes;
}
__host__ __device__ inline int x_bytes(const Geometry& g) {
  return staged(g) * phases(g) * region_bytes(g);
}
__host__ __device__ inline int b_bytes(const Geometry& g) {
  return g.lanes / kLanes * bf16::kpos(g) * kRowBytes;
}
__host__ __device__ inline int slot_bytes(const Geometry& g) {
  return x_bytes(g) + b_bytes(g);
}
// ring slots: as many as fit, up to kMaxSlots
__host__ __device__ inline int slots(const Geometry& g) {
  const int fit = (kSmemBlock - kAtomBytes - kTableBytes) / slot_bytes(g);
  return fit < kMaxSlots ? fit : kMaxSlots;
}
// x and dz arrive by TMA where their global strides are whole 16 bytes, x
// by element-strided boxes (a column phase's cells, each the stride on,
// within TMA's 256 elements and stride 8), else by the producer's copies
__host__ __device__ inline bool tma_x(const Geometry& g) {
  return g.cib % 8 == 0 && g.stride <= 8 && g.stride * wph(g) <= 256;
}
__host__ __device__ inline bool tma_d(const Geometry& g) {
  return g.cob % 8 == 0;
}

// The narrow rows (narrow_rows.cuh; `run_narrow`, the kernel
// wgrad_kernel_bf16_narrow): an m-tile is a group of filter rows (`nunits`
// of them), a CTA's `ntpg` groups' rows K rows of 128 bytes each, in place
// of the window, and two raw buffers of the tile's input rows after the
// slots (staged a stage ahead, read by the producer alone).  Functions of
// their own, so that the per-tap kernels' code is untouched by them.
__host__ __device__ inline bool narrow(const Geometry& g) {
  return g.narrow != 0;
}
__host__ __device__ inline int nunits(const Geometry& g) {
  return narrow_rows::groups(g.hf, g.wf, g.cib);
}
__host__ __device__ inline int ntpg(const Geometry& g) {
  const int span = g.wgs * g.mpw;
  return span < nunits(g) ? span : nunits(g);
}
__host__ __device__ inline int ngroups(const Geometry& g) {
  return ceil_div(nunits(g), ntpg(g));
}
__host__ __device__ inline int nslot_bytes(const Geometry& g) {
  return ntpg(g) * bf16::kpos(g) * kRowBytes + b_bytes(g);
}
__host__ __device__ inline int raw_slot_bytes(const Geometry& g) {
  return ceil_div(narrow_rows::raw_bytes(hwin(g), g.cib, wwin(g)), kRowBytes)
         * kRowBytes;
}
__host__ __device__ inline int nslots(const Geometry& g) {
  const int fit = (kSmemBlock - kAtomBytes - kTableBytes
                   - 2 * raw_slot_bytes(g)) / nslot_bytes(g);
  return fit < kMaxSlots ? fit : kMaxSlots;
}

// Dynamic shared memory of one CTA (core/blocking.py wgrad_smem_bytes at
// op_bytes 2): a swizzle atom to align the base, the slots (the narrow rows'
// raw buffers after them), the tables.
__host__ inline size_t smem_bytes(const Geometry& g) {
  if (narrow(g)) {
    return (size_t)kAtomBytes + (size_t)nslots(g) * nslot_bytes(g)
           + 2 * raw_slot_bytes(g) + kTableBytes;
  }
  return (size_t)kAtomBytes + (size_t)slots(g) * slot_bytes(g) + kTableBytes;
}

// wgrad_tile::plan at one bf16 product a MAC: K padded to 16, the
// (half, tap) m-tiles (the narrow rows' groups), every one of the wgmma's N
// lanes.
__host__ inline void plan(const Geometry& g, long long* out) {
  out[0] = tiles(g);
  out[1] = (long long)g.n * g.ho * g.wo * g.hf * g.wf * g.cib * cigblk(g)
           * g.cob * g.coblk;
  out[2] = (long long)cigblk(g) * g.coblk * tiles(g) * bf16::kpos(g)
           * (narrow(g) ? nunits(g) : bf16::mtiles(g)) * kRows * g.lanes;
  out[3] = (long long)bf16::smem_bytes(g);
}

// Whether the bf16 kernels take this geometry: dz alone (no z, no db), the
// compiled widths, 8 consecutive cells a position group (positions run on
// at 1x1 stride 1 and in the narrow rows), two slots; the narrow rows where
// a filter row's run fits a row and dz lands by TMA.
__host__ inline bool valid(const Geometry& g) {
  if (narrow(g) && !(narrow_rows::fits(g.hf, g.wf, g.cib, g.dil_h, g.dil_w)
                     && bf16::tma_d(g) && g.lanes == kLanes && g.mpw == 1
                     && nslots(g) >= kMinSlots)) {
    return false;
  }
  return valid_map(g) && g.n >= 1 && g.wgs >= 1 && g.mpw >= 1
         && g.prologue == 0
         && g.with_db == 0 && kWarpgroup * (g.wgs + 1)
                                  <= max_threads(g.lanes, g.mpw)
         && (g.lanes == 64 || g.lanes == 128) && g.lanes >= g.cob
         && g.lanes * g.mpw <= kWarpgroup && g.th >= 1 && g.tw >= 1
         && g.th * g.tw <= kMaxPositions
         && (flat(g) || narrow(g) || g.tw % 8 == 0)
         && g.stride >= 1 && wph(g) <= 256 && hwin(g) <= 256
         && g.splits >= 1 && g.splits <= tiles(g)
         && (narrow(g) || slots(g) >= kMinSlots);
}

// A wgmma operand in 128-byte swizzle: `lbo` bytes between 64-element
// blocks of the MN dimension, `sbo` between 8-row groups of K; the base
// offset 0 at any `addr` (the card swizzles by the address's own bits).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 accumulators, both
// operands MN-major in shared memory (transpose bits set); `scale_d` 0
// starts a fresh sum.  D's fragments as wgmma_bf16's.
template <int N>
__device__ void wgmma_tt(float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tt<64>(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tt<128>(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// The shared-memory carve-up of one CTA (smem_bytes): the slots from a
// 1024-byte aligned base (each slot its staged (half, phase) windows, then
// B's 64-lane blocks), then the step tables, the slots' mbarriers, a flag.
struct Smem {
  char* slot0;
  uint64_t* full;       // [kMaxSlots] slot s landed
  int* flag;
};

// Each k16 step's A offsets, in bytes: its first 8 positions' first cell
// and the distance to its second 8 positions' (0 past the tile, where B is
// zero).  Built by the host (`steps_of`) and passed as a kernel parameter,
// so that every wgmma's descriptor is a uniform value: a table in shared
// memory is read per thread, and the compiler then waits for each wgmma
// to finish before it builds the next one's descriptor.
struct Steps {
  int off[kMaxSteps];
  int sbo[kMaxSteps];
};

__host__ inline Steps steps_of(const Geometry& g) {
  Steps st = {};
  // the narrow rows: a row a position, in the tile's order
  auto cell = [&](int p) {
    return narrow(g) ? p : (p / g.tw) * g.stride * wph(g) + p % g.tw;
  };
  for (int j = 0; j < bf16::kpos(g) / 16; ++j) {
    st.off[j] = cell(16 * j) * kRowBytes;
    st.sbo[j] = 16 * j + 8 < g.th * g.tw
                    ? (cell(16 * j + 8) - cell(16 * j)) * kRowBytes
                    : 0;
  }
  return st;
}

__device__ inline Smem carve(char* raw, const Geometry& g) {
  Smem m;
  m.slot0 = raw + ((kAtomBytes - (dt::smem_u32(raw) & (kAtomBytes - 1)))
                   & (kAtomBytes - 1));
  m.full = reinterpret_cast<uint64_t*>(m.slot0
                                       + (size_t)slots(g) * slot_bytes(g));
  m.flag = reinterpret_cast<int*>(m.full + kMaxSlots);
  return m;
}

// The narrow rows' carve-up: the slots, the two raw buffers, the slots'
// mbarriers and the flag.
struct NarrowSmem {
  char* slot0;
  char* raw;            // [2] raw buffers of raw_slot_bytes
  uint64_t* full;       // [kMaxSlots] slot s landed
  int* flag;
};

__device__ inline NarrowSmem ncarve(char* raw, const Geometry& g) {
  NarrowSmem m;
  m.slot0 = raw + ((kAtomBytes - (dt::smem_u32(raw) & (kAtomBytes - 1)))
                   & (kAtomBytes - 1));
  m.raw = m.slot0 + (size_t)nslots(g) * nslot_bytes(g);
  m.full = reinterpret_cast<uint64_t*>(m.raw + 2 * raw_slot_bytes(g));
  m.flag = reinterpret_cast<int*>(m.full + kMaxSlots);
  return m;
}

// The byte offset of lane `c` of row `row` in a swizzled block whose base
// is on an atom: 16-byte chunk c / 8 of the row, XORed with the row's place
// in its atom, as TMA's 128-byte swizzle lands it.
__device__ __forceinline__ int swizzled(int row, int c) {
  return row * kRowBytes + ((((c >> 3) ^ row) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One 64-lane block of cells by the producer's threads (`tid` of
// kWarpgroup) where TMA cannot take it: `count` rows, row i at global cell
// `src(i)` (null: outside the map, zeros), `lanes` lanes each (the rest of
// the row stays the zeros it was set to), pairs by cp.async where `pairs`
// (`any`, a global address for the copies that read nothing).
template <typename Src>
__device__ void copy_rows(char* dst, int count, int lanes, bool pairs,
                          Src src, const unsigned short* any, int tid) {
  if (pairs) {
    const int per = ceil_div(lanes, 2);
    for (int i = tid; i < count * per; i += kWarpgroup) {
      const int r = i / per;
      const int c = (i - r * per) * 2;
      const unsigned short* s = src(r);
      cp_async4(dst + swizzled(r, c), s != nullptr ? s + c : any,
                s != nullptr);
    }
    return;
  }
  // 2-byte lanes: kBatch loads in flight a thread before their stores
  constexpr int kBatch = 8;
  for (int i0 = tid; i0 < count * lanes; i0 += kBatch * kWarpgroup) {
    unsigned short v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kWarpgroup;
      const int r = i / lanes;
      const unsigned short* s = i < count * lanes ? src(r) : nullptr;
      v[k] = s != nullptr ? __ldg(s + (i - r * lanes)) : (unsigned short)0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kWarpgroup;
      if (i < count * lanes) {
        const int r = i / lanes;
        *reinterpret_cast<unsigned short*>(dst + swizzled(r, i - r * lanes))
            = v[k];
      }
    }
  }
}

// Stage s of tile `t` into its slot (`tid` of the producer's kWarpgroup
// threads): the CTA's `nh` halves from `h0` of x's block `x_b`, each in
// every phase, then B's 64-lane blocks, by TMA onto the slot's mbarrier where the strides allow
// and by copies otherwise; the mbarrier completes once everything landed.
__device__ void issue(const Smem& m, const CUtensorMap* tmx,
                      const CUtensorMap* tmd, const bf* __restrict__ x,
                      const bf* __restrict__ dz, const Geometry& g,
                      const Tile& t, int slot, int x_b, int co_b, int h0,
                      int nh, int tid) {
  char* xs = m.slot0 + (size_t)slot * slot_bytes(g);
  char* bs = xs + x_bytes(g);
  uint64_t* bar = m.full + slot;
  const int np = phases(g);
  const int cells = wph(g);
  const int hw = hwin(g);
  const int ih0 = t.oh0 * g.stride - g.pad_top;
  const int iw0 = t.ow0 * g.stride - g.pad_left;
  const int bh = g.lanes / kLanes;
  if (tid == 0) {
    dt::mbar_expect_tx(
        bar, (bf16::tma_x(g) ? nh * np * hw * cells * kRowBytes : 0)
                 + (bf16::tma_d(g) ? bh * g.th * g.tw * kRowBytes : 0));
    if (bf16::tma_x(g)) {
      for (int h = 0; h < nh; ++h) {
        for (int ph = 0; ph < np; ++ph) {
          // phase ph: the cells iw0 + ph, iw0 + ph + s, ... (a box that
          // steps s along W; negative columns land as zeros)
          dt::tma_load_4d(xs + (h * np + ph) * region_bytes(g), tmx, bar,
                          kLanes * (h0 + h), iw0 + ph, ih0,
                          t.n * g.ciblk + x_b);
        }
      }
    }
    if (bf16::tma_d(g)) {
      for (int b = 0; b < bh; ++b) {
        dt::tma_load_5d(bs + b * bf16::kpos(g) * kRowBytes, tmd, bar,
                        kLanes * b, t.ow0, t.oh0, co_b, t.n);
      }
    }
  }
  if (bf16::tma_x(g) && bf16::tma_d(g)) return;
  if (!bf16::tma_x(g)) {
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x)
        + (size_t)(t.n * g.ciblk + x_b) * g.hi * g.wi * g.cib;
    for (int h = 0; h < nh; ++h) {
      const int c0 = kLanes * (h0 + h);
      const int lanes = min(kLanes, g.cib - c0);
      for (int ph = 0; ph < np; ++ph) {
        copy_rows(xs + (h * np + ph) * region_bytes(g), hw * cells, lanes,
                  g.cib % 2 == 0,
                  [&](int r) -> const unsigned short* {
                    const int ih = ih0 + r / cells;
                    const int iw = iw0 + ph + g.stride * (r % cells);
                    return ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi
                               ? xb + ((size_t)ih * g.wi + iw) * g.cib + c0
                               : nullptr;
                  },
                  xb, tid);
      }
    }
  }
  if (!bf16::tma_d(g)) {
    const unsigned short* db = reinterpret_cast<const unsigned short*>(dz)
        + (size_t)(t.n * g.coblk + co_b) * g.ho * g.wo * g.cob;
    for (int b = 0; b < bh; ++b) {
      const int c0 = kLanes * b;
      copy_rows(bs + b * bf16::kpos(g) * kRowBytes, g.th * g.tw,
                min(kLanes, g.cob - c0), g.cob % 2 == 0,
                [&](int p) -> const unsigned short* {
                  const int oh = t.oh0 + p / g.tw;
                  const int ow = t.ow0 + p % g.tw;
                  return oh < g.ho && ow < g.wo
                             ? db + ((size_t)oh * g.wo + ow) * g.cob + c0
                             : nullptr;
                },
                db, tid);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  dt::fence_proxy_async();                  // the copies, for wgmma
  dt::bar_sync(kBarProducer, kWarpgroup);
  if (tid == 0) dt::mbar_expect_tx(bar, 0);   // the copies' arrival
}

// The producer warpgroup: every stage of the CTA's share into the ring, a
// slot once the consumers have released it.
__device__ void produce(const Smem& m, const CUtensorMap* tmx,
                        const CUtensorMap* tmd, const bf* __restrict__ x,
                        const bf* __restrict__ dz, const Geometry& g,
                        long long first, int stages, int ci_b, int co_b,
                        int h0, int nh) {
  const int tid = threadIdx.x - g.wgs * kWarpgroup;
  const int ns = slots(g);
  for (int s = 0; s < stages; ++s) {
    const int slot = s % ns;
    if (s >= ns) dt::bar_sync(kBarEmpty + slot, blockDim.x);
    issue(m, tmx, tmd, x, dz, g, tile_of(g, first + s), slot,
          x_block(g, co_b, ci_b), co_b, h0, nh, tid);
  }
}

// The narrow rows' producer (narrow_rows.cuh): a stage ahead, the tile's
// input rows into a raw buffer by 16-byte copies; for each stage, once the
// consumers have freed its slot, the dz boxes by TMA onto the slot's
// mbarrier, then each of the CTA's groups' rows built from the raw rows
// into the slot, one 128-byte row a position, and the mbarrier's second
// arrival.
__device__ void produce_narrow(const NarrowSmem& m, const CUtensorMap* tmd,
                               const bf* __restrict__ x, const Geometry& g,
                               long long first, int stages, int ci_b,
                               int co_b, int group) {
  const int tid = threadIdx.x - g.wgs * kWarpgroup;
  const int ns = nslots(g);
  const int hw = hwin(g), ww = wwin(g);
  const int rb = raw_slot_bytes(g);
  const int bh = g.lanes / kLanes;
  const int x_b = x_block(g, co_b, ci_b);
  const int u0 = group * ntpg(g);
  const int nu = min(ntpg(g), nunits(g) - u0);
  const int xb = ntpg(g) * bf16::kpos(g) * kRowBytes;   // the rows' bytes
  auto stage_raw = [&](int s) {
    const Tile t = tile_of(g, first + s);
    narrow_rows::stage(m.raw + (s & 1) * rb,
                       x + (size_t)(t.n * g.ciblk + x_b) * g.hi * g.wi
                               * g.cib,
                       g.hi, g.wi, g.cib, t.oh0 * g.stride - g.pad_top,
                       t.ow0 * g.stride - g.pad_left, hw, ww, tid);
    narrow_rows::cp_async_commit();
  };
  if (stages > 0) stage_raw(0);
  for (int s = 0; s < stages; ++s) {
    const int slot = s % ns;
    if (s >= ns) dt::bar_sync(kBarEmpty + slot, blockDim.x);
    char* xs = m.slot0 + (size_t)slot * nslot_bytes(g);
    uint64_t* bar = m.full + slot;
    const Tile t = tile_of(g, first + s);
    if (tid == 0) {
      dt::mbar_expect_tx(bar, bh * g.th * g.tw * kRowBytes);
      for (int b = 0; b < bh; ++b) {
        dt::tma_load_5d(xs + xb + b * bf16::kpos(g) * kRowBytes, tmd,
                        bar, kLanes * b, t.ow0, t.oh0, co_b, t.n);
      }
    }
    // the next stage's rows in flight while this one's are built
    if (s + 1 < stages) {
      stage_raw(s + 1);
      narrow_rows::cp_async_wait(1);
    } else {
      narrow_rows::cp_async_wait(0);
    }
    dt::bar_sync(kBarProducer, kWarpgroup);     // stage s's raw rows landed
    narrow_rows::clear(m.raw + (s & 1) * rb, hw, ww, g.cib, tid);
    dt::bar_sync(kBarProducer, kWarpgroup);
    for (int u = 0; u < nu; ++u) {
      narrow_rows::build(dt::smem_u32(xs) + u * bf16::kpos(g) * kRowBytes,
                         m.raw + (s & 1) * rb, hw, ww, g.cib, g.stride, g.hf,
                         g.wf, u0 + u, g.tw, g.th * g.tw, tid);
    }
    dt::fence_proxy_async();                    // the rows, for wgmma
    dt::bar_sync(kBarProducer, kWarpgroup);
    if (tid == 0) dt::mbar_expect_tx(bar, 0);   // the rows' arrival
  }
}

// Store a consumer's m-tiles into its share's workspace row: m-tile t is
// (half hh[t], tap tp[t]); its row 16 * warp + lane / 4 (+ 8) is channel
// 64 * hh + row of that tap, stored where it is < Cib, lanes < Cob.
template <int N, int MPW>
__device__ void store_dw(float* __restrict__ row,
                         const float (&acc)[MPW][N / 2], const Geometry& g,
                         int ci_b, int co_b, const bool (&on)[MPW],
                         const int (&hh)[MPW], const int (&tp)[MPW]) {
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
    if (!on[t]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = kLanes * hh[t] + threadIdx.x % kWarpgroup / 32 * 16
                    + lane / 4 + 8 * h;
      if (c >= g.cib) continue;
      float* out = row + (((size_t)dw_block(g, co_b, ci_b) * taps(g) + tp[t])
                          * g.cib + c) * g.cob;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + col0;
        if (col < g.cob) out[col] = acc[t][4 * jj + 2 * h];
        if (col + 1 < g.cob) out[col + 1] = acc[t][4 * jj + 2 * h + 1];
      }
    }
  }
}

// store_dw for the narrow rows: m-tile t is group un[t], whose row m (16 *
// warp + lane / 4, + 8) is value e = m % Lp of run k = m / Lp, row (un[t] r
// + k) L + e of the block's (tap, c) rows, (dh wf + dw) Cib + c; stored
// where e < L and the filter has the row.
template <int N, int MPW>
__device__ void store_dw_narrow(float* __restrict__ row,
                                const float (&acc)[MPW][N / 2],
                                const Geometry& g, int ci_b, int co_b,
                                const bool (&on)[MPW], const int (&un)[MPW]) {
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  const int L = narrow_rows::run_values(g.wf, g.cib);
  const int Lp = narrow_rows::run_pad(g.wf, g.cib);
  const int per = narrow_rows::rows_a_group(g.hf, g.wf, g.cib);
  const int rows = taps(g) * g.cib;
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
    if (!on[t]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mr = threadIdx.x % kWarpgroup / 32 * 16 + lane / 4 + 8 * h;
      const int k = mr / Lp;
      const int e = mr - k * Lp;
      const int r = (un[t] * per + k) * L + e;
      if (k >= per || e >= L || r >= rows) continue;
      float* out = row + ((size_t)dw_block(g, co_b, ci_b) * rows + r) * g.cob;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + col0;
        if (col < g.cob) out[col] = acc[t][4 * jj + 2 * h];
        if (col + 1 < g.cob) out[col + 1] = acc[t][4 * jj + 2 * h + 1];
      }
    }
  }
}

// The consumer warpgroups of `run`: each stage's k16 steps of every m-tile
// into a fresh accumulator (all of the warpgroup's m-tiles issued before
// the first wait), added into the running sums; then the sums into the
// share's workspace row.  Every descriptor is built from uniform values
// (the slot, `st`, the warpgroup's index read warp-uniform), so the
// wgmmas of a stage issue back to back.
template <int N, int MPW>
__device__ __forceinline__ void consume(const Smem& m, const Geometry& g,
                                        const Steps& st, int group,
                                        int stages, float* row, int ci_b,
                                        int co_b) {
  const int ns = slots(g);
  const int np = phases(g);
  const int steps = bf16::kpos(g) / 16;
  const int first = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0)
                    * MPW;
  bool on[MPW];
  int hh[MPW], tp[MPW];
  uint32_t abase[MPW];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
    const int i = first + t;
    const int lh = i / tpg(g);
    hh[t] = group / gph(g) * hpg(g) + lh;
    tp[t] = group % gph(g) * tpg(g) + i % tpg(g);
    on[t] = lh < hpg(g) && hh[t] < halves(g) && tp[t] < taps(g);
    // tap (dh, dw) reads column phase (dw dil_w) % s from cell (dw dil_w)
    // / s of window row dh dil_h
    const int dh = tp[t] / g.wf;
    const int col = (tp[t] - dh * g.wf) * g.dil_w;
    abase[t] = (lh * np + col % g.stride) * region_bytes(g)
               + (dh * g.dil_h * wph(g) + col / g.stride) * kRowBytes;
  }
  float total[MPW][N / 2];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[t][i] = 0.0f;
  }
  const uint32_t lbo = bf16::kpos(g) * kRowBytes;     // B's second 64 lanes
  for (int s = 0; s < stages; ++s) {
    const int slot = s % ns;
    const uint32_t xs = dt::smem_u32(m.slot0) + slot * slot_bytes(g);
    const uint32_t bs = xs + x_bytes(g);
    dt::mbar_wait(m.full + slot, s / ns & 1);
    float acc[MPW][N / 2];
    dt::wgmma_fence();
#pragma unroll
    for (int t = 0; t < MPW; ++t) {
      if (!on[t]) continue;
      // kUnroll steps a pass of straight-line wgmmas (a pass of all of
      // them spilled the 128-lane instance's registers)
      for (int j0 = 0; j0 < steps; j0 += kUnroll) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int j = j0 + k;
          if (j < steps) {
            wgmma_tt<N>(acc[t],
                        sw128_desc(xs + abase[t] + st.off[j], 16,
                                   st.sbo[j]),
                        sw128_desc(bs + j * 16 * kRowBytes, lbo,
                                   kAtomBytes),
                        j > 0);
          }
        }
      }
      dt::wgmma_commit();
    }
    dt::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MPW; ++t) {
      if (!on[t]) continue;
      dt::fence_regs<N / 2>(acc[t]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) total[t][i] += acc[t][i];
    }
    if (s + ns < stages) dt::bar_arrive(kBarEmpty + slot, blockDim.x);
  }
  store_dw<N, MPW>(row, total, g, ci_b, co_b, on, hh, tp);
}

// The consumers of `run_narrow`: consume's walk on the narrow rows, m-tile
// t of the warpgroup group u = group * ntpg + first + t of filter rows,
// whose A is its own kpos rows of the slot, read from position 0 on.
template <int N, int MPW>
__device__ __forceinline__ void consume_narrow(const NarrowSmem& m,
                                               const Geometry& g,
                                               const Steps& st, int group,
                                               int stages, float* row,
                                               int ci_b, int co_b) {
  const int ns = nslots(g);
  const int steps = bf16::kpos(g) / 16;
  const int first = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0)
                    * MPW;
  bool on[MPW];
  int un[MPW];
  uint32_t abase[MPW];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
    const int i = first + t;
    un[t] = group * ntpg(g) + i;
    on[t] = i < ntpg(g) && un[t] < nunits(g);
    abase[t] = i * bf16::kpos(g) * kRowBytes;
  }
  float total[MPW][N / 2];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[t][i] = 0.0f;
  }
  const uint32_t lbo = bf16::kpos(g) * kRowBytes;     // B's second 64 lanes
  for (int s = 0; s < stages; ++s) {
    const int slot = s % ns;
    const uint32_t xs = dt::smem_u32(m.slot0) + slot * nslot_bytes(g);
    const uint32_t bs = xs + ntpg(g) * bf16::kpos(g) * kRowBytes;
    dt::mbar_wait(m.full + slot, s / ns & 1);
    float acc[MPW][N / 2];
    dt::wgmma_fence();
#pragma unroll
    for (int t = 0; t < MPW; ++t) {
      if (!on[t]) continue;
      for (int j0 = 0; j0 < steps; j0 += kUnroll) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int j = j0 + k;
          if (j < steps) {
            wgmma_tt<N>(
                acc[t], sw128_desc(xs + abase[t] + st.off[j], 16, st.sbo[j]),
                sw128_desc(bs + j * 16 * kRowBytes, lbo, kAtomBytes), j > 0);
          }
        }
      }
      dt::wgmma_commit();
    }
    dt::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MPW; ++t) {
      if (!on[t]) continue;
      dt::fence_regs<N / 2>(acc[t]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) total[t][i] += acc[t][i];
    }
    if (s + ns < stages) dt::bar_arrive(kBarEmpty + slot, blockDim.x);
  }
  store_dw_narrow<N, MPW>(row, total, g, ci_b, co_b, on, un);
}

// One CTA: m-tile group blockIdx.x % groups, share blockIdx.x / groups, Ci
// block blockIdx.y, Co block blockIdx.z; its sums go to its share's row of
// the f32 `ws` ([splits, |dw|]); the column's last CTA sums the rows of
// each of its (tap, half) blocks into `out`.
template <int N, int MPW>
__device__ void run(char* smem, const CUtensorMap* tmx,
                    const CUtensorMap* tmd, const bf* __restrict__ x,
                    const bf* __restrict__ dz, float* ws, float* out,
                    int* counters, const Geometry& geo, const Steps& st) {
  const int ngroups = bf16::groups(geo);
  const int group = blockIdx.x % ngroups;
  const int split = blockIdx.x / ngroups;
  const int ci_b = blockIdx.y;
  const int co_b = blockIdx.z;
  const long long total = tiles(geo);
  const long long first = total * split / geo.splits;
  const int stages = (int)(total * (split + 1) / geo.splits - first);
  const int nth = blockDim.x;
  const Smem m = carve(smem, geo);
  const int h0 = group / gph(geo) * hpg(geo);
  const int nh = min(hpg(geo), halves(geo) - h0);
  // the slots zeroed once: K's padding rows, the rows past Cib and Cob
  {
    uint4* p = reinterpret_cast<uint4*>(m.slot0);
    const int n16 = slots(geo) * slot_bytes(geo) / 16;
    for (int i = threadIdx.x; i < n16; i += nth) p[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxSlots; ++i) {
      dt::mbar_init(m.full + i,
                    bf16::tma_x(geo) && bf16::tma_d(geo) ? 1 : 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  dt::fence_proxy_async();      // the zeros, before TMA and wgmma see them
  __syncthreads();
  const size_t dw_size = (size_t)geo.coblk * cigblk(geo) * taps(geo)
                         * geo.cib * geo.cob;
  float* row = ws + (size_t)split * dw_size;

  if (threadIdx.x >= geo.wgs * kWarpgroup) {
    produce(m, tmx, tmd, x, dz, geo, first, stages, ci_b, co_b, h0, nh);
  } else {
    consume<N, MPW>(m, geo, st, group, stages, row, ci_b, co_b);
  }

  const int column = dw_block(geo, co_b, ci_b) * ngroups + group;
  if (!split_sum::arrive(counters + column, geo.splits, m.flag, 0, nth,
                         threadIdx.x == 0)) {
    return;
  }
  // the group's (half, tap) blocks, each a run of (tap, c) rows
  const int t0 = group % gph(geo) * tpg(geo);
  for (int h = h0; h < h0 + nh; ++h) {
    for (int tp = t0; tp < min(t0 + tpg(geo), taps(geo)); ++tp) {
      const size_t base = (((size_t)dw_block(geo, co_b, ci_b) * taps(geo)
                            + tp) * geo.cib + kLanes * h) * geo.cob;
      split_sum::sum_rows(ws + base, dw_size, geo.splits, out + base,
                          min(kLanes, geo.cib - kLanes * h) * geo.cob, 1.0f,
                          threadIdx.x, nth);
    }
  }
}

// `run` on the narrow rows (the kernel `wgrad_kernel_bf16_narrow`): the
// same grid, shares, ring and fold, an m-tile a group of filter rows whose
// operand rows the producer builds (produce_narrow); the column's last CTA
// sums its groups' rows, one run of (tap, c) rows.
template <int N, int MPW>
__device__ void run_narrow(char* smem, const CUtensorMap* tmd,
                           const bf* __restrict__ x,
                           float* ws, float* out, int* counters,
                           const Geometry& geo, const Steps& st) {
  const int cgroups = ngroups(geo);
  const int group = blockIdx.x % cgroups;
  const int split = blockIdx.x / cgroups;
  const int ci_b = blockIdx.y;
  const int co_b = blockIdx.z;
  const long long total = tiles(geo);
  const long long first = total * split / geo.splits;
  const int stages = (int)(total * (split + 1) / geo.splits - first);
  const int nth = blockDim.x;
  const NarrowSmem m = ncarve(smem, geo);
  // the slots zeroed once: the rows past a row's values, K's padding
  {
    uint4* p = reinterpret_cast<uint4*>(m.slot0);
    const int n16 = nslots(geo) * nslot_bytes(geo) / 16;
    for (int i = threadIdx.x; i < n16; i += nth) p[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxSlots; ++i) dt::mbar_init(m.full + i, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  dt::fence_proxy_async();      // the zeros, before TMA and wgmma see them
  __syncthreads();
  const size_t dw_size = (size_t)geo.coblk * cigblk(geo) * taps(geo)
                         * geo.cib * geo.cob;
  float* row = ws + (size_t)split * dw_size;

  if (threadIdx.x >= geo.wgs * kWarpgroup) {
    produce_narrow(m, tmd, x, geo, first, stages, ci_b, co_b, group);
  } else {
    consume_narrow<N, MPW>(m, geo, st, group, stages, row, ci_b, co_b);
  }

  const int column = dw_block(geo, co_b, ci_b) * cgroups + group;
  if (!split_sum::arrive(counters + column, geo.splits, m.flag, 0, nth,
                         threadIdx.x == 0)) {
    return;
  }
  // the groups' rows: one run of the block's (tap, c) rows
  const int per = narrow_rows::values(geo.hf, geo.wf, geo.cib);
  const int rows = taps(geo) * geo.cib;
  const int r0 = group * ntpg(geo) * per;
  const int r1 = min(r0 + ntpg(geo) * per, rows);
  const size_t base = ((size_t)dw_block(geo, co_b, ci_b) * rows + r0)
                      * geo.cob;
  split_sum::sum_rows(ws + base, dw_size, geo.splits, out + base,
                      (r1 - r0) * geo.cob, 1.0f, threadIdx.x, nth);
}

// A one-tap unit of the tile (the launch `direct_conv2d_wgrad_bf16_probe`
// makes): x [64][64] and d [16][64] bf16 land by TMA in the swizzle, and one
// wgmma reads A from row `shift` of x with its second 8 rows `gap` rows on,
// B from d: out[c][l] = sum_k<8 x[shift + k][c] d[k][l] + x[shift + gap +
// k][c] d[8 + k][l], f32 [64][64].  One warpgroup.
__device__ void probe(char* smem, const CUtensorMap* tmx,
                      const CUtensorMap* tmd, float* out, int shift,
                      int gap) {
  char* base = smem + ((kAtomBytes - (dt::smem_u32(smem) & (kAtomBytes - 1)))
                       & (kAtomBytes - 1));
  char* xs = base;
  char* ds = base + 64 * kRowBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ds + 16 * kRowBytes);
  if (threadIdx.x == 0) {
    dt::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    dt::mbar_expect_tx(bar, 80 * kRowBytes);
    dt::tma_load_5d(xs, tmx, bar, 0, 0, 0, 0, 0);
    dt::tma_load_5d(ds, tmd, bar, 0, 0, 0, 0, 0);
  }
  dt::mbar_wait(bar, 0);
  float acc[32];
  dt::wgmma_fence();
  wgmma_tt<64>(acc,
               sw128_desc(dt::smem_u32(xs) + shift * kRowBytes, 16,
                          gap * kRowBytes),
               sw128_desc(dt::smem_u32(ds), 16 * kRowBytes, kAtomBytes), 0);
  dt::wgmma_commit();
  dt::wgmma_wait<0>();
  dt::fence_regs<32>(acc);
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / 32 * 16 + lane / 4;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = out + (r + 8 * h) * 64 + 8 * jj + 2 * (lane % 4);
      o[0] = acc[4 * jj + 2 * h];
      o[1] = acc[4 * jj + 2 * h + 1];
    }
  }
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const float*, const float*,
                        const float*, float*, float*, int*, Geometry);

// Internal to each library that includes it (the launch too), as
// fwd_tile.cuh's host helpers: a function-local cache in an inline function
// that two loaded libraries export would bind both to one copy.
namespace {

constexpr int kMaxDevices = 64;
// (wgmma width, m-tiles a warpgroup) of the f32 build, of the bf16 one, then
// of the bf16 narrow rows' (kernels of their own)
constexpr int kInstances = 30;

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device),
// so that a launch at a shape seen before sets nothing; the instance is
// named by its build (`bf16`), width and m-tiles.
inline cudaError_t allow_smem(const void* kernel, const Geometry& g,
                              int device, int bytes, bool bf16 = false) {
  int slot = g.mpw - 1 + (bf16 ? (g.narrow ? 20 : 10) : 0);
  for (int l = g.lanes; l > 8; l /= 2) slot += 2;
  if (device >= kMaxDevices || slot >= kInstances) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  static int allowed[kMaxDevices][kInstances];
  int& have = allowed[device][slot];
  if (bytes <= have) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// Whether the kernels take this geometry.
__host__ inline bool valid(const Geometry& g) {
  return valid_map(g) && g.n >= 1 && g.wgs >= 1 && g.wgs <= kMaxConsumers
         && g.mpw >= 1
         && g.lanes >= g.cob && g.lanes * g.mpw <= kWarpgroup
         && g.th >= 1 && g.tw >= 1 && g.th * g.tw <= kMaxPositions
         && g.stride >= 1 && g.splits >= 1 && g.splits <= tiles(g)
         && smem_bytes(g) <= (size_t)kSmemBlock;
}

// Check the launch, encode its tensor maps (x as [N, Ci/Cib, Hi, Wi, Cib]
// with a box of one window row, `ld` channels a cell; g and z as [N,
// Co/Cob, Ho, Wo, Cob] with a box of the tile), size its shared memory and
// launch (groups * splits, Cig/Cib, Co/Cob) CTAs of `wgs` consumer
// warpgroups and the producer.
inline int launch(Kernel kernel, const float* x, const float* g,
                  const float* z, float* ws, float* out, int* counters,
                  const Geometry& geo, cudaStream_t stream) {
  if (kernel == nullptr || !valid(geo)
      || (geo.prologue != 0) != (z != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread (autograd runs the backward on a thread of its own)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx = {}, tmg = {}, tmz = {};
  if (tma_x(geo)) {
    const long long cib = geo.cib;
    const long long dims[5] = {cib, geo.wi, geo.hi, geo.ciblk, geo.n};
    const long long str[4] = {cib * 4, geo.wi * cib * 4,
                              (long long)geo.hi * geo.wi * cib * 4,
                              (long long)geo.ciblk * geo.hi * geo.wi * cib
                                  * 4};
    const int box[5] = {x_ld(geo.cib, geo.stride), box_cells(geo), 1, 1, 1};
    if (!dt::encode(&tmx, x, 5, dims, str, box))
      return (int)cudaErrorNotSupported;   // the encoder refused the map
  }
  if (tma_d(geo)) {
    const long long cob = geo.cob;
    const long long dims[5] = {cob, geo.wo, geo.ho, geo.coblk, geo.n};
    const long long str[4] = {cob * 4, geo.wo * cob * 4,
                              (long long)geo.ho * geo.wo * cob * 4,
                              (long long)geo.coblk * geo.ho * geo.wo * cob
                                  * 4};
    const int box[5] = {geo.cob, geo.tw, geo.th, 1, 1};
    if (!dt::encode(&tmg, g, 5, dims, str, box)
        || (z != nullptr && !dt::encode(&tmz, z, 5, dims, str, box)))
      return (int)cudaErrorNotSupported;
  }
  const size_t smem = smem_bytes(geo);
  err = allow_smem((const void*)kernel, geo, device, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(groups(geo) * geo.splits, cigblk(geo), geo.coblk);
  kernel<<<grid, kWarpgroup * (geo.wgs + 1), smem, stream>>>(
      tmx, tmg, tmz, x, g, z, ws, out, counters, geo);
  return (int)cudaGetLastError();
}

using KernelBf16 = void (*)(const CUtensorMap, const CUtensorMap,
                            const __nv_bfloat16*, const __nv_bfloat16*,
                            float*, float*, int*, Geometry, bf16::Steps);

// Whether the bf16 kernels take this geometry.
__host__ inline bool valid_bf16(const Geometry& g) {
  return bf16::valid(g);
}

// A bf16 tensor map over 5 indices, innermost first: `dims`, byte
// `strides` of indices 1.., `box`; 128-byte swizzle, zeros outside the
// bounds (negative coordinates included).
inline bool encode_sw128(CUtensorMap* map, const void* base,
                         const long long* dims, const long long* strides,
                         const int* box) {
  const dt::EncodeTiled fn = dt::encoder();
  if (!fn) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  for (int i = 0; i < 5; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    gbox[i] = (cuuint32_t)box[i];
    estride[i] = 1;
  }
  for (int i = 0; i < 4; ++i) gstride[i] = (cuuint64_t)strides[i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// launch for the bf16 build on dz (no z, no db): x as [N * Ci/Cib, Hi, Wi,
// Cib] (a box a (64-channel half, phase): 64 channels, the phase's wph cells
// of each window row, traversing W at element stride s, so any width
// takes it), dz as [N, Co/Cob, Ho, Wo, Cob] (a box a 64-lane block of the
// tile), both 128-byte swizzled; the f32 workspace and sums.  The narrow
// rows read x by the producer's copies (its tensor on 16 bytes).
inline int launch_bf16(KernelBf16 kernel, const __nv_bfloat16* x,
                       const __nv_bfloat16* dz, float* ws, float* out,
                       int* counters, const Geometry& geo,
                       cudaStream_t stream) {
  if (kernel == nullptr || !valid_bf16(geo)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx = {}, tmd = {};
  if (bf16::narrow(geo) && reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (!bf16::narrow(geo) && bf16::tma_x(geo)) {
    const long long cib = geo.cib;
    const long long dims[4] = {cib, geo.wi, geo.hi,
                               (long long)geo.n * geo.ciblk};
    const long long str[3] = {cib * 2, geo.wi * cib * 2,
                              (long long)geo.hi * geo.wi * cib * 2};
    const int box[4] = {bf16::kLanes, geo.stride * bf16::wph(geo),
                        hwin(geo), 1};
    const int steps[4] = {1, geo.stride, 1, 1};
    if (!dt::bf16::encode_swizzled(&tmx, x, 4, dims, str, box, 128, steps))
      return (int)cudaErrorNotSupported;   // the encoder refused the map
  }
  if (bf16::tma_d(geo)) {
    const long long cob = geo.cob;
    const long long dims[5] = {cob, geo.wo, geo.ho, geo.coblk, geo.n};
    const long long str[4] = {cob * 2, geo.wo * cob * 2,
                              (long long)geo.ho * geo.wo * cob * 2,
                              (long long)geo.coblk * geo.ho * geo.wo * cob
                                  * 2};
    const int box[5] = {bf16::kLanes, geo.tw, geo.th, 1, 1};
    if (!encode_sw128(&tmd, dz, dims, str, box))
      return (int)cudaErrorNotSupported;
  }
  const size_t smem = bf16::smem_bytes(geo);
  err = allow_smem((const void*)kernel, geo, device, (int)smem, true);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((bf16::narrow(geo) ? bf16::ngroups(geo)
                                     : bf16::groups(geo)) * geo.splits,
                  cigblk(geo), geo.coblk);
  kernel<<<grid, kWarpgroup * (geo.wgs + 1), smem, stream>>>(
      tmx, tmd, x, dz, ws, out, counters, geo, bf16::steps_of(geo));
  return (int)cudaGetLastError();
}

using ProbeKernel = void (*)(const CUtensorMap, const CUtensorMap, float*,
                             int, int);

// The one-tap unit launch (bf16::probe): x [64][64] and d [16][64] bf16,
// out [64][64] f32; 0 <= shift, 8 <= gap, shift + gap + 8 <= 64.
inline int launch_probe(ProbeKernel kernel, const __nv_bfloat16* x,
                        const __nv_bfloat16* d, float* out, int shift,
                        int gap, cudaStream_t stream) {
  if (shift < 0 || gap < 8 || shift + gap + 8 > 64)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx = {}, tmd = {};
  const long long xdims[5] = {64, 64, 1, 1, 1};
  const long long ddims[5] = {64, 16, 1, 1, 1};
  const long long xstr[4] = {128, 64 * 128, 64 * 128, 64 * 128};
  const long long dstr[4] = {128, 16 * 128, 16 * 128, 16 * 128};
  const int xbox[5] = {64, 64, 1, 1, 1};
  const int dbox[5] = {64, 16, 1, 1, 1};
  if (!encode_sw128(&tmx, x, xdims, xstr, xbox)
      || !encode_sw128(&tmd, d, ddims, dstr, dbox))
    return (int)cudaErrorNotSupported;
  const int smem = 2 * bf16::kAtomBytes + 80 * bf16::kRowBytes;
  err = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kWarpgroup, smem, stream>>>(tmx, tmd, out, shift, gap);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace wgrad_tile
