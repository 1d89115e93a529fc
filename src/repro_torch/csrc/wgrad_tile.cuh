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
  return (g.th - 1) * g.stride + g.hf;
}
__host__ __device__ inline int wwin(const Geometry& g) {
  return (g.tw - 1) * g.stride + g.wf;
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
// floats from one window row to the next: a row's cells, padded to 128
// bytes, where its TMA box lands
__host__ __device__ inline int row_floats(const Geometry& g) {
  return round32(wwin(g) * x_ld(g.cib, g.stride));
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
  return round32(hwin(g) * row_floats(g));
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
// columns of split_sum.cuh: one per (m-tile group, Ci block, Co block)
__host__ __device__ inline int columns(const Geometry& g) {
  return groups(g) * g.ciblk * g.coblk;
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
// position tiles), out[1] the function's MACs (positions x taps x Ci x Co),
// out[2] the tensor-core MACs the tiles issue: every tile's K positions
// over every m-tile, N wide, three products, in every (Ci, Co) block;
// out[3] the dynamic shared memory of a CTA.
__host__ inline void plan(const Geometry& g, long long* out) {
  out[0] = tiles(g);
  out[1] = (long long)g.n * g.ho * g.wo * g.hf * g.wf * g.cib * g.ciblk
           * g.cob * g.coblk;
  out[2] = (long long)g.ciblk * g.coblk * tiles(g) * kpos(g) * mtiles(g)
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
// threads), rows [lo, hwin) of tile `t`, as TMA boxes of a row each (`ld`
// floats a cell, so channels past Cib land as zeros) or, where Cib is not a
// multiple of 4, as 4-byte cp.async copies of one group; rows [0, lo) are
// moved from `xprev`, the previous stage's window, whose rows [hwin - lo,
// hwin) they are.  Cells outside the map land as zeros.
__device__ void issue_x(const CUtensorMap* tmx, const float* __restrict__ x,
                        const Geometry& g, const Tile& t, int ci_b, float* xs,
                        const float* xprev, uint64_t* bar, int lo, int tid) {
  const int ld = x_ld(g.cib, g.stride);
  const int rf = row_floats(g);
  const int ww = wwin(g);
  const int hw = hwin(g);
  const int ih0 = t.oh0 * g.stride - g.pad_top;
  const int iw0 = t.ow0 * g.stride - g.pad_left;
  if (tid < 32) {                       // warp 0: the TMA copies
    if (tid == 0) {
      dt::mbar_expect_tx(bar, tma_x(g) ? (hw - lo) * ww * ld * 4 : 0);
    }
    __syncwarp();
    if (tma_x(g)) {
      for (int r = lo + tid; r < hw; r += 32) {
        dt::tma_load_5d(xs + r * rf, tmx, bar, 0, iw0, ih0 + r, ci_b, t.n);
      }
    }
  }
  if (lo > 0) {                         // the kept rows, while those land
    const float4* src = reinterpret_cast<const float4*>(xprev + (hw - lo) * rf);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int i = tid; i < lo * rf / 4; i += kWarpgroup) dst[i] = src[i];
  }
  if (!tma_x(g)) {                      // Cib = 3: 4-byte copies
    const float* xb = x + (size_t)(t.n * g.ciblk + ci_b) * g.hi * g.wi
                      * g.cib;
    const int per_row = ww * g.cib;
    for (int i = tid; i < (hw - lo) * per_row; i += kWarpgroup) {
      const int r = i / per_row;
      const int rem = i - r * per_row;
      const int col = rem / g.cib;
      const int c = rem - col * g.cib;
      const int ih = ih0 + lo + r;
      const int iw = iw0 + col;
      const bool ok = ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi;
      const float* src = ok ? xb + ((size_t)ih * g.wi + iw) * g.cib + c : xb;
      cp_async4(xs + (lo + r) * rf + col * ld + c, src, ok);
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
// row's lanes < Cob.
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
      float* out = row + ((((size_t)co_b * g.ciblk + ci_b) * g.hf * g.wf
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
  const int ld = x_ld(geo.cib, geo.stride);
  const int rf = row_floats(geo);
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
      ro[t][h] = r < rows ? (tap / geo.wf) * rf + (tap % geo.wf) * ld
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
// block blockIdx.y, Co block blockIdx.z; `wgs` consumer warpgroups of MPW
// m-tiles each and one producer warpgroup.  Its sums go to its share's row
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
  const size_t dw_size = (size_t)geo.coblk * geo.ciblk * geo.hf * geo.wf
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
      issue_x(tmx, x, geo, tile_of(geo, first + s), ci_b, m.x[slot],
              m.x[slot ^ 1], &m.bar_x[slot], more ? keep : 0, tid);
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
  const int column = (co_b * geo.ciblk + ci_b) * ngroups + group;
  if (!split_sum::arrive(counters + column, geo.splits,
                         reinterpret_cast<int*>(m.db), 0, nth,
                         threadIdx.x == 0)) {
    return;
  }
  const int span = geo.wgs * geo.mpw * kRows;
  const int m_lo = group * span;
  const int m_hi = min(geo.hf * geo.wf * geo.cib, m_lo + span);
  const size_t base = ((size_t)co_b * geo.ciblk + ci_b) * geo.hf * geo.wf
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
// The same tile on bf16 operands: the reference's `_wgrad_kernel` under
// BF16 (bf16 x, g and z; dw and db leave in f32, src/repro/kernels/
// direct_conv2d.py:638, `out_dtype=jnp.float32`).  Each stage's k16 steps
// of positions run on bf16 wgmma (m64nNk16, one product a MAC) into a
// fresh f32 accumulator, which is then added to the m-tile's running f32
// sum (the tensor cores add each k16 slice rounding toward zero; a fresh
// accumulator a stage keeps that to the stage's own magnitude), one m-tile
// at a time.  Where the running sums take 64 registers a thread (N * MPW =
// 128) a CTA takes two consumers at most (`max_threads`: 168 registers a
// thread of a 384-thread CTA; under 512 threads' 128 the accumulator in
// 64-lane parts spilled, and 32-lane parts ran a quarter of the wgmma
// width with A loaded four times a step).  The workspace and its fold (split_sum.cuh) stay
// f32 and unchanged.
//
// What differs from the f32 tile:
// * A, x's window, pairs two consecutive positions of one (tap, c) row in
//   a register, and those are `stride` cells apart in shared memory, not
//   adjacent.  The pair is built from two 2-byte loads (four registers a
//   step: eight loads and four position offsets).  Staging A for a
//   descriptor instead would need a copy of the window with each tap's
//   positions contiguous: wgmma's MN-major A takes core matrices of 8 rows
//   x 16 contiguous bytes, and a tile's positions are neither contiguous
//   (`stride` cells apart, a break at each tile row) nor one shift per
//   m-tile below Cib 64; the loads keep one staged window for every tap.
//   A cell is `ld` bf16 (Cib rounded up to 8, then, at odd strides, to 8
//   mod 16): the 8 rows of a warp's load are 8 channels of one cell (16
//   bytes), its 4 column groups positions 2 apart, 4 * stride * ld bytes
//   apart, on distinct 16-byte bank groups where stride * ld is not a
//   multiple of 16 (at stride 2 they fall two to a group).
// * B, dz, is MN-major (Cob contiguous), which bf16 wgmma reads through its
//   transpose bit: the producer writes it as [N/8][K][8], core matrices of
//   8 positions x 8 lanes, a k16 step's two K halves 128 bytes apart, the
//   8-lane groups (K + 1) * 16 bytes apart (fwd_tile.cuh's weight order,
//   K the positions, one position of padding a group so that a quarter
//   warp's stores of one position's groups fall on distinct banks), no
//   split.  K (positions) pads to 16.  A unit of the pass is one
//   position's 8 lanes: one 16-byte load of g (and of z) where Cob is a
//   multiple of 8, consecutive threads on consecutive 16 bytes (the
//   staged [K][Cob] tile is read along Cob).
// * dz = g * act'(z) is formed as B is written: act' in f32, the product
//   rounded once to bf16.  db sums the rounded dz per Cob lane in f32, one
//   lane a producer thread, positions in order, on the CTAs of Ci block 0
//   and m-tile group 0.
// * TMA needs global strides of whole 16 bytes: Cib (x) and Cob (g, z)
//   multiples of 8.  Else the producer copies the same cells by 4-byte
//   cp.async of channel pairs where the pencil is even, else by 2-byte
//   loads and stores (Cib = 3: a pixel's three channels are 6 bytes).
namespace bf16 {

using bf = __nv_bfloat16;

__host__ __device__ inline int kpos(const Geometry& g) {
  return ceil_div(g.th * g.tw, 16) * 16;
}

// threads of the largest CTA of the instance (N, MPW) (the launch bound)
__host__ __device__ constexpr int max_threads(int lanes, int mpw) {
  return kWarpgroup * ((lanes * mpw >= 128 ? 2 : kMaxConsumers) + 1);
}

// bf16 of one staged x cell: Cib rounded up to 8 (a TMA box's 16 bytes),
// then up to the first value whose stride multiple is 8 mod 16, so that an
// A load's four position pairs start on four distinct 16-byte bank groups
// (kept at Cib rounded up to 8 where no such value exists, as at stride 2).
__host__ __device__ inline int x_ld(int cib, int stride) {
  const int base = ceil_div(cib, 8) * 8;
  for (int ld = base; ld < base + 64; ld += 8) {
    if (stride * ld % 16 == 8) return ld;
  }
  return base;
}

// bf16 from one window row to the next, padded to 128 bytes
__host__ __device__ inline int row_elems(const Geometry& g) {
  return ceil_div(wwin(g) * x_ld(g.cib, g.stride), 64) * 64;
}
__host__ __device__ inline bool tma_x(const Geometry& g) {
  return g.cib % 8 == 0;
}
__host__ __device__ inline bool tma_d(const Geometry& g) {
  return g.cob % 8 == 0;
}
__host__ __device__ inline int x_elems(const Geometry& g) {
  return hwin(g) * row_elems(g);
}
__host__ __device__ inline int raw_elems(const Geometry& g) {
  return ceil_div(bf16::kpos(g) * g.cob, 64) * 64;
}
// positions from one 8-lane group of B to the next: K plus one, so that
// the eight 16-byte stores of a quarter warp (consecutive groups of one
// position) fall on distinct bank groups
__host__ __device__ inline int b_pitch(const Geometry& g) {
  return bf16::kpos(g) + 1;
}
__host__ __device__ inline int b_elems(const Geometry& g) {
  return ceil_div(b_pitch(g) * g.lanes, 64) * 64;
}
__host__ __device__ inline int slot_elems(const Geometry& g) {
  return x_elems(g) + (g.prologue ? 2 : 1) * raw_elems(g) + b_elems(g);
}

// Dynamic shared memory of one CTA (core/blocking.py wgrad_smem_bytes at
// op_bytes 2): 128 bytes to align the base, the two slots, the position
// offsets, the db partials and two mbarriers a slot.
__host__ inline size_t smem_bytes(const Geometry& g) {
  return 128 + 2 * (size_t)kSlots * slot_elems(g)
         + 4 * (kMaxPositions + kWarpgroup) + 8 * 2 * kSlots;
}

// wgrad_tile::plan at one bf16 product a MAC, K padded to 16.
__host__ inline void plan(const Geometry& g, long long* out) {
  out[0] = tiles(g);
  out[1] = (long long)g.n * g.ho * g.wo * g.hf * g.wf * g.cib * g.ciblk
           * g.cob * g.coblk;
  out[2] = (long long)g.ciblk * g.coblk * tiles(g) * bf16::kpos(g) * mtiles(g)
           * kRows * g.lanes;
  out[3] = (long long)bf16::smem_bytes(g);
}

struct Smem {
  bf* x[kSlots];
  bf* g[kSlots];
  bf* z[kSlots];
  bf* b[kSlots];
  int* posoff;          // [kMaxPositions]
  float* db;            // [kWarpgroup]
  uint64_t* bar_x;      // [kSlots]
  uint64_t* bar_d;      // [kSlots]
};

__device__ inline Smem carve(char* raw, const Geometry& g) {
  Smem m;
  bf* p = reinterpret_cast<bf*>(raw + ((128 - (dt::smem_u32(raw) & 127))
                                       & 127));
  for (int s = 0; s < kSlots; ++s) {
    m.x[s] = p;
    m.g[s] = m.x[s] + x_elems(g);
    m.z[s] = m.g[s] + (g.prologue ? raw_elems(g) : 0);
    m.b[s] = m.z[s] + raw_elems(g);
    p = m.b[s] + b_elems(g);
  }
  m.posoff = reinterpret_cast<int*>(p);
  m.db = reinterpret_cast<float*>(m.posoff + kMaxPositions);
  m.bar_x = reinterpret_cast<uint64_t*>(m.db + kWarpgroup);
  m.bar_d = m.bar_x + kSlots;
  return m;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Issue a stage's x window onto `bar` (wgrad_tile::issue_x in bf16): TMA
// boxes of a row each where Cib is a multiple of 8, else copies of channel
// pairs (Cib even) or of single channels (Cib odd); rows [0, lo) moved
// from `xprev`.
__device__ void issue_x(const CUtensorMap* tmx, const bf* __restrict__ x,
                        const Geometry& g, const Tile& t, int ci_b, bf* xs,
                        const bf* xprev, uint64_t* bar, int lo, int tid) {
  const int ld = x_ld(g.cib, g.stride);
  const int rf = row_elems(g);
  const int ww = wwin(g);
  const int hw = hwin(g);
  const int ih0 = t.oh0 * g.stride - g.pad_top;
  const int iw0 = t.ow0 * g.stride - g.pad_left;
  if (tid < 32) {                       // warp 0: the TMA copies
    if (tid == 0) {
      dt::mbar_expect_tx(bar, bf16::tma_x(g) ? (hw - lo) * ww * ld * 2 : 0);
    }
    __syncwarp();
    if (bf16::tma_x(g)) {
      for (int r = lo + tid; r < hw; r += 32) {
        dt::tma_load_5d(xs + r * rf, tmx, bar, 0, iw0, ih0 + r, ci_b, t.n);
      }
    }
  }
  if (lo > 0) {                         // the kept rows, while those land
    const uint4* src = reinterpret_cast<const uint4*>(xprev + (hw - lo) * rf);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = tid; i < lo * rf / 8; i += kWarpgroup) dst[i] = src[i];
  }
  if (!bf16::tma_x(g)) {
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x)
        + (size_t)(t.n * g.ciblk + ci_b) * g.hi * g.wi * g.cib;
    unsigned short* d16 = reinterpret_cast<unsigned short*>(xs);
    const int unit = g.cib % 2 == 0 ? 2 : 1;
    const int per_cell = g.cib / unit;
    const int per_row = ww * per_cell;
    for (int i = tid; i < (hw - lo) * per_row; i += kWarpgroup) {
      const int r = i / per_row;
      const int rem = i - r * per_row;
      const int col = rem / per_cell;
      const int c = (rem - col * per_cell) * unit;
      const int ih = ih0 + lo + r;
      const int iw = iw0 + col;
      const bool ok = ih >= 0 && ih < g.hi && iw >= 0 && iw < g.wi;
      const size_t off = ok ? ((size_t)ih * g.wi + iw) * g.cib + c : 0;
      const int at = (lo + r) * rf + col * ld + c;
      if (unit == 2) {
        cp_async4(d16 + at, xb + off, ok);
      } else {
        d16[at] = ok ? __ldg(xb + off) : (unsigned short)0;
      }
    }
    cp_async_commit();
  }
}

// Issue the th x tw positions of g (and z) of tile `t` onto `bar`
// (wgrad_tile::issue_d in bf16): one TMA box each where Cob is a multiple
// of 8, else copies of channel pairs (Cob even) or single channels.
__device__ void issue_d(const CUtensorMap* tmg, const CUtensorMap* tmz,
                        const bf* __restrict__ gg, const bf* __restrict__ zz,
                        const Geometry& g, const Tile& t, int co_b, bf* rg,
                        bf* rz, uint64_t* bar, int tid) {
  if (tid == 0) {
    dt::mbar_expect_tx(bar, bf16::tma_d(g) ? g.th * g.tw * g.cob * 2
                                           * (g.prologue ? 2 : 1)
                                     : 0);
    if (bf16::tma_d(g)) {
      dt::tma_load_5d(rg, tmg, bar, 0, t.ow0, t.oh0, co_b, t.n);
      if (g.prologue) dt::tma_load_5d(rz, tmz, bar, 0, t.ow0, t.oh0, co_b, t.n);
    }
  }
  if (!bf16::tma_d(g)) {
    const size_t map = (size_t)(t.n * g.coblk + co_b) * g.ho * g.wo * g.cob;
    const unsigned short* g16 = reinterpret_cast<const unsigned short*>(gg);
    const unsigned short* z16 = reinterpret_cast<const unsigned short*>(zz);
    unsigned short* dg = reinterpret_cast<unsigned short*>(rg);
    unsigned short* dz = reinterpret_cast<unsigned short*>(rz);
    const int unit = g.cob % 2 == 0 ? 2 : 1;
    for (int i = tid * unit; i < g.th * g.tw * g.cob;
         i += kWarpgroup * unit) {
      const int p = i / g.cob;
      const int c = i - p * g.cob;
      const int oh = t.oh0 + p / g.tw;
      const int ow = t.ow0 + p % g.tw;
      const bool ok = oh < g.ho && ow < g.wo;
      const size_t off = ok ? map + ((size_t)oh * g.wo + ow) * g.cob + c : 0;
      if (unit == 2) {
        cp_async4(dg + i, g16 + off, ok);
        if (g.prologue) cp_async4(dz + i, z16 + off, ok);
      } else {
        dg[i] = ok ? __ldg(g16 + off) : (unsigned short)0;
        if (g.prologue) dz[i] = ok ? __ldg(z16 + off) : (unsigned short)0;
      }
    }
    cp_async_commit();
  }
}

// Form dz from a landed stage's g (and z), rounded to bf16, and write B as
// [N/8][K][8], its 8-lane groups `b_pitch` positions apart (`tid` of
// kWarpgroup, eight lanes of one position a unit, the lane groups of a
// position on consecutive threads); positions past the tile and lanes past
// Cob are 0.  Where Cob is a multiple of 8 a unit's g and z are one 16-byte
// load each, consecutive threads on consecutive 16 bytes; else eight
// 2-byte loads, clamped into the staged cells.
template <int N>
__device__ void transform(const bf* rg, const bf* rz, bf* b,
                          const Geometry& g, int tid) {
  const int live = g.th * g.tw;
  const int kp = bf16::kpos(g);
  const int pitch = b_pitch(g);
  const bool vec = g.cob % 8 == 0;
  for (int u = tid; u < N / 8 * kp; u += kWarpgroup) {
    const int q = u % (N / 8);
    const int p = u / (N / 8);
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (vec) {
      if (8 * q < g.cob && p < live) {
        out = *reinterpret_cast<const uint4*>(rg + p * g.cob + 8 * q);
        if (g.prologue) {
          const uint4 zv =
              *reinterpret_cast<const uint4*>(rz + p * g.cob + 8 * q);
          bf* ob = reinterpret_cast<bf*>(&out);
          const bf* zb = reinterpret_cast<const bf*>(&zv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ob[e] = dt::prologue_bf16(ob[e], zb[e], g.act);
          }
        }
      }
    } else {
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bf v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int co = 8 * q + 2 * e + k;
          // loads clamped into the staged cells (rz is rg without the
          // prologue), then the lanes and positions outside set 0
          const int at = min(p, live - 1) * g.cob + min(co, g.cob - 1);
          bf d = rg[at];
          if (g.prologue) d = dt::prologue_bf16(d, rz[at], g.act);
          v[k] = __float2bfloat16_rn(0.0f);
          if (co < g.cob && p < live) v[k] = d;
        }
        packed[e] = (uint32_t)__bfloat16_as_ushort(v[0])
                    | ((uint32_t)__bfloat16_as_ushort(v[1]) << 16);
      }
      out = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    reinterpret_cast<uint4*>(b)[q * pitch + p] = out;
  }
}

// Contract one landed stage into a warpgroup's MPW running sums: per
// m-tile that is on and per part of NW lanes, the stage's k16 steps of
// positions into a fresh accumulator, then added into `total` in f32.  A
// pairs positions p, p + 1 of each row from two 2-byte loads at the row's
// offset `ro` plus their position offsets, loaded one step ahead into the
// register set the wgmma two steps back has released.  Returns with every
// wgmma complete.
template <int N, int NW, int MPW>
__device__ void mma_stage(float (&total)[MPW][N / 2], const bf* win,
                          const int (&ro)[MPW][2], const bool (&on)[MPW],
                          const int* posoff, int steps, const bf* b,
                          int pitch) {
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(win);
  const int l4 = threadIdx.x % 4;
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
    if (!on[t]) continue;
    auto load = [&](uint32_t (&a)[4], int j) {
      const int p = 16 * j + 2 * l4;
      const int o0 = posoff[p], o1 = posoff[p + 1];
      const int o8 = posoff[p + 8], o9 = posoff[p + 9];
      a[0] = w16[ro[t][0] + o0] | ((uint32_t)w16[ro[t][0] + o1] << 16);
      a[1] = w16[ro[t][1] + o0] | ((uint32_t)w16[ro[t][1] + o1] << 16);
      a[2] = w16[ro[t][0] + o8] | ((uint32_t)w16[ro[t][0] + o9] << 16);
      a[3] = w16[ro[t][1] + o8] | ((uint32_t)w16[ro[t][1] + o9] << 16);
    };
#pragma unroll
    for (int part = 0; part < N / NW; ++part) {
      float acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
      // the part's first 8-lane group, `pitch` positions of 16 bytes a
      // group on
      const uint32_t base = dt::smem_u32(b) + part * NW / 8 * pitch * 16;
      auto step = [&](const uint32_t (&a)[4], int j) {
        dt::wgmma_fence();
        dt::wgmma_bf16<NW, 1>(acc, a, dt::kmajor_desc(base + j * 256, 128,
                                                      pitch * 16));
        dt::wgmma_commit();
      };
      uint32_t a0[4], a1[4];
      load(a0, 0);
      for (int j = 0; j < steps; j += 2) {
        step(a0, j);
        if (j + 1 < steps) {
          dt::wgmma_wait<1>();        // step j - 1 has released a1
          load(a1, j + 1);
          step(a1, j + 1);
        }
        if (j + 2 < steps) {
          dt::wgmma_wait<1>();        // step j has released a0
          load(a0, j + 2);
        }
      }
      dt::wgmma_wait<0>();
      dt::fence_regs<NW / 2>(acc);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) total[t][part * NW / 2 + i] += acc[i];
    }
  }
}

// The consumer warpgroups of `run` (wgrad_tile::consume in bf16).
template <int N, int MPW>
__device__ __forceinline__ void consume(const Smem& m, const Geometry& geo,
                                        int group, int stages, float* row,
                                        int ci_b, int co_b) {
  const int nth = blockDim.x;
  const int ld = x_ld(geo.cib, geo.stride);
  const int rf = row_elems(geo);
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
      ro[t][h] = r < rows ? (tap / geo.wf) * rf + (tap % geo.wf) * ld
                                + (r - tap * geo.cib)
                          : 0;
    }
  }
  float total[MPW][N / 2];
#pragma unroll
  for (int t = 0; t < MPW; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[t][i] = 0.0f;
  }
  const int kp = bf16::kpos(geo);
  for (int s = 0; s < stages; ++s) {
    const int slot = s & 1;
    dt::bar_sync(kBarFull + slot, nth);
    mma_stage<N, N, MPW>(total, m.x[slot], ro, on, m.posoff, kp / 16,
                         m.b[slot], b_pitch(geo));
    if (s + kSlots < stages) dt::bar_arrive(kBarEmpty + slot, nth);
  }
  store_dw<N, MPW>(row, total, geo, ci_b, co_b, mt0);
}

// One CTA (wgrad_tile::run in bf16): its sums go to its share's row of the
// f32 `ws`; the column's last CTA sums the rows into the f32 `out`.
template <int N, int MPW>
__device__ void run(char* smem, const CUtensorMap* tmx, const CUtensorMap* tmg,
                    const CUtensorMap* tmz, const bf* __restrict__ x,
                    const bf* __restrict__ gg, const bf* __restrict__ zz,
                    float* ws, float* out, int* counters,
                    const Geometry& geo) {
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
  const int rf = row_elems(geo);
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
  const size_t dw_size = (size_t)geo.coblk * geo.ciblk * geo.hf * geo.wf
                         * geo.cib * geo.cob;
  const size_t cols = dw_size + (geo.with_db ? geo.coblk * geo.cob : 0);
  float* row = ws + (size_t)split * cols;
  const bool db_cta = geo.with_db && ci_b == 0 && group == 0;

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    const int keep = max(0, hwin(geo) - geo.th * geo.stride);
    auto issue_dz = [&](int s) {
      issue_d(tmg, tmz, gg, zz, geo, tile_of(geo, first + s), co_b,
              m.g[s & 1], m.z[s & 1], &m.bar_d[s & 1], tid);
    };
    for (int s = 0; s < min(stages, kSlots); ++s) issue_dz(s);
    float db = 0.0f;                    // lane tid's sum of dz
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      const int parity = (s >> 1) & 1;
      if (s >= kSlots) dt::bar_sync(kBarEmpty + slot, nth);
      const bool more = geo.streamed && s > 0
                        && (first + s) % tiles_h(geo) != 0;
      if (more && !bf16::tma_x(geo)) dt::bar_sync(kBarProducer, kWarpgroup);
      bf16::issue_x(tmx, x, geo, tile_of(geo, first + s), ci_b, m.x[slot],
                    m.x[slot ^ 1], &m.bar_x[slot], more ? keep : 0, tid);
      if (!bf16::tma_d(geo)) cp_async_wait_all();
      dt::mbar_wait(m.bar_d + slot, parity);
      dt::bar_sync(kBarProducer, kWarpgroup);   // g and z of s landed
      transform<N>(m.g[slot], m.z[slot], m.b[slot], geo, tid);
      dt::bar_sync(kBarProducer, kWarpgroup);   // g and z read, B written
      if (db_cta && tid < N) {
        const bf* col = m.b[slot] + (tid / 8) * b_pitch(geo) * 8 + tid % 8;
        const int live = geo.th * geo.tw;
        for (int p = 0; p < live; ++p) db += __bfloat162float(col[8 * p]);
      }
      if (s + kSlots < stages) issue_dz(s + kSlots);
      if (!bf16::tma_x(geo)) cp_async_wait_all();
      dt::mbar_wait(m.bar_x + slot, parity);
      dt::fence_proxy_async();
      dt::bar_arrive(kBarFull + slot, nth);
    }
    if (db_cta && tid < geo.cob) row[dw_size + co_b * geo.cob + tid] = db;
  } else {
    consume<N, MPW>(m, geo, group, stages, row, ci_b, co_b);
  }

  const int column = (co_b * geo.ciblk + ci_b) * ngroups + group;
  if (!split_sum::arrive(counters + column, geo.splits,
                         reinterpret_cast<int*>(m.db), 0, nth,
                         threadIdx.x == 0)) {
    return;
  }
  const int span = geo.wgs * geo.mpw * kRows;
  const int m_lo = group * span;
  const int m_hi = min(geo.hf * geo.wf * geo.cib, m_lo + span);
  const size_t base = ((size_t)co_b * geo.ciblk + ci_b) * geo.hf * geo.wf
                          * geo.cib * geo.cob
                      + (size_t)m_lo * geo.cob;
  split_sum::sum_rows(ws + base, cols, geo.splits, out + base,
                      (m_hi - m_lo) * geo.cob, 1.0f, threadIdx.x, nth);
  if (db_cta) {
    const size_t db = dw_size + (size_t)co_b * geo.cob;
    split_sum::sum_rows(ws + db, cols, geo.splits, out + db, geo.cob, 1.0f,
                        threadIdx.x, nth);
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
// (wgmma width, m-tiles a warpgroup) of the f32 build, then of the bf16 one
constexpr int kInstances = 20;

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device),
// so that a launch at a shape seen before sets nothing; the instance is
// named by its build (`bf16`), width and m-tiles.
inline cudaError_t allow_smem(const void* kernel, const Geometry& g,
                              int device, int bytes, bool bf16 = false) {
  int slot = g.mpw - 1 + (bf16 ? kInstances / 2 : 0);
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
  return g.n >= 1 && g.wgs >= 1 && g.wgs <= kMaxConsumers && g.mpw >= 1
         && g.lanes >= g.cob && g.lanes * g.mpw <= kWarpgroup
         && g.th >= 1 && g.tw >= 1 && g.th * g.tw <= kMaxPositions
         && g.stride >= 1 && g.splits >= 1 && g.splits <= tiles(g)
         && smem_bytes(g) <= (size_t)kSmemBlock;
}

// Check the launch, encode its tensor maps (x as [N, Ci/Cib, Hi, Wi, Cib]
// with a box of one window row, `ld` channels a cell; g and z as [N,
// Co/Cob, Ho, Wo, Cob] with a box of the tile), size its shared memory and
// launch (groups * splits, Ci/Cib, Co/Cob) CTAs of `wgs` consumer
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
    const int box[5] = {x_ld(geo.cib, geo.stride), wwin(geo), 1, 1, 1};
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
  const dim3 grid(groups(geo) * geo.splits, geo.ciblk, geo.coblk);
  kernel<<<grid, kWarpgroup * (geo.wgs + 1), smem, stream>>>(
      tmx, tmg, tmz, x, g, z, ws, out, counters, geo);
  return (int)cudaGetLastError();
}

using KernelBf16 = void (*)(const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const __nv_bfloat16*,
                            const __nv_bfloat16*, const __nv_bfloat16*,
                            float*, float*, int*, Geometry);

// Whether the bf16 kernels take this geometry.
__host__ inline bool valid_bf16(const Geometry& g) {
  return g.n >= 1 && g.wgs >= 1 && g.mpw >= 1
         && kWarpgroup * (g.wgs + 1) <= bf16::max_threads(g.lanes, g.mpw)
         && g.lanes >= g.cob && g.lanes * g.mpw <= kWarpgroup
         && g.th >= 1 && g.tw >= 1 && g.th * g.tw <= kMaxPositions
         && g.stride >= 1 && g.splits >= 1 && g.splits <= tiles(g)
         && bf16::smem_bytes(g) <= (size_t)kSmemBlock;
}

// launch for the bf16 build: bf16 tensor maps (x a box of one window row,
// `ld` channels a cell, where Cib is a multiple of 8; g and z a box of the
// tile where Cob is), the f32 workspace and sums.
inline int launch_bf16(KernelBf16 kernel, const __nv_bfloat16* x,
                       const __nv_bfloat16* g, const __nv_bfloat16* z,
                       float* ws, float* out, int* counters,
                       const Geometry& geo, cudaStream_t stream) {
  if (kernel == nullptr || !valid_bf16(geo)
      || (geo.prologue != 0) != (z != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx = {}, tmg = {}, tmz = {};
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (bf16::tma_x(geo)) {
    const long long cib = geo.cib;
    const long long dims[5] = {cib, geo.wi, geo.hi, geo.ciblk, geo.n};
    const long long str[4] = {cib * 2, geo.wi * cib * 2,
                              (long long)geo.hi * geo.wi * cib * 2,
                              (long long)geo.ciblk * geo.hi * geo.wi * cib
                                  * 2};
    const int box[5] = {bf16::x_ld(geo.cib, geo.stride), wwin(geo), 1, 1, 1};
    if (!dt::encode(&tmx, x, 5, dims, str, box, type))
      return (int)cudaErrorNotSupported;   // the encoder refused the map
  }
  if (bf16::tma_d(geo)) {
    const long long cob = geo.cob;
    const long long dims[5] = {cob, geo.wo, geo.ho, geo.coblk, geo.n};
    const long long str[4] = {cob * 2, geo.wo * cob * 2,
                              (long long)geo.ho * geo.wo * cob * 2,
                              (long long)geo.coblk * geo.ho * geo.wo * cob
                                  * 2};
    const int box[5] = {geo.cob, geo.tw, geo.th, 1, 1};
    if (!dt::encode(&tmg, g, 5, dims, str, box, type)
        || (z != nullptr && !dt::encode(&tmz, z, 5, dims, str, box, type)))
      return (int)cudaErrorNotSupported;
  }
  const size_t smem = bf16::smem_bytes(geo);
  err = allow_smem((const void*)kernel, geo, device, (int)smem, true);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(groups(geo) * geo.splits, geo.ciblk, geo.coblk);
  kernel<<<grid, kWarpgroup * (geo.wgs + 1), smem, stream>>>(
      tmx, tmg, tmz, x, g, z, ws, out, counters, geo);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace wgrad_tile
