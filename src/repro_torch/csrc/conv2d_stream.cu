// Streamed (halo-ring) blocked direct convolution, f32 — hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv2d_stream.py:
//   `_stream_conv_kernel` (:78; pallas_call :238 in `stream_forward`)
//                                                     -> stream_conv_kernel
//   the same kernel in its transposed form (pallas_call :284 in
//       `stream_dgrad`)                               -> stream_dgrad_kernel
//   `_stream_wgrad_kernel` (:306; pallas_call :384 in `stream_wgrad`)
//                                                     -> stream_wgrad_kernel
// They compute what the window kernels compute (direct_conv2d_fwd.cu,
// direct_conv2d_bwd.cu), on the same blocked layouts and unpadded operands:
//
//   x    [N, Ci/Cib, Hi, Wi, Cib]        unpadded; the copies zero-fill pads
//   w    [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]
//   g, z [N, Co/Cob, Ho, Wo, Cob]        cotangent, saved pre-activation
//   out  [N, Co/Cob, Ho, Wo, Cob]        forward (+ GAP partials per band)
//   dx   [N, Ci/Cib, Hi, Wi, Cib]        dgrad, at the input's shape
//   ws   [splits, |dw| + |db|]           wgrad partial sums, summed by
//                                        `wgrad_reduce` in split order
//
// What differs is how the input reaches shared memory.  On the TPU the
// streamed kernels keep the operands in HBM and drive their own DMA: the
// weight tile is copied once per grid step, and the band's rows arrive as
// strips through a 2-slot ring, strip k+1 in flight while strip k computes,
// the `Hf - stride` halo rows moved slot to slot instead of re-read.  Here:
//
// * The forward: one CTA per (band of hob x wob output positions, output
//   channel block, image).  The band is at most the window kernel's
//   register tile (8 positions x 8 lanes a thread), and the accumulators
//   stay there.  A band is one or two strips (kStrips); strip s owns slots
//   [s * kSlots, (s + 1) * kSlots) of every thread's tile, so a strip's FMAs
//   run over a fixed range of registers with no per-slot predicate.  The
//   loop order is the window kernel's: reduction block, channel chunk, then
//   strips; per output element the sum runs over (block, chunk, dh, dw,
//   channel) in the window kernel's order, so where both pick the same
//   chunk the two forwards agree bit for bit.
//   Per chunk the weight chunk is staged once, and the band's input rows
//   arrive as strips of `hso` output rows through a circular row buffer of
//   `ring_rows` rows (row r of the band lives in slot r % ring_rows), filled
//   by `cp.async`: 16-byte copies where rows are aligned, 4-byte copies
//   otherwise (Cib = 3), the zero-fill form (src-size 0) for pad rows and
//   columns.  The rows of strip k+1 are issued (one commit group) before
//   strip k's taps run, and waited for (`cp.async.wait_group 0` and one
//   `__syncthreads`) before strip k+1's.  The halo rows two strips share
//   are copied from device memory once per chunk; nothing moves between
//   slots.
// * The dgrad (stream_dgrad_kernel) is the phase-split tensor-core tile of
//   dgrad_tile.cuh (dx split by its phase against the stride, each phase an
//   implicit GEMM over the taps it reaches, 3xTF32 wgmma), streamed: one
//   CTA per (band of two or three strips of hso x tw positions of one
//   phase, Ci block, image), one consumer warpgroup per strip and a
//   producer warpgroup.  Per stage (Co block, Cob chunk) the band's
//   cotangent rows, in the cotangent's own coordinates, reach a two-slot
//   ring by TMA with `z` beside them, one copy group per strip: the weight
//   chunk and strip 0's rows, then each later strip's fresh rows (those the
//   strip before does not share), so strip k computes while strip k+1's
//   rows are in flight, and the next stage's groups are in flight while
//   this one computes.  dz = g * act'(z) is formed in place once a group
//   lands; each halo row is read from device memory once per stage.
// * The wgrad (stream_wgrad_kernel) is the tensor-core tile of
//   wgrad_tile.cuh (an implicit GEMM in 3xTF32: rows the (tap, c) pairs,
//   columns Cob, K the output positions), streamed: a CTA walks a
//   contiguous share of (image, column, strip) items of hso x wob output
//   positions, strip by strip down each column, through a two-slot ring;
//   where the next strip continues the column, its window keeps the halo
//   rows the two share (moved slot to slot, as the TPU kernel moves them)
//   and only its fresh rows come from device memory, with its cotangent
//   strip and `z` beside it, a slot ahead of the wgmmas.  db rides the
//   producer of the CTAs of Ci block 0 and m-tile group 0.
//
// What bounds them on this card: the forward, the f32 FMA rate (VGG-16's
// convs do 2*9*Ci FLOPs per output element for a few bytes; the H100's f32
// ridge is ~20 FLOP/byte), in practice the shared-memory reads feeding the
// FMAs; a strip holds half a thread's positions, so each weight read from
// shared memory feeds half as many FMAs as in the window kernel.  No tensor
// cores, TMA or persistent CTAs in it.  The dgrad and the wgrad, the TF32
// tensor-core rate spent three times over by the split, held below it by
// the producer's per-stage copies, passes and barriers (dgrad_tile.cuh,
// wgrad_tile.cuh, direct_conv2d_bwd.cu).
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after its launch (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "dgrad_tile.cuh"
#include "wgrad_tile.cuh"

namespace {

namespace dt = dgrad_tile;
namespace wtile = wgrad_tile;

constexpr int kThreads = 256;   // threads per CTA
constexpr int kLanes = 8;       // register-tile columns of one thread
constexpr int kPositions = 8;   // forward: positions of one thread
constexpr int kMinBlocksPerSm = 2;
static_assert(kLanes == 8, "the float4 pair reads assume 8 lanes");

constexpr int kActRelu = 1;
constexpr int kActGelu = 2;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) {
    return v < 0.0f ? 0.0f : v;
  }
  if (act == kActGelu) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v;
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// cp.async: `valid` false copies no byte and zero-fills the destination
// (src-size 0); `src` must still be a global address.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of map rows [lo, hi) (band-relative; absolute row =
// row0 + r) into the ring: row r goes to slot r % ring_rows, `cols` cells
// from column col0, `chunk` channels from channel c0 of a `pencil`-wide
// map of `rows` x `width` cells.  Cells outside the map are zero-filled.
// `vec`: 16-byte copies (chunk, pencil and the map's start 16-byte aligned).
__device__ __forceinline__ void stage_rows(
    float* ring, int ring_rows, const float* map, int rows, int width,
    int pencil, int row0, int lo, int hi, int col0, int cols, int c0,
    int chunk, bool vec) {
  const int unit = vec ? 4 : 1;
  const int per_cell = chunk / unit;
  const int per_row = cols * per_cell;
  const int total = (hi - lo) * per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = lo + i / per_row;
    const int rem = i - (r - lo) * per_row;
    const int col = rem / per_cell;
    const int c = (rem - col * per_cell) * unit;
    const int ih = row0 + r;
    const int iw = col0 + col;
    const bool ok = ih >= 0 && ih < rows && iw >= 0 && iw < width;
    const float* src =
        ok ? map + ((size_t)ih * width + iw) * pencil + c0 + c : map;
    float* dst = ring + ((r % ring_rows) * cols + col) * chunk + c;
    if (vec) {
      cp_async16(dst, src, ok);
    } else {
      cp_async4(dst, src, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Generic names: the CTA owns a band of an oh x ow output grid with `lanes`
// channels (Cob), and contracts `rblk` blocks of `rpen` channels (Cib) of
// an ih x iw input map (x).
// kVecW: lanes is a multiple of kLanes (two float4 weight reads a step).
// kStrips: the band's strips (hob / hso).  Slot k of a thread's register
// tile belongs to strip k / kSlots, so a strip's FMAs run over a fixed,
// compile-time range of kSlots slots (no per-slot predicates), and each
// strip holds up to kSlots * (position groups) positions.
template <bool kVecW, int kStrips>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
stream_conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ residual,
                   float* __restrict__ out, float* __restrict__ partials,
                   int rblk, int ih, int iw, int rpen, int oblk, int lanes,
                   int oh, int ow, int hf, int wf, int stride, int pad_top,
                   int pad_left, int hob, int wob, int hso, int ring_rows,
                   int ring_cols, int chunk, int ldw, int act) {
  constexpr int kSlots = kPositions / kStrips;
  static_assert(kSlots * kStrips == kPositions, "strips split the tile");
  extern __shared__ __align__(16) float smem[];
  const int tiles_w = ow / wob;
  const int n_tiles = (oh / hob) * tiles_w;
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y;
  const int n = blockIdx.z;
  const int i0 = (tile / tiles_w) * hob;   // band origin in the output grid
  const int j0 = (tile % tiles_w) * wob;
  const int taps = hf * wf;
  const int R = ring_rows;
  const int WW = ring_cols;

  const int ncg = (lanes + kLanes - 1) / kLanes;
  const int npg = kThreads / ncg;
  const int t = threadIdx.x;
  const int cg = t % ncg;
  const int pg = t / ncg;
  const bool computes = pg < npg;
  const int l0 = cg * kLanes;

  // band-relative input row 0 and column 0, in the input map's coordinates
  const int row0 = i0 * stride - pad_top;
  const int col0 = j0 * stride - pad_left;

  float* w_s = smem;                                   // [taps, chunk, ldw]
  float* ring = smem + round4(taps * chunk * ldw);     // [R, WW, chunk]

  float acc[kPositions][kLanes];
#pragma unroll
  for (int k = 0; k < kPositions; ++k) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[k][j] = 0.0f;
  }

  // the ring rows [lo, hi) that strip s reads
  auto strip_rows = [&](int s, int& lo, int& hi) {
    lo = s * hso * stride;
    hi = lo + (hso - 1) * stride + hf;
  };

  const bool vec_in = chunk % 4 == 0 && rpen % 4 == 0;
  const bool vec_w = lanes % 4 == 0;
  const int strip_pos = hso * wob;
  // the band position of slot k of this thread, or -1 (a slot past its
  // strip computes on a valid offset and is never stored)
  auto slot_position = [&](int k) {
    const int q = pg + (k % kSlots) * npg;
    return q < strip_pos ? (k / kSlots) * strip_pos + q : -1;
  };

  for (int rb = 0; rb < rblk; ++rb) {
    const size_t map = (size_t)(n * rblk + rb) * ih * iw * rpen;
    const float* in_b = in + map;
    const float* w_b = w + (size_t)(o_b * rblk + rb) * taps * rpen * lanes;
    for (int c0 = 0; c0 < rpen; c0 += chunk) {
      // every thread is done with the previous chunk's weights and ring
      __syncthreads();
      // per tap one contiguous run of chunk * lanes floats
      const int run = chunk * lanes;
      const int unit = vec_w ? 4 : 1;
      for (int i = t * unit; i < taps * run; i += kThreads * unit) {
        const int tap = i / run;
        const float* src = w_b + ((size_t)tap * rpen + c0) * lanes + i % run;
        if (vec_w) {
          cp_async16(w_s + i, src, true);
        } else {
          cp_async4(w_s + i, src, true);
        }
      }
      int lo, hi;
      strip_rows(0, lo, hi);
      stage_rows(ring, R, in_b, ih, iw, rpen, row0, lo, hi, col0, WW, c0,
                 chunk, vec_in);
      cp_async_commit();
      int fresh_lo = lo;

#pragma unroll
      for (int s = 0; s < kStrips; ++s) {
        cp_async_wait_all();
        __syncthreads();            // strip s has landed, for every thread
        const int s_lo = lo;
        if (s + 1 < kStrips) {      // strip s+1's fresh rows, in flight
          int nlo, nhi;
          strip_rows(s + 1, nlo, nhi);
          fresh_lo = nlo > hi ? nlo : hi;
          stage_rows(ring, R, in_b, ih, iw, rpen, row0, fresh_lo, nhi, col0,
                     WW, c0, chunk, vec_in);
          cp_async_commit();
          lo = nlo;
          hi = nhi;
        }
        if (!computes) continue;
        // per slot of strip s, the ring row (less the strip's first) and
        // column of tap (0, 0)
        const int base = s_lo % R;
        bool on[kSlots];
        int prow[kSlots], pcol[kSlots];
#pragma unroll
        for (int kk = 0; kk < kSlots; ++kk) {
          const int p = slot_position(s * kSlots + kk);
          on[kk] = p >= 0;
          const int r = on[kk] ? p / wob : 0;
          const int c = on[kk] ? p - r * wob : 0;
          prow[kk] = r * stride - s_lo;
          pcol[kk] = c * stride;
        }
        for (int dh = 0; dh < hf; ++dh) {
          for (int dw = 0; dw < wf; ++dw) {
            int off[kSlots];
#pragma unroll
            for (int kk = 0; kk < kSlots; ++kk) {
              int slot = base + prow[kk] + dh;
              if (slot >= R) slot -= R;
              off[kk] = on[kk] ? (slot * WW + pcol[kk] + dw) * chunk : 0;
            }
            const float* wt = w_s + (dh * wf + dw) * chunk * ldw + l0;
#pragma unroll 4
            for (int c = 0; c < chunk; ++c) {
              float wv[kLanes];
              if constexpr (kVecW) {
                load8(wt + c * ldw, wv);
              } else {
#pragma unroll
                for (int j = 0; j < kLanes; ++j) {
                  wv[j] = (l0 + j < lanes) ? wt[c * ldw + j] : 0.0f;
                }
              }
              float xv[kSlots];
#pragma unroll
              for (int kk = 0; kk < kSlots; ++kk) xv[kk] = ring[off[kk] + c];
#pragma unroll
              for (int kk = 0; kk < kSlots; ++kk) {
#pragma unroll
                for (int j = 0; j < kLanes; ++j) {
                  acc[s * kSlots + kk][j] =
                      fmaf(xv[kk], wv[j], acc[s * kSlots + kk][j]);
                }
              }
            }
          }
        }
      }
    }
  }

  // the window kernel's epilogue: acc + b, activation, + residual, one
  // store; acc keeps the stored values for the GAP rider
  if (computes) {
    float bv[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      bv[j] = (bias != nullptr && l0 + j < lanes)
                  ? bias[o_b * lanes + l0 + j] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPositions; ++k) {
      const int p = slot_position(k);
      if (p >= 0) {
        const size_t o = (((size_t)(n * oblk + o_b) * oh + i0 + p / wob)
                          * ow + j0 + p % wob) * lanes + l0;
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if (l0 + j < lanes) {
            float v = acc[k][j];
            if (bias != nullptr) v += bv[j];
            v = activate(v, act);
            if (residual != nullptr) v += residual[o + j];
            out[o + j] = v;
            acc[k][j] = v;
          } else {
            acc[k][j] = 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kLanes; ++j) acc[k][j] = 0.0f;
      }
    }
  }
  if (partials != nullptr) {
    __syncthreads();                        // the ring is free now
    float* red = smem;                      // [npg, lanes]
    if (computes) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (l0 + j < lanes) {
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < kPositions; ++k) sum += acc[k][j];
          red[pg * lanes + l0 + j] = sum;
        }
      }
    }
    __syncthreads();
    for (int co = t; co < lanes; co += kThreads) {
      float sum = 0.0f;
      for (int g = 0; g < npg; ++g) sum += red[g * lanes + co];
      partials[((size_t)(n * oblk + o_b) * n_tiles + tile) * lanes + co] =
          sum;
    }
  }
}

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

// N: the wgmma width (Cib padded up).  A CTA's band is `strips` strips
// (two or three) of hso x tw positions, one 64-row m-tile each (mstride =
// hso * tw), computed by one consumer warpgroup each; one producer
// warpgroup stages them.  A stage is one copy group per strip: the weights
// and window rows [0, hso + T - 1) for strip 0, then each later strip's
// fresh rows [k * hso + T - 1, (k + 1) * hso + T - 1) (T = ceil(Hf / s),
// the most row taps of a phase), so strip k runs while strip k + 1's rows
// are in flight.
template <int N>
__global__ void __launch_bounds__(dt::kMaxThreads, 1)
stream_dgrad_kernel(const __grid_constant__ CUtensorMap tmw,
                    const __grid_constant__ CUtensorMap tmg,
                    const __grid_constant__ CUtensorMap tmz,
                    float* __restrict__ dx, dt::Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  const dt::Tile t = dt::tile_of(geo, blockIdx.x);
  const int ci_b = blockIdx.y;
  const int n = blockIdx.z;
  const int nth = blockDim.x;
  const int strips = nth / dt::kWarpgroup - 1;
  const int pair = 2 * dt::kWarpgroup;  // one consumer and the producer
  const dt::Smem m = dt::carve<N>(smem, geo);
  const int taps = t.r.taps * t.c.taps;
  const int steps = taps * geo.chunk / 8;
  const int per_block = dt::kpad(geo) / geo.chunk;
  const int stages = taps > 0 ? geo.coblk * per_block : 0;
  const int mh = dt::max_taps(geo.hf, geo.stride) - 1;
  const int hso = geo.th / strips;
  // window rows of copy group k: strip 0's all, a later strip's fresh ones
  auto lo_of = [&](int k) { return k == 0 ? 0 : k * hso + mh; };
  auto hi_of = [&](int k) { return (k + 1) * hso + mh; };
  dt::step_shifts(m.shifts, geo, t);
  if (threadIdx.x == 0) {
    for (int i = 0; i < dt::kSlots * dt::kMaxGroups; ++i) {
      dt::mbar_init(&m.bars[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= strips * dt::kWarpgroup) {   // the producer warpgroup
    const int tid = threadIdx.x - strips * dt::kWarpgroup;
    const int o_h = t.r.q0 + t.a0 - mh;
    const int o_w = t.c.q0 + t.b0 - (dt::max_taps(geo.wf, geo.stride) - 1);
    auto issue_stage = [&](int s) {     // warp 0: stage s's copies
      const int slot = s & 1;
      const int co_b = s / per_block;
      const int c0 = (s % per_block) * geo.chunk;
      uint64_t* bars = &m.bars[slot * dt::kMaxGroups];
      if (tid == 0) {
        for (int k = 0; k < strips; ++k) {
          dt::mbar_expect_tx(&bars[k],
                             (k == 0 ? dt::weight_bytes<N>(geo, t) : 0)
                                 + dt::row_bytes(geo, lo_of(k), hi_of(k)));
        }
      }
      __syncwarp();
      for (int k = 0; k < strips; ++k) {
        if (k == 0) {
          dt::issue_weights<N>(&tmw, m.big + slot * m.wst, &bars[k], geo, t,
                               co_b, ci_b, c0, tid, 32);
        }
        dt::issue_rows(&tmg, &tmz, m.win + slot * m.cst,
                       m.zwin + slot * m.cst, &bars[k], geo, n, co_b, c0,
                       o_h, o_w, lo_of(k), hi_of(k), tid, 32);
      }
    };
    if (tid < 32 && stages > 0) issue_stage(0);
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      for (int k = 0; k < strips; ++k) {
        dt::mbar_wait(&m.bars[slot * dt::kMaxGroups + k], (s >> 1) & 1);
        if (k == 0) {
          dt::split_weights(m.big + slot * m.wst, m.small + slot * m.wst,
                            taps * geo.chunk * N, tid, dt::kWarpgroup);
        }
        if (geo.prologue) {
          dt::prologue_rows(m.win + slot * m.cst, m.zwin + slot * m.cst, geo,
                            lo_of(k), hi_of(k), tid, dt::kWarpgroup);
        }
        dt::fence_proxy_async();
        dt::bar_arrive(dt::kBarFull + slot * dt::kMaxGroups + k, pair);
      }
      if (s + 1 < stages) {
        // the other slot once every strip is done with stage s - 1
        if (s >= 1) dt::bar_sync(dt::kBarEmpty + (slot ^ 1), nth);
        if (tid < 32) issue_stage(s + 1);
      }
    }
    return;
  }

  const int strip = threadIdx.x / dt::kWarpgroup;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int off[2];
  dt::row_offsets(off, geo, strip, 0);
  for (int s = 0; s < stages; ++s) {
    const int slot = s & 1;
    dt::bar_sync(dt::kBarFull + slot * dt::kMaxGroups + strip, pair);
    dt::mma_stage<N>(acc, m.win + slot * m.cst, off, m.shifts, steps,
                     m.big + slot * m.wst, m.small + slot * m.wst);
    if (s + 2 < stages) dt::bar_arrive(dt::kBarEmpty + slot, nth);
  }
  dt::store_dx<N>(dx, acc, geo, t, n, ci_b, strip, 0);
}

// The streamed dgrad's launch geometry: bands of `wgs` strips of hso x tw
// phase positions, one m-tile each.  A strip's rows land as boxes of hso
// rows where a window row fills whole 128-byte lines (each box lands on 128
// bytes), else row by row.
dt::Geometry dgrad_geometry(int coblk, int cob, int ho, int wo, int ciblk,
                            int cib, int hi, int wi, int hf, int wf,
                            int stride, int pad_top, int pad_left, int hso,
                            int tw, int wgs, int chunk, int act,
                            bool prologue) {
  const int wwin = tw + (wf - 1) / stride;
  const int rows = wwin * (chunk + 4) % 32 == 0 ? hso : 1;
  return dt::Geometry{coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf,
                      stride, pad_top, pad_left, wgs * hso, tw, hso * tw,
                      chunk, act, prologue, rows};
}

// The compiled dgrad instances: wgmma widths 8, 16, 32, 64 and 128.
dt::Kernel pick_dgrad(int lanes) {
  switch (lanes) {
    case 8: return stream_dgrad_kernel<8>;
    case 16: return stream_dgrad_kernel<16>;
    case 32: return stream_dgrad_kernel<32>;
    case 64: return stream_dgrad_kernel<64>;
    case 128: return stream_dgrad_kernel<128>;
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// N: the wgmma width (Cob padded up); MPW: m-tiles of (tap, c) rows a
// consumer warpgroup holds.
template <int N, int MPW>
__global__ void __launch_bounds__(wtile::kMaxThreads, 1)
stream_wgrad_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmg,
                    const __grid_constant__ CUtensorMap tmz,
                    const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ z, float* __restrict__ ws,
                    wtile::Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  wtile::run<N, MPW>(smem, &tmx, &tmg, &tmz, x, g, z, ws, geo);
}

// The compiled wgrad instances, as the window wgrad's.
wtile::Kernel pick_wgrad(int lanes, int mpw) {
  switch (lanes * 4 + mpw) {
    case 8 * 4 + 1: return stream_wgrad_kernel<8, 1>;
    case 8 * 4 + 2: return stream_wgrad_kernel<8, 2>;
    case 16 * 4 + 1: return stream_wgrad_kernel<16, 1>;
    case 16 * 4 + 2: return stream_wgrad_kernel<16, 2>;
    case 32 * 4 + 1: return stream_wgrad_kernel<32, 1>;
    case 32 * 4 + 2: return stream_wgrad_kernel<32, 2>;
    case 64 * 4 + 1: return stream_wgrad_kernel<64, 1>;
    case 64 * 4 + 2: return stream_wgrad_kernel<64, 2>;
    case 128 * 4 + 1: return stream_wgrad_kernel<128, 1>;
  }
  return nullptr;
}

// The streamed wgrad's launch geometry: items of hso x wob positions,
// walked column by column.
wtile::Geometry wgrad_geometry(int n, int ciblk, int hi, int wi, int cib,
                               int coblk, int cob, int ho, int wo, int hf,
                               int wf, int stride, int pad_top, int pad_left,
                               int hso, int wob, int wgs, int mpw, int lanes,
                               int splits, int act, int prologue,
                               int with_db) {
  return wtile::Geometry{n, ciblk, cib, hi, wi, coblk, cob, ho, wo, hf, wf,
                         stride, pad_top, pad_left, hso, wob, lanes, wgs,
                         mpw, splits, act, prologue, with_db, 1};
}

}  // namespace

extern "C" {

// The compiled register-tile geometry, for the wrapper's blocking model.
void conv2d_stream_geometry(int* threads, int* lanes, int* positions) {
  *threads = kThreads;
  *lanes = kLanes;
  *positions = kPositions;
}

// The forward; see stream_conv_kernel for the generic names.  Grid:
// (bands, oblk, n).
int conv2d_stream_conv(const void* in, const void* w, const void* bias,
                       const void* residual, void* out, void* partials, int n,
                       int rblk, int ih, int iw, int rpen, int oblk, int lanes,
                       int oh, int ow, int hf, int wf, int stride,
                       int pad_top, int pad_left, int hob, int wob, int hso,
                       int ring_rows, int ring_cols, int chunk, int ldw,
                       int act, int smem_bytes, void* stream) {
  const bool vec = lanes % kLanes == 0;
  const int strips = hob / hso;
  if (hob % hso != 0 || (strips != 1 && strips != 2)) {
    return (int)cudaErrorInvalidValue;    // compiled for 1 or 2 strips
  }
  auto pick = [&](auto one, auto two) { return strips == 1 ? one : two; };
  auto kernel = vec ? pick(stream_conv_kernel<true, 1>,
                           stream_conv_kernel<true, 2>)
                    : pick(stream_conv_kernel<false, 1>,
                           stream_conv_kernel<false, 2>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((oh / hob) * (ow / wob), oblk, n);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)w, (const float*)bias,
      (const float*)residual, (float*)out, (float*)partials, rblk, ih, iw,
      rpen, oblk, lanes, oh, ow, hf, wf, stride, pad_top, pad_left, hob, wob,
      hso, ring_rows, ring_cols, chunk, ldw, act);
  return (int)cudaGetLastError();
}

// The dgrad: bands of `wgs` strips (two or three) of hso x tw phase
// positions, one consumer warpgroup each, the wgmma width `lanes`, `chunk`
// Cob channels a stage.
int conv2d_stream_dgrad(const void* g, const void* z, const void* w, void* dx,
                        int n, int coblk, int cob, int ho, int wo, int ciblk,
                        int cib, int hi, int wi, int hf, int wf, int stride,
                        int pad_top, int pad_left, int hso, int tw, int wgs,
                        int lanes, int chunk, int act, void* stream) {
  const dt::Geometry geo = dgrad_geometry(
      coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top,
      pad_left, hso, tw, wgs, chunk, act, z != nullptr);
  if (wgs < 2 || hso * tw > dt::kRows) return (int)cudaErrorInvalidValue;
  return dt::launch(pick_dgrad(lanes), (const float*)g, (const float*)z,
                    (const float*)w, (float*)dx, n, geo, wgs, lanes,
                    (cudaStream_t)stream);
}

// What conv2d_stream_dgrad runs with the same arguments (dgrad_tile::plan):
// out[0] tiles, out[1] the function's MACs, out[2] tensor-core MACs issued.
int conv2d_stream_dgrad_plan(int n, int coblk, int cob, int ho, int wo,
                             int ciblk, int cib, int hi, int wi, int hf,
                             int wf, int stride, int pad_top, int pad_left,
                             int hso, int tw, int wgs, int lanes, int chunk,
                             long long* out) {
  if (wgs < 2 || hso * tw > dt::kRows || stride < 1 || hso < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  dt::plan(dgrad_geometry(coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf,
                          stride, pad_top, pad_left, hso, tw, wgs, chunk, 0,
                          false),
           n, wgs, lanes, out);
  return 0;
}

// The wgrad tile's compiled limits (as direct_conv2d_bwd_geometry).
void conv2d_stream_wgrad_geometry(int* threads, int* rows, int* positions) {
  *threads = wtile::kMaxThreads;
  *rows = wtile::kRows;
  *positions = wtile::kMaxPositions;
}

// The wgrad: items of hso x wob output positions, `wgs` consumer warpgroups
// of `mpw` m-tiles, the wgmma width `lanes`, `splits` position shares.
int conv2d_stream_wgrad(const void* x, const void* g, const void* z, void* ws,
                        int n, int ciblk, int hi, int wi, int cib, int coblk,
                        int cob, int ho, int wo, int hf, int wf, int stride,
                        int pad_top, int pad_left, int hso, int wob, int wgs,
                        int mpw, int lanes, int splits, int act, int with_db,
                        void* stream) {
  const wtile::Geometry geo = wgrad_geometry(
      n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top,
      pad_left, hso, wob, wgs, mpw, lanes, splits, act, z != nullptr,
      with_db);
  return wtile::launch(pick_wgrad(lanes, mpw), (const float*)x,
                       (const float*)g, (const float*)z, (float*)ws, geo,
                       (cudaStream_t)stream);
}

// What conv2d_stream_wgrad runs with the same arguments (wgrad_tile::plan):
// out[0] items, out[1] the function's MACs, out[2] tensor-core MACs issued,
// out[3] shared memory of a CTA.
int conv2d_stream_wgrad_plan(int n, int ciblk, int hi, int wi, int cib,
                             int coblk, int cob, int ho, int wo, int hf,
                             int wf, int stride, int pad_top, int pad_left,
                             int hso, int wob, int wgs, int mpw, int lanes,
                             int splits, int prologue, long long* out) {
  const wtile::Geometry geo = wgrad_geometry(
      n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top,
      pad_left, hso, wob, wgs, mpw, lanes, splits, 0, prologue, 0);
  if (!wtile::valid(geo) || pick_wgrad(lanes, mpw) == nullptr)
    return (int)cudaErrorInvalidValue;
  wtile::plan(geo, out);
  return 0;
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
