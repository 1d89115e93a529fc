// Streamed (halo-ring) blocked direct convolution, f32 — hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv2d_stream.py:
//   `_stream_conv_kernel` (:78; pallas_call :238 in `stream_forward`)
//                                                     -> stream_fwd_kernel
//                                  (bf16 operands: stream_fwd_kernel_bf16)
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
//   out  [N, Co/Cob, Ho, Wo, Cob]        forward (+ GAP partials per band,
//                                        and the pooled [N, Co] they sum to)
//   dx   [N, Ci/Cib, Hi, Wi, Cib]        dgrad, at the input's shape
//   ws   [splits, |dw| + |db|]           wgrad partial sums, summed in
//                                        split order by the kernel's last
//                                        CTAs (split_sum.cuh)
//
// What differs is how the input reaches shared memory.  On the TPU the
// streamed kernels keep the operands in HBM and drive their own DMA: the
// weight tile is copied once per grid step, and the band's rows arrive as
// strips through a 2-slot ring, strip k+1 in flight while strip k computes,
// the `Hf - stride` halo rows moved slot to slot instead of re-read.  Here:
//
// * The forward (stream_fwd_kernel) is the dense forward tile of
//   fwd_tile.cuh (an implicit GEMM in 3xTF32 over the band's output
//   positions, A read from the staged window at each row's own offset, B
//   the weight chunk written transposed in core-matrix order), streamed:
//   one CTA per (band of two or three strips of hso x tw output positions,
//   output block or half of one, image), one consumer warpgroup per strip
//   and a producer warpgroup.  Per stage (Ci block, chunk) the band's input
//   rows reach a two-slot ring by cp.async, one copy group per strip: the
//   weight chunk and strip 0's rows, then each later strip's fresh rows
//   (those the strip before does not share), so strip k computes while
//   strip k+1's rows are in flight, and the next stage's groups are in
//   flight while this one computes.  Each halo row comes from device memory
//   once a stage.  The sum runs in the window forward's order, so where
//   both take the same chunk the two forwards agree bit for bit.
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
//   producer of the CTAs of Ci block 0 and m-tile group 0.  Its bf16 build
//   (stream_wgrad_kernel_bf16) is wgrad_tile.cuh's bf16 GEMM on dz (formed
//   once a layer by direct_conv2d_bwd.cu's dz pass, which sums db) in the
//   same column walk, each stage's whole window landing by TMA in 128-byte
//   swizzled rows, where a row moved between slots would change its swizzle.
//
// What bounds them on this card: the TF32 tensor-core rate spent three
// times over by the split, held below it by the producer's per-stage copies,
// passes and barriers (fwd_tile.cuh, dgrad_tile.cuh, wgrad_tile.cuh,
// direct_conv2d_fwd.cu, direct_conv2d_bwd.cu).
//
// C interface for ctypes: pointers and the stream as void*, ints as int (the
// forward's plan as one int array, built once per shape); each entry point
// returns cudaGetLastError() after its launch (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "dgrad_tile.cuh"
#include "fwd_tile.cuh"
#include "wgrad_tile.cuh"

namespace {

namespace dt = dgrad_tile;
namespace ft = fwd_tile;
namespace wtile = wgrad_tile;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// N: the wgmma width (the output lanes a CTA owns, padded up).  A CTA's
// band is `strips` strips (two or three) of hso x tw output positions, one
// m-tile each, computed by one consumer warpgroup each; the producer stages
// the weights and strip 0's window rows as one copy group, then each later
// strip's fresh rows as a group of its own.
template <int N>
__global__ void __launch_bounds__(ft::max_threads(N), 1)
stream_fwd_kernel(const __grid_constant__ CUtensorMap tmw,
                  const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual,
                  float* __restrict__ out, float* partials,
                  float* __restrict__ pooled, int* counters, ft::Geometry g) {
  extern __shared__ __align__(16) float smem[];
  ft::run<N>(smem, &tmw, x, w, bias, residual, out, partials, pooled,
             counters, g);
}

const void* const kFwdKernels[] = {
    (const void*)stream_fwd_kernel<8>, (const void*)stream_fwd_kernel<16>,
    (const void*)stream_fwd_kernel<32>, (const void*)stream_fwd_kernel<64>,
    (const void*)stream_fwd_kernel<128>};

// The bf16 build (fwd_tile.cuh, namespace bf16): bf16 x, w, residual, out
// and pooled features, an f32 bias and f32 partials; the window build's
// persistent walk, a strip one 64-row m-tile of the band's flattened plane
// rows and its fresh rows one copy group.
template <int N>
__global__ void __launch_bounds__(ft::bf16::max_threads(N), 1)
stream_fwd_kernel_bf16(const __grid_constant__ CUtensorMap tmw,
                       const __grid_constant__ CUtensorMap tmx,
                       const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ residual,
                       __nv_bfloat16* __restrict__ out, float* partials,
                       __nv_bfloat16* __restrict__ pooled, int* counters,
                       ft::Geometry g, int n) {
  extern __shared__ __align__(16) char smem_bf16[];
  ft::bf16::run<N>(smem_bf16, &tmw, &tmx, x, w, bias, residual, out,
                   partials, pooled, counters, g, n);
}

const void* const kFwdKernelsBf16[] = {
    (const void*)stream_fwd_kernel_bf16<8>,
    (const void*)stream_fwd_kernel_bf16<16>,
    (const void*)stream_fwd_kernel_bf16<32>,
    (const void*)stream_fwd_kernel_bf16<64>,
    (const void*)stream_fwd_kernel_bf16<128>};

// by a plan's operand type (as direct_conv2d_fwd's)
const void* const* const kFwdTables[] = {kFwdKernels, kFwdKernelsBf16};

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
                    const float* __restrict__ g, const float* __restrict__ z,
                    const float* __restrict__ w, float* __restrict__ dx,
                    dt::Geometry geo) {
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
  const int stages = taps > 0 ? geo.co_count * per_block : 0;
  const int mh = dt::reach_h(geo);
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
    const int o_w = t.c.q0 + t.b0 - dt::reach_w(geo);
    const bool tma = dt::tma_copies(geo);
    // stage s's copies: TMA by warp 0, or cp.async by every thread, one
    // commit group a strip
    auto issue_stage = [&](int s) {
      const int slot = s & 1;
      const int co_b = geo.co_first + s / per_block;
      const int c0 = (s % per_block) * geo.chunk;
      if (!tma) {
        for (int k = 0; k < strips; ++k) {
          if (k == 0) {
            dt::copy_weights<N>(w, m.big + slot * m.wst, geo, t, co_b, ci_b,
                                c0, tid);
          }
          dt::copy_rows(g, z, m.win + slot * m.cst, m.zwin + slot * m.cst,
                        geo, n, co_b, c0, o_h, o_w, lo_of(k), hi_of(k), tid);
          dt::cp_async_commit();
        }
        return;
      }
      if (tid >= 32) return;
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
    if (stages > 0) issue_stage(0);
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      for (int k = 0; k < strips; ++k) {
        if (tma) {
          dt::mbar_wait(&m.bars[slot * dt::kMaxGroups + k], (s >> 1) & 1);
        } else {                        // every producer thread's strip k
          dt::cp_async_wait(strips - 1 - k);
          dt::bar_sync(dt::kBarProducer, dt::kWarpgroup);
        }
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
        issue_stage(s + 1);
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
  dt::store_dx<N>(dx, acc, geo, t, n, ci_b, strip, 0, geo.co_first > 0);
}

// The streamed dgrad's launch geometry: bands of `wgs` strips of hso x tw
// phase positions, one m-tile each.  A strip's rows land as boxes of hso
// rows where a window row fills whole 128-byte lines (each box lands on 128
// bytes), else row by row.  `bf16` for the bf16 build: boxes of hso rows
// always (its rows are padded to 128 bytes, dgrad_tile::bf16::wpitch), and
// a strip's m-tile starts hso window rows of wpitch cells on.  Dense only:
// groups 1 and no dilation (the C entries refuse any other).
dt::Geometry dgrad_geometry(int coblk, int cob, int ho, int wo, int ciblk,
                            int cib, int hi, int wi, int hf, int wf,
                            int stride, int pad_top, int pad_left, int hso,
                            int tw, int wgs, int chunk, int act,
                            bool prologue, bool bf16 = false) {
  const int wwin = tw + (wf - 1) / stride;
  // a row's cells (chunk + 4 floats) in 128-byte lines
  const int rows = bf16 || wwin * (chunk + 4) % 32 == 0 ? hso : 1;
  dt::Geometry geo{coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf,
                   stride, pad_top, pad_left, wgs * hso, tw, hso * tw,
                   chunk, act, prologue, rows};
  geo.groups = 1;
  geo.dil_h = geo.dil_w = 1;
  geo = dt::with_steps(geo);
  if (bf16 && chunk > 0) geo.mstride = hso * dt::bf16::wpitch(geo);
  return geo;
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

// The bf16 build of the same streamed tile (dgrad_tile.cuh, namespace
// bf16): bf16 g, z, w and dx, f32 sums, every Co block in one persistent
// grid over the `n` images' (band, Ci block) items; a strip is one 64-row
// m-tile of the band's flattened window cells, its fresh rows one copy
// group, and the producer forms dz in place as each group lands.
template <int N>
__global__ void __launch_bounds__(dt::bf16::max_threads(N), 1)
stream_dgrad_kernel_bf16(const __grid_constant__ CUtensorMap tmw,
                         const __grid_constant__ CUtensorMap tmg,
                         const __grid_constant__ CUtensorMap tmz,
                         const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ z,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ dx, dt::Geometry geo,
                         int n) {
  extern __shared__ __align__(16) char smem_bf16[];
  dt::bf16::run<N, true>(smem_bf16, &tmw, &tmg, &tmz, g, z, w, dx, geo, n);
}

dt::bf16::Kernel pick_dgrad_bf16(int lanes) {
  switch (lanes) {
    case 8: return stream_dgrad_kernel_bf16<8>;
    case 16: return stream_dgrad_kernel_bf16<16>;
    case 32: return stream_dgrad_kernel_bf16<32>;
    case 64: return stream_dgrad_kernel_bf16<64>;
    case 128: return stream_dgrad_kernel_bf16<128>;
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
                    const float* __restrict__ z, float* ws, float* out,
                    int* counters, wtile::Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  wtile::run<N, MPW>(smem, &tmx, &tmg, &tmz, x, g, z, ws, out, counters,
                     geo);
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

// The bf16 build of the same streamed GEMM (wgrad_tile.cuh, namespace
// bf16): bf16 x and dz, the f32 workspace and sums; the tiles walked column
// by column, each stage's whole window staged.
template <int N, int MPW>
__global__ void __launch_bounds__(wtile::bf16::max_threads(N, MPW), 1)
stream_wgrad_kernel_bf16(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmd,
                         const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dz, float* ws,
                         float* out, int* counters, wtile::Geometry geo,
                         const __grid_constant__ wtile::bf16::Steps steps) {
  extern __shared__ __align__(16) char smem_bf16[];
  wtile::bf16::run<N, MPW>(smem_bf16, &tmx, &tmd, x, dz, ws, out, counters,
                           geo, steps);
}

wtile::KernelBf16 pick_wgrad_bf16(int lanes, int mpw) {
  switch (lanes * 4 + mpw) {
    case 64 * 4 + 1: return stream_wgrad_kernel_bf16<64, 1>;
    case 64 * 4 + 2: return stream_wgrad_kernel_bf16<64, 2>;
    case 128 * 4 + 1: return stream_wgrad_kernel_bf16<128, 1>;
  }
  return nullptr;
}

// The streamed wgrad's launch geometry: items of hso x wob positions,
// walked column by column; dense only (groups 1, no dilation).
wtile::Geometry wgrad_geometry(int n, int ciblk, int hi, int wi, int cib,
                               int coblk, int cob, int ho, int wo, int hf,
                               int wf, int stride, int pad_top, int pad_left,
                               int hso, int wob, int wgs, int mpw, int lanes,
                               int splits, int act, int prologue,
                               int with_db) {
  return wtile::Geometry{n, ciblk, cib, hi, wi, coblk, cob, ho, wo, hf, wf,
                         stride, pad_top, pad_left, hso, wob, lanes, wgs,
                         mpw, splits, act, prologue, with_db, 1, 1, 1, 1};
}

// Whether a backward's grouped and dilated arguments are dense ones: the
// streamed dgrads and wgrads take them as the window ones do, and refuse
// anything but groups 1 and dilation 1.
bool dense_args(int groups, int dil_h, int dil_w) {
  return groups == 1 && dil_h == 1 && dil_w == 1;
}

// Whether a forward plan's geometry is dense: groups 1, no dilation.
bool dense_plan(const int* plan) {
  ft::Geometry g;
  memcpy(&g, plan, sizeof(g));
  return g.groups == 1 && g.dil_h == 1 && g.dil_w == 1;
}

}  // namespace

extern "C" {

// The compiled forward tile's limits (as direct_conv2d_fwd_geometry).
void conv2d_stream_geometry(int* threads, int* rows, int* consumers) {
  *threads = ft::kMaxThreads;
  *rows = ft::kRows;
  *consumers = ft::kMaxConsumers;
}

// The forward: bands of `wgs` strips of hso x tw output positions.  plan:
// the fwd_tile::Geometry fields in order (strips == wgs), then the wgmma
// width, the images, the dynamic shared memory and the operand type (0:
// f32; 1: the bf16 build, as direct_conv2d_fwd's).  Grid: (bands, Co
// blocks x nsplit, images); the bf16 build's persistent.  GAP as
// direct_conv2d_fwd's.  Dense only, as the reference's streamed kernels:
// a plan with groups other than 1 or a dilation is refused
// (cudaErrorInvalidValue).
int conv2d_stream_conv(const void* x, const void* w, const void* bias,
                       const void* residual, void* out, void* partials,
                       void* pooled, void* counters, const int* plan,
                       void* stream) {
  if (!dense_plan(plan)) return (int)cudaErrorInvalidValue;
  return ft::launch(kFwdTables, true, x, w, bias, residual, out, partials,
                    pooled, counters, plan, (cudaStream_t)stream);
}

// What conv2d_stream_conv runs with the same plan (fwd_tile::plan_of):
// out[0] an image's bands, out[1] the function's MACs, out[2] the
// tensor-core MACs issued, out[3] a CTA's shared memory, out[4] and out[5]
// its window and weight slots.
int conv2d_stream_conv_plan(const int* plan, long long* out) {
  if (!dense_plan(plan)) return (int)cudaErrorInvalidValue;
  return ft::plan_of(true, plan, out);
}

// The dgrad: bands of `wgs` strips (two or three) of hso x tw phase
// positions, one consumer warpgroup each, the wgmma width `lanes`, `chunk`
// Cob channels a stage; `*launches` is how many grids it launched
// (dgrad_tile::launch).  Dense only, as the reference's streamed kernels:
// groups other than 1 or a dilation are refused (cudaErrorInvalidValue).
int conv2d_stream_dgrad(const void* g, const void* z, const void* w, void* dx,
                        int n, int coblk, int cob, int ho, int wo, int ciblk,
                        int cib, int hi, int wi, int hf, int wf, int stride,
                        int pad_top, int pad_left, int hso, int tw, int wgs,
                        int lanes, int chunk, int groups, int dil_h,
                        int dil_w, int act, void* stream, int* launches) {
  *launches = 0;
  const dt::Geometry geo = dgrad_geometry(
      coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top,
      pad_left, hso, tw, wgs, chunk, act, z != nullptr);
  if (!dense_args(groups, dil_h, dil_w) || wgs < 2 || hso * tw > dt::kRows)
    return (int)cudaErrorInvalidValue;
  return dt::launch(pick_dgrad(lanes), (const float*)g, (const float*)z,
                    (const float*)w, (float*)dx, n, geo, wgs, lanes,
                    (cudaStream_t)stream, launches);
}

// What conv2d_stream_dgrad runs with the same arguments (dgrad_tile::plan):
// out[0] tiles, out[1] the function's MACs, out[2] tensor-core MACs issued,
// out[3] a CTA's shared memory, out[4] and out[5] its ring's slots; z staged
// beside the cotangent where `prologue`.
int conv2d_stream_dgrad_plan(int n, int coblk, int cob, int ho, int wo,
                             int ciblk, int cib, int hi, int wi, int hf,
                             int wf, int stride, int pad_top, int pad_left,
                             int hso, int tw, int wgs, int lanes, int chunk,
                             int groups, int dil_h, int dil_w, int prologue,
                             long long* out) {
  if (!dense_args(groups, dil_h, dil_w) || wgs < 2 || hso * tw > dt::kRows
      || stride < 1 || hso < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  dt::plan(dgrad_geometry(coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf,
                          stride, pad_top, pad_left, hso, tw, wgs, chunk, 0,
                          prologue != 0),
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
// of `mpw` m-tiles, the wgmma width `lanes`, `splits` position shares into
// `ws`, summed by each column's last CTA into `out` (as
// direct_conv2d_wgrad, whose plan it takes with hso, wob for th, tw; dense
// only: its groups and dilation must be 1).
int conv2d_stream_wgrad(const void* x, const void* g, const void* z, void* ws,
                        void* out, void* counters, const int* p,
                        void* stream) {
  if (!dense_args(p[20], p[21], p[22]) || p[23] != 0)
    return (int)cudaErrorInvalidValue;
  const wtile::Geometry geo = wgrad_geometry(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19], p[24],
      z != nullptr, p[25]);
  return wtile::launch(pick_wgrad(geo.lanes, geo.mpw), (const float*)x,
                       (const float*)g, (const float*)z, (float*)ws,
                       (float*)out, (int*)counters, geo,
                       (cudaStream_t)stream);
}

// What conv2d_stream_wgrad runs with the same arguments (wgrad_tile::plan):
// out[0] items, out[1] the function's MACs, out[2] tensor-core MACs issued,
// out[3] shared memory of a CTA.
int conv2d_stream_wgrad_plan(int n, int ciblk, int hi, int wi, int cib,
                             int coblk, int cob, int ho, int wo, int hf,
                             int wf, int stride, int pad_top, int pad_left,
                             int hso, int wob, int wgs, int mpw, int lanes,
                             int splits, int groups, int dil_h, int dil_w,
                             int narrow, int prologue, long long* out) {
  if (!dense_args(groups, dil_h, dil_w) || narrow != 0)
    return (int)cudaErrorInvalidValue;
  const wtile::Geometry geo = wgrad_geometry(
      n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top,
      pad_left, hso, wob, wgs, mpw, lanes, splits, 0, prologue, 0);
  if (!wtile::valid(geo) || pick_wgrad(lanes, mpw) == nullptr)
    return (int)cudaErrorInvalidValue;
  wtile::plan(geo, out);
  return 0;
}

// The bf16 build of conv2d_stream_dgrad (bf16 g, z, w and dx), the same
// arguments; one grid always.
int conv2d_stream_dgrad_bf16(const void* g, const void* z, const void* w,
                             void* dx, int n, int coblk, int cob, int ho,
                             int wo, int ciblk, int cib, int hi, int wi,
                             int hf, int wf, int stride, int pad_top,
                             int pad_left, int hso, int tw, int wgs,
                             int lanes, int chunk, int groups, int dil_h,
                             int dil_w, int act, void* stream,
                             int* launches) {
  *launches = 0;
  dt::Geometry geo = dgrad_geometry(
      coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top,
      pad_left, hso, tw, wgs, chunk, act, z != nullptr, true);
  geo.co_first = 0;
  geo.co_count = coblk;
  if (!dense_args(groups, dil_h, dil_w) || wgs < 2)
    return (int)cudaErrorInvalidValue;
  return dt::bf16::launch(pick_dgrad_bf16(lanes),
                          (const __nv_bfloat16*)g, (const __nv_bfloat16*)z,
                          (const __nv_bfloat16*)w, (__nv_bfloat16*)dx, n,
                          geo, wgs, lanes, (cudaStream_t)stream, launches);
}

// What conv2d_stream_dgrad_bf16 runs (dgrad_tile::bf16::plan).
int conv2d_stream_dgrad_bf16_plan(int n, int coblk, int cob, int ho, int wo,
                                  int ciblk, int cib, int hi, int wi, int hf,
                                  int wf, int stride, int pad_top,
                                  int pad_left, int hso, int tw, int wgs,
                                  int lanes, int chunk, int groups,
                                  int dil_h, int dil_w, int prologue,
                                  long long* out) {
  if (!dense_args(groups, dil_h, dil_w) || wgs < 2 || stride < 1 || hso < 1
      || tw < 1 || chunk < 16)
    return (int)cudaErrorInvalidValue;
  dt::Geometry geo = dgrad_geometry(coblk, cob, ho, wo, ciblk, cib, hi, wi,
                                    hf, wf, stride, pad_top, pad_left, hso,
                                    tw, wgs, chunk, 0, prologue != 0,
                                    true);
  geo.co_first = 0;
  geo.co_count = coblk;
  if (!dt::bf16::valid(geo, wgs, lanes)) return (int)cudaErrorInvalidValue;
  dt::bf16::plan(geo, n, wgs, lanes, out);
  return 0;
}

// The bf16 build of conv2d_stream_wgrad on dz (`g` takes dz; `z` null and
// with_db 0, as direct_conv2d_wgrad_bf16), the same plan.
int conv2d_stream_wgrad_bf16(const void* x, const void* g, const void* z,
                             void* ws, void* out, void* counters,
                             const int* p, void* stream) {
  // the narrow rows (p[23]) are the window kernel's alone
  if (!dense_args(p[20], p[21], p[22]) || p[23] != 0)
    return (int)cudaErrorInvalidValue;
  const wtile::Geometry geo = wgrad_geometry(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19], p[24],
      z != nullptr, p[25]);
  return wtile::launch_bf16(pick_wgrad_bf16(geo.lanes, geo.mpw),
                            (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
                            (float*)ws, (float*)out, (int*)counters, geo,
                            (cudaStream_t)stream);
}

// What conv2d_stream_wgrad_bf16 runs (wgrad_tile::bf16::plan).
int conv2d_stream_wgrad_bf16_plan(int n, int ciblk, int hi, int wi, int cib,
                                  int coblk, int cob, int ho, int wo, int hf,
                                  int wf, int stride, int pad_top,
                                  int pad_left, int hso, int wob, int wgs,
                                  int mpw, int lanes, int splits, int groups,
                                  int dil_h, int dil_w, int narrow,
                                  int prologue, long long* out) {
  if (!dense_args(groups, dil_h, dil_w) || narrow != 0)
    return (int)cudaErrorInvalidValue;
  const wtile::Geometry geo = wgrad_geometry(
      n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top,
      pad_left, hso, wob, wgs, mpw, lanes, splits, 0, prologue, 0);
  if (!wtile::valid_bf16(geo) || pick_wgrad_bf16(lanes, mpw) == nullptr)
    return (int)cudaErrorInvalidValue;
  wtile::bf16::plan(geo, out);
  return 0;
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
