// Blocked direct convolution, backward, f32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   `_dgrad_kernel` (src/repro/kernels/direct_conv2d.py:138, pallas_call :498)
//   `_wgrad_kernel` (src/repro/kernels/direct_conv2d.py:175, pallas_call :638)
// and the transposes `_conv_bwd` (:717) wraps around them.  Layouts are the
// paper's blocked ones, as in the forward (direct_conv2d_fwd.cu):
//
//   x   [N, Ci/Cib, Hi, Wi, Cib]   the forward's UNPADDED input
//   g   [N, Co/Cob, Ho, Wo, Cob]   raw cotangent of the conv's output
//   z   [N, Co/Cob, Ho, Wo, Cob]   saved pre-activation, or null (linear)
//   w   [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]
//   dx  [N, Ci/Cib, Hi, Wi, Cib]   written at the unpadded shape
//   dw  [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob] f32, db [Co/Cob, Cob] f32
//
// with dz = g * act'(z) (relu, tanh-gelu) formed once per staged element of
// g — the reference's `cotangent_prologue`.
//
// dgrad (`dgrad_kernel`): the reference runs a stride-1 conv with mirrored
// taps over a stride-dilated, halo-padded copy of the cotangent and crops
// dx; at stride 2 three of every four of its taps read a stride hole.  Here
// dx is split by its phase against the stride, and each phase is an
// implicit GEMM over only the taps it reaches, on the tensor cores in
// 3xTF32 (f32 accuracy): the core is dgrad_tile.cuh, which says how.  This
// kernel is its window form: one CTA per (tile of th x tw positions of one
// phase, Ci block, image), all phases in one grid; one to three consumer
// warpgroups of 64 rows each run the wgmmas, and a producer warpgroup
// stages each stage (Co block, chunk of Cob channels) as one TMA copy
// group, the phase's weight chunk and the whole cotangent window of the
// tile (z beside it), a stage ahead in a two-slot ring, then splits the
// weights and forms dz.
//
// What bounds it on this card: the function does 2*9*Ci*Co FLOPs per input
// position for a few bytes, far above the ridge, so the tensor cores' TF32
// rate, which the three-product split spends three times over (the f32
// FMA rate that bound the earlier kernel is 67 TFLOP/s; TF32 wgmma 495).
// In practice the producer's passes (the split and the prologue, once per
// stage for the whole window) and the per-stage barriers hold it below
// that, most at stride 2, where a phase's few taps give a stage few wgmmas
// while its window costs what a stride-1 window does.
//
// wgrad (`wgrad_kernel`): the reference walks the N*Ho*Wo reduction as a
// sequential grid axis into one resident [Hf, Wf, Cib, Cob] accumulator;
// blocks run in no order on Hopper.  Here the wgrad is an implicit GEMM on
// the tensor cores in 3xTF32, rows the (tap, c) pairs, columns Cob, K the
// output positions: the core is wgrad_tile.cuh, which says how.  This kernel
// is its window form: one CTA per (m-tile group, position share, Ci block,
// Co block); a producer warpgroup stages each tile's whole x window and its
// g and z by cp.async a slot ahead, forms dz and writes it transposed, and
// one to three consumer warpgroups run the wgmmas of their m-tiles on it.
// Each share's sums go to its row of an f32 workspace [splits, |dw| + |db|],
// and the last CTA of each column of shares sums the rows in split order
// into dw and db (split_sum.cuh): one launch, no second pass.  No sum
// depends on the order CTAs run in: two runs give identical bits.  db rides
// the producer of the CTAs of Ci block 0 and m-tile group 0, so it is
// summed once per Co block (the reference's `ci == 0` pass).
//
// What bounds it on this card: the forward's FLOPs (2*9*Ci per output
// element, far above the ridge), at the TF32 tensor-core rate spent three
// times over by the split.  In practice the stage's copies and the
// producer's pass (dz formed, split and transposed once per m-tile group),
// whose latency a two-slot ring hides only while a stage's wgmmas outlast
// it; at stride 2 the x window is four times a tile's positions.
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after its launch (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "dgrad_tile.cuh"
#include "wgrad_tile.cuh"

namespace {

namespace dt = dgrad_tile;
namespace wtile = wgrad_tile;

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

// N: the wgmma width (Cib padded up).  A CTA is `wgs` consumer warpgroups,
// each 64 rows of the tile (position p in warpgroup p / 64; mstride = 64 *
// wgs), and one producer warpgroup that stages, splits and forms dz one
// stage ahead of them: a stage is one copy group, the weights and the
// whole cotangent window of the tile.
template <int N>
__global__ void __launch_bounds__(dt::kMaxThreads, 1)
dgrad_kernel(const __grid_constant__ CUtensorMap tmw,
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
  const int consumers = nth - dt::kWarpgroup;
  const dt::Smem m = dt::carve<N>(smem, geo);
  const int taps = t.r.taps * t.c.taps;
  const int steps = taps * geo.chunk / 8;
  const int per_block = dt::kpad(geo) / geo.chunk;
  const int stages = taps > 0 ? geo.co_count * per_block : 0;
  dt::step_shifts(m.shifts, geo, t);
  if (threadIdx.x == 0) {
    for (int i = 0; i < dt::kSlots; ++i) {
      dt::mbar_init(&m.bars[i * dt::kMaxGroups], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    const int rows = dt::hwin(geo);
    const int o_h = t.r.q0 + t.a0 - (dt::max_taps(geo.hf, geo.stride) - 1);
    const int o_w = t.c.q0 + t.b0 - (dt::max_taps(geo.wf, geo.stride) - 1);
    const bool tma = dt::tma_copies(geo);
    // stage s's copies: TMA by warp 0, or cp.async by every thread
    auto issue_stage = [&](int s) {
      const int slot = s & 1;
      const int co_b = geo.co_first + s / per_block;
      const int c0 = (s % per_block) * geo.chunk;
      if (!tma) {
        dt::copy_weights<N>(w, m.big + slot * m.wst, geo, t, co_b, ci_b, c0,
                            tid);
        dt::copy_rows(g, z, m.win + slot * m.cst, m.zwin + slot * m.cst, geo,
                      n, co_b, c0, o_h, o_w, 0, rows, tid);
        dt::cp_async_commit();
        return;
      }
      if (tid >= 32) return;
      uint64_t* bar = &m.bars[slot * dt::kMaxGroups];
      if (tid == 0) {
        dt::mbar_expect_tx(bar, dt::weight_bytes<N>(geo, t)
                                    + dt::row_bytes(geo, 0, rows));
      }
      __syncwarp();
      dt::issue_weights<N>(&tmw, m.big + slot * m.wst, bar, geo, t, co_b,
                           ci_b, c0, tid, 32);
      dt::issue_rows(&tmg, &tmz, m.win + slot * m.cst,
                     m.zwin + slot * m.cst, bar, geo, n, co_b, c0, o_h, o_w,
                     0, rows, tid, 32);
    };
    if (stages > 0) issue_stage(0);
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      if (tma) {
        dt::mbar_wait(&m.bars[slot * dt::kMaxGroups], (s >> 1) & 1);
      } else {                          // every producer thread's copies
        dt::cp_async_wait(0);
        dt::bar_sync(dt::kBarProducer, dt::kWarpgroup);
      }
      dt::split_weights(m.big + slot * m.wst, m.small + slot * m.wst,
                        taps * geo.chunk * N, tid, dt::kWarpgroup);
      if (geo.prologue) {
        dt::prologue_rows(m.win + slot * m.cst, m.zwin + slot * m.cst, geo,
                          0, rows, tid, dt::kWarpgroup);
      }
      dt::fence_proxy_async();
      dt::bar_arrive(dt::kBarFull + slot * dt::kMaxGroups, nth);
      if (s + 1 < stages) {
        // the other slot once the consumers are done with stage s - 1
        if (s >= 1) dt::bar_sync(dt::kBarEmpty + (slot ^ 1), nth);
        issue_stage(s + 1);
      }
    }
    return;
  }

  const int q0 = threadIdx.x / dt::kWarpgroup * dt::kRows;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int off[2];
  dt::row_offsets(off, geo, 0, q0);
  for (int s = 0; s < stages; ++s) {
    const int slot = s & 1;
    dt::bar_sync(dt::kBarFull + slot * dt::kMaxGroups, nth);
    dt::mma_stage<N>(acc, m.win + slot * m.cst, off, m.shifts, steps,
                     m.big + slot * m.wst, m.small + slot * m.wst);
    if (s + 2 < stages) dt::bar_arrive(dt::kBarEmpty + slot, nth);
  }
  dt::store_dx<N>(dx, acc, geo, t, n, ci_b, 0, q0, geo.co_first > 0);
}

// The window dgrad's launch geometry: tiles of th x tw phase positions, one
// m-tile of 64 * wgs rows, the whole window one TMA box.
dt::Geometry dgrad_geometry(int coblk, int cob, int ho, int wo, int ciblk,
                            int cib, int hi, int wi, int hf, int wf,
                            int stride, int pad_top, int pad_left, int th,
                            int tw, int wgs, int chunk, int act,
                            bool prologue) {
  return dt::Geometry{coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf,
                      stride, pad_top, pad_left, th, tw, dt::kRows * wgs,
                      chunk, act, prologue, th + (hf - 1) / stride};
}

// The compiled dgrad instances: wgmma widths 8, 16, 32, 64 and 128.
dt::Kernel pick_dgrad(int lanes) {
  switch (lanes) {
    case 8: return dgrad_kernel<8>;
    case 16: return dgrad_kernel<16>;
    case 32: return dgrad_kernel<32>;
    case 64: return dgrad_kernel<64>;
    case 128: return dgrad_kernel<128>;
  }
  return nullptr;
}

// The bf16 build of the same tile (dgrad_tile.cuh, namespace bf16): bf16 g,
// z, w and dx, f32 sums, every Co block in one grid.  The producer forms dz
// in place once a stage lands; there is no weight split.
template <int N>
__global__ void __launch_bounds__(dt::bf16::max_threads(N), 1)
dgrad_kernel_bf16(const __grid_constant__ CUtensorMap tmw,
                  const __grid_constant__ CUtensorMap tmg,
                  const __grid_constant__ CUtensorMap tmz,
                  const __nv_bfloat16* __restrict__ g,
                  const __nv_bfloat16* __restrict__ z,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ dx, dt::Geometry geo) {
  namespace db = dt::bf16;
  extern __shared__ __align__(16) char smem_bf16[];
  const dt::Tile t = dt::tile_of(geo, blockIdx.x);
  const int ci_b = blockIdx.y;
  const int n = blockIdx.z;
  const int nth = blockDim.x;
  const int consumers = nth - dt::kWarpgroup;
  const db::Smem m = db::carve<N>(smem_bf16, geo);
  const int taps = t.r.taps * t.c.taps;
  const int steps = taps * geo.chunk / 16;
  const int per_block = db::kpad(geo) / geo.chunk;
  const int stages = taps > 0 ? geo.coblk * per_block : 0;
  const bool tma = db::tma_copies(geo);
  db::step_shifts(m.shifts, geo, t);
  if (threadIdx.x == 0) {
    for (int i = 0; i < dt::kSlots; ++i) {
      dt::mbar_init(&m.bars[i * dt::kMaxGroups], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    const int rows = dt::hwin(geo);
    const int o_h = t.r.q0 + t.a0 - (dt::max_taps(geo.hf, geo.stride) - 1);
    const int o_w = t.c.q0 + t.b0 - (dt::max_taps(geo.wf, geo.stride) - 1);
    auto issue_stage = [&](int s) {
      const int slot = s & 1;
      const int co_b = s / per_block;
      const int c0 = (s % per_block) * geo.chunk;
      if (!tma) {
        db::copy_weights<N>(w, m.wts + slot * m.wst, geo, t, co_b, ci_b, c0,
                            tid);
        db::copy_rows(g, z, m.win + slot * m.cst, m.zwin + slot * m.cst, geo,
                      n, co_b, c0, o_h, o_w, 0, rows, tid);
        dt::cp_async_commit();
        return;
      }
      if (tid >= 32) return;
      uint64_t* bar = &m.bars[slot * dt::kMaxGroups];
      if (tid == 0) {
        dt::mbar_expect_tx(bar, db::weight_bytes<N>(geo, t)
                                    + db::row_bytes(geo, 0, rows));
      }
      __syncwarp();
      db::issue_weights<N>(&tmw, m.wts + slot * m.wst, bar, geo, t, co_b,
                           ci_b, c0, tid, 32);
      db::issue_rows(&tmg, &tmz, m.win + slot * m.cst, m.zwin + slot * m.cst,
                     bar, geo, n, co_b, c0, o_h, o_w, 0, rows, tid, 32);
    };
    if (stages > 0) issue_stage(0);
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      if (tma) {
        dt::mbar_wait(&m.bars[slot * dt::kMaxGroups], (s >> 1) & 1);
      } else {                          // every producer thread's copies
        dt::cp_async_wait(0);
        dt::bar_sync(dt::kBarProducer, dt::kWarpgroup);
      }
      if (geo.prologue) {
        db::prologue_rows(m.win + slot * m.cst, m.zwin + slot * m.cst, geo, 0,
                          rows, tid, dt::kWarpgroup);
      }
      dt::fence_proxy_async();
      dt::bar_arrive(dt::kBarFull + slot * dt::kMaxGroups, nth);
      if (s + 1 < stages) {
        if (s >= 1) dt::bar_sync(dt::kBarEmpty + (slot ^ 1), nth);
        issue_stage(s + 1);
      }
    }
    return;
  }

  const int q0 = threadIdx.x / dt::kWarpgroup * dt::kRows;
  float total[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) total[i] = 0.0f;
  int off[2];
  db::row_offsets(off, geo, 0, q0);
  for (int s = 0; s < stages; ++s) {
    const int slot = s & 1;
    dt::bar_sync(dt::kBarFull + slot * dt::kMaxGroups, nth);
    // the weights' TMA copy, which the wgmmas read, has landed
    if (tma) dt::mbar_wait(&m.bars[slot * dt::kMaxGroups], (s >> 1) & 1);
    db::mma_stage<N, (N > 64 ? 64 : N)>(total, m.win + slot * m.cst, off,
                                        m.shifts, steps,
                                        m.wts + slot * m.wst);
    if (s + 2 < stages) dt::bar_arrive(dt::kBarEmpty + slot, nth);
  }
  db::store_dx<N>(dx, total, geo, t, n, ci_b, 0, q0);
}

// The compiled bf16 dgrad instances, as the f32 ones.
dt::bf16::Kernel pick_dgrad_bf16(int lanes) {
  switch (lanes) {
    case 8: return dgrad_kernel_bf16<8>;
    case 16: return dgrad_kernel_bf16<16>;
    case 32: return dgrad_kernel_bf16<32>;
    case 64: return dgrad_kernel_bf16<64>;
    case 128: return dgrad_kernel_bf16<128>;
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
wgrad_kernel(const __grid_constant__ CUtensorMap tmx,
             const __grid_constant__ CUtensorMap tmg,
             const __grid_constant__ CUtensorMap tmz,
             const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ z, float* ws, float* out,
             int* counters, wtile::Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  wtile::run<N, MPW>(smem, &tmx, &tmg, &tmz, x, g, z, ws, out, counters,
                     geo);
}

// The compiled wgrad instances: wgmma widths 8 to 128, one or two m-tiles a
// warpgroup (one at 128: its accumulator takes 64 registers a thread).
wtile::Kernel pick_wgrad(int lanes, int mpw) {
  switch (lanes * 4 + mpw) {
    case 8 * 4 + 1: return wgrad_kernel<8, 1>;
    case 8 * 4 + 2: return wgrad_kernel<8, 2>;
    case 16 * 4 + 1: return wgrad_kernel<16, 1>;
    case 16 * 4 + 2: return wgrad_kernel<16, 2>;
    case 32 * 4 + 1: return wgrad_kernel<32, 1>;
    case 32 * 4 + 2: return wgrad_kernel<32, 2>;
    case 64 * 4 + 1: return wgrad_kernel<64, 1>;
    case 64 * 4 + 2: return wgrad_kernel<64, 2>;
    case 128 * 4 + 1: return wgrad_kernel<128, 1>;
  }
  return nullptr;
}

// The bf16 build of the same tile (wgrad_tile.cuh, namespace bf16): bf16 x,
// g and z, the f32 workspace and sums.
template <int N, int MPW>
__global__ void __launch_bounds__(wtile::bf16::max_threads(N, MPW), 1)
wgrad_kernel_bf16(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmg,
                  const __grid_constant__ CUtensorMap tmz,
                  const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ g,
                  const __nv_bfloat16* __restrict__ z, float* ws, float* out,
                  int* counters, wtile::Geometry geo) {
  extern __shared__ __align__(16) char smem_bf16[];
  wtile::bf16::run<N, MPW>(smem_bf16, &tmx, &tmg, &tmz, x, g, z, ws, out,
                           counters, geo);
}

// The compiled bf16 wgrad instances, as the f32 ones.
wtile::KernelBf16 pick_wgrad_bf16(int lanes, int mpw) {
  switch (lanes * 4 + mpw) {
    case 8 * 4 + 1: return wgrad_kernel_bf16<8, 1>;
    case 8 * 4 + 2: return wgrad_kernel_bf16<8, 2>;
    case 16 * 4 + 1: return wgrad_kernel_bf16<16, 1>;
    case 16 * 4 + 2: return wgrad_kernel_bf16<16, 2>;
    case 32 * 4 + 1: return wgrad_kernel_bf16<32, 1>;
    case 32 * 4 + 2: return wgrad_kernel_bf16<32, 2>;
    case 64 * 4 + 1: return wgrad_kernel_bf16<64, 1>;
    case 64 * 4 + 2: return wgrad_kernel_bf16<64, 2>;
    case 128 * 4 + 1: return wgrad_kernel_bf16<128, 1>;
  }
  return nullptr;
}

// The window wgrad's launch geometry.
wtile::Geometry wgrad_geometry(int n, int ciblk, int hi, int wi, int cib,
                               int coblk, int cob, int ho, int wo, int hf,
                               int wf, int stride, int pad_top, int pad_left,
                               int th, int tw, int wgs, int mpw, int lanes,
                               int splits, int act, int prologue,
                               int with_db) {
  return wtile::Geometry{n, ciblk, cib, hi, wi, coblk, cob, ho, wo, hf, wf,
                         stride, pad_top, pad_left, th, tw, lanes, wgs, mpw,
                         splits, act, prologue, with_db, 0};
}

}  // namespace

extern "C" {

// The wgrad tile's compiled limits, for the wrapper's blocking model: the
// most threads a CTA, rows of an m-tile, output positions of a stage.
void direct_conv2d_bwd_geometry(int* threads, int* rows, int* positions) {
  *threads = wtile::kMaxThreads;
  *rows = wtile::kRows;
  *positions = wtile::kMaxPositions;
}

// Tiles of th x tw phase positions, `wgs` consumer warpgroups a CTA, the
// wgmma width `lanes`, `chunk` Cob channels a stage; `*launches` is how
// many grids it launched (dgrad_tile::launch).
int direct_conv2d_dgrad(const void* g, const void* z, const void* w, void* dx,
                        int n, int coblk, int cob, int ho, int wo, int ciblk,
                        int cib, int hi, int wi, int hf, int wf, int stride,
                        int pad_top, int pad_left, int th, int tw, int wgs,
                        int lanes, int chunk, int act, void* stream,
                        int* launches) {
  const dt::Geometry geo = dgrad_geometry(
      coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top,
      pad_left, th, tw, wgs, chunk, act, z != nullptr);
  if (th * tw > dt::kRows * wgs) return (int)cudaErrorInvalidValue;
  return dt::launch(pick_dgrad(lanes), (const float*)g, (const float*)z,
                    (const float*)w, (float*)dx, n, geo, wgs, lanes,
                    (cudaStream_t)stream, launches);
}

// What direct_conv2d_dgrad runs with the same arguments (dgrad_tile::plan):
// out[0] tiles, out[1] the function's MACs, out[2] tensor-core MACs issued.
int direct_conv2d_dgrad_plan(int n, int coblk, int cob, int ho, int wo,
                             int ciblk, int cib, int hi, int wi, int hf,
                             int wf, int stride, int pad_top, int pad_left,
                             int th, int tw, int wgs, int lanes, int chunk,
                             long long* out) {
  if (th * tw > dt::kRows * wgs || stride < 1 || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  dt::plan(dgrad_geometry(coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf,
                          stride, pad_top, pad_left, th, tw, wgs, chunk, 0,
                          false),
           n, wgs, lanes, out);
  return 0;
}

// Tiles of th x tw output positions, `wgs` consumer warpgroups of `mpw`
// m-tiles, the wgmma width `lanes`, `splits` position shares into `ws`,
// summed by each column's last CTA into `out` ([|dw| + |db|]);
// `counters`: a zeroed int32 a column (wgrad_tile::columns).  plan, built
// once per shape by the wrapper: n, ciblk, hi, wi, cib, coblk, cob, ho,
// wo, hf, wf, stride, pad_top, pad_left, th, tw, wgs, mpw, lanes, splits,
// act, with_db (as the _plan entry's ints, then those two).
int direct_conv2d_wgrad(const void* x, const void* g, const void* z, void* ws,
                        void* out, void* counters, const int* p,
                        void* stream) {
  const wtile::Geometry geo = wgrad_geometry(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19], p[20],
      z != nullptr, p[21]);
  return wtile::launch(pick_wgrad(geo.lanes, geo.mpw), (const float*)x,
                       (const float*)g, (const float*)z, (float*)ws,
                       (float*)out, (int*)counters, geo,
                       (cudaStream_t)stream);
}

// What direct_conv2d_wgrad runs with the same arguments (wgrad_tile::plan):
// out[0] tiles, out[1] the function's MACs, out[2] tensor-core MACs issued,
// out[3] shared memory of a CTA.
int direct_conv2d_wgrad_plan(int n, int ciblk, int hi, int wi, int cib,
                             int coblk, int cob, int ho, int wo, int hf,
                             int wf, int stride, int pad_top, int pad_left,
                             int th, int tw, int wgs, int mpw, int lanes,
                             int splits, int prologue, long long* out) {
  const wtile::Geometry geo = wgrad_geometry(
      n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top,
      pad_left, th, tw, wgs, mpw, lanes, splits, 0, prologue, 0);
  if (!wtile::valid(geo) || pick_wgrad(lanes, mpw) == nullptr)
    return (int)cudaErrorInvalidValue;
  wtile::plan(geo, out);
  return 0;
}

// The bf16 build of direct_conv2d_dgrad (bf16 g, z, w and dx), the same
// arguments; one grid always.
int direct_conv2d_dgrad_bf16(const void* g, const void* z, const void* w,
                             void* dx, int n, int coblk, int cob, int ho,
                             int wo, int ciblk, int cib, int hi, int wi,
                             int hf, int wf, int stride, int pad_top,
                             int pad_left, int th, int tw, int wgs,
                             int lanes, int chunk, int act, void* stream,
                             int* launches) {
  dt::Geometry geo = dgrad_geometry(
      coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top,
      pad_left, th, tw, wgs, chunk, act, z != nullptr);
  geo.co_first = 0;
  geo.co_count = coblk;
  if (th * tw > dt::kRows * wgs) return (int)cudaErrorInvalidValue;
  return dt::bf16::launch(pick_dgrad_bf16(lanes),
                          (const __nv_bfloat16*)g, (const __nv_bfloat16*)z,
                          (const __nv_bfloat16*)w, (__nv_bfloat16*)dx, n,
                          geo, wgs, lanes, (cudaStream_t)stream, launches);
}

// What direct_conv2d_dgrad_bf16 runs (dgrad_tile::bf16::plan).
int direct_conv2d_dgrad_bf16_plan(int n, int coblk, int cob, int ho, int wo,
                                  int ciblk, int cib, int hi, int wi, int hf,
                                  int wf, int stride, int pad_top,
                                  int pad_left, int th, int tw, int wgs,
                                  int lanes, int chunk, long long* out) {
  if (th * tw > dt::kRows * wgs || stride < 1 || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  dt::bf16::plan(dgrad_geometry(coblk, cob, ho, wo, ciblk, cib, hi, wi, hf,
                                wf, stride, pad_top, pad_left, th, tw, wgs,
                                chunk, 0, false),
                 n, wgs, lanes, out);
  return 0;
}

// The bf16 build of direct_conv2d_wgrad (bf16 x, g and z; the f32
// workspace and sums), the same plan.
int direct_conv2d_wgrad_bf16(const void* x, const void* g, const void* z,
                             void* ws, void* out, void* counters,
                             const int* p, void* stream) {
  const wtile::Geometry geo = wgrad_geometry(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19], p[20],
      z != nullptr, p[21]);
  return wtile::launch_bf16(pick_wgrad_bf16(geo.lanes, geo.mpw),
                            (const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
                            (const __nv_bfloat16*)z, (float*)ws, (float*)out,
                            (int*)counters, geo, (cudaStream_t)stream);
}

// What direct_conv2d_wgrad_bf16 runs (wgrad_tile::bf16::plan).
int direct_conv2d_wgrad_bf16_plan(int n, int ciblk, int hi, int wi, int cib,
                                  int coblk, int cob, int ho, int wo, int hf,
                                  int wf, int stride, int pad_top,
                                  int pad_left, int th, int tw, int wgs,
                                  int mpw, int lanes, int splits,
                                  int prologue, long long* out) {
  const wtile::Geometry geo = wgrad_geometry(
      n, ciblk, hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top,
      pad_left, th, tw, wgs, mpw, lanes, splits, 0, prologue, 0);
  if (!wtile::valid_bf16(geo) || pick_wgrad_bf16(lanes, mpw) == nullptr)
    return (int)cudaErrorInvalidValue;
  wtile::bf16::plan(geo, out);
  return 0;
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
