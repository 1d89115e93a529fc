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
// wgrad:  dw[dh,dw,c,co] = sum_{n,oh,ow} x[n, oh*s+dh-pt, ow*s+dw-pl, c]
//                                        * dz[n,oh,ow,co],  db[co] = sum dz
// The TPU walks the N*Ho*Wo reduction as a sequential grid axis into one
// resident accumulator; blocks run in no order on Hopper, and one CTA per
// (Co block, Ci block) would give conv1_2 of VGG-16 a single CTA.  So a CTA
// holds `taps` taps' [Cib, Cob] blocks in its register tile (8 x 8 per
// thread: one tap of 128 x 128 is 256 threads, the forward's tile) and walks
// a contiguous share of the (image, tile row, tile col) position tiles,
// staging each tile's x window (pads masked, no padded copy) and dz tile.
// Each share's sums go to its row of an f32 workspace [splits, |dw| + |db|];
// `wgrad_reduce` then sums the rows in split order.  No atomics: two runs
// give identical bits.  db rides the CTAs of Ci block 0 and tap group 0 only,
// so it is summed once per Co block (the reference's `ci == 0` pass).  It
// does the forward's FLOPs on plain f32 FMAs, bound in practice by the
// shared-memory reads that feed them; its CTAs of one position tile stage
// the same window once per tap group.
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after its launch (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "dgrad_tile.cuh"

namespace {

namespace dt = dgrad_tile;

constexpr int kThreads = 256;   // wgrad: threads per CTA
constexpr int kLanes = 8;       // register-tile columns of one thread
constexpr int kPositions = 8;   // the forward's positions of one thread
constexpr int kMinBlocksPerSm = 2;
static_assert(kLanes == 8, "the float4 pair reads assume 8 lanes");

// dz = g * act'(z), as the dgrad tile forms it
using dt::prologue;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One staged unit of dz = g * act'(z): 4 floats when `vec` (offsets are
// multiples of 4), else 1.
__device__ __forceinline__ void stage_dz(float* dst, const float* g,
                                         const float* z, size_t src, bool vec,
                                         int act) {
  if (vec) {
    float4 v = __ldg(reinterpret_cast<const float4*>(g + src));
    if (z != nullptr) {
      const float4 zz = __ldg(reinterpret_cast<const float4*>(z + src));
      v.x = prologue(v.x, zz.x, act);
      v.y = prologue(v.y, zz.y, act);
      v.z = prologue(v.z, zz.z, act);
      v.w = prologue(v.w, zz.w, act);
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    float v = __ldg(g + src);
    if (z != nullptr) v = prologue(v, __ldg(z + src), act);
    *dst = v;
  }
}

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
             const __grid_constant__ CUtensorMap tmz, float* __restrict__ dx,
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
  const int stages = taps > 0 ? geo.coblk * per_block : 0;
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
    auto issue_stage = [&](int s) {     // warp 0: stage s's copies
      const int slot = s & 1;
      const int co_b = s / per_block;
      const int c0 = (s % per_block) * geo.chunk;
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
    if (tid < 32 && stages > 0) issue_stage(0);
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 1;
      dt::mbar_wait(&m.bars[slot * dt::kMaxGroups], (s >> 1) & 1);
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
        if (tid < 32) issue_stage(s + 1);
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
  dt::store_dx<N>(dx, acc, geo, t, n, ci_b, 0, q0);
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

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// kVecX / kVecD: Cib / Cob is a multiple of kLanes, so a thread's 8 x values
// / 8 dz values of one position are two aligned float4 reads.
template <bool kVecX, bool kVecD>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ z, float* __restrict__ ws, int n_img,
             int ciblk, int hi, int wi, int cib, int coblk, int cob, int ho,
             int wo, int hf, int wf, int stride, int pad_top, int pad_left,
             int hob, int wob, int taps, int tap_groups, int splits, int act,
             int with_db) {
  extern __shared__ __align__(16) float smem[];
  const int tg = blockIdx.x % tap_groups;
  const int split = blockIdx.x / tap_groups;
  const int ci_b = blockIdx.y;
  const int co_b = blockIdx.z;
  const int hib = (hob - 1) * stride + hf;
  const int wib = (wob - 1) * stride + wf;
  const int tiles_h = ho / hob;
  const int tiles_w = wo / wob;
  const int tiles = n_img * tiles_h * tiles_w;
  const int first = (int)((long long)tiles * split / splits);
  const int last = (int)((long long)tiles * (split + 1) / splits);

  // thread -> (tap, Cib lane group, Cob lane group); Cob fastest, so a warp
  // shares x values (broadcast) and reads neighbouring dz values
  const int ncig = (cib + kLanes - 1) / kLanes;
  const int ncog = (cob + kLanes - 1) / kLanes;
  const int groups = ncig * ncog;
  const int t = threadIdx.x;
  const int tl = t / groups;
  const int cig = (t % groups) / ncog;
  const int cog = t % ncog;
  const int tap = tg * taps + tl;
  const bool active = tl < taps && tap < hf * wf;
  const int dh = active ? tap / wf : 0;
  const int dw = active ? tap % wf : 0;
  const int ci0 = cig * kLanes;
  const int co0 = cog * kLanes;
  const bool db_duty = with_db && active && ci_b == 0 && tg == 0 && tl == 0 &&
                       cig == 0;

  // the dz tile starts on 16 bytes after a window of Cib = 3 channels
  float* x_s = smem;                                   // [hib, wib, cib]
  float* d_s = smem + ((hib * wib * cib + 3) & ~3);    // [hob * wob, cob]

  float acc[kLanes][kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[i][j] = 0.0f;
  }
  float dbacc[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) dbacc[j] = 0.0f;

  const bool vec_x = cib % 4 == 0;
  const bool vec_d = cob % 4 == 0;
  const int unit = vec_d ? 4 : 1;
  for (int tt = first; tt < last; ++tt) {
    const int n = tt / (tiles_h * tiles_w);
    const int th = (tt / tiles_w) % tiles_h;
    const int tw = tt % tiles_w;
    // x window [hib, wib, cib], pads masked
    const float* xb = x + (size_t)(n * ciblk + ci_b) * hi * wi * cib;
    const int h0 = th * hob * stride - pad_top;
    const int w0 = tw * wob * stride - pad_left;
    const int row_elems = wib * cib;
    for (int r = 0; r < hib; ++r) {
      const int ih = h0 + r;
      float* dst = x_s + r * row_elems;
      if (ih < 0 || ih >= hi) {
        for (int i = t; i < row_elems; i += kThreads) dst[i] = 0.0f;
        continue;
      }
      const float* src = xb + (size_t)ih * wi * cib;
      if (vec_x) {
        const int q = cib / 4;
        for (int i = t; i < row_elems / 4; i += kThreads) {
          const int iw = w0 + i / q;
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (iw >= 0 && iw < wi) {
            v = __ldg(reinterpret_cast<const float4*>(
                src + (size_t)iw * cib) + i % q);
          }
          reinterpret_cast<float4*>(dst)[i] = v;
        }
      } else {
        for (int i = t; i < row_elems; i += kThreads) {
          const int iw = w0 + i / cib;
          dst[i] = (iw >= 0 && iw < wi) ? __ldg(src + (size_t)iw * cib + i % cib)
                                        : 0.0f;
        }
      }
    }
    // dz tile [hob * wob, cob]: one contiguous run per output row
    const size_t map = (size_t)(n * coblk + co_b) * ho * wo * cob;
    const float* zb = z != nullptr ? z + map : nullptr;
    const int run = wob * cob / unit;
    for (int i = t; i < hob * run; i += kThreads) {
      const int r = i / run;
      const int e = (i % run) * unit;
      stage_dz(d_s + r * wob * cob + e, g + map, zb,
               ((size_t)(th * hob + r) * wo + tw * wob) * cob + e, vec_d, act);
    }
    __syncthreads();
    if (active) {
      const float* xt = x_s + (dh * wib + dw) * cib + ci0;
      const float* dt = d_s + co0;
      for (int ph = 0; ph < hob; ++ph) {
        for (int pw = 0; pw < wob; ++pw) {
          float xv[kLanes], dv[kLanes];
          const float* xp = xt + (ph * stride * wib + pw * stride) * cib;
          const float* dp = dt + (ph * wob + pw) * cob;
          if constexpr (kVecX) {
            load8(xp, xv);
          } else {
#pragma unroll
            for (int i = 0; i < kLanes; ++i) {
              xv[i] = (ci0 + i < cib) ? xp[i] : 0.0f;
            }
          }
          if constexpr (kVecD) {
            load8(dp, dv);
          } else {
#pragma unroll
            for (int j = 0; j < kLanes; ++j) {
              dv[j] = (co0 + j < cob) ? dp[j] : 0.0f;
            }
          }
#pragma unroll
          for (int i = 0; i < kLanes; ++i) {
#pragma unroll
            for (int j = 0; j < kLanes; ++j) {
              acc[i][j] = fmaf(xv[i], dv[j], acc[i][j]);
            }
          }
          if (db_duty) {
#pragma unroll
            for (int j = 0; j < kLanes; ++j) dbacc[j] += dv[j];
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const size_t dw_size = (size_t)coblk * ciblk * hf * wf * cib * cob;
  float* row = ws + (size_t)split * (dw_size + (with_db ? coblk * cob : 0));
  const size_t base =
      (((size_t)(co_b * ciblk + ci_b) * hf * wf + tap) * cib + ci0) * cob + co0;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    if (ci0 + i < cib) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (co0 + j < cob) row[base + (size_t)i * cob + j] = acc[i][j];
      }
    }
  }
  if (db_duty) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (co0 + j < cob) row[dw_size + co_b * cob + co0 + j] = dbacc[j];
    }
  }
}

// out[i] = sum over rows k = 0 .. splits-1, in that order, of ws[k][i]
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    float* __restrict__ out, long long cols,
                                    int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[(size_t)k * cols + i];
  out[i] = s;
}

}  // namespace

extern "C" {

// The compiled register-tile geometry, for the wrapper's blocking model.
void direct_conv2d_bwd_geometry(int* threads, int* lanes, int* positions) {
  *threads = kThreads;
  *lanes = kLanes;
  *positions = kPositions;
}

// Tiles of th x tw phase positions, `wgs` consumer warpgroups a CTA, the
// wgmma width `lanes`, `chunk` Cob channels a stage.
int direct_conv2d_dgrad(const void* g, const void* z, const void* w, void* dx,
                        int n, int coblk, int cob, int ho, int wo, int ciblk,
                        int cib, int hi, int wi, int hf, int wf, int stride,
                        int pad_top, int pad_left, int th, int tw, int wgs,
                        int lanes, int chunk, int act, void* stream) {
  const dt::Geometry geo = dgrad_geometry(
      coblk, cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top,
      pad_left, th, tw, wgs, chunk, act, z != nullptr);
  if (th * tw > dt::kRows * wgs) return (int)cudaErrorInvalidValue;
  return dt::launch(pick_dgrad(lanes), (const float*)g, (const float*)z,
                    (const float*)w, (float*)dx, n, geo, wgs, lanes,
                    (cudaStream_t)stream);
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

int direct_conv2d_wgrad(const void* x, const void* g, const void* z, void* ws,
                        int n, int ciblk, int hi, int wi, int cib, int coblk,
                        int cob, int ho, int wo, int hf, int wf, int stride,
                        int pad_top, int pad_left, int hob, int wob, int taps,
                        int tap_groups, int splits, int act, int with_db,
                        int smem_bytes, void* stream) {
  const bool vx = cib % kLanes == 0;
  const bool vd = cob % kLanes == 0;
  auto kernel = vx ? (vd ? wgrad_kernel<true, true> : wgrad_kernel<true, false>)
                   : (vd ? wgrad_kernel<false, true>
                         : wgrad_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tap_groups * splits, ciblk, coblk);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)z, (float*)ws, n, ciblk,
      hi, wi, cib, coblk, cob, ho, wo, hf, wf, stride, pad_top, pad_left, hob,
      wob, taps, tap_groups, splits, act, with_db);
  return (int)cudaGetLastError();
}

int wgrad_reduce(const void* ws, void* out, long long cols, int splits,
                 void* stream) {
  const int threads = 256;
  const long long blocks = (cols + threads - 1) / threads;
  wgrad_reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (float*)out, cols, splits);
  return (int)cudaGetLastError();
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
