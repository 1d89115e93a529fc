// Blocked direct convolution, forward, f32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (src/repro/kernels/direct_conv2d.py:102, launched by `_forward_windowed`,
// pallas_call at :351).  Same function:
//
//   out = act(sum_{ci, dh, dw} x_win[dh, dw] @ w[dh, dw] + b) + r
//
// on the paper's blocked layouts, downcast once (f32 here), with an optional
// fused global-average-pool (GAP):
//
//   x        [N, Ci/Cib, Hi, Wi, Cib]      unpadded; TF-SAME pads are masked
//   w        [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]
//   bias     [Co/Cob, Cob]                 or null
//   residual [N, Co/Cob, Ho, Wo, Cob]      or null, added after activation
//   out      [N, Co/Cob, Ho, Wo, Cob]
//   partials [N, Co/Cob, n_tiles, Cob]     f32 per-tile sums, or null (no GAP)
//
// Schedule.  One CTA per (spatial tile of hob x wob outputs, Co block, image).
// The TPU's sequential Ci grid axis becomes a loop inside the CTA: blocks run
// in no order on Hopper, so nothing carries over between CTAs.  For each Ci
// block the CTA walks chunks of the Cib pencil; per chunk it stages the
// halo'd input window [Hib, Wib, chunk] and the weight chunk
// [Hf, Wf, chunk, Cob] in shared memory.  Spatial padding is applied by
// masking the window loads, so no padded copy of x exists (the reference
// pads into a copy; the paper's zero-overhead property is kept here).  Each
// thread then accumulates a register tile of kPositions outputs x kLanes
// output channels in f32 FMAs.  The epilogue runs in registers in the
// reference's order (acc + b, activation, + residual, one store).
//
// What bounds it on this card.  VGG-16's convs do 2*9*Ci FLOPs per output
// element against a few bytes of traffic: far above the H100's f32 ridge
// (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/byte), so the bound is the f32 FMA
// rate, and in practice the shared-memory reads feeding the FMAs.  The
// register tile is the design's answer: per (tap, channel) step a thread
// reads kLanes weights and kPositions inputs from shared memory and does
// kPositions*kLanes FMAs, and warps whose threads share positions read each
// input as a broadcast.  It does not use the tensor cores; wgmma on bf16
// pencils, TMA rings and persistent CTAs are later work.
//
// GAP rider.  Each CTA reduces its stored tile per channel in f32 in a fixed
// order (per thread over its positions, then across position groups through
// shared memory) into `partials`; `gap_finalize` sums the tiles in index
// order and multiplies by the f32 reciprocal of Ho*Wo.  No atomics: two runs
// give identical bits.
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kLanes = 8;       // output channels in one thread's tile
constexpr int kPositions = 8;   // output positions in one thread's tile
// Two CTAs per SM caps a thread at 128 registers.  ptxas then spills a few
// hundred bytes, yet on the H100 this runs faster than one CTA per SM with
// ~170 spill-free registers: the second CTA's FMAs hide the first one's
// staging.  The blocking model's shared-memory budget is sized for two.
constexpr int kMinBlocksPerSm = 2;
static_assert(kLanes == 8, "the float4 weight read assumes 8 lanes");

constexpr int kActLinear = 0;
constexpr int kActRelu = 1;
constexpr int kActGelu = 2;

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

// kVecW: Cob is a multiple of kLanes, so a thread's kLanes weights are two
// aligned float4 reads (scalar reads at a stride of kLanes floats would hit
// the same shared-memory banks from many lanes of a warp).
template <bool kVecW>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
direct_conv2d_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ residual,
                         float* __restrict__ out,
                         float* __restrict__ partials,
                         int ciblk, int hi, int wi, int cib,
                         int coblk, int cob, int ho, int wo,
                         int hf, int wf, int stride, int pad_top, int pad_left,
                         int hob, int wob, int chunk, int act) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_w = wo / wob;
  const int n_tiles = (ho / hob) * tiles_w;
  const int tile = blockIdx.x;
  const int co_b = blockIdx.y;
  const int n = blockIdx.z;
  const int th = tile / tiles_w;
  const int tw = tile % tiles_w;
  const int hib = (hob - 1) * stride + hf;
  const int wib = (wob - 1) * stride + wf;
  const int npos = hob * wob;

  // thread -> (position group, channel group); neighbouring threads take
  // neighbouring channel groups of the same positions
  const int ncg = (cob + kLanes - 1) / kLanes;
  const int npg = kThreads / ncg;
  const int t = threadIdx.x;
  const int cg = t % ncg;
  const int pg = t / ncg;
  const bool computes = pg < npg;
  const int co0 = cg * kLanes;

  float* w_s = smem;                          // [hf, wf, chunk, cob]
  float* x_s = smem + hf * wf * chunk * cob;  // [hib, wib, chunk]

  // shared-memory offset of each of this thread's output positions inside
  // the window; positions past the tile read offset 0 and are never stored
  int xoff[kPositions];
#pragma unroll
  for (int k = 0; k < kPositions; ++k) {
    const int p = pg + k * npg;
    const int pp = p < npos ? p : 0;
    xoff[k] = ((pp / wob) * stride * wib + (pp % wob) * stride) * chunk;
  }

  float acc[kPositions][kLanes];
#pragma unroll
  for (int k = 0; k < kPositions; ++k) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[k][j] = 0.0f;
  }

  const int h0 = th * hob * stride - pad_top;
  const int w0 = tw * wob * stride - pad_left;
  // float4 window loads: every staged run starts on a 16-byte boundary
  const bool vec_x = chunk % 4 == 0 && cib % 4 == 0;

  for (int cb = 0; cb < ciblk; ++cb) {
    const float* xb = x + (size_t)(n * ciblk + cb) * hi * wi * cib;
    const float* wb = w + (size_t)(co_b * ciblk + cb) * hf * wf * cib * cob;
    for (int c0 = 0; c0 < cib; c0 += chunk) {
      // stage the weight chunk [hf, wf, chunk, cob]: per tap one contiguous
      // run of chunk * cob floats
      const int run = chunk * cob;
      for (int tap = 0; tap < hf * wf; ++tap) {
        const float* src = wb + ((size_t)tap * cib + c0) * cob;
        float* dst = w_s + tap * run;
        if constexpr (kVecW) {            // run and offsets: multiples of 8
          for (int i = t; i < run / 4; i += kThreads) {
            reinterpret_cast<float4*>(dst)[i] =
                __ldg(reinterpret_cast<const float4*>(src) + i);
          }
        } else {
          for (int i = t; i < run; i += kThreads) dst[i] = __ldg(src + i);
        }
      }
      // stage the halo'd window row by row; the zero pads are masked loads
      const int row_elems = wib * chunk;
      for (int row = 0; row < hib; ++row) {
        const int ih = h0 + row;
        float* dst = x_s + row * row_elems;
        if (ih < 0 || ih >= hi) {
          for (int i = t; i < row_elems; i += kThreads) dst[i] = 0.0f;
          continue;
        }
        const float* src = xb + (size_t)ih * wi * cib + c0;
        if (vec_x) {
          const int q = chunk / 4;
          for (int i = t; i < row_elems / 4; i += kThreads) {
            const int col = i / q;
            const int c = (i - col * q) * 4;
            const int iw = w0 + col;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (iw >= 0 && iw < wi) {
              v = __ldg(reinterpret_cast<const float4*>(
                  src + (size_t)iw * cib + c));
            }
            reinterpret_cast<float4*>(dst)[i] = v;
          }
        } else {
          for (int i = t; i < row_elems; i += kThreads) {
            const int col = i / chunk;
            const int c = i - col * chunk;
            const int iw = w0 + col;
            dst[i] = (iw >= 0 && iw < wi) ? __ldg(src + (size_t)iw * cib + c)
                                          : 0.0f;
          }
        }
      }
      __syncthreads();
      if (computes) {
        for (int dh = 0; dh < hf; ++dh) {
          for (int dw = 0; dw < wf; ++dw) {
            const float* xt = x_s + (dh * wib + dw) * chunk;
            const float* wt = w_s + (dh * wf + dw) * chunk * cob + co0;
#pragma unroll 4
            for (int c = 0; c < chunk; ++c) {
              float wv[kLanes];
              if constexpr (kVecW) {
                const float4 lo = *reinterpret_cast<const float4*>(wt + c * cob);
                const float4 hi4 =
                    *reinterpret_cast<const float4*>(wt + c * cob + 4);
                wv[0] = lo.x; wv[1] = lo.y; wv[2] = lo.z; wv[3] = lo.w;
                wv[4] = hi4.x; wv[5] = hi4.y; wv[6] = hi4.z; wv[7] = hi4.w;
              } else {
#pragma unroll
                for (int j = 0; j < kLanes; ++j) {
                  wv[j] = (co0 + j < cob) ? wt[c * cob + j] : 0.0f;
                }
              }
#pragma unroll
              for (int k = 0; k < kPositions; ++k) {
                const float xv = xt[xoff[k] + c];
#pragma unroll
                for (int j = 0; j < kLanes; ++j) {
                  acc[k][j] = fmaf(xv, wv[j], acc[k][j]);
                }
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // epilogue: acc + b, activation, + residual, one store; acc keeps the
  // stored values (zero where nothing is stored) for the GAP rider
  if (computes) {
    float bv[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      bv[j] = (bias != nullptr && co0 + j < cob) ? bias[co_b * cob + co0 + j]
                                                 : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPositions; ++k) {
      const int p = pg + k * npg;
      if (p < npos) {
        const int oh = th * hob + p / wob;
        const int ow = tw * wob + p % wob;
        const size_t o =
            (((size_t)(n * coblk + co_b) * ho + oh) * wo + ow) * cob + co0;
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if (co0 + j < cob) {
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
    // the staging buffer is free after the loop's last __syncthreads
    float* red = smem;                         // [npg, cob]
    if (computes) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (co0 + j < cob) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < kPositions; ++k) s += acc[k][j];
          red[pg * cob + co0 + j] = s;
        }
      }
    }
    __syncthreads();
    for (int co = t; co < cob; co += kThreads) {
      float s = 0.0f;
      for (int g = 0; g < npg; ++g) s += red[g * cob + co];
      partials[((size_t)(n * coblk + co_b) * n_tiles + tile) * cob + co] = s;
    }
  }
}

__global__ void gap_finalize_kernel(const float* __restrict__ partials,
                                    float* __restrict__ pooled, int rows,
                                    int n_tiles, int cob, float inv_hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cob) return;
  const int r = i / cob;
  const int co = i % cob;
  const float* p = partials + (size_t)r * n_tiles * cob + co;
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t) s += p[(size_t)t * cob];
  pooled[i] = s * inv_hw;
}

}  // namespace

extern "C" {

// The compiled register-tile geometry, for the wrapper's blocking model.
void direct_conv2d_fwd_geometry(int* threads, int* lanes, int* positions) {
  *threads = kThreads;
  *lanes = kLanes;
  *positions = kPositions;
}

int direct_conv2d_fwd(const void* x, const void* w, const void* bias,
                      const void* residual, void* out, void* partials,
                      int n, int ciblk, int hi, int wi, int cib,
                      int coblk, int cob, int ho, int wo,
                      int hf, int wf, int stride, int pad_top, int pad_left,
                      int hob, int wob, int chunk, int act, int smem_bytes,
                      void* stream) {
  const bool vec_w = cob % kLanes == 0;
  auto kernel = vec_w ? direct_conv2d_fwd_kernel<true>
                      : direct_conv2d_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ho / hob) * (wo / wob), coblk, n);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias,
      (const float*)residual, (float*)out, (float*)partials, ciblk, hi, wi,
      cib, coblk, cob, ho, wo, hf, wf, stride, pad_top, pad_left, hob, wob,
      chunk, act);
  return (int)cudaGetLastError();
}

int gap_finalize(const void* partials, void* pooled, int rows, int n_tiles,
                 int cob, float inv_hw, void* stream) {
  const int total = rows * cob;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  gap_finalize_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, (float*)pooled, rows, n_tiles, cob, inv_hw);
  return (int)cudaGetLastError();
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
