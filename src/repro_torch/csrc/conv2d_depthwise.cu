// Depthwise convolution, f32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv2d_depthwise.py:
//   `_dw_fwd_kernel`   (:72,  pallas_call :215), which is also the reference's
//                      dgrad body (`depthwise_dgrad_pallas` :232: mirrored
//                      taps over the dilated, padded cotangent)
//   `_dw_wgrad_kernel` (:105, pallas_call :337)
// The depthwise conv is the group conv with one channel per group: each lane
// of the channel pencil multiplies its own Hf x Wf tap stack, and nothing is
// contracted.  Layouts:
//
//   x   [N, C/Cb, Hi, Wi, Cb]   the forward's UNPADDED input
//   out [N, C/Cb, Ho, Wo, Cb]   g, z, r likewise
//   w   [C/Cb, 1, Hf, Wf, 1, Cb] (grouped-HWIO blocked at Cig = 1)
//   b   [C/Cb, Cb]
//
//   out[n, c, oh, ow] = act(sum_{dh, dw} x[n, c, oh*s + dh*dh_d - pt,
//                                          ow*s + dw*dw_d - pl] * w[c, dh, dw]
//                           + b[c]) + r[n, c, oh, ow]
//   dx[n, c, i, j]  = sum_{dh, dw} dz[n, c, (i + pt - dh*dh_d) / s,
//                                        (j + pl - dw*dw_d) / s] * w[c, dh, dw]
//                     (a term counts when both divisions are exact and land
//                      in the map), dz = g * act'(z)
//   dw[c, dh, dw]   = sum_{n, oh, ow} x[n, c, oh*s + dh*dh_d - pt, ...] * dz
//   db[c]           = sum_{n, oh, ow} dz
//
// Forward and dgrad are one tap kernel, `depthwise_tap_kernel<kDgrad>`.  One
// CTA per (tile of hob x wob positions of the output, or of dx, channel
// block, image).  It stages a halo'd window [hwin, wwin, Cb] of the input
// (forward: pads masked) or of the cotangent (dgrad: dz formed on the way in,
// zero outside the map) in shared memory; loads run along the pencil, so 32
// lanes read 128 contiguous bytes.  Thread t owns lane t % Cb and every
// (256 / Cb)-th position of the tile, so a 32-lane pencil still fills the
// CTA with 8 position groups; it keeps its lane's taps in registers and, per
// position, sums the taps (forward) or the mirrored taps that the stride
// does not skip (dgrad).  As in the dense dgrad, no stride-dilated or padded
// copy of the cotangent or of z exists and dx is written at the input's
// shape; TF-SAME's (0, 1) pads at stride 2 are the masks.  The forward's
// epilogue is the reference's (+ b, activation, + r, one store), and with
// GAP it writes per-tile partial sums for `gap_finalize`.
//
// wgrad: the TPU reduces (N, Ho/Hob, Wo/Wob) into a resident [Hf*Wf, Cb]
// block.  Here a CTA owns one channel block's [Hf*Wf, Cb] sums and walks a
// contiguous share of the position tiles (`splits` shares), staging each
// tile's x window and dz tile; a thread holds its lane's tap sums and db in
// registers, the position groups' sums meet in shared memory in group order,
// and each share's row of the [splits, |dw| + |db|] f32 workspace is summed
// by `wgrad_reduce` (direct_conv2d_bwd.cu) in split order.  No atomics.
//
// What bounds these on this card.  A depthwise conv does 2*Hf*Wf = 18 FLOPs
// per output element against at least 8 bytes of traffic (one input and one
// output element; at stride 2, four inputs): 2.25 FLOP/byte or less, far
// below the H100's f32 ridge (~20 FLOP/byte).  Bytes bound it.  The design's
// answer: every element of x, g, z, out and dx crosses device memory once
// per CTA with full 128-byte lines (the halo rows are re-read from L2), the
// taps come from shared memory and registers, and the grid is sized to hold
// the card's resident CTAs so that enough loads are in flight.  Not done
// yet: asynchronous staging (cp.async or TMA) overlapped with the taps.
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after its launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kMaxTaps = 25;    // filter taps a thread holds (5x5)
constexpr int kMinBlocksPerSm = 2;

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

// dz = g * act'(z); relu' is 1/2 at 0, as the VJP of the reference's
// jnp.maximum(z, 0) splits the tie
__device__ __forceinline__ float prologue(float g, float z, int act) {
  if (act == kActRelu) {
    return z > 0.0f ? g : (z == 0.0f ? 0.5f * g : 0.0f);
  }
  if (act == kActGelu) {
    const float k = 0.7978845608028654f;
    const float a = 0.044715f;
    const float z2 = z * z;
    const float t = tanhf(k * (z + a * z2 * z));
    return g * (0.5f * (1.0f + t)
                + 0.5f * z * (1.0f - t * t) * k * (1.0f + 3.0f * a * z2));
  }
  return g;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// Stage the window [hwin, wwin, cb] whose cell (r, col) is map row r0 + r,
// column c0 + col of `src` ([hs, ws, cb] of one image and channel block),
// zero outside the map; with z given, dz = g * act'(z).  float4 units when
// cb is a multiple of 4.
__device__ __forceinline__ void stage_window(
    float* dst, const float* src, const float* z, int hs, int ws, int cb,
    int r0, int c0, int hwin, int wwin, int act) {
  const bool vec = cb % 4 == 0;
  const int unit = vec ? 4 : 1;
  const int units = cb / unit;
  for (int i = threadIdx.x; i < hwin * wwin * units; i += kThreads) {
    const int cell = i / units;
    const int c = (i % units) * unit;
    const int h = r0 + cell / wwin;
    const int w = c0 + cell % wwin;
    float* d = dst + cell * cb + c;
    if (h < 0 || h >= hs || w < 0 || w >= ws) {
      for (int e = 0; e < unit; ++e) d[e] = 0.0f;
      continue;
    }
    const size_t o = ((size_t)h * ws + w) * cb + c;
    if (vec) {
      float4 v = __ldg(reinterpret_cast<const float4*>(src + o));
      if (z != nullptr) {
        const float4 zz = __ldg(reinterpret_cast<const float4*>(z + o));
        v.x = prologue(v.x, zz.x, act);
        v.y = prologue(v.y, zz.y, act);
        v.z = prologue(v.z, zz.z, act);
        v.w = prologue(v.w, zz.w, act);
      }
      *reinterpret_cast<float4*>(d) = v;
    } else {
      float v = __ldg(src + o);
      if (z != nullptr) v = prologue(v, __ldg(z + o), act);
      *d = v;
    }
  }
}

// ---------------------------------------------------------------------------
// forward and dgrad: the tap loop
// ---------------------------------------------------------------------------

// src: x (forward) or g (dgrad), [N, C/Cb, hs, ws, Cb]; z: the saved
// pre-activation of the dgrad's prologue or null; out: [N, C/Cb, hd, wd, Cb],
// the conv's output (forward) or dx (dgrad).  act: the epilogue's activation
// (forward) or the prologue's (dgrad).
template <bool kDgrad>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_tap_kernel(const float* __restrict__ src,
                     const float* __restrict__ z,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ residual,
                     float* __restrict__ out,
                     float* __restrict__ partials,
                     int cblk, int cb, int hs, int ws, int hd, int wd,
                     int hf, int wf, int stride, int dil_h, int dil_w,
                     int pad_top, int pad_left, int hob, int wob, int hwin,
                     int wwin, int act) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_w = wd / wob;
  const int tile = blockIdx.x;
  const int c_b = blockIdx.y;
  const int n = blockIdx.z;
  const int i0 = (tile / tiles_w) * hob;
  const int j0 = (tile % tiles_w) * wob;
  const int npos = hob * wob;
  const int taps = hf * wf;

  const int npg = kThreads / cb;
  const int t = threadIdx.x;
  const int lane = t % cb;
  const int pg = t / cb;
  const bool computes = pg < npg;

  // the window's origin in the source map
  int r0, c0;
  if constexpr (kDgrad) {
    r0 = floordiv(i0 + pad_top - (hf - 1) * dil_h, stride);
    c0 = floordiv(j0 + pad_left - (wf - 1) * dil_w, stride);
  } else {
    r0 = i0 * stride - pad_top;
    c0 = j0 * stride - pad_left;
  }
  const size_t map = (size_t)(n * cblk + c_b);
  stage_window(smem, src + map * hs * ws * cb,
               z != nullptr ? z + map * hs * ws * cb : nullptr, hs, ws, cb,
               r0, c0, hwin, wwin, act);

  // this lane's taps and their offsets inside the window (forward) or their
  // dilated extents (dgrad)
  float wv[kMaxTaps];
  int th[kMaxTaps], tw[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    const bool on = computes && k < taps;
    wv[k] = on ? __ldg(w + ((size_t)c_b * taps + k) * cb + lane) : 0.0f;
    th[k] = on ? (k / wf) * dil_h : 0;
    tw[k] = on ? (k % wf) * dil_w : 0;
  }
  const float bv = (!kDgrad && bias != nullptr && computes)
                       ? bias[c_b * cb + lane] : 0.0f;
  __syncthreads();

  float gsum = 0.0f;
  if (computes) {
    for (int p = pg; p < npos; p += npg) {
      const int ph = p / wob;
      const int pw = p % wob;
      float acc = 0.0f;
      if constexpr (kDgrad) {
        // numerators (i + pt) - s * r0 >= (hf - 1) * dil_h >= th[k]; a tap
        // counts where the stride divides both.  Strides 1 and 2 (all of
        // MobileNet's) take loops without integer division.
        const int ah = i0 + ph + pad_top - stride * r0;
        const int aw = j0 + pw + pad_left - stride * c0;
        if (stride == 1) {
#pragma unroll
          for (int k = 0; k < kMaxTaps; ++k) {
            if (k == taps) break;
            acc = fmaf(smem[((ah - th[k]) * wwin + aw - tw[k]) * cb + lane],
                       wv[k], acc);
          }
        } else if (stride == 2) {
#pragma unroll
          for (int k = 0; k < kMaxTaps; ++k) {
            if (k == taps) break;
            const int uh = ah - th[k];
            const int uw = aw - tw[k];
            if (((uh | uw) & 1) == 0) {
              acc = fmaf(smem[((uh >> 1) * wwin + (uw >> 1)) * cb + lane],
                         wv[k], acc);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kMaxTaps; ++k) {
            if (k == taps) break;
            const int uh = ah - th[k];
            const int uw = aw - tw[k];
            if (uh % stride == 0 && uw % stride == 0) {
              acc = fmaf(
                  smem[((uh / stride) * wwin + uw / stride) * cb + lane],
                  wv[k], acc);
            }
          }
        }
      } else {
        const int base = (ph * stride * wwin + pw * stride) * cb + lane;
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          if (k == taps) break;
          acc = fmaf(smem[base + (th[k] * wwin + tw[k]) * cb], wv[k], acc);
        }
      }
      const size_t o =
          ((map * hd + i0 + ph) * wd + j0 + pw) * cb + lane;
      if constexpr (!kDgrad) {
        acc = activate(acc + bv, act);
        if (residual != nullptr) acc += residual[o];
        gsum += acc;
      }
      out[o] = acc;
    }
  }

  if (!kDgrad && partials != nullptr) {
    // per-tile sums of the stored values, the position groups in order
    __syncthreads();                       // the window is no longer read
    float* red = smem;                     // [npg, cb]
    if (computes) red[pg * cb + lane] = gsum;
    __syncthreads();
    if (t < cb) {
      float s = 0.0f;
      for (int g = 0; g < npg; ++g) s += red[g * cb + t];
      partials[(map * gridDim.x + tile) * cb + t] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_wgrad_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ z, float* __restrict__ ws,
                       int n_img, int cblk, int cb, int hi, int wi, int ho,
                       int wo, int hf, int wf, int stride, int dil_h,
                       int dil_w, int pad_top, int pad_left, int hob, int wob,
                       int splits, int act, int with_db) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x;
  const int c_b = blockIdx.y;
  const int hib = (hob - 1) * stride + (hf - 1) * dil_h + 1;
  const int wib = (wob - 1) * stride + (wf - 1) * dil_w + 1;
  const int tiles_h = ho / hob;
  const int tiles_w = wo / wob;
  const int tiles = n_img * tiles_h * tiles_w;
  const int first = (int)((long long)tiles * split / splits);
  const int last = (int)((long long)tiles * (split + 1) / splits);
  const int npos = hob * wob;
  const int taps = hf * wf;

  const int npg = kThreads / cb;
  const int t = threadIdx.x;
  const int lane = t % cb;
  const int pg = t / cb;
  const bool computes = pg < npg;

  float* x_s = smem;                                   // [hib, wib, cb]
  float* d_s = smem + ((hib * wib * cb + 3) & ~3);     // [npos, cb]

  int toff[kMaxTaps];
  float acc[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    toff[k] = k < taps ? ((k / wf) * dil_h * wib + (k % wf) * dil_w) * cb : 0;
    acc[k] = 0.0f;
  }
  float dbacc = 0.0f;

  for (int tt = first; tt < last; ++tt) {
    const int n = tt / (tiles_h * tiles_w);
    const int ti = (tt / tiles_w) % tiles_h;
    const int tj = tt % tiles_w;
    const size_t map = (size_t)(n * cblk + c_b);
    stage_window(x_s, x + map * hi * wi * cb, nullptr, hi, wi, cb,
                 ti * hob * stride - pad_top, tj * wob * stride - pad_left,
                 hib, wib, 0);
    // the dz tile: the cotangent window of the tile itself, all in the map
    stage_window(d_s, g + map * ho * wo * cb,
                 z != nullptr ? z + map * ho * wo * cb : nullptr, ho, wo, cb,
                 ti * hob, tj * wob, hob, wob, act);
    __syncthreads();
    if (computes) {
      for (int p = pg; p < npos; p += npg) {
        const int ph = p / wob;
        const int pw = p % wob;
        const float dv = d_s[p * cb + lane];
        const int base = (ph * stride * wib + pw * stride) * cb + lane;
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          if (k == taps) break;
          acc[k] = fmaf(x_s[base + toff[k]], dv, acc[k]);
        }
        dbacc += dv;
      }
    }
    __syncthreads();
  }

  // the position groups' sums [npg, taps + 1, cb], added in group order
  float* red = smem;
  const int stride_g = (taps + 1) * cb;
  if (computes) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k < taps) red[pg * stride_g + k * cb + lane] = acc[k];
    }
    red[pg * stride_g + taps * cb + lane] = dbacc;
  }
  __syncthreads();
  const size_t dw_size = (size_t)cblk * taps * cb;
  float* row = ws + (size_t)split * (dw_size + (with_db ? cblk * cb : 0));
  for (int e = t; e < stride_g; e += kThreads) {
    float s = 0.0f;
    for (int q = 0; q < npg; ++q) s += red[q * stride_g + e];
    if (e < taps * cb) {
      row[(size_t)c_b * taps * cb + e] = s;
    } else if (with_db) {
      row[dw_size + c_b * cb + e - taps * cb] = s;
    }
  }
}

}  // namespace

extern "C" {

// The compiled geometry, for the wrapper's blocking model: threads per CTA,
// lanes per thread, filter taps a thread holds.
void conv2d_depthwise_geometry(int* threads, int* lanes, int* taps) {
  *threads = kThreads;
  *lanes = 1;
  *taps = kMaxTaps;
}

// dgrad = 0: the forward (src = x [hs, ws] = the input's extents, out =
// [hd, wd] = the output's); dgrad = 1: src = g [hs, ws] = the output's
// extents, z its prologue, out = dx [hd, wd] = the input's extents.
int conv2d_depthwise_taps(const void* src, const void* z, const void* w,
                          const void* bias, const void* residual, void* out,
                          void* partials, int dgrad, int n, int cblk, int cb,
                          int hs, int ws, int hd, int wd, int hf, int wf,
                          int stride, int dil_h, int dil_w, int pad_top,
                          int pad_left, int hob, int wob, int hwin, int wwin,
                          int act, int smem_bytes, void* stream) {
  auto kernel = dgrad ? depthwise_tap_kernel<true>
                      : depthwise_tap_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hd / hob) * (wd / wob), cblk, n);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)z, (const float*)w,
      (const float*)bias, (const float*)residual, (float*)out,
      (float*)partials, cblk, cb, hs, ws, hd, wd, hf, wf, stride, dil_h,
      dil_w, pad_top, pad_left, hob, wob, hwin, wwin, act);
  return (int)cudaGetLastError();
}

int conv2d_depthwise_wgrad(const void* x, const void* g, const void* z,
                           void* ws, int n, int cblk, int cb, int hi, int wi,
                           int ho, int wo, int hf, int wf, int stride,
                           int dil_h, int dil_w, int pad_top, int pad_left,
                           int hob, int wob, int splits, int act, int with_db,
                           int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      depthwise_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  depthwise_wgrad_kernel<<<dim3(splits, cblk), kThreads, smem_bytes,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)z, (float*)ws, n, cblk,
      cb, hi, wi, ho, wo, hf, wf, stride, dil_h, dil_w, pad_top, pad_left,
      hob, wob, splits, act, with_db);
  return (int)cudaGetLastError();
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
