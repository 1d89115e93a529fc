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
// What bounds these on this card.  A depthwise conv does 2*Hf*Wf = 18 FLOPs
// per output element against at least 8 bytes of traffic (one input and one
// output element; at stride 2, four inputs): 2.25 FLOP/byte or less, far
// below the H100's f32 ridge (~20 FLOP/byte).  Bytes bound it.
//
// forward (`depthwise_fwd_kernel`).  An item is a tile of hob x wob output
// positions of one image and channel block, over `lanes` lanes of the
// pencil (a pencil splits into 64- or 32-lane parts where that is what
// fills the card).  A persistent grid of at most the card's resident CTAs
// walks the items; each CTA stages an item's halo'd input window [hwin,
// wwin, lanes] by cp.async (16-byte copies, or 4-byte ones where lanes is
// not a multiple of 4) into one slot of a two-slot ring while it runs the
// taps of the item before from the other slot, so device memory stays busy
// under the taps and the stores.  Copies of cells outside the map copy
// nothing and zero-fill: they are the SAME (and TF-SAME's (0, 1)) pads.
// Thread t owns lane t % lanes and runs of output columns of the item's
// rows; at 3x3, dilation 1 and stride 1 or 2 (every MobileNet leg) it keeps
// the three tap columns in registers and loads only the columns a step
// along the run brings (3 loads an output at stride 1, 6 at stride 2, not
// 9), with no division in the walk.  Other filters, strides and dilations
// take a loop over the taps.  The epilogue is the reference's (+ b,
// activation, + r, one store); with GAP a CTA writes each item's sums over
// its positions, its position groups added in order, for `gap_finalize`,
// which adds an image's tiles in order.  No atomics.
//
// dgrad (`depthwise_dgrad_kernel`): one CTA per (tile of hob x wob positions
// of dx, channel block, image).  It stages a halo'd window of the cotangent
// (dz formed on the way in, zero outside the map) in shared memory; thread
// t owns lane t % Cb and every (256 / Cb)-th position of the tile, keeps its
// lane's taps in registers and, per position, sums the mirrored taps that
// the stride does not skip.  As in the dense dgrad, no stride-dilated or
// padded copy of the cotangent or of z exists and dx is written at the
// input's shape; TF-SAME's (0, 1) pads at stride 2 are the masks.
//
// wgrad: the TPU reduces (N, Ho/Hob, Wo/Wob) into a resident [Hf*Wf, Cb]
// block.  Here a CTA owns one channel block's [Hf*Wf, Cb] sums and walks a
// contiguous share of the position tiles (`splits` shares), staging each
// tile's x window and dz tile; a thread holds its lane's tap sums and db in
// registers, the position groups' sums meet in shared memory in group order,
// and each share's row of the [splits, |dw| + |db|] f32 workspace is summed
// by `wgrad_reduce` (direct_conv2d_bwd.cu) in split order.  No atomics.
//
// C interface for ctypes: pointers and the stream as void*, ints as int (the
// forward's geometry as one int array, built once per shape); each entry
// point returns cudaGetLastError() after its launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kMaxTaps = 25;    // filter taps a thread holds (5x5)
constexpr int kMinBlocksPerSm = 2;
constexpr int kSlots = 2;       // the forward's ring of item windows
constexpr int kMaxDevices = 64;

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
// forward: a persistent walk over items, two item windows in flight
// ---------------------------------------------------------------------------

// The forward's launch geometry, passed by value; its fields are the int
// array the host builds once per shape (conv2d_depthwise_fwd).
struct FwdGeometry {
  int cblk, cb, hi, wi, ho, wo;
  int hf, wf, stride, dil_h, dil_w, pad_top, pad_left;
  int hob, wob, hwin, wwin;
  int lanes;       // lanes of the pencil an item covers (divides cb)
  int items;       // images x channel blocks x lane groups x tiles
  int act;
};
constexpr int kFwdInts = sizeof(FwdGeometry) / sizeof(int);

struct Item {
  int map;         // n * cblk + c_b
  int lane0;       // the item's first lane of the pencil
  int tile;        // row-major over the output's tiles
  int i0, j0;      // the tile's first output row and column
};

__device__ __forceinline__ Item item_of(const FwdGeometry& g, int it) {
  const int tiles_w = g.wo / g.wob;
  const int tiles = (g.ho / g.hob) * tiles_w;
  const int groups = g.cb / g.lanes;
  Item m;
  m.tile = it % tiles;
  it /= tiles;
  m.lane0 = (it % groups) * g.lanes;
  m.map = it / groups;
  m.i0 = (m.tile / tiles_w) * g.hob;
  m.j0 = (m.tile % tiles_w) * g.wob;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async: `valid` false copies no byte and zero-fills the destination
// (src-size 0); `src` must still be a global address.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one of this thread's copy groups is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of item m's window [hwin, wwin, lanes] into `dst` (every
// thread of the CTA; the caller commits the group).
__device__ __forceinline__ void stage_item(float* dst,
                                           const float* __restrict__ x,
                                           const FwdGeometry& g,
                                           const Item& m) {
  const bool vec = g.lanes % 4 == 0;
  const int unit = vec ? 4 : 1;
  const int units = g.lanes / unit;
  const int r0 = m.i0 * g.stride - g.pad_top;
  const int c0 = m.j0 * g.stride - g.pad_left;
  const float* src = x + (size_t)m.map * g.hi * g.wi * g.cb + m.lane0;
  const int total = g.hwin * g.wwin * units;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int cell = i / units;
    const int c = (i - cell * units) * unit;
    const int r = cell / g.wwin;
    const int h = r0 + r;
    const int w = c0 + cell - r * g.wwin;
    const bool ok = h >= 0 && h < g.hi && w >= 0 && w < g.wi;
    const float* s = ok ? src + ((size_t)h * g.wi + w) * g.cb + c : x;
    if (vec) {
      cp_async16(dst + cell * g.lanes + c, s, ok);
    } else {
      cp_async4(dst + cell * g.lanes + c, s, ok);
    }
  }
}

// kS: 1 or 2 for a 3x3 filter at dilation 1 and that stride (tap columns
// kept in registers along a run), 0 for any filter, stride and dilation.
template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ residual,
                     float* __restrict__ out,
                     float* __restrict__ partials, FwdGeometry g) {
  extern __shared__ __align__(16) float smem[];
  const int L = g.lanes;
  const int slot_floats = (g.hwin * g.wwin * L + 3) & ~3;
  float* red = smem + kSlots * slot_floats;          // [npg, L] GAP sums
  const int t = threadIdx.x;
  const int lane = t % L;
  const int npg = kThreads / L;
  const int pg = t / L;
  const bool computes = pg < npg;
  const int taps = g.hf * g.wf;
  const int tiles = (g.ho / g.hob) * (g.wo / g.wob);
  // a unit of work: a run of columns of one output row of the item; the
  // rows split into `segs` runs so that every position group has one
  const int segs = min(g.wob, max(1, (npg + g.hob - 1) / g.hob));
  const int run = (g.wob + segs - 1) / segs;
  const int units = g.hob * segs;

  int it = blockIdx.x;
  if (it < g.items) stage_item(smem, x, g, item_of(g, it));
  cp_async_commit();
  for (int k = 0; it < g.items; it += gridDim.x, ++k) {
    const int slot = k & 1;
    const Item m = item_of(g, it);
    const int next = it + gridDim.x;
    if (next < g.items) {
      stage_item(smem + (slot ^ 1) * slot_floats, x, g, item_of(g, next));
    }
    cp_async_commit();

    // the item's taps and bias, loaded while its window lands
    const int c_b = m.map % g.cblk;
    const int lg = m.lane0 + lane;
    float wv[kS ? 9 : kMaxTaps];
#pragma unroll
    for (int q = 0; q < (kS ? 9 : kMaxTaps); ++q) {
      wv[q] = (computes && q < taps)
                  ? __ldg(w + ((size_t)c_b * taps + q) * g.cb + lg) : 0.0f;
    }
    const float bv = (bias != nullptr && computes) ? __ldg(bias + c_b * g.cb
                                                           + lg) : 0.0f;
    cp_async_wait_one();
    __syncthreads();

    const float* win = smem + slot * slot_floats + lane;
    float gsum = 0.0f;
    if (computes) {
      for (int u = pg; u < units; u += npg) {
        const int i = u / segs;
        const int jb = (u - i * segs) * run;
        const int je = min(g.wob, jb + run);
        const size_t o0 = (((size_t)m.map * g.ho + m.i0 + i) * g.wo + m.j0)
                              * g.cb + lg;
        if constexpr (kS != 0) {
          // rows i*s .. i*s + 2 of the window; a[d][e]: tap (d, e) of the
          // current output
          const float* rp = win + (size_t)i * kS * g.wwin * L;
          const int rs = g.wwin * L;
          float a[3][3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              a[d][e] = rp[d * rs + (jb * kS + e) * L];
            }
          }
          for (int j = jb; j < je; ++j) {
            if (j > jb) {
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                if constexpr (kS == 1) {
                  a[d][0] = a[d][1];
                  a[d][1] = a[d][2];
                  a[d][2] = rp[d * rs + (j + 2) * L];
                } else {
                  a[d][0] = a[d][2];
                  a[d][1] = rp[d * rs + (2 * j + 1) * L];
                  a[d][2] = rp[d * rs + (2 * j + 2) * L];
                }
              }
            }
            float acc = 0.0f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                acc = fmaf(a[d][e], wv[3 * d + e], acc);
              }
            }
            const size_t o = o0 + (size_t)j * g.cb;
            float v = activate(acc + bv, g.act);
            if (residual != nullptr) v += __ldg(residual + o);
            out[o] = v;
            gsum += v;
          }
        } else {
          for (int j = jb; j < je; ++j) {
            const float* base =
                win + ((size_t)i * g.stride * g.wwin + j * g.stride) * L;
            float acc = 0.0f;
#pragma unroll
            for (int q = 0; q < kMaxTaps; ++q) {
              if (q == taps) break;
              const int dh = q / g.wf;
              const int dw = q - dh * g.wf;
              acc = fmaf(base[(dh * g.dil_h * g.wwin + dw * g.dil_w) * L],
                         wv[q], acc);
            }
            const size_t o = o0 + (size_t)j * g.cb;
            float v = activate(acc + bv, g.act);
            if (residual != nullptr) v += __ldg(residual + o);
            out[o] = v;
            gsum += v;
          }
        }
      }
    }
    if (partials != nullptr) {
      // the item's sums of the stored values, the position groups in order
      if (computes) red[pg * L + lane] = gsum;
      __syncthreads();
      if (t < L) {
        float s = 0.0f;
        for (int q = 0; q < npg; ++q) s += red[q * L + t];
        partials[((size_t)m.map * tiles + m.tile) * g.cb + m.lane0 + t] = s;
      }
    }
    __syncthreads();                 // the slot is refilled next iteration
  }
}

// ---------------------------------------------------------------------------
// dgrad: the tap loop over the cotangent window, mirrored taps
// ---------------------------------------------------------------------------

// g: [N, C/Cb, hs, ws, Cb] with the prologue's z beside it (or null); dx:
// [N, C/Cb, hd, wd, Cb] at the forward input's extents.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_dgrad_kernel(const float* __restrict__ src,
                       const float* __restrict__ z,
                       const float* __restrict__ w,
                       float* __restrict__ out,
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

  // the window's origin in the cotangent
  const int r0 = floordiv(i0 + pad_top - (hf - 1) * dil_h, stride);
  const int c0 = floordiv(j0 + pad_left - (wf - 1) * dil_w, stride);
  const size_t map = (size_t)(n * cblk + c_b);
  stage_window(smem, src + map * hs * ws * cb,
               z != nullptr ? z + map * hs * ws * cb : nullptr, hs, ws, cb,
               r0, c0, hwin, wwin, act);

  // this lane's taps and their dilated extents
  float wv[kMaxTaps];
  int th[kMaxTaps], tw[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    const bool on = computes && k < taps;
    wv[k] = on ? __ldg(w + ((size_t)c_b * taps + k) * cb + lane) : 0.0f;
    th[k] = on ? (k / wf) * dil_h : 0;
    tw[k] = on ? (k % wf) * dil_w : 0;
  }
  __syncthreads();

  if (computes) {
    for (int p = pg; p < npos; p += npg) {
      const int ph = p / wob;
      const int pw = p % wob;
      float acc = 0.0f;
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
            acc = fmaf(smem[((uh / stride) * wwin + uw / stride) * cb + lane],
                       wv[k], acc);
          }
        }
      }
      out[((map * hd + i0 + ph) * wd + j0 + pw) * cb + lane] = acc;
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

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int variant, int bytes) {
  static int allowed[kMaxDevices][4];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int& have = allowed[device][variant];
  if (bytes <= have || bytes <= 48 * 1024) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
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

// The forward.  plan: the FwdGeometry fields in order, then the grid's
// CTAs, the dynamic shared memory and the kernel variant (0: any filter;
// 1, 2: 3x3 at dilation 1 and that stride).
int conv2d_depthwise_fwd(const void* x, const void* w, const void* bias,
                         const void* residual, void* out, void* partials,
                         const int* plan, void* stream) {
  FwdGeometry g;
  int* fields = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kFwdInts; ++i) fields[i] = plan[i];
  const int grid = plan[kFwdInts];
  const int smem = plan[kFwdInts + 1];
  const int variant = plan[kFwdInts + 2];
  if (grid <= 0) return 0;
  auto kernel = variant == 1   ? depthwise_fwd_kernel<1>
                : variant == 2 ? depthwise_fwd_kernel<2>
                               : depthwise_fwd_kernel<0>;
  cudaError_t err = allow_smem(kernel, variant, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias,
      (const float*)residual, (float*)out, (float*)partials, g);
  return (int)cudaGetLastError();
}

// The dgrad: g [hs, ws] = the output's extents, z its prologue (or null),
// dx [hd, wd] = the input's extents.
int conv2d_depthwise_dgrad(const void* g, const void* z, const void* w,
                           void* dx, int n, int cblk, int cb, int hs, int ws,
                           int hd, int wd, int hf, int wf, int stride,
                           int dil_h, int dil_w, int pad_top, int pad_left,
                           int hob, int wob, int hwin, int wwin, int act,
                           int smem_bytes, void* stream) {
  cudaError_t err = allow_smem(depthwise_dgrad_kernel, 3, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hd / hob) * (wd / wob), cblk, n);
  depthwise_dgrad_kernel<<<grid, kThreads, smem_bytes,
                           (cudaStream_t)stream>>>(
      (const float*)g, (const float*)z, (const float*)w, (float*)dx, cblk,
      cb, hs, ws, hd, wd, hf, wf, stride, dil_h, dil_w, pad_top, pad_left,
      hob, wob, hwin, wwin, act);
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
