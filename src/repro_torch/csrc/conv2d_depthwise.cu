// Depthwise convolution, f32 and bf16 — hand-written for Hopper (sm_90a).
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
// its positions, its position groups added in order, and the CTA of the
// last item of an (image, channel block) adds the image's tiles in order
// into the pooled features (split_sum.cuh), in the same launch.
//
// dgrad (`depthwise_dgrad_kernel<kS>`): the forward's design over
// items of dx.  An item is a tile of hob x wob positions of dx of one image
// and channel block over `lanes` lanes; a persistent grid walks the items,
// staging each item's cotangent window (g, and z beside it with the
// prologue) by cp.async into one slot of a two-slot ring while the taps of
// the item before run from the other.  A thread takes one (column, lane
// unit) pair of the window and walks its rows by a stepped offset, so a
// copy costs no division.  Cells outside the map zero-fill; g = 0 gives dz
// = 0 for every activation, so they add nothing.  dz = g * act'(z) is
// formed once per staged cell in a pass over the landed slot.  At 3x3,
// dilation 1 and stride 1 (kS 1) the taps turned by 180 degrees make dx
// the forward's correlation, and a thread walks a run of a row with the tap
// columns in registers: three loads an output, no division.  At stride 2 (kS 2) dx splits by phase: row u + pt
// even takes taps dh 0 and 2, odd dh 1, and columns likewise, so the four
// phases run 2x2, 2x1, 1x2 and 1x1 taps (TF-SAME's pads (0, 1) or any
// other), each over only its own taps with no parity test, and consecutive
// outputs of a phase read consecutive cotangent columns (one load a row tap
// an output).  Any other filter up to 5x5, stride or dilation takes a tap
// loop that tests each tap's divisions (kS 0).  As in the dense dgrad, no
// stride-dilated or padded copy of the cotangent or of z exists and dx is
// written at the input's shape.
//
// wgrad (`depthwise_wgrad_kernel<kS>`): the TPU reduces (N, Ho/Hob,
// Wo/Wob) into a resident [Hf*Wf, Cb] block.  Here the forward's items
// (tiles of output positions of one image over `lanes` lanes, a pencil split
// into 64- or 32-lane parts where that fills the card) make the walk: a
// column is a (channel block, lane group), and each CTA walks a contiguous
// share of its column's items (`splits` shares), staging each item's x
// window and its g tile (z beside it with the prologue) by cp.async into one
// slot of a two-slot ring while the item before runs from the other, cells
// outside the map zero-filled, each copy by a thread stepping the rows of
// one (column, lane unit) pair.  dz = g * act'(z) is formed once per staged
// cell in a pass over the landed slot.  At 3x3, dilation 1 and stride 1 or
// 2 (every MobileNet leg) a thread walks a run of an output row with the x
// columns of its three tap columns in registers, loading only the columns a
// step brings (3 x loads and one dz load an output at stride 1, 6 and one
// at stride 2, not 9 and a division), and keeps its 9 tap sums and db in
// registers; other filters up to 5x5, strides and dilations take a tap
// loop (kS 0).  The position groups' sums meet in shared memory in group
// order into the share's row of the [splits, |dw| + |db|] f32 workspace,
// and the column's last CTA sums the rows in split order into dw and db
// (split_sum.cuh).  No sum depends on the order CTAs run in.
//
// bf16 builds (`depthwise_fwd_kernel_bf16`, `depthwise_dgrad_kernel_bf16`,
// `depthwise_wgrad_kernel_bf16`): the same three walks on 2-byte cells, the
// reference's kernels under its BF16 policy.  x, w, g, z, the residual, out
// and dx are bf16; the bias, every tap product and sum, the epilogue and dw
// and db are f32.  Each walk is one template over the cell type (`fwd_walk`,
// `dgrad_walk`, `wgrad_walk`) that the f32 and the bf16 kernels both run:
// the shared-memory ring holds the type's cells and a read converts a cell
// to f32.  The forward rounds act(sum + b) (+ r) once to bf16 and sums the
// rounded values for the GAP; the dgrad's and the wgrad's dz = g * act'(z)
// is rounded to bf16 before any tap reads it (the reference's
// cotangent_prologue); dx is rounded once.  Staging copies 16 bytes (8
// lanes) where the lane count allows, else 4 (2 lanes), else, for an odd
// pencil (Cb = 3), each 2-byte cell by a plain load and store, zero outside
// the map, since cp.async has no 2-byte copy.
//
// C interface for ctypes: pointers and the stream as void*, ints as int (the
// forward's geometry as one int array, built once per shape); each entry
// point (and its `_bf16` twin, which takes the same arguments) returns
// cudaGetLastError() after its launch (0 on success), and refuses a plan
// whose shared memory is not the walk's own carve-up (core/blocking.py's
// depthwise_*_smem_bytes at the build's cell size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "split_sum.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// A cell's value in f32, and an f32 value stored as a cell (bf16: rounded
// to nearest, once).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// a read-only global load, in f32
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Cells of a ring buffer of `n` cells, rounded up to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int ring_cells(int n) {
  constexpr int k = 16 / sizeof(T);
  return (n + k - 1) / k * k;
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

// Item `it` of a walk over tiles of hob x wob of an h x w map, tile-major,
// then lane groups of `lanes`, then (image, channel block) maps.
__device__ __forceinline__ Item item_at(int it, int h, int w, int hob,
                                        int wob, int cb, int lanes) {
  const int tiles_w = w / wob;
  const int tiles = (h / hob) * tiles_w;
  const int groups = cb / lanes;
  Item m;
  m.tile = it % tiles;
  it /= tiles;
  m.lane0 = (it % groups) * lanes;
  m.map = it / groups;
  m.i0 = (m.tile / tiles_w) * hob;
  m.j0 = (m.tile % tiles_w) * wob;
  return m;
}

__device__ __forceinline__ Item item_of(const FwdGeometry& g, int it) {
  return item_at(it, g.ho, g.wo, g.hob, g.wob, g.cb, g.lanes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async: `valid` false copies no byte and zero-fills the destination
// (src-size 0); `src` must still be a global address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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

// Issue the copies of a window [hwin, wwin, lanes] whose cell (r, c) is row
// r0 + r, column c0 + c of `src` (one map [hs, ws, cb], from its lane 0
// on), zero outside the map (every thread of the CTA; the caller commits
// the group).  A thread takes one (column, lane unit) pair and a residue of
// the rows and walks them by an offset it steps, so that a copy costs no
// division: per-copy index arithmetic ran the forward's staging at 1.8x
// its bytes' bound.  A unit is 16 bytes where the lanes allow, else 4;
// an odd bf16 pencil's cells go one by one as 2-byte loads and stores.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           const T* any, int hs, int ws,
                                           int cb, int lanes, int r0, int c0,
                                           int hwin, int wwin) {
  constexpr int k16 = 16 / sizeof(T);    // cells of a 16-byte copy
  constexpr int k4 = 4 / sizeof(T);      // of a 4-byte one
  const int unit = lanes % k16 == 0 ? k16 : (lanes % k4 == 0 ? k4 : 1);
  const int units = lanes / unit;
  const int pairs = wwin * units;
  const int rstep = pairs >= kThreads ? 1 : kThreads / pairs;
  const int dst_row = wwin * lanes * rstep;
  for (int p = threadIdx.x; p < pairs * rstep; p += kThreads) {
    const int q = p % pairs;
    const int r = p / pairs;
    const int col = q / units;
    const int c = (q - col * units) * unit;
    const int w = c0 + col;
    const bool w_ok = w >= 0 && w < ws;
    long long off = ((long long)(r0 + r) * ws + w) * cb + c;
    const long long src_row = (long long)ws * cb * rstep;
    T* d = dst + (r * wwin + col) * lanes + c;
    for (int h = r0 + r; h < r0 + hwin; h += rstep) {
      const bool ok = w_ok && h >= 0 && h < hs;
      const T* s = ok ? src + off : any;
      if (unit == k16) {
        cp_async16(d, s, ok);
      } else if (unit == k4) {
        cp_async4(d, s, ok);
      } else {
        *reinterpret_cast<unsigned short*>(d) =
            ok ? __ldg(reinterpret_cast<const unsigned short*>(s))
               : (unsigned short)0;
      }
      off += src_row;
      d += dst_row;
    }
  }
}

// Issue the copies of item m's input window [hwin, wwin, lanes] into
// `dst` (every thread of the CTA; the caller commits the group).
template <typename T>
__device__ __forceinline__ void stage_item(T* dst, const T* __restrict__ x,
                                           const FwdGeometry& g,
                                           const Item& m) {
  stage_rows(dst, x + (size_t)m.map * g.hi * g.wi * g.cb + m.lane0, x, g.hi,
             g.wi, g.cb, g.lanes, m.i0 * g.stride - g.pad_top,
             m.j0 * g.stride - g.pad_left, g.hwin, g.wwin);
}

// The forward's walk on cells of type T (float, or bf16 with f32 taps,
// sums and epilogue, the result rounded once).  kS: 1 or 2 for a 3x3 filter
// at dilation 1 and that stride (tap columns kept in registers along a
// run), 0 for any filter, stride and dilation.
template <typename T, int kS>
__device__ __forceinline__ void fwd_walk(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const float* __restrict__ bias,
                                         const T* __restrict__ residual,
                                         T* __restrict__ out, float* partials,
                                         T* __restrict__ pooled,
                                         int* counters, const FwdGeometry& g) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* smem = reinterpret_cast<T*>(dw_smem);
  const int L = g.lanes;
  const int slot_floats = ring_cells<T>(g.hwin * g.wwin * L);
  // [npg, L] GAP sums
  float* red = reinterpret_cast<float*>(smem + kSlots * slot_floats);
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
                  ? ldg_f32(w + ((size_t)c_b * taps + q) * g.cb + lg) : 0.0f;
    }
    const float bv = (bias != nullptr && computes) ? __ldg(bias + c_b * g.cb
                                                           + lg) : 0.0f;
    cp_async_wait_one();
    __syncthreads();

    const T* win = smem + slot * slot_floats + lane;
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
          const T* rp = win + (size_t)i * kS * g.wwin * L;
          const int rs = g.wwin * L;
          float a[3][3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              a[d][e] = to_f32(rp[d * rs + (jb * kS + e) * L]);
            }
          }
          for (int j = jb; j < je; ++j) {
            if (j > jb) {
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                if constexpr (kS == 1) {
                  a[d][0] = a[d][1];
                  a[d][1] = a[d][2];
                  a[d][2] = to_f32(rp[d * rs + (j + 2) * L]);
                } else {
                  a[d][0] = a[d][2];
                  a[d][1] = to_f32(rp[d * rs + (2 * j + 1) * L]);
                  a[d][2] = to_f32(rp[d * rs + (2 * j + 2) * L]);
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
            if (residual != nullptr) v += ldg_f32(residual + o);
            const T stored = from_f32<T>(v);
            out[o] = stored;
            gsum += to_f32(stored);
          }
        } else {
          for (int j = jb; j < je; ++j) {
            const T* base =
                win + ((size_t)i * g.stride * g.wwin + j * g.stride) * L;
            float acc = 0.0f;
#pragma unroll
            for (int q = 0; q < kMaxTaps; ++q) {
              if (q == taps) break;
              const int dh = q / g.wf;
              const int dw = q - dh * g.wf;
              acc = fmaf(to_f32(base[(dh * g.dil_h * g.wwin + dw * g.dil_w)
                                     * L]),
                         wv[q], acc);
            }
            const size_t o = o0 + (size_t)j * g.cb;
            float v = activate(acc + bv, g.act);
            if (residual != nullptr) v += ldg_f32(residual + o);
            const T stored = from_f32<T>(v);
            out[o] = stored;
            gsum += to_f32(stored);
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
      // the last item of (image, channel block), over its tiles and lane
      // groups: the tiles in order, times the f32 reciprocal of Ho * Wo
      split_sum::gap_fold(partials, pooled, counters, m.map, tiles,
                          tiles * (g.cb / L), g.cb, g.ho * g.wo,
                          reinterpret_cast<int*>(red), 0, kThreads);
    }
    __syncthreads();                 // the slot is refilled next iteration
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ residual,
                     float* __restrict__ out, float* partials,
                     float* __restrict__ pooled, int* counters,
                     FwdGeometry g) {
  fwd_walk<float, kS>(x, w, bias, residual, out, partials, pooled, counters,
                      g);
}

// the bf16 build: bf16 cells, f32 bias, partials and sums; out and the
// pooled features bf16
template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_fwd_kernel_bf16(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias,
                          const bf16* __restrict__ residual,
                          bf16* __restrict__ out, float* partials,
                          bf16* __restrict__ pooled, int* counters,
                          FwdGeometry g) {
  fwd_walk<bf16, kS>(x, w, bias, residual, out, partials, pooled, counters,
                     g);
}

// ---------------------------------------------------------------------------
// dgrad: a persistent walk over items of dx, two cotangent windows in flight
// ---------------------------------------------------------------------------

// The dgrad's launch geometry, passed by value; its fields are the int array
// the host builds once per shape (conv2d_depthwise_dgrad).
struct DgradGeometry {
  int cblk, cb, ho, wo, hi, wi;   // g, z [N, cblk, ho, wo, cb]; dx at hi x wi
  int hf, wf, stride, dil_h, dil_w, pad_top, pad_left;
  int hob, wob, hwin, wwin;       // an item's dx tile and cotangent window
  int lanes;       // lanes of the pencil an item covers (divides cb)
  int items;       // images x channel blocks x lane groups x tiles
  int act;
  int prologue;    // 1: z is staged beside g and dz = g * act'(z) formed
};
constexpr int kDgradInts = sizeof(DgradGeometry) / sizeof(int);

// dz = g * act'(z) over a landed slot, in place of g (cells [0, n), n a
// whole number of 16 bytes); bf16 cells take the f32 product rounded once
// to bf16, the reference's cotangent_prologue under BF16.
template <typename T>
__device__ __forceinline__ void prologue_pass(T* gs, const T* zs, int n,
                                              int act) {
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      float4 v = reinterpret_cast<float4*>(gs)[i];
      const float4 zz = reinterpret_cast<const float4*>(zs)[i];
      v.x = prologue(v.x, zz.x, act);
      v.y = prologue(v.y, zz.y, act);
      v.z = prologue(v.z, zz.z, act);
      v.w = prologue(v.w, zz.w, act);
      reinterpret_cast<float4*>(gs)[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < n / 2; i += kThreads) {
      __nv_bfloat162 v = reinterpret_cast<__nv_bfloat162*>(gs)[i];
      const __nv_bfloat162 zz = reinterpret_cast<const __nv_bfloat162*>(zs)[i];
      v.x = __float2bfloat16_rn(prologue(__bfloat162float(v.x),
                                         __bfloat162float(zz.x), act));
      v.y = __float2bfloat16_rn(prologue(__bfloat162float(v.y),
                                         __bfloat162float(zz.y), act));
      reinterpret_cast<__nv_bfloat162*>(gs)[i] = v;
    }
  }
}

// One run of a stride-2 phase (3x3, dilation 1): outputs k0 .. k1 - 1 of
// the phase along a row, output k at out + k * ostep.  RT row taps (2: dh
// 0 at window row wr and dh 2 at wr - 1; 1: dh 1 at wr) by CT column taps
// (2: dw 0 at window column wc + k and dw 2 one left of it; 1: dw 1 at wc +
// k).  Output k + 1 reads the column right of output k's, so the columns a
// step along the run brings are one load per row tap.
template <int RT, int CT, typename T>
__device__ __forceinline__ void phase_run(const T* cell,
                                          const float (&w9)[9], int rs,
                                          int L, int wr, int wc, int k0,
                                          int k1, T* out, int ostep) {
  float cur[RT], prv[RT];
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    cur[t] = to_f32(cell[(wr - t) * rs + (wc + k0) * L]);
    prv[t] = CT == 2 ? to_f32(cell[(wr - t) * rs + (wc + k0 - 1) * L])
                     : 0.0f;
  }
  for (int k = k0; k < k1; ++k) {
    if (k > k0) {
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        if constexpr (CT == 2) prv[t] = cur[t];
        cur[t] = to_f32(cell[(wr - t) * rs + (wc + k) * L]);
      }
    }
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int dh = RT == 2 ? 2 * t : 1;
      acc = fmaf(cur[t], w9[3 * dh + (CT == 2 ? 0 : 1)], acc);
      if constexpr (CT == 2) acc = fmaf(prv[t], w9[3 * dh + 2], acc);
    }
    out[(size_t)k * ostep] = from_f32<T>(acc);
  }
}

// The dgrad's walk on cells of type T (float, or bf16 with f32 taps and
// sums, dz rounded to bf16 before the taps and dx once).  kS: 1 for a 3x3
// filter at dilation 1 and stride 1 (the forward's register path with the
// taps turned by 180 degrees), 2 for it at stride 2 (dx split by phase,
// each phase over only its own taps), 0 for any filter up to 5x5, stride
// and dilation (a tap loop that tests each tap's divisions).
template <typename T, int kS>
__device__ __forceinline__ void dgrad_walk(const T* __restrict__ g,
                                           const T* __restrict__ z,
                                           const T* __restrict__ w,
                                           T* __restrict__ dx,
                                           const DgradGeometry& geo) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* smem = reinterpret_cast<T*>(dw_smem);
  const int L = geo.lanes;
  const int win_floats = ring_cells<T>(geo.hwin * geo.wwin * L);
  const int slot_floats = (geo.prologue ? 2 : 1) * win_floats;
  const int t = threadIdx.x;
  const int lane = t % L;
  const int npg = kThreads / L;
  const int pg = t / L;
  const bool computes = pg < npg;
  const int taps = geo.hf * geo.wf;
  const int rs = geo.wwin * L;
  const size_t map_floats = (size_t)geo.ho * geo.wo * geo.cb;
  // a unit of work: a run of outputs of one row of the item (at stride 2,
  // of one column phase of it); the rows split into `segs` runs so that
  // every position group has one
  const int parts = kS == 2 ? 2 : 1;
  const int per_row = kS == 2 ? (geo.wob + 1) / 2 : geo.wob;
  const int segs = min(per_row, max(1, (npg + parts * geo.hob - 1)
                                           / (parts * geo.hob)));
  const int units = geo.hob * parts * segs;

  auto origin = [&](const Item& m, int& r0, int& c0) {
    r0 = floordiv(m.i0 + geo.pad_top - (geo.hf - 1) * geo.dil_h, geo.stride);
    c0 = floordiv(m.j0 + geo.pad_left - (geo.wf - 1) * geo.dil_w,
                  geo.stride);
  };
  auto stage = [&](T* slot, const Item& m) {
    int r0, c0;
    origin(m, r0, c0);
    const size_t base = (size_t)m.map * map_floats + m.lane0;
    stage_rows(slot, g + base, g, geo.ho, geo.wo, geo.cb, L, r0, c0,
               geo.hwin, geo.wwin);
    if (geo.prologue) {
      stage_rows(slot + win_floats, z + base, z, geo.ho, geo.wo, geo.cb, L,
                 r0, c0, geo.hwin, geo.wwin);
    }
  };

  int it = blockIdx.x;
  if (it < geo.items) {
    stage(smem, item_at(it, geo.hi, geo.wi, geo.hob, geo.wob, geo.cb, L));
  }
  cp_async_commit();
  for (int k = 0; it < geo.items; it += gridDim.x, ++k) {
    const int slot = k & 1;
    const Item m = item_at(it, geo.hi, geo.wi, geo.hob, geo.wob, geo.cb, L);
    const int next = it + gridDim.x;
    if (next < geo.items) {
      stage(smem + (slot ^ 1) * slot_floats,
            item_at(next, geo.hi, geo.wi, geo.hob, geo.wob, geo.cb, L));
    }
    cp_async_commit();

    // the item's taps, loaded while its window lands
    const int c_b = m.map % geo.cblk;
    const int lg = m.lane0 + lane;
    float wv[kS ? 9 : kMaxTaps];
#pragma unroll
    for (int q = 0; q < (kS ? 9 : kMaxTaps); ++q) {
      // kS 1 reads the taps turned by 180 degrees
      const int tap = kS == 1 ? 8 - q : q;
      wv[q] = (computes && q < taps)
                  ? ldg_f32(w + ((size_t)c_b * taps + tap) * geo.cb + lg)
                  : 0.0f;
    }
    cp_async_wait_one();
    __syncthreads();

    // dz once per staged cell, in place of g: each cell is read by up to
    // three outputs' taps, and forming it at each read timed slower
    T* gs = smem + slot * slot_floats;
    if (geo.prologue) {
      prologue_pass(gs, gs + win_floats, win_floats, geo.act);
      __syncthreads();
    }
    const T* cell = gs + lane;
    int r0, c0;
    origin(m, r0, c0);
    if (computes) {
      for (int u = pg; u < units; u += npg) {
        const int i = u / (parts * segs);
        const int rest = u - i * parts * segs;
        const int part = rest / segs;
        const int seg = rest - part * segs;
        T* orow = dx + (((size_t)m.map * geo.hi + m.i0 + i) * geo.wi
                        + m.j0) * geo.cb + lg;
        if constexpr (kS == 1) {
          // window rows i .. i + 2 turned: a[d][e] is tap (2 - d, 2 - e)
          const int run = (geo.wob + segs - 1) / segs;
          const int jb = seg * run;
          const int je = min(geo.wob, jb + run);
          const int rp = i * rs;
          float a[3][3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              a[d][e] = to_f32(cell[rp + d * rs + (jb + e) * L]);
            }
          }
          for (int j = jb; j < je; ++j) {
            if (j > jb) {
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                a[d][0] = a[d][1];
                a[d][1] = a[d][2];
                a[d][2] = to_f32(cell[rp + d * rs + (j + 2) * L]);
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
            orow[(size_t)j * geo.cb] = from_f32<T>(acc);
          }
        } else if constexpr (kS == 2) {
          // the row's phase fixes its row taps, `part` the column phase
          const int ut = m.i0 + i + geo.pad_top;
          const int v0 = m.j0 + geo.pad_left;
          const int jf = (part - v0) & 1;          // first column of the part
          const int count = jf < geo.wob ? (geo.wob - jf + 1) / 2 : 0;
          const int run = (count + segs - 1) / segs;
          const int k0 = seg * run;
          const int k1 = min(count, k0 + run);
          if (k0 < k1) {
            const int wr = (ut >> 1) - r0;           // dh 0 (even), dh 1 (odd)
            const int wc = ((v0 + jf) >> 1) - c0;    // dw 0 (even), dw 1 (odd)
            T* o = orow + (size_t)jf * geo.cb;
            const int ostep = 2 * geo.cb;
            if (ut & 1) {
              if (part) {
                phase_run<1, 1>(cell, wv, rs, L, wr, wc, k0, k1, o, ostep);
              } else {
                phase_run<1, 2>(cell, wv, rs, L, wr, wc, k0, k1, o, ostep);
              }
            } else if (part) {
              phase_run<2, 1>(cell, wv, rs, L, wr, wc, k0, k1, o, ostep);
            } else {
              phase_run<2, 2>(cell, wv, rs, L, wr, wc, k0, k1, o, ostep);
            }
          }
        } else {
          const int run = (geo.wob + segs - 1) / segs;
          const int jb = seg * run;
          const int je = min(geo.wob, jb + run);
          // numerators relative to the window's origin; a tap counts where
          // the stride divides both
          const int ah = m.i0 + i + geo.pad_top - geo.stride * r0;
          for (int j = jb; j < je; ++j) {
            const int aw = m.j0 + j + geo.pad_left - geo.stride * c0;
            float acc = 0.0f;
#pragma unroll
            for (int q = 0; q < kMaxTaps; ++q) {
              if (q == taps) break;
              const int uh = ah - (q / geo.wf) * geo.dil_h;
              const int uw = aw - (q % geo.wf) * geo.dil_w;
              if (geo.stride == 1) {
                acc = fmaf(to_f32(cell[uh * rs + uw * L]), wv[q], acc);
              } else if (uh % geo.stride == 0 && uw % geo.stride == 0) {
                acc = fmaf(to_f32(cell[(uh / geo.stride) * rs
                                       + (uw / geo.stride) * L]),
                           wv[q], acc);
              }
            }
            orow[(size_t)j * geo.cb] = from_f32<T>(acc);
          }
        }
      }
    }
    __syncthreads();                 // the slot is refilled next iteration
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_dgrad_kernel(const float* __restrict__ g,
                       const float* __restrict__ z,
                       const float* __restrict__ w,
                       float* __restrict__ dx, DgradGeometry geo) {
  dgrad_walk<float, kS>(g, z, w, dx, geo);
}

// the bf16 build: g, z, w and dx bf16
template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_dgrad_kernel_bf16(const bf16* __restrict__ g,
                            const bf16* __restrict__ z,
                            const bf16* __restrict__ w,
                            bf16* __restrict__ dx, DgradGeometry geo) {
  dgrad_walk<bf16, kS>(g, z, w, dx, geo);
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// The wgrad's launch geometry, passed by value; its fields are the int array
// the host builds once per shape (conv2d_depthwise_wgrad).
struct WgradGeometry {
  int cblk, cb, hi, wi, ho, wo;   // x at hi x wi; g, z [N, cblk, ho, wo, cb]
  int hf, wf, stride, dil_h, dil_w, pad_top, pad_left;
  int hob, wob, hwin, wwin;       // an item's output tile and x window
  int lanes;       // lanes of the pencil an item covers (divides cb)
  int per_column;  // items of a (channel block, lane group): images x tiles
  int splits;      // contiguous shares of a column's items, a CTA each
  int act;
  int prologue;    // 1: z is staged beside g and dz = g * act'(z) formed
  int with_db;
};
constexpr int kWgradInts = sizeof(WgradGeometry) / sizeof(int);

// The wgrad's walk on cells of type T (float, or bf16: dz rounded to bf16
// before the taps, every product and sum f32).  kS: 1 or 2 for a 3x3 filter
// at dilation 1 and that stride (a run of a row with the three tap columns
// in registers), 0 for any filter up to 5x5, stride and dilation (a tap
// loop).
template <typename T, int kS>
__device__ __forceinline__ void wgrad_walk(const T* __restrict__ x,
                                           const T* __restrict__ g,
                                           const T* __restrict__ z,
                                           float* ws, float* out,
                                           int* counters,
                                           const WgradGeometry& geo) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* smem = reinterpret_cast<T*>(dw_smem);
  const int L = geo.lanes;
  const int split = blockIdx.x, column = blockIdx.y;
  const int groups = geo.cb / L;
  const int c_b = column / groups;
  const int lane0 = (column - c_b * groups) * L;
  const int x_floats = ring_cells<T>(geo.hwin * geo.wwin * L);
  const int t_floats = ring_cells<T>(geo.hob * geo.wob * L);
  const int slot_floats = x_floats + (geo.prologue ? 2 : 1) * t_floats;
  const int t = threadIdx.x;
  const int lane = t % L;
  const int npg = kThreads / L;
  const int pg = t / L;
  const bool computes = pg < npg;
  const int taps = geo.hf * geo.wf;
  const int tiles_w = geo.wo / geo.wob;
  const int tiles = (geo.ho / geo.hob) * tiles_w;
  const int first = (int)((long long)geo.per_column * split / geo.splits);
  const int last = (int)((long long)geo.per_column * (split + 1) / geo.splits);
  const int rs = geo.wwin * L;
  // a unit of work: a run of columns of one output row of the item; the
  // rows split into `segs` runs so that every position group has one
  const int segs = min(geo.wob, max(1, (npg + geo.hob - 1) / geo.hob));
  const int run = (geo.wob + segs - 1) / segs;
  const int units = geo.hob * segs;

  // item `it` of the column: image it / tiles, tile it % tiles; its x
  // window (zeros outside the map: the pads), g tile and z tile
  auto stage = [&](T* slot, int it) {
    const int img = it / tiles, tile = it - img * tiles;
    const int i0 = tile / tiles_w * geo.hob, j0 = tile % tiles_w * geo.wob;
    const size_t map = (size_t)img * geo.cblk + c_b;
    stage_rows(slot, x + map * geo.hi * geo.wi * geo.cb + lane0, x, geo.hi,
               geo.wi, geo.cb, L, i0 * geo.stride - geo.pad_top,
               j0 * geo.stride - geo.pad_left, geo.hwin, geo.wwin);
    const size_t gm = map * geo.ho * geo.wo * geo.cb + lane0;
    stage_rows(slot + x_floats, g + gm, g, geo.ho, geo.wo, geo.cb, L, i0, j0,
               geo.hob, geo.wob);
    if (geo.prologue) {
      stage_rows(slot + x_floats + t_floats, z + gm, z, geo.ho, geo.wo,
                 geo.cb, L, i0, j0, geo.hob, geo.wob);
    }
  };

  float acc[kS ? 9 : kMaxTaps];
  int toff[kS ? 1 : kMaxTaps];
#pragma unroll
  for (int q = 0; q < (kS ? 9 : kMaxTaps); ++q) acc[q] = 0.0f;
  if constexpr (kS == 0) {
#pragma unroll
    for (int q = 0; q < kMaxTaps; ++q) {
      toff[q] = q < taps ? ((q / geo.wf) * geo.dil_h * geo.wwin
                            + (q % geo.wf) * geo.dil_w) * L
                         : 0;
    }
  }
  float dbacc = 0.0f;

  if (first < last) stage(smem, first);
  cp_async_commit();
  for (int it = first, k = 0; it < last; ++it, ++k) {
    const int slot = k & 1;
    if (it + 1 < last) stage(smem + (slot ^ 1) * slot_floats, it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const T* xs = smem + slot * slot_floats;
    T* gs = smem + slot * slot_floats + x_floats;
    // dz once per staged cell, in place of g
    if (geo.prologue) {
      prologue_pass(gs, gs + t_floats, t_floats, geo.act);
      __syncthreads();
    }
    if (computes) {
      const T* xw = xs + lane;
      for (int u = pg; u < units; u += npg) {
        const int i = u / segs;
        const int jb = (u - i * segs) * run;
        const int je = min(geo.wob, jb + run);
        const T* dzr = gs + (size_t)i * geo.wob * L + lane;
        if constexpr (kS != 0) {
          // window rows i*s .. i*s + 2; a[d][e]: tap (d, e)'s x for the
          // current output
          const T* rp = xw + (size_t)i * kS * rs;
          float a[3][3];
          if (jb < je) {
#pragma unroll
            for (int d = 0; d < 3; ++d) {
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                a[d][e] = to_f32(rp[d * rs + (jb * kS + e) * L]);
              }
            }
          }
          for (int j = jb; j < je; ++j) {
            if (j > jb) {
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                if constexpr (kS == 1) {
                  a[d][0] = a[d][1];
                  a[d][1] = a[d][2];
                  a[d][2] = to_f32(rp[d * rs + (j + 2) * L]);
                } else {
                  a[d][0] = a[d][2];
                  a[d][1] = to_f32(rp[d * rs + (2 * j + 1) * L]);
                  a[d][2] = to_f32(rp[d * rs + (2 * j + 2) * L]);
                }
              }
            }
            const float dv = to_f32(dzr[j * L]);
#pragma unroll
            for (int d = 0; d < 3; ++d) {
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                acc[3 * d + e] = fmaf(a[d][e], dv, acc[3 * d + e]);
              }
            }
            dbacc += dv;
          }
        } else {
          for (int j = jb; j < je; ++j) {
            const T* base =
                xw + ((size_t)i * geo.stride * geo.wwin + j * geo.stride) * L;
            const float dv = to_f32(dzr[j * L]);
#pragma unroll
            for (int q = 0; q < kMaxTaps; ++q) {
              if (q == taps) break;
              acc[q] = fmaf(to_f32(base[toff[q]]), dv, acc[q]);
            }
            dbacc += dv;
          }
        }
      }
    }
    __syncthreads();                 // the slot is refilled next iteration
  }

  // the position groups' sums [npg, taps + 1, L], added in group order into
  // the share's row (the ring is free: every copy has landed and been read)
  float* red = reinterpret_cast<float*>(dw_smem);
  const int stride_g = (taps + 1) * L;
  if (computes) {
#pragma unroll
    for (int q = 0; q < (kS ? 9 : kMaxTaps); ++q) {
      if (q < taps) red[pg * stride_g + q * L + lane] = acc[q];
    }
    red[pg * stride_g + taps * L + lane] = dbacc;
  }
  __syncthreads();
  const size_t dw_size = (size_t)geo.cblk * taps * geo.cb;
  const size_t cols = dw_size + (geo.with_db ? (size_t)geo.cblk * geo.cb : 0);
  // the column's outputs: tap q of lane l at dw_at(q) + l, db's at db_at + l
  const size_t dw_at = (size_t)c_b * taps * geo.cb + lane0;
  const size_t db_at = dw_size + (size_t)c_b * geo.cb + lane0;
  float* row = ws + (size_t)split * cols;
  for (int e = t; e < stride_g; e += kThreads) {
    float sum = 0.0f;
    for (int q = 0; q < npg; ++q) sum += red[q * stride_g + e];
    const int q = e / L, l = e - q * L;
    if (q < taps) {
      row[dw_at + (size_t)q * geo.cb + l] = sum;
    } else if (geo.with_db) {
      row[db_at + l] = sum;
    }
  }

  // the column's last CTA sums its rows in split order, one output a thread
  // (red is free once every thread has arrived)
  if (!split_sum::arrive(counters + column, geo.splits,
                         reinterpret_cast<int*>(red), 0, kThreads, t == 0)) {
    return;
  }
  for (int e = t; e < stride_g; e += kThreads) {
    const int q = e / L, l = e - q * L;
    if (q == taps && !geo.with_db) continue;
    const size_t at = q < taps ? dw_at + (size_t)q * geo.cb + l : db_at + l;
    split_sum::sum_rows(ws + at, cols, geo.splits, out + at, 1, 1.0f, 0, 1);
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_wgrad_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ z, float* ws, float* out,
                       int* counters, WgradGeometry geo) {
  wgrad_walk<float, kS>(x, g, z, ws, out, counters, geo);
}

// the bf16 build: x, g and z bf16; the workspace, dw and db f32
template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
depthwise_wgrad_kernel_bf16(const bf16* __restrict__ x,
                            const bf16* __restrict__ g,
                            const bf16* __restrict__ z, float* ws,
                            float* out, int* counters, WgradGeometry geo) {
  wgrad_walk<bf16, kS>(x, g, z, ws, out, counters, geo);
}

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device);
// `slot` names the kernel among its entry's instances (the f32 variants,
// then the bf16 ones).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int slot, int bytes) {
  static int allowed[kMaxDevices][6];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int& have = allowed[device][slot];
  if (bytes <= have || bytes <= 48 * 1024) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// The walks' shared memory at cells of type T (core/blocking.py
// depthwise_fwd_smem_bytes, depthwise_dgrad_smem_bytes,
// depthwise_wgrad_smem_bytes): the two-slot ring of T cells, each buffer
// rounded up to 16 bytes; the forward's GAP sums and the wgrad's position
// groups' sums (which reuse the ring) f32.
template <typename T>
size_t fwd_smem(const FwdGeometry& g, bool gap) {
  return sizeof(T) * kSlots * (size_t)ring_cells<T>(g.hwin * g.wwin * g.lanes)
         + (gap ? 4 * (size_t)(kThreads / g.lanes) * g.lanes : 0);
}

template <typename T>
size_t dgrad_smem(const DgradGeometry& g) {
  return sizeof(T) * kSlots * (g.prologue ? 2 : 1)
         * (size_t)ring_cells<T>(g.hwin * g.wwin * g.lanes);
}

template <typename T>
size_t wgrad_smem(const WgradGeometry& g) {
  const size_t slot = ring_cells<T>(g.hwin * g.wwin * g.lanes)
                      + (g.prologue ? 2 : 1)
                            * (size_t)ring_cells<T>(g.hob * g.wob * g.lanes);
  const size_t red = 4 * (size_t)(kThreads / g.lanes)
                     * (g.hf * g.wf + 1) * g.lanes;
  const size_t ring = sizeof(T) * kSlots * slot;
  return ring > red ? ring : red;
}

// The entries' launches, by cell type (the f32 kernels, or their bf16
// builds); each refuses a plan whose shared memory is not its walk's.
template <typename T>
int fwd_launch(const void* x, const void* w, const void* bias,
               const void* residual, void* out, void* partials, void* pooled,
               void* counters, const int* plan, void* stream) {
  FwdGeometry g;
  int* fields = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kFwdInts; ++i) fields[i] = plan[i];
  const int grid = plan[kFwdInts];
  const int smem = plan[kFwdInts + 1];
  const int variant = plan[kFwdInts + 2];
  if (partials != nullptr && (pooled == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if (variant < 0 || variant > 2 || g.lanes < 1 || g.cb % g.lanes != 0
      || (size_t)smem != fwd_smem<T>(g, partials != nullptr))
    return (int)cudaErrorInvalidValue;
  if (grid <= 0) return 0;
  using Kernel = void (*)(const T*, const T*, const float*, const T*, T*,
                          float*, T*, int*, FwdGeometry);
  Kernel kernel;
  if constexpr (sizeof(T) == 4) {
    kernel = variant == 1   ? depthwise_fwd_kernel<1>
             : variant == 2 ? depthwise_fwd_kernel<2>
                            : depthwise_fwd_kernel<0>;
  } else {
    kernel = variant == 1   ? depthwise_fwd_kernel_bf16<1>
             : variant == 2 ? depthwise_fwd_kernel_bf16<2>
                            : depthwise_fwd_kernel_bf16<0>;
  }
  cudaError_t err = allow_smem(kernel, variant + (sizeof(T) == 4 ? 0 : 3),
                               smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const float*)bias, (const T*)residual,
      (T*)out, (float*)partials, (T*)pooled, (int*)counters, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dgrad_launch(const void* g, const void* z, const void* w, void* dx,
                 const int* plan, void* stream) {
  DgradGeometry geo;
  int* fields = reinterpret_cast<int*>(&geo);
  for (int i = 0; i < kDgradInts; ++i) fields[i] = plan[i];
  const int grid = plan[kDgradInts];
  const int smem = plan[kDgradInts + 1];
  const int variant = plan[kDgradInts + 2];
  if ((geo.prologue != 0) != (z != nullptr) || variant < 0 || variant > 2
      || geo.lanes < 1
      || geo.cb % geo.lanes != 0 || geo.hf * geo.wf > kMaxTaps
      || (size_t)smem != dgrad_smem<T>(geo)) {
    return (int)cudaErrorInvalidValue;
  }
  if (grid <= 0) return 0;
  using Kernel = void (*)(const T*, const T*, const T*, T*, DgradGeometry);
  Kernel kernel;
  if constexpr (sizeof(T) == 4) {
    kernel = variant == 1   ? depthwise_dgrad_kernel<1>
             : variant == 2 ? depthwise_dgrad_kernel<2>
                            : depthwise_dgrad_kernel<0>;
  } else {
    kernel = variant == 1   ? depthwise_dgrad_kernel_bf16<1>
             : variant == 2 ? depthwise_dgrad_kernel_bf16<2>
                            : depthwise_dgrad_kernel_bf16<0>;
  }
  cudaError_t err = allow_smem(kernel, variant + (sizeof(T) == 4 ? 0 : 3),
                               smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)z, (const T*)w, (T*)dx, geo);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad_launch(const void* x, const void* g, const void* z, void* ws,
                 void* out, void* counters, const int* plan, void* stream) {
  WgradGeometry geo;
  int* fields = reinterpret_cast<int*>(&geo);
  for (int i = 0; i < kWgradInts; ++i) fields[i] = plan[i];
  const int columns = plan[kWgradInts];
  const int smem = plan[kWgradInts + 1];
  const int variant = plan[kWgradInts + 2];
  if ((geo.prologue != 0) != (z != nullptr) || variant < 0 || variant > 2
      || geo.lanes < 1 || geo.cb % geo.lanes != 0 || geo.splits < 1
      || geo.hf * geo.wf > kMaxTaps
      || columns != geo.cblk * (geo.cb / geo.lanes)
      || (size_t)smem != wgrad_smem<T>(geo)) {
    return (int)cudaErrorInvalidValue;
  }
  if (columns <= 0 || geo.per_column <= 0) return 0;
  using Kernel = void (*)(const T*, const T*, const T*, float*, float*, int*,
                          WgradGeometry);
  Kernel kernel;
  if constexpr (sizeof(T) == 4) {
    kernel = variant == 1   ? depthwise_wgrad_kernel<1>
             : variant == 2 ? depthwise_wgrad_kernel<2>
                            : depthwise_wgrad_kernel<0>;
  } else {
    kernel = variant == 1   ? depthwise_wgrad_kernel_bf16<1>
             : variant == 2 ? depthwise_wgrad_kernel_bf16<2>
                            : depthwise_wgrad_kernel_bf16<0>;
  }
  cudaError_t err = allow_smem(kernel, variant + (sizeof(T) == 4 ? 0 : 3),
                               smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(geo.splits, columns), kThreads, smem,
           (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (const T*)z, (float*)ws, (float*)out,
      (int*)counters, geo);
  return (int)cudaGetLastError();
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

// The forward; with GAP (partials not null) the items' sums into partials
// and the pooled [N, C] features into pooled, with two zeroed int32
// counters an (image, channel block).  plan: the FwdGeometry fields in
// order, then the grid's CTAs, the dynamic shared memory and the kernel
// variant (0: any filter; 1, 2: 3x3 at dilation 1 and that stride).
int conv2d_depthwise_fwd(const void* x, const void* w, const void* bias,
                         const void* residual, void* out, void* partials,
                         void* pooled, void* counters, const int* plan,
                         void* stream) {
  return fwd_launch<float>(x, w, bias, residual, out, partials, pooled,
                           counters, plan, stream);
}

// The bf16 build of the forward: x, w, residual, out and pooled bf16; the
// bias and partials f32.
int conv2d_depthwise_fwd_bf16(const void* x, const void* w, const void* bias,
                              const void* residual, void* out,
                              void* partials, void* pooled, void* counters,
                              const int* plan, void* stream) {
  return fwd_launch<bf16>(x, w, bias, residual, out, partials, pooled,
                          counters, plan, stream);
}

// The dgrad: g, and z where the plan asks for the prologue, into dx.  plan:
// the DgradGeometry fields in order, then the grid's CTAs, the dynamic
// shared memory and the kernel variant (0: any filter; 1, 2: 3x3 at
// dilation 1 and that stride).
int conv2d_depthwise_dgrad(const void* g, const void* z, const void* w,
                           void* dx, const int* plan, void* stream) {
  return dgrad_launch<float>(g, z, w, dx, plan, stream);
}

// The bf16 build of the dgrad: g, z, w and dx bf16.
int conv2d_depthwise_dgrad_bf16(const void* g, const void* z, const void* w,
                                void* dx, const int* plan, void* stream) {
  return dgrad_launch<bf16>(g, z, w, dx, plan, stream);
}

// The wgrad: `splits` position shares of each (channel block, lane group)
// into `ws` [splits, |dw| + |db|], summed by each column's last CTA into
// `out` ([|dw| + |db|]); `counters`: a zeroed int32 a column.  plan: the
// WgradGeometry fields in order, then the columns, the dynamic shared
// memory and the kernel variant (0: any filter; 1, 2: 3x3 at dilation 1
// and that stride).
int conv2d_depthwise_wgrad(const void* x, const void* g, const void* z,
                           void* ws, void* out, void* counters,
                           const int* plan, void* stream) {
  return wgrad_launch<float>(x, g, z, ws, out, counters, plan, stream);
}

// The bf16 build of the wgrad: x, g and z bf16; ws and out f32.
int conv2d_depthwise_wgrad_bf16(const void* x, const void* g, const void* z,
                                void* ws, void* out, void* counters,
                                const int* plan, void* stream) {
  return wgrad_launch<bf16>(x, g, z, ws, out, counters, plan, stream);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
