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
// with dz = g * act'(z) (relu, tanh-gelu) formed as each element of g is
// staged in shared memory — the reference's `cotangent_prologue`.
//
// dgrad:  dx[n,i,j,c] = sum_{co,dh,dw} dz[n, (i+pt-dh)/s, (j+pl-dw)/s, co]
//                                      * w[dh,dw,c,co]
// where a term counts only if the division is exact and the index lies in
// [0, Ho) x [0, Wo).  The reference builds a stride-dilated, halo-padded
// copy of g (and of z), writes dx at the padded extents and crops it.  Here
// masks replace all three copies, as the forward masks its pads: the staged
// cotangent window is zero outside the map, and a tap that the stride skips
// for a position reads a run of zeros in shared memory instead.  So dx rows
// that no output reads (past the dgrad extents) come out exactly 0.
// Schedule: the forward's, on the input grid.  One CTA per (dx tile of
// hob x wob positions, Ci block, image); the Co blocks and Cob chunks loop
// inside the CTA; each thread holds kPositions dx positions x kLanes Cib
// lanes in f32 registers.  Per chunk the CTA stages the weight chunk
// transposed to [tap, chunk, Cib] (so a thread reads its 8 lanes as two
// float4) and the cotangent window [hwin, wwin, chunk].
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
// so it is summed once per Co block (the reference's `ci == 0` pass).
//
// What bounds these on this card.  Both do the forward's 2*9*Ci*Co FLOPs per
// position against a few bytes of traffic, far above the H100's f32 ridge
// (~20 FLOP/byte), so the bound is the f32 FMA rate, and in practice the
// shared-memory reads feeding the FMAs.  The design's answer is the same
// register tile as the forward: per step a thread reads 8 + 8 floats and
// does 64 FMAs, with warp-wide broadcasts of the operand its neighbours
// share.  Known costs, left for later work: at stride 2 three of four
// dgrad taps read zeros (splitting dx by its parity against the stride
// removes them); wgrad CTAs of one position tile stage the same window once
// per tap group; nothing uses the tensor cores (wgmma), TMA or persistent
// CTAs.
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after its launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kLanes = 8;       // register-tile columns of one thread
constexpr int kPositions = 8;   // dgrad: dx positions of one thread
constexpr int kMinBlocksPerSm = 2;
static_assert(kLanes == 8, "the float4 pair reads assume 8 lanes");

constexpr int kActRelu = 1;
constexpr int kActGelu = 2;

// dz = g * act'(z), in f32; the reference takes act' from the activation's
// own VJP, this is the same derivative written out (relu is
// jnp.maximum(z, 0) there, whose VJP splits the tie at z == 0)
__device__ __forceinline__ float prologue(float g, float z, int act) {
  if (act == kActRelu) {
    return z > 0.0f ? g : (z == 0.0f ? 0.5f * g : 0.0f);
  }
  if (act == kActGelu) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
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

// kVecW: Cib is a multiple of kLanes, so a thread's lanes are two aligned
// float4 reads of the staged (transposed) weight row.
template <bool kVecW>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
dgrad_kernel(const float* __restrict__ g, const float* __restrict__ z,
             const float* __restrict__ w, float* __restrict__ dx,
             int coblk, int cob, int ho, int wo, int ciblk, int cib, int hi,
             int wi, int hf, int wf, int stride, int pad_top, int pad_left,
             int hob, int wob, int hwin, int wwin, int chunk, int ldw,
             int act) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_w = wi / wob;
  const int tile = blockIdx.x;
  const int ci_b = blockIdx.y;
  const int n = blockIdx.z;
  const int i0 = (tile / tiles_w) * hob;
  const int j0 = (tile % tiles_w) * wob;
  const int npos = hob * wob;

  // thread -> (position group, Cib lane group), as the forward's tile
  const int ncg = (cib + kLanes - 1) / kLanes;
  const int npg = kThreads / ncg;
  const int t = threadIdx.x;
  const int cg = t % ncg;
  const int pg = t / ncg;
  const bool computes = pg < npg;
  const int c_lo = cg * kLanes;

  // the window's origin in cotangent coordinates
  const int oh_lo = floordiv(i0 + pad_top - (hf - 1), stride);
  const int ow_lo = floordiv(j0 + pad_left - (wf - 1), stride);

  float* w_s = smem;                               // [hf*wf, chunk, ldw]
  float* d_s = smem + hf * wf * chunk * ldw;       // [hwin, wwin, chunk]
  const int zero_off = hwin * wwin * chunk;        // + [chunk] zeros
  for (int i = t; i < chunk; i += kThreads) d_s[zero_off + i] = 0.0f;

  // per position: its numerator (i + pt) - s * oh_lo, >= hf - 1 >= dh; -1
  // for the slots past the tile
  int ah[kPositions], aw[kPositions];
#pragma unroll
  for (int k = 0; k < kPositions; ++k) {
    const int p = pg + k * npg;
    if (p < npos) {
      ah[k] = i0 + p / wob + pad_top - stride * oh_lo;
      aw[k] = j0 + p % wob + pad_left - stride * ow_lo;
    } else {
      ah[k] = -1;
      aw[k] = -1;
    }
  }

  float acc[kPositions][kLanes];
#pragma unroll
  for (int k = 0; k < kPositions; ++k) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[k][j] = 0.0f;
  }

  const int taps = hf * wf;
  const bool vec_d = chunk % 4 == 0 && cob % 4 == 0;
  const int unit = vec_d ? 4 : 1;
  const int units = chunk / unit;
  for (int co_b = 0; co_b < coblk; ++co_b) {
    const size_t map = (size_t)(n * coblk + co_b) * ho * wo * cob;
    const float* gb = g + map;
    const float* zb = z != nullptr ? z + map : nullptr;
    const float* wb = w + (size_t)(co_b * ciblk + ci_b) * taps * cib * cob;
    for (int c0 = 0; c0 < cob; c0 += chunk) {
      // weight chunk, transposed: w_s[tap][c][ci] = w[tap][ci][c0 + c];
      // neighbouring threads read neighbouring c (coalesced)
      for (int i = t; i < taps * cib * chunk; i += kThreads) {
        const int c = i % chunk;
        const int rest = i / chunk;
        const int ci = rest % cib;
        const int tap = rest / cib;
        w_s[(tap * chunk + c) * ldw + ci] =
            __ldg(wb + ((size_t)tap * cib + ci) * cob + c0 + c);
      }
      // cotangent window, prologue applied, zero outside the map
      for (int i = t; i < hwin * wwin * units; i += kThreads) {
        const int cell = i / units;
        const int c = (i % units) * unit;
        const int oh = oh_lo + cell / wwin;
        const int ow = ow_lo + cell % wwin;
        float* dst = d_s + cell * chunk + c;
        if (oh >= 0 && oh < ho && ow >= 0 && ow < wo) {
          stage_dz(dst, gb, zb, ((size_t)oh * wo + ow) * cob + c0 + c, vec_d,
                   act);
        } else {
          for (int e = 0; e < unit; ++e) dst[e] = 0.0f;
        }
      }
      __syncthreads();
      if (computes) {
        for (int dh = 0; dh < hf; ++dh) {
          for (int dw = 0; dw < wf; ++dw) {
            int off[kPositions];
#pragma unroll
            for (int k = 0; k < kPositions; ++k) {
              const int uh = ah[k] - dh;
              const int uw = aw[k] - dw;
              const bool hit = ah[k] >= 0 && uh % stride == 0 &&
                               uw % stride == 0;
              off[k] = hit ? ((uh / stride) * wwin + uw / stride) * chunk
                           : zero_off;
            }
            const float* wt = w_s + (dh * wf + dw) * chunk * ldw + c_lo;
#pragma unroll 4
            for (int c = 0; c < chunk; ++c) {
              float wv[kLanes];
              if constexpr (kVecW) {
                load8(wt + c * ldw, wv);
              } else {
#pragma unroll
                for (int j = 0; j < kLanes; ++j) {
                  wv[j] = (c_lo + j < cib) ? wt[c * ldw + j] : 0.0f;
                }
              }
#pragma unroll
              for (int k = 0; k < kPositions; ++k) {
                const float dv = d_s[off[k] + c];
#pragma unroll
                for (int j = 0; j < kLanes; ++j) {
                  acc[k][j] = fmaf(dv, wv[j], acc[k][j]);
                }
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (computes) {
#pragma unroll
    for (int k = 0; k < kPositions; ++k) {
      const int p = pg + k * npg;
      if (p < npos) {
        const size_t o = (((size_t)(n * ciblk + ci_b) * hi + i0 + p / wob)
                          * wi + j0 + p % wob) * cib + c_lo;
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if (c_lo + j < cib) dx[o + j] = acc[k][j];
        }
      }
    }
  }
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

int direct_conv2d_dgrad(const void* g, const void* z, const void* w, void* dx,
                        int n, int coblk, int cob, int ho, int wo, int ciblk,
                        int cib, int hi, int wi, int hf, int wf, int stride,
                        int pad_top, int pad_left, int hob, int wob, int hwin,
                        int wwin, int chunk, int ldw, int act, int smem_bytes,
                        void* stream) {
  auto kernel = cib % kLanes == 0 ? dgrad_kernel<true> : dgrad_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hi / hob) * (wi / wob), ciblk, n);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)z, (const float*)w, (float*)dx, coblk,
      cob, ho, wo, ciblk, cib, hi, wi, hf, wf, stride, pad_top, pad_left, hob,
      wob, hwin, wwin, chunk, ldw, act);
  return (int)cudaGetLastError();
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
