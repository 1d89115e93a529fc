// Pointwise (1x1, stride 1) convolution, f32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv2d_pointwise.py:
//   `_pw_fwd_kernel`   (:56,  pallas_call :211)  out = act(x @ w + b) + r
//   `_pw_dgrad_kernel` (:87,  pallas_call :268)  dx  = dz @ w^T
//   `_pw_wgrad_kernel` (:114, pallas_call :335)  dw  = sum_positions x^T dz
// with dz = g * act'(z) (relu, tanh-gelu) formed as g is staged.  Layouts are
// the paper's blocked ones:
//
//   x   [N, Ci/Cib, H, W, Cib]       g, z, out, r  [N, Co/Cob, H, W, Cob]
//   w   [Co/Cob, Ci/Cib, 1, 1, Cib, Cob]            b  [Co/Cob, Cob]
//
// A 1x1 stride-1 conv has no halo: for one (image, channel block) the
// H*W*Cb slab is contiguous, so the conv is a matrix product over channel
// pencils at every position.  The forward and the dgrad are one kernel,
// `channel_matmul_kernel`, templated on the weight's orientation:
//
//   out[n, ob, p, o] = sum_{kb, k} in[n, kb, p, k] * W(ob, kb, k, o)
//   forward: in = x,  W(ob, kb, k, o) = w[ob][kb][k][o]
//   dgrad:   in = dz, W(ob, kb, k, o) = w[kb][ob][o][k]   (w read transposed)
//
// One CTA per (position tile of one image, output block, image).  The CTA
// walks the input blocks and `chunk`-channel steps of each; per step it
// stages the tile's input rows [positions, chunk] and the weight chunk
// [chunk, ob] (transposed on the way in for the dgrad) in shared memory, and
// each thread accumulates kPpt positions x kLanes output lanes in f32 FMAs.
// The forward epilogue is the reference's: + b, activation, + r, one store;
// with GAP it writes per-tile f32 partial sums of the stored values, which
// `gap_finalize` (direct_conv2d_fwd.cu) reduces in tile order.  Tiles never
// straddle images, so the pooled sums stay per image; a map's last tile is
// ragged and masked.
//
// wgrad: the TPU walks (N, H/Hob, W/Wob) as a sequential reduction axis into
// one resident [Cib, Cob] block.  Blocks run in no order on Hopper, so a CTA
// owns one [Cib, Cob] block and a contiguous share of the position tiles
// (`splits` shares per block); its threads form `pgroups` position groups of
// 8 x 8 register tiles, whose sums meet in shared memory in group order, and
// each share's sums go to its row of an f32 workspace [splits, |dw| + |db|]
// that `wgrad_reduce` (direct_conv2d_bwd.cu) adds in split order.  No
// atomics: two runs give identical bits.  db rides the Ci-block-0 CTAs only.
//
// What bounds these on this card.  Per output element the forward does 2*Ci
// FLOPs against 4 bytes written and 4*Ci/Co bytes read: 32 to 512 FLOP/byte
// on MobileNet's legs, above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s,
// ~20 FLOP/byte), so the f32 FMA rate bounds them, and in practice the
// shared-memory reads feeding the FMAs.  The register tile is the design's
// answer, as in the dense kernels: per channel step a thread reads kLanes
// weights (two float4) and kPpt inputs (broadcasts) for kPpt * kLanes FMAs.
// The 7x7 and 14x14 legs give few positions; the blocking model shrinks the
// tile to two positions a thread before it lets the grid drop below the
// card's resident CTAs, and kPpt is compiled per size so that no FMA is
// spent on an empty slot.  No tensor cores (wgmma), TMA or pipelining yet.
//
// C interface for ctypes: pointers and the stream as void*, ints as int; each
// entry point returns cudaGetLastError() after its launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kLanes = 8;       // output lanes in one thread's register tile
constexpr int kPositions = 8;   // most positions in one thread's tile
constexpr int kMinBlocksPerSm = 2;
static_assert(kLanes == 8, "the float4 pair reads assume 8 lanes");

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

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One staged unit of in (or of dz = g * act'(z) when z is given): 4 floats
// when `vec` (offsets are multiples of 4), else 1.
__device__ __forceinline__ void stage_in(float* dst, const float* g,
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
// forward and dgrad: the channel matmul
// ---------------------------------------------------------------------------

// kTransW: the dgrad's orientation (w read transposed, the z prologue on the
// input rows, no epilogue).  kVecW: ob is a multiple of kLanes, so a thread's
// weights are two aligned float4 reads.  kPpt: positions per thread.
template <bool kTransW, bool kVecW, int kPpt>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
channel_matmul_kernel(const float* __restrict__ in,
                      const float* __restrict__ z,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ residual,
                      float* __restrict__ out,
                      float* __restrict__ partials,
                      int kblk, int kb, int oblk, int ob, int hw,
                      int positions, int chunk, int ldx, int ldw, int act) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y;
  const int n = blockIdx.z;
  const int p0 = tile * positions;
  const int np = min(positions, hw - p0);

  // thread -> (position group, lane group); neighbouring threads take
  // neighbouring lane groups of the same positions
  const int ncg = (ob + kLanes - 1) / kLanes;
  const int npg = kThreads / ncg;
  const int t = threadIdx.x;
  const int cg = t % ncg;
  const int pg = t / ncg;
  const bool computes = pg < npg;
  const int o0 = cg * kLanes;

  float* w_s = smem;                 // [chunk, ldw]
  float* x_s = smem + chunk * ldw;   // [positions, ldx]

  int xoff[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int p = pg + k * npg;
    xoff[k] = (p < np ? p : 0) * ldx;
  }
  float acc[kPpt][kLanes];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[k][j] = 0.0f;
  }

  const bool vec_x = chunk % 4 == 0 && kb % 4 == 0;
  const int unit = vec_x ? 4 : 1;
  const int units = chunk / unit;
  for (int k_b = 0; k_b < kblk; ++k_b) {
    const size_t slab = ((size_t)(n * kblk + k_b) * hw + p0) * kb;
    const float* ib = in + slab;
    const float* zb = z != nullptr ? z + slab : nullptr;
    for (int c0 = 0; c0 < kb; c0 += chunk) {
      if constexpr (kTransW) {
        // w_s[c][o] = w[k_b][o_b][o][c0 + c]: neighbouring threads read
        // neighbouring c (coalesced) and write down a padded column
        const float* wb = w + (size_t)(k_b * oblk + o_b) * ob * kb + c0;
        for (int i = t; i < chunk * ob; i += kThreads) {
          const int c = i % chunk;
          const int o = i / chunk;
          w_s[c * ldw + o] = __ldg(wb + (size_t)o * kb + c);
        }
      } else {
        // w_s[c][o] = w[o_b][k_b][c0 + c][o]: one contiguous run
        const float* wb = w + ((size_t)(o_b * kblk + k_b) * kb + c0) * ob;
        if constexpr (kVecW) {
          for (int i = t; i < chunk * ob / 4; i += kThreads) {
            reinterpret_cast<float4*>(w_s)[i] =
                __ldg(reinterpret_cast<const float4*>(wb) + i);
          }
        } else {
          for (int i = t; i < chunk * ob; i += kThreads) w_s[i] = __ldg(wb + i);
        }
      }
      // the tile's input rows [np, chunk], zero past the map's end
      for (int i = t; i < positions * units; i += kThreads) {
        const int p = i / units;
        const int c = (i % units) * unit;
        float* dst = x_s + p * ldx + c;
        if (p < np) {
          stage_in(dst, ib, zb, (size_t)p * kb + c0 + c, vec_x, act);
        } else {
          for (int e = 0; e < unit; ++e) dst[e] = 0.0f;
        }
      }
      __syncthreads();
      if (computes) {
        const float* wt = w_s + o0;
#pragma unroll 4
        for (int c = 0; c < chunk; ++c) {
          float wv[kLanes];
          if constexpr (kVecW) {
            load8(wt + c * ldw, wv);
          } else {
#pragma unroll
            for (int j = 0; j < kLanes; ++j) {
              wv[j] = (o0 + j < ob) ? wt[c * ldw + j] : 0.0f;
            }
          }
#pragma unroll
          for (int k = 0; k < kPpt; ++k) {
            const float xv = x_s[xoff[k] + c];
#pragma unroll
            for (int j = 0; j < kLanes; ++j) {
              acc[k][j] = fmaf(xv, wv[j], acc[k][j]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // epilogue (forward: + b, activation, + r); acc keeps the stored values,
  // zero where nothing is stored, for the GAP rider
  if (computes) {
    float bv[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      bv[j] = (bias != nullptr && o0 + j < ob) ? bias[o_b * ob + o0 + j]
                                               : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPpt; ++k) {
      const int p = pg + k * npg;
      if (p < np) {
        const size_t o = ((size_t)(n * oblk + o_b) * hw + p0 + p) * ob + o0;
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if (o0 + j < ob) {
            float v = acc[k][j];
            if constexpr (!kTransW) {
              v = activate(v + bv[j], act);
              if (residual != nullptr) v += residual[o + j];
            }
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
    // per-tile sums of the stored values: each thread over its positions,
    // then the position groups in order; the staging buffer is free
    float* red = smem;                         // [npg, ob]
    if (computes) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (o0 + j < ob) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < kPpt; ++k) s += acc[k][j];
          red[pg * ob + o0 + j] = s;
        }
      }
    }
    __syncthreads();
    const int tiles = gridDim.x;
    for (int o = t; o < ob; o += kThreads) {
      float s = 0.0f;
      for (int g = 0; g < npg; ++g) s += red[g * ob + o];
      partials[((size_t)(n * oblk + o_b) * tiles + tile) * ob + o] = s;
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
pointwise_wgrad_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ z, float* __restrict__ ws,
                       int n_img, int ciblk, int cib, int coblk, int cob,
                       int hw, int positions, int splits, int act,
                       int with_db) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x;
  const int ci_b = blockIdx.y;
  const int co_b = blockIdx.z;
  const int tiles_img = (hw + positions - 1) / positions;
  const int tiles = n_img * tiles_img;
  const int first = (int)((long long)tiles * split / splits);
  const int last = (int)((long long)tiles * (split + 1) / splits);

  // thread -> (position group, Cib lane group, Cob lane group); Cob
  // fastest, so a warp shares x values (broadcast) and reads neighbouring dz
  const int ncig = (cib + kLanes - 1) / kLanes;
  const int ncog = (cob + kLanes - 1) / kLanes;
  const int groups = ncig * ncog;
  const int pgroups = kThreads / groups;
  const int t = threadIdx.x;
  const int pgp = t / groups;
  const int cig = (t % groups) / ncog;
  const int cog = t % ncog;
  const bool active = pgp < pgroups;
  const int ci0 = cig * kLanes;
  const int co0 = cog * kLanes;
  const bool db_duty = with_db && active && ci_b == 0 && cig == 0;

  float* x_s = smem;                                      // [positions, cib]
  float* d_s = smem + ((positions * cib + 3) & ~3);       // [positions, cob]

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
  for (int tt = first; tt < last; ++tt) {
    const int n = tt / tiles_img;
    const int p0 = (tt % tiles_img) * positions;
    const int np = min(positions, hw - p0);
    // x rows and dz rows of the tile: one contiguous run each
    const float* xb = x + ((size_t)(n * ciblk + ci_b) * hw + p0) * cib;
    if (vec_x) {
      for (int i = t; i < np * cib / 4; i += kThreads) {
        reinterpret_cast<float4*>(x_s)[i] =
            __ldg(reinterpret_cast<const float4*>(xb) + i);
      }
    } else {
      for (int i = t; i < np * cib; i += kThreads) x_s[i] = __ldg(xb + i);
    }
    const size_t dmap = ((size_t)(n * coblk + co_b) * hw + p0) * cob;
    const float* zb = z != nullptr ? z + dmap : nullptr;
    const int unit = vec_d ? 4 : 1;
    for (int i = t; i < np * cob / unit; i += kThreads) {
      stage_in(d_s + i * unit, g + dmap, zb, (size_t)i * unit, vec_d, act);
    }
    __syncthreads();
    if (active) {
      for (int p = pgp; p < np; p += pgroups) {
        float xv[kLanes], dv[kLanes];
        const float* xp = x_s + p * cib + ci0;
        const float* dp = d_s + p * cob + co0;
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
    __syncthreads();
  }

  // the position groups' sums, added in group order; the staging buffer is
  // free after the loop's last __syncthreads
  const int block = cib * cob;
  const int stride = block + cob;
  float* red = smem;                              // [pgroups, block + cob]
  if (active) {
    float* mine = red + pgp * stride;
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (ci0 + i < cib) {
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if (co0 + j < cob) mine[(ci0 + i) * cob + co0 + j] = acc[i][j];
        }
      }
    }
    if (db_duty) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (co0 + j < cob) mine[block + co0 + j] = dbacc[j];
      }
    }
  }
  __syncthreads();
  const size_t dw_size = (size_t)coblk * ciblk * cib * cob;
  float* row = ws + (size_t)split * (dw_size + (with_db ? coblk * cob : 0));
  float* dwb = row + (size_t)(co_b * ciblk + ci_b) * block;
  for (int e = t; e < block; e += kThreads) {
    float s = 0.0f;
    for (int q = 0; q < pgroups; ++q) s += red[q * stride + e];
    dwb[e] = s;
  }
  if (with_db && ci_b == 0) {
    for (int e = t; e < cob; e += kThreads) {
      float s = 0.0f;
      for (int q = 0; q < pgroups; ++q) s += red[q * stride + block + e];
      row[dw_size + co_b * cob + e] = s;
    }
  }
}

template <bool kTransW, bool kVecW>
void* pick_ppt(int ppt) {
  switch (ppt) {
    case 1: return (void*)channel_matmul_kernel<kTransW, kVecW, 1>;
    case 2: return (void*)channel_matmul_kernel<kTransW, kVecW, 2>;
    case 4: return (void*)channel_matmul_kernel<kTransW, kVecW, 4>;
    default: return (void*)channel_matmul_kernel<kTransW, kVecW, 8>;
  }
}

}  // namespace

extern "C" {

// The compiled register-tile geometry, for the wrapper's blocking model.
void conv2d_pointwise_geometry(int* threads, int* lanes, int* positions) {
  *threads = kThreads;
  *lanes = kLanes;
  *positions = kPositions;
}

// The forward (transposed = 0: in = x, out = the conv's output, with the
// epilogue) or the dgrad (transposed = 1: in = g with the z prologue, out =
// dx).  kblk/kb: the input's blocks; oblk/ob: the output's.
int conv2d_pointwise_matmul(const void* in, const void* z, const void* w,
                            const void* bias, const void* residual, void* out,
                            void* partials, int transposed, int n, int kblk,
                            int kb, int oblk, int ob, int hw, int positions,
                            int chunk, int ldx, int ldw, int act,
                            int smem_bytes, void* stream) {
  const int npg = kThreads / ((ob + kLanes - 1) / kLanes);
  const int need = (positions + npg - 1) / npg;
  int ppt = 1;
  while (ppt < need) ppt *= 2;
  if (ppt > kPositions) return (int)cudaErrorInvalidValue;
  const bool vec_w = ob % kLanes == 0;
  void* kernel = transposed ? (vec_w ? pick_ppt<true, true>(ppt)
                                     : pick_ppt<true, false>(ppt))
                            : (vec_w ? pick_ppt<false, true>(ppt)
                                     : pick_ppt<false, false>(ppt));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (hw + positions - 1) / positions;
  const float* in_f = (const float*)in;
  const float* z_f = (const float*)z;
  const float* w_f = (const float*)w;
  const float* b_f = (const float*)bias;
  const float* r_f = (const float*)residual;
  float* out_f = (float*)out;
  float* p_f = (float*)partials;
  void* args[] = {&in_f, &z_f, &w_f, &b_f, &r_f, &out_f, &p_f, &kblk, &kb,
                  &oblk, &ob, &hw, &positions, &chunk, &ldx, &ldw, &act};
  err = cudaLaunchKernel(kernel, dim3(tiles, oblk, n), dim3(kThreads), args,
                         smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int conv2d_pointwise_wgrad(const void* x, const void* g, const void* z,
                           void* ws, int n, int ciblk, int cib, int coblk,
                           int cob, int hw, int positions, int splits,
                           int act, int with_db, int smem_bytes,
                           void* stream) {
  const bool vx = cib % kLanes == 0;
  const bool vd = cob % kLanes == 0;
  auto kernel = vx ? (vd ? pointwise_wgrad_kernel<true, true>
                         : pointwise_wgrad_kernel<true, false>)
                   : (vd ? pointwise_wgrad_kernel<false, true>
                         : pointwise_wgrad_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, ciblk, coblk);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)z, (float*)ws, n, ciblk,
      cib, coblk, cob, hw, positions, splits, act, with_db);
  return (int)cudaGetLastError();
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
