// Flash attention, forward, GQA — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   `_kernel` (:33, pallas_call :86, `flash_attention_pallas` :73)
// and computes exactly the mask and arithmetic of the reference's chunked
// online softmax `attend` (src/repro/nn/attention.py:49-126), of which the
// TPU kernel's causal iota mask is the case `positions = arange`:
//
//   s[r, c]  = softcap(scale * q[r] . k[c], cap)                      (f32)
//   valid    = kvpos[c] >= 0  &&  (no kv_valid || kvpos[c] < kv_valid[b])
//              && (!causal || kvpos[c] <= qpos[r])
//              && (no window || kvpos[c] > qpos[r] - window)
//   s        = valid ? s : -1e30
//   online:  m' = max(m, max_c s); alpha = exp(m - m'); p = exp(s - m')
//            l' = l * alpha + sum_c p;  acc' = acc * alpha + p @ v
//   out[r]   = acc / max(l, 1e-37), cast once to q's dtype
//
// Layouts, all read and written in place through strides (the last dim is
// contiguous): q and out are [B, Sq, KV, G, Dh] (or any strides of the
// same five indices, e.g. the TPU kernel's [B, H, Sq, Dh] with h = kv*G +
// g), k and v [B, Skv, KV, Dh]; q-head (kv, g) reads KV head kv, the TPU
// kernel's index map h -> h // G, so no K/V head is repeated in memory.
// qpos [B, Sq] and kvpos [B, Skv] are int32, kv_valid [B] optional.  Keys
// past Skv are masked like the reference's -10^9 padding positions.
//
// Design.  One CTA of 256 threads per (64-row q block, q-head, batch).  Q
// is staged once, transposed (Qt [Dh][68]), in shared memory; K (Kt, also
// transposed) and V ([64][Dh]) are staged per 64-key block.  Thread (ty =
// t / 16, tx = t % 16) owns q rows 4ty..4ty+3: it computes their scores
// against keys 4tx..4tx+3 from one float4 of Qt and one of Kt per d (16
// FMAs per two shared loads), keeps the rows' m and l in registers (the 16
// threads of a row group meet by warp shuffles), writes its p's into a
// transposed P tile, and accumulates acc[4 rows][d = 4(tx + 16j) .. +3] of
// p @ v in registers.  All arithmetic is f32 on CUDA cores; bf16 inputs
// are widened as they are staged.  Blocks whose keys are all masked for
// every row of the CTA (past the causal diagonal, before the window, or
// padding) are skipped: their p would be exp(-1e30 - m) = 0, or they would
// be wiped by alpha = exp(-1e30 - m) = 0 at the first visible key, so
// skipping changes no bit of a row that sees any key.  (A row that sees no
// key at all gets an undefined average of v, as in the reference, where it
// depends on the chunking.)
//
// What bounds it on this card.  4 * Dh FLOPs per unmasked (q, k) pair
// against q, k, v and out crossing device memory once: at danube's prefill
// (S 2048, Dh 80) some 170 FLOP per byte, so operations bound it, on the
// tensor cores at 989 TFLOP/s for bf16 (67 on f32 CUDA cores).  This first
// kernel runs on the CUDA cores in f32: the redesign moves both products
// to wgmma with TMA-fed K/V tiles and shares each K/V tile across the G
// query heads of its group.
//
// C interface for ctypes: pointers and the stream as void*, the strides as
// one int64 array, the ints as one int32 array; each entry point returns
// cudaGetLastError() (0 = launched).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 64;            // keys per staged block
constexpr int kLd = kBQ + 4;       // row length of the transposed tiles
constexpr float kNegInf = -1e30f;  // the reference's finite sentinel
constexpr int kPadPos = -1000000000;  // the reference's padding position
constexpr int kMaxDh = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qpos;
  const int* kvpos;
  const int* kv_valid;    // null: every key valid
  long long qs_b, qs_s, qs_kv, qs_g;
  long long ks_b, ks_s, ks_kv;
  long long vs_b, vs_s, vs_kv;
  long long os_b, os_s, os_kv, os_g;
  int sq, skv, groups, dh;
  int causal, has_window, window, has_cap;
  float cap, scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// min and max over the 64 values of warps 0-1 (one per thread t < 64),
// ignoring lanes with ok = false; -> through smem `red` [4]
__device__ __forceinline__ void minmax64(int v, bool ok, int* red) {
  const int tid = threadIdx.x;
  int lo = ok ? v : INT32_MAX, hi = ok ? v : INT32_MIN;
  if (tid < 64) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if ((tid & 31) == 0) {
      red[2 * (tid >> 5)] = lo;
      red[2 * (tid >> 5) + 1] = hi;
    }
  }
}

template <typename T, int kNch>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dh = p.dh;
  const int d4 = dh / 4;
  float* qt = smem;                   // [Dh][kLd]  Q transposed
  float* kt = qt + dh * kLd;          // [Dh][kLd]  K transposed
  float* vs = kt + dh * kLd;          // [kBK][Dh]  V
  float* pt = vs + kBK * dh;          // [kBK][kLd] P transposed
  int* kpos = reinterpret_cast<int*>(pt + kBK * kLd);   // [kBK]
  int* red = kpos + kBK;              // [4] block reductions

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.groups, g = h % p.groups;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs_b + kvh * p.qs_kv
                + g * p.qs_g;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks_b + kvh * p.ks_kv;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs_b + kvh * p.vs_kv;
  const int* qpos = p.qpos + (long long)b * p.sq;
  const int* kvpos = p.kvpos + (long long)b * p.skv;
  const int kvv = p.kv_valid ? p.kv_valid[b] : 0;

  // Q, transposed; row r fastest so that the transposed stores do not
  // conflict (the row-strided loads hit L1 across the d4 chunks)
  for (int e = tid; e < kBQ * d4; e += kThreads) {
    const int r = e % kBQ, c4 = e / kBQ;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.sq) val = load4(qb + (q0 + r) * p.qs_s + 4 * c4);
    qt[(4 * c4 + 0) * kLd + r] = val.x;
    qt[(4 * c4 + 1) * kLd + r] = val.y;
    qt[(4 * c4 + 2) * kLd + r] = val.z;
    qt[(4 * c4 + 3) * kLd + r] = val.w;
  }
  {
    const bool ok = tid < kBQ && q0 + tid < p.sq;
    minmax64(ok ? qpos[q0 + tid] : 0, ok, red);
  }
  __syncthreads();
  const int qlo = min(red[0], red[2]), qhi = max(red[1], red[3]);
  __syncthreads();          // red is rewritten by the first key block
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    qp[i] = r < p.sq ? qpos[r] : 0;
  }

  float m[4], l[4], acc[4][kNch][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNch; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  const int n_blocks = (p.skv + kBK - 1) / kBK;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * kBK;
    // the block's key positions; padding past Skv takes the reference's
    // padding position, which no mask admits
    bool kok = false;
    if (tid < kBK) {
      const int kp = k0 + tid < p.skv ? kvpos[k0 + tid] : kPadPos;
      kpos[tid] = kp;
      kok = kp >= 0 && (!p.kv_valid || kp < kvv);
      minmax64(kp, kok, red);
    }
    __syncthreads();
    const int kmin = min(red[0], red[2]), kmax = max(red[1], red[3]);
    const bool skip = kmin > kmax                       // no valid key
        || (p.causal && kmin > qhi)
        || (p.has_window && (long long)kmax <= (long long)qlo - p.window);
    if (skip) {
      __syncthreads();      // red and kpos are rewritten by the next block
      continue;
    }

    // K transposed, row fastest; V row-major, d fastest
    for (int e = tid; e < kBK * d4; e += kThreads) {
      const int c = e % kBK, c4 = e / kBK;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < p.skv) val = load4(kb + (k0 + c) * p.ks_s + 4 * c4);
      kt[(4 * c4 + 0) * kLd + c] = val.x;
      kt[(4 * c4 + 1) * kLd + c] = val.y;
      kt[(4 * c4 + 2) * kLd + c] = val.z;
      kt[(4 * c4 + 3) * kLd + c] = val.w;
    }
    for (int e = tid; e < kBK * d4; e += kThreads) {
      const int c = e / d4, c4 = e % d4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < p.skv) val = load4(vb + (k0 + c) * p.vs_s + 4 * c4);
      store4(vs + c * dh + 4 * c4, val);
    }
    __syncthreads();

    // scores of rows 4ty+i against keys 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    int kp[4];
    bool kvalid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kp[j] = kpos[4 * tx + j];
      kvalid[j] = kp[j] >= 0 && (!p.kv_valid || kp[j] < kvv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = s[i][j] * p.scale;
        if (p.has_cap) v = p.cap * tanhf(v / p.cap);
        bool ok = kvalid[j];
        if (p.causal) ok = ok && kp[j] <= qp[i];
        if (p.has_window)
          ok = ok && (long long)kp[j] > (long long)qp[i] - p.window;
        v = ok ? v : kNegInf;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNch; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(pt + (4 * tx + j) * kLd + 4 * ty,
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
    __syncthreads();

    // acc += p @ v over the block's keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kLd + 4 * ty);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < kNch; ++j) {
        const int d = 4 * (tx + 16 * j);
        if (d < dh) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + c * dh + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(pr[i], vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pr[i], vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pr[i], vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pr[i], vv.w, acc[i][j][3]);
          }
        }
      }
    }
    __syncthreads();        // kt, vs, pt, kpos and red are rewritten next
  }

  T* ob = static_cast<T*>(p.o) + b * p.os_b + kvh * p.os_kv + g * p.os_g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < kNch; ++j) {
      const int d = 4 * (tx + 16 * j);
      if (d < dh)
        store4(ob + r * p.os_s + d,
               make_float4(acc[i][j][0] * inv, acc[i][j][1] * inv,
                           acc[i][j][2] * inv, acc[i][j][3] * inv));
    }
  }
}

// Dynamic shared memory of one CTA at head dim dh: Qt, Kt, V, Pt, the key
// positions and the block reductions.
int smem_bytes_for(int dh) {
  return (2 * dh * kLd + kBK * dh + kBK * kLd) * (int)sizeof(float)
         + (kBK + 8) * (int)sizeof(int);
}

template <typename T, int kNch>
int launch(const Params& p, int batch, int heads, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, kNch>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int batch, int heads, int smem_bytes,
             cudaStream_t stream) {
  switch ((p.dh + 63) / 64) {
    case 1: return launch<T, 1>(p, batch, heads, smem_bytes, stream);
    case 2: return launch<T, 2>(p, batch, heads, smem_bytes, stream);
    case 3: return launch<T, 3>(p, batch, heads, smem_bytes, stream);
    case 4: return launch<T, 4>(p, batch, heads, smem_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The compiled geometry, for the wrapper: threads per CTA, q rows per CTA,
// keys per staged block.
void flash_attention_geometry(int* threads, int* block_q, int* block_k) {
  *threads = kThreads;
  *block_q = kBQ;
  *block_k = kBK;
}

// strides (int64, in elements): q b,s,kv,g | k b,s,kv | v b,s,kv |
// out b,s,kv,g.  ints: batch, kv heads, groups, sq, skv, dh, causal,
// has_window, window, has_cap, bf16.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const void* qpos, const void* kvpos,
                        const void* kv_valid, const long long* strides,
                        const int* ints, float scale, float cap,
                        void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.qpos = static_cast<const int*>(qpos);
  p.kvpos = static_cast<const int*>(kvpos);
  p.kv_valid = static_cast<const int*>(kv_valid);
  p.qs_b = strides[0]; p.qs_s = strides[1]; p.qs_kv = strides[2];
  p.qs_g = strides[3];
  p.ks_b = strides[4]; p.ks_s = strides[5]; p.ks_kv = strides[6];
  p.vs_b = strides[7]; p.vs_s = strides[8]; p.vs_kv = strides[9];
  p.os_b = strides[10]; p.os_s = strides[11]; p.os_kv = strides[12];
  p.os_g = strides[13];
  const int batch = ints[0], kv = ints[1];
  p.groups = ints[2]; p.sq = ints[3]; p.skv = ints[4]; p.dh = ints[5];
  p.causal = ints[6]; p.has_window = ints[7]; p.window = ints[8];
  p.has_cap = ints[9];
  const int bf16 = ints[10];
  p.cap = cap;
  p.scale = scale;
  if (p.dh <= 0 || p.dh > kMaxDh || p.dh % 8) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes_for(p.dh);
  const int heads = kv * p.groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(p, batch, heads, smem, s)
              : dispatch<float>(p, batch, heads, smem, s);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
