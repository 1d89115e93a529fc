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
// qpos [B, Sq] and kvpos [B, Skv] are int32.  The caller folds kv_valid
// into kvpos: a key at or past kv_valid[b] takes the reference's -10^9
// padding position, which fails kvpos >= 0 as the reference's kv_valid
// test would.  Keys past Skv are masked the same way.
//
// f32, head dim up to 128: flash_fwd_tf32, on the tensor cores in 3xTF32
// (as the CNN tiles: x = big + small, both TF32, and a product is
// small*big + big*small + big*big, the dropped small*small below 2^-22 of
// it).  One CTA of two consumer warpgroups and a producer warpgroup per
// (128-row q tile, KV head, batch), rows = position * G + g as the bf16
// kernel's, so each K/V tile is staged once for all G heads; causal tiles
// with the most keys first; the producer skips and marks blocks as the
// bf16 kernel's does.  The producer's first warp brings each stage's K and
// V by TMA (K as [Dh/4][keys][4], the K-major core-matrix order, straight
// from its Dh-contiguous rows; V as it lies); its 128 threads then split K
// in place into TF32 halves and write V^T's halves [keys/4][Dh][4] (TF32
// wgmma has no transpose, so P @ V needs V K-major), with V's rows within
// each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7: a consumer's S fragment
// holds keys 2t, 2t + 1 of each 8, which is then P's A fragment (k columns
// t, t + 4) as it lies, with no shuffle (the masks use the true
// positions).  It splits a stage while the consumers run the one before.
// Each consumer warpgroup owns 64 rows:
//   S = Q K^T    wgmma m64nBKk8 tf32, Q from shared memory as it was
//                loaded, split into registers at each k8 step;
//   softmax      the bf16 kernel's, on the f32 S fragment;
//   O = O a + PV wgmma m64nNk8 tf32 (N = Dh, or Dh / 2 twice past 80), P
//                split in registers, into a fresh accumulator each stage
//                added to the f32 O: wgmma's adds round toward zero, and
//                one accumulator over 2048 keys drifts past the tolerance
//                where rows average many keys.
// Shared memory decides the stage: Q (40 KB at Dh 80) stays as loaded and
// is split at each use, since its halves would take 80 KB; two stages of
// 64 keys (K and V^T in halves, 80 KB each at Dh 80) then fit beside it,
// and at Dh 128 two of 32 keys.
// Registers are the other limit: ptxas gives a thread of a CTA of three
// warpgroups (or of two and a warp: it counts whole warpgroups) 168, which
// a consumer's O, stage accumulator, S and A halves fill at Dh 80.  At Dh
// 128 (two stages of 32 keys) every layout with all of O in registers
// spilled on the H100 (P @ V in passes of 32 or 64 columns, 16-key
// stages, a producer warp), so there O's second half lives in shared
// memory, a thread's own slice, rescaled and added to once a stage after
// its pass of P @ V.  Q in registers was not an option.
//
// f32 otherwise (head dim past 128, more heads a KV head than 128 rows, or
// K/V strides TMA cannot take; kernels/flash_attention.py `f32_route`
// states the rule): flash_fwd_kernel.  One CTA of 256 threads per (64-row
// q block, q-head, batch).  Q is staged once, transposed (Qt [Dh][68]), in
// shared memory; K (Kt, also transposed) and V ([64][Dh]) are staged per
// 64-key block.  Thread (ty = t / 16, tx = t % 16) owns q rows 4ty..4ty+3: it
// computes their scores against keys 4tx..4tx+3 from one float4 of Qt and
// one of Kt per d (16 FMAs per two shared loads), keeps the rows' m and l
// in registers (the 16 threads of a row group meet by warp shuffles),
// writes its p's into a transposed P tile, and accumulates acc[4 rows][d =
// 4(tx + 16j) .. +3] of p @ v in registers.  All arithmetic is f32 on CUDA
// cores.
//
// The kernels skip the blocks whose keys are all masked for every row of
// the CTA (past the causal diagonal, before the window, or padding): their
// p would be exp(-1e30 - m) = 0, or they would be wiped by alpha =
// exp(-1e30 - m) = 0 at the first visible key, so skipping changes no bit
// of a row that sees any key.  A row that sees no key at all ends with m =
// -1e30.  In the reference every key it scans then has p = exp(-1e30 -
// (-1e30)) = 1, the zero padding of its last chunk included, so its output
// is the sum of v over the Skv keys divided by the n_scan keys scanned
// (Skv rounded up to the reference's chunk; the caller passes it).  The
// epilogues write exactly that for such rows, summed from V in global
// memory; no row of a causal prefill takes that path.
//
// What bounds it on this card.  4 * Dh FLOPs per unmasked (q, k) pair
// against q, k, v and out crossing device memory once: at danube's prefill
// (S 2048, Dh 80) some 170 FLOP per byte, so operations bound it, on the
// tensor cores at 989 TFLOP/s for bf16 and, as three TF32 products, 495
// for f32 (67 on f32 CUDA cores).
//
// bf16: flash_fwd_wgmma, on the tensor cores.  One CTA of two consumer
// warpgroups and one producer warp per (128-row q tile, KV head, batch).
// The 128 rows are the G query heads of the KV head times Pq = 128 / G
// positions, row = position * G + g (spare rows past Pq * G are zero and
// never stored), so each K/V tile is staged once for all G heads.  TMA
// brings the tiles: Q once, through a 5-D tensor map over (Dh, G, KV, S, B)
// whose box (64, G, 1, Pq, 1) lands exactly that row order; K and V through
// 4-D maps over (Dh, KV, S, B) into a ring of stages, filled by the
// producer warp and emptied by the consumers, with mbarriers.  Head-dim
// columns come in 64-wide chunks in 128-byte-swizzled rows; TMA fills
// zeros past Dh (and past S), so Dh = 80 runs five k-steps of 16 and a
// P @ V of N = 80.  Each consumer warpgroup owns 64 rows:
//   S = Q K^T    wgmma m64n64k16, Q and K from shared memory (K-major);
//   softmax      on the S fragment in registers: scale, softcap, masks on
//                the thread's (row, key) positions, m and l per row across
//                the 4 threads of a quad, all f32;
//   O += P V     wgmma m64nDk16, P from registers, V from shared memory
//                (MN-major, the transpose bit), f32 accumulators.
// P is f32; to keep its precision it goes in as two bf16 halves,
// P = hi + lo with hi = bf16(P), lo = bf16(P - hi) (residual ~2^-18 P),
// so P @ V is two products on the same V tile: 6 * Dh FLOPs per pair
// instead of 4 * Dh.  l sums the f32 P.  The producer does the skipping
// and marks the blocks that every row sees whole, which take a path with
// no mask.  The grid issues the causal tiles with the most keys first.
//
// C interface for ctypes: pointers and the stream as void*, the strides as
// one int64 array, the ints as one int32 array; each entry point returns
// cudaGetLastError() (0 = launched).  The tensor maps are encoded by
// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dgrad_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 64;            // keys per staged block
constexpr int kLd = kBQ + 4;       // row length of the transposed tiles
constexpr float kNegInf = -1e30f;  // the reference's finite sentinel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPadPos = -1000000000;  // the reference's padding position
constexpr int kMaxDh = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qpos;
  const int* kvpos;
  long long qs_b, qs_s, qs_kv, qs_g;
  long long ks_b, ks_s, ks_kv;
  long long vs_b, vs_s, vs_kv;
  long long os_b, os_s, os_kv, os_g;
  int sq, skv, groups, dh;
  int causal, has_window, window, has_cap;
  int n_scan;             // keys the reference scans: Skv up to its chunk
  float cap, scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

template <int kNch>
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
  const float* qb = static_cast<const float*>(p.q) + b * p.qs_b
                    + kvh * p.qs_kv + g * p.qs_g;
  const float* kb = static_cast<const float*>(p.k) + b * p.ks_b
                    + kvh * p.ks_kv;
  const float* vb = static_cast<const float*>(p.v) + b * p.vs_b
                    + kvh * p.vs_kv;
  const int* qpos = p.qpos + (long long)b * p.sq;
  const int* kvpos = p.kvpos + (long long)b * p.skv;

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
      kok = kp >= 0;
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
      kvalid[j] = kp[j] >= 0;
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

  float* ob = static_cast<float*>(p.o) + b * p.os_b + kvh * p.os_kv
               + g * p.os_g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.sq) continue;
    if (m[i] == kNegInf) {  // the row sees no key: the reference's average
#pragma unroll 1
      for (int j = 0; j < kNch; ++j) {
        const int d = 4 * (tx + 16 * j);
        if (d >= dh) continue;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < p.skv; ++c) {
          const float4 vv = load4(vb + c * p.vs_s + d);
          sum.x += vv.x;
          sum.y += vv.y;
          sum.z += vv.z;
          sum.w += vv.w;
        }
        const float n = (float)p.n_scan;
        store4(ob + r * p.os_s + d,
               make_float4(sum.x / n, sum.y / n, sum.z / n, sum.w / n));
      }
      continue;
    }
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

template <int kNch>
int launch(const Params& p, int batch, int heads, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<kNch>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Params& p, int batch, int heads,
                 cudaStream_t stream) {
  const int smem = smem_bytes_for(p.dh);
  switch ((p.dh + 63) / 64) {
    case 1: return launch<1>(p, batch, heads, smem, stream);
    case 2: return launch<2>(p, batch, heads, smem, stream);
    case 3: return launch<3>(p, batch, heads, smem, stream);
    case 4: return launch<4>(p, batch, heads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: flash_fwd_wgmma
// ---------------------------------------------------------------------------

constexpr int kHConsumers = 2;                     // consumer warpgroups
constexpr int kHRows = 64 * kHConsumers;           // q rows per CTA
constexpr int kHBK = 64;                           // keys per K/V tile
constexpr int kHConsumerThreads = 128 * kHConsumers;
constexpr int kHThreads = kHConsumerThreads + 32;  // + the producer warp
constexpr int kCol = 64;             // head-dim columns per swizzled chunk
constexpr int kRowBytes = 128;       // one chunk row: 64 bf16, the swizzle
constexpr int kQChunkBytes = kHRows * kRowBytes;
constexpr int kKVChunkBytes = kHBK * kRowBytes;
constexpr int kAtomBytes = 8 * kRowBytes;          // 8 rows of a swizzle atom

// The bf16 kernel's parameters: only what it reads (q, k and v come
// through the tensor maps; v also directly, for rows that see no key).
// The three maps and these must fit in 512 bytes: on the H100 the kernel
// runs about half as long again with 8 bytes of unused padding past them
// (launch/flash_params_ab.py measures it).  So the tile count comes from
// the grid, and the switches share one word, read where they are used
// (held in registers, they made the Dh 128 instance spill).
constexpr int kCausal = 1, kWindow = 2, kCap = 4;  // HParams::flags
struct HParams {
  void* o;
  const void* v;
  const int* qpos;
  const int* kvpos;
  long long os_b, os_s, os_kv, os_g;
  long long vs_b, vs_s, vs_kv;
  int sq, skv, groups, dh, kv_heads, window;
  int n_scan;             // keys the reference scans: Skv up to its chunk
  int flags;              // kCausal | kWindow | kCap
  float cap, scale;
};
static_assert(3 * sizeof(CUtensorMap) + sizeof(HParams) <= 512,
              "the bf16 kernel's parameters outgrow 512 bytes");

// Shared memory of one CTA at padded head dim kD (a multiple of 16): Q's
// chunks, the K and V stages, each stage's key positions and kind, and the
// barriers; every tile starts on a 1024-byte swizzle atom.
template <int kD>
struct HLayout {
  static constexpr int kNC = (kD + kCol - 1) / kCol;  // head-dim chunks
  static constexpr int kStages = kNC <= 2 ? 3 : 2;
  static constexpr int kTileBytes = kNC * kKVChunkBytes;   // K or V tile
  static constexpr int kK = kNC * kQChunkBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kPos = kV + kStages * kTileBytes;   // int [S][kHBK]
  static constexpr int kKind = kPos + kStages * kHBK * 4;  // int [S]
  static constexpr int kBar = (kKind + kStages * 4 + 7) / 8 * 8;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kSmem = kBytes + 1024;   // + slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the barrier's phase `parity` to complete.  A wait that lasts
// 2^34 clocks (some 9 s) traps: a lost arrival fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A wgmma operand in shared memory, 128-byte swizzle: `lbo` is the byte
// step between 64-column chunks of an MN-major operand (unused K-major),
// `sbo` the step between 8-row atoms.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup's wgmmas are
// pending (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// After wgmma_wait: the registers a wgmma wrote or read are live up to
// here and not touched before it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 accumulators; the
// fragment layout: thread (warp w, lane l) holds rows 16w + l/4 (+8) and
// columns 8j + 2(l%4) (+1) as d[4j .. 4j+3].
template <int N>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The output of a row that sees no key at columns col, col + 1: the sum of
// v over the Skv keys over the n_scan keys the reference scans.
__device__ __forceinline__ uint32_t unseen_row(const __nv_bfloat16* v,
                                               long long vs_s, int skv,
                                               int n_scan) {
  float x = 0.f, y = 0.f;
  for (int c = 0; c < skv; ++c) {
    const float2 vv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(v + c * vs_s));
    x += vv.x;
    y += vv.y;
  }
  return pack_bf16(x / (float)n_scan, y / (float)n_scan);
}

// Rows that see no key, written after the accumulators are dead.  Kept out
// of line: inlined, the Dh 80 instance ran a little slower at danube's
// prefill in an A/B within one call on the H100.
__device__ __noinline__ void write_unseen(__nv_bfloat16* o0,
                                          __nv_bfloat16* o1, bool w0,
                                          bool w1, const __nv_bfloat16* vb,
                                          long long vs_s, int skv,
                                          int n_scan, int dh, int c2) {
  for (int col = c2; col < dh; col += 8) {
    if (w0)
      *reinterpret_cast<uint32_t*>(o0 + col) =
          unseen_row(vb + col, vs_s, skv, n_scan);
    if (w1)
      *reinterpret_cast<uint32_t*>(o1 + col) =
          unseen_row(vb + col, vs_s, skv, n_scan);
  }
}

template <int kD>
__global__ void __launch_bounds__(kHThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const HParams p) {
  using L = HLayout<kD>;
  constexpr int kNC = L::kNC, kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = sm;
  uint8_t* sk = sm + L::kK;
  uint8_t* sv = sm + L::kV;
  int* kpos_s = reinterpret_cast<int*>(sm + L::kPos);
  int* kind_s = reinterpret_cast<int*>(sm + L::kKind);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kS;
  uint64_t* qbar = empty + kS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // heaviest causal tiles first: the q tile is the slowest grid index of
  // the grid's n_tiles x KV x B CTAs
  const int pq = kHRows / p.groups;            // positions per CTA
  const int n_tiles = (p.sq + pq - 1) / pq;
  const int per_tile = (int)gridDim.x / n_tiles;
  const int tile = n_tiles - 1 - (int)blockIdx.x / per_tile;
  const int kvh = (int)blockIdx.x % per_tile % p.kv_heads;
  const int b = (int)blockIdx.x % per_tile / p.kv_heads;
  const int q0 = tile * pq;                    // the tile's first position
  const int rows = pq * p.groups;              // rows that hold (pos, head)
  const int* qpos = p.qpos + (long long)b * p.sq;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHConsumerThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zero Q's spare rows (past Pq * G), which the products read; TMA writes
  // the others
  if (tid < kHConsumerThreads) {
    const int per_chunk = (kHRows - rows) * (kRowBytes / 16);
    for (int e = tid; e < kNC * per_chunk; e += kHConsumerThreads) {
      const int c = e / per_chunk, u = e % per_chunk;
      *reinterpret_cast<uint4*>(sq + c * kQChunkBytes + rows * kRowBytes
                                + u * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kHConsumerThreads / 32) {
    // ---- producer warp: Q once, then the visible K/V blocks -------------
    if (lane == 0) {
      mbar_expect_tx(qbar, kNC * rows * kRowBytes);
      for (int c = 0; c < kNC; ++c)
        tma_load_5d(sq + c * kQChunkBytes, &tq, qbar, c * kCol, 0, kvh, q0,
                    b);
    }
    int qlo = INT32_MAX, qhi = INT32_MIN;
    for (int i = lane; i < pq && q0 + i < p.sq; i += 32) {
      qlo = min(qlo, qpos[q0 + i]);
      qhi = max(qhi, qpos[q0 + i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, off));
      qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, off));
    }
    const int* kvpos = p.kvpos + (long long)b * p.skv;
    const int n_blocks = (p.skv + kHBK - 1) / kHBK;
    // a block's key positions; padding past Skv takes the reference's
    // padding position, which no mask admits
    auto key_pos = [&](int c) { return c < p.skv ? kvpos[c] : kPadPos; };
    int next0 = key_pos(lane), next1 = key_pos(32 + lane);
    int stage = 0, phase = 0;
    for (int blk = 0; blk < n_blocks; ++blk) {
      const int k0 = blk * kHBK;
      const int kp0 = next0, kp1 = next1;
      next0 = key_pos(k0 + kHBK + lane);       // in flight while this block
      next1 = key_pos(k0 + kHBK + 32 + lane);  // waits for its stage
      const bool ok0 = kp0 >= 0, ok1 = kp1 >= 0;
      int lo = min(ok0 ? kp0 : INT32_MAX, ok1 ? kp1 : INT32_MAX);
      int hi = max(ok0 ? kp0 : INT32_MIN, ok1 ? kp1 : INT32_MIN);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      const bool all_ok = __all_sync(0xffffffffu, ok0 && ok1);
      if (lo > hi || ((p.flags & kCausal) && lo > qhi)
          || ((p.flags & kWindow)
              && (long long)hi <= (long long)qlo - p.window))
        continue;                      // no row sees a key of this block
      const bool whole = all_ok && (!(p.flags & kCausal) || hi <= qlo)
          && (!(p.flags & kWindow)
              || (long long)lo > (long long)qhi - p.window);
      mbar_wait(&empty[stage], phase ^ 1);
      kpos_s[stage * kHBK + lane] = kp0;
      kpos_s[stage * kHBK + 32 + lane] = kp1;
      __syncwarp();
      if (lane == 0) {
        kind_s[stage] = whole ? 1 : 0;
        mbar_expect_tx(&full[stage], 2 * L::kTileBytes);
        for (int c = 0; c < kNC; ++c) {
          const int off = stage * L::kTileBytes + c * kKVChunkBytes;
          tma_load_4d(sk + off, &tk, &full[stage], c * kCol, kvh, k0, b);
          tma_load_4d(sv + off, &tv, &full[stage], c * kCol, kvh, k0, b);
        }
      }
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      kind_s[stage] = -1;              // the end
      mbar_arrive(&full[stage]);
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ---------------------------------
    const int wg = warp >> 2;
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
    const int c2 = 2 * (lane & 3);     // the thread's first column of 8
    const int pos0 = r0 / p.groups, g0 = r0 - pos0 * p.groups;
    const int pos1 = r1 / p.groups, g1 = r1 - pos1 * p.groups;
    const bool live0 = r0 < rows && q0 + pos0 < p.sq;
    const bool live1 = r1 < rows && q0 + pos1 < p.sq;
    const int qp0 = live0 ? qpos[q0 + pos0] : 0;
    const int qp1 = live1 ? qpos[q0 + pos1] : 0;

    float o[kD / 2], s[32];
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) ph[i] = pl[i] = 0u;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const uint32_t q_base = smem_u32(sq) + wg * 64 * kRowBytes;
    const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv);

    // scale, softcap, masks, then the online softmax on this block's S,
    // in place (S becomes the f32 P); a row's 64 keys lie on the 4 threads
    // of a quad.  -> the rows' rescale factors alpha.
    auto softmax = [&](int stage, int kind, float& a0, float& a1) {
      const int* kp = kpos_s + stage * kHBK;
#pragma unroll
      for (int j = 0; j < kHBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[4 * j + e] * p.scale;
          if (p.flags & kCap) v = p.cap * tanhf(v / p.cap);
          s[4 * j + e] = v;
        }
        if (kind == 0) {
          const int2 kc = *reinterpret_cast<const int2*>(kp + 8 * j + c2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpe = (e & 1) ? kc.y : kc.x;
            const int qp = e < 2 ? qp0 : qp1;
            bool ok = kpe >= 0;
            if (p.flags & kCausal) ok = ok && kpe <= qp;
            if (p.flags & kWindow)
              ok = ok && (long long)kpe > (long long)qp - p.window;
            if (!ok) s[4 * j + e] = kNegInf;
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kHBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = exp2f((m0 - mn0) * kLog2e);
      a1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kHBK / 8; ++j) {
        s[4 * j] = exp2f((s[4 * j] - mn0) * kLog2e);
        s[4 * j + 1] = exp2f((s[4 * j + 1] - mn0) * kLog2e);
        s[4 * j + 2] = exp2f((s[4 * j + 2] - mn1) * kLog2e);
        s[4 * j + 3] = exp2f((s[4 * j + 3] - mn1) * kLog2e);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;     // this thread's share of the row sums
      l1 = l1 * a1 + sum1;
    };
    // P = hi + lo in bf16; the S fragment of keys 16kk..16kk+15 is the A
    // fragment of k-step kk: (s[2i], s[2i+1]) -> register i
    auto split = [&]() {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
        const float2 hf = __bfloat1622float2(h);
        ph[i] = *reinterpret_cast<const uint32_t*>(&h);
        pl[i] = pack_bf16(s[2 * i] - hf.x, s[2 * i + 1] - hf.y);
      }
    };
    // S = Q K^T: kD / 16 k-steps of 32 bytes inside the swizzled rows
    auto issue_qk = [&](int stage) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        wgmma_ss<kHBK>(
            s,
            sw128_desc(q_base + (kk >> 2) * kQChunkBytes + col, 16,
                       kAtomBytes),
            sw128_desc(k_base + stage * L::kTileBytes
                       + (kk >> 2) * kKVChunkBytes + col, 16, kAtomBytes),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: V's rows are the k dimension, its columns N (MN-major)
    auto issue_pv = [&](int stage) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHBK / 16; ++kk) {
        const uint64_t dv = sw128_desc(
            v_base + stage * L::kTileBytes + kk * 16 * kRowBytes,
            kKVChunkBytes, kAtomBytes);
        wgmma_rs<kD>(o, ph + 4 * kk, dv);
        wgmma_rs<kD>(o, pl + 4 * kk, dv);
      }
      wgmma_commit();
    };

    // The pipeline: block i's S = Q K^T is issued with block i-1's P V,
    // and its softmax runs while that P V is on the tensor cores; O is
    // rescaled and P rebuilt once it is done.
    mbar_wait(qbar, 0);
    int stage = 0, phase = 0;
    mbar_wait(&full[stage], phase);
    if (kind_s[stage] >= 0) {
      float a0, a1;
      issue_qk(stage);
      wgmma_wait<0>();
      fence_regs<32>(s);
      softmax(stage, kind_s[stage], a0, a1);   // o is 0: no rescale
      split();
      for (;;) {
        const int prev = stage;
        if (++stage == kS) {
          stage = 0;
          phase ^= 1;
        }
        mbar_wait(&full[stage], phase);
        const int kind = kind_s[stage];
        if (kind < 0) {
          stage = prev;
          break;
        }
        issue_qk(stage);
        issue_pv(prev);
        wgmma_wait<1>();       // this block's S; the previous P V runs on
        fence_regs<32>(s);
        softmax(stage, kind, a0, a1);
        wgmma_wait<0>();
        fence_regs<kD / 2>(o);
        fence_regs<16>(ph);
        fence_regs<16>(pl);
        mbar_arrive(&empty[prev]);
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        split();
      }
      issue_pv(stage);         // the last block's P V
      wgmma_wait<0>();
      fence_regs<kD / 2>(o);
      fence_regs<16>(ph);
      fence_regs<16>(pl);
    }

    // out = acc / max(l, 1e-37), cast once, through the output strides
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
    // rows that see no key (m stayed at the sentinel) take the reference's
    // average of v instead
    const bool none0 = m0 == kNegInf, none1 = m1 == kNegInf;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v)
                              + b * p.vs_b + kvh * p.vs_kv;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.os_b
                        + kvh * p.os_kv;
    __nv_bfloat16* o0 = ob + (long long)(q0 + pos0) * p.os_s + g0 * p.os_g;
    __nv_bfloat16* o1 = ob + (long long)(q0 + pos1) * p.os_s + g1 * p.os_g;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= p.dh) continue;
      if (live0 && !none0)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (live1 && !none1)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if ((live0 && none0) || (live1 && none1))
      write_unseen(o0, o1, live0 && none0, live1 && none1, vb, p.vs_s,
                   p.skv, p.n_scan, p.dh, c2);
  }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map over `rank` indices (head dim first), strides in
// elements for indices 1.., 128-byte swizzle, zeros past the bounds.  An
// index of extent 1 takes the row's bytes as its stride (never stepped).
bool encode(CUtensorMap* map, const void* base, int rank,
            const long long* dims, const long long* strides,
            const int* box) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    gbox[i] = (cuuint32_t)box[i];
    estride[i] = 1;
  }
  for (int i = 1; i < rank; ++i)
    gstride[i - 1] = (cuuint64_t)(dims[i] == 1 ? dims[0] : strides[i - 1])
                     * sizeof(__nv_bfloat16);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch_wgmma(const Params& p, int batch, int kv, cudaStream_t stream) {
  using L = HLayout<kD>;
  HParams h;
  h.o = p.o;
  h.v = p.v;
  h.qpos = p.qpos;
  h.kvpos = p.kvpos;
  h.os_b = p.os_b; h.os_s = p.os_s; h.os_kv = p.os_kv; h.os_g = p.os_g;
  h.vs_b = p.vs_b; h.vs_s = p.vs_s; h.vs_kv = p.vs_kv;
  h.sq = p.sq; h.skv = p.skv; h.groups = p.groups; h.dh = p.dh;
  h.kv_heads = kv; h.window = p.window;
  h.n_scan = p.n_scan;
  h.flags = (p.causal ? kCausal : 0) | (p.has_window ? kWindow : 0)
            | (p.has_cap ? kCap : 0);
  h.cap = p.cap; h.scale = p.scale;
  const int pq = kHRows / p.groups;               // as the kernel derives
  const int n_tiles = (p.sq + pq - 1) / pq;

  CUtensorMap tq, tk, tv;
  const long long qdims[5] = {p.dh, p.groups, kv, p.sq, batch};
  const long long qstr[4] = {p.qs_g, p.qs_kv, p.qs_s, p.qs_b};
  const int qbox[5] = {kCol, p.groups, 1, pq, 1};
  const long long kdims[4] = {p.dh, kv, p.skv, batch};
  const long long kstr[3] = {p.ks_kv, p.ks_s, p.ks_b};
  const long long vstr[3] = {p.vs_kv, p.vs_s, p.vs_b};
  const int kbox[4] = {kCol, 1, kHBK, 1};
  if (!encode(&tq, p.q, 5, qdims, qstr, qbox)
      || !encode(&tk, p.k, 4, kdims, kstr, kbox)
      || !encode(&tv, p.v, 4, kdims, vstr, kbox))
    return (int)cudaErrorInvalidValue;

  auto kernel = flash_fwd_wgmma<kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)n_tiles * kv * batch;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kHThreads, L::kSmem, stream>>>(tq, tk, tv, h);
  return (int)cudaGetLastError();
}

// bf16: the padded head dim of the instance (TMA's zero fill covers the
// columns past Dh).
int dispatch_wgmma(const Params& p, int batch, int kv, cudaStream_t stream) {
  if (p.groups < 1 || p.groups > kHRows) return (int)cudaErrorInvalidValue;
  if (p.dh <= 64) return launch_wgmma<64>(p, batch, kv, stream);
  if (p.dh <= 80) return launch_wgmma<80>(p, batch, kv, stream);
  if (p.dh <= 128) return launch_wgmma<128>(p, batch, kv, stream);
  return launch_wgmma<256>(p, batch, kv, stream);
}

// ---------------------------------------------------------------------------
// f32: flash_fwd_tf32, 3xTF32 wgmma
// ---------------------------------------------------------------------------

namespace dt = dgrad_tile;

constexpr int kTConsumers = 2;                       // consumer warpgroups
constexpr int kTRows = 64 * kTConsumers;             // q rows per CTA
constexpr int kTProducer = 128;                      // producer warpgroup
constexpr int kTThreads = 128 * kTConsumers + kTProducer;
constexpr int kTBarSplit = 1;                        // the producer's barrier
constexpr int kTStages = 2;                          // K/V stages
constexpr int kTMaxDh = 128;

// The f32 kernel's parameters: K and V come through the two tensor maps
// (V also directly, for rows that see no key), Q through its pointer.
struct TParams {
  const void* q;
  void* o;
  const void* v;
  const int* qpos;
  const int* kvpos;
  long long qs_b, qs_s, qs_kv, qs_g;
  long long os_b, os_s, os_kv, os_g;
  long long vs_b, vs_s, vs_kv;
  int sq, skv, groups, dh, kv_heads, window;
  int n_scan;             // keys the reference scans: Skv up to its chunk
  int flags;              // kCausal | kWindow | kCap
  float cap, scale;
};
static_assert(2 * sizeof(CUtensorMap) + sizeof(TParams) <= 512,
              "the f32 kernel's parameters outgrow 512 bytes");

// Shared memory of one CTA at padded head dim kD and kBK keys a stage, in
// floats from a 128-byte aligned base: Q [kTRows][kD + 4] (the row pitch
// spreads an A load's eight rows over the banks), then each stage's K hi
// and lo [kD/4][kBK][4] (TMA lands K in the hi half), V^T hi and lo
// [kBK/4][kD][4] (V lands [kBK][kD] in the lo half), past head dim 80
// O's second half [kD/2 / 2 fragment values][consumer threads], the
// stages' key positions and kinds, and the barriers.
template <int kD, int kBK>
struct TLayout {
  // O's columns a consumer thread keeps in registers; past head dim 80
  // the other half lives in shared memory, a thread's own slice
  static constexpr int kORegs = kD > 80 ? kD / 2 : kD;
  static constexpr int kQLd = kD + 4;
  static constexpr int kTile = kBK * kD;             // floats of one half
  static constexpr int kStageFloats = 4 * kTile;
  static constexpr int kStage0 = kTRows * kQLd;
  static constexpr int kOSmem = kStage0 + kTStages * kStageFloats;
  static constexpr int kPos = kOSmem + kTRows * (kD - kORegs);
  static constexpr int kKind = kPos + kTStages * kBK;
  static constexpr int kBar = (kKind + kTStages + 1) / 2 * 2;
  static constexpr int kBytes = kBar * 4 + 3 * kTStages * 8;
  static constexpr int kSmem = kBytes + 128;    // + slack to align the base
  static_assert(kStage0 % 32 == 0 && kTile % 32 == 0,
                "every TMA box lands on 128 bytes");
  static_assert(kSmem <= 232448, "a CTA's shared memory outgrows the SM's");
};

// big = tf32(v), small = tf32(v - big), as bits
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = dt::tf32_bits(v[i]);
    small[i] = dt::tf32_bits(v[i] - __uint_as_float(big[i]));
  }
}

__device__ __forceinline__ float4 split_f4(float4 v, float4& small) {
  const float h[4] = {v.x, v.y, v.z, v.w};
  uint32_t bg[4], sm[4];
  split4(h, bg, sm);
  small = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                      __uint_as_float(sm[2]), __uint_as_float(sm[3]));
  return make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]),
                     __uint_as_float(bg[2]), __uint_as_float(bg[3]));
}

// acc += A B over kSteps k8 steps, three TF32 products a step (small*big,
// big*small, big*big into the one accumulator): A from registers, filled
// by load(big, small, j) one step ahead into the pair the wgmma two steps
// back has released; B's halves K-major from shared addresses big and
// small, step j `step` bytes on, `lbo` bytes between a step's K halves.
// Returns with every wgmma complete.
template <int N, int kSteps, typename Load>
__device__ __forceinline__ void mma3(float (&acc)[N / 2], Load load,
                                     uint32_t big, uint32_t small,
                                     uint32_t lbo, uint32_t step) {
  uint32_t big0[4], small0[4], big1[4], small1[4];
  auto issue = [&](const uint32_t (&ab)[4], const uint32_t (&as)[4],
                   int j) {
    dt::issue<N>(acc, ab, as, dt::kmajor_desc(big + j * step, lbo, 128),
                 dt::kmajor_desc(small + j * step, lbo, 128));
  };
  load(big0, small0, 0);
#pragma unroll
  for (int j = 0; j < kSteps; j += 2) {
    issue(big0, small0, j);
    if (j + 1 < kSteps) {
      dt::wgmma_wait<1>();
      load(big1, small1, j + 1);
      issue(big1, small1, j + 1);
    }
    if (j + 2 < kSteps) {
      dt::wgmma_wait<1>();
      load(big0, small0, j + 2);
    }
  }
  dt::wgmma_wait<0>();
  dt::fence_regs<N / 2>(acc);
}

// Rows that see no key (f32): columns col, col + 1 of each 8 from c2, the
// sum of v over the Skv keys over the n_scan keys the reference scans.
__device__ __noinline__ void write_unseen_f32(float* o0, float* o1, bool w0,
                                              bool w1, const float* vb,
                                              long long vs_s, int skv,
                                              int n_scan, int dh, int c2) {
  for (int col = c2; col < dh; col += 8) {
    float x = 0.f, y = 0.f;
    for (int c = 0; c < skv; ++c) {
      const float2 vv = *reinterpret_cast<const float2*>(vb + c * vs_s + col);
      x += vv.x;
      y += vv.y;
    }
    const float2 out = make_float2(x / (float)n_scan, y / (float)n_scan);
    if (w0) *reinterpret_cast<float2*>(o0 + col) = out;
    if (w1) *reinterpret_cast<float2*>(o1 + col) = out;
  }
}

template <int kD, int kBK>
__global__ void __launch_bounds__(kTThreads, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const TParams p) {
  using L = TLayout<kD, kBK>;
  constexpr int kS = kTStages;
  extern __shared__ float4 smem_t[];
  float* sm = reinterpret_cast<float*>(smem_t);
  sm += ((128 - (smem_u32(sm) & 127)) & 127) / 4;
  float* sq = sm;
  float* stg = sm + L::kStage0;
  int* kpos_s = reinterpret_cast<int*>(sm + L::kPos);
  int* kind_s = reinterpret_cast<int*>(sm + L::kKind);
  uint64_t* landed = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* ready = landed + kS;
  uint64_t* empty = ready + kS;

  const int tid = threadIdx.x, lane = tid & 31;
  // heaviest causal tiles first, as the bf16 kernel
  const int pq = kTRows / p.groups;            // positions per CTA
  const int n_tiles = (p.sq + pq - 1) / pq;
  const int per_tile = (int)gridDim.x / n_tiles;
  const int tile = n_tiles - 1 - (int)blockIdx.x / per_tile;
  const int kvh = (int)blockIdx.x % per_tile % p.kv_heads;
  const int b = (int)blockIdx.x % per_tile / p.kv_heads;
  const int q0 = tile * pq;
  const int rows = pq * p.groups;
  const int* qpos = p.qpos + (long long)b * p.sq;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&ready[s], kTProducer);
      mbar_init(&empty[s], 128 * kTConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q as it lies, row = position * G + g; zeros past the rows, Sq and Dh
  {
    constexpr int kC4 = kD / 4;
    const float* qb = static_cast<const float*>(p.q) + b * p.qs_b
                      + kvh * p.qs_kv;
    for (int e = tid; e < kTRows * kC4; e += kTThreads) {
      const int r = e / kC4, c4 = e - r * kC4;
      const int pos = r / p.groups, g = r - pos * p.groups;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && q0 + pos < p.sq && 4 * c4 < p.dh)
        val = __ldg(reinterpret_cast<const float4*>(
            qb + (long long)(q0 + pos) * p.qs_s + g * p.qs_g + 4 * c4));
      *reinterpret_cast<float4*>(sq + r * L::kQLd + 4 * c4) = val;
    }
  }
  __syncthreads();

  if (tid >= 128 * kTConsumers) {
    // ---- producer warpgroup: TMA, then the split of each landed stage ----
    const int ptid = tid - 128 * kTConsumers, pwarp = ptid >> 5;
    int qlo = INT32_MAX, qhi = INT32_MIN;
    for (int i = lane; i < pq && q0 + i < p.sq; i += 32) {
      qlo = min(qlo, qpos[q0 + i]);
      qhi = max(qhi, qpos[q0 + i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, off));
      qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, off));
    }
    const int* kvpos = p.kvpos + (long long)b * p.skv;
    const int n_blocks = (p.skv + kBK - 1) / kBK;
    constexpr int kPer = kBK / 32;             // key positions a lane
    int blk = 0, k0 = 0, kp[kPer];
    bool whole = false;
    // The next block from `blk` on that some row sees: its first key k0,
    // this lane's key positions kp (padding past Skv takes the reference's
    // padding position, which no mask admits) and whether every row sees
    // all of it.  Every warp finds the same blocks.
    auto next_visible = [&]() -> bool {
      for (; blk < n_blocks; ++blk) {
        const int base = blk * kBK;
        int lo = INT32_MAX, hi = INT32_MIN;
        bool all_ok = true;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = base + lane + 32 * j;
          kp[j] = c < p.skv ? kvpos[c] : kPadPos;
          const bool ok = kp[j] >= 0;
          all_ok = all_ok && ok;
          lo = min(lo, ok ? kp[j] : INT32_MAX);
          hi = max(hi, ok ? kp[j] : INT32_MIN);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        all_ok = __all_sync(0xffffffffu, all_ok);
        if (lo > hi || ((p.flags & kCausal) && lo > qhi)
            || ((p.flags & kWindow)
                && (long long)hi <= (long long)qlo - p.window))
          continue;                    // no row sees a key of this block
        whole = all_ok && (!(p.flags & kCausal) || hi <= qlo)
            && (!(p.flags & kWindow)
                || (long long)lo > (long long)qhi - p.window);
        k0 = base;
        ++blk;
        return true;
      }
      return false;
    };
    // tile i (the block next_visible found) into stage i % kS, once the
    // tile before in that stage is consumed: K as [Dh/4][keys][4] into the
    // K hi half, V as [keys][Dh] into the V lo half
    auto issue = [&](int i) {
      const int s = i % kS;
      if (pwarp != 0) return;
      if (i >= kS) mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < kPer; ++j) kpos_s[s * kBK + lane + 32 * j] = kp[j];
      __syncwarp();
      if (lane == 0) {
        float* st = stg + s * L::kStageFloats;
        kind_s[s] = whole ? 1 : 0;
        mbar_expect_tx(&landed[s], 2 * L::kTile * 4);
        tma_load_5d(st, &tk, &landed[s], 0, k0, 0, kvh, b);
        tma_load_4d(st + 3 * L::kTile, &tv, &landed[s], 0, k0, kvh, b);
      }
    };
    // tile i once landed: K hi and lo in place of K; V^T hi and lo from V,
    // its rows within each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7, so
    // that the consumers' S fragment (keys 2t, 2t + 1 of a thread) is P's
    // A fragment (k columns t, t + 4) as it lies
    auto split = [&](int i) {
      const int s = i % kS;
      mbar_wait(&landed[s], (i / kS) & 1);
      float* khi = stg + s * L::kStageFloats;
      float* klo = khi + L::kTile;
      float* vhi = klo + L::kTile;
      float* vlo = vhi + L::kTile;
      constexpr int kUnits = kBK / 4 * kD;           // (k quad, column)
      constexpr int kPerT = (kUnits + kTProducer - 1) / kTProducer;
      float4 vv[kPerT];
#pragma unroll
      for (int u = 0; u < kPerT; ++u) {
        const int unit = ptid + kTProducer * u;
        if (kUnits % kTProducer == 0 || unit < kUnits) {
          const int q = unit / kD, d = unit - q * kD;
          const float* src = vlo + (8 * (q >> 1) + (q & 1)) * kD + d;
          vv[u] = make_float4(src[0], src[2 * kD], src[4 * kD], src[6 * kD]);
        }
      }
      dt::bar_sync(kTBarSplit, kTProducer);    // V read before it is
#pragma unroll                                  // overwritten
      for (int u = 0; u < kPerT; ++u) {
        const int unit = ptid + kTProducer * u;
        if (kUnits % kTProducer == 0 || unit < kUnits) {
          float4 lo;
          const float4 hi = split_f4(vv[u], lo);
          reinterpret_cast<float4*>(vhi)[unit] = hi;
          reinterpret_cast<float4*>(vlo)[unit] = lo;
        }
      }
#pragma unroll 2
      for (int e = ptid; e < L::kTile / 4; e += kTProducer) {
        float4 lo;
        const float4 hi = split_f4(reinterpret_cast<float4*>(khi)[e], lo);
        reinterpret_cast<float4*>(khi)[e] = hi;
        reinterpret_cast<float4*>(klo)[e] = lo;
      }
      dt::fence_proxy_async();
      mbar_arrive(&ready[s]);
    };

    // a tile is issued once the one two stages back is consumed, and split
    // while the consumers run the one before it
    int issued = 0;
    for (int j = 0; j < kS - 1 && next_visible(); ++j) issue(issued++);
    for (int i = 0; i < issued; ++i) {
      split(i);
      if (next_visible()) issue(issued++);
    }
    // the end: kind -1 in the next stage, once the tile before in it is
    // consumed (so that no thread's arrival can count toward that tile)
    const int s = issued % kS;
    if (issued >= kS) mbar_wait(&empty[s], ((issued / kS) & 1) ^ 1);
    if (ptid == 0) kind_s[s] = -1;
    mbar_arrive(&ready[s]);
  } else {
    // ---- consumer warpgroups: 64 rows each ---------------------------------
    const int wg = tid >> 7, warp = (tid >> 5) & 3;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const int t4 = lane & 3, c2 = 2 * t4;
    // the rows' positions (what the epilogue needs besides is derived
    // again there: registers are short through the loop)
    int qp0 = 0, qp1 = 0;
    {
      const int pos0 = r0 / p.groups, pos1 = r1 / p.groups;
      if (r0 < rows && q0 + pos0 < p.sq) qp0 = qpos[q0 + pos0];
      if (r1 < rows && q0 + pos1 < p.sq) qp1 = qpos[q0 + pos1];
    }
    const float* qa0 = sq + r0 * L::kQLd + t4;
    const float* qa1 = qa0 + 8 * L::kQLd;
    const uint32_t stg_u = smem_u32(stg);
    // O: columns [0, kOR) in registers; past head dim 80 columns [kOR, kD)
    // in shared memory, this thread's fragment values at [k][tid]
    constexpr int kOR = L::kORegs;
    float* osm = sm + L::kOSmem + tid;

    float o[kOR / 2];
#pragma unroll
    for (int i = 0; i < kOR / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int k = 0; k < (kD - kOR) / 2; ++k) osm[k * 128 * kTConsumers] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int i = 0;; ++i) {
      const int s = i % kS;
      mbar_wait(&ready[s], (i / kS) & 1);
      const int kind = kind_s[s];
      if (kind < 0) break;
      const uint32_t khi = stg_u + s * L::kStageFloats * 4;
      const uint32_t klo = khi + L::kTile * 4;
      const uint32_t vhi = klo + L::kTile * 4;
      const uint32_t vlo = vhi + L::kTile * 4;

      // S = Q K^T: Q split at each load, K's halves K-major as they lie
      float sc[kBK / 2];
#pragma unroll
      for (int k = 0; k < kBK / 2; ++k) sc[k] = 0.f;
      mma3<kBK, kD / 8>(
          sc,
          [&](uint32_t (&big)[4], uint32_t (&small)[4], int j) {
            const float v[4] = {qa0[8 * j], qa1[8 * j], qa0[8 * j + 4],
                                qa1[8 * j + 4]};
            split4(v, big, small);
          },
          khi, klo, kBK * 16, kBK * 32);

      // scale, softcap, masks, the online softmax: S becomes the f32 P and
      // a0, a1 the rows' rescale factors (a row's keys lie on a quad)
      float a0, a1;
      {
        const int* kp = kpos_s + s * kBK;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = sc[4 * j + e] * p.scale;
            if (p.flags & kCap) v = p.cap * tanhf(v / p.cap);
            sc[4 * j + e] = v;
          }
          if (kind == 0) {
            const int2 kc = *reinterpret_cast<const int2*>(kp + 8 * j + c2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpe = (e & 1) ? kc.y : kc.x;
              const int qp = e < 2 ? qp0 : qp1;
              bool ok = kpe >= 0;
              if (p.flags & kCausal) ok = ok && kpe <= qp;
              if (p.flags & kWindow)
                ok = ok && (long long)kpe > (long long)qp - p.window;
              if (!ok) sc[4 * j + e] = kNegInf;
            }
          }
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        a0 = exp2f((m0 - mn0) * kLog2e);
        a1 = exp2f((m1 - mn1) * kLog2e);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          sc[4 * j] = exp2f((sc[4 * j] - mn0) * kLog2e);
          sc[4 * j + 1] = exp2f((sc[4 * j + 1] - mn0) * kLog2e);
          sc[4 * j + 2] = exp2f((sc[4 * j + 2] - mn1) * kLog2e);
          sc[4 * j + 3] = exp2f((sc[4 * j + 3] - mn1) * kLog2e);
          sum0 += sc[4 * j] + sc[4 * j + 1];
          sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = l0 * a0 + sum0;     // this thread's share of the row sums
        l1 = l1 * a1 + sum1;
      }

      // O = O * alpha + P V into a fresh accumulator each stage (wgmma's
      // adds round toward zero, and one accumulator over every key tile
      // drifts): P split in registers, V^T's halves K-major in the
      // permuted key order; O's register columns, then its shared ones
      auto load_p = [&](uint32_t (&big)[4], uint32_t (&small)[4], int j) {
        const float v[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                            sc[4 * j + 3]};
        split4(v, big, small);
      };
      {
        float f[kOR / 2];
#pragma unroll
        for (int k = 0; k < kOR / 2; ++k) f[k] = 0.f;
        mma3<kOR, kBK / 8>(f, load_p, vhi, vlo, kD * 16, kD * 32);
#pragma unroll
        for (int k = 0; k < kOR / 2; ++k)
          o[k] = fmaf(o[k], (k & 2) ? a1 : a0, f[k]);
      }
      if constexpr (kOR < kD) {
        float f[(kD - kOR) / 2];
#pragma unroll
        for (int k = 0; k < (kD - kOR) / 2; ++k) f[k] = 0.f;
        mma3<kD - kOR, kBK / 8>(f, load_p, vhi + kOR * 16, vlo + kOR * 16,
                                kD * 16, kD * 32);
#pragma unroll
        for (int k = 0; k < (kD - kOR) / 2; ++k) {
          float& os = osm[k * 128 * kTConsumers];
          os = fmaf(os, (k & 2) ? a1 : a0, f[k]);
        }
      }
      mbar_arrive(&empty[s]);
    }

    // out = acc / max(l, 1e-37), through the output strides
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
    // rows that see no key (m stayed at the sentinel) take the reference's
    // average of v instead
    const bool none0 = m0 == kNegInf, none1 = m1 == kNegInf;
    const int pos0 = r0 / p.groups, g0 = r0 - pos0 * p.groups;
    const int pos1 = r1 / p.groups, g1 = r1 - pos1 * p.groups;
    const bool live0 = r0 < rows && q0 + pos0 < p.sq;
    const bool live1 = r1 < rows && q0 + pos1 < p.sq;
    const float* vb = static_cast<const float*>(p.v) + b * p.vs_b
                      + kvh * p.vs_kv;
    float* ob = static_cast<float*>(p.o) + b * p.os_b + kvh * p.os_kv;
    float* o0 = ob + (long long)(q0 + pos0) * p.os_s + g0 * p.os_g;
    float* o1 = ob + (long long)(q0 + pos1) * p.os_s + g1 * p.os_g;
    // columns 8j + c2 (+1) of rows r0 (v[0], v[1]) and r1 (v[2], v[3])
    auto store = [&](int j, float v0, float v1, float v2, float v3) {
      const int col = 8 * j + c2;
      if (col >= p.dh) return;
      if (live0 && !none0)
        *reinterpret_cast<float2*>(o0 + col) =
            make_float2(v0 * inv0, v1 * inv0);
      if (live1 && !none1)
        *reinterpret_cast<float2*>(o1 + col) =
            make_float2(v2 * inv1, v3 * inv1);
    };
#pragma unroll
    for (int j = 0; j < kOR / 8; ++j)
      store(j, o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
#pragma unroll 1
    for (int j = kOR / 8; j < kD / 8; ++j) {
      const float* v = osm + (4 * j - kOR / 2) * 128 * kTConsumers;
      store(j, v[0], v[128 * kTConsumers], v[2 * 128 * kTConsumers],
            v[3 * 128 * kTConsumers]);
    }
    if ((live0 && none0) || (live1 && none1))
      write_unseen_f32(o0, o1, live0 && none0, live1 && none1, vb, p.vs_s,
                       p.skv, p.n_scan, p.dh, c2);
  }
}

template <int kD, int kBK>
int launch_tf32(const Params& p, int batch, int kv, cudaStream_t stream) {
  using L = TLayout<kD, kBK>;
  TParams t;
  t.q = p.q; t.o = p.o; t.v = p.v;
  t.qpos = p.qpos; t.kvpos = p.kvpos;
  t.qs_b = p.qs_b; t.qs_s = p.qs_s; t.qs_kv = p.qs_kv; t.qs_g = p.qs_g;
  t.os_b = p.os_b; t.os_s = p.os_s; t.os_kv = p.os_kv; t.os_g = p.os_g;
  t.vs_b = p.vs_b; t.vs_s = p.vs_s; t.vs_kv = p.vs_kv;
  t.sq = p.sq; t.skv = p.skv; t.groups = p.groups; t.dh = p.dh;
  t.kv_heads = kv; t.window = p.window; t.n_scan = p.n_scan;
  t.flags = (p.causal ? kCausal : 0) | (p.has_window ? kWindow : 0)
            | (p.has_cap ? kCap : 0);
  t.cap = p.cap; t.scale = p.scale;
  const int pq = kTRows / p.groups;               // as the kernel derives
  const int n_tiles = (p.sq + pq - 1) / pq;

  // K over (Dh % 4, S, Dh / 4, KV, B), boxes landing [kD/4][kBK][4]; V over
  // (Dh, S, KV, B), boxes landing [kBK][kD]; zeros past Dh and Skv.  Byte
  // strides; an index of extent 1 is never stepped.
  auto bytes = [](long long extent, long long stride) {
    return extent == 1 ? 16 : stride * 4;
  };
  CUtensorMap tk, tv;
  const long long kdims[5] = {4, p.skv, p.dh / 4, kv, batch};
  const long long kstr[4] = {bytes(p.skv, p.ks_s), 16, bytes(kv, p.ks_kv),
                             bytes(batch, p.ks_b)};
  const int kbox[5] = {4, kBK, kD / 4, 1, 1};
  const long long vdims[4] = {p.dh, p.skv, kv, batch};
  const long long vstr[3] = {bytes(p.skv, p.vs_s), bytes(kv, p.vs_kv),
                             bytes(batch, p.vs_b)};
  const int vbox[4] = {kD, kBK, 1, 1};
  if (!dt::encode(&tk, p.k, 5, kdims, kstr, kbox)
      || !dt::encode(&tv, p.v, 4, vdims, vstr, vbox))
    return (int)cudaErrorInvalidValue;

  auto kernel = flash_fwd_tf32<kD, kBK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)n_tiles * kv * batch;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kTThreads, L::kSmem, stream>>>(tk, tv, t);
  return (int)cudaGetLastError();
}

// f32 on the tensor cores at the padded head dim of the instance.  Keys a
// stage: 64 where two stages of K and V^T in TF32 halves fit beside Q
// (padded head dim up to 80), else 32.  launch/flash_f32_ab.py builds the
// other stage at head dim 80 with -DFLASH_TF32_STAGE80=32 to time it.
#ifndef FLASH_TF32_STAGE80
#define FLASH_TF32_STAGE80 64
#endif
int dispatch_tf32(const Params& p, int batch, int kv, cudaStream_t stream) {
  if (p.groups < 1 || p.groups > kTRows || p.dh > kTMaxDh)
    return (int)cudaErrorInvalidValue;
  if (p.dh <= 64) return launch_tf32<64, 64>(p, batch, kv, stream);
  if (p.dh <= 80)
    return launch_tf32<80, FLASH_TF32_STAGE80>(p, batch, kv, stream);
  return launch_tf32<128, 32>(p, batch, kv, stream);
}

}  // namespace

extern "C" {

// The f32 kernel's geometry, for the wrapper: threads per CTA, q rows per
// CTA, keys per staged block.
void flash_attention_geometry(int* threads, int* block_q, int* block_k) {
  *threads = kThreads;
  *block_q = kBQ;
  *block_k = kBK;
}

// The bf16 kernel's geometry: threads per CTA, q rows per CTA (G heads x
// positions), keys per K/V tile.
void flash_attention_wgmma_geometry(int* threads, int* rows, int* block_k) {
  *threads = kHThreads;
  *rows = kHRows;
  *block_k = kHBK;
}

// The f32 tensor-core kernel's geometry: threads per CTA, q rows per CTA,
// the largest head dim it takes.
void flash_attention_tf32_geometry(int* threads, int* rows, int* max_dh) {
  *threads = kTThreads;
  *rows = kTRows;
  *max_dh = kTMaxDh;
}

// strides (int64, in elements): q b,s,kv,g | k b,s,kv | v b,s,kv |
// out b,s,kv,g.  kvpos carries kv_valid (keys at or past it take the
// padding position).  ints: batch, kv heads, groups, sq, skv, dh, causal,
// has_window, window, has_cap, kernel (0: f32 flash_fwd_kernel, 1: bf16
// flash_fwd_wgmma, 2: f32 flash_fwd_tf32), n_scan (the keys the
// reference's chunked scan covers: Skv rounded up to its chunk).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const void* qpos, const void* kvpos,
                        const long long* strides,
                        const int* ints, float scale, float cap,
                        void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.qpos = static_cast<const int*>(qpos);
  p.kvpos = static_cast<const int*>(kvpos);
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
  const int kernel = ints[10];
  p.n_scan = ints[11];
  p.cap = cap;
  p.scale = scale;
  if (p.dh <= 0 || p.dh > kMaxDh || p.dh % 8 || p.n_scan < p.skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case 0: return dispatch_f32(p, batch, kv * p.groups, s);
    case 1: return dispatch_wgmma(p, batch, kv, s);
    case 2: return dispatch_tf32(p, batch, kv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
