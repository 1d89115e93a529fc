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
// f32: flash_fwd_kernel.  One CTA of 256 threads per (64-row q block,
// q-head, batch).  Q is staged once, transposed (Qt [Dh][68]), in shared
// memory; K (Kt, also transposed) and V ([64][Dh]) are staged per 64-key
// block.  Thread (ty = t / 16, tx = t % 16) owns q rows 4ty..4ty+3: it
// computes their scores against keys 4tx..4tx+3 from one float4 of Qt and
// one of Kt per d (16 FMAs per two shared loads), keeps the rows' m and l
// in registers (the 16 threads of a row group meet by warp shuffles),
// writes its p's into a transposed P tile, and accumulates acc[4 rows][d =
// 4(tx + 16j) .. +3] of p @ v in registers.  All arithmetic is f32 on CUDA
// cores.
//
// Both kernels skip the blocks whose keys are all masked for every row of
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
// tensor cores at 989 TFLOP/s for bf16 (67 on f32 CUDA cores).
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

// strides (int64, in elements): q b,s,kv,g | k b,s,kv | v b,s,kv |
// out b,s,kv,g.  kvpos carries kv_valid (keys at or past it take the
// padding position).  ints: batch, kv heads, groups, sq, skv, dh, causal,
// has_window, window, has_cap, bf16, n_scan (the keys the reference's
// chunked scan covers: Skv rounded up to its chunk).
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
  const int bf16 = ints[10];
  p.n_scan = ints[11];
  p.cap = cap;
  p.scale = scale;
  if (p.dh <= 0 || p.dh > kMaxDh || p.dh % 8 || p.n_scan < p.skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_wgmma(p, batch, kv, s)
              : dispatch_f32(p, batch, kv * p.groups, s);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
