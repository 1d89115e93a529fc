// Causal depthwise conv1d (the Mamba short conv) — hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/conv1d_depthwise.py:
//   `_kernel` (:27, pallas_call :56, `conv1d_depthwise_blocked_pallas` :44)
// and computes the reference's oracle `direct_conv1d_depthwise(x, w, bias,
// causal=True)` (src/repro/core/direct_conv.py:274):
//
//   out[b, l, c] = sum_{k < K} x[b, l - K + 1 + k, c] * w[k, c]  (+ bias[c])
//
// taps added in ascending k, then the bias, in f32, and one cast to x's
// dtype.  x is read in place through three strides: element (b, l, c) lies
// at b*sb + (c / Db)*sblk + l*sl + c % Db, so the one kernel reads the
// sequence-major [B, L, D] (Db = D; the row stride sl may exceed D, as for
// Mamba2's xBC, a column slice of in_proj's output) and the channel-blocked
// [B, D/Db, L, Db] of the TPU kernel (sblk = L*Db) without a relayout.  out
// is written through the same kind of strides.  w is [K, D] and bias [D],
// both f32 (the wrapper widens bf16 taps: K*D elements).
//
// Design.  A thread owns one channel, or a pair of adjacent channels (one
// float2 or bf16x2 load per row; the wrapper takes the pair path only when
// the base pointer and every stride keep the pair aligned), so a warp's
// loads of one row are 32 or 64 contiguous channels.  A CTA of 128 threads
// walks a block of kRows = 64 rows, loading eight rows at a time so that
// as many loads are in flight, with the last K-1 inputs in registers;
// the causal tail of a block is the previous block's last K-1 rows read
// from x itself (zeros before row 0) — the TPU kernel's trick, with no
// padded copy.  K is a template parameter (1..8), so the window and the
// taps stay in registers.
//
// What bounds it on this card.  2K FLOPs per output against at least one
// input and one output element: 1 FLOP/byte for f32 at K = 4, far below the
// ridge.  Bytes bound it (x and out once, the tail rows again from L2).
//
// C interface for ctypes: pointers and the stream as void*, strides as
// int64, the rest as int; returns cudaGetLastError() (0 = launched).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;       // rows a CTA walks
constexpr int kUnroll = 8;      // rows loaded together (divides kRows)
constexpr int kMaxTaps = 8;

template <typename T, int kVec> struct Vec;

template <> struct Vec<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};
template <> struct Vec<float, 2> {
  __device__ static void load(const float* p, float (&v)[2]) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[2]) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

template <typename T, int kVec, int kK>
__global__ void __launch_bounds__(kThreads)
conv1d_causal_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int seq, int d, int db, long long xsb, long long xsblk,
                     long long xsl, long long osb, long long osblk,
                     long long osl) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c0 >= d) return;
  const int l0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int blk = c0 / db, lane = c0 % db;
  const T* xp = x + b * xsb + blk * xsblk + lane;
  T* op = out + b * osb + blk * osblk + lane;

  float taps[kK][kVec], bs[kVec];
#pragma unroll
  for (int k = 0; k < kK; ++k)
#pragma unroll
    for (int v = 0; v < kVec; ++v) taps[k][v] = w[k * d + c0 + v];
#pragma unroll
  for (int v = 0; v < kVec; ++v) bs[v] = bias ? bias[c0 + v] : 0.f;

  // buf[i] = x[l - (K - 1) + i]: the causal tail of row l (i < K - 1),
  // then the kUnroll rows l, l + 1, ... loaded together so that as many
  // loads are in flight
  float buf[kK - 1 + kUnroll][kVec];
#pragma unroll
  for (int i = 0; i < kK - 1; ++i) {
    const int row = l0 - (kK - 1) + i;
    if (row >= 0) {
      Vec<T, kVec>::load(xp + row * xsl, buf[i]);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) buf[i][v] = 0.f;
    }
  }
  const int l_end = min(l0 + kRows, seq);
  for (int l = l0; l < l_end; l += kUnroll) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (l + i < l_end) {
        Vec<T, kVec>::load(xp + (l + i) * xsl, buf[kK - 1 + i]);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) buf[kK - 1 + i][v] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (l + i >= l_end) break;
      float acc[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < kK; ++k) a = fmaf(buf[i + k][v], taps[k][v], a);
        if (bias) a += bs[v];
        acc[v] = a;
      }
      Vec<T, kVec>::store(op + (l + i) * osl, acc);
    }
#pragma unroll
    for (int i = 0; i < kK - 1; ++i)
#pragma unroll
      for (int v = 0; v < kVec; ++v) buf[i][v] = buf[kUnroll + i][v];
  }
}

template <typename T, int kVec, int kK>
int launch(const void* x, const float* w, const float* bias, void* out,
           int batch, int seq, int d, int db, const long long* st,
           cudaStream_t stream) {
  const int per_cta = kThreads * kVec;
  const dim3 grid((d + per_cta - 1) / per_cta, (seq + kRows - 1) / kRows,
                  batch);
  conv1d_causal_kernel<T, kVec, kK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), seq, d, db,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <typename T, int kVec>
int by_taps(int k, const void* x, const float* w, const float* bias,
            void* out, int batch, int seq, int d, int db, const long long* st,
            cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, kVec, 1>(x, w, bias, out, batch, seq, d, db, st, s);
    case 2: return launch<T, kVec, 2>(x, w, bias, out, batch, seq, d, db, st, s);
    case 3: return launch<T, kVec, 3>(x, w, bias, out, batch, seq, d, db, st, s);
    case 4: return launch<T, kVec, 4>(x, w, bias, out, batch, seq, d, db, st, s);
    case 5: return launch<T, kVec, 5>(x, w, bias, out, batch, seq, d, db, st, s);
    case 6: return launch<T, kVec, 6>(x, w, bias, out, batch, seq, d, db, st, s);
    case 7: return launch<T, kVec, 7>(x, w, bias, out, batch, seq, d, db, st, s);
    case 8: return launch<T, kVec, 8>(x, w, bias, out, batch, seq, d, db, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The compiled geometry, for the wrapper: threads per CTA, rows a CTA
// walks, the most taps.
void conv1d_depthwise_geometry(int* threads, int* rows, int* max_taps) {
  *threads = kThreads;
  *rows = kRows;
  *max_taps = kMaxTaps;
}

// strides (int64, elements): x b, blk, l | out b, blk, l.  vec = 2 takes
// channel pairs (the wrapper has checked their alignment).
int conv1d_depthwise_causal(const void* x, const void* w, const void* bias,
                            void* out, int batch, int seq, int d, int db,
                            int k, int vec, int bf16,
                            const long long* strides, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 2 && (d % 2 || db % 2)) return (int)cudaErrorInvalidValue;
  if (bf16)
    return vec == 2
        ? by_taps<__nv_bfloat16, 2>(k, x, wf, bf, out, batch, seq, d, db, strides, s)
        : by_taps<__nv_bfloat16, 1>(k, x, wf, bf, out, batch, seq, d, db, strides, s);
  return vec == 2
      ? by_taps<float, 2>(k, x, wf, bf, out, batch, seq, d, db, strides, s)
      : by_taps<float, 1>(k, x, wf, bf, out, batch, seq, d, db, strides, s);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
