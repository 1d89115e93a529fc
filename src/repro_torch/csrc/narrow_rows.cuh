// Narrow pencils on the bf16 tensor cores: a filter row's (dw, c) run as one
// 128-byte operand row.  The device core that the bf16 window forward
// (fwd_tile.cuh, bf16 `run_narrow`) and the bf16 window wgrad
// (wgrad_tile.cuh, bf16 `run_narrow`) share where a filter row's run of
// L = wf * Cib values fits 64 lanes at dilation 1 (Cib 3 at 11x11 and 3x3:
// the first conv of AlexNet, VGG-16 and MobileNet v1).
//
// In the blocked layout x[n, ci_b, ih, s ow - pl + dw, c] for dw < wf, c <
// Cib is one contiguous run of L bf16 values.  For output position (oh, ow)
// of a tile and filter-row group j (rows j r .. j r + r - 1 of the filter,
// r = min(64 / Lp, hf) of them, G = ceil(hf / r) groups), the producer
// builds one 128-byte row: run k (input row s oh + j r + k) at values k Lp
// .. k Lp + L - 1, Lp = L rounded up to 8, so that each 16-byte chunk of
// the row holds one run's values; zeros past each run, past the filter's
// rows and past r Lp.  An m-tile of the wgrad is a group (64 rows (dh, dw,
// c), the gaps' rows zero, read MN-major; K the tile's positions); a group
// of the forward's k16 slices is the same rows read K-major (M the
// positions, K the packed (dh, dw, c)) against the weights' rows (dh wf +
// dw) Cib + c, which lie contiguous in [Hf, Wf, Cib, Cob]: a TMA box of L
// rows a run lands at row k Lp.  The rows are the group's positions only,
// consecutive in the tile's row-major order, so positions run on across row
// breaks and any tile width takes them.
//
// Raw rows.  A 6-byte pixel takes no TMA, and an image row of 227 pixels
// (1362 bytes) starts 2 bytes aligned.  So the producer stages the tile's
// input rows by 16-byte cp.async copies of the aligned chunks that cover
// each row's pixels in the map, each landing at the same offset mod 16 in a
// row of `raw_pitch` bytes (`lead`, a table beside the rows, is where a
// row's first pixel lands); each input element is read from device memory
// once a window.  Once they land, `clear` zeroes each row's pixels outside
// the map (the pads, the rows past it; the table's [lo, hi) is a row's
// pixels in the map), over the neighbours' or a stale stage's bytes.  A row
// is then built 16 bytes at a time, four rows a pass for the loads in
// flight: a thread always takes the same chunk of its rows, whose run and
// offset it knows once; it reads the five aligned words that cover the
// chunk's eight values and funnel-shifts them by the run's 2-byte phase
// (run offsets are s ow Cib * 2 bytes: 24 at AlexNet's conv1, 12 at
// MobileNet's, 6 at VGG-16's), masks the values past the run, and stores
// the chunk in the 128-byte swizzle (chunk q of row f at q ^ (f & 7)) that
// either reading takes.  Values past r Lp are zeroed once (the kernels zero
// their slots at the start) and never written.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "dgrad_tile.cuh"

namespace narrow_rows {

namespace dt = dgrad_tile;

constexpr int kRowBytes = 128;      // one operand row: 64 bf16 values
constexpr int kRowValues = 64;
constexpr int kThreads = 128;       // the producer warpgroup

// Whether a conv takes the narrow rows: dilation 1, more than one tap, a
// filter row's run within one 128-byte row.
__host__ __device__ inline bool fits(int hf, int wf, int cib, int dil_h,
                                     int dil_w) {
  return dil_h == 1 && dil_w == 1 && hf * wf > 1 && wf * cib <= kRowValues;
}

// L, Lp, r, G: a run's values, its place in a row (whole 16-byte chunks),
// the filter rows a row holds, the groups
__host__ __device__ inline int run_values(int wf, int cib) { return wf * cib; }
__host__ __device__ inline int run_pad(int wf, int cib) {
  return (run_values(wf, cib) + 7) / 8 * 8;
}
__host__ __device__ inline int rows_a_group(int hf, int wf, int cib) {
  const int r = kRowValues / run_pad(wf, cib);
  return r < hf ? r : hf;
}
__host__ __device__ inline int groups(int hf, int wf, int cib) {
  const int r = rows_a_group(hf, wf, cib);
  return (hf + r - 1) / r;
}
// the (tap, c) rows of dw (or of w) a group covers, r L; the 16-byte chunks
// a row holds, r Lp / 8; r Lp padded to the forward's k16 slices
__host__ __device__ inline int values(int hf, int wf, int cib) {
  return rows_a_group(hf, wf, cib) * run_values(wf, cib);
}
__host__ __device__ inline int chunks(int hf, int wf, int cib) {
  return rows_a_group(hf, wf, cib) * run_pad(wf, cib) / 8;
}
__host__ __device__ inline int kpad(int hf, int wf, int cib) {
  return (rows_a_group(hf, wf, cib) * run_pad(wf, cib) + 15) / 16 * 16;
}

// A raw row's bytes: its pixels, a lead of up to 15 bytes and the partial
// chunks at either end; the table of `lead`, `lo` and `hi` after the rows.
__host__ __device__ inline int raw_pitch(int cib, int pixels) {
  return (2 * cib * pixels + 32 + 15) / 16 * 16;
}
__host__ __device__ inline int raw_bytes(int rows, int cib, int pixels) {
  return rows * raw_pitch(cib, pixels) + (12 * rows + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for all but the newest `pending` (0, 1 or 2) groups of copies
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 1) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending > 0) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Stage `rows` input rows of `pixels` pixels from (ih0, iw0) of one image's
// input block `xb` ([hi][wi][cib] bf16, on 16 bytes where its tensor starts)
// into `raw` (`tid` of the producer's kThreads): the aligned 16-byte chunks
// that cover each row's pixels in the map, the last one cut at the row's
// end, and the table.  The copies are this thread's; the caller commits.
__device__ inline void stage(char* raw, const __nv_bfloat16* xb, int hi,
                             int wi, int cib, int ih0, int iw0, int rows,
                             int pixels, int tid) {
  const int rp = raw_pitch(cib, pixels);
  int* lead = reinterpret_cast<int*>(raw + rows * rp);
  int* lo = lead + rows;
  int* hi_ = lo + rows;
  const uint32_t base = dt::smem_u32(raw);
  const long long row_bytes = 2ll * cib * wi;
  const int most = (2 * cib * pixels + 30) / 16 + 1;   // chunks a row
  for (int i = tid; i < rows * most; i += kThreads) {
    const int r = i / most;
    const int k = i - r * most;
    const int ih = ih0 + r;
    const bool in = ih >= 0 && ih < hi;
    const int plo = in ? (iw0 < 0 ? -iw0 : 0) : 0;
    int phi = in ? (wi - iw0 < pixels ? wi - iw0 : pixels) : 0;
    if (phi < plo) phi = plo;
    // the address of the row's pixel 0 (iw0), outside the row at a pad
    const long long g0 = (long long)reinterpret_cast<uintptr_t>(xb)
                         + ih * row_bytes + 2ll * cib * iw0;
    if (k == 0) {
      lead[r] = (int)(g0 & 15);
      lo[r] = plo;
      hi_[r] = phi;
    }
    if (phi <= plo) continue;
    const long long ge = g0 + 2ll * cib * phi;
    const long long a = ((g0 + 2ll * cib * plo) & ~15ll) + 16ll * k;
    if (a >= ge) continue;
    cp_async16(base + r * rp + (uint32_t)(a - (g0 & ~15ll)),
               reinterpret_cast<const void*>((uintptr_t)a),
               ge - a < 16 ? (int)(ge - a) : 16);
  }
}

// Zero each staged row's pixels outside the map (`tid` of the producer's
// kThreads), once its copies have landed: [0, lo) and [hi, pixels) of a row
// in the map, the whole row past it; a thread a row (most rows have none).
__device__ inline void clear(char* raw, int rows, int pixels, int cib,
                             int tid) {
  const int rp = raw_pitch(cib, pixels);
  const int* lead = reinterpret_cast<const int*>(raw + rows * rp);
  const int* lo = lead + rows;
  const int* hi = lo + rows;
  const uint32_t base = dt::smem_u32(raw);
  for (int r = tid; r < rows; r += kThreads) {
    const int l = lo[r] * cib;
    const int h = hi[r] * cib;
    const int n = l + pixels * cib - h;       // elements outside the map
    const uint32_t row = base + r * rp + lead[r];
    for (int e = 0; e < n; ++e) {
      dt::bf16::st_u16(row + 2 * (e < l ? e : e - l + h), (unsigned short)0);
    }
  }
}

// Build group j's rows, one a position f < npos of a th x tw tile (f = oh
// tw + ow), at `dst` (a 1024-byte aligned run of 128-byte rows, row f at f
// * 128) from the staged raw rows (`rows` of `pixels` pixels, cleared;
// `tid` of the producer's kThreads).  Thread tid takes chunk q = tid % Q
// (run q / (Lp / 8), its values 8 (q % (Lp / 8)) ..) of rows tid / Q,
// tid / Q + 128 / Q, ..., four rows a pass.
__device__ inline void build(uint32_t dst, const char* raw, int rows,
                             int pixels, int cib, int stride, int hf, int wf,
                             int j, int tw, int npos, int tid) {
  const int L = run_values(wf, cib);
  const int cpr = run_pad(wf, cib) / 8;           // chunks a run
  const int r = rows_a_group(hf, wf, cib);
  const int nq = r * cpr;
  const int per = kThreads / nq;
  if (tid >= per * nq) return;
  const int q = tid % nq;
  const int k = q / cpr;                          // the chunk's run
  const int e0 = 8 * (q - k * cpr);               // its first value
  const bool dead = j * r + k >= hf;              // a row past the filter
  // the chunk's values past the run: masked a bf16 pair at a time
  const int nv = L - e0 < 8 ? L - e0 : 8;
  uint32_t mask[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mask[e] = dead ? 0u : (2 * e + 1 < nv ? 0xFFFFFFFFu
                                          : (2 * e < nv ? 0xFFFFu : 0u));
  }
  const int rp = raw_pitch(cib, pixels);
  const int* lead = reinterpret_cast<const int*>(raw + rows * rp);
  const uint32_t rawb = dt::smem_u32(raw);
  const int step = stride * cib * 2;              // bytes from ow to ow + 1
  constexpr int kPass = 4;
  for (int f0 = tid / nq; f0 < npos; f0 += kPass * per) {
    uint32_t x[kPass][5], at[kPass], sh[kPass];
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int f = f0 + u * per;
      const int fc = f < npos ? f : f0;          // past the tile: row f0's
      const int oh = fc / tw;
      const int i = dead ? 0 : oh * stride + j * r + k;
      const uint32_t a = rawb + i * rp + lead[i] + (fc - oh * tw) * step
                         + 2 * e0;
      sh[u] = (a & 2u) * 8u;
      at[u] = dt::bf16::swizzled(dst + fc * kRowBytes + 16 * q, kRowBytes);
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(x[u][e]) : "r"((a & ~3u) + 4 * e));
      }
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      if (f0 + u * per >= npos) continue;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = __funnelshift_r(x[u][e], x[u][e + 1], sh[u]) & mask[e];
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(at[u]), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

}  // namespace narrow_rows
