// Split sums folded into the kernels that write their shares (sm_90a).
//
// A split-K wgrad writes one row of partial sums per position share into an
// f32 workspace [splits, |dw| + |db|], and a forward with the GAP rider
// writes one row of per-channel sums per tile into [N, Co/Cob, tiles, Cob].
// The reference sums such rows in one resident accumulator across its
// sequential grid (src/repro/kernels/direct_conv2d.py `_wgrad_kernel`,
// conv2d_common.py `gap_update`); blocks run in no order on Hopper, so the
// rows are summed once every share is written.  Here the kernel that writes
// them sums them too, with no second launch (a "last block" reduction):
//
// * A column is the set of CTAs whose rows cover the same outputs (for a
//   wgrad a (m-tile group, Ci block, Co block), for the GAP an (image,
//   output block)).  Each CTA, once its rows are stored, arrives once on
//   the column's int32 counter in device memory (an arena the wrapper keeps
//   per device and stream, kernels/split_sum.py).
// * The CTA that arrives last sums the column's rows in index order, row 0
//   first: the sum the plain `conv2d_common.wgrad_reduce` / `gap_finalize`
//   computes, in its order, so the outputs are bit for bit those of summing
//   the rows apart.  It waits for nobody: every other CTA of the column has
//   stored its rows and left, so no CTA holds an SM that another needs.
// * That CTA sets the counter back to 0, so the next launch and a
//   CUDA-graph replay find it clean.
//
// One SM reads the column's rows alone, so the choosers keep a column's
// rows short where the sum is folded (core/blocking.py, SPLIT_SUM_*).
//
// Memory order: every writer fences its stores (`__threadfence`) before the
// CTA's one arrival (a relaxed atomic after a barrier); the last CTA's
// leader fences after its arrival and hands over through a barrier; the
// rows are read with `ld.global.cg` (L2, not the non-coherent path).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace split_sum {
namespace {

// loads of one thread in flight while it sums a column of rows
constexpr int kInFlight = 8;

__device__ __forceinline__ void sync(int bar, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Arrive on a column's counter once this CTA's rows are stored: every one
// of the `count` threads on named barrier `bar` calls it, `lead` true for
// one of them; `flag` is an int of shared memory the call may overwrite.
// -> true in the last of the column's `arrivals` CTAs, once every row of
// the column is visible to it.
__device__ bool arrive(int* counter, int arrivals, int* flag, int bar,
                       int count, bool lead) {
  __threadfence();                // this thread's rows, to the whole card
  sync(bar, count);               // every thread's, before the arrival
  if (lead) {
    const bool last = atomicAdd(counter, 1) == arrivals - 1;
    if (last) {
      __threadfence();            // the other CTAs' rows, visible here
      atomicExch(counter, 0);
    }
    *flag = last;
  }
  sync(bar, count);
  return *flag != 0;
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// out[i] = (rows[i] + rows[pitch + i] + ... + rows[(count-1) * pitch + i])
// * scale, the rows added in index order, for i in [0, len): `tid` of `nth`
// threads, float4 at a time where the addresses and the pitch allow, each
// thread with kInFlight rows' loads in flight.
__device__ void sum_rows(const float* rows, size_t pitch, int count,
                         float* out, int len, float scale, int tid,
                         int nth) {
  const bool quads = ((reinterpret_cast<uintptr_t>(rows)
                       | reinterpret_cast<uintptr_t>(out)) & 15) == 0
                     && pitch % 4 == 0 && len % 4 == 0;
  if (quads) {
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    const size_t p4 = pitch / 4;
    for (int i = tid; i < len / 4; i += nth) {
      float4 s = __ldcg(r4 + i);
      int k = 1;
      for (; k + kInFlight <= count; k += kInFlight) {
        float4 v[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j)
          v[j] = __ldcg(r4 + (size_t)(k + j) * p4 + i);
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) add4(s, v[j]);
      }
      for (; k < count; ++k) add4(s, __ldcg(r4 + (size_t)k * p4 + i));
      reinterpret_cast<float4*>(out)[i] =
          make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
    }
    return;
  }
  for (int i = tid; i < len; i += nth) {
    float s = __ldcg(rows + i);
    int k = 1;
    for (; k + kInFlight <= count; k += kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        v[j] = __ldcg(rows + (size_t)(k + j) * pitch + i);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) s += v[j];
    }
    for (; k < count; ++k) s += __ldcg(rows + (size_t)k * pitch + i);
    out[i] = s * scale;
  }
}

// The GAP rider's fold: every one of the `count` threads on named barrier
// `bar` calls it once its tile's sums are stored in `partials` [columns,
// tiles, cob]; the column's last of `arrivals` CTAs writes `pooled`
// [columns, cob], the tiles summed in order times the f32 reciprocal of
// `hw`.  Out of line, so that none of its values is hoisted into the
// kernel's main loop: at 128 lanes the pointwise tile has no register to
// spare.
__device__ __noinline__ void gap_fold(const float* partials, float* pooled,
                                      int* counters, int column, int tiles,
                                      int arrivals, int cob, int hw,
                                      int* flag, int bar, int count) {
  if (arrive(counters + column, arrivals, flag, bar, count,
             threadIdx.x == 0)) {
    sum_rows(partials + (size_t)column * tiles * cob, cob, tiles,
             pooled + (size_t)column * cob, cob, __frcp_rn((float)hw),
             threadIdx.x, count);
  }
}

}  // namespace
}  // namespace split_sum
