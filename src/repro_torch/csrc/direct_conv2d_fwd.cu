// Blocked direct convolution, forward, f32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (src/repro/kernels/direct_conv2d.py:102, launched by `_forward_windowed`,
// pallas_call at :351).  Same function:
//
//   out = act(sum_{ci, dh, dw} x_win[dh, dw] @ w[dh, dw] + b) + r
//
// on the paper's blocked layouts (unpadded x: the pads are zero-filled
// copies, no padded copy of x exists), with an optional fused
// global-average-pool (GAP) whose per-tile sums `gap_finalize` adds.
//
// `fwd_kernel<N>` is the dense forward tile of fwd_tile.cuh, one CTA per
// (tile of th x tw output positions, output block or half of one, image):
// an implicit GEMM on the tensor cores, 3xTF32 wgmma m64nNk8 with f32
// accumulators, A read from the staged halo window at each row's own
// offset (stride 2 is only an offset), B the weight chunk written
// transposed in core-matrix order by a producer warpgroup that stages the
// next (Ci block, chunk) by cp.async while the consumers run this one.  The
// TPU's sequential Ci grid axis is that loop of stages inside the CTA:
// blocks run in no order on Hopper, so nothing carries over between CTAs.
//
// What bounds it on this card.  VGG-16's convs do 2*9*Ci FLOPs per output
// element against a few bytes of traffic, far above the H100's ridge, so
// the bound is the tensor cores' rate spent three times over by the split
// (the function's MACs as three TF32 products at 495 TFLOP/s; 1.5 ms for
// VGG-16's 13 convs at batch 8, against 3.7 ms at the f32 FMA rate of the
// FMA register tile this replaces).  The design keeps the copies off the
// consumers' path (a producer warpgroup a stage ahead) and shares each
// staged window across the nine taps and each weight chunk across 64 to
// 192 positions; what is left bounding it is what `launch/fwd_parts_ab.py`
// measures.
//
// GAP rider.  Each CTA writes its tile's sums per channel in a fixed order
// into `partials` [N, Co/Cob, tiles, Cob]; `gap_finalize` sums the tiles in
// index order and multiplies by the f32 reciprocal of Ho*Wo.  No atomics:
// two runs give identical bits.
//
// C interface for ctypes: pointers and the stream as void*, the launch's
// plan as one int array built once per shape; each entry point returns
// cudaGetLastError() after its launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

#include "fwd_tile.cuh"

namespace {

namespace ft = fwd_tile;

// N: the wgmma width (the output lanes a CTA owns, padded up).
template <int N>
__global__ void __launch_bounds__(ft::max_threads(N), 1)
fwd_kernel(const __grid_constant__ CUtensorMap tmw,
           const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias,
           const float* __restrict__ residual, float* __restrict__ out,
           float* __restrict__ partials, ft::Geometry g) {
  extern __shared__ __align__(16) float smem[];
  ft::run<N>(smem, &tmw, x, w, bias, residual, out, partials, g);
}

const void* const kKernels[] = {
    (const void*)fwd_kernel<8>, (const void*)fwd_kernel<16>,
    (const void*)fwd_kernel<32>, (const void*)fwd_kernel<64>,
    (const void*)fwd_kernel<128>};

__global__ void gap_finalize_kernel(const float* __restrict__ partials,
                                    float* __restrict__ pooled, int rows,
                                    int n_tiles, int cob, float inv_hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cob) return;
  const int r = i / cob;
  const int co = i % cob;
  const float* p = partials + (size_t)r * n_tiles * cob + co;
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t) s += p[(size_t)t * cob];
  pooled[i] = s * inv_hw;
}

}  // namespace

extern "C" {

// The compiled tile's limits, for the wrapper's blocking model: threads of
// the largest CTA, rows of an m-tile, consumer warpgroups at most.
void direct_conv2d_fwd_geometry(int* threads, int* rows, int* consumers) {
  *threads = ft::kMaxThreads;
  *rows = ft::kRows;
  *consumers = ft::kMaxConsumers;
}

// The forward: x, w, the bias and residual (null where absent) into out,
// with the tiles' GAP sums into partials where the plan asks for them.
// plan: the fwd_tile::Geometry fields in order (strips 1), then the wgmma
// width, the images and the dynamic shared memory.
int direct_conv2d_fwd(const void* x, const void* w, const void* bias,
                      const void* residual, void* out, void* partials,
                      const int* plan, void* stream) {
  return ft::launch(kKernels, false, x, w, bias, residual, out, partials,
                    plan, (cudaStream_t)stream);
}

// What direct_conv2d_fwd runs with the same plan (fwd_tile::plan): out[0]
// an image's tiles, out[1] the function's MACs, out[2] the tensor-core MACs
// issued, out[3] a CTA's shared memory.
int direct_conv2d_fwd_plan(const int* plan, long long* out) {
  return ft::plan_of(false, plan, out);
}

int gap_finalize(const void* partials, void* pooled, int rows, int n_tiles,
                 int cob, float inv_hw, void* stream) {
  const int total = rows * cob;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  gap_finalize_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, (float*)pooled, rows, n_tiles, cob, inv_hw);
  return (int)cudaGetLastError();
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
