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
// global-average-pool (GAP) into the pooled [N, Co] features.
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
// into `partials` [N, Co/Cob, tiles, Cob]; the last CTA of each (image,
// output block) to arrive sums its tiles in index order and multiplies by
// the f32 reciprocal of Ho*Wo (split_sum.cuh), in the same launch.  Two
// runs give identical bits.
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
           float* partials, float* __restrict__ pooled, int* counters,
           ft::Geometry g) {
  extern __shared__ __align__(16) float smem[];
  ft::run<N>(smem, &tmw, x, w, bias, residual, out, partials, pooled,
             counters, g);
}

const void* const kKernels[] = {
    (const void*)fwd_kernel<8>, (const void*)fwd_kernel<16>,
    (const void*)fwd_kernel<32>, (const void*)fwd_kernel<64>,
    (const void*)fwd_kernel<128>};

}  // namespace

extern "C" {

// The compiled tile's limits, for the wrapper's blocking model: threads of
// the largest CTA, rows of an m-tile, consumer warpgroups at most.
void direct_conv2d_fwd_geometry(int* threads, int* rows, int* consumers) {
  *threads = ft::kMaxThreads;
  *rows = ft::kRows;
  *consumers = ft::kMaxConsumers;
}

// The forward: x, w, the bias and residual (null where absent) into out;
// where the plan asks for GAP, the tiles' sums into partials and the pooled
// features into pooled ([N, Co]), with two zeroed int32 counters an (image,
// output block).  plan: the fwd_tile::Geometry fields in order (strips 1),
// then the wgmma width, the images and the dynamic shared memory.
int direct_conv2d_fwd(const void* x, const void* w, const void* bias,
                      const void* residual, void* out, void* partials,
                      void* pooled, void* counters, const int* plan,
                      void* stream) {
  return ft::launch(kKernels, false, x, w, bias, residual, out, partials,
                    pooled, counters, plan, (cudaStream_t)stream);
}

// What direct_conv2d_fwd runs with the same plan (fwd_tile::plan): out[0]
// an image's tiles, out[1] the function's MACs, out[2] the tensor-core MACs
// issued, out[3] a CTA's shared memory.
int direct_conv2d_fwd_plan(const int* plan, long long* out) {
  return ft::plan_of(false, plan, out);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
