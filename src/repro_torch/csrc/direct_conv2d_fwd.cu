// Blocked direct convolution, forward, f32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (src/repro/kernels/direct_conv2d.py:102, launched by `_forward_windowed`,
// pallas_call at :351), in f32 (`fwd_kernel`) and in bf16
// (`fwd_kernel_bf16`, the tile's bf16 build: bf16 operands on bf16 wgmma
// read from shared memory by descriptor, stride 2 staged as phase planes,
// one f32 accumulator, a persistent grid; fwd_tile.cuh, namespace bf16).
// Same function:
//
//   out = act(sum_{ci, dh, dw} x_win[dh, dw] @ w[dh, dw] + b) + r
//
// on the paper's blocked layouts (unpadded x: the pads are zero-filled
// copies, no padded copy of x exists), with an optional fused
// global-average-pool (GAP) into the pooled [N, Co] features; grouped
// (`Cig > 1`: an output block contracts its group's input blocks, the
// reference's map at :319-325) and dilated (the taps' origins strided)
// geometry included, as fwd_tile.cuh sets out.
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

// The bf16 build (fwd_tile.cuh, namespace bf16): bf16 x, w, residual, out
// and pooled features, an f32 bias and f32 partials; a persistent grid
// over the `n` images' (tile, output block x split) items, A (the window's
// cells, in the chunk's swizzle) and B (a filter row's weights, MN-major as
// they lie) read by bf16 wgmma (m64nNk16) from shared memory.
template <int N>
__global__ void __launch_bounds__(ft::bf16::max_threads(N), 1)
fwd_kernel_bf16(const __grid_constant__ CUtensorMap tmw,
                const __grid_constant__ CUtensorMap tmx,
                const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ residual,
                __nv_bfloat16* __restrict__ out, float* partials,
                __nv_bfloat16* __restrict__ pooled, int* counters,
                ft::Geometry g, int n) {
  extern __shared__ __align__(16) char smem_bf16[];
  ft::bf16::run<N>(smem_bf16, &tmw, &tmx, x, w, bias, residual, out,
                   partials, pooled, counters, g, n);
}

const void* const kKernelsBf16[] = {
    (const void*)fwd_kernel_bf16<8>, (const void*)fwd_kernel_bf16<16>,
    (const void*)fwd_kernel_bf16<32>, (const void*)fwd_kernel_bf16<64>,
    (const void*)fwd_kernel_bf16<128>};

// The bf16 build on the narrow rows (fwd_tile.cuh, bf16 `run_narrow`;
// narrow_rows.cuh): where a filter row's (dw, c) run fits one 128-byte row
// (Cib 3 at 11x11 and 3x3), A is a row an output position and filter-row
// group that the producer builds from the tile's staged input rows, K the
// group's packed (dh, dw, c); widths 16 to 128.
template <int N>
__global__ void __launch_bounds__(ft::bf16::max_threads(N), 1)
fwd_kernel_bf16_narrow(const __grid_constant__ CUtensorMap tmw,
                       const __grid_constant__ CUtensorMap tmx,
                       const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ residual,
                       __nv_bfloat16* __restrict__ out, float* partials,
                       __nv_bfloat16* __restrict__ pooled, int* counters,
                       ft::Geometry g, int n) {
  extern __shared__ __align__(16) char smem_narrow[];
  ft::bf16::run_narrow<N>(smem_narrow, &tmw, x, bias, residual, out,
                          partials, pooled, counters, g, n);
}

const void* const kKernelsNarrow[] = {
    nullptr, (const void*)fwd_kernel_bf16_narrow<16>,
    (const void*)fwd_kernel_bf16_narrow<32>,
    (const void*)fwd_kernel_bf16_narrow<64>,
    (const void*)fwd_kernel_bf16_narrow<128>};

// by a plan's operand type (fwd_tile's kOperandF32, kOperandBf16), then the
// bf16 narrow rows (kOperandNarrow)
const void* const* const kTables[] = {kKernels, kKernelsBf16, kKernelsNarrow};

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
// then the wgmma width, the images, the dynamic shared memory and the
// operand type (0: f32; 1: the bf16 build, on bf16 x, w, residual, out and
// pooled, an f32 bias and f32 partials, chunks multiples of 16).
int direct_conv2d_fwd(const void* x, const void* w, const void* bias,
                      const void* residual, void* out, void* partials,
                      void* pooled, void* counters, const int* plan,
                      void* stream) {
  return ft::launch(kTables, false, x, w, bias, residual, out, partials,
                    pooled, counters, plan, (cudaStream_t)stream);
}

// What direct_conv2d_fwd runs with the same plan (fwd_tile::plan_of):
// out[0] an image's tiles, out[1] the function's MACs, out[2] the
// tensor-core MACs issued (three products a MAC in f32, one in bf16),
// out[3] a CTA's shared memory, out[4] and out[5] its window and weight
// slots.
int direct_conv2d_fwd_plan(const int* plan, long long* out) {
  return ft::plan_of(false, plan, out);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
