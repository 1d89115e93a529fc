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
// pencils at every position.  The forward is one GEMM tile,
// `pointwise_tile_kernel`:
//
//   out[n, ob, p, o] = sum_{kb, k} x[n, kb, p, k] * w[ob][kb][k][o]
//
// The dgrad is not built here: its wrapper launches the dense dgrad's
// TMA-fed tile at a 1x1 filter (direct_conv2d_bwd.cu `dgrad_kernel`), whose
// B operand, the weight as stored, is K-major already and which timed
// faster than this tile with the weight read transposed.
//
// The tile, on the tensor cores.  A CTA owns `rows` = 64 x (consumer
// warpgroups) consecutive positions of one image (M; tiles never straddle
// images, so GAP sums stay per image, and only an image's last tile is
// ragged) by N lanes of one output block (a 128-lane block may split in two
// CTAs of 64 where that fills the card), and contracts K = (input block,
// channel) `chunk` channels a stage: wgmma m64nNk8 in TF32 with f32
// accumulators, A (the staged input rows) read from shared memory into
// registers, B (the weight chunk) from shared memory in the core-matrix
// order [chunk/4][N][4] that TF32 wgmma's K-major operand takes.
//
// f32 accuracy from TF32 (3xTF32), as the dense dgrad and wgrad tiles
// (dgrad_tile.cuh): each operand splits into big + small TF32 halves and
// the three products small*big + big*small + big*big go into one f32
// accumulator.  A splits as it is loaded, B once a stage.
//
// Warp roles.  A CTA is `wgs` consumer warpgroups (the first threads) and
// one producer warpgroup.  A stage's copies are cp.async (16 bytes where
// the pencils are multiples of 4, else 4; zero-filled past the map's end
// and past a pencil), issued by the producer's 128 threads a stage ahead
// into a two-slot ring of input rows and raw weight chunks: a launch
// encodes nothing on the host, and every pencil width takes the one path.
// The producer then writes the weight chunk, staged raw, in core-matrix
// order split into its halves: the weight [k][o] is N-contiguous (MN
// major), which TF32 wgmma does not take, so the producer transposes it on
// that pass.  Named barriers hand a slot to the consumers and back.  No
// atomics: every sum runs in a fixed order, and two runs give identical
// bits.
//
// Epilogue: the forward's is the reference's (+ b, activation, + r, one
// store); with GAP each CTA writes its tile's sums of the stored values,
// the rows of a warp summed by shuffles and the consumer warps in order,
// and the last CTA of an (image, output block) adds the image's tiles in
// order into the pooled features (split_sum.cuh), in the same launch.
//
// What bounds it on this card.  Per output element the forward does 2*Ci
// FLOPs against 4 bytes written and 4*Ci/Co bytes read: 32 to 512 FLOP/byte
// on MobileNet's legs.  As three TF32 products on the tensor cores (495
// TFLOP/s) that is near or under the H100's ridge (~150 FLOP/byte), so the
// legs are bound by bytes and operations alike at batch 8, by operations at
// batch 32's larger maps; the f32 FMA rate (67 TFLOP/s) that bound the
// earlier kernel is printed beside it.  In practice the 7x7 and 14x14 maps
// give few CTAs (the N split doubles them) and short contractions give few
// stages to hide a stage's copies behind.
//
// wgrad: the TPU walks (N, H/Hob, W/Wob) as a sequential reduction axis into
// one resident [Cib, Cob] block.  Blocks run in no order on Hopper, so a CTA
// owns one [Cib, Cob] block and a contiguous share of the position tiles
// (`splits` shares per block); its threads form `pgroups` position groups of
// 8 x 8 register tiles, whose sums meet in shared memory in group order, and
// each share's sums go to its row of an f32 workspace [splits, |dw| + |db|];
// the last CTA of each block's column of shares adds the rows in split
// order into dw and db (split_sum.cuh).  No sum depends on the order CTAs run in:
// two runs give identical bits.  db rides the Ci-block-0 CTAs only.
//
// C interface for ctypes: pointers and the stream as void*, ints as int (the
// tile's plan as one int array, built once per shape); each entry point
// returns cudaGetLastError() after its launch (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dgrad_tile.cuh"
#include "split_sum.cuh"

namespace {

namespace dt = dgrad_tile;

constexpr int kThreads = 256;   // threads per wgrad CTA
constexpr int kLanes = 8;       // output lanes in one wgrad thread's tile
constexpr int kMinBlocksPerSm = 2;
constexpr int kMaxDevices = 64;

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
      v.x = dt::prologue(v.x, zz.x, act);
      v.y = dt::prologue(v.y, zz.y, act);
      v.z = dt::prologue(v.z, zz.z, act);
      v.w = dt::prologue(v.w, zz.w, act);
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    float v = __ldg(g + src);
    if (z != nullptr) v = dt::prologue(v, __ldg(z + src), act);
    *dst = v;
  }
}

// ---------------------------------------------------------------------------
// forward: the tensor-core tile
// ---------------------------------------------------------------------------

constexpr int kWarpgroup = dt::kWarpgroup;
constexpr int kMaxConsumers = 3;
constexpr int kTileThreads = kWarpgroup * (kMaxConsumers + 1);
constexpr int kRows = 64;           // rows of one wgmma tile
// ring slots: a stage's copies are issued a stage ahead of its use
constexpr int kSlots = 2;
// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;                   // + slot: the stage is ready
constexpr int kBarEmpty = kBarFull + kSlots;  // + slot: consumed
constexpr int kBarProducer = kBarEmpty + kSlots;  // the producer's own
constexpr int kBarGap = kBarProducer + 1;     // the consumers', GAP sums

// The tile's launch geometry, passed by value; its fields are the int array
// the host builds once per shape (conv2d_pointwise_tile).
struct Geometry {
  int kblk, kw;      // the contraction: input blocks of kw channels
  int oblk, ow;      // the output: blocks of ow lanes
  int hw;            // positions of one image
  int rows;          // positions of a tile: 64 x consumer warpgroups
  int nsplit;        // CTAs an output block's lanes split into, N each
  int chunk;         // channels a stage contracts (a multiple of 8)
  int act;
  int gap;           // 1: the forward writes the tile's GAP sums
};
constexpr int kGeometryInts = sizeof(Geometry) / sizeof(int);

__host__ __device__ inline int kpad(const Geometry& g) {
  return (g.kw + 7) / 8 * 8;
}

// floats from one staged input row to the next: the chunk and 4 more, so
// that the eight rows of a warp's A load fall on eight distinct bank quads
__host__ __device__ inline int row_floats(const Geometry& g) {
  return g.chunk + 4;
}

// Dynamic shared memory of one CTA (core/blocking.py pointwise_smem_bytes):
// 128 bytes to align the base; per ring slot the input rows, the raw weight
// chunk [chunk][N] and its big and small halves; the k8 steps' A shifts;
// the consumer warps' GAP sums.
__host__ inline size_t smem_bytes(const Geometry& g, int n, int wgs) {
  const size_t rows = (size_t)g.rows * row_floats(g);
  return 128 + 4 * (kSlots * (rows + 3 * (size_t)g.chunk * n)
                    + g.chunk / 8 + (g.gap ? (size_t)4 * wgs * n : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kSlots - 2 of this thread's copy groups are in flight:
// the stage about to be processed has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kSlots - 2) : "memory");
}

// Copy `count` runs of `len` floats, run r from src + r * src_stride (valid
// while r < valid_runs, and float e of it while e < valid_len) to dst + r *
// dst_stride, by `tid` of 128 producer threads; 16-byte copies when `vec`
// (len, the strides and the bases multiples of 4 floats).
__device__ __forceinline__ void copy_runs(float* dst, int dst_stride,
                                          const float* src, int src_stride,
                                          int count, int len, int valid_runs,
                                          int valid_len, bool vec, int tid) {
  const int unit = vec ? 4 : 1;
  const int units = len / unit;
  for (int i = tid; i < count * units; i += kWarpgroup) {
    const int r = i / units;
    const int e = (i - r * units) * unit;
    const bool ok = r < valid_runs && e < valid_len;
    const float* s = ok ? src + (size_t)r * src_stride + e : src;
    if (vec) {
      cp_async16(dst + r * dst_stride + e, s, ok);
    } else {
      cp_async4(dst + r * dst_stride + e, s, ok);
    }
  }
}

// The shared-memory carve-up of one CTA (smem_bytes): kSlots slots of
// `slot` floats each, [input rows | big | small | raw] a slot, then the
// shifts and the GAP sums.  A slot's buffers are reached by
// offset, so that a slot index known only at run time costs no local
// memory.
struct Smem {
  float* base;
  int slot;            // floats of one slot
  int big, small, raw;   // offsets inside a slot
  int* shifts;         // [chunk / 8]
  float* red;          // [4 * wgs][N] the consumer warps' GAP sums

  __device__ float* rows_of(int s) const { return base + s * slot; }
  __device__ float* big_of(int s) const { return base + s * slot + big; }
  __device__ float* small_of(int s) const { return base + s * slot + small; }
  __device__ float* raw_of(int s) const { return base + s * slot + raw; }
};

template <int N>
__device__ inline Smem carve(float* smem, const Geometry& g) {
  Smem m;
  m.base = smem + ((128 - (dt::smem_u32(smem) & 127)) & 127) / 4;
  m.big = g.rows * row_floats(g);
  m.small = m.big + g.chunk * N;
  m.raw = m.small + g.chunk * N;
  m.slot = m.raw + g.chunk * N;
  float* p = m.base + kSlots * m.slot;
  m.shifts = reinterpret_cast<int*>(p);
  m.red = p + g.chunk / 8;
  return m;
}

// Issue stage s's copies (the producer's 128 threads, `tid`; the caller
// commits them as one group): the tile's input rows [rows][chunk] of
// channels [c0, c0 + chunk) of input block kb, and the raw weight chunk.
template <int N>
__device__ inline void issue_stage(const Smem& m, int slot,
                                   const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const Geometry& g, int n, int o_b, int o0,
                                   int kb, int c0, int p0, int tid) {
  const int ld = row_floats(g);
  const bool vx = g.kw % 4 == 0;
  const size_t slab = ((size_t)(n * g.kblk + kb) * g.hw + p0) * g.kw + c0;
  const int valid_rows = min(g.rows, g.hw - p0);
  const int valid_k = min(g.chunk, g.kw - c0);
  copy_runs(m.rows_of(slot), ld, x + slab, g.kw, g.rows, g.chunk, valid_rows,
            valid_k, vx, tid);
  // w[o_b][kb][c0 + k][o0 + n]: chunk runs of N lanes
  const int valid_n = min(N, g.ow - o0);
  const float* wb = w + ((size_t)(o_b * g.kblk + kb) * g.kw + c0) * g.ow + o0;
  copy_runs(m.raw_of(slot), N, wb, g.ow, g.chunk, N, valid_k, valid_n,
            g.ow % 4 == 0, tid);
}

// The raw weight chunk [chunk][N] into the core-matrix order
// [chunk/4][N][4], transposed and split into TF32 halves: unit (q, n) is
// B[4q .. 4q + 3][n] (the producer's threads, neighbouring threads on
// neighbouring n).
template <int N>
__device__ inline void split_weights(const Smem& m, int slot,
                                     const Geometry& g, int tid) {
  auto split = [](float v, float& s) {
    const float h = __uint_as_float(dt::tf32_bits(v));
    s = __uint_as_float(dt::tf32_bits(v - h));
    return h;
  };
  for (int u = tid; u < g.chunk / 4 * N; u += kWarpgroup) {
    const int q = u / N;
    const int n = u - q * N;
    const float* r = m.raw_of(slot) + 4 * q * N + n;
    float4 v = make_float4(r[0], r[N], r[2 * N], r[3 * N]);
    float4 lo;
    v.x = split(v.x, lo.x);
    v.y = split(v.y, lo.y);
    v.z = split(v.z, lo.z);
    v.w = split(v.w, lo.w);
    reinterpret_cast<float4*>(m.big_of(slot))[u] = v;
    reinterpret_cast<float4*>(m.small_of(slot))[u] = lo;
  }
}

// N: the wgmma width (the output lanes a CTA owns, padded up).
template <int N>
__global__ void __launch_bounds__(kTileThreads, 1)
pointwise_tile_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ residual,
                      float* __restrict__ out, float* partials,
                      float* __restrict__ pooled, int* counters,
                      Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int o_b = blockIdx.y / g.nsplit;
  const int o0 = blockIdx.y % g.nsplit * N;
  const int n = blockIdx.z;
  const int p0 = tile * g.rows;
  const int nth = blockDim.x;
  const int consumers = nth - kWarpgroup;
  const Smem m = carve<N>(smem, g);
  const int per_block = kpad(g) / g.chunk;
  const int stages = g.kblk * per_block;
  const int steps = g.chunk / 8;
  for (int j = threadIdx.x; j < steps; j += nth) m.shifts[j] = 8 * j;
  __syncthreads();

  if (threadIdx.x >= consumers) {       // the producer warpgroup
    const int tid = threadIdx.x - consumers;
    auto issue = [&](int s) {
      issue_stage<N>(m, s % kSlots, x, w, g, n, o_b, o0, s / per_block,
                     s % per_block * g.chunk, p0, tid);
    };
    // one copy group a stage, committed even when empty, so that the
    // group of stage s is the oldest in flight when s is processed
    for (int s = 0; s < kSlots - 1; ++s) {
      if (s < stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      const int slot = s % kSlots;
      cp_async_wait_ring();
      dt::bar_sync(kBarProducer, kWarpgroup);   // every thread's copies
      split_weights<N>(m, slot, g, tid);
      dt::fence_proxy_async();
      dt::bar_arrive(kBarFull + slot, nth);
      // stage s + kSlots - 1 refills the slot of stage s - 1 once the
      // consumers are done with it and every producer thread has split
      // its raw chunk
      const int next = s + kSlots - 1;
      if (next < stages) {
        if (s >= 1) dt::bar_sync(kBarEmpty + (s - 1) % kSlots, nth);
        issue(next);
      }
      cp_async_commit();
    }
    return;
  }

  // a consumer thread: rows r and r + 8 of its warpgroup's m-tile
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / kWarpgroup * kRows
                + threadIdx.x % kWarpgroup / 32 * 16 + lane / 4;
  const int ld = row_floats(g);
  const int off[2] = {r * ld + lane % 4, (r + 8) * ld + lane % 4};
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % kSlots;
    dt::bar_sync(kBarFull + slot, nth);
    dt::mma_stage<N>(acc, m.rows_of(slot), off, m.shifts, steps,
                     m.big_of(slot), m.small_of(slot));
    if (s + kSlots < stages) dt::bar_arrive(kBarEmpty + slot, nth);
  }

  // the epilogue; acc keeps the stored values, zero where nothing is
  // stored, for the GAP sums
  const int col0 = 2 * (lane % 4);
  const bool pairs = g.ow % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + r + 8 * h;
    const bool row_ok = p < g.hw;
    const size_t base = ((size_t)(n * g.oblk + o_b) * g.hw + p) * g.ow + o0;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + col0;
      float v[2] = {acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]};
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = row_ok && o0 + col + e < g.ow;
        if (ok[e]) {
          const int o = o0 + col + e;
          v[e] = activate(v[e] + (bias != nullptr
                                      ? __ldg(bias + o_b * g.ow + o) : 0.0f),
                          g.act);
          if (residual != nullptr) v[e] += __ldg(residual + base + col + e);
        }
        acc[4 * jj + 2 * h + e] = ok[e] ? v[e] : 0.0f;
      }
      if (pairs && ok[1]) {
        *reinterpret_cast<float2*>(out + base + col) = make_float2(v[0], v[1]);
      } else {
        if (ok[0]) out[base + col] = v[0];
        if (ok[1]) out[base + col + 1] = v[1];
      }
    }
  }

  if (g.gap) {
    // the tile's sums of the stored values: a thread's two rows, the eight
    // row groups of a warp by shuffles, then the consumer warps in order
    const int wid = threadIdx.x / 32;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[4 * jj + e] + acc[4 * jj + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) m.red[wid * N + 8 * jj + col0 + e] = s;
      }
    }
    dt::bar_sync(kBarGap, consumers);
    const int c = threadIdx.x;
    if (c < N && o0 + c < g.ow) {
      float s = 0.0f;
      for (int q = 0; q < consumers / 32; ++q) s += m.red[q * N + c];
      partials[((size_t)(n * g.oblk + o_b) * gridDim.x + tile) * g.ow + o0
               + c] = s;
    }
    // the last CTA of (n, o_b), both lane halves: the image's tiles in
    // order, times the f32 reciprocal of H * W
    split_sum::gap_fold(partials, pooled, counters, n * g.oblk + o_b,
                        gridDim.x, gridDim.x * g.nsplit, g.ow, g.hw,
                        reinterpret_cast<int*>(m.red), kBarGap, consumers);
  }
}

void* pick_tile(int lanes) {
  switch (lanes) {
    case 8: return (void*)pointwise_tile_kernel<8>;
    case 16: return (void*)pointwise_tile_kernel<16>;
    case 32: return (void*)pointwise_tile_kernel<32>;
    case 64: return (void*)pointwise_tile_kernel<64>;
    case 128: return (void*)pointwise_tile_kernel<128>;
  }
  return nullptr;
}

// Raise a kernel's dynamic shared-memory limit once per device to the most
// any launch has asked of it (the attribute is the kernel's, per device).
cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
  static int allowed[kMaxDevices][5];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int& have = allowed[device][slot];
  if (bytes <= have || bytes <= 48 * 1024) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
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
                       const float* __restrict__ z, float* ws, float* out,
                       int* counters, int n_img, int ciblk, int cib,
                       int coblk, int cob, int hw, int positions, int splits,
                       int act, int with_db) {
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

  // the last CTA of block (ci_b, co_b) sums its rows in split order, and
  // db where the column has it (red is free: every thread is past its last
  // read once it arrives)
  const size_t cols = dw_size + (with_db ? coblk * cob : 0);
  if (!split_sum::arrive(counters + co_b * ciblk + ci_b, splits,
                         reinterpret_cast<int*>(red), 0, kThreads, t == 0)) {
    return;
  }
  const size_t at = (size_t)(co_b * ciblk + ci_b) * block;
  split_sum::sum_rows(ws + at, cols, splits, out + at, block, 1.0f, t,
                      kThreads);
  if (with_db && ci_b == 0) {
    const size_t db = dw_size + (size_t)co_b * cob;
    split_sum::sum_rows(ws + db, cols, splits, out + db, cob, 1.0f, t,
                        kThreads);
  }
}

}  // namespace

extern "C" {

// The compiled geometry, for the wrapper's blocking model: the wgrad's
// threads a CTA and lanes a thread, and the rows of the tile's m-tile.
void conv2d_pointwise_geometry(int* threads, int* lanes, int* rows) {
  *threads = kThreads;
  *lanes = kLanes;
  *rows = kRows;
}

// The forward: x, w, the bias and residual (null where absent) into out;
// where the plan asks for GAP, the tiles' sums into partials and the pooled
// features into pooled ([N, Co]), with two zeroed int32 counters an (image,
// output block).  plan: the Geometry fields in order, then the wgmma width,
// the consumer warpgroups, an image's tiles, the images and the dynamic
// shared memory (which must be smem_bytes's).
int conv2d_pointwise_tile(const void* x, const void* w, const void* bias,
                          const void* residual, void* out, void* partials,
                          void* pooled, void* counters, const int* plan,
                          void* stream) {
  Geometry g;
  int* fields = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kGeometryInts; ++i) fields[i] = plan[i];
  const int* more = plan + kGeometryInts;
  const int lanes = more[0], wgs = more[1];
  const int tiles = more[2], n = more[3], smem = more[4];
  const void* kernel = pick_tile(lanes);
  if (kernel == nullptr || wgs < 1 || wgs > kMaxConsumers
      || g.rows != kRows * wgs || g.chunk % 8 != 0 || g.chunk < 8
      || kpad(g) % g.chunk != 0 || g.nsplit < 1
      || (g.nsplit - 1) * lanes >= g.ow || g.nsplit * lanes < g.ow
      || tiles != (g.hw + g.rows - 1) / g.rows
      || (size_t)smem != smem_bytes(g, lanes, wgs)
      || (g.gap && (!partials || !pooled || !counters))) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles == 0 || n == 0) return 0;
  int slot = 0;
  for (int l = lanes; l > 8; l /= 2) ++slot;
  cudaError_t err = allow_smem(kernel, slot, smem);
  if (err != cudaSuccess) return (int)err;
  const float* x_f = (const float*)x;
  const float* w_f = (const float*)w;
  const float* b_f = (const float*)bias;
  const float* r_f = (const float*)residual;
  float* out_f = (float*)out;
  float* p_f = (float*)partials;
  float* pool_f = (float*)pooled;
  int* c_i = (int*)counters;
  void* args[] = {&x_f, &w_f, &b_f, &r_f, &out_f, &p_f, &pool_f, &c_i, &g};
  err = cudaLaunchKernel(kernel, dim3(tiles, g.oblk * g.nsplit, n),
                         dim3(kWarpgroup * (wgs + 1)), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wgrad: `splits` position shares of each (Ci block, Co block) into
// `ws` [splits, |dw| + |db|], summed by each block's last CTA into `out`
// ([|dw| + |db|]); `counters`: a zeroed int32 a block.
int conv2d_pointwise_wgrad(const void* x, const void* g, const void* z,
                           void* ws, void* out, void* counters, int n,
                           int ciblk, int cib, int coblk, int cob, int hw,
                           int positions, int splits, int act, int with_db,
                           int smem_bytes, void* stream) {
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
      (const float*)x, (const float*)g, (const float*)z, (float*)ws,
      (float*)out, (int*)counters, n, ciblk, cib, coblk, cob, hw, positions,
      splits, act, with_db);
  return (int)cudaGetLastError();
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
