#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure raises and exits non-zero,
and no phase catches its own failure:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build every CUDA source in ``src/repro_torch/csrc`` (one nvcc each, all
   started together; sm_90a), printing each kernel's registers and spills,
   and the count of ``HGMMA`` (wgmma) instructions in each function of the
   flash-attention library's SASS where the toolkit has ``cuobjdump``: the
   bf16 kernel and the f32 tensor-core kernel (``flash_fwd_tf32``) must
   have some, and every instance of the latter, of the depthwise wgrad
   (``depthwise_wgrad_kernel``, its bf16 build included) and of the
   depthwise forward's and dgrad's bf16 builds spill nothing; each
   instance of the two
   phase-split dgrad
   kernels (``csrc/dgrad_tile.cuh``) must have tensor-core instructions and
   spill nothing (each line counts HGMMA, HMMA and ``WARPGROUP.DEPBAR``,
   a wait for wgmmas in flight: the bf16 builds, ``dgrad_kernel_bf16`` and
   ``stream_dgrad_kernel_bf16``, must hold fewer waits than HGMMA, and so
   must the dense forwards' bf16 builds, ``fwd_kernel_bf16`` and
   ``stream_fwd_kernel_bf16``), and each instance of the two wgrad kernels
   (``csrc/wgrad_tile.cuh``), of the two dense forwards (``fwd_kernel``,
   ``stream_fwd_kernel``, on ``csrc/fwd_tile.cuh``) and of the pointwise
   forward's tile (``pointwise_tile_kernel``, its bf16 build included)
   HGMMA (wgmma) instructions and no spill (the pointwise dgrad and wgrad
   run the dense dgrad's
   ``dgrad_kernel`` and wgrad's ``wgrad_kernel`` at 1x1);
3. hold each kernel against its plain PyTorch version on the card: every
   distinct VGG-16 layer shape at batch 8 that the 224x224 and 160x160
   entries give (the server's two buckets), a small gelu + residual shape
   at stride 2 with ``Cib = 3``, a gelu + residual + GAP shape, and the
   last conv with the GAP folded in, on both routes: its pooled features
   bit for bit ``conv2d_common.gap_finalize`` of the per-tile sums the same
   launch wrote;
4. the full VGG-16 forward (13 convs, 224x224, batch 8) through the
   kernels, with its launch counts, against the plain path's logits;
5. the main path: ``ConvServer`` on buckets 160x160 and 224x224 at batch 8
   serving 24 ragged requests drawn from ``--seed``; every request must end
   OK with the logits of the plain PyTorch forward of its padded image;
6. per-layer times (CUDA events after warm-up): kernel, eager and as a
   CUDA-graph replay, plain version, cuDNN ``F.conv2d`` (f32, TF32 off)
   and the bound (the function's MACs as three TF32 products, the f32 FMA
   bound beside it); per layer the forward's tiles, the function's MACs
   and the tensor-core MACs its tiles issue with their padding share (the
   kernel library's own plan, ``direct_conv2d_fwd_plan``, must equal
   ``core.blocking.fwd_plan``);
7. the backward kernels against their plain versions at batch 8 on every
   distinct VGG-16 layer shape of a 224x224 entry: dgrad with the relu
   prologue (all but conv1_1's shape; its tile printed), wgrad with the
   prologue and ``db`` (all 10, its tiles printed; against f64 sums, twice,
   bit for bit; the worst err/bound printed), the autograd path on a
   small gelu + residual conv at stride 2 with ``Cib = 3`` against torch
   autograd through the plain forward; each wgrad's folded split sum bit
   for bit ``conv2d_common.wgrad_reduce`` of the workspace its launch
   filled, every counter back at 0 (``check_fold``); and the dgrad at
   ``Cob % 4 != 0`` (a pencil of 6, Co = 1000's of 125: the cp.async
   path) against its plain version, timed beside
   ``aten.convolution_backward`` (``c1_dgrads``);
8. the second main path: three AdamW steps (cosine schedule) of the
   full-width VGG-16 at batch 8, 224x224, on images and labels drawn from
   ``--seed``, with the launch counts of a step; step 1's loss and every
   gradient against torch autograd through the plain forward, and the
   parameters after step 3 against a plain-path trainer run in lockstep;
9. backward times: per layer, dgrad and wgrad (its split sum folded in)
   against their plain versions, ``aten.convolution_backward`` and the
   bound (the
   dgrads' and wgrads' at the 3xTF32 split's, the f32 FMA bound printed
   beside it); per wgrad layer its tiles, the function's MACs, the
   tensor-core MACs its tiles issue with their padding share, its shared
   memory, eager and CUDA-graph times and the library time (the kernel
   library's own plan, ``*_wgrad_plan``, must equal
   ``core.blocking.wgrad_plan``) and its split sum (shares, columns, the
   CTAs of a column that sum them); per dgrad layer its stride, phase count and
   tiles, its MACs by phase (the kernel library's own count of the launch
   must equal the blocking model's, and its MACs the function's), the
   tensor-core MACs its tiles issue with their padding share, eager and
   CUDA-graph times and the library time;
   the train step against the plain path's; the step's peak device memory
   beside the bytes it must hold;
10. the separable kernels' forwards against their plain versions at batch
    8 on every distinct MobileNet v1 layer shape of both buckets
    (depthwise at pencils 32, 64 and 128, strides 1 and 2; pointwise, the
    last leg with its GAP), plus small gelu + residual + dilation-2
    depthwise and gelu + residual + GAP pointwise shapes; each folded GAP
    bit for bit the finalize of its partials (``check_gap``);
11. the third main path: the full MobileNet v1 forward (224x224, batch 8)
    with its launch counts against the plain forward's logits, then
    ``ConvServer`` on buckets 160 and 224 serving 24 ragged requests, each
    OK with the plain logits of its padded image, and no backward launch;
12. the separable backward kernels against their plain versions at batch
    32 on every distinct MobileNet shape (both wgrads against f64 sums and
    twice, bit for bit, and their folded split sums as phase 7's), the
    depthwise dgrad's and wgrad's other paths (the tap loop at dilation 2,
    stride 3 and 5x5, Cb = 3, a pencil of 6, pads (1, 1) and (0, 1) at
    stride 2; the wgrad as at the MobileNet shapes), and the autograd
    path of a small gelu block with a residual against torch autograd
    through the plain forward;
13. the fourth main path: three AdamW steps of the full-width MobileNet v1
    at batch 32, 224x224, held to phase 8's rules, with the launch counts
    of a step;
14. per-leg forward (batch 8), dgrad and wgrad (batch 32) times of the
    depthwise and pointwise legs: eager and as a CUDA-graph replay (device
    alone), the wrapper's host µs a call (``HOST_CALLS`` calls, no
    synchronise), beside the plain version, the library call (eager and
    as a CUDA-graph replay) and the bound (the pointwise forward's and
    dgrad's at the 3xTF32 split's, the f32 FMA bound beside it, with the
    tensor-core MACs their tiles issue and the padding share; the pointwise
    wgrad's likewise, its kernel library's plan checked against the
    model's; each wgrad's split sum and the rows its summing CTA reads; the
    depthwise dgrad's phases and the taps it runs, the depthwise wgrad's
    items and items a CTA); the train
    step against the plain trainer's, and one kernel step under
    ``torch.profiler``: its device-busy share and kernels by device time;
    the step's peak device memory beside the bytes it must hold;
15. the streamed (halo-ring) kernels against their plain versions: the
    forward at every distinct VGG-16 shape of both buckets at batch 8
    (also against the window kernel: bit for bit where both choosers take
    the same channel chunk, else within 1e-5 of max|y|, with a count of
    each), a small gelu + residual + GAP shape at stride 2 with ``Cib =
    3``, and the dgrad and wgrad at 224 with the relu prologue and ``db``
    (the wgrad against f64 sums, twice, bit for bit, the worst err/bound
    printed, its folded split sum as phase 7's); each layer's streamed
    tiles are printed; the streamed dgrad at ``Cob % 4 != 0`` as phase 7's;
16. the fifth and sixth main paths: VGG-16 through ``ConvServer(context=
    ConvContext(stream=True))``, 24 requests each OK with the plain logits,
    then three AdamW steps at batch 8 on the streamed route held to phase
    8's rules; both runs launch the streamed kernels and no window forward,
    dgrad or wgrad;
17. per-layer and summed times of the three streamed kernels, eager and as
    a CUDA-graph replay, beside the window kernels, the plain versions,
    cuDNN (TF32 off) and the bound (each as in phases 6 and 9, with the
    forward's tiles and the dgrad's phases, MACs and issued MACs, and both
    forwards' and both wgrads' plans checked against the model, their
    issued MACs and padding); the
    streamed train step against the
    window step and the plain step; its peak device memory beside the bytes
    it must hold;
18. the language models' kernels against their plain versions: flash
    attention (``csrc/flash_attention.cu``) at h2o-danube-1.8b's prefill
    shape (B 2, S 2048, 32 q-heads over 8 KV heads, Dh 80) in f32 and bf16,
    a window that bites (S 1024, window 256), softcap 50, non-causal, MQA,
    Dh 128, deepseek-coder's grouping (G 7, Dh 128, bf16), ragged S 1000,
    ``kv_valid`` with positions that are not ``arange``, f32 past the
    tensor-core kernel (Dh 256 with ``kv_valid`` and a window, and K/V
    expanded over the KV heads with stride 0), and the TPU kernel's ``[B, H,
    S, Dh]`` entry on strided views in bf16 and f32, each line naming the
    kernel that ran, as the wrapper counted its launch (bf16, f32 ``tf32``
    on the tensor cores, ``fma`` on CUDA cores); it fails unless all three
    ran; the causal conv1d (``csrc/conv1d_depthwise.cu``) at
    mamba2-780m's shape (B 2, L 2048, 3328 channels, K 4, bias) on the
    strided ``in_proj`` slice, a contiguous tensor, a ragged L and the
    blocked layout, f32 and bf16;
19. h2o-danube-1.8b at full width and depth, weights from ``--seed``: (a)
    ``make_prefill_step`` at B 2, S 2048 in f32 through the kernels (24
    flash launches) against the plain path, then each layer's attention
    inputs through the kernel against the plain version, and with the
    scores scaled to the reference init's size against f64; (b)
    ``decode_step`` over the first 32 tokens against the prefill; (d) the
    ``ContinuousBatcher`` (batch 4, cache 128) answering 8 requests of 8-48
    prompt tokens and 16 new tokens each, with no kernel launch while it
    serves, every first token checked against the kernel prefill: its
    argmax where the top-2 gap clears a tolerance (twice the decode path's
    measured distance from the prefill, and (a)'s tolerance), else a logit
    within that tolerance of the max (with the count of vocabulary tokens
    that band admits); (c) the published bf16 config's
    prefill against its plain path, within 4 times a control's reading
    (the plain path with the kernel's sums in another order) and each
    layer's call again on its own bf16 inputs, its device time split by
    kernel under ``torch.profiler``, and (d) again in bf16;
20. mamba2-780m, the same checks (48 conv1d launches a forward; each
    layer's conv1d on its own inputs; no f64 check), and (e), a
    measurement: layer by layer, the distance of the bf16 kernel and bf16
    plain prefills' hidden states from the f32 plain prefill's, relative to
    its max, with the port's init of ``a_log``/``dt_bias`` (Mamba-2's
    published one: A in [1, 16], dt in [1e-3, 1e-1]) and again with the
    reference's (both 0);
21. times: each kernel at its model's shape, eager and as a CUDA-graph
    replay, beside its plain version, the library call
    (``scaled_dot_product_attention``, the faster of GQA and K/V repeated
    beforehand, both printed; ``F.conv1d``) and the bound (flash:
    the function's 4 Dh FLOPs an unmasked pair, in f32 as three TF32
    products with the f32 FMA bound beside it; for bf16 the 6 Dh that its
    split P @ V executes is printed beside it); per
    model, prefill ms and tokens/s in f32 and bf16, the plain path's
    prefill, decode ms a step at batch 4, and peak device memory beside
    the parameter and cache bytes;
22. the bf16 build of the dense forward tile (``fwd_kernel_bf16``,
    ``stream_fwd_kernel_bf16``) against the plain version under ``BF16``
    at every VGG-16 shape of both buckets and at gelu + residual + GAP
    shapes with ``Cib = 3`` and 64 (one bf16 ulp plus ``BF16_FWD_REL`` of
    max|y|; at every VGG-16 shape two runs bit for bit, and the kernel
    library's ``*_plan``, its ring slots included, ``core.blocking``'s);
    the GAP replay (``conv2d_common.gap_replay``) bit for bit the
    kernel's pooled features on its own stored map, f32 and bf16, both
    routes; the last main paths: VGG-16 (phase 4's weights) served in
    bf16 through ``ConvServer``, window then ``stream=True``, 24 requests
    each OK with only the bf16 forward launched, the served logits within
    twice the bf16 plain forward's distance from the f32 plain logits;
    peak device memory beside ``memory_model``'s bytes held;
    ``assert_zero_overhead`` on the served blocked tensors; im2col and FFT
    at conv5_2 against ``F.conv2d``; a small ``ResidualBlock`` stack's
    forward (f32, bf16) and one train step through the kernels against the
    plain path; per-layer and summed bf16 times (eager, CUDA graph, plain,
    cuDNN bf16 channels-last, the bound at the bf16 peak, the weight
    cast; MobileNet v1's ``conv1`` after VGG-16's 13, outside their sums)
    and the whole bf16 forward;
23. bf16 training: the bf16 builds of the dgrad and wgrad tiles
    (``dgrad_kernel_bf16``, ``stream_dgrad_kernel_bf16``,
    ``wgrad_kernel_bf16``, ``stream_wgrad_kernel_bf16``; phase 2 prints
    their registers, spills and HGMMA under the f32 kernels' names) against
    their plain versions under ``BF16`` at every VGG-16 layer at batch 8 on
    both routes (dx within one bf16 ulp plus ``BF16_FWD_REL`` of max|dx|,
    two runs bit for bit; dw and db against f64 sums of the same bf16
    operands within ``WGRAD_REL`` of sum|x dz|, each folded sum bit for bit
    its workspace's in-order reduce with the counters at 0; each kernel's
    plan equal to the blocking model's) and the bf16 dz pass
    (``dz_kernel_bf16``: dz bit for bit ``cotangent_prologue``, its folded
    db bit for bit its reduce; each bf16 dgrad on its dz bit for bit the
    same dgrad with its prologue; the wgrad lines time the pass and the
    GEMM together, the pass apart too), the dgrad at Cob 6 and 125 beside
    cuDNN bf16, and the autograd path (relu and gelu, a residual and GAP,
    Cib 3 and 64) against the same function on the CPU's plain versions;
    the last main
    paths: VGG-16 (phase 4's weights as f32 masters) trained in bf16, 3
    AdamW steps at batch 8, window then ``stream=True``, only the bf16
    builds launched, held to a plain bf16 trainer (the same training path
    on the plain versions, a CPU copy) and an f32 plain trainer (autograd
    through the plain forward): step 1's loss within 1e-2 of the plain
    bf16 path's, each gradient within ``BF16_TOL`` of its max of the plain
    bf16 path's (or twice that path's own max distance from the f32
    gradient, where that is larger) and no further from the f32
    gradients (relative L2) than twice the plain bf16 path; after 3 steps
    no more elements off the f32 trainer's by ``PARAM_STEP`` of the
    summed learning rate than twice the plain bf16 trainer's, none off the
    plain bf16 trainer's by more than 2.1 times it; per
    layer and summed times (eager, CUDA graph, plain, cuDNN's
    ``convolution_backward`` in bf16 channels-last, the bound at 989e12
    against the bf16 bytes), the bf16 train steps beside the f32 one, and
    peak memory beside ``memory_model.bytes_precision_split`` and the
    largest dz (``bytes_backward_transient``);
24. MobileNet v1 in bf16: the separable family's bf16 builds
    (``pointwise_tile_kernel_bf16``, ``depthwise_{fwd,dgrad,wgrad}_
    kernel_bf16``, and the dense ``dgrad_kernel_bf16`` and
    ``wgrad_kernel_bf16`` at 1x1 for the pointwise backward) against
    their plain versions under ``BF16``: the forwards at batch 8 at every
    MobileNet shape of both buckets (the last pointwise leg with its GAP
    folded, bit for bit its finalize; gelu, a residual and GAP at Cb 3, 6
    and 8), the backwards at batch 32 at every shape of the 224 bucket and
    on the depthwise tap loop's paths (dilation 2, stride 3, 5x5, Cb 3, a
    pencil of 6, pads (1, 1) and (0, 1)), with phase 23's tolerances, two
    runs bit for bit and the folded sums bit for bit their reduce, the
    pointwise dgrad on the dz pass's dz bit for bit itself with its
    prologue; the
    pointwise backward's plans equal the blocking model's, and each C
    entry refuses a plan whose shared memory is not its kernel's; fp16
    refused; the last main paths: MobileNet v1 (phase 11's weights)
    served in bf16 through ``ConvServer``, 24 requests each OK with only
    bf16 forwards launched, the logits within twice the bf16 plain
    forward's distance from the f32 plain logits; the whole forward in
    bf16 beside f32; MobileNet v1 trained in bf16, 3 AdamW steps at batch
    32, held to phase 23's rules (``bf16_trainers``); per-leg and summed
    times (eager, CUDA graph, plain, cuDNN bf16 channels-last eager and
    graph, the bound at 989e12 against the bf16 bytes); the bf16 step
    beside the f32 step; peak memory beside
    ``memory_model.bytes_precision_split``.

25. grouped and dilated geometry on the window forward, f32 and bf16
    (``grouped_dilated_phases``): AlexNet's two-tower layers
    (``configs.cnn.alexnet_blocked``, lane 64) at batch 8 and its conv4/
    conv5 at lane 128 (Cib 96, Cob 96/128), DeepLab-LargeFOV's conv5
    (dilation 2) and fc6 (dilation 12) on their 41x41 map, groups 4 with
    dilation 2 at stride 2, dilation 3 at stride 2: each kernel against its
    plain version (phases 3 and 22's tolerances), two runs bit for bit, the
    GAP of conv5 folded (``check_gap``); AlexNet served by ``ConvServer``
    (24 requests, batch 8, 227x227) in f32 (logits within ``LOGIT_RTOL``)
    and bf16 (twice the bf16 plain forward's distance), only the forward
    kernel of each build launched; per layer eager and graph ms, plain ms,
    cuDNN ``F.conv2d(groups=, dilation=)``, the bound and its share, the
    kernel's MAC count equal to the grouped function's and the padding its
    tiles issue, at Cob 48/96 the chosen TMA split beside the best two-way
    split on 2-byte copies; the AlexNet forward; a forced stream and
    autograd on a grouped layer raise.

27. the bf16 window forward and wgrad where AlexNet lost
    (``narrow_rows_phases``): the narrow rows (``csrc/narrow_rows.cuh``: a
    filter row's (dw, c) run a 128-byte operand row, the kernels
    ``fwd_kernel_bf16_narrow`` and ``wgrad_kernel_bf16_narrow``) at
    AlexNet's conv1, VGG-16's conv1_1, MobileNet's conv1, Cib 3 at 7x7
    stride 2 and Cib 8 at 5x5, and the wgrad's x by element-strided TMA
    boxes at AlexNet's conv2-3 and odd widths (31 at stride 2, Cib 64 and
    48), each against its plain version (phase 23's rules, two runs bit for
    bit, conv1's GAP folded), each plan equal to the blocking model's with
    the issued MACs beside the function's; per layer eager and graph ms
    beside cuDNN bf16, the bound and its share; AlexNet's (bf16 and f32),
    VGG-16's and MobileNet's train steps at batch 32 under
    ``torch.profiler`` and on the host clock, the bf16 ones launching the
    narrow rows at the first conv.

``[time]`` lines say when each phase ended.  The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints neither.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# f32 kernel vs f32 plain version: the same products summed in another order
# (per tap and channel chunk in registers vs per tap einsum), over up to
# 9 * 512 = 4608 terms of O(1) inputs; f32 rounding stays far below 1e-4.
TOL = {"atol": 1e-4, "rtol": 1e-4}
# logits after 13 layers and the head, relative to the largest logit
LOGIT_RTOL = 1e-3
# NVIDIA H100 SXM data sheet: f32 (non-tensor) peak and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# wgrad vs its f64 plain version: each element sums N*Ho*Wo (up to 401,408
# at conv1_2) products in f32, in shares of a few thousand and then across
# shares.  The bound scales with the sum's length through its absolute
# terms: |kernel - f64| <= WGRAD_REL * sum|x * dz| (about 84 f32 ulps of
# that sum; a missing share or tap would be off by ~1e-3 of it).
WGRAD_REL = 1e-5
# step-1 gradients, kernel path vs torch autograd through the plain forward:
# per tensor, relative to its largest value.  The two forwards sum in other
# orders, so wherever |z| is within f32 rounding of 0 their relu masks can
# differ, and each such flip changes one cotangent element by its whole
# value; 12 layers of dgrad carry the flips down, so the first layers'
# gradients differ by ~1e-3 of their largest value (2.2e-3 at conv1_1 on
# the H100).  A wrong tap, pad or reduction moves them by O(1).
GRAD_RTOL = 1e-2
# parameters after 3 AdamW steps, kernel trainer vs plain trainer.  Adam
# moves an element by lr * m / sqrt(v), ~lr * sign(g) whatever |g| is, so
# an element whose gradient is within the two paths' difference (up to
# ~2e-3 of a tensor's largest gradient, above) of 0 steps differently, by
# up to 2 * sum(lr).  The check: at most PARAM_FRAC of all elements differ
# by more than PARAM_STEP * sum(lr), and none by more than 2.1 * sum(lr).
# A wrong gradient moves most elements apart.
PARAM_FRAC, PARAM_STEP = 1e-2, 0.1
# peak learning rate of the 3 steps: Adam's sign-like first step at 1e-3
# throws a random, unnormalized VGG-16 into a loss of ~350, which magnifies
# every difference between the two trainers; 1e-5 keeps the steps tame
TRAIN_LR = 1e-5
KERNEL_SOURCE = "src/repro_torch/csrc/direct_conv2d_fwd.cu"
BWD_SOURCE = "src/repro_torch/csrc/direct_conv2d_bwd.cu"
TPU_KERNEL = "src/repro/kernels/direct_conv2d.py:102"
TPU_DGRAD = "src/repro/kernels/direct_conv2d.py:138"
TPU_WGRAD = "src/repro/kernels/direct_conv2d.py:175"
# the dz pass replaces no kernel of its own: the prologue both of them run
TPU_PROLOGUE = "src/repro/kernels/conv2d_common.py:313 (cotangent_prologue)"
BATCH, ENTRY = 8, 224
BUCKETS = ((160, 160), (224, 224))
SOURCES = ("direct_conv2d_fwd", "direct_conv2d_bwd", "conv2d_pointwise",
           "conv2d_depthwise", "conv2d_stream", "flash_attention",
           "conv1d_depthwise")
# MobileNet v1: served at batch 8, trained at batch 32
MB_BATCH, MB_TRAIN_BATCH = 8, 32
PW_SOURCE = "src/repro_torch/csrc/conv2d_pointwise.cu"
DW_SOURCE = "src/repro_torch/csrc/conv2d_depthwise.cu"
# the TPU kernel each new kernel replaces; the depthwise dgrad is the
# reference's forward body run on the dilated, padded cotangent
TPU_SEPARABLE = {
    "conv2d_pointwise_fwd": "src/repro/kernels/conv2d_pointwise.py:56",
    "conv2d_pointwise_dgrad": "src/repro/kernels/conv2d_pointwise.py:87",
    "conv2d_pointwise_wgrad": "src/repro/kernels/conv2d_pointwise.py:114",
    "conv2d_depthwise_fwd": "src/repro/kernels/conv2d_depthwise.py:72",
    "conv2d_depthwise_dgrad": "src/repro/kernels/conv2d_depthwise.py:72",
    "conv2d_depthwise_wgrad": "src/repro/kernels/conv2d_depthwise.py:105",
}
STREAM_SOURCE = "src/repro_torch/csrc/conv2d_stream.cu"
# the streamed forward's TPU kernel is also its dgrad (transpose=True)
TPU_STREAM = "src/repro/kernels/conv2d_stream.py:78"
TPU_STREAM_WGRAD = "src/repro/kernels/conv2d_stream.py:306"
# the language models (phases 18-21)
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
CONV1D_SOURCE = "src/repro_torch/csrc/conv1d_depthwise.cu"
TPU_FLASH = "src/repro/kernels/flash_attention.py:33"
FLASH_BF16_KERNEL = "flash_fwd_wgmma"    # the bf16 kernel's name
FLASH_F32_KERNEL = "flash_fwd_tf32"      # the f32 tensor-core kernel's
DW_WGRAD_KERNEL = "depthwise_wgrad_kernel"
TPU_CONV1D = "src/repro/kernels/conv1d_depthwise.py:27"
LM_BATCH, LM_SEQ = 2, 2048             # the prefill: batch 2, 2048 tokens
SERVE_BATCH, SERVE_CACHE = 4, 128      # the batcher's slots and cache
SERVE_REQUESTS, SERVE_NEW = 8, 16      # requests, new tokens each
SERVE_PROMPT_MAX = 48                  # prompts of 8-48 tokens
DECODE_CHECK = 32                      # decode steps held to the prefill
# a kernel vs its plain version in the working dtype: the same f32 sums in
# another order (attention: 2048 terms of O(1), then the softmax), plus one
# bf16 ulp for bf16 outputs (see compare_lm)
KERNEL_REL, KERNEL_ABS = 1e-5, 1e-6
# decode vs the prefill's logits: the reference's own tolerance
# (tests/test_decode_consistency.py)
DECODE_TOL = 2e-3
# 19(a) layer by layer, at scores as large as the reference's init makes
# them (the softmax nearly an argmax, where f32 rounding of the scores moves
# the output): the kernel's distance to the same attention computed in f64
# within EXACT_MULT times the plain version's, plus the kernel tolerance
EXACT_MULT = 4
# 19(c)/20(c): the bf16 prefill through the kernels within BF16_CONTROL_MULT
# times the reading of a control, the plain path with the kernel's own sums
# in another order (see lm_phases)
BF16_CONTROL_MULT = 4
# the bf16 forwards against their plain versions under BF16: one bf16 ulp
# of each element's magnitude (the two round f32 sums of the same bf16
# products, in other orders, once to bf16) plus this share of max|y|
BF16_FWD_REL = 1e-5
# bf16 training: each step-1 gradient of the kernels against the plain bf16
# path's, relative to its largest value (the reference's BF16_TOL,
# tests/test_precision.py), or twice the plain bf16 path's own distance
# from the f32 gradients where that is larger: at full VGG-16 depth from a
# random start the first layers' gradients are a small rest of large
# cancelling sums, and a bf16 path ends ~15 % of their max from the f32
# ones, and ~14 % from another bf16 path that sums in another order (H100,
# phase 23); a wrong tap or rounding moves them by O(1)
BF16_TOL = 3e-2
# NVIDIA H100 SXM data sheet: dense bf16 and TF32 tensor-core peaks
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# the dgrad kernels' functions (csrc/dgrad_tile.cuh), whose 3xTF32 split
# executes three TF32 products for each of the function's MACs
DGRAD_KERNELS = {"direct_conv2d_bwd": "dgrad_kernel",
                 "conv2d_stream": "stream_dgrad_kernel"}
# the bf16 builds of the two dgrads (dgrad_kernel_bf16,
# stream_dgrad_kernel_bf16): wgmma from shared memory, a filter row's
# issued back to back
BF16_DGRAD_KERNEL = "dgrad_kernel_bf16"
# the bf16 builds of the two dense forwards (fwd_kernel_bf16,
# stream_fwd_kernel_bf16): the same design, a filter row's wgmmas issued
# back to back
BF16_FWD_KERNEL = "fwd_kernel_bf16"
# the bf16 build of the pointwise forward (pointwise_tile_kernel_bf16): a
# stage's wgmmas issued back to back, one wait a stage
BF16_PW_KERNEL = "pointwise_tile_kernel_bf16"
# the wgrad kernels' functions (csrc/wgrad_tile.cuh), 3xTF32 as the dgrads
WGRAD_KERNELS = {"direct_conv2d_bwd": "wgrad_kernel",
                 "conv2d_stream": "stream_wgrad_kernel"}
# the pointwise forward's tensor-core tile, 3xTF32 as well
PW_TILE_KERNELS = {"conv2d_pointwise": "pointwise_tile_kernel"}
# the dense forwards' tile (csrc/fwd_tile.cuh), 3xTF32 as well
FWD_TILE_KERNELS = {"direct_conv2d_fwd": "fwd_kernel",
                    "conv2d_stream": "stream_fwd_kernel"}
# calls a wrapper's host cost is averaged over (time.perf_counter, no
# synchronise): few enough that the launch queue never fills and holds the
# host back to the device's pace
HOST_CALLS = 200
LAYER_NAMES = [f"conv{st}_{k}" for st, k in
               ((1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3),
                (4, 1), (4, 2), (4, 3), (5, 1), (5, 2), (5, 3))]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def compare(label: str, got, want, atol: float, rtol: float) -> float:
    """Print and check max abs/rel error; -> max abs error."""
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got.double() - want.double()).abs()
    max_abs = err.max().item()
    max_rel = (err / want.double().abs().clamp_min(1e-6)).max().item()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    print(f"[check] {label}: max_abs_err={max_abs:.3e} max_rel_err="
          f"{max_rel:.3e} tol=atol {atol:g} + rtol {rtol:g} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return max_abs


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed between two events, so the host's launch overhead (the
    Python wrappers, ctypes) is not in it.  The warm-up runs on the stream
    the graph is captured on, so that the split sums' counters the graph
    keeps are that stream's own (``kernels.split_sum``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """The host's µs a call of ``fn``: ``calls`` calls with no synchronise
    between them, on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tf32x3_bound(flops: float, nbytes: float):
    """The tensor-core dgrads' and wgrads' bound: the function's FLOPs at
    the better of the f32 FMA peak and the 3xTF32 split's (three TF32
    products a MAC on the tensor cores), against its bytes -> (ms, kind,
    the f32 FMA bound's ms)."""
    f32 = bound(flops, nbytes)
    return (*min(f32, bound(3 * flops, nbytes, PEAK_TF32_FLOPS)), f32[0])


def device_split(fn, top: int | None = 8):
    """One call of ``fn`` under ``torch.profiler``, recorded after a call in
    the profiler's warm-up cycle (a profile that records from its first
    call can miss the kernels launched as it starts): (wall ms, device-busy
    ms, the ``top`` kernels by device time, all of them with None, as
    (name, ms, launches)), or None where the profiler records no device
    time.  ``fn`` runs three times.  The wall time includes the profiler's
    own host cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    saved, wall = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: saved.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            prof.step()
    # kernels only: an operator's row repeats its kernels' device time, and
    # the step's own annotation spans it on the device
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in (saved[0] if saved else [])
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[1])
    if not rows:
        return None
    return wall[1], sum(r[1] for r in rows), rows[:top]


def port_rows(rows) -> int:
    """The launches of the port's own kernels (each in its source's
    anonymous namespace) among a profile's kernel rows."""
    return sum(c for key, _, c in rows
               if key.removeprefix("void ").startswith(
                   "(anonymous namespace)::"))


def sass_counts(sass: str) -> dict:
    """Per function of a ``cuobjdump -sass`` listing: (HGMMA: wgmma, HMMA:
    mma.sync, WARPGROUP.DEPBAR: a wait for wgmmas in flight)."""
    import re
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0, 0]
        elif fn is not None and "HGMMA" in line:
            counts[fn][0] += 1
        elif fn is not None and "HMMA" in line:
            counts[fn][1] += 1
        elif fn is not None and "WARPGROUP.DEPBAR" in line:
            counts[fn][2] += 1
    return {fn: tuple(n) for fn, n in counts.items()}


def hgmma_counts(lib: Path):
    """``sass_counts`` of ``lib``'s SASS, by ``cuobjdump -sass``; None when
    the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    return sass_counts(subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True,
        check=True, timeout=300).stdout)


def ptxas_report(log: str) -> dict:
    """Per compiled function in an ``nvcc -Xptxas -v`` log: (registers,
    spill store bytes, spill load bytes)."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn] = [0, int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in out:
            out[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def fwd_work(x, w, h: int, stride: int, streamed: bool):
    """A 3x3 SAME forward of ``x``, ``w`` over an ``h x h`` input as its
    kernel tiles it -> (its ``FwdBlocking``, its ``FwdPlan``, the function's
    MACs).  Fails unless the kernel library's own count of the launch
    (``*_plan``, the C++ tile geometry) equals the blocking model's
    (``core.blocking.fwd_plan``), and its MACs equal the function's."""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.kernels.direct_conv2d import fwd_launch, fwd_plans
    kernel, model = fwd_plans(x, w, stride, "SAME", streamed=streamed)
    route = "streamed" if streamed else "window"
    if kernel != model:
        fail(f"{route} forward at {h}x{h} s{stride}: the kernel's plan "
             f"{kernel} != the blocking model's {model}")
    spec = ConvSpec.make(x.shape[0], h, h, x.shape[1] * x.shape[4],
                         w.shape[0] * w.shape[5], 3, 3, stride, "SAME")
    fn_macs = spec.flops() // 2
    if kernel.function_macs != fn_macs:
        fail(f"{route} forward at {h}x{h} s{stride}: its tiles take "
             f"{kernel.function_macs} MACs, the function {fn_macs}")
    blk = fwd_launch(spec, x.shape[4], w.shape[5], 0, False, streamed).blk
    return blk, kernel, fn_macs


def fwd_text(blk, plan, macs: int, graph: float) -> str:
    """A forward's tiles and MACs as one phrase of a log line."""
    shape = (f"bands of {blk.strips} strips of {blk.hso}x{blk.tw}"
             if blk.strips > 1 else f"tiles of {blk.th}x{blk.tw}")
    return (f"{plan.tiles} {shape} output positions an image, "
            f"{blk.wgs} consumer warpgroup(s), lanes {blk.lanes} x "
            f"{blk.nsplit} split(s), chunk {blk.chunk}, shared memory "
            f"{plan.smem} B; function MACs {macs}, tensor-core MACs issued "
            f"{plan.issued_macs} (three products each; padding "
            f"{100 * plan.padding_share:.1f} %); "
            f"{macs / 1e6 / graph:.1f} function GMAC/s on the device")


def dgrad_work(g, w, z, h: int, stride: int, streamed: bool):
    """A 3x3 SAME relu dgrad of ``g``, ``w``, ``z`` over an ``h x h``
    input as its kernel splits it -> (phases, its ``DgradPlan``, the
    function's MACs).  Fails unless the kernel library's own count of the
    launch (``*_dgrad_plan``, the C++ tile geometry) equals the blocking
    model's (``core.blocking.dgrad_plan``), and its MACs by phase equal the
    function's."""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.kernels.direct_conv2d import dgrad_plans
    kernel, model = dgrad_plans(g, w, (h, h), stride, "SAME", z, "relu",
                                streamed=streamed)
    route = "streamed" if streamed else "window"
    if kernel != model:
        fail(f"{route} dgrad at {h}x{h} s{stride}: the kernel's plan "
             f"{kernel} != the blocking model's {model}")
    fn_macs = ConvSpec.make(g.shape[0], h, h, w.shape[1] * w.shape[4],
                            g.shape[1] * g.shape[4], 3, 3, stride,
                            "SAME").flops() // 2
    if kernel.function_macs != fn_macs:
        fail(f"{route} dgrad at {h}x{h} s{stride}: its phases take "
             f"{kernel.function_macs} MACs, the function {fn_macs}")
    return stride * stride, kernel, fn_macs


def wgrad_work(x, g, z, h: int, stride: int, streamed: bool):
    """A 3x3 SAME relu wgrad of ``x``, ``g``, ``z`` over an ``h x h`` input
    as its kernel tiles it -> (its ``WgradPlan``, the function's MACs).
    Fails unless the kernel library's own count of the launch
    (``*_wgrad_plan``, the C++ tile geometry) equals the blocking model's
    (``core.blocking.wgrad_plan``), and its MACs equal the function's."""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.kernels.direct_conv2d import wgrad_plans
    kernel, model = wgrad_plans(x, g, 3, 3, stride, "SAME", z, "relu",
                                streamed=streamed)
    route = "streamed" if streamed else "window"
    if kernel != model:
        fail(f"{route} wgrad at {h}x{h} s{stride}: the kernel's plan "
             f"{kernel} != the blocking model's {model}")
    fn_macs = ConvSpec.make(x.shape[0], h, h, x.shape[1] * x.shape[4],
                            g.shape[1] * g.shape[4], 3, 3, stride,
                            "SAME").flops() // 2
    if kernel.function_macs != fn_macs:
        fail(f"{route} wgrad at {h}x{h} s{stride}: its tiles take "
             f"{kernel.function_macs} MACs, the function {fn_macs}")
    return kernel, fn_macs


def tiles_text(blk) -> str:
    """A wgrad blocking as one phrase of a log line."""
    return (f"tiles of {blk.th}x{blk.tw} output positions (K {blk.kpos}), "
            f"{blk.wgs} consumer warpgroup(s) of {blk.mpw} m-tile(s), lanes "
            f"{blk.lanes}, {blk.groups} m-tile group(s) x {blk.splits} "
            f"share(s), window {blk.hwin}x{blk.wwin}")


def mostly(rows) -> str:
    """The kind of bound that makes up most of the summed ``(ms, kind)``."""
    by_ops = sum(ms for ms, kind in rows if kind == "operations")
    return "operations" if 2 * by_ops >= sum(ms for ms, _ in rows) else "bytes"


# the worst err/bound of each compare_scaled label, for the phases' summaries
RATIOS = {}


def compare_scaled(label: str, got, want, scale, rel: float) -> float:
    """Check ``|got - want| <= rel * scale`` elementwise (all f64); -> max
    abs error.  The worst err/bound goes to ``RATIOS[label]``."""
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got.double() - want).abs()
    ratio = (err / (rel * scale).clamp_min(1e-300)).max().item()
    RATIOS[label] = ratio
    ok = bool((err <= rel * scale).all())
    print(f"[check] {label}: max_abs_err={err.max().item():.3e} worst "
          f"err/bound={ratio:.3f} tol=|err| <= {rel:g} * sum|terms| -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its f64 plain version")
    return err.max().item()


def check_fold(label: str, launch, views) -> None:
    """``launch``: a wgrad kernel's ``(ws, out)``, its workspace and the sum
    of the rows its last CTA of each column wrote (a bf16 GEMM's ``ws``
    holds dw's rows alone, ``out``'s db tail is the dz pass's, held by
    ``check_dz_pass``); ``views``: ``(dw, db)`` of another run.
    Fail unless ``out`` is bit for bit ``conv2d_common.wgrad_reduce(ws)``
    and the other run's dw and db, and every counter is back at 0."""
    from repro_torch.core import conv2d_common
    from repro_torch.kernels import split_sum
    ws, out = launch
    want = conv2d_common.wgrad_reduce(ws)
    other = torch.cat([v.reshape(-1) for v in views if v is not None])
    torch.cuda.synchronize()
    if not (torch.equal(out[:want.numel()], want)
            and torch.equal(out, other)):
        fail(f"{label}: the folded sum of {ws.shape[0]} shares differs from "
             "the in-order sum of its workspace rows")
    if any(int(a.count_nonzero()) for a in split_sum.arenas()):
        fail(f"{label}: a split-sum counter was left set")
    print(f"[check] {label}: the folded sum of {ws.shape[0]} shares is bit "
          "for bit the in-order sum of its rows; counters at 0")


def check_dz_pass(label: str, g, z, act, want_db, abs_db) -> float:
    """The bf16 dz pass at ``g``, ``z``: dz bit for bit
    ``conv2d_common.cotangent_prologue`` (relu; one bf16 ulp for gelu, whose
    f32 derivative the kernel and torch round differently), two runs bit
    for bit, db within WGRAD_REL of ``abs_db`` from the f64 ``want_db``,
    the folded db bit for bit the in-order sum of its shares' rows and the
    counters at 0.  -> max abs error of db."""
    from repro_torch.core import conv2d_common
    from repro_torch.kernels import split_sum
    from repro_torch.kernels.direct_conv2d import dz_partials
    (ws, dz, db), (_, dz2, db2) = (dz_partials(g, z, act, True)
                                   for _ in range(2))
    torch.cuda.synchronize()
    want = conv2d_common.cotangent_prologue(g, z, act)
    same = torch.equal(dz, want)
    if act == "gelu":
        bf16_close(f"{label} dz", dz, want)
    elif not same:
        fail(f"{label}: dz differs from cotangent_prologue")
    if not (torch.equal(dz, dz2) and torch.equal(db, db2)):
        fail(f"{label}: two runs differ")
    if not torch.equal(db.reshape(-1), conv2d_common.wgrad_reduce(ws)):
        fail(f"{label}: the folded db of {ws.shape[0]} shares differs from "
             "the in-order sum of its rows")
    if any(int(a.count_nonzero()) for a in split_sum.arenas()):
        fail(f"{label}: a split-sum counter was left set")
    err = compare_scaled(f"bf16 dz pass db {label}", db, want_db, abs_db,
                         WGRAD_REL)
    print(f"[check] {label}: dz {'bit for bit' if same else 'within a bf16 ulp of'} "
          f"cotangent_prologue, db folded from {ws.shape[0]} shares bit for "
          "bit their in-order sum, two runs bit for bit, counters at 0")
    return err


def check_gap(label: str, launch, hw: int, other) -> None:
    """``launch``: a forward's ``(pooled, partials)`` with the GAP folded
    in; ``other``: the pooled features of another run.  Fail unless
    ``pooled`` is bit for bit ``conv2d_common.gap_finalize(partials, hw)``
    and ``other``, and every counter is back at 0."""
    from repro_torch.core import conv2d_common
    from repro_torch.kernels import split_sum
    pooled, parts = launch
    want = conv2d_common.gap_finalize(parts, hw).to(pooled.dtype)
    torch.cuda.synchronize()
    if not (torch.equal(pooled, want) and torch.equal(pooled, other)):
        fail(f"{label}: the folded GAP differs from the in-order finalize "
             f"of its partials {list(parts.shape)}")
    if any(int(a.count_nonzero()) for a in split_sum.arenas()):
        fail(f"{label}: a split-sum counter was left set")
    print(f"[check] {label}: the folded GAP of {parts.shape[2]} tiles is bit "
          "for bit the in-order finalize of its partials; counters at 0")


def split_sum_text(x, g, s, streamed: bool = False) -> str:
    """The split sum a dense wgrad launch folds at these operands: its
    shares, columns and the rows its summing CTA (one a column) reads."""
    from repro_torch.core.blocking import (choose_stream_wgrad_blocking,
                                           choose_wgrad_blocking)
    n, ciblk, _, _, cib = x.shape
    _, coblk, ho, wo, cob = g.shape
    blk = (choose_stream_wgrad_blocking if streamed else
           choose_wgrad_blocking)(n, ho, wo, 3, 3, s, ciblk, cib, coblk, cob,
                                  prologue=True)
    return split_sum_line(blk.splits, blk.groups * ciblk * coblk,
                          min(9 * cib, blk.wgs * blk.mpw * 64) * cob)


def split_sum_line(splits: int, columns: int, floats: int) -> str:
    return (f"split sum: {splits} shares, {columns} columns, the last CTA "
            f"of a column reading {splits * floats * 4 / 1024:.0f} KiB")


def separable_split_sum(leg: str, n: int, ci: int, co: int, ho: int,
                        s: int) -> str:
    """The split sum MobileNet's depthwise (``leg`` "dw") or pointwise
    ("pw", the dense wgrad tile at 1x1) wgrad folds at a block of ``ci ->
    co`` channels, ``ho x ho`` outputs, batch ``n``: its shares, columns and
    the rows a column's summing CTA reads."""
    from repro_torch.core.blocking import (choose_depthwise_wgrad_blocking,
                                           choose_wgrad_blocking)
    cb, cob = min(ci, 128), min(co, 128)
    if leg == "dw":
        # a column is a (channel block, lane group): its tap sums and db
        blk = choose_depthwise_wgrad_blocking(n, ci // cb, ho, ho, cb, 3, 3,
                                              s)
        splits = blk.splits
        columns, floats = blk.columns(ci // cb, cb), 10 * blk.lanes
    else:
        blk = choose_wgrad_blocking(n, ho, ho, 1, 1, 1, ci // cb, cb,
                                    co // cob, cob, prologue=True)
        splits = blk.splits
        columns = blk.groups * (ci // cb) * (co // cob)
        floats = min(cb, blk.wgs * blk.mpw * 64) * cob
    return split_sum_line(splits, columns, floats)


# Cob % 4 != 0 (the dgrads' cp.async path): (n, ci, co, h, stride), a
# pencil of 6 and Co = 1000's pencil of 125
C1_SHAPES = ((8, 64, 6, 56, 2), (8, 512, 1000, 14, 1))


def c1_dgrads(route: str, streamed: bool) -> float:
    """The dgrad of each ``C1_SHAPES`` layer on the ``streamed`` route
    against its plain version, timed beside ``aten.convolution_backward``
    -> the largest abs error."""
    from repro_torch.core import conv2d_common
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked)
    from repro_torch.kernels.direct_conv2d import direct_conv2d_dgrad
    worst = 0.0
    for n, ci, co, h, s in C1_SHAPES:
        cob = 6 if co == 6 else 125
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(co + h)
        cib = min(ci, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        with torch.no_grad():
            z = direct_conv_blocked(x, w, s, "SAME").contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        tag = f"{ci}->{co} {h}x{h} s{s} n{n} relu, Cob {cob}"

        def dgrad():
            return direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z, "relu",
                                       stream=streamed)
        got = dgrad()
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z, "relu")
        torch.cuda.synchronize()
        worst = max(worst, compare(f"{route} dgrad {tag}", got, want, **TOL))
        ho = z.shape[2]
        pad = max((ho - 1) * s + 3 - h, 0)
        xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(n, ci, h, h),
                   (pad // 2, pad - pad // 2, pad // 2, pad - pad // 2))
        w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                  .contiguous())
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        dz_nchw = dz.permute(0, 1, 4, 2, 3).reshape(n, co, ho, ho)
        k_ms, l_ms = time_ms(dgrad), time_ms(
            lambda: torch.ops.aten.convolution_backward(
                dz_nchw.contiguous(), xp.contiguous(), w_oihw, None, [s, s],
                [0, 0], [1, 1], False, [0, 0], 1, [True, False, False]))
        b_ms, b_by, _ = tf32x3_bound(2 * n * ho * ho * 9 * ci * co,
                                     4 * (2 * g.numel() + w.numel()
                                          + x.numel()))
        print(f"[c1] {route} dgrad {tag} (cp.async copies): kernel_ms "
              f"{k_ms:.4f} graph_ms {graph_ms(dgrad):.4f} library_ms "
              f"{l_ms:.4f} (aten.convolution_backward) bound_ms {b_ms:.4f} "
              f"({b_by}, 3xTF32)")
    return worst


def plain_cnn_forward(x, m, precision=None):
    """A ``BlockedCNN``'s forward through the plain conv, dense or
    depthwise (a pointwise leg is a dense 1x1 conv; a ``ResidualBlock``
    adds its input in the epilogue), differentiable by torch autograd and
    independent of the port's plain dgrad and wgrad.  ``precision="bf16"``
    chains the layers in bf16 as the model does under that policy: the
    images cast once, bf16 maps and pooled features, the head cast to
    bf16."""
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.core.layout import nhwc_to_blocked
    from repro_torch.core.precision import resolve_precision
    from repro_torch.nn.conv import DepthwiseSeparableBlock, ResidualBlock
    op = resolve_precision(precision).op_dtype
    hb = nhwc_to_blocked(x.to(op), m.convs[0].in_pencil)
    last = len(m.convs) - 1
    for i, layer in enumerate(m.convs):
        legs = ((layer.dw, layer.pw)
                if isinstance(layer, DepthwiseSeparableBlock) else (layer,))
        for leg in legs:
            hb = direct_conv_blocked(
                hb, leg.w, leg.stride, leg.padding, leg.b, leg.activation,
                precision, groups=leg.groups, dilation=leg.dilation,
                residual=hb if isinstance(leg, ResidualBlock) else None,
                gap=i == last and leg is legs[-1])
    return hb @ m.head.to(hb.dtype)


def _kernel_modules():
    from repro_torch.kernels import (conv2d_depthwise, conv2d_pointwise,
                                     conv2d_stream, direct_conv2d)
    return direct_conv2d, conv2d_depthwise, conv2d_pointwise, conv2d_stream


def reset_all_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def lockstep_train(tag, train_model, n, batch_seed, want_step, dev,
                   context=None, entry=ENTRY):
    """Three AdamW steps (cosine, peak ``TRAIN_LR``) of ``train_model``
    through ``make_train_step`` under ``context``, in lockstep with a
    plain-path trainer from the same start on the same ``n``-image batches
    of ``entry`` pixels (drawn from ``batch_seed``).  Fails unless one step
    launches ``want_step``, step 1's loss and every gradient agree with torch
    autograd through the plain forward (``GRAD_RTOL``), and the parameters
    after step 3 agree with the plain trainer's (``PARAM_FRAC``,
    ``PARAM_STEP``).  -> a namespace: the model, both steps and states, the
    optimizer, the batches and the launches of the three steps."""
    from repro_torch.train.losses import cross_entropy
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainstep import make_train_step

    plain_model = copy.deepcopy(train_model)
    start = {k: p.detach().clone() for k, p in train_model.named_parameters()}
    lr = cosine_schedule(TRAIN_LR, 1, 3)
    opt = AdamW(lr=lr)
    state = opt.init(dict(train_model.named_parameters()))
    plain_state = opt.init(dict(plain_model.named_parameters()))
    step = make_train_step(train_model, opt, context=context)
    plain_params = dict(plain_model.named_parameters())

    def plain_step(st, bt):
        for p in plain_params.values():
            p.grad = None
        logits_p = plain_cnn_forward(bt["images"], plain_model)
        loss_p, _ = cross_entropy(logits_p[:, None, :],
                                  bt["targets"][:, None], 1000)
        loss_p.backward()
        opt.update({k: p.grad for k, p in plain_params.items()}, st,
                   plain_params)
        return loss_p.detach()

    rng = np.random.default_rng(batch_seed)
    batches = [
        {"images": torch.from_numpy(rng.standard_normal(
            (n, entry, entry, 3), dtype=np.float32)).to(dev),
         "targets": torch.from_numpy(rng.integers(0, 1000, n)).to(dev)}
        for _ in range(3)]
    losses, plain_losses = [], []
    reset_all_launches()
    for k, bt in enumerate(batches):
        loss, _ = step(state, bt)
        torch.cuda.synchronize()
        if k == 0:
            per_step = {key: v for key, v in all_launches().items() if v}
            grads = {name: p.grad.clone()
                     for name, p in train_model.named_parameters()}
        losses.append(loss.item())
        plain_losses.append(plain_step(plain_state, bt).item())
        if k == 0:
            print(f"[{tag}] launches in one step: {per_step}")
            if per_step != want_step:
                fail(f"a train step launched {per_step}, expected "
                     f"{want_step}")
            ratios = {}
            for name, p in plain_params.items():
                e = (grads[name] - p.grad).abs().max().item()
                ratios[name] = e / max(p.grad.abs().max().item(), 1e-30)
            print(f"[{tag}] step-1 gradients vs plain autograd, max-err/"
                  "max-value per tensor: " + " ".join(
                      f"{key}={v:.2e}" for key, v in ratios.items()))
            over = {key: v for key, v in ratios.items() if not v <= GRAD_RTOL}
            if over:
                fail(f"step-1 gradients beyond {GRAD_RTOL:g}: {over}")
            print(f"[{tag}] all {len(ratios)} gradients within "
                  f"{GRAD_RTOL:g} of their largest value -> ok")
            if not abs(losses[0] - plain_losses[0]) <= 1e-4 * abs(
                    plain_losses[0]):
                fail(f"step-1 loss {losses[0]} != plain {plain_losses[0]}")
    counts = all_launches()
    print(f"[{tag}] n{n} {entry}x{entry} 1000 classes, AdamW cosine: losses "
          f"{losses} plain path {plain_losses}")
    print(f"[{tag}] launches in 3 steps: {counts}")
    if any(not np.isfinite(v) for v in losses):
        fail("non-finite loss")
    lr_sum = sum(lr(t) for t in (1, 2, 3))
    far, n_el, worst, apart, moved = 0, 0, 0.0, 0.0, 0.0
    for name, p in train_model.named_parameters():
        d = (p.detach() - plain_params[name].detach()).abs()
        far += int((d > PARAM_STEP * lr_sum).sum())
        n_el += d.numel()
        worst = max(worst, d.max().item())
        apart += d.square().sum().item()
        moved += (plain_params[name].detach()
                  - start[name]).square().sum().item()
    print(f"[{tag}] parameters after 3 steps vs the plain trainer: {far} of "
          f"{n_el} elements differ by more than {PARAM_STEP:g} * sum(lr)="
          f"{lr_sum:g}, largest difference {worst:.3e}, |kernel - plain| / "
          f"|plain - start| = {(apart / moved) ** 0.5:.3e} (tol: at most "
          f"{PARAM_FRAC:g} of elements, none above 2.1 * sum(lr))")
    if far > PARAM_FRAC * n_el or worst > 2.1 * lr_sum:
        fail("the kernel trainer drifted from the plain trainer")
    return types.SimpleNamespace(
        model=train_model, step=step, state=state, opt=opt,
        plain_step=plain_step, plain_state=plain_state, batches=batches,
        counts=counts)


def timed_steps(tag, runs, batches):
    """Host-clock ms of four steps of each ``(name, step, state)`` of
    ``runs`` (each ending in a synchronize), taken in turns: first to last,
    then last to first twice, then first to last.  -> {name: [ms]}."""
    times = {name: [] for name, _, _ in runs}
    for k in range(4):
        for name, fn, st in (runs if k % 3 == 0 else runs[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(st, batches[k % 3])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    print(f"[{tag}] step ms (host clock, synchronized): " + " ".join(
        f"{name} {t}" for name, t in times.items()) + "; median " + " ".join(
        f"{name} {np.median(t):.3f}" for name, t in times.items()))
    return times


def step_peak_bytes(tr):
    """Peak device memory of one step of ``tr``'s kernel trainer beyond
    what other phases hold (the plain trainer is dropped first).  -> (peak,
    bytes of the parameters)."""
    tr.plain_step = tr.plain_state = None
    torch.cuda.empty_cache()
    params = list(tr.model.parameters())
    p_bytes = 4 * sum(p.numel() for p in params)
    state_bytes = 3 * p_bytes + sum(4 * p.grad.numel() for p in params
                                    if p.grad is not None)
    other = torch.cuda.memory_allocated() - state_bytes
    torch.cuda.reset_peak_memory_stats()
    tr.step(tr.state, tr.batches[0])
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - other, p_bytes


def nchw(t):
    """A blocked map ``[N, C/Cb, H, W, Cb]`` as the library's NCHW."""
    b_, cblk, hh, ww, cb = t.shape
    return t.permute(0, 1, 4, 2, 3).reshape(b_, cblk * cb, hh, ww)


def oihw(w, groups):
    """A blocked 3x3 depthwise (``groups > 1``: ``[C/Cb, 1, 3, 3, 1, Cb]``)
    or dense weight as the library's OIHW."""
    if groups > 1:
        return w.permute(0, 5, 1, 2, 3, 4).reshape(-1, 1, 3, 3)
    return w.permute(0, 5, 1, 4, 2, 3).reshape(
        w.shape[0] * w.shape[5], w.shape[1] * w.shape[4], w.shape[2],
        w.shape[3])


def mobilenet_blocks(entry: int):
    """(ci, co, stride, h) of MobileNet v1's 13 blocks at an ``entry``-pixel
    input: h the depthwise leg's input extent."""
    from repro_torch.configs.cnn import MOBILENET_V1_BLOCKS, MOBILENET_V1_CONV1
    from repro_torch.core.convspec import ConvSpec
    h = ConvSpec.make(1, entry, entry, *MOBILENET_V1_CONV1[:2], 3, 3,
                      MOBILENET_V1_CONV1[2], "SAME").ho
    out = []
    for ci, co, s in MOBILENET_V1_BLOCKS:
        out.append((ci, co, s, h))
        h = -(-h // s)
    return out


def mobilenet_phases(args, dev, t_start):
    """Phases 10-14: the separable family and MobileNet v1.  -> (the new
    kernels' entries of the ``{"kernels": [...]}`` line, the launches of
    MobileNet's two main-path runs, serving and training, per kernel, the
    served model)."""
    from repro_torch.configs.cnn import (MOBILENET_V1_CONV1,
                                         mobilenet_v1_blocked)
    from repro_torch.core import conv2d_common
    from repro_torch.core.blocking import (choose_depthwise_wgrad_blocking,
                                           choose_pointwise_blocking,
                                           choose_wgrad_blocking,
                                           depthwise_dgrad_taps,
                                           pointwise_issued_macs)
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels import conv2d_depthwise as dwk
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels.direct_conv2d import dgrad_plans, wgrad_plans
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.nn.conv import DepthwiseSeparableBlock
    from repro_torch.serve.scheduler import ConvRequest, Outcome

    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)

    def stamp(phase):
        print(f"[time] phase {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def dw_operands(n, c, h, s, dil=1, cb=None, residual=False):
        cb = cb or min(c, 128)
        x = torch.randn((n, c // cb, h, h, cb), device=dev, generator=gen)
        w = torch.randn((c // cb, 1, 3, 3, 1, cb), device=dev,
                        generator=gen) / 3
        b = 0.1 * torch.randn((c // cb, cb), device=dev, generator=gen)
        spec = ConvSpec.make(n, h, h, c, c, 3, 3, s, "SAME", groups=c,
                             dilation=dil)
        r = (torch.randn((n, c // cb, spec.ho, spec.wo, cb), device=dev,
                         generator=gen) if residual else None)
        return x, w, b, r, spec

    def pw_operands(n, ci, co, h, cib=None, cob=None, residual=False):
        cib, cob = cib or min(ci, 128), cob or min(co, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=dev,
                        generator=gen) / ci ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        r = (torch.randn((n, co // cob, h, h, cob), device=dev,
                         generator=gen) if residual else None)
        return x, w, b, r

    # the f32 kernels' names (phase 24 holds the bf16 builds)
    f32_names = [k for mod in (pwk, dwk) for k in mod.LAUNCHES
                 if not k.endswith("_bf16")]
    err = {k: 0.0 for k in f32_names}

    def track(kernel, value):
        err[kernel] = max(err[kernel], value)

    # -- 10. the new forward kernels vs their plain versions ----------------
    served_blocks = [b for bh, _ in BUCKETS for b in mobilenet_blocks(bh)]
    last_pw = {(ci, co, -(-h // s)) for ci, co, s, h in
               (mobilenet_blocks(bh)[-1] for bh, _ in BUCKETS)}
    dw_shapes = sorted({(ci, s, h) for ci, _, s, h in served_blocks})
    pw_shapes = sorted({(ci, co, -(-h // s)) for ci, co, s, h in
                        served_blocks})
    with torch.no_grad():
        for c, s, h in dw_shapes:
            x, w, b, _, _ = dw_operands(MB_BATCH, c, h, s)
            got = dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME", "relu")
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu", groups=c)
            torch.cuda.synchronize()
            track("conv2d_depthwise_fwd", compare(
                f"dwconv {c} Cb={min(c, 128)} {h}x{h} s{s} n{MB_BATCH} relu",
                got, want, **TOL))
        for ci, co, h in pw_shapes:
            gap = (ci, co, h) in last_pw
            x, w, b, _ = pw_operands(MB_BATCH, ci, co, h)
            got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", "relu",
                                               gap=gap)
            want = direct_conv_blocked(x, w, 1, "VALID", b, "relu", gap=gap)
            torch.cuda.synchronize()
            track("conv2d_pointwise_fwd", compare(
                f"pwconv {ci}->{co} {h}x{h} n{MB_BATCH} relu"
                f"{'+gap' if gap else ''}", got, want, **TOL))
            if gap:
                check_gap(f"pwconv {ci}->{co} {h}x{h} n{MB_BATCH} relu+gap",
                          pwk.pointwise_gap(x, w, b, "relu"), h * h, got)
        for n, c, h, cb, s, gap in ((2, 24, 13, 8, 1, True),
                                    (2, 48, 12, 16, 2, False)):
            x, w, b, r, spec = dw_operands(n, c, h, s, 2, cb, residual=True)
            got = dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME", "gelu",
                                               residual=r, gap=gap,
                                               dilation=2)
            want = direct_conv_blocked(x, w, s, "SAME", b, "gelu", groups=c,
                                       dilation=2, residual=r, gap=gap)
            torch.cuda.synchronize()
            tag = (f"dwconv {c} Cb={cb} {h}x{h} s{s} dilation 2 n{n} "
                   f"gelu+residual{'+gap' if gap else ''}")
            track("conv2d_depthwise_fwd", compare(tag, got, want, **TOL))
            if gap:
                check_gap(tag, dwk.depthwise_gap(x, w, b, s, "SAME", "gelu",
                                                 r, dilation=2),
                          spec.ho * spec.wo, got)
        x, w, b, r = pw_operands(2, 24, 40, 9, 8, 8, residual=True)
        got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "SAME", "gelu",
                                           residual=r, gap=True)
        want = direct_conv_blocked(x, w, 1, "VALID", b, "gelu", residual=r,
                                   gap=True)
        torch.cuda.synchronize()
        track("conv2d_pointwise_fwd", compare(
            "pwconv 24->40 Cib=Cob=8 9x9 n2 gelu+residual+gap", got, want,
            **TOL))
    stamp(10)

    # -- 11. the third main path: MobileNet v1 served ------------------------
    model = mobilenet_v1_blocked(
        1000, device=dev, generator=torch.Generator().manual_seed(args.seed + 2))
    images = torch.randn((MB_BATCH, ENTRY, ENTRY, 3),
                         generator=torch.Generator().manual_seed(args.seed + 3)
                         ).to(dev)
    one_forward = {"direct_conv2d_fwd": 1, "conv2d_depthwise_fwd": 13,
                   "conv2d_pointwise_fwd": 13}
    with torch.no_grad():
        reset_all_launches()
        logits = model(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in all_launches().items() if v}
        print(f"[mobilenet] forward n{MB_BATCH} {ENTRY}x{ENTRY}: launches "
              f"{counts}")
        if counts != one_forward:
            fail(f"expected {one_forward}, got {counts}")
        ref = plain_cnn_forward(images, model)
        compare("mobilenet logits vs plain path", logits, ref,
                atol=LOGIT_RTOL * ref.abs().max().item(), rtol=0.0)
        fwd_ms = time_ms(lambda: model(images), iters=10)
        fwd_graph_ms = graph_ms(lambda: model(images))
        fwd_plain_ms = time_ms(lambda: plain_cnn_forward(images, model),
                               iters=10)
    print(f"[mobilenet] forward n{MB_BATCH} ms: kernels {fwd_ms:.3f} (device "
          f"alone, CUDA graph replay: {fwd_graph_ms:.3f}) plain "
          f"{fwd_plain_ms:.3f}")

    server = ConvServer(model, list(BUCKETS), MB_BATCH, device=dev)
    server.warmup()
    rng = np.random.default_rng(args.seed + 2)
    reqs = []
    for rid in range(24):
        hh, ww = (int(v) for v in rng.integers(96, ENTRY + 1, size=2))
        reqs.append(ConvRequest(rid, rng.standard_normal(
            (hh, ww, 3), dtype=np.float32)))
    reset_all_launches()
    for r in reqs:
        server.submit(r)
    server.run()
    torch.cuda.synchronize()
    served = all_launches()
    backward = {k: v for k, v in served.items()
                if ("dgrad" in k or "wgrad" in k) and v}
    if backward:
        fail(f"the server launched backward kernels: {backward}")
    health = server.health()
    print(f"[mobilenet-serve] launches {served} health {json.dumps(health)}")
    bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
    if bad:
        fail(f"requests not OK: {bad}")
    n_fwd = health["batches"]
    if n_fwd == 0 or any(served[k] != v * n_fwd for k, v in
                         one_forward.items()):
        fail(f"server forwards did not all run the kernels: {served}")
    with torch.no_grad():
        worst = 0.0
        for r in reqs:
            img = torch.from_numpy(server.bucketer.pad(r.image, r.bucket))
            want = plain_cnn_forward(img[None].to(dev), model)[0].cpu().numpy()
            worst = max(worst, float(np.abs(r.logits - want).max()
                                     / max(np.abs(want).max(), 1e-30)))
    print(f"[mobilenet-serve] logits vs plain PyTorch forward of the padded "
          f"image: max rel-to-max err {worst:.3e} (tol {LOGIT_RTOL:g})")
    if not worst <= LOGIT_RTOL:
        fail("served logits differ from the plain forward")
    lat = server.latencies() * 1e3
    print(f"[mobilenet-serve] {len(reqs)} requests OK, {health['steps']} "
          f"steps, latency p50 {np.percentile(lat, 50):.3f} ms p99 "
          f"{np.percentile(lat, 99):.3f} ms, occupancy "
          f"{server.occupancy():.3f}")
    del server
    stamp(11)

    # -- 12. the new backward kernels vs their plain versions ----------------
    train_blocks = mobilenet_blocks(ENTRY)
    n = MB_TRAIN_BATCH
    bwd = {}          # per distinct leg: the operands phase 14 times
    for c, s, h in sorted({(ci, s, h) for ci, _, s, h in train_blocks}):
        x, w, b, _, spec = dw_operands(n, c, h, s)
        with torch.no_grad():
            z = direct_conv_blocked(x, w, s, "SAME", b, groups=c).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        bwd[("dw", c, s, h)] = (x, w, z, g, spec)
        tag = f"{c} Cb={min(c, 128)} {h}x{h} s{s} n{n} relu"
        got = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", z, "relu")
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z, "relu",
                                         groups=c)
        torch.cuda.synchronize()
        track("conv2d_depthwise_dgrad", compare(f"dw dgrad {tag}", got, want,
                                                **TOL))
        del got, want
        dw, db = dwk.depthwise_wgrad(x, g, 3, 3, s, "SAME", z, "relu", True)
        dw2, db2 = dwk.depthwise_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                       True)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"dw wgrad {tag}: two runs differ")
        check_fold(f"dw wgrad {tag}", dwk.depthwise_wgrad_partials(
            x, g, 3, 3, s, "SAME", z, "relu", True), (dw, db))
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), g.double(), 3, 3, s, "SAME", z.double(), "relu",
            True, groups=c)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), 3, 3, s, "SAME",
            with_db=True, groups=c)
        track("conv2d_depthwise_wgrad", max(
            compare_scaled(f"dw wgrad dw {tag} (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"dw wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL)))
        del dw, db, dw2, db2, want_dw, want_db, abs_dw, abs_db, dz
    # the depthwise dgrad's and wgrad's other paths: the tap loop (dilation
    # 2, stride 3, 5x5), Cb = 3 (4-byte copies) at stride 2, a pencil of 6,
    # TF-SAME pads (1, 1) and (0, 1) at stride 2
    for nn, c, h, cb, s, dil, hf, act in (
            (2, 24, 13, 8, 1, 2, 3, "gelu"), (2, 16, 11, 8, 3, 1, 3, "relu"),
            (2, 16, 12, 16, 1, 1, 5, "gelu"), (2, 6, 9, 3, 2, 1, 3, "relu"),
            (2, 12, 10, 6, 1, 1, 3, None), (2, 32, 7, 32, 2, 1, 3, "gelu"),
            (2, 64, 12, 64, 2, 1, 3, "relu")):
        x = torch.randn((nn, c // cb, h, h, cb), device=dev, generator=gen)
        w = torch.randn((c // cb, 1, hf, hf, 1, cb), device=dev,
                        generator=gen) / hf
        z = direct_conv_blocked(x, w, s, "SAME", groups=c,
                                dilation=dil).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        zz = z if act else None
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", zz, act,
                                         groups=c, dilation=dil)
        got = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", zz, act, dil)
        torch.cuda.synchronize()
        tag = (f"{c} Cb={cb} {h}x{h} {hf}x{hf} s{s} dilation {dil} n{nn} "
               f"{act}")
        track("conv2d_depthwise_dgrad", compare(f"dw dgrad {tag}", got, want,
                                                **TOL))
        x = torch.randn(x.shape, device=dev, generator=gen)
        dw, db = dwk.depthwise_wgrad(x, g, hf, hf, s, "SAME", zz, act, True,
                                     dil)
        dw2, db2 = dwk.depthwise_wgrad(x, g, hf, hf, s, "SAME", zz, act,
                                       True, dil)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"dw wgrad {tag}: two runs differ")
        check_fold(f"dw wgrad {tag}", dwk.depthwise_wgrad_partials(
            x, g, hf, hf, s, "SAME", zz, act, True, dil), (dw, db))
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), g.double(), hf, hf, s, "SAME",
            None if zz is None else zz.double(), act, True, groups=c,
            dilation=dil)
        dz = g if zz is None else conv2d_common.cotangent_prologue(g, zz,
                                                                   act)
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), hf, hf, s, "SAME",
            with_db=True, groups=c, dilation=dil)
        track("conv2d_depthwise_wgrad", max(
            compare_scaled(f"dw wgrad dw {tag} (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"dw wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL)))
    for ci, co, h in sorted({(ci, co, -(-h // s))
                             for ci, co, s, h in train_blocks}):
        x, w, b, _ = pw_operands(n, ci, co, h)
        with torch.no_grad():
            z = direct_conv_blocked(x, w, 1, "VALID", b).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        bwd[("pw", ci, co, h)] = (x, w, z, g, None)
        tag = f"{ci}->{co} {h}x{h} n{n} relu"
        got = pwk.pointwise_dgrad(g, w, z, "relu")
        want = direct_conv_dgrad_blocked(g, w, (h, h), 1, "VALID", z, "relu")
        torch.cuda.synchronize()
        track("conv2d_pointwise_dgrad", compare(f"pw dgrad {tag}", got, want,
                                                **TOL))
        del got, want
        dw, db = pwk.pointwise_wgrad(x, g, z, "relu", True)
        dw2, db2 = pwk.pointwise_wgrad(x, g, z, "relu", True)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"pw wgrad {tag}: two runs differ")
        check_fold(f"pw wgrad {tag}", pwk.pointwise_wgrad_partials(
            x, g, z, "relu", True), (dw, db))
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), g.double(), 1, 1, 1, "VALID", z.double(), "relu",
            True)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), 1, 1, 1, "VALID",
            with_db=True)
        track("conv2d_pointwise_wgrad", max(
            compare_scaled(f"pw wgrad dw {tag} (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"pw wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL)))
        del dw, db, dw2, db2, want_dw, want_db, abs_dw, abs_db, dz

    # the autograd path of a small gelu block at stride 2 with a residual,
    # against torch autograd through the plain forward
    block = DepthwiseSeparableBlock(16, 24, stride=2, activation="gelu",
                                    lane=8, device=dev,
                                    generator=torch.Generator().manual_seed(5))
    x = torch.randn((2, 2, 11, 11, 8), device=dev, generator=gen)
    r = torch.randn((2, 3, 6, 6, 8), device=dev, generator=gen)
    ct = torch.randn(r.shape, device=dev, generator=gen)
    params = [block.dw.w, block.dw.b, block.pw.w, block.pw.b]

    def grads_of(forward):
        ins = [x.clone().requires_grad_(), r.clone().requires_grad_()]
        for p in params:
            p.grad = None
        forward(*ins).backward(ct)
        return [t.grad for t in ins] + [p.grad.clone() for p in params]

    got = grads_of(lambda x_, r_: block(x_, residual=r_))
    want = grads_of(lambda x_, r_: direct_conv_blocked(
        direct_conv_blocked(x_, block.dw.w, 2, "SAME", block.dw.b, "gelu",
                            groups=16), block.pw.w, 1, "VALID", block.pw.b,
        "gelu", residual=r_))
    torch.cuda.synchronize()
    for name, gk, gp in zip(("dx", "dres", "dw.w", "dw.b", "pw.w", "pw.b"),
                            got, want):
        kernel = {"dx": "conv2d_depthwise_dgrad", "dres": None,
                  "dw.w": "conv2d_depthwise_wgrad",
                  "dw.b": "conv2d_depthwise_wgrad"}.get(
                      name, "conv2d_pointwise_wgrad")
        e = compare(f"autograd {name} block 16->24 11x11 s2 n2 gelu+residual "
                    "vs plain autograd", gk, gp, **TOL)
        if kernel:
            track(kernel, e)
    stamp(12)

    # -- 13. the fourth main path: MobileNet v1 trained ---------------------
    one_step = {"direct_conv2d_fwd": 1, "direct_conv2d_wgrad": 1,
                "conv2d_depthwise_fwd": 13,
                "conv2d_depthwise_dgrad": 13, "conv2d_depthwise_wgrad": 13,
                "conv2d_pointwise_fwd": 13, "conv2d_pointwise_dgrad": 13,
                "conv2d_pointwise_wgrad": 13}
    tr = lockstep_train("mobilenet-train", mobilenet_v1_blocked(
        1000, device=dev, generator=torch.Generator().manual_seed(
            args.seed + 4)), n, args.seed + 4, one_step, dev)
    trained = tr.counts
    stamp(13)

    # -- 14. times: per leg, the step, the forward; peak memory --------------
    fwd_rows, bwd_rows = {}, {}
    device = {}       # per leg and kind: the kernel's time in a CUDA graph
    lib_device = {}   # the library call's, likewise
    host = {}         # the wrapper's host µs a call
    f32_bound = {}    # the pointwise tiles' f32 FMA bound, beside 3xTF32's
    issued = {}       # the pointwise tiles' tensor-core MACs and function's
    dw_taps = {}      # the depthwise dgrad's phases and the taps it runs

    def graphs(key, kernel, library):
        device[key] = graph_ms(kernel)
        lib_device[key] = graph_ms(library)
        host[key] = host_us(kernel)

    def pw_issued(key, n_, hw, kblk, kw, oblk, ow, gap):
        blk = choose_pointwise_blocking(n_, hw, kblk, kw, oblk, ow, gap=gap)
        issued[key] = (pointwise_issued_macs(blk, n_, kblk, kw, oblk),
                       n_ * hw * kblk * kw * oblk * ow)

    with torch.no_grad():
        for c, s, h in sorted({(ci, s, h) for ci, _, s, h in
                               mobilenet_blocks(ENTRY)}):
            x, w, b, _, spec = dw_operands(MB_BATCH, c, h, s)
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(nchw(x), (pl, pr, pt, pb)).contiguous()
            wl, bl = oihw(w, c).contiguous(), b.reshape(-1)
            kernel = lambda: dwk.depthwise_conv2d_blocked(  # noqa: E731
                x, w, b, s, "SAME", "relu")
            library = lambda: F.conv2d(  # noqa: E731
                xp, wl, bl, stride=s, groups=c)
            graphs(("dw", c, s, h, "fwd"), kernel, library)
            fwd_rows[("dw", c, s, h)] = (
                time_ms(kernel),
                time_ms(lambda: direct_conv_blocked(x, w, s, "SAME", b,
                                                    "relu", groups=c)),
                time_ms(library),
                *bound(spec.flops(), 4 * (x.numel() + w.numel() + b.numel()
                                          + MB_BATCH * c * spec.ho
                                          * spec.wo)))
        for ci, co, h in sorted({(ci, co, -(-h // s)) for ci, co, s, h in
                                 mobilenet_blocks(ENTRY)}):
            gap = (ci, co, h) == (1024, 1024, 7)
            x, w, b, _ = pw_operands(MB_BATCH, ci, co, h)
            xl, wl, bl = nchw(x).contiguous(), oihw(w, 1).contiguous(), \
                b.reshape(-1)
            out_elems = MB_BATCH * co * (1 if gap else h * h)
            kernel = lambda: pwk.pointwise_conv2d_blocked(  # noqa: E731
                x, w, b, 1, "VALID", "relu", gap=gap)
            library = lambda: F.conv2d(xl, wl, bl)  # noqa: E731
            key = ("pw", ci, co, h)
            graphs(key + ("fwd",), kernel, library)
            b_ms, b_by, f32_bound[key + ("fwd",)] = tf32x3_bound(
                2 * MB_BATCH * h * h * ci * co,
                4 * (x.numel() + w.numel() + b.numel() + out_elems))
            pw_issued(key + ("fwd",), MB_BATCH, h * h, ci // x.shape[4],
                      x.shape[4], co // w.shape[5], w.shape[5], gap)
            fwd_rows[key] = (
                time_ms(kernel),
                time_ms(lambda: direct_conv_blocked(x, w, 1, "VALID", b,
                                                    "relu", gap=gap)),
                time_ms(library), b_ms, b_by)
    for key, (x, w, z, g, spec) in bwd.items():
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        dzl = nchw(dz).contiguous()
        if key[0] == "dw":
            _, c, s, h = key
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(nchw(x), (pl, pr, pt, pb)).contiguous()
            wl = oihw(w, c).contiguous()
            flops = spec.flops()
            phases, taps = depthwise_dgrad_taps(h, h, 3, 3, s, (1, 1),
                                                spec.pads)
            dw_taps[key] = (phases, n * c * taps, n * c * h * h)
            bwd_rows[key] = {
                "dgrad": (
                    time_ms(lambda: dwk.depthwise_dgrad(g, w, (h, h), s,
                                                        "SAME", z, "relu")),
                    time_ms(lambda: direct_conv_dgrad_blocked(
                        g, w, (h, h), s, "SAME", z, "relu", groups=c)),
                    time_ms(lambda: torch.ops.aten.convolution_backward(
                        dzl, xp, wl, None, [s, s], [0, 0], [1, 1], False,
                        [0, 0], c, [True, False, False])),
                    *bound(flops, 4 * (2 * g.numel() + w.numel()
                                       + x.numel()))),
                "wgrad": (
                    time_ms(lambda: dwk.depthwise_wgrad_partials(
                        x, g, 3, 3, s, "SAME", z, "relu", True)),
                    time_ms(lambda: direct_conv_wgrad_blocked(
                        x, g, 3, 3, s, "SAME", z, "relu", True, groups=c)),
                    time_ms(lambda: torch.ops.aten.convolution_backward(
                        dzl, xp, wl, None, [s, s], [0, 0], [1, 1], False,
                        [0, 0], c, [False, True, False])),
                    *bound(flops, 4 * (x.numel() + 2 * g.numel() + w.numel()
                                       + c)))}
        else:
            _, ci, co, h = key
            xl, wl = nchw(x).contiguous(), oihw(w, 1).contiguous()
            flops = 2 * n * h * h * ci * co
            # g and z read, dx written, w read once
            b_ms, b_by, f32_bound[key + ("dgrad",)] = tf32x3_bound(
                flops, 4 * (2 * g.numel() + w.numel() + x.numel()))
            # the dgrad runs the dense dgrad's tile at 1x1: its kernel
            # library's own plan must be the blocking model's
            plan, model_plan = dgrad_plans(g, w, (h, h), 1, "VALID", z,
                                           "relu")
            if plan != model_plan:
                fail(f"pw dgrad {ci}->{co} {h}x{h}: the kernel's plan {plan} "
                     f"!= the blocking model's {model_plan}")
            issued[key + ("dgrad",)] = (plan.issued_macs, plan.function_macs)
            # the wgrad runs the dense wgrad's tile at 1x1, likewise
            wplan, wmodel = wgrad_plans(x, g, 1, 1, 1, "VALID", z, "relu")
            if wplan != wmodel:
                fail(f"pw wgrad {ci}->{co} {h}x{h}: the kernel's plan {wplan} "
                     f"!= the blocking model's {wmodel}")
            issued[key + ("wgrad",)] = (wplan.issued_macs,
                                        wplan.function_macs)
            # x, g and z read, dw and db written
            wb_ms, wb_by, f32_bound[key + ("wgrad",)] = tf32x3_bound(
                flops, 4 * (x.numel() + 2 * g.numel() + w.numel() + co))
            bwd_rows[key] = {
                "dgrad": (
                    time_ms(lambda: pwk.pointwise_dgrad(g, w, z, "relu")),
                    time_ms(lambda: direct_conv_dgrad_blocked(
                        g, w, (h, h), 1, "VALID", z, "relu")),
                    time_ms(lambda: torch.ops.aten.convolution_backward(
                        dzl, xl, wl, None, [1, 1], [0, 0], [1, 1], False,
                        [0, 0], 1, [True, False, False])),
                    b_ms, b_by),
                "wgrad": (
                    time_ms(lambda: pwk.pointwise_wgrad_partials(
                        x, g, z, "relu", True)),
                    time_ms(lambda: direct_conv_wgrad_blocked(
                        x, g, 1, 1, 1, "VALID", z, "relu", True)),
                    time_ms(lambda: torch.ops.aten.convolution_backward(
                        dzl, xl, wl, None, [1, 1], [0, 0], [1, 1], False,
                        [0, 0], 1, [False, True, False])),
                    wb_ms, wb_by)}
        if key[0] == "dw":
            xin, st, groups = xp, s, c
            dgrad = lambda: dwk.depthwise_dgrad(  # noqa: E731
                g, w, (h, h), s, "SAME", z, "relu")
            wgrad = lambda: dwk.depthwise_wgrad_partials(  # noqa: E731
                x, g, 3, 3, s, "SAME", z, "relu", True)
        else:
            xin, st, groups = xl, 1, 1
            dgrad = lambda: pwk.pointwise_dgrad(g, w, z, "relu")  # noqa: E731
            wgrad = lambda: pwk.pointwise_wgrad_partials(  # noqa: E731
                x, g, z, "relu", True)
        for kind, fn, mask in (("dgrad", dgrad, [True, False, False]),
                               ("wgrad", wgrad, [False, True, False])):
            graphs(key + (kind,), fn,
                   lambda mask=mask: torch.ops.aten.convolution_backward(
                       dzl, xin, wl, None, [st, st], [0, 0], [1, 1], False,
                       [0, 0], groups, mask))
        del dz, dzl

    # sums over the 13 legs of each kind, in the network's order
    sums = {k: [0.0, 0.0, 0.0, 0.0] for k in f32_names}
    device_sums = {k: 0.0 for k in sums}
    lib_sums = {k: 0.0 for k in sums}
    host_sums = {k: 0.0 for k in sums}
    issued_sums = {k: [0, 0] for k in sums}
    dw_taps_sum = [0, 0]
    f32_sums = {k: 0.0 for k in sums}
    kinds = {k: [] for k in sums}
    for i, (ci, co, s, h) in enumerate(mobilenet_blocks(ENTRY)):
        ho = -(-h // s)
        legs = (("dw", ("dw", ci, s, h), "conv2d_depthwise", ci, h, s),
                ("pw", ("pw", ci, co, ho), "conv2d_pointwise", co, ho, 1))
        for leg, key, kernel, cout, ext, st in legs:
            rows = {"fwd": fwd_rows[key], **bwd_rows[key]}
            for kind, (k_ms, p_ms, l_ms, b_ms, b_by) in rows.items():
                name = f"{kernel}_{kind}"
                for j, v in enumerate((k_ms, p_ms, l_ms, b_ms)):
                    sums[name][j] += v
                leg_kind = key + (kind,)
                d_ms = device[leg_kind]
                device_sums[name] += d_ms
                lib_sums[name] += lib_device[leg_kind]
                host_sums[name] += host[leg_kind]
                kinds[name].append((b_ms, b_by))
                extra = ""
                if leg_kind in f32_bound:
                    got, fn_macs = issued[leg_kind]
                    issued_sums[name][0] += got
                    f32_sums[name] += f32_bound[leg_kind]
                    issued_sums[name][1] += fn_macs
                    extra = (f" (3xTF32; f32 FMA {f32_bound[leg_kind]:.4f}) "
                             f"tensor-core MACs issued {got} for the "
                             f"function's {fn_macs}, padding "
                             f"{1 - 3 * fn_macs / got:.3f}")
                if kind == "wgrad":
                    extra += "; " + separable_split_sum(leg, n, ci, co, ho,
                                                        s)
                if leg == "dw" and kind == "wgrad":
                    wb = choose_depthwise_wgrad_blocking(
                        n, ci // min(ci, 128), ho, ho, min(ci, 128), 3, 3, s)
                    extra += (f"; items {wb.hob}x{wb.wob} over {wb.lanes} "
                              f"lanes, {wb.per_column / wb.splits:.2f} a CTA")
                if leg == "dw" and kind == "dgrad":
                    phases, taps, positions = dw_taps[key]
                    dw_taps_sum[0] += taps
                    dw_taps_sum[1] += positions
                    extra += (f" phases {phases}, taps run {taps} "
                              f"({taps / positions:.2f} a dx position)")
                print(f"[mb-layer] block{i + 1} {leg} {kind} {ci}->{cout} "
                      f"in {ext}x{ext} s{st} "
                      f"n{MB_BATCH if kind == 'fwd' else n}: kernel_ms "
                      f"{k_ms:.4f} device_ms {d_ms:.4f} host_us "
                      f"{host[leg_kind]:.1f} plain_ms {p_ms:.4f} library_ms "
                      f"{l_ms:.4f} library_device_ms "
                      f"{lib_device[leg_kind]:.4f} bound_ms {b_ms:.4f} "
                      f"({b_by}){extra} bound/kernel {b_ms / k_ms:.3f}")
    for name, (k_ms, p_ms, l_ms, b_ms) in sums.items():
        got, fn_macs = issued_sums[name]
        pad = (f" (3xTF32; f32 FMA {f32_sums[name]:.4f}), padding "
               f"{1 - 3 * fn_macs / got:.3f} of the tensor-core MACs issued"
               if got else "")
        if name == "conv2d_depthwise_dgrad":
            taps_run, positions = dw_taps_sum
            pad += (f", taps run {taps_run} ({taps_run / positions:.2f} a dx "
                    "position)")
        print(f"[mb-layer] all 13 {name}: kernel_ms {k_ms:.4f} device_ms "
              f"{device_sums[name]:.4f} host_us {host_sums[name]:.1f} "
              f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
              f"library_device_ms {lib_sums[name]:.4f} bound_ms "
              f"{b_ms:.4f} ({mostly(kinds[name])}){pad}")
    del bwd, fwd_rows

    timed_steps(f"mobilenet-train n{n}", [
        ("plain", tr.plain_step, tr.plain_state),
        ("kernels", tr.step, tr.state)], tr.batches)
    # how busy the device is in a kernel step: the host's share is the rest
    split = device_split(lambda: tr.step(tr.state, tr.batches[0]))
    if split is None:
        print("[mobilenet-train] torch.profiler records no device time here: "
              "the step's device-busy share is not measured")
    else:
        wall, busy, top = split
        print(f"[mobilenet-train] one step under torch.profiler: wall "
              f"{wall:.2f} ms, device busy {busy:.2f} ms (busy share "
              f"{busy / wall:.3f}, idle share {1 - busy / wall:.3f}); by "
              "kernel: " + "; ".join(f"{nm[:60]} {ms:.3f} ms x{k}"
                                     for nm, ms, k in top))

    # peak device memory of one kernel step, against what it must hold
    peak, p_bytes = step_peak_bytes(tr)
    del tr
    ci0, co0, s0 = MOBILENET_V1_CONV1
    h0 = -(-ENTRY // s0)
    saved = 4 * n * (ci0 * ENTRY * ENTRY + co0 * h0 * h0)
    ws_max = 4 * choose_wgrad_blocking(n, h0, h0, 3, 3, s0, 1, ci0, 1,
                                       co0, prologue=True).splits * (
        9 * ci0 * co0 + co0)
    for ci, co, s, h in mobilenet_blocks(ENTRY):
        ho = -(-h // s)
        cb, cob = min(ci, 128), min(co, 128)
        # depthwise leg: x and z; pointwise leg: its x and z
        saved += 4 * n * (ci * h * h + ci * ho * ho + ci * ho * ho
                          + co * ho * ho)
        dws = choose_depthwise_wgrad_blocking(n, ci // cb, ho, ho, cb, 3, 3,
                                              s).splits
        pws = choose_wgrad_blocking(n, ho, ho, 1, 1, 1, ci // cb, cb,
                                    co // cob, cob, prologue=True).splits
        ws_max = max(ws_max, 4 * dws * (10 * ci), 4 * pws * (ci * co + co))
    must = 4 * p_bytes + saved + ws_max
    print(f"[mobilenet-train] peak device memory of one step: "
          f"{peak / 2**20:.1f} MiB; it must hold {must / 2**20:.1f} MiB = "
          f"parameters, gradients and 2 Adam moments "
          f"{4 * p_bytes / 2**20:.1f} + saved x and z {saved / 2**20:.1f} + "
          f"largest wgrad workspace {ws_max / 2**20:.1f}")
    stamp(14)

    sources = {"conv2d_pointwise": PW_SOURCE, "conv2d_depthwise": DW_SOURCE}
    entries = []
    for name, (k_ms, p_ms, l_ms, b_ms) in sums.items():
        family, kind = name.rsplit("_", 1)
        # the pointwise dgrad and wgrad are the dense dgrad's and wgrad's
        # tiles at 1x1
        source = BWD_SOURCE if name in ("conv2d_pointwise_dgrad",
                                        "conv2d_pointwise_wgrad") else \
            sources[family]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": TPU_SEPARABLE[name],
            "launches": served[name] + trained[name],
            "max_abs_err": err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": mostly(kinds[name]),
            "library_ms": l_ms})
    counts = {k: served[k] + trained[k] for k in served}
    return entries, counts, model


def stream_phases(args, dev, t_start):
    """Phases 15-17: the streamed (halo-ring) kernels and VGG-16 served and
    trained through them.  -> (the streamed kernels' entries of the
    ``{"kernels": [...]}`` line, the launches of the two main-path runs,
    serving and training, per kernel)."""
    from repro_torch.configs.cnn import vgg16_blocked, vgg16_layers
    from repro_torch.core import conv2d_common
    from repro_torch.core.blocking import (choose_fwd_blocking,
                                           choose_stream_dgrad_blocking,
                                           choose_stream_fwd_blocking,
                                           choose_stream_wgrad_blocking)
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels import conv2d_stream as stk
    from repro_torch.kernels.direct_conv2d import (direct_conv2d_blocked,
                                                   direct_conv2d_dgrad,
                                                   direct_conv2d_wgrad,
                                                   wgrad_partials)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome
    from repro_torch.train.trainstep import make_train_step

    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    streamed = ConvContext(stream=True)
    window_kernels = ("direct_conv2d_fwd", "direct_conv2d_dgrad",
                      "direct_conv2d_wgrad")

    def stamp(phase):
        print(f"[time] phase {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def operands(n, ci, co, h, s, residual=False):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        r = (torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                         generator=gen) if residual else None)
        return x, w, b, r, spec

    def layer_shapes(entry):
        out, h = [], entry
        for ci, co, s in vgg16_layers():
            out.append((ci, co, s, h))
            h = ConvSpec.make(1, h, h, ci, co, 3, 3, s, "SAME").ho
        return out

    def distinct(seq):
        return sorted(set(seq), key=seq.index)

    layers = layer_shapes(ENTRY)
    shapes = distinct(layers)
    checked = distinct([sh for bh, _ in BUCKETS for sh in layer_shapes(bh)])
    err = dict.fromkeys(stk.LAUNCHES, 0.0)

    # -- 15. the streamed kernels vs their plain versions and the window ----
    bitwise, close = [], []
    with torch.no_grad():
        for ci, co, s, h in checked:
            x, w, b, _, spec = operands(BATCH, ci, co, h, s)
            cib, cob = min(ci, 128), min(co, 128)
            got = direct_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                        stream=True)
            win = direct_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                        stream=False)
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu")
            torch.cuda.synchronize()
            tag = f"{ci}->{co} {h}x{h} s{s} n{BATCH} relu"
            err["conv2d_stream_fwd"] = max(
                err["conv2d_stream_fwd"],
                compare(f"stream fwd {tag}", got, want, **TOL))
            shape = (BATCH, spec.ho, spec.wo, 3, 3, s, ci // cib, cib,
                     co // cob, cob)
            sb = choose_stream_fwd_blocking(*shape)
            wb = choose_fwd_blocking(*shape)
            same = torch.equal(got, win)
            diff = (got - win).abs().max().item()
            scale = want.abs().max().item()
            print(f"[stream] fwd {tag}: band {sb.th}x{sb.tw} ({sb.strips} "
                  f"strips of {sb.hso} rows) lanes {sb.lanes} x "
                  f"{sb.nsplit} chunk {sb.chunk} window {sb.hwin}x{sb.wwin};"
                  f" window tile {wb.th}x{wb.tw} ({wb.wgs} warpgroups) "
                  f"lanes {wb.lanes} x {wb.nsplit} chunk {wb.chunk}; vs "
                  "window: "
                  + ("bit for bit" if same else
                     f"max diff {diff:.3e} = {diff / scale:.2e} of max|y|"))
            if sb.chunk == wb.chunk and not same:
                fail(f"stream fwd {tag}: the same chunk as the window "
                     "kernel, yet not bit for bit")
            if not diff <= 1e-5 * scale:
                fail(f"stream fwd {tag}: {diff:.3e} from the window kernel")
            (bitwise if same else close).append(tag)
        print(f"[stream] forward vs window kernel: {len(bitwise)} of "
              f"{len(checked)} VGG-16 shapes bit for bit, {len(close)} "
              "within 1e-5 of max|y| (other channel chunks)")
        for n, ci, co, h, s in ((2, 3, 64, 20, 2), (2, 64, 128, 28, 1)):
            x, w, b, r, _ = operands(n, ci, co, h, s, residual=True)
            got = direct_conv2d_blocked(x, w, b, s, "SAME", "gelu",
                                        residual=r, gap=True, stream=True)
            want = direct_conv_blocked(x, w, s, "SAME", b, "gelu",
                                       residual=r, gap=True)
            torch.cuda.synchronize()
            err["conv2d_stream_fwd"] = max(
                err["conv2d_stream_fwd"], compare(
                    f"stream fwd {ci}->{co} {h}x{h} s{s} n{n} "
                    "gelu+residual+gap", got, want, **TOL))

    bwd_ops = {}
    for ci, co, s, h in shapes:
        x, w, b, _, spec = operands(BATCH, ci, co, h, s)
        cib, cob = min(ci, 128), min(co, 128)
        with torch.no_grad():
            z = direct_conv_blocked(x, w, s, "SAME", b).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        bwd_ops[(ci, co, s, h)] = (x, w, z, g, spec)
        tag = f"{ci}->{co} {h}x{h} s{s} n{BATCH} relu"
        db_ = choose_stream_dgrad_blocking(BATCH, h, h, 3, 3, s, ci // cib,
                                           cib, cob, prologue=True)
        wg = choose_stream_wgrad_blocking(BATCH, spec.ho, spec.wo, 3, 3, s,
                                          ci // cib, cib, co // cob, cob,
                                          prologue=True)
        print(f"[stream] bwd {tag}: dgrad band {db_.th}x{db_.tw} phase "
              f"positions ({db_.strips} strips of {db_.hso} rows, a "
              f"consumer warpgroup each) lanes {db_.lanes} chunk "
              f"{db_.chunk} window {db_.hwin}x{db_.wwin}; wgrad strips of "
              f"{wg.hso} rows down each column, {wg.items} items, "
              f"{tiles_text(wg)}")
        if ci != 3:        # conv1_1's dx is never needed: no dgrad there
            got = direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z, "relu",
                                      stream=True)
            want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z,
                                             "relu")
            torch.cuda.synchronize()
            err["conv2d_stream_dgrad"] = max(
                err["conv2d_stream_dgrad"],
                compare(f"stream dgrad {tag}", got, want, **TOL))
            del got, want
        dw, db = direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                     with_db=True, stream=True)
        dw2, db2 = direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                       with_db=True, stream=True)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"stream wgrad {tag}: two runs differ")
        check_fold(f"stream wgrad {tag}", stk.stream_wgrad_partials(
            x, g, 3, 3, s, "SAME", z, "relu", with_db=True), (dw, db))
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), g.double(), 3, 3, s, "SAME", z.double(), "relu",
            with_db=True)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), 3, 3, s, "SAME",
            with_db=True)
        err["conv2d_stream_wgrad"] = max(
            err["conv2d_stream_wgrad"],
            compare_scaled(f"stream wgrad dw {tag} (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"stream wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL))
        del dw, db, dw2, db2, want_dw, want_db, abs_dw, abs_db, dz
    worst = {k: max(v for lab, v in RATIOS.items()
                    if lab.startswith(f"stream wgrad {k} ")) for k in ("dw",
                                                                    "db")}
    print(f"[stream] wgrad worst err/bound over {len(shapes)} shapes: dw "
          f"{worst['dw']:.3f} db {worst['db']:.3f} (tol 1; 3xTF32 tensor "
          "cores, two runs bit for bit)")
    # Cob % 4 != 0: the streamed dgrad's cp.async path
    err["conv2d_stream_dgrad"] = max(err["conv2d_stream_dgrad"],
                                     c1_dgrads("streamed", True))
    stamp(15)

    # -- 16. the fifth and sixth main paths: VGG-16 on the streamed route --
    model = vgg16_blocked(1000, device=dev, generator=torch.Generator()
                          .manual_seed(args.seed + 2))
    server = ConvServer(model, list(BUCKETS), BATCH, device=dev,
                        context=streamed)
    server.warmup()
    rng = np.random.default_rng(args.seed + 2)
    reqs = []
    for rid in range(24):
        hh, ww = (int(v) for v in rng.integers(96, ENTRY + 1, size=2))
        reqs.append(ConvRequest(rid, rng.standard_normal(
            (hh, ww, 3), dtype=np.float32)))
    reset_all_launches()
    for r in reqs:
        server.submit(r)
    server.run()
    torch.cuda.synchronize()
    served = all_launches()
    health = server.health()
    print(f"[stream-serve] launches {({k: v for k, v in served.items() if v})}"
          f" health {json.dumps(health)}")
    n_fwd = health["batches"]
    if any(served[k] for k in window_kernels) or n_fwd == 0 or \
            served["conv2d_stream_fwd"] != 13 * n_fwd or \
            served["conv2d_stream_dgrad"] or served["conv2d_stream_wgrad"]:
        fail(f"the streamed server did not run 13 streamed forwards a "
             f"batch and nothing else: {served}")
    bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
    if bad:
        fail(f"requests not OK: {bad}")
    with torch.no_grad():
        worst = 0.0
        for r in reqs:
            img = torch.from_numpy(server.bucketer.pad(r.image, r.bucket))
            want = plain_cnn_forward(img[None].to(dev), model)[0].cpu().numpy()
            worst = max(worst, float(np.abs(r.logits - want).max()
                                     / max(np.abs(want).max(), 1e-30)))
    print(f"[stream-serve] {len(reqs)} requests OK; logits vs the plain "
          f"forward of the padded image: max rel-to-max err {worst:.3e} "
          f"(tol {LOGIT_RTOL:g})")
    if not worst <= LOGIT_RTOL:
        fail("served logits differ from the plain forward")
    del server, model

    tr = lockstep_train(
        "stream-train", vgg16_blocked(1000, device=dev, generator=torch
                                      .Generator().manual_seed(args.seed + 3)),
        BATCH, args.seed + 3, {"conv2d_stream_fwd": 13,
                               "conv2d_stream_dgrad": 12,
                               "conv2d_stream_wgrad": 13},
        dev, context=streamed)
    trained = tr.counts
    stamp(16)

    # -- 17. times: per layer, the step; peak memory ------------------------
    rows = {}
    with torch.no_grad():
        for key in shapes:
            ci, co, s, h = key
            x, w, z, g, spec = bwd_ops[key]
            b = 0.1 * torch.randn((co // min(co, 128), min(co, 128)),
                                  device=dev, generator=gen)
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h),
                       (pl, pr, pt, pb)).contiguous()
            w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                      .contiguous())
            dz = conv2d_common.cotangent_prologue(g, z, "relu")
            dz_nchw = (dz.permute(0, 1, 4, 2, 3)
                       .reshape(BATCH, co, spec.ho, spec.wo).contiguous())
            flops = spec.flops()
            row = {}

            def both(fn):
                return time_ms(fn), graph_ms(fn)

            row["fwd"] = (
                *both(lambda: direct_conv2d_blocked(
                    x, w, b, s, "SAME", "relu", stream=True)),
                *both(lambda: direct_conv2d_blocked(
                    x, w, b, s, "SAME", "relu", stream=False)),
                time_ms(lambda: direct_conv_blocked(x, w, s, "SAME", b,
                                                    "relu")),
                time_ms(lambda: F.conv2d(xp, w_oihw, b.reshape(co),
                                         stride=s)),
                *tf32x3_bound(flops, 4 * (x.numel() + w.numel() + b.numel()
                                          + z.numel())))
            if ci != 3:
                row["dgrad"] = (
                    *both(lambda: direct_conv2d_dgrad(
                        g, w, (h, h), s, "SAME", z, "relu", stream=True)),
                    *both(lambda: direct_conv2d_dgrad(
                        g, w, (h, h), s, "SAME", z, "relu", stream=False)),
                    time_ms(lambda: direct_conv_dgrad_blocked(
                        g, w, (h, h), s, "SAME", z, "relu")),
                    time_ms(lambda: torch.ops.aten.convolution_backward(
                        dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1],
                        False, [0, 0], 1, [True, False, False])),
                    *tf32x3_bound(flops, 4 * (2 * g.numel() + w.numel()
                                             + x.numel())))
            row["wgrad"] = (
                *both(lambda: stk.stream_wgrad_partials(
                    x, g, 3, 3, s, "SAME", z, "relu", with_db=True)),
                *both(lambda: wgrad_partials(x, g, 3, 3, s, "SAME", z,
                                             "relu", with_db=True)),
                time_ms(lambda: direct_conv_wgrad_blocked(
                    x, g, 3, 3, s, "SAME", z, "relu", with_db=True)),
                time_ms(lambda: torch.ops.aten.convolution_backward(
                    dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                    [0, 0], 1, [False, True, False])),
                *tf32x3_bound(flops, 4 * (x.numel() + 2 * g.numel()
                                          + w.numel() + co)))
            rows[key] = row
            del xp, w_oihw, dz, dz_nchw
    names = {"fwd": "conv2d_stream_fwd", "dgrad": "conv2d_stream_dgrad",
             "wgrad": "conv2d_stream_wgrad"}
    sums = {kind: [0.0] * 7 for kind in names}
    kinds = {kind: [] for kind in names}
    dg = {"macs": 0, "issued": 0, "f32": 0.0}
    wg = {"macs": 0, "issued": 0, "window_issued": 0, "f32": 0.0}
    fw = {"macs": 0, "issued": 0, "window_issued": 0, "f32": 0.0}
    for lname, key in zip(LAYER_NAMES, layers):
        ci, co, s, h = key
        x, w, z, g, _ = bwd_ops[key]
        v = rows[key]["fwd"]
        sblk, plan, macs = fwd_work(x, w, h, s, streamed=True)
        _, wplan, _ = fwd_work(x, w, h, s, streamed=False)
        fw["macs"] += macs
        fw["issued"] += plan.issued_macs
        fw["window_issued"] += wplan.issued_macs
        fw["f32"] += v[8]
        print(f"[stream-time] {lname} fwd tiles: stream "
              f"{fwd_text(sblk, plan, macs, v[1])}; window {wplan.tiles} "
              f"tiles, issued {wplan.issued_macs} (padding "
              f"{100 * wplan.padding_share:.1f} %) (both plans the blocking "
              f"model's); stream eager_ms {v[0]:.4f} graph_ms {v[1]:.4f}, "
              f"window eager_ms {v[2]:.4f} graph_ms {v[3]:.4f}, library_ms "
              f"{v[5]:.4f}; bound_ms {v[6]:.4f} (3xTF32), f32 FMA bound_ms "
              f"{v[8]:.4f}")
        v = rows[key]["wgrad"]
        plan, macs = wgrad_work(x, g, z, h, s, streamed=True)
        wplan, _ = wgrad_work(x, g, z, h, s, streamed=False)
        wg["macs"] += macs
        wg["issued"] += plan.issued_macs
        wg["window_issued"] += wplan.issued_macs
        wg["f32"] += v[8]
        print(f"[stream-time] {lname} wgrad tiles: stream {plan.tiles} "
              f"items, tensor-core MACs issued {plan.issued_macs} (padding "
              f"{100 * plan.padding_share:.1f} %); window {wplan.tiles} "
              f"tiles, issued {wplan.issued_macs} (padding "
              f"{100 * wplan.padding_share:.1f} %); function MACs {macs} "
              f"(both plans the blocking model's); stream eager_ms "
              f"{v[0]:.4f} graph_ms {v[1]:.4f} "
              f"({macs / 1e6 / v[1]:.1f} function GMAC/s on the device), "
              f"window eager_ms {v[2]:.4f} graph_ms {v[3]:.4f}, library_ms "
              f"{v[5]:.4f}; bound_ms {v[6]:.4f} (3xTF32), f32 FMA bound_ms "
              f"{v[8]:.4f}; {split_sum_text(x, g, s, streamed=True)}")
        if "dgrad" in rows[key]:
            v = rows[key]["dgrad"]
            phases, plan, macs = dgrad_work(g, w, z, h, s, streamed=True)
            dg["macs"] += macs
            dg["issued"] += plan.issued_macs
            dg["f32"] += v[8]
            print(f"[stream-time] {lname} dgrad phases: stride {s}, {phases} "
                  f"phase(s), {plan.tiles} tiles, function MACs by phase "
                  f"{plan.function_macs} (the function's), tensor-core MACs "
                  f"issued {plan.issued_macs} (three products each; "
                  f"padding {100 * plan.padding_share:.1f} %); stream "
                  f"eager_ms {v[0]:.4f} graph_ms {v[1]:.4f} "
                  f"({macs / 1e6 / v[1]:.1f} function GMAC/s on the device), "
                  f"window eager_ms {v[2]:.4f} graph_ms {v[3]:.4f}, "
                  f"library_ms {v[5]:.4f}; bound_ms {v[6]:.4f} (3xTF32), f32 "
                  f"FMA bound_ms {v[8]:.4f}, issued MACs at the TF32 peak "
                  f"{2 * plan.issued_macs / PEAK_TF32_FLOPS * 1e3:.4f} ms")
        for kind in names:
            if kind not in rows[key]:
                continue
            v = rows[key][kind]
            for i in range(7):
                sums[kind][i] += v[i]
            kinds[kind].append((v[6], v[7]))
            print(f"[stream-time] {lname} {kind} {ci}->{co} in {h}x{h} s{s} "
                  f"n{BATCH}: stream_ms {v[0]:.4f} stream_device_ms "
                  f"{v[1]:.4f} window_ms {v[2]:.4f} window_device_ms "
                  f"{v[3]:.4f} plain_ms {v[4]:.4f} library_ms {v[5]:.4f} "
                  f"bound_ms {v[6]:.4f} ({v[7]}) bound/stream_device "
                  f"{v[6] / v[1]:.3f}")
    for kind, v in sums.items():
        print(f"[stream-time] all {len(kinds[kind])} {kind}: stream_ms "
              f"{v[0]:.4f} stream_device_ms {v[1]:.4f} window_ms {v[2]:.4f} "
              f"window_device_ms {v[3]:.4f} plain_ms {v[4]:.4f} library_ms "
              f"{v[5]:.4f} bound_ms {v[6]:.4f} ({mostly(kinds[kind])})")
    print(f"[stream-time] all {len(kinds['fwd'])} fwd tiles: function MACs "
          f"{fw['macs']}, tensor-core MACs issued {fw['issued']} streamed "
          f"(padding {100 * (1 - 3 * fw['macs'] / fw['issued']):.1f} %), "
          f"{fw['window_issued']} window (padding "
          f"{100 * (1 - 3 * fw['macs'] / fw['window_issued']):.1f} %); "
          f"stream graph_ms {sums['fwd'][1]:.4f}, window graph_ms "
          f"{sums['fwd'][3]:.4f}, library_ms {sums['fwd'][5]:.4f}; bound_ms "
          f"{sums['fwd'][6]:.4f} (3xTF32), f32 FMA bound_ms {fw['f32']:.4f}")
    print(f"[stream-time] all {len(kinds['dgrad'])} dgrad phases: function "
          f"MACs by phase {dg['macs']}, tensor-core MACs issued "
          f"{dg['issued']} (padding "
          f"{100 * (1 - 3 * dg['macs'] / dg['issued']):.1f} %); bound_ms "
          f"{sums['dgrad'][6]:.4f} (3xTF32), f32 FMA bound_ms "
          f"{dg['f32']:.4f}")
    print(f"[stream-time] all {len(kinds['wgrad'])} wgrad tiles: function "
          f"MACs {wg['macs']}, tensor-core MACs issued {wg['issued']} "
          f"streamed (padding "
          f"{100 * (1 - 3 * wg['macs'] / wg['issued']):.1f} %), "
          f"{wg['window_issued']} window (padding "
          f"{100 * (1 - 3 * wg['macs'] / wg['window_issued']):.1f} %); "
          f"stream graph_ms {sums['wgrad'][1]:.4f}, window graph_ms "
          f"{sums['wgrad'][3]:.4f}, library_ms {sums['wgrad'][5]:.4f}; "
          f"bound_ms {sums['wgrad'][6]:.4f} (3xTF32), f32 FMA bound_ms "
          f"{wg['f32']:.4f}")
    del bwd_ops

    window_step = make_train_step(tr.model, tr.opt)
    window_state = tr.opt.init(dict(tr.model.named_parameters()))
    timed_steps("stream-train", [("plain", tr.plain_step, tr.plain_state),
                                 ("window", window_step, window_state),
                                 ("stream", tr.step, tr.state)], tr.batches)
    del window_step, window_state
    peak, p_bytes = step_peak_bytes(tr)
    saved, ws_max, hh = 0, 0, ENTRY
    for (ci, co, s), c in zip(vgg16_layers(), tr.model.convs):
        ho = -(-hh // s)
        saved += 4 * BATCH * (ci * hh * hh + co * ho * ho)    # x and z
        wg = choose_stream_wgrad_blocking(
            BATCH, ho, ho, 3, 3, s, ci // c.in_pencil, c.in_pencil,
            co // c.out_pencil, c.out_pencil, prologue=True)
        ws_max = max(ws_max, 4 * wg.splits * (9 * ci * co + co))
        hh = ho
    must = 4 * p_bytes + saved + ws_max
    print(f"[stream-train] peak device memory of one step: "
          f"{peak / 2**20:.1f} MiB; it must hold {must / 2**20:.1f} MiB = "
          f"parameters, gradients and 2 Adam moments "
          f"{4 * p_bytes / 2**20:.1f} + saved x and z {saved / 2**20:.1f} + "
          f"largest wgrad workspace {ws_max / 2**20:.1f}")
    if peak > must:
        fail("the streamed step held more than its parameters, moments, "
             "saved maps and workspace: a padded, dilated or dz copy?")
    del tr
    torch.cuda.empty_cache()
    stamp(17)

    tpu = {"conv2d_stream_fwd": TPU_STREAM, "conv2d_stream_dgrad": TPU_STREAM,
           "conv2d_stream_wgrad": TPU_STREAM_WGRAD}
    entries = []
    for kind, name in names.items():
        v = sums[kind]
        label = f"{name} (stream_fwd_kernel)" if kind == "fwd" else name
        entries.append({
            "name": label, "route": "cuda", "source": STREAM_SOURCE,
            "replaces": tpu[name], "launches": served[name] + trained[name],
            "max_abs_err": err[name], "ms": v[0], "plain_ms": v[4],
            "bound_ms": v[6], "bound_by": mostly(kinds[kind]),
            "library_ms": v[5]})
    counts = {k: served[k] + trained[k] for k in served}
    return entries, counts


def lm_mixers(attend_fn, conv_fn):
    """Within this context each attention layer calls ``attend_fn`` where
    it calls ``kernels.flash_attention.attend``, and each Mamba layer
    ``conv_fn`` for ``kernels.conv1d_depthwise.conv1d_depthwise``; the
    names are restored after."""
    import contextlib
    from repro_torch.nn import attention, ssm

    @contextlib.contextmanager
    def ctx():
        saved = attention.attend, ssm.conv1d_depthwise
        attention.attend, ssm.conv1d_depthwise = attend_fn, conv_fn
        try:
            yield
        finally:
            attention.attend, ssm.conv1d_depthwise = saved
    return ctx()


def plain_lm_kernels():
    """Within this context the language models run the plain versions of
    their kernels on the card (the same model's plain path)."""
    from repro_torch.core.direct_conv import direct_conv1d_depthwise
    from repro_torch.kernels.flash_attention import attend_plain
    return lm_mixers(attend_plain, direct_conv1d_depthwise)


def control_lm_kernels(kernel: str):
    """The control of 19(c)/20(c): the plain path with ``kernel``'s sums in
    another sound order.  Attention: the plain online softmax over chunks of
    the kernel's key block (``BF16_BLOCK_K`` keys for bf16, ``BLOCK_K`` for
    f32: 64 either way) instead of 2048, so that it rescales a row as often
    as the kernel does (32 times at S 2048); conv1d: the taps added in
    descending k instead of ascending."""
    from repro_torch.core.direct_conv import direct_conv1d_depthwise
    from repro_torch.kernels.flash_attention import (BF16_BLOCK_K, BLOCK_K,
                                                     attend_plain)

    def attend_blocked(q, *a, **kw):
        block = BF16_BLOCK_K if q.dtype == torch.bfloat16 else BLOCK_K
        return attend_plain(q, *a, **{**kw, "chunk": block})

    def conv_descending(x, w, bias=None):
        b, n, d = x.shape
        xp = F.pad(x, (0, 0, w.shape[0] - 1, 0))
        acc = torch.zeros((b, n, d), dtype=torch.float32, device=x.device)
        for i in reversed(range(w.shape[0])):
            acc = acc + xp[:, i:i + n, :].float() * w[i].float()
        if bias is not None:
            acc = acc + bias.float()
        return acc.to(x.dtype)

    if kernel == "flash_attention":
        return lm_mixers(attend_blocked, direct_conv1d_depthwise)
    return lm_mixers(attend_plain, conv_descending)


def attend_exact(q, k, v, *, q_positions, kv_positions, causal=True,
                 window=None, cap=None, scale, kv_valid=None, **_):
    """``attend``'s masked softmax attention in f64 and in one piece (no
    online rescaling): q [B,Sq,KV,G,Dh], k/v [B,Skv,KV,Dh] -> f64 like
    q."""
    s = torch.einsum("bskgd,bckd->bskgc", q.double(), k.double()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    kp, qp = kv_positions[:, None, :], q_positions[:, :, None]
    valid = kp >= 0
    if kv_valid is not None:
        valid = valid & (kp < kv_valid[:, None, None])
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    return torch.einsum("bskgc,bckd->bskgd", torch.softmax(s, dim=-1),
                        v.double())


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_lm(label: str, got, want, quiet: bool = False) -> float:
    """Kernel vs plain version, both in the working dtype: within
    ``KERNEL_REL * max|want| + KERNEL_ABS`` (the same f32 sums in another
    order), and for bf16 one bf16 ulp more (the plain version rounds its f32
    result once, the kernel too, to neighbouring values at worst).  -> max
    abs error.  ``quiet`` prints only a failure."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: {tuple(got.shape)} {got.dtype} != "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        fail(f"{label}: non-finite output")
    err = (g - w).abs()
    bound = KERNEL_REL * w.abs().max() + KERNEL_ABS
    if want.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    ok = bool((err <= bound).all())
    rel = (err.max() / w.abs().max().clamp_min(1e-30)).item()
    if not quiet or not ok:
        print(f"[check] {label}: max_abs_err={err.max().item():.3e} "
              f"rel-to-max={rel:.3e} worst err/bound="
              f"{(err / bound).max().item():.3f} -> "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return err.max().item()


def lm_phases(args, dev, t_start):
    """Phases 18-21: the flash-attention and conv1d kernels, and
    h2o-danube-1.8b and mamba2-780m at full width and depth, prefilled and
    served.  -> (the two kernels' entries of the ``{"kernels": [...]}``
    line, their launches in the main-path runs)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.direct_conv import direct_conv1d_depthwise
    from repro_torch.core.layout import (blocked_to_bld, bld_to_blocked,
                                         kd_to_blocked, largest_divisor_leq)
    from repro_torch.kernels import conv1d_depthwise as c1k
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.nn.models import build_model
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.serve.scheduler import ContinuousBatcher, Request
    from repro_torch.train.trainstep import make_prefill_step

    gen = torch.Generator(device=dev).manual_seed(args.seed + 30)
    err = {"flash_attention": 0.0, "conv1d_depthwise": 0.0}

    def stamp(phase):
        print(f"[time] phase {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def reset():
        fak.reset_launches()
        c1k.reset_launches()

    def counts():
        return {**fak.LAUNCHES, **c1k.LAUNCHES}

    def randn(shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def record(name, label, got, want):
        err[name] = max(err[name], compare_lm(label, got, want))

    def launched(fn):
        """``fn()`` and the flash kernel it launched, read from the
        wrapper's counts by kernel (exactly one launch)."""
        before = dict(fak.KERNEL_LAUNCHES)
        out = fn()
        ran = [k for k, n in fak.KERNEL_LAUNCHES.items()
               if n != before[k]]
        if len(ran) != 1 or fak.KERNEL_LAUNCHES[ran[0]] != \
                before[ran[0]] + 1:
            fail(f"one flash launch expected, the counts moved from "
                 f"{before} to {fak.KERNEL_LAUNCHES}")
        return out, ran[0]

    # -- 18. the kernels vs their plain versions ----------------------------
    danube, mamba = get_config("h2o-danube-1.8b"), get_config("mamba2-780m")
    hq, hkv, dh = danube.n_heads, danube.n_kv_heads, danube.head_dim
    # b, s, kv heads, groups, dh, dtype, causal, window, cap, kv_valid,
    # position stride (0: arange)
    flash_cases = [
        ("danube prefill", LM_BATCH, LM_SEQ, hkv, hq // hkv, dh,
         torch.float32, True, None, None, None, 0),
        ("danube prefill", LM_BATCH, LM_SEQ, hkv, hq // hkv, dh,
         torch.bfloat16, True, None, None, None, 0),
        ("window 256", 1, 1024, hkv, hq // hkv, dh, torch.float32, True,
         256, None, None, 0),
        ("softcap 50", 1, 1024, 4, 2, 128, torch.bfloat16, True, None, 50.0,
         None, 0),
        ("non-causal", 1, 512, 4, 2, 64, torch.float32, False, None, None,
         None, 0),
        ("MQA", 1, 1024, 1, 8, 128, torch.bfloat16, True, None, None, None,
         0),
        ("Dh 128", 1, 1024, 8, 4, 128, torch.float32, True, None, None, None,
         0),
        # deepseek-coder's grouping: 56 q-heads over 8 KV heads, G = 7 (no
        # power of two: 18 positions x 7 heads fill 126 of a CTA's rows)
        ("G 7", 1, 1024, 8, 7, 128, torch.bfloat16, True, None, None, None,
         0),
        ("ragged S 1000", 2, 1000, hkv, hq // hkv, dh, torch.float32, True,
         None, None, None, 0),
        ("kv_valid, positions 3i+7, softcap", 2, 700, 2, 4, dh,
         torch.float32, True, None, 50.0, (2200, 333), 3),
        # batch 1's rows past position 150 + 64 see no key: the reference's
        # average of v over the scanned keys
        ("rows that see no key: kv_valid, window, positions 2i+7", 2, 260,
         1, 6, 128, torch.bfloat16, True, 64, None, (300, 150), 2),
        ("rows that see no key: kv_valid, window, positions 2i+7", 2, 260,
         1, 6, 128, torch.float32, True, 64, None, (300, 150), 2),
        # past the tensor-core kernel's head dims: f32 on CUDA cores
        ("Dh 256: kv_valid, window 128", 2, 512, 2, 2, 256, torch.float32,
         True, 128, None, (512, 300), 0),
    ]
    seen = set()              # the flash kernels phase 18 launched
    with torch.no_grad():
        for (label, b, s, nkv, g, d, dtype, causal, window, cap, kv_valid,
             off) in flash_cases:
            q = randn((b, s, nkv, g, d), dtype)
            k, v = randn((b, s, nkv, d), dtype), randn((b, s, nkv, d), dtype)
            # positions arange(s), or off * arange(s) + 7 (not arange)
            qp = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
                b, s)
            if off:
                qp = off * qp + 7
            kw = dict(q_positions=qp, kv_positions=qp, causal=causal,
                      window=window, cap=cap, scale=d ** -0.5,
                      kv_valid=None if kv_valid is None else
                      torch.tensor(kv_valid, device=dev))
            got, ran = launched(lambda: fak.attend(q, k, v, **kw))
            want = fak.attend_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            seen.add(ran)
            record("flash_attention",
                   f"flash {label} B{b} S{s} KV{nkv} G{g} Dh{d} "
                   f"{str(dtype)[6:]} on {ran}", got, want)
            del q, k, v, got, want
        # MQA's one K/V head expanded over danube's 8 (kv-head stride 0,
        # no TMA map of it): f32 on CUDA cores
        q = randn((1, 1024, hkv, hq // hkv, dh), torch.float32)
        k, v = (randn((1, 1024, 1, dh), torch.float32).expand(
            1, 1024, hkv, dh) for _ in range(2))
        pos = torch.arange(1024, device=dev, dtype=torch.int32)[None]
        kw = dict(q_positions=pos, kv_positions=pos, scale=dh ** -0.5)
        got, ran = launched(lambda: fak.attend(q, k, v, **kw))
        seen.add(ran)
        record("flash_attention", f"flash expanded K/V (kv-head stride 0) "
               f"B1 S1024 KV{hkv} G{hq // hkv} Dh{dh} float32 on {ran}",
               got, fak.attend_plain(q, k, v, **kw))
        del q, k, v, got
        # the TPU kernel's [B, H, S, Dh] entry, on strided views
        for dtype in (torch.bfloat16, torch.float32):
            q = randn((LM_BATCH, 512, hq, dh), dtype).transpose(1, 2)
            k = randn((LM_BATCH, 512, hkv, dh), dtype).transpose(1, 2)
            v = randn((LM_BATCH, 512, hkv, dh), dtype).transpose(1, 2)
            got, ran = launched(
                lambda: fak.flash_attention(q, k, v, scale=dh ** -0.5))
            seen.add(ran)
            record("flash_attention", f"flash_attention [B,H,S,Dh] views "
                   f"{str(dtype)[6:]} on {ran}", got,
                   fak.flash_attention_plain(q, k, v, scale=dh ** -0.5))
        if seen != set(fak.KERNEL_CODES):
            fail(f"phase 18 launched the flash kernels {sorted(seen)}, not "
                 f"all of {sorted(fak.KERNEL_CODES)}")

        cd, kt = mamba.ssm.conv_dim(mamba.d_model), mamba.ssm.d_conv
        di = mamba.ssm.d_inner(mamba.d_model)
        width = 2 * di + 2 * mamba.ssm.n_groups * mamba.ssm.d_state + \
            mamba.ssm.n_heads(mamba.d_model)
        for dtype in (torch.float32, torch.bfloat16):
            zx = randn((LM_BATCH, LM_SEQ, width), dtype)
            w, bias = randn((kt, cd), dtype), randn((cd,), dtype)
            for label, x in (("in_proj slice", zx[:, :, di:di + cd]),
                             ("contiguous",
                              zx[:, :, di:di + cd].contiguous()),
                             (f"ragged L {LM_SEQ - 48}",
                              zx[:, :LM_SEQ - 48, di:di + cd])):
                record("conv1d_depthwise",
                       f"conv1d {label} {tuple(x.shape)} stride "
                       f"{x.stride(1)} {str(dtype)[6:]}",
                       c1k.conv1d_depthwise(x, w, bias),
                       direct_conv1d_depthwise(x, w, bias))
            db = largest_divisor_leq(cd, 128)     # the reference's pencil
            xb = bld_to_blocked(zx[:, :, di:di + cd], db).contiguous()
            got = blocked_to_bld(c1k.conv1d_depthwise_blocked(
                xb, kd_to_blocked(w, db)))
            record("conv1d_depthwise", f"conv1d blocked [B, D/{db}, L, {db}] "
                   f"{str(dtype)[6:]}", got,
                   direct_conv1d_depthwise(zx[:, :, di:di + cd], w, None))
            del zx, xb, got
        torch.cuda.synchronize()
    stamp(18)

    # -- 19-20. the models -------------------------------------------------
    launches = {"flash_attention": 0, "conv1d_depthwise": 0}
    model_times = {}
    rng = np.random.default_rng(args.seed)

    def serve(arch, tag, model, prefill, prompts, tol):
        """19(d)/20(d): the ContinuousBatcher answers ``prompts`` at batch
        SERVE_BATCH, cache SERVE_CACHE, SERVE_NEW new tokens each; every
        request must complete, and every first token is checked against
        the kernel prefill's last-position logits of its prompt: where
        their top-2 gap exceeds ``tol`` it must be the argmax, else its
        logit must lie within ``tol`` of the maximum (a near tie that the
        decode path may break either way).  The batcher feeds prompts
        token by token through ``decode_step``, as the reference does, so
        serving launches neither kernel; the checking prefills' launches
        are no main-path launches.  -> (first tokens checked by argmax,
        checked by distance from the max)."""
        batcher = ContinuousBatcher(model, batch=SERVE_BATCH,
                                    cache_len=SERVE_CACHE)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
                for i, p in enumerate(prompts)]
        reset()
        t0 = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        done = batcher.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        served = counts()
        if any(served.values()):
            fail(f"{arch} {tag}: serving launched {served}; decode_step "
                 "runs no kernel")
        if len(done) != len(reqs) or any(
                len(r.out_tokens) != SERVE_NEW for r in reqs):
            fail(f"{arch} {tag}: {len(done)} of {len(reqs)} requests served")
        by_argmax = by_distance = 0
        bands = []          # per request checked by distance: vocabulary
        for r in reqs:      # tokens within tol of the max, what it admits
            lg = prefill({"tokens": torch.from_numpy(
                r.prompt.astype(np.int64))[None].to(dev)})[0, -1].double()
            top2 = torch.topk(lg, 2).values
            gap = (top2[0] - top2[1]).item()
            tok = r.out_tokens[0]
            if gap > tol:
                by_argmax += 1
                if int(lg.argmax()) != tok:
                    fail(f"{arch} {tag}: request {r.rid}'s first token "
                         f"{tok} != the prefill argmax {int(lg.argmax())} "
                         f"(top-2 gap {gap:.4f} > {tol:.4f})")
                continue
            by_distance += 1
            bands.append(int((lg >= top2[0] - tol).sum()))
            short = (top2[0] - lg[tok]).item()
            if not short <= tol:
                fail(f"{arch} {tag}: request {r.rid}'s first token {tok} "
                     f"has a prefill logit {short:.4f} below the max "
                     f"(tolerance {tol:.4f}, top-2 gap {gap:.4f})")
        print(f"[{arch}] (d) {tag} ContinuousBatcher batch {SERVE_BATCH} "
              f"cache {SERVE_CACHE}: {len(done)}/{len(reqs)} requests of "
              f"{[len(p) for p in prompts]} prompt tokens, {SERVE_NEW} new "
              f"each, {batcher.decode_steps} decode steps in {serve_s:.2f} "
              f"s, launches while serving {served}; all {len(reqs)} first "
              f"tokens checked: {by_argmax} = the kernel prefill's argmax "
              f"(top-2 gap above {tol:.4f}), {by_distance} within "
              f"{tol:.4f} of its max (gap within it), admitting "
              f"{bands} of the {lg.numel()} vocabulary tokens "
              f"(largest {max(bands, default=0)})")
        return by_argmax, by_distance

    def decode_logits(model, toks, steps, dtype=None):
        """decode_step's logits over the first ``steps`` tokens of ``toks``,
        with a cache of ``dtype`` (None: the batcher's, the model's
        default)."""
        step = make_serve_step(model)
        cache = model.init_cache(LM_BATCH, steps, **(
            {} if dtype is None else {"dtype": dtype}))
        dec = []
        for t in range(steps):
            lg, cache = step(cache, toks[:, t:t + 1], t)
            dec.append(lg[:, 0])
        return torch.stack(dec, dim=1)

    def tie_threshold(arch, tag, model, toks, logits, gate):
        """The top-2 gap above which (d) holds a first token to the argmax,
        and below which to a logit within it of the max: the served
        token comes from decode_step with the batcher's cache, so at least
        twice the distance of its logits from the kernel prefill's, measured
        over the longest prompt's length, and at least ``gate``."""
        dec = decode_logits(model, toks, SERVE_PROMPT_MAX)
        r = (dec.double() - logits[:, :SERVE_PROMPT_MAX].double()).abs()
        r = r.max().item()
        tol = max(gate, 2 * r)
        print(f"[{arch}] (d) {tag} tie threshold: max(gate {gate:.4f}, 2 x "
              f"|decode (batcher's cache) - kernel prefill| over "
              f"{SERVE_PROMPT_MAX} tokens {r:.4f}) = {tol:.4f}")
        return tol

    def layer_checks(arch, tag, cfg, kernel, prefill, batch):
        """Each layer's call of ``kernel`` in one more ``prefill``, on that
        layer's own inputs: the kernel against its plain version under
        phase 18's tolerance.  For attention in f32 also with q scaled so
        that the scores are as large as the reference's init makes them,
        whose fan-in over the heads axis draws q and k sqrt(d/H) and
        sqrt(d/KV) times larger (160 in danube): there the kernel's distance
        to the same attention in f64 is held to EXACT_MULT times the plain
        version's, plus the kernel tolerance."""
        calls = []
        run, plain = ((fak.attend, fak.attend_plain)
                      if kernel == "flash_attention" else
                      (c1k.conv1d_depthwise, direct_conv1d_depthwise))

        def keep(*a, **kw):
            calls.append((a, kw))
            return run(*a, **kw)
        with lm_mixers(*((keep, c1k.conv1d_depthwise)
                         if kernel == "flash_attention" else
                         (fak.attend, keep))):
            prefill(batch)
        if len(calls) != cfg.n_layers:
            fail(f"{arch}: {len(calls)} {kernel} calls, {cfg.n_layers} "
                 "layers")
        worst = 0.0
        for i, (a, kw) in enumerate(calls):
            worst = max(worst, compare_lm(
                f"{arch} {tag} layer {i} {kernel}", run(*a, **kw),
                plain(*a, **kw), quiet=True))
        err[kernel] = max(err[kernel], worst)
        line = (f"[{arch}] {tag} per layer: {len(calls)} {kernel} calls on "
                f"the layers' own inputs, kernel vs plain max_abs_err "
                f"{worst:.3e} (phase-18 tolerance)")
        if kernel == "flash_attention" and \
                calls[0][0][0].dtype == torch.float32:
            factor = cfg.d_model / (cfg.n_heads * cfg.n_kv_heads) ** 0.5
            far = {"kernel": 0.0, "plain": 0.0, "ratio": 0.0}
            for i, ((q, k, v), kw) in enumerate(calls):
                qs = q * factor
                exact = attend_exact(qs, k, v, **kw)
                ek = (run(qs, k, v, **kw).double() - exact).abs().max()
                ep = (plain(qs, k, v, **kw).double() - exact).abs().max()
                bound = (EXACT_MULT * ep + KERNEL_REL * exact.abs().max()
                         + KERNEL_ABS).item()
                ek, ep = ek.item(), ep.item()
                far["kernel"] = max(far["kernel"], ek)
                far["plain"] = max(far["plain"], ep)
                far["ratio"] = max(far["ratio"], ek / bound)
                if ek > bound:
                    fail(f"{arch} layer {i}: at scores x{factor:.0f} the "
                         f"kernel is {ek:.3e} from f64, the plain version "
                         f"{ep:.3e} (bound {bound:.3e})")
                del exact, qs
            line += (f"; with scores x{factor:.0f} (the reference's init), "
                     f"distance to f64: kernel {far['kernel']:.3e}, plain "
                     f"{far['plain']:.3e}, worst kernel/bound "
                     f"{far['ratio']:.3f}")
        print(line + " -> ok")
        del calls
        torch.cuda.empty_cache()

    def hidden_drift(arch, cfg32, model16, cfg16, batch):
        """20(e), a measurement: each layer's output in the bf16 kernel and
        bf16 plain prefills against the f32 plain prefill's, max|h - h_f32|
        relative to max|h_f32|, with the port's init (``a_log``/``dt_bias``
        drawn as published Mamba-2 draws them: A uniform in [1, 16], dt
        log-uniform in [1e-3, 1e-1]); then again with the reference's, both
        0, in both models.  Runs after every other check and time of the
        model: it draws the f32 model again from the seed and zeroes both
        models' ``a_log``/``dt_bias``."""
        import contextlib
        model32 = build_model(cfg32, dev, torch.Generator().manual_seed(
            args.seed))

        def prefill(model, cfg, plain, hook):
            handles = [layer.register_forward_hook(hook)
                       for layer in model.layers]
            try:
                with (plain_lm_kernels() if plain
                      else contextlib.nullcontext()):
                    return make_prefill_step(model, cfg)(batch)
            finally:
                for h in handles:
                    h.remove()

        def measure(init):
            ref = []
            want = prefill(model32, cfg32, True,
                           lambda m, i, out: ref.append(out[0].float()))
            for tag, plain in (("bf16 kernel", False), ("bf16 plain", True)):
                drift = []

                def against(m, i, out):
                    r = ref[len(drift)]
                    drift.append(((out[0].float() - r).abs().max()
                                  / r.abs().max()).item())
                got = prefill(model16, cfg16, plain, against)
                logit = ((got.float() - want).abs().max()
                         / want.abs().max()).item()
                print(f"[{arch}] (e) {init} init, {tag} prefill: hidden "
                      f"state vs the f32 plain prefill's, max|h - h_f32| / "
                      f"max|h_f32| by layer: "
                      + " ".join(f"{d:.2e}" for d in drift)
                      + f"; largest {max(drift):.3e}; logits {logit:.3e}")
            del ref, want

        measure("the port's (published)")
        for layer in (*model32.layers, *model16.layers):
            layer.mamba.a_log.zero_()
            layer.mamba.dt_bias.zero_()
        measure("the reference's (zero)")
        del model32
        torch.cuda.empty_cache()

    def run_model(phase, arch, kernel, per_forward):
        cfg16 = get_config(arch)
        cfg32 = dataclasses.replace(cfg16, dtype="float32",
                                    param_dtype="float32")
        toks = torch.from_numpy(rng.integers(
            0, cfg16.vocab_size, (LM_BATCH, LM_SEQ), dtype=np.int64)).to(dev)
        batch = {"tokens": toks}
        want = {"flash_attention": per_forward if kernel == "flash_attention"
                else 0,
                "conv1d_depthwise": per_forward
                if kernel == "conv1d_depthwise" else 0}
        t0 = time.perf_counter()
        model = build_model(cfg32, dev, torch.Generator().manual_seed(
            args.seed))
        n_par = sum(p.numel() for p in model.parameters())
        print(f"[{arch}] f32 model: {n_par} parameters (config n_params "
              f"{cfg16.n_params()}), drawn in "
              f"{time.perf_counter() - t0:.1f} s")
        # (a) f32 prefill through the kernels vs the plain path
        prefill = make_prefill_step(model, cfg32)
        reset()
        logits = prefill(batch)
        torch.cuda.synchronize()
        got = counts()
        print(f"[{arch}] (a) f32 prefill B{LM_BATCH} S{LM_SEQ}: launches "
              f"{got}")
        if got != want:
            fail(f"{arch}: expected launches {want} a forward, got {got}")
        for k in launches:
            launches[k] += got[k]
        with plain_lm_kernels():
            reset()
            plain = prefill(batch)
            torch.cuda.synchronize()
            if any(counts().values()):
                fail(f"{arch}: the plain path launched {counts()}")
        scale = plain.abs().max().item()
        compare(f"{arch} (a) f32 prefill logits vs plain path", logits,
                plain, atol=LOGIT_RTOL * scale, rtol=0.0)
        layer_checks(arch, "(a) f32", cfg32, kernel, prefill, batch)
        times = {"f32_prefill_ms": time_ms(lambda: prefill(batch), iters=3,
                                           warmup=1)}
        with plain_lm_kernels():
            times["f32_plain_prefill_ms"] = time_ms(lambda: prefill(batch),
                                                    iters=2, warmup=1)
        del plain
        # (b) decode against the forward, f32 cache
        dec = decode_logits(model, toks, DECODE_CHECK, torch.float32)
        compare(f"{arch} (b) decode_step x{DECODE_CHECK} vs prefill logits",
                dec, logits[:, :DECODE_CHECK], atol=DECODE_TOL,
                rtol=DECODE_TOL)
        # (d) in f32 first, where the decode path lies closest to the
        # prefill, so that most first tokens are checked
        prompts = [rng.integers(0, cfg16.vocab_size, (int(n),),
                                dtype=np.int32)
                   for n in rng.integers(8, SERVE_PROMPT_MAX + 1,
                                         SERVE_REQUESTS)]
        by_argmax, _ = serve(arch, "f32", model, prefill, prompts,
                             tie_threshold(arch, "f32", model, toks, logits,
                                           LOGIT_RTOL * scale))
        if by_argmax == 0:
            fail(f"{arch}: no f32 request's first token cleared the tie "
                 "threshold for the argmax check")
        del model, prefill, logits, dec
        torch.cuda.empty_cache()

        # (c) the published bf16 config through the kernels vs its plain path
        model = build_model(cfg16, dev, torch.Generator().manual_seed(
            args.seed))
        p_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        prefill = make_prefill_step(model, cfg16)
        reset()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = prefill(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = counts()
        if got != want:
            fail(f"{arch}: expected launches {want} a bf16 forward, got "
                 f"{got}")
        for k in launches:
            launches[k] += got[k]
        with plain_lm_kernels():
            plain = prefill(batch)
        with control_lm_kernels(kernel):
            control = prefill(batch)
        r_control = (control.double() - plain.double()).abs().max().item()
        tol_c = BF16_CONTROL_MULT * r_control
        print(f"[{arch}] (c) bf16 rule: |kernel - plain| <= "
              f"{BF16_CONTROL_MULT} x the control's |control - plain| = "
              f"{BF16_CONTROL_MULT} x {r_control:.4f} = {tol_c:.4f} "
              f"(max|plain logit| {plain.abs().max().item():.4f})")
        compare(f"{arch} (c) bf16 prefill logits vs plain path", logits,
                plain, atol=tol_c, rtol=0.0)
        layer_checks(arch, "(c) bf16", cfg16, kernel, prefill, batch)
        tol_d = tie_threshold(arch, "bf16", model, toks, logits, tol_c)
        del control
        times["bf16_prefill_ms"] = time_ms(lambda: prefill(batch), iters=3,
                                           warmup=1)
        with plain_lm_kernels():
            times["bf16_plain_prefill_ms"] = time_ms(lambda: prefill(batch),
                                                     iters=2, warmup=1)
        split = device_split(lambda: prefill(batch))
        if split is None:
            print(f"[{arch}] bf16 prefill by kernel: torch.profiler records "
                  "no device time here (not measured)")
        else:
            wall, busy, top = split
            print(f"[{arch}] bf16 prefill under torch.profiler: wall "
                  f"{wall:.2f} ms, device busy {busy:.2f} ms (idle share "
                  f"{1 - busy / wall:.3f}); by kernel: " + "; ".join(
                      f"{name[:70]} {ms:.3f} ms x{n}" for name, ms, n in top))
        times["bf16_prefill_peak_mib"] = peak / 2 ** 20
        times["bf16_prefill_peak_above_params_mib"] = (peak - base) / 2 ** 20
        times["param_mib"] = p_bytes / 2 ** 20
        del plain, logits
        torch.cuda.empty_cache()

        # (d) the ContinuousBatcher serves the requests, bf16
        serve(arch, "bf16", model, prefill, prompts, tol_d)

        # decode ms a step at batch 4 against a cache of SERVE_CACHE
        step = make_serve_step(model)
        cache = model.init_cache(SERVE_BATCH, SERVE_CACHE)
        c_bytes = sum(t.numel() * t.element_size()
                      for entry in cache for t in entry)
        tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int64, device=dev)
        state = {"cache": cache, "pos": 0}

        def one():
            _, state["cache"] = step(state["cache"], tok, state["pos"])
            state["pos"] += 1
        times["bf16_decode_ms"] = time_ms(one, iters=20, warmup=3)
        times["cache_mib"] = c_bytes / 2 ** 20
        for key in ("f32", "bf16"):
            times[f"{key}_prefill_tok_s"] = (LM_BATCH * LM_SEQ * 1e3
                                             / times[f"{key}_prefill_ms"])
        model_times[arch] = times
        print(f"[{arch}] times " + json.dumps(times))
        del prefill, step, state, cache
        torch.cuda.empty_cache()
        if kernel == "conv1d_depthwise":
            hidden_drift(arch, cfg32, model, cfg16, batch)
        del model
        torch.cuda.empty_cache()
        stamp(phase)

    run_model(19, "h2o-danube-1.8b", "flash_attention", danube.n_layers)
    run_model(20, "mamba2-780m", "conv1d_depthwise", mamba.n_layers)

    # -- 21. per-kernel times at the models' shapes --------------------------
    rows = {}
    with torch.no_grad():
        for dtype, peak in ((torch.float32, PEAK_F32_FLOPS),
                            (torch.bfloat16, PEAK_BF16_FLOPS)):
            b, s = LM_BATCH, LM_SEQ
            q = randn((b, s, hkv, hq // hkv, dh), dtype)
            k, v = randn((b, s, hkv, dh), dtype), randn((b, s, hkv, dh), dtype)
            pos = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
                b, s).contiguous()
            kw = dict(q_positions=pos, kv_positions=pos, scale=dh ** -0.5)
            # SDPA on [B, H, S, Dh] views of the same tensors, with GQA
            # (enable_gqa) and on K/V repeated to H heads before timing;
            # each backend runs what it takes, and the faster is the
            # library's time
            qh = q.reshape(b, s, hq, dh).transpose(1, 2)
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            kr = kh.repeat_interleave(hq // hkv, dim=1)
            vr = vh.repeat_interleave(hq // hkv, dim=1)
            sdpa = {"K/V repeated": lambda: F.scaled_dot_product_attention(
                qh, kr, vr, is_causal=True, scale=dh ** -0.5)}
            try:
                F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, scale=dh ** -0.5,
                    enable_gqa=True)
                sdpa["GQA"] = lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, scale=dh ** -0.5,
                    enable_gqa=True)
            except TypeError:            # a torch without enable_gqa
                print("[lm-time] SDPA has no enable_gqa here")
            sdpa_ms = {k_: time_ms(fn) for k_, fn in sdpa.items()}
            print(f"[lm-time] SDPA {str(dtype)[6:]} at danube's prefill: "
                  + " ".join(f"{k_} {v_:.4f} ms" for k_, v_ in
                             sdpa_ms.items()), flush=True)
            pairs = s * (s + 1) // 2
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            # the function's 4 Dh FLOPs an unmasked pair (q.k and p v);
            # the bf16 kernel runs p v twice, on p's two bf16 halves, and
            # so executes 6 Dh, printed beside the bound; f32 runs on the
            # tensor cores as three TF32 products (the f32 FMA bound beside)
            flops = 4 * b * hq * dh * pairs
            t_bytes = nbytes / HBM_BYTES_PER_S
            if dtype == torch.bfloat16:
                t_ops = flops / peak
                note = (f" (the split P @ V executes 6 Dh FLOPs a pair: "
                        f"{max(1.5 * t_ops, t_bytes) * 1e3:.4f} ms at peak)")
            else:
                t_ops = 3 * flops / PEAK_TF32_FLOPS
                t_fma = max(flops / peak, t_bytes)
                _, ran = launched(lambda: fak.attend(q, k, v, **kw))
                note = f" (3xTF32; f32 FMA {t_fma * 1e3:.4f} ms; on {ran})"
            rows[("flash_attention", dtype)] = (
                time_ms(lambda: fak.attend(q, k, v, **kw)),
                graph_ms(lambda: fak.attend(q, k, v, **kw)),
                time_ms(lambda: fak.attend_plain(q, k, v, **kw), iters=3),
                min(sdpa_ms.values()), max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes", note)
            del q, k, v, qh, kh, vh, kr, vr, sdpa

            zx = randn((b, s, width), dtype)
            x = zx[:, :, di:di + cd]
            w, bias = randn((kt, cd), dtype), randn((cd,), dtype)
            xt = x.transpose(1, 2).contiguous()           # [B, D, L]
            wt = w.t().reshape(cd, 1, kt).contiguous()
            nbytes = (2 * x.numel() + w.numel() + bias.numel()) * \
                x.element_size()
            rows[("conv1d_depthwise", dtype)] = (
                time_ms(lambda: c1k.conv1d_depthwise(x, w, bias)),
                graph_ms(lambda: c1k.conv1d_depthwise(x, w, bias)),
                time_ms(lambda: direct_conv1d_depthwise(x, w, bias)),
                time_ms(lambda: F.conv1d(xt, wt, bias, padding=kt - 1,
                                         groups=cd)),
                nbytes / HBM_BYTES_PER_S * 1e3, "bytes", "")
            del zx, x, xt
    where = {"flash_attention": f"danube B{LM_BATCH} S{LM_SEQ} H{hq} "
             f"KV{hkv} Dh{dh} causal",
             "conv1d_depthwise": f"mamba2 B{LM_BATCH} L{LM_SEQ} D{cd} "
             f"K{kt} (in_proj slice)"}
    for (name, dtype), v in rows.items():
        print(f"[lm-time] {name} {str(dtype)[6:]} at {where[name]}"
              f": ms {v[0]:.4f} device_ms {v[1]:.4f} plain_ms {v[2]:.4f} "
              f"library_ms {v[3]:.4f} bound_ms {v[4]:.4f} ({v[5]}){v[6]} "
              f"share of bound {v[4] / v[1]:.3f}")
    stamp(21)

    source = {"flash_attention": (FLASH_SOURCE, TPU_FLASH),
              "conv1d_depthwise": (CONV1D_SOURCE, TPU_CONV1D)}
    entries = []
    for name, (src, tpu) in source.items():
        v = rows[(name, torch.bfloat16)]     # the published configs' dtype
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": v[0], "plain_ms": v[2], "bound_ms": v[4], "bound_by": v[5],
            "library_ms": v[3]})
    print(f"[lm] launches of the main-path runs (each model's f32 and bf16 "
          f"prefill; serving launches none): {launches}")
    return entries, launches


def bf16_close(label: str, got, want) -> float:
    """Print and check a bf16 kernel against its plain version under BF16:
    both round f32 sums of the same bf16 products once to bf16, in other
    orders, so each element within one bf16 ulp of its magnitude plus
    ``BF16_FWD_REL`` of max|want|; -> max abs error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: {got.dtype} {tuple(got.shape)} against "
             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    g, w = got.double(), want.double()
    err = (g - w).abs()
    bound = (bf16_ulp(w) + BF16_FWD_REL * w.abs().max())
    worst = (err / bound).max().item()
    ok = worst <= 1.0
    print(f"[bf16] {label}: max_abs_err={err.max().item():.3e} worst "
          f"err/(1 bf16 ulp + {BF16_FWD_REL:g} max) {worst:.3f} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return err.max().item()


def bf16_phases(args, dev, t_start, model):
    """Phase 22: the bf16 build of the dense forward tile on both routes,
    the GAP replay, VGG-16 (``model``, phase 4's) served in bf16 through
    ``ConvServer`` on both routes, the layer times, peak memory, the layout
    and baseline checks, and a small ``ResidualBlock`` stack.  -> (the bf16
    kernels' entries of the ``{"kernels": [...]}`` line, the launches of the
    two bf16 main-path runs per kernel)."""
    from repro_torch.configs.cnn import vgg16_layers
    from repro_torch.core import conv2d_common
    from repro_torch.core import conv_baselines as base
    from repro_torch.core import layout as L
    from repro_torch.core import memory_model as mm
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.core.precision import Precision
    from repro_torch.kernels import conv2d_stream as stk
    from repro_torch.kernels.direct_conv2d import (LAUNCHES,
                                                   direct_conv2d_blocked,
                                                   fwd_plans, gap_forward)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.nn.conv import BlockedCNN, BlockedConv2D, ResidualBlock
    from repro_torch.serve.scheduler import ConvRequest, Outcome

    gen = torch.Generator(device=dev).manual_seed(args.seed + 40)
    names = {False: "direct_conv2d_fwd_bf16", True: "conv2d_stream_fwd_bf16"}

    def launches(streamed):
        return (stk.LAUNCHES if streamed else LAUNCHES)[names[streamed]]

    def operands(n, ci, co, h, stride, residual=False):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")
        r = (torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                         generator=gen).bfloat16() if residual else None)
        return x.bfloat16(), w, b, r, spec

    def layer_shapes(entry):
        out, h = [], entry
        for ci, co, s in vgg16_layers():
            out.append((ci, co, s, h))
            h = -(-h // s)
        return out

    # -- 22(a) each bf16 forward against its plain version ------------------
    served = [sh for bh, _ in BUCKETS for sh in layer_shapes(bh)]
    checked = sorted(set(served), key=served.index)
    max_err = {False: 0.0, True: 0.0}
    with torch.no_grad():
        for ci, co, s, h in checked:
            x, w, b, _, _ = operands(BATCH, ci, co, h, s)
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu", "bf16")
            for streamed in (False, True):
                got = direct_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                            precision="bf16",
                                            stream=streamed)
                again = direct_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                              precision="bf16",
                                              stream=streamed)
                torch.cuda.synchronize()
                label = (f"{'streamed' if streamed else 'window'} conv "
                         f"{ci}->{co} {h}x{h} s{s} n{BATCH} relu")
                max_err[streamed] = max(max_err[streamed], bf16_close(
                    label, got, want))
                # no sum depends on which CTA of the persistent grid ran
                # first
                if not torch.equal(got, again):
                    fail(f"{label}: two runs differ")
                kernel, model_plan = fwd_plans(x, w, s, "SAME",
                                               streamed=streamed,
                                               dtype=torch.bfloat16)
                if kernel != model_plan:
                    fail(f"{label}: the kernel's plan {kernel} != the "
                         f"blocking model's {model_plan}")
            del x, w, want, got, again
        print("[bf16] every bf16 forward above: two runs, identical bits; "
              "its *_plan (tiles, MACs, shared memory, ring slots) the "
              "blocking model's")
        for n, ci, co, h, s in ((2, 3, 64, 20, 2), (2, 64, 128, 28, 1)):
            x, w, b, r, _ = operands(n, ci, co, h, s, residual=True)
            want = direct_conv_blocked(x, w, s, "SAME", b, "gelu", "bf16",
                                       residual=r, gap=True)
            for streamed in (False, True):
                got = direct_conv2d_blocked(x, w, b, s, "SAME", "gelu",
                                            residual=r, gap=True,
                                            precision="bf16",
                                            stream=streamed)
                torch.cuda.synchronize()
                max_err[streamed] = max(max_err[streamed], bf16_close(
                    f"{'streamed' if streamed else 'window'} conv {ci}->{co}"
                    f" {h}x{h} s{s} n{n} gelu+residual+gap", got, want))

        # -- 22(b) the GAP replay on the kernel's own stored map ------------
        ci, co, s, h = layer_shapes(ENTRY)[-1]
        cases = ((BATCH, ci, co, h, s, "relu", False),
                 (2, 3, 64, 20, 2, "gelu", True))
        for n, ci, co, h, s, act, res in cases:
            x, w, b, r, _ = operands(n, ci, co, h, s, residual=res)
            for prec in ("f32", "bf16"):
                xx = x if prec == "bf16" else x.float()
                rr = None if r is None else (r if prec == "bf16"
                                             else r.float())
                for streamed in (False, True):
                    pooled, _, out, blk = gap_forward(
                        xx, w, b, s, "SAME", act, rr, streamed=streamed,
                        precision=prec, with_map=True)
                    replay = conv2d_common.gap_replay(out, blk)
                    torch.cuda.synchronize()
                    route = "streamed" if streamed else "window"
                    if not torch.equal(replay, pooled):
                        fail(f"{route} {prec} GAP replay differs from the "
                             f"kernel's pooled features at {ci}->{co} "
                             f"{h}x{h}")
                    print(f"[bf16] GAP replay {route} {prec} {ci}->{co} "
                          f"{h}x{h} s{s} n{n} {act}"
                          f"{'+residual' if res else ''}: identical bits to "
                          f"the kernel's pooled {list(pooled.shape)} "
                          f"{pooled.dtype} over {blk.tiles} tiles of "
                          f"{blk.th}x{blk.tw}")

    # an fp16 policy has no build: refused on the card, never run in bf16,
    # in inference and in training
    x, w, b, _, _ = operands(2, 64, 64, 8, 1)
    fp16 = Precision(operand="float16")
    for streamed in (False, True):
        for call, what in (
                (lambda: direct_conv2d_blocked(
                    x.half(), w, b, 1, "SAME", "relu", precision=fp16,
                    stream=streamed), "fp16 inference"),
                (lambda: direct_conv2d_blocked(
                    x, w.requires_grad_(), b, 1, "SAME", "relu",
                    precision=fp16, stream=streamed), "fp16 training")):
            reset_all_launches()
            try:
                call()
            except NotImplementedError:
                pass
            else:
                fail(f"{what} on the {'streamed' if streamed else 'window'} "
                     "route ran instead of raising NotImplementedError")
            w.requires_grad_(False)
            if any(all_launches().values()):
                fail(f"{what} launched {all_launches()}")
    print("[bf16] fp16 inference and fp16 training raise NotImplementedError "
          "on both routes, no launch")
    print(f"[time] phase 22(a-b) done at {time.perf_counter() - t_start:.1f} s")

    # -- 22(c) VGG-16 served in bf16, window then streamed -------------------
    bf16 = ConvContext(precision="bf16")
    rng = np.random.default_rng(args.seed + 40)
    runs, counts = {}, {}
    for streamed in (False, True):
        ctx = ConvContext(precision="bf16", stream=streamed)
        server = ConvServer(model, list(BUCKETS), BATCH, device=dev,
                            context=ctx)
        server.warmup()
        reqs = []
        for rid in range(24):
            hh, ww = (int(v) for v in rng.integers(96, ENTRY + 1, size=2))
            reqs.append(ConvRequest(rid, rng.standard_normal(
                (hh, ww, 3), dtype=np.float32)))
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        for r in reqs:
            server.submit(r)
        server.run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        got = {k: v for k, v in all_launches().items() if v}
        route = "streamed" if streamed else "window"
        n_fwd = server.health()["batches"]
        print(f"[bf16-serve] {route}: launches {got} batches {n_fwd}")
        if got != {names[streamed]: 13 * n_fwd}:
            fail(f"the bf16 {route} serve launched {got}, not 13 "
                 f"{names[streamed]} a batch (no f32, backward or plain "
                 "route)")
        bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
        if bad:
            fail(f"bf16 {route} requests not OK: {bad}")
        counts[names[streamed]] = got.get(names[streamed], 0)
        runs[streamed] = (reqs, server, peak)

    with torch.no_grad():
        served_err = {False: 0.0, True: 0.0}
        plain_err = 0.0
        for i, r in enumerate(runs[False][0] + runs[True][0]):
            streamed = i >= 24
            img = torch.from_numpy(runs[streamed][1].bucketer.pad(
                r.image, r.bucket))[None].to(dev)
            f32 = plain_cnn_forward(img, model)[0]
            scale = f32.abs().max().item()
            served_err[streamed] = max(served_err[streamed], float(
                (torch.from_numpy(r.logits).to(dev) - f32).abs().max())
                / scale)
            pb = plain_cnn_forward(img, model, "bf16")[0].float()
            plain_err = max(plain_err, float((pb - f32).abs().max()) / scale)
    for streamed in (False, True):
        route = "streamed" if streamed else "window"
        reqs, server, peak = runs[streamed]
        lat = server.latencies() * 1e3
        print(f"[bf16-serve] {route}: 24 requests OK; served logits vs the "
              f"f32 plain forward: max rel-to-max err "
              f"{served_err[streamed]:.3e}, the bf16 plain forward's "
              f"{plain_err:.3e} (limit 2x: {2 * plain_err:.3e}); latency "
              f"p50 {np.percentile(lat, 50):.3f} ms p99 "
              f"{np.percentile(lat, 99):.3f} ms")
        if not served_err[streamed] <= 2 * plain_err:
            fail(f"bf16 {route} served logits are further from the f32 "
                 "plain forward than twice the bf16 plain forward")

    # -- 22(d) peak memory, zero overhead, the memory model ------------------
    params = sum(p.numel() for p in model.parameters())
    shapes = [mm.ConvShape(f"conv{i}", BATCH, h, h, ci, co, 3, 3, s, "SAME")
              for i, (ci, co, s, h) in enumerate(layer_shapes(ENTRY))]
    held = max(sh.base_bytes(2) for sh in shapes)
    images = 4 * BATCH * ENTRY * ENTRY * 3
    for streamed in (False, True):
        route = "streamed" if streamed else "window"
        peak = runs[streamed][2]
        print(f"[bf16-serve] {route}: peak device memory above the f32 "
              f"weights ({4 * params / 2**20:.1f} MiB) {peak / 2**20:.1f} "
              f"MiB; memory_model's largest layer held in bf16 (x, bf16 w, "
              f"y) {held / 2**20:.1f} MiB + the f32 images "
              f"{images / 2**20:.1f} MiB")
    seen = []
    hooks = [c.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0].shape, out.shape)))
        for c in model.convs]
    with torch.no_grad():
        model(torch.randn((BATCH, ENTRY, ENTRY, 3), device=dev),
              context=bf16)
    for hk in hooks:
        hk.remove()
    for (xin, yout), c in zip(seen, model.convs):
        n, cblk, h, w, cb = xin
        L.assert_zero_overhead((n, h, w, cblk * cb), tuple(xin))
        if len(yout) == 5:
            n, cblk, h, w, cb = yout
            L.assert_zero_overhead((n, h, w, cblk * cb), tuple(yout))
    print(f"[bf16-serve] assert_zero_overhead holds on the {len(seen)} "
          "served layers' blocked inputs and outputs")
    direct_mib = sum(mm.bytes_overhead(sh, "direct", 2) for sh in shapes)
    im2col_mib = sum(mm.bytes_overhead(sh, "im2col", 2)
                     for sh in shapes) / 2**20
    print(f"[bf16-serve] memory_model over the 13 convs in bf16: direct "
          f"overhead {direct_mib} B, im2col {im2col_mib:.1f} MiB, chained "
          f"repacks removed {mm.chain_repack_bytes(shapes, 2) / 2**20:.1f} "
          "MiB")

    # the baselines at conv5_2 (batch 8, 14x14) against F.conv2d
    x = torch.randn((BATCH, 14, 14, 512), device=dev, generator=gen)
    w = torch.randn((3, 3, 512, 512), device=dev, generator=gen) / 48.0
    want = base.conv_lax(x, w, 1, "SAME")
    scale = want.abs().max().item()
    xp = base.pad_input(x, "SAME", 3, 3)
    packed = base.im2col(xp, 3, 3)
    sh = mm.ConvShape("conv5_2", BATCH, 14, 14, 512, 512, 3, 3, 1, "SAME")
    if 4 * packed.numel() != mm.bytes_overhead(sh, "im2col", 4):
        fail("im2col's packed matrix is not memory_model's im2col bytes")
    del packed, xp
    for name, got, rel in (
            ("conv_im2col", base.conv_im2col(x, w, 1, "SAME"), 1e-5),
            ("conv_fft", base.conv_fft(x, w, 1, "SAME"), 1e-4)):
        compare(f"baseline {name} conv5_2 n{BATCH} vs F.conv2d", got, want,
                atol=rel * scale, rtol=0.0)
    print(f"[bf16] baselines: im2col's packed matrix "
          f"{mm.bytes_overhead(sh, 'im2col', 4) / 2**20:.1f} MiB, the FFT's "
          f"buffers {mm.bytes_overhead(sh, 'fft', 4) / 2**20:.1f} MiB "
          "(memory_model), direct 0")
    del x, w, want

    # -- 22(e) a small ResidualBlock stack: forward and one train step -------
    rgen = torch.Generator().manual_seed(args.seed + 41)
    convs = [BlockedConv2D(3, 64, device=dev, generator=rgen),
             ResidualBlock(64, 64, activation="gelu", device=dev,
                           generator=rgen),
             BlockedConv2D(64, 128, stride=2, device=dev, generator=rgen),
             ResidualBlock(128, 128, device=dev, generator=rgen)]
    rmodel = BlockedCNN(convs, 10, device=dev, generator=rgen)
    imgs = torch.randn((2, 32, 32, 3), device=dev, generator=gen)
    with torch.no_grad():
        reset_all_launches()
        got = rmodel(imgs)
        torch.cuda.synchronize()
        if LAUNCHES["direct_conv2d_fwd"] != 4:
            fail(f"the residual stack did not run the kernels: {LAUNCHES}")
        want = plain_cnn_forward(imgs, rmodel)
        compare("residual stack forward vs plain", got, want,
                atol=LOGIT_RTOL * want.abs().max().item(), rtol=0.0)
        bf16_close("residual stack bf16 forward vs plain bf16",
                   rmodel(imgs, context=bf16),
                   plain_cnn_forward(imgs, rmodel, "bf16"))
    ct = torch.randn((2, 10), device=dev, generator=gen)
    reset_all_launches()
    (rmodel(imgs) * ct).sum().backward()
    torch.cuda.synchronize()
    ran = {k: v for k, v in all_launches().items() if v}
    kgrads = [p.grad.clone() for p in rmodel.parameters()]
    for p in rmodel.parameters():
        p.grad = None
    (plain_cnn_forward(imgs, rmodel) * ct).sum().backward()
    for (name, p), g in zip(rmodel.named_parameters(), kgrads):
        compare(f"residual stack step grad {name} vs plain autograd", g,
                p.grad, atol=GRAD_RTOL * p.grad.abs().max().item(), rtol=0.0)
    print(f"[bf16] residual stack train step launches {ran}")
    if ran.get("direct_conv2d_dgrad", 0) < 3 or \
            ran.get("direct_conv2d_wgrad", 0) < 4:
        fail(f"the residual stack's step did not run the backward kernels: "
             f"{ran}")
    del rmodel
    print(f"[time] phase 22(c-e) done at {time.perf_counter() - t_start:.1f} s")

    # -- 22(f) per-layer times of the bf16 forwards ---------------------------
    rows = {False: [], True: []}
    cast = []
    # VGG-16's 13 convs (summed below), then MobileNet v1's conv1 (Cib 3,
    # stride 2: the copies path into phase planes), timed alone
    timed = list(zip(LAYER_NAMES, layer_shapes(ENTRY))) + [
        ("mobilenet.conv1", (3, 32, 2, ENTRY))]
    with torch.no_grad():
        for name, (ci, co, s, h) in timed:
            x, w32, b, _, spec = operands(BATCH, ci, co, h, s)
            w = w32.bfloat16()
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h),
                       (pl, pr, pt, pb)).contiguous(
                memory_format=torch.channels_last)
            w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                      .contiguous(memory_format=torch.channels_last))
            b_flat = b.reshape(co).bfloat16()
            l_ms = time_ms(lambda: F.conv2d(xp, w_oihw, b_flat, stride=s))
            l_graph = graph_ms(lambda: F.conv2d(xp, w_oihw, b_flat,
                                                stride=s))
            p_ms = time_ms(lambda: direct_conv_blocked(
                x, w, s, "SAME", b, "relu", "bf16"), iters=3)
            c_ms = time_ms(lambda: w32.to(torch.bfloat16))
            cast.append(c_ms)
            nbytes = 2 * (x.numel() + w.numel()
                          + BATCH * co * spec.ho * spec.wo) + 4 * b.numel()
            b_ms, b_by = bound(spec.flops(), nbytes, PEAK_BF16_FLOPS)
            for streamed in (False, True):
                def fwd():
                    return direct_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                                 precision="bf16",
                                                 stream=streamed)
                kernel, model_plan = fwd_plans(x, w, s, "SAME",
                                               streamed=streamed,
                                               dtype=torch.bfloat16)
                if kernel != model_plan:
                    fail(f"bf16 {name}: the kernel's plan {kernel} != the "
                         f"blocking model's {model_plan}")
                k_ms, g_ms = time_ms(fwd), graph_ms(fwd)
                if name != "mobilenet.conv1":
                    rows[streamed].append((k_ms, g_ms, p_ms, l_ms, l_graph,
                                           b_ms, b_by, kernel))
                route = "streamed" if streamed else "window"
                print(f"[bf16-time] {name} {route} {ci}->{co} in {h}x{h} "
                      f"s{s} n{BATCH}: kernel_ms "
                      f"{k_ms:.4f} graph_ms {g_ms:.4f} plain_ms {p_ms:.4f} "
                      f"cuDNN bf16 ms {l_ms:.4f} [{l_graph:.4f}] bound_ms "
                      f"{b_ms:.4f} ({b_by}, bf16) bound/graph "
                      f"{b_ms / g_ms:.3f}; weight cast ms {c_ms:.4f}; "
                      f"{kernel.tiles} tiles, tensor-core MACs issued "
                      f"{kernel.issued_macs} (padding "
                      f"{100 * kernel.padding_share:.1f} %), shared memory "
                      f"{kernel.smem} B, window/weight slots "
                      f"{kernel.window_slots}/{kernel.weight_slots}")
            del x, w, w32, xp, w_oihw
    entries = []
    for streamed in (False, True):
        rs = rows[streamed]
        tot = [sum(r[i] for r in rs) for i in range(6)]
        by = mostly([(r[5], r[6]) for r in rs])
        macs = sum(r[7].function_macs for r in rs)
        issued = sum(r[7].issued_macs for r in rs)
        route = "streamed" if streamed else "window"
        print(f"[bf16-time] all 13 convs {route}: kernel_ms {tot[0]:.4f} "
              f"graph_ms {tot[1]:.4f} plain_ms {tot[2]:.4f} cuDNN bf16 ms "
              f"{tot[3]:.4f} [{tot[4]:.4f}] bound_ms {tot[5]:.4f} ({by}, "
              f"bf16), {100 * tot[5] / tot[1]:.1f} % of the bound as a "
              f"graph; weight casts {sum(cast):.4f} ms; function MACs "
              f"{macs}, issued {issued} (padding "
              f"{100 * (1 - macs / issued):.1f} %)")
        fn = "stream_fwd_kernel_bf16" if streamed else "fwd_kernel_bf16"
        entries.append({
            "name": f"{names[streamed]} ({fn})",
            "route": "cuda", "source": STREAM_SOURCE if streamed
            else KERNEL_SOURCE,
            "replaces": TPU_STREAM if streamed else TPU_KERNEL,
            "launches": counts[names[streamed]],
            "max_abs_err": max_err[streamed], "ms": tot[0],
            "plain_ms": tot[2], "bound_ms": tot[5], "bound_by": by,
            "library_ms": tot[3]})
    with torch.no_grad():
        img = torch.randn((BATCH, ENTRY, ENTRY, 3), device=dev)
        for streamed in (False, True):
            ctx = ConvContext(precision="bf16", stream=streamed)
            f_ms = time_ms(lambda: model(img, context=ctx), iters=5)
            f_graph = graph_ms(lambda: model(img, context=ctx), iters=3)
            print(f"[bf16-time] VGG-16 forward n{BATCH} {ENTRY}x{ENTRY} "
                  f"bf16 {'streamed' if streamed else 'window'}: "
                  f"{f_ms:.3f} ms eager, {f_graph:.3f} ms as a CUDA graph "
                  "(weight casts included)")
        f32_ms = time_ms(lambda: model(img), iters=5)
        print(f"[bf16-time] VGG-16 forward n{BATCH} {ENTRY}x{ENTRY} f32 "
              f"window: {f32_ms:.3f} ms eager (the same call)")
    print(f"[time] phase 22 done at {time.perf_counter() - t_start:.1f} s")
    return entries, counts


def bf16_trainers(model, n, seed, runs_spec, dev, entry=ENTRY):
    """Phase 23's, 24's and 26's bf16 training check.  ``model`` (f32
    masters) trained 3 AdamW steps (cosine, peak ``TRAIN_LR``) at batch
    ``n`` on ``entry``-pixel images drawn from ``seed``: by an f32 plain
    trainer (autograd through the plain forward), by a plain bf16 trainer
    (the same training path on the plain versions, a CPU copy of the model: the
    wrappers take their plain versions for CPU tensors, so that only the
    order of the f32 sums differs from the kernels; with its own rounding
    points a plain path ends ~15 % from the f32 gradients at VGG-16's
    conv1_2, and so ~15 % from the kernels as well), and by a kernel trainer
    for each ``(tag, context, launches of one step)`` of ``runs_spec``.
    Each kernel trainer must launch those builds, its step-1 loss be within
    1e-2 of the plain bf16 path's, each gradient within ``BF16_TOL`` of its
    max of the plain bf16 path's (or twice that path's own max distance
    from the f32 gradient, where that is larger) and no further from the
    f32 gradients (relative L2) than twice the plain bf16 path; after 3
    steps no more elements off the f32 trainer's by ``PARAM_STEP`` of the
    summed learning rate than twice the plain bf16 trainer's, none off the
    plain bf16 trainer's by more than 2.1 times it.  -> (the launches of
    the kernel trainers' steps, [(step, state, model) a run], the batches,
    the learning-rate schedule)."""
    from repro_torch.core.context import ConvContext
    from repro_torch.train.losses import cross_entropy
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainstep import make_train_step

    rng = np.random.default_rng(seed)
    batches = [
        {"images": torch.from_numpy(rng.standard_normal(
            (n, entry, entry, 3), dtype=np.float32)).to(dev),
         "targets": torch.from_numpy(rng.integers(0, 1000, n)).to(dev)}
        for _ in range(3)]
    lr = cosine_schedule(TRAIN_LR, 1, 3)
    lr_sum = sum(lr(t) for t in (1, 2, 3))

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # the f32 plain trainer: autograd through the plain forward, 3 steps
    # (the f32 reference of the gradient and drift rules)
    f32m = copy.deepcopy(model)
    fopt = AdamW(lr=lr)
    fparams = dict(f32m.named_parameters())
    fstate = fopt.init(fparams)
    for i, bt in enumerate(batches):
        for p in fparams.values():
            p.grad = None
        logits = plain_cnn_forward(bt["images"], f32m)
        loss, _ = cross_entropy(logits[:, None, :], bt["targets"][:, None],
                                1000)
        loss.backward()
        if i == 0:
            f32_loss = loss.detach()
            f32_grads = {k: p.grad.clone() for k, p in fparams.items()}
        fopt.update({k: p.grad for k, p in fparams.items()}, fstate,
                    fparams)
    f32_params = {k: p.detach().clone() for k, p in fparams.items()}
    del f32m, fparams, fstate, logits, loss

    def off(params, ref):
        """Elements of ``params`` more than PARAM_STEP of the summed
        learning rate from ``ref``'s, and the largest difference."""
        n_off, worst = 0, 0.0
        for k, v in params.items():
            d = (v - ref[k]).abs()
            n_off += int((d > PARAM_STEP * lr_sum).sum())
            worst = max(worst, d.max().item())
        return n_off, worst
    # the plain bf16 trainer, 3 steps on the CPU
    t0 = time.perf_counter()
    pm = copy.deepcopy(model).cpu()
    popt = AdamW(lr=lr)
    pstate = popt.init(dict(pm.named_parameters()))
    pstep = make_train_step(pm, popt, context=ConvContext(precision="bf16"))
    plain_losses = []
    for i, bt in enumerate(batches):
        loss, _ = pstep(pstate, {k: v.cpu() for k, v in bt.items()})
        plain_losses.append(loss.item())
        if i == 0:
            pgrads = {k: p.grad.to(dev) for k, p in pm.named_parameters()}
    pparams = {k: p.detach().to(dev) for k, p in pm.named_parameters()}
    n_el = sum(v.numel() for v in pparams.values())
    del pm, pstate
    plain_far, _ = off(pparams, f32_params)
    print(f"[bf16-train] the plain bf16 trainer (the training path on the "
          f"plain versions, on the CPU): 3 steps in "
          f"{time.perf_counter() - t0:.1f} s, losses {plain_losses}; after "
          f"3 steps {plain_far} of {n_el} elements more than {PARAM_STEP:g}"
          f" * sum(lr)={lr_sum:g} from the f32 plain trainer's")
    counts, runs = {}, []
    for tag, ctx, want_step in runs_spec:
        km = copy.deepcopy(model)
        opt = AdamW(lr=lr)
        kstate = opt.init(dict(km.named_parameters()))
        step = make_train_step(km, opt, context=ctx)
        reset_all_launches()
        losses = []
        for i, bt in enumerate(batches):
            loss, _ = step(kstate, bt)
            torch.cuda.synchronize()
            losses.append(loss.item())
            if i > 0:
                continue
            per_step = {k: v for k, v in all_launches().items() if v}
            print(f"[{tag}] launches in one step: {per_step}")
            if per_step != want_step:
                fail(f"a bf16 train step launched {per_step}, expected "
                     f"{want_step}")
            if not abs(losses[0] - plain_losses[0]) <= 1e-2 * abs(
                    plain_losses[0]):
                fail(f"bf16 step-1 loss {losses[0]} not within 1e-2 of the "
                     f"plain bf16 path's {plain_losses[0]}")
            worst, over, far, noisy = 0.0, [], [], 0
            for k, p in km.named_parameters():
                pg, kg, fg = pgrads[k], p.grad, f32_grads[k]
                e = (kg - pg).abs().max().item() / pg.abs().max().item()
                noise = (pg - fg).abs().max().item() / fg.abs().max().item()
                worst = max(worst, e)
                # where the plain bf16 path's own rounding noise passes
                # BF16_TOL of max (the early layers of a random VGG-16:
                # ~15 % from f32), twice that noise
                tol = max(BF16_TOL, 2 * noise)
                noisy += tol > BF16_TOL
                if not e <= tol:
                    over.append((k, e, tol))
                dk, dp = rel(kg, fg), rel(pg, fg)
                print(f"[{tag}] step-1 grad {k}: max err vs plain bf16 / "
                      f"max {e:.2e} (tol {tol:.2e}; the plain bf16 path's "
                      f"max err vs f32 / max {noise:.2e}); |kernel - f32| / "
                      f"|f32| {dk:.3e}, |plain bf16 - f32| / |f32| {dp:.3e}")
                if not dk <= 2 * dp:
                    far.append((k, dk, dp))
            print(f"[{tag}] step-1 loss {losses[0]:.6f}, plain bf16 "
                  f"{plain_losses[0]:.6f}, f32 plain {f32_loss.item():.6f}; "
                  f"worst gradient err {worst:.2e} of its max (tol "
                  f"{BF16_TOL:g}, or twice the plain bf16 path's own max "
                  f"err vs f32 at {noisy} of {len(pgrads)} tensors); "
                  f"gradients no further from the f32 ones than twice the "
                  f"plain bf16 path's: {not far}")
            if over:
                fail(f"bf16 step-1 gradients beyond their tolerance: {over}")
            if far:
                fail(f"bf16 gradients further from the f32 plain ones than "
                     f"twice the bf16 plain path: {far}")
        counts.update({k: v for k, v in all_launches().items() if v})
        kparams = {k: p.detach() for k, p in km.named_parameters()}
        far, worst = off(kparams, pparams)
        far32, _ = off(kparams, f32_params)
        print(f"[{tag}] n{n} {entry}x{entry}: losses {losses}, plain "
              f"bf16 {plain_losses}; after 3 steps {far} of {n_el} elements "
              f"differ from the plain bf16 trainer by more than "
              f"{PARAM_STEP:g} * sum(lr)={lr_sum:g} (largest {worst:.3e}), "
              f"{far32} from the f32 plain trainer's (tol: twice the plain "
              f"bf16 trainer's {plain_far}, and none from the plain bf16 "
              f"trainer's by more than 2.1 * sum(lr))")
        if any(not np.isfinite(v) for v in losses):
            fail("non-finite bf16 loss")
        if far32 > 2 * plain_far or worst > 2.1 * lr_sum:
            fail("the bf16 kernel trainer drifted from the f32 trainer "
                 "further than twice the plain bf16 trainer")
        runs.append((step, kstate, km))
    del pgrads, pparams, f32_grads, f32_params, kparams
    torch.cuda.empty_cache()
    return counts, runs, batches, lr


def bf16_train_phases(args, dev, t_start, model, smi):
    """Phase 23: the bf16 builds of the dgrad and wgrad tiles on both
    routes against their plain versions under ``BF16``, the autograd path
    with relu and gelu, a residual and GAP, VGG-16 (``model``, phase 4's
    weights as f32 masters) trained in bf16 for 3 AdamW steps on both
    routes, and the builds' times.  -> (the four builds' entries of the
    ``{"kernels": [...]}`` line, the launches of the two bf16 training
    runs per kernel)."""
    from repro_torch.configs.cnn import vgg16_layers
    from repro_torch.core import conv2d_common
    from repro_torch.core import memory_model as mm
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels import conv2d_stream as stk
    from repro_torch.kernels.direct_conv2d import (cotangent_pass,
                                                   direct_conv2d_blocked,
                                                   direct_conv2d_dgrad,
                                                   dgrad_plans, split_wgrad,
                                                   wgrad_partials,
                                                   wgrad_plans)
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainstep import make_train_step

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 50)
    key = {(False, "dgrad"): "direct_conv2d_dgrad_bf16",
           (True, "dgrad"): "conv2d_stream_dgrad_bf16",
           (False, "wgrad"): "direct_conv2d_wgrad_bf16",
           (True, "wgrad"): "conv2d_stream_wgrad_bf16"}
    fn_of = {"direct_conv2d_dgrad_bf16": "dgrad_kernel_bf16",
             "conv2d_stream_dgrad_bf16": "stream_dgrad_kernel_bf16",
             "direct_conv2d_wgrad_bf16": "wgrad_kernel_bf16",
             "conv2d_stream_wgrad_bf16": "stream_wgrad_kernel_bf16"}
    dz_key = "direct_conv2d_dz_bf16"

    def route(streamed):
        return "streamed" if streamed else "window"

    print(f"[bf16-train] card: {smi}")

    def layer_shapes(entry):
        out, h = [], entry
        for ci, co, s in vgg16_layers():
            out.append((ci, co, s, h))
            h = -(-h // s)
        return out

    def operands(n, ci, co, h, s, cob=None):
        cib, cob = min(ci, 128), cob or min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        z = torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                        generator=gen)
        g = torch.randn(z.shape, device=dev, generator=gen)
        return x.to(bf), w.to(bf), z.to(bf), g.to(bf), spec

    def wgrad_run(x, g, z, s, streamed):
        if streamed:
            return stk.stream_wgrad_partials(x, g, 3, 3, s, "SAME", z, "relu",
                                             True, precision="bf16")
        return wgrad_partials(x, g, 3, 3, s, "SAME", z, "relu", True,
                              precision="bf16")

    # -- 23(a) each build against its plain version, with its times ----------
    max_err = {k: 0.0 for k in (*key.values(), dz_key)}
    rows = {k: [] for k in (*key.values(), dz_key)}
    for name, (ci, co, s, h) in zip(LAYER_NAMES, layer_shapes(ENTRY)):
        x, w, z, g, spec = operands(BATCH, ci, co, h, s)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        (pt, pb), (pl, pr) = spec.pads
        cl = torch.channels_last
        xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h),
                   (pl, pr, pt, pb)).contiguous(memory_format=cl)
        w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                  .contiguous(memory_format=cl))
        dz_nchw = (dz.permute(0, 1, 4, 2, 3)
                   .reshape(BATCH, co, spec.ho, spec.wo)
                   .contiguous(memory_format=cl))

        def library(mask):
            return lambda: torch.ops.aten.convolution_backward(
                dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                [0, 0], 1, mask)
        tag = f"{name} {ci}->{co} in {h}x{h} s{s} n{BATCH}"
        if ci != 3:                       # the images' dx is never taken
            want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z,
                                             "relu")
            p_ms = time_ms(lambda: direct_conv_dgrad_blocked(
                g, w, (h, h), s, "SAME", z, "relu"), iters=3)
            lib = library([True, False, False])
            l_ms, l_graph = time_ms(lib), graph_ms(lib)
            b_ms, b_by = bound(spec.flops(), 2 * (2 * g.numel() + w.numel()
                                                  + x.numel()),
                               PEAK_BF16_FLOPS)
            for streamed in (False, True):
                def dgrad():
                    return direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z,
                                               "relu", stream=streamed,
                                               precision="bf16")
                got, again = dgrad(), dgrad()
                on_dz = direct_conv2d_dgrad(dz, w, (h, h), s, "SAME",
                                            stream=streamed,
                                            precision="bf16",
                                            prologue_tiles=True)
                torch.cuda.synchronize()
                k = key[(streamed, "dgrad")]
                max_err[k] = max(max_err[k], bf16_close(
                    f"{route(streamed)} dgrad {tag} relu", got, want))
                if not torch.equal(got, again):
                    fail(f"bf16 {route(streamed)} dgrad {name}: two runs "
                         "differ")
                if not torch.equal(on_dz, got):
                    fail(f"bf16 {route(streamed)} dgrad {name}: on the dz "
                         "pass's dz it differs from its own prologue")
                print(f"[check] bf16 {route(streamed)} dgrad {tag} on the "
                      "dz pass's dz (prologue off): bit for bit the same "
                      "dgrad with its prologue")
                del on_dz
                plan, model_plan = dgrad_plans(g, w, (h, h), s, "SAME", z,
                                               "relu", streamed=streamed,
                                               dtype=bf)
                if plan != model_plan:
                    fail(f"bf16 dgrad {name}: the kernel's plan {plan} != "
                         f"the blocking model's {model_plan}")
                k_ms, g_ms = time_ms(dgrad), graph_ms(dgrad)
                rows[k].append((k_ms, g_ms, p_ms, l_ms, l_graph, b_ms, b_by))
                print(f"[bf16-bwd-time] {tag} dgrad {route(streamed)}: "
                      f"eager_ms {k_ms:.4f} graph_ms {g_ms:.4f} plain_ms "
                      f"{p_ms:.4f} library_ms {l_ms:.4f} [{l_graph:.4f}] "
                      f"(convolution_backward, bf16 channels-last) bound_ms "
                      f"{b_ms:.4f} ({b_by}, bf16) bound/graph "
                      f"{b_ms / g_ms:.3f}; {plan.tiles} tiles, tensor-core "
                      f"MACs issued {plan.issued_macs} (padding "
                      f"{100 * plan.padding_share:.1f} %)")
            del want, got, again
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), dz.double(), 3, 3, s, "SAME", with_db=True)
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), 3, 3, s, "SAME",
            with_db=True)
        p_ms = time_ms(lambda: direct_conv_wgrad_blocked(
            x, g, 3, 3, s, "SAME", z, "relu", with_db=True), iters=3)
        lib = library([False, True, False])
        l_ms, l_graph = time_ms(lib), graph_ms(lib)
        b_ms, b_by = bound(spec.flops(), 2 * (x.numel() + 2 * g.numel())
                           + 4 * (w.numel() + co), PEAK_BF16_FLOPS)
        # the dz pass: dz and db once a layer, against cotangent_prologue
        max_err[dz_key] = max(max_err[dz_key], check_dz_pass(
            f"dz pass {tag} relu", g, z, "relu", want_db, abs_db))

        def dz_pass():
            return cotangent_pass(g, z, "relu", True)

        def dz_plain():
            d = conv2d_common.cotangent_prologue(g, z, "relu")
            return d, d.float().sum(dim=(0, 2, 3))
        d_ms, d_graph = time_ms(dz_pass), graph_ms(dz_pass)
        dp_ms = time_ms(dz_plain, iters=3)
        db_ms, db_by = bound(g.numel(), 2 * 3 * g.numel() + 4 * co,
                             PEAK_BF16_FLOPS)
        rows[dz_key].append((d_ms, d_graph, dp_ms, 0.0, 0.0, db_ms, db_by))
        print(f"[bf16-bwd-time] {tag} dz pass (dz_kernel_bf16, with db): "
              f"eager_ms {d_ms:.4f} graph_ms {d_graph:.4f} plain_ms "
              f"{dp_ms:.4f} bound_ms {db_ms:.4f} ({db_by}, 6 bytes an "
              f"element) bound/graph {db_ms / d_graph:.3f}")
        for streamed in (False, True):
            k = key[(streamed, "wgrad")]
            first = wgrad_run(x, g, z, s, streamed)
            dw, db = split_wgrad(wgrad_run(x, g, z, s, streamed)[1], x.shape,
                                 g.shape, 3, 3, True)
            check_fold(f"bf16 {route(streamed)} wgrad {tag}", first,
                       (dw, db))
            max_err[k] = max(
                max_err[k],
                compare_scaled(f"bf16 wgrad dw {route(streamed)} {tag}", dw,
                               want_dw, abs_dw, WGRAD_REL),
                compare_scaled(f"bf16 wgrad db {route(streamed)} {tag}", db,
                               want_db, abs_db, WGRAD_REL))
            plan, model_plan = wgrad_plans(x, g, 3, 3, s, "SAME", z, "relu",
                                           streamed=streamed, dtype=bf)
            if plan != model_plan:
                fail(f"bf16 wgrad {name}: the kernel's plan {plan} != the "
                     f"blocking model's {model_plan}")

            def wgrad():
                return wgrad_run(x, g, z, s, streamed)
            k_ms, g_ms = time_ms(wgrad), graph_ms(wgrad)
            rows[k].append((k_ms, g_ms, p_ms, l_ms, l_graph, b_ms, b_by))
            print(f"[bf16-bwd-time] {tag} wgrad {route(streamed)} (the dz "
                  f"pass and the GEMM): eager_ms "
                  f"{k_ms:.4f} graph_ms {g_ms:.4f} plain_ms {p_ms:.4f} "
                  f"library_ms {l_ms:.4f} [{l_graph:.4f}] "
                  f"(convolution_backward, bf16 channels-last, no db) "
                  f"bound_ms {b_ms:.4f} ({b_by}, bf16) bound/graph "
                  f"{b_ms / g_ms:.3f}; {plan.tiles} tiles, tensor-core MACs "
                  f"issued {plan.issued_macs} (padding "
                  f"{100 * plan.padding_share:.1f} %), shared memory "
                  f"{plan.smem} B")
        del x, w, z, g, dz, xp, w_oihw, dz_nchw, want_dw, want_db, abs_dw
        del abs_db
    print(f"[bf16-train] wgrad worst err/bound: " + " ".join(
        f"{kind} {max(v for lab, v in RATIOS.items() if lab.startswith(f'bf16 wgrad {kind} ')):.3f}"
        for kind in ("dw", "db")) + f" (tol 1, |err| <= {WGRAD_REL:g} * "
        "sum|x dz|; two runs bit for bit)")

    # Cob % 8 != 0: the cp.async (Cob 6) and 2-byte (Cob 125) copies, each
    # beside cuDNN bf16's dgrad in channels-last at the same shape
    for n, ci, co, h, s in C1_SHAPES:
        cob = 6 if co == 6 else 125
        x, w, z, g, spec = operands(n, ci, co, h, s, cob)
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z, "relu")
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        (pt, pb), (pl, pr) = spec.pads
        cl = torch.channels_last
        xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(n, ci, h, h),
                   (pl, pr, pt, pb)).contiguous(memory_format=cl)
        w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                  .contiguous(memory_format=cl))
        dz_nchw = (dz.permute(0, 1, 4, 2, 3).reshape(n, co, spec.ho, spec.wo)
                   .contiguous(memory_format=cl))

        def cudnn():
            return torch.ops.aten.convolution_backward(
                dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                [0, 0], 1, [True, False, False])
        c_ms, c_graph = time_ms(cudnn), graph_ms(cudnn)
        for streamed in (False, True):
            def dgrad():
                return direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z,
                                           "relu", stream=streamed,
                                           precision="bf16")
            got = dgrad()
            torch.cuda.synchronize()
            k = key[(streamed, "dgrad")]
            tag = f"{ci}->{co} {h}x{h} s{s} n{n} relu, Cob {cob}"
            max_err[k] = max(max_err[k], bf16_close(
                f"{route(streamed)} dgrad {tag}", got, want))
            print(f"[bf16-c1] {route(streamed)} dgrad {tag}: eager_ms "
                  f"{time_ms(dgrad):.4f} graph_ms {graph_ms(dgrad):.4f}; "
                  f"cuDNN bf16 (convolution_backward, channels-last) "
                  f"{c_ms:.4f} [{c_graph:.4f}] on {smi}")
        del x, w, z, g, want, got, dz, xp, w_oihw, dz_nchw

    # the autograd path: relu and gelu, a residual and GAP, Cib = 3 and 64,
    # against the same function on the CPU's plain versions
    for n, ci, co, h, s, act in ((2, 3, 64, 20, 2, "gelu"),
                                 (2, 64, 128, 28, 1, "relu")):
        x, w, _, _, spec = operands(n, ci, co, h, s)
        x, w = x.float(), w.float()
        b = 0.1 * torch.randn((co // min(co, 128), min(co, 128)), device=dev,
                              generator=gen)
        r = torch.randn((n, co // min(co, 128), spec.ho, spec.wo,
                         min(co, 128)), device=dev, generator=gen).to(bf)
        ct = torch.randn((n, co), device=dev, generator=gen)

        def grads(streamed, device):
            ins = [t.detach().to(device).clone().requires_grad_()
                   for t in (x, w, b, r)]
            out = direct_conv2d_blocked(*ins[:3], s, "SAME", act,
                                        residual=ins[3], gap=True,
                                        precision="bf16", stream=streamed)
            (out.float() * ct.to(device)).sum().backward()
            return [t.grad for t in ins]
        for streamed in (False, True):
            reset_all_launches()
            got = grads(streamed, dev)
            torch.cuda.synchronize()
            ran = {k: v for k, v in all_launches().items() if v}
            pre = "conv2d_stream" if streamed else "direct_conv2d"
            if ran != {f"{pre}_fwd_bf16": 1, f"{pre}_dgrad_bf16": 1,
                       f"{pre}_wgrad_bf16": 1, dz_key: 1}:
                fail(f"the bf16 autograd path launched {ran}")
            want = grads(streamed, torch.device("cpu"))
            for nm, gk, gp in zip(("dx", "dw", "db", "dres"), got, want):
                k = key[(streamed, "dgrad" if nm == "dx" else "wgrad")]
                e = compare(f"bf16 autograd {nm} {route(streamed)} {ci}->{co} "
                            f"{h}x{h} s{s} n{n} {act}+residual+gap vs the "
                            "plain versions", gk.cpu(), gp,
                            atol=GRAD_RTOL * gp.abs().max().item(), rtol=0.0)
                max_err[k] = max(max_err[k], e)
    print(f"[time] phase 23(a) done at {time.perf_counter() - t_start:.1f} s")

    # -- 23(b) VGG-16 trained in bf16, window then streamed ------------------
    runs_spec = []
    for streamed in (False, True):
        pre = "conv2d_stream" if streamed else "direct_conv2d"
        runs_spec.append((f"bf16-train {route(streamed)}",
                          ConvContext(precision="bf16", stream=streamed),
                          {f"{pre}_fwd_bf16": 13, f"{pre}_dgrad_bf16": 12,
                           f"{pre}_wgrad_bf16": 13, dz_key: 13}))
    counts, trained, batches, lr = bf16_trainers(model, BATCH, args.seed + 50,
                                                 runs_spec, dev)
    runs = {streamed: trained[i] for i, streamed in enumerate((False, True))}
    print(f"[time] phase 23(b) done at {time.perf_counter() - t_start:.1f} s")

    # -- 23(c) summed times, the step beside f32's, peak memory ---------------
    f32m = copy.deepcopy(model)
    f32opt = AdamW(lr=lr)
    f32state = f32opt.init(dict(f32m.named_parameters()))
    f32step = make_train_step(f32m, f32opt)
    timed = timed_steps("bf16-train", [
        ("f32 window", f32step, f32state),
        ("bf16 window", runs[False][0], runs[False][1]),
        ("bf16 streamed", runs[True][0], runs[True][1])], batches)
    del f32m, f32state, f32step
    torch.cuda.empty_cache()
    print(f"[bf16-train] step medians on {smi}: " + ", ".join(
        f"{k} {np.median(v):.3f} ms" for k, v in timed.items()))
    shapes = [mm.ConvShape(f"conv{i}", BATCH, h, h, ci, co, 3, 3, s, "SAME")
              for i, (ci, co, s, h) in enumerate(layer_shapes(ENTRY))]
    modelled = sum(mm.bytes_precision_split(sh, "bf16")["total"]
                   for sh in shapes)
    transient = max(mm.bytes_backward_transient(sh, "bf16") for sh in shapes)
    for streamed in (False, True):
        step, state, km = runs[streamed]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batches[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[bf16-train] {route(streamed)} step peak device memory above "
              f"the parameters, gradients and moments it holds "
              f"{peak / 2**20:.1f} MiB; memory_model.bytes_precision_split's"
              f" bf16 training bytes over the 13 convs {modelled / 2**20:.1f}"
              f" MiB, the largest dz a backward holds besides "
              f"(bytes_backward_transient) {transient / 2**20:.1f} MiB "
              f"({smi})")
    entries = []
    print("[bf16-bwd-time] the parent's, recorded (PERF.md, H100 80GB HBM3 at "
          "700.00 W; not measured here): window wgrad 5.278 [5.192] ms, "
          "streamed 5.464 [5.353], window dgrad 2.132 [2.055], streamed "
          "2.461 [2.363]; bf16 steps 12.863 ms window, 13.565 streamed")
    rs = rows[dz_key]
    tot = [sum(r[i] for r in rs) for i in range(6)]
    print(f"[bf16-bwd-time] all {len(rs)} dz passes (dz_kernel_bf16, inside "
          f"each wgrad line above) on {smi}: eager_ms {tot[0]:.4f} graph_ms "
          f"{tot[1]:.4f} plain_ms {tot[2]:.4f} bound_ms {tot[5]:.4f} "
          f"(bytes), {100 * tot[5] / tot[1]:.1f} % of the bound as a graph; "
          f"launches in the two bf16 training runs {counts.get(dz_key, 0)}")
    entries.append({
        "name": f"{dz_key} (dz_kernel_bf16)", "route": "cuda",
        "source": BWD_SOURCE, "replaces": TPU_PROLOGUE,
        "launches": counts.get(dz_key, 0), "max_abs_err": max_err[dz_key],
        "ms": tot[0], "plain_ms": tot[2], "bound_ms": tot[5],
        "bound_by": "bytes", "library_ms": None})
    for (streamed, kind), k in key.items():
        rs = rows[k]
        tot = [sum(r[i] for r in rs) for i in range(6)]
        by = mostly([(r[5], r[6]) for r in rs])
        print(f"[bf16-bwd-time] all {len(rs)} {kind} {route(streamed)} "
              f"({fn_of[k]}) on {smi}: eager_ms {tot[0]:.4f} graph_ms "
              f"{tot[1]:.4f} plain_ms {tot[2]:.4f} library_ms {tot[3]:.4f} "
              f"[{tot[4]:.4f}] bound_ms {tot[5]:.4f} ({by}, bf16), "
              f"{100 * tot[5] / tot[1]:.1f} % of the bound as a graph; "
              f"launches in the two bf16 training runs {counts.get(k, 0)}")
        entries.append({
            "name": f"{k} ({fn_of[k]})", "route": "cuda",
            "source": STREAM_SOURCE if streamed else BWD_SOURCE,
            "replaces": {"dgrad": TPU_STREAM if streamed else TPU_DGRAD,
                         "wgrad": TPU_STREAM_WGRAD if streamed
                         else TPU_WGRAD}[kind],
            "launches": counts.get(k, 0), "max_abs_err": max_err[k],
            "ms": tot[0], "plain_ms": tot[2], "bound_ms": tot[5],
            "bound_by": by, "library_ms": tot[3]})
    del runs
    torch.cuda.empty_cache()
    print(f"[time] phase 23 done at {time.perf_counter() - t_start:.1f} s")
    return entries, {k: counts.get(k, 0) for k in (*key.values(), dz_key)}


def separable_bf16_phases(args, dev, t_start, smi, model):
    """Phase 24: the separable family's bf16 builds (the pointwise forward
    tile's, ``pointwise_tile_kernel_bf16``; the three depthwise walks',
    ``depthwise_{fwd,dgrad,wgrad}_kernel_bf16``; the dense bf16 dgrad and
    wgrad tiles at 1x1 for the pointwise backward) against their plain
    versions under ``BF16``, MobileNet v1 (``model``, phase 11's weights)
    served in bf16 through ``ConvServer`` and trained in bf16 (its weights
    as f32 masters), the legs' times, the bf16 step beside the f32 one and
    peak memory.  -> (the six builds' entries of the ``{"kernels": [...]}``
    line, the launches of the two bf16 main-path runs per kernel)."""
    from repro_torch.configs.cnn import MOBILENET_V1_CONV1
    from repro_torch.core import conv2d_common
    from repro_torch.core import memory_model as mm
    from repro_torch.core.blocking import choose_pointwise_blocking
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.core.precision import Precision
    from repro_torch.kernels import conv2d_depthwise as dwk
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels.direct_conv2d import (cotangent_pass,
                                                   dgrad_plans,
                                                   direct_conv2d_blocked,
                                                   wgrad_plans)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainstep import make_train_step

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 60)
    fn_of = {"conv2d_pointwise_fwd_bf16": "pointwise_tile_kernel_bf16",
             "conv2d_pointwise_dgrad_bf16": "dgrad_kernel_bf16 at 1x1",
             "conv2d_pointwise_wgrad_bf16": "wgrad_kernel_bf16 at 1x1",
             "conv2d_depthwise_fwd_bf16": "depthwise_fwd_kernel_bf16",
             "conv2d_depthwise_dgrad_bf16": "depthwise_dgrad_kernel_bf16",
             "conv2d_depthwise_wgrad_bf16": "depthwise_wgrad_kernel_bf16"}
    err = {k: 0.0 for k in fn_of}

    def track(name, value):
        err[name] = max(err[name], value)

    def stamp(part):
        print(f"[time] phase 24({part}) done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def dw_operands(n, c, h, cb=None, hf=3):
        """bf16 x and w (as the bf16 chain and the training path hand them
        over) and an f32 bias."""
        cb = cb or min(c, 128)
        x = torch.randn((n, c // cb, h, h, cb), device=dev,
                        generator=gen).to(bf)
        w = (torch.randn((c // cb, 1, hf, hf, 1, cb), device=dev,
                         generator=gen) / hf).to(bf)
        b = 0.1 * torch.randn((c // cb, cb), device=dev, generator=gen)
        return x, w, b

    def pw_operands(n, ci, co, h):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev,
                        generator=gen).to(bf)
        w = (torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=dev,
                         generator=gen) / ci ** 0.5).to(bf)
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        return x, w, b

    def wgrad_held(label, name, run, partials, x, dz, hf, s, groups, dil=1):
        """dw and db of two runs bit for bit, the folded sum bit for bit its
        workspace's in-order reduce, both against f64 sums of the same bf16
        operands within WGRAD_REL of sum|x dz|."""
        (dw, db), (dw2, db2) = run(), run()
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"{label}: two runs differ")
        check_fold(label, partials(), (dw, db))
        pad = "VALID" if hf == 1 else "SAME"
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), dz.double(), hf, hf, s, pad, with_db=True,
            groups=groups, dilation=dil)
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), hf, hf, s, pad,
            with_db=True, groups=groups, dilation=dil)
        track(name, max(
            compare_scaled(f"bf16 {label} dw (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"bf16 {label} db", db, want_db, abs_db,
                           WGRAD_REL)))

    # -- 24(a) each build against its plain version ---------------------------
    served_blocks = [b for bh, _ in BUCKETS for b in mobilenet_blocks(bh)]
    last_pw = {(ci, co, -(-h // s)) for ci, co, s, h in
               (mobilenet_blocks(bh)[-1] for bh, _ in BUCKETS)}
    with torch.no_grad():
        for c, s, h in sorted({(ci, s, h) for ci, _, s, h in served_blocks}):
            x, w, b = dw_operands(MB_BATCH, c, h)
            got = dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                               precision="bf16")
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu", "bf16",
                                       groups=c)
            torch.cuda.synchronize()
            track("conv2d_depthwise_fwd_bf16", bf16_close(
                f"dw fwd {c} Cb={min(c, 128)} {h}x{h} s{s} n{MB_BATCH} relu",
                got, want))
        for ci, co, h in sorted({(ci, co, -(-h // s))
                                 for ci, co, s, h in served_blocks}):
            gap = (ci, co, h) in last_pw
            x, w, b = pw_operands(MB_BATCH, ci, co, h)
            got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", "relu",
                                               gap=gap, precision="bf16")
            want = direct_conv_blocked(x, w, 1, "VALID", b, "relu", "bf16",
                                       gap=gap)
            torch.cuda.synchronize()
            tag = f"pw fwd {ci}->{co} {h}x{h} n{MB_BATCH} relu"
            track("conv2d_pointwise_fwd_bf16", bf16_close(
                tag + ("+gap" if gap else ""), got, want))
            again = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID",
                                                 "relu", gap=gap,
                                                 precision="bf16")
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"bf16 {tag}: two runs differ")
            if gap:
                check_gap(f"bf16 {tag}+gap", pwk.pointwise_gap(
                    x, w, b, "relu", precision="bf16"), h * h, got)
            cib, cob = x.shape[4], w.shape[5]
            blk = choose_pointwise_blocking(MB_BATCH, h * h, ci // cib, cib,
                                            co // cob, cob, gap=gap,
                                            op_bytes=2)
            plan, model_plan = pwk.pointwise_plans(x, w, gap, "relu")
            if plan != model_plan:
                fail(f"bf16 {tag}: the kernel's plan {plan} != the blocking "
                     f"model's {model_plan}")
            print(f"[bf16-sep] {tag}: {plan.items} items of {blk.rows} "
                  f"flattened (image, position) rows by lanes {blk.lanes} x "
                  f"{blk.nsplit}, {blk.wgs} consumer warpgroup(s), chunk "
                  f"{blk.chunk}, ring {plan.ring}, x boxes of {blk.brows} "
                  f"rows, shared memory {plan.smem} B, GAP slots "
                  f"{plan.slots}; tensor-core MACs issued "
                  f"{plan.issued_macs} for the function's "
                  f"{plan.function_macs} "
                  f"({plan.issued_macs / plan.function_macs:.3f}x); the "
                  "kernel's plan is the blocking model's, two runs bit for "
                  "bit")
        # gelu, a residual and GAP through the bf16 forwards' epilogues,
        # and the depthwise tap loop at dilation 2 with Cb 3 and 6
        for n, c, h, cb, s, dil in ((2, 24, 13, 8, 1, 2), (2, 6, 9, 3, 2, 1),
                                    (2, 12, 10, 6, 1, 2)):
            x, w, b = dw_operands(n, c, h, cb)
            spec = ConvSpec.make(n, h, h, c, c, 3, 3, s, "SAME", groups=c,
                                 dilation=dil)
            r = torch.randn((n, c // cb, spec.ho, spec.wo, cb), device=dev,
                            generator=gen).to(bf)
            got = dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME", "gelu",
                                               residual=r, gap=True,
                                               dilation=dil, precision="bf16")
            want = direct_conv_blocked(x, w, s, "SAME", b, "gelu", "bf16",
                                       groups=c, dilation=dil, residual=r,
                                       gap=True)
            tag = (f"dw fwd {c} Cb={cb} {h}x{h} s{s} dilation {dil} n{n} "
                   "gelu+residual+gap")
            track("conv2d_depthwise_fwd_bf16", bf16_close(tag, got, want))
            check_gap(f"bf16 {tag}", dwk.depthwise_gap(
                x, w, b, s, "SAME", "gelu", r, dil, precision="bf16"),
                spec.ho * spec.wo, got)
        x = torch.randn((2, 3, 9, 9, 8), device=dev, generator=gen).to(bf)
        w = (torch.randn((5, 3, 1, 1, 8, 8), device=dev, generator=gen)
             / 24 ** 0.5).to(bf)
        b = 0.1 * torch.randn((5, 8), device=dev, generator=gen)
        r = torch.randn((2, 5, 9, 9, 8), device=dev, generator=gen).to(bf)
        got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", "gelu",
                                           residual=r, gap=True,
                                           precision="bf16")
        want = direct_conv_blocked(x, w, 1, "VALID", b, "gelu", "bf16",
                                   residual=r, gap=True)
        track("conv2d_pointwise_fwd_bf16", bf16_close(
            "pw fwd 24->40 Cib=Cob=8 9x9 n2 gelu+residual+gap", got, want))
        # the copies path (Cib 4, Cob 6: no TMA), items across 7x7 images
        x = torch.randn((3, 3, 7, 7, 4), device=dev, generator=gen).to(bf)
        w = (torch.randn((2, 3, 1, 1, 4, 6), device=dev, generator=gen)
             / 12 ** 0.5).to(bf)
        b = 0.1 * torch.randn((2, 6), device=dev, generator=gen)
        r = torch.randn((3, 2, 7, 7, 6), device=dev, generator=gen).to(bf)
        got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", "gelu",
                                           residual=r, gap=True,
                                           precision="bf16")
        want = direct_conv_blocked(x, w, 1, "VALID", b, "gelu", "bf16",
                                   residual=r, gap=True)
        tag = "pw fwd 12->12 Cib=4 Cob=6 7x7 n3 gelu+residual+gap"
        track("conv2d_pointwise_fwd_bf16", bf16_close(tag, got, want))
        check_gap(f"bf16 {tag}", pwk.pointwise_gap(
            x, w, b, "gelu", r, precision="bf16"), 49, got)
    stamp("a fwd")

    n = MB_TRAIN_BATCH
    bwd = {}       # per distinct leg at the training entry: operands to time
    for c, s, h in sorted({(ci, s, h) for ci, _, s, h in
                           mobilenet_blocks(ENTRY)}):
        x, w, b = dw_operands(n, c, h)
        with torch.no_grad():
            z = direct_conv_blocked(x, w, s, "SAME", b, None, "bf16",
                                    groups=c).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen).to(bf)
        bwd[("dw", c, s, h)] = (x, w, z, g)
        tag = f"dw {c} Cb={min(c, 128)} {h}x{h} s{s} n{n} relu"
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z, "relu",
                                         c, precision="bf16")
        got = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", z, "relu",
                                  precision="bf16")
        again = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", z, "relu",
                                    precision="bf16")
        torch.cuda.synchronize()
        track("conv2d_depthwise_dgrad_bf16", bf16_close(f"{tag} dgrad", got,
                                                        want))
        if not torch.equal(got, again):
            fail(f"bf16 dw dgrad {tag}: two runs differ")
        del got, again, want
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        wgrad_held(
            f"dw wgrad {tag}", "conv2d_depthwise_wgrad_bf16",
            lambda: dwk.depthwise_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                        True, precision="bf16"),
            lambda: dwk.depthwise_wgrad_partials(
                x, g, 3, 3, s, "SAME", z, "relu", True, precision="bf16"),
            x, dz, 3, s, c)
        del dz
    # the depthwise dgrad's and wgrad's other paths: the tap loop (dilation
    # 2, stride 3, 5x5), Cb = 3 (2-byte cells) at stride 2, a pencil of 6
    # (4-byte copies), TF-SAME pads (1, 1) and (0, 1) at stride 2
    for nn, c, h, cb, s, dil, hf, act in (
            (2, 24, 13, 8, 1, 2, 3, "gelu"), (2, 16, 11, 8, 3, 1, 3, "relu"),
            (2, 16, 12, 16, 1, 1, 5, "gelu"), (2, 6, 9, 3, 2, 1, 3, "relu"),
            (2, 12, 10, 6, 1, 1, 3, None), (2, 32, 7, 32, 2, 1, 3, "gelu"),
            (2, 64, 12, 64, 2, 1, 3, "relu")):
        x, w, b = dw_operands(nn, c, h, cb, hf)
        z = direct_conv_blocked(x, w, s, "SAME", b, None, "bf16", groups=c,
                                dilation=dil).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen).to(bf)
        zz = z if act else None
        tag = (f"dw {c} Cb={cb} {h}x{h} {hf}x{hf} s{s} dilation {dil} n{nn} "
               f"{act}")
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", zz, act, c,
                                         dil, precision="bf16")
        got = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", zz, act, dil,
                                  precision="bf16")
        torch.cuda.synchronize()
        track("conv2d_depthwise_dgrad_bf16", bf16_close(f"{tag} dgrad", got,
                                                        want))
        dz = conv2d_common.cotangent_prologue(g, zz, act)
        wgrad_held(
            f"dw wgrad {tag}", "conv2d_depthwise_wgrad_bf16",
            lambda: dwk.depthwise_wgrad(x, g, hf, hf, s, "SAME", zz, act,
                                        True, dil, precision="bf16"),
            lambda: dwk.depthwise_wgrad_partials(
                x, g, hf, hf, s, "SAME", zz, act, True, dil,
                precision="bf16"), x, dz, hf, s, c, dil)
    for ci, co, h in sorted({(ci, co, -(-h // s))
                             for ci, co, s, h in mobilenet_blocks(ENTRY)}):
        x, w, b = pw_operands(n, ci, co, h)
        with torch.no_grad():
            z = direct_conv_blocked(x, w, 1, "VALID", b, None,
                                    "bf16").contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen).to(bf)
        bwd[("pw", ci, co, h)] = (x, w, z, g)
        tag = f"pw {ci}->{co} {h}x{h} n{n} relu"
        want = direct_conv_dgrad_blocked(g, w, (h, h), 1, "VALID", z, "relu",
                                         precision="bf16")
        got = pwk.pointwise_dgrad(g, w, z, "relu", precision="bf16")
        again = pwk.pointwise_dgrad(g, w, z, "relu", precision="bf16")
        # as bf16 training calls it: on the dz pass's dz, prologue off
        on_dz = pwk.pointwise_dgrad(cotangent_pass(g, z, "relu", False)[0],
                                    w, precision="bf16", prologue_tiles=True)
        torch.cuda.synchronize()
        track("conv2d_pointwise_dgrad_bf16", bf16_close(f"{tag} dgrad", got,
                                                        want))
        if not torch.equal(got, again):
            fail(f"bf16 pw dgrad {tag}: two runs differ")
        if not torch.equal(on_dz, got):
            fail(f"bf16 pw dgrad {tag}: on the dz pass's dz it differs from "
                 "its own prologue")
        print(f"[check] bf16 {tag} dgrad on the dz pass's dz (prologue "
              "off): bit for bit the same dgrad with its prologue")
        del got, again, want, on_dz
        plan, model_plan = dgrad_plans(g, w, (h, h), 1, "VALID", z, "relu",
                                       dtype=bf)
        wplan, wmodel = wgrad_plans(x, g, 1, 1, 1, "VALID", z, "relu",
                                    dtype=bf)
        if plan != model_plan or wplan != wmodel:
            fail(f"bf16 pw {tag}: the kernels' plans {plan} {wplan} != the "
                 f"blocking model's {model_plan} {wmodel}")
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        wgrad_held(
            f"pw wgrad {tag}", "conv2d_pointwise_wgrad_bf16",
            lambda: pwk.pointwise_wgrad(x, g, z, "relu", True,
                                        precision="bf16"),
            lambda: pwk.pointwise_wgrad_partials(x, g, z, "relu", True,
                                                 precision="bf16"),
            x, dz, 1, 1, 1)
        del dz
    print("[bf16-sep] every launch above passed its C entry's check that "
          "the plan's shared memory is the kernel's own carve-up "
          "(core.blocking's *_smem_bytes at op_bytes 2), and the pointwise "
          "dgrad's and wgrad's plans (the dense bf16 tiles at 1x1) equal "
          "core.blocking's")
    # an fp16 policy has no build: refused on the card in inference and in
    # training, by both families, with no launch
    x, w, b = dw_operands(2, 16, 8)
    fp16 = Precision(operand="float16", residual="float16")
    calls = (
        lambda: dwk.depthwise_conv2d_blocked(x.half(), w.float(), b, 1,
                                             "SAME", precision=fp16),
        lambda: dwk.depthwise_conv2d_blocked(
            x.float(), w.float().requires_grad_(), b, 1, "SAME",
            precision=fp16),
        lambda: pwk.pointwise_conv2d_blocked(
            x.half(), torch.zeros((2, 1, 1, 1, 16, 8), device=dev), None,
            precision=fp16),
        lambda: pwk.pointwise_conv2d_blocked(
            x.float(), torch.zeros((2, 1, 1, 1, 16, 8), device=dev,
                                   requires_grad=True), None,
            precision=fp16))
    reset_all_launches()
    for call in calls:
        try:
            call()
        except NotImplementedError:
            continue
        fail("an fp16 separable call ran instead of raising "
             "NotImplementedError")
    if any(all_launches().values()):
        fail(f"an fp16 separable call launched {all_launches()}")
    print("[bf16-sep] fp16 inference and training raise NotImplementedError "
          "in both separable families, no launch")
    stamp("a bwd")

    # -- 24(b) MobileNet v1 served in bf16 ----------------------------------
    ctx = ConvContext(precision="bf16")
    server = ConvServer(model, list(BUCKETS), MB_BATCH, device=dev,
                        context=ctx)
    server.warmup()
    rng = np.random.default_rng(args.seed + 60)
    reqs = []
    for rid in range(24):
        hh, ww = (int(v) for v in rng.integers(96, ENTRY + 1, size=2))
        reqs.append(ConvRequest(rid, rng.standard_normal(
            (hh, ww, 3), dtype=np.float32)))
    reset_all_launches()
    for r in reqs:
        server.submit(r)
    server.run()
    torch.cuda.synchronize()
    served = {k: v for k, v in all_launches().items() if v}
    n_fwd = server.health()["batches"]
    one = {"direct_conv2d_fwd_bf16": 1, "conv2d_depthwise_fwd_bf16": 13,
           "conv2d_pointwise_fwd_bf16": 13}
    print(f"[bf16-mobilenet-serve] launches {served} batches {n_fwd}")
    if n_fwd == 0 or served != {k: v * n_fwd for k, v in one.items()}:
        fail(f"the bf16 MobileNet serve launched {served}, not {one} a "
             "batch (no f32, backward or plain route)")
    bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
    if bad:
        fail(f"bf16 MobileNet requests not OK: {bad}")
    served_err = plain_err = 0.0
    with torch.no_grad():
        for r in reqs:
            img = torch.from_numpy(server.bucketer.pad(
                r.image, r.bucket))[None].to(dev)
            f32 = plain_cnn_forward(img, model)[0]
            scale = f32.abs().max().item()
            served_err = max(served_err, float(
                (torch.from_numpy(r.logits).to(dev) - f32).abs().max())
                / scale)
            pb = plain_cnn_forward(img, model, "bf16")[0].float()
            plain_err = max(plain_err, float((pb - f32).abs().max()) / scale)
    lat = server.latencies() * 1e3
    print(f"[bf16-mobilenet-serve] 24 requests OK; served logits vs the f32 "
          f"plain forward: max rel-to-max err {served_err:.3e}, the bf16 "
          f"plain forward's {plain_err:.3e} (limit 2x: {2 * plain_err:.3e}); "
          f"latency p50 {np.percentile(lat, 50):.3f} ms p99 "
          f"{np.percentile(lat, 99):.3f} ms")
    if not served_err <= 2 * plain_err:
        fail("bf16 MobileNet served logits are further from the f32 plain "
             "forward than twice the bf16 plain forward")
    del server
    # the whole forward at batch 8, in bf16 beside f32, in this call
    with torch.no_grad():
        img = torch.randn((MB_BATCH, ENTRY, ENTRY, 3), device=dev,
                          generator=gen)
        for tag, c in (("bf16", ctx), ("f32", None)):
            def forward(c=c):
                return model(img, context=c)
            print(f"[bf16-mobilenet-serve] MobileNet v1 forward n{MB_BATCH} "
                  f"{ENTRY}x{ENTRY} {tag}: {time_ms(forward):.3f} ms eager, "
                  f"{graph_ms(forward):.3f} ms as a CUDA graph (weight casts "
                  f"included) on {smi}")
    stamp("b")

    # -- 24(c) MobileNet v1 trained in bf16 ---------------------------------
    want_step = {"direct_conv2d_fwd_bf16": 1, "direct_conv2d_wgrad_bf16": 1,
                 "direct_conv2d_dz_bf16": 14}
    for fam in ("depthwise", "pointwise"):
        for kind in ("fwd", "dgrad", "wgrad"):
            want_step[f"conv2d_{fam}_{kind}_bf16"] = 13
    trained, runs, batches, lr = bf16_trainers(
        model, n, args.seed + 60,
        [("bf16-mobilenet-train", ctx, want_step)], dev)
    bstep, bstate, bmodel = runs[0]
    stamp("c")

    # -- 24(d) per-leg times: eager, graph, plain, cuDNN bf16, the bound -----
    cl = torch.channels_last
    # (leg key, kind) -> (eager, graph, plain, cuDNN eager, cuDNN graph,
    # bound, bound_by); per pointwise leg the dense 1x1 control's (eager,
    # graph)
    rows, controls = {}, {}
    with torch.no_grad():
        for c, s, h in sorted({(ci, s, h) for ci, _, s, h in
                               mobilenet_blocks(ENTRY)}):
            x, w, b = dw_operands(MB_BATCH, c, h)
            spec = ConvSpec.make(MB_BATCH, h, h, c, c, 3, 3, s, "SAME",
                                 groups=c)
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(nchw(x), (pl, pr, pt, pb)).contiguous(
                memory_format=cl)
            wl = oihw(w, c).contiguous(memory_format=cl)
            bl = b.reshape(-1).to(bf)

            def fwd():
                return dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME",
                                                    "relu", precision="bf16")

            def lib():
                return F.conv2d(xp, wl, bl, stride=s, groups=c)
            rows[(("dw", c, s, h), "fwd")] = (
                time_ms(fwd), graph_ms(fwd),
                time_ms(lambda: direct_conv_blocked(
                    x, w, s, "SAME", b, "relu", "bf16", groups=c), iters=3),
                time_ms(lib), graph_ms(lib), *bound(spec.flops(), 2 * (
                    x.numel() + w.numel() + MB_BATCH * c * spec.ho * spec.wo)
                    + 4 * b.numel(), PEAK_BF16_FLOPS))
        for ci, co, h in sorted({(ci, co, -(-h // s)) for ci, co, s, h in
                                 mobilenet_blocks(ENTRY)}):
            gap = (ci, co, h) == (1024, 1024, 7)
            x, w, b = pw_operands(MB_BATCH, ci, co, h)
            xl = nchw(x).contiguous(memory_format=cl)
            wl = oihw(w, 1).contiguous(memory_format=cl)
            bl = b.reshape(-1).to(bf)
            out_elems = MB_BATCH * co * (1 if gap else h * h)

            def fwd():
                return pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID",
                                                    "relu", gap=gap,
                                                    precision="bf16")

            def lib():
                return F.conv2d(xl, wl, bl)

            def dense():
                return direct_conv2d_blocked(x, w, b, 1, "VALID", "relu",
                                             gap=gap, precision="bf16",
                                             stream=False)
            # the control: the dense bf16 forward (fwd_kernel_bf16) at 1x1
            controls[(ci, co, h)] = (time_ms(dense), graph_ms(dense))
            rows[(("pw", ci, co, h), "fwd")] = (
                time_ms(fwd), graph_ms(fwd),
                time_ms(lambda: direct_conv_blocked(
                    x, w, 1, "VALID", b, "relu", "bf16", gap=gap), iters=3),
                time_ms(lib), graph_ms(lib), *bound(
                    2 * MB_BATCH * h * h * ci * co,
                    2 * (x.numel() + w.numel() + out_elems) + 4 * b.numel(),
                    PEAK_BF16_FLOPS))
    for key, (x, w, z, g) in bwd.items():
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        dzl = nchw(dz).contiguous(memory_format=cl)
        if key[0] == "dw":
            _, c, s, h = key
            spec = ConvSpec.make(n, h, h, c, c, 3, 3, s, "SAME", groups=c)
            (pt, pb), (pl, pr) = spec.pads
            xin = F.pad(nchw(x), (pl, pr, pt, pb)).contiguous(
                memory_format=cl)
            wl = oihw(w, c).contiguous(memory_format=cl)
            flops, st, groups, out_c = spec.flops(), s, c, c

            def dgrad():
                return dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", z,
                                           "relu", precision="bf16")

            def wgrad():
                return dwk.depthwise_wgrad_partials(
                    x, g, 3, 3, s, "SAME", z, "relu", True, precision="bf16")

            def plain_d():
                return direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z,
                                                 "relu", c, precision="bf16")

            def plain_w():
                return direct_conv_wgrad_blocked(
                    x, g, 3, 3, s, "SAME", z, "relu", True, c,
                    precision="bf16")
        else:
            _, ci, co, h = key
            xin = nchw(x).contiguous(memory_format=cl)
            wl = oihw(w, 1).contiguous(memory_format=cl)
            flops, st, groups, out_c = 2 * n * h * h * ci * co, 1, 1, co

            def dgrad():
                return pwk.pointwise_dgrad(g, w, z, "relu", precision="bf16")

            def wgrad():
                return pwk.pointwise_wgrad_partials(x, g, z, "relu", True,
                                                    precision="bf16")

            def plain_d():
                return direct_conv_dgrad_blocked(g, w, (h, h), 1, "VALID", z,
                                                 "relu", precision="bf16")

            def plain_w():
                return direct_conv_wgrad_blocked(
                    x, g, 1, 1, 1, "VALID", z, "relu", True,
                    precision="bf16")
        for kind, fn, plain, mask, nbytes in (
                ("dgrad", dgrad, plain_d, [True, False, False],
                 2 * (2 * g.numel() + w.numel() + x.numel())),
                ("wgrad", wgrad, plain_w, [False, True, False],
                 2 * (x.numel() + 2 * g.numel())
                 + 4 * (w.numel() + out_c))):
            def lib(mask=mask):
                return torch.ops.aten.convolution_backward(
                    dzl, xin, wl, None, [st, st], [0, 0], [1, 1], False,
                    [0, 0], groups, mask)
            rows[(key, kind)] = (time_ms(fn), graph_ms(fn),
                                 time_ms(plain, iters=3), time_ms(lib),
                                 graph_ms(lib),
                                 *bound(flops, nbytes, PEAK_BF16_FLOPS))
        del dz, dzl, xin
    del bwd
    sums = {k: [0.0] * 6 for k in fn_of}
    kinds = {k: [] for k in fn_of}
    control = [0.0, 0.0]
    for i, (ci, co, s, h) in enumerate(mobilenet_blocks(ENTRY)):
        ho = -(-h // s)
        for leg, key, fam, cout, ext, st in (
                ("dw", ("dw", ci, s, h), "depthwise", ci, h, s),
                ("pw", ("pw", ci, co, ho), "pointwise", co, ho, 1)):
            for kind in ("fwd", "dgrad", "wgrad"):
                *times, b_by = rows[(key, kind)]
                k_ms, g_ms, p_ms, l_ms, l_graph, b_ms = times
                name = f"conv2d_{fam}_{kind}_bf16"
                for j, v in enumerate(times):
                    sums[name][j] += v
                kinds[name].append((b_ms, b_by))
                print(f"[bf16-sep-time] block{i + 1} {leg} {kind} {ci}->"
                      f"{cout} in {ext}x{ext} s{st} "
                      f"n{MB_BATCH if kind == 'fwd' else n}: eager_ms "
                      f"{k_ms:.4f} graph_ms {g_ms:.4f} plain_ms {p_ms:.4f} "
                      f"cuDNN bf16 ms {l_ms:.4f} [{l_graph:.4f}] "
                      f"(channels-last) bound_ms {b_ms:.4f} ({b_by}, bf16) "
                      f"bound/graph {b_ms / g_ms:.3f}")
                if leg == "pw" and kind == "fwd":
                    c_ms, c_graph = controls[key[1:]]
                    control[0] += c_ms
                    control[1] += c_graph
                    print(f"[bf16-sep-time] block{i + 1} pw fwd control: "
                          f"the dense bf16 forward (fwd_kernel_bf16) at 1x1 "
                          f"eager_ms {c_ms:.4f} graph_ms {c_graph:.4f}")
    for name, (k_ms, g_ms, p_ms, l_ms, l_graph, b_ms) in sums.items():
        print(f"[bf16-sep-time] all 13 {name} ({fn_of[name]}) on {smi}: "
              f"eager_ms {k_ms:.4f} graph_ms {g_ms:.4f} plain_ms {p_ms:.4f} "
              f"cuDNN bf16 ms {l_ms:.4f} [{l_graph:.4f}] bound_ms "
              f"{b_ms:.4f} ({mostly(kinds[name])}, bf16), "
              f"{100 * b_ms / g_ms:.1f} % of the bound as a graph")
    print(f"[bf16-sep-time] all 13 pw fwd legs' control, the dense bf16 "
          f"forward (fwd_kernel_bf16) at 1x1, on {smi}: eager_ms "
          f"{control[0]:.4f} graph_ms {control[1]:.4f}")
    stamp("d")

    # -- 24(e) the bf16 step beside the f32 step; peak memory -----------------
    f32m = copy.deepcopy(model)
    f32opt = AdamW(lr=lr)
    f32state = f32opt.init(dict(f32m.named_parameters()))
    f32step = make_train_step(f32m, f32opt)
    timed = timed_steps(f"bf16-mobilenet-train n{n}", [
        ("f32", f32step, f32state), ("bf16", bstep, bstate)], batches)
    del f32m, f32state, f32step
    torch.cuda.empty_cache()
    print(f"[bf16-mobilenet-train] step medians on {smi}: " + ", ".join(
        f"{k} {np.median(v):.3f} ms" for k, v in timed.items()))
    ci0, co0, s0 = MOBILENET_V1_CONV1
    shapes = [mm.ConvShape("conv1", n, ENTRY, ENTRY, ci0, co0, 3, 3, s0,
                           "SAME")]
    for i, (ci, co, s, h) in enumerate(mobilenet_blocks(ENTRY)):
        ho = -(-h // s)
        shapes += [mm.ConvShape(f"dw{i + 1}", n, h, h, ci, ci, 3, 3, s,
                                "SAME", groups=ci),
                   mm.ConvShape(f"pw{i + 1}", n, ho, ho, ci, co, 1, 1, 1,
                                "VALID")]
    split = [mm.bytes_precision_split(sh, "bf16") for sh in shapes]
    modelled = sum(sp["total"] for sp in split)
    f32_total = sum(sp["f32_total"] for sp in split)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bstep(bstate, batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[bf16-mobilenet-train] step peak device memory above the "
          f"parameters, gradients and moments it holds {peak / 2**20:.1f} "
          f"MiB; memory_model.bytes_precision_split's bf16 training bytes "
          f"over conv1 and the 26 legs {modelled / 2**20:.1f} MiB (the f32 "
          f"policy's {f32_total / 2**20:.1f} MiB) ({smi})")
    del runs, bstep, bstate, bmodel
    torch.cuda.empty_cache()

    counts = {k: served.get(k, 0) + trained.get(k, 0)
              for k in (*fn_of, "direct_conv2d_dz_bf16")}
    entries = []
    for name, (k_ms, g_ms, p_ms, l_ms, l_graph, b_ms) in sums.items():
        fam_kind = name[:-len("_bf16")]
        source = BWD_SOURCE if name in ("conv2d_pointwise_dgrad_bf16",
                                        "conv2d_pointwise_wgrad_bf16") else \
            (PW_SOURCE if "pointwise" in name else DW_SOURCE)
        entries.append({
            "name": f"{name} ({fn_of[name]})", "route": "cuda",
            "source": source, "replaces": TPU_SEPARABLE[fam_kind],
            "launches": counts[name], "max_abs_err": err[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": mostly(kinds[name]), "library_ms": l_ms})
    print(f"[time] phase 24 done at {time.perf_counter() - t_start:.1f} s")
    return entries, counts


# Phase 25: AlexNet's two towers (Krizhevsky et al. 2012; Caffe's
# bvlc_alexnet keeps group 2 on conv2, conv4, conv5) and two dilated
# layers of DeepLab-LargeFOV (Chen et al. 2015, arXiv:1412.7062: conv5 at
# dilation 2, fc6 at dilation 12, on the 41x41 map of a 321 input at output
# stride 8), on the window forward's grouped map and dilated taps
ALEXNET_ENTRY = 227
# (name, n, ci, co, h, filter, stride, padding, groups, dilation, lane, gap)
GROUPED_DILATED_SHAPES = [
    ("alexnet.conv4@128", 8, 384, 384, 13, 3, 1, "SAME", 2, 1, 128, False),
    ("alexnet.conv5@128", 8, 384, 256, 13, 3, 1, "SAME", 2, 1, 128, True),
    ("deeplab.conv5", 8, 512, 512, 41, 3, 1, "SAME", 1, 2, 128, False),
    ("deeplab.fc6", 8, 512, 1024, 41, 3, 1, "SAME", 1, 12, 128, False),
    ("g4.d2.s2", 8, 256, 256, 56, 3, 2, "SAME", 4, 2, 64, False),
    ("d3.s2", 8, 128, 128, 28, 3, 2, "SAME", 1, 3, 128, False),
]


def unread_share(blk, f: int, d: int) -> float:
    """The share of a stride-1 bf16 window plane's cells that no tap reads:
    a tile's rows (columns) read ``a + t d`` over its ``th`` (``tw``)
    outputs and ``f`` taps, against the plane's rows and pitch."""
    rows = len({a + t * d for a in range(blk.th) for t in range(f)})
    cols = len({a + t * d for a in range(blk.tw) for t in range(f)})
    plane_rows = blk.th + (f - 1) * d
    return 1 - rows * cols / (plane_rows * blk.pitch)


def grouped_dilated_phases(args, dev, t_start, smi):
    """Phase 25: the window forward's grouped map and dilated taps, both
    builds.  (a) each AlexNet layer (``configs.cnn.alexnet_blocked``: its
    weights, lane 64) at batch 8 on its own input extent, and conv4/conv5 at
    lane 128 (Cib 96, Cob 96 and 128), kernel against plain version (f32:
    phase 3's tolerance; bf16: phase 22's), two runs bit for bit, the GAP
    of conv5 folded (``check_gap``); (b) DeepLab-LargeFOV's conv5 and fc6,
    groups 4 with dilation 2 at stride 2, dilation 3 at stride 2, likewise;
    (c) AlexNet served by ``ConvServer`` (24 requests, batch 8, 227x227) in
    f32 (logits within ``LOGIT_RTOL`` of the largest of the plain forward)
    and in bf16 (within twice the bf16 plain forward's distance from f32),
    only the forward kernel of each build launched; (d) per layer eager and
    CUDA-graph ms, plain ms, cuDNN ``F.conv2d(groups=, dilation=)`` (f32
    with TF32 off; bf16 channels-last), the bound and its share, the
    kernel's own MAC count (its ``*_plan`` entry, equal to the grouped
    function's) with the padding its tiles issue, and the AlexNet forward;
    (e) a forced stream and autograd on grouped geometry raise, launching
    nothing.  -> (kernels-line entries, the served launches)."""
    from repro_torch.configs.cnn import ALEXNET_LANE, alexnet_blocked
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.core.blocking import H100_SXM, fwd_candidates
    from repro_torch.core.layout import BlockedConvLayout
    from repro_torch.kernels import direct_conv2d as dck
    from repro_torch.kernels.direct_conv2d import (direct_conv2d_blocked,
                                                   fwd_launch, fwd_plans,
                                                   gap_forward)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome
    names = {False: "direct_conv2d_fwd", True: "direct_conv2d_fwd_bf16"}
    gen = torch.Generator().manual_seed(args.seed + 250)
    model = alexnet_blocked(device=dev, generator=gen)
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 251)

    def stamp(part):
        print(f"[time] phase 25({part}) done at "
              f"{time.perf_counter() - t_start:.1f} s")

    # the shapes of (a) and (b): (name, x, w, b, spec, gap)
    cases = []
    h = ALEXNET_ENTRY
    for i, conv in enumerate(model.convs):
        spec = conv.spec(BATCH, h, h)
        x = torch.randn((BATCH, conv.ci // conv.in_pencil, h, h,
                         conv.in_pencil), device=dev, generator=dgen)
        cases.append((f"alexnet.conv{i + 1}", x, conv.w.detach(),
                      conv.b.detach(), spec, i == len(model.convs) - 1))
        h = spec.ho
    for (name, n, ci, co, hh, f, s, pad, g, d, lane,
         gap) in GROUPED_DILATED_SHAPES:
        lay = BlockedConvLayout.choose(ci, co, lane, groups=g)
        spec = ConvSpec.make(n, hh, hh, ci, co, f, f, s, pad, g, d)
        cig = ci // g
        x = torch.randn((n, ci // lay.cb_in, hh, hh, lay.cb_in), device=dev,
                        generator=dgen)
        w = torch.randn((co // lay.cb_out, cig // lay.cb_in, f, f,
                         lay.cb_in, lay.cb_out), device=dev,
                        generator=dgen) / (f * f * cig) ** 0.5
        b = 0.1 * torch.randn((co // lay.cb_out, lay.cb_out), device=dev,
                              generator=dgen)
        cases.append((name, x, w, b, spec, gap))

    # -- 25(a-b) kernel against plain version, both builds -------------------
    max_err = {False: 0.0, True: 0.0}
    with torch.no_grad():
        for name, x, w, b, spec, gap in cases:
            pad, g, d = spec.pads, spec.groups, spec.dilation
            for bf16 in (False, True):
                prec = "bf16" if bf16 else "f32"
                xin = x.bfloat16() if bf16 else x
                reset_all_launches()
                got = direct_conv2d_blocked(xin, w, b, spec.stride, pad,
                                            "relu", precision=prec, groups=g,
                                            dilation=d)
                again = direct_conv2d_blocked(xin, w, b, spec.stride, pad,
                                              "relu", precision=prec,
                                              groups=g, dilation=d)
                torch.cuda.synchronize()
                launched = {k: v for k, v in all_launches().items() if v}
                if launched != {names[bf16]: 2}:
                    fail(f"{name} {prec}: launched {launched}, not two "
                         f"{names[bf16]}")
                want = direct_conv_blocked(xin, w, spec.stride, pad, b,
                                           "relu", prec, g, d)
                label = (f"{name} {prec} {spec.ci}->{spec.co} groups {g} "
                         f"dilation {d[0]} s{spec.stride} in "
                         f"{spec.hi}x{spec.wi}")
                err = (bf16_close(label, got, want) if bf16 else
                       compare(label, got, want, **TOL))
                max_err[bf16] = max(max_err[bf16], err)
                if not torch.equal(got, again):
                    fail(f"{label}: two runs differ")
                if gap:
                    launch = gap_forward(xin, w, b, spec.stride, pad, "relu",
                                         precision=prec, groups=g,
                                         dilation=d)
                    other, _ = gap_forward(xin, w, b, spec.stride, pad,
                                           "relu", precision=prec, groups=g,
                                           dilation=d)
                    check_gap(f"{label} GAP", launch, spec.ho * spec.wo,
                              other)
                    pooled = launch[0].double()
                    want_p = direct_conv_blocked(xin, w, spec.stride, pad, b,
                                                 "relu", prec, g, d,
                                                 gap=True).double()
                    rel = ((pooled - want_p).abs().max()
                           / want_p.abs().max()).item()
                    print(f"[grouped] {label} GAP: pooled vs the plain "
                          f"pooled features, max rel-to-max {rel:.3e}")
                    if rel > (1e-2 if bf16 else 1e-4):
                        fail(f"{label}: pooled features off the plain ones")
    stamp("a-b")

    # -- 25(c) AlexNet served in f32 and bf16 ---------------------------------
    rng = np.random.default_rng(args.seed + 252)
    images = [rng.standard_normal((ALEXNET_ENTRY, ALEXNET_ENTRY, 3),
                                  dtype=np.float32) for _ in range(24)]
    bucket = [(ALEXNET_ENTRY, ALEXNET_ENTRY)]
    served_counts, runs = {}, {}
    for bf16 in (False, True):
        ctx = ConvContext(precision="bf16" if bf16 else "f32")
        server = ConvServer(model, bucket, BATCH, device=dev, context=ctx)
        server.warmup()
        reqs = [ConvRequest(i, img) for i, img in enumerate(images)]
        reset_all_launches()
        for r in reqs:
            server.submit(r)
        server.run()
        torch.cuda.synchronize()
        got = {k: v for k, v in all_launches().items() if v}
        n_fwd = server.health()["batches"]
        prec = "bf16" if bf16 else "f32"
        print(f"[alexnet-serve] {prec}: launches {got} batches {n_fwd}")
        if n_fwd == 0 or got != {names[bf16]: 5 * n_fwd}:
            fail(f"the {prec} AlexNet serve launched {got}, not 5 "
                 f"{names[bf16]} a batch")
        bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
        if bad:
            fail(f"AlexNet {prec} requests not OK: {bad}")
        served_counts[names[bf16]] = got.get(names[bf16], 0)
        runs[bf16] = (reqs, server)
    err = {False: 0.0, True: 0.0}
    plain_err = 0.0
    with torch.no_grad():
        for i in range(24):
            img = torch.from_numpy(images[i])[None].to(dev)
            f32 = plain_cnn_forward(img, model)[0]
            scale = f32.abs().max().item()
            for bf16 in (False, True):
                logits = torch.from_numpy(runs[bf16][0][i].logits).to(dev)
                err[bf16] = max(err[bf16], float(
                    (logits.float() - f32).abs().max()) / scale)
            pb = plain_cnn_forward(img, model, "bf16")[0].float()
            plain_err = max(plain_err, float((pb - f32).abs().max()) / scale)
    for bf16 in (False, True):
        lat = runs[bf16][1].latencies() * 1e3
        limit = 2 * plain_err if bf16 else LOGIT_RTOL
        print(f"[alexnet-serve] {'bf16' if bf16 else 'f32'}: 24 requests OK; "
              f"logits vs the f32 plain forward: max rel-to-max err "
              f"{err[bf16]:.3e} (limit {limit:.3e}"
              f"{', twice the bf16 plain forward' if bf16 else ''}); latency "
              f"p50 {np.percentile(lat, 50):.3f} ms p99 "
              f"{np.percentile(lat, 99):.3f} ms")
        if not err[bf16] <= limit:
            fail(f"AlexNet {'bf16' if bf16 else 'f32'} served logits off "
                 "the plain forward")
    del runs
    stamp("c")

    # -- 25(d) times, MACs, bounds --------------------------------------------
    print(f"[grouped-time] {smi}")
    sums = {False: [0.0] * 5, True: [0.0] * 5}
    kinds = {False: [], True: []}
    with torch.no_grad():
        for name, x, w, b, spec, gap in cases:
            pad, g, d, s = spec.pads, spec.groups, spec.dilation, spec.stride
            n, co = spec.n, spec.co
            (pt, pb_), (pl, pr) = pad
            macs = spec.flops() // 2
            for bf16 in (False, True):
                prec = "bf16" if bf16 else "f32"
                dt = torch.bfloat16 if bf16 else torch.float32
                xin, wl = x.to(dt), w.to(dt)
                xp = F.pad(nchw(xin), (pl, pr, pt, pb_))
                w_oihw = w.permute(0, 5, 1, 4, 2, 3).reshape(
                    co, spec.cig, spec.hf, spec.wf).to(dt)
                b_flat = b.reshape(co).to(dt)
                if bf16:
                    xp = xp.contiguous(memory_format=torch.channels_last)
                    w_oihw = w_oihw.contiguous(
                        memory_format=torch.channels_last)
                else:
                    xp, w_oihw = xp.contiguous(), w_oihw.contiguous()

                def lib():
                    return F.conv2d(xp, w_oihw, b_flat, stride=s, groups=g,
                                    dilation=d)

                def fwd():
                    return direct_conv2d_blocked(xin, w, b, s, pad, "relu",
                                                 precision=prec, groups=g,
                                                 dilation=d)
                kernel, model_plan = fwd_plans(xin, w, s, pad, dtype=dt,
                                               groups=g, dilation=d)
                if kernel != model_plan:
                    fail(f"{name} {prec}: the kernel's plan {kernel} != the "
                         f"blocking model's {model_plan}")
                if kernel.function_macs != macs:
                    fail(f"{name} {prec}: the kernel counts "
                         f"{kernel.function_macs} MACs, the grouped function "
                         f"{macs}")
                blk = fwd_launch(spec, x.shape[4], w.shape[5], 1, False,
                                 False, dtype=dt).blk
                k_ms, g_ms = time_ms(fwd), graph_ms(fwd)
                l_ms, l_graph = time_ms(lib), graph_ms(lib)
                p_ms = time_ms(lambda: direct_conv_blocked(
                    xin, w, s, pad, b, "relu", prec, g, d), iters=3)
                esize = 2 if bf16 else 4
                nbytes = (esize * (x.numel() + w.numel()
                                   + n * co * spec.ho * spec.wo)
                          + 4 * b.numel())
                if bf16:
                    b_ms, b_by = bound(spec.flops(), nbytes, PEAK_BF16_FLOPS)
                    fma = ""
                else:
                    b_ms, b_by, f_ms = tf32x3_bound(spec.flops(), nbytes)
                    fma = f" [f32 FMA {f_ms:.4f}]"
                unread = (f", window cells no tap reads "
                          f"{100 * unread_share(blk, spec.hf, d[0]):.1f} %"
                          if bf16 and d[0] > 1 and s == 1 else "")
                slow = g_ms / l_graph
                print(f"[grouped-time] {name} {prec} {spec.ci}->{co} groups "
                      f"{g} dilation {d[0]} s{s} {spec.hi}->{spec.ho} "
                      f"n{n}: kernel_ms {k_ms:.4f} graph_ms {g_ms:.4f} "
                      f"plain_ms {p_ms:.4f} cuDNN ms {l_ms:.4f} "
                      f"[{l_graph:.4f}] ({slow:.2f}x as graphs"
                      f"{'; more than 2x cuDNN' if slow > 2 else ''}) "
                      f"bound_ms {b_ms:.4f} ({b_by}{fma}) bound/graph "
                      f"{b_ms / g_ms:.3f}; tiles {blk.th}x{blk.tw}, "
                      f"{blk.wgs} consumer(s), lanes {blk.lanes} x "
                      f"{blk.nsplit}, chunk {blk.chunk}, window "
                      f"{blk.hwin}x{blk.wwin}, pitch {blk.pitch}, filter "
                      f"rows a stage {blk.stage_rows(spec.hf)}; "
                      f"MACs {macs} (1/{g} of the dense {macs * g}), issued "
                      f"{kernel.issued_macs} ({kernel.products} a MAC; "
                      f"padding {100 * kernel.padding_share:.1f} %), "
                      f"shared memory {kernel.smem} B{unread}")
                if bf16 and blk.nsplit > 2:
                    # Cob 48/96: the chosen split (three ways or more)
                    # lands whole weight rows by TMA; time the best two-way
                    # split, whose weights come by 2-byte copies, beside it
                    alt = min((kb for kb in fwd_candidates(
                        n, spec.ho, spec.wo, spec.hf, spec.wf, s,
                        spec.cig // x.shape[4], x.shape[4], w.shape[0],
                        w.shape[5], H100_SXM, False, False, None, 2, d)
                        if kb[1].nsplit <= 2), key=lambda kb: kb[0])[1]
                    aplan = fwd_launch(spec, x.shape[4], w.shape[5], 1, False,
                                       False, blk=alt, dtype=dt)
                    entry = dck._lib().direct_conv2d_fwd

                    def copies():
                        err_, out_, _, _ = dck.fwd_run(entry, aplan, xin, w,
                                                       b, None, spec)
                        if err_:
                            fail(f"{name}: the two-way split failed ({err_})")
                        return out_
                    bf16_close(f"{name} bf16, the two-way split "
                               f"(lanes {alt.lanes} x {alt.nsplit})",
                               copies(), fwd())
                    a_ms = graph_ms(copies)
                    print(f"[grouped-time] {name} bf16 Cob {w.shape[5]}: "
                          f"{blk.nsplit} x {blk.lanes} lanes (weights by TMA) "
                          f"{g_ms:.4f} ms against {alt.nsplit} x {alt.lanes} "
                          f"(weights by 2-byte copies) {a_ms:.4f} ms, as "
                          "graphs")
                if name.startswith("alexnet.conv") and "@" not in name:
                    for j, v in enumerate((k_ms, p_ms, b_ms, l_ms, g_ms)):
                        sums[bf16][j] += v
                    kinds[bf16].append((b_ms, b_by))
        img = torch.randn((BATCH, ALEXNET_ENTRY, ALEXNET_ENTRY, 3),
                          device=dev)
        for bf16 in (False, True):
            ctx = ConvContext(precision="bf16" if bf16 else "f32")
            f_ms = time_ms(lambda: model(img, context=ctx), iters=5)
            f_graph = graph_ms(lambda: model(img, context=ctx), iters=3)
            k_ms, p_ms, b_ms, l_ms, g_ms = sums[bf16]
            print(f"[grouped-time] AlexNet forward n{BATCH} "
                  f"{ALEXNET_ENTRY}x{ALEXNET_ENTRY} "
                  f"{'bf16' if bf16 else 'f32'}: {f_ms:.3f} ms eager, "
                  f"{f_graph:.3f} ms as a CUDA graph; its 5 convs: kernel "
                  f"{k_ms:.4f} ms eager, {g_ms:.4f} as graphs, plain "
                  f"{p_ms:.4f}, cuDNN {l_ms:.4f}, bound {b_ms:.4f} "
                  f"({100 * b_ms / g_ms:.1f} % as graphs)")
    stamp("d")

    # -- 25(e) a forced stream refused; gradients through grouped and ------
    # dilated layers (their backward, phase 26)
    name, x, w, b, spec, _ = cases[1]           # conv2, groups 2
    reset_all_launches()
    try:
        with torch.no_grad():
            direct_conv2d_blocked(x, w, b, spec.stride, spec.pads, "relu",
                                  groups=2, stream=True)
        fail("a forced stream on a grouped layer ran")
    except ValueError as e:
        print(f"[grouped] forced stream on {name}: ValueError ({e})")
    if any(all_launches().values()):
        fail(f"a refused call launched {all_launches()}")
    for case in (cases[1], cases[len(model.convs) + 3]):   # conv2, fc6
        name, x, w, b, spec, _ = case
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        reset_all_launches()
        direct_conv2d_blocked(xg, wg, b, spec.stride, spec.pads, "relu",
                              groups=spec.groups,
                              dilation=spec.dilation).square().sum().backward()
        torch.cuda.synchronize()
        ran = {k: v for k, v in all_launches().items() if v}
        # a dgrad whose contraction passes kMaxTruncatingK (fc6's) is a grid
        # a Co block
        want = {"direct_conv2d_fwd": 1, "direct_conv2d_dgrad":
                ran.get("direct_conv2d_dgrad", 0) or 1,
                "direct_conv2d_wgrad": 1}
        if ran != want or not all(
                torch.isfinite(t).all() and t.abs().sum() > 0
                for t in (xg.grad, wg.grad)):
            fail(f"autograd through {name}: launched {ran}, not {want} "
                 "with finite nonzero gradients")
        print(f"[grouped] autograd through {name} (groups {spec.groups}, "
              f"dilation {spec.dilation[0]}): finite nonzero dx and dw, "
              f"launched {ran}")
    entries = []
    for bf16 in (False, True):
        k_ms, p_ms, b_ms, l_ms, _ = sums[bf16]
        entries.append({
            "name": f"{names[bf16]} ({'fwd_kernel_bf16' if bf16 else 'fwd_kernel'}"
                    ": grouped and dilated, AlexNet)",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL + " (grouped map :319-325)",
            "launches": served_counts[names[bf16]],
            "max_abs_err": max_err[bf16], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": mostly(kinds[bf16]),
            "library_ms": l_ms})
    print(f"[time] phase 25 done at {time.perf_counter() - t_start:.1f} s")
    return entries, served_counts


# Phase 26: the backward of phase 25's grouped and dilated geometry (the
# reference's _dgrad_windowed and _wgrad_windowed), and AlexNet's two towers
# trained on it at batch 32
ALEXNET_TRAIN_BATCH = 32


def dgrad_pairs(spec):
    """``(the dgrad's MACs, the phase split's)`` of ``spec``: the (input
    position, tap) pairs whose output lies in the map, and those whose
    division is exact wherever the output lies (the phases' taps, whose
    rows outside the map the kernels read as zeros), each times Cib x the
    group's Co, over the images."""
    (pt, _), (pl, _) = spec.pads
    true, split = 1, 1
    for e, f, p, d, o in ((spec.hi, spec.hf, pt, spec.dilation[0], spec.ho),
                          (spec.wi, spec.wf, pl, spec.dilation[1], spec.wo)):
        hits = [(i + p - k * d) // spec.stride for i in range(e)
                for k in range(f) if (i + p - k * d) % spec.stride == 0]
        true *= sum(1 for q in hits if 0 <= q < o)
        split *= len(hits)
    per = spec.n * spec.ci * spec.co // spec.groups
    return true * per, split * per


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its return type, namespace and
    parameter list (``void (anonymous namespace)::fwd_kernel<32>(...)`` ->
    ``fwd_kernel<32>``)."""
    import re
    return re.sub(r"^void |\(anonymous namespace\)::", "",
                  key).split("(")[0][:60]


def bwd_window_unread(kind: str, bf16: bool, spec, cib: int, cob: int):
    """The share of a backward tile's staged window that no tap reads, at
    the tile the chooser takes for ``spec``: the dgrad's cotangent window
    (the f32 tile's rows gathered into the taps' bands where they are
    sparse), or the wgrad's x window (the f32 tile's bands, the bf16
    build's column phases)."""
    from repro_torch.core import blocking as B
    ob = 2 if bf16 else 4
    s, (dh, dw) = spec.stride, spec.dilation

    def share(positions, offsets, staged):
        return len({p + o for p in positions for o in offsets}) / staged
    if kind == "dgrad":
        blk = B.choose_dgrad_blocking(spec.n, spec.hi, spec.wi, spec.hf,
                                      spec.wf, s, spec.ci // cib, cib, cob,
                                      B.H100_SXM, True, ob, spec.dilation)
        (th_, qh), (tw_, qw) = (B.dgrad_tap_steps(s, d) for d in (dh, dw))
        mh = B.dgrad_max_taps(spec.hf, s, dh)
        mw = B.dgrad_max_taps(spec.wf, s, dw)
        band = blk.th if (not bf16 and B.dgrad_gathered(
            blk.th, spec.hf, s, dh)) else qh
        rows = share(range(blk.th), [u * band for u in range(mh)], blk.hwin)
        cols = share(range(blk.tw), [u * qw for u in range(mw)], blk.wwin)
        return 1 - rows * cols
    blk = B.choose_wgrad_blocking(spec.n, spec.ho, spec.wo, spec.hf, spec.wf,
                                  s, spec.ci // cib, cib, spec.co // cob, cob,
                                  B.H100_SXM, True, ob, spec.groups,
                                  spec.dilation)
    pos_h = [a * s for a in range(blk.th)]
    pos_w = [b * s for b in range(blk.tw)]
    if bf16:
        rows = share(pos_h, [k * dh for k in range(spec.hf)], blk.hwin)
        cells = {((p + k * dw) % s, (p + k * dw) // s) for p in pos_w
                 for k in range(spec.wf)}
        cols = len(cells) / (B.wgrad_bf16_phases(spec.wf, s, dw)
                             * B.wgrad_bf16_wph(blk.tw, spec.wf, s, dw))
        return 1 - rows * cols
    nrows, bands, cells = B.wgrad_staged(blk.th, blk.tw, spec.hf, spec.wf, s,
                                         spec.dilation)
    bh = nrows // spec.hf if nrows != blk.hwin else dh
    bw = cells if bands > 1 else dw
    rows = share(pos_h, [k * bh for k in range(spec.hf)], nrows)
    cols = share(pos_w, [k * bw for k in range(spec.wf)], bands * cells)
    return 1 - rows * cols


def grouped_dilated_bwd_phases(args, dev, t_start, smi):
    """Phase 26: the window dgrad and wgrad on grouped (Cig > 1) and dilated
    geometry, both builds.  (a) AlexNet (``alexnet_blocked``, lane 64, its
    weights) at batch 8: the wgrad of conv1-5 and the dgrad of conv2-5 (the
    images take no gradient); DeepLab-LargeFOV's conv5 (dilation 2) and fc6
    (dilation 12) at 41x41, groups 4 with dilation 2 at stride 2, dilation
    3 at stride 2 (phase 25's shapes): each against its plain version by
    phase 9's and 23's rules (f32 dx within ``TOL``; bf16 dx within a bf16
    ulp + 1e-5 of max and bit for bit the same dgrad on the dz pass's dz;
    dw and db against f64 sums within ``WGRAD_REL`` of sum|x dz|, the folded
    split sums bit for bit their in-order sum), two runs bit for bit, each
    kernel's plan (its C entry) equal to the blocking model's; (b) AlexNet
    trained 3 AdamW steps at batch 32 on 227x227 images, in f32 in lockstep
    with a plain trainer (``lockstep_train``) and in bf16 by
    ``bf16_trainers``' rules, each step launching that build's window
    kernels alone; (c) per layer the dgrad and the wgrad eager and as CUDA
    graphs beside cuDNN's ``convolution_backward(groups=, dilation=)`` (f32
    with TF32 off; bf16 channels-last; no db), the bound and its share, the
    kernels' MAC counts (the dgrad's: the (input, tap) pairs whose output
    lies in the map, and the phases' count beside it), and the AlexNet step
    under ``torch.profiler`` and on the host clock.  -> (kernels-line
    entries, the launches of the two AlexNet trainings)."""
    from repro_torch.configs.cnn import alexnet_blocked
    from repro_torch.core import conv2d_common
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.core.layout import BlockedConvLayout
    from repro_torch.kernels.direct_conv2d import (cotangent_pass,
                                                   direct_conv2d_dgrad,
                                                   direct_conv2d_wgrad,
                                                   dgrad_plans, split_wgrad,
                                                   wgrad_partials,
                                                   wgrad_plans)
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainstep import make_train_step
    bf = torch.bfloat16
    key = {(False, "dgrad"): "direct_conv2d_dgrad",
           (True, "dgrad"): "direct_conv2d_dgrad_bf16",
           (False, "wgrad"): "direct_conv2d_wgrad",
           (True, "wgrad"): "direct_conv2d_wgrad_bf16"}
    fn_of = {"direct_conv2d_dgrad": "dgrad_kernel",
             "direct_conv2d_dgrad_bf16": "dgrad_kernel_bf16",
             "direct_conv2d_wgrad": "wgrad_kernel",
             "direct_conv2d_wgrad_bf16": "wgrad_kernel_bf16"}
    gen = torch.Generator().manual_seed(args.seed + 260)
    model = alexnet_blocked(device=dev, generator=gen)
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 261)

    def stamp(part):
        print(f"[time] phase 26({part}) done at "
              f"{time.perf_counter() - t_start:.1f} s")

    # (name, spec, w, cib, dgrad): AlexNet's five layers, then the dilated
    # and strided shapes of phase 25
    cases, h = [], ALEXNET_ENTRY
    for i, conv in enumerate(model.convs):
        spec = conv.spec(BATCH, h, h)
        cases.append((f"alexnet.conv{i + 1}", spec, conv.w.detach(),
                      conv.in_pencil, i > 0))
        h = spec.ho
    for (name, n, ci, co, hh, f, s, pad, g, d, lane,
         _) in GROUPED_DILATED_SHAPES[2:]:
        lay = BlockedConvLayout.choose(ci, co, lane, groups=g)
        spec = ConvSpec.make(n, hh, hh, ci, co, f, f, s, pad, g, d)
        w = torch.randn((co // lay.cb_out, ci // g // lay.cb_in, f, f,
                         lay.cb_in, lay.cb_out), device=dev,
                        generator=dgen) / (f * f * ci // g) ** 0.5
        cases.append((name, spec, w, lay.cb_in, True))

    def operands(spec, w, cib):
        x = torch.randn((spec.n, spec.ci // cib, spec.hi, spec.wi, cib),
                        device=dev, generator=dgen)
        z = torch.randn((spec.n, w.shape[0], spec.ho, spec.wo, w.shape[5]),
                        device=dev, generator=dgen)
        return x, z, torch.randn(z.shape, device=dev, generator=dgen)

    # -- 26(a) each build against its plain version ---------------------------
    print(f"[grouped-bwd] card: {smi}")
    max_err = {k: 0.0 for k in key.values()}
    timing = []
    for name, spec, w, cib, dgrad in cases:
        x, z, g = operands(spec, w, cib)
        hw, s, pad = (spec.hi, spec.wi), spec.stride, spec.pads
        kw = dict(groups=spec.groups, dilation=spec.dilation)
        for bf16 in (False, True):
            prec = "bf16" if bf16 else "f32"
            dt = bf if bf16 else torch.float32
            xx, ww, zz, gg = (t.to(dt) for t in (x, w, z, g))
            tag = (f"{name} {prec} {spec.ci}->{spec.co} groups "
                   f"{spec.groups} dilation {spec.dilation[0]} s{s} in "
                   f"{spec.hi}x{spec.wi} n{spec.n}")
            if dgrad:
                k = key[(bf16, "dgrad")]

                def run_dgrad(ww=ww, zz=zz, gg=gg, prec=prec, hw=hw, s=s,
                              pad=pad, kw=kw):
                    return direct_conv2d_dgrad(gg, ww, hw, s, pad, zz,
                                               "relu", precision=prec, **kw)
                got, again = run_dgrad(), run_dgrad()
                want = direct_conv_dgrad_blocked(gg, ww, hw, s, pad, zz,
                                                 "relu", **kw)
                torch.cuda.synchronize()
                max_err[k] = max(max_err[k], bf16_close(
                    f"grouped dgrad {tag}", got, want) if bf16 else compare(
                    f"grouped dgrad {tag}", got, want, **TOL))
                if not torch.equal(got, again):
                    fail(f"grouped dgrad {tag}: two runs differ")
                if bf16:
                    dz, _ = cotangent_pass(gg, zz, "relu", False)
                    on_dz = direct_conv2d_dgrad(dz, ww, hw, s, pad,
                                                precision=prec,
                                                prologue_tiles=True, **kw)
                    if not torch.equal(on_dz, got):
                        fail(f"grouped dgrad {tag}: on the dz pass's dz it "
                             "differs from its own prologue")
                plan, model_plan = dgrad_plans(gg, ww, hw, s, pad, zz, "relu",
                                               dtype=dt, **kw)
                if plan != model_plan:
                    fail(f"grouped dgrad {tag}: the kernel's plan {plan} != "
                         f"the blocking model's {model_plan}")
                timing.append((name, spec, bf16, "dgrad", run_dgrad, plan,
                               (xx, ww, zz, gg)))
                del got, again, want
            k = key[(bf16, "wgrad")]

            def run_wgrad(xx=xx, zz=zz, gg=gg, prec=prec, spec=spec, s=s,
                          pad=pad, kw=kw):
                return wgrad_partials(xx, gg, spec.hf, spec.wf, s, pad, zz,
                                      "relu", True, precision=prec, **kw)
            first = run_wgrad()
            dw, db = split_wgrad(run_wgrad()[1], xx.shape, gg.shape, spec.hf,
                                 spec.wf, True, spec.groups)
            check_fold(f"grouped wgrad {tag}", first, (dw, db))
            dz = conv2d_common.cotangent_prologue(gg, zz, "relu")
            want_dw, want_db = direct_conv_wgrad_blocked(
                xx.double(), dz.double(), spec.hf, spec.wf, s, pad,
                with_db=True, **kw)
            abs_dw, abs_db = direct_conv_wgrad_blocked(
                xx.abs().double(), dz.abs().double(), spec.hf, spec.wf, s,
                pad, with_db=True, **kw)
            max_err[k] = max(
                max_err[k],
                compare_scaled(f"grouped wgrad dw {tag}", dw, want_dw,
                               abs_dw, WGRAD_REL),
                compare_scaled(f"grouped wgrad db {tag}", db, want_db,
                               abs_db, WGRAD_REL))
            plan, model_plan = wgrad_plans(xx, gg, spec.hf, spec.wf, s, pad,
                                           zz, "relu", dtype=dt, **kw)
            if plan != model_plan:
                fail(f"grouped wgrad {tag}: the kernel's plan {plan} != the "
                     f"blocking model's {model_plan}")
            if plan.function_macs != spec.flops() // 2:
                fail(f"grouped wgrad {tag}: the kernel counts "
                     f"{plan.function_macs} MACs, the grouped function "
                     f"{spec.flops() // 2}")
            timing.append((name, spec, bf16, "wgrad", run_wgrad, plan,
                           (xx, ww, zz, gg)))
            del first, dw, db, dz, want_dw, want_db, abs_dw, abs_db
    print(f"[grouped-bwd] wgrad worst err/bound: " + " ".join(
        f"{kind} {max(v for lab, v in RATIOS.items() if lab.startswith(f'grouped wgrad {kind} ')):.3f}"
        for kind in ("dw", "db")) + f" (tol 1, |err| <= {WGRAD_REL:g} * "
        "sum|x dz|; two runs bit for bit)")
    stamp("a")

    # -- 26(b) AlexNet trained in f32 and in bf16 -----------------------------
    n_train = ALEXNET_TRAIN_BATCH
    tr = lockstep_train(
        "alexnet-train", copy.deepcopy(model), n_train, args.seed + 262,
        {"direct_conv2d_fwd": 5, "direct_conv2d_dgrad": 4,
         "direct_conv2d_wgrad": 5}, dev, entry=ALEXNET_ENTRY)
    train_counts = dict(tr.counts)
    counts, trained, batches, _ = bf16_trainers(
        model, n_train, args.seed + 263,
        [("alexnet-bf16-train", ConvContext(precision="bf16"),
          {"direct_conv2d_fwd_bf16": 5, "direct_conv2d_dgrad_bf16": 4,
           "direct_conv2d_wgrad_bf16": 5, "direct_conv2d_dz_bf16": 5})],
        dev, entry=ALEXNET_ENTRY)
    for k, v in counts.items():
        train_counts[k] = train_counts.get(k, 0) + v
    stamp("b")

    # -- 26(c) times, MACs, bounds, the step ----------------------------------
    print(f"[grouped-bwd-time] {smi}")
    sums = {k: [0.0] * 4 for k in key.values()}
    kinds = {k: [] for k in key.values()}
    for name, spec, bf16, kind, fn, plan, (xx, ww, zz, gg) in timing:
        k = key[(bf16, kind)]
        prec = "bf16" if bf16 else "f32"
        s, (pt, pb_), (pl, pr) = spec.stride, *spec.pads
        dz = conv2d_common.cotangent_prologue(gg, zz, "relu")
        cl = torch.channels_last if bf16 else torch.contiguous_format
        xp = F.pad(nchw(xx), (pl, pr, pt, pb_)).contiguous(memory_format=cl)
        # a grouped weight [Co/Cob, Cig/Cib, ...] is the library's [Co, Cig,
        # Hf, Wf] as a dense one is
        w_oihw = oihw(ww, 1).contiguous(memory_format=cl)
        dz_nchw = nchw(dz).contiguous(memory_format=cl)
        mask = [kind == "dgrad", kind == "wgrad", False]

        def lib():
            return torch.ops.aten.convolution_backward(
                dz_nchw, xp, w_oihw, None, [s, s], [0, 0],
                list(spec.dilation), False, [0, 0], spec.groups, mask)
        if kind == "dgrad":
            def plain():
                return direct_conv_dgrad_blocked(gg, ww, (spec.hi, spec.wi),
                                                 s, spec.pads, zz, "relu",
                                                 spec.groups, spec.dilation)
            macs, split = dgrad_pairs(spec)
            nbytes = xx.element_size() * (2 * gg.numel() + ww.numel()
                                          + xx.numel())
            mac_text = (f"MACs {macs} (input positions x taps whose output "
                        f"lies in the map; the phases' taps {split}, "
                        f"{100 * (1 - macs / split):.1f} % of them read rows "
                        f"outside the map as zeros; 1/{spec.groups} of the "
                        f"dense count)")
            if plan.function_macs != split:
                fail(f"{name} {prec} dgrad: the kernel counts "
                     f"{plan.function_macs} phase MACs, not {split}")
        else:
            def plain():
                return direct_conv_wgrad_blocked(xx, gg, spec.hf, spec.wf, s,
                                                 spec.pads, zz, "relu", True,
                                                 spec.groups, spec.dilation)
            macs = spec.flops() // 2
            nbytes = (xx.element_size() * (xx.numel() + 2 * gg.numel())
                      + 4 * (ww.numel() + spec.co))
            mac_text = (f"MACs {macs} (the grouped function's, 1/"
                        f"{spec.groups} of the dense count)")
        k_ms, g_ms = time_ms(fn), graph_ms(fn)
        l_ms, l_graph = time_ms(lib), graph_ms(lib)
        p_ms = time_ms(plain, iters=2, warmup=1)
        if bf16:
            b_ms, b_by = bound(2 * macs, nbytes, PEAK_BF16_FLOPS)
            fma = ""
        else:
            b_ms, b_by, f_ms = tf32x3_bound(2 * macs, nbytes)
            fma = f" [f32 FMA {f_ms:.4f}]"
        slow = g_ms / l_graph
        unread = ""
        if spec.dilation[0] > 1:
            left = bwd_window_unread(kind, bf16, spec, xx.shape[4],
                                     ww.shape[5])
            unread = f", staged window cells no tap reads {100 * left:.1f} %"
        print(f"[grouped-bwd-time] {name} {prec} {kind} {spec.ci}->{spec.co}"
              f" groups {spec.groups} dilation {spec.dilation[0]} s{s} "
              f"{spec.hi}->{spec.ho} n{spec.n}: eager_ms {k_ms:.4f} "
              f"graph_ms {g_ms:.4f} plain_ms {p_ms:.4f} cuDNN ms "
              f"{l_ms:.4f} [{l_graph:.4f}] ({slow:.2f}x as graphs"
              f"{'; more than 2x cuDNN' if slow > 2 else ''}) bound_ms "
              f"{b_ms:.4f} ({b_by}{fma}) bound/graph {b_ms / g_ms:.3f}; "
              f"{mac_text}; issued {plan.issued_macs} ({plan.products} a "
              f"MAC; padding {100 * plan.padding_share:.1f} %), "
              f"{plan.tiles} tiles, shared memory {plan.smem} B{unread}")
        if name.startswith("alexnet.conv"):
            for j, v in enumerate((k_ms, p_ms, b_ms, l_ms)):
                sums[k][j] += v
            kinds[k].append((b_ms, b_by))
        del dz, xp, w_oihw, dz_nchw
    for k, (k_ms, p_ms, b_ms, l_ms) in sums.items():
        print(f"[grouped-bwd-time] AlexNet {fn_of[k]} summed over its "
              f"layers: {k_ms:.4f} ms eager, plain {p_ms:.4f}, cuDNN "
              f"{l_ms:.4f}, bound {b_ms:.4f}")
    del timing
    step_runs = [("f32", tr.step, tr.state), ("bf16", trained[0][0],
                                               trained[0][1])]
    times = timed_steps("alexnet-step", step_runs, batches)
    for tag, step, state in step_runs:
        reset_all_launches()
        split = device_split(lambda: step(state, batches[0]), None)
        if split is None:
            print(f"[alexnet-step] {tag}: the profiler recorded no device "
                  "time")
            continue
        wall, busy, rows = split
        print(f"[alexnet-step] {tag} n{n_train} {ALEXNET_ENTRY}x"
              f"{ALEXNET_ENTRY}: host-clock median "
              f"{np.median(times[tag]):.3f} ms; under torch.profiler "
              f"{wall:.3f} ms wall, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f} %); the port's launches in the "
              f"profile {port_rows(rows)} of "
              f"{sum(all_launches().values()) // 3} counted; largest "
              f"kernels: " + "; ".join(
                  f"{kernel_name(n_)} {ms:.3f} ms x{c}"
                  for n_, ms, c in rows[:8]))
    del tr, trained
    torch.cuda.empty_cache()
    entries = []
    for (bf16, kind), k in key.items():
        k_ms, p_ms, b_ms, l_ms = sums[k]
        entries.append({
            "name": f"{k} ({fn_of[k]}: grouped and dilated, AlexNet "
                    "trained)",
            "route": "cuda", "source": BWD_SOURCE,
            "replaces": (TPU_DGRAD + " (grouped map :481-494)"
                         if kind == "dgrad"
                         else TPU_WGRAD + " (grouped walk :606-613)"),
            "launches": train_counts.get(k, 0),
            "max_abs_err": max_err[k], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": mostly(kinds[k]),
            "library_ms": l_ms})
    print(f"[time] phase 26 done at {time.perf_counter() - t_start:.1f} s")
    return entries, train_counts

# Phase 27's shapes beside AlexNet's conv1-3: (name, n, ci, co, h, filter,
# stride, pads, cib, cob, forward too): VGG-16's conv1_1 and MobileNet's
# conv1 (Cib 3), Cib 3 at 7x7 stride 2 pads 3, Cib 8 at 5x5 (40-value runs),
# odd widths at stride 2 with Cib 64 and 48 (element-strided boxes)
NARROW_SHAPES = [
    ("vgg16.conv1_1", 8, 3, 64, 224, 3, 1, "SAME", 3, 64, True),
    ("mobilenet.conv1", 8, 3, 32, 224, 3, 2, "SAME", 3, 32, True),
    ("cib3.7x7s2", 8, 3, 64, 112, 7, 2, ((3, 3), (3, 3)), 3, 64, True),
    ("cib8.5x5", 8, 8, 64, 56, 5, 1, "SAME", 8, 64, True),
    ("odd31.cib64", 8, 64, 64, 31, 3, 2, "SAME", 64, 64, False),
    ("odd31.cib48", 8, 48, 64, 31, 3, 2, "SAME", 48, 64, False),
]
NARROW_TRAIN_BATCH = 32


def narrow_rows_phases(args, dev, t_start, smi, vgg, mobilenet):
    """Phase 27: the bf16 window forward and wgrad redesigned where AlexNet
    loses: the narrow rows (``csrc/narrow_rows.cuh``: a filter row's (dw,
    c) run a 128-byte operand row, ``fwd_kernel_bf16_narrow`` and
    ``wgrad_kernel_bf16_narrow``) and the wgrad's x by element-strided TMA
    boxes at any width.  (a) AlexNet's conv1 (forward, its GAP folded, and
    wgrad), conv2 and conv3 (wgrad), and ``NARROW_SHAPES`` at batch 8,
    each against its plain version under BF16 by phase 23's rules (the
    forward within a bf16 ulp + 1e-5 of max; dw and db against f64 sums
    within ``WGRAD_REL`` of sum|x dz|, the folded sums bit for bit), two
    runs bit for bit; (b) each plan (the C entries') equal to the blocking
    model's, with the issued tensor-core MACs beside the function's; (c)
    per layer eager and graph ms beside cuDNN bf16 (channels-last; the
    wgrad without db), the bound and its share; then AlexNet's, VGG-16's
    and MobileNet's bf16 train steps (3 AdamW steps at batch 32) under
    ``torch.profiler`` (device busy) and on the host clock, the f32 AlexNet
    step's beside, each step launching kernels alone, the narrow rows at
    the first conv.  -> (kernels-line entries, the steps' launches)."""
    from repro_torch.configs.cnn import alexnet_blocked
    from repro_torch.core import blocking as B
    from repro_torch.core import conv2d_common
    from repro_torch.core.context import ConvContext
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels import direct_conv2d as dck
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainstep import make_train_step
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(args.seed + 270)
    alexnet = alexnet_blocked(device=dev, generator=gen)
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 271)
    print(f"[narrow] card: {smi}")

    # (name, spec, cib, cob, w, forward too)
    cases, h = [], ALEXNET_ENTRY
    for i, conv in enumerate(alexnet.convs[:3]):
        spec = conv.spec(BATCH, h, h)
        cases.append((f"alexnet.conv{i + 1}", spec, conv.in_pencil,
                      conv.w.shape[5], conv.w.detach(), i == 0))
        h = spec.ho
    for (name, n, ci, co, hh, f, st, pad, cib, cob,
         fwd) in NARROW_SHAPES:
        spec = ConvSpec.make(n, hh, hh, ci, co, f, f, st, pad)
        w = torch.randn((co // cob, ci // cib, f, f, cib, cob), device=dev,
                        generator=dgen) / (f * f * ci) ** 0.5
        cases.append((name, spec, cib, cob, w, fwd))

    # -- 27(a-b) kernels against plain versions; plans ----------------------
    err = {"fwd": 0.0, "wgrad": 0.0}
    timing = []
    for name, spec, cib, cob, w, fwd in cases:
        s, pad, g = spec.stride, spec.pads, spec.groups
        x = torch.randn((spec.n, spec.ci // cib, spec.hi, spec.wi, cib),
                        device=dev, generator=dgen).to(bf)
        z = torch.randn((spec.n, spec.co // cob, spec.ho, spec.wo, cob),
                        device=dev, generator=dgen).to(bf)
        gg = torch.randn(z.shape, device=dev, generator=dgen).to(bf)
        b = 0.1 * torch.randn((spec.co // cob, cob), device=dev,
                              generator=dgen)
        tag = (f"{name} bf16 {spec.ci}->{spec.co} {spec.hf}x{spec.wf} s{s} "
               f"groups {g} in {spec.hi}x{spec.wi} n{spec.n}")
        # where the rows fit but the chooser keeps the per-tap tiles, each
        # kernel also runs the narrow rows asked for
        asked = {k: B.narrow_fits(spec.hf, spec.wf, cib, spec.dilation)
                 and not B.narrow_chosen(spec.hf, spec.wf, cib, spec.dilation,
                                         widths=widths)
                 for k, widths in (("fwd", B.NARROW_FWD_CIBS),
                                   ("wgrad", B.NARROW_WGRAD_CIBS))}
        if fwd:
            with torch.no_grad():
                dck.reset_launches()
                got = dck.direct_conv2d_blocked(x, w, b, s, pad, "relu",
                                                precision="bf16", groups=g)
                again = dck.direct_conv2d_blocked(x, w, b, s, pad, "relu",
                                                  precision="bf16", groups=g)
                torch.cuda.synchronize()
                narrow = dck.NARROW_LAUNCHES["fwd_kernel_bf16_narrow"]
                want = direct_conv_blocked(x, w, s, pad, b, "relu", "bf16", g)
                err["fwd"] = max(err["fwd"], bf16_close(f"narrow fwd {tag}",
                                                        got, want))
                if not torch.equal(got, again):
                    fail(f"narrow fwd {tag}: two runs differ")
                plan, model = dck.fwd_plans(x, w, s, pad, dtype=bf, groups=g)
                if plan != model:
                    fail(f"narrow fwd {tag}: the kernel's plan {plan} != the "
                         f"blocking model's {model}")
                if name == "alexnet.conv1":
                    if narrow != 2:
                        fail(f"narrow fwd {tag}: {narrow} of 2 launches on "
                             "the narrow rows")
                    launch = dck.gap_forward(x, w, b, s, pad, "relu",
                                             precision="bf16")
                    other, _ = dck.gap_forward(x, w, b, s, pad, "relu",
                                               precision="bf16")
                    check_gap(f"narrow fwd {tag} GAP", launch,
                              spec.ho * spec.wo, other)
                print(f"[narrow] fwd {tag}: narrow rows {narrow > 0}, MACs "
                      f"{plan.function_macs}, issued {plan.issued_macs} "
                      f"({plan.issued_macs / plan.function_macs:.2f}x), "
                      f"shared memory {plan.smem} B")
                if asked["fwd"]:
                    # the narrow rows asked for, by their least-cost tile
                    blk = min(B.fwd_candidates(
                        spec.n, spec.ho, spec.wo, spec.hf, spec.wf, s,
                        spec.cig // cib, cib, spec.co // cob, cob,
                        B.H100_SXM, False, False, op_bytes=2, narrow=True),
                        key=lambda kb: kb[0])[1]
                    lp = dck.fwd_launch(spec, cib, cob, 1, False, False,
                                        blk=blk, dtype=bf)
                    runs = [dck.fwd_run(dck._lib().direct_conv2d_fwd, lp, x,
                                        w, b, None, spec) for _ in range(2)]
                    torch.cuda.synchronize()
                    if any(r[0] for r in runs):
                        fail(f"narrow fwd {tag} (asked): CUDA error "
                             f"{[r[0] for r in runs]}")
                    err["fwd"] = max(err["fwd"], bf16_close(
                        f"narrow fwd {tag} (asked: {blk})", runs[0][1], want))
                    if not torch.equal(runs[0][1], runs[1][1]):
                        fail(f"narrow fwd {tag} (asked): two runs differ")

                def run_fwd(x=x, w=w, b=b, s=s, pad=pad, g=g):
                    return dck.direct_conv2d_blocked(x, w, b, s, pad, "relu",
                                                     precision="bf16",
                                                     groups=g)
                timing.append((name, spec, "fwd", run_fwd, plan,
                               (x, w, b, gg)))

        def run_wgrad(x=x, z=z, gg=gg, spec=spec, s=s, pad=pad, g=g):
            return dck.wgrad_partials(x, gg, spec.hf, spec.wf, s, pad, z,
                                      "relu", True, precision="bf16",
                                      groups=g)
        dck.reset_launches()
        first = run_wgrad()
        dw, db = dck.split_wgrad(run_wgrad()[1], x.shape, gg.shape, spec.hf,
                                 spec.wf, True, g)
        narrow = dck.NARROW_LAUNCHES["wgrad_kernel_bf16_narrow"]
        check_fold(f"narrow wgrad {tag}", first, (dw, db))
        dz = conv2d_common.cotangent_prologue(gg, z, "relu")
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), dz.double(), spec.hf, spec.wf, s, pad, with_db=True,
            groups=g)
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), spec.hf, spec.wf, s, pad,
            with_db=True, groups=g)
        err["wgrad"] = max(
            err["wgrad"],
            compare_scaled(f"narrow wgrad dw {tag}", dw, want_dw, abs_dw,
                           WGRAD_REL),
            compare_scaled(f"narrow wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL))
        if not torch.equal(first[1], torch.cat([dw.reshape(-1),
                                                db.reshape(-1)])):
            fail(f"narrow wgrad {tag}: two runs differ")
        plan, model = dck.wgrad_plans(x, gg, spec.hf, spec.wf, s, pad, z,
                                      "relu", dtype=bf, groups=g)
        if plan != model:
            fail(f"narrow wgrad {tag}: the kernel's plan {plan} != the "
                 f"blocking model's {model}")
        if name == "alexnet.conv1" and narrow != 2:
            fail(f"narrow wgrad {tag}: {narrow} of 2 launches on the narrow "
                 "rows")
        if asked["wgrad"]:
            blk = min(B.wgrad_candidates(
                spec.n, spec.ho, spec.wo, spec.hf, spec.wf, s,
                spec.ci // cib, cib, spec.co // cob, cob, B.H100_SXM, True,
                False, op_bytes=2, groups=g, narrow=True),
                key=lambda kb: kb[0])[1]
            lib = dck._bwd_lib()
            outs = [dck.bf16_wgrad(
                lib.direct_conv2d_wgrad_bf16, blk, x, gg, spec, z, "relu",
                True, B.H100_SXM, {"direct_conv2d_wgrad_bf16": 0},
                "direct_conv2d_wgrad_bf16", lib)[1] for _ in range(2)]
            adw, adb = dck.split_wgrad(outs[0], x.shape, gg.shape, spec.hf,
                                       spec.wf, True, g)
            err["wgrad"] = max(
                err["wgrad"],
                compare_scaled(f"narrow wgrad dw {tag} (asked: {blk})", adw,
                               want_dw, abs_dw, WGRAD_REL),
                compare_scaled(f"narrow wgrad db {tag} (asked)", adb,
                               want_db, abs_db, WGRAD_REL))
            if not torch.equal(outs[0], outs[1]):
                fail(f"narrow wgrad {tag} (asked): two runs differ")
            del outs, adw, adb
        print(f"[narrow] wgrad {tag}: narrow rows {narrow > 0}, MACs "
              f"{plan.function_macs}, issued {plan.issued_macs} "
              f"({plan.issued_macs / plan.function_macs:.2f}x), shared "
              f"memory {plan.smem} B")
        timing.append((name, spec, "wgrad", run_wgrad, plan, (x, w, b, gg)))
        del first, dw, db, dz, want_dw, want_db, abs_dw, abs_db
    print(f"[time] phase 27(a-b) done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # -- 27(c) times per layer ----------------------------------------------
    print(f"[narrow-time] {smi}")
    sums = {("fwd", True): [0.0] * 4, ("wgrad", True): [0.0] * 4}
    kinds = {k: [] for k in sums}
    cl = torch.channels_last
    for name, spec, kind, fn, plan, (x, w, b, gg) in timing:
        s, (pt, pb_), (pl, pr) = spec.stride, *spec.pads
        xp = F.pad(nchw(x), (pl, pr, pt, pb_)).contiguous(memory_format=cl)
        w_oihw = oihw(w.to(bf), 1).contiguous(memory_format=cl)
        if kind == "fwd":
            def lib():
                return F.conv2d(xp, w_oihw, None, s, 0, 1, spec.groups)

            def plain():
                return direct_conv_blocked(x, w, s, spec.pads, b, "relu",
                                           "bf16", spec.groups)
            nbytes = 2 * (x.numel() + w.numel()) + 2 * spec.n * spec.co \
                * spec.ho * spec.wo
        else:
            g_nchw = nchw(gg).contiguous(memory_format=cl)

            def lib():
                return torch.ops.aten.convolution_backward(
                    g_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                    [0, 0], spec.groups, [False, True, False])

            def plain():
                return direct_conv_wgrad_blocked(x, gg, spec.hf, spec.wf, s,
                                                 spec.pads, with_db=True,
                                                 groups=spec.groups)
            nbytes = 2 * (x.numel() + gg.numel()) + 4 * (w.numel() + spec.co)
        k_ms, g_ms = time_ms(fn), graph_ms(fn)
        l_ms, l_graph = time_ms(lib), graph_ms(lib)
        p_ms = time_ms(plain, iters=2, warmup=1)
        macs = plan.function_macs
        b_ms, b_by = bound(2 * macs, nbytes, PEAK_BF16_FLOPS)
        print(f"[narrow-time] {name} bf16 {kind} {spec.ci}->{spec.co} "
              f"{spec.hf}x{spec.wf} s{s} {spec.hi}->{spec.ho} n{spec.n}: "
              f"eager_ms {k_ms:.4f} graph_ms {g_ms:.4f} plain_ms {p_ms:.4f} "
              f"cuDNN bf16 ms {l_ms:.4f} [{l_graph:.4f}] "
              f"({g_ms / l_graph:.2f}x as graphs) bound_ms {b_ms:.4f} "
              f"({b_by}) bound/graph {b_ms / g_ms:.3f}; MACs {macs}, issued "
              f"{plan.issued_macs} ({plan.issued_macs / macs:.2f}x)")
        key = (kind, True)
        if B.narrow_chosen(spec.hf, spec.wf, x.shape[4], spec.dilation,
                           widths=B.NARROW_FWD_CIBS if kind == "fwd"
                           else B.NARROW_WGRAD_CIBS):
            for j, v in enumerate((k_ms, p_ms, b_ms, l_ms)):
                sums[key][j] += v
            kinds[key].append((b_ms, b_by))
        del xp, w_oihw
    del timing
    torch.cuda.empty_cache()
    print(f"[time] phase 27(c) layers done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # -- 27(c) the three nets' bf16 train steps ------------------------------
    n_train = NARROW_TRAIN_BATCH
    rng = np.random.default_rng(args.seed + 272)
    lr = cosine_schedule(TRAIN_LR, 1, 3)
    counts = {}
    narrow_counts = dict.fromkeys(dck.NARROW_LAUNCHES, 0)
    for tag, model, entry, prec in (
            ("alexnet", alexnet, ALEXNET_ENTRY, "bf16"),
            ("alexnet", alexnet, ALEXNET_ENTRY, "f32"),
            ("vgg16", vgg, ENTRY, "bf16"),
            ("mobilenet", mobilenet, ENTRY, "bf16")):
        batches = [
            {"images": torch.from_numpy(rng.standard_normal(
                (n_train, entry, entry, 3), dtype=np.float32)).to(dev),
             "targets": torch.from_numpy(rng.integers(0, 1000,
                                                      n_train)).to(dev)}
            for _ in range(3)]
        km = copy.deepcopy(model)
        opt = AdamW(lr=lr)
        state = opt.init(dict(km.named_parameters()))
        step = make_train_step(km, opt, context=ConvContext(precision=prec))
        reset_all_launches()
        losses = []
        for bt in batches:
            loss, _ = step(state, bt)
            torch.cuda.synchronize()
            losses.append(loss.item())
        launched = {k: v for k, v in all_launches().items() if v}
        narrow = dict(dck.NARROW_LAUNCHES)
        if not all(np.isfinite(losses)):
            fail(f"{tag} {prec} step: non-finite losses {losses}")
        if prec == "bf16":
            if any(not k.endswith("_bf16") for k in launched):
                fail(f"{tag} bf16 steps launched {launched}")
            if min(narrow.values()) < 3:
                fail(f"{tag} bf16 steps: the first conv's narrow-row "
                     f"kernels launched {narrow}, not each of 3 steps")
            for k, v in narrow.items():
                narrow_counts[k] += v
            for k, v in launched.items():
                counts[k] = counts.get(k, 0) + v
        times = timed_steps(f"narrow-step {tag} {prec}",
                            [(prec, step, state)], batches)
        reset_all_launches()
        split = device_split(lambda: step(state, batches[0]), None)
        if split is None:
            print(f"[narrow-step] {tag} {prec}: the profiler recorded no "
                  "device time")
        else:
            wall, busy, rows = split
            print(f"[narrow-step] {tag} {prec} n{n_train} {entry}x{entry}: "
                  f"losses {[round(v, 4) for v in losses]}; launches of 3 "
                  f"steps {launched}, on the narrow rows {narrow}; "
                  f"host-clock median {np.median(times[prec]):.3f} ms; under "
                  f"torch.profiler {wall:.3f} ms wall, device busy "
                  f"{busy:.3f} ms ({100 * busy / wall:.1f} %); the port's "
                  f"launches in the profile {port_rows(rows)} of "
                  f"{sum(all_launches().values()) // 3} counted; largest "
                  f"kernels: " + "; ".join(
                      f"{kernel_name(n_)} {ms:.3f} ms x{c}"
                      for n_, ms, c in rows[:8]))
        del km, state, step, batches
        torch.cuda.empty_cache()
    entries = []
    for kind, key, fn, tpu, where in (
            ("fwd", "direct_conv2d_fwd_bf16", "fwd_kernel_bf16_narrow",
             TPU_KERNEL, "the Cib 3 first layers and Cib 8 5x5"),
            ("wgrad", "direct_conv2d_wgrad_bf16", "wgrad_kernel_bf16_narrow",
             TPU_WGRAD, "the Cib 3 first layers")):
        k_ms, p_ms, b_ms, l_ms = sums[(kind, True)]
        entries.append({
            "name": f"{key} ({fn}: the narrow rows, {where})",
            "route": "cuda",
            "source": KERNEL_SOURCE if kind == "fwd" else BWD_SOURCE,
            "replaces": tpu, "launches": narrow_counts[fn],
            "max_abs_err": err[kind], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": mostly(kinds[(kind, True)]),
            "library_ms": l_ms})
    print(f"[time] phase 27 done at {time.perf_counter() - t_start:.1f} s")
    return entries, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.cnn import vgg16_blocked, vgg16_layers
    from repro_torch.core import conv2d_common
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.blocking import (choose_dgrad_blocking,
                                           choose_wgrad_blocking)
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels._build import build
    from repro_torch.kernels.direct_conv2d import (LAUNCHES,
                                                   direct_conv2d_blocked,
                                                   direct_conv2d_dgrad,
                                                   direct_conv2d_wgrad,
                                                   gap_forward,
                                                   reset_launches,
                                                   wgrad_partials)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, SOURCES))
    for res in built:
        print(f"[build] {res.name}: {res.seconds:.1f} s -> {res.path.name}")
        for line in res.log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "wgmma" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] total {time.perf_counter() - t0:.1f} s")
    flash_lib = next(r.path for r in built if r.name == "flash_attention")
    hgmma = hgmma_counts(flash_lib)
    if hgmma is None:
        print("[build] no cuobjdump in this toolkit: the HGMMA count of the "
              "flash-attention SASS is not taken")
    else:
        for fn, (n, *_) in hgmma.items():
            print(f"[build] HGMMA instructions {n:4d} in {fn}")
        for kernel in (FLASH_BF16_KERNEL, FLASH_F32_KERNEL):
            wgmma = {fn: n for fn, (n, *_) in hgmma.items() if kernel in fn}
            if not wgmma or not all(wgmma.values()):
                fail(f"the flash kernel {kernel}'s SASS holds no HGMMA: "
                     f"{wgmma}")
    # the f32 flash kernel on the tensor cores and the depthwise wgrad:
    # registers and no spill in every compiled instance
    for name, kernel in (("flash_attention", FLASH_F32_KERNEL),
                         ("conv2d_depthwise", DW_WGRAD_KERNEL),
                         ("conv2d_depthwise", "depthwise_fwd_kernel_bf16"),
                         ("conv2d_depthwise", "depthwise_dgrad_kernel_bf16"),
                         ("direct_conv2d_bwd", "dz_kernel_bf16")):
        res = next(r for r in built if r.name == name)
        ptx = {fn: v for fn, v in ptxas_report(res.log).items()
               if kernel in fn}
        if not ptx:
            fail(f"{name}: no {kernel} instance in the ptxas report")
        for fn, (regs, st, ld) in sorted(ptx.items()):
            print(f"[build] {name} {fn}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B")
            if st or ld:
                fail(f"{fn} spills ({st} B stores, {ld} B loads)")
    # the phase-split dgrads and the wgrads: tensor-core instructions and no
    # spills in every compiled instance (the main paths take lanes 64 and
    # 128)
    tiles_of = (DGRAD_KERNELS, WGRAD_KERNELS, PW_TILE_KERNELS,
                FWD_TILE_KERNELS)
    sass = {res.name: hgmma_counts(res.path) for res in built
            if any(res.name in tiles for tiles in tiles_of)}
    for res, kernel in [(res, tiles[res.name]) for res in built
                        for tiles in tiles_of if res.name in tiles]:
        # the wgrads, the pointwise tile and the forward tiles must hold
        # HGMMA (wgmma)
        wgrad = kernel not in DGRAD_KERNELS.values()
        ptx = {fn: v for fn, v in ptxas_report(res.log).items()
               if kernel in fn and (wgrad or "wgrad" not in fn)}
        tc = sass[res.name]
        for fn, (regs, st, ld) in sorted(ptx.items()):
            n_hg, n_hm, n_dep = (0, 0, 0) if tc is None else tc.get(
                fn, (0, 0, 0))
            n_tc = ("not taken" if tc is None else
                    f"HGMMA {n_hg} HMMA {n_hm} WARPGROUP.DEPBAR {n_dep}")
            print(f"[build] {res.name} {fn}: tensor-core instructions "
                  f"{n_tc}, {regs} registers, spill stores {st} B, spill "
                  f"loads {ld} B")
            if st or ld:
                fail(f"{fn} spills ({st} B stores, {ld} B loads)")
            if tc is not None and not (n_hg or n_hm):
                fail(f"{fn}'s SASS holds no tensor-core instruction")
            if tc is not None and wgrad and not n_hg:
                fail(f"{fn}'s SASS holds no HGMMA (wgmma)")
            # the bf16 dgrads and forwards issue a filter row's wgmmas back
            # to back: fewer waits for them than wgmmas
            if tc is not None and (BF16_DGRAD_KERNEL in fn
                                   or BF16_FWD_KERNEL in fn
                                   or BF16_PW_KERNEL in fn) and (
                    not n_hg or n_dep >= n_hg):
                fail(f"{fn} waits for its wgmmas {n_dep} times for "
                     f"{n_hg} HGMMA")
        if not ptx:
            fail(f"{res.name}: no {kernel} instance in the ptxas report")
    print(f"[time] phase 2 done at {time.perf_counter() - t_start:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def operands(n, ci, co, h, stride, residual=False):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")
        r = (torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                         generator=gen) if residual else None)
        return x, w, b, r, spec

    # -- 3. kernels vs plain versions --------------------------------------
    def layer_shapes(entry):
        out, h = [], entry
        for ci, co, s in vgg16_layers():
            out.append((ci, co, s, h))
            h = ConvSpec.make(1, h, h, ci, co, 3, 3, s, "SAME").ho
        return out

    layers = layer_shapes(ENTRY)
    shapes = sorted(set(layers), key=layers.index)
    # every shape the server's buckets give the kernel, with its own tiles
    served_layers = [sh for bh, _ in BUCKETS for sh in layer_shapes(bh)]
    checked = sorted(set(served_layers), key=served_layers.index)
    max_err = {"direct_conv2d_fwd": 0.0}
    with torch.no_grad():
        for ci, co, s, h in checked:
            x, w, b, _, _ = operands(BATCH, ci, co, h, s)
            got = direct_conv2d_blocked(x, w, b, s, "SAME", "relu")
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu")
            torch.cuda.synchronize()
            max_err["direct_conv2d_fwd"] = max(
                max_err["direct_conv2d_fwd"],
                compare(f"conv {ci}->{co} {h}x{h} s{s} n{BATCH} relu", got,
                        want, **TOL))
        for n, ci, co, h, s, gap in ((2, 3, 64, 20, 2, False),
                                     (2, 64, 128, 28, 1, True)):
            x, w, b, r, _ = operands(n, ci, co, h, s, residual=True)
            got = direct_conv2d_blocked(x, w, b, s, "SAME", "gelu",
                                        residual=r, gap=gap)
            want = direct_conv_blocked(x, w, s, "SAME", b, "gelu",
                                       residual=r, gap=gap)
            torch.cuda.synchronize()
            max_err["direct_conv2d_fwd"] = max(
                max_err["direct_conv2d_fwd"],
                compare(f"conv {ci}->{co} {h}x{h} s{s} n{n} gelu+residual"
                        f"{'+gap' if gap else ''}", got, want, **TOL))
        # the last VGG-16 conv with the GAP folded in, both routes: the
        # pooled features bit for bit the in-order finalize of the per-tile
        # sums the same launch wrote
        ci, co, s, h = layers[-1]
        x, w, b, _, _ = operands(BATCH, ci, co, h, s)
        want = direct_conv_blocked(x, w, s, "SAME", b, "relu", gap=True)
        for streamed in (False, True):
            pooled, parts = gap_forward(x, w, b, s, "SAME", "relu",
                                        streamed=streamed)
            hw = ConvSpec.make(BATCH, h, h, ci, co, 3, 3, s, "SAME").ho ** 2
            fold = conv2d_common.gap_finalize(parts, hw)
            torch.cuda.synchronize()
            route = "streamed" if streamed else "window"
            if not torch.equal(pooled, fold):
                fail(f"{route} forward's folded GAP differs from the "
                     f"finalize of its partials {list(parts.shape)}")
            print(f"[check] {route} forward's folded GAP {list(parts.shape)}"
                  ": identical bits to conv2d_common.gap_finalize of its "
                  "partials")
            max_err["direct_conv2d_fwd"] = max(
                max_err["direct_conv2d_fwd"],
                compare(f"conv {ci}->{co} {h}x{h} s{s} n{BATCH} relu+gap "
                        f"({route})", pooled, want, **TOL))

    # -- 4. full VGG-16 forward --------------------------------------------
    cpu_gen = torch.Generator().manual_seed(args.seed)
    model = vgg16_blocked(1000, device=dev, generator=cpu_gen)
    images = torch.randn((BATCH, ENTRY, ENTRY, 3), generator=cpu_gen).to(dev)

    with torch.no_grad():
        reset_launches()
        logits = model(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
        print(f"[vgg16] forward n{BATCH} {ENTRY}x{ENTRY}: launches {counts}")
        if counts != {"direct_conv2d_fwd": 13}:
            fail(f"expected 13 conv launches (the GAP in the last), got "
                 f"{counts}")
        ref = plain_cnn_forward(images, model)
        scale = ref.abs().max().item()
        compare("vgg16 logits vs plain path", logits, ref,
                atol=LOGIT_RTOL * scale, rtol=0.0)
        fwd_ms = time_ms(lambda: model(images), iters=5)
        fwd_plain_ms = time_ms(lambda: plain_cnn_forward(images, model),
                               iters=5)
    print(f"[vgg16] forward ms: kernels {fwd_ms:.3f} plain {fwd_plain_ms:.3f}")

    # -- 5. the main path: ConvServer --------------------------------------
    server = ConvServer(model, list(BUCKETS), BATCH, device=dev)
    server.warmup()
    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(24):
        hh, ww = (int(v) for v in rng.integers(96, ENTRY + 1, size=2))
        reqs.append(ConvRequest(rid, rng.standard_normal(
            (hh, ww, 3), dtype=np.float32)))
    reset_launches()
    for r in reqs:
        server.submit(r)
    server.run()
    torch.cuda.synchronize()
    served = dict(LAUNCHES)
    if any(served[k] for k in ("direct_conv2d_dgrad", "direct_conv2d_wgrad")):
        fail(f"the server launched backward kernels: {served}")
    health = server.health()
    print(f"[serve] launches {served} health {json.dumps(health)}")
    bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
    if bad:
        fail(f"requests not OK: {bad}")
    n_fwd = health["batches"]
    if n_fwd == 0 or served["direct_conv2d_fwd"] != 13 * n_fwd:
        fail(f"server forwards did not all run the kernels: {served}")
    with torch.no_grad():
        err = 0.0
        for r in reqs:
            img = torch.from_numpy(server.bucketer.pad(r.image, r.bucket))
            want = plain_cnn_forward(img[None].to(dev), model)[0].cpu().numpy()
            err = max(err, float(np.abs(r.logits - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    print(f"[serve] logits vs plain PyTorch forward of the padded image: "
          f"max rel-to-max err {err:.3e} (tol {LOGIT_RTOL:g})")
    if not err <= LOGIT_RTOL:
        fail("served logits differ from the plain forward")
    lat = server.latencies() * 1e3
    print(f"[serve] {len(reqs)} requests OK, {health['steps']} steps, "
          f"latency p50 {np.percentile(lat, 50):.3f} ms p99 "
          f"{np.percentile(lat, 99):.3f} ms, occupancy "
          f"{server.occupancy():.3f}")

    print(f"[time] phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # -- 6. per-layer times ------------------------------------------------
    rows, timed = [], {}
    with torch.no_grad():
        for ci, co, s, h in shapes:
            x, w, b, _, spec = operands(BATCH, ci, co, h, s)
            (pt, pb), (pl, pr) = spec.pads
            x_nchw = (x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h)
                      .contiguous())
            xp = F.pad(x_nchw, (pl, pr, pt, pb))
            w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                      .contiguous())
            b_flat = b.reshape(co)
            def fwd():
                return direct_conv2d_blocked(x, w, b, s, "SAME", "relu")
            k_ms = time_ms(fwd)
            p_ms = time_ms(lambda: direct_conv_blocked(
                x, w, s, "SAME", b, "relu"))
            l_ms = time_ms(lambda: F.conv2d(xp, w_oihw, b_flat, stride=s))
            nbytes = 4 * (x.numel() + w.numel() + b.numel()
                          + BATCH * co * spec.ho * spec.wo)
            b_ms, b_by, f32_ms = tf32x3_bound(spec.flops(), nbytes)
            timed[(ci, co, s, h)] = (k_ms, p_ms, l_ms, b_ms, b_by,
                                     graph_ms(fwd), f32_ms,
                                     fwd_work(x, w, h, s, False))
        fw_sum = {"graph": 0.0, "f32": 0.0, "macs": 0, "issued": 0}
        for name, key in zip(LAYER_NAMES, layers):
            k_ms, p_ms, l_ms, b_ms, b_by, g_ms, f32_ms, work = timed[key]
            ci, co, s, h = key
            rows.append((k_ms, p_ms, l_ms, b_ms, b_by))
            fblk, plan, macs = work
            fw_sum["graph"] += g_ms
            fw_sum["f32"] += f32_ms
            fw_sum["macs"] += macs
            fw_sum["issued"] += plan.issued_macs
            print(f"[layer] {name} {ci}->{co} in {h}x{h} s{s} n{BATCH}: "
                  f"kernel_ms {k_ms:.4f} graph_ms {g_ms:.4f} plain_ms "
                  f"{p_ms:.4f} library_ms {l_ms:.4f} launches/forward 1 "
                  f"bound_ms {b_ms:.4f} ({b_by}, 3xTF32), f32 FMA bound_ms "
                  f"{f32_ms:.4f}, bound/kernel {b_ms / k_ms:.3f}")
            print(f"[layer] {name} fwd tiles: "
                  f"{fwd_text(fblk, plan, macs, g_ms)}")
    tot = [sum(r[i] for r in rows) for i in range(4)]
    conv_by = mostly([(r[3], r[4]) for r in rows])
    print(f"[layer] all 13 convs: kernel_ms {tot[0]:.4f} graph_ms "
          f"{fw_sum['graph']:.4f} plain_ms {tot[1]:.4f} library_ms "
          f"{tot[2]:.4f} bound_ms {tot[3]:.4f} ({conv_by}, 3xTF32), f32 FMA "
          f"bound_ms {fw_sum['f32']:.4f}; function MACs {fw_sum['macs']}, "
          f"tensor-core MACs issued {fw_sum['issued']} (padding "
          f"{100 * (1 - 3 * fw_sum['macs'] / fw_sum['issued']):.1f} %)")

    # -- 7. backward kernels vs plain versions -----------------------------
    bwd_err = {"direct_conv2d_dgrad": 0.0, "direct_conv2d_wgrad": 0.0}
    bwd_ops = {}      # per distinct shape: the operands phase 9 times
    for ci, co, s, h in shapes:
        x, w, b, _, spec = operands(BATCH, ci, co, h, s)
        with torch.no_grad():     # the kernels take contiguous operands
            z = direct_conv_blocked(x, w, s, "SAME", b).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        bwd_ops[(ci, co, s, h)] = (x, w, z, g, spec)
        tag = f"{ci}->{co} {h}x{h} s{s} n{BATCH} relu"
        if ci != 3:        # conv1_1's dx is never needed: no dgrad there
            cib, cob = min(ci, 128), min(co, 128)
            dblk = choose_dgrad_blocking(BATCH, h, h, 3, 3, s, ci // cib,
                                         cib, cob, prologue=True)
            print(f"[bwd] dgrad {tag}: tile {dblk.th}x{dblk.tw} phase "
                  f"positions, {dblk.wgs} consumer warpgroup(s), lanes "
                  f"{dblk.lanes}, chunk {dblk.chunk}, window "
                  f"{dblk.hwin}x{dblk.wwin}")
            got = direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z, "relu")
            want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z,
                                             "relu")
            torch.cuda.synchronize()
            bwd_err["direct_conv2d_dgrad"] = max(
                bwd_err["direct_conv2d_dgrad"],
                compare(f"dgrad {tag}", got, want, **TOL))
            del got, want
        cib, cob = min(ci, 128), min(co, 128)
        wblk = choose_wgrad_blocking(BATCH, spec.ho, spec.wo, 3, 3, s,
                                     ci // cib, cib, co // cob, cob,
                                     prologue=True)
        print(f"[bwd] wgrad {tag}: {tiles_text(wblk)}")
        dw, db = direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                     with_db=True)
        dw2, db2 = direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                       with_db=True)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"wgrad {tag}: two runs differ")
        check_fold(f"wgrad {tag}", wgrad_partials(
            x, g, 3, 3, s, "SAME", z, "relu", with_db=True), (dw, db))
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), g.double(), 3, 3, s, "SAME", z.double(), "relu",
            with_db=True)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), 3, 3, s, "SAME",
            with_db=True)
        bwd_err["direct_conv2d_wgrad"] = max(
            bwd_err["direct_conv2d_wgrad"],
            compare_scaled(f"wgrad dw {tag} (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL))
        del dw, db, dw2, db2, want_dw, want_db, abs_dw, abs_db, dz
    worst = {k: max(v for lab, v in RATIOS.items()
                    if lab.startswith(f"wgrad {k} ")) for k in ("dw", "db")}
    print(f"[bwd] wgrad worst err/bound over {len(shapes)} shapes: dw "
          f"{worst['dw']:.3f} db {worst['db']:.3f} (tol 1; 3xTF32 tensor "
          "cores, two runs bit for bit)")

    # the autograd path on a small gelu + residual conv, stride 2, Cib = 3,
    # against torch autograd through the plain forward
    x, w, b, r, _ = operands(2, 3, 64, 20, 2, residual=True)
    ct = torch.randn(r.shape, device=dev, generator=gen)

    def grads_of(forward):
        ins = [t.clone().requires_grad_() for t in (x, w, b, r)]
        forward(*ins).backward(ct)
        return [t.grad for t in ins]

    got = grads_of(lambda x_, w_, b_, r_: direct_conv2d_blocked(
        x_, w_, b_, 2, "SAME", "gelu", residual=r_))
    want = grads_of(lambda x_, w_, b_, r_: direct_conv_blocked(
        x_, w_, 2, "SAME", b_, "gelu", residual=r_))
    torch.cuda.synchronize()
    for name, gk, gp in zip(("dx", "dw", "db", "dres"), got, want):
        kernel = "direct_conv2d_dgrad" if name == "dx" else \
            "direct_conv2d_wgrad"
        bwd_err[kernel] = max(bwd_err[kernel], compare(
            f"autograd {name} 3->64 20x20 s2 n2 gelu+residual vs plain "
            "autograd", gk, gp, **TOL))

    # Cob % 4 != 0: the dgrad's cp.async path, at a pencil of 6 and at Co
    # = 1000's pencil of 125, against the plain version and the library
    bwd_err["direct_conv2d_dgrad"] = max(bwd_err["direct_conv2d_dgrad"],
                                         c1_dgrads("window", False))

    print(f"[time] phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # -- 8. the second main path: VGG-16 training ---------------------------
    tr = lockstep_train(
        "train", vgg16_blocked(1000, device=dev, generator=torch.Generator()
                               .manual_seed(args.seed + 1)),
        BATCH, args.seed, {"direct_conv2d_fwd": 13, "direct_conv2d_dgrad": 12,
                           "direct_conv2d_wgrad": 13},
        dev)
    train_counts = tr.counts

    # -- 9. backward times -------------------------------------------------
    brows = {}
    for ci, co, s, h in shapes:
        x, w, z, g, spec = bwd_ops[(ci, co, s, h)]
        (pt, pb), (pl, pr) = spec.pads
        xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h),
                   (pl, pr, pt, pb)).contiguous()
        w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                  .contiguous())
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        dz_nchw = (dz.permute(0, 1, 4, 2, 3)
                   .reshape(BATCH, co, spec.ho, spec.wo).contiguous())
        flops = spec.flops()
        row = {}
        if ci != 3:
            def dgrad():
                return direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z, "relu")
            d_bound = tf32x3_bound(flops, 4 * (2 * g.numel() + w.numel()
                                              + x.numel()))
            row["dgrad"] = (
                time_ms(dgrad),
                time_ms(lambda: direct_conv_dgrad_blocked(
                    g, w, (h, h), s, "SAME", z, "relu")),
                time_ms(lambda: torch.ops.aten.convolution_backward(
                    dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1],
                    False, [0, 0], 1, [True, False, False])),
                *d_bound[:2])
            row["dgrad_f32_bound"] = d_bound[2]
            row["dgrad_graph"] = graph_ms(dgrad)
        def wgrad():
            return wgrad_partials(x, g, 3, 3, s, "SAME", z, "relu",
                                  with_db=True)
        w_bound = tf32x3_bound(flops, 4 * (x.numel() + 2 * g.numel()
                                           + w.numel() + co))
        row["wgrad"] = (
            time_ms(wgrad),
            time_ms(lambda: direct_conv_wgrad_blocked(
                x, g, 3, 3, s, "SAME", z, "relu", with_db=True)),
            time_ms(lambda: torch.ops.aten.convolution_backward(
                dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                [0, 0], 1, [False, True, False])),
            *w_bound[:2])
        row["wgrad_f32_bound"] = w_bound[2]
        row["wgrad_graph"] = graph_ms(wgrad)
        row["split_sum"] = split_sum_text(x, g, s)
        brows[(ci, co, s, h)] = row
        del xp, w_oihw, dz, dz_nchw
    sums = {k: [0.0, 0.0, 0.0, 0.0] for k in ("dgrad", "wgrad")}
    kinds = {k: [] for k in sums}
    dg_sum = {"graph": 0.0, "macs": 0, "issued": 0, "f32": 0.0}
    wg_sum = dict(dg_sum)
    for name, key in zip(LAYER_NAMES, layers):
        ci, co, s, h = key
        row = brows[key]
        x, w, z, g, _ = bwd_ops[key]
        plan, macs = wgrad_work(x, g, z, h, s, streamed=False)
        k_ms, _, l_ms, b_ms, _ = row["wgrad"]
        wg_sum["graph"] += row["wgrad_graph"]
        wg_sum["macs"] += macs
        wg_sum["issued"] += plan.issued_macs
        wg_sum["f32"] += row["wgrad_f32_bound"]
        print(f"[bwd] {name} wgrad tiles: {plan.tiles} tiles, function MACs "
              f"{plan.function_macs} (the function's), tensor-core MACs "
              f"issued {plan.issued_macs} (three products each; padding "
              f"{100 * plan.padding_share:.1f} %), shared memory "
              f"{plan.smem} B; eager_ms {k_ms:.4f} graph_ms "
              f"{row['wgrad_graph']:.4f} library_ms {l_ms:.4f}; "
              f"{macs / 1e6 / row['wgrad_graph']:.1f} function GMAC/s on the "
              f"device; bound_ms {b_ms:.4f} (3xTF32), f32 FMA bound_ms "
              f"{row['wgrad_f32_bound']:.4f}; {row['split_sum']}")
        if "dgrad" in row:
            k_ms, _, l_ms, b_ms, _ = row["dgrad"]
            f32_ms = row["dgrad_f32_bound"]
            phases, plan, macs = dgrad_work(g, w, z, h, s, streamed=False)
            dg_sum["graph"] += row["dgrad_graph"]
            dg_sum["macs"] += macs
            dg_sum["issued"] += plan.issued_macs
            dg_sum["f32"] += f32_ms
            print(f"[bwd] {name} dgrad phases: stride {s}, {phases} "
                  f"phase(s), {plan.tiles} tiles, function MACs by phase "
                  f"{plan.function_macs} (the function's), tensor-core MACs "
                  f"issued {plan.issued_macs} (three products each; padding "
                  f"{100 * plan.padding_share:.1f} %); eager_ms {k_ms:.4f} "
                  f"graph_ms {row['dgrad_graph']:.4f} library_ms "
                  f"{l_ms:.4f}; {macs / 1e6 / row['dgrad_graph']:.1f} "
                  f"function GMAC/s on the device; bound_ms {b_ms:.4f} "
                  f"(3xTF32), f32 FMA bound_ms {f32_ms:.4f}, issued MACs at "
                  f"the TF32 peak "
                  f"{2 * plan.issued_macs / PEAK_TF32_FLOPS * 1e3:.4f} ms")
        for kind in ("dgrad", "wgrad"):
            if kind not in row:
                continue
            k_ms, p_ms, l_ms, b_ms, b_by = row[kind]
            for i, v in enumerate((k_ms, p_ms, l_ms, b_ms)):
                sums[kind][i] += v
            kinds[kind].append((b_ms, b_by))
            print(f"[bwd] {name} {kind} {ci}->{co} in {h}x{h} s{s} n{BATCH}:"
                  f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                  f"{l_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) bound/kernel "
                  f"{b_ms / k_ms:.3f}")
    for kind, (k_ms, p_ms, l_ms, b_ms) in sums.items():
        print(f"[bwd] all {len(kinds[kind])} {kind}: kernel_ms {k_ms:.4f} "
              f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
              f"{b_ms:.4f} ({mostly(kinds[kind])})")
    print(f"[bwd] all {len(kinds['dgrad'])} dgrad phases: function MACs "
          f"by phase {dg_sum['macs']}, tensor-core MACs issued "
          f"{dg_sum['issued']} (padding "
          f"{100 * (1 - 3 * dg_sum['macs'] / dg_sum['issued']):.1f} %); "
          f"eager_ms {sums['dgrad'][0]:.4f} graph_ms {dg_sum['graph']:.4f} "
          f"library_ms {sums['dgrad'][2]:.4f}; bound_ms "
          f"{sums['dgrad'][3]:.4f} (3xTF32), f32 FMA bound_ms "
          f"{dg_sum['f32']:.4f}")
    print(f"[bwd] all {len(kinds['wgrad'])} wgrad tiles: function MACs "
          f"{wg_sum['macs']}, tensor-core MACs issued {wg_sum['issued']} "
          f"(padding {100 * (1 - 3 * wg_sum['macs'] / wg_sum['issued']):.1f}"
          f" %); eager_ms {sums['wgrad'][0]:.4f} graph_ms "
          f"{wg_sum['graph']:.4f} library_ms {sums['wgrad'][2]:.4f}; "
          f"bound_ms {sums['wgrad'][3]:.4f} (3xTF32), f32 FMA bound_ms "
          f"{wg_sum['f32']:.4f}")

    timed_steps("train", [("plain", tr.plain_step, tr.plain_state),
                          ("kernels", tr.step, tr.state)], tr.batches)

    # peak device memory of one kernel step, against what it must hold
    peak, p_bytes = step_peak_bytes(tr)
    saved, ws_max, hh = 0, 0, ENTRY
    for (ci, co, s), c in zip(vgg16_layers(), tr.model.convs):
        ho = -(-hh // s)
        saved += 4 * BATCH * (ci * hh * hh + co * ho * ho)    # x and z
        wb = choose_wgrad_blocking(BATCH, ho, ho, 3, 3, s,
                                   ci // c.in_pencil, c.in_pencil,
                                   co // c.out_pencil, c.out_pencil,
                                   prologue=True)
        ws_max = max(ws_max, 4 * wb.splits * (9 * ci * co + co))
        hh = ho
    must = 4 * p_bytes + saved + ws_max
    print(f"[train] peak device memory of one step: {peak / 2**20:.1f} MiB; "
          f"it must hold {must / 2**20:.1f} MiB = parameters, gradients and "
          f"2 Adam moments {4 * p_bytes / 2**20:.1f} + saved x and z "
          f"{saved / 2**20:.1f} + largest wgrad workspace "
          f"{ws_max / 2**20:.1f}")

    print(f"[time] phase 9 done at {time.perf_counter() - t_start:.1f} s")
    del tr, bwd_ops
    torch.cuda.empty_cache()

    mb_entries, mb_counts, mb_model = mobilenet_phases(args, dev, t_start)
    st_entries, st_counts = stream_phases(args, dev, t_start)
    lm_entries, lm_counts = lm_phases(args, dev, t_start)
    bf_entries, bf_counts = bf16_phases(args, dev, t_start, model)
    bt_entries, bt_counts = bf16_train_phases(args, dev, t_start, model, smi)
    sb_entries, sb_counts = separable_bf16_phases(args, dev, t_start, smi,
                                                  mb_model)
    gd_entries, gd_counts = grouped_dilated_phases(args, dev, t_start, smi)
    gb_entries, gb_counts = grouped_dilated_bwd_phases(args, dev, t_start,
                                                       smi)
    nr_entries, nr_counts = narrow_rows_phases(args, dev, t_start, smi, model,
                                               mb_model)

    # launches of each main-path run: VGG-16 served and trained, MobileNet
    # v1 served and trained, VGG-16 served and trained on the streamed route
    launches = {k: served.get(k, 0) + train_counts[k] + mb_counts[k]
                + st_counts[k] for k in st_counts}
    print(f"[launches] VGG-16 served {served} trained {train_counts}; "
          f"MobileNet v1 served and trained {mb_counts}; VGG-16 on the "
          f"streamed route served and trained {st_counts}; VGG-16 served "
          f"in bf16 on both routes {bf_counts}; VGG-16 trained in bf16 on "
          f"both routes {bt_counts}; MobileNet v1 served and trained in "
          f"bf16 {sb_counts}; AlexNet served in f32 and bf16 {gd_counts}; "
          f"AlexNet trained in f32 and bf16 {gb_counts}; the three nets "
          f"trained in bf16 at batch 32 {nr_counts}")
    kernels = [
        {"name": "direct_conv2d_fwd (fwd_kernel)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
         "launches": launches["direct_conv2d_fwd"],
         "max_abs_err": max_err["direct_conv2d_fwd"], "ms": tot[0],
         "plain_ms": tot[1], "bound_ms": tot[3], "bound_by": conv_by,
         "library_ms": tot[2]},
    ]
    for name, kind, tpu in (("direct_conv2d_dgrad", "dgrad", TPU_DGRAD),
                            ("direct_conv2d_wgrad", "wgrad", TPU_WGRAD)):
        k_ms, p_ms, l_ms, b_ms = sums[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE,
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": bwd_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": mostly(kinds[kind]),
            "library_ms": l_ms})
    kernels.extend(mb_entries)
    kernels.extend(st_entries)
    kernels.extend(lm_entries)
    kernels.extend(bf_entries)
    for e in bt_entries:            # the dz pass runs MobileNet's too
        if e["name"].startswith("direct_conv2d_dz_bf16"):
            e["launches"] += sb_counts.get("direct_conv2d_dz_bf16", 0)
    kernels.extend(bt_entries)
    kernels.extend(sb_entries)
    kernels.extend(gd_entries)
    kernels.extend(gb_entries)
    kernels.extend(nr_entries)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
