"""Wrappers of the CUDA depthwise kernels, and their autograd.

``depthwise_conv2d_blocked`` is the port of the reference's
``depthwise_conv2d_blocked_pallas`` (``repro/kernels/conv2d_depthwise.py:
447``): a depthwise conv (``groups == C``) on the blocked layouts, weight
``[C/Cb, 1, Hf, Wf, 1, Cb]``, with stride, TF-SAME pads, filter dilation
and the fused epilogue (bias, activation, residual, GAP).

* Under ``torch.no_grad``/``inference_mode``, or when no operand requires
  grad, it runs the fused inference kernel (``_dw_fwd_kernel``, ``:72``):
  ``csrc/conv2d_depthwise.cu``'s ``depthwise_fwd_kernel`` (a persistent
  walk over items, each staged by cp.async under the taps of the one
  before), or under the ``BF16`` policy its bf16 build
  (``depthwise_fwd_kernel_bf16``: bf16 cells, f32 taps and sums, bf16 out;
  x, the f32 master weights and the residual cast to bf16 once a call, as
  the reference's ``_dwconv`` casts them) on a CUDA tensor, the plain
  version
  (``core.direct_conv.direct_conv_blocked`` with ``groups=C``) on a CPU
  tensor.  With ``gap`` the kernel writes per-item partial sums and the CTA
  of each (image, channel block)'s last item adds them into the pooled
  features (``csrc/split_sum.cuh``).
* With grad mode on and an operand that requires grad it enters
  ``kernels.conv_autograd.BlockedConvFunction``, the counterpart of
  ``_dwconv`` / ``_dwconv_fwd`` / ``_dwconv_bwd`` (``:354-440``), with
  this family's kernels: ``depthwise_dgrad`` (a tap kernel with mirrored
  taps, as the reference runs its dgrad through ``_dw_fwd_kernel``) and
  ``depthwise_wgrad`` (``_dw_wgrad_kernel``, ``:105``: the forward's
  items walked in shares of each (channel block, lane group), whose last
  CTA adds the shares in split order), with the ``dz = g * act'(z)``
  prologue and ``db``.  No padded, dilated or cropped copy
  exists on the card.  The training path runs the f32 policy or ``BF16``
  (``direct_conv2d.training_policy``): under ``BF16`` the forward's bf16
  build with a linear epilogue gives the bf16 ``z``, and the bf16 builds
  of the dgrad and wgrad (``depthwise_dgrad_kernel_bf16``,
  ``depthwise_wgrad_kernel_bf16``: dz rounded to bf16 before the taps, as
  the reference's ``cotangent_prologue``) the bf16 ``dx`` and the f32
  ``dw`` and ``db``.  A float16 policy raises: no build reads it.

A forward call's host path is lean, because at MobileNet's small legs it,
not the device, sets the pace: the checks that depend only on shapes and
the launch plan (tiles, shared memory, grid, the C entry's int array) are
built once per shape, each operand is checked and read once, and the
launch skips entering the device's context when it is current.

Every wrapper takes its plain version only because the tensor lies on the
CPU; a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts the
launches of this module's kernels, each build under its own name (the bf16
builds' with ``_bf16``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import (DW_MAX_TAPS, H100_SXM,
                                       DepthwiseBlocking,
                                       DepthwiseWgradBlocking,
                                       choose_depthwise_blocking,
                                       choose_depthwise_dgrad_blocking,
                                       choose_depthwise_wgrad_blocking,
                                       depthwise_dgrad_smem_bytes,
                                       depthwise_dgrad_variant,
                                       depthwise_fwd_smem_bytes,
                                       depthwise_wgrad_smem_bytes)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.direct_conv import (backward_spec, conv_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_preactivation,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.padding import Padding
from repro_torch.core.precision import BF16, F32, Precision
from repro_torch.kernels.direct_conv2d import (_ACT_CODES, _GRID_YZ_MAX,
                                               _backward_operands,
                                               _by_shapes, _call, _check,
                                               _check_activation,
                                               _cuda_device, _library, _ptr,
                                               _require, _stream, _suffix,
                                               bf16_operands, build_dtype,
                                               plain_policy,
                                               training_policy)
from repro_torch.kernels import split_sum
from repro_torch.kernels.conv_autograd import BlockedConvFunction

__all__ = ["LAUNCHES", "reset_launches", "depthwise_conv2d_blocked",
           "depthwise_gap", "depthwise_dgrad", "depthwise_wgrad",
           "depthwise_wgrad_partials"]

LAUNCHES = {"conv2d_depthwise_fwd": 0, "conv2d_depthwise_fwd_bf16": 0,
            "conv2d_depthwise_dgrad": 0, "conv2d_depthwise_dgrad_bf16": 0,
            "conv2d_depthwise_wgrad": 0, "conv2d_depthwise_wgrad_bf16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    # each entry and its bf16 build, which takes the same arguments
    for kind, pointers in (("fwd", 8), ("dgrad", 4), ("wgrad", 6)):
        for build in ("", "_bf16"):
            entry = getattr(lib, f"conv2d_depthwise_{kind}{build}")
            entry.argtypes = [ptr] * pointers + [ctypes.POINTER(i32), ptr]
            entry.restype = i32


def _lib() -> ctypes.CDLL:
    # the depthwise kernels' geometry: threads, lanes per thread, taps
    return _library("conv2d_depthwise", _declare,
                    (H100_SXM.threads, 1, DW_MAX_TAPS))


def _taps(hf: int, wf: int) -> None:
    if hf * wf > DW_MAX_TAPS:
        raise ValueError(f"filter {hf}x{wf}: the depthwise kernels hold at "
                         f"most {DW_MAX_TAPS} taps")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def depthwise_conv2d_blocked(x: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             stride: int = 1, padding: Padding = "VALID",
                             activation: Optional[str] = None,
                             residual: Optional[torch.Tensor] = None,
                             gap: bool = False, precision=F32,
                             dilation=1) -> torch.Tensor:
    """Blocked depthwise convolution with the fused epilogue,
    differentiable.

    x: ``[N, C/Cb, Hi, Wi, Cb]``; w: ``[C/Cb, 1, Hf, Wf, 1, Cb]``; bias:
    ``[C/Cb, Cb]`` or None; residual: the output's shape or None, added
    after the activation -> ``[N, C/Cb, Ho, Wo, Cb]``, or with ``gap=True``
    the pooled ``[N, C]`` features.  ``padding`` is TF-SAME aware against
    the dilated filter; on CUDA the pads are masked loads.  Under ``BF16``
    the output (and the pooled features) are bf16.
    """
    spec = _forward_spec(x.shape, w.shape, stride, padding, dilation,
                         None if bias is None else bias.shape,
                         None if residual is None else residual.shape,
                         activation)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, residual)):
        policy = training_policy(precision)
        return BlockedConvFunction.apply(x, w, bias, residual,
                                         _Depthwise(policy), spec,
                                         activation, gap, policy)
    if x.device.type == "cpu":
        return direct_conv_blocked(x, w, stride, padding, bias, activation,
                                   precision, groups=spec.groups,
                                   dilation=spec.dilation, residual=residual,
                                   gap=gap)
    return _fwd_cuda(x, w, bias, residual, spec, activation, gap,
                     build_dtype(precision))


@_by_shapes
def _forward_spec(x_shape, w_shape, stride, padding, dilation, b_shape,
                  r_shape, activation) -> ConvSpec:
    """The forward's checks of its operands' shapes and of the activation,
    and its spec."""
    if len(x_shape) != 5:
        raise ValueError(f"expected x [N, C/Cb, H, W, Cb], got "
                         f"{tuple(x_shape)}")
    spec = conv_spec(torch.empty(x_shape, device="meta"),
                     torch.empty(w_shape, device="meta"), stride, padding,
                     x_shape[1] * x_shape[4], dilation)
    _check_activation(activation)
    _taps(spec.hf, spec.wf)
    n, cblk, _, _, cb = x_shape
    if b_shape is not None and tuple(b_shape) != (cblk, cb):
        raise ValueError(f"bias shape {tuple(b_shape)} != {(cblk, cb)}")
    out_shape = (n, cblk, spec.ho, spec.wo, cb)
    if r_shape is not None and tuple(r_shape) != out_shape:
        raise ValueError(f"residual shape {tuple(r_shape)} != "
                         f"output shape {out_shape}")
    return spec


@dataclasses.dataclass(frozen=True)
class _FwdPlan:
    """What a forward launch at one shape needs but its pointers, stream
    and library, built once (``_fwd_plan``): the tiles, the output and GAP
    partials' shapes and the C entry's int array."""
    blk: DepthwiseBlocking
    out_shape: Tuple[int, ...]
    partials_shape: Tuple[int, ...]
    ints: object


@functools.lru_cache(maxsize=1024)
def _fwd_plan(x_shape: Tuple[int, ...], spec: ConvSpec, act: int,
              gap: bool, op_bytes: int = 4) -> _FwdPlan:
    """The plan of a forward launch by the build for ``op_bytes``
    operands (4: f32, 2: bf16)."""
    n, cblk, hi, wi, cb = x_shape
    blk = choose_depthwise_blocking(n, cblk, spec.ho, spec.wo, cb, spec.hf,
                                    spec.wf, spec.stride, spec.dilation,
                                    gap=gap, op_bytes=op_bytes)
    smem = depthwise_fwd_smem_bytes(blk.hwin, blk.wwin, blk.lanes, H100_SXM,
                                    gap, op_bytes)
    # the kernel's variants: 3x3 at dilation 1 and stride 1 or 2 keep their
    # tap columns in registers; 0 takes any filter, stride and dilation
    fast = (spec.hf, spec.wf, spec.dilation) == (3, 3, (1, 1))
    variant = spec.stride if fast and spec.stride in (1, 2) else 0
    ints = (cblk, cb, hi, wi, spec.ho, spec.wo, spec.hf, spec.wf,
            spec.stride, *spec.dilation, spec.pads[0][0], spec.pads[1][0],
            blk.hob, blk.wob, blk.hwin, blk.wwin, blk.lanes, blk.items, act,
            blk.grid, smem, variant)
    if blk.items >= 2 ** 31:
        raise ValueError(f"grid too large: {blk.items} items")
    n_tiles = (spec.ho // blk.hob) * (spec.wo // blk.wob)
    return _FwdPlan(blk=blk, out_shape=(n, cblk, spec.ho, spec.wo, cb),
                    partials_shape=(n, cblk, n_tiles, cb),
                    ints=(ctypes.c_int * len(ints))(*ints))


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              residual: Optional[torch.Tensor], spec: ConvSpec,
              activation: Optional[str], gap: bool,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the forward kernel's build for ``dtype`` operands on CUDA
    operands -> the output map, or with ``gap`` the pooled ``[N, C]``."""
    out, pooled, _ = _launch_cuda(x, w, bias, residual, spec, activation, gap,
                                  dtype)
    return pooled if gap else out


def depthwise_gap(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: Padding = "VALID",
                  activation: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None, dilation=1,
                  precision=F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward (under ``BF16`` its bf16 build) with the
    GAP rider on CUDA operands -> ``(pooled [N, C], partials [N, C/Cb,
    tiles, Cb])``: the per-item f32 sums the kernel wrote and the pooled
    features summed from them in the same launch."""
    spec = _forward_spec(x.shape, w.shape, stride, padding, dilation,
                         None if bias is None else bias.shape,
                         None if residual is None else residual.shape,
                         activation)
    _, pooled, partials = _launch_cuda(x, w, bias, residual, spec,
                                       activation, True,
                                       build_dtype(precision))
    return pooled, partials


def _launch_cuda(x, w, bias, residual, spec, activation, gap,
                 dtype: torch.dtype = torch.float32):
    """Launch the forward kernel's build for ``dtype`` on CUDA operands
    (cast to bf16 by ``bf16_operands`` for the bf16 build), each checked
    and read once, the shape's plan from ``_fwd_plan`` -> ``(out, pooled or
    None, partials or None)``: out and pooled at ``dtype``, the partials
    f32."""
    dev = _cuda_device(x)
    if dtype == torch.bfloat16:
        x, w, bias, residual = bf16_operands(x, w, bias, residual)
    ptrs = [_require(t, name, dev, vector_loads=name == "x",
                     dtype=torch.float32 if name == "bias" else dtype)
            for name, t in (("x", x), ("w", w), ("bias", bias),
                            ("residual", residual))]
    plan = _fwd_plan(x.shape, spec, _ACT_CODES[activation], gap,
                     dtype.itemsize)
    out = torch.empty(plan.out_shape, device=dev, dtype=dtype)
    partials = pooled = counters = None
    stream = _stream(dev)
    if gap:
        n, cblk, _, cb = plan.partials_shape
        partials = torch.empty(plan.partials_shape, device=dev,
                               dtype=torch.float32)
        pooled = torch.empty((n, cblk * cb), device=dev, dtype=dtype)
        counters = split_sum.counters(dev, stream, n * cblk)
    lib = _lib()
    name = "conv2d_depthwise_fwd" + _suffix(dtype)
    err = _call(dev, getattr(lib, name), *ptrs, out.data_ptr(),
                _ptr(partials), _ptr(pooled), counters, plan.ints, stream)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return out, pooled, partials


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def depthwise_dgrad(g: torch.Tensor, w: torch.Tensor,
                    input_hw: Tuple[int, int], stride: int = 1,
                    padding: Padding = "VALID",
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    dilation=1, precision=F32) -> torch.Tensor:
    """Input gradient of ``act(dwconv(x, w) + b)``: the raw cotangent ``g
    [N, C/Cb, Ho, Wo, Cb]``, the saved pre-activation ``z`` (None for a
    linear epilogue) and ``w`` -> ``dx [N, C/Cb, Hi, Wi, Cb]`` at the
    unpadded ``input_hw``.  ``stride``/``padding``/``dilation`` are the
    forward's.  On CUDA the kernel walks items of dx (``_dgrad_plan``):
    3x3 at stride 1 on the register path, at stride 2 split by phase;
    under ``BF16`` its bf16 build on ``g``, ``z`` and ``w`` cast to bf16
    (dz rounded to bf16 before the taps, dx bf16); on the CPU the plain
    version on the same bf16 operands."""
    _backward_operands(g, z, activation)
    dtype = build_dtype(precision)
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, input_hw, stride, padding, z,
                                         activation, g.shape[1] * g.shape[4],
                                         dilation,
                                         precision=plain_policy(dtype))
    prologue = z is not None and activation not in (None, "linear")
    plan = _dgrad_plan(g.shape, w.shape, tuple(input_hw), stride,
                       _hashable(padding), _hashable(dilation),
                       _ACT_CODES[activation], prologue, dtype.itemsize)
    return dgrad_launch(plan, g, w, z if prologue else None, dtype)


def _hashable(v):
    """A padding or dilation argument as a key of ``_dgrad_plan``'s cache."""
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(e) for e in v)
    return v


@dataclasses.dataclass(frozen=True)
class _DgradPlan:
    """What a dgrad launch at one shape needs but its pointers, stream and
    library, built once (``_dgrad_plan``): the items, dx's shape and the C
    entry's int array."""
    blk: DepthwiseBlocking
    spec: ConvSpec
    dx_shape: Tuple[int, ...]
    variant: int
    ints: object


@functools.lru_cache(maxsize=1024)
def _dgrad_plan(g_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
                input_hw: Tuple[int, int], stride, padding, dilation,
                act: int, prologue: bool, op_bytes: int = 4) -> _DgradPlan:
    """The plan of a dgrad launch by the build for ``op_bytes`` operands:
    the items of ``choose_depthwise_dgrad_blocking`` and the kernel
    variant."""
    n, cblk, ho, wo, cb = g_shape
    hi, wi = input_hw
    spec = backward_spec(n, hi, wi, w_shape, stride, padding,
                         torch.empty(g_shape, device="meta"), None,
                         cblk * cb, dilation)
    _taps(spec.hf, spec.wf)
    if cblk > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: C/Cb={cblk}, N={n}")
    blk = choose_depthwise_dgrad_blocking(n, cblk, hi, wi, cb, spec.hf,
                                          spec.wf, spec.stride,
                                          spec.dilation, spec.pads, prologue,
                                          op_bytes=op_bytes)
    if blk.items >= 2 ** 31:
        raise ValueError(f"grid too large: {blk.items} items")
    variant = depthwise_dgrad_variant(spec.hf, spec.wf, spec.stride,
                                      spec.dilation)
    smem = depthwise_dgrad_smem_bytes(blk.hwin, blk.wwin, blk.lanes,
                                      prologue, op_bytes)
    ints = (cblk, cb, ho, wo, hi, wi, spec.hf, spec.wf, spec.stride,
            *spec.dilation, spec.pads[0][0], spec.pads[1][0], blk.hob,
            blk.wob, blk.hwin, blk.wwin, blk.lanes, blk.items, act,
            int(prologue), blk.grid, smem, variant)
    return _DgradPlan(blk=blk, spec=spec, dx_shape=(n, cblk, hi, wi, cb),
                      variant=variant, ints=(ctypes.c_int * len(ints))(*ints))


def dgrad_launch(plan: _DgradPlan, g: torch.Tensor, w: torch.Tensor,
                 z: Optional[torch.Tensor],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the dgrad of ``plan`` (a plan for ``dtype``'s build) on
    CUDA operands cast to ``dtype`` (``z`` only with the prologue), each
    checked and read once -> dx at ``dtype``; counts the launch."""
    dev = _cuda_device(g)
    g, w = g.to(dtype), w.to(dtype)
    z = None if z is None else z.to(dtype)
    ptrs = (_require(g, "g", dev, vector_loads=True, dtype=dtype),
            _require(z, "z", dev, vector_loads=True, dtype=dtype),
            _require(w, "w", dev, dtype=dtype))
    if z is not None and z.shape != g.shape:
        raise ValueError(f"pre-activation shape {tuple(z.shape)} != "
                         f"{tuple(g.shape)}")
    dx = torch.empty(plan.dx_shape, device=dev, dtype=dtype)
    lib = _lib()
    name = "conv2d_depthwise_dgrad" + _suffix(dtype)
    err = _call(dev, getattr(lib, name), *ptrs, dx.data_ptr(), plan.ints,
                _stream(dev))
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return dx


def depthwise_wgrad(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                    stride: int = 1, padding: Padding = "VALID",
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    with_db: bool = False, dilation=1, precision=F32):
    """Weight (and bias) gradient of ``act(dwconv(x, w) + b)``: the
    forward's unpadded input ``x``, the raw cotangent ``g`` and the saved
    pre-activation ``z`` -> ``(dw [C/Cb, 1, Hf, Wf, 1, Cb] f32, db [C/Cb,
    Cb] f32 or None)``.  On CUDA the wgrad kernel
    (``depthwise_wgrad_partials``; under ``BF16`` its bf16 build on ``x``,
    ``g`` and ``z`` cast to bf16, dz rounded to bf16, dw and db f32) writes
    one partial sum per position share and the last CTA of each channel
    block adds the shares in order: two runs give identical bits."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        return direct_conv_wgrad_blocked(
            x, g, hf, wf, stride, padding, z, activation, with_db,
            g.shape[1] * g.shape[4], dilation,
            precision=plain_policy(build_dtype(precision)))
    _, out = depthwise_wgrad_partials(x, g, hf, wf, stride, padding, z,
                                      activation, with_db, dilation,
                                      precision)
    cblk, cb = g.shape[1], g.shape[4]
    dw_size = cblk * hf * wf * cb
    dw = out[:dw_size].view(cblk, 1, hf, wf, 1, cb)
    db = out[dw_size:].view(cblk, cb) if with_db else None
    return dw, db


def depthwise_wgrad_partials(x: torch.Tensor, g: torch.Tensor, hf: int,
                             wf: int, stride: int = 1,
                             padding: Padding = "VALID",
                             z: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None,
                             with_db: bool = False,
                             dilation=1, precision=F32
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgrad kernel (under ``BF16`` its bf16 build) on CUDA operands
    -> ``(ws, out)``: the f32 workspace ``[splits, |dw| + |db|]``, each row
    laid out as ``dw`` then ``db``, and ``out [|dw| + |db|]``, its rows
    summed in split order by the last CTA of each (channel block, lane
    group)."""
    _backward_operands(g, z, activation)
    dtype = build_dtype(precision)
    prologue = z is not None and activation not in (None, "linear")
    plan = _wgrad_plan(tuple(x.shape), tuple(g.shape), hf, wf, stride,
                       _hashable(padding), _hashable(dilation),
                       _ACT_CODES[activation], prologue, with_db,
                       op_bytes=dtype.itemsize)
    return wgrad_launch(plan, x, g, z if prologue else None, dtype)


@dataclasses.dataclass(frozen=True)
class _WgradPlan:
    """What a wgrad launch at one shape needs but its pointers, stream and
    library, built once (``_wgrad_plan``): the items and shares, the
    workspace's row length, the columns and the C entry's int array."""
    blk: DepthwiseWgradBlocking
    spec: ConvSpec
    cols: int
    columns: int
    variant: int
    ints: object


@functools.lru_cache(maxsize=1024)
def _wgrad_plan(x_shape: Tuple[int, ...], g_shape: Tuple[int, ...],
                hf: int, wf: int, stride, padding, dilation, act: int,
                prologue: bool, with_db: bool,
                blk: Optional[DepthwiseWgradBlocking] = None,
                op_bytes: int = 4) -> _WgradPlan:
    """The plan of a wgrad launch by the build for ``op_bytes`` operands:
    the items and shares of ``choose_depthwise_wgrad_blocking`` (or
    ``blk``, as ``launch/separable_bwd_ab.py`` times other items) and the
    kernel variant."""
    n, cblk, hi, wi, cb = x_shape
    if (g_shape[1], g_shape[4]) != (cblk, cb):
        raise ValueError(f"cotangent blocks {(g_shape[1], g_shape[4])} do "
                         f"not match the input's {(cblk, cb)}")
    spec = backward_spec(n, hi, wi, (cblk, 1, hf, wf, 1, cb), stride,
                         padding, torch.empty(g_shape, device="meta"), None,
                         cblk * cb, dilation)
    _taps(hf, wf)
    if blk is None:
        blk = choose_depthwise_wgrad_blocking(n, cblk, spec.ho, spec.wo, cb,
                                              hf, wf, spec.stride,
                                              spec.dilation, prologue,
                                              op_bytes=op_bytes)
    columns = blk.columns(cblk, cb)
    if columns > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: {columns} columns")
    variant = depthwise_dgrad_variant(hf, wf, spec.stride, spec.dilation)
    smem = depthwise_wgrad_smem_bytes(blk.hwin, blk.wwin, blk.hob, blk.wob,
                                      blk.lanes, hf * wf, prologue,
                                      op_bytes=op_bytes)
    ints = (cblk, cb, hi, wi, spec.ho, spec.wo, hf, wf, spec.stride,
            *spec.dilation, spec.pads[0][0], spec.pads[1][0], blk.hob,
            blk.wob, blk.hwin, blk.wwin, blk.lanes, blk.per_column,
            blk.splits, act, int(prologue), int(with_db), columns, smem,
            variant)
    cols = cblk * hf * wf * cb + (cblk * cb if with_db else 0)
    return _WgradPlan(blk=blk, spec=spec, cols=cols, columns=columns,
                      variant=variant,
                      ints=(ctypes.c_int * len(ints))(*ints))


def wgrad_launch(plan: _WgradPlan, x: torch.Tensor, g: torch.Tensor,
                 z: Optional[torch.Tensor],
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the wgrad of ``plan`` (a plan for ``dtype``'s build) on CUDA
    operands cast to ``dtype`` (``z`` only with the prologue), each checked
    and read once -> ``(ws, out)``, both f32; counts the launch."""
    dev = _cuda_device(x)
    x, g = x.to(dtype), g.to(dtype)
    z = None if z is None else z.to(dtype)
    ptrs = (_require(x, "x", dev, vector_loads=True, dtype=dtype),
            _require(g, "g", dev, vector_loads=True, dtype=dtype),
            _require(z, "z", dev, vector_loads=True, dtype=dtype))
    if z is not None and z.shape != g.shape:
        raise ValueError(f"pre-activation shape {tuple(z.shape)} != "
                         f"{tuple(g.shape)}")
    ws = torch.empty((plan.blk.splits, plan.cols), device=dev,
                     dtype=torch.float32)
    out = torch.empty((plan.cols,), device=dev, dtype=torch.float32)
    stream = _stream(dev)
    lib = _lib()
    name = "conv2d_depthwise_wgrad" + _suffix(dtype)
    err = _call(dev, getattr(lib, name), *ptrs, ws.data_ptr(),
                out.data_ptr(), split_sum.counters(dev, stream, plan.columns),
                plan.ints, stream)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return ws, out


# ---------------------------------------------------------------------------
# autograd: the reference's custom VJP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Depthwise:
    """The depthwise family's kernels for ``BlockedConvFunction``, in the
    builds of ``policy`` (F32, or ``BF16``: the forward's bf16 build with a
    linear epilogue gives the bf16 ``z``, the dgrad's and wgrad's bf16
    builds the gradients)."""
    policy: Precision = F32

    def preactivation(self, x, w, bias, spec: ConvSpec) -> torch.Tensor:
        if x.device.type == "cpu":
            return direct_conv_preactivation(
                x, w, spec.stride, spec.pads, bias, spec.groups,
                spec.dilation,
                precision=self.policy if self.policy == BF16 else None)
        return _fwd_cuda(x, w, bias, None, spec, None, False,
                         build_dtype(self.policy))

    def dgrad(self, g, w, spec: ConvSpec, z, activation) -> torch.Tensor:
        return depthwise_dgrad(g, w, (spec.hi, spec.wi), spec.stride,
                               spec.pads, z, activation, spec.dilation,
                               self.policy)

    def wgrad(self, x, g, spec: ConvSpec, z, activation, with_db: bool):
        return depthwise_wgrad(x, g, spec.hf, spec.wf, spec.stride, spec.pads,
                               z, activation, with_db, spec.dilation,
                               self.policy)
