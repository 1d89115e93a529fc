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
  before) on a CUDA tensor, the plain version
  (``core.direct_conv.direct_conv_blocked`` with ``groups=C``) on a CPU
  tensor.  With ``gap`` the kernel writes per-item partial sums and the CTA
  of each (image, channel block)'s last item adds them into the pooled
  features (``csrc/split_sum.cuh``).
* With grad mode on and an operand that requires grad it enters
  ``kernels.conv_autograd.BlockedConvFunction``, the counterpart of
  ``_dwconv`` / ``_dwconv_fwd`` / ``_dwconv_bwd`` (``:354-440``), with
  this family's kernels: ``depthwise_dgrad`` (a tap kernel with mirrored
  taps, as the reference runs its dgrad through ``_dw_fwd_kernel``) and
  ``depthwise_wgrad`` (``_dw_wgrad_kernel``, ``:105``, whose last CTA of
  each channel block adds its shares in split order), with the ``dz = g *
  act'(z)`` prologue and ``db``.  No padded, dilated or cropped copy
  exists on the card.

A forward call's host path is lean, because at MobileNet's small legs it,
not the device, sets the pace: the checks that depend only on shapes and
the launch plan (tiles, shared memory, grid, the C entry's int array) are
built once per shape, each operand is checked and read once, and the
launch skips entering the device's context when it is current.

Every wrapper takes its plain version only because the tensor lies on the
CPU; a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts the
launches of this module's kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import (DW_MAX_TAPS, H100_SXM,
                                       DepthwiseBlocking,
                                       choose_depthwise_blocking,
                                       choose_depthwise_dgrad_blocking,
                                       choose_depthwise_wgrad_blocking,
                                       depthwise_fwd_smem_bytes,
                                       depthwise_smem_bytes,
                                       depthwise_wgrad_smem_bytes)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.direct_conv import (backward_spec, conv_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_preactivation,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.padding import Padding
from repro_torch.core.precision import F32, resolve_precision
from repro_torch.kernels.direct_conv2d import (_ACT_CODES, _GRID_YZ_MAX,
                                               _backward_operands,
                                               _by_shapes, _call, _check,
                                               _check_activation,
                                               _cuda_device, _library, _ptr,
                                               _require, _stream)
from repro_torch.kernels import split_sum
from repro_torch.kernels.conv_autograd import BlockedConvFunction

__all__ = ["LAUNCHES", "reset_launches", "depthwise_conv2d_blocked",
           "depthwise_gap", "depthwise_dgrad", "depthwise_wgrad",
           "depthwise_wgrad_partials"]

LAUNCHES = {"conv2d_depthwise_fwd": 0, "conv2d_depthwise_dgrad": 0,
            "conv2d_depthwise_wgrad": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.conv2d_depthwise_fwd.argtypes = [ptr] * 8 + [ctypes.POINTER(i32),
                                                     ptr]
    lib.conv2d_depthwise_fwd.restype = i32
    lib.conv2d_depthwise_dgrad.argtypes = [ptr] * 4 + [i32] * 20 + [ptr]
    lib.conv2d_depthwise_dgrad.restype = i32
    lib.conv2d_depthwise_wgrad.argtypes = [ptr] * 6 + [i32] * 20 + [ptr]
    lib.conv2d_depthwise_wgrad.restype = i32


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
    the dilated filter; on CUDA the pads are masked loads.
    """
    spec = _forward_spec(x.shape, w.shape, stride, padding, dilation,
                         None if bias is None else bias.shape,
                         None if residual is None else residual.shape,
                         activation)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, residual)):
        if resolve_precision(precision).op_dtype != torch.float32:
            raise NotImplementedError(
                "the training path runs the f32 policy only")
        return BlockedConvFunction.apply(x, w, bias, residual, _Depthwise,
                                         spec, activation, gap)
    if x.device.type == "cpu":
        return direct_conv_blocked(x, w, stride, padding, bias, activation,
                                   precision, groups=spec.groups,
                                   dilation=spec.dilation, residual=residual,
                                   gap=gap)
    if resolve_precision(precision).op_dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernel of this slice runs the f32 policy only")
    return _fwd_cuda(x, w, bias, residual, spec, activation, gap)


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
              gap: bool) -> _FwdPlan:
    n, cblk, hi, wi, cb = x_shape
    blk = choose_depthwise_blocking(n, cblk, spec.ho, spec.wo, cb, spec.hf,
                                    spec.wf, spec.stride, spec.dilation,
                                    gap=gap)
    smem = depthwise_fwd_smem_bytes(blk.hwin, blk.wwin, blk.lanes, H100_SXM,
                                    gap)
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
              activation: Optional[str], gap: bool) -> torch.Tensor:
    """Launch the forward kernel on CUDA operands -> the output map, or
    with ``gap`` the pooled ``[N, C]``."""
    out, pooled, _ = _launch_cuda(x, w, bias, residual, spec, activation, gap)
    return pooled if gap else out


def depthwise_gap(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: Padding = "VALID",
                  activation: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None, dilation=1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward with the GAP rider on CUDA operands ->
    ``(pooled [N, C], partials [N, C/Cb, tiles, Cb])``: the per-item sums
    the kernel wrote and the pooled features summed from them in the same
    launch."""
    spec = _forward_spec(x.shape, w.shape, stride, padding, dilation,
                         None if bias is None else bias.shape,
                         None if residual is None else residual.shape,
                         activation)
    _, pooled, partials = _launch_cuda(x, w, bias, residual, spec,
                                       activation, True)
    return pooled, partials


def _launch_cuda(x, w, bias, residual, spec, activation, gap):
    """Launch the forward kernel on CUDA operands, each checked and read
    once, the shape's plan from ``_fwd_plan`` -> ``(out, pooled or None,
    partials or None)``."""
    dev = _cuda_device(x)
    ptrs = [_require(t, name, dev, vector_loads=name == "x")
            for name, t in (("x", x), ("w", w), ("bias", bias),
                            ("residual", residual))]
    plan = _fwd_plan(x.shape, spec, _ACT_CODES[activation], gap)
    out = torch.empty(plan.out_shape, device=dev, dtype=torch.float32)
    partials = pooled = counters = None
    stream = _stream(dev)
    if gap:
        n, cblk, _, cb = plan.partials_shape
        partials = torch.empty(plan.partials_shape, device=dev,
                               dtype=torch.float32)
        pooled = torch.empty((n, cblk * cb), device=dev, dtype=torch.float32)
        counters = split_sum.counters(dev, stream, n * cblk)
    lib = _lib()
    err = _call(dev, lib.conv2d_depthwise_fwd, *ptrs, out.data_ptr(),
                _ptr(partials), _ptr(pooled), counters, plan.ints, stream)
    LAUNCHES["conv2d_depthwise_fwd"] += 1
    _check(err, lib, "conv2d_depthwise_fwd")
    return out, pooled, partials


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def depthwise_dgrad(g: torch.Tensor, w: torch.Tensor,
                    input_hw: Tuple[int, int], stride: int = 1,
                    padding: Padding = "VALID",
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    dilation=1) -> torch.Tensor:
    """Input gradient of ``act(dwconv(x, w) + b)``: the raw cotangent ``g
    [N, C/Cb, Ho, Wo, Cb]``, the saved pre-activation ``z`` (None for a
    linear epilogue) and ``w`` -> ``dx [N, C/Cb, Hi, Wi, Cb]`` at the
    unpadded ``input_hw``.  ``stride``/``padding``/``dilation`` are the
    forward's."""
    _backward_operands(g, z, activation)
    hi, wi = input_hw
    groups = g.shape[1] * g.shape[4]
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, input_hw, stride, padding, z,
                                         activation, groups, dilation)
    dev = _cuda_device(g)
    n, cblk, ho, wo, cb = g.shape
    spec = backward_spec(n, hi, wi, w.shape, stride, padding, g, z, groups,
                         dilation)
    _taps(spec.hf, spec.wf)
    ptrs = (_require(g, "g", dev, vector_loads=True),
            _require(z, "z", dev, vector_loads=True),
            _require(w, "w", dev))
    if cblk > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: C/Cb={cblk}, N={n}")
    blk = choose_depthwise_dgrad_blocking(n, cblk, hi, wi, cb, spec.hf,
                                          spec.wf, spec.stride,
                                          spec.dilation)
    smem = depthwise_smem_bytes(blk.hwin, blk.wwin, cb, H100_SXM)
    dx = torch.empty((n, cblk, hi, wi, cb), device=dev, dtype=torch.float32)
    lib = _lib()
    err = _call(dev, lib.conv2d_depthwise_dgrad, *ptrs, dx.data_ptr(), n,
                cblk, cb, ho, wo, hi, wi, spec.hf, spec.wf, spec.stride,
                *spec.dilation, spec.pads[0][0], spec.pads[1][0], blk.hob,
                blk.wob, blk.hwin, blk.wwin, _ACT_CODES[activation], smem,
                _stream(dev))
    LAUNCHES["conv2d_depthwise_dgrad"] += 1
    _check(err, lib, "conv2d_depthwise_dgrad")
    return dx


def depthwise_wgrad(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                    stride: int = 1, padding: Padding = "VALID",
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    with_db: bool = False, dilation=1):
    """Weight (and bias) gradient of ``act(dwconv(x, w) + b)``: the
    forward's unpadded input ``x``, the raw cotangent ``g`` and the saved
    pre-activation ``z`` -> ``(dw [C/Cb, 1, Hf, Wf, 1, Cb] f32, db [C/Cb,
    Cb] f32 or None)``.  On CUDA the wgrad kernel
    (``depthwise_wgrad_partials``) writes one partial sum per position
    share and the last CTA of each channel block adds the shares in order:
    two runs give identical bits."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        return direct_conv_wgrad_blocked(x, g, hf, wf, stride, padding, z,
                                         activation, with_db,
                                         g.shape[1] * g.shape[4], dilation)
    _, out = depthwise_wgrad_partials(x, g, hf, wf, stride, padding, z,
                                      activation, with_db, dilation)
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
                             dilation=1
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgrad kernel on CUDA operands -> ``(ws, out)``: the f32
    workspace ``[splits, |dw| + |db|]``, each row laid out as ``dw`` then
    ``db``, and ``out [|dw| + |db|]``, its rows summed in split order by
    the last CTA of each channel block."""
    _backward_operands(g, z, activation)
    dev = _cuda_device(x)
    n, cblk, hi, wi, cb = x.shape
    if (g.shape[1], g.shape[4]) != (cblk, cb):
        raise ValueError(f"cotangent blocks {(g.shape[1], g.shape[4])} do not "
                         f"match the input's {(cblk, cb)}")
    spec = backward_spec(n, hi, wi, (cblk, 1, hf, wf, 1, cb), stride,
                         padding, g, z, cblk * cb, dilation)
    ptrs = (_require(x, "x", dev, vector_loads=True),
            _require(g, "g", dev, vector_loads=True),
            _require(z, "z", dev, vector_loads=True))
    if cblk > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: C/Cb={cblk}")
    blk = choose_depthwise_wgrad_blocking(n, cblk, spec.ho, spec.wo, cb, hf,
                                          wf, spec.stride, spec.dilation)
    smem = depthwise_wgrad_smem_bytes(blk.hob, blk.wob, cb, hf, wf,
                                      spec.stride, spec.dilation)
    cols = cblk * hf * wf * cb + (cblk * cb if with_db else 0)
    ws = torch.empty((blk.splits, cols), device=dev, dtype=torch.float32)
    out = torch.empty((cols,), device=dev, dtype=torch.float32)
    stream = _stream(dev)
    lib = _lib()
    err = _call(dev, lib.conv2d_depthwise_wgrad, *ptrs, ws.data_ptr(),
                out.data_ptr(), split_sum.counters(dev, stream, cblk), n,
                cblk, cb, hi, wi, spec.ho, spec.wo, hf, wf, spec.stride,
                *spec.dilation, spec.pads[0][0], spec.pads[1][0], blk.hob,
                blk.wob, blk.splits, _ACT_CODES[activation],
                int(with_db), smem, stream)
    LAUNCHES["conv2d_depthwise_wgrad"] += 1
    _check(err, lib, "conv2d_depthwise_wgrad")
    return ws, out


# ---------------------------------------------------------------------------
# autograd: the reference's custom VJP
# ---------------------------------------------------------------------------

class _Depthwise:
    """The depthwise family's kernels for ``BlockedConvFunction``."""

    @staticmethod
    def preactivation(x, w, bias, spec: ConvSpec) -> torch.Tensor:
        if x.device.type == "cpu":
            return direct_conv_preactivation(x, w, spec.stride, spec.pads,
                                             bias, spec.groups, spec.dilation)
        return _fwd_cuda(x, w, bias, None, spec, None, False)

    @staticmethod
    def dgrad(g, w, spec: ConvSpec, z, activation) -> torch.Tensor:
        return depthwise_dgrad(g, w, (spec.hi, spec.wi), spec.stride,
                               spec.pads, z, activation, spec.dilation)

    @staticmethod
    def wgrad(x, g, spec: ConvSpec, z, activation, with_db: bool):
        return depthwise_wgrad(x, g, spec.hf, spec.wf, spec.stride, spec.pads,
                               z, activation, with_db, spec.dilation)
