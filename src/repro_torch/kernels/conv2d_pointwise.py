"""Wrappers of the CUDA pointwise (1x1) kernels, and their autograd.

``pointwise_conv2d_blocked`` is the port of the reference's
``pointwise_conv2d_blocked_pallas`` (``repro/kernels/conv2d_pointwise.py:
426``): a 1x1 stride-1 unpadded conv, a channel matmul at every position,
with the fused epilogue (bias, activation, residual, GAP).  Like the
reference it refuses any other geometry.

* Under ``torch.no_grad``/``inference_mode``, or when no operand requires
  grad, it runs the fused inference kernel (``_pw_fwd_kernel``, ``:56``):
  ``csrc/conv2d_pointwise.cu``'s tensor-core tile (``pointwise_tile_kernel``,
  a 3xTF32 wgmma GEMM fed by a producer warpgroup), or under the ``BF16``
  policy its bf16 build (``pointwise_tile_kernel_bf16``: bf16 wgmma from
  shared memory landed by TMA, f32 sums, bf16 out, a persistent grid over
  items of rows that may span images; x, the f32 master weights and the
  residual cast to bf16 once a call, as the reference's ``_pwconv`` casts
  them), on a CUDA tensor.  With ``gap`` the kernel writes per-tile (bf16:
  per item and image) partial sums and the last arrival of each (image,
  output block) adds them into the pooled features
  (``csrc/split_sum.cuh``).
* With grad mode on and an operand that requires grad it enters
  ``kernels.conv_autograd.BlockedConvFunction``, the counterpart of
  ``_pwconv`` / ``_pwconv_fwd`` / ``_pwconv_bwd`` (``:351-420``), with this
  family's kernels: ``pointwise_dgrad`` (``_pw_dgrad_kernel``, ``:87``:
  the dense dgrad's tensor-core tile at a 1x1 filter, ``csrc/dgrad_tile.cuh``
  through ``direct_conv2d_bwd.cu``'s ``dgrad_kernel``, which timed faster
  than the forward's tile with the weight read transposed; it copies by
  TMA, or by cp.async where Cob is not a multiple of 4) and
  ``pointwise_wgrad`` (``_pw_wgrad_kernel``, ``:114``: the dense wgrad's
  tensor-core tile at a 1x1 filter, ``csrc/wgrad_tile.cuh`` through
  ``direct_conv2d_bwd.cu``'s ``wgrad_kernel``, whose last CTA of each
  column adds its shares in split order), with the ``dz = g * act'(z)``
  prologue and ``db``.  The training path runs the f32 policy or ``BF16``
  (``direct_conv2d.training_policy``): under ``BF16`` the forward's bf16
  build with a linear epilogue gives the bf16 ``z``, and the dense tiles'
  bf16 builds (``dgrad_kernel_bf16``, ``wgrad_kernel_bf16``) at 1x1 the
  bf16 ``dx`` and the f32 ``dw`` and ``db``.  A float16 policy raises: no
  build reads it.

A 1x1 stride-1 conv is a dense conv, so the plain versions are the dense
ones of ``core.direct_conv`` at that geometry: the CPU path runs them, and
the tests and ``chip_smoke.py`` hold the kernels against them.

The forward builds its launch plan (tiles, the C entry's int array) and
the wgrad its tiles once per shape, and the forward's shape checks are
cached by the shapes, as the depthwise forward's are.

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

from repro_torch.core.blocking import (H100_SXM, PW_CONSUMERS, PW_ROWS,
                                       PointwiseBlocking, PointwisePlan,
                                       choose_dgrad_blocking,
                                       choose_pointwise_blocking,
                                       choose_wgrad_blocking,
                                       pointwise_plan, pointwise_plan_ints,
                                       pointwise_smem_bytes)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.direct_conv import (backward_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_preactivation,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.padding import Padding, normalize_padding
from repro_torch.core.precision import BF16, F32, Precision
from repro_torch.kernels.direct_conv2d import (_ACT_CODES, _GRID_YZ_MAX,
                                               _backward_operands,
                                               _by_shapes, _call, _check,
                                               _check_activation,
                                               _cuda_device, _library, _ptr,
                                               _bwd_lib, _require, _stream,
                                               _suffix, bf16_operands,
                                               bf16_wgrad, build_dtype,
                                               cotangent_pass, dgrad_launch,
                                               plain_policy, split_wgrad,
                                               training_policy, wgrad_launch,
                                               wgrad_launch_plan,
                                               WgradLaunch)
from repro_torch.kernels import split_sum
from repro_torch.kernels.conv_autograd import BlockedConvFunction

__all__ = ["LAUNCHES", "reset_launches", "pointwise_conv2d_blocked",
           "pointwise_gap", "pointwise_dgrad", "pointwise_wgrad",
           "pointwise_wgrad_partials", "pointwise_plans"]

LAUNCHES = {"conv2d_pointwise_fwd": 0, "conv2d_pointwise_fwd_bf16": 0,
            "conv2d_pointwise_dgrad": 0, "conv2d_pointwise_dgrad_bf16": 0,
            "conv2d_pointwise_wgrad": 0, "conv2d_pointwise_wgrad_bf16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    for build in ("", "_bf16"):
        entry = getattr(lib, f"conv2d_pointwise_tile{build}")
        entry.argtypes = [ptr] * 8 + [ctypes.POINTER(i32), ptr]
        entry.restype = i32
    lib.conv2d_pointwise_plan_bf16.argtypes = [
        ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_pointwise_plan_bf16.restype = i32


def _lib() -> ctypes.CDLL:
    # the compiled geometry: the tile's largest CTA, its consumer
    # warpgroups and the rows of an m-tile
    return _library("conv2d_pointwise", _declare,
                    (128 * (PW_CONSUMERS + 1), PW_CONSUMERS, PW_ROWS))


def _check_operands(x_shape, w_shape) -> None:
    """x ``[N, Ci/Cib, H, W, Cib]`` and a 1x1 weight ``[Co/Cob, Ci/Cib, 1,
    1, Cib, Cob]`` that chains with it."""
    if len(x_shape) != 5 or len(w_shape) != 6:
        raise ValueError(f"expected x [N, Ci/Cib, H, W, Cib] and w [Co/Cob, "
                         f"Ci/Cib, 1, 1, Cib, Cob]; got {tuple(x_shape)}, "
                         f"{tuple(w_shape)}")
    if tuple(w_shape[2:4]) != (1, 1):
        raise ValueError(f"pointwise kernel needs a 1x1 filter, got "
                         f"{w_shape[2]}x{w_shape[3]}")
    if (w_shape[1], w_shape[4]) != (x_shape[1], x_shape[4]):
        raise ValueError(f"weight input blocks {(w_shape[1], w_shape[4])} do "
                         f"not match the map's {(x_shape[1], x_shape[4])}")


@_by_shapes
def _forward_checks(x_shape, w_shape, stride, padding, b_shape, r_shape,
                    activation) -> None:
    """The forward's checks of its operands' shapes, its geometry and the
    activation."""
    _check_operands(x_shape, w_shape)
    pads = normalize_padding(padding, 1, 1, stride, x_shape[2], x_shape[3])
    if stride != 1 or pads != ((0, 0), (0, 0)):
        raise ValueError(
            f"pointwise fast path serves stride=1, zero-pad only; got "
            f"stride={stride}, padding={padding!r}: route the direct conv "
            "instead")
    _check_activation(activation)
    n, _, h, wd, _ = x_shape
    coblk, cob = w_shape[0], w_shape[5]
    if b_shape is not None and tuple(b_shape) != (coblk, cob):
        raise ValueError(f"bias shape {tuple(b_shape)} != {(coblk, cob)}")
    if r_shape is not None and tuple(r_shape) != (n, coblk, h, wd, cob):
        raise ValueError(f"residual shape {tuple(r_shape)} != output "
                         f"shape {(n, coblk, h, wd, cob)}")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def pointwise_conv2d_blocked(x: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             stride: int = 1, padding: Padding = "VALID",
                             activation: Optional[str] = None,
                             residual: Optional[torch.Tensor] = None,
                             gap: bool = False,
                             precision=F32) -> torch.Tensor:
    """Fused 1x1-as-matmul blocked conv, differentiable.

    x: ``[N, Ci/Cib, H, W, Cib]``; w: ``[Co/Cob, Ci/Cib, 1, 1, Cib, Cob]``;
    bias: ``[Co/Cob, Cob]`` or None; residual: the output's shape or None,
    added after the activation -> ``[N, Co/Cob, H, W, Cob]``, or with
    ``gap=True`` the pooled ``[N, Co]`` features.  Only pointwise geometry
    is served, stride 1 and zero pads (SAME on a 1x1 filter is zero pads);
    anything else raises, as the reference's entry point does.  Under
    ``BF16`` the output (and the pooled features) are bf16.
    """
    _forward_checks(x.shape, w.shape, stride, padding,
                    None if bias is None else bias.shape,
                    None if residual is None else residual.shape, activation)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, residual)):
        policy = training_policy(precision)
        n, ciblk, h, wd, cib = x.shape
        spec = ConvSpec.make(n, h, wd, ciblk * cib, w.shape[0] * w.shape[5],
                             1, 1)
        return BlockedConvFunction.apply(x, w, bias, residual,
                                         _Pointwise(policy), spec,
                                         activation, gap, policy)
    if x.device.type == "cpu":
        return direct_conv_blocked(x, w, 1, "VALID", bias, activation,
                                   precision, residual=residual, gap=gap)
    return _fwd_cuda(x, w, bias, residual, activation, gap,
                     build_dtype(precision))


@dataclasses.dataclass(frozen=True)
class _TilePlan:
    """What a tile launch at one shape needs but its pointers, stream and
    library, built once (``_tile_plan``): the tiles and the C entry's int
    array."""
    blk: PointwiseBlocking
    ints: object


@functools.lru_cache(maxsize=1024)
def _tile_plan(n: int, hw: int, kblk: int, kw: int, oblk: int, ow: int,
               act: int, gap: bool,
               blk: Optional[PointwiseBlocking] = None,
               op_bytes: int = 4) -> _TilePlan:
    """The plan of a tile launch by the build for ``op_bytes`` operands
    (4: f32, 2: bf16, ``core.blocking.pointwise_plan_ints``): ``blk``, or
    the chooser's tiles."""
    if blk is None:
        blk = choose_pointwise_blocking(n, hw, kblk, kw, oblk, ow, gap=gap,
                                        op_bytes=op_bytes)
    if op_bytes == 2:
        ints = pointwise_plan_ints(blk, n, hw, kblk, kw, oblk, ow, act, gap)
    else:
        smem = pointwise_smem_bytes(blk.rows, blk.chunk, blk.lanes, blk.wgs,
                                    gap, op_bytes)
        ints = (kblk, kw, oblk, ow, hw, blk.rows, blk.nsplit, blk.chunk, act,
                int(gap), blk.lanes, blk.wgs, blk.tiles, n, smem)
    return _TilePlan(blk=blk, ints=(ctypes.c_int * len(ints))(*ints))


def pointwise_plans(x: torch.Tensor, w: torch.Tensor, gap: bool = False,
                    activation: Optional[str] = None
                    ) -> Tuple[PointwisePlan, PointwisePlan]:
    """What one launch of the bf16 build runs on these operands' shapes,
    tiled as its wrapper tiles them: ``(the kernel library's own count, its
    conv2d_pointwise_plan_bf16 entry; core.blocking.pointwise_plan's)``.
    Reads the built library; launches nothing."""
    n, kblk, h, wd, kw = x.shape
    oblk, ow = w.shape[0], w.shape[5]
    plan = _tile_plan(n, h * wd, kblk, kw, oblk, ow, _ACT_CODES[activation],
                      gap, op_bytes=2)
    out = (ctypes.c_longlong * 6)()
    if _lib().conv2d_pointwise_plan_bf16(plan.ints, out):
        raise ValueError(f"the bf16 tile refuses the tiles {plan.blk}")
    return (PointwisePlan(*out),
            pointwise_plan(plan.blk, n, h * wd, kblk, kw, oblk, ow, gap))


def tile_launch(plan: _TilePlan, dev: torch.device, ptrs, out: torch.Tensor,
                partials: Optional[torch.Tensor] = None,
                pooled: Optional[torch.Tensor] = None) -> int:
    """Launch the tile of ``plan`` on checked operand pointers ``(x, w,
    bias, residual)`` into ``out`` (with GAP, the tiles' sums into
    ``partials`` and the pooled features into ``pooled``), by the build of
    ``out``'s dtype (f32, or bf16: ``pointwise_tile_kernel_bf16``) -> the
    CUDA error code; the caller counts the launch."""
    stream = _stream(dev)
    # the GAP's columns: one an (image, output block)
    counters = (split_sum.counters(dev, stream, out.shape[0] * out.shape[1])
                if pooled is not None else None)
    entry = getattr(_lib(), "conv2d_pointwise_tile" + _suffix(out.dtype))
    return _call(dev, entry, *ptrs, out.data_ptr(), _ptr(partials),
                 _ptr(pooled), counters, plan.ints, stream)


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              residual: Optional[torch.Tensor], activation: Optional[str],
              gap: bool, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the tile forward's build for ``dtype`` operands on CUDA
    operands -> the output map, or with ``gap`` the pooled ``[N, Co]``."""
    out, pooled, _ = _launch_cuda(x, w, bias, residual, activation, gap,
                                  dtype)
    return pooled if gap else out


def pointwise_gap(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None, precision=F32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the tile forward (under ``BF16`` its bf16 build) with
    the GAP rider on CUDA operands -> ``(pooled [N, Co], partials [N,
    Co/Cob, tiles, Cob])``: the per-tile f32 sums the kernel wrote (the
    bf16 build's: an image's per-item sums in its slots, unused slots 0) and
    the pooled features the last arrival of each image and output block
    summed from them."""
    _forward_checks(x.shape, w.shape, 1, "VALID",
                    None if bias is None else bias.shape,
                    None if residual is None else residual.shape, activation)
    _, pooled, partials = _launch_cuda(x, w, bias, residual, activation, True,
                                       build_dtype(precision))
    return pooled, partials


def _launch_cuda(x, w, bias, residual, activation, gap,
                 dtype: torch.dtype = torch.float32):
    """Launch the tile forward's build for ``dtype`` on CUDA operands
    (cast to bf16 by ``bf16_operands`` for the bf16 build), each checked
    and read once, the shape's plan from ``_tile_plan`` -> ``(out, pooled
    or None, partials or None)``: out and pooled at ``dtype``, the partials
    f32."""
    dev = _cuda_device(x)
    if dtype == torch.bfloat16:
        x, w, bias, residual = bf16_operands(x, w, bias, residual)
    ptrs = (_require(x, "x", dev, vector_loads=True, dtype=dtype),
            _require(w, "w", dev, vector_loads=True, dtype=dtype),
            _require(bias, "bias", dev),
            _require(residual, "residual", dev, dtype=dtype))
    n, ciblk, h, wd, cib = x.shape
    coblk, cob = w.shape[0], w.shape[5]
    if coblk > _GRID_YZ_MAX // 2 or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Co/Cob={coblk}, N={n}")
    hw = h * wd
    plan = _tile_plan(n, hw, ciblk, cib, coblk, cob, _ACT_CODES[activation],
                      gap, op_bytes=dtype.itemsize)
    out = torch.empty((n, coblk, h, wd, cob), device=dev, dtype=dtype)
    partials = pooled = None
    if gap:
        partials = torch.empty((n, coblk, plan.blk.tiles, cob), device=dev,
                               dtype=torch.float32)
        pooled = torch.empty((n, coblk * cob), device=dev, dtype=dtype)
    err = tile_launch(plan, dev, ptrs, out, partials, pooled)
    name = "conv2d_pointwise_fwd" + _suffix(dtype)
    LAUNCHES[name] += 1
    _check(err, _lib(), name)
    return out, pooled, partials


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _check_backward(g: torch.Tensor, w: torch.Tensor,
                    z: Optional[torch.Tensor]) -> None:
    if w.dim() != 6 or w.shape[2:4] != (1, 1):
        raise ValueError(f"expected a 1x1 weight [Co/Cob, Ci/Cib, 1, 1, Cib, "
                         f"Cob], got {tuple(w.shape)}")
    if (g.shape[1], g.shape[4]) != (w.shape[0], w.shape[5]):
        raise ValueError(f"cotangent blocks {(g.shape[1], g.shape[4])} do not "
                         f"match the weight's {(w.shape[0], w.shape[5])}")
    if z is not None and z.shape != g.shape:
        raise ValueError(f"pre-activation shape {tuple(z.shape)} != "
                         f"{tuple(g.shape)}")


def pointwise_dgrad(g: torch.Tensor, w: torch.Tensor,
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    precision=F32,
                    prologue_tiles: Optional[bool] = None) -> torch.Tensor:
    """Input gradient of ``act(x @ w + b)``: the raw cotangent ``g [N,
    Co/Cob, H, W, Cob]``, the saved pre-activation ``z`` (None for a
    linear epilogue) and ``w`` -> ``dx [N, Ci/Cib, H, W, Cib]``, with ``dz
    = g * act'(z)`` formed as ``g`` is staged.  On CUDA it is the dense
    dgrad kernel at a 1x1 filter, with the tiles its chooser takes (any
    Cob: TMA copies, or cp.async where Cob is not a multiple of 4, 8 in
    bf16); under ``BF16`` its bf16 build (``dgrad_kernel_bf16``) on ``g``,
    ``z`` and ``w`` cast to bf16, dx bf16; on the CPU the plain version on
    the same bf16 operands.  ``prologue_tiles`` as
    ``direct_conv2d.direct_conv2d_dgrad``'s."""
    _backward_operands(g, z, activation)
    _check_backward(g, w, z)
    dtype = build_dtype(precision)
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, g.shape[2:4], 1, "VALID", z,
                                         activation,
                                         precision=plain_policy(dtype))
    _cuda_device(g)
    n, _, h, wd, cob = g.shape
    ciblk, cib = w.shape[1], w.shape[4]
    prologue = z is not None and activation not in (None, "linear")
    spec = backward_spec(n, h, wd, w.shape, 1, "VALID", g, z)
    blk = choose_dgrad_blocking(
        n, h, wd, 1, 1, 1, ciblk, cib, cob,
        prologue=prologue if prologue_tiles is None else prologue_tiles,
        op_bytes=dtype.itemsize)
    lib = _bwd_lib()
    err, dx, grids = dgrad_launch(
        getattr(lib, "direct_conv2d_dgrad" + _suffix(dtype)), blk.th, blk,
        g, w, spec, z if prologue else None, activation, dtype)
    name = "conv2d_pointwise_dgrad" + _suffix(dtype)
    LAUNCHES[name] += grids
    _check(err, lib, name)
    return dx


def pointwise_wgrad(x: torch.Tensor, g: torch.Tensor,
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    with_db: bool = False, precision=F32):
    """Weight (and bias) gradient of ``act(x @ w + b)`` -> ``(dw [Co/Cob,
    Ci/Cib, 1, 1, Cib, Cob] f32, db [Co/Cob, Cob] f32 or None)``.  On CUDA
    the dense wgrad's tensor-core tile at a 1x1 filter
    (``pointwise_wgrad_partials``; under ``BF16`` its bf16 build on ``x``,
    ``g`` and ``z`` cast to bf16, dw and db still f32) writes one partial
    sum per position share and the last CTA of each column adds the shares
    in order: two runs give identical bits."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        _check_wgrad(x, g, z)
        return direct_conv_wgrad_blocked(
            x, g, 1, 1, 1, "VALID", z, activation, with_db,
            precision=plain_policy(build_dtype(precision)))
    _, out = pointwise_wgrad_partials(x, g, z, activation, with_db,
                                      precision)
    return split_wgrad(out, x.shape, g.shape, 1, 1, with_db)


def _check_wgrad(x: torch.Tensor, g: torch.Tensor,
                 z: Optional[torch.Tensor]) -> None:
    if x.dim() != 5 or (x.shape[0], x.shape[2], x.shape[3]) != (
            g.shape[0], g.shape[2], g.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and the cotangent "
                         f"{tuple(g.shape)} must share N, H and W")
    if z is not None and z.shape != g.shape:
        raise ValueError(f"pre-activation shape {tuple(z.shape)} != "
                         f"{tuple(g.shape)}")


@functools.lru_cache(maxsize=1024)
def _wgrad_plan(x_shape, g_shape, act: int, prologue: bool,
                with_db: bool, op_bytes: int = 4) -> WgradLaunch:
    """The plan of a wgrad launch at one shape: the dense wgrad tile's
    chooser at a 1x1 filter, stride 1, no pads, for ``op_bytes`` operands
    (2: the bf16 build)."""
    n, ciblk, h, wd, cib = x_shape
    coblk, cob = g_shape[1], g_shape[4]
    blk = choose_wgrad_blocking(n, h, wd, 1, 1, 1, ciblk, cib, coblk, cob,
                                prologue=prologue, op_bytes=op_bytes)
    spec = ConvSpec.make(n, h, wd, ciblk * cib, coblk * cob, 1, 1)
    return wgrad_launch_plan(blk, x_shape, g_shape, 1, 1, spec, act,
                             with_db)


def pointwise_wgrad_partials(x: torch.Tensor, g: torch.Tensor,
                             z: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None,
                             with_db: bool = False, precision=F32
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgrad on CUDA operands, the dense wgrad tile at a 1x1 filter
    (``csrc/wgrad_tile.cuh`` through ``direct_conv2d_bwd.cu``'s
    ``wgrad_kernel``, under ``BF16`` ``wgrad_kernel_bf16``; its rows are
    the Cib channels) -> ``(ws, out)``: the f32 workspace ``[splits, |dw| +
    |db|]``, each row laid out as ``dw`` then ``db``, and ``out [|dw| +
    |db|]``, its rows summed in split order by the last CTA of each
    column."""
    _backward_operands(g, z, activation)
    _check_wgrad(x, g, z)
    dtype = build_dtype(precision)
    prologue = z is not None and activation not in (None, "linear")
    lib = _bwd_lib()
    name = "conv2d_pointwise_wgrad" + _suffix(dtype)
    if dtype == torch.bfloat16:
        n, ciblk, h, wd, cib = x.shape
        coblk, cob = g.shape[1], g.shape[4]
        blk = choose_wgrad_blocking(n, h, wd, 1, 1, 1, ciblk, cib, coblk,
                                    cob, op_bytes=2)
        spec = ConvSpec.make(n, h, wd, ciblk * cib, coblk * cob, 1, 1)
        return bf16_wgrad(getattr(lib, "direct_conv2d_wgrad_bf16"), blk, x,
                          g, spec, z, activation, with_db, H100_SXM,
                          LAUNCHES, name, lib)
    plan = _wgrad_plan(x.shape, g.shape, _ACT_CODES[activation], prologue,
                       with_db, dtype.itemsize)
    err, ws, out = wgrad_launch(
        getattr(lib, "direct_conv2d_wgrad" + _suffix(dtype)), plan, x, g,
        z if prologue else None, dtype)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return ws, out


# ---------------------------------------------------------------------------
# autograd: the reference's custom VJP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Pointwise:
    """The pointwise family's kernels for ``BlockedConvFunction``, in the
    builds of ``policy`` (F32, or ``BF16``: the forward's bf16 build with a
    linear epilogue gives the bf16 ``z``, the dz pass dz and db, the dense
    dgrad's and wgrad's bf16 builds on dz at 1x1 the gradients)."""
    policy: Precision = F32

    def preactivation(self, x, w, bias, spec: ConvSpec) -> torch.Tensor:
        if x.device.type == "cpu":
            return direct_conv_preactivation(
                x, w, 1, "VALID", bias,
                precision=self.policy if self.policy == BF16 else None)
        return _fwd_cuda(x, w, bias, None, None, False,
                         build_dtype(self.policy))

    def dgrad(self, g, w, spec: ConvSpec, z, activation,
              prologue_tiles: Optional[bool] = None) -> torch.Tensor:
        return pointwise_dgrad(g, w, z, activation, self.policy,
                               prologue_tiles)

    def wgrad(self, x, g, spec: ConvSpec, z, activation, with_db: bool):
        return pointwise_wgrad(x, g, z, activation, with_db, self.policy)

    def cotangent(self, g, z, activation, with_db: bool):
        return cotangent_pass(g, z, activation, with_db)
