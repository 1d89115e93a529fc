"""Wrappers of the CUDA pointwise (1x1) kernels, and their autograd.

``pointwise_conv2d_blocked`` is the port of the reference's
``pointwise_conv2d_blocked_pallas`` (``repro/kernels/conv2d_pointwise.py:
426``): a 1x1 stride-1 unpadded conv, a channel matmul at every position,
with the fused epilogue (bias, activation, residual, GAP).  Like the
reference it refuses any other geometry.

* Under ``torch.no_grad``/``inference_mode``, or when no operand requires
  grad, it runs the fused inference kernel (``_pw_fwd_kernel``, ``:56``):
  ``csrc/conv2d_pointwise.cu``'s tensor-core tile (``pointwise_tile_kernel``,
  a 3xTF32 wgmma GEMM fed by a producer warpgroup) on a CUDA tensor.  With
  ``gap`` the kernel writes per-tile partial sums and its last CTA of each
  (image, output block) adds them into the pooled features
  (``csrc/split_sum.cuh``).
* With grad mode on and an operand that requires grad it enters
  ``kernels.conv_autograd.BlockedConvFunction``, the counterpart of
  ``_pwconv`` / ``_pwconv_fwd`` / ``_pwconv_bwd`` (``:351-420``), with this
  family's kernels: ``pointwise_dgrad`` (``_pw_dgrad_kernel``, ``:87``:
  the dense dgrad's tensor-core tile at a 1x1 filter, ``csrc/dgrad_tile.cuh``
  through ``direct_conv2d_bwd.cu``'s ``dgrad_kernel``, which timed faster
  than the forward's tile with the weight read transposed; it copies by
  TMA, or by cp.async where Cob is not a multiple of 4) and
  ``pointwise_wgrad`` (``_pw_wgrad_kernel``, ``:114``, whose last CTA of
  each block adds its shares in split order), with the ``dz = g *
  act'(z)`` prologue and ``db``.

A 1x1 stride-1 conv is a dense conv, so the plain versions are the dense
ones of ``core.direct_conv`` at that geometry: the CPU path runs them, and
the tests and ``chip_smoke.py`` hold the kernels against them.

The forward builds its launch plan (tiles, the C entry's int array) once
per shape, and its shape checks are cached by the shapes, as the
depthwise forward's are.

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

from repro_torch.core.blocking import (PW_ROWS, PointwiseBlocking,
                                       choose_dgrad_blocking,
                                       choose_pointwise_blocking,
                                       choose_pointwise_wgrad_blocking,
                                       pointwise_smem_bytes,
                                       pointwise_wgrad_smem_bytes)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.direct_conv import (backward_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_preactivation,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.padding import Padding, normalize_padding
from repro_torch.core.precision import F32, resolve_precision
from repro_torch.kernels.direct_conv2d import (_ACT_CODES, _GRID_YZ_MAX,
                                               _backward_operands,
                                               _by_shapes, _call, _check,
                                               _check_activation,
                                               _cuda_device, _library, _ptr,
                                               _bwd_lib, _require,
                                               _stream, dgrad_launch)
from repro_torch.kernels import split_sum
from repro_torch.kernels.conv_autograd import BlockedConvFunction

__all__ = ["LAUNCHES", "reset_launches", "pointwise_conv2d_blocked",
           "pointwise_gap", "pointwise_dgrad", "pointwise_wgrad",
           "pointwise_wgrad_partials"]

LAUNCHES = {"conv2d_pointwise_fwd": 0, "conv2d_pointwise_dgrad": 0,
            "conv2d_pointwise_wgrad": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.conv2d_pointwise_tile.argtypes = [ptr] * 8 + [ctypes.POINTER(i32),
                                                      ptr]
    lib.conv2d_pointwise_tile.restype = i32
    lib.conv2d_pointwise_wgrad.argtypes = [ptr] * 6 + [i32] * 11 + [ptr]
    lib.conv2d_pointwise_wgrad.restype = i32


def _lib() -> ctypes.CDLL:
    # the compiled geometry: the wgrad's threads and lanes a thread, the
    # tile's m-tile rows
    return _library("conv2d_pointwise", _declare, (256, 8, PW_ROWS))


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
    anything else raises, as the reference's entry point does.
    """
    _forward_checks(x.shape, w.shape, stride, padding,
                    None if bias is None else bias.shape,
                    None if residual is None else residual.shape, activation)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, residual)):
        if resolve_precision(precision).op_dtype != torch.float32:
            raise NotImplementedError(
                "the training path runs the f32 policy only")
        n, ciblk, h, wd, cib = x.shape
        spec = ConvSpec.make(n, h, wd, ciblk * cib, w.shape[0] * w.shape[5],
                             1, 1)
        return BlockedConvFunction.apply(x, w, bias, residual, _Pointwise,
                                         spec, activation, gap)
    if x.device.type == "cpu":
        return direct_conv_blocked(x, w, 1, "VALID", bias, activation,
                                   precision, residual=residual, gap=gap)
    if resolve_precision(precision).op_dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernel of this slice runs the f32 policy only")
    return _fwd_cuda(x, w, bias, residual, activation, gap)


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
               blk: Optional[PointwiseBlocking] = None) -> _TilePlan:
    """The plan of a tile launch: ``blk``, or the chooser's tiles."""
    if blk is None:
        blk = choose_pointwise_blocking(n, hw, kblk, kw, oblk, ow, gap=gap)
    smem = pointwise_smem_bytes(blk.rows, blk.chunk, blk.lanes, blk.wgs, gap)
    ints = (kblk, kw, oblk, ow, hw, blk.rows, blk.nsplit, blk.chunk, act,
            int(gap), blk.lanes, blk.wgs, blk.tiles, n, smem)
    return _TilePlan(blk=blk, ints=(ctypes.c_int * len(ints))(*ints))


def tile_launch(plan: _TilePlan, dev: torch.device, ptrs, out: torch.Tensor,
                partials: Optional[torch.Tensor] = None,
                pooled: Optional[torch.Tensor] = None) -> int:
    """Launch the tile of ``plan`` on checked operand pointers ``(x, w,
    bias, residual)`` into ``out`` (with GAP, the tiles' sums into
    ``partials`` and the pooled features into ``pooled``) -> the CUDA error
    code; the caller counts the launch."""
    stream = _stream(dev)
    # the GAP's columns: one an (image, output block)
    counters = (split_sum.counters(dev, stream, out.shape[0] * out.shape[1])
                if pooled is not None else None)
    return _call(dev, _lib().conv2d_pointwise_tile, *ptrs, out.data_ptr(),
                 _ptr(partials), _ptr(pooled), counters, plan.ints, stream)


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              residual: Optional[torch.Tensor], activation: Optional[str],
              gap: bool) -> torch.Tensor:
    """Launch the tile forward on CUDA operands -> the output map, or with
    ``gap`` the pooled ``[N, Co]``."""
    out, pooled, _ = _launch_cuda(x, w, bias, residual, activation, gap)
    return pooled if gap else out


def pointwise_gap(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the tile forward with the GAP rider on CUDA operands
    -> ``(pooled [N, Co], partials [N, Co/Cob, tiles, Cob])``: the per-tile
    sums the kernel wrote and the pooled features the last CTA of each
    image and output block summed from them."""
    _forward_checks(x.shape, w.shape, 1, "VALID",
                    None if bias is None else bias.shape,
                    None if residual is None else residual.shape, activation)
    _, pooled, partials = _launch_cuda(x, w, bias, residual, activation, True)
    return pooled, partials


def _launch_cuda(x, w, bias, residual, activation, gap):
    """Launch the tile forward on CUDA operands, each checked and read
    once, the shape's plan from ``_tile_plan`` -> ``(out, pooled or None,
    partials or None)``."""
    dev = _cuda_device(x)
    ptrs = (_require(x, "x", dev, vector_loads=True),
            _require(w, "w", dev, vector_loads=True),
            _require(bias, "bias", dev),
            _require(residual, "residual", dev))
    n, ciblk, h, wd, cib = x.shape
    coblk, cob = w.shape[0], w.shape[5]
    if coblk > _GRID_YZ_MAX // 2 or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Co/Cob={coblk}, N={n}")
    hw = h * wd
    plan = _tile_plan(n, hw, ciblk, cib, coblk, cob, _ACT_CODES[activation],
                      gap)
    out = torch.empty((n, coblk, h, wd, cob), device=dev, dtype=torch.float32)
    partials = pooled = None
    if gap:
        partials = torch.empty((n, coblk, plan.blk.tiles, cob), device=dev,
                               dtype=torch.float32)
        pooled = torch.empty((n, coblk * cob), device=dev,
                             dtype=torch.float32)
    err = tile_launch(plan, dev, ptrs, out, partials, pooled)
    LAUNCHES["conv2d_pointwise_fwd"] += 1
    _check(err, _lib(), "conv2d_pointwise_fwd")
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
                    activation: Optional[str] = None) -> torch.Tensor:
    """Input gradient of ``act(x @ w + b)``: the raw cotangent ``g [N,
    Co/Cob, H, W, Cob]``, the saved pre-activation ``z`` (None for a
    linear epilogue) and ``w`` -> ``dx [N, Ci/Cib, H, W, Cib]``, with ``dz
    = g * act'(z)`` formed as ``g`` is staged.  On CUDA it is the dense
    dgrad kernel at a 1x1 filter, with the tiles its chooser takes (any
    Cob: TMA copies, or cp.async where Cob is not a multiple of 4)."""
    _backward_operands(g, z, activation)
    _check_backward(g, w, z)
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, g.shape[2:4], 1, "VALID", z,
                                         activation)
    _cuda_device(g)
    n, _, h, wd, cob = g.shape
    ciblk, cib = w.shape[1], w.shape[4]
    prologue = z is not None and activation not in (None, "linear")
    spec = backward_spec(n, h, wd, w.shape, 1, "VALID", g, z)
    blk = choose_dgrad_blocking(n, h, wd, 1, 1, 1, ciblk, cib, cob,
                                prologue=prologue)
    err, dx, grids = dgrad_launch(_bwd_lib().direct_conv2d_dgrad, blk.th,
                                  blk, g, w, spec,
                                  z if prologue else None, activation)
    LAUNCHES["conv2d_pointwise_dgrad"] += grids
    _check(err, _bwd_lib(), "conv2d_pointwise_dgrad")
    return dx


def pointwise_wgrad(x: torch.Tensor, g: torch.Tensor,
                    z: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None,
                    with_db: bool = False):
    """Weight (and bias) gradient of ``act(x @ w + b)`` -> ``(dw [Co/Cob,
    Ci/Cib, 1, 1, Cib, Cob] f32, db [Co/Cob, Cob] f32 or None)``.  On CUDA
    the wgrad kernel (``pointwise_wgrad_partials``) writes one partial sum
    per position share and the last CTA of each block adds the shares in
    order: two runs give identical bits."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        _check_wgrad(x, g, z)
        return direct_conv_wgrad_blocked(x, g, 1, 1, 1, "VALID", z,
                                         activation, with_db)
    _, out = pointwise_wgrad_partials(x, g, z, activation, with_db)
    ciblk, cib, coblk, cob = x.shape[1], x.shape[4], g.shape[1], g.shape[4]
    dw_size = coblk * ciblk * cib * cob
    dw = out[:dw_size].view(coblk, ciblk, 1, 1, cib, cob)
    db = out[dw_size:].view(coblk, cob) if with_db else None
    return dw, db


def _check_wgrad(x: torch.Tensor, g: torch.Tensor,
                 z: Optional[torch.Tensor]) -> None:
    if x.dim() != 5 or (x.shape[0], x.shape[2], x.shape[3]) != (
            g.shape[0], g.shape[2], g.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and the cotangent "
                         f"{tuple(g.shape)} must share N, H and W")
    if z is not None and z.shape != g.shape:
        raise ValueError(f"pre-activation shape {tuple(z.shape)} != "
                         f"{tuple(g.shape)}")


def pointwise_wgrad_partials(x: torch.Tensor, g: torch.Tensor,
                             z: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None,
                             with_db: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgrad kernel on CUDA operands -> ``(ws, out)``: the f32
    workspace ``[splits, |dw| + |db|]``, each row laid out as ``dw`` then
    ``db``, and ``out [|dw| + |db|]``, its rows summed in split order by
    the last CTA of each block."""
    _backward_operands(g, z, activation)
    _check_wgrad(x, g, z)
    dev = _cuda_device(x)
    ptrs = (_require(x, "x", dev, vector_loads=True),
            _require(g, "g", dev, vector_loads=True),
            _require(z, "z", dev, vector_loads=True))
    n, ciblk, h, wd, cib = x.shape
    coblk, cob = g.shape[1], g.shape[4]
    if ciblk > _GRID_YZ_MAX or coblk > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Ci/Cib={ciblk}, Co/Cob={coblk}")
    hw = h * wd
    blk = choose_pointwise_wgrad_blocking(n, hw, ciblk, cib, coblk, cob)
    smem = pointwise_wgrad_smem_bytes(blk.positions, cib, cob, blk.pgroups)
    cols = coblk * ciblk * cib * cob + (coblk * cob if with_db else 0)
    ws = torch.empty((blk.splits, cols), device=dev, dtype=torch.float32)
    out = torch.empty((cols,), device=dev, dtype=torch.float32)
    stream = _stream(dev)
    columns = ciblk * coblk
    lib = _lib()
    err = _call(dev, lib.conv2d_pointwise_wgrad, *ptrs, ws.data_ptr(),
                out.data_ptr(), split_sum.counters(dev, stream, columns), n,
                ciblk, cib, coblk, cob, hw, blk.positions, blk.splits,
                _ACT_CODES[activation], int(with_db), smem, stream)
    LAUNCHES["conv2d_pointwise_wgrad"] += 1
    _check(err, lib, "conv2d_pointwise_wgrad")
    return ws, out


# ---------------------------------------------------------------------------
# autograd: the reference's custom VJP
# ---------------------------------------------------------------------------

class _Pointwise:
    """The pointwise family's kernels for ``BlockedConvFunction``."""

    @staticmethod
    def preactivation(x, w, bias, spec: ConvSpec) -> torch.Tensor:
        if x.device.type == "cpu":
            return direct_conv_preactivation(x, w, 1, "VALID", bias)
        return _fwd_cuda(x, w, bias, None, None, False)

    @staticmethod
    def dgrad(g, w, spec: ConvSpec, z, activation) -> torch.Tensor:
        return pointwise_dgrad(g, w, z, activation)

    @staticmethod
    def wgrad(x, g, spec: ConvSpec, z, activation, with_db: bool):
        return pointwise_wgrad(x, g, z, activation, with_db)
