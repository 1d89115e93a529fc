"""Wrappers of the CUDA streamed (halo-ring) dense conv kernels.

The port of ``repro/kernels/conv2d_stream.py``: ``stream_forward``
(``_stream_conv_kernel``, ``:78``, launched at ``:238``; here
``stream_fwd_kernel``, the dense forward tile of ``csrc/fwd_tile.cuh`` fed
strip by strip), ``stream_dgrad``
(that kernel's transposed use, ``:284``; here ``stream_dgrad_kernel``, the
phase-split tensor-core tile of ``csrc/dgrad_tile.cuh`` fed strip by
strip) and ``stream_wgrad`` (``_stream_wgrad_kernel``, ``:306``, launched
at ``:384``), all in ``csrc/conv2d_stream.cu``.  They compute the dense
family's functions:

* ``stream_forward``: ``act(conv(x, w) + b) + r``, pooled with ``gap``;
* ``stream_dgrad``: ``dx`` of that conv from the raw cotangent ``g`` and the
  saved pre-activation ``z`` (``dz = g * act'(z)`` formed in the kernel),
  written at the unpadded input's shape;
* ``stream_wgrad``: ``(dw, db)``, the kernel's per-share partial sums added
  in split order by the last CTA of each column of shares
  (``stream_wgrad_kernel``: the
  tensor-core wgrad tile of ``csrc/wgrad_tile.cuh`` walked strip by strip
  down each column, the halo rows kept; the sums, ``csrc/split_sum.cuh``).

Unlike the reference they take the port's **unpadded** operands: pads and
halos are zero-filled copies, and the dgrad reads no stride hole (each
phase takes only the taps it reaches), so no padded, dilated or ``dz``
tensor exists.  Tiles come from the streamed blocking
models (``choose_stream_fwd_blocking``, ``choose_stream_dgrad_blocking``,
``choose_stream_wgrad_blocking``); ``hso`` pins the strip height.  The
forward's launch plan is built once per shape (``fwd_launch``).

The plain versions are the dense family's (``core.direct_conv``), since the
function is the same: a CPU tensor takes them, after the same blocking and
argument checks as a CUDA tensor; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts this module's kernels.  The routing
between these kernels and the window ones lives in
``kernels.direct_conv2d`` and ``core.dispatch``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import (H100_SXM, FwdBlocking, MachineModel,
                                       choose_stream_dgrad_blocking,
                                       choose_stream_fwd_blocking,
                                       choose_stream_wgrad_blocking)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.direct_conv import (backward_spec, conv_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.padding import Padding
from repro_torch.core.precision import F32, resolve_precision
from repro_torch.kernels.direct_conv2d import (FWD_GEOMETRY, WGRAD_GEOMETRY,
                                               _ACT_CODES,
                                               _backward_operands, _check,
                                               _check_activation,
                                               _cuda_device, _library,
                                               check_machine, dgrad_launch,
                                               fwd_launch, fwd_run,
                                               split_wgrad, wgrad_launch)

__all__ = ["LAUNCHES", "reset_launches", "stream_blocking", "stream_forward",
           "stream_dgrad", "stream_wgrad", "stream_wgrad_partials"]

LAUNCHES = {"conv2d_stream_fwd": 0, "conv2d_stream_dgrad": 0,
            "conv2d_stream_wgrad": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.conv2d_stream_conv.argtypes = [ptr] * 8 + [ctypes.POINTER(i32), ptr]
    lib.conv2d_stream_conv.restype = i32
    lib.conv2d_stream_conv_plan.argtypes = [
        ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_stream_conv_plan.restype = i32
    lib.conv2d_stream_dgrad.argtypes = [ptr] * 4 + [i32] * 20 + [
        ptr, ctypes.POINTER(i32)]
    lib.conv2d_stream_dgrad.restype = i32
    lib.conv2d_stream_dgrad_plan.argtypes = [i32] * 19 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_stream_dgrad_plan.restype = i32
    lib.conv2d_stream_wgrad.argtypes = [ptr] * 6 + [i32] * 22 + [ptr]
    lib.conv2d_stream_wgrad.restype = i32
    lib.conv2d_stream_wgrad_plan.argtypes = [i32] * 21 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_stream_wgrad_plan.restype = i32


def _lib() -> ctypes.CDLL:
    return _library("conv2d_stream", _declare, FWD_GEOMETRY,
                    more_geometries=(("conv2d_stream_wgrad_geometry",
                                      WGRAD_GEOMETRY),))


def gap_entry():
    """``(library, its forward's C entry, its LAUNCHES key)``, for
    ``kernels.direct_conv2d.gap_forward``."""
    lib = _lib()
    return lib, lib.conv2d_stream_conv, "conv2d_stream_fwd"


def _prologue(z: Optional[torch.Tensor], activation: Optional[str]) -> bool:
    return z is not None and activation not in (None, "linear")


def stream_blocking(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                    gap: bool, hso: Optional[int],
                    machine: MachineModel) -> FwdBlocking:
    """The streamed forward's tiles for operands ``x``, ``w`` of geometry
    ``spec``; raises what the model raises (a pinned ``hso`` that does not
    divide the rows, a misfit), on either device."""
    check_machine(machine)
    cib, cob = x.shape[4], w.shape[5]
    return choose_stream_fwd_blocking(x.shape[0], spec.ho, spec.wo, spec.hf,
                                      spec.wf, spec.stride, spec.ci // cib,
                                      cib, spec.co // cob, cob, machine, gap,
                                      hso)


def stream_forward(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, stride: int = 1,
                   padding: Padding = "VALID",
                   activation: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None,
                   gap: bool = False, *, hso: Optional[int] = None,
                   machine: MachineModel = H100_SXM,
                   precision=F32) -> torch.Tensor:
    """The streamed forward: x ``[N, Ci/Cib, Hi, Wi, Cib]``, w ``[Co/Cob,
    Ci/Cib, Hf, Wf, Cib, Cob]``, bias ``[Co/Cob, Cob]``, residual at the
    output's shape -> the output map, or with ``gap`` the pooled ``[N,
    Co]`` (the kernel's per-band partial sums, added by the last CTA of
    each image and output block).
    Inference only: the training path enters through
    ``kernels.direct_conv2d.direct_conv2d_blocked``."""
    spec = conv_spec(x, w, stride, padding)
    _check_activation(activation)
    n, coblk, cob = x.shape[0], w.shape[0], w.shape[5]
    if bias is not None and tuple(bias.shape) != (coblk, cob):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(coblk, cob)}")
    out_shape = (n, coblk, spec.ho, spec.wo, cob)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"output shape {out_shape}")
    if x.device.type == "cpu":
        stream_blocking(x, w, spec, gap, hso, machine)
        return direct_conv_blocked(x, w, stride, padding, bias, activation,
                                   precision, residual=residual, gap=gap)
    if resolve_precision(precision).op_dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernels of this slice run the f32 policy only")
    check_machine(machine)
    plan = fwd_launch(spec, x.shape[4], cob, _ACT_CODES[activation], gap,
                      True, hso, machine)
    lib = _lib()
    err, out, _, pooled = fwd_run(lib.conv2d_stream_conv, plan, x, w, bias,
                                  residual, spec)
    LAUNCHES["conv2d_stream_fwd"] += 1
    _check(err, lib, "conv2d_stream_fwd")
    return pooled if gap else out


def stream_dgrad(g: torch.Tensor, w: torch.Tensor,
                 input_hw: Tuple[int, int], stride: int = 1,
                 padding: Padding = "VALID",
                 z: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None, *,
                 hso: Optional[int] = None,
                 machine: MachineModel = H100_SXM) -> torch.Tensor:
    """The streamed input gradient: the raw cotangent ``g [N, Co/Cob, Ho,
    Wo, Cob]``, the saved pre-activation ``z`` (None for a linear
    epilogue) and ``w`` -> ``dx [N, Ci/Cib, Hi, Wi, Cib]`` at the unpadded
    ``input_hw``.  ``stride``/``padding`` are the forward's."""
    _backward_operands(g, z, activation)
    check_machine(machine)
    hi, wi = input_hw
    n, coblk, ho, wo, cob = g.shape
    _, ciblk, hf, wf, cib, _ = w.shape
    spec = backward_spec(n, hi, wi, w.shape, stride, padding, g, z)
    prologue = _prologue(z, activation)
    blk = choose_stream_dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib,
                                       cob, machine, prologue, hso)
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, input_hw, stride, padding, z,
                                         activation)
    lib = _lib()
    err, dx, grids = dgrad_launch(lib.conv2d_stream_dgrad, blk.hso, blk, g,
                                  w, spec, z if prologue else None,
                                  activation)
    LAUNCHES["conv2d_stream_dgrad"] += grids
    _check(err, lib, "conv2d_stream_dgrad")
    return dx


def stream_wgrad(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                 stride: int = 1, padding: Padding = "VALID",
                 z: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 with_db: bool = False, *, hso: Optional[int] = None,
                 machine: MachineModel = H100_SXM):
    """The streamed weight (and bias) gradient: the forward's unpadded input
    ``x``, the raw cotangent ``g`` and the saved pre-activation ``z`` ->
    ``(dw [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob] f32, db [Co/Cob, Cob] f32 or
    None)``.  On CUDA: ``stream_wgrad_partials``, whose last CTA of each
    column adds its shares in order (identical bits run to run)."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z, activation,
                               hso, machine)
        return direct_conv_wgrad_blocked(x, g, hf, wf, stride, padding, z,
                                         activation, with_db)
    _, out = stream_wgrad_partials(x, g, hf, wf, stride, padding, z,
                                   activation, with_db, hso=hso,
                                   machine=machine)
    return split_wgrad(out, x.shape, g.shape, hf, wf, with_db)


def _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z, activation, hso,
                           machine):
    check_machine(machine)
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = g.shape
    spec = backward_spec(n, hi, wi, (coblk, ciblk, hf, wf, cib, cob), stride,
                         padding, g, z)
    blk = choose_stream_wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib,
                                       coblk, cob, machine,
                                       _prologue(z, activation), hso)
    return spec, blk


def stream_wgrad_partials(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                          stride: int = 1, padding: Padding = "VALID",
                          z: Optional[torch.Tensor] = None,
                          activation: Optional[str] = None,
                          with_db: bool = False, *,
                          hso: Optional[int] = None,
                          machine: MachineModel = H100_SXM
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed wgrad kernel on CUDA operands -> ``(ws, out)``: the f32
    workspace ``[splits, |dw| + |db|]`` of per-share partial sums and their
    in-order sum ``[|dw| + |db|]`` that the last CTA of each column of
    shares wrote."""
    _backward_operands(g, z, activation)
    _cuda_device(x)
    spec, blk = _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z,
                                       activation, hso, machine)
    lib = _lib()
    err, ws, out = wgrad_launch(lib.conv2d_stream_wgrad, blk, x, g, hf, wf,
                                spec, z if _prologue(z, activation) else None,
                                activation, with_db)
    LAUNCHES["conv2d_stream_wgrad"] += 1
    _check(err, lib, "conv2d_stream_wgrad")
    return ws, out
