"""Wrappers of the CUDA streamed (halo-ring) dense conv kernels.

The port of ``repro/kernels/conv2d_stream.py``: ``stream_forward``
(``_stream_conv_kernel``, ``:78``, launched at ``:238``), ``stream_dgrad``
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
  in split order by the dense family's ``wgrad_reduce``
  (``stream_wgrad_kernel``: the tensor-core wgrad tile of
  ``csrc/wgrad_tile.cuh`` walked strip by strip down each column, the halo
  rows kept).

Unlike the reference they take the port's **unpadded** operands: pads and
halos are zero-filled copies, and the dgrad reads no stride hole (each
phase takes only the taps it reaches), so no padded, dilated or ``dz``
tensor exists.  Tiles come from the streamed blocking
models (``choose_stream_blocking``, ``choose_stream_dgrad_blocking``,
``choose_stream_wgrad_blocking``); ``hso`` pins the strip height.

The plain versions are the dense family's (``core.direct_conv``), since the
function is the same: a CPU tensor takes them, after the same blocking and
argument checks as a CUDA tensor; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts this module's kernels; ``gap_finalize`` and
``wgrad_reduce`` count in ``kernels.direct_conv2d.LAUNCHES``.  The routing
between these kernels and the window ones lives in
``kernels.direct_conv2d`` and ``core.dispatch``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import (H100_SXM, MachineModel, StreamBlocking,
                                       choose_stream_blocking,
                                       choose_stream_dgrad_blocking,
                                       choose_stream_wgrad_blocking,
                                       stream_gap_floats, stream_smem_bytes)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.direct_conv import (backward_spec, conv_spec,
                                          direct_conv_blocked,
                                          direct_conv_dgrad_blocked,
                                          direct_conv_wgrad_blocked)
from repro_torch.core.padding import Padding
from repro_torch.core.precision import F32, resolve_precision
from repro_torch.kernels.direct_conv2d import (WGRAD_GEOMETRY, _ACT_CODES,
                                               _GRID_YZ_MAX,
                                               _backward_operands, _call,
                                               _check, _check_activation,
                                               _cuda_device, _library, _ptr,
                                               _require, _stream,
                                               check_machine,
                                               dgrad_launch, gap_finalize,
                                               split_wgrad, wgrad_launch,
                                               wgrad_reduce)

__all__ = ["LAUNCHES", "reset_launches", "stream_blocking", "stream_forward",
           "stream_dgrad", "stream_wgrad", "stream_wgrad_partials"]

LAUNCHES = {"conv2d_stream_fwd": 0, "conv2d_stream_dgrad": 0,
            "conv2d_stream_wgrad": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.conv2d_stream_conv.argtypes = [ptr] * 6 + [i32] * 23 + [ptr]
    lib.conv2d_stream_conv.restype = i32
    lib.conv2d_stream_dgrad.argtypes = [ptr] * 4 + [i32] * 20 + [ptr]
    lib.conv2d_stream_dgrad.restype = i32
    lib.conv2d_stream_dgrad_plan.argtypes = [i32] * 19 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_stream_dgrad_plan.restype = i32
    lib.conv2d_stream_wgrad.argtypes = [ptr] * 4 + [i32] * 22 + [ptr]
    lib.conv2d_stream_wgrad.restype = i32
    lib.conv2d_stream_wgrad_plan.argtypes = [i32] * 21 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_stream_wgrad_plan.restype = i32


def _lib() -> ctypes.CDLL:
    return _library("conv2d_stream", _declare, more_geometries=(
        ("conv2d_stream_wgrad_geometry", WGRAD_GEOMETRY),))


def _prologue(z: Optional[torch.Tensor], activation: Optional[str]) -> bool:
    return z is not None and activation not in (None, "linear")


def stream_blocking(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                    gap: bool, hso: Optional[int],
                    machine: MachineModel) -> StreamBlocking:
    """The streamed forward's tiles for operands ``x``, ``w`` of geometry
    ``spec``; raises what the model raises (a pinned ``hso`` that divides
    no band, a misfit), on either device."""
    check_machine(machine)
    return choose_stream_blocking(x.shape[0], spec.padded_hi,
                                  spec.padded_wi, spec.ci, spec.co, spec.hf,
                                  spec.wf, spec.stride, w.shape[5],
                                  x.shape[4], machine, gap, hso)


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
    Co]`` (the kernel's per-band partial sums through ``gap_finalize``).
    Inference only: the training path enters through
    ``kernels.direct_conv2d.direct_conv2d_blocked``."""
    spec = conv_spec(x, w, stride, padding)
    _check_activation(activation)
    blk = stream_blocking(x, w, spec, gap, hso, machine)
    n, coblk, cob, cib = x.shape[0], w.shape[0], w.shape[5], x.shape[4]
    if x.device.type == "cpu":
        return direct_conv_blocked(x, w, stride, padding, bias, activation,
                                   precision, residual=residual, gap=gap)
    if resolve_precision(precision).op_dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernels of this slice run the f32 policy only")
    dev = _cuda_device(x)
    ptrs = [_require(t, name, dev, vector_loads=name in ("x", "w"))
            for name, t in (("x", x), ("w", w), ("bias", bias),
                            ("residual", residual))]
    out_shape = (n, coblk, spec.ho, spec.wo, cob)
    if bias is not None and tuple(bias.shape) != (coblk, cob):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(coblk, cob)}")
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"output shape {out_shape}")
    if coblk > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Co/Cob={coblk}, N={n}")
    smem = stream_smem_bytes(
        blk.ring_rows, blk.ring_cols, blk.chunk, blk.ldw, spec.hf, spec.wf,
        gap_floats=stream_gap_floats(cob, machine) if gap else 0)
    n_bands = (spec.ho // blk.hob) * (spec.wo // blk.wob)
    out = torch.empty(out_shape, device=dev, dtype=torch.float32)
    partials = (torch.empty((n, coblk, n_bands, cob), device=dev,
                            dtype=torch.float32) if gap else None)
    lib = _lib()
    err = _call(dev, lib.conv2d_stream_conv, *ptrs, out.data_ptr(),
                _ptr(partials), n, x.shape[1], x.shape[2], x.shape[3], cib,
                coblk, cob, spec.ho, spec.wo, spec.hf, spec.wf, stride,
                spec.pads[0][0], spec.pads[1][0], blk.hob, blk.wob, blk.hso,
                blk.ring_rows, blk.ring_cols, blk.chunk, blk.ldw,
                _ACT_CODES[activation], smem, _stream(dev))
    LAUNCHES["conv2d_stream_fwd"] += 1
    _check(err, lib, "conv2d_stream_fwd")
    if gap:
        return gap_finalize(partials, spec.ho * spec.wo)
    return out


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
    err, dx = dgrad_launch(lib.conv2d_stream_dgrad, blk.hso, blk, g, w, spec,
                           z if prologue else None, activation)
    LAUNCHES["conv2d_stream_dgrad"] += 1
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
    None)``.  On CUDA: ``stream_wgrad_partials`` and then ``wgrad_reduce``,
    which adds the shares in order (no atomics, identical bits run to
    run)."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z, activation,
                               hso, machine)
        return direct_conv_wgrad_blocked(x, g, hf, wf, stride, padding, z,
                                         activation, with_db)
    ws = stream_wgrad_partials(x, g, hf, wf, stride, padding, z, activation,
                               with_db, hso=hso, machine=machine)
    return split_wgrad(wgrad_reduce(ws), x.shape, g.shape, hf, wf, with_db)


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
                          machine: MachineModel = H100_SXM) -> torch.Tensor:
    """The streamed wgrad kernel on CUDA operands -> the f32 workspace
    ``[splits, |dw| + |db|]`` of per-share partial sums."""
    _backward_operands(g, z, activation)
    _cuda_device(x)
    spec, blk = _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z,
                                       activation, hso, machine)
    lib = _lib()
    err, ws = wgrad_launch(lib.conv2d_stream_wgrad, blk, x, g, hf, wf, spec,
                           z if _prologue(z, activation) else None,
                           activation, with_db)
    LAUNCHES["conv2d_stream_wgrad"] += 1
    _check(err, lib, "conv2d_stream_wgrad")
    return ws
