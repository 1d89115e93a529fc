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
  under the ``BF16`` policy the tile's bf16 build
  (``stream_fwd_kernel_bf16``: bf16 operands and output, f32 sums);
* ``stream_dgrad``: ``dx`` of that conv from the raw cotangent ``g`` and the
  saved pre-activation ``z`` (``dz = g * act'(z)`` formed in the kernel),
  written at the unpadded input's shape; under ``BF16`` the tile's bf16
  build (``stream_dgrad_kernel_bf16``: bf16 operands and dx, f32 sums);
* ``stream_wgrad``: ``(dw, db)``, the kernel's per-share partial sums added
  in split order by the last CTA of each column of shares
  (``stream_wgrad_kernel``: the
  tensor-core wgrad tile of ``csrc/wgrad_tile.cuh`` walked strip by strip
  down each column, the halo rows kept; the sums, ``csrc/split_sum.cuh``);
  under ``BF16`` its bf16 build (``stream_wgrad_kernel_bf16``: bf16
  operands, f32 sums, dw and db).

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
from repro_torch.core.conv2d_common import gap_replay
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
                                               _suffix, build_dtype,
                                               check_machine,
                                               declare_backward, dgrad_launch,
                                               fwd_launch, fwd_run,
                                               plain_policy, split_wgrad,
                                               wgrad_launch,
                                               wgrad_launch_plan)

__all__ = ["LAUNCHES", "reset_launches", "stream_blocking", "stream_forward",
           "stream_dgrad", "stream_wgrad", "stream_wgrad_partials"]

LAUNCHES = {"conv2d_stream_fwd": 0, "conv2d_stream_fwd_bf16": 0,
            "conv2d_stream_dgrad": 0, "conv2d_stream_dgrad_bf16": 0,
            "conv2d_stream_wgrad": 0, "conv2d_stream_wgrad_bf16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.conv2d_stream_conv.argtypes = [ptr] * 8 + [ctypes.POINTER(i32), ptr]
    lib.conv2d_stream_conv.restype = i32
    lib.conv2d_stream_conv_plan.argtypes = [
        ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_longlong)]
    lib.conv2d_stream_conv_plan.restype = i32
    declare_backward(lib, "conv2d_stream", ptr, i32)


def _lib() -> ctypes.CDLL:
    return _library("conv2d_stream", _declare, FWD_GEOMETRY,
                    more_geometries=(("conv2d_stream_wgrad_geometry",
                                      WGRAD_GEOMETRY),))


def _prologue(z: Optional[torch.Tensor], activation: Optional[str]) -> bool:
    return z is not None and activation not in (None, "linear")


def stream_blocking(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                    gap: bool, hso: Optional[int], machine: MachineModel,
                    op_bytes: int = 4) -> FwdBlocking:
    """The streamed forward's tiles for operands ``x``, ``w`` of geometry
    ``spec`` at ``op_bytes`` operands; raises what the model raises (a
    pinned ``hso`` that does not divide the rows, a misfit), on either
    device."""
    check_machine(machine)
    cib, cob = x.shape[4], w.shape[5]
    return choose_stream_fwd_blocking(x.shape[0], spec.ho, spec.wo, spec.hf,
                                      spec.wf, spec.stride, spec.ci // cib,
                                      cib, spec.co // cob, cob, machine, gap,
                                      hso, op_bytes)


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
    each image and output block); under the ``BF16`` policy the bf16
    build, at bf16 out and pooled features.
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
        blk = stream_blocking(x, w, spec, gap, hso, machine,
                              resolve_precision(precision).operand_itemsize)
        out = direct_conv_blocked(x, w, stride, padding, bias, activation,
                                  precision, residual=residual)
        return gap_replay(out, blk) if gap else out
    check_machine(machine)
    plan = fwd_launch(spec, x.shape[4], cob, _ACT_CODES[activation], gap,
                      True, hso, machine, dtype=build_dtype(precision))
    lib = _lib()
    name = "conv2d_stream_fwd" + plan.suffix
    err, out, _, pooled = fwd_run(lib.conv2d_stream_conv, plan, x, w, bias,
                                  residual, spec)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return pooled if gap else out


def stream_dgrad(g: torch.Tensor, w: torch.Tensor,
                 input_hw: Tuple[int, int], stride: int = 1,
                 padding: Padding = "VALID",
                 z: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None, *,
                 hso: Optional[int] = None,
                 machine: MachineModel = H100_SXM,
                 precision=F32) -> torch.Tensor:
    """The streamed input gradient: the raw cotangent ``g [N, Co/Cob, Ho,
    Wo, Cob]``, the saved pre-activation ``z`` (None for a linear
    epilogue) and ``w`` -> ``dx [N, Ci/Cib, Hi, Wi, Cib]`` at the unpadded
    ``input_hw``.  ``stride``/``padding`` are the forward's; under
    ``BF16`` the bf16 build (``stream_dgrad_kernel_bf16``, bf16 dx)."""
    _backward_operands(g, z, activation)
    check_machine(machine)
    dtype = build_dtype(precision)
    hi, wi = input_hw
    n, coblk, ho, wo, cob = g.shape
    _, ciblk, hf, wf, cib, _ = w.shape
    spec = backward_spec(n, hi, wi, w.shape, stride, padding, g, z)
    prologue = _prologue(z, activation)
    blk = choose_stream_dgrad_blocking(n, hi, wi, hf, wf, stride, ciblk, cib,
                                       cob, machine, prologue, hso,
                                       dtype.itemsize)
    if g.device.type == "cpu":
        return direct_conv_dgrad_blocked(g, w, input_hw, stride, padding, z,
                                         activation,
                                         precision=plain_policy(dtype))
    lib = _lib()
    name = "conv2d_stream_dgrad" + _suffix(dtype)
    err, dx, grids = dgrad_launch(getattr(lib, name), blk.hso, blk, g, w,
                                  spec, z if prologue else None, activation,
                                  dtype)
    LAUNCHES[name] += grids
    _check(err, lib, name)
    return dx


def stream_wgrad(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                 stride: int = 1, padding: Padding = "VALID",
                 z: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 with_db: bool = False, *, hso: Optional[int] = None,
                 machine: MachineModel = H100_SXM, precision=F32):
    """The streamed weight (and bias) gradient: the forward's unpadded input
    ``x``, the raw cotangent ``g`` and the saved pre-activation ``z`` ->
    ``(dw [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob] f32, db [Co/Cob, Cob] f32 or
    None)``.  On CUDA: ``stream_wgrad_partials``, whose last CTA of each
    column adds its shares in order (identical bits run to run); under
    ``BF16`` the bf16 build (``stream_wgrad_kernel_bf16``, f32 out)."""
    _backward_operands(g, z, activation)
    if x.device.type == "cpu":
        dtype = build_dtype(precision)
        _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z, activation,
                               hso, machine, dtype)
        return direct_conv_wgrad_blocked(x, g, hf, wf, stride, padding, z,
                                         activation, with_db,
                                         precision=plain_policy(dtype))
    _, out = stream_wgrad_partials(x, g, hf, wf, stride, padding, z,
                                   activation, with_db, hso=hso,
                                   machine=machine, precision=precision)
    return split_wgrad(out, x.shape, g.shape, hf, wf, with_db)


def _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z, activation, hso,
                           machine, dtype=torch.float32):
    check_machine(machine)
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = g.shape
    spec = backward_spec(n, hi, wi, (coblk, ciblk, hf, wf, cib, cob), stride,
                         padding, g, z)
    blk = choose_stream_wgrad_blocking(n, ho, wo, hf, wf, stride, ciblk, cib,
                                       coblk, cob, machine,
                                       _prologue(z, activation), hso,
                                       dtype.itemsize)
    return spec, blk


def stream_wgrad_partials(x: torch.Tensor, g: torch.Tensor, hf: int, wf: int,
                          stride: int = 1, padding: Padding = "VALID",
                          z: Optional[torch.Tensor] = None,
                          activation: Optional[str] = None,
                          with_db: bool = False, *,
                          hso: Optional[int] = None,
                          machine: MachineModel = H100_SXM, precision=F32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed wgrad kernel on CUDA operands (under ``BF16`` its bf16
    build) -> ``(ws, out)``: the f32 workspace ``[splits, |dw| + |db|]`` of
    per-share partial sums and their in-order sum ``[|dw| + |db|]`` that
    the last CTA of each column of shares wrote."""
    _backward_operands(g, z, activation)
    _cuda_device(x)
    dtype = build_dtype(precision)
    spec, blk = _stream_wgrad_blocking(x, g, hf, wf, stride, padding, z,
                                       activation, hso, machine, dtype)
    lib = _lib()
    name = "conv2d_stream_wgrad" + _suffix(dtype)
    plan = wgrad_launch_plan(blk, x.shape, g.shape, hf, wf, spec,
                             _ACT_CODES[activation], with_db)
    err, ws, out = wgrad_launch(getattr(lib, name), plan, x, g,
                                z if _prologue(z, activation) else None,
                                dtype)
    LAUNCHES[name] += 1
    _check(err, lib, name)
    return ws, out
