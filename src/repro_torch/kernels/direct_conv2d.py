"""Wrapper of the CUDA forward kernel of the blocked direct convolution.

``direct_conv2d_blocked`` is the port of the reference's
``direct_conv2d_blocked_pallas`` forward (``_fwd_kernel``,
``repro/kernels/direct_conv2d.py:102``):

* a CPU tensor runs the plain PyTorch version
  (``core.direct_conv.direct_conv_blocked``);
* a CUDA tensor launches ``csrc/direct_conv2d_fwd.cu`` with the launch
  parameters of ``core.blocking.choose_blocking``, or raises.  There is no
  fallback from one to the other.

The wrapper checks device, dtype (f32 in this slice), shapes, contiguity
and the 16-byte alignment of the operands read with float4 loads, and
raises on anything the kernel does not take.  This slice is inference
only: on CUDA it refuses inputs that require grad while grad mode is on
rather than return a result autograd cannot see through.

``LAUNCHES`` counts the kernels launched (a plain integer per kernel, bumped
where the launch happens and nowhere else), so a run can show that it went
through them; ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core import conv2d_common
from repro_torch.core.blocking import H100_SXM, choose_blocking, smem_bytes
from repro_torch.core.direct_conv import conv_spec, direct_conv_blocked
from repro_torch.core.errors import KernelLaunchError
from repro_torch.core.padding import Padding
from repro_torch.core.precision import F32, resolve_precision
from repro_torch.kernels._build import library

__all__ = ["LAUNCHES", "reset_launches", "direct_conv2d_blocked",
           "gap_finalize"]

LAUNCHES = {"direct_conv2d_fwd": 0, "gap_finalize": 0}

_ACT_CODES = {None: 0, "linear": 0, "relu": 1, "gelu": 2}
_GRID_YZ_MAX = 65535


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared; checks that
    its register-tile geometry is the one the blocking model assumes."""
    lib = library("direct_conv2d_fwd")
    if lib.direct_conv2d_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.direct_conv2d_fwd.argtypes = [ptr] * 6 + [i32] * 19 + [ptr]
        lib.direct_conv2d_fwd.restype = i32
        lib.gap_finalize.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float,
                                     ptr]
        lib.gap_finalize.restype = i32
        lib.cuda_error_name.argtypes = [i32]
        lib.cuda_error_name.restype = ctypes.c_char_p
        lib.direct_conv2d_fwd_geometry.argtypes = [ctypes.POINTER(i32)] * 3
        lib.direct_conv2d_fwd_geometry.restype = None
        geo = [i32(), i32(), i32()]
        lib.direct_conv2d_fwd_geometry(*(ctypes.byref(g) for g in geo))
        m = H100_SXM
        built = tuple(g.value for g in geo)
        if built != (m.threads, m.lanes, m.positions):
            raise RuntimeError(
                f"kernel register tile (threads, lanes, positions)={built} "
                f"differs from the blocking model's "
                f"{(m.threads, m.lanes, m.positions)}")
    return lib


def _check(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err:
        raise KernelLaunchError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.cuda_error_name(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, name: str, device: torch.device,
             vector_loads: bool = False) -> None:
    """Raise on an operand the kernel cannot take.  ``vector_loads``: the
    kernel reads it with float4 loads, so it must start on 16 bytes (a
    contiguous view at an odd storage offset would fault on the card)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != torch.float32:
        raise NotImplementedError(
            f"{name} is {t.dtype}: the CUDA kernel of this slice takes f32 "
            "operands (bf16 pencils are queued)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vector_loads and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernel reads it with float4 loads); pass a copy")


def direct_conv2d_blocked(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: Padding = "VALID",
                          activation: Optional[str] = None,
                          residual: Optional[torch.Tensor] = None,
                          gap: bool = False, precision=F32) -> torch.Tensor:
    """Blocked direct convolution with the fused epilogue.

    x: ``[N, Ci/Cib, Hi, Wi, Cib]``; w: ``[Co/Cob, Ci/Cib, Hf, Wf, Cib,
    Cob]``; bias: ``[Co/Cob, Cob]`` or None; residual: ``[N, Co/Cob, Ho,
    Wo, Cob]`` or None, added after the activation -> the output map, or
    with ``gap=True`` the pooled ``[N, Co]`` features.  ``padding`` is
    TF-SAME aware; on CUDA the pads are masked loads, never a padded copy.
    """
    spec = conv_spec(x, w, stride, padding)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"have {sorted(k for k in _ACT_CODES if k)}")
    n, coblk, cob = x.shape[0], w.shape[0], w.shape[5]
    if bias is not None and tuple(bias.shape) != (coblk, cob):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(coblk, cob)}")
    out_shape = (n, coblk, spec.ho, spec.wo, cob)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"output shape {out_shape}")
    if x.device.type == "cpu":
        return direct_conv_blocked(x, w, stride, padding, bias, activation,
                                   precision, residual=residual, gap=gap)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if resolve_precision(precision).op_dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernel of this slice runs the f32 policy only")
    operands = {"x": x, "w": w, "bias": bias, "residual": residual}
    for name, t in operands.items():
        if t is not None:
            _require(t, name, x.device, vector_loads=name in ("x", "w"))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands.values()):
        raise RuntimeError(
            "direct_conv2d_blocked on CUDA is inference-only in this slice: "
            "call it under torch.no_grad() (the autograd path arrives with "
            "the training slice)")
    if coblk > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"grid too large: Co/Cob={coblk}, N={n}")

    blk = choose_blocking(spec.padded_hi, spec.padded_wi, spec.ci, spec.co,
                          spec.hf, spec.wf, spec.stride, cob=cob,
                          cib=x.shape[4], gap=gap)
    smem = smem_bytes(blk.hob, blk.wob, blk.chunk, cob, spec.hf, spec.wf,
                      spec.stride, H100_SXM, gap)
    n_tiles = (spec.ho // blk.hob) * (spec.wo // blk.wob)
    out = torch.empty(out_shape, device=x.device, dtype=torch.float32)
    partials = (torch.empty((n, coblk, n_tiles, cob), device=x.device,
                            dtype=torch.float32) if gap else None)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.direct_conv2d_fwd(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(residual), _ptr(out),
            _ptr(partials), n, x.shape[1], x.shape[2], x.shape[3], x.shape[4],
            coblk, cob, spec.ho, spec.wo, spec.hf, spec.wf, spec.stride,
            spec.pads[0][0], spec.pads[1][0], blk.hob, blk.wob, blk.chunk,
            _ACT_CODES[activation], smem, stream)
        LAUNCHES["direct_conv2d_fwd"] += 1
    _check(err, lib, "direct_conv2d_fwd")
    if gap:
        return gap_finalize(partials, spec.ho * spec.wo)
    return out


def gap_finalize(partials: torch.Tensor, hw: int) -> torch.Tensor:
    """``[N, Co/Cob, n_tiles, Cob]`` f32 per-tile sums -> pooled ``[N, Co]``:
    tiles summed in index order, times the f32 reciprocal of ``hw``."""
    if partials.dim() != 4:
        raise ValueError(f"partials must be [N, Co/Cob, n_tiles, Cob], got "
                         f"{tuple(partials.shape)}")
    if partials.device.type == "cpu":
        return conv2d_common.gap_finalize(partials, hw)
    _require(partials, "partials", partials.device)
    n, coblk, n_tiles, cob = partials.shape
    pooled = torch.empty((n, coblk * cob), device=partials.device,
                         dtype=torch.float32)
    inv_hw = float(np.float32(1.0) / np.float32(hw))
    lib = _lib()
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    with torch.cuda.device(partials.device):
        err = lib.gap_finalize(_ptr(partials), _ptr(pooled), n * coblk,
                               n_tiles, cob, inv_hw, stream)
        LAUNCHES["gap_finalize"] += 1
    _check(err, lib, "gap_finalize")
    return pooled
