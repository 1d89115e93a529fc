"""Wrappers of the causal depthwise conv1d kernel (the Mamba short conv).

``csrc/conv1d_depthwise.cu`` replaces the reference's Pallas kernel
``conv1d_depthwise_blocked_pallas`` (``repro/kernels/conv1d_depthwise.py``)
and computes the reference's oracle ``direct_conv1d_depthwise(x, w, bias,
causal=True)``, whose port (``core.direct_conv.direct_conv1d_depthwise``) is
its plain version.  Two entry points:

* :func:`conv1d_depthwise` on ``[B, L, D]``, the counterpart of the
  reference's ``kernels/ops.py`` ``conv1d_depthwise``; x may be a strided
  view (a column slice: the row stride may exceed D), which the kernel
  reads in place;
* :func:`conv1d_depthwise_blocked` on the channel-blocked ``[B, D/Db, L,
  Db]``, the counterpart of ``conv1d_depthwise_blocked_pallas``; the same
  kernel reads it through a channel-block stride.

Each routes by device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises (``KernelLaunchError`` on a failed launch,
``ValueError``/``NotImplementedError`` on an operand the kernel does not
take); there is no fallback.  Channel pairs are loaded as one 8-byte (f32)
or 4-byte (bf16) word when the base pointer and every stride keep them
aligned, else one channel at a time: a load width inside the kernel.  The
kernel computes no gradient, so with grad mode on and an operand that
requires grad the wrappers raise (the LM-training slice adds the backward).

``LAUNCHES["conv1d_depthwise"]`` counts launches; ``reset_launches`` sets it
to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.direct_conv import direct_conv1d_depthwise
from repro_torch.core.layout import blocked_to_bld, bld_to_blocked
from repro_torch.kernels.direct_conv2d import (_check, _cuda_device, _library,
                                               _no_autograd, _stream)

__all__ = ["LAUNCHES", "reset_launches", "conv1d_depthwise",
           "conv1d_depthwise_blocked", "MAX_TAPS"]

LAUNCHES = {"conv1d_depthwise": 0}
THREADS, ROWS, MAX_TAPS = 128, 64, 8
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.conv1d_depthwise_causal.argtypes = ([ptr] * 4 + [i32] * 7
                                            + [ptr, ptr])
    lib.conv1d_depthwise_causal.restype = i32


def _lib() -> ctypes.CDLL:
    return _library("conv1d_depthwise", _declare, (THREADS, ROWS, MAX_TAPS))


def _launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            out: torch.Tensor, db: int, x_strides, out_strides) -> None:
    """One launch over ``x`` of logical shape [B, L, D] whose element (b, l,
    c) lies at ``b*sb + (c // db)*sblk + l*sl + c % db`` (``x_strides`` =
    (sb, sblk, sl)); ``out`` likewise."""
    dev = _cuda_device(x)
    b, l, d = x.shape[0], x.shape[-2], w.shape[1]
    k = w.shape[0]
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"x is {x.dtype}: the kernel takes f32 or "
                                  "bf16")
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"{k} taps: the kernel holds 1..{MAX_TAPS}")
    if x.stride(-1) != 1:
        raise ValueError("x's channels must be contiguous (stride 1)")
    for t, name in ((w, "w"), (bias, "bias")):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x is on {dev}")
    wf = w.to(torch.float32).contiguous()          # K*D taps, widened once
    bf = None if bias is None else bias.to(torch.float32).contiguous()
    esize = x.element_size()
    vec = 2 if (d % 2 == 0 and db % 2 == 0
                and x.data_ptr() % (2 * esize) == 0
                and out.data_ptr() % (2 * esize) == 0
                and all(s % 2 == 0 for s in (*x_strides, *out_strides))) \
        else 1
    strides = (ctypes.c_longlong * 6)(*x_strides, *out_strides)
    lib = _lib()
    err = lib.conv1d_depthwise_causal(
        x.data_ptr(), wf.data_ptr(), None if bf is None else bf.data_ptr(),
        out.data_ptr(), b, l, d, db, k, vec, int(x.dtype == torch.bfloat16),
        strides, _stream(dev))
    _check(err, lib, "conv1d_depthwise")
    LAUNCHES["conv1d_depthwise"] += 1


def conv1d_depthwise(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv1d.  x: ``[B, L, D]`` (channels contiguous, any
    batch and row strides); w: ``[K, D]``; bias: ``[D]`` or None -> a new
    contiguous ``[B, L, D]`` in x's dtype."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"expected x [B, L, D] and w [K, D], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (x.shape[2],):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({x.shape[2]},)")
    _no_autograd("conv1d_depthwise", x, w, bias)
    if x.device.type == "cpu":
        return direct_conv1d_depthwise(x, w, bias, causal=True)
    b, l, d = x.shape
    out = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    _launch(x, w, bias, out, d, (x.stride(0), 0, x.stride(1)),
            (l * d, 0, d))
    return out


def conv1d_depthwise_blocked(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """Causal depthwise conv1d on the blocked layout.  x: ``[B, D/Db, L,
    Db]`` (lanes contiguous); w: ``[K, D/Db, Db]`` -> a new contiguous ``[B,
    D/Db, L, Db]`` in x's dtype, with no bias (the TPU kernel has none)."""
    if x.dim() != 4 or w.dim() != 3 or tuple(w.shape[1:]) != (
            x.shape[1], x.shape[3]):
        raise ValueError(f"expected x [B, D/Db, L, Db] and w [K, D/Db, Db], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    _no_autograd("conv1d_depthwise", x, w)
    b, dblk, l, db = x.shape
    w2 = w.reshape(w.shape[0], dblk * db)
    if x.device.type == "cpu":
        return bld_to_blocked(direct_conv1d_depthwise(
            blocked_to_bld(x), w2, None, causal=True), db).contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch(x, w2, None, out, db, (x.stride(0), x.stride(1), x.stride(2)),
            (out.stride(0), out.stride(1), out.stride(2)))
    return out
