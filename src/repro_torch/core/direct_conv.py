"""Zero-memory-overhead direct convolution (paper §3), plain PyTorch.

``direct_conv_blocked`` is the plain version of the forward kernel: the tap
loop of the reference (``repro/core/direct_conv.py``) as one
``torch.einsum`` per filter tap over a strided view of the padded blocked
input, accumulated in f32, followed by the fused epilogue (bias,
activation, residual, one downcast) and the optional GAP rider.  The CPU
path of every layer runs it, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.

Only dense geometry is served in this slice: grouped, dilated and
depthwise-lane convolutions raise ``NotImplementedError`` naming the kernel
zoo slice that brings them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.conv2d_common import (apply_activation, epilogue,
                                            gap_finalize, gap_partials,
                                            tap_windows)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.padding import Padding
from repro_torch.core.precision import resolve_precision

__all__ = ["apply_activation", "pad_blocked", "bias_to_blocked",
           "direct_conv_blocked", "conv_spec"]


def pad_blocked(x: torch.Tensor, ph, pw) -> torch.Tensor:
    """Zero-pad the spatial dims of a blocked map ``[N, C/Cb, H, W, Cb]``."""
    if not (any(ph) or any(pw)):
        return x
    # F.pad lists pads from the last dim backwards: (Cb, W, H)
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def bias_to_blocked(bias: torch.Tensor, cb_out: int) -> torch.Tensor:
    """Flat bias ``[Co] -> [Co/Cb, Cb]`` channel pencils."""
    co = bias.shape[0]
    if co % cb_out:
        raise ValueError(f"Co={co} not divisible by block {cb_out}")
    return bias.reshape(-1, cb_out)


def conv_spec(x: torch.Tensor, w: torch.Tensor, stride: int,
              padding: Padding, groups: int = 1,
              dilation=1) -> ConvSpec:
    """The dense conv geometry of blocked operands; raises on the geometry
    this slice does not serve and on operands that do not chain."""
    if x.dim() != 5 or w.dim() != 6:
        raise ValueError(f"expected x [N, Ci/Cib, H, W, Cib] and w [Co/Cob, "
                         f"Ci/Cib, Hf, Wf, Cib, Cob]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    n, ciblk, hi, wi, cib = x.shape
    coblk, ciblk_w, hf, wf, cib_w, cob = w.shape
    spec = ConvSpec.make(n, hi, wi, ciblk * cib, coblk * cob, hf, wf,
                         stride=stride, padding=padding, groups=groups,
                         dilation=dilation)
    if not spec.is_dense:
        raise NotImplementedError(
            f"groups={spec.groups}, dilation={spec.dilation}: grouped, "
            "dilated and depthwise convolutions arrive with the kernel zoo "
            "slice of the port")
    if (ciblk_w, cib_w) != (ciblk, cib):
        raise ValueError(f"weight input blocks {(ciblk_w, cib_w)} do not "
                         f"match the map's {(ciblk, cib)}")
    if spec.ho <= 0 or spec.wo <= 0:
        raise ValueError(f"empty output for input {hi}x{wi}, filter {hf}x{wf}")
    return spec


def direct_conv_blocked(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                        padding: Padding = "VALID",
                        bias: Optional[torch.Tensor] = None,
                        activation: Optional[str] = None,
                        precision=None, groups: int = 1, dilation=1,
                        residual: Optional[torch.Tensor] = None,
                        gap: bool = False) -> torch.Tensor:
    """Direct convolution on blocked layouts with the fused epilogue.

    x: ``[N, Ci/Cib, Hi, Wi, Cib]``; w: ``[Co/Cob, Ci/Cib, Hf, Wf, Cib,
    Cob]``; bias: ``[Co/Cob, Cob]`` or None; residual: the output's shape or
    None -> ``[N, Co/Cob, Ho, Wo, Cob]`` in the operand dtype, or with
    ``gap=True`` the pooled ``[N, Co]`` features.

    ``padding`` is TF-SAME aware (asymmetric at stride 2).  ``precision``
    casts the operands once; the contraction then runs on f32 copies of the
    cast values, so a bf16 policy is bf16 operands with an f32 sum.  The
    pooled features are the f32 mean of the *stored* (downcast) map.
    """
    spec = conv_spec(x, w, stride, padding, groups, dilation)
    if precision is not None:
        op = resolve_precision(precision).op_dtype
        x, w = x.to(op), w.to(op)
        if residual is not None:
            residual = residual.to(op)
    out_dtype = x.dtype
    xp = pad_blocked(x, *spec.pads).to(torch.float32)
    w32 = w.to(torch.float32)
    acc = None
    for (dh, dw), win in tap_windows(xp, spec.hf, spec.wf, spec.ho, spec.wo,
                                     spec.stride):
        # [N, Ci/Cib, Ho, Wo, Cib] x [Co/Cob, Ci/Cib, Cib, Cob]
        #   -> [N, Co/Cob, Ho, Wo, Cob]
        term = torch.einsum("nchwb,ocbk->nohwk", win, w32[:, :, dh, dw])
        acc = term if acc is None else acc + term
    out = epilogue(acc, bias, activation, residual, out_dtype)
    if gap:
        pooled = gap_finalize(gap_partials(out, spec.ho, spec.wo),
                              spec.ho * spec.wo)
        return pooled.to(out_dtype)
    return out
