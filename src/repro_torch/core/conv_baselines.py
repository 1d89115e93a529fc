"""The paper's §2 baselines, im2col + GEMM and FFT convolution, and the
library convolution every implementation is held against, in PyTorch.

The port of ``repro/core/conv_baselines.py``, on NHWC maps and HWIO
weights as there.  ``conv_lax`` keeps the reference's name (there XLA's
``lax.conv_general_dilated``) and runs ``F.conv2d`` on NCHW copies;
``conv_im2col`` materializes the packed ``[N*Ho*Wo, Hf*Wf*Ci]`` matrix,
the memory overhead the paper removes, and ``conv_fft`` pads the kernel to
the image size (§2.1).  ``core.memory_model`` counts both buffers.  They
are baselines, plain PyTorch by design: nothing on the main path calls
them.  On a CUDA tensor ``F.conv2d`` runs cuDNN, in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.padding import Padding, normalize_padding, out_size

__all__ = [
    "Padding", "normalize_padding", "pad_input", "out_size",
    "conv_lax", "im2col", "conv_im2col", "conv_fft",
]


def pad_input(x: torch.Tensor, padding: Padding, hf: int, wf: int,
              stride: int = 1) -> torch.Tensor:
    """Zero-pad an NHWC map's spatial dims by ``padding`` (TF-SAME aware)."""
    (ph0, ph1), (pw0, pw1) = normalize_padding(
        padding, hf, wf, stride, x.shape[1], x.shape[2])
    if ph0 == ph1 == pw0 == pw1 == 0:
        return x
    return F.pad(x, (0, 0, pw0, pw1, ph0, ph1))


def conv_lax(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             padding: Padding = "VALID", groups: int = 1,
             dilation: int | tuple = 1) -> torch.Tensor:
    """The library convolution: ``F.conv2d``.  x: NHWC, w: HWIO (grouped:
    ``w.shape[2] == Ci // groups``) -> NHWC.  SAME resolves against the
    dilated filter extent; asymmetric pads are explicit zero pads."""
    dil = dilation if isinstance(dilation, tuple) else (dilation, dilation)
    hf_eff = (w.shape[0] - 1) * dil[0] + 1
    wf_eff = (w.shape[1] - 1) * dil[1] + 1
    (ph0, ph1), (pw0, pw1) = normalize_padding(
        padding, hf_eff, wf_eff, stride, x.shape[1], x.shape[2])
    x_nchw = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(x_nchw, w.permute(3, 2, 0, 1), stride=stride,
                 dilation=dil, groups=groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# im2col + GEMM (paper §2.2): the baseline with the memory overhead
# ---------------------------------------------------------------------------

def im2col(x: torch.Tensor, hf: int, wf: int, stride: int = 1) -> torch.Tensor:
    """Materialize the packed matrix ``[N, Ho, Wo, Hf*Wf*Ci]`` of an
    already padded NHWC map; the last dim in (hf, wf, ci) order, matching
    ``w.reshape(hf * wf * ci, co)``."""
    n, hi, wi, ci = x.shape
    ho, wo = out_size(hi, hf, stride), out_size(wi, wf, stride)
    cols = [x[:, dh:dh + (ho - 1) * stride + 1:stride,
              dw:dw + (wo - 1) * stride + 1:stride, :]
            for dh in range(hf) for dw in range(wf)]
    # [N, Ho, Wo, Hf*Wf, Ci] -> [N, Ho, Wo, Hf*Wf*Ci]
    return torch.stack(cols, dim=3).reshape(n, ho, wo, hf * wf * ci)


def conv_im2col(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: Padding = "VALID") -> torch.Tensor:
    """Packing + GEMM: the Caffe-style baseline the paper measures against."""
    hf, wf, ci, co = w.shape
    x = pad_input(x, padding, hf, wf, stride)
    packed = im2col(x, hf, wf, stride)                        # the overhead
    n, ho, wo, k = packed.shape
    gemm = packed.reshape(n * ho * wo, k) @ w.reshape(k, co)  # the GEMM
    return gemm.reshape(n, ho, wo, co)


# ---------------------------------------------------------------------------
# FFT convolution (paper §2.1): the kernel padded to the image size
# ---------------------------------------------------------------------------

def conv_fft(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             padding: Padding = "VALID") -> torch.Tensor:
    """Frequency-domain cross-correlation in f32: the kernel zero-padded to
    the (padded) image, the product of the spectra, the valid region kept.
    The circular wrap never reaches a valid output, since the kernel's
    support is Hf x Wf."""
    hf, wf, ci, co = w.shape
    x = pad_input(x, padding, hf, wf, stride)
    n, hi, wi, _ = x.shape
    ho, wo = out_size(hi, hf, stride), out_size(wi, wf, stride)
    xf = torch.fft.rfftn(x.to(torch.float32), dim=(1, 2))      # [N,Hi,Wi',Ci]
    wpad = x.new_zeros((hi, wi, ci, co), dtype=torch.float32)
    wpad[:hf, :wf] = w.to(torch.float32)
    kf = torch.conj(torch.fft.rfftn(wpad, dim=(0, 1)))         # correlation
    of = torch.einsum("nhwc,hwco->nhwo", xf, kf)
    out = torch.fft.irfftn(of, s=(hi, wi), dim=(1, 2))
    out = out[:, :(ho - 1) * stride + 1:stride, :(wo - 1) * stride + 1:stride]
    return out.to(x.dtype)
