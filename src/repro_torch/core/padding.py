"""Padding semantics shared by every convolution path of the port.

Pure Python.  TF-SAME semantics: ``out = ceil(in / stride)`` with an
*asymmetric* ``(lo, hi)`` split — at stride 2 over an even input the pad is
``(0, 1)``, not PyTorch's symmetric ``padding=1``.  The plain version and
the CUDA kernel both take their pads from :func:`normalize_padding`.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

__all__ = ["Padding", "normalize_padding", "out_size"]

Padding = Union[str, int, Sequence[Tuple[int, int]]]


def _same_pads(size: int | None, f: int, stride: int) -> Tuple[int, int]:
    """TF-style stride-aware SAME: output = ceil(size / stride).

    With ``stride > 1`` the total pad depends on the input size
    (``(ceil(size/stride) - 1) * stride + f - size``), so that combination
    raises without one instead of using the stride-1 formula ``f - 1``.
    """
    if stride == 1:
        total = f - 1
    elif size is None:
        raise ValueError(
            "SAME padding with stride > 1 requires the input size: "
            "pass hi/wi to normalize_padding (the stride-1 formula f-1 "
            "is wrong for strided SAME)")
    else:
        out = -(-size // stride)
        total = max((out - 1) * stride + f - size, 0)
    return (total // 2, total - total // 2)


def normalize_padding(padding: Padding, hf: int, wf: int, stride: int = 1,
                      hi: int | None = None, wi: int | None = None,
                      ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """-> ``((ph_lo, ph_hi), (pw_lo, pw_hi))`` explicit per-edge pads."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return (0, 0), (0, 0)
        if p == "SAME":
            return _same_pads(hi, hf, stride), _same_pads(wi, wf, stride)
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (ph0, ph1), (pw0, pw1) = padding
    return (ph0, ph1), (pw0, pw1)


def out_size(hi: int, hf: int, stride: int) -> int:
    """Output extent of a VALID convolution over an (already padded) input."""
    return (hi - hf) // stride + 1
