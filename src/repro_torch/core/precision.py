"""Mixed-precision policy for the blocked kernel family, with torch dtypes.

  operand   what the contraction reads (x windows, weight tiles).
  accum     what partial sums live in.  Always f32: the kernels accumulate
            in f32 registers and the plain version contracts in f32.
  residual  what a training step would store between forward and backward.

Operands are cast once on kernel entry; the output is the operand dtype,
rounded once after the fused epilogue.  The dense forward, dgrad and wgrad
kernels take f32 and bf16 operands (bf16 with an f32 bias; the wgrad's dw
and db stay f32); the separable family takes f32 only so far; the plain
version takes both.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Precision", "F32", "BF16", "resolve_precision"]

_SUPPORTED = ("float32", "bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class Precision:
    """(operand, accum, residual) dtype triple, by canonical dtype name."""

    operand: str = "float32"
    accum: str = "float32"
    residual: str = "float32"

    def __post_init__(self):
        for field in ("operand", "residual"):
            name = getattr(self, field)
            if name not in _SUPPORTED:
                raise ValueError(
                    f"unsupported {field} dtype {name!r}; have {_SUPPORTED}")
        if self.accum != "float32":
            # the kernels keep f32 register accumulators; a narrower sum
            # would change the arithmetic the tiles rely on
            raise ValueError(
                f"accumulator must stay float32 (got {self.accum!r}): the "
                "kernel accumulators are f32 by construction")

    @property
    def op_dtype(self) -> torch.dtype:
        return getattr(torch, self.operand)

    @property
    def accum_dtype(self) -> torch.dtype:
        return getattr(torch, self.accum)

    @property
    def residual_dtype(self) -> torch.dtype:
        return getattr(torch, self.residual)

    @property
    def operand_itemsize(self) -> int:
        """Bytes per operand element: what the shared-memory budget of the
        forward tiles sees (``core.blocking``)."""
        return self.op_dtype.itemsize

    @property
    def accum_itemsize(self) -> int:
        return self.accum_dtype.itemsize

    @property
    def name(self) -> str:
        """Short display name ("f32", "bf16", or the full triple)."""
        if self == F32:
            return "f32"
        if self == BF16:
            return "bf16"
        return f"{self.operand}/{self.accum}/{self.residual}"


F32 = Precision()
BF16 = Precision(operand="bfloat16", residual="bfloat16")

_ALIASES = {
    None: F32,
    "f32": F32, "float32": F32, "fp32": F32,
    "bf16": BF16, "bfloat16": BF16,
}


def resolve_precision(policy) -> Precision:
    """Accept a Precision, a name ("f32"/"bf16"), or None (-> f32)."""
    if isinstance(policy, Precision):
        return policy
    try:
        return _ALIASES[policy]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown precision policy {policy!r}; pass a Precision or one "
            f"of {sorted(k for k in _ALIASES if k)}") from None
