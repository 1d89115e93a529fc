"""ConvSpec: the frozen conv geometry every layer of the port shares.

Pure Python on top of ``core.padding``: extents, ``groups``, per-axis
``dilation``, stride and normalized per-edge pads, plus the derived facts
(output extents, effective filter span, per-group channels, FLOPs).  Weight
layout convention is grouped-HWIO blocked, ``[Co/Cob, Cig/Cib, Hf, Wf, Cib,
Cob]`` with ``Cig = Ci // groups``; dense convs are ``groups=1``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple, Union

from repro_torch.core.padding import Padding, normalize_padding, out_size

__all__ = ["ConvSpec", "as_dilation"]

Dilation = Union[int, Tuple[int, int]]


def as_dilation(dilation: Dilation) -> Tuple[int, int]:
    """Normalize an int or pair to per-axis ``(dh, dw)``."""
    if isinstance(dilation, int):
        dilation = (dilation, dilation)
    dh, dw = dilation
    if dh < 1 or dw < 1:
        raise ValueError(f"dilation must be >= 1 per axis, got {(dh, dw)}")
    return (int(dh), int(dw))


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Frozen conv geometry: extents + groups/dilation + normalized pads.

    ``pads`` are explicit per-edge ``((ph_lo, ph_hi), (pw_lo, pw_hi))``;
    build via :meth:`make` to normalize string/int paddings (SAME uses the
    *effective* dilated filter extent) and int dilations.
    """

    n: int
    hi: int
    wi: int
    ci: int
    co: int
    hf: int
    wf: int
    stride: int = 1
    pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))
    groups: int = 1
    dilation: Tuple[int, int] = (1, 1)

    def __post_init__(self):
        (ph0, ph1), (pw0, pw1) = self.pads
        object.__setattr__(self, "pads",
                           ((int(ph0), int(ph1)), (int(pw0), int(pw1))))
        object.__setattr__(self, "dilation", as_dilation(self.dilation))
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.ci % self.groups or self.co % self.groups:
            raise ValueError(
                f"groups={self.groups} must divide both ci={self.ci} and "
                f"co={self.co}")

    @classmethod
    def make(cls, n: int, hi: int, wi: int, ci: int, co: int, hf: int,
             wf: int, stride: int = 1, padding: Padding = "VALID",
             groups: int = 1, dilation: Dilation = 1) -> "ConvSpec":
        """Normalize ``padding``/``dilation`` and build the frozen spec.

        Specs are cached by their arguments (a spec is frozen), so a layer
        that builds one at every call pays for it once."""
        if not isinstance(padding, (str, int)):
            padding = tuple(tuple(p) for p in padding)
        if not isinstance(dilation, int):
            dilation = tuple(dilation)
        return _make(cls, n, hi, wi, ci, co, hf, wf, stride, padding, groups,
                     dilation)

    @property
    def hf_eff(self) -> int:
        """Dilated filter extent: the halo a tap span actually covers."""
        return (self.hf - 1) * self.dilation[0] + 1

    @property
    def wf_eff(self) -> int:
        return (self.wf - 1) * self.dilation[1] + 1

    @property
    def padded_hi(self) -> int:
        return self.hi + self.pads[0][0] + self.pads[0][1]

    @property
    def padded_wi(self) -> int:
        return self.wi + self.pads[1][0] + self.pads[1][1]

    @property
    def ho(self) -> int:
        return out_size(self.padded_hi, self.hf_eff, self.stride)

    @property
    def wo(self) -> int:
        return out_size(self.padded_wi, self.wf_eff, self.stride)

    @property
    def cig(self) -> int:
        """Input channels per group — the weight tensor's I extent."""
        return self.ci // self.groups

    @property
    def is_dense(self) -> bool:
        """Ungrouped and undilated: the geometry of the dense kernels."""
        return self.groups == 1 and self.dilation == (1, 1)

    @property
    def is_grouped(self) -> bool:
        return self.groups > 1

    @property
    def is_depthwise(self) -> bool:
        """One channel per group, multiplier 1: MobileNet's dw conv."""
        return self.groups > 1 and self.groups == self.ci == self.co

    @property
    def is_pointwise(self) -> bool:
        """1x1 dense stride-1 unpadded conv: a pure channel matmul."""
        return (self.hf == 1 and self.wf == 1 and self.stride == 1
                and self.groups == 1 and self.pads == ((0, 0), (0, 0)))

    def flops(self) -> int:
        """MACs x2; each output channel contracts ``cig`` inputs per tap."""
        return (2 * self.n * self.ho * self.wo * self.hf * self.wf
                * self.cig * self.co)


@functools.lru_cache(maxsize=4096)
def _make(cls, n, hi, wi, ci, co, hf, wf, stride, padding, groups,
          dilation) -> ConvSpec:
    dh, dw = as_dilation(dilation)
    pads = normalize_padding(padding, (hf - 1) * dh + 1, (wf - 1) * dw + 1,
                             stride, hi, wi)
    return cls(n, hi, wi, ci, co, hf, wf, stride, pads, groups, (dh, dw))
