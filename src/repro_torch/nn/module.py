"""Parameter specs and their seeded initialization on a ``torch.Generator``.

A layer describes its parameters as ``{name: ParamSpec}``; ``init_tree``
draws them in the dict's order from one explicit generator.  Draws happen on
the CPU and the result moves to ``device``, so a seed gives the same numbers
on every device.  The reference initializes from ``jax.random`` keys, which
give other numbers; tests that compare the two packages feed both the same
numpy parameters instead (``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

__all__ = ["ParamSpec", "init_tree"]

SpecTree = Union["ParamSpec", Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "fan_in"            # fan_in | normal | zeros
    scale: float = 1.0              # multiplier (normal: stddev)


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    if spec.init == "normal":
        return spec.scale * torch.randn(spec.shape, generator=gen)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return std * torch.randn(spec.shape, generator=gen)
    raise ValueError(f"unknown init {spec.init!r}")


def init_tree(specs: SpecTree, gen: torch.Generator,
              device: Union[str, torch.device] = "cpu") -> Any:
    """Draw every spec of a (nested) dict from ``gen`` (a CPU generator), in
    the dict's order, as f32 tensors on ``device``."""
    if isinstance(specs, ParamSpec):
        return _init_one(specs, gen).to(device=device, dtype=torch.float32)
    return {k: init_tree(v, gen, device) for k, v in specs.items()}
