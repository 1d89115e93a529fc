"""Parameter specs and their seeded initialization on a ``torch.Generator``.

A layer describes its parameters as ``{name: ParamSpec}``; ``init_tree``
draws them in the dict's order from one explicit generator.  Draws happen on
the CPU in f32 and the result moves to ``device`` in the spec's ``dtype``, so
a seed gives the same numbers on every device (and a bf16 parameter is the
f32 draw rounded once, as the reference casts it).  ``ParamSpec`` carries no
sharding ``axes``: there is no mesh in the port yet.  ``fan_in`` overrides
the reference's rule (the second-to-last axis) where that axis is not what
the weight contracts, as in attention's ``[D, H, Dh]`` projections.
``log_uniform`` and ``softplus_inv_log_uniform`` draw Mamba-2's ``a_log``
and ``dt_bias`` as the published model does, from ``bounds``.  The
reference initializes from ``jax.random`` keys, which
give other numbers; tests that compare the two packages feed both the same
numpy parameters instead (``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

__all__ = ["ParamSpec", "init_tree", "register_tree"]

SpecTree = Union["ParamSpec", Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    # fan_in | normal | zeros | ones | log_uniform | softplus_inv_log_uniform
    init: str = "fan_in"
    scale: float = 1.0              # multiplier (normal: stddev)
    dtype: torch.dtype = torch.float32
    fan_in: Optional[int] = None    # None: the second-to-last axis
    bounds: Optional[Tuple[float, float]] = None   # the two *uniform inits


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    if spec.init == "ones":
        return torch.ones(spec.shape)
    if spec.init == "normal":
        return spec.scale * torch.randn(spec.shape, generator=gen)
    if spec.init == "fan_in":
        fan_in = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                                 else spec.shape[-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return std * torch.randn(spec.shape, generator=gen)
    if spec.init == "log_uniform":
        # log(u), u uniform in [low, high]
        low, high = spec.bounds
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float64)
        return torch.log(low + (high - low) * u).float()
    if spec.init == "softplus_inv_log_uniform":
        # softplus^-1(t), t log-uniform in [low, high]
        low, high = spec.bounds
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float64)
        t = torch.exp(math.log(low) + (math.log(high) - math.log(low)) * u)
        return (t + torch.log(-torch.expm1(-t))).float()
    raise ValueError(f"unknown init {spec.init!r}")


def init_tree(specs: SpecTree, gen: torch.Generator,
              device: Union[str, torch.device] = "cpu") -> Any:
    """Draw every spec of a (nested) dict from ``gen`` (a CPU generator), in
    the dict's order, as tensors of each spec's dtype on ``device``."""
    if isinstance(specs, ParamSpec):
        return _init_one(specs, gen).to(device=device, dtype=specs.dtype)
    return {k: init_tree(v, gen, device) for k, v in specs.items()}


def register_tree(module: torch.nn.Module, specs: Dict[str, Any],
                  gen: torch.Generator,
                  device: Union[str, torch.device] = "cpu") -> None:
    """Draw ``specs`` (see :func:`init_tree`) and register them on
    ``module``: a leaf as a parameter named by its key, a nested dict as a
    child module of the same name, so that ``state_dict`` keys follow the
    reference's parameter paths (``q.w``, ``norm.w``, ...).  The parameters
    do not require grad: the language models are served, not trained, until
    their training slice."""
    for name, spec in specs.items():
        if isinstance(spec, ParamSpec):
            module.register_parameter(name, torch.nn.Parameter(
                init_tree(spec, gen, device), requires_grad=False))
        else:
            child = torch.nn.Module()
            register_tree(child, spec, gen, device)
            module.add_module(name, child)
