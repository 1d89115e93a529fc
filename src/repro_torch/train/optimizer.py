"""AdamW and learning-rate schedules, the port of ``repro/train/optimizer.py``
(``OptState``, ``global_norm``, ``cosine_schedule``, ``linear_warmup``,
``AdamW``).

The arithmetic is the reference's: b2 = 0.95, the gradients scaled to a
global norm of at most ``grad_clip``, bias-corrected moments, decoupled
weight decay on every parameter, and the learning rate read at the step
count *after* it is incremented.  Unlike the reference's pure function,
``AdamW.update`` works in place: it updates the parameters and the moment
tensors of the ``OptState`` it is given, and bumps its step.
``zero1_shardings`` waits for the sharding slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

__all__ = ["AdamW", "OptState", "cosine_schedule", "linear_warmup",
           "global_norm"]


@dataclasses.dataclass
class OptState:
    """Step count and the f32 first and second moments, by parameter name."""
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element, in f32, on the device."""
    return torch.sqrt(sum(t.to(torch.float32).square().sum()
                          for t in tensors))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at step ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return peak * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
    return lr


def linear_warmup(peak: float, warmup: int) -> Callable[[int], float]:
    return lambda step: peak * min(step + 1, warmup) / warmup


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        """Zero f32 moments shaped like ``params``, on their devices."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return OptState(step=0, mu={k: zeros(p) for k, p in params.items()},
                        nu={k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
        """One step, in place on ``params`` and ``state`` -> metrics
        ``{"grad_norm": tensor, "lr": float}`` (the norm before clipping)."""
        if set(grads) != set(params) or set(state.mu) != set(params):
            raise ValueError("grads, state and params must name the same "
                             "parameters")
        state.step += 1
        gn = global_norm(grads.values())
        scale = None
        if self.grad_clip is not None:
            scale = torch.clamp(self.grad_clip / torch.clamp(gn, min=1e-9),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** state.step
        bc2 = 1 - b2 ** state.step
        lr = float(self.lr(state.step))
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            if scale is not None:
                g = g * scale
            m, v = state.mu[name], state.nu[name]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        return {"grad_norm": gn, "lr": lr}
