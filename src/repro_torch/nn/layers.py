"""Basic layers: projections, embeddings, norms, MLPs, positional encodings.

The port of ``repro/nn/layers.py``.  Each layer is an ``nn.Module`` whose
parameters are drawn from its ``specs()`` (``nn.module.register_tree``) in
the layer's parameter dtype, and whose ``forward`` keeps every casting point
of the reference: norms and rope in f32 and then one cast back, SiLU/GELU in
f32 and then a cast, projections in the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.module import ParamSpec, register_tree

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "MLP", "rope",
           "sinusoidal_positions", "softcap", "cast_specs", "Init"]


@dataclasses.dataclass(frozen=True)
class Init:
    """Where and how a module's parameters are drawn: the CPU generator,
    the device they live on and the parameter dtype (the config's
    ``param_dtype``)."""

    gen: torch.Generator
    device: torch.device
    dtype: torch.dtype = torch.float32


def cast_specs(specs: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Every spec of the tree in ``dtype`` (the reference's
    ``cast_float_specs``: all of its specs are floating point)."""
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(specs, dtype=dtype)
    return {k: cast_specs(v, dtype) for k, v in specs.items()}


class SpecModule(torch.nn.Module):
    """A module whose parameters are its ``specs()``, drawn at construction."""

    def specs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _draw(self, init: Init) -> None:
        register_tree(self, cast_specs(self.specs(), init.dtype), init.gen,
                      init.device)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


class Linear(SpecModule):
    def __init__(self, d_in: int, d_out: int, init: Init,
                 use_bias: bool = False):
        super().__init__()
        self.d_in, self.d_out, self.use_bias = d_in, d_out, use_bias
        self._draw(init)

    def specs(self):
        s = {"w": ParamSpec((self.d_in, self.d_out), init="fan_in")}
        if self.use_bias:
            s["b"] = ParamSpec((self.d_out,), init="zeros")
        return s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.use_bias:
            y = y + self.b.to(x.dtype)
        return y


class Embedding(SpecModule):
    def __init__(self, vocab: int, d: int, init: Init,
                 padded_vocab: Optional[int] = None):
        super().__init__()
        self.vocab, self.d = vocab, d
        self.rows = padded_vocab or vocab
        self._draw(init)

    def specs(self):
        return {"w": ParamSpec((self.rows, self.d), init="normal",
                               scale=0.02)}

    def forward(self, tokens: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        # gather, then cast: the same values as the reference's cast table
        return F.embedding(tokens, self.w).to(dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-logits head: [..., d] @ [d, vocab_padded]."""
        return x @ self.w.to(x.dtype).T


class RMSNorm(SpecModule):
    def __init__(self, d: int, init: Init, eps: float = 1e-5,
                 zero_centered: bool = False):
        super().__init__()
        self.d, self.eps, self.zero_centered = d, eps, zero_centered
        self._draw(init)

    def specs(self):
        init = "zeros" if self.zero_centered else "ones"
        return {"w": ParamSpec((self.d,), init=init)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        var = torch.mean(x * x, dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        w = self.w.float()
        if self.zero_centered:
            w = 1.0 + w
        return (x * w).to(dtype)


class LayerNorm(SpecModule):
    def __init__(self, d: int, init: Init, eps: float = 1e-5):
        super().__init__()
        self.d, self.eps = d, eps
        self._draw(init)

    def specs(self):
        return {"w": ParamSpec((self.d,), init="ones"),
                "b": ParamSpec((self.d,), init="zeros")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        x = (x - mu) * torch.rsqrt(var + self.eps)
        return (x * self.w.float() + self.b.float()).to(dtype)


class MLP(torch.nn.Module):
    """SwiGLU (llama-family) or GELU (whisper) feed-forward."""

    def __init__(self, d_model: int, d_ff: int, init: Init,
                 act: str = "swiglu", use_bias: bool = False):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.gate = Linear(d_model, d_ff, init)
            self.up = Linear(d_model, d_ff, init)
            self.down = Linear(d_ff, d_model, init)
        elif act == "gelu":
            self.fc1 = Linear(d_model, d_ff, init, use_bias=use_bias)
            self.fc2 = Linear(d_ff, d_model, init, use_bias=use_bias)
        else:
            raise ValueError(f"unknown mlp_act {act!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "swiglu":
            h = F.silu(self.gate(x).float()).to(x.dtype) * self.up(x)
            return self.down(h)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(self.fc1(x).float(), approximate="tanh").to(x.dtype)
        return self.fc2(h)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x: [B, S, H, D_h], positions: [B, S]
    (int)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]                          # [B, S, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper-style sinusoidal table [n, d]."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / max(half - 1, 1))
    ang = (torch.arange(n, dtype=torch.float32, device=device)[:, None]
           * freqs[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
