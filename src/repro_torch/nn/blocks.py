"""Decoder layer blocks composed per ``ModelConfig``.

The port of ``repro/nn/blocks.py``'s ``DecoderLayer`` for the mixers
``attn`` (through the flash-attention kernel) and ``mamba`` (through the
conv1d kernel) and the MLPs ``dense`` and ``none``, with gemma2's
``post_norm`` sandwich and per-layer ``window``.  A layer with an MoE MLP
or a cross-attention mixer, and the encoder layer, raise
``NotImplementedError``: they wait for ROADMAP queue A item 13.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.nn.attention import Attention, init_kv_cache
from repro_torch.nn.layers import MLP, Init, LayerNorm, RMSNorm
from repro_torch.nn.ssm import Mamba2

__all__ = ["DecoderLayer", "make_norm"]


def make_norm(cfg: ModelConfig, init: Init):
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, init, cfg.norm_eps)
    return RMSNorm(cfg.d_model, init, cfg.norm_eps,
                   zero_centered=cfg.post_norm)     # gemma2 stores (1+w)


class DecoderLayer(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, kind: LayerKind, init: Init):
        super().__init__()
        if kind.mlp == "moe" or kind.mixer == "cross_attn":
            raise NotImplementedError(
                f"{cfg.name}: a layer with mixer {kind.mixer!r} and mlp "
                f"{kind.mlp!r} is not ported yet (MoE and cross-attention "
                "are ROADMAP queue A item 13)")
        if kind.mixer not in ("attn", "mamba") or \
                kind.mlp not in ("dense", "none"):
            raise ValueError(f"unknown layer kind {kind}")
        self.cfg, self.kind = cfg, kind
        c = cfg
        self.norm1 = make_norm(c, init)
        if kind.mixer == "mamba":
            self.mamba = Mamba2(c.d_model, c.ssm, init, c.norm_eps)
        else:
            self.attn = Attention(
                d_model=c.d_model, n_heads=c.n_heads,
                n_kv_heads=c.n_kv_heads, head_dim=c.head_dim, init=init,
                rope_theta=c.rope_theta, use_rope=c.use_rope,
                qk_norm=c.qk_norm, use_bias=c.use_bias, scale=c.attn_scale,
                norm_eps=c.norm_eps)
        if c.post_norm:
            self.post_norm1 = make_norm(c, init)
        if kind.mlp != "none":
            self.norm2 = make_norm(c, init)
            self.mlp = MLP(c.d_model, c.d_ff, init, act=c.mlp_act,
                           use_bias=c.use_bias)
            if c.post_norm:
                self.post_norm2 = make_norm(c, init)

    def specs(self):
        """The layer's parameter specs, nested as its modules are (the
        reference's ``DecoderLayer.specs`` tree)."""
        return {name: (child.specs() if hasattr(child, "specs") else
                       {n: c.specs() for n, c in child.named_children()})
                for name, child in self.named_children()}

    def _mix(self, h, positions, chunk):
        if self.kind.mixer == "mamba":
            return self.mamba(h)
        return self.attn(h, positions=positions, causal=True,
                         window=self.kind.window, cap=self.cfg.attn_softcap,
                         chunk=chunk)

    def _residual_mlp(self, x):
        if self.kind.mlp == "none":
            return x
        y = self.mlp(self.norm2(x))
        if self.cfg.post_norm:
            y = self.post_norm2(y)
        return x + y

    # -- forward (prefill) -------------------------------------------------
    def forward(self, x, *, positions, chunk: int = 2048):
        """-> (x, aux); aux is 0 (only an MoE MLP has an auxiliary loss)."""
        y = self._mix(self.norm1(x), positions, chunk)
        if self.cfg.post_norm:
            y = self.post_norm1(y)
        x = self._residual_mlp(x + y)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # -- decode --------------------------------------------------------------
    def init_cache(self, batch: int, window: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
        c = self.cfg
        if self.kind.mixer == "mamba":
            return self.mamba.init_cache(batch, dtype, device)
        w = min(window, self.kind.window) if self.kind.window else window
        return init_kv_cache(batch, w, c.n_kv_heads, c.head_dim, dtype,
                             device)

    def decode(self, x, cache, pos: int):
        """x: [B,1,D] one token; -> (x, new_cache)."""
        h = self.norm1(x)
        if self.kind.mixer == "mamba":
            y, cache = self.mamba.decode(h, cache)
        else:
            y, cache = self.attn.decode(h, cache, pos,
                                        window=self.kind.window,
                                        cap=self.cfg.attn_softcap)
        if self.cfg.post_norm:
            y = self.post_norm1(y)
        return self._residual_mlp(x + y), cache
