"""Reduced (smoke-test) variants of the 10 architectures, copied from the
reference's ``repro/configs/reduced.py``.

Same family/structure — layer pattern, MoE top-k, SSM, softcaps, enc-dec,
cross-attention — at toy width/depth so one forward/train step runs on CPU in
seconds.
"""
from __future__ import annotations

import dataclasses

from .base import EncoderConfig, ModelConfig
from .registry import get_config

__all__ = ["reduced_config"]


def reduced_config(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    r = dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=64,
        vocab_size=211,
        max_seq_len=64,
        param_dtype="float32",
        dtype="float32",
    )
    if cfg.n_heads:
        kv = max(2, min(cfg.n_kv_heads, 4))
        heads = max(kv, 4)
        r = dataclasses.replace(r, n_heads=heads, n_kv_heads=kv, head_dim=16,
                                d_ff=128 if cfg.d_ff else 0)
    if cfg.window:
        r = dataclasses.replace(r, window=8)
    if cfg.moe:
        r = dataclasses.replace(r, moe=dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64))
    if cfg.ssm:
        r = dataclasses.replace(r, ssm=dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=8))
    if cfg.encoder:
        r = dataclasses.replace(r, encoder=EncoderConfig(n_layers=2,
                                                         max_frames=12))
    if cfg.cross_attn_period:
        r = dataclasses.replace(r, n_img_tokens=8)
    # depth: keep >= 2 periods of the layer pattern
    period = r.period
    r = dataclasses.replace(r, n_layers=2 * period)
    # gemma2 attn_scale depends on d_model/H
    if cfg.attn_scale is not None:
        r = dataclasses.replace(r, attn_scale=(r.d_model / r.n_heads) ** -0.5)
    return r
