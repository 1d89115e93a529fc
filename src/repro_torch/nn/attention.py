"""Attention: GQA + RoPE + sliding window + soft-capping, with the
flash-attention kernel on the full-sequence path and a ring-cache decode.

The port of ``repro/nn/attention.py`` for one device.  ``Attention.forward``
(the reference's ``__call__``: train, prefill) projects q, k and v, applies
rope, and calls ``kernels.flash_attention.attend`` on the grouped layout
``[B, S, KV, G, Dh]``: the CUDA kernel on the card, the plain chunked
online softmax on the CPU.  ``Attention.decode`` is one token against a
ring-buffer KV cache (``_decode_update_and_attend``, the reference's
single-device ``flash_decode``); it stays plain torch, as the reference
computes it with jnp outside any Pallas kernel.  Decode writes the new
token's K/V row into the ring cache in place and returns that cache: a
server that steps some slots keeps the others' rows itself
(``serve.scheduler``).

Not ported yet (ROADMAP queue A item 13): cross-attention (``cross=True``,
``from_kv``) with the encoder-decoder, and sharding (padded heads,
``flash_decode``'s ``shard_map`` over a sequence-sharded cache).
``padded_heads`` equals ``n_heads``: without a mesh the reference pads
nothing, so there is no head mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import NEG_INF, attend
from repro_torch.nn.layers import Init, SpecModule, rope, softcap
from repro_torch.nn.module import ParamSpec

__all__ = ["Attention", "KVCache", "init_kv_cache", "flash_decode"]


class KVCache(NamedTuple):
    """Ring-buffer KV cache for one layer.  k/v: [B, W, KV, Dh]."""
    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(batch: int, window: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> KVCache:
    shape = (batch, window, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _decode_update_and_attend(q, k_new, v_new, ck, cv, pos: int, *,
                              window: Optional[int], cap, scale):
    """q: [B,KV,G,Dh]; k_new/v_new: [B,KV,Dh]; ck/cv: [B, W, KV, Dh] ring
    buffers; pos: the index of the token being written.  -> (out
    [B,KV,G,Dh], ck, cv), with the new row written into ck and cv in
    place."""
    w_total = ck.shape[1]
    slot = pos % w_total
    ck[:, slot] = k_new.to(ck.dtype)
    cv[:, slot] = v_new.to(cv.dtype)

    # validity: ring slot j holds global position p(j) = pos - ((slot - j) mod W)
    j = torch.arange(w_total, device=q.device)
    gpos = pos - torch.remainder(slot - j, w_total)
    valid = gpos >= 0
    if window is not None:
        valid = valid & (gpos > pos - window)

    s = torch.einsum("bkgd,bwkd->bkgw", q.float(), ck.float()) * scale
    s = softcap(s, cap)
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    m_loc = s.amax(dim=-1)
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bkgw,bwkd->bkgd", p, cv.float())
    out = o_loc / torch.clamp_min(l_loc[..., None], 1e-37)
    return out.to(q.dtype), ck, cv


def flash_decode(q, k_new, v_new, cache: KVCache, pos: int, *, window, cap,
                 scale) -> Tuple[torch.Tensor, KVCache]:
    """One decode step against a ring cache on one device; the cache is
    updated in place."""
    out, ck, cv = _decode_update_and_attend(
        q, k_new, v_new, cache.k, cache.v, pos, window=window, cap=cap,
        scale=scale)
    return out, KVCache(ck, cv)


class Attention(SpecModule):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, init: Init, rope_theta: float = 10000.0,
                 use_rope: bool = True, qk_norm: bool = False,
                 use_bias: bool = False, scale: Optional[float] = None,
                 cross: bool = False, norm_eps: float = 1e-6):
        super().__init__()
        if cross:
            raise NotImplementedError(
                "cross-attention (and the encoder-decoder) is not ported "
                "yet: ROADMAP queue A item 13")
        self.d_model, self.n_heads = d_model, n_heads
        self.n_kv_heads, self.head_dim = n_kv_heads, head_dim
        self.padded_heads = n_heads
        self.rope_theta, self.use_rope = rope_theta, use_rope
        self.qk_norm, self.use_bias = qk_norm, use_bias
        self.scale, self.norm_eps = scale, norm_eps
        self._draw(init)

    @property
    def _scale(self) -> float:
        return self.scale if self.scale is not None else self.head_dim ** -0.5

    @property
    def groups(self) -> int:
        return self.padded_heads // self.n_kv_heads

    def specs(self):
        d, dh = self.d_model, self.head_dim
        hp, kv = self.padded_heads, self.n_kv_heads
        # fan-in over the contracted size, so that scores start O(1) (the
        # reference's rule takes the heads axis: ROADMAP section C)
        s = {"q": {"w": ParamSpec((d, hp, dh), fan_in=d)},
             "k": {"w": ParamSpec((d, kv, dh), fan_in=d)},
             "v": {"w": ParamSpec((d, kv, dh), fan_in=d)},
             "o": {"w": ParamSpec((hp, dh, d), fan_in=hp * dh)}}
        if self.use_bias:
            s["q"]["b"] = ParamSpec((hp, dh), init="zeros")
            s["k"]["b"] = ParamSpec((kv, dh), init="zeros")
            s["v"]["b"] = ParamSpec((kv, dh), init="zeros")
            s["o"]["b"] = ParamSpec((d,), init="zeros")
        if self.qk_norm:
            s["q_norm"] = {"w": ParamSpec((dh,), init="ones")}
            s["k_norm"] = {"w": ParamSpec((dh,), init="ones")}
        return s

    # -- helpers -----------------------------------------------------------
    def _norm(self, w, x):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.norm_eps) * w.float()).to(x.dtype)

    def _project(self, x, which: str):
        """x [B, S, D] @ w [D, n, Dh] -> [B, S, n, Dh]."""
        p = getattr(self, which)
        w = p.w.to(x.dtype)
        y = (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:2],
                                                     *w.shape[1:])
        if self.use_bias:
            y = y + p.b.to(x.dtype)
        return y

    def qkv(self, x, kv_src, positions, kv_positions):
        q = self._project(x, "q")
        k = self._project(kv_src, "k")
        v = self._project(kv_src, "v")
        if self.qk_norm:
            q = self._norm(self.q_norm.w, q)
            k = self._norm(self.k_norm.w, k)
        if self.use_rope:
            q = rope(q, positions, self.rope_theta)
            k = rope(k, kv_positions, self.rope_theta)
        return q, k, v

    def output(self, ctx):
        """ctx: [B,S,Hp,Dh] -> the o-projection [B, S, D]."""
        w = self.o.w.to(ctx.dtype)
        y = ctx.reshape(*ctx.shape[:2], -1) @ w.reshape(-1, w.shape[-1])
        if self.use_bias:
            y = y + self.o.b.to(ctx.dtype)
        return y

    # -- full paths ----------------------------------------------------------
    def forward(self, x, *, positions, causal=True, window=None, cap=None,
                chunk=2048):
        """Prefill self-attention through the flash kernel."""
        q, k, v = self.qkv(x, x, positions, positions)
        b, s, hp, dh = q.shape
        qg = q.reshape(b, s, self.n_kv_heads, self.groups, dh)
        ctx = attend(qg, k, v, q_positions=positions, kv_positions=positions,
                     causal=causal, window=window, cap=cap, scale=self._scale,
                     chunk=chunk)
        return self.output(ctx.reshape(b, s, hp, dh))

    def from_kv(self, *args, **kwargs):
        raise NotImplementedError(
            "cross-attention against precomputed K/V is not ported yet: "
            "ROADMAP queue A item 13")

    def decode(self, x, cache: KVCache, pos: int, *, window=None, cap=None):
        """One-token step.  x: [B, 1, D]; pos: the global position."""
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        q, k, v = self.qkv(x, x, positions, positions)
        qg = q.reshape(b, self.n_kv_heads, self.groups, self.head_dim)
        ctx, new_cache = flash_decode(qg, k[:, 0], v[:, 0], cache, pos,
                                      window=window, cap=cap,
                                      scale=self._scale)
        ctx = ctx.reshape(b, 1, self.padded_heads, self.head_dim)
        return self.output(ctx), new_cache
