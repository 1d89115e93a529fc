"""Decoder-only language models with a prefill and a decode API.

The port of ``repro/nn/models.py``'s ``LM`` for one device.  The reference
stacks each layer-pattern period on a leading axis and runs the periods
under ``lax.scan``; the port keeps one ``DecoderLayer`` per layer in a
``ModuleList`` (layer ``i`` has kind ``cfg.layer_kinds()[i % period]``) and
loops over them in Python, so its parameter names are ``layers.{i}.<path>``
where the reference has ``layers/b{i % period}/<path>[i // period]``
(``convert.params_from_jax`` maps one onto the other).

The vocabulary is padded to a multiple of 128 (the reference's
``padded_vocab`` without a mesh) and the logits are f32 over the padded
vocabulary.  ``embed_scale``, ``learned_pos``, ``final_softcap`` and tied or
untied heads are kept.  ``build_model`` raises for an encoder-decoder
config, and a config with MoE or cross-attention layers raises when its
layers are built: they wait for ROADMAP queue A item 13.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.nn.blocks import DecoderLayer, make_norm
from repro_torch.nn.layers import Embedding, Init, cast_specs, softcap
from repro_torch.nn.module import register_tree, ParamSpec

__all__ = ["LM", "build_model", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


class LM(torch.nn.Module):
    """Decoder-only LM: ``forward(tokens) -> (logits, aux)``, ``init_cache``
    and ``decode_step``.  Parameters are drawn from ``generator`` (a CPU
    generator, seed 0 by default) in the config's ``param_dtype`` on
    ``device``; activations run in the config's ``dtype``."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.encoder is not None:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP "
                "queue A item 13)")
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        init = Init(gen, self.device, DTYPES[cfg.param_dtype])
        self.dtype = DTYPES[cfg.dtype]
        self.padded_heads = cfg.n_heads
        self.padded_vocab = -(-cfg.vocab_size // 128) * 128
        self.period = cfg.period
        kinds = cfg.layer_kinds()
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, init,
                               padded_vocab=self.padded_vocab)
        self.layers = torch.nn.ModuleList(
            DecoderLayer(cfg, kinds[i % self.period], init)
            for i in range(cfg.n_layers))
        self.final_norm = make_norm(cfg, init)
        top = {}
        if cfg.learned_pos:
            top["pos"] = ParamSpec((cfg.max_seq_len, cfg.d_model),
                                   init="normal", scale=0.02,
                                   dtype=init.dtype)
        if not cfg.tie_embeddings:
            top["lm_head"] = ParamSpec((cfg.d_model, self.padded_vocab),
                                       dtype=init.dtype)
        register_tree(self, top, gen, self.device)

    # -- specs ---------------------------------------------------------------
    def specs(self):
        """The parameter specs in the reference's layout: each layer-pattern
        period's layers ``b{j}`` stacked on a leading axis of ``n_layers //
        period``, every spec in the config's ``param_dtype``."""
        n_periods = self.cfg.n_layers // self.period

        def stacked(spec):
            if isinstance(spec, ParamSpec):
                return dataclasses.replace(spec,
                                           shape=(n_periods,) + spec.shape)
            return {k: stacked(v) for k, v in spec.items()}

        tree = {"embed": self.embed.specs(),
                "layers": {f"b{j}": stacked(self.layers[j].specs())
                           for j in range(self.period)},
                "final_norm": self.final_norm.specs()}
        if self.cfg.learned_pos:
            tree["pos"] = ParamSpec((self.cfg.max_seq_len, self.cfg.d_model),
                                    init="normal", scale=0.02)
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = ParamSpec((self.cfg.d_model,
                                         self.padded_vocab))
        return cast_specs(tree, DTYPES[self.cfg.param_dtype])

    # -- the head ------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens, dtype=self.dtype)
        if self.cfg.embed_scale:
            x = (x.float() * math.sqrt(self.cfg.d_model)).to(self.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.cfg.tie_embeddings:
            logits = self.embed.attend(x)
        else:
            logits = x @ self.lm_head.to(x.dtype)
        return softcap(logits.float(), self.cfg.final_softcap)

    # -- forward -------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, *, chunk: int = 2048):
        """tokens [B, S] -> (f32 logits [B, S, padded_vocab], aux)."""
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = _positions(b, s, tokens.device)
        if self.cfg.learned_pos:
            x = x + self.pos.to(self.dtype)[positions]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, a = layer(x, positions=positions, chunk=chunk)
            aux = aux + a
        return self._logits(x), aux

    # -- serving -------------------------------------------------------------
    def cache_window(self, cache_len: int) -> int:
        return cache_len

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> List:
        """One decode cache per layer (a ``KVCache`` or ``MambaCache``)."""
        return [layer.init_cache(batch, cache_len, dtype, self.device)
                for layer in self.layers]

    def decode_step(self, cache: List, tokens: torch.Tensor, pos: int):
        """tokens: [B, 1]; pos: the global position -> (f32 logits [B, 1,
        padded_vocab], new cache).  Attention layers write the token's K/V
        into their ``cache`` entries in place; Mamba layers return new
        states."""
        x = self._embed(tokens)
        if self.cfg.learned_pos:
            x = x + self.pos.to(self.dtype)[pos][None, None]
        new_cache = []
        for layer, entry in zip(self.layers, cache):
            x, entry = layer.decode(x, entry, pos)
            new_cache.append(entry)
        return self._logits(x), new_cache


def build_model(cfg: ModelConfig, device: Union[str, torch.device] = "cuda",
                generator: Optional[torch.Generator] = None) -> LM:
    """The model of ``cfg`` on ``device`` (the GPU unless the caller asks
    for the CPU)."""
    return LM(cfg, device, generator)
