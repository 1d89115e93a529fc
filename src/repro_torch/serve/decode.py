"""Serving steps: single-token decode, the decode-loop prefill, and the
samplers.  The port of ``repro/serve/decode.py`` for the decoder-only
``nn.models.LM``; everything runs without autograd.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.nn.models import LM

__all__ = ["make_serve_step", "make_prefill", "greedy", "sample_topk"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def sample_topk(logits: torch.Tensor, generator: torch.Generator,
                k: int = 40, temp: float = 1.0) -> torch.Tensor:
    """Sample one token per row among the ``k`` largest logits, from an
    explicit generator (on the logits' device)."""
    lf = logits[:, -1].float() / max(temp, 1e-6)
    vals, idx = torch.topk(lf, k, dim=-1)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                               generator=generator)
    return torch.gather(idx, 1, choice)[:, 0].to(torch.int32)


def make_serve_step(model: LM) -> Callable:
    """-> ``serve_step(cache, tokens [B, 1], pos) -> (logits, cache)``: one
    new token against the ring or SSM cache; the old cache is not
    modified."""
    def serve_step(cache: List, tokens: torch.Tensor, pos: int):
        with torch.no_grad():
            return model.decode_step(cache, tokens, pos)
    return serve_step


def make_prefill(model: LM, cache_len: int) -> Callable:
    """Sequential prefill through the decode path (the exactness oracle of
    the full-sequence prefill): ``prefill(tokens [B, S], cache=None) ->
    (logits of the last token, cache, next position)``."""
    serve_step = make_serve_step(model)

    def prefill(tokens: torch.Tensor, cache: Optional[List] = None
                ) -> Tuple[torch.Tensor, List, int]:
        b, s = tokens.shape
        if cache is None:
            cache = model.init_cache(b, cache_len)
        logits = torch.zeros((b, 1, model.padded_vocab), dtype=torch.float32,
                             device=tokens.device)
        for t in range(s):
            logits, cache = serve_step(cache, tokens[:, t:t + 1], t)
        return logits, cache, s
    return prefill
