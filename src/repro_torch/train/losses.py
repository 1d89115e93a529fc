"""Cross-entropy, the port of ``repro/train/losses.py:73`` ``cross_entropy``.

The mean negative log-likelihood and the accuracy, both in f32, over a
``[B, S, Vp]`` logit tensor whose columns past ``vocab`` are padding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["cross_entropy"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits ``[B, S, Vp]`` (cast to f32 here), targets ``[B, S]`` integer
    -> ``(mean_nll, {"nll", "accuracy", "tokens"})``.  Columns at or past
    ``vocab`` are masked to -1e30 before the log-sum-exp; ``mask`` weights
    each position (1 everywhere when None)."""
    logits = logits.to(torch.float32)
    vp = logits.shape[-1]
    if vp != vocab:
        col = torch.arange(vp, device=logits.device).view(1, 1, vp)
        logits = torch.where(col < vocab, logits,
                             torch.full_like(logits, -1e30))
    targets = targets.to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - ll
    mask = (torch.ones_like(nll) if mask is None
            else mask.to(device=nll.device, dtype=torch.float32))
    tot = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / tot
    acc = ((logits.argmax(-1) == targets).to(torch.float32) * mask).sum() / tot
    return loss, {"nll": loss, "accuracy": acc, "tokens": tot}
