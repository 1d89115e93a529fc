"""Serve a language model with continuous batching over the batched decode
step: the port of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch h2o-danube-1.8b --reduced \\
        [--requests 6] [--batch 2] [--cache-len 64] [--max-new 8] \\
        [--seed 0] [--device cuda]

Weights are drawn from ``--seed`` (the port's generator); prompts of 3-11
tokens are drawn with numpy from the same seed.  ``--device`` defaults to
``cuda`` and fails without a GPU; ``--device cpu`` runs the plain path.
Decoder-only configs whose layers are attention or Mamba-2 with dense or no
MLPs are served (h2o-danube-1.8b, mamba2-780m, gemma2-27b, ...); MoE,
cross-attention and the encoder-decoder raise.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.reduced import reduced_config
from repro_torch.configs.registry import get_config
from repro_torch.nn.models import build_model
from repro_torch.serve.scheduler import ContinuousBatcher, Request

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, args.device,
                        torch.Generator().manual_seed(args.seed))
    print(f"[serve] {cfg.name}: {cfg.n_params() / 1e6:.1f}M params on "
          f"{model.device}")

    rng = np.random.default_rng(args.seed)
    batcher = ContinuousBatcher(model, batch=args.batch,
                                cache_len=args.cache_len)
    for i in range(args.requests):
        plen = int(rng.integers(3, 12))
        batcher.submit(Request(rid=i,
                               prompt=rng.integers(0, cfg.vocab_size, (plen,),
                                                   dtype=np.int32),
                               max_new_tokens=args.max_new))
    done = batcher.run()
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: {r.prompt.tolist()} -> {r.out_tokens}")
    print(f"[serve] completed {len(done)} requests in "
          f"{batcher.decode_steps} decode steps")
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
