"""Train a toy ``BlockedCNN`` of ``examples/train_conv_net.py`` with the
port.

    python -m repro_torch.launch.train_conv [--model dense|separable]
                                            [--steps 150] [--device cuda]
                                            [--seed 0] [--dtype f32|bf16]

The models are the example's ``MODELS``, channel pencil ``CB = 8``:
``dense`` is ``conv 8->16 (relu, SAME) -> conv 16->32 (relu, SAME, stride
2) -> GAP -> linear 32->8``; ``separable`` is the same widths and strides
as two ``DepthwiseSeparableBlock``s (3x3 depthwise, then 1x1 pointwise,
relu after each).  The
task is the example's too: 16x16 images of noise with one of 8 fixed 3x3
stamps at a random position, the class being the stamp, made with numpy
from ``--seed``.  AdamW runs with a cosine schedule (peak 1e-2, 10 warm-up
steps) and no weight decay.  On ``cuda`` (the default) every conv runs
through its family's forward, dgrad and wgrad kernels (dense, or depthwise
and pointwise); ``--device cpu`` runs their plain versions.  ``--dtype
bf16`` trains under the ``BF16`` policy, the counterpart of the example's
``--dtype bf16`` (``ConvContext(precision="bf16")``: bf16 operands and
saved pre-activations on the bf16 builds of the forward, dgrad and wgrad
kernels, dense or depthwise and pointwise, f32 master weights and AdamW,
the loss in f32).  At the end the trained
parameters classify a fresh batch through the fused inference path, under
the same policy.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.context import ConvContext
from repro_torch.core.device import resolve_device
from repro_torch.nn.conv import (BlockedCNN, BlockedConv2D,
                                 DepthwiseSeparableBlock)
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.trainstep import make_train_step

__all__ = ["CB", "N_CLASSES", "MODELS", "dense_model", "separable_model",
           "make_batch", "main"]

CB = 8            # channel pencil of the toy net
N_CLASSES = 8

# 8 fixed, mutually distinct 3x3 stamps (the classes), as in the example
_STAMPS = np.sign(np.random.default_rng(1234).normal(size=(8, 3, 3))) * 3.0


def dense_model(device: Union[str, torch.device] = "cuda",
                generator: Optional[torch.Generator] = None) -> BlockedCNN:
    """The example's ``MODELS["dense"]``, with weights from ``generator``."""
    convs = [BlockedConv2D(8, 16, 3, 3, stride=1, padding="SAME",
                           activation="relu", lane=CB, device=device,
                           generator=generator),
             BlockedConv2D(16, 32, 3, 3, stride=2, padding="SAME",
                           activation="relu", lane=CB, device=device,
                           generator=generator)]
    return BlockedCNN(convs, N_CLASSES, device=device, generator=generator)


def separable_model(device: Union[str, torch.device] = "cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> BlockedCNN:
    """The example's ``MODELS["separable"]``, with weights from
    ``generator``."""
    blocks = [DepthwiseSeparableBlock(8, 16, 3, 3, stride=1, padding="SAME",
                                      activation="relu", lane=CB,
                                      device=device, generator=generator),
              DepthwiseSeparableBlock(16, 32, 3, 3, stride=2, padding="SAME",
                                      activation="relu", lane=CB,
                                      device=device, generator=generator)]
    return BlockedCNN(blocks, N_CLASSES, device=device, generator=generator)


MODELS = {"dense": dense_model, "separable": separable_model}


def make_batch(rng: np.random.Generator, n: int = 128
               ) -> Tuple[np.ndarray, np.ndarray]:
    """A class-specific 3x3 stamp at a random position plus background
    noise -> ``(images [n, 16, 16, 8] f32, labels [n] int)``; the example's
    ``make_batch``, on numpy arrays."""
    ys = rng.integers(0, 8, n)
    xs = rng.normal(0, 0.1, (n, 16, 16, 1)).astype(np.float32)
    for i, y in enumerate(ys):
        r, c = rng.integers(0, 14, 2)       # 3x3 stamp: top-left in 0..13
        xs[i, r:r + 3, c:c + 3, 0] += _STAMPS[y]
    return xs.repeat(8, axis=-1), ys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="dense")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the precision policy")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    context = ConvContext(precision=args.dtype)
    model = MODELS[args.model](dev, torch.Generator().manual_seed(args.seed))
    opt = AdamW(lr=cosine_schedule(1e-2, 10, args.steps), weight_decay=0.0)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, context=context)
    tag = f"{args.model}/{dev.type}" + ("/bf16" if args.dtype == "bf16"
                                        else "")
    rng = np.random.default_rng(args.seed)

    def batch():
        x, y = make_batch(rng)
        return {"images": torch.from_numpy(x).to(dev),
                "targets": torch.from_numpy(y).to(dev)}

    for s in range(args.steps):
        loss, metrics = step(state, batch())
        if (s + 1) % 25 == 0 or s + 1 == args.steps:
            print(f"[{tag}] step {s + 1}: "
                  f"loss={float(loss):.4f} "
                  f"acc={float(metrics['accuracy']):.2f}")
    b = batch()
    with torch.inference_mode():
        logits = model(b["images"], context=context)
    acc = float((logits.argmax(-1) == b["targets"]).float().mean())
    print(f"fused inference path: acc={acc:.2f}")
    if args.steps >= 100 and acc <= 0.9:
        print("the conv net failed to learn the task (acc <= 0.9)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
