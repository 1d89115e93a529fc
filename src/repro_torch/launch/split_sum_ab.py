"""Time the wgrads' split sums: per leg, and in the train steps around them.

Every wgrad kernel writes one row of partial sums per position share into
an f32 workspace ``[splits, |dw| + |db|]``, and the rows are summed in split
order.  This script times, as CUDA-graph replays (device ms, no host launch
cost), each wgrad of MobileNet v1 (13 pointwise and 13 depthwise legs,
batch 32) and of VGG-16 (13 layers on the window kernel and 13 on the
streamed one, batch 8), each with its relu prologue and ``db``, under the
rules the tree offers:

* a tree whose kernels fold the sum (``csrc/split_sum.cuh``): the wrappers
  as they are (``fold``), the same kernels with the choosers' split counts
  divided by K (``fold/K``, K in ``--factors``), and with the separable
  wgrads' choosers at another column budget
  (``core.blocking.SPLIT_SUM_COLUMN_BYTES``, ``fold@M`` for M MiB in
  ``--column-mib``);
* a tree whose wrappers sum the rows by a second launch
  (``direct_conv2d.wgrad_reduce``): the kernel and that reduce
  (``two-launch``), the rule of the port before the fold.

Each rule's outputs are held against the first rule's at ``1e-3`` of their
largest value (other split counts add in other orders, and a longer share
runs a longer truncating accumulation).  Then it times ``STEPS`` train
steps of MobileNet v1 (batch 32) and VGG-16 (batch 8) through the tree's
own wrappers (host clock, synchronized), and checks that the split sums'
counters read 0.  Prints the card's name and power limit, each leg's ms and
per family the sums; ``--out`` writes the numbers as JSON.  Needs an H100
and nvcc; to time another tree, run this file with that tree's ``src``
first on the path::

    PYTHONPATH=src python -m repro_torch.launch.split_sum_ab --out ab.json
    PYTHONPATH=other/src python src/repro_torch/launch/split_sum_ab.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

ITERS, REPEATS, STEPS = 20, 3, 8
FACTORS = (2,)
NAMES = [f"conv{st}_{k}" for st, k in
         ((1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3),
          (4, 1), (4, 2), (4, 3), (5, 1), (5, 2), (5, 3))]


def graph_ms(fn, iters: int = ITERS) -> float:
    """Device ms of one call: ``iters`` calls captured in a CUDA graph (warm
    up on the capture stream) and replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


class Splits:
    """Wraps the wgrad choosers where the kernels' wrappers call them,
    so that every split count can be divided by ``factor``, and sets the
    column budget of the separable ones (``budget`` bytes, None for the
    tree's own)."""

    def __init__(self, modules):
        from repro_torch.core import blocking
        self.blocking = blocking
        self.own = getattr(blocking, "SPLIT_SUM_COLUMN_BYTES", None)
        self.factor, self.choosers = 1, []
        # the launch plans a wrapper caches by shape hold a chooser's tiles
        self.plans = [mod._wgrad_plan for mod, _ in modules
                      if hasattr(mod, "_wgrad_plan")]
        for mod, name in modules:
            if not hasattr(mod, name):
                continue
            self.choosers.append(getattr(mod, name))
            setattr(mod, name, self._wrap(getattr(mod, name)))

    def take(self, factor: int, budget) -> None:
        self.factor = factor
        for plan in self.plans:
            plan.cache_clear()
        budget = self.own if budget is None else budget
        if budget != getattr(self.blocking, "SPLIT_SUM_COLUMN_BYTES", None):
            self.blocking.SPLIT_SUM_COLUMN_BYTES = budget
            for chooser in self.choosers:
                chooser.cache_clear()

    def _wrap(self, orig):
        def chooser(*args, **kw):
            blk = orig(*args, **kw)
            return dataclasses.replace(
                blk, splits=max(1, blk.splits // self.factor))
        return chooser


def mobilenet_legs(entry: int = 224):
    """MobileNet v1's 13 blocks as ``(kind, ci, co, stride, h)`` legs, kind
    ``pw`` or ``dw``, ``h`` the leg's input extent."""
    from repro_torch.configs.cnn import MOBILENET_V1_BLOCKS, MOBILENET_V1_CONV1
    h = -(-entry // MOBILENET_V1_CONV1[2])
    out = []
    for ci, co, s in MOBILENET_V1_BLOCKS:
        out.append(("dw", ci, ci, s, h))
        h = -(-h // s)
        out.append(("pw", ci, co, 1, h))
    return out


def vgg_legs(entry: int = 224):
    from repro_torch.configs.cnn import vgg16_layers
    out, h = [], entry
    for name, (ci, co, s) in zip(NAMES, vgg16_layers()):
        out.append((name, ci, co, s, h))
        h = -(-h // s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    ap.add_argument("--factors", default=",".join(map(str, FACTORS)),
                    help="divisors of the split counts to time beside the "
                         "choosers' own (comma-separated; empty for none)")
    ap.add_argument("--column-mib", default="",
                    help="column budgets of the separable wgrads' choosers "
                         "to time beside the tree's own (comma-separated "
                         "MiB)")
    ap.add_argument("--no-steps", action="store_true",
                    help="time the legs only")
    ap.add_argument("--no-legs", action="store_true",
                    help="time the train steps only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_sum_ab: no CUDA device")
        return 1
    from repro_torch.kernels import (conv2d_depthwise, conv2d_pointwise,
                                     conv2d_stream, direct_conv2d)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    two_launch = hasattr(direct_conv2d, "wgrad_reduce")
    splits = None
    if two_launch:
        rules = {"two-launch": (1, None)}
    else:
        splits = Splits([
            (direct_conv2d, "choose_wgrad_blocking"),
            (conv2d_stream, "choose_stream_wgrad_blocking"),
            # the pointwise wgrad's: the dense tile's, or in an older tree
            # its own FMA kernel's
            (conv2d_pointwise, "choose_wgrad_blocking"),
            (conv2d_pointwise, "choose_pointwise_wgrad_blocking"),
            (conv2d_depthwise, "choose_depthwise_wgrad_blocking")])
        rules = {"fold": (1, None)}
        rules.update({f"fold/{k}": (int(k), None)
                      for k in args.factors.split(",") if k})
        rules.update({f"fold@{m}": (1, int(float(m) * (1 << 20)))
                      for m in args.column_mib.split(",") if m})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    legs = []          # (family, label, fn)
    for kind, ci, co, s, h in mobilenet_legs():
        n, cib, cob = 32, min(ci, 128), min(co, 128)
        ho = -(-h // s)
        x = randn(n, ci // cib, h, h, cib)
        if kind == "pw":
            g = randn(n, co // cob, ho, ho, cob)
            z = randn(n, co // cob, ho, ho, cob)
            fn = (lambda x=x, g=g, z=z: conv2d_pointwise.pointwise_wgrad(
                x, g, z, "relu", True))
        else:
            g = randn(n, ci // cib, ho, ho, cib)
            z = randn(n, ci // cib, ho, ho, cib)
            fn = (lambda x=x, g=g, z=z, s=s: conv2d_depthwise.depthwise_wgrad(
                x, g, 3, 3, s, "SAME", z, "relu", True))
        legs.append((f"mobilenet {kind}", f"{kind} {ci}->{co} {h}x{h} s{s}",
                     fn))
    for name, ci, co, s, h in vgg_legs():
        n, cib, cob = 8, min(ci, 128), min(co, 128)
        ho = -(-h // s)
        x = randn(n, ci // cib, h, h, cib)
        g = randn(n, co // cob, ho, ho, cob)
        z = randn(n, co // cob, ho, ho, cob)
        legs.append(("vgg16 window", f"{name} {ci}->{co} {h}x{h} s{s}",
                     lambda x=x, g=g, z=z, s=s:
                     direct_conv2d.direct_conv2d_wgrad(
                         x, g, 3, 3, s, "SAME", z, "relu", True)))
        legs.append(("vgg16 streamed", f"{name} {ci}->{co} {h}x{h} s{s}",
                     lambda x=x, g=g, z=z, s=s: conv2d_stream.stream_wgrad(
                         x, g, 3, 3, s, "SAME", z, "relu", True)))

    def take(rule):
        if splits is not None:
            splits.take(*rules[rule])

    results = {"card": card, "legs": [], "sums": {}, "steps": {}}
    for family, label, fn in ([] if args.no_legs else legs):
        ref = None
        row = {"family": family, "leg": label}
        for rule in rules:
            take(rule)
            got = torch.cat([t.reshape(-1) for t in fn() if t is not None])
            torch.cuda.synchronize()
            if ref is None:
                ref = got
            err = (got - ref).abs().max().item()
            if not err <= 1e-3 * ref.abs().max().item():
                print(f"FAIL {family} {label} {rule}: |diff| {err:.3e}, "
                      f"max |out| {ref.abs().max().item():.3e}")
                return 1
            row[rule] = float("inf")
        for _ in range(REPEATS):
            for rule in rules:
                take(rule)
                row[rule] = min(row[rule], graph_ms(fn))
        take(next(iter(rules)))
        print(f"[leg] {family} {label}: " + " ".join(
            f"{r} {row[r]:.4f}" for r in rules))
        results["legs"].append(row)
        for r in rules:
            by_rule = results["sums"].setdefault(family, {})
            by_rule[r] = by_rule.get(r, 0.0) + row[r]
    for family, by_rule in results["sums"].items():
        print(f"[sum] {family}: " + " ".join(
            f"{r} {ms:.4f}" for r, ms in by_rule.items()))
    if not args.no_steps:
        results["steps"] = train_steps(dev, next(iter(rules)))
    if not two_launch:
        from repro_torch.kernels import split_sum
        torch.cuda.synchronize()
        dirty = sum(int(a.count_nonzero()) for a in split_sum.arenas())
        print(f"[check] counters left set: {dirty}")
        if dirty:
            return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def train_steps(dev, rule: str):
    """Host-clock ms of ``STEPS`` train steps (after two) of MobileNet v1
    at batch 32 and VGG-16 at batch 8 through the tree's own wrappers."""
    from repro_torch.configs.cnn import mobilenet_v1_blocked, vgg16_blocked
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainstep import make_train_step
    rng = np.random.default_rng(0)
    out = {}
    for name, build, n in (("mobilenet_v1 n32", mobilenet_v1_blocked, 32),
                           ("vgg16 n8", vgg16_blocked, 8)):
        model = build(device=dev)
        opt = AdamW(lr=cosine_schedule(1e-4, 1, 1000))
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt)
        batch = {"images": torch.from_numpy(rng.standard_normal(
            (n, 224, 224, 3), dtype=np.float32)).to(dev),
                 "targets": torch.from_numpy(rng.integers(0, 1000, n)).to(dev)}
        times = []
        for k in range(STEPS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            if k >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        print(f"[step] {name}: {rule} median {np.median(times):.3f} ms "
              f"{[round(v, 3) for v in times]}")
        out[name] = times
        del model, opt, state, step
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
