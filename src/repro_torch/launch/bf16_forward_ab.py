"""Time the bf16 dense forward of one tree.

The bf16 builds of the window and streamed forwards at VGG-16's 13 layers
and MobileNet v1's ``conv1`` (batch 8, a 224x224 entry, relu, through the
public wrapper ``direct_conv2d_blocked(precision="bf16", stream=...)``), each
checked against the plain version under ``BF16`` and timed eager and as a
CUDA-graph replay, beside cuDNN bf16 in channels-last (eager and graph) and
the bound (the function's FLOPs at 989e12 against its bf16 bytes at
3.35e12); then VGG-16's bf16 serving forward (the model under a bf16
context, eager and graph) and, with ``--steps``, VGG-16's bf16 train step
on both routes (``bf16_backward_ab.train_steps``: host-clock medians and
the device-busy ms under ``torch.profiler``).  Prints the card's name and
power limit and the tree it imported.  To hold two trees in one call, copy
this file into the other tree and run it there with that tree's ``src``
first on ``PYTHONPATH``, in turns (parent, this, this, parent)::

    PYTHONPATH=src python -m repro_torch.launch.bf16_forward_ab \\
        [--steps] [--out bf16_forward.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

import repro_torch
from repro_torch.configs.cnn import (mobilenet_v1_layers, vgg16_blocked,
                                     vgg16_layers)
from repro_torch.core.convspec import ConvSpec
from repro_torch.launch.bf16_backward_ab import eager_ms, train_steps
from repro_torch.launch.dgrad_tiles_ab import NAMES, graph_ms

N, ENTRY = 8, 224
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def layers():
    """``(name, ci, co, stride, h)``: VGG-16's 13 convs, then MobileNet v1's
    ``conv1``, ``h`` the input's side."""
    out, h = [], ENTRY
    for name, (ci, co, s) in zip(NAMES, vgg16_layers()):
        out.append((name, ci, co, s, h))
        h = -(-h // s)
    kind, ci, co, s = mobilenet_v1_layers()[0]
    out.append(("mobilenet.conv1", ci, co, s, ENTRY))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", action="store_true",
                    help="time VGG-16's bf16 train steps as well")
    ap.add_argument("--out", default=None, help="write the times as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_forward_ab: no CUDA device")
        return 1
    from repro_torch.core.context import ConvContext
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tree = repro_torch.__file__
    print(f"[fwd-ab] card: {card}; tree {tree}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    res = {"card": card, "tree": tree, "layers": []}
    with torch.no_grad():
        for name, ci, co, s, h in layers():
            cib, cob = min(ci, 128), min(co, 128)
            spec = ConvSpec.make(N, h, h, ci, co, 3, 3, s, "SAME")
            x = torch.randn((N, ci // cib, h, h, cib), device=dev,
                            generator=gen).to(bf)
            w = (torch.randn((co // cob, ci // cib, 3, 3, cib, cob),
                             device=dev, generator=gen)
                 / (9 * ci) ** 0.5).to(bf)
            b = 0.1 * torch.randn((co // cob, cob), device=dev,
                                  generator=gen)
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu", "bf16")
            scale = want.float().abs().max().item()
            nbytes = 2 * (x.numel() + w.numel() + want.numel()) + 4 * co
            bound = max(spec.flops() / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
            row = {"layer": name, "shape": f"{ci}->{co} s{s} {h}x{h}",
                   "bound_ms": bound * 1e3}
            for route in (False, True):
                key = "streamed" if route else "window"

                def fwd(route=route):
                    return direct_conv2d_blocked(x, w, b, s, "SAME", "relu",
                                                 precision="bf16",
                                                 stream=route)
                err = (fwd().float() - want.float()).abs().max().item()
                if err > 2.0 ** -7 * (1 + scale):
                    raise RuntimeError(f"{name} {key}: |out - plain| = {err}"
                                       f" (max |out| {scale})")
                row[key] = graph_ms(fwd, 10)
                row[f"{key}_eager"] = eager_ms(fwd)
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(N, ci, h, h),
                       (pl, pr, pt, pb)).contiguous(
                memory_format=torch.channels_last)
            w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                      .contiguous(memory_format=torch.channels_last))
            b_flat = b.reshape(co).to(bf)

            def cudnn():
                return F.conv2d(xp, w_oihw, b_flat, stride=s)
            row["cudnn"] = graph_ms(cudnn, 10)
            row["cudnn_eager"] = eager_ms(cudnn)
            res["layers"].append(row)
            print("[fwd-ab] " + " ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
            del x, w, b, want, xp, w_oihw

        vgg = res["layers"][:13]
        sums = {k: sum(r[k] for r in vgg) for k in vgg[0]
                if isinstance(vgg[0][k], float)}
        res["vgg16_sums"] = sums
        print("[fwd-ab] VGG-16's 13 layers summed (ms; graphs unless _eager): "
              + " ".join(f"{k} {v:.4f}" for k, v in sums.items())
              + "; share of the bound as a graph: window "
              f"{100 * sums['bound_ms'] / sums['window']:.1f} %, streamed "
              f"{100 * sums['bound_ms'] / sums['streamed']:.1f} %",
              flush=True)

        model = vgg16_blocked(1000, device=dev,
                              generator=torch.Generator().manual_seed(1))
        img = torch.randn((N, ENTRY, ENTRY, 3), device=dev, generator=gen)
        for route in (False, True):
            key = "streamed" if route else "window"
            ctx = ConvContext(precision="bf16", stream=route)

            def forward(ctx=ctx):
                return model(img, context=ctx)
            res[f"vgg16_forward_{key}"] = graph_ms(forward, 5)
            res[f"vgg16_forward_{key}_eager"] = eager_ms(forward, 5)
            print(f"[fwd-ab] VGG-16 bf16 serving forward n{N} {key}: "
                  f"{res[f'vgg16_forward_{key}_eager']:.4f} ms eager, "
                  f"{res[f'vgg16_forward_{key}']:.4f} ms as a graph "
                  "(weight casts included)", flush=True)
        del model
    if args.steps:
        res["steps"] = train_steps(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
