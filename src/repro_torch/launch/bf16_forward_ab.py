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
the device-busy ms under ``torch.profiler``).  With ``--mobilenet`` it
times MobileNet v1's bf16 pointwise forward instead: its 13 pointwise legs
(a 224x224 entry, relu, the last leg with its GAP at batch 8) at batch 8
and 32 through ``pointwise_conv2d_blocked(precision="bf16")``
(``pointwise_tile_kernel_bf16``), eager and as a CUDA graph, each checked
against the plain version, beside the dense bf16 forward at a 1x1 filter
(``direct_conv2d_blocked(precision="bf16", stream=False)``,
``fwd_kernel_bf16``: the control), cuDNN bf16 in channels-last and the
bound; then MobileNet's bf16 serving forward at batch 8 (eager and graph)
and its bf16 train step at batch 32 (host-clock median and the device-busy
ms under ``torch.profiler``).  With ``--alexnet`` it times instead the bf16
forward of AlexNet's five two-tower convs (batch 8, 227x227, lane 64) and
of VGG-16's conv1_1 and MobileNet's conv1 (the first layers, Cib 3) through
``direct_conv2d_blocked(precision="bf16", groups=...)``, each checked
against the plain version, eager and as a graph beside cuDNN bf16 and the
bound, then AlexNet's bf16 serving forward (batch 8) and, with ``--steps``,
the three nets' train steps at batch 32 (``bf16_backward_ab.net_steps``).
Prints the card's name and power limit and the tree it imported.  To hold
two trees in one call, copy this file (and ``bf16_backward_ab.py``) into
the other tree and run it there with that tree's ``src`` first on
``PYTHONPATH``, in turns (parent, this, this, parent)::

    PYTHONPATH=src python -m repro_torch.launch.bf16_forward_ab \\
        [--steps | --mobilenet | --alexnet] [--out bf16_forward.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch
from repro_torch.configs.cnn import (mobilenet_v1_blocked,
                                     mobilenet_v1_layers, vgg16_blocked,
                                     vgg16_layers)
from repro_torch.core.convspec import ConvSpec
from repro_torch.launch.bf16_backward_ab import (device_split, eager_ms,
                                                first_and_alexnet_layers,
                                                net_steps, train_steps)
from repro_torch.launch.dgrad_tiles_ab import NAMES, graph_ms
from repro_torch.launch.separable_parts_ab import pw_legs

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


def mobilenet(dev, gen, res) -> None:
    """``--mobilenet``: the pointwise legs, the serving forward and the
    train step (module docstring) into ``res``."""
    import torch.nn.functional as F
    from repro_torch.core.context import ConvContext
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainstep import make_train_step
    bf = torch.bfloat16
    legs = pw_legs()
    res["pw_legs"] = []
    keys = ("pointwise", "pointwise_eager", "dense_1x1", "dense_1x1_eager",
            "cudnn", "cudnn_eager", "bound_ms")
    with torch.no_grad():
        for n in (8, 32):
            sums = dict.fromkeys(keys, 0.0)
            timed = {}
            for ci, co, h in legs:
                gap = n == 8 and (ci, co) == (1024, 1024)
                key = (ci, co, h, gap)
                if key not in timed:
                    cib, cob = min(ci, 128), min(co, 128)
                    x = torch.randn((n, ci // cib, h, h, cib), device=dev,
                                    generator=gen).to(bf)
                    w = (torch.randn((co // cob, ci // cib, 1, 1, cib, cob),
                                     device=dev, generator=gen)
                         / ci ** 0.5).to(bf)
                    b = 0.1 * torch.randn((co // cob, cob), device=dev,
                                          generator=gen)
                    want = direct_conv_blocked(x, w, 1, "VALID", b, "relu",
                                               "bf16", gap=gap).float()
                    scale = want.abs().max().item()

                    def pw(x=x, w=w, b=b, gap=gap):
                        return pwk.pointwise_conv2d_blocked(
                            x, w, b, 1, "VALID", "relu", gap=gap,
                            precision="bf16")

                    def dense(x=x, w=w, b=b, gap=gap):
                        return direct_conv2d_blocked(
                            x, w, b, 1, "VALID", "relu", gap=gap,
                            precision="bf16", stream=False)
                    for tag, fn in (("pointwise", pw), ("dense_1x1", dense)):
                        err = (fn().float() - want).abs().max().item()
                        if err > 2.0 ** -7 * (1 + scale):
                            raise RuntimeError(
                                f"{tag} {ci}->{co} {h}x{h} n{n}: |out - "
                                f"plain| = {err} (max |out| {scale})")
                    xl = (x.permute(0, 1, 4, 2, 3).reshape(n, ci, h, h)
                          .contiguous(memory_format=torch.channels_last))
                    wl = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 1, 1)
                          .contiguous(memory_format=torch.channels_last))
                    bl = b.reshape(co).to(bf)

                    def cudnn(xl=xl, wl=wl, bl=bl):
                        return F.conv2d(xl, wl, bl)
                    out_elems = n * co * (1 if gap else h * h)
                    nbytes = 2 * (x.numel() + w.numel() + out_elems) \
                        + 4 * co
                    row = {"leg": f"{ci}->{co} {h}x{h}", "n": n, "gap": gap,
                           "bound_ms": 1e3 * max(
                               2 * n * h * h * ci * co / PEAK_BF16_FLOPS,
                               nbytes / PEAK_BYTES)}
                    for tag, fn in (("pointwise", pw), ("dense_1x1", dense),
                                    ("cudnn", cudnn)):
                        row[tag] = graph_ms(fn, 10)
                        row[f"{tag}_eager"] = eager_ms(fn)
                    timed[key] = row
                    print("[pw-ab] " + " ".join(
                        f"{k} {v:.4f}" if isinstance(v, float)
                        else f"{k} {v}" for k, v in row.items()),
                        flush=True)
                    del x, w, b, want, xl, wl
                for k in keys:
                    sums[k] += timed[key][k]
            res["pw_legs"] += list(timed.values())
            res[f"pw_sums_n{n}"] = sums
            print(f"[pw-ab] MobileNet's 13 pointwise legs n{n} summed (ms; "
                  "graphs unless _eager): " + " ".join(
                      f"{k} {v:.4f}" for k, v in sums.items())
                  + f"; share of the bound as a graph: pointwise "
                  f"{100 * sums['bound_ms'] / sums['pointwise']:.1f} %",
                  flush=True)
        model = mobilenet_v1_blocked(1000, device=dev,
                                     generator=torch.Generator().manual_seed(2))
        img = torch.randn((N, ENTRY, ENTRY, 3), device=dev, generator=gen)
        ctx = ConvContext(precision="bf16")

        def forward():
            return model(img, context=ctx)
        res["mobilenet_forward"] = graph_ms(forward, 5)
        res["mobilenet_forward_eager"] = eager_ms(forward, 5)
        print(f"[pw-ab] MobileNet v1 bf16 serving forward n{N}: "
              f"{res['mobilenet_forward_eager']:.4f} ms eager, "
              f"{res['mobilenet_forward']:.4f} ms as a graph (weight casts "
              "included)", flush=True)
    nt = 32
    rng = np.random.default_rng(0)
    batches = [{"images": torch.from_numpy(rng.standard_normal(
        (nt, ENTRY, ENTRY, 3), dtype=np.float32)).to(dev),
        "targets": torch.from_numpy(rng.integers(0, 1000, nt)).to(dev)}
        for _ in range(3)]
    opt = AdamW(lr=lambda step: 1e-5)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, context=ctx)
    step(state, batches[0])                     # warm-up
    times = []
    for k in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batches[k % 3])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    split = device_split(lambda: step(state, batches[1]))
    res["mobilenet_step_ms"] = float(np.median(times))
    res["mobilenet_step_device_busy_ms"] = None if split is None \
        else split[0]
    print(f"[pw-ab] MobileNet v1 bf16 train step n{nt}: median "
          f"{np.median(times):.3f} ms of {[round(t, 3) for t in times]}; "
          f"device busy "
          f"{'not measured' if split is None else f'{split[0]:.3f} ms'}",
          flush=True)
    if split is not None:
        for kname, ms, count in split[1]:
            print(f"[pw-ab]   step kernel {ms:.3f} ms x{count} {kname[:90]}",
                  flush=True)


def alexnet(dev, gen, res) -> None:
    """``--alexnet``: the layers and the serving forward (module docstring)
    into ``res``."""
    from repro_torch.configs.cnn import alexnet_blocked
    from repro_torch.core.context import ConvContext
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked
    bf = torch.bfloat16
    res["alexnet"] = []
    with torch.no_grad():
        for name, spec, cib, cob in first_and_alexnet_layers(N):
            n, s, g = spec.n, spec.stride, spec.groups
            x = torch.randn((n, spec.ci // cib, spec.hi, spec.wi, cib),
                            device=dev, generator=gen).to(bf)
            w = (torch.randn((spec.co // cob, spec.cig // cib, spec.hf,
                              spec.wf, cib, cob), device=dev, generator=gen)
                 / (spec.hf * spec.wf * spec.cig) ** 0.5).to(bf)
            b = 0.1 * torch.randn((spec.co // cob, cob), device=dev,
                                  generator=gen)
            want = direct_conv_blocked(x, w, s, spec.pads, b, "relu", "bf16",
                                       g)
            scale = want.float().abs().max().item()

            def fwd():
                return direct_conv2d_blocked(x, w, b, s, spec.pads, "relu",
                                             precision="bf16", groups=g)
            err = (fwd().float() - want.float()).abs().max().item()
            if err > 2.0 ** -7 * (1 + scale):
                raise RuntimeError(f"{name}: |out - plain| = {err} (max "
                                   f"|out| {scale})")
            (pt, pb), (pl, pr) = spec.pads
            xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(n, spec.ci, spec.hi,
                                                        spec.wi),
                       (pl, pr, pt, pb)).contiguous(
                memory_format=torch.channels_last)
            w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(
                spec.co, spec.cig, spec.hf, spec.wf)
                .contiguous(memory_format=torch.channels_last))
            b_flat = b.reshape(spec.co).to(bf)

            def cudnn():
                return F.conv2d(xp, w_oihw, b_flat, stride=s, groups=g)
            nbytes = 2 * (x.numel() + w.numel() + want.numel()) + 4 * spec.co
            row = {"layer": name, "window": graph_ms(fwd, 10),
                   "window_eager": eager_ms(fwd),
                   "cudnn": graph_ms(cudnn, 10),
                   "cudnn_eager": eager_ms(cudnn),
                   "bound_ms": 1e3 * max(spec.flops() / PEAK_BF16_FLOPS,
                                         nbytes / PEAK_BYTES)}
            res["alexnet"].append(row)
            print("[fwd-ab] " + " ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
            del x, w, b, want, xp, w_oihw
        five = res["alexnet"][:5]
        sums = {k: sum(r[k] for r in five) for k in five[0] if k != "layer"}
        res["alexnet_sums"] = sums
        print("[fwd-ab] AlexNet's five convs summed (ms; graphs unless "
              "_eager): " + " ".join(f"{k} {v:.4f}" for k, v in sums.items()),
              flush=True)
        model = alexnet_blocked(1000, device=dev,
                                generator=torch.Generator().manual_seed(1))
        img = torch.randn((N, 227, 227, 3), device=dev, generator=gen)
        ctx = ConvContext(precision="bf16")

        def forward():
            return model(img, context=ctx)
        res["alexnet_forward"] = graph_ms(forward, 5)
        res["alexnet_forward_eager"] = eager_ms(forward, 5)
        print(f"[fwd-ab] AlexNet bf16 serving forward n{N}: "
              f"{res['alexnet_forward_eager']:.4f} ms eager, "
              f"{res['alexnet_forward']:.4f} ms as a graph (weight casts "
              "included)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", action="store_true",
                    help="time VGG-16's bf16 train steps as well")
    ap.add_argument("--mobilenet", action="store_true",
                    help="time MobileNet's bf16 pointwise legs, serving "
                    "forward and train step instead")
    ap.add_argument("--alexnet", action="store_true",
                    help="time AlexNet's and the first layers' bf16 forwards "
                    "and AlexNet's serving forward instead (--steps: the "
                    "three nets' train steps at batch 32)")
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
    if args.alexnet:
        alexnet(dev, gen, res)
        if args.steps:
            res["steps"] = net_steps(dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    if args.mobilenet:
        mobilenet(dev, gen, res)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
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
