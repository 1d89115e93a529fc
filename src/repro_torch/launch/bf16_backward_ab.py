"""Time the bf16 backward of the dense and pointwise convs of one tree.

The bf16 wgrads (window and streamed) at VGG-16's 13 layers (batch 8, the
relu prologue and ``db``, as the training path calls them) and the
pointwise bf16 wgrad and dgrad at MobileNet v1's 13 pointwise legs (batch
32), each through its public wrapper, so that a tree that forms dz once a
layer times its dz pass with its GEMM; where the tree has the dz pass
(``direct_conv2d.cotangent_pass``) the pass alone too, and the bf16 dgrads
(VGG-16's and the pointwise one) with their prologue and on dz; then VGG-16's bf16 train step on both
routes (the median of 8 host-clock steps) and its peak device memory above
the parameters, gradients and moments.  Every time is a CUDA-graph replay
(eager beside it for the wgrads and the dgrads on dz).  With ``--alexnet``
it times instead the bf16 wgrads (their dz pass included) of AlexNet's five
two-tower convs (``configs.cnn.alexnet_blocked``, batch 8, 227x227) and of
VGG-16's conv1_1 and MobileNet's conv1 (the first layers, Cib 3), and the
bf16 dgrads of AlexNet's conv2-5, each beside cuDNN bf16's
``convolution_backward`` (channels-last; the wgrad without db), then the
three nets' train steps at batch 32 (``net_steps``: AlexNet in bf16 and
f32, VGG-16 and MobileNet in bf16; host-clock medians and the device-busy
ms under ``torch.profiler``).  Prints the card's name and power limit and
the tree it imported.  To hold two trees in one call, run it (with
``bf16_forward_ab.py``, which imports it, copied beside it) with each
tree's ``src`` first on ``PYTHONPATH``, in turns (parent, this, this,
parent)::

    PYTHONPATH=src python -m repro_torch.launch.bf16_backward_ab \\
        [--alexnet] [--out bf16_backward.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import repro_torch
from repro_torch.configs.cnn import (mobilenet_v1_layers, vgg16_blocked,
                                     vgg16_layers)
from repro_torch.core.convspec import ConvSpec
from repro_torch.launch.dgrad_tiles_ab import graph_ms

N_VGG, N_MOBILENET, ENTRY = 8, 32, 224


def eager_ms(fn, iters: int = 10) -> float:
    """Device time of one eager call, between two events."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def vgg_shapes():
    out, h = [], ENTRY
    for ci, co, s in vgg16_layers():
        out.append((ci, co, s, h))
        h = -(-h // s)
    return out


def pointwise_legs():
    """MobileNet v1's pointwise legs as ``(ci, co, h)`` (their maps' side)."""
    out, h = [], ENTRY
    for kind, ci, co, s in mobilenet_v1_layers():
        h = -(-h // s)
        if kind == "separable":
            out.append((ci, co, h))
    return out


def device_split(fn, top: int = 12):
    """One call of ``fn`` under ``torch.profiler``, recorded after a call in
    the profiler's warm-up cycle (a profile that records from its first
    call can miss the kernels launched as it starts): (device-busy ms, the
    ``top`` kernels by device time as (name, ms, launches)), or None where
    the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    saved = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: saved.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in (saved[0] if saved else [])
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[1])
    if not rows:
        return None
    return sum(r[1] for r in rows), rows[:top]


def train_steps(dev) -> dict:
    """VGG-16's bf16 train step on both routes: both trainers built and
    warmed first, then 8 host-clock steps in turns (window, streamed,
    streamed, window, ...), their medians, each route's peak memory above
    its parameters, gradients and moments, and one step of each under
    ``torch.profiler``: device-busy ms and the kernels that take it."""
    from repro_torch.core.context import ConvContext
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainstep import make_train_step
    rng = np.random.default_rng(0)
    batches = [
        {"images": torch.from_numpy(rng.standard_normal(
            (N_VGG, ENTRY, ENTRY, 3), dtype=np.float32)).to(dev),
         "targets": torch.from_numpy(rng.integers(0, 1000, N_VGG)).to(dev)}
        for _ in range(3)]
    runs = {}
    for route in (False, True):
        model = vgg16_blocked(1000, device=dev,
                              generator=torch.Generator().manual_seed(1))
        opt = AdamW(lr=lambda step: 1e-5)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt, context=ConvContext(
            precision="bf16", stream=route))
        step(state, batches[0])                 # warm-up and builds
        runs["streamed" if route else "window"] = (step, state, model)
    times = {name: [] for name in runs}
    order = list(runs)
    for k in range(8):
        for name in (order if k % 2 == 0 else order[::-1]):
            step, state, _ = runs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batches[k % 3])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, (step, state, model) in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batches[0])
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        split = device_split(lambda: step(state, batches[1]))
        out[name] = {"ms": times[name], "median_ms": float(
            np.median(times[name])), "peak_mib": peak,
            "device_busy_ms": None if split is None else split[0]}
        print(f"[bf16-ab] VGG-16 bf16 train step {name}: median "
              f"{np.median(times[name]):.3f} ms of "
              f"{[round(t, 3) for t in times[name]]}; peak {peak:.1f} MiB "
              f"above the parameters, gradients and moments; device busy "
              f"{'not measured' if split is None else f'{split[0]:.3f} ms'}"
              , flush=True)
        if split is not None:
            for kname, ms, count in split[1]:
                print(f"[bf16-ab]   {name} step kernel {ms:.3f} ms x{count} "
                      f"{kname[:90]}", flush=True)
    return out


def net_steps(dev, n: int = 32) -> dict:
    """AlexNet's train step in bf16 and in f32 (227x227), VGG-16's and
    MobileNet v1's in bf16 (224x224), at batch ``n``: each trainer warmed
    by a step, then the median of 6 host-clock steps and one step under
    ``torch.profiler`` (device-busy ms and the kernels that take it)."""
    from repro_torch.configs.cnn import alexnet_blocked, mobilenet_v1_blocked
    from repro_torch.core.context import ConvContext
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainstep import make_train_step
    rng = np.random.default_rng(0)
    out = {}
    for name, build, entry, prec in (
            ("alexnet", alexnet_blocked, 227, "bf16"),
            ("alexnet", alexnet_blocked, 227, "f32"),
            ("vgg16", vgg16_blocked, ENTRY, "bf16"),
            ("mobilenet", mobilenet_v1_blocked, ENTRY, "bf16")):
        batches = [{"images": torch.from_numpy(rng.standard_normal(
            (n, entry, entry, 3), dtype=np.float32)).to(dev),
            "targets": torch.from_numpy(rng.integers(0, 1000, n)).to(dev)}
            for _ in range(3)]
        model = build(1000, device=dev,
                      generator=torch.Generator().manual_seed(1))
        opt = AdamW(lr=lambda step: 1e-5)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt,
                               context=ConvContext(precision=prec))
        step(state, batches[0])                 # warm-up and builds
        times = []
        for k in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batches[k % 3])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        split = device_split(lambda: step(state, batches[1]))
        key = f"{name}_{prec}"
        out[key] = {"ms": times, "median_ms": float(np.median(times)),
                    "device_busy_ms": None if split is None else split[0]}
        print(f"[steps] {name} {prec} train step n{n} {entry}x{entry}: "
              f"median {np.median(times):.3f} ms of "
              f"{[round(t, 3) for t in times]}; device busy "
              f"{'not measured' if split is None else f'{split[0]:.3f} ms'}",
              flush=True)
        if split is not None:
            for kname, ms, count in split[1][:6]:
                print(f"[steps]   {key} kernel {ms:.3f} ms x{count} "
                      f"{kname[:90]}", flush=True)
        del model, state, step, batches
        torch.cuda.empty_cache()
    return out


def first_and_alexnet_layers(n: int = 8):
    """AlexNet's five convs (a 227x227 entry, lane 64), VGG-16's conv1_1 and
    MobileNet's conv1, as ``(name, ConvSpec, cib, cob)``."""
    from repro_torch.launch.fwd_tiles_ab import grouped_layers
    kind, ci, co, s = mobilenet_v1_layers()[0]
    return grouped_layers(n)[:5] + [
        ("vgg16.conv1_1", ConvSpec.make(n, ENTRY, ENTRY, 3, 64, 3, 3, 1,
                                        "SAME"), 3, 64),
        ("mobilenet.conv1", ConvSpec.make(n, ENTRY, ENTRY, ci, co, 3, 3, s,
                                          "SAME"), ci, co)]


def alexnet(dev, gen, res) -> None:
    """``--alexnet``: the wgrads and dgrads (module docstring) into
    ``res``."""
    import torch.nn.functional as F
    from repro_torch.kernels import direct_conv2d as dck
    bf = torch.bfloat16
    cl = torch.channels_last
    res["alexnet"] = []
    for name, spec, cib, cob in first_and_alexnet_layers():
        n, s, g = spec.n, spec.stride, spec.groups
        x = torch.randn((n, spec.ci // cib, spec.hi, spec.wi, cib),
                        device=dev, generator=gen).to(bf)
        w = (torch.randn((spec.co // cob, spec.cig // cib, spec.hf, spec.wf,
                          cib, cob), device=dev, generator=gen)
             / (spec.hf * spec.wf * spec.cig) ** 0.5).to(bf)
        z = torch.randn((n, spec.co // cob, spec.ho, spec.wo, cob),
                        device=dev, generator=gen).to(bf)
        gg = torch.randn(z.shape, device=dev, generator=gen).to(bf)
        (pt, pb), (pl, pr) = spec.pads
        xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(n, spec.ci, spec.hi,
                                                    spec.wi),
                   (pl, pr, pt, pb)).contiguous(memory_format=cl)
        w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(
            spec.co, spec.cig, spec.hf, spec.wf).contiguous(memory_format=cl))
        dz_nchw = (gg.permute(0, 1, 4, 2, 3).reshape(n, spec.co, spec.ho,
                                                     spec.wo)
                   .contiguous(memory_format=cl))
        row = {"layer": name}

        def wgrad():
            return dck.direct_conv2d_wgrad(x, gg, spec.hf, spec.wf, s,
                                           spec.pads, z, "relu", True,
                                           precision="bf16", groups=g)

        def lib_wgrad():
            return torch.ops.aten.convolution_backward(
                dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                [0, 0], g, [False, True, False])
        row["wgrad"] = graph_ms(wgrad, 10)
        row["wgrad_eager"] = eager_ms(wgrad)
        row["wgrad_cudnn"] = graph_ms(lib_wgrad, 10)
        if name.startswith("alexnet") and name != "alexnet.conv1":
            def dgrad():
                return dck.direct_conv2d_dgrad(gg, w, (spec.hi, spec.wi), s,
                                               spec.pads, z, "relu",
                                               precision="bf16", groups=g)

            def lib_dgrad():
                return torch.ops.aten.convolution_backward(
                    dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                    [0, 0], g, [True, False, False])
            row["dgrad"] = graph_ms(dgrad, 10)
            row["dgrad_eager"] = eager_ms(dgrad)
            row["dgrad_cudnn"] = graph_ms(lib_dgrad, 10)
        res["alexnet"].append(row)
        print("[bf16-ab] " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        del x, w, z, gg, xp, w_oihw, dz_nchw
    five = res["alexnet"][:5]
    sums = {k: sum(r.get(k, 0.0) for r in five) for k in five[1]
            if k != "layer"}
    res["alexnet_sums"] = sums
    print("[bf16-ab] AlexNet's five convs summed (ms; graphs unless _eager;"
          " dgrads over conv2-5): " + " ".join(
              f"{k} {v:.4f}" for k, v in sums.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alexnet", action="store_true",
                    help="AlexNet's and the first layers' bf16 wgrads and "
                         "dgrads, then the three nets' train steps at "
                         "batch 32, instead")
    ap.add_argument("--out", default=None, help="write the times as JSON")
    ap.add_argument("--no-steps", action="store_true",
                    help="skip the train steps")
    ap.add_argument("--steps-only", action="store_true",
                    help="time the train steps alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_backward_ab: no CUDA device")
        return 1
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels import direct_conv2d as dck
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tree = repro_torch.__file__
    has_pass = hasattr(dck, "cotangent_pass")
    print(f"[bf16-ab] card: {card}; tree {tree}; dz pass: {has_pass}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    res = {"card": card, "tree": tree, "vgg": [], "pointwise": []}
    if args.alexnet:
        if not args.steps_only:
            alexnet(dev, gen, res)
        if not args.no_steps:
            res["steps"] = net_steps(dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    if args.steps_only:
        res["steps"] = train_steps(dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0

    for ci, co, s, h in vgg_shapes():
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(N_VGG, h, h, ci, co, 3, 3, s, "SAME")
        x = torch.randn((N_VGG, ci // cib, h, h, cib), device=dev,
                        generator=gen).to(bf)
        w = (torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                         generator=gen) / (9 * ci) ** 0.5).to(bf)
        z = torch.randn((N_VGG, co // cob, spec.ho, spec.wo, cob),
                        device=dev, generator=gen).to(bf)
        g = torch.randn(z.shape, device=dev, generator=gen).to(bf)
        row = {"layer": f"{ci}->{co} s{s} {h}x{h}"}
        for route in (False, True):
            name = "streamed" if route else "window"

            def wgrad(route=route):
                return dck.direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z,
                                               "relu", True, stream=route,
                                               precision="bf16")
            row[f"wgrad_{name}"] = graph_ms(wgrad, 10)
            row[f"wgrad_{name}_eager"] = eager_ms(wgrad)
            if ci != 3:
                def dgrad(route=route):
                    return dck.direct_conv2d_dgrad(g, w, (h, h), s, "SAME",
                                                   z, "relu", stream=route,
                                                   precision="bf16")
                row[f"dgrad_{name}"] = graph_ms(dgrad, 10)
        if has_pass:
            dz, _ = dck.cotangent_pass(g, z, "relu", True)
            row["dz_pass"] = graph_ms(
                lambda: dck.cotangent_pass(g, z, "relu", True), 10)
            row["dz_pass_eager"] = eager_ms(
                lambda: dck.cotangent_pass(g, z, "relu", True))
            if ci != 3:
                for route in (False, True):
                    name = "streamed" if route else "window"

                    def on_dz(route=route):
                        return dck.direct_conv2d_dgrad(
                            dz, w, (h, h), s, "SAME", stream=route,
                            precision="bf16", prologue_tiles=True)
                    row[f"dgrad_{name}_on_dz"] = graph_ms(on_dz, 10)
                    row[f"dgrad_{name}_on_dz_eager"] = eager_ms(on_dz)
            del dz
        res["vgg"].append(row)
        print("[bf16-ab] vgg " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        del x, w, z, g

    for ci, co, h in pointwise_legs():
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((N_MOBILENET, ci // cib, h, h, cib), device=dev,
                        generator=gen).to(bf)
        z = torch.randn((N_MOBILENET, co // cob, h, h, cob), device=dev,
                        generator=gen).to(bf)
        g = torch.randn(z.shape, device=dev, generator=gen).to(bf)
        w = (torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=dev,
                         generator=gen) / ci ** 0.5).to(bf)

        def wgrad():
            return pwk.pointwise_wgrad(x, g, z, "relu", True,
                                       precision="bf16")

        def dgrad():
            return pwk.pointwise_dgrad(g, w, z, "relu", precision="bf16")
        row = {"leg": f"{ci}->{co} {h}x{h}", "wgrad": graph_ms(wgrad, 10),
               "wgrad_eager": eager_ms(wgrad), "dgrad": graph_ms(dgrad, 10),
               "dgrad_eager": eager_ms(dgrad)}
        if has_pass:
            row["dz_pass"] = graph_ms(
                lambda: dck.cotangent_pass(g, z, "relu", True), 10)
            row["dz_pass_eager"] = eager_ms(
                lambda: dck.cotangent_pass(g, z, "relu", True))
            dz, _ = dck.cotangent_pass(g, z, "relu", False)

            def on_dz():
                return pwk.pointwise_dgrad(dz, w, precision="bf16",
                                           prologue_tiles=True)
            row["dgrad_on_dz"] = graph_ms(on_dz, 10)
            row["dgrad_on_dz_eager"] = eager_ms(on_dz)
            del dz
        res["pointwise"].append(row)
        print("[bf16-ab] pointwise " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        del x, z, g, w

    sums = {k: sum(r[k] for r in res["vgg"] if k in r)
            for k in res["vgg"][-1] if k != "layer"}
    for k in res["pointwise"][-1]:
        if k != "leg":
            sums[f"pointwise_{k}"] = sum(r[k] for r in res["pointwise"])
    res["sums"] = sums
    print("[bf16-ab] sums (ms; graphs unless _eager; dgrads over the 12 "
          "layers past conv1_1): " + " ".join(
              f"{k} {v:.4f}" for k, v in sums.items()), flush=True)

    if not args.no_steps:
        res["steps"] = train_steps(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
