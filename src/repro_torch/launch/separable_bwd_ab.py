"""Time MobileNet v1's pointwise wgrad, depthwise dgrad and wgrad, and options.

At every distinct leg of MobileNet v1 (batch 32, a 224x224 entry, the relu
prologue), as CUDA-graph replays of ``ITERS`` calls (device ms, no host
launch cost), this script times:

* the pointwise wgrad as the tree routes it (``pointwise_wgrad_partials``,
  ``db`` in), and the dense wgrad tile at a 1x1 filter
  (``csrc/wgrad_tile.cuh``; where the tree builds its launch plans by
  ``wgrad_launch_plan``) at the tiles its chooser weighs: the ``TOP``
  of least model cost and the ``PER_COUNT`` cheapest of each (consumer
  warpgroups, m-tiles a warpgroup) pair, each twice in opposite orders, the
  faster time kept; each against f64 sums (``|dw - f64| <= 1e-5 * sum |x *
  dz|``);
* the depthwise dgrad as the tree routes it (``depthwise_dgrad``),
  against the plain version;
* the depthwise wgrad as the tree routes it (``depthwise_wgrad_partials``,
  ``db`` in), and where the tree builds its launch plans by
  ``_wgrad_plan`` the items its chooser weighs
  (``depthwise_wgrad_candidates``): the chooser's, and the ``DW_PER_SPLIT``
  largest that give every position group a position at each lane split,
  each twice in opposite orders, the faster time kept; each against f64
  sums as the pointwise wgrad.

It prints the card's name and power limit, each leg's times, and the sums
over the network's 13 legs of each kind (repeated legs counted each time).
``--out`` writes the numbers as JSON.  Needs an H100 and nvcc; to time
another tree (its route), run this file with that tree's ``src`` first on
the path, in the same call::

    PYTHONPATH=src python -m repro_torch.launch.separable_bwd_ab
    PYTHONPATH=other/src python src/repro_torch/launch/separable_bwd_ab.py
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

ITERS, TOP, PER_COUNT = 10, 6, 1
DW_PER_SPLIT = 4
N = 32
REL = 1e-5
TOL = {"atol": 1e-4, "rtol": 1e-4}


def graph_ms(fn, iters: int = ITERS) -> float:
    """Device ms of one call: ``iters`` calls captured in a CUDA graph (warm
    up on the capture stream, whose split-sum counters the graph keeps) and
    replayed between two events."""
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


def mobilenet_legs(entry: int = 224):
    """MobileNet v1's 13 blocks in order as ``(ci, co, stride, h)``, ``h``
    the depthwise leg's input extent (the pointwise leg's is ``ceil(h /
    stride)``)."""
    from repro_torch.configs.cnn import MOBILENET_V1_BLOCKS, MOBILENET_V1_CONV1
    h = -(-entry // MOBILENET_V1_CONV1[2])
    out = []
    for ci, co, s in MOBILENET_V1_BLOCKS:
        out.append((ci, co, s, h))
        h = -(-h // s)
    return out


def wgrad_tiles(n: int, ci: int, co: int, h: int, top: int = TOP,
                per_count: int = PER_COUNT):
    """The dense wgrad tiles at 1x1 to time for a ``ci -> co`` pointwise leg
    over ``h x h``, as ``(model cost, blocking)``, the chooser's first."""
    from repro_torch.core.blocking import (H100_SXM, choose_wgrad_blocking,
                                           wgrad_candidates)
    cib, cob = min(ci, 128), min(co, 128)
    args = (n, h, h, 1, 1, 1, ci // cib, cib, co // cob, cob)
    found = sorted(wgrad_candidates(*args, H100_SXM, True, False),
                   key=lambda kb: kb[0])
    keep = [choose_wgrad_blocking(*args, prologue=True)]
    keep += [b for _, b in found[:top]]
    for pair in sorted({(b.wgs, b.mpw) for _, b in found}):
        keep += [b for _, b in found if (b.wgs, b.mpw) == pair][:per_count]
    cost = {}
    for k, b in found:
        cost.setdefault(b, k[0])
    return [(cost[b], b) for b in dict.fromkeys(keep)]


def depthwise_wgrad_items(n: int, ci: int, s: int, h: int,
                          per_split: int = DW_PER_SPLIT):
    """The depthwise wgrad items to time for a ``ci``-channel leg over an
    ``h x h`` input at stride ``s`` (3x3, SAME, the relu prologue), the
    chooser's first."""
    from repro_torch.core.blocking import (H100_SXM,
                                           choose_depthwise_wgrad_blocking,
                                           depthwise_wgrad_candidates)
    cb, ho = min(ci, 128), -(-h // s)
    args = (n, ci // cb, ho, ho, cb, 3, 3, s)
    keep = [choose_depthwise_wgrad_blocking(*args)]
    found = depthwise_wgrad_candidates(*args)
    for lanes in sorted({b.lanes for b in found}, reverse=True):
        busy = [b for b in found if b.lanes == lanes
                and b.hob * b.wob >= H100_SXM.threads // lanes]
        busy.sort(key=lambda b: (-b.hob * b.wob, b.hwin * b.wwin, -b.wob))
        keep += busy[:per_split]
    return list(dict.fromkeys(keep))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    ap.add_argument("--tag", default="this tree",
                    help="the tree's name in the printed lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("separable_bwd_ab: no CUDA device")
        return 1
    from repro_torch.core.conv2d_common import cotangent_prologue
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels import conv2d_depthwise as dwk
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels import direct_conv2d
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tag = args.tag
    pw, dw, dww = {}, {}, {}   # per distinct leg: {rule: graph ms}

    for ci, co, s, h in mobilenet_legs():
        ho = -(-h // s)
        cb, cob = min(ci, 128), min(co, 128)
        if (ci, co, ho) not in pw:
            x = torch.randn((N, ci // cb, ho, ho, cb), device=dev,
                            generator=gen)
            w = torch.randn((co // cob, ci // cb, 1, 1, cb, cob), device=dev,
                            generator=gen) / ci ** 0.5
            z = direct_conv_blocked(x, w, 1, "VALID").contiguous()
            g = torch.randn(z.shape, device=dev, generator=gen)
            want, _ = direct_conv_wgrad_blocked(x.double(), g.double(), 1, 1,
                                                1, "VALID", z.double(),
                                                "relu")
            dz = cotangent_prologue(g, z, "relu")
            scale, _ = direct_conv_wgrad_blocked(x.abs().double(),
                                                 dz.abs().double(), 1, 1, 1,
                                                 "VALID")

            def check(label, out):
                got = out[:want.numel()].view(want.shape).double()
                ratio = ((got - want).abs()
                         / (REL * scale).clamp_min(1e-300)).max().item()
                if not ratio <= 1:
                    raise RuntimeError(f"{label}: err/bound {ratio}")

            route = (lambda x=x, g=g, z=z: pwk.pointwise_wgrad_partials(
                x, g, z, "relu", True))
            check("pw wgrad route", route()[1])
            times = {f"route ({tag})": graph_ms(route)}
            spec = ConvSpec.make(N, ho, ho, ci, co, 1, 1)
            entry = direct_conv2d._bwd_lib().direct_conv2d_wgrad
            runs = []
            # the tiles where the tree builds wgrad launch plans
            tiles = (wgrad_tiles(N, ci, co, ho)
                     if hasattr(direct_conv2d, "wgrad_launch_plan") else [])
            for cost, blk in tiles:
                plan = direct_conv2d.wgrad_launch_plan(blk, x.shape, g.shape,
                                                       1, 1, spec, 1, True)

                def run(blk=blk, plan=plan, x=x, g=g, z=z):
                    err, _, out = direct_conv2d.wgrad_launch(entry, plan, x,
                                                             g, z)
                    if err:
                        raise RuntimeError(f"wgrad tile {blk}: CUDA error "
                                           f"{err}")
                    return out
                check(f"pw wgrad tile {blk}", run())
                runs.append((cost, blk, run))
            ms = [graph_ms(r) for _, _, r in runs]
            for i in reversed(range(len(runs))):
                ms[i] = min(ms[i], graph_ms(runs[i][2]))
            for (cost, blk, _), t in zip(runs, ms):
                print(f"[pw-tile] {ci}->{co} {ho}x{ho} th {blk.th} tw "
                      f"{blk.tw} wgs {blk.wgs} mpw {blk.mpw} groups "
                      f"{blk.groups} splits {blk.splits} model_cost "
                      f"{cost:.0f} graph_ms {t:.4f}")
            if ms:
                times["tile chosen"] = ms[0]
                times["tile fastest"] = min(ms)
            pw[(ci, co, ho)] = times
            print(f"[pw-leg] {ci}->{co} {ho}x{ho} n{N}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()), flush=True)
            del x, w, z, g, want, dz, scale, runs
        if (ci, s, h) not in dw:
            x = torch.randn((N, ci // cb, h, h, cb), device=dev,
                            generator=gen)
            w = torch.randn((ci // cb, 1, 3, 3, 1, cb), device=dev,
                            generator=gen) / 3
            z = direct_conv_blocked(x, w, s, "SAME", groups=ci).contiguous()
            g = torch.randn(z.shape, device=dev, generator=gen)
            want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z,
                                             "relu", groups=ci)
            route = (lambda g=g, w=w, z=z, h=h, s=s: dwk.depthwise_dgrad(
                g, w, (h, h), s, "SAME", z, "relu"))
            torch.testing.assert_close(route(), want, **TOL)
            times = {f"route ({tag})": min(graph_ms(route), graph_ms(route))}
            dw[(ci, s, h)] = times
            print(f"[dw-leg] {ci} {h}x{h} s{s} n{N}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()), flush=True)

            # the depthwise wgrad
            want, want_b = direct_conv_wgrad_blocked(
                x.double(), g.double(), 3, 3, s, "SAME", z.double(), "relu",
                True, groups=ci)
            dz = cotangent_prologue(g, z, "relu")
            scale, scale_b = direct_conv_wgrad_blocked(
                x.abs().double(), dz.abs().double(), 3, 3, s, "SAME",
                with_db=True, groups=ci)

            def check_dw(label, out):
                got = out[:want.numel()].view(want.shape).double()
                got_b = out[want.numel():].view(want_b.shape).double()
                ratio = max(((got - want).abs() / (REL * scale).clamp_min(
                    1e-300)).max().item(), ((got_b - want_b).abs() / (
                        REL * scale_b).clamp_min(1e-300)).max().item())
                if not ratio <= 1:
                    raise RuntimeError(f"{label}: err/bound {ratio}")

            route = (lambda x=x, g=g, z=z, s=s: dwk.depthwise_wgrad_partials(
                x, g, 3, 3, s, "SAME", z, "relu", True))
            check_dw("dw wgrad route", route()[1])
            times = {f"route ({tag})": min(graph_ms(route), graph_ms(route))}
            runs = []
            items = (depthwise_wgrad_items(N, ci, s, h)
                     if hasattr(dwk, "_wgrad_plan") else [])
            for blk in items:
                plan = dwk._wgrad_plan(tuple(x.shape), tuple(g.shape), 3, 3,
                                       s, "SAME", 1, dwk._ACT_CODES["relu"],
                                       True, True, blk)

                def run(plan=plan, x=x, g=g, z=z):
                    return dwk.wgrad_launch(plan, x, g, z)[1]
                check_dw(f"dw wgrad items {blk}", run())
                runs.append((blk, run))
            ms = [graph_ms(r) for _, r in runs]
            for i in reversed(range(len(runs))):
                ms[i] = min(ms[i], graph_ms(runs[i][1]))
            for (blk, _), t in zip(runs, ms):
                print(f"[dw-wgrad-item] {ci} {h}x{h} s{s} hob {blk.hob} wob "
                      f"{blk.wob} lanes {blk.lanes} splits {blk.splits} "
                      f"items/CTA {blk.per_column / blk.splits:.2f} "
                      f"graph_ms {t:.4f}")
            if ms:
                times["items chosen"] = ms[0]
                times["items fastest"] = min(ms)
            dww[(ci, s, h)] = times
            print(f"[dw-wgrad-leg] {ci} {h}x{h} s{s} n{N}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()), flush=True)
            del x, w, z, g, want, want_b, dz, scale, scale_b, runs

    sums = {"pw": {}, "dw": {}, "dww": {}}
    for ci, co, s, h in mobilenet_legs():
        for kind, times in (("pw", pw[(ci, co, -(-h // s))]),
                            ("dw", dw[(ci, s, h)]),
                            ("dww", dww[(ci, s, h)])):
            for label, t in times.items():
                sums[kind][label] = sums[kind].get(label, 0.0) + t
    for kind, name in (("pw", "pointwise wgrad"), ("dw", "depthwise dgrad"),
                       ("dww", "depthwise wgrad")):
        print(f"[sum] {name} (13 legs, n{N}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sums[kind].items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "tag": tag, "sums": sums,
                       "pw": {str(k): v for k, v in pw.items()},
                       "dw": {str(k): v for k, v in dw.items()},
                       "dww": {str(k): v for k, v in dww.items()}}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
