"""Time the phase-split dgrad kernels at the tiles their chooser weighs.

The window dgrad (``csrc/direct_conv2d_bwd.cu``) and the streamed one
(``csrc/conv2d_stream.cu``) take their tiles from the cost model of
``core.blocking.dgrad_candidates``.  For each VGG-16 dgrad layer (batch 8,
a 224x224 entry, the relu prologue; conv1_1 takes no dgrad) and both
routes, this script times as CUDA-graph replays of ``ITERS`` calls the
``TOP`` candidates of least model cost and the ``PER_COUNT`` cheapest of
each consumer count (each twice, the candidates in opposite orders, the
faster time kept),
checks each tile's ``dx`` against the plain version, and prints the card's
name and power limit, each tile with its model cost and ms, and per layer
and route the chooser's tile beside the fastest one measured, then the sums.
``--dtype bf16`` times the bf16 builds (``dgrad_kernel_bf16``,
``stream_dgrad_kernel_bf16``) at the bf16 chooser's candidates
(``op_bytes`` 2) on bf16 operands, each ``dx`` within 1e-2 of max|dx| of
the plain version on the same operands.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.dgrad_tiles_ab [--dtype bf16]
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.configs.cnn import vgg16_layers
from repro_torch.core.blocking import H100_SXM, dgrad_candidates
from repro_torch.core.convspec import ConvSpec

TOP, PER_COUNT, ITERS = 12, 3, 10
NAMES = [f"conv{st}_{k}" for st, k in
         ((1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3),
          (4, 1), (4, 2), (4, 3), (5, 1), (5, 2), (5, 3))]


def dgrad_layers(entry: int = 224):
    """VGG-16's dgrad layers as ``(name, ci, co, stride, h)``, ``h`` the
    layer's input extent."""
    out, h = [], entry
    for name, (ci, co, s) in zip(NAMES, vgg16_layers()):
        if ci != 3:
            out.append((name, ci, co, s, h))
        h = -(-h // s)
    return out


def tile_candidates(n: int, ci: int, co: int, stride: int, h: int,
                    streamed: bool, top: int, per_count: int,
                    op_bytes: int = 4):
    """The tiles to time, as ``(model cost, DgradBlocking)``, the chooser's
    first: the ``top`` of least cost and the ``per_count`` cheapest of each
    consumer count (of the bf16 build's chooser at ``op_bytes`` 2)."""
    cib, cob = min(ci, 128), min(co, 128)
    found = sorted(dgrad_candidates(n, h, h, 3, 3, stride, ci // cib, cib,
                                    cob, H100_SXM, True, streamed, None,
                                    op_bytes),
                   key=lambda kb: kb[0])
    keep = [b for _, b in found[:top]]
    for wgs in sorted({b.wgs for _, b in found}):
        keep += [b for _, b in found if b.wgs == wgs][:per_count]
    cost = {b: k[0] for k, b in found}
    return [(cost[b], b) for b in dict.fromkeys(keep)]


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed between two events.  The warm-up runs on the stream the
    graph is captured on, so that the split sums' counters the graph keeps
    are that stream's own (``kernels.split_sum``)."""
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
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    suffix = "_bf16" if args.dtype == "bf16" else ""
    if not torch.cuda.is_available():
        print("dgrad_tiles_ab: no CUDA device")
        return 1
    from repro_torch.core.direct_conv import direct_conv_dgrad_blocked
    from repro_torch.kernels import conv2d_stream, direct_conv2d
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    entries = {False: (direct_conv2d._bwd_lib, "direct_conv2d_dgrad" + suffix),
               True: (conv2d_stream._lib, "conv2d_stream_dgrad" + suffix)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    sums = {route: [0.0, 0.0] for route in entries}
    for name, ci, co, s, h in dgrad_layers():
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        g = torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                        generator=gen)
        z = torch.randn(g.shape, device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * co) ** 0.5
        g, z, w = g.to(dtype), z.to(dtype), w.to(dtype)
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z, "relu")
        scale = want.abs().max().item()
        tol = 1e-4 * (1 + scale) if args.dtype == "f32" else 1e-2 * scale
        for streamed, (lib, symbol) in entries.items():
            entry = getattr(lib(), symbol)
            runs = []
            for cost, blk in tile_candidates(n, ci, co, s, h, streamed, TOP,
                                             PER_COUNT, dtype.itemsize):
                rows = blk.hso if streamed else blk.th

                def run(blk=blk, rows=rows):
                    err, dx, _ = direct_conv2d.dgrad_launch(
                        entry, rows, blk, g, w, spec, z, "relu", dtype)
                    if err:
                        raise RuntimeError(f"{symbol} {blk}: CUDA error "
                                           f"{err}")
                    return dx
                bad = (run().float() - want.float()).abs().max().item()
                if bad > tol:
                    raise RuntimeError(f"{symbol} {blk}: |dx - plain| = "
                                       f"{bad} (max |dx| {scale})")
                runs.append((cost, blk, run))
            # two passes in opposite orders; each tile keeps its faster one
            ms = [graph_ms(r, ITERS) for _, _, r in runs]
            for i in reversed(range(len(runs))):
                ms[i] = min(ms[i], graph_ms(runs[i][2], ITERS))
            times = [(t, blk) for t, (_, blk, _) in zip(ms, runs)]
            for (cost, blk, _), t in zip(runs, ms):
                print(f"[tile] {name} {'stream' if streamed else 'window'} "
                      f"th {blk.th} tw {blk.tw} wgs {blk.wgs} chunk "
                      f"{blk.chunk} model_cost {cost:.0f} graph_ms {t:.4f}")
            chosen, best = times[0], min(times, key=lambda t: t[0])
            sums[streamed][0] += chosen[0]
            sums[streamed][1] += best[0]
            print(f"[layer] {name} {'stream' if streamed else 'window'} "
                  f"{ci}->{co} in {h}x{h} s{s}: chosen (th {chosen[1].th}, "
                  f"tw {chosen[1].tw}, wgs {chosen[1].wgs}, chunk "
                  f"{chosen[1].chunk}) {chosen[0]:.4f} ms; fastest (th "
                  f"{best[1].th}, tw {best[1].tw}, wgs {best[1].wgs}, chunk "
                  f"{best[1].chunk}) {best[0]:.4f} ms, ratio "
                  f"{chosen[0] / best[0]:.3f}")
        del g, z, w, want
    for streamed, (chosen, best) in sums.items():
        print(f"[sum] {'stream' if streamed else 'window'} {args.dtype}: "
              f"chosen tiles "
              f"{chosen:.4f} ms, fastest measured {best:.4f} ms, ratio "
              f"{chosen / best:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
