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
(``op_bytes`` 2) on bf16 operands, on the dz pass's dz with the prologue
off as bf16 training calls them, each ``dx`` within 1e-2 of max|dx| of the
plain version on the same operands, and also times the ``BF16_PER_CHUNK``
cheapest of each (consumer count, chunk), the set the bf16 cost model was
fitted to.  ``--grouped`` times instead the window kernel's grouped and
dilated geometry: AlexNet's dgrad layers (conv2-5 of ``alexnet_blocked``,
a 227x227 entry; the images take no gradient) and DeepLab-LargeFOV's conv5
(dilation 2) and fc6 (dilation 12) on a 41x41 map (``grouped_layers``).
Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.dgrad_tiles_ab \
        [--dtype bf16] [--grouped]
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.configs.cnn import vgg16_layers
from repro_torch.core.blocking import H100_SXM, dgrad_candidates
from repro_torch.core.convspec import ConvSpec

TOP, PER_COUNT, ITERS = 12, 3, 10
BF16_PER_CHUNK = 4
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


def grouped_layers(n: int = 8):
    """AlexNet's dgrad layers (conv2-5) and DeepLab-LargeFOV's conv5 and
    fc6 (``fwd_tiles_ab.grouped_layers``), as ``(name, ConvSpec, cib,
    cob)``."""
    from repro_torch.launch.fwd_tiles_ab import grouped_layers as layers
    return [layer for layer in layers(n) if layer[0] != "alexnet.conv1"]


def grouped_candidates(spec: ConvSpec, cib: int, cob: int, op_bytes: int,
                       top: int = TOP, per_count: int = PER_COUNT):
    """``tile_candidates`` of the window dgrad at ``spec``'s grouped and
    dilated geometry, the relu prologue's tiles (as training takes
    them)."""
    found = dgrad_candidates(spec.n, spec.hi, spec.wi, spec.hf, spec.wf,
                             spec.stride, spec.ci // cib, cib, cob, H100_SXM,
                             True, False, None, op_bytes, spec.dilation)
    return _keep(found, top, per_count, 0)


def tile_candidates(n: int, ci: int, co: int, stride: int, h: int,
                    streamed: bool, top: int, per_count: int,
                    op_bytes: int = 4, per_chunk: int = 0):
    """The tiles to time, as ``(model cost, DgradBlocking)``, the chooser's
    first: the ``top`` of least cost and the ``per_count`` cheapest of each
    consumer count (of the bf16 build's chooser at ``op_bytes`` 2), and
    with ``per_chunk`` that many of each (consumer count, chunk)."""
    cib, cob = min(ci, 128), min(co, 128)
    return _keep(dgrad_candidates(n, h, h, 3, 3, stride, ci // cib, cib, cob,
                                  H100_SXM, True, streamed, None, op_bytes),
                 top, per_count, per_chunk)


def _keep(found, top: int, per_count: int, per_chunk: int):
    """The ``top`` of least cost among ``found`` and the ``per_count`` (and
    ``per_chunk``) cheapest of each kind, the least first."""
    found = sorted(found, key=lambda kb: kb[0])
    keep = [b for _, b in found[:top]]
    for wgs in sorted({b.wgs for _, b in found}):
        keep += [b for _, b in found if b.wgs == wgs][:per_count]
        for chunk in sorted({b.chunk for _, b in found}):
            keep += [b for _, b in found
                     if (b.wgs, b.chunk) == (wgs, chunk)][:per_chunk]
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
    ap.add_argument("--grouped", action="store_true",
                    help="AlexNet's and DeepLab-LargeFOV's grouped and "
                         "dilated dgrads, the window kernel")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    suffix = "_bf16" if args.dtype == "bf16" else ""
    per_chunk = BF16_PER_CHUNK if args.dtype == "bf16" else 0
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
    if args.grouped:            # the streamed kernels are dense-only
        entries = {False: entries[False]}
        layers = grouped_layers(n)
    else:
        layers = [(name, ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME"),
                   min(ci, 128), min(co, 128))
                  for name, ci, co, s, h in dgrad_layers()]
    sums = {route: [0.0, 0.0] for route in entries}
    for name, spec, cib, cob in layers:
        ci, co, s, h = spec.ci, spec.co, spec.stride, spec.hi
        g = torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                        generator=gen)
        z = torch.randn(g.shape, device=dev, generator=gen)
        w = torch.randn((co // cob, spec.cig // cib, spec.hf, spec.wf, cib,
                         cob), device=dev, generator=gen) / (
            spec.hf * spec.wf * co / spec.groups) ** 0.5
        g, z, w = g.to(dtype), z.to(dtype), w.to(dtype)
        want = direct_conv_dgrad_blocked(g, w, (h, h), s, spec.pads, z,
                                         "relu", spec.groups, spec.dilation)
        # the bf16 builds run on the dz pass's dz, as bf16 training calls
        # them (prologue off, the tiles of the dgrad with its prologue)
        operands = ((direct_conv2d.cotangent_pass(g, z, "relu", False)[0],
                     None, None) if args.dtype == "bf16"
                    else (g, z, "relu"))
        scale = want.abs().max().item()
        tol = 1e-4 * (1 + scale) if args.dtype == "f32" else 1e-2 * scale
        for streamed, (lib, symbol) in entries.items():
            entry = getattr(lib(), symbol)
            runs = []
            for cost, blk in (
                    grouped_candidates(spec, cib, cob, dtype.itemsize)
                    if args.grouped else
                    tile_candidates(n, ci, co, s, h, streamed, TOP,
                                    PER_COUNT, dtype.itemsize, per_chunk)):
                rows = blk.hso if streamed else blk.th

                def run(blk=blk, rows=rows):
                    d, zz, act = operands
                    err, dx, _ = direct_conv2d.dgrad_launch(
                        entry, rows, blk, d, w, spec, zz, act, dtype)
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
                  f"{ci}->{co} in {h}x{h} s{s} groups {spec.groups} "
                  f"dilation {spec.dilation[0]}: chosen (th {chosen[1].th}, "
                  f"tw {chosen[1].tw}, wgs {chosen[1].wgs}, chunk "
                  f"{chosen[1].chunk}) {chosen[0]:.4f} ms; fastest (th "
                  f"{best[1].th}, tw {best[1].tw}, wgs {best[1].wgs}, chunk "
                  f"{best[1].chunk}) {best[0]:.4f} ms, ratio "
                  f"{chosen[0] / best[0]:.3f}")
        del g, z, w, want, operands
    for streamed, (chosen, best) in sums.items():
        print(f"[sum] {'stream' if streamed else 'window'} {args.dtype}"
              f"{' grouped' if args.grouped else ''}: chosen tiles "
              f"{chosen:.4f} ms, fastest measured {best:.4f} ms, ratio "
              f"{chosen / best:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
