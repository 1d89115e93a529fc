"""Time the tensor-core wgrad kernels at the tiles their chooser weighs.

The window wgrad (``csrc/direct_conv2d_bwd.cu``) and the streamed one
(``csrc/conv2d_stream.cu``), both on ``csrc/wgrad_tile.cuh``, take their
tiles from the cost model of ``core.blocking.wgrad_candidates``.  For each
distinct VGG-16 layer shape (batch 8, a 224x224 entry, the relu prologue
and ``db``) and both routes, this script times as CUDA-graph replays of
``ITERS`` calls the ``TOP`` candidates of least model cost and the
``PER_COUNT`` cheapest of each (consumer warpgroups, m-tiles a warpgroup)
pair (each twice, the candidates in opposite orders, the faster time
kept), checks each tile's workspace, reduced, against the f64 plain
version (``|dw - plain| <= 1e-5 * sum |x * dz|``), and prints the card's
name and power limit, each tile with its model cost and ms, and per layer
and route the chooser's tile beside the fastest one measured, then the
sums over VGG-16's 13 layers.  ``--dtype bf16`` times the bf16 GEMMs
(``wgrad_kernel_bf16``, ``stream_wgrad_kernel_bf16``) at the bf16
chooser's candidates (``op_bytes`` 2) on bf16 x and dz (formed once by the
dz pass, which no candidate changes), against the f64 sums of the same
bf16 operands.  ``--grouped`` times instead the window kernel's grouped and
dilated geometry: AlexNet's five layers (``alexnet_blocked``, a 227x227
entry) and DeepLab-LargeFOV's conv5 (dilation 2) and fc6 (dilation 12) on
a 41x41 map (``grouped_layers``).  ``--first`` times the bf16 window GEMM
at the three nets' first layers (Cib 3: the narrow rows of
``csrc/narrow_rows.cuh``) and AlexNet's conv2 and conv3 (odd widths at
stride 2: x by element-strided TMA boxes), the cheapest candidates of each
path among them, and prints each layer's fastest tile of each path beside
the chosen one.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.wgrad_tiles_ab \
        [--dtype bf16] [--grouped | --first]
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.configs.cnn import vgg16_layers
from repro_torch.core.blocking import H100_SXM, wgrad_candidates
from repro_torch.core.convspec import ConvSpec
from repro_torch.launch.dgrad_tiles_ab import NAMES, graph_ms
from repro_torch.launch.fwd_tiles_ab import first_layers, grouped_layers

TOP, PER_COUNT, ITERS = 8, 2, 10
REL = 1e-5


def wgrad_layers(entry: int = 224):
    """VGG-16's 13 layers as ``(name, ci, co, stride, h)``, ``h`` the
    layer's input extent."""
    out, h = [], entry
    for name, (ci, co, s) in zip(NAMES, vgg16_layers()):
        out.append((name, ci, co, s, h))
        h = -(-h // s)
    return out


def grouped_candidates(spec: ConvSpec, cib: int, cob: int, op_bytes: int,
                       top: int = TOP, per_count: int = PER_COUNT,
                       both: bool = False):
    """``tile_candidates`` of the window wgrad at ``spec``'s grouped and
    dilated geometry (``grouped_layers``), with the relu prologue; with
    ``both`` the bf16 GEMM's other path's after them (the per-tap tiles
    where the narrow rows fit, each path's cost its own model's)."""
    out = {}
    for path in (None, True, False) if both else (None,):
        for cost, b in _keep(wgrad_candidates(
                spec.n, spec.ho, spec.wo, spec.hf, spec.wf, spec.stride,
                spec.ci // cib, cib, spec.co // cob, cob, H100_SXM, True,
                False, None, op_bytes, spec.groups, spec.dilation, path),
                top, per_count):
            out.setdefault(b, cost)
    return [(cost, b) for b, cost in out.items()]


def tile_candidates(n: int, ci: int, co: int, stride: int, h: int,
                    streamed: bool, top: int, per_count: int,
                    op_bytes: int = 4):
    """The tiles to time, as ``(model cost, blocking)``, the chooser's
    first: the ``top`` of least cost and the ``per_count`` cheapest of each
    (consumer warpgroups, m-tiles a warpgroup) pair (of the bf16 build's
    chooser at ``op_bytes`` 2)."""
    cib, cob = min(ci, 128), min(co, 128)
    ho = -(-h // stride)
    return _keep(wgrad_candidates(n, ho, ho, 3, 3, stride, ci // cib, cib,
                                  co // cob, cob, H100_SXM, True, streamed,
                                  None, op_bytes), top, per_count)


def _keep(found, top: int, per_count: int):
    """The ``top`` of least cost among ``found`` and the ``per_count``
    cheapest of each (consumer warpgroups, m-tiles a warpgroup) pair, the
    least first."""
    found = sorted(found, key=lambda kb: kb[0])
    keep = [b for _, b in found[:top]]
    for pair in sorted({(b.wgs, b.mpw) for _, b in found}):
        keep += [b for _, b in found if (b.wgs, b.mpw) == pair][:per_count]
    cost = {}
    for k, b in found:
        cost.setdefault(b, k[0])
    return [(cost[b], b) for b in dict.fromkeys(keep)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--grouped", action="store_true",
                    help="AlexNet's and DeepLab-LargeFOV's grouped and "
                         "dilated wgrads, the window kernel")
    ap.add_argument("--first", action="store_true",
                    help="the bf16 window GEMM's narrow rows and per-tap "
                         "tiles at the first layers and AlexNet's conv2-3")
    args = ap.parse_args(argv)
    if args.first:
        args.dtype = "bf16"
    bf16 = args.dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    suffix = "_bf16" if args.dtype == "bf16" else ""
    if not torch.cuda.is_available():
        print("wgrad_tiles_ab: no CUDA device")
        return 1
    from repro_torch.core.conv2d_common import cotangent_prologue
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.kernels import conv2d_stream, direct_conv2d
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    entries = {False: (direct_conv2d._bwd_lib, "direct_conv2d_wgrad" + suffix),
               True: (conv2d_stream._lib, "conv2d_stream_wgrad" + suffix)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    if args.grouped or args.first:    # the streamed kernels: dense, per tap
        entries = {False: entries[False]}
        layers = first_layers(n) if args.first else grouped_layers(n)
    else:
        layers = [(name, ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME"),
                   min(ci, 128), min(co, 128))
                  for name, ci, co, s, h in wgrad_layers()]
    sums = {route: [0.0, 0.0] for route in entries}
    timed = {}
    for name, spec, cib, cob in layers:
        ci, co, s, h = spec.ci, spec.co, spec.stride, spec.hi
        hf, wf, pad, gr, dil = (spec.hf, spec.wf, spec.pads, spec.groups,
                                spec.dilation)
        key = (ci, co, s, h, hf, gr, dil)
        if key in timed:                 # a repeated shape: its times again
            for streamed, (chosen, best) in timed[key].items():
                sums[streamed][0] += chosen
                sums[streamed][1] += best
            continue
        timed[key] = {}
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, spec.cig // cib, hf, wf, cib, cob),
                        device=dev, generator=gen) / (
            hf * wf * spec.cig) ** 0.5
        z = direct_conv_blocked(x, w, s, pad, groups=gr,
                                dilation=dil).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        x, z, g = x.to(dtype), z.to(dtype), g.to(dtype)
        dz = cotangent_prologue(g, z, "relu")
        want, _ = direct_conv_wgrad_blocked(x.double(), dz.double(), hf, wf,
                                            s, pad, groups=gr, dilation=dil)
        scale, _ = direct_conv_wgrad_blocked(x.abs().double(),
                                             dz.abs().double(), hf, wf, s,
                                             pad, groups=gr, dilation=dil)
        for streamed, (lib, symbol) in entries.items():
            entry = getattr(lib(), symbol)
            runs = []
            for cost, blk in (
                    grouped_candidates(spec, cib, cob, dtype.itemsize,
                                       both=args.first)
                    if args.grouped or args.first else
                    tile_candidates(n, ci, co, s, h, streamed, TOP,
                                    PER_COUNT, dtype.itemsize)):
                # the bf16 GEMM takes dz alone, no db
                plan = direct_conv2d.wgrad_launch_plan(
                    blk, x.shape, g.shape, hf, wf, spec, 0 if bf16 else 1,
                    not bf16)
                operands = (x, dz, None) if bf16 else (x, g, z)

                def run(blk=blk, plan=plan, operands=operands):
                    err, _, out = direct_conv2d.wgrad_launch(
                        entry, plan, *operands, dtype)
                    if err:
                        raise RuntimeError(f"{symbol} {blk}: CUDA error "
                                           f"{err}")
                    return out
                dw, _ = direct_conv2d.split_wgrad(run(), x.shape, g.shape, hf,
                                                  wf, not bf16, gr)
                ratio = ((dw.double() - want).abs()
                         / (REL * scale).clamp_min(1e-300)).max().item()
                if not ratio <= 1:
                    raise RuntimeError(f"{symbol} {blk}: err/bound {ratio}")
                runs.append((cost, blk, run))
            # two passes in opposite orders; each tile keeps its faster one
            ms = [graph_ms(r, ITERS) for _, _, r in runs]
            for i in reversed(range(len(runs))):
                ms[i] = min(ms[i], graph_ms(runs[i][2], ITERS))
            route = "stream" if streamed else "window"
            for (cost, blk, _), t in zip(runs, ms):
                print(f"[tile] {name} {route} th {blk.th} tw {blk.tw} wgs "
                      f"{blk.wgs} mpw {blk.mpw} groups {blk.groups} splits "
                      f"{blk.splits} narrow {blk.narrow} model_cost "
                      f"{cost:.0f} graph_ms {t:.4f}")
            times = [(t, blk) for t, (_, blk, _) in zip(ms, runs)]
            chosen, best = times[0], min(times, key=lambda t: t[0])
            timed[key][streamed] = (chosen[0], best[0])
            sums[streamed][0] += chosen[0]
            sums[streamed][1] += best[0]

            def tile(b):
                return (f"(th {b.th}, tw {b.tw}, wgs {b.wgs}, mpw {b.mpw}, "
                        f"splits {b.splits}"
                        f"{', narrow rows' if b.narrow else ''})")
            print(f"[layer] {name} {route} {ci}->{co} in {h}x{h} s{s} "
                  f"groups {gr} dilation {dil[0]}: "
                  f"chosen {tile(chosen[1])} {chosen[0]:.4f} ms; fastest "
                  f"{tile(best[1])} {best[0]:.4f} ms, ratio "
                  f"{chosen[0] / best[0]:.3f}", flush=True)
            for path in sorted({b.narrow for _, b in times}):
                t, b = min((tb for tb in times if tb[1].narrow == path),
                           key=lambda tb: tb[0])
                print(f"[path] {name} {'narrow rows' if path else 'per tap'}"
                      f": fastest {tile(b)} {t:.4f} ms", flush=True)
        del x, w, z, g, want, dz, scale
    for streamed, (chosen, best) in sums.items():
        print(f"[sum] {'stream' if streamed else 'window'} {args.dtype} "
              f"({len(layers)} layers{', grouped' if args.grouped else ''}): "
              f"chosen tiles {chosen:.4f} ms, fastest measured {best:.4f} "
              f"ms, ratio {chosen / best:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
