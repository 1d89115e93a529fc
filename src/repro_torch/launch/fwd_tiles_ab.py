"""Time the dense forward kernels at the tiles their chooser weighs.

The window forward (``csrc/direct_conv2d_fwd.cu``) and the streamed one
(``csrc/conv2d_stream.cu``), both the tile of ``csrc/fwd_tile.cuh``, take
their tiles from the cost model of ``core.blocking.fwd_candidates``.  For
each of VGG-16's 13 layers (batch 8, a 224x224 entry, relu) and both
routes, this script times as CUDA-graph replays of ``ITERS`` calls the
``TOP`` candidates of least model cost and the ``PER_KIND`` cheapest of each
(consumer count, lane split) (each twice, the candidates in opposite
orders, the faster time kept), checks each tile's output against the plain
version, and prints the card's name and power limit, each tile with its
model cost and ms, and per layer and route the chooser's tile beside the
fastest one measured, then the sums.  ``--dtype bf16`` does the same for
the tile's bf16 build (bf16 operands, the bf16 chooser's candidates, the
cheapest of each (consumer count, lane split, chunk), the plain version
under ``BF16``), and with ``--mobilenet`` MobileNet v1's ``conv1`` as well.
``--grouped`` times instead the window kernel's grouped and dilated
geometry: AlexNet's five two-tower layers (``configs.cnn.alexnet_blocked``,
its pencils at lane 64; a 227x227 entry) and DeepLab-LargeFOV's dilated
conv5 and fc6 on a 41x41 map.  ``--first`` times the bf16 window kernel at
the three nets' first layers (AlexNet's conv1, VGG-16's conv1_1,
MobileNet's conv1: Cib 3, where the narrow rows of ``csrc/narrow_rows.cuh``
apply) and AlexNet's conv2 and conv3, the cheapest candidates of each path
(narrow rows and per tap) among them, and prints each layer's fastest tile
of each path beside the chosen one.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.fwd_tiles_ab \\
        [--dtype bf16] [--mobilenet | --grouped | --first]
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.configs.cnn import (ALEXNET_LANE, alexnet_layers,
                                     mobilenet_v1_layers, vgg16_layers)
from repro_torch.core.blocking import H100_SXM, fwd_candidates
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.layout import BlockedConvLayout
from repro_torch.launch.dgrad_tiles_ab import NAMES, graph_ms

TOP, PER_KIND, ITERS = 10, 2, 10


def fwd_layers(entry: int = 224):
    """VGG-16's 13 layers as ``(name, ci, co, stride, h)``, ``h`` the
    layer's input extent."""
    out, h = [], entry
    for name, (ci, co, s) in zip(NAMES, vgg16_layers()):
        out.append((name, ci, co, s, h))
        h = -(-h // s)
    return out


def grouped_layers(n: int = 8):
    """AlexNet's five layers (a 227x227 entry) and DeepLab-LargeFOV's conv5
    (dilation 2, 512 -> 512) and fc6 (dilation 12, 512 -> 1024) on a 41x41
    map, as ``(name, ConvSpec, cib, cob)``."""
    out, h = [], 227
    for i, (ci, co, f, s, pad, g) in enumerate(alexnet_layers()):
        spec = ConvSpec.make(n, h, h, ci, co, f, f, s, pad, g)
        lay = BlockedConvLayout.choose(ci, co, ALEXNET_LANE, groups=g)
        out.append((f"alexnet.conv{i + 1}", spec, lay.cb_in, lay.cb_out))
        h = spec.ho
    for name, co, d in (("deeplab.conv5", 512, 2), ("deeplab.fc6", 1024, 12)):
        out.append((name, ConvSpec.make(n, 41, 41, 512, co, 3, 3, 1, "SAME",
                                        1, d), 128, 128))
    return out


def first_layers(n: int = 8):
    """The three nets' first layers (Cib 3), AlexNet's conv2 and conv3, and
    two shapes off the nets that the narrow rows fit: Cib 3 at 7x7 stride 2
    and Cib 8 at 5x5 (40-value runs), as ``(name, ConvSpec, cib, cob)``."""
    alexnet = grouped_layers(n)
    _, ci, co, s = mobilenet_v1_layers()[0]
    return [alexnet[0],
            ("vgg16.conv1_1", ConvSpec.make(n, 224, 224, 3, 64, 3, 3, 1,
                                            "SAME"), 3, 64),
            ("mobilenet.conv1", ConvSpec.make(n, 224, 224, ci, co, 3, 3, s,
                                              "SAME"), ci, co),
            *alexnet[1:3],
            ("cib3.7x7s2", ConvSpec.make(n, 112, 112, 3, 64, 7, 7, 2,
                                         ((3, 3), (3, 3))), 3, 64),
            ("cib8.5x5", ConvSpec.make(n, 56, 56, 8, 64, 5, 5, 1, "SAME"), 8,
             64)]


def tile_candidates(n: int, ci: int, co: int, stride: int, h: int,
                    streamed: bool, top: int, per_kind: int,
                    op_bytes: int = 4, spec=None, cib=None, cob=None,
                    both: bool = False):
    """The tiles to time at ``op_bytes`` operands, as ``(model cost,
    FwdBlocking)``, the chooser's first: the ``top`` of least cost and the
    ``per_kind`` cheapest of each (consumer count, lane split), and at 2-byte
    operands of each chunk too; with ``both`` the same of the bf16 build's
    other path after them (the per-tap tiles where the narrow rows fit, each
    path's cost its own model's).  ``spec`` (with its pencils ``cib``,
    ``cob``) gives any geometry, grouped and dilated included, in place of
    a 3x3 SAME layer."""
    if spec is None:
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")

    def kind(b):
        return (b.wgs, b.nsplit) + ((b.chunk,) if op_bytes == 2 else ())
    keep, cost = [], {}
    for path in (None, True, False) if both else (None,):
        found = sorted(fwd_candidates(n, spec.ho, spec.wo, spec.hf, spec.wf,
                                      spec.stride, spec.cig // cib, cib,
                                      spec.co // cob, cob, H100_SXM, False,
                                      streamed, op_bytes=op_bytes,
                                      dilation=spec.dilation, narrow=path),
                       key=lambda kb: kb[0])
        keep += [b for _, b in found[:top]]
        for k in sorted({kind(b) for _, b in found}):
            keep += [b for _, b in found if kind(b) == k][:per_kind]
        for k, b in found:
            cost.setdefault(b, k[0])
    return [(cost[b], b) for b in dict.fromkeys(keep)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="the build to time (default f32)")
    parser.add_argument("--mobilenet", action="store_true",
                        help="MobileNet v1's conv1 after VGG-16's layers")
    parser.add_argument("--grouped", action="store_true",
                        help="AlexNet's and DeepLab-LargeFOV's grouped and "
                             "dilated layers, window kernel, instead")
    parser.add_argument("--first", action="store_true",
                        help="the bf16 window kernel's narrow rows and "
                             "per-tap tiles at the first layers and "
                             "AlexNet's conv2-3, instead")
    args = parser.parse_args(argv)
    if args.first:
        args.dtype = "bf16"
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    # the bf16 build rounds its output once: one bf16 ulp of the magnitude
    tol = 2.0 ** -7 if args.dtype == "bf16" else 1e-4
    if not torch.cuda.is_available():
        print("fwd_tiles_ab: no CUDA device")
        return 1
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.kernels import conv2d_stream, direct_conv2d
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"operands {args.dtype}")
    entries = {False: (direct_conv2d._lib, "direct_conv2d_fwd"),
               True: (conv2d_stream._lib, "conv2d_stream_conv")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    sums = {route: [0.0, 0.0] for route in entries}
    layers = [(name, ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME"),
               min(ci, 128), min(co, 128)) for name, ci, co, s, h in
              fwd_layers()]
    if args.mobilenet:
        _, ci, co, s = mobilenet_v1_layers()[0]
        layers.append(("mobilenet.conv1", ConvSpec.make(
            n, 224, 224, ci, co, 3, 3, s, "SAME"), ci, co))
    if args.grouped or args.first:    # the streamed kernels: dense, per tap
        layers = first_layers(n) if args.first else grouped_layers(n)
        entries, sums = {False: entries[False]}, {False: [0.0, 0.0]}
    for name, spec, cib, cob in layers:
        ci, co, s, h = spec.ci, spec.co, spec.stride, spec.hi
        g, f = spec.groups, spec.hf
        x = torch.randn((n, ci // cib, h, h, cib), device=dev,
                        generator=gen).to(dtype)
        w = (torch.randn((co // cob, spec.cig // cib, f, f, cib, cob),
                         device=dev, generator=gen)
             / (f * f * spec.cig) ** 0.5).to(dtype)
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        want = direct_conv_blocked(x, w, s, spec.pads, b, "relu", None, g,
                                   spec.dilation).float()
        scale = want.abs().max().item()
        for streamed, (lib, symbol) in entries.items():
            entry = getattr(lib(), symbol)
            runs = []
            for cost, blk in tile_candidates(n, ci, co, s, h, streamed, TOP,
                                             PER_KIND, dtype.itemsize, spec,
                                             cib, cob, both=args.first):
                plan = direct_conv2d.fwd_launch(spec, cib, cob, 1, False,
                                                streamed, blk=blk,
                                                dtype=dtype)

                def run(plan=plan, blk=blk):
                    err, out, _, _ = direct_conv2d.fwd_run(entry, plan, x, w,
                                                           b, None, spec)
                    if err:
                        raise RuntimeError(f"{symbol} {blk}: CUDA error "
                                           f"{err}")
                    return out
                bad = (run().float() - want).abs().max().item()
                if bad > tol * (1 + scale):
                    raise RuntimeError(f"{symbol} {blk}: |out - plain| = "
                                       f"{bad} (max |out| {scale})")
                runs.append((cost, blk, run))
            # two passes in opposite orders; each tile keeps its faster one
            ms = [graph_ms(r, ITERS) for _, _, r in runs]
            for i in reversed(range(len(runs))):
                ms[i] = min(ms[i], graph_ms(runs[i][2], ITERS))
            route = "stream" if streamed else "window"
            for (cost, blk, _), t in zip(runs, ms):
                print(f"[tile] {name} {route} th {blk.th} tw {blk.tw} wgs "
                      f"{blk.wgs} nsplit {blk.nsplit} lanes {blk.lanes} chunk "
                      f"{blk.chunk} frows {blk.stage_rows(f)} narrow "
                      f"{blk.narrow} model_cost {cost:.0f} graph_ms {t:.4f}")
            times = [(t, blk) for t, (_, blk, _) in zip(ms, runs)]
            chosen, best = times[0], min(times, key=lambda t: t[0])
            sums[streamed][0] += chosen[0]
            sums[streamed][1] += best[0]

            def text(blk):
                return (f"(th {blk.th}, tw {blk.tw}, wgs {blk.wgs}, nsplit "
                        f"{blk.nsplit}, lanes {blk.lanes}, chunk {blk.chunk}"
                        f"{', narrow rows' if blk.narrow else ''})")
            print(f"[layer] {name} {route} {ci}->{co} in {h}x{h} s{s}: "
                  f"chosen {text(chosen[1])} {chosen[0]:.4f} ms; fastest "
                  f"{text(best[1])} {best[0]:.4f} ms, ratio "
                  f"{chosen[0] / best[0]:.3f}", flush=True)
            for path in sorted({b.narrow for _, b in times}):
                t, b = min((tb for tb in times if tb[1].narrow == path),
                           key=lambda tb: tb[0])
                print(f"[path] {name} {'narrow rows' if path else 'per tap'}"
                      f": fastest {text(b)} {t:.4f} ms", flush=True)
        del x, w, b, want
    for streamed, (chosen, best) in sums.items():
        print(f"[sum] {'stream' if streamed else 'window'}: chosen tiles "
              f"{chosen:.4f} ms, fastest measured {best:.4f} ms, ratio "
              f"{chosen / best:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
