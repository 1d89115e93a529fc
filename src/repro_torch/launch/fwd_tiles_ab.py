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
fastest one measured, then the sums.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.fwd_tiles_ab
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.configs.cnn import vgg16_layers
from repro_torch.core.blocking import H100_SXM, fwd_candidates
from repro_torch.core.convspec import ConvSpec
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


def tile_candidates(n: int, ci: int, co: int, stride: int, h: int,
                    streamed: bool, top: int, per_kind: int):
    """The tiles to time, as ``(model cost, FwdBlocking)``, the chooser's
    first: the ``top`` of least cost and the ``per_kind`` cheapest of each
    (consumer count, lane split)."""
    cib, cob = min(ci, 128), min(co, 128)
    ho = -(-h // stride)
    found = sorted(fwd_candidates(n, ho, ho, 3, 3, stride, ci // cib, cib,
                                  co // cob, cob, H100_SXM, False, streamed),
                   key=lambda kb: kb[0])
    keep = [b for _, b in found[:top]]
    for kind in sorted({(b.wgs, b.nsplit) for _, b in found}):
        keep += [b for _, b in found
                 if (b.wgs, b.nsplit) == kind][:per_kind]
    cost = {b: k[0] for k, b in found}
    return [(cost[b], b) for b in dict.fromkeys(keep)]


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_tiles_ab: no CUDA device")
        return 1
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.kernels import conv2d_stream, direct_conv2d
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    entries = {False: (direct_conv2d._lib, "direct_conv2d_fwd"),
               True: (conv2d_stream._lib, "conv2d_stream_conv")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    sums = {route: [0.0, 0.0] for route in entries}
    for name, ci, co, s, h in fwd_layers():
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        want = direct_conv_blocked(x, w, s, "SAME", b, "relu")
        scale = want.abs().max().item()
        for streamed, (lib, symbol) in entries.items():
            entry = getattr(lib(), symbol)
            runs = []
            for cost, blk in tile_candidates(n, ci, co, s, h, streamed, TOP,
                                             PER_KIND):
                plan = direct_conv2d.fwd_launch(spec, cib, cob, 1, False,
                                                streamed, blk=blk)

                def run(plan=plan, blk=blk):
                    err, out, _, _ = direct_conv2d.fwd_run(entry, plan, x, w,
                                                           b, None, spec)
                    if err:
                        raise RuntimeError(f"{symbol} {blk}: CUDA error "
                                           f"{err}")
                    return out
                bad = (run() - want).abs().max().item()
                if bad > 1e-4 * (1 + scale):
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
                      f"{blk.wgs} nsplit {blk.nsplit} chunk {blk.chunk} "
                      f"model_cost {cost:.0f} graph_ms {t:.4f}")
            times = [(t, blk) for t, (_, blk, _) in zip(ms, runs)]
            chosen, best = times[0], min(times, key=lambda t: t[0])
            sums[streamed][0] += chosen[0]
            sums[streamed][1] += best[0]

            def text(blk):
                return (f"(th {blk.th}, tw {blk.tw}, wgs {blk.wgs}, nsplit "
                        f"{blk.nsplit}, chunk {blk.chunk})")
            print(f"[layer] {name} {route} {ci}->{co} in {h}x{h} s{s}: "
                  f"chosen {text(chosen[1])} {chosen[0]:.4f} ms; fastest "
                  f"{text(best[1])} {best[0]:.4f} ms, ratio "
                  f"{chosen[0] / best[0]:.3f}", flush=True)
        del x, w, b, want
    for streamed, (chosen, best) in sums.items():
        print(f"[sum] {'stream' if streamed else 'window'}: chosen tiles "
              f"{chosen:.4f} ms, fastest measured {best:.4f} ms, ratio "
              f"{chosen / best:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
