"""Time the pointwise forward's and dgrad's tiles at the tiles their
choosers weigh.

The pointwise forward (``csrc/conv2d_pointwise.cu``,
``pointwise_tile_kernel``) takes its tiles from the cost model of
``core.blocking.pointwise_candidates``; the pointwise dgrad runs the dense
dgrad tile at 1x1 (``csrc/dgrad_tile.cuh`` through ``direct_conv2d_bwd.cu``'s
``dgrad_kernel``), tiled by ``core.blocking.dgrad_candidates``.  For each
distinct MobileNet v1 pointwise leg (a 224x224 entry; the forward at batch
8, the last leg with its GAP; the dgrad at batch 32 with the relu
prologue) this script times every candidate as a CUDA-graph replay of
``ITERS`` calls (twice, the candidates in opposite orders, the faster time
kept) and checks each one's output against the plain version.  It prints
the card's name and power limit, each tile with its ms (the forward's with
its model cost), per leg the chooser's tile beside the fastest, and the
sums over the 13 legs.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.pointwise_tiles_ab
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.core.blocking import (H100_SXM, choose_dgrad_blocking,
                                       choose_pointwise_blocking,
                                       dgrad_candidates,
                                       pointwise_candidates)
from repro_torch.launch.dgrad_tiles_ab import graph_ms
from repro_torch.launch.separable_parts_ab import pw_legs

ITERS = 10
FWD_BATCH, DGRAD_BATCH = 8, 32


def pointwise_legs():
    """The distinct MobileNet v1 pointwise legs as ``(ci, co, h)``."""
    return sorted(set(pw_legs()), key=pw_legs().index)


def _fwd_args(ci: int, co: int, h: int):
    """The forward chooser's arguments at a leg: ``(n, hw, kblk, kw, oblk,
    ow)``, gap."""
    cib, cob = min(ci, 128), min(co, 128)
    return ((FWD_BATCH, h * h, ci // cib, cib, co // cob, cob),
            (ci, co) == (1024, 1024))


def _dgrad_args(ci: int, co: int, h: int):
    """The dense dgrad chooser's arguments at a leg: ``(n, hi, wi, hf, wf,
    stride, ciblk, cib, cob)``."""
    cib, cob = min(ci, 128), min(co, 128)
    return DGRAD_BATCH, h, h, 1, 1, 1, ci // cib, cib, cob


def tile_candidates(ci: int, co: int, h: int):
    """The forward tiles to time at a leg, the chooser's first."""
    args, gap = _fwd_args(ci, co, h)
    chosen = choose_pointwise_blocking(*args, gap=gap)
    found = sorted(pointwise_candidates(*args, H100_SXM, gap),
                   key=lambda kb: kb[0])
    return [chosen] + [b for _, b in found if b != chosen]


def dgrad_tile_candidates(ci: int, co: int, h: int):
    """The dense dgrad tiles at 1x1 to time at a leg, the chooser's
    first."""
    args = _dgrad_args(ci, co, h)
    chosen = choose_dgrad_blocking(*args, prologue=True)
    found = sorted(dgrad_candidates(*args, H100_SXM, True, False),
                   key=lambda kb: kb[0])
    return [chosen] + [b for _, b in found if b != chosen]


def _time_all(runs):
    """Graph ms of each run, timed twice in opposite orders, the faster
    kept."""
    ms = [graph_ms(r, ITERS) for r in runs]
    for i in reversed(range(len(runs))):
        ms[i] = min(ms[i], graph_ms(runs[i], ITERS))
    return ms


def _check_run(what, run, want, scale):
    bad = (run() - want).abs().max().item()
    if bad > 1e-4 * (1 + scale):
        raise RuntimeError(f"{what}: |out - plain| = {bad} (max |out| "
                           f"{scale})")


def main() -> int:
    if not torch.cuda.is_available():
        print("pointwise_tiles_ab: no CUDA device")
        return 1
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked)
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels.direct_conv2d import (_ACT_CODES, _bwd_lib,
                                                   dgrad_launch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    weight = {leg: pw_legs().count(leg) for leg in pointwise_legs()}
    sums = {kind: [0.0, 0.0] for kind in ("fwd", "dgrad")}
    for ci, co, h in pointwise_legs():
        cib, cob = min(ci, 128), min(co, 128)
        for kind in ("fwd", "dgrad"):
            n = FWD_BATCH if kind == "fwd" else DGRAD_BATCH
            x = torch.randn((n, ci // cib, h, h, cib), device=dev,
                            generator=gen)
            w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob),
                            device=dev, generator=gen) / ci ** 0.5
            b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
            runs = []
            if kind == "fwd":
                (_, hw, kblk, kw, oblk, ow), gap = _fwd_args(ci, co, h)
                want = direct_conv_blocked(x, w, 1, "VALID", b, "relu",
                                           gap=gap)
                tiles = tile_candidates(ci, co, h)
                for blk in tiles:
                    plan = pwk._tile_plan(n, hw, kblk, kw, oblk, ow,
                                          _ACT_CODES["relu"], gap, blk)

                    def run(plan=plan):
                        out = torch.empty((n, oblk, h, h, ow), device=dev)
                        part = (torch.empty((n, oblk, plan.blk.tiles, ow),
                                            device=dev) if gap else None)
                        pooled = (torch.empty((n, oblk * ow), device=dev)
                                  if gap else None)
                        err = pwk.tile_launch(
                            plan, dev, (x.data_ptr(), w.data_ptr(),
                                        b.data_ptr(), None), out, part,
                            pooled)
                        if err:
                            raise RuntimeError(f"fwd {plan.blk}: CUDA error "
                                               f"{err}")
                        return pooled if gap else out
                    runs.append(run)
                cost = {bk: k[0] for k, bk in pointwise_candidates(
                    n, hw, kblk, kw, oblk, ow, H100_SXM, gap)}
                names = [f"rows {bk.rows} lanes {bk.lanes} nsplit "
                         f"{bk.nsplit} chunk {bk.chunk} model_cost "
                         f"{cost[bk]:.0f}" for bk in tiles]
            else:
                z = direct_conv_blocked(x, w, 1, "VALID", b).contiguous()
                g = torch.randn(z.shape, device=dev, generator=gen)
                want = direct_conv_dgrad_blocked(g, w, (h, h), 1, "VALID", z,
                                                 "relu")
                spec = ConvSpec.make(n, h, h, ci, co, 1, 1)
                tiles = dgrad_tile_candidates(ci, co, h)
                for blk in tiles:
                    def run(blk=blk):
                        err, dx, _ = dgrad_launch(
                            _bwd_lib().direct_conv2d_dgrad, blk.th, blk, g,
                            w, spec, z, "relu")
                        if err:
                            raise RuntimeError(f"dgrad {blk}: CUDA error "
                                               f"{err}")
                        return dx
                    runs.append(run)
                names = [f"th {bk.th} tw {bk.tw} wgs {bk.wgs} chunk "
                         f"{bk.chunk}" for bk in tiles]
            scale = want.abs().max().item()
            for blk, run in zip(tiles, runs):
                _check_run(f"{kind} {blk}", run, want, scale)
            ms = _time_all(runs)
            for name, t in zip(names, ms):
                print(f"[tile] {kind} {ci}->{co} {h}x{h} {name} graph_ms "
                      f"{t:.4f}", flush=True)
            best = min(range(len(ms)), key=ms.__getitem__)
            sums[kind][0] += weight[(ci, co, h)] * ms[0]
            sums[kind][1] += weight[(ci, co, h)] * ms[best]
            print(f"[leg] {kind} {ci}->{co} {h}x{h} n{n}: chosen {ms[0]:.4f} "
                  f"ms, fastest {ms[best]:.4f} ms ({names[best]}), ratio "
                  f"{ms[0] / ms[best]:.3f}", flush=True)
            del x, w, b, want, runs
    for kind, (chosen, best) in sums.items():
        print(f"[sum] {kind} over the 13 legs: chosen {chosen:.4f} ms, "
              f"fastest measured {best:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
