"""Time the pointwise forward's and dgrad's tiles at the tiles their
choosers weigh.

The pointwise forward (``csrc/conv2d_pointwise.cu``,
``pointwise_tile_kernel``) takes its tiles from the cost model of
``core.blocking.pointwise_candidates``; the pointwise dgrad runs the dense
dgrad tile at 1x1 (``csrc/dgrad_tile.cuh`` through ``direct_conv2d_bwd.cu``'s
``dgrad_kernel``), tiled by ``core.blocking.dgrad_candidates``.  For each
distinct MobileNet v1 pointwise leg (a 224x224 entry; the forward at batch
8, the last leg with its GAP, or at ``--batch``; the dgrad at batch 32
with the relu prologue) this script times every candidate as a CUDA-graph
replay of ``ITERS`` calls (twice, the candidates in opposite orders, the
faster time kept) and checks each one's output against the plain version.  It prints
the card's name and power limit, each tile with its ms (the forward's with
its model cost), per leg the chooser's tile beside the fastest, and the
sums over the 13 legs.  ``--dtype bf16`` times the bf16 builds
(``pointwise_tile_kernel_bf16``: every candidate of its search, each
consumer count, chunk, lane split and ring; ``dgrad_kernel_bf16``) at their
choosers' candidates (``op_bytes`` 2; the dgrad's a selection,
``dgrad_tile_candidates``) on bf16 operands, each output held to the plain
version under ``BF16`` within one bf16 ulp plus 1e-5 of its max (the
dgrad on the dz pass's dz, as bf16 training calls it); ``--kind``
times one kernel's tiles alone.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.pointwise_tiles_ab \
        [--dtype bf16] [--kind fwd|dgrad|both] [--batch N]
"""
from __future__ import annotations

import argparse
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
# the bf16 dgrad's candidates timed at a leg: the least model cost, and the
# cheapest of each (consumer count, chunk)
BF16_TOP, BF16_PER_CHUNK = 12, 4


def pointwise_legs():
    """The distinct MobileNet v1 pointwise legs as ``(ci, co, h)``."""
    return sorted(set(pw_legs()), key=pw_legs().index)


def _fwd_args(ci: int, co: int, h: int, n: int = FWD_BATCH):
    """The forward chooser's arguments at a leg: ``(n, hw, kblk, kw, oblk,
    ow)``, gap (the last leg's at batch 8, as it is served)."""
    cib, cob = min(ci, 128), min(co, 128)
    return ((n, h * h, ci // cib, cib, co // cob, cob),
            n == FWD_BATCH and (ci, co) == (1024, 1024))


def _dgrad_args(ci: int, co: int, h: int):
    """The dense dgrad chooser's arguments at a leg: ``(n, hi, wi, hf, wf,
    stride, ciblk, cib, cob)``."""
    cib, cob = min(ci, 128), min(co, 128)
    return DGRAD_BATCH, h, h, 1, 1, 1, ci // cib, cib, cob


def tile_candidates(ci: int, co: int, h: int, op_bytes: int = 4,
                    n: int = FWD_BATCH):
    """The forward tiles to time at a leg (``op_bytes`` 2: the bf16
    build's) at batch ``n``, the chooser's first."""
    args, gap = _fwd_args(ci, co, h, n)
    chosen = choose_pointwise_blocking(*args, gap=gap, op_bytes=op_bytes)
    found = sorted(pointwise_candidates(*args, H100_SXM, gap, op_bytes),
                   key=lambda kb: kb[0])
    return [chosen] + [b for _, b in found if b != chosen]


def dgrad_tile_candidates(ci: int, co: int, h: int, op_bytes: int = 4):
    """The dense dgrad tiles at 1x1 to time at a leg, the chooser's first:
    every candidate of the f32 build; of the bf16 build (``op_bytes`` 2)
    the ``BF16_TOP`` of least model cost and the ``BF16_PER_CHUNK``
    cheapest of each (consumer count, chunk)."""
    args = _dgrad_args(ci, co, h)
    chosen = choose_dgrad_blocking(*args, prologue=True, op_bytes=op_bytes)
    found = sorted(dgrad_candidates(*args, H100_SXM, True, False, None,
                                    op_bytes),
                   key=lambda kb: kb[0])
    keep = [b for _, b in found]
    if op_bytes == 2:
        keep = keep[:BF16_TOP] + [
            b for group in sorted({(b.wgs, b.chunk) for b in keep})
            for b in [b for b in keep
                      if (b.wgs, b.chunk) == group][:BF16_PER_CHUNK]]
    return [chosen] + [b for b in dict.fromkeys(keep) if b != chosen]


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


def _check_bf16_run(what, run, want, scale):
    """One bf16 ulp of each element's magnitude plus 1e-5 of max|want|:
    both round f32 sums of the same bf16 products once, in other orders."""
    got, want = run().double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    worst = ((got - want).abs() / (ulp + 1e-5 * scale)).max().item()
    if worst > 1.0:
        raise RuntimeError(f"{what}: err / (1 bf16 ulp + 1e-5 max) = "
                           f"{worst}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--kind", choices=("fwd", "dgrad", "both"),
                    default="both", help="the tiles of one kernel alone")
    ap.add_argument("--batch", type=int, default=FWD_BATCH,
                    help="the forward's batch (the last leg's GAP at 8)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pointwise_tiles_ab: no CUDA device")
        return 1
    bf16 = args.dtype == "bf16"
    dt = torch.bfloat16 if bf16 else torch.float32
    op_bytes = dt.itemsize
    suffix = "_bf16" if bf16 else ""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked)
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels.direct_conv2d import (_ACT_CODES, _bwd_lib,
                                                   cotangent_pass,
                                                   dgrad_launch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    weight = {leg: pw_legs().count(leg) for leg in pointwise_legs()}
    kinds = ("fwd", "dgrad") if args.kind == "both" else (args.kind,)
    sums = {kind: [0.0, 0.0] for kind in kinds}
    for ci, co, h in pointwise_legs():
        cib, cob = min(ci, 128), min(co, 128)
        for kind in kinds:
            n = args.batch if kind == "fwd" else DGRAD_BATCH
            x = torch.randn((n, ci // cib, h, h, cib), device=dev,
                            generator=gen).to(dt)
            w = (torch.randn((co // cob, ci // cib, 1, 1, cib, cob),
                             device=dev, generator=gen) / ci ** 0.5).to(dt)
            b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
            runs = []
            if kind == "fwd":
                (_, hw, kblk, kw, oblk, ow), gap = _fwd_args(ci, co, h, n)
                want = direct_conv_blocked(x, w, 1, "VALID", b, "relu",
                                           args.dtype, gap=gap)
                tiles = tile_candidates(ci, co, h, op_bytes, n)
                for blk in tiles:
                    plan = pwk._tile_plan(n, hw, kblk, kw, oblk, ow,
                                          _ACT_CODES["relu"], gap, blk,
                                          op_bytes)

                    def run(plan=plan):
                        out = torch.empty((n, oblk, h, h, ow), device=dev,
                                          dtype=dt)
                        part = (torch.empty((n, oblk, plan.blk.tiles, ow),
                                            device=dev) if gap else None)
                        pooled = (torch.empty((n, oblk * ow), device=dev,
                                              dtype=dt)
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
                    n, hw, kblk, kw, oblk, ow, H100_SXM, gap, op_bytes)}
                names = [f"rows {bk.rows} lanes {bk.lanes} nsplit "
                         f"{bk.nsplit} chunk {bk.chunk}"
                         + (f" ring {bk.ring} brows {bk.brows}" if bf16
                            else "")
                         + f" model_cost {cost[bk]:.0f}" for bk in tiles]
            else:
                z = direct_conv_blocked(x, w, 1, "VALID", b).contiguous()
                g = torch.randn(z.shape, device=dev, generator=gen).to(dt)
                want = direct_conv_dgrad_blocked(
                    g, w, (h, h), 1, "VALID", z, "relu",
                    precision=args.dtype if bf16 else None)
                spec = ConvSpec.make(n, h, h, ci, co, 1, 1)
                tiles = dgrad_tile_candidates(ci, co, h, op_bytes)
                entry = getattr(_bwd_lib(), "direct_conv2d_dgrad" + suffix)
                # the bf16 build on the dz pass's dz, as training calls it
                operands = ((cotangent_pass(g, z, "relu", False)[0], None,
                             None) if bf16 else (g, z, "relu"))
                for blk in tiles:
                    def run(blk=blk):
                        err, dx, _ = dgrad_launch(entry, blk.th, blk,
                                                  operands[0], w, spec,
                                                  *operands[1:], dt)
                        if err:
                            raise RuntimeError(f"dgrad {blk}: CUDA error "
                                               f"{err}")
                        return dx
                    runs.append(run)
                names = [f"th {bk.th} tw {bk.tw} wgs {bk.wgs} chunk "
                         f"{bk.chunk}" for bk in tiles]
            scale = want.abs().max().item()
            check = _check_bf16_run if bf16 else _check_run
            for blk, run in zip(tiles, runs):
                check(f"{kind} {blk}", run, want, scale)
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
        print(f"[sum] {args.dtype} {kind} over the 13 legs: chosen "
              f"{chosen:.4f} ms, fastest measured {best:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
