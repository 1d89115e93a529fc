#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure raises and exits non-zero,
and no phase catches its own failure:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card: every
   distinct VGG-16 layer shape at batch 8 that the 224x224 and 160x160
   entries give (the server's two buckets), a small gelu + residual shape
   at stride 2 with ``Cib = 3``, a gelu + residual + GAP shape, and the GAP
   finalize kernel;
4. the full VGG-16 forward (13 convs, 224x224, batch 8) through the
   kernels, with its launch counts, against the plain path's logits;
5. the main path: ``ConvServer`` on buckets 160x160 and 224x224 at batch 8
   serving 24 ragged requests drawn from ``--seed``; every request must end
   OK with the logits of the plain PyTorch forward of its padded image;
6. per-layer times (CUDA events after warm-up): kernel, plain version,
   cuDNN ``F.conv2d`` (f32, TF32 off) and the f32 bound.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints neither.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# f32 kernel vs f32 plain version: the same products summed in another order
# (per tap and channel chunk in registers vs per tap einsum), over up to
# 9 * 512 = 4608 terms of O(1) inputs; f32 rounding stays far below 1e-4.
TOL = {"atol": 1e-4, "rtol": 1e-4}
# logits after 13 layers and the head, relative to the largest logit
LOGIT_RTOL = 1e-3
# NVIDIA H100 SXM data sheet: f32 (non-tensor) peak and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "src/repro_torch/csrc/direct_conv2d_fwd.cu"
TPU_KERNEL = "src/repro/kernels/direct_conv2d.py:102"
BATCH, ENTRY = 8, 224
BUCKETS = ((160, 160), (224, 224))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def compare(label: str, got, want, atol: float, rtol: float) -> float:
    """Print and check max abs/rel error; -> max abs error."""
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got.double() - want.double()).abs()
    max_abs = err.max().item()
    max_rel = (err / want.double().abs().clamp_min(1e-6)).max().item()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    print(f"[check] {label}: max_abs_err={max_abs:.3e} max_rel_err="
          f"{max_rel:.3e} tol=atol {atol:g} + rtol {rtol:g} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return max_abs


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.cnn import vgg16_blocked, vgg16_layers
    from repro_torch.core import conv2d_common
    from repro_torch.core.blocking import choose_blocking
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.core.layout import nhwc_to_blocked
    from repro_torch.kernels._build import build
    from repro_torch.kernels.direct_conv2d import (LAUNCHES,
                                                   direct_conv2d_blocked,
                                                   gap_finalize,
                                                   reset_launches)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    res = build("direct_conv2d_fwd")
    print(f"[build] {res.name}: {res.seconds:.1f} s -> {res.path.name}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    print(f"[build] total {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def operands(n, ci, co, h, stride, residual=False):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")
        r = (torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                         generator=gen) if residual else None)
        return x, w, b, r, spec

    # -- 3. kernels vs plain versions --------------------------------------
    def layer_shapes(entry):
        out, h = [], entry
        for ci, co, s in vgg16_layers():
            out.append((ci, co, s, h))
            h = ConvSpec.make(1, h, h, ci, co, 3, 3, s, "SAME").ho
        return out

    layers = layer_shapes(ENTRY)
    shapes = sorted(set(layers), key=layers.index)
    # every shape the server's buckets give the kernel, with its own tiles
    served_layers = [sh for bh, _ in BUCKETS for sh in layer_shapes(bh)]
    checked = sorted(set(served_layers), key=served_layers.index)
    max_err = {"direct_conv2d_fwd": 0.0, "gap_finalize": 0.0}
    with torch.no_grad():
        for ci, co, s, h in checked:
            x, w, b, _, _ = operands(BATCH, ci, co, h, s)
            got = direct_conv2d_blocked(x, w, b, s, "SAME", "relu")
            want = direct_conv_blocked(x, w, s, "SAME", b, "relu")
            torch.cuda.synchronize()
            max_err["direct_conv2d_fwd"] = max(
                max_err["direct_conv2d_fwd"],
                compare(f"conv {ci}->{co} {h}x{h} s{s} n{BATCH} relu", got,
                        want, **TOL))
        for n, ci, co, h, s, gap in ((2, 3, 64, 20, 2, False),
                                     (2, 64, 128, 28, 1, True)):
            x, w, b, r, _ = operands(n, ci, co, h, s, residual=True)
            got = direct_conv2d_blocked(x, w, b, s, "SAME", "gelu",
                                        residual=r, gap=gap)
            want = direct_conv_blocked(x, w, s, "SAME", b, "gelu",
                                       residual=r, gap=gap)
            torch.cuda.synchronize()
            max_err["direct_conv2d_fwd"] = max(
                max_err["direct_conv2d_fwd"],
                compare(f"conv {ci}->{co} {h}x{h} s{s} n{n} gelu+residual"
                        f"{'+gap' if gap else ''}", got, want, **TOL))
        # the partial sums the last VGG-16 conv hands to the GAP finalize
        ci, co, s, h = layers[-1]
        spec = ConvSpec.make(BATCH, h, h, ci, co, 3, 3, s, "SAME")
        cob = min(co, 128)
        blk = choose_blocking(spec.padded_hi, spec.padded_wi, ci, co, 3, 3,
                              s, cob=cob, cib=min(ci, 128), gap=True)
        gap_shape = (BATCH, co // cob,
                     (spec.ho // blk.hob) * (spec.wo // blk.wob), cob)
        gap_hw = spec.ho * spec.wo
        parts = torch.randn(gap_shape, device=dev, generator=gen)
        max_err["gap_finalize"] = compare(
            f"gap_finalize {list(gap_shape)} hw={gap_hw}",
            gap_finalize(parts, gap_hw),
            conv2d_common.gap_finalize(parts, gap_hw), **TOL)

    # -- 4. full VGG-16 forward --------------------------------------------
    cpu_gen = torch.Generator().manual_seed(args.seed)
    model = vgg16_blocked(1000, device=dev, generator=cpu_gen)
    images = torch.randn((BATCH, ENTRY, ENTRY, 3), generator=cpu_gen).to(dev)
    last = len(model.convs) - 1

    def plain_forward(x):
        hb = nhwc_to_blocked(x, model.convs[0].in_pencil)
        for i, c in enumerate(model.convs):
            hb = direct_conv_blocked(hb, c.w, c.stride, c.padding, c.b,
                                     c.activation, gap=(i == last))
        return hb @ model.head

    with torch.no_grad():
        reset_launches()
        logits = model(images)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        print(f"[vgg16] forward n{BATCH} {ENTRY}x{ENTRY}: launches {counts}")
        if counts != {"direct_conv2d_fwd": 13, "gap_finalize": 1}:
            fail(f"expected 13 conv launches and 1 GAP finalize, got {counts}")
        ref = plain_forward(images)
        scale = ref.abs().max().item()
        compare("vgg16 logits vs plain path", logits, ref,
                atol=LOGIT_RTOL * scale, rtol=0.0)
        fwd_ms = time_ms(lambda: model(images), iters=5)
        fwd_plain_ms = time_ms(lambda: plain_forward(images), iters=5)
    print(f"[vgg16] forward ms: kernels {fwd_ms:.3f} plain {fwd_plain_ms:.3f}")

    # -- 5. the main path: ConvServer --------------------------------------
    server = ConvServer(model, list(BUCKETS), BATCH, device=dev)
    server.warmup()
    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(24):
        hh, ww = (int(v) for v in rng.integers(96, ENTRY + 1, size=2))
        reqs.append(ConvRequest(rid, rng.standard_normal(
            (hh, ww, 3), dtype=np.float32)))
    reset_launches()
    for r in reqs:
        server.submit(r)
    server.run()
    torch.cuda.synchronize()
    served = dict(LAUNCHES)
    health = server.health()
    print(f"[serve] launches {served} health {json.dumps(health)}")
    bad = [r.rid for r in reqs if r.outcome is not Outcome.OK]
    if bad:
        fail(f"requests not OK: {bad}")
    n_fwd = served["gap_finalize"]
    if n_fwd == 0 or served["direct_conv2d_fwd"] != 13 * n_fwd:
        fail(f"server forwards did not all run the kernels: {served}")
    with torch.no_grad():
        err = 0.0
        for r in reqs:
            img = torch.from_numpy(server.bucketer.pad(r.image, r.bucket))
            want = plain_forward(img[None].to(dev))[0].cpu().numpy()
            err = max(err, float(np.abs(r.logits - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    print(f"[serve] logits vs plain PyTorch forward of the padded image: "
          f"max rel-to-max err {err:.3e} (tol {LOGIT_RTOL:g})")
    if not err <= LOGIT_RTOL:
        fail("served logits differ from the plain forward")
    lat = server.latencies() * 1e3
    print(f"[serve] {len(reqs)} requests OK, {health['steps']} steps, "
          f"latency p50 {np.percentile(lat, 50):.3f} ms p99 "
          f"{np.percentile(lat, 99):.3f} ms, occupancy "
          f"{server.occupancy():.3f}")

    # -- 6. per-layer times ------------------------------------------------
    rows, timed = [], {}
    with torch.no_grad():
        for ci, co, s, h in shapes:
            x, w, b, _, spec = operands(BATCH, ci, co, h, s)
            (pt, pb), (pl, pr) = spec.pads
            x_nchw = (x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h)
                      .contiguous())
            xp = F.pad(x_nchw, (pl, pr, pt, pb))
            w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                      .contiguous())
            b_flat = b.reshape(co)
            k_ms = time_ms(lambda: direct_conv2d_blocked(
                x, w, b, s, "SAME", "relu"))
            p_ms = time_ms(lambda: direct_conv_blocked(
                x, w, s, "SAME", b, "relu"))
            l_ms = time_ms(lambda: F.conv2d(xp, w_oihw, b_flat, stride=s))
            nbytes = 4 * (x.numel() + w.numel() + b.numel()
                          + BATCH * co * spec.ho * spec.wo)
            b_ms, b_by = bound(spec.flops(), nbytes)
            timed[(ci, co, s, h)] = (k_ms, p_ms, l_ms, b_ms, b_by)
        names = [f"conv{st}_{k}" for st, k in
                 ((1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3),
                  (4, 1), (4, 2), (4, 3), (5, 1), (5, 2), (5, 3))]
        for name, key in zip(names, layers):
            k_ms, p_ms, l_ms, b_ms, b_by = timed[key]
            ci, co, s, h = key
            rows.append((k_ms, p_ms, l_ms, b_ms, b_by))
            print(f"[layer] {name} {ci}->{co} in {h}x{h} s{s} n{BATCH}: "
                  f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                  f"{l_ms:.4f} launches/forward 1 bound_ms {b_ms:.4f} "
                  f"({b_by}) bound/kernel {b_ms / k_ms:.3f}")
        parts = torch.randn(gap_shape, device=dev, generator=gen)
        g_ms = time_ms(lambda: gap_finalize(parts, gap_hw), iters=50)
        gp_ms = time_ms(lambda: conv2d_common.gap_finalize(parts, gap_hw),
                        iters=50)
        pooled = gap_shape[0] * gap_shape[1] * gap_shape[3]
        g_bound, g_by = bound(parts.numel(), 4 * (parts.numel() + pooled))
    tot = [sum(r[i] for r in rows) for i in range(4)]
    # the kind of bound that makes up most of the 13 launches' summed bound
    by_ops = sum(r[3] for r in rows if r[4] == "operations")
    conv_by = "operations" if 2 * by_ops >= tot[3] else "bytes"
    print(f"[layer] all 13 convs: kernel_ms {tot[0]:.4f} plain_ms "
          f"{tot[1]:.4f} library_ms {tot[2]:.4f} bound_ms {tot[3]:.4f} "
          f"({conv_by})")
    print(f"[layer] gap_finalize {list(gap_shape)} hw={gap_hw}: kernel_ms "
          f"{g_ms:.4f} plain_ms {gp_ms:.4f} bound_ms {g_bound:.6f} ({g_by})")

    kernels = [
        {"name": "direct_conv2d_fwd", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
         "launches": served["direct_conv2d_fwd"],
         "max_abs_err": max_err["direct_conv2d_fwd"], "ms": tot[0],
         "plain_ms": tot[1], "bound_ms": tot[3], "bound_by": conv_by,
         "library_ms": tot[2]},
        {"name": "gap_finalize", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": TPU_KERNEL, "launches": served["gap_finalize"],
         "max_abs_err": max_err["gap_finalize"], "ms": g_ms,
         "plain_ms": gp_ms, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
