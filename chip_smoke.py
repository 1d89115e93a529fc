#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure raises and exits non-zero,
and no phase catches its own failure:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build every CUDA source in ``src/repro_torch/csrc`` (one nvcc each, all
   started together; sm_90a), printing each kernel's registers and spills;
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
   cuDNN ``F.conv2d`` (f32, TF32 off) and the f32 bound;
7. the backward kernels against their plain versions at batch 8 on every
   distinct VGG-16 layer shape of a 224x224 entry: dgrad with the relu
   prologue (all but conv1_1's shape), wgrad with the prologue and ``db``
   (all 10; against f64 sums, twice, bit for bit), the autograd path on a
   small gelu + residual conv at stride 2 with ``Cib = 3`` against torch
   autograd through the plain forward, and the wgrad reduce alone;
8. the second main path: three AdamW steps (cosine schedule) of the
   full-width VGG-16 at batch 8, 224x224, on images and labels drawn from
   ``--seed``, with the launch counts of a step; step 1's loss and every
   gradient against torch autograd through the plain forward, and the
   parameters after step 3 against a plain-path trainer run in lockstep;
9. backward times: per layer, dgrad, wgrad and the wgrad reduce against
   their plain versions, ``aten.convolution_backward`` and the f32 bound;
   the train step against the plain path's; the step's peak device memory
   beside the bytes it must hold.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints neither.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# wgrad vs its f64 plain version: each element sums N*Ho*Wo (up to 401,408
# at conv1_2) products in f32, in shares of a few thousand and then across
# shares.  The bound scales with the sum's length through its absolute
# terms: |kernel - f64| <= WGRAD_REL * sum|x * dz| (about 84 f32 ulps of
# that sum; a missing share or tap would be off by ~1e-3 of it).
WGRAD_REL = 1e-5
# step-1 gradients, kernel path vs torch autograd through the plain forward:
# per tensor, relative to its largest value.  The two forwards sum in other
# orders, so wherever |z| is within f32 rounding of 0 their relu masks can
# differ, and each such flip changes one cotangent element by its whole
# value; 12 layers of dgrad carry the flips down, so the first layers'
# gradients differ by ~1e-3 of their largest value (2.2e-3 at conv1_1 on
# the H100).  A wrong tap, pad or reduction moves them by O(1).
GRAD_RTOL = 1e-2
# parameters after 3 AdamW steps, kernel trainer vs plain trainer.  Adam
# moves an element by lr * m / sqrt(v), ~lr * sign(g) whatever |g| is, so
# an element whose gradient is within the two paths' difference (up to
# ~2e-3 of a tensor's largest gradient, above) of 0 steps differently, by
# up to 2 * sum(lr).  The check: at most PARAM_FRAC of all elements differ
# by more than PARAM_STEP * sum(lr), and none by more than 2.1 * sum(lr).
# A wrong gradient moves most elements apart.
PARAM_FRAC, PARAM_STEP = 1e-2, 0.1
# peak learning rate of the 3 steps: Adam's sign-like first step at 1e-3
# throws a random, unnormalized VGG-16 into a loss of ~350, which magnifies
# every difference between the two trainers; 1e-5 keeps the steps tame
TRAIN_LR = 1e-5
KERNEL_SOURCE = "src/repro_torch/csrc/direct_conv2d_fwd.cu"
BWD_SOURCE = "src/repro_torch/csrc/direct_conv2d_bwd.cu"
TPU_KERNEL = "src/repro/kernels/direct_conv2d.py:102"
TPU_DGRAD = "src/repro/kernels/direct_conv2d.py:138"
TPU_WGRAD = "src/repro/kernels/direct_conv2d.py:175"
BATCH, ENTRY = 8, 224
BUCKETS = ((160, 160), (224, 224))
SOURCES = ("direct_conv2d_fwd", "direct_conv2d_bwd")
LAYER_NAMES = [f"conv{st}_{k}" for st, k in
               ((1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3),
                (4, 1), (4, 2), (4, 3), (5, 1), (5, 2), (5, 3))]


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


def mostly(rows) -> str:
    """The kind of bound that makes up most of the summed ``(ms, kind)``."""
    by_ops = sum(ms for ms, kind in rows if kind == "operations")
    return "operations" if 2 * by_ops >= sum(ms for ms, _ in rows) else "bytes"


def compare_scaled(label: str, got, want, scale, rel: float) -> float:
    """Check ``|got - want| <= rel * scale`` elementwise (all f64); -> max
    abs error."""
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got.double() - want).abs()
    ratio = (err / (rel * scale).clamp_min(1e-300)).max().item()
    ok = bool((err <= rel * scale).all())
    print(f"[check] {label}: max_abs_err={err.max().item():.3e} worst "
          f"err/bound={ratio:.3f} tol=|err| <= {rel:g} * sum|terms| -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its f64 plain version")
    return err.max().item()


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
    from repro_torch.core.blocking import choose_wgrad_blocking
    from repro_torch.core.direct_conv import (direct_conv_blocked,
                                              direct_conv_dgrad_blocked,
                                              direct_conv_wgrad_blocked)
    from repro_torch.core.layout import nhwc_to_blocked
    from repro_torch.kernels._build import build
    from repro_torch.kernels.direct_conv2d import (LAUNCHES,
                                                   direct_conv2d_blocked,
                                                   direct_conv2d_dgrad,
                                                   direct_conv2d_wgrad,
                                                   gap_finalize,
                                                   reset_launches,
                                                   wgrad_partials,
                                                   wgrad_reduce)
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome
    from repro_torch.train.losses import cross_entropy
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainstep import make_train_step

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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, SOURCES))
    for res in built:
        print(f"[build] {res.name}: {res.seconds:.1f} s -> {res.path.name}")
        for line in res.log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
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

    def plain_forward(x, m=model):
        """The VGG-16 forward through the plain conv; differentiable by
        torch autograd (einsum per tap), independent of the port's plain
        dgrad and wgrad."""
        hb = nhwc_to_blocked(x, m.convs[0].in_pencil)
        for i, c in enumerate(m.convs):
            hb = direct_conv_blocked(hb, c.w, c.stride, c.padding, c.b,
                                     c.activation, gap=(i == last))
        return hb @ m.head

    with torch.no_grad():
        reset_launches()
        logits = model(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in LAUNCHES.items() if v}
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
    if any(served[k] for k in ("direct_conv2d_dgrad", "direct_conv2d_wgrad",
                               "wgrad_reduce")):
        fail(f"the server launched backward kernels: {served}")
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
        for name, key in zip(LAYER_NAMES, layers):
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
    conv_by = mostly([(r[3], r[4]) for r in rows])
    print(f"[layer] all 13 convs: kernel_ms {tot[0]:.4f} plain_ms "
          f"{tot[1]:.4f} library_ms {tot[2]:.4f} bound_ms {tot[3]:.4f} "
          f"({conv_by})")
    print(f"[layer] gap_finalize {list(gap_shape)} hw={gap_hw}: kernel_ms "
          f"{g_ms:.4f} plain_ms {gp_ms:.4f} bound_ms {g_bound:.6f} ({g_by})")

    # -- 7. backward kernels vs plain versions -----------------------------
    bwd_err = {"direct_conv2d_dgrad": 0.0, "direct_conv2d_wgrad": 0.0,
               "wgrad_reduce": 0.0}
    bwd_ops = {}      # per distinct shape: the operands phase 9 times
    for ci, co, s, h in shapes:
        x, w, b, _, spec = operands(BATCH, ci, co, h, s)
        with torch.no_grad():     # the kernels take contiguous operands
            z = direct_conv_blocked(x, w, s, "SAME", b).contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        bwd_ops[(ci, co, s, h)] = (x, w, z, g, spec)
        tag = f"{ci}->{co} {h}x{h} s{s} n{BATCH} relu"
        if ci != 3:        # conv1_1's dx is never needed: no dgrad there
            got = direct_conv2d_dgrad(g, w, (h, h), s, "SAME", z, "relu")
            want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z,
                                             "relu")
            torch.cuda.synchronize()
            bwd_err["direct_conv2d_dgrad"] = max(
                bwd_err["direct_conv2d_dgrad"],
                compare(f"dgrad {tag}", got, want, **TOL))
            del got, want
        dw, db = direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                     with_db=True)
        dw2, db2 = direct_conv2d_wgrad(x, g, 3, 3, s, "SAME", z, "relu",
                                       with_db=True)
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"wgrad {tag}: two runs differ")
        want_dw, want_db = direct_conv_wgrad_blocked(
            x.double(), g.double(), 3, 3, s, "SAME", z.double(), "relu",
            with_db=True)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        abs_dw, abs_db = direct_conv_wgrad_blocked(
            x.abs().double(), dz.abs().double(), 3, 3, s, "SAME",
            with_db=True)
        bwd_err["direct_conv2d_wgrad"] = max(
            bwd_err["direct_conv2d_wgrad"],
            compare_scaled(f"wgrad dw {tag} (2 runs identical)", dw,
                           want_dw, abs_dw, WGRAD_REL),
            compare_scaled(f"wgrad db {tag}", db, want_db, abs_db,
                           WGRAD_REL))
        del dw, db, dw2, db2, want_dw, want_db, abs_dw, abs_db, dz

    # the autograd path on a small gelu + residual conv, stride 2, Cib = 3,
    # against torch autograd through the plain forward
    x, w, b, r, _ = operands(2, 3, 64, 20, 2, residual=True)
    ct = torch.randn(r.shape, device=dev, generator=gen)

    def grads_of(forward):
        ins = [t.clone().requires_grad_() for t in (x, w, b, r)]
        forward(*ins).backward(ct)
        return [t.grad for t in ins]

    got = grads_of(lambda x_, w_, b_, r_: direct_conv2d_blocked(
        x_, w_, b_, 2, "SAME", "gelu", residual=r_))
    want = grads_of(lambda x_, w_, b_, r_: direct_conv_blocked(
        x_, w_, 2, "SAME", b_, "gelu", residual=r_))
    torch.cuda.synchronize()
    for name, gk, gp in zip(("dx", "dw", "db", "dres"), got, want):
        kernel = "direct_conv2d_dgrad" if name == "dx" else \
            "direct_conv2d_wgrad"
        bwd_err[kernel] = max(bwd_err[kernel], compare(
            f"autograd {name} 3->64 20x20 s2 n2 gelu+residual vs plain "
            "autograd", gk, gp, **TOL))

    # the reduce alone, on the workspace shape of conv4_2
    ci, co, s, h = layers[8]
    wb = choose_wgrad_blocking(BATCH, h, h, 3, 3, s, ci // 128, 128,
                               co // 128, 128)
    parts = torch.randn((wb.splits, 9 * ci * co + co), device=dev,
                        generator=gen)
    got = wgrad_reduce(parts)
    want = conv2d_common.wgrad_reduce(parts)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("wgrad_reduce differs from the in-order sum of its rows")
    print(f"[check] wgrad_reduce {list(parts.shape)}: identical bits to "
          f"the rows summed in order -> ok")
    del parts, got, want

    # -- 8. the second main path: VGG-16 training ---------------------------
    train_model = vgg16_blocked(
        1000, device=dev, generator=torch.Generator().manual_seed(args.seed + 1))
    plain_model = copy.deepcopy(train_model)
    start = {k: p.detach().clone()
             for k, p in train_model.named_parameters()}
    lr = cosine_schedule(TRAIN_LR, 1, 3)
    opt = AdamW(lr=lr)
    state = opt.init(dict(train_model.named_parameters()))
    plain_state = opt.init(dict(plain_model.named_parameters()))
    step = make_train_step(train_model, opt)
    plain_params = dict(plain_model.named_parameters())

    def plain_step(st, bt):
        for p in plain_params.values():
            p.grad = None
        logits_p = plain_forward(bt["images"], plain_model)
        loss_p, _ = cross_entropy(logits_p[:, None, :],
                                  bt["targets"][:, None], 1000)
        loss_p.backward()
        opt.update({k: p.grad for k, p in plain_params.items()}, st,
                   plain_params)
        return loss_p.detach()

    rng = np.random.default_rng(args.seed)

    def batch():
        return {"images": torch.from_numpy(rng.standard_normal(
                    (BATCH, ENTRY, ENTRY, 3), dtype=np.float32)).to(dev),
                "targets": torch.from_numpy(
                    rng.integers(0, 1000, BATCH)).to(dev)}

    train_batches = [batch() for _ in range(3)]
    losses, plain_losses = [], []
    reset_launches()
    for k, bt in enumerate(train_batches):
        loss, _ = step(state, bt)
        torch.cuda.synchronize()
        if k == 0:
            per_step = dict(LAUNCHES)
            grads = {n: p.grad.clone()
                     for n, p in train_model.named_parameters()}
        losses.append(loss.item())
        plain_losses.append(plain_step(plain_state, bt).item())
        if k == 0:
            print(f"[train] launches in one step: {per_step}")
            want = {"direct_conv2d_fwd": 13, "gap_finalize": 0,
                    "direct_conv2d_dgrad": 12, "direct_conv2d_wgrad": 13,
                    "wgrad_reduce": 13}
            if per_step != want:
                fail(f"a train step launched {per_step}, expected {want}")
            ratios = {}
            for name, p in plain_params.items():
                err = (grads[name] - p.grad).abs().max().item()
                ratios[name] = err / max(p.grad.abs().max().item(), 1e-30)
            print("[train] step-1 gradients vs plain autograd, max-err/"
                  "max-value per tensor: " + " ".join(
                      f"{k}={v:.2e}" for k, v in ratios.items()))
            bad = {k: v for k, v in ratios.items() if not v <= GRAD_RTOL}
            if bad:
                fail(f"step-1 gradients beyond {GRAD_RTOL:g}: {bad}")
            print(f"[train] all {len(ratios)} gradients within "
                  f"{GRAD_RTOL:g} of their largest value -> ok")
            if not abs(losses[0] - plain_losses[0]) <= 1e-4 * abs(
                    plain_losses[0]):
                fail(f"step-1 loss {losses[0]} != plain {plain_losses[0]}")
    train_counts = dict(LAUNCHES)
    print(f"[train] VGG-16 n{BATCH} {ENTRY}x{ENTRY} 1000 classes, AdamW "
          f"cosine: losses {losses} plain path {plain_losses}")
    print(f"[train] launches in 3 steps: {train_counts}")
    if any(not np.isfinite(v) for v in losses):
        fail("non-finite loss")
    lr_sum = sum(lr(t) for t in (1, 2, 3))
    far, n_el, worst, apart, moved = 0, 0, 0.0, 0.0, 0.0
    for name, p in train_model.named_parameters():
        d = (p.detach() - plain_params[name].detach()).abs()
        far += int((d > PARAM_STEP * lr_sum).sum())
        n_el += d.numel()
        worst = max(worst, d.max().item())
        apart += d.square().sum().item()
        moved += (plain_params[name].detach()
                  - start[name]).square().sum().item()
    print(f"[train] parameters after 3 steps vs the plain trainer: {far} of "
          f"{n_el} elements differ by more than {PARAM_STEP:g} * sum(lr)="
          f"{lr_sum:g}, largest difference {worst:.3e}, |kernel - plain| / "
          f"|plain - start| = {(apart / moved) ** 0.5:.3e} (tol: at most "
          f"{PARAM_FRAC:g} of elements, none above 2.1 * sum(lr))")
    if far > PARAM_FRAC * n_el or worst > 2.1 * lr_sum:
        fail("the kernel trainer drifted from the plain trainer")
    del grads, start

    # -- 9. backward times -------------------------------------------------
    brows = {}
    for ci, co, s, h in shapes:
        x, w, z, g, spec = bwd_ops[(ci, co, s, h)]
        (pt, pb), (pl, pr) = spec.pads
        xp = F.pad(x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h),
                   (pl, pr, pt, pb)).contiguous()
        w_oihw = (w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 3, 3)
                  .contiguous())
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        dz_nchw = (dz.permute(0, 1, 4, 2, 3)
                   .reshape(BATCH, co, spec.ho, spec.wo).contiguous())
        flops = spec.flops()
        row = {}
        if ci != 3:
            row["dgrad"] = (
                time_ms(lambda: direct_conv2d_dgrad(g, w, (h, h), s, "SAME",
                                                    z, "relu")),
                time_ms(lambda: direct_conv_dgrad_blocked(
                    g, w, (h, h), s, "SAME", z, "relu")),
                time_ms(lambda: torch.ops.aten.convolution_backward(
                    dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1],
                    False, [0, 0], 1, [True, False, False])),
                *bound(flops, 4 * (2 * g.numel() + w.numel() + x.numel())))
        row["wgrad"] = (
            time_ms(lambda: wgrad_partials(x, g, 3, 3, s, "SAME", z, "relu",
                                           with_db=True)),
            time_ms(lambda: direct_conv_wgrad_blocked(
                x, g, 3, 3, s, "SAME", z, "relu", with_db=True)),
            time_ms(lambda: torch.ops.aten.convolution_backward(
                dz_nchw, xp, w_oihw, None, [s, s], [0, 0], [1, 1], False,
                [0, 0], 1, [False, True, False])),
            *bound(flops, 4 * (x.numel() + 2 * g.numel() + w.numel() + co)))
        ws = wgrad_partials(x, g, 3, 3, s, "SAME", z, "relu", with_db=True)
        row["reduce"] = (
            time_ms(lambda: wgrad_reduce(ws), iters=20),
            time_ms(lambda: conv2d_common.wgrad_reduce(ws), iters=20),
            time_ms(lambda: torch.sum(ws, dim=0), iters=20),
            *bound(ws.numel(), 4 * (ws.numel() + ws.shape[1])))
        row["splits"] = ws.shape[0]
        brows[(ci, co, s, h)] = row
        del ws, xp, w_oihw, dz, dz_nchw
    sums = {k: [0.0, 0.0, 0.0, 0.0] for k in ("dgrad", "wgrad", "reduce")}
    kinds = {k: [] for k in sums}
    for name, key in zip(LAYER_NAMES, layers):
        ci, co, s, h = key
        row = brows[key]
        for kind in ("dgrad", "wgrad", "reduce"):
            if kind not in row:
                continue
            k_ms, p_ms, l_ms, b_ms, b_by = row[kind]
            for i, v in enumerate((k_ms, p_ms, l_ms, b_ms)):
                sums[kind][i] += v
            kinds[kind].append((b_ms, b_by))
            extra = f" splits {row['splits']}" if kind == "reduce" else ""
            print(f"[bwd] {name} {kind} {ci}->{co} in {h}x{h} s{s} n{BATCH}:"
                  f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                  f"{l_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) bound/kernel "
                  f"{b_ms / k_ms:.3f}{extra}")
    for kind, (k_ms, p_ms, l_ms, b_ms) in sums.items():
        print(f"[bwd] all {len(kinds[kind])} {kind}: kernel_ms {k_ms:.4f} "
              f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
              f"{b_ms:.4f} ({mostly(kinds[kind])})")

    def timed_step(fn, st, bt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(st, bt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    k_times, p_times = [], []
    for k in range(4):              # plain, kernel, kernel, plain, ...
        bt = train_batches[k % 3]
        if k % 3 == 0:
            p_times.append(timed_step(plain_step, plain_state, bt))
            k_times.append(timed_step(step, state, bt))
        else:
            k_times.append(timed_step(step, state, bt))
            p_times.append(timed_step(plain_step, plain_state, bt))
    print(f"[train] step ms (host clock, synchronized): kernels {k_times} "
          f"plain {p_times}; median kernels {np.median(k_times):.3f} plain "
          f"{np.median(p_times):.3f}")

    # peak device memory of one kernel step, against what it must hold
    del plain_model, plain_state, plain_params
    torch.cuda.empty_cache()
    params = list(train_model.parameters())
    p_bytes = 4 * sum(p.numel() for p in params)
    state_bytes = 3 * p_bytes + sum(4 * p.grad.numel() for p in params
                                    if p.grad is not None)
    other = torch.cuda.memory_allocated() - state_bytes
    torch.cuda.reset_peak_memory_stats()
    step(state, train_batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    saved, ws_max, hh = 0, 0, ENTRY
    for (ci, co, s), c in zip(vgg16_layers(), train_model.convs):
        ho = -(-hh // s)
        saved += 4 * BATCH * (ci * hh * hh + co * ho * ho)    # x and z
        wb = choose_wgrad_blocking(BATCH, ho, ho, 3, 3, s,
                                   ci // c.in_pencil, c.in_pencil,
                                   co // c.out_pencil, c.out_pencil)
        ws_max = max(ws_max, 4 * wb.splits * (9 * ci * co + co))
        hh = ho
    must = 4 * p_bytes + saved + ws_max
    print(f"[train] peak device memory of one step: {peak / 2**20:.1f} MiB; "
          f"it must hold {must / 2**20:.1f} MiB = parameters, gradients and "
          f"2 Adam moments {4 * p_bytes / 2**20:.1f} + saved x and z "
          f"{saved / 2**20:.1f} + largest wgrad workspace "
          f"{ws_max / 2**20:.1f}")

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
    for name, kind, tpu in (("direct_conv2d_dgrad", "dgrad", TPU_DGRAD),
                            ("direct_conv2d_wgrad", "wgrad", TPU_WGRAD),
                            ("wgrad_reduce", "reduce", TPU_WGRAD)):
        k_ms, p_ms, l_ms, b_ms = sums[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE,
            "replaces": tpu, "launches": train_counts[name],
            "max_abs_err": bwd_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": mostly(kinds[kind]),
            "library_ms": l_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
