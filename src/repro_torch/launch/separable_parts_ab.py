"""Where the separable family's forward time goes: host and device parts.

Two measurements on the card, at MobileNet v1's legs (batch 8, a 224x224
entry, relu; the last pointwise leg with its GAP):

* **host µs a call**: ``time.perf_counter`` over ``HOST_CALLS`` calls of a
  wrapper with no synchronise between them (the host's cost of a call,
  which hides behind the device only while the device is slower; few
  enough calls that the launch queue does not fill and hold the host to
  the device's pace), for
  ``depthwise_conv2d_blocked`` and ``pointwise_conv2d_blocked`` (the last
  leg's GAP summed in the same launch) beside the library's call for the
  same function (``F.conv2d``), and each call's device time as a
  CUDA-graph replay;
* **the depthwise forward with parts of its work taken out**: the library
  of ``csrc/conv2d_depthwise.cu`` is built again from copies of the source
  in which one part is skipped (``PARTS``), and each variant is timed as a
  CUDA-graph replay through the public wrapper at every depthwise leg;
  likewise the pointwise dgrad, the dense dgrad tile at 1x1
  (``DGRAD_PARTS``, ``csrc/direct_conv2d_bwd.cu``; batch 32, the relu
  prologue), and the pointwise forward's bf16 build
  (``pointwise_tile_kernel_bf16``, ``PW_BF16_PARTS``: without its wgmmas,
  without its TMA copies, without its epilogue, without the epilogue's
  stores, the epilogue only a test of the accumulators, no bias read;
  batch 8, bf16 operands).
  Only ``whole`` computes the function; the others are timing probes.

The variants are built from this checkout's sources; another tree is
measured by running its own copy of this script.  Prints the card's name
and power limit first.  Needs a GPU and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.separable_parts_ab
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.configs.cnn import MOBILENET_V1_BLOCKS
from repro_torch.kernels import _build
from repro_torch.launch.dgrad_tiles_ab import graph_ms

HOST_CALLS, BATCH, ENTRY = 200, 8, 224
# {variant: ((text of the source, its replacement), ...)} of the depthwise
# forward (`depthwise_fwd_kernel`): the cp.async staging of the next item
# under this one's taps (taps_only keeps the ring's waits and barriers)
PARTS = {
    "whole": (),
    "stage_only": (("    if (computes) {\n      for (int u = pg;",
                    "    if (0) {\n      for (int u = pg;"),),
    "taps_only": (("stage_item(smem", "if (0) stage_item(smem"),),
}


# the dense dgrad kernel (direct_conv2d_bwd.cu `dgrad_kernel`) that the
# pointwise dgrad launches at 1x1
DGRAD_PARTS = {
    "whole": (),
    "no_wgmma": (("    dt::mma_stage<N>(acc, m.win + slot * m.cst,",
                  "    if (0) dt::mma_stage<N>(acc, m.win + slot * m.cst,"),),
    "no_split_dz": (("      dt::split_weights(m.big + slot * m.wst,",
                     "      if (0) dt::split_weights(m.big + slot * m.wst,"),
                    ("        dt::prologue_rows(m.win + slot * m.cst,",
                     "        if (0) dt::prologue_rows(m.win + slot * m.cst,")),
}


# the pointwise forward's bf16 build (conv2d_pointwise.cu
# `pointwise_tile_kernel_bf16`): without its wgmmas, without its TMA copies
# (the producer arrives on each slot's mbarrier with nothing landed),
# without its epilogue (the items' stores and GAP), with the epilogue's
# arithmetic but not its output stores, with the epilogue replaced by a
# test of two accumulators (the wgmmas waited for, nothing stored), and
# with no bias read
PW_BF16_PARTS = {
    "whole": (),
    "no_wgmma": (
        ("      if (live) {\n        pb::mma_any<N>(",
         "      if (0) {\n        pb::mma_any<N>("),),
    "no_copy": (
        ("            dt::mbar_expect_tx(&m.full[slot],\n"
         "                               boxes * pb::halves(g) * g.brows * cb\n"
         "                                   + 2 * g.chunk * N);",
         "            pb::db::mbar_arrive(&m.full[slot]);"),
        ("          pb::issue_x(&tmx, a, &m.full[slot], g, it, kb, c0, tid);\n"
         "          if (tid == 0) {",
         "          if (0) {")),
    "no_epilogue": (
        ("    pb::store_any<N, kGap>(acc, g, it, c, m, brow,",
         "    if (0) pb::store_any<N, kGap>(acc, g, it, c, m, brow,"),),
    "no_store": (
        ("          if (row_ok[h] && o0 + col8 < g.ow) {", "          if (0) {"),
        ("        if (!row_ok[h]) continue;", "        if (true) continue;")),
    "acc_live": (
        ("    pb::store_any<N, kGap>(acc, g, it, c, m, brow, residual, out, "
         "partials,\n                           pooled, counters);",
         "    if (acc[0] == 1234.5f && acc[N / 2 - 1] == 1.5f) {\n"
         "      out[threadIdx.x] = __float2bfloat16_rn(acc[1]);\n"
         "    }"),),
    "no_bias": (
        ("    float* brow = bias != nullptr ? m.bias + (walked & 1) * N : "
         "nullptr;",
         "    float* brow = nullptr;"),),
}


def dw_legs(entry: int = ENTRY):
    """MobileNet v1's depthwise legs as ``(c, stride, h)``, ``h`` the input
    extent, in the network's order."""
    h, out = -(-entry // 2), []
    for ci, _, s in MOBILENET_V1_BLOCKS:
        out.append((ci, s, h))
        h = -(-h // s)
    return out


def pw_legs(entry: int = ENTRY):
    """MobileNet v1's pointwise legs as ``(ci, co, h)``."""
    return [(ci, co, -(-h // s)) for (ci, s, h), (_, co, _) in
            zip(dw_legs(entry), MOBILENET_V1_BLOCKS)]


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs a call of ``fn`` over ``calls`` calls, no synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def build_variant(source: str, name: str, edits) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu`` built from a copy of the
    sources with ``edits`` made to it (its text kept in the build
    directory)."""
    src = _build.BUILD_DIR / f"parts_{source}_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = src / f"{source}.cu"
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    lib_path = src / f"lib{source}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(lib_path))


def time_parts(label: str, source: str, variants, legs) -> None:
    """Each variant of ``source``'s library at each ``(tag, weight, fn)``
    of ``legs``, as CUDA-graph replays of ``fn`` with the variant loaded in
    its place; prints a line a leg and the weighted sums."""
    libs = {name: build_variant(source, name, edits)
            for name, edits in variants.items()}
    loaded = _build._loaded.get(source)
    totals = dict.fromkeys(libs, 0.0)
    try:
        for tag, weight, fn in legs:
            times = {}
            for name, lib in libs.items():
                _build._loaded[source] = lib
                times[name] = min(graph_ms(fn, 10) for _ in range(2))
            for name, t in times.items():
                totals[name] += weight * t
            print(f"[parts] {label} {tag}: " + " ".join(
                f"{k}_ms {v:.4f}" for k, v in times.items()), flush=True)
    finally:
        if loaded is None:
            _build._loaded.pop(source, None)
        else:
            _build._loaded[source] = loaded
    print(f"[parts] {label} summed over the 13 legs: " + " ".join(
        f"{k}_ms {v:.4f}" for k, v in totals.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("separable_parts_ab: no CUDA device")
        return 1
    from repro_torch.kernels import conv2d_depthwise as dwk
    from repro_torch.kernels import conv2d_pointwise as pwk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cudnn.allow_tf32 = False
    ops = {}
    sums = {}

    def row(kind, tag, kernel, library):
        us = (host_us(kernel), host_us(library))
        ms = (graph_ms(kernel, 10), graph_ms(library, 10))
        print(f"[host] {kind} {tag}: wrapper {us[0]:.1f} us a call, "
              f"library {us[1]:.1f}; device (graph) ms {ms[0]:.4f}, library "
              f"{ms[1]:.4f}", flush=True)
        acc = sums.setdefault(kind, [0.0] * 4)
        for i, v in enumerate((*us, *ms)):
            acc[i] += v

    with torch.no_grad():
        for c, s, h in dw_legs():
            cb = min(c, 128)
            x = torch.randn((BATCH, c // cb, h, h, cb), device=dev,
                            generator=gen)
            w = torch.randn((c // cb, 1, 3, 3, 1, cb), device=dev,
                            generator=gen) / 3
            b = 0.1 * torch.randn((c // cb, cb), device=dev, generator=gen)
            pad = (0, 1, 0, 1) if s == 2 else (1, 1, 1, 1)
            xl = F.pad(x.permute(0, 1, 4, 2, 3).reshape(BATCH, c, h, h),
                       pad).contiguous()
            wl = w.permute(0, 5, 1, 2, 3, 4).reshape(c, 1, 3, 3).contiguous()
            bl = b.reshape(-1)
            ops[(c, s, h)] = (x, w, b)
            row("dw fwd", f"{c} {h}x{h} s{s}",
                lambda: dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME",
                                                     "relu"),
                lambda: F.relu(F.conv2d(xl, wl, bl, stride=s, groups=c)))
        for ci, co, h in pw_legs():
            gap = (ci, co) == (1024, 1024)
            cib, cob = min(ci, 128), min(co, 128)
            x = torch.randn((BATCH, ci // cib, h, h, cib), device=dev,
                            generator=gen)
            w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob),
                            device=dev, generator=gen) / ci ** 0.5
            b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
            xl = x.permute(0, 1, 4, 2, 3).reshape(BATCH, ci, h, h) \
                .contiguous()
            wl = w.permute(0, 5, 1, 4, 2, 3).reshape(co, ci, 1, 1) \
                .contiguous()
            bl = b.reshape(-1)
            row("pw fwd", f"{ci}->{co} {h}x{h}{' +gap' if gap else ''}",
                lambda: pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID",
                                                     "relu", gap=gap),
                lambda: F.relu(F.conv2d(xl, wl, bl)))
    for kind, (us, lib_us, ms, lib_ms) in sums.items():
        print(f"[host] {kind} summed over the legs: wrapper {us:.1f} us, "
              f"library {lib_us:.1f} us; device (graph) ms {ms:.4f}, "
              f"library {lib_ms:.4f}", flush=True)

    def dw_fwd(x, w, b, s):
        def run():
            with torch.no_grad():
                return dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME",
                                                    "relu")
        return run

    time_parts("dw fwd", "conv2d_depthwise", PARTS,
               [(f"{c} {h}x{h} s{s}", dw_legs().count((c, s, h)),
                 dw_fwd(*ops[(c, s, h)], s)) for c, s, h in ops])

    from repro_torch.core.direct_conv import direct_conv_blocked
    legs = []
    for ci, co, h in sorted(set(pw_legs()), key=pw_legs().index):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((32, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=dev,
                        generator=gen) / ci ** 0.5
        z = direct_conv_blocked(x, w, 1, "VALID").contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        legs.append((f"{ci}->{co} {h}x{h}", pw_legs().count((ci, co, h)),
                     lambda g=g, w=w, z=z: pwk.pointwise_dgrad(
                         g, w, z, "relu")))
    time_parts("pw dgrad (dense tile at 1x1)", "direct_conv2d_bwd",
               DGRAD_PARTS, legs)

    legs = []
    for ci, co, h in sorted(set(pw_legs()), key=pw_legs().index):
        cib, cob = min(ci, 128), min(co, 128)
        x = torch.randn((BATCH, ci // cib, h, h, cib), device=dev,
                        generator=gen).bfloat16()
        w = (torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=dev,
                         generator=gen) / ci ** 0.5).bfloat16()
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)

        def fwd(x=x, w=w, b=b, gap=(ci, co) == (1024, 1024)):
            with torch.no_grad():
                return pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID",
                                                    "relu", gap=gap,
                                                    precision="bf16")
        legs.append((f"{ci}->{co} {h}x{h}", pw_legs().count((ci, co, h)),
                     fwd))
    time_parts("pw fwd bf16 (pointwise_tile_kernel_bf16)",
               "conv2d_pointwise", PW_BF16_PARTS, legs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
