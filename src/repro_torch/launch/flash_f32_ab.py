"""Time the f32 flash-attention kernels at h2o-danube-1.8b's prefill shape.

At batch 2 x 2048 tokens, 32 query heads over 8 KV heads, head dim 80,
causal (``chip_smoke.py``'s phase 21 shape), and at head dim 128 (phase
18's case: batch 1 x 1024, 32 over 8 heads), this script times on the
card, eager and as CUDA-graph replays of ``ITERS`` launches (device ms, no
host launch cost), each candidate twice in opposite orders with the faster
time kept:

* the tensor-core kernel ``flash_fwd_tf32`` (3xTF32 wgmma) as the route
  launches it (the stage ``csrc/flash_attention.cu`` derives from the head
  dim: 64 keys up to a padded 80, else 32), and at head dim 80 a second
  library built from the same source with ``STAGE_FLAGS`` (32-key stages),
  loaded in its place while it is timed;
* the CUDA-core kernel ``flash_fwd_kernel``, which the route keeps for
  head dims past 128;
* ``F.scaled_dot_product_attention`` in f32 with TF32 off, the yardstick:
  with GQA and on K/V repeated beforehand, each as PyTorch picks its
  backend and under each backend that takes it.

Each kernel's output is first held to the plain version (``attend_plain``)
within ``1e-5 * max|out| + 1e-6``, as ``chip_smoke.py`` holds it.  It
prints the card's name and power limit, each time, the 3xTF32 and f32 FMA
bounds, and the route's time over the fastest stage's (to be within 1.05)
at each shape.  ``--out`` writes the numbers as JSON.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.flash_f32_ab
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch
import torch.nn.attention
import torch.nn.functional as F

ITERS = 10
# the other stage at head dim 80, as nvcc flags
STAGE_FLAGS = ("-DFLASH_TF32_STAGE80=32",)
# NVIDIA H100 SXM data sheet: TF32 tensor-core and f32 (non-tensor) peaks
PEAK_TF32, PEAK_F32 = 495e12, 67e12
CHOSEN_WITHIN = 1.05
# SDPA's backends, each timed on its own where it takes the call
SDPA_BACKENDS = tuple(getattr(torch.nn.attention.SDPBackend, n) for n in (
    "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"))
# (batch, sequence, KV heads, groups, head dim) of the head-dim-128 case
DH128_SHAPE = (1, 1024, 8, 4, 128)


def graph_ms(fn, iters: int = ITERS) -> float:
    """Device ms of one call: ``iters`` calls captured in a CUDA graph and
    replayed between two events."""
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
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = ITERS) -> float:
    """Wall ms of one call, ``iters`` calls between two events after a
    warm-up."""
    for _ in range(2):
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


def candidates(dh: int = 80):
    """``(label, kernel, flags)`` of every launch timed at head dim ``dh``,
    the route's first: ``kernel`` the wrapper's code, ``flags`` the nvcc
    flags of the library it runs in (``()``: the package's own)."""
    out = [("tf32 (the route's stage)", "tf32", ())]
    if dh == 80:
        out.append(("tf32 32-key stages", "tf32", STAGE_FLAGS))
    return out + [("fma (flash_fwd_kernel)", "fma", ())]


def build_stage(flags) -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` built with ``flags`` added, into its own
    library under the build directory."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "flash_f32_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libflash_attention{''.join(flags).replace('=', '_')}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                           str(lib), str(_build.CSRC / "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with {flags}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def sdpa_runs(q, k, v, *, scale: float):
    """``(label, fn, None)`` of SDPA in f32 on ``[B, H, S, Dh]`` views,
    causal, with GQA (``enable_gqa``) and on K/V repeated to H heads
    beforehand: each as PyTorch picks its backend, then under each backend
    of ``SDPA_BACKENDS`` that takes it (one that refuses is printed)."""
    from torch.nn.attention import sdpa_kernel
    b, s, hkv, g, dh = q.shape
    qh = q.reshape(b, s, hkv * g, dh).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    kr, vr = (t.repeat_interleave(g, dim=1) for t in (kh, vh))

    def call(kk, vv, gqa, backend):
        def run():
            kw = {"enable_gqa": True} if gqa else {}
            if backend is None:
                return F.scaled_dot_product_attention(
                    qh, kk, vv, is_causal=True, scale=scale, **kw)
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    qh, kk, vv, is_causal=True, scale=scale, **kw)
        return run

    runs = []
    for form, kk, vv, gqa in (("K/V repeated", kr, vr, False),
                              ("GQA", kh, vh, True)):
        for backend in (None, *SDPA_BACKENDS):
            name = "default" if backend is None else backend.name
            fn = call(kk, vv, gqa, backend)
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"[flash-f32] SDPA f32 {form} {name}: refused "
                      f"({str(exc).splitlines()[0][:80]})")
                continue
            runs.append((f"SDPA f32 (TF32 off) {form} {name}", fn, None))
    return runs


def time_shape(fak, dev, b: int, s: int, hkv: int, g: int, dh: int) -> dict:
    """Check and time ``candidates(dh)`` and SDPA at one causal shape ->
    its results; prints a line each."""
    hq = hkv * g
    gen = torch.Generator(device=dev).manual_seed(dh)
    q = torch.randn((b, s, hkv, g, dh), device=dev, generator=gen)
    k = torch.randn((b, s, hkv, dh), device=dev, generator=gen)
    v = torch.randn((b, s, hkv, dh), device=dev, generator=gen)
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
        b, s).contiguous()
    kw = dict(q_positions=pos, kv_positions=pos, causal=True, window=None,
              cap=None, scale=dh ** -0.5, kv_valid=None)
    want = fak.attend_plain(q, k, v, **kw).double()
    bound = 1e-5 * want.abs().max().item() + 1e-6

    from repro_torch.kernels import _build
    own = _build.library("flash_attention")

    def launcher(kernel, flags):
        out = torch.empty_like(q)
        lib = build_stage(flags) if flags else own

        def run():
            # the library of this candidate in the package's place
            _build._loaded["flash_attention"] = lib
            try:
                fak._launch(q, k, v, out, q.stride()[:4], k.stride()[:3],
                            v.stride()[:3], out.stride()[:4], kv_heads=hkv,
                            groups=g, sq=s, skv=s, chunk=fak.PLAIN_CHUNK,
                            kernel=kernel, **kw)
            finally:
                _build._loaded["flash_attention"] = own
            return out
        return run

    runs = []
    for label, kernel, flags in candidates(dh):
        fn = launcher(kernel, flags)
        err = (fn().double() - want).abs().max().item()
        torch.cuda.synchronize()
        if not err <= bound:
            raise RuntimeError(f"{label}: max error {err} past {bound}")
        runs.append((label, fn, err))
    runs += sdpa_runs(q, k, v, scale=dh ** -0.5)
    graph = [graph_ms(fn) for _, fn, _ in runs]
    for i in reversed(range(len(runs))):
        graph[i] = min(graph[i], graph_ms(runs[i][1]))
    eager = [min(eager_ms(fn), eager_ms(fn)) for _, fn, _ in runs]
    # the function's 4 Dh FLOPs an unmasked pair, as three TF32 products
    # on the tensor cores, or once on CUDA cores
    pairs = b * hq * s * (s + 1) // 2
    flops = 4 * dh * pairs
    tf32_bound = 3 * flops / PEAK_TF32 * 1e3
    fma_bound = flops / PEAK_F32 * 1e3
    shape = f"B{b} S{s} H{hq} KV{hkv} Dh{dh} causal"
    results = {"shape": shape, "bound_ms_3xtf32": tf32_bound,
               "bound_ms_f32_fma": fma_bound, "runs": {}}
    for (label, _, err), t_g, t_e in zip(runs, graph, eager):
        print(f"[flash-f32] {shape} {label}: ms {t_e:.4f} graph_ms "
              f"{t_g:.4f} share of the 3xTF32 bound {tf32_bound / t_g:.3f}"
              + ("" if err is None else f" max_abs_err {err:.3e}"))
        results["runs"][label] = {"ms": t_e, "graph_ms": t_g,
                                  "max_abs_err": err}
    stages = [t for (label, _, _), t in zip(runs, graph)
              if label.startswith("tf32")]
    ratio = stages[0] / min(stages)
    results["chosen_over_fastest"] = ratio
    print(f"[flash-f32] {shape} bounds: 3xTF32 {tf32_bound:.4f} ms, f32 "
          f"FMA {fma_bound:.4f} ms; the route's stage over the fastest: "
          f"{ratio:.3f} ({'ok' if ratio <= CHOSEN_WITHIN else 'OVER'} "
          f"{CHOSEN_WITHIN})")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_f32_ab: no CUDA device")
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fak
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    cfg = get_config("h2o-danube-1.8b")
    dev = torch.device("cuda")
    results = {"card": card, "shapes": [
        time_shape(fak, dev, 2, 2048, cfg.n_kv_heads,
                   cfg.n_heads // cfg.n_kv_heads, cfg.head_dim),
        # chip_smoke.py's phase-18 "Dh 128" case
        time_shape(fak, dev, *DH128_SHAPE)]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
