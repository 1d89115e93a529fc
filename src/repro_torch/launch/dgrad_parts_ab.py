"""Time the bf16 window dgrad kernel with parts of its work taken out.

Which side bounds the bf16 build of ``csrc/dgrad_tile.cuh``: the
consumers' wgmmas, or the producer's copies?  This script builds the window
dgrad's library (``csrc/direct_conv2d_bwd.cu``) again from copies of the
sources in which one part of the work is skipped, each into the build
directory, the three builds at once:

* ``whole``: the kernel as it is;
* ``no_wgmma``: the consumers skip their wgmmas (the producer's time);
* ``no_copy``: the producer issues no copy and arrives on each stage's
  mbarriers with nothing staged (the consumers' time, the barriers
  between them kept).

Only ``whole`` computes the function; the others are timing probes.  At
VGG-16's 12 dgrad layers (batch 8) and two of MobileNet v1's pointwise legs
(batch 32, the 1x1 dgrad), each on dz as the bf16 training path calls it
(the dz pass's dz, prologue off, the tiles of the dgrad with its relu
prologue), it prints the card's name and power limit and each variant's
CUDA-graph ms, and their sums.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.dgrad_parts_ab --dtype bf16
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core.blocking import choose_dgrad_blocking
from repro_torch.core.convspec import ConvSpec
from repro_torch.launch.dgrad_tiles_ab import dgrad_layers, graph_ms

# (file in csrc, source text, its replacement) per variant, for the bf16
# tile (dgrad_tile.cuh, namespace bf16, `run`)
VARIANTS = {
    "whole": (),
    "no_wgmma": (("dgrad_tile.cuh",
                  "        mma_filter_row<N>(acc, smem_u32(win(ws)) + row0,",
                  "        if (0) mma_filter_row<N>(acc, smem_u32(win(ws)) "
                  "+ row0,"),),
    "no_copy": (("dgrad_tile.cuh",
                 "              mbar_expect_tx(&full[k], bf16::row_bytes("
                 "geo, lo_of(k),\n"
                 "                                                       "
                 "hi_of(k)));",
                 "              mbar_expect_tx(&full[k], 0);"),
                ("dgrad_tile.cuh",
                 "            issue_rows(tmg, tmz, win(ws), zwin(ws), "
                 "&full[k], geo, it.n,",
                 "            if (0) issue_rows(tmg, tmz, win(ws), zwin(ws), "
                 "&full[k], geo, it.n,"),
                ("dgrad_tile.cuh",
                 "              mbar_expect_tx(&m.rfull[rs], t.c.taps * N * "
                 "cell_bytes(geo));",
                 "              mbar_expect_tx(&m.rfull[rs], 0);"),
                ("dgrad_tile.cuh",
                 "            issue_row_weights<N>(tmw, wrow(rs), "
                 "&m.rfull[rs], geo, t, r,",
                 "            if (0) issue_row_weights<N>(tmw, wrow(rs), "
                 "&m.rfull[rs], geo, t, r,")),
}
# MobileNet v1's pointwise legs timed here, (ci, co, map side), batch 32
POINTWISE_LEGS = ((128, 128, 56), (512, 512, 14))
N_VGG, N_POINTWISE = 8, 32


def layers():
    """``(label, n, ci, co, stride, h, hf)`` of every layer timed: VGG-16's
    dgrads (3x3) and the pointwise legs (1x1)."""
    out = [(name, N_VGG, ci, co, s, h, 3)
           for name, ci, co, s, h in dgrad_layers()]
    out += [(f"pw {ci}->{co} {h}x{h}", N_POINTWISE, ci, co, 1, h, 1)
            for ci, co, h in POINTWISE_LEGS]
    return out


def build_variant(name: str, edits):
    """The window dgrad's library built from sources with ``edits`` made,
    -> its path."""
    from repro_torch.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
    src = BUILD_DIR / f"dgrad_parts_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for file, old, new in edits:
        path = src / file
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {file} no longer holds {old!r}")
        path.write_text(text.replace(old, new))
    lib_path = src / "libdgrad.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path),
                           str(src / "direct_conv2d_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16",), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dgrad_parts_ab: no CUDA device")
        return 1
    import repro_torch
    from repro_torch.kernels import direct_conv2d
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"[parts] tree {repro_torch.__file__}", flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(
            lambda kv: build_variant(f"{args.dtype}_{kv[0]}", kv[1]),
            VARIANTS.items())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        direct_conv2d._declare_bwd(lib, ctypes.c_void_p, ctypes.c_int)
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    sums = {name: 0.0 for name in libs}
    for label, n, ci, co, s, h, f in layers():
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, f, f, s,
                             "SAME" if f > 1 else "VALID")
        g = torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                        generator=gen).to(bf)
        z = torch.randn(g.shape, device=dev, generator=gen).to(bf)
        w = (torch.randn((co // cob, ci // cib, f, f, cib, cob), device=dev,
                         generator=gen) / (f * f * co) ** 0.5).to(bf)
        dz, _ = direct_conv2d.cotangent_pass(g, z, "relu", False)
        blk = choose_dgrad_blocking(n, h, h, f, f, s, ci // cib, cib, cob,
                                    prologue=True, op_bytes=2)
        times = {}
        for name, lib in libs.items():
            def run(lib=lib):
                err, dx, _ = direct_conv2d.dgrad_launch(
                    lib.direct_conv2d_dgrad_bf16, blk.th, blk, dz, w, spec,
                    None, None, bf)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return dx
            times[name] = min(graph_ms(run, 10), graph_ms(run, 10))
            sums[name] += times[name]
        print(f"[parts] {args.dtype} {label} {ci}->{co} in {h}x{h} s{s} "
              f"{f}x{f}, tile {blk.th}x{blk.tw} wgs {blk.wgs} chunk "
              f"{blk.chunk}: "
              + " ".join(f"{k}_ms {v:.4f}" for k, v in times.items()),
              flush=True)
        del g, z, w, dz
    print("[parts] sums: " + " ".join(f"{k}_ms {v:.4f}"
                                      for k, v in sums.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
