"""Time the window wgrad kernel with parts of its work taken out.

Which side bounds ``csrc/wgrad_tile.cuh``: the consumers' wgmmas, or the
producer's copies and dz pass?  This script builds the window wgrad's
library (``csrc/direct_conv2d_bwd.cu``) again from copies of the sources
in which one part of the work is skipped, each into the build directory:

* ``whole``: the kernel as it is;
* ``no_wgmma``: the consumers skip their wgmmas (the producer's time);
* ``no_dz``: the producer skips the dz pass (its copies still land);
* ``no_copy``: the producer skips its copies and the dz pass (the
  consumers' time, the barriers between them kept).

Only ``whole`` computes the function; the others are timing probes.  At a
few VGG-16 layers (batch 8, the relu prologue and ``db``, the chooser's
tiles) it prints the card's name and power limit and each variant's
CUDA-graph ms.  ``--dtype bf16`` takes the same parts out of the tile's
bf16 build (``wgrad_kernel_bf16``, ``BF16_VARIANTS``) and times it on bf16
operands at the bf16 chooser's tiles.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.wgrad_parts_ab [--dtype bf16]
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from repro_torch.core.blocking import choose_wgrad_blocking
from repro_torch.core.convspec import ConvSpec
from repro_torch.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from repro_torch.launch.dgrad_tiles_ab import graph_ms

# (source text, its replacement) in csrc/wgrad_tile.cuh, per variant
VARIANTS = {
    "whole": (),
    "no_wgmma": (("    mma_stage<N, MPW>(acc, m.x[slot]",
                  "    if (0) mma_stage<N, MPW>(acc, m.x[slot]"),),
    "no_dz": (("      db = transform<N>(",
               "      if (0) db = transform<N>("),),
    "no_copy": (("      issue_x(tmx, x, geo,",
                 "      if (0) issue_x(tmx, x, geo,"),
                ("    for (int s = 0; s < min(stages, kSlots); ++s) "
                 "issue_g(s);", ""),
                ("      if (s + kSlots < stages) issue_g(s + kSlots);", ""),
                ("      dt::mbar_wait(&m.bar_d[slot], parity);", ""),
                ("      dt::mbar_wait(&m.bar_x[slot], parity);", ""),
                ("      db = transform<N>(",
                 "      if (0) db = transform<N>(")),
}
# the same parts of the bf16 build (wgrad_tile.cuh, namespace bf16)
BF16_VARIANTS = {
    "whole": (),
    "no_wgmma": (("    mma_stage<N, N, MPW>(total, m.x[slot]",
                  "    if (0) mma_stage<N, N, MPW>(total, m.x[slot]"),),
    "no_dz": (("      transform<N>(m.g[slot], m.z[slot], m.b[slot]",
               "      if (0) transform<N>(m.g[slot], m.z[slot], m.b[slot]"),),
    "no_copy": (("      bf16::issue_x(tmx, x, geo,",
                 "      if (0) bf16::issue_x(tmx, x, geo,"),
                ("    for (int s = 0; s < min(stages, kSlots); ++s) "
                 "issue_dz(s);", ""),
                ("      if (s + kSlots < stages) issue_dz(s + kSlots);", ""),
                ("      dt::mbar_wait(m.bar_d + slot, parity);", ""),
                ("      dt::mbar_wait(m.bar_x + slot, parity);", ""),
                ("      transform<N>(m.g[slot], m.z[slot], m.b[slot]",
                 "      if (0) transform<N>(m.g[slot], m.z[slot], m.b[slot]")),
}
# (ci, co, stride, input extent)
LAYERS = ((3, 64, 1, 224), (64, 64, 1, 224), (64, 128, 2, 224),
          (128, 128, 1, 112), (256, 256, 1, 56), (512, 512, 1, 28),
          (512, 512, 1, 14))


def build_variant(name: str, edits) -> ctypes.CDLL:
    """The window wgrad's library built from sources with ``edits`` made to
    ``wgrad_tile.cuh``, loaded with its C signatures declared."""
    from repro_torch.kernels import direct_conv2d
    src = BUILD_DIR / f"wgrad_parts_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    header = src / "wgrad_tile.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the header no longer holds {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    lib_path = src / "libwgrad.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path),
                           str(src / "direct_conv2d_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    direct_conv2d._declare_bwd(lib, ctypes.c_void_p, ctypes.c_int)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    bf16 = args.dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    if not torch.cuda.is_available():
        print("wgrad_parts_ab: no CUDA device")
        return 1
    from repro_torch.core.direct_conv import direct_conv_blocked
    from repro_torch.kernels import direct_conv2d
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {name: build_variant(f"{args.dtype}_{name}", edits)
            for name, edits in (BF16_VARIANTS if bf16
                                else VARIANTS).items()}
    entry = "direct_conv2d_wgrad_bf16" if bf16 else "direct_conv2d_wgrad"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    for ci, co, s, h in LAYERS:
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        z = direct_conv_blocked(x, w, s, "SAME").contiguous()
        g = torch.randn(z.shape, device=dev, generator=gen)
        x, z, g = x.to(dtype), z.to(dtype), g.to(dtype)
        blk = choose_wgrad_blocking(n, spec.ho, spec.wo, 3, 3, s, ci // cib,
                                    cib, co // cob, cob, prologue=True,
                                    op_bytes=dtype.itemsize)
        plan = direct_conv2d.wgrad_launch_plan(blk, x.shape, g.shape, 3, 3,
                                               spec, 1, True)
        times = {}
        for name, lib in libs.items():
            def run(lib=lib):
                err, ws, _ = direct_conv2d.wgrad_launch(
                    getattr(lib, entry), plan, x, g, z, dtype)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return ws
            times[name] = min(graph_ms(run, 10), graph_ms(run, 10))
        print(f"[parts] {args.dtype} {ci}->{co} in {h}x{h} s{s}, tiles "
              f"{blk.th}x{blk.tw} "
              f"wgs {blk.wgs} mpw {blk.mpw} groups {blk.groups} splits "
              f"{blk.splits}: "
              + " ".join(f"{k}_ms {v:.4f}" for k, v in times.items()),
              flush=True)
        del x, w, z, g
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
