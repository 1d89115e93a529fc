"""Time the dense forward tile with parts of its work taken out.

What bounds ``csrc/fwd_tile.cuh``: the consumers' wgmmas, the A operand's
split as it is loaded, or the producer's copies and weight split?  This
script builds the window forward's library (``csrc/direct_conv2d_fwd.cu``)
again from copies of the sources in which one part of the work is skipped,
each into the build directory:

* ``whole``: the kernel as it is;
* ``no_wgmma``: the consumers skip their wgmmas (their A loads stay):
  the producer's time, the A loads and the barriers;
* ``no_a_split``: the consumers load A but do not split it (its raw bits
  go to both halves);
* ``no_split``: the producer skips the weight split (its copies still
  land);
* ``no_copy``: the producer issues no copies and waits for none (it still
  splits what the buffers hold): the consumers' time and the split.

Only ``whole`` computes the function; the others are timing probes.  At
VGG-16's 13 layers (batch 8, relu, the chooser's tiles) it prints the
card's name and power limit and each variant's CUDA-graph ms, then the
sums.  Needs an H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.fwd_parts_ab
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core.convspec import ConvSpec
from repro_torch.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from repro_torch.launch.dgrad_tiles_ab import graph_ms
from repro_torch.launch.fwd_tiles_ab import fwd_layers

# per variant, (header, source text, its replacement) in csrc/
VARIANTS = {
    "whole": (),
    "no_wgmma": (("fwd_tile.cuh", "      dt::issue<NW>(acc, a_big, a_small,",
                  "      if (0) dt::issue<NW>(acc, a_big, a_small,"),),
    "no_a_split": (("dgrad_tile.cuh",
                    "    big[i] = tf32_bits(v[i]);\n"
                    "    small[i] = tf32_bits(v[i] - __uint_as_float(big[i]));",
                    "    big[i] = __float_as_uint(v[i]);\n"
                    "    small[i] = big[i];"),),
    "no_split": (("fwd_tile.cuh",
                  "      if (k == 0) split_weights<N>(m, slot, g, tid);",
                  "      if (0) split_weights<N>(m, slot, g, tid);"),),
    "no_copy": (("fwd_tile.cuh",
                 "      if (k == 0) issue_weights<N>(m, tmw, w, g, o_b, i_b,"
                 " c0, o0, tid);", ""),
                ("fwd_tile.cuh",
                 "      if (k == 0 && tma_weights(g)) dt::mbar_wait(m.wbar, "
                 "s & 1);", ""),
                ("fwd_tile.cuh",
                 "      issue_rows(win, x, g, n, i_b, c0, h0, w0, lo, hi, "
                 "tid);", "")),
}


def build_variant(name: str, edits) -> ctypes.CDLL:
    """The window forward's library built from sources with ``edits``
    made, loaded with its C signatures declared."""
    from repro_torch.kernels import direct_conv2d
    src = BUILD_DIR / f"fwd_parts_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for header, old, new in edits:
        path = src / header
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {header} no longer holds {old!r}")
        path.write_text(text.replace(old, new))
    lib_path = src / "libfwd.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path),
                           str(src / "direct_conv2d_fwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    direct_conv2d._declare_fwd(lib, ctypes.c_void_p, ctypes.c_int)
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_parts_ab: no CUDA device")
        return 1
    from repro_torch.kernels import direct_conv2d
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv),
                                           VARIANTS.items())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8
    sums = dict.fromkeys(VARIANTS, 0.0)
    for name, ci, co, s, h in fwd_layers():
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=gen)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                        generator=gen) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co // cob, cob), device=dev, generator=gen)
        plan = direct_conv2d.fwd_launch(spec, cib, cob, 1, False, False)
        blk = plan.blk
        times = {}
        for variant, lib in libs.items():
            def run(lib=lib):
                err, out, _, _ = direct_conv2d.fwd_run(
                    lib.direct_conv2d_fwd, plan, x, w, b, None, spec)
                if err:
                    raise RuntimeError(f"{variant}: CUDA error {err}")
                return out
            times[variant] = min(graph_ms(run, 10), graph_ms(run, 10))
            sums[variant] += times[variant]
        print(f"[parts] {name} {ci}->{co} in {h}x{h} s{s}, tile {blk.th}x"
              f"{blk.tw} wgs {blk.wgs} nsplit {blk.nsplit} chunk "
              f"{blk.chunk}: "
              + " ".join(f"{k}_ms {v:.4f}" for k, v in times.items()),
              flush=True)
        del x, w, b
    print("[parts] all 13 layers: "
          + " ".join(f"{k}_ms {v:.4f}" for k, v in sums.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
