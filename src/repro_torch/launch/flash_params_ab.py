"""Time the bf16 flash-attention kernel against copies of itself whose
parameters are padded past 512 bytes.

The bf16 kernel (``csrc/flash_attention.cu``, ``flash_fwd_wgmma``) takes
three tensor maps and ``HParams`` by value, and ``static_assert``s that they
fit in 512 bytes.  This script builds the source as it is and with ``pad``
unused bytes appended to ``HParams`` (the assert relaxed), all in one
process, and times each at h2o-danube-1.8b's prefill shape (B 2, S 2048,
32 q-heads over 8 KV heads, Dh 80, causal) with CUDA events, alternating
the order over rounds.  It prints the card's name and power limit, each
variant's parameter bytes and ptxas report, and its ms a call.  Needs an
H100 and nvcc::

    PYTHONPATH=src python -m repro_torch.launch.flash_params_ab
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fak

_HPARAMS_END = "  int flags;              // kCausal | kWindow | kCap\n" \
               "  float cap, scale;\n};"
_ASSERT = "3 * sizeof(CUtensorMap) + sizeof(HParams) <= 512"
# the kernel's parameters as the source has them: three 128-byte maps and
# HParams (4 pointers, 7 int64 strides, 8 ints, 2 floats)
_BYTES = 3 * 128 + 4 * 8 + 7 * 8 + 8 * 4 + 2 * 4


def variant_source(pad: int) -> str:
    """The kernel's source with ``pad`` unused bytes (a multiple of 8)
    appended to ``HParams``."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if _HPARAMS_END not in src or _ASSERT not in src:
        raise RuntimeError("flash_attention.cu's HParams changed; update "
                           "this script")
    if pad:
        src = src.replace(_HPARAMS_END, _HPARAMS_END[:-2]
                          + f"  long long pad_[{pad // 8}];\n}};")
        src = src.replace(_ASSERT, "true")
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pads", type=int, nargs="+", default=[0, 8, 16],
                    help="bytes appended to HParams, multiples of 8")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_params_ab: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out = _build.BUILD_DIR / "flash_params_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for pad in args.pads:
        cu = out / f"flash_pad{pad}.cu"
        cu.write_text(variant_source(pad))
        procs[pad] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(
                ".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for pad, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for pad {pad}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "flash_fwd_wgmmaILi80E" in line:
                report = " ".join(x.split(":", 1)[-1].strip()
                                  for x in lines[i + 2:i + 4])
                print(f"pad {pad}: {_BYTES + pad} bytes of parameters; "
                      f"ptxas, Dh 80: {report}")
        lib = ctypes.CDLL(str(out / f"flash_pad{pad}.so"))
        fak._declare(lib, ctypes.c_void_p, ctypes.c_int)
        lib.cuda_error_name.argtypes = [ctypes.c_int]
        lib.cuda_error_name.restype = ctypes.c_char_p
        libs[pad] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, kv, g, dh = 2, 2048, 8, 4, 80

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen).to(
            torch.bfloat16)
    q, k, v = randn((b, s, kv, g, dh)), randn((b, s, kv, dh)), \
        randn((b, s, kv, dh))
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
        b, s).contiguous()
    kw = dict(q_positions=pos, kv_positions=pos, causal=True,
              scale=dh ** -0.5)
    lib_of = fak._lib
    try:
        want = None
        for pad, lib in libs.items():
            fak._lib = lambda lib=lib: lib
            got = fak.attend(q, k, v, **kw)
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise RuntimeError(f"pad {pad} computes another result")
        times = {pad: [] for pad in libs}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for r in range(args.rounds):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for pad in order:
                fak._lib = lambda lib=libs[pad]: lib
                for _ in range(5):
                    fak.attend(q, k, v, **kw)
                torch.cuda.synchronize()
                start.record()
                for _ in range(args.iters):
                    fak.attend(q, k, v, **kw)
                end.record()
                torch.cuda.synchronize()
                times[pad].append(start.elapsed_time(end) / args.iters)
    finally:
        fak._lib = lib_of
    for pad, ms in times.items():
        print(f"pad {pad} ({_BYTES + pad} bytes): bf16 flash at danube's "
              f"prefill, ms a call over {args.iters} calls, by round: "
              + " ".join(f"{t:.4f}" for t in ms))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
