"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` file has a plain C interface and becomes one shared
library, compiled for ``sm_90a`` at first use into ``src/repro_torch/build``
(listed in ``.gitignore``).  A library's file name carries a hash of its
source, of every shared header ``csrc/*.cuh`` and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "BuildResult", "build",
           "library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str          # source stem, e.g. "direct_conv2d_fwd"
    path: Path         # the shared library
    seconds: float     # wall time of this build (0.0 when it was cached)
    log: str           # nvcc's output (ptxas register/shared-memory report),
                       # kept beside the library for a cached build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _target(src: Path) -> Path:
    """The library built from ``src``: its name hashes the source, every
    header in ``CSRC`` (a source may include any of them) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Raises ``RuntimeError`` with nvcc's output when the compile fails."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source {src}")
    target = _target(src)
    log = target.with_suffix(".log")
    if target.exists():
        return BuildResult(name, target, 0.0,
                           log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}")
    log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    log_tmp.write_text(proc.stdout)
    os.replace(log_tmp, log)             # the log first: a built library
    os.replace(tmp, target)              # has one; atomic, never half seen
    return BuildResult(name, target, time.perf_counter() - t0, proc.stdout)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use, once per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name).path))
    return lib
