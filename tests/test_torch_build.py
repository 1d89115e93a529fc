"""The kernels' build targets on the CPU: no ``nvcc`` is needed to name a
library.  A library's name hashes its source and every shared header, so a
header edit rebuilds every source that may include it."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def test_the_dgrad_sources_include_the_shared_tile():
    for name in ("direct_conv2d_bwd", "conv2d_stream"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "dgrad_tile.cuh"' in text


@pytest.mark.parametrize("name", SOURCES)
def test_a_header_edit_changes_every_target(tmp_path, monkeypatch, name):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    src = csrc / f"{name}.cu"
    before = _build._target(src)
    assert before == _build._target(src)            # deterministic
    assert before.name.startswith(f"lib{name}-")
    header = csrc / "dgrad_tile.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = _build._target(src)
    assert edited != before
    # a new header counts too, and so does the source itself
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target(src) != edited
    newest = _build._target(src)
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target(src) != newest


def test_a_cached_build_returns_the_log_of_its_compile(tmp_path, monkeypatch):
    # a library built earlier is not compiled again, and its result keeps
    # the ptxas report that its compile printed
    csrc, build_dir = tmp_path / "csrc", tmp_path / "build"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("compiled"))
    target = _build._target(csrc / "conv2d_stream.cu")
    build_dir.mkdir()
    target.write_bytes(b"")
    assert _build.build("conv2d_stream").log == ""
    target.with_suffix(".log").write_text("ptxas info : Used 90 registers")
    res = _build.build("conv2d_stream")
    assert (res.path, res.seconds) == (target, 0.0)
    assert res.log == "ptxas info : Used 90 registers"
