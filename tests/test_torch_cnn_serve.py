"""The port's VGG-16 BlockedCNN and ConvServer against the JAX reference, plus
the guards that keep the port apart from JAX and off the CPU by default.

Small: widths cut by ``width_div=16``, images up to 32x32, batch 2-4."""
import itertools
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs.cnn import vgg16_blocked, vgg16_layers  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train_conv  # noqa: E402
from repro_torch.launch.conv_serve import ConvServer  # noqa: E402
from repro_torch.nn.conv import BlockedConv2D  # noqa: E402
from repro_torch.serve.scheduler import ConvRequest, Outcome  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WIDTH_DIV, N_CLASSES = 16, 10
# logits after 13 convs + head; both sides sum f32 products in other orders
LOGIT_TOL = {"rtol": 1e-4, "atol": 1e-6}


def _jax_model():
    convs = tuple(jconv.BlockedConv2D(ci, co, stride=s, padding="SAME",
                                      activation="relu")
                  for ci, co, s in vgg16_layers(WIDTH_DIV))
    return jconv.BlockedCNN(convs=convs, n_classes=N_CLASSES)


def _numpy_tree(model, seed=0):
    """Seeded numpy parameters in the reference's tree layout."""
    rng = np.random.default_rng(seed)
    specs = model.specs()
    tree = {}
    for i in range(len(model.convs)):
        s = specs[f"conv{i}"]
        fan_in = 9 * model.convs[i].ci
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) * np.sqrt(2.0 / fan_in))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    tree["head"] = rng.normal(size=specs["head"].shape).astype(np.float32)
    return tree


def _port_model(tree):
    model = vgg16_blocked(N_CLASSES, WIDTH_DIV, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    return model


@pytest.fixture(scope="module")
def models():
    jmodel = _jax_model()
    tree = _numpy_tree(jmodel)
    return jmodel, tree, _port_model(tree)


def test_narrow_vgg16_logits_match_jax(models):
    jmodel, tree, port = models
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jtree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in tree.items()}
    want = np.asarray(jmodel(jtree, jnp.asarray(x),
                             context=ConvContext(impl="jnp")))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, N_CLASSES)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_vgg16_config_at_published_widths():
    layers = vgg16_layers()
    assert [co for _, co, _ in layers] == [64, 64, 128, 128, 256, 256, 256,
                                           512, 512, 512, 512, 512, 512]
    assert [i for i, (_, _, s) in enumerate(layers) if s == 2] == [2, 4, 7, 10]
    h, macs = 224, 0
    for ci, co, s in layers:
        h = -(-h // s)
        macs += h * h * 9 * ci * co
    assert h == 14
    assert abs(macs - 15.35e9) < 0.01e9            # VGG-16's conv MACs
    with pytest.raises(ValueError, match="width_div"):
        vgg16_layers(3)


def test_params_from_jax_layout_and_errors(models):
    _, tree, port = models
    sd = port.state_dict()
    assert set(sd) == set(params_from_jax(tree, device="cpu"))
    assert tuple(sd["convs.0.w"].shape) == (64 // WIDTH_DIV // 4, 1, 3, 3, 3, 4)
    with pytest.raises(ValueError, match="not a BlockedCNN"):
        params_from_jax({"conv1": tree["conv1"], "head": tree["head"]},
                        device="cpu")


def _ragged_requests(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    return [ConvRequest(rid, rng.normal(size=(int(h), int(w), 3))
                        .astype(np.float32))
            for rid, (h, w) in enumerate(rng.integers(lo, hi + 1,
                                                      size=(count, 2)))]


def test_conv_server_serves_ragged_requests_like_a_direct_forward(models):
    _, _, port = models
    ticks = itertools.count()
    srv = ConvServer(port, [(16, 16), (32, 32)], batch=4, device="cpu",
                     clock=lambda: float(next(ticks)))
    srv.warmup()
    reqs = _ragged_requests(2, 10, 8, 32)
    for r in reqs:
        assert srv.submit(r) is Outcome.PENDING
    done = srv.run()
    assert len(done) == len(reqs)
    assert all(r.outcome is Outcome.OK and r.done for r in reqs)
    with torch.no_grad():
        for r in reqs:
            assert r.bucket == srv.bucketer.bucket_for(*r.image.shape[:2])
            img = torch.from_numpy(srv.bucketer.pad(r.image, r.bucket))
            want = port(img[None])[0].numpy()
            np.testing.assert_allclose(r.logits, want, rtol=1e-5, atol=1e-6)
    small = sum(1 for r in reqs if r.bucket == (16, 16))
    steps_small, steps_big = -(-small // 4), -(-(len(reqs) - small) // 4)
    assert srv.occupancy((16, 16)) == pytest.approx(small / 4 / steps_small)
    assert srv.occupancy((32, 32)) == pytest.approx(
        (len(reqs) - small) / 4 / steps_big)
    h = srv.health()
    assert (h["submitted"], h["ok"], h["pending"]) == (10, 10, 0)
    assert len(srv.latencies()) == 10 and (srv.latencies() > 0).all()


def test_conv_server_deadlines_and_shedding(models):
    _, _, port = models
    now = [0.0]
    srv = ConvServer(port, [(16, 16)], batch=2, device="cpu",
                     clock=lambda: now[0], max_queue=2)
    a, b, c = _ragged_requests(3, 3, 8, 16)
    assert srv.submit(a, timeout=0.5) is Outcome.PENDING
    assert srv.submit(b) is Outcome.PENDING
    assert srv.submit(c) is Outcome.REJECTED          # queue full: shed now
    assert c.done and c.logits is None
    now[0] = 1.0                                      # a's deadline passed
    srv.run()
    assert a.outcome is Outcome.TIMED_OUT and a.logits is None
    assert b.outcome is Outcome.OK and b.logits.shape == (N_CLASSES,)
    h = srv.health()
    assert (h["shed"], h["timed_out"], h["ok"]) == (1, 1, 1)
    assert h["shed_rate"] == pytest.approx(1 / 3)
    assert srv.occupancy() == pytest.approx(0.5)      # b ran alone
    with pytest.raises(ValueError, match="exceeds every bucket"):
        srv.submit(ConvRequest(9, np.zeros((17, 4, 3), np.float32)))


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]


def test_port_imports_neither_jax_nor_reference():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    sources = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders


def test_default_device_entry_points_refuse_the_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    _, tree, port = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vgg16_blocked(N_CLASSES, WIDTH_DIV)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockedConv2D(3, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConvServer(port, [(16, 16)], batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_conv.dense_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_conv.main(["--steps", "1"])


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:       # a directory with the script and nothing else
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
