"""The port's training path against the JAX reference on the CPU: the loss,
the optimizer and its schedules, one VGG-16 step's gradients, five steps of
the example's toy dense net, and gradient accumulation.

Inputs and parameters are numpy arrays from fixed seeds, handed to both
packages.  Small: widths cut by ``width_div=16``, images up to 32x32."""
import copy
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainstep import (TrainSettings,  # noqa: E402
                                   make_loss_fn as jax_loss_fn)
from repro_torch.configs.cnn import vgg16_blocked, vgg16_layers  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import train_conv  # noqa: E402
from repro_torch.train.losses import cross_entropy  # noqa: E402
from repro_torch.train.optimizer import (AdamW, cosine_schedule,  # noqa: E402
                                         global_norm, linear_warmup)
from repro_torch.train.trainstep import (make_loss_fn,  # noqa: E402
                                         make_train_step)

ROOT = Path(__file__).resolve().parents[1]
WIDTH_DIV, N_CLASSES = 16, 10
# the optimizer: the same f32 arithmetic; the reference evaluates the
# learning rate and the bias corrections in f32, the port in f64
OPT_TOL = {"rtol": 1e-5, "atol": 1e-7}


def _tree_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves(tree):
    """``{"conv0": {"w": a}, "head": h}`` -> ``{"conv0.w": a, "head": h}``."""
    return {f"{k}.{kk}" if isinstance(v, dict) else k: np.asarray(vv)
            for k, v in tree.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}


def _grad_leaves(model):
    """The port's ``.grad`` of each parameter under the reference's names."""
    return {("head" if k == "head" else
             "conv{}.{}".format(*k.split(".")[1:])): p.grad.numpy()
            for k, p in model.named_parameters()}


def _numpy_tree(jmodel, seed):
    """Seeded numpy parameters in the reference's tree layout."""
    rng = np.random.default_rng(seed)
    specs = jmodel.specs()
    tree = {}
    for i, c in enumerate(jmodel.convs):
        s = specs[f"conv{i}"]
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) * np.sqrt(2.0 / (9 * c.ci)))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    c_last = jmodel.convs[-1].co
    tree["head"] = (rng.normal(size=specs["head"].shape)
                    / np.sqrt(c_last)).astype(np.float32)
    return tree


# ---------------------------------------------------------------------------
# loss, schedules, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vp,masked", [(10, False), (13, False), (13, True)])
def test_cross_entropy_matches_reference(vp, masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(3, 4, vp))).astype(np.float32)
    targets = rng.integers(0, 10, size=(3, 4)).astype(np.int32)
    mask = (rng.random((3, 4)) > 0.3).astype(np.float32) if masked else None
    want_loss, want = jlosses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), 10,
        mask=None if mask is None else jnp.asarray(mask))
    loss, got = cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(targets), 10,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for k in ("nll", "accuracy", "tokens"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)


def test_schedules_match_reference():
    cos_j = jopt.cosine_schedule(3e-3, 4, 20, floor=0.2)
    cos_t = cosine_schedule(3e-3, 4, 20, floor=0.2)
    warm_j, warm_t = jopt.linear_warmup(1e-2, 5), linear_warmup(1e-2, 5)
    for step in range(0, 25):
        s = jnp.asarray(step, jnp.int32)
        np.testing.assert_allclose(cos_t(step), float(cos_j(s)), rtol=1e-6)
        np.testing.assert_allclose(warm_t(step), float(warm_j(s)), rtol=1e-6)


@pytest.mark.parametrize("grad_scale,clip,decay", [
    (3.0, 1.0, 0.1),       # clipped: the global norm is well above 1
    (0.01, 1.0, 0.1),      # under the clip
    (3.0, None, 0.0),      # no clip, no decay
])
def test_adamw_matches_reference(grad_scale, clip, decay):
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    j_opt = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, 2, 5), weight_decay=decay,
                       grad_clip=clip)
    t_opt = AdamW(lr=cosine_schedule(1e-2, 2, 5), weight_decay=decay,
                  grad_clip=clip)
    jp, js = _tree_j(params), j_opt.init(_tree_j(params))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = t_opt.init(tp)
    for _ in range(5):
        grads = {k: (grad_scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = j_opt.update(_tree_j(grads), js, jp)
        tm = t_opt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                          ts, tp)
        assert ts.step == int(js.step)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **OPT_TOL)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                       **OPT_TOL)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                       **OPT_TOL)


def test_global_norm_and_name_checks():
    ts = [torch.full((2, 2), 1.0), torch.full((4,), 2.0)]
    assert global_norm(ts).item() == pytest.approx(np.sqrt(4 + 16))
    opt = AdamW(lr=lambda s: 1e-3)
    p = {"a": torch.zeros(2)}
    st = opt.init(p)
    with pytest.raises(ValueError, match="same"):
        opt.update({"b": torch.zeros(2)}, st, p)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _jax_vgg():
    convs = tuple(jconv.BlockedConv2D(ci, co, stride=s, padding="SAME",
                                      activation="relu")
                  for ci, co, s in vgg16_layers(WIDTH_DIV))
    return jconv.BlockedCNN(convs=convs, n_classes=N_CLASSES)


def test_narrow_vgg16_step_gradients_match_jax():
    jmodel = _jax_vgg()
    tree = _numpy_tree(jmodel, seed=2)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, size=2).astype(np.int32)
    loss_j = jax_loss_fn(jmodel, None,
                         TrainSettings(context=ConvContext(impl="jnp")))
    (want_loss, _), want = jax.value_and_grad(loss_j, has_aux=True)(
        _tree_j(tree), {"images": jnp.asarray(images),
                        "targets": jnp.asarray(targets)})
    model = vgg16_blocked(N_CLASSES, WIDTH_DIV, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    loss, _ = make_loss_fn(model)({"images": torch.from_numpy(images),
                                   "targets": torch.from_numpy(targets)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got, want = _grad_leaves(model), _leaves(want)
    assert set(got) == set(want)
    # 13 layers of f32 sums in other orders: relative to each tensor's
    # largest gradient
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_conv_net_example", ROOT / "examples" / "train_conv_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_toy_dense_training_matches_the_jax_example():
    steps = 5
    ex = _example()
    jmodel = ex.MODELS["dense"]
    tree = _numpy_tree(jmodel, seed=4)
    rng = np.random.default_rng(5)
    batches = [train_conv.make_batch(rng, 32) for _ in range(steps)]

    loss_fn = ex.make_loss(jmodel, ConvContext(impl="jnp"))
    j_opt = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, 10, steps),
                       weight_decay=0.0)
    jp = _tree_j(tree)
    js = j_opt.init(jp)

    @jax.jit
    def jstep(p, st, x, y):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, x, y)
        p, st, _ = j_opt.update(g, st, p)
        return p, st, loss

    model = train_conv.dense_model("cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    opt = AdamW(lr=cosine_schedule(1e-2, 10, steps), weight_decay=0.0)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    tol = ex.PARITY_TOL["f32"]
    for x, y in batches:
        jp, js, want = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        loss, _ = step(state, {"images": torch.from_numpy(x),
                               "targets": torch.from_numpy(y)})
        assert abs(loss.item() - float(want)) < tol + tol * abs(float(want))
    # five Adam steps of at most lr = 5e-3 from the same start: the
    # trajectories agree to f32 rounding of the gradients
    got, want = _leaves(params_to_numpy(model)), _leaves(jp)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_accumulating_two_microbatches_equals_one_batch():
    model = vgg16_blocked(N_CLASSES, WIDTH_DIV, device="cpu",
                          generator=torch.Generator().manual_seed(6))
    twin = copy.deepcopy(model)
    rng = np.random.default_rng(7)
    batch = {"images": torch.from_numpy(
                 rng.normal(size=(4, 16, 16, 3)).astype(np.float32)),
             "targets": torch.from_numpy(rng.integers(0, N_CLASSES, 4))}
    results = []
    for m, accum in ((model, 1), (twin, 2)):
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 4))
        state = opt.init(dict(m.named_parameters()))
        loss, metrics = make_train_step(m, opt, accum_steps=accum)(state,
                                                                   batch)
        assert state.step == 1
        results.append((loss, metrics, {k: p.grad.clone()
                                        for k, p in m.named_parameters()}))
    (l1, m1, g1), (l2, m2, g2) = results
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-6)
    np.testing.assert_allclose(m2["accuracy"].item(), m1["accuracy"].item())
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-6 * g1[k].abs().max().item(),
                                   err_msg=k)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, AdamW(lr=lambda s: 1e-3), accum_steps=3)(
            AdamW(lr=lambda s: 1e-3).init(dict(model.named_parameters())),
            batch)


def test_params_to_numpy_inverts_params_from_jax():
    jmodel = _jax_vgg()
    tree = _numpy_tree(jmodel, seed=8)
    model = vgg16_blocked(N_CLASSES, WIDTH_DIV, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    back = params_to_numpy(model)
    assert set(back) == set(tree)
    for i in range(len(jmodel.convs)):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[f"conv{i}"][leaf],
                                          tree[f"conv{i}"][leaf])
    np.testing.assert_array_equal(back["head"], tree["head"])
    assert all(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="not a BlockedCNN"):
        params_to_numpy(torch.nn.Linear(2, 2))


def test_train_conv_runs_on_the_cpu_when_asked(capsys):
    for dtype, tag in (("f32", "dense/cpu"), ("bf16", "dense/cpu/bf16")):
        assert train_conv.main(["--device", "cpu", "--steps", "3",
                                "--dtype", dtype]) == 0
        out = capsys.readouterr().out
        assert f"[{tag}] step 3:" in out and "fused inference path" in out
    # the separable model trains in bf16 too, on its plain versions here
    assert train_conv.main(["--device", "cpu", "--steps", "1", "--model",
                            "separable", "--dtype", "bf16"]) == 0
    out = capsys.readouterr().out
    assert "[separable/cpu/bf16] step 1:" in out and \
        "fused inference path" in out


# ---------------------------------------------------------------------------
# the separable family
# ---------------------------------------------------------------------------

def _spec_tree(specs, seed):
    """Seeded numpy parameters for a nested tree of the reference's
    ``ParamSpec``s (dense layers and depthwise-separable blocks)."""
    rng = np.random.default_rng(seed)

    def draw(name, spec):
        if isinstance(spec, dict):
            return {k: draw(k, v) for k, v in spec.items()}
        if name == "b":
            return (0.05 * rng.normal(size=spec.shape)).astype(np.float32)
        fan_in = np.prod(spec.shape[1:5]) if name == "w" else spec.shape[0]
        return (rng.normal(size=spec.shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)

    return {k: draw(k, v) for k, v in specs.items()}


def _flat(tree, prefix=""):
    """A nested tree's leaves under dotted names."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def test_toy_separable_training_matches_the_jax_example():
    steps = 5
    ex = _example()
    jmodel = ex.MODELS["separable"]
    tree = _spec_tree(jmodel.specs(), seed=14)
    rng = np.random.default_rng(15)
    batches = [train_conv.make_batch(rng, 32) for _ in range(steps)]

    loss_fn = ex.make_loss(jmodel, ConvContext(impl="jnp"))
    j_opt = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, 10, steps),
                       weight_decay=0.0)
    jp = _tree_j(tree)
    js = j_opt.init(jp)

    @jax.jit
    def jstep(p, st, x, y):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, x, y)
        p, st, _ = j_opt.update(g, st, p)
        return p, st, loss

    model = train_conv.separable_model("cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    opt = AdamW(lr=cosine_schedule(1e-2, 10, steps), weight_decay=0.0)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt)
    tol = ex.PARITY_TOL["f32"]
    for x, y in batches:
        jp, js, want = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        loss, _ = step(state, {"images": torch.from_numpy(x),
                               "targets": torch.from_numpy(y)})
        assert abs(loss.item() - float(want)) < tol + tol * abs(float(want))
    got, want = _flat(params_to_numpy(model)), _flat(jp)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_params_round_trip_on_a_nested_tree():
    ex = _example()
    jmodel = ex.MODELS["separable"]
    tree = _spec_tree(jmodel.specs(), seed=16)
    model = train_conv.separable_model("cpu")
    sd = params_from_jax(tree, device="cpu")
    assert set(sd) == set(model.state_dict()) == {
        f"convs.{i}.{leg}.{p}" for i in range(2) for leg in ("dw", "pw")
        for p in "wb"} | {"head"}
    model.load_state_dict(sd)
    back = params_to_numpy(model)
    assert set(back) == set(tree)
    for name, leaf in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[name], leaf)
    broken = dict(tree, conv1={"dw": tree["conv1"]["dw"]})
    with pytest.raises(ValueError, match="not a BlockedCNN"):
        params_from_jax(broken, device="cpu")


def test_train_conv_trains_the_separable_net_on_the_cpu(capsys):
    assert train_conv.main(["--model", "separable", "--device", "cpu",
                            "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[separable/cpu] step 3:" in out and "fused inference path" in out
