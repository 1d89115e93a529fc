"""The port's separable family against the JAX reference on the CPU: the
pointwise kernels' plain versions against the pointwise Pallas kernel in
interpret mode, the depthwise plain versions against the jnp oracle and
``conv_lax``, both VJPs against ``jax.vjp``, the routing of
``BlockedConv2D``, and ``DepthwiseSeparableBlock`` and MobileNet v1 built
narrow against the JAX ``BlockedCNN``.

Inputs and parameters are numpy arrays from fixed seeds, handed to both
packages.  Small: pencils of 4 to 16 channels, maps of 8 to 16 pixels,
MobileNet at ``width_div`` 16 on 32x32 images.  Tolerances are relative to
each tensor's largest value: both sides sum the same f32 products in other
orders."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext  # noqa: E402
from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.core.layout import (blocked_to_nhwc as j_unblock,  # noqa: E402
                               nhwc_to_blocked as j_block)
from repro.kernels.conv2d_pointwise import (  # noqa: E402
    pointwise_conv2d_blocked_pallas)
from repro.nn import conv as jconv  # noqa: E402
from repro.train.trainstep import (TrainSettings,  # noqa: E402
                                   make_loss_fn as jax_loss_fn)
from repro_torch.configs.cnn import (mobilenet_v1_blocked,  # noqa: E402
                                     mobilenet_v1_layers)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_blocked, direct_conv_dgrad_blocked,
    direct_conv_preactivation, direct_conv_wgrad_blocked)
from repro_torch.kernels import conv2d_depthwise as dwk  # noqa: E402
from repro_torch.kernels import conv2d_pointwise as pwk  # noqa: E402
from repro_torch.kernels import direct_conv2d as dck  # noqa: E402
from repro_torch.launch.conv_serve import ConvServer  # noqa: E402
from repro_torch.launch.train_conv import separable_model  # noqa: E402
from repro_torch.nn import conv as tconv  # noqa: E402
from repro_torch.serve.scheduler import ConvRequest, Outcome  # noqa: E402
from repro_torch.train.trainstep import make_loss_fn  # noqa: E402

REL = 1e-5


def _close(got, want, rel=REL, what=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# pointwise
# ---------------------------------------------------------------------------

def _pw_operands(seed, n, ci, co, h, w, cib, cob, residual):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 1, 1, cib, cob))
          / np.sqrt(ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    r = (rng.normal(size=(n, co // cob, h, w, cob)).astype(np.float32)
         if residual else None)
    return x, wt, b, r


# (n, ci, co, h, w, cib, cob, activation, residual, gap)
PW_CASES = [
    (2, 8, 16, 8, 8, 4, 8, "relu", False, False),
    (2, 12, 8, 9, 10, 4, 4, "gelu", True, False),      # 3 Ci x 2 Co blocks
    (1, 16, 32, 12, 12, 16, 16, None, False, True),
    (3, 8, 12, 8, 8, 8, 4, "relu", True, True),
]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act,res,gap", PW_CASES)
def test_pointwise_plain_matches_pallas_interpret(n, ci, co, h, w, cib, cob,
                                                  act, res, gap):
    x, wt, b, r = _pw_operands(0, n, ci, co, h, w, cib, cob, res)
    want = pointwise_conv2d_blocked_pallas(
        _j(x), _j(wt), _j(b), activation=act, interpret=True,
        residual=_j(r), gap=gap)
    got = pwk.pointwise_conv2d_blocked(_t(x), _t(wt), _t(b), 1, "SAME", act,
                                       residual=_t(r), gap=gap)
    _close(got.numpy(), want)


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act,res,gap", PW_CASES)
def test_pointwise_vjp_matches_pallas_interpret(n, ci, co, h, w, cib, cob,
                                                act, res, gap):
    x, wt, b, r = _pw_operands(1, n, ci, co, h, w, cib, cob, res)
    args = [x, wt, b] + ([r] if res else [])

    def jf(x_, w_, b_, *r_):
        return pointwise_conv2d_blocked_pallas(
            x_, w_, b_, activation=act, interpret=True,
            residual=r_[0] if r_ else None, gap=gap)

    out, vjp = jax.vjp(jf, *map(_j, args))
    ct = np.random.default_rng(2).normal(size=out.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    ins = [_t(a).clone().requires_grad_() for a in args]
    got = pwk.pointwise_conv2d_blocked(ins[0], ins[1], ins[2], 1, "VALID",
                                       act, residual=ins[3] if res else None,
                                       gap=gap)
    got.backward(_t(ct))
    for name, t, wv in zip(("dx", "dw", "db", "dres"), ins, want):
        _close(t.grad.numpy(), wv, what=name)


def test_pointwise_refuses_other_geometry():
    x, wt, b, _ = _pw_operands(3, 1, 8, 8, 6, 6, 4, 4, False)
    with pytest.raises(ValueError, match="stride=1, zero-pad only"):
        pwk.pointwise_conv2d_blocked(_t(x), _t(wt), _t(b), stride=2)
    with pytest.raises(ValueError, match="stride=1, zero-pad only"):
        pwk.pointwise_conv2d_blocked(_t(x), _t(wt), _t(b), padding=1)
    with pytest.raises(ValueError, match="1x1 filter"):
        pwk.pointwise_conv2d_blocked(_t(x), torch.zeros(2, 2, 3, 3, 4, 4))
    with pytest.raises(ValueError, match="input blocks"):
        pwk.pointwise_conv2d_blocked(_t(x), _t(wt)[:, :1])
    with pytest.raises(ValueError, match="unknown activation"):
        pwk.pointwise_conv2d_blocked(_t(x), _t(wt), activation="swish")


# ---------------------------------------------------------------------------
# depthwise
# ---------------------------------------------------------------------------

def _dw_operands(seed, n, c, h, w, cb, stride, padding, dilation, residual):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c // cb, h, w, cb)).astype(np.float32)
    wt = (rng.normal(size=(c // cb, 1, 3, 3, 1, cb)) / 3).astype(np.float32)
    b = (0.1 * rng.normal(size=(c // cb, cb))).astype(np.float32)
    r = None
    if residual:
        sp = ConvSpec.make(n, h, w, c, c, 3, 3, stride, padding, groups=c,
                           dilation=dilation)
        r = rng.normal(size=(n, c // cb, sp.ho, sp.wo, cb)).astype(np.float32)
    return x, wt, b, r


# (n, c, h, w, cb, stride, padding, dilation, activation, residual, gap)
DW_CASES = [
    (2, 8, 9, 9, 4, 1, "SAME", 1, "relu", False, False),
    (2, 16, 8, 8, 16, 2, "SAME", 1, "relu", False, False),   # pads (0, 1)
    (1, 12, 11, 10, 4, 2, "VALID", 1, "gelu", False, False),
    (2, 8, 12, 12, 8, 1, "SAME", 2, "gelu", True, True),     # dilation 2
    (1, 8, 13, 13, 4, 2, "SAME", 2, None, True, False),
]


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,act,res,gap", DW_CASES)
def test_depthwise_plain_matches_jax_oracle_and_lax(n, c, h, w, cb, s, pad,
                                                    dil, act, res, gap):
    x, wt, b, r = _dw_operands(4, n, c, h, w, cb, s, pad, dil, res)
    want = jax_conv(_j(x), _j(wt), s, pad, _j(b), act, groups=c,
                    dilation=dil, residual=_j(r), gap=gap)
    got = dwk.depthwise_conv2d_blocked(_t(x), _t(wt), _t(b), s, pad, act,
                                       residual=_t(r), gap=gap, dilation=dil)
    _close(got.numpy(), want)
    # the bare conv against XLA's grouped convolution
    w_hwio = np.transpose(wt[:, 0, :, :, 0, :], (1, 2, 0, 3)).reshape(
        3, 3, 1, c)
    lax = conv_lax(j_unblock(_j(x)), jnp.asarray(w_hwio), s, pad, groups=c,
                   dilation=dil)
    bare = dwk.depthwise_conv2d_blocked(_t(x), _t(wt), None, s, pad,
                                        dilation=dil)
    _close(bare.numpy(), j_block(lax, cb))


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,act,res,gap", DW_CASES)
def test_depthwise_vjp_matches_jax_oracle(n, c, h, w, cb, s, pad, dil, act,
                                          res, gap):
    x, wt, b, r = _dw_operands(5, n, c, h, w, cb, s, pad, dil, res)
    args = [x, wt, b] + ([r] if res else [])

    def jf(x_, w_, b_, *r_):
        return jax_conv(x_, w_, s, pad, b_, act, groups=c, dilation=dil,
                        residual=r_[0] if r_ else None, gap=gap)

    out, vjp = jax.vjp(jf, *map(_j, args))
    ct = np.random.default_rng(6).normal(size=out.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    ins = [_t(a).clone().requires_grad_() for a in args]
    got = dwk.depthwise_conv2d_blocked(ins[0], ins[1], ins[2], s, pad, act,
                                       residual=ins[3] if res else None,
                                       gap=gap, dilation=dil)
    got.backward(_t(ct))
    for name, t, wv in zip(("dx", "dw", "db", "dres"), ins, want):
        _close(t.grad.numpy(), wv, what=name)


@pytest.mark.parametrize("family", ["pointwise", "depthwise"])
def test_autograd_functions_gradcheck_f64(family):
    rng = np.random.default_rng(7)
    if family == "pointwise":
        shapes = [(1, 2, 3, 3, 2), (2, 2, 1, 1, 2, 2), (2, 2)]
        fn = lambda x, w, b: pwk.pointwise_conv2d_blocked(  # noqa: E731
            x, w, b, activation="gelu")
    else:
        shapes = [(1, 2, 5, 5, 2), (2, 1, 3, 3, 1, 2), (2, 2)]
        fn = lambda x, w, b: dwk.depthwise_conv2d_blocked(  # noqa: E731
            x, w, b, 2, "SAME", "gelu", dilation=2)
    ins = [torch.from_numpy(rng.normal(size=s)).requires_grad_()
           for s in shapes]
    assert torch.autograd.gradcheck(fn, ins)


def test_depthwise_refuses_what_the_kernels_do_not_take():
    x, wt, b, _ = _dw_operands(8, 1, 8, 6, 6, 4, 1, "SAME", 1, False)
    with pytest.raises(ValueError, match="depthwise weight"):
        dwk.depthwise_conv2d_blocked(_t(x), torch.zeros(2, 2, 3, 3, 4, 4))
    with pytest.raises(ValueError, match="at most 25 taps"):
        dwk.depthwise_conv2d_blocked(_t(x), torch.zeros(2, 1, 7, 7, 1, 4),
                                     padding="SAME")
    with pytest.raises(ValueError, match="bias shape"):
        dwk.depthwise_conv2d_blocked(_t(x), _t(wt), _t(b).reshape(-1))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _spy(monkeypatch):
    """Count the calls of each family's wrapper from ``nn.conv``."""
    calls = {"pointwise": 0, "depthwise": 0, "dense": 0}
    for name, attr in (("pointwise", "pointwise_conv2d_blocked"),
                       ("depthwise", "depthwise_conv2d_blocked"),
                       ("dense", "direct_conv2d_blocked")):
        real = getattr(tconv, attr)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tconv, attr, wrapped)
    return calls


@pytest.mark.parametrize("layer,kind", [
    (dict(ci=8, co=16, hf=1, wf=1, padding="SAME"), "pointwise"),
    (dict(ci=8, co=16, hf=1, wf=1, stride=2), "dense"),   # not pointwise
    (dict(ci=8, co=8, groups=8), "depthwise"),
    (dict(ci=8, co=8, groups=8, stride=2, dilation=2), "depthwise"),
    (dict(ci=8, co=16), "dense"),
])
def test_blocked_conv2d_routes_by_geometry(monkeypatch, layer, kind):
    calls = _spy(monkeypatch)
    conv = tconv.BlockedConv2D(**layer, lane=8, device="cpu")
    x = torch.randn(2, 1, 10, 10, 8)
    with torch.no_grad():
        conv(x)
    assert calls == {k: int(k == kind) for k in calls}


def test_grouped_and_dilated_dense_layers_are_refused(monkeypatch):
    # grouped and dilated dense layers go to the dense wrapper, never to
    # the separable family: served on its grouped map and dilated taps, and
    # (now that their dgrad and wgrad are ported) trained through it too,
    # the gradients those of the plain backward
    calls = _spy(monkeypatch)
    for layer in (dict(groups=2), dict(dilation=2)):
        conv = tconv.BlockedConv2D(8, 16, **layer, lane=8, device="cpu")
        cb = conv.in_pencil               # per group: 4 at groups 2
        x = torch.randn(2, 8 // cb, 10, 10, cb)
        with torch.no_grad():
            got = conv(x)
        want = direct_conv_blocked(x, conv.w, 1, "SAME", conv.b, "relu",
                                   groups=conv.groups,
                                   dilation=conv.dilation)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        xg = x.clone().requires_grad_(True)
        y = conv(xg)
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        g = torch.randn_like(y)
        y.backward(g)
        z = direct_conv_preactivation(x, conv.w.detach(), 1, "SAME",
                                      conv.b.detach(), conv.groups,
                                      conv.dilation)
        dx = direct_conv_dgrad_blocked(g, conv.w.detach(), (10, 10), 1,
                                       "SAME", z, "relu", conv.groups,
                                       conv.dilation)
        dw, db = direct_conv_wgrad_blocked(x, g, 3, 3, 1, "SAME", z, "relu",
                                           True, conv.groups, conv.dilation)
        torch.testing.assert_close(xg.grad, dx, rtol=0, atol=0)
        torch.testing.assert_close(conv.w.grad, dw, rtol=0, atol=0)
        torch.testing.assert_close(conv.b.grad, db, rtol=0, atol=0)
    assert calls == {"pointwise": 0, "depthwise": 0, "dense": 4}


# ---------------------------------------------------------------------------
# blocks and MobileNet against the JAX BlockedCNN
# ---------------------------------------------------------------------------

WIDTH_DIV, N_CLASSES = 16, 10


def _numpy_tree(specs, seed):
    """Seeded numpy parameters for a (nested) tree of the reference's
    ``ParamSpec``s: weights scaled by their fan-in, small biases."""
    rng = np.random.default_rng(seed)

    def draw(name, spec):
        if isinstance(spec, dict):
            return {k: draw(k, v) for k, v in spec.items()}
        shape = spec.shape
        if name == "b":
            return (0.05 * rng.normal(size=shape)).astype(np.float32)
        fan_in = (np.prod(shape[1:5]) if name == "w" else shape[0])
        return (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)

    return {k: draw(k, v) for k, v in specs.items()}


def _jax_mobilenet():
    layers = []
    for kind, ci, co, s in mobilenet_v1_layers(WIDTH_DIV):
        cls = jconv.BlockedConv2D if kind == "conv" else \
            jconv.DepthwiseSeparableBlock
        layers.append(cls(ci, co, stride=s, padding="SAME",
                          activation="relu"))
    return jconv.BlockedCNN(convs=tuple(layers), n_classes=N_CLASSES)


@pytest.fixture(scope="module")
def mobilenets():
    jmodel = _jax_mobilenet()
    tree = _numpy_tree(jmodel.specs(), seed=9)
    model = mobilenet_v1_blocked(N_CLASSES, WIDTH_DIV, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    return jmodel, tree, model


def test_separable_block_matches_jax_block():
    jblock = jconv.DepthwiseSeparableBlock(8, 16, stride=2, lane=8)
    tree = _numpy_tree(jblock.specs(), seed=10)
    x = np.random.default_rng(11).normal(size=(2, 1, 9, 9, 8)).astype(
        np.float32)
    want = jblock(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                  context=ConvContext(impl="jnp"))
    block = tconv.DepthwiseSeparableBlock(8, 16, stride=2, lane=8,
                                          device="cpu")
    assert (block.in_pencil, block.out_pencil) == (jblock.in_pencil,
                                                   jblock.out_pencil)
    with torch.no_grad():
        for leg in ("dw", "pw"):
            getattr(block, leg).w.copy_(_t(tree[leg]["w"]))
            getattr(block, leg).b.copy_(_t(tree[leg]["b"]))
        got = block(_t(x))
    _close(got.numpy(), want, 1e-4)


def test_narrow_mobilenet_logits_match_jax(mobilenets):
    jmodel, tree, model = mobilenets
    x = np.random.default_rng(12).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = jmodel(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                  context=ConvContext(impl="jnp"))
    with torch.no_grad():
        got = model(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_narrow_mobilenet_step_gradients_match_jax(mobilenets):
    jmodel, tree, model = mobilenets
    rng = np.random.default_rng(13)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, size=2).astype(np.int32)
    loss_j = jax_loss_fn(jmodel, None,
                         TrainSettings(context=ConvContext(impl="jnp")))
    (want_loss, _), want = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {"images": jnp.asarray(images), "targets": jnp.asarray(targets)})
    model.zero_grad()
    loss, _ = make_loss_fn(model)({"images": _t(images),
                                   "targets": _t(targets)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [p.key for p in path]
        name = "head" if keys == ["head"] else \
            "convs." + keys[0][4:] + "." + ".".join(keys[1:])
        flat[name] = np.asarray(leaf)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(flat)
    # 14 layers of f32 sums in other orders: relative to each tensor's
    # largest gradient
    for name, w in flat.items():
        _close(got[name], w, 1e-4, what=name)


def test_mobilenet_config_at_published_widths():
    model = mobilenet_v1_blocked(1000, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 4_220_032
    kinds = [type(c).__name__ for c in model.convs]
    assert kinds == ["BlockedConv2D"] + ["DepthwiseSeparableBlock"] * 13
    assert [c.in_pencil for c in model.convs[1:]] == \
        [32, 64, 128, 128, 128, 128] + [128] * 7
    assert model.convs[-1].dw.stride == 1        # Table 1's erratum
    with pytest.raises(ValueError, match="width_div"):
        mobilenet_v1_layers(3)


def test_server_warms_up_a_model_whose_first_layer_is_a_block():
    model = separable_model("cpu", torch.Generator().manual_seed(0))
    server = ConvServer(model, [(8, 8)], 2, device="cpu")
    server.warmup()
    req = ConvRequest(0, np.ones((7, 8, 8), np.float32))
    server.submit(req)
    server.run()
    assert req.outcome is Outcome.OK and req.logits.shape == (8,)


def test_launch_counters_stay_zero_on_the_cpu(mobilenets):
    _, _, model = mobilenets
    for mod in (pwk, dwk, dck):
        mod.reset_launches()
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    assert not any(v for mod in (pwk, dwk, dck) for v in mod.LAUNCHES.values())
