"""The separable family (MobileNet's pointwise and depthwise legs) under the
``BF16`` policy, on the CPU: the plain versions the wrappers run here
against the JAX package's reference, the training path's cast discipline,
and the choosers and memory model at 2-byte operands.

* Pointwise: the port's forward (residual, GAP) and its autograd against
  ``pointwise_conv2d_blocked_pallas(..., precision="bf16", interpret=True)``
  and its ``jax.vjp`` (the reference's ``_pwconv`` / ``_pwconv_fwd`` /
  ``_pwconv_bwd``).
* Depthwise: the depthwise Pallas kernels do not run under the installed
  jax (ROADMAP queue C), so the reference's ``_dwconv_fwd`` /
  ``_dwconv_bwd`` cast discipline is built from JAX pieces: the forward is
  ``repro.core.direct_conv.direct_conv_blocked(..., precision="bf16",
  groups=C)``; the backward takes ``dz`` from
  ``repro.kernels.conv2d_common.cotangent_prologue`` on the bf16 cotangent
  and the saved bf16 pre-activation, then ``jax.vjp`` of the f32 linear
  oracle on the bf16-valued operands, dx rounded once to bf16, dw and db
  kept in f32.
* A narrow separable CNN (``launch.train_conv.separable_model``: two
  blocks, pencils of 8) one bf16 step against the JAX model under
  ``ConvContext(impl="jnp", precision="bf16")``, with the JAX weights
  carried by ``convert.params_from_jax``.

Tolerances, and why:

* forwards and dx (bf16): each element within one bf16 ulp of its
  magnitude plus ``BF16_FWD_REL`` (1e-5) of max|y|: both sides round f32
  sums of the same exact bf16 products once to bf16, in other orders;
* dw and db (f32): within ``WGRAD_REL`` (1e-5) of sum|x * dz| (of sum|dz|
  for db) per element: the same f32 sums of the same products in other
  orders;
* the narrow step: the loss within the example's bf16 parity tolerance
  (``PARITY_TOL["bf16"]``, ``examples/train_conv_net.py``: 5e-2 relative);
  each gradient, relative to its largest value, within ``BF16_TOL`` (3e-2,
  the reference's ``tests/test_precision.py``) or twice the port's own bf16
  path's distance from the f32 gradient where that is larger: the JAX
  model under ``impl="jnp"`` differentiates a bf16 forward with its own
  rounding points, so the two bf16 paths may round apart layer by layer.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext as JConvContext  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.kernels import conv2d_common as jcommon  # noqa: E402
from repro.kernels.conv2d_pointwise import (  # noqa: E402
    pointwise_conv2d_blocked_pallas)
from repro.nn import conv as jconv  # noqa: E402
from repro.train.trainstep import (TrainSettings,  # noqa: E402
                                   make_loss_fn as jax_loss_fn)
from repro_torch.configs.cnn import (MOBILENET_V1_BLOCKS,  # noqa: E402
                                     MOBILENET_V1_CONV1)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core.context import ConvContext  # noqa: E402
from repro_torch.core.conv2d_common import cotangent_prologue  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_wgrad_blocked)
from repro_torch.core.precision import Precision  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import conv2d_depthwise as dwk  # noqa: E402
from repro_torch.kernels import conv2d_pointwise as pwk  # noqa: E402
from repro_torch.kernels import direct_conv2d as dck  # noqa: E402
from repro_torch.launch.train_conv import (N_CLASSES,  # noqa: E402
                                           make_batch, separable_model)
from repro_torch.nn.conv import DepthwiseSeparableBlock  # noqa: E402
from repro_torch.train.trainstep import make_loss_fn  # noqa: E402

BF16_FWD_REL = 1e-5
WGRAD_REL = 1e-5
BF16_TOL = 3e-2               # the reference's tests/test_precision.py
PARITY_TOL_BF16 = 5e-2        # examples/train_conv_net.py PARITY_TOL["bf16"]
BF = torch.bfloat16


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf16_np(a):
    """Round to bf16 (nearest, ties to even) -> f32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def _bf16_close(got, want, what=""):
    """Every element within one bf16 ulp of its magnitude, plus
    ``BF16_FWD_REL`` of max|want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    bound = ulp + BF16_FWD_REL * np.abs(w).max()
    worst = (np.abs(g - w) / bound).max()
    assert worst <= 1.0, (what, worst)


def _wgrad_close(got, want, scale, what=""):
    """``|got - want| <= WGRAD_REL * scale`` elementwise (scale: the sum of
    the products' magnitudes)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    s = np.asarray(scale, np.float64)
    assert g.shape == w.shape == s.shape, (what, g.shape, w.shape, s.shape)
    assert np.all(np.abs(g - w) <= WGRAD_REL * s + 1e-30), (
        what, (np.abs(g - w) / np.maximum(WGRAD_REL * s, 1e-30)).max())


def _saved_z(out):
    """The saved pre-activation of a ``BlockedConvFunction`` output (None
    where the activation is linear)."""
    return out.grad_fn.saved_tensors[2]


def _spread(ct, gap, shape):
    """The cotangent the backward kernels see: a pooled cotangent spread
    over the map in f32, then cast to bf16 once (``BlockedConvFunction``,
    the reference's ``_pwconv_bwd`` / ``_dwconv_bwd``)."""
    ct = torch.as_tensor(ct, dtype=torch.float32)
    if gap:
        n, cblk, ho, wo, cb = shape
        ct = (ct.reshape(n, cblk, 1, 1, cb) / (ho * wo)).expand(shape)
    return ct.to(BF).contiguous()


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


# (n, ci, co, h, w, cib, cob, activation, residual, gap): pencils of 8 and
# 16, Cob % 8 != 0 (the dense bf16 dgrad's 2-byte copies on the card), Cib
# 4 (the tile's Cib padded to 16)
PW_CASES = [
    (2, 16, 32, 8, 8, 8, 16, "relu", False, False),
    (2, 12, 12, 9, 10, 4, 6, "gelu", True, False),     # 3 Ci x 2 Co blocks
    (1, 16, 32, 12, 12, 16, 16, None, False, True),
    (3, 8, 24, 8, 8, 8, 8, "relu", True, True),
    # several small images: the bf16 tile's items span images
    (4, 16, 32, 7, 7, 16, 16, "relu", True, True),
]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act,res,gap", PW_CASES)
def test_pointwise_bf16_forward_matches_pallas_interpret(n, ci, co, h, w, cib,
                                                         cob, act, res, gap):
    x, wt, b, r = _pw_operands(0, n, ci, co, h, w, cib, cob, res)
    want = pointwise_conv2d_blocked_pallas(
        _j(x), _j(wt), _j(b), activation=act, interpret=True, residual=_j(r),
        gap=gap, precision="bf16")
    got = pwk.pointwise_conv2d_blocked(_t(x), _t(wt), _t(b), 1, "SAME", act,
                                       residual=_t(r), gap=gap,
                                       precision="bf16")
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act,res,gap", PW_CASES)
def test_pointwise_bf16_vjp_matches_pallas_interpret(n, ci, co, h, w, cib,
                                                     cob, act, res, gap):
    x, wt, b, r = _pw_operands(1, n, ci, co, h, w, cib, cob, res)
    args = [x, wt, b] + ([r] if res else [])

    def jf(x_, w_, b_, *r_):
        return pointwise_conv2d_blocked_pallas(
            x_, w_, b_, activation=act, interpret=True,
            residual=r_[0] if r_ else None, gap=gap, precision="bf16")

    out, vjp = jax.vjp(jf, *map(_j, args))
    ct = np.random.default_rng(2).normal(size=out.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct).astype(out.dtype))
    ins = [_t(a).clone().requires_grad_() for a in args]
    got = pwk.pointwise_conv2d_blocked(ins[0], ins[1], ins[2], 1, "VALID",
                                       act, residual=ins[3] if res else None,
                                       gap=gap, precision="bf16")
    z = _saved_z(got)
    got.backward(_t(ct).to(got.dtype))
    # dx: a bf16 dgrad, up-cast to x's f32
    assert ins[0].grad.dtype == torch.float32
    _bf16_close(ins[0].grad.numpy(), np.asarray(want[0]), "dx")
    # dw, db: f32 sums of the bf16 x and dz
    g = _spread(_bf16_np(ct), gap, (n, co // cob, h, w, cob))
    dz = cotangent_prologue(g, z, act).double().abs()
    xa = _t(x).to(BF).double().abs()
    abs_dw, abs_db = direct_conv_wgrad_blocked(xa, dz, 1, 1, 1, "VALID",
                                               with_db=True)
    _wgrad_close(ins[1].grad.numpy(), want[1], abs_dw.numpy(), "dw")
    _wgrad_close(ins[2].grad.numpy(), want[2], abs_db.numpy(), "db")
    if res:
        np.testing.assert_array_equal(ins[3].grad.numpy(),
                                      np.asarray(want[3]).astype(np.float32))


# ---------------------------------------------------------------------------
# depthwise
# ---------------------------------------------------------------------------

def _dw_operands(seed, n, c, h, w, cb, stride, padding, dilation, residual):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c // cb, h, w, cb)).astype(np.float32)
    wt = (rng.normal(size=(c // cb, 1, 3, 3, 1, cb)) / 3).astype(np.float32)
    b = (0.1 * rng.normal(size=(c // cb, cb))).astype(np.float32)
    sp = ConvSpec.make(n, h, w, c, c, 3, 3, stride, padding, groups=c,
                       dilation=dilation)
    r = (rng.normal(size=(n, c // cb, sp.ho, sp.wo, cb)).astype(np.float32)
         if residual else None)
    return x, wt, b, r, sp


# (n, c, h, w, cb, stride, padding, dilation, activation, residual, gap):
# strides 1 and 2, dilation 2, SAME (and TF-SAME's (0, 1)) and VALID, relu
# and gelu, a residual and GAP, pencils of 8 and 16 and an odd one of 3
DW_CASES = [
    (2, 16, 9, 9, 8, 1, "SAME", 1, "relu", False, False),
    (2, 16, 8, 8, 16, 2, "SAME", 1, "relu", True, False),     # pads (0, 1)
    (1, 24, 11, 10, 8, 2, "VALID", 1, "gelu", False, True),
    (2, 8, 12, 12, 8, 1, "SAME", 2, "gelu", True, True),      # dilation 2
    (1, 6, 9, 9, 3, 2, "SAME", 1, None, False, False),        # Cb 3
]


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,act,res,gap", DW_CASES)
def test_depthwise_bf16_forward_matches_the_references_bf16_forward(
        n, c, h, w, cb, s, pad, dil, act, res, gap):
    x, wt, b, r, _ = _dw_operands(4, n, c, h, w, cb, s, pad, dil, res)
    want = jax_conv(_j(x), _j(wt), s, pad, _j(b), act, precision="bf16",
                    groups=c, dilation=dil, residual=_j(r), gap=gap)
    got = dwk.depthwise_conv2d_blocked(_t(x), _t(wt), _t(b), s, pad, act,
                                       residual=_t(r), gap=gap, dilation=dil,
                                       precision="bf16")
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _dw_reference_vjp(x, wt, b, r, sp, s, pad, dil, act, gap, ct):
    """The reference's ``_dwconv_fwd`` / ``_dwconv_bwd`` cast discipline on
    JAX pieces -> (dx, dw, db, dres) as f32 numpy."""
    c = sp.co
    xq, wq = _bf16_np(x), _bf16_np(wt)
    z = jax_conv(_j(xq), _j(wq), s, pad, _j(b), None, precision="bf16",
                 groups=c, dilation=dil)             # f32 sums + b, in bf16
    g = jnp.asarray(_spread(_bf16_np(ct), gap, z.shape).float().numpy())
    g = g.astype(jnp.bfloat16)
    dz = jcommon.cotangent_prologue(g, None if act is None else z, act)
    dz = dz.astype(jnp.float32)

    def linear(x_, w_):                              # the f32 oracle
        return jax_conv(x_, w_, s, pad, None, None, groups=c, dilation=dil)

    _, vjp = jax.vjp(linear, _j(xq), _j(wq))
    dx, dw = vjp(dz)
    dx = np.asarray(dx.astype(jnp.bfloat16).astype(jnp.float32))
    db = np.asarray(dz.sum(axis=(0, 2, 3)))
    dres = np.asarray(g.astype(jnp.float32)) if r is not None else None
    return dx, np.asarray(dw), db, dres, np.asarray(dz)


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,act,res,gap", DW_CASES)
def test_depthwise_bf16_vjp_matches_the_references_cast_discipline(
        n, c, h, w, cb, s, pad, dil, act, res, gap):
    x, wt, b, r, sp = _dw_operands(5, n, c, h, w, cb, s, pad, dil, res)
    args = [x, wt, b] + ([r] if res else [])
    ins = [_t(a).clone().requires_grad_() for a in args]
    got = dwk.depthwise_conv2d_blocked(ins[0], ins[1], ins[2], s, pad, act,
                                       residual=ins[3] if res else None,
                                       gap=gap, dilation=dil,
                                       precision="bf16")
    ct = np.random.default_rng(6).normal(size=got.shape).astype(np.float32)
    got.backward(_t(ct).to(got.dtype))
    dx, dw, db, dres, dz = _dw_reference_vjp(x, wt, b, r, sp, s, pad, dil,
                                             act, gap, ct)
    assert all(t.grad.dtype == torch.float32 for t in ins)
    _bf16_close(ins[0].grad.numpy(), dx, "dx")
    xa = torch.from_numpy(_bf16_np(x)).double().abs()
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        xa, torch.from_numpy(dz).double().abs(), 3, 3, s, pad, with_db=True,
        groups=c, dilation=dil)
    _wgrad_close(ins[1].grad.numpy(), dw, abs_dw.numpy(), "dw")
    _wgrad_close(ins[2].grad.numpy(), db, abs_db.numpy(), "db")
    if res:
        np.testing.assert_array_equal(ins[3].grad.numpy(), dres)


def test_depthwise_bf16_dgrad_rounds_dz_before_the_taps():
    """dz = g * act'(z) is rounded to bf16 before any tap reads it (the
    reference's ``cotangent_prologue``): the plain bf16 dgrad equals the
    linear dgrad of that rounded dz, bit for bit."""
    x, wt, b, _, sp = _dw_operands(7, 2, 16, 10, 10, 8, 2, "SAME", 1, False)
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.normal(size=(2, 2, sp.ho, sp.wo, 8))
                         .astype(np.float32)).to(BF)
    g = torch.from_numpy(rng.normal(size=z.shape).astype(np.float32)).to(BF)
    wq = _t(wt).to(BF)
    got = dwk.depthwise_dgrad(g, wq, (10, 10), 2, "SAME", z, "gelu",
                              precision="bf16")
    dz = cotangent_prologue(g, z, "gelu")
    assert dz.dtype == BF
    want = dwk.depthwise_dgrad(dz, wq, (10, 10), 2, "SAME", None, None,
                               precision="bf16")
    assert got.dtype == BF
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the slice as a whole: a narrow separable CNN, one bf16 step
# ---------------------------------------------------------------------------

def _jax_separable():
    blocks = tuple(jconv.DepthwiseSeparableBlock(ci, co, stride=s,
                                                 padding="SAME",
                                                 activation="relu", lane=8)
                   for ci, co, s in ((8, 16, 1), (16, 32, 2)))
    return jconv.BlockedCNN(convs=blocks, n_classes=N_CLASSES)


def _tree(jmodel, seed):
    rng = np.random.default_rng(seed)

    def draw(name, spec):
        if isinstance(spec, dict):
            return {k: draw(k, v) for k, v in spec.items()}
        shape = spec.shape
        if name == "b":
            return (0.05 * rng.normal(size=shape)).astype(np.float32)
        fan_in = np.prod(shape[1:5]) if name == "w" else shape[0]
        return (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)

    return {k: draw(k, v) for k, v in jmodel.specs().items()}


def _flat_grads(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        name = "head" if keys == ["head"] else \
            "convs." + keys[0][4:] + "." + ".".join(keys[1:])
        out[name] = np.asarray(leaf, np.float32)
    return out


def _port_step(tree, batch, precision):
    model = separable_model("cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    loss, _ = make_loss_fn(model, ConvContext(precision=precision))(
        {k: _t(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def test_narrow_separable_bf16_step_matches_the_jax_model_under_bf16():
    jmodel = _jax_separable()
    tree = _tree(jmodel, seed=21)
    xs, ys = make_batch(np.random.default_rng(22), n=8)
    batch = {"images": xs, "targets": ys.astype(np.int32)}
    loss_j = jax_loss_fn(jmodel, None, TrainSettings(
        context=JConvContext(impl="jnp", precision="bf16")))
    (jl, _), jg = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = _flat_grads(jg)
    before = {k: v for mod in (pwk, dwk, dck) for k, v in mod.LAUNCHES.items()}
    loss, grads = _port_step(tree, batch, "bf16")
    assert {k: v for mod in (pwk, dwk, dck)
            for k, v in mod.LAUNCHES.items()} == before
    _, f32_grads = _port_step(tree, batch, "f32")
    assert abs(loss - float(jl)) <= PARITY_TOL_BF16 * abs(float(jl))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name       # the f32 masters' grads
        g, f32 = g.numpy(), f32_grads[name].numpy()
        noise = np.abs(g - f32).max() / np.abs(f32).max()
        err = np.abs(g - want[name]).max() / np.abs(want[name]).max()
        assert err <= max(BF16_TOL, 2 * noise), (name, err, noise)


# ---------------------------------------------------------------------------
# policy plumbing and refusals
# ---------------------------------------------------------------------------

def _pw_call(x, w, b, r, precision):
    return pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", "gelu",
                                        residual=r, precision=precision)


def _dw_call(x, w, b, r, precision):
    return dwk.depthwise_conv2d_blocked(x, w, b, 1, "SAME", "gelu",
                                        residual=r, precision=precision)


FAMILIES = {
    "pointwise": ((2, 1, 6, 6, 8), (2, 1, 1, 1, 8, 8), (2, 8),
                  (2, 2, 6, 6, 8), _pw_call),
    "depthwise": ((2, 1, 6, 6, 8), (1, 1, 3, 3, 1, 8), (1, 8),
                  (2, 1, 6, 6, 8), _dw_call),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_training_saves_bf16_operands_and_returns_master_dtypes(family):
    xs, ws, bs, rs, call = FAMILIES[family]
    rng = np.random.default_rng(9)
    x, w, r = (torch.from_numpy(rng.normal(size=s).astype(np.float32) / 3)
               .requires_grad_() for s in (xs, ws, rs))
    b = torch.zeros(bs, requires_grad=True)
    out = call(x, w, b, r, "bf16")
    assert out.dtype == BF
    assert [t.dtype for t in out.grad_fn.saved_tensors] == [BF] * 3
    out.float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == r.grad.dtype \
        == torch.float32
    # the residual's cotangent is the bf16 g, up-cast
    np.testing.assert_array_equal(r.grad.numpy(), np.ones(r.shape))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp16_training_is_refused(family):
    xs, ws, bs, rs, call = FAMILIES[family]
    w = torch.zeros(ws, requires_grad=True)
    fp16 = Precision(operand="float16", residual="float16")
    with pytest.raises(NotImplementedError, match="f32 policy and BF16"):
        call(torch.zeros(xs), w, None, None, fp16)


def test_cpu_tensors_never_reach_a_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU tensor reached the build of {name}")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(dck, "library", refuse)
    gen = torch.Generator().manual_seed(3)
    block = DepthwiseSeparableBlock(8, 16, stride=2, lane=8, device="cpu",
                                    generator=gen)
    x = torch.randn((2, 1, 9, 9, 8), generator=gen)
    ctx = ConvContext(precision="bf16")
    out = block(x, context=ctx)
    assert out.dtype == BF
    out.float().sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in block.parameters())
    with torch.no_grad():
        assert block(x, context=ctx).dtype == BF


# ---------------------------------------------------------------------------
# the choosers and the memory model at 2-byte operands
# ---------------------------------------------------------------------------

def _mobilenet_legs(entry):
    """(ci, co, stride, h) of MobileNet v1's 13 blocks at ``entry``, h the
    depthwise leg's input extent."""
    h = ConvSpec.make(1, entry, entry, *MOBILENET_V1_CONV1[:2], 3, 3,
                      MOBILENET_V1_CONV1[2], "SAME").ho
    out = []
    for ci, co, s in MOBILENET_V1_BLOCKS:
        out.append((ci, co, s, h))
        h = -(-h // s)
    return out


@pytest.mark.parametrize("entry", [160, 224])
def test_choosers_at_two_byte_operands_at_mobilenets_legs(entry):
    for ci, co, s, h in _mobilenet_legs(entry):
        ho = -(-h // s)
        cb, cob = min(ci, 128), min(co, 128)
        for n, gap in ((8, False), (8, (ci, co, ho) == (1024, 1024, 7)),
                       (32, False)):
            pw = blocking.choose_pointwise_blocking(
                n, ho * ho, ci // cb, cb, co // cob, cob, gap=gap,
                op_bytes=2)
            assert pw.chunk % 16 == 0 and \
                blocking.pointwise_kpad(cb, 2) % pw.chunk == 0
            assert blocking.pointwise_smem_bytes(
                pw.rows, pw.chunk, pw.lanes, pw.wgs, gap, 2, ring=pw.ring,
                brows=pw.brows) <= blocking.H100_SXM.smem_block
            issued = blocking.pointwise_issued_macs(pw, n, ci // cb, cb,
                                                    co // cob, 2, ho * ho)
            assert issued >= n * ho * ho * ci * co
        for n in (8, 32):
            fwd = blocking.choose_depthwise_blocking(
                n, ci // cb, ho, ho, cb, 3, 3, s, op_bytes=2)
            assert blocking.depthwise_fwd_smem_bytes(
                fwd.hwin, fwd.wwin, fwd.lanes, op_bytes=2) <= \
                blocking.H100_SXM.smem_budget
            dg = blocking.choose_depthwise_dgrad_blocking(
                n, ci // cb, h, h, cb, 3, 3, s,
                pads=ConvSpec.make(n, h, h, ci, ci, 3, 3, s, "SAME",
                                   groups=ci).pads, op_bytes=2)
            assert dg.hob * dg.wob <= blocking.DW_THREAD_POSITIONS * (
                blocking.H100_SXM.threads // dg.lanes)
            wg = blocking.choose_depthwise_wgrad_blocking(
                n, ci // cb, ho, ho, cb, 3, 3, s, op_bytes=2)
            assert wg.splits >= 1 and wg.per_column % wg.splits >= 0


def test_smem_models_at_two_byte_cells():
    # a depthwise ring of bf16 cells is half the f32 one where both round
    # to whole 16 bytes; the position groups' sums stay f32
    assert blocking.depthwise_fwd_smem_bytes(6, 10, 64, op_bytes=2) * 2 == \
        blocking.depthwise_fwd_smem_bytes(6, 10, 64)
    assert blocking.depthwise_fwd_smem_bytes(3, 3, 3, gap=True,
                                             op_bytes=2) == \
        2 * 2 * 32 + 4 * (256 // 3) * 3
    assert blocking.depthwise_dgrad_smem_bytes(5, 5, 3, True, 2) == \
        2 * 2 * 2 * 80
    assert blocking.depthwise_wgrad_smem_bytes(4, 4, 2, 2, 8, 9, True,
                                               op_bytes=2) == \
        max(2 * 2 * (128 + 2 * 32), 4 * 32 * 10 * 8)
    # the pointwise tile: a 1024-byte alignment; per ring slot x's rows
    # (32 spare, 128, 32 spare) of 128 swizzled bytes and the weights
    # [chunk][N], each in whole 1024 bytes; 8 mbarriers; two f32 bias rows;
    # the GAP sums and a flag
    assert blocking.pointwise_smem_bytes(128, 64, 64, 2, True, 2, ring=2,
                                         brows=32) == \
        1024 + 2 * ((32 + 128 + 32) * 128 + 64 * 64 * 2) + 64 + 2 * 4 * 64 \
        + 4 * 4 * 2 * 64 + 16
    # a chunk of 128 is two such halves; 16 channels, 32-byte rows
    assert blocking.pointwise_smem_bytes(64, 128, 128, 1, False, 2, ring=3,
                                         brows=25) == \
        1024 + 3 * (2 * 15 * 1024 + 128 * 128 * 2) + 64 + 2 * 4 * 128
    assert blocking.pointwise_smem_bytes(64, 16, 8, 1, False, 2, ring=4,
                                         brows=32) == \
        1024 + 4 * (4 * 1024 + 1024) + 64 + 2 * 4 * 8
    with pytest.raises(ValueError, match="4- or 2-byte"):
        blocking.pointwise_smem_bytes(64, 16, 8, 1, op_bytes=1)


def test_memory_model_splits_mobilenets_bf16_training_bytes():
    """``bytes_precision_split`` at MobileNet's legs: the depthwise leg's
    weights are 9 C (one input channel a group), and every role but the
    f32 masters halves under BF16."""
    n = 32
    for ci, co, s, h in _mobilenet_legs(224):
        dw = mm.ConvShape("dw", n, h, h, ci, ci, 3, 3, s, "SAME", groups=ci)
        ho = dw.ho
        pw = mm.ConvShape("pw", n, ho, ho, ci, co, 1, 1, 1, "VALID")
        for shape, w in ((dw, 9 * ci), (pw, ci * co)):
            f32 = mm.bytes_precision_split(shape, "f32")
            bf = mm.bytes_precision_split(shape, "bf16")
            x = n * shape.hi * shape.wi * shape.ci
            y = n * shape.ho * shape.wo * shape.co
            assert bf["params_master"] == f32["params_master"] == 4 * w
            assert bf["params_compute"] == 2 * w and f32["params_compute"] == 0
            assert bf["activations"] * 2 == f32["activations"] == 4 * (x + y)
            assert bf["vjp_residual"] * 2 == f32["vjp_residual"]
            assert bf["total"] + bf["saved"] == f32["total"]


def test_parts_ab_edits_apply_to_the_sources():
    """``launch/separable_parts_ab.py`` builds its probes by editing copies
    of the sources: every edit must still find its text."""
    from repro_torch.kernels._build import CSRC
    from repro_torch.launch import separable_parts_ab as ab
    for source, variants in (("conv2d_depthwise", ab.PARTS),
                             ("direct_conv2d_bwd", ab.DGRAD_PARTS),
                             ("conv2d_pointwise", ab.PW_BF16_PARTS)):
        text = (CSRC / f"{source}.cu").read_text()
        for name, edits in variants.items():
            for old, _ in edits:
                assert old in text, (source, name, old)


def test_pointwise_tiles_ab_times_the_bf16_choosers_tiles_first():
    from repro_torch.launch import pointwise_tiles_ab as ab
    for ci, co, h in ab.pointwise_legs():
        cib, cob = min(ci, 128), min(co, 128)
        gap = (ci, co) == (1024, 1024)
        args = (8, h * h, ci // cib, cib, co // cob, cob)
        tiles = ab.tile_candidates(ci, co, h, 2)
        assert tiles[0] == blocking.choose_pointwise_blocking(
            *args, gap=gap, op_bytes=2)
        assert {t.chunk % 16 for t in tiles} == {0}
        tiles = ab.dgrad_tile_candidates(ci, co, h, 2)
        assert tiles[0] == blocking.choose_dgrad_blocking(
            32, h, h, 1, 1, 1, ci // cib, cib, cob, prologue=True,
            op_bytes=2)
