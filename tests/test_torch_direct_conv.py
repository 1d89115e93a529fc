"""The port's plain direct conv (the CUDA kernel's CPU counterpart) against
the JAX reference: the jnp oracle and the streamed Pallas kernel in
interpret mode.  f32 throughout, ``rtol = atol = 1e-5``: both sides sum the
same f32 products, in different orders."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.direct_conv import direct_conv_blocked as jax_direct_conv  # noqa: E402
from repro.kernels.direct_conv2d import direct_conv2d_blocked_pallas  # noqa: E402
from repro_torch.core import conv2d_common  # noqa: E402
from repro_torch.core.direct_conv import (bias_to_blocked,  # noqa: E402
                                          direct_conv_blocked, pad_blocked)
from repro_torch.kernels.direct_conv2d import (LAUNCHES,  # noqa: E402
                                               _require,
                                               direct_conv2d_blocked)
from repro_torch.nn.conv import BlockedConv2D  # noqa: E402
from repro_torch.core.precision import Precision  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _operands(seed, n, ci, co, h, w, cib, cob, stride, residual):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
          / np.sqrt(9 * ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    ho, wo = -(-h // stride), -(-w // stride)
    r = (rng.normal(size=(n, co // cob, ho, wo, cob)).astype(np.float32)
         if residual else None)
    return x, wt, b, r


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (n, ci, co, h, w, cib, cob, stride, activation, residual, gap)
CASES = [
    (2, 4, 8, 8, 8, 4, 8, 1, "relu", False, False),
    (2, 4, 8, 8, 8, 4, 8, 2, "relu", False, False),
    (2, 8, 8, 9, 7, 4, 4, 2, "gelu", False, False),
    (2, 4, 4, 6, 6, 2, 4, 1, None, False, False),
    (2, 8, 16, 8, 8, 8, 8, 1, "gelu", True, False),
    (2, 8, 16, 10, 10, 4, 16, 2, "relu", True, False),
    (2, 8, 8, 8, 8, 8, 8, 1, "relu", False, True),
    (2, 8, 16, 12, 12, 8, 8, 2, "gelu", True, True),
    (2, 3, 8, 16, 16, 3, 8, 1, "relu", False, False),        # Cib = 3
    (2, 3, 16, 32, 32, 3, 16, 2, "relu", False, True),       # Cib = 3, gap
]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,act,res,gap", CASES)
def test_plain_conv_matches_jax_oracle(n, ci, co, h, w, cib, cob, stride,
                                       act, res, gap):
    x, wt, b, r = _operands(0, n, ci, co, h, w, cib, cob, stride, res)
    want = np.asarray(jax_direct_conv(
        _j(x), _j(wt), stride, "SAME", _j(b), act, residual=_j(r), gap=gap))
    before = dict(LAUNCHES)
    got = direct_conv2d_blocked(_t(x), _t(wt), _t(b), stride, "SAME", act,
                                residual=_t(r), gap=gap)
    assert LAUNCHES == before          # the CPU runs the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("stride,act,res,gap", [
    (1, "relu", False, True), (2, "gelu", True, False),
    (1, None, True, True)])
def test_plain_conv_matches_streamed_pallas_interpret(stride, act, res, gap):
    x, wt, b, r = _operands(1, 2, 8, 8, 8, 8, 4, 8, stride, res)
    want = np.asarray(direct_conv2d_blocked_pallas(
        _j(x), _j(wt), _j(b), stride=stride, padding="SAME", activation=act,
        stream=True, interpret=True, residual=_j(r), gap=gap))
    got = direct_conv2d_blocked(_t(x), _t(wt), _t(b), stride, "SAME", act,
                                residual=_t(r), gap=gap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_epilogue_order_is_bias_activation_residual():
    acc = torch.tensor([-2.0, 1.0]).reshape(1, 1, 1, 2, 1)
    bias = torch.tensor([[0.5]])
    res = torch.full((1, 1, 1, 2, 1), -1.0)
    out = conv2d_common.epilogue(acc, bias, "relu", res, torch.float32)
    # relu(-2 + .5) - 1 = -1 ; relu(1 + .5) - 1 = .5
    np.testing.assert_array_equal(out.flatten().numpy(), [-1.0, 0.5])
    with pytest.raises(TypeError, match="f32"):
        conv2d_common.epilogue(acc.double(), None, None, None, torch.float32)


def test_gelu_is_the_tanh_approximation():
    import jax
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = conv2d_common.apply_activation(torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        conv2d_common.apply_activation(torch.from_numpy(x), "swish")


@pytest.mark.parametrize("hob,wob", [(1, 1), (2, 3), (4, 6), (1, 6)])
def test_gap_partials_any_tiling_is_the_mean(hob, wob):
    out = torch.randn(2, 3, 4, 6, 5, generator=torch.Generator().manual_seed(0))
    pooled = conv2d_common.gap_finalize(
        conv2d_common.gap_partials(out, hob, wob), 24)
    np.testing.assert_allclose(pooled.numpy(),
                               out.mean(dim=(2, 3)).reshape(2, 15).numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        conv2d_common.gap_partials(out, 3, 6)


def test_tap_windows_are_views():
    xp = torch.zeros(1, 1, 6, 6, 2)
    wins = list(conv2d_common.tap_windows(xp, 3, 3, 2, 2, stride=2))
    assert len(wins) == 9
    for (_, _), v in wins:
        assert v.shape == (1, 1, 2, 2, 2)
        assert v.data_ptr() >= xp.data_ptr() and v._base is xp


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wt, b, _ = _operands(2, 1, 4, 8, 6, 6, 4, 8, 1, False)
    x, wt, b = _t(x), _t(wt), _t(b)
    with pytest.raises(ValueError, match="unknown activation"):
        direct_conv2d_blocked(x, wt, b, 1, "SAME", "swish")
    with pytest.raises(ValueError, match="bias shape"):
        direct_conv2d_blocked(x, wt, b.reshape(-1), 1, "SAME")
    with pytest.raises(ValueError, match="residual shape"):
        direct_conv2d_blocked(x, wt, b, 1, "SAME",
                              residual=torch.zeros(1, 1, 5, 6, 8))
    with pytest.raises(ValueError, match="input blocks"):
        direct_conv2d_blocked(x, wt[:, :, :, :, :2], b, 1, "SAME")
    with pytest.raises(ValueError, match="expected x"):
        direct_conv2d_blocked(x[0], wt, b, 1, "SAME")
    with pytest.raises(NotImplementedError, match="kernel zoo"):
        direct_conv_blocked(x, wt, 1, "SAME", groups=2)
    # the plain conv computes dilation (the depthwise kernels take it); the
    # dense kernels do not, so a dilated dense layer is refused
    with pytest.raises(NotImplementedError, match="kernel zoo"):
        BlockedConv2D(4, 8, dilation=2, device="cpu")


def test_float4_operands_must_be_16_byte_aligned():
    # the CUDA path's operand check; a contiguous view one float into its
    # storage is contiguous but would fault under the kernel's float4 loads
    base = torch.zeros(4 * 8 + 4)
    view = base[1:33].view(1, 1, 4, 1, 8)
    assert view.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        _require(view, "x", view.device, vector_loads=True)
    _require(view, "residual", view.device)           # scalar loads: fine
    _require(base[4:].view(1, 1, 4, 1, 8), "x", view.device,
             vector_loads=True)


def test_bf16_policy_casts_operands_and_sums_in_f32():
    x, wt, b, _ = _operands(3, 2, 4, 8, 6, 6, 4, 8, 1, False)
    got = direct_conv_blocked(_t(x), _t(wt), 1, "SAME", _t(b), "relu",
                              precision="bf16")
    assert got.dtype == torch.bfloat16
    xq = torch.from_numpy(x).bfloat16().float()
    wq = torch.from_numpy(wt).bfloat16().float()
    want = direct_conv_blocked(xq, wq, 1, "SAME", _t(b), "relu")
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.bfloat16().float().numpy())


def test_pad_and_bias_helpers():
    x = torch.ones(1, 1, 2, 3, 2)
    p = pad_blocked(x, (0, 1), (2, 0))
    assert p.shape == (1, 1, 3, 5, 2)
    assert p[0, 0, 2].abs().sum() == 0 and p[0, 0, :, :2].abs().sum() == 0
    assert pad_blocked(x, (0, 0), (0, 0)) is x
    assert bias_to_blocked(torch.arange(8.0), 4).shape == (2, 4)
    # Co not a pencil multiple: zero-padded, as the reference's pad-to-block
    # bias (and as pad-to-block maps need)
    padded = bias_to_blocked(torch.arange(6.0), 4)
    assert padded.shape == (2, 4)
    assert padded.reshape(-1).tolist() == [0, 1, 2, 3, 4, 5, 0, 0]


# ---------------------------------------------------------------------------
# the backward: plain dgrad / wgrad and the autograd path against jax.vjp of
# the reference's direct_conv_blocked.  f32 on both sides; each gradient
# sums at most N*Ho*Wo = 512 (wgrad) or 9*Co = 144 (dgrad) products of O(1)
# terms, so the two orders of summation stay within rtol = atol = 1e-5.
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.kernels.conv2d_common import (  # noqa: E402
    cotangent_prologue as jax_prologue)
from repro.nn.conv import (  # noqa: E402
    blocked_global_avg_pool as jax_gap)
from repro_torch.core.blocking import dgrad_extents  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_dgrad_blocked, direct_conv_preactivation,
    direct_conv_wgrad_blocked)
from repro_torch.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_dgrad, direct_conv2d_wgrad)

BWD_TOL = {"rtol": 1e-5, "atol": 1e-5}

# (n, ci, co, h, w, cib, cob, stride, padding, activation, residual, gap)
BWD_CASES = [
    (2, 4, 8, 8, 8, 4, 8, 1, "SAME", "relu", False, False),
    (2, 4, 8, 8, 8, 4, 8, 2, "SAME", "relu", False, False),   # pads (0, 1)
    (2, 8, 8, 9, 7, 4, 4, 2, "SAME", "gelu", False, False),   # odd extents
    (2, 4, 4, 6, 6, 2, 4, 1, "SAME", None, False, False),
    (2, 8, 16, 8, 8, 8, 8, 1, "SAME", "gelu", True, False),
    (2, 8, 16, 10, 10, 4, 16, 2, "SAME", "relu", True, True),
    (2, 3, 8, 16, 16, 3, 8, 2, "SAME", "relu", False, True),  # Cib = 3
    (2, 3, 8, 11, 11, 3, 8, 2, "SAME", "gelu", True, False),  # Cib = 3
    (2, 4, 8, 10, 10, 4, 8, 2, "VALID", "relu", False, False),  # past E
    (1, 4, 4, 7, 9, 4, 4, 1, ((2, 0), (0, 1)), "gelu", False, False),
]


def _jax_vjp(x, wt, b, r, stride, padding, act, gap):
    """-> (output, cotangent -> [dx, dw, db(, dres)]) of the reference."""
    def f(x_, w_, b_, *r_):
        return jax_direct_conv(x_, w_, stride, padding, b_, act,
                               residual=r_[0] if r_ else None, gap=gap)
    args = [_j(x), _j(wt), _j(b)] + ([_j(r)] if r is not None else [])
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), lambda ct: [np.asarray(t) for t in vjp(_j(ct))]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act,res,gap",
                         BWD_CASES)
def test_autograd_path_matches_jax_vjp(n, ci, co, h, w, cib, cob, stride,
                                       padding, act, res, gap):
    x, wt, b, r = _operands(4, n, ci, co, h, w, cib, cob, stride, res)
    if padding == "VALID":
        r = None
    out_j, vjp = _jax_vjp(x, wt, b, r, stride, padding, act, gap)
    ct = np.random.default_rng(5).normal(size=out_j.shape).astype(np.float32)
    grads_j = vjp(ct)
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (x, wt, b) + ((r,) if r is not None else ())]
    before = dict(LAUNCHES)
    out = direct_conv2d_blocked(ins[0], ins[1], ins[2], stride, padding, act,
                                residual=ins[3] if r is not None else None,
                                gap=gap)
    out.backward(torch.from_numpy(ct))
    assert LAUNCHES == before            # the CPU runs the plain versions
    np.testing.assert_allclose(out.detach().numpy(), out_j, **BWD_TOL)
    for name, t, want in zip(("dx", "dw", "db", "dres"), ins, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("case", [0, 1, 2, 6, 8, 9])
@pytest.mark.parametrize("prologue", [False, True])
def test_plain_dgrad_and_wgrad_match_jax_vjp(case, prologue):
    n, ci, co, h, w, cib, cob, stride, padding, act, _, _ = BWD_CASES[case]
    act = act if prologue else None
    x, wt, b, _ = _operands(6, n, ci, co, h, w, cib, cob, stride, False)
    z = direct_conv_preactivation(_t(x), _t(wt), stride, padding, _t(b))
    g = np.random.default_rng(7).normal(size=tuple(z.shape)).astype(
        np.float32)
    dx_j, dw_j, db_j = _jax_vjp(x, wt, b, None, stride, padding, act,
                                False)[1](g)
    zz = z if prologue else None
    dx = direct_conv2d_dgrad(_t(g), _t(wt), (h, w), stride, padding, zz, act)
    dw, db = direct_conv2d_wgrad(_t(x), _t(g), 3, 3, stride, padding, zz, act,
                                 with_db=True)
    assert dx.shape == x.shape and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), dx_j, **BWD_TOL)
    np.testing.assert_allclose(dw.numpy(), dw_j, **BWD_TOL)
    np.testing.assert_allclose(db.numpy(), db_j, **BWD_TOL)
    dw_nodb, none = direct_conv_wgrad_blocked(_t(x), _t(g), 3, 3, stride,
                                              padding, zz, act)
    assert none is None and torch.equal(dw_nodb, dw)


@pytest.mark.parametrize("stride", [1, 2])
def test_autograd_path_matches_streamed_pallas_grad(stride):
    # the Pallas custom VJP (dgrad + wgrad kernels, streamed route) in
    # interpret mode: [2, 2, 8, 8, 4] with a 3x3 Cb = 4 filter, relu
    x, wt, b, _ = _operands(8, 2, 8, 8, 8, 8, 4, 4, stride, False)
    ct = np.random.default_rng(9).normal(
        size=(2, 2, 8 // stride, 8 // stride, 4)).astype(np.float32)

    def loss(x_, w_, b_):
        out = direct_conv2d_blocked_pallas(x_, w_, b_, stride=stride,
                                           padding="SAME", activation="relu",
                                           stream=True, interpret=True)
        return (out * _j(ct)).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(_j(x), _j(wt), _j(b))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, wt, b)]
    out = direct_conv2d_blocked(*ins[:3], stride, "SAME", "relu")
    (out * torch.from_numpy(ct)).sum().backward()
    for t, wj in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wj), **BWD_TOL)


@pytest.mark.parametrize("stride,act,res,gap,cib", [
    (1, "relu", False, False, 4), (2, "gelu", True, False, 4),
    (2, "relu", True, True, 3), (1, None, False, True, 2),
    (2, "gelu", False, True, 3)])
def test_autograd_function_gradcheck_f64(stride, act, res, gap, cib):
    rng = np.random.default_rng(10)

    def f64(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.normal(size=shape)).requires_grad_()
    x = f64(2, 2, 7, 6, cib)
    w = f64(2, 2, 3, 3, cib, 4, scale=0.3)
    b = f64(2, 4)
    ho, wo = -(-7 // stride), -(-6 // stride)
    ins = (x, w, b) + ((f64(2, 2, ho, wo, 4),) if res else ())

    def fn(x_, w_, b_, *r_):
        return direct_conv2d_blocked(x_, w_, b_, stride, "SAME", act,
                                     residual=r_[0] if r_ else None, gap=gap,
                                     precision=None)
    assert torch.autograd.gradcheck(fn, ins)


def test_first_layer_skips_dgrad_when_the_input_needs_no_grad(monkeypatch):
    import repro_torch.kernels.direct_conv2d as kernels
    calls = []
    dgrad = kernels.direct_conv2d_dgrad
    monkeypatch.setattr(kernels, "direct_conv2d_dgrad",
                        lambda *a, **k: calls.append(1) or dgrad(*a, **k))
    x, wt, b, _ = _operands(11, 2, 3, 8, 8, 8, 3, 8, 1, False)
    w = torch.from_numpy(wt).requires_grad_()
    direct_conv2d_blocked(_t(x), w, _t(b), 1, "SAME", "relu").sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape and not calls
    xg = torch.from_numpy(x).requires_grad_()
    direct_conv2d_blocked(xg, w, _t(b), 1, "SAME", "relu").sum().backward()
    assert len(calls) == 1 and xg.grad.shape == xg.shape


@pytest.mark.parametrize("act", ["relu", "gelu", None, "linear"])
def test_cotangent_prologue_matches_jax(act):
    z = np.linspace(-4, 4, 97).astype(np.float32)
    z[48] = 0.0                                   # relu'(0) = 0
    g = np.random.default_rng(12).normal(size=97).astype(np.float32)
    want = np.asarray(jax_prologue(_j(g), _j(z), act))
    got = conv2d_common.cotangent_prologue(_t(g), _t(z), act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert conv2d_common.cotangent_prologue(_t(g), None, "relu") is not None


def test_dgrad_rows_past_the_extents_are_exactly_zero():
    # VALID, stride 2, 10 rows: the forward reads rows 0..8 only
    assert dgrad_extents(4, 4, 3, 3, 2) == (9, 9)
    g = torch.randn(1, 1, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    w = torch.randn(1, 1, 3, 3, 4, 4)
    dx = direct_conv_dgrad_blocked(g, w, (10, 10), 2, "VALID")
    assert (dx[:, :, 9] == 0).all() and (dx[:, :, :, 9] == 0).all()
    assert (dx[:, :, :9, :9] != 0).any()


def test_blocked_global_avg_pool_matches_jax():
    x = np.random.default_rng(13).normal(size=(2, 3, 5, 4, 8)).astype(
        np.float32)
    np.testing.assert_allclose(
        conv2d_common.blocked_global_avg_pool(_t(x)).numpy(),
        np.asarray(jax_gap(_j(x))), rtol=1e-6, atol=1e-7)


def test_wgrad_reduce_adds_rows_in_order_and_checks_shapes():
    parts = torch.randn(5, 7, generator=torch.Generator().manual_seed(1))
    want = (((parts[0] + parts[1]) + parts[2]) + parts[3]) + parts[4]
    assert torch.equal(conv2d_common.wgrad_reduce(parts), want)
    with pytest.raises(ValueError, match="splits"):
        conv2d_common.wgrad_reduce(parts[0])


def test_backward_wrappers_reject_mismatched_operands():
    x, wt, b, _ = _operands(14, 1, 4, 8, 6, 6, 4, 8, 1, False)
    g = torch.zeros(1, 1, 6, 6, 8)
    with pytest.raises(ValueError, match="unknown activation"):
        direct_conv2d_dgrad(g, _t(wt), (6, 6), 1, "SAME", g, "swish")
    with pytest.raises(ValueError, match="pre-activation"):
        direct_conv2d_dgrad(g, _t(wt), (6, 6), 1, "SAME", None, "relu")
    with pytest.raises(ValueError, match="cotangent shape"):
        direct_conv2d_dgrad(g, _t(wt), (7, 6), 1, "VALID")
    with pytest.raises(ValueError, match="cotangent shape"):
        direct_conv2d_wgrad(_t(x), g[:, :, :5], 3, 3, 1, "SAME")
    with pytest.raises(NotImplementedError, match="f32 policy"):
        direct_conv2d_blocked(_t(x), _t(wt).requires_grad_(), _t(b), 1,
                              "SAME", precision=Precision(operand="float16"))
