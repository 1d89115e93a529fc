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
                                               direct_conv2d_blocked,
                                               gap_finalize)

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
    pooled = gap_finalize(conv2d_common.gap_partials(out, hob, wob), 24)
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
    with pytest.raises(NotImplementedError, match="kernel zoo"):
        direct_conv_blocked(x, wt, 1, "SAME", dilation=2)


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
    with pytest.raises(ValueError):
        bias_to_blocked(torch.arange(6.0), 4)
