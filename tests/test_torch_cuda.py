"""The CUDA forward kernel against its plain version, on the card.

Marked ``gpu``; each test skips (inside the fixture) when no CUDA device is
visible.  On a machine with one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.direct_conv import direct_conv_blocked  # noqa: E402
from repro_torch.kernels.direct_conv2d import (LAUNCHES,  # noqa: E402
                                               direct_conv2d_blocked,
                                               reset_launches)

pytestmark = pytest.mark.gpu

# f32 kernel vs f32 plain version: the same products in another order
TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(dev, n, ci, co, h, cib, cob, stride, residual, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, ci // cib, h, h, cib), device=dev, generator=g)
    w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=dev,
                    generator=g) / (9 * ci) ** 0.5
    b = torch.randn((co // cob, cob), device=dev, generator=g)
    ho = -(-h // stride)
    r = (torch.randn((n, co // cob, ho, ho, cob), device=dev, generator=g)
         if residual else None)
    return x, w, b, r


# (n, ci, co, h, cib, cob, stride, activation, residual, gap)
CASES = [
    (2, 3, 64, 17, 3, 64, 1, "relu", False, False),
    (2, 3, 64, 20, 3, 64, 2, "gelu", True, False),
    (2, 64, 128, 28, 64, 128, 1, "gelu", True, True),
    (3, 24, 12, 9, 8, 12, 2, None, False, True),      # Cob not a multiple of 8
    (1, 256, 256, 14, 128, 128, 2, "relu", True, True),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,res,gap", CASES)
def test_kernel_matches_plain_version(cuda, n, ci, co, h, cib, cob, stride,
                                      act, res, gap):
    x, w, b, r = _operands(cuda, n, ci, co, h, cib, cob, stride, res)
    reset_launches()
    with torch.no_grad():
        got = direct_conv2d_blocked(x, w, b, stride, "SAME", act,
                                    residual=r, gap=gap)
        again = direct_conv2d_blocked(x, w, b, stride, "SAME", act,
                                      residual=r, gap=gap)
        want = direct_conv_blocked(x, w, stride, "SAME", b, act, residual=r,
                                   gap=gap)
    torch.cuda.synchronize()
    assert LAUNCHES == {"direct_conv2d_fwd": 2, "gap_finalize": 2 * gap}
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)                  # no atomics: same bits


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w, b, _ = _operands(cuda, 1, 8, 8, 6, 8, 8, 1, False)
    with pytest.raises(RuntimeError, match="inference-only"):
        direct_conv2d_blocked(x, w.requires_grad_(), b, 1, "SAME")
    w = w.detach()
    with pytest.raises(NotImplementedError, match="f32"):
        direct_conv2d_blocked(x.bfloat16(), w.bfloat16(), None, 1, "SAME")
    with pytest.raises(NotImplementedError, match="f32 policy"):
        direct_conv2d_blocked(x, w, b, 1, "SAME", precision="bf16")
    with pytest.raises(ValueError, match="contiguous"):
        direct_conv2d_blocked(x.transpose(2, 3), w, b, 1, "SAME")
    with pytest.raises(ValueError, match="is on"):
        direct_conv2d_blocked(x, w, b.cpu(), 1, "SAME")
    offset = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x)
    offset.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        direct_conv2d_blocked(offset, w, b, 1, "SAME")
