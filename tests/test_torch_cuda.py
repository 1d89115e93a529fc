"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips (inside the fixture) when no CUDA device is
visible.  On a machine with one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import conv2d_common  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_blocked, direct_conv_dgrad_blocked, direct_conv_wgrad_blocked)
from repro_torch.kernels.direct_conv2d import (LAUNCHES,  # noqa: E402
                                               cotangent_pass,
                                               direct_conv2d_blocked,
                                               direct_conv2d_dgrad,
                                               direct_conv2d_wgrad,
                                               dgrad_plans, fwd_plans,
                                               dz_partials, gap_forward,
                                               reset_launches,
                                               wgrad_bf16_probe,
                                               wgrad_partials, wgrad_plans)
from repro_torch.core.blocking import (FwdBlocking,  # noqa: E402
                                       choose_fwd_blocking,
                                       choose_stream_fwd_blocking,
                                       fwd_bf16_layout, fwd_bf16_pitch,
                                       fwd_plan)
from repro_torch.core.context import ConvContext  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.kernels import conv2d_depthwise as dwk  # noqa: E402
from repro_torch.kernels import conv2d_stream as stk  # noqa: E402
from repro_torch.kernels import conv2d_pointwise as pwk  # noqa: E402
from repro_torch.kernels import direct_conv2d as dck  # noqa: E402
from repro_torch.kernels import split_sum  # noqa: E402
from repro_torch.nn.conv import (BlockedCNN, BlockedConv2D,  # noqa: E402
                                 DepthwiseSeparableBlock)

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
    (2, 512, 512, 14, 128, 128, 1, "relu", False, True),  # conv5's 14x14
    (2, 12, 20, 23, 4, 20, 1, "gelu", True, False),    # Cob 20, ragged tiles
    (2, 8, 6, 9, 8, 6, 1, "relu", True, True),    # Cob 6: weights by cp.async
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
    assert LAUNCHES == {"direct_conv2d_fwd": 2, "direct_conv2d_fwd_bf16": 0,
                        "direct_conv2d_dgrad": 0,
                        "direct_conv2d_dgrad_bf16": 0,
                        "direct_conv2d_wgrad": 0,
                        "direct_conv2d_wgrad_bf16": 0,
                        "direct_conv2d_dz_bf16": 0}
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)                  # no atomics: same bits


# (n, ci, co, h, w, cib, cob, stride, padding)
FWD_PAD_CASES = [
    (2, 16, 24, 10, 9, 8, 24, 2, "VALID"),
    (2, 8, 16, 9, 11, 8, 16, 1, ((2, 0), (0, 1))),   # asymmetric pads
    (1, 3, 32, 30, 30, 3, 32, 2, "SAME"),            # MobileNet's conv1, Cib 3
]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding", FWD_PAD_CASES)
def test_forward_kernels_match_plain_version_at_other_pads(
        cuda, streamed, n, ci, co, h, w, cib, cob, stride, padding):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((n, ci // cib, h, w, cib), device=cuda, generator=g)
    wt = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=cuda,
                     generator=g) / (9 * ci) ** 0.5
    b = torch.randn((co // cob, cob), device=cuda, generator=g)
    stk.reset_launches()
    reset_launches()
    with torch.no_grad():
        got = direct_conv2d_blocked(x, wt, b, stride, padding, "relu",
                                    stream=streamed)
        want = direct_conv_blocked(x, wt, stride, padding, b, "relu")
    torch.cuda.synchronize()
    assert (stk.LAUNCHES["conv2d_stream_fwd"], LAUNCHES["direct_conv2d_fwd"]
            ) == ((1, 0) if streamed else (0, 1))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,res,gap", CASES)
def test_forward_kernel_plans_match_the_blocking_model(
        cuda, streamed, n, ci, co, h, cib, cob, stride, act, res, gap):
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    kernel, model = fwd_plans(x, w, stride, "SAME", gap, streamed=streamed)
    assert kernel == model
    assert kernel.function_macs == n * (-(-h // stride)) ** 2 * 9 * ci * co


# (n, ci, co, h, cib, cob, stride, activation, padding)
BWD_CASES = [
    (2, 16, 16, 9, 8, 16, 1, "relu", "SAME"),
    (2, 16, 24, 10, 16, 8, 2, "gelu", "SAME"),      # asymmetric (0, 1) pads
    (2, 3, 16, 11, 3, 16, 2, "relu", "SAME"),       # Cib = 3, odd extent
    (1, 8, 12, 10, 8, 12, 2, None, "VALID"),        # rows past the extents
    (2, 128, 128, 14, 128, 128, 1, "relu", "SAME"),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding", BWD_CASES)
def test_backward_kernels_match_plain_versions(cuda, n, ci, co, h, cib, cob,
                                               stride, act, padding):
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    # the plain conv may return a permuted layout; the kernels take
    # contiguous operands
    z = direct_conv_blocked(x, w, stride, padding).contiguous()
    g = torch.randn(z.shape, device=cuda)
    zz = None if act is None else z
    reset_launches()
    dx = direct_conv2d_dgrad(g, w, (h, h), stride, padding, zz, act)
    dw, db = direct_conv2d_wgrad(x, g, 3, 3, stride, padding, zz, act,
                                 with_db=True)
    dw2, db2 = direct_conv2d_wgrad(x, g, 3, 3, stride, padding, zz, act,
                                   with_db=True)
    torch.cuda.synchronize()
    assert LAUNCHES["direct_conv2d_dgrad"] == 1
    assert LAUNCHES["direct_conv2d_wgrad"] == 2
    want_dx = direct_conv_dgrad_blocked(g, w, (h, h), stride, padding, zz,
                                        act)
    torch.testing.assert_close(dx, want_dx, **TOL)
    # wgrad sums n*Ho*Wo products per element: compare with f64 sums
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), g.double(), 3, 3, stride, padding,
        None if zz is None else zz.double(), act, with_db=True)
    torch.testing.assert_close(dw.double(), want_dw, **TOL)
    torch.testing.assert_close(db.double(), want_db, **TOL)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)   # no atomics


# (n, ci, co, h, cib, cob, stride, activation, padding): the phase-split
# tensor-core dgrads (csrc/dgrad_tile.cuh) at strides 1 and 2, odd extents,
# Cib = 3, 64 and 128, relu, gelu and linear prologues, rows past the dgrad
# extents (VALID), Cob % 8 != 0
DGRAD_CASES = [
    (2, 64, 64, 14, 64, 64, 1, "relu", "SAME"),
    (2, 64, 128, 14, 64, 128, 2, "relu", "SAME"),
    (2, 128, 128, 9, 128, 128, 1, "gelu", "SAME"),    # odd hi
    (2, 128, 256, 11, 128, 128, 2, None, "SAME"),     # odd hi, stride 2
    (2, 256, 128, 7, 128, 128, 1, "relu", "SAME"),    # two Ci blocks
    (2, 3, 64, 20, 3, 64, 2, "gelu", "SAME"),         # Cib = 3
    (1, 8, 12, 10, 8, 12, 2, None, "VALID"),          # rows past the extents
    (3, 16, 24, 9, 16, 24, 2, "relu", "VALID"),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         DGRAD_CASES)
def test_dgrad_kernels_match_plain_version_and_each_other(
        cuda, n, ci, co, h, cib, cob, stride, act, padding):
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    z = direct_conv_blocked(x, w, stride, padding).contiguous()
    g = torch.randn(z.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    zz = None if act is None else z
    want = direct_conv_dgrad_blocked(g, w, (h, h), stride, padding, zz, act)
    reset_launches()
    stk.reset_launches()
    runs = {route: [direct_conv2d_dgrad(g, w, (h, h), stride, padding, zz,
                                        act, stream=route)
                    for _ in range(2)] for route in (False, True)}
    torch.cuda.synchronize()
    assert LAUNCHES["direct_conv2d_dgrad"] == 2
    assert stk.LAUNCHES["conv2d_stream_dgrad"] == 2
    for route, (dx, again) in runs.items():
        torch.testing.assert_close(dx, want, **TOL)
        assert torch.equal(dx, again)          # no atomics: the same bits
        if padding == "VALID":
            # rows and columns the forward never read come out exactly 0
            ext = (h - 3) // stride * stride + 3
            assert (dx[:, :, ext:] == 0).all() and \
                (dx[:, :, :, ext:] == 0).all()
    torch.testing.assert_close(runs[True][0], runs[False][0], **TOL)


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         DGRAD_CASES)
def test_dgrad_kernel_plans_match_the_blocking_model(
        cuda, n, ci, co, h, cib, cob, stride, act, padding):
    # the kernels' own count of a launch (tiles, MACs by phase, tensor-core
    # MACs issued; dgrad_tile::plan) against core.blocking.dgrad_plan
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    z = direct_conv_blocked(x, w, stride, padding).contiguous()
    g = torch.randn(z.shape, device=cuda)
    zz = None if act is None else z
    for streamed in (False, True):
        kernel, model = dgrad_plans(g, w, (h, h), stride, padding, zz, act,
                                    streamed=streamed)
        assert kernel == model
        assert kernel.issued_macs >= 3 * kernel.function_macs > 0


# (n, ci, co, h, cib, cob, stride, grids): Cob % 4 != 0, where TMA cannot
# stride g, z and w and the producer copies by cp.async; Cob 125 is Co =
# 1000's; `grids` the launches of one call
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,grids", [
    (1, 8, 6, 8, 8, 6, 1, 1),
    (2, 16, 12, 11, 8, 6, 2, 1),
    (2, 64, 250, 14, 64, 125, 1, 1),
    (1, 128, 125, 15, 128, 125, 2, 1),
    # K = 9 x 8 x 128 past 9 x 512: a launch a Co block
    (1, 64, 1000, 10, 64, 125, 1, 8),
])
def test_dgrad_kernels_take_a_cob_not_a_multiple_of_4(cuda, n, ci, co, h,
                                                      cib, cob, stride,
                                                      grids):
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    z = direct_conv_blocked(x, w, stride, "SAME").contiguous()
    g = torch.randn(z.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    want = direct_conv_dgrad_blocked(g, w, (h, h), stride, "SAME", z, "relu")
    reset_launches()
    stk.reset_launches()
    for route in (False, True):
        dx = direct_conv2d_dgrad(g, w, (h, h), stride, "SAME", z, "relu",
                                 stream=route)
        again = direct_conv2d_dgrad(g, w, (h, h), stride, "SAME", z, "relu",
                                    stream=route)
        torch.cuda.synchronize()
        torch.testing.assert_close(dx, want, **TOL)
        assert torch.equal(dx, again)
    assert LAUNCHES["direct_conv2d_dgrad"] == 2 * grids
    assert stk.LAUNCHES["conv2d_stream_dgrad"] == 2 * grids


def test_dgrad_kernels_run_from_a_fresh_thread(cuda):
    # autograd runs a backward on a thread of its own: the kernels' tensor
    # maps must encode on a thread where the device's context is not yet
    # current
    import threading
    x, w, _, _ = _operands(cuda, 2, 3, 64, 20, 3, 64, 2, False)
    z = direct_conv_blocked(x, w, 2, "SAME").contiguous()
    g = torch.randn(z.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    want = direct_conv_dgrad_blocked(g, w, (20, 20), 2, "SAME", z, "gelu")
    out = {}

    def run():
        try:
            for route in (False, True):
                out[route] = direct_conv2d_dgrad(g, w, (20, 20), 2, "SAME", z,
                                                 "gelu", stream=route)
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 - re-raised below
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in out, out.get("error")
    for route in (False, True):
        torch.testing.assert_close(out[route], want, **TOL)


# (n, ci, co, h, cib, cob, stride, activation, padding): the tensor-core
# wgrads (csrc/wgrad_tile.cuh) at test_backward_kernels_match_plain_versions'
# shapes, plus Cob = 12 and 6 (g and z by 4-byte copies), two Ci blocks and
# two m-tiles
WGRAD_CASES = BWD_CASES + [
    (2, 16, 12, 9, 16, 12, 1, "gelu", "SAME"),
    (2, 8, 6, 9, 8, 6, 1, "relu", "SAME"),
    (2, 256, 128, 7, 128, 128, 2, "relu", "SAME"),
    (3, 3, 64, 20, 3, 64, 2, None, "SAME"),
]
# |kernel - f64| <= WGRAD_REL * sum |x * dz| (chip_smoke.py's bound)
WGRAD_REL = 1e-5


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         WGRAD_CASES)
def test_wgrad_kernels_match_plain_version_and_each_other(
        cuda, n, ci, co, h, cib, cob, stride, act, padding):
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    z = direct_conv_blocked(x, w, stride, padding).contiguous()
    g = torch.randn(z.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    zz = None if act is None else z
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), g.double(), 3, 3, stride, padding,
        None if zz is None else zz.double(), act, with_db=True)
    dz = g if act is None else conv2d_common.cotangent_prologue(g, zz, act)
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        x.abs().double(), dz.abs().double(), 3, 3, stride, padding,
        with_db=True)
    reset_launches()
    stk.reset_launches()
    runs = {route: [direct_conv2d_wgrad(x, g, 3, 3, stride, padding, zz, act,
                                        with_db=True, stream=route)
                    for _ in range(2)] for route in (False, True)}
    torch.cuda.synchronize()
    assert LAUNCHES["direct_conv2d_wgrad"] == 2
    assert stk.LAUNCHES["conv2d_stream_wgrad"] == 2
    for (dw, db), (dw2, db2) in runs.values():
        assert ((dw.double() - want_dw).abs() <= WGRAD_REL * abs_dw).all()
        assert ((db.double() - want_db).abs() <= WGRAD_REL * abs_db).all()
        # no atomics: two runs give the same bits
        assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         WGRAD_CASES)
def test_wgrad_kernel_plans_match_the_blocking_model(
        cuda, n, ci, co, h, cib, cob, stride, act, padding):
    # the kernels' own count of a launch (tiles, the function's MACs,
    # tensor-core MACs issued, shared memory; wgrad_tile::plan) against
    # core.blocking.wgrad_plan
    x, w, _, _ = _operands(cuda, n, ci, co, h, cib, cob, stride, False)
    z = direct_conv_blocked(x, w, stride, padding).contiguous()
    g = torch.randn(z.shape, device=cuda)
    zz = None if act is None else z
    for streamed in (False, True):
        kernel, model = wgrad_plans(x, g, 3, 3, stride, padding, zz, act,
                                    streamed=streamed)
        assert kernel == model
        assert kernel.issued_macs >= 3 * kernel.function_macs > 0


def test_wgrad_kernels_run_from_a_fresh_thread(cuda):
    # autograd runs a backward on a thread of its own: the wgrads' tensor
    # maps must encode where the device's context is not yet current
    import threading
    x, w, _, _ = _operands(cuda, 2, 64, 128, 14, 64, 128, 2, False)
    z = direct_conv_blocked(x, w, 2, "SAME").contiguous()
    g = torch.randn(z.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    want = [direct_conv2d_wgrad(x, g, 3, 3, 2, "SAME", z, "relu",
                                with_db=True, stream=route)
            for route in (False, True)]
    out = {}

    def run():
        try:
            for route in (False, True):
                out[route] = direct_conv2d_wgrad(x, g, 3, 3, 2, "SAME", z,
                                                 "relu", with_db=True,
                                                 stream=route)
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 - re-raised below
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in out, out.get("error")
    for route, (dw, db) in zip((False, True), want):
        assert torch.equal(out[route][0], dw)
        assert torch.equal(out[route][1], db)


def _graph_replay(fn):
    """``fn()`` warmed up on a side stream, captured on it in a CUDA graph
    and replayed once -> what the replay returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


# each folded wgrad: (its launch on (x, g, z) -> (ws, out), the (n, ci, co,
# h, cib, cob, stride) of its operands); the depthwise one at ci == co
FOLDED_WGRADS = {
    "window": (lambda x, g, z, s: wgrad_partials(x, g, 3, 3, s, "SAME", z,
                                                 "relu", True),
               (8, 64, 64, 56, 64, 64, 1)),
    "streamed": (lambda x, g, z, s: stk.stream_wgrad_partials(
        x, g, 3, 3, s, "SAME", z, "relu", True), (8, 128, 128, 28, 128, 128,
                                                  2)),
    "pointwise": (lambda x, g, z, s: pwk.pointwise_wgrad_partials(
        x, g, z, "relu", True), (32, 128, 128, 56, 128, 128, 1)),
    "depthwise": (lambda x, g, z, s: dwk.depthwise_wgrad_partials(
        x, g, 3, 3, s, "SAME", z, "relu", True), (32, 128, 128, 56, 128, 128,
                                                  1)),
}


@pytest.mark.parametrize("kind", list(FOLDED_WGRADS))
def test_folded_wgrad_sums_its_workspace_in_order(cuda, kind):
    # two runs and a CUDA-graph replay: each sum bit for bit the in-order
    # reduce of the workspace its own launch filled, the counters at 0
    launch, (n, ci, co, h, cib, cob, s) = FOLDED_WGRADS[kind]
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda, generator=gen)
    if kind == "depthwise":
        w = torch.randn((ci // cib, 1, 3, 3, 1, cib), device=cuda,
                        generator=gen)
        z = direct_conv_blocked(x, w, s, "SAME", groups=ci).contiguous()
    else:
        f = 1 if kind == "pointwise" else 3
        w = torch.randn((co // cob, ci // cib, f, f, cib, cob), device=cuda,
                        generator=gen) / (f * f * ci) ** 0.5
        z = direct_conv_blocked(x, w, s, "SAME").contiguous()
    g = torch.randn(z.shape, device=cuda, generator=gen)
    runs = [launch(x, g, z, s), launch(x, g, z, s),
            _graph_replay(lambda: launch(x, g, z, s))]
    torch.cuda.synchronize()
    for ws, out in runs:
        assert ws.shape[0] > 1                  # a split sum, not a copy
        assert torch.equal(out, conv2d_common.wgrad_reduce(ws))
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][1], runs[2][1])
    assert all(int(a.count_nonzero()) == 0 for a in split_sum.arenas())


@pytest.mark.parametrize("kind", ["window", "streamed", "pointwise",
                                  "depthwise"])
def test_folded_gap_is_the_finalize_of_its_partials(cuda, kind):
    # each forward with the GAP rider: two runs and a CUDA-graph replay,
    # the pooled features bit for bit the in-order finalize of the partials
    # its own launch wrote, the counters at 0
    n, c, h = 8, 512, 14
    x, w, b, r = _operands(cuda, n, c, c, h, 128, 128, 1, True)
    if kind == "pointwise":
        w = w[:, :, 1:2, 1:2].contiguous()
        launch = lambda: pwk.pointwise_gap(x, w, b, "relu", r)  # noqa: E731
        want = direct_conv_blocked(x, w, 1, "VALID", b, "relu", residual=r,
                                   gap=True)
    elif kind == "depthwise":
        w = w[:, :1, :, :, :1].contiguous()
        launch = lambda: dwk.depthwise_gap(  # noqa: E731
            x, w, b, 1, "SAME", "relu", r)
        want = direct_conv_blocked(x, w, 1, "SAME", b, "relu", groups=c,
                                   residual=r, gap=True)
    else:
        launch = lambda: gap_forward(  # noqa: E731
            x, w, b, 1, "SAME", "relu", r, streamed=kind == "streamed")
        want = direct_conv_blocked(x, w, 1, "SAME", b, "relu", residual=r,
                                   gap=True)
    runs = [launch(), launch(), _graph_replay(launch)]
    torch.cuda.synchronize()
    for pooled, parts in runs:
        assert torch.equal(pooled, conv2d_common.gap_finalize(parts, h * h))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][0], runs[2][0])
    torch.testing.assert_close(runs[0][0], want, **TOL)
    assert all(int(a.count_nonzero()) == 0 for a in split_sum.arenas())


def test_backward_of_a_two_layer_model_launches_the_kernels(cuda):
    gen = torch.Generator().manual_seed(0)
    convs = [BlockedConv2D(8, 16, stride=1, lane=8, device=cuda,
                           generator=gen),
             BlockedConv2D(16, 16, stride=2, lane=8, device=cuda,
                           generator=gen)]
    model = BlockedCNN(convs, 4, device=cuda, generator=gen)
    images = torch.randn((2, 12, 12, 8), device=cuda)
    reset_launches()
    loss = model(images).square().sum()
    loss.backward()
    torch.cuda.synchronize()
    # the first layer's dx is not needed: the images do not require grad
    assert LAUNCHES == {"direct_conv2d_fwd": 2, "direct_conv2d_fwd_bf16": 0,
                        "direct_conv2d_dgrad": 1,
                        "direct_conv2d_dgrad_bf16": 0,
                        "direct_conv2d_wgrad": 2,
                        "direct_conv2d_wgrad_bf16": 0,
                        "direct_conv2d_dz_bf16": 0}
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.core.precision import Precision
    x, w, b, _ = _operands(cuda, 1, 8, 8, 6, 8, 8, 1, False)
    with pytest.raises(NotImplementedError, match="f32 policy"):
        direct_conv2d_blocked(x, w.requires_grad_(), b, 1, "SAME",
                              precision=Precision(operand="float16"))
    w = w.detach()
    with pytest.raises(NotImplementedError, match="f32"):
        direct_conv2d_blocked(x.bfloat16(), w.bfloat16(), None, 1, "SAME")
    # the bf16 policy's inference runs the bf16 build, casting f32 operands
    got = direct_conv2d_blocked(x, w, b, 1, "SAME", precision="bf16")
    assert got.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="contiguous"):
        direct_conv2d_blocked(x.transpose(2, 3), w, b, 1, "SAME")
    with pytest.raises(ValueError, match="is on"):
        direct_conv2d_blocked(x, w, b.cpu(), 1, "SAME")
    offset = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x)
    offset.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        direct_conv2d_blocked(offset, w, b, 1, "SAME")


def _ran(mod) -> dict:
    """The kernels of a wrapper module that launched, with their counts."""
    return {k: v for k, v in mod.LAUNCHES.items() if v}


# (n, ci, co, h, cib, cob, activation, residual, gap)
PW_CASES = [
    (2, 32, 64, 28, 32, 64, "relu", False, False),
    (2, 12, 20, 9, 4, 4, "gelu", True, False),        # Cob not a multiple of 8
    (3, 1024, 1024, 7, 128, 128, "relu", False, True),
    (2, 16, 24, 5, 8, 8, "gelu", True, True),
    (2, 12, 18, 7, 4, 6, "relu", True, True),   # Cob 6: the dgrad's cp.async
    (2, 6, 16, 5, 3, 8, "gelu", False, True),   # Cib = 3: 4-byte copies
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,act,res,gap", PW_CASES)
def test_pointwise_kernels_match_plain_versions(cuda, n, ci, co, h, cib, cob,
                                                act, res, gap):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda, generator=g)
    w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=cuda,
                    generator=g) / ci ** 0.5
    b = torch.randn((co // cob, cob), device=cuda, generator=g)
    r = (torch.randn((n, co // cob, h, h, cob), device=cuda, generator=g)
         if res else None)
    pwk.reset_launches()
    with torch.no_grad():
        got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", act,
                                           residual=r, gap=gap)
    want = direct_conv_blocked(x, w, 1, "VALID", b, act, residual=r, gap=gap)
    z = direct_conv_blocked(x, w, 1, "VALID", b).contiguous()
    ct = torch.randn(z.shape, device=cuda, generator=g)
    # the dgrad is the dense dgrad tile at 1x1 (cp.async where Cob % 4)
    dx = pwk.pointwise_dgrad(ct, w, z, act)
    dw, db = pwk.pointwise_wgrad(x, ct, z, act, with_db=True)
    dw2, db2 = pwk.pointwise_wgrad(x, ct, z, act, with_db=True)
    torch.cuda.synchronize()
    assert _ran(pwk) == {"conv2d_pointwise_fwd": 1,
                         "conv2d_pointwise_dgrad": 1,
                         "conv2d_pointwise_wgrad": 2}
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(dx, direct_conv_dgrad_blocked(
        ct, w, (h, h), 1, "VALID", z, act), **TOL)
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), ct.double(), 1, 1, 1, "VALID", z.double(), act,
        with_db=True)
    torch.testing.assert_close(dw.double(), want_dw, **TOL)
    torch.testing.assert_close(db.double(), want_db, **TOL)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)   # no atomics


# (n, c, h, cb, stride, dilation, activation, residual, gap)
DW_CASES = [
    (2, 32, 28, 32, 1, 1, "relu", False, False),
    (2, 64, 28, 64, 2, 1, "relu", False, False),      # TF-SAME pads (0, 1)
    (2, 256, 14, 128, 2, 1, "relu", True, True),
    (2, 24, 13, 8, 1, 2, "gelu", True, True),         # dilation 2
    (2, 6, 9, 3, 2, 1, None, False, False),           # Cb = 3, odd extent
    (2, 16, 11, 8, 3, 1, "relu", False, False),       # the generic stride
]


@pytest.mark.parametrize("n,c,h,cb,s,dil,act,res,gap", DW_CASES)
def test_depthwise_kernels_match_plain_versions(cuda, n, c, h, cb, s, dil,
                                                act, res, gap):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((n, c // cb, h, h, cb), device=cuda, generator=g)
    w = torch.randn((c // cb, 1, 3, 3, 1, cb), device=cuda, generator=g) / 3
    b = torch.randn((c // cb, cb), device=cuda, generator=g)
    z = direct_conv_blocked(x, w, s, "SAME", b, groups=c,
                            dilation=dil).contiguous()
    r = torch.randn(z.shape, device=cuda, generator=g) if res else None
    dwk.reset_launches()
    with torch.no_grad():
        got = dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME", act,
                                           residual=r, gap=gap, dilation=dil)
    want = direct_conv_blocked(x, w, s, "SAME", b, act, groups=c,
                               dilation=dil, residual=r, gap=gap)
    ct = torch.randn(z.shape, device=cuda, generator=g)
    zz = None if act is None else z
    dx = dwk.depthwise_dgrad(ct, w, (h, h), s, "SAME", zz, act, dil)
    dw, db = dwk.depthwise_wgrad(x, ct, 3, 3, s, "SAME", zz, act, True, dil)
    dw2, db2 = dwk.depthwise_wgrad(x, ct, 3, 3, s, "SAME", zz, act, True, dil)
    torch.cuda.synchronize()
    assert _ran(dwk) == {"conv2d_depthwise_fwd": 1,
                         "conv2d_depthwise_dgrad": 1,
                         "conv2d_depthwise_wgrad": 2}
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(dx, direct_conv_dgrad_blocked(
        ct, w, (h, h), s, "SAME", zz, act, c, dil), **TOL)
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), ct.double(), 3, 3, s, "SAME",
        None if zz is None else zz.double(), act, True, c, dil)
    torch.testing.assert_close(dw.double(), want_dw, **TOL)
    torch.testing.assert_close(db.double(), want_db, **TOL)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)   # no atomics


def _mobilenet_legs():
    """MobileNet v1's distinct (ci, co, stride, h) blocks at a 224 entry."""
    from repro_torch.launch.separable_bwd_ab import mobilenet_legs
    return sorted(set(mobilenet_legs()))


@pytest.mark.parametrize("ci,co,s,h", _mobilenet_legs())
def test_pointwise_wgrad_matches_f64_at_mobilenet_legs(cuda, ci, co, s, h):
    # the dense wgrad tile at 1x1 at every pointwise leg's pencils (batch
    # 2): against f64 sums within 1e-5 of the terms' magnitudes (as
    # chip_smoke.py), twice and in a CUDA-graph replay bit for bit, the
    # split-sum counters back at 0
    gen = torch.Generator(device=cuda).manual_seed(6)
    ho = -(-h // s)
    cib, cob = min(ci, 128), min(co, 128)
    x = torch.randn((2, ci // cib, ho, ho, cib), device=cuda, generator=gen)
    w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=cuda,
                    generator=gen) / ci ** 0.5
    z = direct_conv_blocked(x, w, 1, "VALID").contiguous()
    g = torch.randn(z.shape, device=cuda, generator=gen)
    pwk.reset_launches()
    runs = [pwk.pointwise_wgrad(x, g, z, "relu", True) for _ in range(2)]
    torch.cuda.synchronize()
    assert pwk.LAUNCHES["conv2d_pointwise_wgrad"] == 2
    replay = _graph_replay(lambda: pwk.pointwise_wgrad(x, g, z, "relu",
                                                       True))
    want = direct_conv_wgrad_blocked(x.double(), g.double(), 1, 1, 1,
                                     "VALID", z.double(), "relu", True)
    dz = conv2d_common.cotangent_prologue(g, z, "relu")
    scale = direct_conv_wgrad_blocked(x.abs().double(), dz.abs().double(),
                                      1, 1, 1, "VALID", with_db=True)
    for got, ref, mag in zip(runs[0], want, scale):
        assert bool(((got.double() - ref).abs() <= 1e-5 * mag).all())
    for other in (runs[1], replay):
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    assert all(int(a.count_nonzero()) == 0 for a in split_sum.arenas())


@pytest.mark.parametrize("ci,s,h", sorted({(ci, s, h) for ci, _, s, h in
                                           _mobilenet_legs()}))
def test_depthwise_dgrad_matches_plain_at_mobilenet_legs(cuda, ci, s, h):
    # every depthwise leg's pencils and extents (batch 2, relu), on the
    # register path (stride 1) and the phase split (stride 2)
    gen = torch.Generator(device=cuda).manual_seed(7)
    cb = min(ci, 128)
    x = torch.randn((2, ci // cb, h, h, cb), device=cuda, generator=gen)
    w = torch.randn((ci // cb, 1, 3, 3, 1, cb), device=cuda,
                    generator=gen) / 3
    z = direct_conv_blocked(x, w, s, "SAME", groups=ci).contiguous()
    g = torch.randn(z.shape, device=cuda, generator=gen)
    want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", z, "relu", ci)
    dwk.reset_launches()
    got = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", z, "relu")
    torch.cuda.synchronize()
    assert dwk.LAUNCHES["conv2d_depthwise_dgrad"] == 1
    torch.testing.assert_close(got, want, **TOL)
    plan = dwk._dgrad_plan(tuple(g.shape), tuple(w.shape), (h, h), s, "SAME",
                           1, 1, True)
    assert plan.variant == s


# (n, c, h, cb, stride, dilation, filter, activation): the tap loop
# (dilation 2, stride 3, 5x5), Cb = 3 and a pencil of 6 (4-byte copies),
# odd extents at stride 2 (TF-SAME pads (1, 1)), linear
DW_DGRAD_CASES = [
    (2, 24, 13, 8, 1, 2, 3, "gelu"),
    (2, 16, 11, 8, 3, 1, 3, "relu"),
    (2, 16, 12, 16, 1, 1, 5, "gelu"),
    (2, 6, 9, 3, 2, 1, 3, "relu"),
    (2, 12, 10, 6, 1, 1, 3, None),
    (2, 32, 7, 32, 2, 1, 3, "gelu"),
    (2, 24, 15, 6, 2, 1, 3, "relu"),
]


@pytest.mark.parametrize("n,c,h,cb,s,dil,hf,act", DW_DGRAD_CASES)
def test_depthwise_dgrad_takes_every_filter_stride_and_pencil(
        cuda, n, c, h, cb, s, dil, hf, act):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((n, c // cb, h, h, cb), device=cuda, generator=gen)
    w = torch.randn((c // cb, 1, hf, hf, 1, cb), device=cuda,
                    generator=gen) / hf
    z = direct_conv_blocked(x, w, s, "SAME", groups=c,
                            dilation=dil).contiguous()
    g = torch.randn(z.shape, device=cuda, generator=gen)
    zz = z if act else None
    want = direct_conv_dgrad_blocked(g, w, (h, h), s, "SAME", zz, act, c,
                                     dil)
    dwk.reset_launches()
    got = dwk.depthwise_dgrad(g, w, (h, h), s, "SAME", zz, act, dil)
    torch.cuda.synchronize()
    assert dwk.LAUNCHES["conv2d_depthwise_dgrad"] == 1
    torch.testing.assert_close(got, want, **TOL)


def test_separable_model_runs_through_the_kernels(cuda):
    gen = torch.Generator().manual_seed(0)
    blocks = [DepthwiseSeparableBlock(8, 16, stride=1, lane=8, device=cuda,
                                      generator=gen),
              DepthwiseSeparableBlock(16, 16, stride=2, lane=8, device=cuda,
                                      generator=gen)]
    model = BlockedCNN(blocks, 4, device=cuda, generator=gen)
    images = torch.randn((2, 12, 12, 8), device=cuda)
    for mod in (pwk, dwk):
        mod.reset_launches()
    reset_launches()
    with torch.no_grad():
        model(images)
    torch.cuda.synchronize()
    assert pwk.LAUNCHES["conv2d_pointwise_fwd"] == 2
    assert dwk.LAUNCHES["conv2d_depthwise_fwd"] == 2
    assert all(v == 0 for v in LAUNCHES.values())    # the GAP folded in
    loss = model(images).square().sum()
    loss.backward()
    torch.cuda.synchronize()
    # the first block's dx is not needed: the images do not require grad
    assert _ran(pwk) == {"conv2d_pointwise_fwd": 4,
                         "conv2d_pointwise_dgrad": 2,
                         "conv2d_pointwise_wgrad": 2}
    assert _ran(dwk) == {"conv2d_depthwise_fwd": 4,
                         "conv2d_depthwise_dgrad": 1,
                         "conv2d_depthwise_wgrad": 2}
    assert all(v == 0 for v in LAUNCHES.values())    # the sums folded in
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


# (n, ci, co, h, cib, cob, stride, activation, residual, gap, hso)
STREAM_CASES = [
    (2, 3, 64, 20, 3, 64, 2, "gelu", True, False, None),     # Cib = 3
    (2, 3, 64, 17, 3, 64, 1, "relu", False, True, 1),
    (2, 64, 128, 28, 64, 128, 1, "gelu", True, True, None),
    (2, 64, 128, 28, 64, 128, 2, "relu", False, False, 2),   # (0, 1) pads
    (3, 24, 12, 9, 8, 12, 2, None, False, True, None),       # Cob % 8 != 0
    (2, 128, 128, 14, 128, 128, 1, "relu", False, False, None),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,res,gap,hso",
                         STREAM_CASES)
def test_stream_kernels_match_plain_and_window(cuda, n, ci, co, h, cib, cob,
                                               stride, act, res, gap, hso):
    x, w, b, r = _operands(cuda, n, ci, co, h, cib, cob, stride, res)
    stk.reset_launches()
    reset_launches()
    with torch.no_grad():
        got = direct_conv2d_blocked(x, w, b, stride, "SAME", act, residual=r,
                                    gap=gap, stream=True, hso=hso)
        window = direct_conv2d_blocked(x, w, b, stride, "SAME", act,
                                       residual=r, gap=gap, stream=False)
        want = direct_conv_blocked(x, w, stride, "SAME", b, act, residual=r,
                                   gap=gap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    # the same sums in the same order where both choosers take the same
    # channel chunk (GAP sums positions in each tile's own grouping)
    spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")
    args = (n, spec.ho, spec.wo, 3, 3, stride, ci // cib, cib, co // cob,
            cob)
    sblk = choose_stream_fwd_blocking(*args, gap=gap, hso=hso)
    wblk = choose_fwd_blocking(*args, gap=gap)
    same = sblk.chunk == wblk.chunk and not gap
    if same:
        assert torch.equal(got, window)
    else:
        scale = want.abs().max()
        assert (got - window).abs().max() <= 1e-5 * scale
    z = direct_conv_blocked(x, w, stride, "SAME", b).contiguous()
    ct = torch.randn(z.shape, device=cuda)
    zz = None if act is None else z
    dx = direct_conv2d_dgrad(ct, w, (h, h), stride, "SAME", zz, act,
                             stream=True)
    dx_win = direct_conv2d_dgrad(ct, w, (h, h), stride, "SAME", zz, act)
    dw, db = direct_conv2d_wgrad(x, ct, 3, 3, stride, "SAME", zz, act,
                                 with_db=True, stream=True)
    dw2, db2 = direct_conv2d_wgrad(x, ct, 3, 3, stride, "SAME", zz, act,
                                   with_db=True, stream=True)
    torch.cuda.synchronize()
    assert stk.LAUNCHES == {"conv2d_stream_fwd": 1,
                            "conv2d_stream_fwd_bf16": 0,
                            "conv2d_stream_dgrad": 1,
                            "conv2d_stream_dgrad_bf16": 0,
                            "conv2d_stream_wgrad": 2,
                            "conv2d_stream_wgrad_bf16": 0}
    assert LAUNCHES["direct_conv2d_fwd"] == 1        # the window forward
    assert LAUNCHES["direct_conv2d_dgrad"] == 1      # the window dgrad
    assert LAUNCHES["direct_conv2d_wgrad"] == 0
    want_dx = direct_conv_dgrad_blocked(ct, w, (h, h), stride, "SAME", zz,
                                        act)
    torch.testing.assert_close(dx, want_dx, **TOL)
    torch.testing.assert_close(dx, dx_win, **TOL)
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), ct.double(), 3, 3, stride, "SAME",
        None if zz is None else zz.double(), act, with_db=True)
    torch.testing.assert_close(dw.double(), want_dw, **TOL)
    torch.testing.assert_close(db.double(), want_db, **TOL)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)   # no atomics


def test_stream_context_trains_a_two_layer_model_on_the_stream_kernels(
        cuda):
    gen = torch.Generator().manual_seed(0)
    convs = [BlockedConv2D(8, 16, stride=1, lane=8, device=cuda,
                           generator=gen),
             BlockedConv2D(16, 16, stride=2, lane=8, device=cuda,
                           generator=gen)]
    model = BlockedCNN(convs, 4, device=cuda, generator=gen)
    images = torch.randn((2, 12, 12, 8), device=cuda)
    grads = []
    for ctx in (ConvContext(stream=True), None):
        for p in model.parameters():
            p.grad = None
        stk.reset_launches()
        reset_launches()
        model(images, context=ctx).square().sum().backward()
        torch.cuda.synchronize()
        grads.append([p.grad.clone() for p in model.parameters()])
        if ctx is not None:
            assert stk.LAUNCHES == {"conv2d_stream_fwd": 2,
                                    "conv2d_stream_fwd_bf16": 0,
                                    "conv2d_stream_dgrad": 1,
                                    "conv2d_stream_dgrad_bf16": 0,
                                    "conv2d_stream_wgrad": 2,
                                    "conv2d_stream_wgrad_bf16": 0}
            assert all(v == 0 for v in LAUNCHES.values())
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


# ---------------------------------------------------------------------------
# the language models' kernels: flash attention and the causal conv1d
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _agree(got, want):
    """Within 1e-5 of max|want| + 1e-6: both compute the same f32 sums in
    another order.  bf16: the plain version computes in f32 from the same
    bf16 inputs and rounds once, so the two may also round to neighbouring
    bf16 values: one bf16 ulp more."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.double(), want.double()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    bound = 1e-5 * w.abs().max() + 1e-6
    if want.dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    assert bool((err <= bound).all()), float((err - bound).max())


def _attend_operands(dev, b, sq, skv, nkv, g, dh, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, nkv, g, dh), device=dev, generator=gen)
    k = torch.randn((b, skv, nkv, dh), device=dev, generator=gen)
    v = torch.randn((b, skv, nkv, dh), device=dev, generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype)


# b, sq, skv, kv, g, dh, causal, window, cap, kv_valid, q offset
ATTEND_GPU_CASES = [
    (2, 200, 200, 4, 2, 80, True, None, None, None, 0),      # danube's Dh
    (1, 256, 256, 2, 4, 128, True, 48, None, None, 0),       # window bites
    (2, 130, 130, 2, 2, 16, True, None, 50.0, None, 0),      # softcap
    (1, 100, 100, 2, 2, 64, False, None, None, None, 0),     # non-causal
    (1, 97, 97, 1, 8, 32, True, None, None, None, 0),        # MQA, ragged
    (2, 70, 150, 2, 2, 256, True, None, None, (150, 91), 80),  # kv_valid
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTEND_GPU_CASES)
def test_flash_attention_kernel_matches_plain_version(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fak
    b, sq, skv, nkv, g, dh, causal, window, cap, kv_valid, off = case
    q, k, v = _attend_operands(cuda, b, sq, skv, nkv, g, dh, dtype)
    qp = (torch.arange(sq, device=cuda) + off)[None].expand(b, sq)
    kp = torch.arange(skv, device=cuda)[None].expand(b, skv)
    kvv = None if kv_valid is None else torch.tensor(kv_valid, device=cuda)
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal, window=window,
              cap=cap, scale=dh ** -0.5, kv_valid=kvv)
    fak.reset_launches()
    got = fak.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fak.LAUNCHES["flash_attention"] == 1
    _agree(got, fak.attend_plain(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_tpu_layout_reads_strided_views(cuda, dtype):
    """[B, H, S, Dh] views of [B, S, H, Dh] tensors: no copy is made."""
    from repro_torch.kernels import flash_attention as fak
    gen = torch.Generator(device=cuda).manual_seed(1)
    qs = torch.randn((2, 150, 8, 80), device=cuda, generator=gen).to(dtype)
    ks = torch.randn((2, 150, 2, 80), device=cuda, generator=gen).to(dtype)
    vs = torch.randn((2, 150, 2, 80), device=cuda, generator=gen).to(dtype)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (qs, ks, vs))
    got = fak.flash_attention(q, k, v, scale=0.1, causal=True)
    _agree(got, fak.flash_attention_plain(q, k, v, scale=0.1, causal=True))


# the bf16 tensor-core kernel at every phase-18 case of chip_smoke.py, and
# G = 6 and 7 (no power of two: a CTA's 128 rows hold 21 x 6 or 18 x 7),
# G = 1, Dh 64, 80 and 128: label, b, s, kv, g, dh, causal, window, cap,
# kv_valid, position stride (0: arange; else stride * i + 7).  In the G 6
# window case, batch 1's rows past position 150 + 64 see no key and take
# the reference's average of v.
BF16_FLASH_CASES = [
    ("danube prefill", 2, 2048, 8, 4, 80, True, None, None, None, 0),
    ("window 256", 1, 1024, 8, 4, 80, True, 256, None, None, 0),
    ("softcap 50", 1, 1024, 4, 2, 128, True, None, 50.0, None, 0),
    ("non-causal", 1, 512, 4, 2, 64, False, None, None, None, 0),
    ("MQA", 1, 1024, 1, 8, 128, True, None, None, None, 0),
    ("Dh 128", 1, 1024, 8, 4, 128, True, None, None, None, 0),
    ("G 7 (deepseek-coder)", 1, 1024, 8, 7, 128, True, None, None, None, 0),
    ("ragged S 1000", 2, 1000, 8, 4, 80, True, None, None, None, 0),
    ("kv_valid, positions 3i+7, softcap", 2, 700, 2, 4, 80, True, None,
     50.0, (2200, 333), 3),
    ("G 6, Dh 64, ragged", 2, 333, 2, 6, 64, True, None, None, None, 0),
    ("G 7, Dh 80, window", 1, 500, 2, 7, 80, True, 100, None, None, 0),
    ("G 6, Dh 128, positions 2i+7, window, kv_valid", 2, 260, 1, 6, 128,
     True, 64, None, (300, 150), 2),
    ("G 1, Dh 80, non-causal", 1, 300, 3, 1, 80, False, None, 30.0, None, 0),
]


@pytest.mark.parametrize("case", BF16_FLASH_CASES, ids=lambda c: c[0])
def test_flash_attention_bf16_kernel_matches_plain_version(cuda, case):
    from repro_torch.kernels import flash_attention as fak
    _, b, s, nkv, g, dh, causal, window, cap, kv_valid, stride = case
    q, k, v = _attend_operands(cuda, b, s, s, nkv, g, dh, torch.bfloat16,
                               seed=s + g)
    pos = torch.arange(s, device=cuda, dtype=torch.int32)[None].expand(b, s)
    if stride:
        pos = stride * pos + 7
    kw = dict(q_positions=pos, kv_positions=pos, causal=causal,
              window=window, cap=cap, scale=dh ** -0.5,
              kv_valid=None if kv_valid is None else
              torch.tensor(kv_valid, device=cuda))
    fak.reset_launches()
    got = fak.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fak.LAUNCHES["flash_attention"] == 1
    _agree(got, fak.attend_plain(q, k, v, **kw))


@pytest.mark.parametrize("case", BF16_FLASH_CASES, ids=lambda c: c[0])
def test_flash_attention_f32_kernel_matches_plain_version(cuda, case):
    # the same cases in f32: every one on the tensor-core kernel (Dh <= 128,
    # G <= 128)
    from repro_torch.kernels import flash_attention as fak
    _, b, s, nkv, g, dh, causal, window, cap, kv_valid, stride = case
    q, k, v = _attend_operands(cuda, b, s, s, nkv, g, dh, torch.float32,
                               seed=s + g)
    pos = torch.arange(s, device=cuda, dtype=torch.int32)[None].expand(b, s)
    if stride:
        pos = stride * pos + 7
    kw = dict(q_positions=pos, kv_positions=pos, causal=causal,
              window=window, cap=cap, scale=dh ** -0.5,
              kv_valid=None if kv_valid is None else
              torch.tensor(kv_valid, device=cuda))
    fak.reset_launches()
    got = fak.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fak.LAUNCHES["flash_attention"] == 1
    assert fak.KERNEL_LAUNCHES == {"fma": 0, "bf16": 0, "tf32": 1}
    _agree(got, fak.attend_plain(q, k, v, **kw))


def test_flash_attention_f32_routes_past_the_tensor_core_kernel(cuda):
    # Dh 256, G 130 and K/V expanded over the KV heads (stride 0) run on
    # CUDA cores (flash_fwd_kernel), by the rule
    from repro_torch.kernels import flash_attention as fak
    for nkv, g, dh, expand in ((1, 2, 256, False), (1, 130, 16, False),
                               (2, 4, 80, True)):
        q, k, v = _attend_operands(cuda, 1, 70, 70, nkv, g, dh,
                                   torch.float32)
        if expand:
            k, v = (t[:, :, :1].expand(t.shape) for t in (k, v))
        pos = torch.arange(70, device=cuda)[None]
        kw = dict(q_positions=pos, kv_positions=pos, scale=dh ** -0.5)
        fak.reset_launches()
        got = fak.attend(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fak.KERNEL_LAUNCHES == {"fma": 1, "bf16": 0, "tf32": 0}
        _agree(got, fak.attend_plain(q, k, v, **kw))


@pytest.mark.parametrize("chunk", [2048, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rows_that_see_no_key_match_plain_version(
        cuda, dtype, chunk):
    """kv_valid and a window leave most rows of batch 1 no key, whole CTAs
    of them (no block visited) and rows of CTAs that do see keys: each gets
    the reference's sum of v over the keys scanned at ``chunk`` (120 keys
    at 2048, 128 at 64)."""
    from repro_torch.kernels import flash_attention as fak
    b, s, nkv, g, dh = 2, 120, 2, 3, 64
    q, k, v = _attend_operands(cuda, b, s, s, nkv, g, dh, dtype, seed=5)
    pos = torch.arange(s, device=cuda, dtype=torch.int32)[None].expand(b, s)
    kw = dict(q_positions=pos, kv_positions=pos, causal=True, window=16,
              cap=None, scale=dh ** -0.5, chunk=chunk,
              kv_valid=torch.tensor((120, 40), device=cuda))
    fak.reset_launches()
    got = fak.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fak.LAUNCHES["flash_attention"] == 1
    want = fak.attend_plain(q, k, v, **kw)
    _agree(got, want)
    avg = v[1].float().sum(dim=0) / fak.scanned_keys(s, chunk)
    _agree(got[1, 56:], avg[None, :, None].expand(s - 56, nkv, g, dh).to(
        dtype))


def test_flash_attention_bf16_kernel_raises_on_what_it_refuses(cuda):
    """A bf16 operand off TMA's 16-byte rule raises; nothing is launched and
    nothing falls back to another kernel or the plain version."""
    from repro_torch.kernels import flash_attention as fak
    q, k, v = _attend_operands(cuda, 1, 64, 64, 2, 4, 80, torch.bfloat16)
    pos = torch.arange(64, device=cuda)[None]
    wide = torch.zeros((1, 64, 2, 84), device=cuda, dtype=torch.bfloat16)
    k_odd = wide[..., :80]                 # row stride 84: 168 bytes
    fak.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        fak.attend(q, k_odd, v, q_positions=pos, kv_positions=pos,
                   scale=1.0)
    buf = torch.zeros(q.numel() + 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="misaligned"):
        fak.attend(buf[4:].view(q.shape), k, v, q_positions=pos,
                   kv_positions=pos, scale=1.0)
    assert fak.LAUNCHES["flash_attention"] == 0


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fak
    q, k, v = _attend_operands(cuda, 1, 8, 8, 1, 1, 12, torch.float32)
    pos = torch.arange(8, device=cuda)[None]
    with pytest.raises(NotImplementedError, match="head dim"):
        fak.attend(q, k, v, q_positions=pos, kv_positions=pos, scale=1.0)
    q, k, v = _attend_operands(cuda, 1, 8, 8, 1, 1, 16, torch.float32)
    buf = torch.zeros(q.numel() + 1, device=cuda)
    q_odd = buf[1:].view(q.shape)
    with pytest.raises(ValueError, match="misaligned"):
        fak.attend(q_odd, k, v, q_positions=pos, kv_positions=pos, scale=1.0)


# b, l, d, k, column offset in a wider row (None: contiguous), dtype
CONV1D_GPU_CASES = [
    (2, 300, 3328, 4, 3072, torch.float32),     # mamba2's xBC slice
    (2, 300, 3328, 4, 3072, torch.bfloat16),
    (2, 129, 160, 4, None, torch.float32),      # reduced width, ragged L
    (1, 77, 161, 3, 5, torch.float32),          # odd D and offset: 1 lane
    (1, 77, 161, 8, 5, torch.bfloat16),
    (3, 64, 96, 1, None, torch.bfloat16),
]


@pytest.mark.parametrize("b,l,d,k,off,dtype", CONV1D_GPU_CASES)
def test_conv1d_kernel_matches_plain_version(cuda, b, l, d, k, off, dtype):
    from repro_torch.core.direct_conv import direct_conv1d_depthwise
    from repro_torch.kernels import conv1d_depthwise as c1k
    gen = torch.Generator(device=cuda).manual_seed(l)
    width = d if off is None else off + d + 40
    wide = torch.randn((b, l, width), device=cuda, generator=gen).to(dtype)
    x = wide if off is None else wide[:, :, off:off + d]
    w = torch.randn((k, d), device=cuda, generator=gen).to(dtype)
    bias = torch.randn((d,), device=cuda, generator=gen).to(dtype)
    c1k.reset_launches()
    got = c1k.conv1d_depthwise(x, w, bias)
    torch.cuda.synchronize()
    assert c1k.LAUNCHES["conv1d_depthwise"] == 1
    _agree(got, direct_conv1d_depthwise(x, w, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1d_blocked_kernel_matches_plain_version(cuda, dtype):
    from repro_torch.core.direct_conv import direct_conv1d_depthwise
    from repro_torch.core.layout import (blocked_to_bld, bld_to_blocked,
                                         kd_to_blocked)
    from repro_torch.kernels import conv1d_depthwise as c1k
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 200, 3328), device=cuda, generator=gen).to(dtype)
    w = torch.randn((4, 3328), device=cuda, generator=gen).to(dtype)
    xb = bld_to_blocked(x, 128).contiguous()
    got = c1k.conv1d_depthwise_blocked(xb, kd_to_blocked(w, 128))
    _agree(blocked_to_bld(got), direct_conv1d_depthwise(x, w, None))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m"])
def test_reduced_lm_prefill_runs_through_the_kernels(cuda, arch):
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels import conv1d_depthwise as c1k
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.nn.models import build_model
    from repro_torch.train.trainstep import make_prefill_step
    cfg = reduced_config(arch)
    gpu = build_model(cfg, cuda, torch.Generator().manual_seed(0))
    cpu = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    fak.reset_launches()
    c1k.reset_launches()
    got = make_prefill_step(gpu, cfg)({"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    n_attn = sum(k.mixer == "attn" for k in cfg.layer_kinds()) * (
        cfg.n_layers // cfg.period)
    assert fak.LAUNCHES["flash_attention"] == n_attn
    assert c1k.LAUNCHES["conv1d_depthwise"] == cfg.n_layers - n_attn
    want = make_prefill_step(cpu, cfg)({"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_serve_launcher_runs_on_the_card(cuda):
    from repro_torch.launch.serve import main
    assert main(["--arch", "h2o-danube-1.8b", "--reduced", "--requests",
                 "4", "--max-new", "4"]) == 0
    assert main(["--arch", "mamba2-780m", "--reduced", "--requests", "3",
                 "--max-new", "3"]) == 0


# ---------------------------------------------------------------------------
# the bf16 build of the dense forward tile (fwd_kernel_bf16,
# stream_fwd_kernel_bf16) against the plain version under BF16: both round
# the same f32 sums of bf16 products to bf16 once, in other orders, so an
# element may land one bf16 ulp apart; plus 1e-5 of max|y| for the sums
# ---------------------------------------------------------------------------

def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    bound = ulp + 1e-5 * w.abs().max()
    assert bool(((g - w).abs() <= bound).all()), float(
        ((g - w).abs() / bound).max())


BF16_CASES = [
    (2, 3, 64, 17, 3, 64, 1, "relu", False, False),    # Cib 3: 2-byte copies
    (2, 3, 64, 20, 3, 64, 2, "gelu", True, True),
    (2, 64, 128, 28, 64, 128, 1, "gelu", True, True),
    (3, 24, 12, 9, 8, 12, 2, None, False, True),       # Cob 12: 2-byte weights
    (2, 12, 20, 23, 4, 20, 1, "gelu", True, False),    # Cib 4: 4-byte copies
    (2, 8, 5, 9, 8, 5, 1, "relu", True, True),         # Cob 5: odd, no pairs
    (1, 256, 256, 14, 128, 128, 2, "relu", True, True),
    (2, 512, 512, 14, 128, 128, 1, "relu", False, True),
]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,res,gap", BF16_CASES)
def test_bf16_forward_kernels_match_plain_version(cuda, streamed, n, ci, co,
                                                  h, cib, cob, stride, act,
                                                  res, gap):
    x, w, b, r = _operands(cuda, n, ci, co, h, cib, cob, stride, res)
    x = x.bfloat16()
    r = None if r is None else r.bfloat16()
    reset_launches()
    stk.reset_launches()
    with torch.no_grad():
        got = direct_conv2d_blocked(x, w, b, stride, "SAME", act, residual=r,
                                    gap=gap, precision="bf16",
                                    stream=streamed)
        want = direct_conv_blocked(x, w, stride, "SAME", b, act, "bf16",
                                   residual=r, gap=gap)
    torch.cuda.synchronize()
    assert (stk.LAUNCHES["conv2d_stream_fwd_bf16"],
            LAUNCHES["direct_conv2d_fwd_bf16"]) == ((1, 0) if streamed
                                                    else (0, 1))
    assert LAUNCHES["direct_conv2d_fwd"] == stk.LAUNCHES[
        "conv2d_stream_fwd"] == 0
    _bf16_close(got, want)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,res,gap",
                         [c for c in BF16_CASES if c[-1]])
def test_gap_replay_is_the_kernels_pooled_features_bit_for_bit(
        cuda, streamed, dtype, n, ci, co, h, cib, cob, stride, act, res,
        gap):
    x, w, b, r = _operands(cuda, n, ci, co, h, cib, cob, stride, res)
    if dtype == "bf16":
        x = x.bfloat16()
        r = None if r is None else r.bfloat16()
    pooled, parts, out, blk = gap_forward(x, w, b, stride, "SAME", act, r,
                                          streamed=streamed, precision=dtype,
                                          with_map=True)
    torch.cuda.synchronize()
    assert torch.equal(conv2d_common.gap_replay(out, blk), pooled)
    hw = out.shape[2] * out.shape[3]
    assert torch.equal(
        conv2d_common.gap_finalize(parts, hw).to(pooled.dtype), pooled)


def _bf16_tile(spec, cob, streamed, th, tw, wgs, chunk, nsplit):
    """A bf16 forward tile pinned past the chooser, as the chooser would
    describe it (its plane pitch, tiles and window)."""
    s = spec.stride
    lanes = next(n for n in (8, 16, 32, 64, 128) if -(-cob // nsplit) <= n)
    blk = FwdBlocking(th=th, tw=tw, wgs=wgs, strips=wgs if streamed else 1,
                      lanes=lanes, nsplit=nsplit, chunk=chunk,
                      tiles=-(-spec.ho // th) * -(-spec.wo // tw),
                      hwin=(th - 1) * s + 3, wwin=(tw - 1) * s + 3,
                      pitch=fwd_bf16_pitch(tw, 3, s, chunk, streamed))
    lay = fwd_bf16_layout(th, tw, 3, 3, s, chunk, lanes, wgs, blk.strips,
                          True)
    assert lay.windows >= 2 and lay.rows >= 2
    return blk


def _bf16_launch(spec, cib, cob, blk, streamed, x, w, b, r):
    """One launch of the bf16 forward at the pinned tiles ``blk`` (gelu,
    GAP) -> (out, pooled), counted as the wrappers count it."""
    plan = dck.fwd_launch(spec, cib, cob, 2, True, streamed, blk=blk,
                          dtype=torch.bfloat16)
    if streamed:
        lib, name, entry = (stk._lib(), "conv2d_stream_fwd_bf16",
                            stk._lib().conv2d_stream_conv)
        stk.LAUNCHES[name] += 1
    else:
        lib, name, entry = (dck._lib(), "direct_conv2d_fwd_bf16",
                            dck._lib().direct_conv2d_fwd)
        LAUNCHES[name] += 1
    err, out, _, pooled = dck.fwd_run(entry, plan, x, w, b, r, spec)
    dck._check(err, lib, name)
    return out, pooled, plan


# (n, ci, co, h, cib, cob, stride, streamed, th, tw, wgs, chunk, nsplit):
# stride 2 as phase planes by TMA at chunks 64 and 32; three consumers at
# 128 lanes, at chunk 64 and at chunk 16 with the lanes split; the copies
# paths (Cib 3 at stride 2: 2-byte window copies into four planes; Cib 6
# and Cob 12: 4-byte window copies and 2-byte weight copies); the weights'
# rows of 16 and 8 lanes (the 32-byte swizzle, the interleaved core
# matrices); each walked by a persistent grid of more items than the card
# holds CTAs
PINNED_BF16 = [
    (16, 64, 128, 56, 64, 128, 2, False, 6, 5, 1, 64, 1),
    (16, 64, 128, 56, 64, 128, 2, True, 4, 6, 2, 32, 1),
    (32, 128, 128, 28, 128, 128, 1, False, 6, 20, 3, 64, 1),
    (16, 128, 128, 28, 128, 128, 1, True, 6, 13, 3, 16, 2),
    (16, 3, 32, 62, 3, 32, 2, False, 7, 8, 1, 16, 1),
    (16, 6, 12, 40, 6, 12, 1, True, 4, 9, 2, 16, 1),
    (16, 16, 16, 40, 16, 16, 1, False, 4, 12, 1, 16, 1),
    (32, 8, 8, 40, 8, 8, 2, True, 4, 9, 2, 16, 1),
]


@pytest.mark.parametrize(
    "n,ci,co,h,cib,cob,stride,streamed,th,tw,wgs,chunk,nsplit", PINNED_BF16)
def test_bf16_forward_tiles_pinned_past_the_chooser(cuda, n, ci, co, h, cib,
                                                    cob, stride, streamed,
                                                    th, tw, wgs, chunk,
                                                    nsplit):
    x, w, b, r = _operands(cuda, n, ci, co, h, cib, cob, stride, True)
    x, r = x.bfloat16(), r.bfloat16()
    spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")
    blk = _bf16_tile(spec, cob, streamed, th, tw, wgs, chunk, nsplit)
    assert n * blk.tiles * (co // cob) * nsplit > 2 * 132   # items > CTAs
    with torch.no_grad():
        out, pooled, plan = _bf16_launch(spec, cib, cob, blk, streamed, x, w,
                                         b, r)
        out2, pooled2, _ = _bf16_launch(spec, cib, cob, blk, streamed, x, w,
                                        b, r)
        want = direct_conv_blocked(x, w, stride, "SAME", b, "gelu", "bf16",
                                   residual=r)
    torch.cuda.synchronize()
    _bf16_close(out, want)
    # no sum depends on which CTA ran first: two runs, identical bits; the
    # GAP replay on the flattened rows bit for bit the kernel's
    assert torch.equal(out, out2) and torch.equal(pooled, pooled2)
    assert torch.equal(conv2d_common.gap_replay(out, blk), pooled)
    # the kernel library's count of the launch is the model's
    got = (__import__("ctypes").c_longlong * 6)()
    plan_entry = (stk._lib().conv2d_stream_conv_plan if streamed
                  else dck._lib().direct_conv2d_fwd_plan)
    assert plan_entry(plan.ints, got) == 0
    model = fwd_plan(blk, n, spec.ho, spec.wo, 3, 3, stride, ci // cib, cib,
                     co // cob, cob, True, 2)
    assert tuple(got) == (model.tiles, model.function_macs,
                          model.issued_macs, model.smem, model.window_slots,
                          model.weight_slots)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_window_and_streamed_kernels_agree_bit_for_bit(cuda, stride):
    # one K order (stages, filter rows, taps, k16 slices) in both kernels:
    # at one chunk they store the same bits, whatever their tiles
    n, ci, co, h = 4, 128, 128, 30
    x, w, b, r = _operands(cuda, n, ci, co, h, 64, 64, stride, True)
    x, r = x.bfloat16(), r.bfloat16()
    spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME")
    outs = []
    with torch.no_grad():
        for streamed, th, tw, wgs in ((False, 8, 9, 2), (True, 6, 7, 3),
                                      (False, 3, 15, 1), (True, 4, 11, 2)):
            blk = _bf16_tile(spec, 64, streamed, th, tw, wgs, 32, 1)
            outs.append(_bf16_launch(spec, 64, 64, blk, streamed, x, w, b,
                                     r)[0])
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert torch.equal(other, outs[0])


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("gap", [False, True])
def test_fp16_policy_raises_on_cuda_and_launches_nothing(cuda, streamed,
                                                         gap):
    from repro_torch.core.precision import Precision
    x, w, b, _ = _operands(cuda, 2, 16, 16, 9, 8, 16, 1, False)
    fp16 = Precision(operand="float16")
    reset_launches()
    stk.reset_launches()
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="float16"):
            direct_conv2d_blocked(x.half(), w, b, 1, "SAME", "relu", gap=gap,
                                  precision=fp16, stream=streamed)
        with pytest.raises(NotImplementedError, match="float16"):
            gap_forward(x, w, b, 1, "SAME", "relu", streamed=streamed,
                        precision=fp16)
    assert not any(LAUNCHES.values()) and not any(stk.LAUNCHES.values())


def test_bf16_policy_refuses_training_and_serves_a_narrow_cnn(cuda):
    # training refuses a float16 policy (no backward build reads it) and,
    # since the bf16 builds of the backward tiles, runs BF16 on them alone
    from repro_torch.core.precision import Precision
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome
    gen = torch.Generator().manual_seed(0)
    convs = [BlockedConv2D(3, 16, stride=1, lane=8, device=cuda,
                           generator=gen),
             BlockedConv2D(16, 16, stride=2, lane=8, device=cuda,
                           generator=gen)]
    model = BlockedCNN(convs, 4, device=cuda, generator=gen)
    images = torch.randn((2, 12, 12, 3), device=cuda)
    ctx = ConvContext(precision="bf16")
    reset_launches()
    with pytest.raises(NotImplementedError, match="f32 policy and BF16"):
        model(images, context=ConvContext(precision=Precision(
            operand="float16", residual="float16")))
    assert not any(LAUNCHES.values())
    model(images, context=ctx).float().square().sum().backward()
    torch.cuda.synchronize()
    # and the dz pass once a layer (relu, and db)
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "direct_conv2d_fwd_bf16": 2, "direct_conv2d_dgrad_bf16": 1,
        "direct_conv2d_wgrad_bf16": 2, "direct_conv2d_dz_bf16": 2}
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())
    reset_launches()
    with torch.no_grad():
        got = model(images, context=ctx)
        want = model.cpu()(images.cpu(), context=ctx)
        model.to(cuda)
    assert LAUNCHES["direct_conv2d_fwd_bf16"] == 2
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2 * want.abs().max().item())
    server = ConvServer(model, [(12, 12)], 2, device=cuda, context=ctx)
    reqs = [ConvRequest(i, images[i].cpu().numpy()) for i in range(2)]
    for req in reqs:
        server.submit(req)
    server.run()
    assert all(req.outcome is Outcome.OK for req in reqs)


# ---------------------------------------------------------------------------
# the bf16 builds of the dgrad and wgrad tiles (dgrad_tile.cuh and
# wgrad_tile.cuh, namespace bf16) against their plain versions under BF16:
# dx within one bf16 ulp of |dx| plus 1e-5 of max|dx| (both round f32 sums
# of the same exact bf16 products once to bf16, in other orders); dw and db
# against f64 sums of the same bf16 operands within WGRAD_REL of sum |x dz|
# ---------------------------------------------------------------------------

# (n, ci, co, h, cib, cob, stride, activation, padding)
BF16_BWD_CASES = [
    (2, 64, 64, 14, 64, 64, 1, "relu", "SAME"),
    (2, 64, 128, 14, 64, 128, 2, "relu", "SAME"),
    (2, 128, 128, 9, 128, 128, 1, "gelu", "SAME"),   # odd hi
    (2, 128, 256, 11, 128, 128, 2, None, "SAME"),    # two Co blocks
    (2, 256, 128, 7, 128, 128, 1, "relu", "SAME"),   # two Ci blocks
    (2, 3, 64, 20, 3, 64, 2, "gelu", "SAME"),        # Cib = 3
    (1, 8, 12, 10, 8, 12, 2, None, "VALID"),         # Cob 12: 4-byte copies
    (2, 16, 6, 9, 16, 6, 1, "relu", "SAME"),         # Cob 6
    (1, 64, 250, 14, 64, 125, 1, "relu", "SAME"),    # Cob 125: odd
    (2, 12, 16, 9, 4, 16, 1, "gelu", "SAME"),        # Cib 4: 4-byte x copies
]


def _bf16_bwd_operands(dev, n, ci, co, h, cib, cob, stride, act, padding):
    x, w, _, _ = _operands(dev, n, ci, co, h, cib, cob, stride, False)
    x, w = x.bfloat16(), w.bfloat16()
    z = direct_conv_blocked(x, w, stride, padding).contiguous()
    g = torch.randn(z.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(7)).bfloat16()
    return x, w, g, (None if act is None else z)


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         BF16_BWD_CASES)
def test_bf16_dgrad_kernels_match_plain_version(cuda, n, ci, co, h, cib, cob,
                                                stride, act, padding):
    if ci == 3:
        pytest.skip("the images' dx is never taken")
    x, w, g, z = _bf16_bwd_operands(cuda, n, ci, co, h, cib, cob, stride, act,
                                    padding)
    want = direct_conv_dgrad_blocked(g, w, (h, h), stride, padding, z, act)
    reset_launches()
    stk.reset_launches()
    for route in (False, True):
        dx = direct_conv2d_dgrad(g, w, (h, h), stride, padding, z, act,
                                 stream=route, precision="bf16")
        again = direct_conv2d_dgrad(g, w, (h, h), stride, padding, z, act,
                                    stream=route, precision="bf16")
        torch.cuda.synchronize()
        _bf16_close(dx, want)
        assert torch.equal(dx, again)
    assert LAUNCHES["direct_conv2d_dgrad_bf16"] == 2
    assert stk.LAUNCHES["conv2d_stream_dgrad_bf16"] == 2
    assert LAUNCHES["direct_conv2d_dgrad"] == stk.LAUNCHES[
        "conv2d_stream_dgrad"] == 0
    for streamed in (False, True):
        kernel, model = dgrad_plans(g, w, (h, h), stride, padding, z, act,
                                    streamed=streamed, dtype=torch.bfloat16)
        assert kernel == model
        assert kernel.issued_macs >= kernel.function_macs > 0


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         BF16_BWD_CASES)
def test_bf16_wgrad_kernels_match_plain_version(cuda, n, ci, co, h, cib, cob,
                                                stride, act, padding):
    x, w, g, z = _bf16_bwd_operands(cuda, n, ci, co, h, cib, cob, stride, act,
                                    padding)
    dz = conv2d_common.cotangent_prologue(g, z, act)     # bf16, rounded
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), dz.double(), 3, 3, stride, padding, with_db=True)
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        x.abs().double(), dz.abs().double(), 3, 3, stride, padding,
        with_db=True)
    reset_launches()
    stk.reset_launches()
    for route in (False, True):
        runs = [direct_conv2d_wgrad(x, g, 3, 3, stride, padding, z, act,
                                    with_db=True, stream=route,
                                    precision="bf16") for _ in range(2)]
        torch.cuda.synchronize()
        (dw, db), (dw2, db2) = runs
        assert dw.dtype == db.dtype == torch.float32
        assert ((dw.double() - want_dw).abs() <= WGRAD_REL * abs_dw).all()
        assert ((db.double() - want_db).abs() <= WGRAD_REL * abs_db).all()
        assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert LAUNCHES["direct_conv2d_wgrad_bf16"] == 2
    assert stk.LAUNCHES["conv2d_stream_wgrad_bf16"] == 2
    assert LAUNCHES["direct_conv2d_wgrad"] == stk.LAUNCHES[
        "conv2d_stream_wgrad"] == 0
    for streamed in (False, True):
        kernel, model = wgrad_plans(x, g, 3, 3, stride, padding, z, act,
                                    streamed=streamed, dtype=torch.bfloat16)
        assert kernel == model
        assert kernel.issued_macs >= kernel.function_macs > 0


# the bf16 wgrad tile's one-tap unit: A read by descriptor from a swizzled
# row `shift` (off a 1024-byte atom for shift % 8 != 0), its second 8 rows
# `gap` rows on (a row break of the window: gap != 8)
PROBE_CASES = [(0, 8), (1, 8), (3, 8), (7, 8), (5, 11), (2, 34), (9, 18),
               (6, 9)]


@pytest.mark.parametrize("shift,gap", PROBE_CASES)
def test_bf16_wgrad_unit_reads_a_by_descriptor_at_any_row(cuda, shift, gap):
    gen = torch.Generator(device=cuda).manual_seed(shift * 64 + gap)
    x = torch.randn((64, 64), device=cuda, generator=gen).bfloat16()
    d = torch.randn((16, 64), device=cuda, generator=gen).bfloat16()
    rows = torch.cat([x[shift:shift + 8], x[shift + gap:shift + gap + 8]])
    want = rows.double().t() @ d.double()
    got = wgrad_bf16_probe(x, d, shift, gap)
    torch.cuda.synchronize()
    # 16 exact bf16 products a sum, added in f32
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)


# (n, coblk, h, w, cob, act): Cob a multiple of 8 (16-byte units) and not
# (6 even, 125 and 3 odd: single lanes), linear (db alone)
DZ_CASES = [(2, 2, 9, 7, 64, "relu"), (3, 1, 14, 14, 128, "gelu"),
            (2, 3, 5, 6, 6, "relu"), (1, 2, 7, 7, 125, "gelu"),
            (2, 1, 8, 8, 3, "relu"), (4, 2, 6, 5, 16, None)]


@pytest.mark.parametrize("n,coblk,h,w,cob,act", DZ_CASES)
def test_dz_pass_is_the_prologue_bit_for_bit_with_its_db(cuda, n, coblk, h,
                                                         w, cob, act):
    gen = torch.Generator(device=cuda).manual_seed(cob)
    g = torch.randn((n, coblk, h, w, cob), device=cuda,
                    generator=gen).bfloat16()
    z = torch.randn(g.shape, device=cuda, generator=gen).bfloat16()
    z[0, 0, 0, 0, 0] = 0.0                       # relu's tie
    zz = None if act is None else z
    reset_launches()
    runs = [dz_partials(g, zz, act, True) for _ in range(2)]
    torch.cuda.synchronize()
    assert LAUNCHES["direct_conv2d_dz_bf16"] == 2
    want = conv2d_common.cotangent_prologue(g, zz, act)
    (ws, dz, db), (_, dz2, db2) = runs
    assert dz.dtype == torch.bfloat16
    if act == "gelu":
        # the kernel's f32 gelu' (tanhf, contracted multiply-adds) against
        # torch's elementwise ops: the same rounding to bf16 but where the
        # two f32 values straddle a bf16 tie, one bf16 ulp
        _bf16_close(dz, want)
    else:
        assert torch.equal(dz, want)
    assert torch.equal(dz, dz2) and torch.equal(db, db2)
    assert torch.equal(db.reshape(-1), conv2d_common.wgrad_reduce(ws))
    exact = want.double().sum(dim=(0, 2, 3))
    scale = want.double().abs().sum(dim=(0, 2, 3))
    assert ((db.double() - exact).abs() <= WGRAD_REL * scale).all()
    assert all(int(a.count_nonzero()) == 0 for a in split_sum.arenas())
    dz3, db3 = cotangent_pass(g, zz, act, False)
    assert db3 is None and torch.equal(dz3, dz)


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,padding",
                         [c for c in BF16_BWD_CASES if c[1] != 3
                          and c[7] is not None])
def test_bf16_dgrads_on_dz_are_their_prologue_bit_for_bit(
        cuda, n, ci, co, h, cib, cob, stride, act, padding):
    x, w, g, z = _bf16_bwd_operands(cuda, n, ci, co, h, cib, cob, stride, act,
                                    padding)
    dz, _ = cotangent_pass(g, z, act, False)
    for route in (False, True):
        with_prologue = direct_conv2d_dgrad(g, w, (h, h), stride, padding, z,
                                            act, stream=route,
                                            precision="bf16")
        on_dz = direct_conv2d_dgrad(dz, w, (h, h), stride, padding,
                                    stream=route, precision="bf16",
                                    prologue_tiles=True)
        torch.cuda.synchronize()
        assert torch.equal(on_dz, with_prologue)


# the bf16 dgrads at a filter whose phases take more taps than 3x3's do
# (5x5: 5 x 5 taps at stride 1; 3 x 3, 3 x 2, 2 x 3, 2 x 2 at stride 2),
# which the tap loop runs where the straight-line stages of filters up to
# 3x3 do not
@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_dgrad_kernels_take_a_5x5_filter(cuda, stride):
    gen = torch.Generator(device=cuda).manual_seed(5 + stride)
    n, ci, co, h = 2, 64, 128, 13
    ho = -(-h // stride)
    g = torch.randn((n, 1, ho, ho, co), device=cuda, generator=gen).bfloat16()
    z = torch.randn(g.shape, device=cuda, generator=gen).bfloat16()
    w = (torch.randn((1, 1, 5, 5, ci, co), device=cuda, generator=gen)
         / (25 * ci) ** 0.5).bfloat16()
    want = direct_conv_dgrad_blocked(g, w, (h, h), stride, "SAME", z, "relu")
    reset_launches()
    stk.reset_launches()
    for route in (False, True):
        dx = direct_conv2d_dgrad(g, w, (h, h), stride, "SAME", z, "relu",
                                 stream=route, precision="bf16")
        torch.cuda.synchronize()
        _bf16_close(dx, want)
    assert LAUNCHES["direct_conv2d_dgrad_bf16"] == 1
    assert stk.LAUNCHES["conv2d_stream_dgrad_bf16"] == 1


# the kernel library's own carve-up of a bf16 dgrad CTA (its shared memory
# and both rings' slots, from its *_plan entry) is the Python model's
# (core.blocking.dgrad_bf16_smem_bytes, dgrad_bf16_rings) at every tile the
# choosers take on the main paths: VGG-16's dgrads on both routes, with the
# prologue and without, MobileNet's pointwise legs, and the copies' paths
def test_bf16_dgrad_plans_hold_the_model_carve_up_at_the_chosen_tiles(cuda):
    from repro_torch.launch.dgrad_tiles_ab import dgrad_layers
    from repro_torch.launch.pointwise_tiles_ab import pointwise_legs
    cases = [(8, ci, co, s, h, 3, min(co, 128))
             for _, ci, co, s, h in dgrad_layers()]
    cases += [(32, ci, co, 1, h, 1, min(co, 128))
              for ci, co, h in pointwise_legs()]
    cases += [(8, 64, 6, 2, 56, 3, 6), (8, 512, 1000, 1, 14, 3, 125)]
    bf = torch.bfloat16
    for n, ci, co, s, h, f, cob in cases:
        cib = min(ci, 128)
        ho = -(-h // s)
        g = torch.empty((n, co // cob, ho, ho, cob), device=cuda, dtype=bf)
        w = torch.empty((co // cob, ci // cib, f, f, cib, cob), device=cuda,
                        dtype=bf)
        padding = "SAME" if f > 1 else "VALID"
        for z, act in ((g, "relu"), (None, None)):
            for streamed in (False, True):
                kernel, model = dgrad_plans(g, w, (h, h), s, padding, z, act,
                                            streamed=streamed, dtype=bf)
                assert kernel == model, (n, ci, co, s, h, streamed, act)
                assert kernel.window_slots >= 2 and kernel.weight_slots >= 2


def test_bf16_pointwise_wgrad_at_a_7x7_leg(cuda):
    # 49 positions a tile padded to 64 (K past the map zero), 1x1 flat rows
    n, ci, co, h, cib, cob = 4, 256, 192, 7, 128, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda,
                    generator=gen).bfloat16()
    g = torch.randn((n, co // cob, h, h, cob), device=cuda,
                    generator=gen).bfloat16()
    z = torch.randn(g.shape, device=cuda, generator=gen).bfloat16()
    dz = conv2d_common.cotangent_prologue(g, z, "relu")
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), dz.double(), 1, 1, 1, "VALID", with_db=True)
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        x.abs().double(), dz.abs().double(), 1, 1, 1, "VALID", with_db=True)
    pwk.reset_launches()
    dw, db = pwk.pointwise_wgrad(x, g, z, "relu", True, precision="bf16")
    torch.cuda.synchronize()
    assert pwk.LAUNCHES["conv2d_pointwise_wgrad_bf16"] == 1
    assert ((dw.double() - want_dw).abs() <= WGRAD_REL * abs_dw).all()
    assert ((db.double() - want_db).abs() <= WGRAD_REL * abs_db).all()


@pytest.mark.parametrize("streamed", [False, True])
def test_bf16_folded_wgrad_sums_its_workspace_in_order(cuda, streamed):
    n, ci, co, h, cib, cob, s = ((8, 128, 128, 28, 128, 128, 2) if streamed
                                 else (8, 64, 64, 56, 64, 64, 1))
    x, w, g, z = _bf16_bwd_operands(cuda, n, ci, co, h, cib, cob, s, "relu",
                                    "SAME")

    def launch():
        if streamed:
            return stk.stream_wgrad_partials(x, g, 3, 3, s, "SAME", z,
                                             "relu", True, precision="bf16")
        return wgrad_partials(x, g, 3, 3, s, "SAME", z, "relu", True,
                              precision="bf16")
    runs = [launch(), launch(), _graph_replay(launch)]
    torch.cuda.synchronize()
    for ws, out in runs:
        # the bf16 GEMM's rows are dw's; db is the dz pass's, at out's tail
        assert ws.shape[0] > 1
        assert torch.equal(out[:ws.shape[1]],
                           conv2d_common.wgrad_reduce(ws))
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][1], runs[2][1])
    assert all(int(a.count_nonzero()) == 0 for a in split_sum.arenas())


@pytest.mark.parametrize("streamed", [False, True])
def test_bf16_training_step_matches_the_plain_path(cuda, streamed):
    # a gelu + residual + GAP conv at stride 2 on Cib = 3 and a 64-lane
    # conv, both under BF16, against autograd of the same function on the
    # CPU's plain versions: the bf16 builds alone launch
    gen = torch.Generator().manual_seed(3)
    convs = [BlockedConv2D(3, 64, stride=2, activation="gelu", device=cuda,
                           generator=gen),
             BlockedConv2D(64, 64, stride=1, device=cuda, generator=gen)]
    model = BlockedCNN(convs, 10, device=cuda, generator=gen)
    images = torch.randn((2, 20, 20, 3), device=cuda)
    ctx = ConvContext(precision="bf16", stream=streamed)
    reset_launches()
    stk.reset_launches()
    model(images, context=ctx).float().square().sum().backward()
    torch.cuda.synchronize()
    got = [p.grad.clone() for p in model.parameters()]
    pre = "conv2d_stream" if streamed else "direct_conv2d"
    launched = {k: v for k, v in {**LAUNCHES, **stk.LAUNCHES}.items() if v}
    assert launched == {f"{pre}_fwd_bf16": 2, f"{pre}_dgrad_bf16": 1,
                        f"{pre}_wgrad_bf16": 2, "direct_conv2d_dz_bf16": 2}
    cpu = model.cpu()
    for p in cpu.parameters():
        p.grad = None
    cpu(images.cpu(), context=ctx).float().square().sum().backward()
    for a, p in zip(got, cpu.parameters()):
        scale = p.grad.abs().max().item()
        torch.testing.assert_close(a.cpu(), p.grad, rtol=0.0,
                                   atol=3e-2 * scale)


# ---------------------------------------------------------------------------
# the separable family's bf16 builds (pointwise_tile_kernel_bf16, the
# depthwise_*_kernel_bf16 walks, the dense dgrad_kernel_bf16 and
# wgrad_kernel_bf16 at 1x1) against their plain versions under BF16, with
# the tolerances of the dense bf16 builds above
# ---------------------------------------------------------------------------

# (n, ci, co, h, cib, cob, activation, residual, gap): Cib 3 (2-byte row
# copies) and 4 (4-byte), Cob 6 and 20 (2-byte weights, the dgrad's
# cp.async), MobileNet's last leg with its GAP
PW_BF16_CASES = [
    (2, 32, 64, 28, 32, 64, "relu", False, False),
    (2, 12, 20, 9, 4, 20, "gelu", True, False),
    (3, 1024, 1024, 7, 128, 128, "relu", False, True),
    (2, 16, 24, 5, 8, 8, "gelu", True, True),
    (2, 12, 18, 7, 4, 6, "relu", True, True),
    (2, 6, 16, 5, 3, 8, "gelu", False, True),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,act,res,gap", PW_BF16_CASES)
def test_pointwise_bf16_builds_match_plain_versions(cuda, n, ci, co, h, cib,
                                                    cob, act, res, gap):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda,
                    generator=g).bfloat16()
    w = torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=cuda,
                    generator=g) / ci ** 0.5
    b = torch.randn((co // cob, cob), device=cuda, generator=g)
    r = (torch.randn((n, co // cob, h, h, cob), device=cuda,
                     generator=g).bfloat16() if res else None)
    pwk.reset_launches()
    with torch.no_grad():
        got = pwk.pointwise_conv2d_blocked(x, w, b, 1, "VALID", act,
                                           residual=r, gap=gap,
                                           precision="bf16")
    want = direct_conv_blocked(x, w, 1, "VALID", b, act, "bf16", residual=r,
                               gap=gap)
    _bf16_close(got, want)
    if gap:
        pooled, parts = pwk.pointwise_gap(x, w, b, act, r, precision="bf16")
        torch.cuda.synchronize()
        assert torch.equal(pooled, got) and torch.equal(
            conv2d_common.gap_finalize(parts, h * h).to(pooled.dtype), pooled)
    wq = w.bfloat16()
    z = direct_conv_blocked(x, wq, 1, "VALID", b, None, "bf16").contiguous()
    ct = torch.randn(z.shape, device=cuda, generator=g).bfloat16()
    zz = None if act is None else z
    dx = pwk.pointwise_dgrad(ct, wq, zz, act, precision="bf16")
    _bf16_close(dx, direct_conv_dgrad_blocked(ct, wq, (h, h), 1, "VALID",
                                              zz, act, precision="bf16"))
    dz = conv2d_common.cotangent_prologue(ct, zz, act)
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), dz.double(), 1, 1, 1, "VALID", with_db=True)
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        x.abs().double(), dz.abs().double(), 1, 1, 1, "VALID", with_db=True)
    runs = [pwk.pointwise_wgrad(x, ct, zz, act, True, precision="bf16")
            for _ in range(2)]
    torch.cuda.synchronize()
    (dw, db), (dw2, db2) = runs
    assert dw.dtype == db.dtype == torch.float32
    assert ((dw.double() - want_dw).abs() <= WGRAD_REL * abs_dw).all()
    assert ((db.double() - want_db).abs() <= WGRAD_REL * abs_db).all()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert _ran(pwk) == {"conv2d_pointwise_fwd_bf16": 2 if gap else 1,
                         "conv2d_pointwise_dgrad_bf16": 1,
                         "conv2d_pointwise_wgrad_bf16": 2}


# (n, ci, co, h, cib, cob, activation, residual, gap, tile changes): items
# that span 7x7 and 5x5 images at one to three consumers (two at 128 lanes
# with GAP), a chunk of 128 as two swizzled halves, a lane split, the
# copies path (Cib 4, Cob 6), and more items than the card holds CTAs (the
# persistent grid walks them)
PW_BF16_TILES = [
    (8, 512, 256, 7, 128, 128, "relu", True, True,
     {"wgs": 3, "chunk": 64, "nsplit": 2}),
    (4, 256, 128, 7, 128, 128, "gelu", False, True, {"wgs": 2}),
    (8, 1024, 256, 7, 128, 128, "relu", False, True,
     {"wgs": 1, "chunk": 128}),
    (6, 256, 256, 5, 128, 128, "gelu", True, True, {"wgs": 2, "nsplit": 2}),
    (3, 12, 12, 7, 4, 6, "gelu", True, True, {}),
    (64, 256, 512, 14, 128, 128, "relu", False, False, {"wgs": 1}),
]


def _pw_bf16_tile(n, hw, kblk, kw, oblk, ow, gap, changes):
    """The chooser's bf16 tile with ``changes``, its GAP slots, box rows and
    the most ring slots that fit a CTA."""
    import dataclasses
    from repro_torch.core import blocking
    blk = blocking.choose_pointwise_blocking(n, hw, kblk, kw, oblk, ow,
                                             gap=gap, op_bytes=2)
    if "wgs" in changes:
        changes = dict(changes, rows=64 * changes["wgs"])
    if "nsplit" in changes:
        changes = dict(changes, lanes=blocking.dgrad_lanes(
            -(-ow // changes["nsplit"])))
    blk = dataclasses.replace(blk, **changes)
    brows = blocking.pointwise_bf16_brows(hw, blk.chunk)
    ring = max(r for r in range(2, 5) if blocking.pointwise_smem_bytes(
        blk.rows, blk.chunk, blk.lanes, blk.wgs, gap, 2, ring=r,
        brows=brows) <= blocking.H100_SXM.smem_block)
    return dataclasses.replace(
        blk, brows=brows, ring=ring,
        tiles=blocking.pointwise_bf16_gap_slots(n, hw, blk.rows))


@pytest.mark.parametrize("n,ci,co,h,cib,cob,act,res,gap,changes",
                         PW_BF16_TILES)
def test_pointwise_bf16_tiles_span_images(cuda, n, ci, co, h, cib, cob, act,
                                          res, gap, changes):
    import ctypes
    from repro_torch.core import blocking
    from repro_torch.kernels.direct_conv2d import _ACT_CODES
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda,
                    generator=g).bfloat16()
    w = (torch.randn((co // cob, ci // cib, 1, 1, cib, cob), device=cuda,
                     generator=g) / ci ** 0.5).bfloat16()
    b = torch.randn((co // cob, cob), device=cuda, generator=g)
    r = (torch.randn((n, co // cob, h, h, cob), device=cuda,
                     generator=g).bfloat16() if res else None)
    hw, kblk, oblk = h * h, ci // cib, co // cob
    blk = _pw_bf16_tile(n, hw, kblk, cib, oblk, cob, gap, changes)
    plan = pwk._tile_plan(n, hw, kblk, cib, oblk, cob, _ACT_CODES[act], gap,
                          blk, 2)
    got = (ctypes.c_longlong * 6)()
    assert pwk._lib().conv2d_pointwise_plan_bf16(plan.ints, got) == 0
    model = blocking.pointwise_plan(blk, n, hw, kblk, cib, oblk, cob, gap)
    assert blocking.PointwisePlan(*got) == model
    if changes.get("wgs") == 1 and n == 64:
        assert model.items > torch.cuda.get_device_properties(
            cuda).multi_processor_count

    def run():
        out = torch.empty((n, oblk, h, h, cob), device=cuda,
                          dtype=torch.bfloat16)
        parts = (torch.empty((n, oblk, blk.tiles, cob), device=cuda)
                 if gap else None)
        pooled = (torch.empty((n, oblk * cob), device=cuda,
                              dtype=torch.bfloat16) if gap else None)
        err = pwk.tile_launch(plan, cuda, (x.data_ptr(), w.data_ptr(),
                                           b.data_ptr(),
                                           None if r is None
                                           else r.data_ptr()),
                              out, parts, pooled)
        assert err == 0
        return out, parts, pooled
    (out, parts, pooled), (out2, parts2, pooled2) = run(), run()
    torch.cuda.synchronize()
    _bf16_close(out, direct_conv_blocked(x, w, 1, "VALID", b, act, "bf16",
                                         residual=r))
    assert torch.equal(out, out2)
    if gap:
        assert torch.equal(pooled, pooled2) and torch.equal(parts, parts2)
        assert torch.equal(conv2d_common.gap_finalize(parts, hw).to(
            pooled.dtype), pooled)
        _bf16_close(pooled, direct_conv_blocked(x, w, 1, "VALID", b, act,
                                                "bf16", residual=r, gap=True))
    assert not any(int(a.count_nonzero()) for a in split_sum.arenas())


# (n, c, h, cb, stride, dilation, filter, activation, residual, gap): the
# register paths (3x3 at stride 1 and 2), the tap loop (dilation 2, stride
# 3, 5x5), Cb 3 (2-byte cells), 6 (4-byte copies), 8, 32 and 128
DW_BF16_CASES = [
    (2, 32, 28, 32, 1, 1, 3, "relu", False, False),
    (2, 64, 28, 64, 2, 1, 3, "relu", True, False),
    (2, 256, 14, 128, 2, 1, 3, "relu", True, True),
    (2, 24, 13, 8, 1, 2, 3, "gelu", True, True),
    (2, 6, 9, 3, 2, 1, 3, None, False, False),
    (2, 16, 11, 8, 3, 1, 3, "relu", False, False),
    (2, 16, 12, 16, 1, 1, 5, "gelu", False, True),
    (2, 12, 10, 6, 1, 1, 3, None, True, False),
    (2, 24, 15, 6, 2, 1, 3, "relu", False, False),
]


@pytest.mark.parametrize("n,c,h,cb,s,dil,hf,act,res,gap", DW_BF16_CASES)
def test_depthwise_bf16_builds_match_plain_versions(cuda, n, c, h, cb, s,
                                                    dil, hf, act, res, gap):
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((n, c // cb, h, h, cb), device=cuda,
                    generator=g).bfloat16()
    w = torch.randn((c // cb, 1, hf, hf, 1, cb), device=cuda,
                    generator=g) / hf
    b = torch.randn((c // cb, cb), device=cuda, generator=g)
    wq = w.bfloat16()
    z = direct_conv_blocked(x, wq, s, "SAME", b, None, "bf16", groups=c,
                            dilation=dil).contiguous()
    r = (torch.randn(z.shape, device=cuda, generator=g).bfloat16() if res
         else None)
    dwk.reset_launches()
    with torch.no_grad():
        got = dwk.depthwise_conv2d_blocked(x, w, b, s, "SAME", act,
                                           residual=r, gap=gap, dilation=dil,
                                           precision="bf16")
    want = direct_conv_blocked(x, w, s, "SAME", b, act, "bf16", groups=c,
                               dilation=dil, residual=r, gap=gap)
    _bf16_close(got, want)
    if gap:
        pooled, parts = dwk.depthwise_gap(x, w, b, s, "SAME", act, r, dil,
                                          precision="bf16")
        torch.cuda.synchronize()
        hw = z.shape[2] * z.shape[3]
        assert torch.equal(pooled, got) and torch.equal(
            conv2d_common.gap_finalize(parts, hw).to(pooled.dtype), pooled)
    ct = torch.randn(z.shape, device=cuda, generator=g).bfloat16()
    zz = None if act is None else z
    dx = dwk.depthwise_dgrad(ct, wq, (h, h), s, "SAME", zz, act, dil,
                             precision="bf16")
    _bf16_close(dx, direct_conv_dgrad_blocked(ct, wq, (h, h), s, "SAME", zz,
                                              act, c, dil, precision="bf16"))
    dz = conv2d_common.cotangent_prologue(ct, zz, act)
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), dz.double(), hf, hf, s, "SAME", with_db=True, groups=c,
        dilation=dil)
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        x.abs().double(), dz.abs().double(), hf, hf, s, "SAME", with_db=True,
        groups=c, dilation=dil)
    runs = [dwk.depthwise_wgrad(x, ct, hf, hf, s, "SAME", zz, act, True, dil,
                                precision="bf16") for _ in range(2)]
    torch.cuda.synchronize()
    (dw, db), (dw2, db2) = runs
    assert dw.dtype == db.dtype == torch.float32
    assert ((dw.double() - want_dw).abs() <= WGRAD_REL * abs_dw).all()
    assert ((db.double() - want_db).abs() <= WGRAD_REL * abs_db).all()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert all(int(a.count_nonzero()) == 0 for a in split_sum.arenas())
    assert _ran(dwk) == {"conv2d_depthwise_fwd_bf16": 2 if gap else 1,
                         "conv2d_depthwise_dgrad_bf16": 1,
                         "conv2d_depthwise_wgrad_bf16": 2}


def test_separable_cnn_trains_and_serves_in_bf16_on_the_bf16_builds(cuda):
    # a small separable CNN (a dense first conv, then two blocks) one bf16
    # step on the card: only bf16 builds launch, each block's legs once
    # forward, the first block's dx skipped; the same step on a CPU copy
    # launches nothing and gives the gradients within BF16_TOL of their
    # max; then served in bf16 by ConvServer
    from repro_torch.launch.conv_serve import ConvServer
    from repro_torch.serve.scheduler import ConvRequest, Outcome
    gen = torch.Generator().manual_seed(5)
    convs = [BlockedConv2D(3, 16, stride=2, lane=8, device=cuda,
                           generator=gen),
             DepthwiseSeparableBlock(16, 24, stride=1, lane=8, device=cuda,
                                     generator=gen),
             DepthwiseSeparableBlock(24, 32, stride=2, lane=8, device=cuda,
                                     generator=gen)]
    model = BlockedCNN(convs, 4, device=cuda, generator=gen)
    images = torch.randn((2, 16, 16, 3), device=cuda)
    ctx = ConvContext(precision="bf16")
    mods = (pwk, dwk)
    for mod in mods:
        mod.reset_launches()
    reset_launches()
    model(images, context=ctx).float().square().sum().backward()
    torch.cuda.synchronize()
    got = [p.grad.clone() for p in model.parameters()]
    # the dz pass for the dense conv and the two pointwise legs
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "direct_conv2d_fwd_bf16": 1, "direct_conv2d_wgrad_bf16": 1,
        "direct_conv2d_dz_bf16": 3}
    assert _ran(pwk) == {"conv2d_pointwise_fwd_bf16": 2,
                         "conv2d_pointwise_dgrad_bf16": 2,
                         "conv2d_pointwise_wgrad_bf16": 2}
    assert _ran(dwk) == {"conv2d_depthwise_fwd_bf16": 2,
                         "conv2d_depthwise_dgrad_bf16": 2,
                         "conv2d_depthwise_wgrad_bf16": 2}
    cpu = model.cpu()
    for p in cpu.parameters():
        p.grad = None
    for mod in mods:
        mod.reset_launches()
    reset_launches()
    cpu(images.cpu(), context=ctx).float().square().sum().backward()
    assert not any(v for mod in mods for v in mod.LAUNCHES.values())
    assert not any(LAUNCHES.values())
    for a, p in zip(got, cpu.parameters()):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a.cpu(), p.grad, rtol=0.0,
                                   atol=3e-2 * p.grad.abs().max().item())
    model.to(cuda)
    server = ConvServer(model, [(16, 16)], 2, device=cuda, context=ctx)
    reqs = [ConvRequest(i, images[i].cpu().numpy()) for i in range(2)]
    for mod in mods:
        mod.reset_launches()
    for req in reqs:
        server.submit(req)
    server.run()
    assert all(req.outcome is Outcome.OK for req in reqs)
    assert _ran(pwk) == {"conv2d_pointwise_fwd_bf16": 2}
    assert _ran(dwk) == {"conv2d_depthwise_fwd_bf16": 2}


# grouped (Cig > 1) and dilated geometry on the window forward, both builds:
# (n, ci, co, h, cib, cob, filter, stride, padding, groups, dilation, act,
# residual, gap)
GROUPED_DILATED_CASES = [
    # AlexNet's conv2 at lane 128: Cib 48, Cob 96, pads (1, 1) at stride 2
    (2, 96, 192, 27, 48, 96, 5, 2, ((1, 1), (1, 1)), 2, 1, "relu", False,
     False),
    (2, 64, 64, 17, 64, 64, 3, 1, "SAME", 1, 2, "relu", True, False),
    (2, 16, 32, 29, 16, 32, 3, 1, "SAME", 1, 12, "gelu", False, False),
    (2, 64, 64, 19, 16, 16, 3, 2, "SAME", 4, 2, "relu", False, True),
    (2, 32, 64, 21, 16, 32, 3, 2, "SAME", 2, 3, None, True, False),
    # AlexNet's conv1: 11x11 at stride 4, Cib 3
    (1, 3, 48, 63, 3, 48, 11, 4, "VALID", 1, 1, "relu", False, False),
    # the GAP on a grouped layer (conv5 at lane 128: Cib 96, Cob 128)
    (2, 384, 256, 13, 96, 128, 3, 1, "SAME", 2, 1, "relu", False, True),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "n,ci,co,h,cib,cob,f,stride,padding,groups,dil,act,res,gap",
    GROUPED_DILATED_CASES)
def test_grouped_and_dilated_forward_matches_plain_version(
        cuda, dtype, n, ci, co, h, cib, cob, f, stride, padding, groups, dil,
        act, res, gap):
    g = torch.Generator(device=cuda).manual_seed(7)
    cig = ci // groups
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda, generator=g)
    w = torch.randn((co // cob, cig // cib, f, f, cib, cob), device=cuda,
                    generator=g) / (f * f * cig) ** 0.5
    b = torch.randn((co // cob, cob), device=cuda, generator=g)
    spec = ConvSpec.make(n, h, h, ci, co, f, f, stride, padding, groups, dil)
    r = (torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=cuda,
                     generator=g) if res else None)
    prec = "bf16" if dtype == "bf16" else "f32"
    if dtype == "bf16":
        x = x.bfloat16()
        r = None if r is None else r.bfloat16()
    reset_launches()
    with torch.no_grad():
        got = direct_conv2d_blocked(x, w, b, stride, padding, act,
                                    residual=r, gap=gap, precision=prec,
                                    groups=groups, dilation=dil)
        again = direct_conv2d_blocked(x, w, b, stride, padding, act,
                                      residual=r, gap=gap, precision=prec,
                                      groups=groups, dilation=dil)
        want = direct_conv_blocked(x, w, stride, padding, b, act, prec,
                                   groups, dil, residual=r, gap=gap)
    torch.cuda.synchronize()
    name = "direct_conv2d_fwd" + ("_bf16" if dtype == "bf16" else "")
    assert LAUNCHES[name] == 2 and sum(LAUNCHES.values()) == 2
    if dtype == "bf16":
        _bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)                  # no atomics: same bits
    kernel, model = fwd_plans(x, w, stride, padding, gap,
                              dtype=x.dtype, groups=groups, dilation=dil)
    assert kernel == model
    assert kernel.function_macs == spec.flops() // 2


# grouped (Cig > 1) and dilated geometry on the window dgrad and wgrad, both
# builds: (n, ci, co, h, cib, cob, filter, stride, padding, groups,
# dilation, dgrad)
GROUPED_DILATED_BWD_CASES = [
    # AlexNet's conv2: the grouped dgrad at Cib 48, the wgrad of its towers
    (2, 96, 256, 27, 48, 64, 5, 2, ((1, 1), (1, 1)), 2, 1, True),
    # dilation 2 at stride 2 (gcd 2: half the phases take no tap), and 3
    (2, 64, 64, 19, 16, 16, 3, 2, "SAME", 4, 2, True),
    (2, 64, 64, 18, 32, 32, 3, 2, "VALID", 1, 2, True),
    (2, 32, 64, 21, 16, 32, 3, 2, "SAME", 2, 3, True),
    # dilation 12 on a small map: the f32 tiles gather the taps' bands
    (2, 128, 128, 29, 128, 128, 3, 1, "SAME", 1, 12, True),
    # AlexNet's conv1 wgrad: 11x11 at stride 4, Cib 3
    (2, 3, 96, 63, 3, 48, 11, 4, "VALID", 1, 1, False),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "n,ci,co,h,cib,cob,f,stride,padding,groups,dil,dgrad",
    GROUPED_DILATED_BWD_CASES)
def test_grouped_and_dilated_backward_matches_plain_version(
        cuda, dtype, n, ci, co, h, cib, cob, f, stride, padding, groups, dil,
        dgrad):
    gen = torch.Generator(device=cuda).manual_seed(11)
    cig = ci // groups
    spec = ConvSpec.make(n, h, h, ci, co, f, f, stride, padding, groups, dil)
    x = torch.randn((n, ci // cib, h, h, cib), device=cuda, generator=gen)
    w = torch.randn((co // cob, cig // cib, f, f, cib, cob), device=cuda,
                    generator=gen) / (f * f * cig) ** 0.5
    z = torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=cuda,
                    generator=gen)
    g = torch.randn(z.shape, device=cuda, generator=gen)
    bf16 = dtype == "bf16"
    prec = "bf16" if bf16 else "f32"
    if bf16:
        x, w, z, g = x.bfloat16(), w.bfloat16(), z.bfloat16(), g.bfloat16()
    kw = dict(groups=groups, dilation=dil)
    sfx = "_bf16" if bf16 else ""
    if dgrad:
        reset_launches()
        got = direct_conv2d_dgrad(g, w, (h, h), stride, padding, z, "relu",
                                  precision=prec, **kw)
        again = direct_conv2d_dgrad(g, w, (h, h), stride, padding, z, "relu",
                                    precision=prec, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["direct_conv2d_dgrad" + sfx] >= 2
        want = direct_conv_dgrad_blocked(g, w, (h, h), stride, padding, z,
                                         "relu", **kw)
        if bf16:
            _bf16_close(got, want)
            dz, _ = cotangent_pass(g, z, "relu", False)
            on_dz = direct_conv2d_dgrad(dz, w, (h, h), stride, padding,
                                        precision=prec, prologue_tiles=True,
                                        **kw)
            assert torch.equal(on_dz, got)
        else:
            torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)
        kernel, model = dgrad_plans(g, w, (h, h), stride, padding, z, "relu",
                                    dtype=x.dtype, **kw)
        assert kernel == model
    reset_launches()
    dw, db = direct_conv2d_wgrad(x, g, f, f, stride, padding, z, "relu",
                                 True, precision=prec, **kw)
    dw2, db2 = direct_conv2d_wgrad(x, g, f, f, stride, padding, z, "relu",
                                   True, precision=prec, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["direct_conv2d_wgrad" + sfx] == 2
    assert dw.shape == w.shape and dw.dtype == torch.float32
    dz = conv2d_common.cotangent_prologue(g, z, "relu")
    want_dw, want_db = direct_conv_wgrad_blocked(
        x.double(), dz.double(), f, f, stride, padding, with_db=True, **kw)
    abs_dw, abs_db = direct_conv_wgrad_blocked(
        x.abs().double(), dz.abs().double(), f, f, stride, padding,
        with_db=True, **kw)
    assert ((dw.double() - want_dw).abs() <= WGRAD_REL * abs_dw).all()
    assert ((db.double() - want_db).abs() <= WGRAD_REL * abs_db).all()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    kernel, model = wgrad_plans(x, g, f, f, stride, padding, z, "relu",
                                dtype=x.dtype, **kw)
    assert kernel == model
    assert kernel.function_macs == spec.flops() // 2


def test_grouped_and_dilated_layer_trains_on_the_window_kernels(cuda):
    # autograd through a grouped and a dilated layer: gradients flow, the
    # window forward, dgrad and wgrad launched, the plain backward's values
    for kw in (dict(groups=2), dict(dilation=2)):
        conv = BlockedConv2D(32, 64, 3, 3, 2, "SAME", "relu", lane=16,
                             device=cuda, **kw)
        cb = conv.in_pencil
        x = torch.randn((2, 32 // cb, 15, 15, cb), device=cuda,
                        requires_grad=True)
        reset_launches()
        y = conv(x)
        ct = torch.randn_like(y)
        y.backward(ct)
        torch.cuda.synchronize()
        assert {k for k, v in LAUNCHES.items() if v} == {
            "direct_conv2d_fwd", "direct_conv2d_dgrad", "direct_conv2d_wgrad"}
        w, b = conv.w.detach(), conv.b.detach()
        z = direct_conv_blocked(x.detach(), w, 2, "SAME", b, None,
                                groups=conv.groups, dilation=conv.dilation)
        want = direct_conv_dgrad_blocked(ct, w, (15, 15), 2, "SAME", z,
                                         "relu", conv.groups, conv.dilation)
        torch.testing.assert_close(x.grad, want, **TOL)
        assert torch.isfinite(conv.w.grad).all()


def test_gathered_dilated_windows_match_plain_version(cuda):
    # the f32 tiles' band gather where the window is sparse: the wgrad's
    # rows and columns (TMA boxes a band; Cib 3 by cp.async) and the
    # dgrad's rows (a box a row; Cob 6 by cp.async), at tiles the choosers
    # weigh or that the launches take, each against the plain version
    from repro_torch.core import blocking as B
    gen = torch.Generator(device=cuda).manual_seed(13)
    for n, ci, co, h, cib, cob, d in ((2, 128, 128, 29, 128, 128, 12),
                                       (2, 3, 32, 33, 3, 32, 4)):
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, 1, "SAME", 1, d)
        x = torch.randn((n, ci // cib, h, h, cib), device=cuda, generator=gen)
        z = torch.randn((n, co // cob, h, h, cob), device=cuda, generator=gen)
        g = torch.randn(z.shape, device=cuda, generator=gen)
        dz = conv2d_common.cotangent_prologue(g, z, "relu")
        want, _ = direct_conv_wgrad_blocked(x.double(), dz.double(), 3, 3, 1,
                                            "SAME", dilation=d)
        scale, _ = direct_conv_wgrad_blocked(x.abs().double(),
                                             dz.abs().double(), 3, 3, 1,
                                             "SAME", dilation=d)
        found = {(b.th, b.tw, b.wgs, b.mpw): b for _, b in B.wgrad_candidates(
            n, h, h, 3, 3, 1, ci // cib, cib, co // cob, cob, B.H100_SXM,
            True, False, None, 4, 1, (d, d))
            if B.wgrad_staged(b.th, b.tw, 3, 3, 1, (d, d))[1] > 1}
        assert found
        for blk in list(found.values())[::max(1, len(found) // 3)][:3]:
            plan = dck.wgrad_launch_plan(blk, x.shape, g.shape, 3, 3, spec,
                                         1, True)
            err, _, out = dck.wgrad_launch(dck._bwd_lib().direct_conv2d_wgrad,
                                           plan, x, g, z)
            assert err == 0
            dw, _ = dck.split_wgrad(out, x.shape, g.shape, 3, 3, True)
            assert ((dw.double() - want).abs() <= WGRAD_REL * scale).all()
    for n, ci, co, h, cib, cob, d in ((2, 16, 16, 27, 16, 16, 12),
                                       (2, 16, 6, 27, 16, 6, 12)):
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, 1, "SAME", 1, d)
        w = torch.randn((co // cob, ci // cib, 3, 3, cib, cob), device=cuda,
                        generator=gen) / (9 * ci) ** 0.5
        z = torch.randn((n, co // cob, h, h, cob), device=cuda, generator=gen)
        g = torch.randn(z.shape, device=cuda, generator=gen)
        want = direct_conv_dgrad_blocked(g, w, (h, h), 1, "SAME", z, "relu",
                                         dilation=d)
        for th, tw in ((2, 8), (3, 21)):
            assert B.dgrad_gathered(th, 3, 1, d)
            blk = B.DgradBlocking(th=th, tw=tw, strips=1, wgs=1,
                                  lanes=B.dgrad_lanes(cib), chunk=8,
                                  mstride=64,
                                  hwin=B.dgrad_rows(th, 3, 1, d),
                                  wwin=tw + 2 * d)
            err, dx, _ = dck.dgrad_launch(
                dck._bwd_lib().direct_conv2d_dgrad, th, blk, g, w, spec, z,
                "relu")
            assert err == 0
            torch.testing.assert_close(dx, want, **TOL)


# ---------------------------------------------------------------------------
# the narrow rows (csrc/narrow_rows.cuh) and the bf16 wgrad's element-strided
# boxes: phase 27's shapes at batch 2
# ---------------------------------------------------------------------------

# (n, ci, co, h, filter, stride, padding, groups, cib, cob)
NARROW_CASES = [
    (2, 3, 96, 63, 11, 4, "VALID", 1, 3, 48),       # AlexNet's conv1
    (2, 96, 256, 27, 5, 2, ((1, 1), (1, 1)), 2, 48, 64),   # conv2 (wgrad)
    (2, 256, 384, 13, 3, 2, "VALID", 1, 64, 64),    # conv3 (wgrad)
    (2, 3, 64, 32, 3, 1, "SAME", 1, 3, 64),         # VGG-16's conv1_1
    (2, 3, 32, 32, 3, 2, "SAME", 1, 3, 32),         # MobileNet's conv1
    (2, 3, 64, 30, 7, 2, ((3, 3), (3, 3)), 1, 3, 64),
    (2, 8, 64, 20, 5, 1, "SAME", 1, 8, 64),         # 40-value runs
    (2, 64, 64, 31, 3, 2, "SAME", 1, 64, 64),       # odd widths
    (2, 48, 64, 31, 3, 2, "SAME", 1, 48, 64),
]


def _narrow_operands(dev, n, ci, co, h, f, stride, padding, groups, cib, cob,
                     seed=17):
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = ConvSpec.make(n, h, h, ci, co, f, f, stride, padding, groups)
    x = torch.randn((n, ci // cib, h, h, cib), device=dev,
                    generator=gen).bfloat16()
    w = torch.randn((co // cob, ci // groups // cib, f, f, cib, cob),
                    device=dev, generator=gen) / (f * f * ci) ** 0.5
    b = torch.randn((co // cob, cob), device=dev, generator=gen)
    g = torch.randn((n, co // cob, spec.ho, spec.wo, cob), device=dev,
                    generator=gen).bfloat16()
    return spec, x, w, b, g


def _least(found):
    """The least-cost candidate."""
    return min(found, key=lambda kb: kb[0])[1]


def _fwd_tiles(spec, cib, cob, narrow):
    """One path's forward tiles (the narrow rows or per tap)."""
    from repro_torch.core import blocking as B
    return B.fwd_candidates(spec.n, spec.ho, spec.wo, spec.hf, spec.wf,
                            spec.stride, spec.cig // cib, cib, spec.co // cob,
                            cob, B.H100_SXM, False, False, op_bytes=2,
                            narrow=narrow)


def _wgrad_tiles(spec, cib, cob, narrow):
    from repro_torch.core import blocking as B
    return B.wgrad_candidates(spec.n, spec.ho, spec.wo, spec.hf, spec.wf,
                              spec.stride, spec.ci // cib, cib,
                              spec.co // cob, cob, B.H100_SXM, False, False,
                              op_bytes=2, groups=spec.groups, narrow=narrow)


def _fwd_with(blk, x, w, b, spec):
    plan = dck.fwd_launch(spec, x.shape[4], w.shape[5], 1, False, False,
                          blk=blk, dtype=torch.bfloat16)
    err, out, _, _ = dck.fwd_run(dck._lib().direct_conv2d_fwd, plan, x, w, b,
                                 None, spec)
    assert err == 0
    return out


def _wgrad_with(blk, x, g, spec):
    lib = dck._bwd_lib()
    _, out = dck.bf16_wgrad(lib.direct_conv2d_wgrad_bf16, blk, x, g, spec,
                            None, None, False, dck.H100_SXM, LAUNCHES,
                            "direct_conv2d_wgrad_bf16", lib)
    return dck.split_wgrad(out, x.shape, g.shape, spec.hf, spec.wf, False,
                           spec.groups)[0]


@pytest.mark.parametrize("n,ci,co,h,f,stride,padding,groups,cib,cob",
                         NARROW_CASES)
def test_narrow_rows_and_strided_boxes_match_plain_versions(
        cuda, n, ci, co, h, f, stride, padding, groups, cib, cob):
    from repro_torch.core import blocking as B
    spec, x, w, b, g = _narrow_operands(cuda, n, ci, co, h, f, stride,
                                        padding, groups, cib, cob)
    narrow = B.narrow_fits(f, f, cib)
    want_dw, _ = direct_conv_wgrad_blocked(x.double(), g.double(), f, f,
                                           stride, padding, groups=groups)
    scale, _ = direct_conv_wgrad_blocked(x.abs().double(), g.abs().double(),
                                         f, f, stride, padding, groups=groups)
    # the chooser's wgrad tile and, where the rows fit, the least-cost
    # narrow one; each twice, bit for bit
    wtiles = [B.choose_wgrad_blocking(n, spec.ho, spec.wo, f, f, stride,
                                      ci // cib, cib, co // cob, cob,
                                      op_bytes=2, groups=groups)]
    if narrow:
        wtiles.append(_least(_wgrad_tiles(spec, cib, cob, True)))
    for blk in wtiles:
        reset_launches()
        dw, dw2 = (_wgrad_with(blk, x, g, spec) for _ in range(2))
        torch.cuda.synchronize()
        assert dck.NARROW_LAUNCHES["wgrad_kernel_bf16_narrow"] == \
            2 * blk.narrow
        assert ((dw.double() - want_dw).abs() <= WGRAD_REL * scale).all()
        assert torch.equal(dw, dw2)
    if not narrow:
        return
    want = direct_conv_blocked(x, w, stride, padding, b, "relu", "bf16")
    for blk in (B.choose_fwd_blocking(n, spec.ho, spec.wo, f, f, stride,
                                      ci // cib, cib, co // cob, cob,
                                      op_bytes=2),
                _least(_fwd_tiles(spec, cib, cob, True))):
        reset_launches()
        got, again = (_fwd_with(blk, x, w, b, spec) for _ in range(2))
        torch.cuda.synchronize()
        _bf16_close(got, want)
        assert torch.equal(got, again)


@pytest.mark.parametrize("n,ci,co,h,f,stride,padding,groups,cib,cob",
                         [c for c in NARROW_CASES if c[8] == 3])
def test_narrow_rows_against_the_per_tap_tiles(cuda, n, ci, co, h, f, stride,
                                               padding, groups, cib, cob):
    # at Cib 3 the narrow rows and the per-tap tile (pinned) compute the
    # same function: each within phase 23's rules of the other
    spec, x, w, b, g = _narrow_operands(cuda, n, ci, co, h, f, stride,
                                        padding, groups, cib, cob, seed=19)
    fwd = [_fwd_with(_least(_fwd_tiles(spec, cib, cob, k)), x, w, b, spec)
           for k in (True, False)]
    _bf16_close(fwd[0], fwd[1])
    dws = [_wgrad_with(_least(_wgrad_tiles(spec, cib, cob, k)), x, g, spec)
           for k in (True, False)]
    scale, _ = direct_conv_wgrad_blocked(x.abs().double(), g.abs().double(),
                                         f, f, stride, padding)
    assert ((dws[0].double() - dws[1].double()).abs()
            <= 2 * WGRAD_REL * scale).all()


def test_dense_bf16_tiles_keep_their_per_tap_tiles_past_conv1(cuda):
    # VGG-16's layers past conv1_1 take no narrow row: the chooser's bf16
    # forward and wgrad tiles are the per-tap ones, each within phase 23's
    # rules of the plain version and bit for bit across two runs (their
    # bits against the parent build: launch/bits_ab.py)
    from repro_torch.core import blocking as B
    for ci, co, s, h in ((64, 64, 1, 20), (64, 128, 2, 21), (128, 128, 1, 9)):
        spec, x, w, b, g = _narrow_operands(cuda, 2, ci, co, h, 3, s, "SAME",
                                            1, ci, co)
        fwd = B.choose_fwd_blocking(2, spec.ho, spec.wo, 3, 3, s, 1, ci, 1,
                                    co, op_bytes=2)
        wgr = B.choose_wgrad_blocking(2, spec.ho, spec.wo, 3, 3, s, 1, ci, 1,
                                      co, op_bytes=2)
        assert not fwd.narrow and not wgr.narrow
        got, again = (_fwd_with(fwd, x, w, b, spec) for _ in range(2))
        _bf16_close(got, direct_conv_blocked(x, w, s, "SAME", b, "relu",
                                             "bf16"))
        assert torch.equal(got, again)
        dw, dw2 = (_wgrad_with(wgr, x, g, spec) for _ in range(2))
        want, _ = direct_conv_wgrad_blocked(x.double(), g.double(), 3, 3, s,
                                            "SAME")
        scale, _ = direct_conv_wgrad_blocked(x.abs().double(),
                                             g.abs().double(), 3, 3, s,
                                             "SAME")
        assert ((dw.double() - want).abs() <= WGRAD_REL * scale).all()
        assert torch.equal(dw, dw2)


def test_narrow_row_instances_hold_wgmma_and_spill_nothing(cuda):
    # phase 2's rules on the new instances: HGMMA in each, the forward's
    # fewer WARPGROUP.DEPBAR than HGMMA, no spill (ptxas's report)
    import re
    import shutil
    import subprocess
    from repro_torch.kernels._build import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, kernel in (("direct_conv2d_fwd", "fwd_kernel_bf16_narrow"),
                         ("direct_conv2d_bwd", "wgrad_kernel_bf16_narrow")):
        res = build(name)
        spills = {}
        fn = None
        for line in res.log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn is not None and kernel in fn:
                spills[fn] = (int(m.group(1)), int(m.group(2)))
        assert spills and all(v == (0, 0) for v in spills.values()), spills
        sass = subprocess.run([tool, "-sass", str(res.path)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = [0, 0]
            elif fn is not None and "HGMMA" in line:
                counts[fn][0] += 1
            elif fn is not None and "WARPGROUP.DEPBAR" in line:
                counts[fn][1] += 1
        mine = {k: v for k, v in counts.items() if kernel in k}
        assert mine
        for k, (hg, dep) in mine.items():
            assert hg > 0, k
            if "fwd" in kernel:
                assert dep < hg, (k, hg, dep)
