"""The port's streamed (halo-ring) family against the JAX reference's.

On the CPU each streamed wrapper computes its plain version after the same
routing and blocking checks as on the card, so these tests hold the port's
streamed path against the reference's streamed Pallas kernels in interpret
mode (``stream=True, interpret=True``), which run under the installed jax.
f32 throughout, ``rtol = atol = 1e-5``: both sides sum the same f32
products in other orders.  Also here: the Hopper streamed blocking models at
every VGG-16 shape, the routing vocabulary (``KernelRoute``,
``stream_flag``, ``route_stream``, ``ConvContext``) and a narrow VGG-style
``BlockedCNN`` served and trained with ``ConvContext(stream=True)``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext as JConvContext  # noqa: E402
from repro.core.dispatch import KernelRoute as JKernelRoute  # noqa: E402
from repro.core.dispatch import stream_flag as jstream_flag  # noqa: E402
from repro.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked_pallas, direct_conv2d_dgrad_pallas,
    direct_conv2d_wgrad_pallas)
from repro.nn import conv as jconv  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch.configs.cnn import vgg16_layers  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.blocking import (H100_SXM, MachineModel,  # noqa: E402
                                       SmemMisfitError)
from repro_torch.core.context import ConvContext, as_context  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.dispatch import (KernelRoute,  # noqa: E402
                                       resolve_stream, route_stream,
                                       stream_flag)
from repro_torch.core.errors import TransientError  # noqa: E402
from repro_torch.core.padding import normalize_padding  # noqa: E402
from repro_torch.kernels import conv2d_stream  # noqa: E402
from repro_torch.kernels import direct_conv2d  # noqa: E402
from repro_torch.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked, direct_conv2d_dgrad, direct_conv2d_wgrad)
from repro_torch.launch.conv_serve import ConvServer  # noqa: E402
from repro_torch.nn.conv import (BlockedCNN, BlockedConv2D,  # noqa: E402
                                 DepthwiseSeparableBlock)
from repro_torch.serve.scheduler import ConvRequest, Outcome  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.trainstep import make_train_step  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}
TINY = MachineModel(name="tiny", threads=256, smem_budget=1024,
                    smem_block=1024)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _operands(seed, n, ci, co, h, cib, cob, stride, residual=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, h, cib)).astype(np.float32)
    w = (rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
         / np.sqrt(9 * ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    ho = -(-h // stride)
    r = (rng.normal(size=(n, co // cob, ho, ho, cob)).astype(np.float32)
         if residual else None)
    g = rng.normal(size=(n, co // cob, ho, ho, cob)).astype(np.float32)
    return x, w, b, r, g


def _pads(n, h, ci, co, stride):
    return ConvSpec.make(n, h, h, ci, co, 3, 3, stride, "SAME").pads


def _padded(x, pads):
    (pt, pb), (pl, pr) = pads
    return np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr), (0, 0)))


def _preactivation(x, w, b, stride):
    """z of the forward, through the reference's jnp oracle."""
    from repro.core.direct_conv import direct_conv_blocked as jax_conv
    return np.asarray(jax_conv(_j(x), _j(w), stride, "SAME", _j(b), None))


# ---------------------------------------------------------------------------
# each wrapper against the reference's streamed Pallas kernel (interpret)
# ---------------------------------------------------------------------------

# (n, ci, co, h, cib, cob, stride, activation, residual, gap, hso)
FWD_CASES = [
    (2, 4, 8, 8, 4, 8, 1, "relu", False, False, None),
    (2, 4, 8, 8, 4, 8, 1, "relu", False, False, 1),
    (2, 8, 8, 8, 4, 8, 2, "gelu", False, False, 2),
    (2, 8, 16, 8, 8, 8, 1, "gelu", True, False, 2),
    (2, 8, 16, 12, 8, 8, 2, "relu", True, True, 1),
    (2, 3, 8, 16, 3, 8, 2, "relu", False, True, 2),          # Cib = 3
    (2, 4, 4, 6, 4, 4, 1, None, True, True, None),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,res,gap,hso",
                         FWD_CASES)
def test_stream_forward_matches_pallas_stream_interpret(
        n, ci, co, h, cib, cob, stride, act, res, gap, hso):
    x, w, b, r, _ = _operands(0, n, ci, co, h, cib, cob, stride, res)
    want = np.asarray(direct_conv2d_blocked_pallas(
        _j(x), _j(w), _j(b), stride=stride, padding="SAME", activation=act,
        stream=True, hso=hso, interpret=True, residual=_j(r), gap=gap))
    got = direct_conv2d_blocked(_t(x), _t(w), _t(b), stride, "SAME", act,
                                residual=_t(r), gap=gap, stream=True,
                                hso=hso)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the module's own entry point is the same function
    again = conv2d_stream.stream_forward(_t(x), _t(w), _t(b), stride, "SAME",
                                         act, _t(r), gap, hso=hso)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


# (n, ci, co, h, cib, cob, stride, activation, hso)
DGRAD_CASES = [
    (2, 4, 8, 8, 4, 8, 1, "relu", None),
    (2, 4, 8, 8, 4, 8, 1, "gelu", 2),
    (2, 8, 8, 9, 4, 4, 2, "relu", 1),
    (2, 8, 16, 10, 8, 8, 2, None, None),
    (2, 8, 8, 8, 8, 8, 2, "gelu", None),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,hso", DGRAD_CASES)
def test_stream_dgrad_matches_pallas_stream_interpret(n, ci, co, h, cib, cob,
                                                      stride, act, hso):
    x, w, b, _, g = _operands(1, n, ci, co, h, cib, cob, stride)
    z = _preactivation(x, w, b, stride) if act else None
    dxp = np.asarray(direct_conv2d_dgrad_pallas(
        _j(g), _j(w), stride=stride, stream=True, hso=hso, interpret=True,
        z=_j(z), activation=act))
    # the reference's gradient is w.r.t. the padded input, at the touched
    # extents: embed, then crop the pads
    pads = _pads(n, h, ci, co, stride)
    full = np.zeros(_padded(x, pads).shape, np.float32)
    full[:, :, :dxp.shape[2], :dxp.shape[3]] = dxp
    (pt, _), (pl, _) = pads
    want = full[:, :, pt:pt + h, pl:pl + h]
    got = direct_conv2d_dgrad(_t(g), _t(w), (h, h), stride, "SAME", _t(z),
                              act, stream=True, hso=hso)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (n, ci, co, h, cib, cob, stride, activation, with_db, hso)
WGRAD_CASES = [
    (2, 4, 8, 8, 4, 8, 1, "relu", True, None),
    (2, 4, 8, 8, 4, 8, 1, "gelu", True, 2),
    (2, 8, 8, 9, 4, 4, 2, "relu", False, 1),
    (2, 3, 8, 16, 3, 8, 2, "relu", True, 2),
    (2, 8, 16, 12, 8, 8, 2, None, True, 2),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,act,with_db,hso",
                         WGRAD_CASES)
def test_stream_wgrad_matches_pallas_stream_interpret(
        n, ci, co, h, cib, cob, stride, act, with_db, hso):
    x, w, b, _, g = _operands(2, n, ci, co, h, cib, cob, stride)
    z = _preactivation(x, w, b, stride) if act else None
    xp = _padded(x, _pads(n, h, ci, co, stride))
    want = direct_conv2d_wgrad_pallas(
        _j(xp), _j(g), 3, 3, stride=stride, stream=True, hso=hso,
        interpret=True, z=_j(z), activation=act, with_db=with_db)
    want_dw, want_db = want if with_db else (want, None)
    dw, db = direct_conv2d_wgrad(_t(x), _t(g), 3, 3, stride, "SAME", _t(z),
                                 act, with_db, stream=True, hso=hso)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)
    if with_db:
        np.testing.assert_allclose(db.numpy(), np.asarray(want_db), **TOL)
    else:
        assert db is None


# ---------------------------------------------------------------------------
# the Hopper streamed blocking models at every VGG-16 shape
# ---------------------------------------------------------------------------

def _vgg_shapes(entry):
    out, h = [], entry
    for ci, co, s in vgg16_layers():
        out.append((ci, co, s, h))
        h = ConvSpec.make(1, h, h, ci, co, 3, 3, s, "SAME").ho
    return sorted(set(out), key=out.index)


@pytest.mark.parametrize("entry", [224, 160])
def test_stream_forward_blocking_at_every_vgg16_shape(entry):
    n = 8
    for ci, co, s, h in _vgg_shapes(entry):
        cib, cob = min(ci, 128), min(co, 128)
        spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
        for gap in (False, True):
            blk = blocking.choose_stream_fwd_blocking(
                n, spec.ho, spec.wo, 3, 3, s, ci // cib, cib, co // cob, cob,
                gap=gap)
            # a band of two or three strips of hso rows, each one consumer
            # warpgroup's 64-row m-tile; bands may overhang the map
            assert blk.strips == blk.wgs and 2 <= blk.wgs <= \
                blocking.FWD_CONSUMERS and blk.th == blk.strips * blk.hso
            assert blk.mstride == blk.hso * blk.tw <= 64
            assert blk.th < spec.ho + blk.strips and blk.tw <= spec.wo
            assert blk.lanes in blocking.DGRAD_LANES
            assert (blk.nsplit - 1) * blk.lanes < cob <= blk.nsplit * blk.lanes
            assert (-(-cib // 8) * 8) % blk.chunk == 0
            assert (blk.hwin, blk.wwin) == ((blk.th - 1) * s + 3,
                                            (blk.tw - 1) * s + 3)
            smem = blocking.fwd_smem_bytes(blk.th, blk.tw, 3, 3, s,
                                           blk.chunk, blk.lanes, blk.wgs,
                                           gap)
            assert smem <= H100_SXM.smem_block
            # the grid fills the card where the map has the positions
            grid = n * (co // cob) * blk.nsplit * blk.tiles
            assert grid >= min(H100_SXM.sms,
                               n * (co // cob) * spec.ho * spec.wo // 192)


@pytest.mark.parametrize("entry", [224, 160])
def test_stream_dgrad_blocking_at_every_vgg16_shape(entry):
    n = 8
    for ci, co, s, h in _vgg_shapes(entry):
        cib, cob = min(ci, 128), min(co, 128)
        blk = blocking.choose_stream_dgrad_blocking(
            n, h, h, 3, 3, s, ci // cib, cib, cob, prologue=True)
        # a band of two or three strips of hso phase rows, each one
        # consumer warpgroup's 64-row m-tile
        assert blk.strips == blk.wgs and 2 <= blk.wgs <= \
            blocking.DGRAD_CONSUMERS and blk.th == blk.strips * blk.hso
        assert blk.mstride == blk.hso * blk.tw <= 64
        assert blk.lanes == blocking.dgrad_lanes(cib) and cob % blk.chunk == 0
        hp = -(-h // s)
        assert blk.th < hp + blk.strips and blk.tw <= hp   # bands may overhang
        smem = blocking.dgrad_smem_bytes(3, 3, s, blk.lanes, blk.chunk,
                                         blk.hwin, blk.wwin, True, True)
        assert smem <= H100_SXM.smem_block
        assert (blk.hwin, blk.wwin) == (blk.th + -(-3 // s) - 1,
                                        blk.tw + -(-3 // s) - 1)
        # the grid fills the card where the map has the positions for it
        pads = normalize_padding("SAME", 3, 3, s, h, h)
        grid = n * (ci // cib) * len(blocking.dgrad_tiles(
            blk, h, h, 3, 3, s, pads))
        assert grid >= min(H100_SXM.sms, n * (ci // cib) * h * h // 128)


@pytest.mark.parametrize("entry", [224, 160])
def test_stream_wgrad_blocking_at_every_vgg16_shape(entry):
    n = 8
    for ci, co, s, h in _vgg_shapes(entry):
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        blk = blocking.choose_stream_wgrad_blocking(
            n, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob, prologue=True)
        # strips of hso rows down each column, a stage of at most
        # WGRAD_MAX_POSITIONS positions, every (tap, c) row in some m-tile
        assert 1 <= blk.hso * blk.wob <= blocking.WGRAD_MAX_POSITIONS
        assert blocking.wgrad_smem_bytes(
            blk.hso, blk.wob, 3, 3, s, cib, cob, blk.lanes,
            True) <= H100_SXM.smem_block
        assert blk.items == n * -(-ho // blk.wob) * -(-ho // blk.hso)
        assert blk.groups * blk.wgs * blk.mpw * 64 >= 9 * cib
        # the shares' workspace stays within the one the choosers allow
        assert 1 <= blk.splits <= blk.items
        assert blk.splits == 1 or 4 * blk.splits * (
            9 * ci * co + co) <= blocking.WGRAD_WORKSPACE_BYTES


def test_stream_choosers_raise_smem_misfit_on_a_tiny_machine():
    assert issubclass(SmemMisfitError, TransientError)
    assert issubclass(SmemMisfitError, ValueError)
    with pytest.raises(SmemMisfitError, match="no streamed band fits"):
        blocking.choose_stream_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64,
                                            TINY)
    with pytest.raises(SmemMisfitError, match="no streamed dgrad tile fits"):
        blocking.choose_stream_dgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 64,
                                              TINY)
    with pytest.raises(SmemMisfitError, match="no streamed wgrad strip fits"):
        blocking.choose_stream_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64,
                                              TINY)
    # the window choosers raise the same type, with their old messages
    with pytest.raises(SmemMisfitError, match="no tile fits"):
        blocking.choose_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64, TINY)
    with pytest.raises(SmemMisfitError, match="no wgrad tile fits"):
        blocking.choose_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64, TINY)


def test_pinned_strip_height_must_divide():
    with pytest.raises(ValueError, match="hso=3 must divide"):
        blocking.choose_stream_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 8,
                                              hso=3)
    with pytest.raises(ValueError, match="hso=3 must divide"):
        blocking.choose_stream_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 8,
                                            hso=3)
    blk = blocking.choose_stream_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 8,
                                              hso=2)
    assert blk.hso == 2 and blk.th % 2 == 0


# ---------------------------------------------------------------------------
# routing: KernelRoute, stream_flag, route_stream, the wrappers' rules
# ---------------------------------------------------------------------------

ROUTES = [None, True, False, (True, None, False), (None, True, True),
          (False, False, None)]


@pytest.mark.parametrize("stream", ROUTES)
def test_stream_flag_and_kernel_route_match_reference(stream):
    port = KernelRoute(*stream) if isinstance(stream, tuple) else stream
    ref = JKernelRoute(*stream) if isinstance(stream, tuple) else stream
    for d in ("fwd", "dgrad", "wgrad"):
        assert stream_flag(port, d) == jstream_flag(ref, d)
    if isinstance(stream, tuple):
        assert port == KernelRoute(*stream) and hash(port) == hash(
            KernelRoute(*stream))
        assert _fields(port) == _fields(ref)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_resolve_stream_rules():
    assert resolve_stream(None, None, "fwd") is None
    assert resolve_stream(None, 2, "fwd") is True          # hso -> streamed
    assert resolve_stream(KernelRoute(dgrad=False), None, "dgrad") is False
    with pytest.raises(ValueError, match="cannot combine with stream=False"):
        resolve_stream(False, 2, "fwd")
    with pytest.raises(ValueError, match="dense-only"):
        resolve_stream(True, None, "fwd", groups=4)
    with pytest.raises(ValueError, match="dense-only"):
        resolve_stream(KernelRoute(wgrad=True), None, "wgrad",
                       dilation=(2, 2))
    assert resolve_stream(None, None, "fwd", groups=4) is False
    with pytest.raises(ValueError, match="unknown direction"):
        KernelRoute().get("bwd")


def test_wrappers_refuse_bad_routes():
    x, w, b, _, g = _operands(3, 2, 4, 8, 8, 4, 8, 1)
    xt, wt, gt = _t(x), _t(w), _t(g)
    with pytest.raises(ValueError, match="cannot combine with stream=False"):
        direct_conv2d_blocked(xt, wt, None, 1, "SAME", stream=False, hso=1)
    with pytest.raises(ValueError, match="cannot combine with stream=False"):
        direct_conv2d_dgrad(gt, wt, (8, 8), 1, "SAME", stream=False, hso=1)
    with pytest.raises(ValueError, match="cannot combine with stream=False"):
        direct_conv2d_wgrad(xt, gt, 3, 3, 1, "SAME", stream=False, hso=1)
    # a stream=True layer must be dense
    with pytest.raises(ValueError, match="dense-only"):
        BlockedConv2D(8, 8, groups=8, lane=8, stream=True, device="cpu")
    with pytest.raises(ValueError, match="dense-only"):
        BlockedConv2D(8, 16, 1, 1, lane=8, stream=KernelRoute(fwd=True),
                      device="cpu")
    # a machine may differ from H100_SXM only in budget and card size
    other = MachineModel(name="half", threads=128, smem_budget=48 * 1024)
    with pytest.raises(ValueError, match="compiled for"):
        direct_conv2d_blocked(xt, wt, None, 1, "SAME", machine=other)
    with pytest.raises(ValueError, match="compiled for"):
        direct_conv2d_wgrad(xt, gt, 3, 3, 1, "SAME", stream=True,
                            machine=other)


def test_route_stream_outcomes():
    """On the Hopper models the window fits every VGG-16 conv, and no shape
    misfits the window while the streamed model fits (the streamed kernels
    stage a ring of at least the window's rows and the same weight chunk):
    only the False and the raising outcomes occur.  The budget sweep pins
    that for small pencils down to the misfit floor."""
    for entry in (224, 160):
        for ci, co, s, h in _vgg_shapes(entry):
            spec = ConvSpec.make(8, h, h, ci, co, 3, 3, s, "SAME")
            for d in ("fwd", "dgrad", "wgrad"):
                assert route_stream(d, spec, min(ci, 128), min(co, 128),
                                    H100_SXM, prologue=True) is False
    outcomes = set()
    for budget in range(256, 16 * 1024, 256):
        m = MachineModel(name=f"b{budget}", threads=256, smem_budget=budget,
                         smem_block=budget)
        for c, h, s in ((8, 8, 1), (16, 9, 2), (32, 6, 1)):
            spec = ConvSpec.make(2, h, h, c, c, 3, 3, s, "SAME")
            for d in ("fwd", "dgrad", "wgrad"):
                try:
                    outcomes.add(route_stream(d, spec, c, c, m,
                                              prologue=True))
                except SmemMisfitError as e:
                    assert "window model" in str(e) and "streamed model" \
                        in str(e)
                    outcomes.add("misfit")
    assert outcomes == {False, "misfit"}


def test_conv_context_fields_and_defaults():
    a, b = ConvContext(stream=True, precision="f32"), ConvContext(
        stream=True, precision=ConvContext(precision="f32").precision)
    assert a == b and hash(a) == hash(b)
    assert as_context(None) == ConvContext() and as_context(a) is a
    with pytest.raises(TypeError, match="ConvContext"):
        as_context("stream")
    assert ConvContext().resolve_stream_for(False) is False
    assert a.resolve_stream_for(False) is True
    assert a.override(stream=None) is a
    assert a.override(stream=False).stream is False
    assert ConvContext().resolve_machine_for(H100_SXM) is H100_SXM
    assert ConvContext(machine=TINY).resolve_machine_for(H100_SXM) is TINY
    assert ConvContext().resolve_precision_for("f32").op_dtype == torch.float32
    # the reference's context carries the same three fields
    for f in ("machine", "stream", "precision"):
        assert hasattr(JConvContext(), f)


# ---------------------------------------------------------------------------
# a narrow VGG-style BlockedCNN, served and trained through the stream route
# ---------------------------------------------------------------------------

LAYERS = ((3, 8, 1), (8, 16, 2), (16, 16, 1))
N_CLASSES = 5


def _jax_model():
    convs = tuple(jconv.BlockedConv2D(ci, co, stride=s, padding="SAME",
                                      activation="relu", lane=8)
                  for ci, co, s in LAYERS)
    return jconv.BlockedCNN(convs=convs, n_classes=N_CLASSES)


def _port_model(tree, stream=None):
    convs = [BlockedConv2D(ci, co, stride=s, padding="SAME",
                           activation="relu", lane=8, stream=stream,
                           device="cpu") for ci, co, s in LAYERS]
    model = BlockedCNN(convs, N_CLASSES, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    return model


def _numpy_tree(jmodel, seed):
    rng = np.random.default_rng(seed)
    specs = jmodel.specs()
    tree = {}
    for i, (ci, _, _) in enumerate(LAYERS):
        s = specs[f"conv{i}"]
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) * np.sqrt(2.0 / (9 * ci)))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    tree["head"] = rng.normal(size=specs["head"].shape).astype(np.float32)
    return tree


def _tree_j(tree):
    return jax.tree.map(jnp.asarray, tree)


JSTREAM = JConvContext(impl="stream", stream=True, interpret=True)


def _spy(monkeypatch):
    """Count the streamed wrappers' calls and the window route's own
    blocking calls."""
    calls = {}
    for mod, attr in ((conv2d_stream, "stream_blocking"),
                      (conv2d_stream, "stream_dgrad"),
                      (conv2d_stream, "stream_wgrad"),
                      (direct_conv2d, "choose_fwd_blocking"),
                      (direct_conv2d, "choose_dgrad_blocking"),
                      (direct_conv2d, "choose_wgrad_blocking")):
        real = getattr(mod, attr)
        calls[attr] = 0

        def wrapped(*a, _real=real, _name=attr, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, attr, wrapped)
    return calls


def test_narrow_cnn_served_through_the_stream_route_matches_jax(monkeypatch):
    jmodel = _jax_model()
    tree = _numpy_tree(jmodel, seed=0)
    rng = np.random.default_rng(1)
    sizes = [(8, 8), (6, 8), (8, 5), (7, 7), (8, 8)]
    images = [rng.normal(size=(h, w, 3)).astype(np.float32) for h, w in sizes]
    calls = _spy(monkeypatch)
    server = ConvServer(_port_model(tree), [(8, 8)], batch=4, device="cpu",
                        context=ConvContext(stream=True))
    reqs = [ConvRequest(i, im) for i, im in enumerate(images)]
    for r in reqs:
        server.submit(r)
    server.run()
    assert all(r.outcome is Outcome.OK for r in reqs)
    # two forwards of three dense convs, all on the streamed route
    assert calls["stream_blocking"] == 6 and \
        calls["choose_fwd_blocking"] == 0
    padded = np.stack([server.bucketer.pad(im, (8, 8)) for im in images])
    want = np.asarray(jmodel(_tree_j(tree), jnp.asarray(padded),
                             context=JSTREAM))
    got = np.stack([r.logits for r in reqs])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_narrow_cnn_trained_through_the_stream_route_matches_jax(monkeypatch):
    steps, lr = 2, 1e-2
    jmodel = _jax_model()
    tree = _numpy_tree(jmodel, seed=2)
    rng = np.random.default_rng(3)
    batches = [{"images": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
                "targets": rng.integers(0, N_CLASSES, 4).astype(np.int32)}
               for _ in range(steps)]
    j_opt = jopt.AdamW(lr=lambda s: jnp.float32(lr), weight_decay=0.0)
    jstep = jax.jit(jtrainstep.make_train_step(
        jmodel, None, j_opt, jtrainstep.TrainSettings(context=JSTREAM)))
    jp = _tree_j(tree)
    js = j_opt.init(jp)
    for bt in batches:
        jp, js, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in bt.items()})

    calls = _spy(monkeypatch)
    model = _port_model(tree)
    opt = AdamW(lr=lambda t: lr, weight_decay=0.0)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, context=ConvContext(stream=True))
    for bt in batches:
        step(state, {k: torch.from_numpy(v) for k, v in bt.items()})
    # per step: three streamed forwards, two dgrads (the images need
    # none), three wgrads; no window route
    assert calls == {"stream_blocking": 3 * steps, "stream_dgrad": 2 * steps,
                     "stream_wgrad": 3 * steps, "choose_fwd_blocking": 0,
                     "choose_dgrad_blocking": 0, "choose_wgrad_blocking": 0}
    got = params_to_numpy(model)
    for name, want in tree.items():
        if isinstance(want, dict):
            for k in want:
                np.testing.assert_allclose(got[name][k],
                                           np.asarray(jp[name][k]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name}.{k}")
        else:
            np.testing.assert_allclose(got[name], np.asarray(jp[name]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_context_stream_leaves_separable_legs_alone(monkeypatch):
    """A context's stream reaches dense layers only; the default context
    keeps the window route (the models fit it)."""
    calls = _spy(monkeypatch)
    block = DepthwiseSeparableBlock(8, 16, lane=8, device="cpu")
    dense = BlockedConv2D(16, 16, lane=8, device="cpu")
    x = torch.randn(1, 1, 6, 6, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = block(x, context=ConvContext(stream=True))
        assert calls["stream_blocking"] == 0 and \
            calls["choose_fwd_blocking"] == 0
        a = dense(y, context=ConvContext(stream=True))
        assert calls["stream_blocking"] == 1
        b = dense(y)
        assert calls["choose_fwd_blocking"] == 1 and \
            calls["stream_blocking"] == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
