"""The rest of the dense main path against the JAX reference, on the CPU.

The layout helpers (pad to block and strip, ``blocked_shapes``,
``assert_zero_overhead``) bit for bit ``repro.core.layout``'s; every
function of ``core.memory_model`` exactly ``repro.core.memory_model``'s on
VGG-16's and MobileNet v1's layer shapes; the baselines of
``core.conv_baselines`` within 1e-5 (``conv_lax``, ``conv_im2col``) and
1e-4 (``conv_fft``) of max|y| of JAX's; ``direct_conv_nhwc`` against the
reference's; ``ResidualBlock`` in a narrow ``BlockedCNN`` against the JAX
model under ``ConvContext(impl="jnp")`` on the same weights (1e-5 of
max|y|: f32 sums in other orders) and one autograd step against torch
autograd through the plain forward; the GAP replay bit for bit a numpy
emulation of the forward tile's in-tile order, at tiles that leave rows
past the map, and within 1e-6 of max of JAX's pooled features.
Inputs come from numpy seeds; shapes are a few layers at pencils of 8."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import conv_baselines as jbase  # noqa: E402
from repro.core import layout as jlayout  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.context import ConvContext as JContext  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.core.direct_conv import direct_conv_nhwc as jax_conv_nhwc  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro_torch.configs.cnn import mobilenet_v1_layers, vgg16_layers  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import blocking, conv2d_common  # noqa: E402
from repro_torch.core import conv_baselines as base  # noqa: E402
from repro_torch.core import layout  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core.direct_conv import (direct_conv_blocked,  # noqa: E402
                                          direct_conv_nhwc)
from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked  # noqa: E402
from repro_torch.nn.conv import (BlockedCNN, BlockedConv2D,  # noqa: E402
                                 ResidualBlock)


def _rng(seed):
    return np.random.default_rng(seed)


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,cb", [(8, 8), (6, 4), (5, 8), (12, 8), (3, 3)])
def test_pad_to_block_maps_round_trip_as_the_reference(c, cb):
    x = _rng(0).normal(size=(2, 3, 4, c)).astype(np.float32)
    want = np.asarray(jlayout.nhwc_to_blocked(jnp.asarray(x), cb,
                                              pad_to_block=True))
    got = layout.nhwc_to_blocked(torch.from_numpy(x), cb, pad_to_block=True)
    np.testing.assert_array_equal(got.numpy(), want)
    back = layout.blocked_to_nhwc(got, c=c)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jlayout.blocked_to_nhwc(jnp.asarray(want),
                                                         c=c)))
    if c % cb:
        with pytest.raises(ValueError, match="pad_to_block"):
            layout.nhwc_to_blocked(torch.from_numpy(x), cb)
    with pytest.raises(ValueError, match="strip"):
        layout.blocked_to_nhwc(got, c=got.shape[1] * cb + 1)


@pytest.mark.parametrize("ci,co,cib,cob", [(8, 8, 8, 8), (5, 6, 4, 4),
                                           (3, 10, 3, 8)])
def test_pad_to_block_weights_as_the_reference(ci, co, cib, cob):
    w = _rng(1).normal(size=(3, 3, ci, co)).astype(np.float32)
    want = np.asarray(jlayout.hwio_to_blocked(jnp.asarray(w), cib, cob,
                                              pad_to_block=True))
    got = layout.hwio_to_blocked(torch.from_numpy(w), cib, cob,
                                 pad_to_block=True)
    np.testing.assert_array_equal(got.numpy(), want)
    back = layout.blocked_to_hwio(got)[:, :, :ci, :co]
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize("n,cap", [(7, 128), (3, 8), (256, 128), (13, 4)])
def test_choose_pencil_pad_to_block_and_shapes(n, cap):
    assert layout.choose_pencil(n, cap, pad_to_block=True) == \
        jlayout.choose_pencil(n, cap, pad_to_block=True) == min(n, cap)
    cb = layout.choose_pencil(n, cap, min_util=0.0)
    assert layout.blocked_shapes(2, 5, 6, n, cb) == \
        tuple(jlayout.blocked_shapes(2, 5, 6, n, cb))
    layout.assert_zero_overhead((2, 5, 6, n),
                                layout.blocked_shapes(2, 5, 6, n, cb))
    with pytest.raises(AssertionError, match="element count"):
        layout.assert_zero_overhead((2, 5, 6, n), (2, 1, 5, 6, n + 1))
    with pytest.raises(AssertionError):
        jlayout.assert_zero_overhead((2, 5, 6, n), (2, 1, 5, 6, n + 1))


# ---------------------------------------------------------------------------
# memory model
# ---------------------------------------------------------------------------

def _layer_shapes():
    """VGG-16's 13 convs and MobileNet v1's legs (224x224, batch 8) as
    ``(name, n, hi, ci, co, hf, stride, groups)``."""
    out, h = [], 224
    for i, (ci, co, s) in enumerate(vgg16_layers()):
        out.append((f"vgg{i}", 8, h, ci, co, 3, s, 1))
        h = -(-h // s)
    h = 224
    for i, (kind, ci, co, s) in enumerate(mobilenet_v1_layers()):
        if kind == "conv":
            out.append((f"mb{i}", 8, h, ci, co, 3, s, 1))
        else:
            out.append((f"mb{i}dw", 8, h, ci, ci, 3, s, ci))
            h = -(-h // s)
            out.append((f"mb{i}pw", 8, h, ci, co, 1, 1, 1))
            continue
        h = -(-h // s)
    return out


SHAPES = _layer_shapes()


def _shapes(pad):
    ours = [mm.ConvShape(name, n, h, h, ci, co, hf, hf, s, pad, groups)
            for name, n, h, ci, co, hf, s, groups in SHAPES]
    theirs = [jmm.ConvShape(name, n, h, h, ci, co, hf, hf, s, pad, groups)
              for name, n, h, ci, co, hf, s, groups in SHAPES]
    return ours, theirs


@pytest.mark.parametrize("pad", ["SAME", "VALID", 1])
def test_memory_model_is_the_references_on_vgg16_and_mobilenet(pad):
    ours, theirs = _shapes(pad)
    for s, t in zip(ours, theirs):
        for attr in ("ho", "wo", "padded_hi", "padded_wi", "cig", "hf_eff"):
            assert getattr(s, attr) == getattr(t, attr), (s.name, attr)
        assert s.flops() == t.flops() and s.pads == t.pads
        for db in (4, 2):
            assert s.base_bytes(db) == t.base_bytes(db)
            for algo in ("direct", "im2col", "mec", "fft"):
                assert mm.bytes_overhead(s, algo, db) == \
                    jmm.bytes_overhead(t, algo, db), (s.name, algo)
            assert mm.bytes_channel_pad(s, 128, db) == \
                jmm.bytes_channel_pad(t, 128, db)
            for flags in ({}, {"residual": True}, {"gap": True},
                          {"residual": True, "gap": True, "act_bwd": True}):
                assert mm.bytes_epilogue_fusion(s, db, **flags) == \
                    jmm.bytes_epilogue_fusion(t, db, **flags)
        for pol in ("f32", "bf16"):
            assert mm.bytes_precision_split(s, pol) == \
                jmm.bytes_precision_split(t, pol)
    assert mm.chain_repack_bytes(ours) == jmm.chain_repack_bytes(theirs)
    assert mm.overhead_table(ours) == jmm.overhead_table(theirs)
    with pytest.raises(ValueError, match="unknown algorithm"):
        mm.bytes_overhead(ours[0], "winograd")


@dataclasses.dataclass(frozen=True)
class _RefBlocking:
    hob: int
    wob: int
    cob: int


def test_halo_refetch_reads_the_ports_forward_tiles():
    # tiles that divide the map: the reference's formula on (hob, wob, cob)
    ours, theirs = _shapes("SAME")
    for s, t in zip(ours, theirs):
        if s.groups > 1:
            continue
        for th, tw in ((s.ho, s.wo), (1, s.wo), (s.ho // 2 or 1, 1)):
            if s.ho % th or s.wo % tw:
                continue
            cob = min(s.co, 128)
            blk = blocking.FwdBlocking(th=th, tw=tw, wgs=1, strips=1,
                                       lanes=cob, nsplit=1, chunk=8,
                                       tiles=0, hwin=0, wwin=0)
            assert mm.bytes_halo_refetch(s, blk) == jmm.bytes_halo_refetch(
                t, _RefBlocking(th, tw, cob)), (s.name, th, tw)
    # the chooser's tiles, the map's edge overhung: never negative, zero
    # for one tile over the map
    for s in ours:
        if s.groups > 1 or s.hf == 1:
            continue
        cib, cob = min(s.ci, 128), min(s.co, 128)
        blk = blocking.choose_fwd_blocking(s.n, s.ho, s.wo, 3, 3, s.stride,
                                           s.ci // cib, cib, s.co // cob,
                                           cob)
        assert mm.bytes_halo_refetch(s, blk) >= 0
        one = dataclasses.replace(blk, th=s.ho, tw=s.wo)
        assert mm.bytes_halo_refetch(s, one) == 0


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_baselines_match_the_references(stride, padding):
    rng = _rng(2)
    x = rng.normal(size=(2, 11, 10, 6)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 6, 8)) / np.sqrt(54)).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = np.asarray(jbase.conv_lax(jx, jw, stride, padding))
    scale = np.abs(want).max()
    for got, rel in ((base.conv_lax(tx, tw, stride, padding), 1e-5),
                     (base.conv_im2col(tx, tw, stride, padding), 1e-5),
                     (base.conv_fft(tx, tw, stride, padding), 1e-4)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rel * scale)
    np.testing.assert_allclose(
        base.conv_fft(tx, tw, stride, padding).numpy(),
        np.asarray(jbase.conv_fft(jx, jw, stride, padding)), rtol=0,
        atol=1e-4 * scale)
    xp = base.pad_input(tx, padding, 3, 3, stride)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jbase.pad_input(jx, padding, 3, 3, stride)))
    cols = base.im2col(xp, 3, 3, stride)
    np.testing.assert_array_equal(
        cols.numpy(), np.asarray(jbase.im2col(jnp.asarray(xp.numpy()), 3, 3,
                                              stride)))


def test_conv_lax_takes_groups_and_dilation():
    rng = _rng(3)
    x = rng.normal(size=(1, 9, 9, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 2, 8)).astype(np.float32)
    want = np.asarray(jbase.conv_lax(jnp.asarray(x), jnp.asarray(w), 1,
                                     "SAME", groups=4, dilation=2))
    got = base.conv_lax(torch.from_numpy(x), torch.from_numpy(w), 1, "SAME",
                        groups=4, dilation=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("ci,co,pad_to_block,lane", [
    (6, 8, False, 128), (5, 7, True, 4), (8, 16, False, 8)])
def test_direct_conv_nhwc_matches_the_reference(ci, co, pad_to_block, lane):
    rng = _rng(4)
    x = rng.normal(size=(2, 9, 8, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    want = np.asarray(jax_conv_nhwc(jnp.asarray(x), jnp.asarray(w), 2,
                                    "SAME", jnp.asarray(b), "relu",
                                    pad_to_block=pad_to_block, lane=lane))
    got = direct_conv_nhwc(torch.from_numpy(x), torch.from_numpy(w), 2,
                           "SAME", torch.from_numpy(b), "relu",
                           pad_to_block=pad_to_block, lane=lane)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# ResidualBlock
# ---------------------------------------------------------------------------

def _residual_models(seed=5):
    """A narrow BlockedCNN with two ResidualBlocks, the JAX one and the
    port's on the same numpy weights."""
    jconvs = (jconv.BlockedConv2D(3, 8, stride=1, padding="SAME",
                                  activation="relu"),
              jconv.ResidualBlock(jconv.BlockedConv2D(8, 8, padding="SAME",
                                                      activation="gelu")),
              jconv.BlockedConv2D(8, 16, stride=2, padding="SAME",
                                  activation="relu"),
              jconv.ResidualBlock(jconv.BlockedConv2D(16, 16, padding="SAME",
                                                      activation="relu")))
    jmodel = jconv.BlockedCNN(convs=jconvs, n_classes=5)
    rng = _rng(seed)
    tree = {}
    for key, spec in jmodel.specs().items():
        if key == "head":
            tree[key] = rng.normal(size=spec.shape).astype(np.float32)
        else:
            fan = np.prod(spec["w"].shape[1:5])
            tree[key] = {
                "w": (rng.normal(size=spec["w"].shape) / np.sqrt(fan))
                .astype(np.float32),
                "b": (0.1 * rng.normal(size=spec["b"].shape))
                .astype(np.float32)}
    convs = [BlockedConv2D(3, 8, device="cpu"),
             ResidualBlock(8, 8, activation="gelu", device="cpu"),
             BlockedConv2D(8, 16, stride=2, device="cpu"),
             ResidualBlock(16, 16, device="cpu")]
    port = BlockedCNN(convs, 5, device="cpu")
    port.load_state_dict(params_from_jax(tree, device="cpu"))
    return jmodel, tree, port


def test_residual_block_checks_and_forward():
    with pytest.raises(ValueError, match="identity"):
        ResidualBlock(8, 16, device="cpu")
    with pytest.raises(ValueError, match="identity"):
        ResidualBlock(8, 8, stride=2, device="cpu")
    block = ResidualBlock(8, 8, activation="gelu", device="cpu")
    x = torch.from_numpy(_rng(6).normal(size=(2, 1, 7, 7, 8))
                         .astype(np.float32))
    with pytest.raises(ValueError, match="own skip"):
        block(x, residual=x)
    with torch.no_grad():
        got = block(x)
    jblock = jconv.ResidualBlock(jconv.BlockedConv2D(8, 8, padding="SAME",
                                                     activation="gelu"))
    p = {"w": jnp.asarray(block.w.detach().numpy()),
         "b": jnp.asarray(block.b.detach().numpy())}
    want = np.asarray(jblock(p, jnp.asarray(x.numpy()),
                             context=JContext(impl="jnp")))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_residual_cnn_matches_the_jax_model():
    jmodel, tree, port = _residual_models()
    x = _rng(7).normal(size=(2, 12, 12, 3)).astype(np.float32)
    want = np.asarray(jmodel(_jnp_tree(tree), jnp.asarray(x),
                             context=JContext(impl="jnp")))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    back = params_to_numpy(port)
    for key, leaf in tree.items():
        if key == "head":
            np.testing.assert_array_equal(back[key], leaf)
        else:
            for k in ("w", "b"):
                np.testing.assert_array_equal(back[key][k], leaf[k])


def test_residual_cnn_autograd_step_matches_plain_autograd():
    _, _, port = _residual_models()
    x = torch.from_numpy(_rng(8).normal(size=(2, 12, 12, 3))
                         .astype(np.float32))
    ct = torch.from_numpy(_rng(9).normal(size=(2, 5)).astype(np.float32))
    (port(x) * ct).sum().backward()
    got = {k: p.grad.clone() for k, p in port.named_parameters()}
    params = {k: p.detach().clone().requires_grad_()
              for k, p in port.named_parameters()}
    h = layout.nhwc_to_blocked(x, port.convs[0].in_pencil)
    last = len(port.convs) - 1
    for i, c in enumerate(port.convs):
        h = direct_conv_blocked(
            h, params[f"convs.{i}.w"], c.stride, c.padding,
            params[f"convs.{i}.b"], c.activation,
            residual=h if isinstance(c, ResidualBlock) else None,
            gap=i == last)
    ((h @ params["head"]) * ct).sum().backward()
    for k, g in got.items():
        want = params[k].grad
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# GAP replay
# ---------------------------------------------------------------------------

def _kernel_gap(out, blk):
    """The forward tile's GAP written out thread by thread in numpy f32:
    each consumer thread's two rows, the warp's shfl_xor 4, 8, 16 steps
    (lane ^ m: row group g ^ (m / 4)), the warps in order from 0, the
    tiles in index order, times the f32 reciprocal of Ho*Wo."""
    f = out.to(torch.float32).numpy()
    n, coblk, ho, wo, cob = f.shape
    streamed = blk.strips > 1
    ms = blk.th // blk.strips * blk.tw if streamed else 64 * blk.wgs
    across = -(-wo // blk.tw)
    tiles = -(-ho // blk.th) * across
    zero = np.zeros((n, coblk, cob), np.float32)
    parts = []
    for tile in range(tiles):
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        red = []
        for wid in range(4 * blk.wgs):
            wg, w4 = divmod(wid, 4)
            t = []
            for g in range(8):
                v = []
                for h in range(2):
                    q = (0 if streamed else 64 * wg) + 16 * w4 + g + 8 * h
                    p = (wg * ms if streamed else 0) + q
                    oh, ow = oh0 + p // blk.tw, ow0 + p % blk.tw
                    live = (q < ms and p < blk.th * blk.tw and oh < ho
                            and ow < wo)
                    v.append(f[:, :, oh, ow] if live else zero)
                t.append(v[0] + v[1])
            for m in (1, 2, 4):          # shfl_xor 4, 8, 16 lanes
                t = [t[g] + t[g ^ m] for g in range(8)]
            red.append(t[0])
        s = zero
        for r in red:
            s = s + r
        parts.append(s)
    acc = parts[0]
    for s in parts[1:]:
        acc = acc + s
    return (acc * (np.float32(1) / np.float32(ho * wo))).reshape(n, -1)


def _gap_tiles(ho, wo):
    """The chooser's tiles and some that overhang the map: window tiles of
    one to three consumer warpgroups, streamed bands of two and three
    strips."""
    b = blocking.FwdBlocking
    return [blocking.choose_fwd_blocking(2, ho, wo, 3, 3, 1, 1, 8, 1, 8),
            blocking.choose_stream_fwd_blocking(2, ho, wo, 3, 3, 1, 1, 8, 1,
                                                8),
            b(5, 3, 1, 1, 8, 1, 8, 0, 0, 0), b(9, 13, 2, 1, 8, 1, 8, 0, 0, 0),
            b(7, 20, 3, 1, 8, 1, 8, 0, 0, 0), b(4, 3, 2, 2, 8, 1, 8, 0, 0, 0),
            b(6, 7, 3, 3, 8, 1, 8, 0, 0, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gap_replay_is_the_tiles_order_bit_for_bit(dtype):
    out = torch.from_numpy(_rng(10).normal(size=(2, 2, 11, 13, 8))
                           .astype(np.float32)).to(dtype)
    for blk in _gap_tiles(11, 13):
        got = conv2d_common.gap_replay(out, blk)
        assert got.dtype == dtype
        want = torch.from_numpy(_kernel_gap(out, blk)).to(dtype)
        assert torch.equal(got, want), blk
    # another order of the same sum differs somewhere: the replay is the
    # kernel's order, not any sum
    flat = out.to(torch.float32).mean(dim=(2, 3)).reshape(2, -1)
    assert not all(torch.equal(conv2d_common.gap_replay(out, blk)
                               .to(torch.float32), flat)
                   for blk in _gap_tiles(11, 13))


@pytest.mark.parametrize("stream", [False, True])
def test_plain_path_pools_in_the_kernels_order_near_jax(stream):
    rng = _rng(11)
    x = rng.normal(size=(2, 1, 15, 15, 8)).astype(np.float32)
    w = (rng.normal(size=(2, 1, 3, 3, 8, 8)) / np.sqrt(72)).astype(np.float32)
    b = rng.normal(size=(2, 8)).astype(np.float32)
    got = direct_conv2d_blocked(*(torch.from_numpy(a) for a in (x, w, b)), 1,
                                "SAME", "relu", gap=True, stream=stream)
    args = (2, 15, 15, 3, 3, 1, 1, 8, 2, 8, blocking.H100_SXM, True)
    blk = (blocking.choose_stream_fwd_blocking(*args) if stream
           else blocking.choose_fwd_blocking(*args))
    out = direct_conv_blocked(torch.from_numpy(x), torch.from_numpy(w), 1,
                              "SAME", torch.from_numpy(b), "relu")
    assert torch.equal(got, torch.from_numpy(_kernel_gap(out, blk)))
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), 1, "SAME",
                               jnp.asarray(b), "relu", gap=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
