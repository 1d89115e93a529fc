"""Port value types and layouts against the JAX reference (CPU, small)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import convspec as jconvspec  # noqa: E402
from repro.core import layout as jlayout  # noqa: E402
from repro.core import padding as jpadding  # noqa: E402
from repro_torch.core import blocking, convspec, errors, layout, padding  # noqa: E402
from repro_torch.core import precision  # noqa: E402

PADDING_CASES = [
    ("SAME", 3, 3, 1, 8, 8),
    ("SAME", 3, 3, 2, 8, 8),       # even input, stride 2: (0, 1)
    ("SAME", 3, 3, 2, 7, 9),
    ("SAME", 1, 1, 2, 6, 6),
    ("SAME", 5, 3, 3, 10, 11),
    ("VALID", 3, 3, 2, 9, 9),
    (2, 3, 3, 1, None, None),
    (((1, 2), (0, 3)), 3, 3, 1, None, None),
]


@pytest.mark.parametrize("pad,hf,wf,stride,hi,wi", PADDING_CASES)
def test_normalize_padding_matches_reference(pad, hf, wf, stride, hi, wi):
    got = padding.normalize_padding(pad, hf, wf, stride, hi, wi)
    assert got == jpadding.normalize_padding(pad, hf, wf, stride, hi, wi)


def test_stride2_same_on_even_input_is_asymmetric():
    assert padding.normalize_padding("SAME", 3, 3, 2, 224, 224) == \
        ((0, 1), (0, 1))
    with pytest.raises(ValueError, match="requires the input size"):
        padding.normalize_padding("SAME", 3, 3, 2)
    assert padding.out_size(225, 3, 2) == jpadding.out_size(225, 3, 2) == 112


@pytest.mark.parametrize("n,hi,wi,ci,co,stride,pad", [
    (2, 8, 8, 4, 8, 1, "SAME"), (1, 9, 6, 3, 16, 2, "SAME"),
    (3, 7, 7, 8, 8, 2, "VALID"), (1, 224, 224, 3, 64, 2, "SAME")])
def test_convspec_matches_reference(n, hi, wi, ci, co, stride, pad):
    a = convspec.ConvSpec.make(n, hi, wi, ci, co, 3, 3, stride, pad)
    b = jconvspec.ConvSpec.make(n, hi, wi, ci, co, 3, 3, stride, pad)
    assert (a.pads, a.ho, a.wo, a.flops()) == (b.pads, b.ho, b.wo, b.flops())
    assert a.is_dense
    assert not convspec.ConvSpec.make(n, hi, wi, ci, co, 3, 3,
                                      dilation=2).is_dense
    assert convspec.as_dilation(3) == jconvspec.as_dilation(3) == (3, 3)


@pytest.mark.parametrize("n", [1, 3, 12, 64, 97, 224, 512, 4608])
def test_divisors_match_reference(n):
    assert layout.divisors(n) == jlayout.divisors(n)
    for cap in (1, 5, 16, 128):
        assert (layout.largest_divisor_leq(n, cap)
                == jlayout.largest_divisor_leq(n, cap))


def test_vgg16_pencils_match_reference():
    from repro_torch.configs.cnn import vgg16_layers
    pencils = [(layout.BlockedConvLayout.choose(ci, co).cb_in,
                layout.BlockedConvLayout.choose(ci, co).cb_out)
               for ci, co, _ in vgg16_layers()]
    want = [(jlayout.BlockedConvLayout.choose(ci, co).cb_in,
             jlayout.BlockedConvLayout.choose(ci, co).cb_out)
            for ci, co, _ in vgg16_layers()]
    assert pencils == want
    assert pencils[:4] == [(3, 64), (64, 64), (64, 128), (128, 128)]


def test_choose_pencil_warns_like_reference():
    with pytest.warns(UserWarning, match="fills"):
        layout.choose_pencil(131, 128)            # prime: pencil 1


@pytest.mark.parametrize("cb", [1, 3, 4])
def test_feature_map_round_trip_matches_reference(cb):
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 12)).astype(np.float32)
    got = layout.nhwc_to_blocked(torch.from_numpy(x), cb)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlayout.nhwc_to_blocked(x, cb)))
    np.testing.assert_array_equal(layout.blocked_to_nhwc(got).numpy(), x)
    with pytest.raises(ValueError):
        layout.nhwc_to_blocked(torch.from_numpy(x), 5)


@pytest.mark.parametrize("cib,cob", [(3, 8), (6, 4), (2, 16)])
def test_weight_round_trip_matches_reference(cib, cob):
    w = np.random.default_rng(1).normal(size=(3, 3, 6, 16)).astype(np.float32)
    got = layout.hwio_to_blocked(torch.from_numpy(w), cib, cob)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlayout.hwio_to_blocked(w, cib, cob)))
    np.testing.assert_array_equal(layout.blocked_to_hwio(got).numpy(), w)


def test_precision_policy():
    assert precision.resolve_precision(None) is precision.F32
    assert precision.resolve_precision("bf16").op_dtype == torch.bfloat16
    assert precision.F32.accum_dtype == torch.float32
    assert precision.resolve_precision(precision.BF16) is precision.BF16
    with pytest.raises(ValueError, match="accumulator"):
        precision.Precision(accum="bfloat16")
    with pytest.raises(ValueError, match="unknown precision"):
        precision.resolve_precision("fp8")


def test_error_taxonomy():
    assert errors.is_transient(errors.KernelLaunchError("x"))
    assert errors.classify(errors.DeadlineExceededError()) is \
        errors.TransientError
    assert errors.classify(ValueError()) is errors.FatalError
    assert not errors.is_transient(errors.FatalError())


@pytest.mark.parametrize("hi,ci,co,stride", [
    (226, 3, 64, 1), (226, 64, 64, 1), (225, 64, 128, 2), (114, 128, 128, 1),
    (57, 256, 512, 2), (30, 512, 512, 1), (16, 512, 512, 1), (12, 8, 16, 2)])
def test_blocking_fits_the_cta(hi, ci, co, stride):
    # the forward tiles (csrc/fwd_tile.cuh) over the padded input's output:
    # 64-row m-tiles of one image's positions by a compiled wgmma width (the
    # block or half of it), a chunk of k8 slices of Cib, one CTA's shared
    # memory, no consumer warpgroup without a row of its own
    m = blocking.H100_SXM
    cob, cib = min(co, 128), min(ci, 128)
    ho = (hi - 3) // stride + 1
    for gap in (False, True):
        for choose in (blocking.choose_fwd_blocking,
                       blocking.choose_stream_fwd_blocking):
            blk = choose(8, ho, ho, 3, 3, stride, ci // cib, cib, co // cob,
                         cob, gap=gap)
            assert blk.lanes in blocking.DGRAD_LANES
            assert (blk.nsplit - 1) * blk.lanes < cob <= blk.nsplit * blk.lanes
            # a 128-lane consumer's running sum: two consumers at most
            assert blk.lanes < 128 or blk.wgs <= blocking.FWD_WIDE_CONSUMERS
            assert blk.chunk % 8 == 0 and -(-cib // 8) * 8 % blk.chunk == 0
            if choose is blocking.choose_fwd_blocking:
                assert blk.strips == 1 and blk.th <= ho and blk.tw <= ho
                assert 64 * (blk.wgs - 1) < blk.th * blk.tw <= 64 * blk.wgs
            else:
                assert blk.strips == blk.wgs >= 2
                assert blk.hso * blk.tw <= 64 and blk.tw <= ho
            assert blk.tiles == -(-ho // blk.th) * -(-ho // blk.tw)
            assert (blk.hwin, blk.wwin) == ((blk.th - 1) * stride + 3,
                                            (blk.tw - 1) * stride + 3)
            assert blocking.fwd_smem_bytes(
                blk.th, blk.tw, 3, 3, stride, blk.chunk, blk.lanes, blk.wgs,
                gap) <= m.smem_block


def test_blocking_pins_and_misfit():
    # a small map takes the pencil's wgmma width and whole chunk, and its
    # tiles run in one round of the card's SMs
    blk = blocking.choose_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 8)
    assert (blk.wgs, blk.lanes, blk.nsplit, blk.chunk) == (1, 8, 1, 8)
    assert blk.tiles <= blocking.H100_SXM.sms
    # a 256-lane pencil splits in two 128-lane CTAs; past that none fits
    wide = blocking.choose_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 256)
    assert (wide.nsplit, wide.lanes) == (2, 128)
    with pytest.raises(blocking.SmemMisfitError, match="no tile fits"):
        blocking.choose_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 512)
    with pytest.raises(ValueError, match="empty forward"):
        blocking.choose_fwd_blocking(1, 0, 8, 3, 3, 1, 1, 8, 1, 8)
    small = dataclasses.replace(blocking.H100_SXM, smem_block=2048)
    with pytest.raises(blocking.SmemMisfitError, match="no tile fits"):
        blocking.choose_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 64,
                                     machine=small)
    with pytest.raises(blocking.SmemMisfitError,
                       match="no streamed band fits"):
        blocking.choose_stream_fwd_blocking(1, 8, 8, 3, 3, 1, 1, 8, 1, 64,
                                            machine=small)


@pytest.mark.parametrize("hi,ci,co,stride", [
    (224, 3, 64, 1), (224, 64, 64, 1), (224, 64, 128, 2), (112, 128, 128, 1),
    (56, 256, 512, 2), (28, 512, 512, 1), (14, 512, 512, 1), (11, 3, 16, 2)])
def test_backward_blocking_fits_the_cta(hi, ci, co, stride):
    m = blocking.H100_SXM
    cob, cib = min(co, 128), min(ci, 128)
    for prologue in (False, True):
        d = blocking.choose_dgrad_blocking(8, hi, hi, 3, 3, stride,
                                           ci // cib, cib, cob, m, prologue)
        # a tile of one phase of the unpadded input: 64-row wgmma tiles of
        # its positions by the Cib lanes, padded up to a compiled width
        assert d.lanes in blocking.DGRAD_LANES and cib <= d.lanes
        assert d.lanes < 2 * cib or d.lanes == 8
        assert d.strips == 1 and 1 <= d.wgs <= blocking.DGRAD_CONSUMERS
        assert d.th * d.tw <= d.mstride == 64 * d.wgs
        assert d.th <= -(-hi // stride) and d.tw <= -(-hi // stride)
        assert d.chunk % 8 == 0 and -(-cob // 8) * 8 % d.chunk == 0
        assert (d.hwin, d.wwin) == (d.th + -(-3 // stride) - 1,
                                    d.tw + -(-3 // stride) - 1)
        assert blocking.dgrad_smem_bytes(3, 3, stride, d.lanes, d.chunk,
                                         d.hwin, d.wwin, prologue) \
            <= m.smem_block
    ho = -(-hi // stride)
    for prologue in (False, True):
        wg = blocking.choose_wgrad_blocking(8, ho, ho, 3, 3, stride,
                                            ci // cib, cib, co // cob, cob,
                                            prologue=prologue)
        # a stage of th x tw output positions; the window and the staged
        # dz fit one CTA, and a consumer thread's accumulators 64 registers
        assert 1 <= wg.th * wg.tw <= blocking.WGRAD_MAX_POSITIONS
        assert blocking.wgrad_smem_bytes(wg.th, wg.tw, 3, 3, stride, cib,
                                         cob, wg.lanes, prologue) \
            <= m.smem_block
        assert wg.lanes in blocking.DGRAD_LANES and cob <= wg.lanes
        assert wg.lanes * wg.mpw <= 128
        # the m-tile groups cover the 9 * Cib (tap, c) rows
        rows = wg.groups * wg.wgs * wg.mpw * 64
        assert rows >= 9 * cib > rows - wg.wgs * wg.mpw * 64
        assert 1 <= wg.splits <= wg.tiles == (
            8 * -(-ho // wg.th) * -(-ho // wg.tw))
        assert 4 * wg.splits * (9 * ci * co + co) <= max(
            blocking.WGRAD_WORKSPACE_BYTES, 4 * (9 * ci * co + co))


def test_dgrad_window_covers_every_tap_a_tile_reaches():
    # a dx tile's rows reach cotangent rows (i + pad - dh) / s for the taps
    # that divide; the depthwise dgrad kernel stages hwin rows from
    # floor((i0 + pad - 2) / s): check that they hold every row reached, for
    # every tile phase
    for stride in (1, 2, 3):
        for hob in (1, 2, 5, 8):
            hwin, _ = blocking.dgrad_window(hob, 1, 3, 3, stride)
            for pad in (0, 1, 2):
                for i0 in range(0, 4 * hob, hob):
                    lo = (i0 + pad - 2) // stride
                    reach = [(i + pad - dh) // stride
                             for i in range(i0, i0 + hob) for dh in range(3)
                             if (i + pad - dh) % stride == 0]
                    assert lo <= min(reach) and max(reach) < lo + hwin


def test_wgrad_blocking_misfit_raises():
    tiny = blocking.MachineModel("tiny", threads=256, smem_budget=1024,
                                 smem_block=1024)
    with pytest.raises(ValueError, match="no wgrad tile fits"):
        blocking.choose_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64,
                                       machine=tiny)
    with pytest.raises(ValueError, match="widest wgmma"):
        blocking.choose_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 256, 1, 256)


# ---------------------------------------------------------------------------
# the separable family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap,groups", [
    (64, 128, 1), (64, 128, 4), (96, 16, 3), (1024, 128, 8), (30, 8, 5)])
def test_grouped_pencils_match_reference(n, cap, groups):
    assert layout.choose_pencil(n, cap, groups=groups) == \
        jlayout.choose_pencil(n, cap, groups=groups)
    with pytest.raises(ValueError, match="must divide"):
        layout.choose_pencil(n + 1, cap, groups=2 if n % 2 == 0 else 3)


@pytest.mark.parametrize("ci,co,lane,groups", [
    (32, 32, 128, 32), (1024, 1024, 128, 1024), (12, 12, 8, 12),
    (32, 64, 128, 1), (64, 128, 8, 4)])
def test_depthwise_layout_and_weight_shapes_match_reference(ci, co, lane,
                                                            groups):
    from repro.nn import conv as jconv
    from repro_torch.nn.conv import BlockedConv2D
    a = layout.BlockedConvLayout.choose(ci, co, lane, groups=groups)
    b = jlayout.BlockedConvLayout.choose(ci, co, lane, groups=groups)
    assert (a.cb_in, a.cb_out, a.cb_w, a.cb_weight) == \
        (b.cb_in, b.cb_out, b.cb_w, b.cb_weight)
    if groups in (1, ci):                 # what the port's layers build
        want = jconv.BlockedConv2D(ci, co, groups=groups,
                                   lane=lane).specs()["w"].shape
        got = BlockedConv2D(ci, co, groups=groups, lane=lane,
                            device="cpu").w.shape
        assert tuple(got) == tuple(want)
    spec = convspec.ConvSpec.make(2, 8, 8, ci, co, 3, 3, groups=groups)
    ref = jconvspec.ConvSpec.make(2, 8, 8, ci, co, 3, 3, groups=groups)
    assert (spec.is_grouped, spec.is_depthwise, spec.is_pointwise) == \
        (ref.is_grouped, ref.is_depthwise, ref.is_pointwise)
    one = convspec.ConvSpec.make(2, 8, 8, ci, co, 1, 1, padding="SAME")
    assert one.is_pointwise and one.is_pointwise == jconvspec.ConvSpec.make(
        2, 8, 8, ci, co, 1, 1, padding="SAME").is_pointwise


def _mobilenet_shapes():
    """Every distinct (ci, co, stride, input extent) of MobileNet's blocks
    at the server's two entries."""
    from repro_torch.configs.cnn import MOBILENET_V1_BLOCKS
    shapes = []
    for entry in (224, 160):
        h = -(-entry // 2)
        for ci, co, s in MOBILENET_V1_BLOCKS:
            shapes.append((ci, co, s, h))
            h = -(-h // s)
    return sorted(set(shapes))


@pytest.mark.parametrize("n", [8, 32])
def test_separable_choosers_fit_the_cta_at_every_mobilenet_shape(n):
    m = blocking.H100_SXM
    for ci, co, s, h in _mobilenet_shapes():
        cb, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        d = blocking.choose_depthwise_blocking(n, ci // cb, ho, ho, cb, 3, 3,
                                               s)
        assert ho % d.hob == 0 and ho % d.wob == 0 and cb % d.lanes == 0
        assert d.hob * d.wob <= (m.threads // d.lanes) * \
            blocking.DW_THREAD_POSITIONS
        assert blocking.depthwise_fwd_smem_bytes(d.hwin, d.wwin, d.lanes,
                                                 m) <= m.smem_budget
        assert (d.hwin, d.wwin) == (s * (d.hob - 1) + 3, s * (d.wob - 1) + 3)
        assert d.items == n * (ci // d.lanes) * (ho // d.hob) * (ho // d.wob)
        assert d.grid == min(d.items, m.wave)
        pads = padding.normalize_padding("SAME", 3, 3, s, h, h)
        for prologue in (False, True):
            d = blocking.choose_depthwise_dgrad_blocking(
                n, ci // cb, h, h, cb, 3, 3, s, (1, 1), pads, prologue)
            assert h % d.hob == 0 and h % d.wob == 0 and cb % d.lanes == 0
            assert d.hob * d.wob <= (m.threads // d.lanes) * \
                blocking.DW_THREAD_POSITIONS
            assert blocking.depthwise_dgrad_smem_bytes(
                d.hwin, d.wwin, d.lanes, prologue) <= m.smem_budget
            # the cotangent rows a tile reads: within the old bound, and
            # exactly a tile's at stride 1
            bound = blocking.dgrad_window(d.hob, d.wob, 3, 3, s)
            assert d.hwin <= bound[0] and d.wwin <= bound[1]
            if s == 1:
                assert (d.hwin, d.wwin) == (d.hob + 2, d.wob + 2)
            assert d.items == n * (ci // d.lanes) * (h // d.hob) * (
                h // d.wob)
            assert d.grid == min(d.items, m.wave)
        wg = blocking.choose_depthwise_wgrad_blocking(n, ci // cb, ho, ho, cb,
                                                      3, 3, s)
        assert ho % wg.hob == 0 and ho % wg.wob == 0 and cb % wg.lanes == 0
        assert blocking.depthwise_wgrad_smem_bytes(
            wg.hwin, wg.wwin, wg.hob, wg.wob, wg.lanes, 9, True) \
            <= m.smem_budget
        assert 1 <= wg.splits <= wg.per_column == n * (ho // wg.hob) * (
            ho // wg.wob)
        hw = ho * ho
        for gap in (False, True):
            p = blocking.choose_pointwise_blocking(n, hw, ci // cb, cb,
                                                   co // cob, cob, gap=gap)
            assert p.rows == blocking.PW_ROWS * p.wgs
            assert p.tiles == -(-hw // p.rows) and cb % p.chunk == 0
            assert p.lanes * p.nsplit >= cob > (p.nsplit - 1) * p.lanes
            assert blocking.pointwise_smem_bytes(
                p.rows, p.chunk, p.lanes, p.wgs, gap) <= m.smem_block
        # the pointwise dgrad: the dense dgrad tile at 1x1
        for prologue in (False, True):
            d = blocking.choose_dgrad_blocking(n, ho, ho, 1, 1, 1, ci // cb,
                                               cb, cob, prologue=prologue)
            assert d.lanes >= cb and (d.hwin, d.wwin) == (d.th, d.tw)
            assert blocking.dgrad_smem_bytes(
                1, 1, 1, d.lanes, d.chunk, d.hwin, d.wwin, prologue) \
                <= m.smem_block
        # the pointwise wgrad: the dense wgrad tile at 1x1, its rows the
        # Cib channels
        pw = blocking.choose_wgrad_blocking(n, ho, ho, 1, 1, 1, ci // cb, cb,
                                            co // cob, cob, prologue=True)
        assert blocking.wgrad_smem_bytes(pw.th, pw.tw, 1, 1, 1, cb, cob,
                                         pw.lanes, True) <= m.smem_block
        assert (pw.hwin, pw.wwin) == (pw.th, pw.tw) and pw.lanes >= cob
        assert pw.groups * pw.wgs * pw.mpw * 64 >= cb
        assert 1 <= pw.splits <= pw.tiles == n * -(-ho // pw.th) * -(
            -ho // pw.tw)


def test_separable_choosers_fill_the_card_where_the_map_allows():
    m = blocking.H100_SXM
    # 112x112 legs: tiles whose items give each resident CTA more than one
    d = blocking.choose_depthwise_blocking(8, 1, 112, 112, 32, 3, 3, 1)
    assert (d.hob, d.wob, d.lanes) == (14, 16, 32)
    assert d.items >= blocking.DW_ITEMS_PER_CTA * m.wave == 1.5 * d.grid
    # 7x7x1024: the pencil splits and the items shrink to fill the card
    d = blocking.choose_depthwise_blocking(8, 8, 7, 7, 128, 3, 3, 1)
    assert d.items >= m.wave and d.grid == m.wave
    # the dgrad's items: the forward's rule over dx, its windows of the
    # cotangent; at stride 2 a 16x16 tile of dx reads 9x9 cotangent cells
    d = blocking.choose_depthwise_dgrad_blocking(8, 1, 112, 112, 32, 3, 3, 1)
    assert (d.hob, d.wob, d.lanes, d.hwin, d.wwin) == (8, 16, 32, 10, 18)
    assert d.items >= blocking.DW_ITEMS_PER_CTA * m.wave == 1.5 * d.grid
    d = blocking.choose_depthwise_dgrad_blocking(8, 2, 112, 112, 32, 3, 3, 2,
                                                 (1, 1), ((0, 1), (0, 1)))
    assert (d.hob, d.wob, d.hwin, d.wwin) == (16, 16, 9, 9)
    # 7x7x1024 pointwise: one m-tile an image, the output block split in two
    p = blocking.choose_pointwise_blocking(8, 49, 8, 128, 8, 128)
    assert (p.rows, p.tiles, p.nsplit) == (64, 1, 2)
    with pytest.raises(ValueError, match="taps"):
        blocking.choose_depthwise_wgrad_blocking(1, 1, 8, 8, 8, 7, 7)
