"""The tensor-core wgrad tile of the CUDA wgrad kernels
(``csrc/wgrad_tile.cuh``) on the CPU: the kernels' own tile arithmetic
written out in numpy, stage by stage as a CTA runs it ((tap, c) rows read
at their offsets into the staged x window, dz written transposed in core-
matrix order, shares summed in split order, ``db`` on the first group of Ci
block 0), against ``jax.vjp`` of the reference's ``direct_conv_blocked``;
the launch plan and the choosers of ``core.blocking``; and an emulation of
the kernels' 3xTF32 arithmetic at a real share's length.  The tile
arithmetic runs in f64 against JAX's f32, ``rtol = atol = 1e-5``: at most
N * Ho * Wo = 242 products of O(1) terms per element, summed in other
orders."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.direct_conv import direct_conv_blocked as jax_direct_conv  # noqa: E402
from repro_torch.configs.cnn import MOBILENET_V1_CONV1, vgg16_layers  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.conv2d_common import cotangent_prologue  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import direct_conv_preactivation  # noqa: E402
from repro_torch.core.padding import normalize_padding  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}
# chip_smoke.py's bound on a wgrad element: |kernel - f64| <= WGRAD_REL *
# sum |x * dz| over its terms
WGRAD_REL = 1e-5

# (n, ci, co, h, w, cib, cob, stride, padding, activation)
CASES = [
    (2, 4, 8, 8, 8, 4, 8, 1, "SAME", "relu"),
    (2, 4, 8, 8, 8, 4, 8, 2, "SAME", "gelu"),        # pads (0, 1)
    (2, 8, 8, 9, 7, 4, 4, 2, "SAME", "relu"),        # odd extents, two Ci blocks
    (2, 3, 8, 11, 11, 3, 8, 2, "SAME", "gelu"),      # Cib = 3, odd
    (2, 3, 16, 10, 9, 3, 16, 1, "SAME", None),       # Cib = 3, linear
    (2, 4, 8, 10, 10, 4, 8, 2, "VALID", "relu"),     # rows past the extents
    (1, 4, 12, 9, 11, 4, 12, 1, "VALID", "gelu"),    # Cob % 8 != 0
    (1, 4, 6, 7, 9, 4, 6, 1, ((2, 0), (0, 1)), "relu"),  # Cob % 4 != 0
    (2, 16, 24, 8, 8, 8, 24, 1, "SAME", "relu"),     # two m-tiles, N = 32
]


def _operands(seed, n, ci, co, h, w, cib, cob, stride, padding):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
          / np.sqrt(9 * ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    z = direct_conv_preactivation(torch.from_numpy(x), torch.from_numpy(wt),
                                  stride, padding, torch.from_numpy(b))
    g = rng.normal(size=tuple(z.shape)).astype(np.float32)
    return x, wt, b, z, g


def _jax_dw_db(x, wt, b, g, stride, padding, act):
    def f(w_, b_):
        return jax_direct_conv(jnp.asarray(x), w_, stride, padding, b_, act)
    _, vjp = jax.vjp(f, jnp.asarray(wt), jnp.asarray(b))
    dw, db = vjp(jnp.asarray(g))
    return np.asarray(dw), np.asarray(db)


def _tile_wgrad(x, dz, blk, hf, wf, stride, pads, streamed):
    """The kernels' arithmetic in numpy (``wgrad_tile::run``), per CTA
    (Ci block, Co block, m-tile group, share): each stage's x window staged
    as ``issue_stage`` stages it (the streamed walk keeping the halo rows of
    the stage before), dz written as ``transform`` writes B ([K/4][N][4]),
    A read at ``ro[m] + posoff[p]``, the products summed into the share's
    workspace row; then the rows added in split order.  Unwritten shared
    memory and workspace start as NaN, so a read or a sum that misses shows.
    -> ``(dw, db)``."""
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = dz.shape
    (pt, _), (pl, _) = pads
    th, tw, lanes, kpos = blk.th, blk.tw, blk.lanes, blk.kpos
    ld = blocking.wgrad_ldx(cib, stride)
    hwin, wwin = (th - 1) * stride + hf, (tw - 1) * stride + wf
    rf = -(-wwin * ld // 32) * 32        # a row padded to 128 bytes
    rows = hf * wf * cib
    mt = blocking.wgrad_mtiles(hf, wf, cib)
    posoff = np.array([(p // tw) * stride * rf + (p % tw) * stride * ld
                       if p < th * tw else 0 for p in range(kpos)])
    ro = np.zeros(mt * 64, int)
    for m in range(rows):
        tap, c = divmod(m, cib)
        ro[m] = (tap // wf) * rf + (tap % wf) * ld + c
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    total = n * tiles_h * tiles_w
    assert total == blk.tiles

    def tile_of(t):
        img, rem = divmod(t, tiles_h * tiles_w)
        a, b = ((rem % tiles_h, rem // tiles_h) if streamed
                else divmod(rem, tiles_w))
        return img, a * th, b * tw

    dw_size = coblk * ciblk * hf * wf * cib * cob
    ws = np.full((blk.splits, dw_size + coblk * cob), np.nan)
    keep = max(0, hwin - th * stride)
    for ci_b in range(ciblk):
        for co_b in range(coblk):
            for group in range(blk.groups):
                m0 = group * blk.wgs * blk.mpw * 64
                m1 = min(m0 + blk.wgs * blk.mpw * 64, mt * 64)
                for split in range(blk.splits):
                    first = total * split // blk.splits
                    last = total * (split + 1) // blk.splits
                    acc = np.zeros((m1 - m0, lanes))
                    db = np.zeros(lanes)
                    prev = None
                    for t in range(first, last):
                        img, oh0, ow0 = tile_of(t)
                        xs = np.full(hwin * rf, np.nan)
                        lo = keep if (streamed and t > first
                                      and t % tiles_h) else 0
                        if lo:
                            xs[:lo * rf] = prev[(hwin - lo) * rf:]
                        for r in range(lo, hwin):
                            for col in range(wwin):
                                ih = oh0 * stride - pt + r
                                iw = ow0 * stride - pl + col
                                inside = 0 <= ih < hi and 0 <= iw < wi
                                at = r * rf + col * ld
                                xs[at:at + cib] = (x[img, ci_b, ih, iw]
                                                   if inside else 0.0)
                        b_op = np.zeros(kpos // 4 * lanes * 4)
                        for p in range(th * tw):
                            oh, ow = oh0 + p // tw, ow0 + p % tw
                            if oh < ho and ow < wo:
                                for co in range(cob):
                                    b_op[(p // 4 * lanes + co) * 4 + p % 4] = \
                                        dz[img, co_b, oh, ow, co]
                        bm = (b_op.reshape(kpos // 4, lanes, 4)
                              .transpose(0, 2, 1).reshape(kpos, lanes))
                        a_op = xs[ro[m0:m1, None] + posoff[None, :]]
                        acc += a_op @ bm
                        db += bm.sum(0)
                        prev = xs
                    for m in range(m0, min(m1, rows)):
                        tap, c = divmod(m, cib)
                        base = (((co_b * ciblk + ci_b) * hf * wf + tap) * cib
                                + c) * cob
                        ws[split, base:base + cob] = acc[m - m0, :cob]
                    if group == 0 and ci_b == 0:
                        ws[split, dw_size + co_b * cob:
                           dw_size + (co_b + 1) * cob] = db[:cob]
    out = ws[0].copy()
    for k in range(1, blk.splits):
        out += ws[k]
    return (out[:dw_size].reshape(coblk, ciblk, hf, wf, cib, cob),
            out[dw_size:].reshape(coblk, cob))


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act", CASES)
def test_kernel_tile_arithmetic_matches_jax_vjp(streamed, n, ci, co, h, w,
                                                cib, cob, stride, padding,
                                                act):
    x, wt, b, z, g = _operands(7, n, ci, co, h, w, cib, cob, stride,
                               padding)
    want_dw, want_db = _jax_dw_db(x, wt, b, g, stride, padding, act)
    dz = cotangent_prologue(torch.from_numpy(g), z if act else None,
                            act).numpy().astype(np.float64)
    pads = normalize_padding(padding, 3, 3, stride, h, w)
    ho, wo = dz.shape[2:4]
    choose = (blocking.choose_stream_wgrad_blocking if streamed
              else blocking.choose_wgrad_blocking)
    chosen = choose(n, ho, wo, 3, 3, stride, ci // cib, cib, co // cob, cob,
                    prologue=act is not None)
    mt = blocking.wgrad_mtiles(3, 3, cib)
    blks = [chosen]
    for th, tw, wgs, mpw in ((2, 3, 1, 2), (3, 1, 2, 1), (1, 5, 3, 1)):
        if chosen.lanes * mpw > 128:
            mpw = 1
        tiles = n * -(-ho // th) * -(-wo // tw)
        blks.append(dataclasses.replace(
            chosen, th=th, tw=tw, wgs=wgs, mpw=mpw,
            groups=-(-mt // (wgs * mpw)), splits=min(3, tiles), tiles=tiles,
            hwin=(th - 1) * stride + 3, wwin=(tw - 1) * stride + 3))
    for blk in blks:
        dw, db = _tile_wgrad(x.astype(np.float64), dz, blk, 3, 3, stride,
                             pads, streamed)
        np.testing.assert_allclose(dw, want_dw, **TOL, err_msg=str(blk))
        np.testing.assert_allclose(db, want_db, **TOL, err_msg=str(blk))


def _vgg_layers(entry=224):
    out, h = [], entry
    for ci, co, s in vgg16_layers():
        out.append((ci, co, s, h))
        h = -(-h // s)
    return out


# every VGG-16 layer at batch 8, MobileNet v1's conv1 at batch 32
FITS = ([(8,) + layer for layer in _vgg_layers()]
        + [(32, MOBILENET_V1_CONV1[0], MOBILENET_V1_CONV1[1],
            MOBILENET_V1_CONV1[2], 224)])


@pytest.mark.parametrize("n,ci,co,s,h", FITS)
def test_wgrad_choosers_fit_the_cta(n, ci, co, s, h):
    m = blocking.H100_SXM
    cib, cob = min(ci, 128), min(co, 128)
    ho = -(-h // s)
    mt = blocking.wgrad_mtiles(3, 3, cib)
    for streamed, choose in ((False, blocking.choose_wgrad_blocking),
                             (True, blocking.choose_stream_wgrad_blocking)):
        for prologue in (False, True):
            blk = choose(n, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob,
                         prologue=prologue)
            assert isinstance(blk, blocking.StreamWgradBlocking) == streamed
            # shared memory, registers (a 64 x N f32 accumulator takes N / 2
            # registers of a thread, at most 64 of them) and threads
            assert blocking.wgrad_smem_bytes(
                blk.th, blk.tw, 3, 3, s, cib, cob, blk.lanes,
                prologue) <= m.smem_block
            assert blk.lanes * blk.mpw <= 128 and blk.mpw in blocking.WGRAD_MPW
            assert 1 <= blk.wgs <= blocking.WGRAD_CONSUMERS
            assert blk.lanes == blocking.wgrad_lanes(cob) >= cob
            # the groups cover the m-tiles, none of them idle
            per = blk.wgs * blk.mpw
            assert (blk.groups - 1) * per < mt <= blk.groups * per
            assert blk.th * blk.tw <= blocking.WGRAD_MAX_POSITIONS
            assert blk.tiles == n * -(-ho // blk.th) * -(-ho // blk.tw)
            assert 1 <= blk.splits <= blk.tiles
            cols = 9 * ci * co + co
            assert 4 * blk.splits * cols <= max(
                blocking.WGRAD_WORKSPACE_BYTES, 4 * cols)
            # a streamed strip walks whole columns of the map
            if streamed:
                assert blk.hso == blk.th and blk.items == blk.tiles


def test_wgrad_choosers_fill_the_card_at_vgg16_shapes():
    # every layer's grid holds at least one CTA an SM
    for n, ci, co, s, h in FITS[:-1]:
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        for choose in (blocking.choose_wgrad_blocking,
                       blocking.choose_stream_wgrad_blocking):
            blk = choose(n, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob,
                         prologue=True)
            grid = blk.groups * blk.splits * (ci // cib) * (co // cob)
            assert grid >= blocking.H100_SXM.sms


@pytest.mark.parametrize("n,ci,co,s,h", FITS + [(2, 8, 12, 2, 9),
                                                 (1, 24, 6, 1, 7)])
def test_wgrad_plan_counts_the_function_and_what_the_tiles_issue(n, ci, co,
                                                                  s, h):
    cib, cob = (min(ci, 128), min(co, 128)) if ci > 8 or co > 12 else (
        ci, co)
    ciblk, coblk = ci // cib, co // cob
    spec = ConvSpec.make(n, h, h, ci, co, 3, 3, s, "SAME")
    for choose in (blocking.choose_wgrad_blocking,
                   blocking.choose_stream_wgrad_blocking):
        blk = choose(n, spec.ho, spec.wo, 3, 3, s, ciblk, cib, coblk, cob,
                     prologue=True)
        plan = blocking.wgrad_plan(blk, n, spec.ho, spec.wo, 3, 3, s, ciblk,
                                   cib, coblk, cob, True)
        assert plan.function_macs == spec.flops() // 2
        assert plan.tiles == blk.tiles
        mt = blocking.wgrad_mtiles(3, 3, cib)
        assert plan.issued_macs == (3 * ciblk * coblk * blk.tiles * blk.kpos
                                    * mt * 64 * blk.lanes)
        # the padding: m-tile rows past 9 Cib, K past the map's positions,
        # lanes past Cob
        live = n * spec.ho * spec.wo
        assert 1 - plan.padding_share == pytest.approx(
            9 * cib / (mt * 64) * live / (blk.tiles * blk.kpos)
            * cob / blk.lanes)
        assert plan.smem == blocking.wgrad_smem_bytes(
            blk.th, blk.tw, 3, 3, s, cib, cob, blk.lanes, True)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("cib", [3, 8, 64, 128])
def test_x_cells_spread_an_a_load_over_the_banks(stride, cib):
    # a warp's A load reads 8 consecutive channels at four positions s
    # cells apart: with ld * s = 8 mod 16 floats they start on four distinct
    # 8-bank groups, so the 32 loads hit 32 banks
    ld = blocking.wgrad_ldx(cib, stride)
    assert ld >= cib and ld % 4 == 0 and ld < cib + 32
    banks = {(q * stride * ld + c) % 32 for q in range(4) for c in range(8)}
    assert len(banks) == 32


def test_wgrad_choosers_raise_smem_misfit_on_a_tiny_machine():
    tiny = dataclasses.replace(blocking.H100_SXM, smem_block=4096)
    with pytest.raises(blocking.SmemMisfitError, match="no wgrad tile fits"):
        blocking.choose_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64, tiny)
    with pytest.raises(blocking.SmemMisfitError,
                       match="no streamed wgrad strip fits"):
        blocking.choose_stream_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 64,
                                              tiny)
    with pytest.raises(blocking.SmemMisfitError, match="widest wgmma"):
        blocking.choose_wgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 1, 256)


# ---------------------------------------------------------------------------
# the kernels' 3xTF32 arithmetic at a real share's length
# ---------------------------------------------------------------------------

def _tf32(v):
    """Round f32 to TF32's 10-bit mantissa, nearest with ties away from 0
    (``cvt.rna.tf32.f32``), as f32."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x1000) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32 (f64 in, f32 values out): the
    tensor cores' accumulation into an f32 register."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_3xtf32_share_sums_meet_the_chip_bound_at_conv1_2():
    # conv1_2 (64 -> 64, 224 x 224, batch 8) sums 401,408 terms an element;
    # its chosen tiles split them into shares that each CTA accumulates in
    # one f32 register through the tensor cores: per k8 slice three wgmmas
    # (small*big, big*small, big*big of the TF32 halves), each an exact sum
    # of 8 products added to the accumulator rounded toward zero.  The
    # shares are then added in f32 in split order (wgrad_reduce).  Emulate
    # one split's worth of elements at the chosen share length and hold
    # them to chip_smoke.py's WGRAD_REL bound against exact f64 sums.
    blk = blocking.choose_wgrad_blocking(8, 224, 224, 3, 3, 1, 1, 64, 1, 64,
                                         prologue=True)
    share = -(-blk.tiles // blk.splits) * blk.kpos
    assert 2000 <= share <= 20000
    rng = np.random.default_rng(0)
    elems = 256
    # x ~ N(0, 1); dz = g where the relu passes (half the terms are 0)
    x = rng.normal(size=(elems, share)).astype(np.float32)
    dz = (rng.normal(size=(elems, share))
          * (rng.random((elems, share)) < 0.5)).astype(np.float32)
    xb = _tf32(x)
    xs = _tf32(x - xb)
    db_ = _tf32(dz)
    ds = _tf32(dz - db_)
    acc = np.zeros(elems, np.float32)
    for k in range(0, share, 8):
        sl = slice(k, k + 8)
        for a, b in ((xs, db_), (xb, ds), (xb, db_)):
            acc = _add_rz(acc, (a[:, sl].astype(np.float64)
                                * b[:, sl].astype(np.float64)).sum(1))
    exact = (x.astype(np.float64) * dz.astype(np.float64)).sum(1)
    bound = WGRAD_REL * np.abs(x.astype(np.float64) * dz).sum(1)
    ratio = np.abs(acc.astype(np.float64) - exact) / bound
    # one share holds 1 / splits of an element's terms: its error must stay
    # well inside the bound, which the other shares' terms also widen
    assert ratio.max() < 0.5, ratio.max()


# ---------------------------------------------------------------------------
# the tiles timed on the card
# ---------------------------------------------------------------------------

def test_wgrad_tiles_ab_times_the_chosen_tile_first():
    # launch/wgrad_tiles_ab.py: VGG-16's 13 layers, each route's candidates
    # led by the chooser's tile, every (consumer warpgroups, m-tiles a
    # warpgroup) pair the search weighs among them
    from repro_torch.launch import wgrad_tiles_ab as ab
    layers = ab.wgrad_layers()
    assert [name for name, *_ in layers] == ab.NAMES
    assert sum(s == 2 for _, _, _, s, _ in layers) == 4
    for name, ci, co, s, h in layers:
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        for streamed, choose in (
                (False, blocking.choose_wgrad_blocking),
                (True, blocking.choose_stream_wgrad_blocking)):
            tiles = ab.tile_candidates(8, ci, co, s, h, streamed, 4, 1)
            assert tiles[0][1] == choose(8, ho, ho, 3, 3, s, ci // cib, cib,
                                         co // cob, cob, prologue=True)
            assert len({b for _, b in tiles}) == len(tiles)
            found = blocking.wgrad_candidates(
                8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob,
                blocking.H100_SXM, True, streamed)
            assert {(b.wgs, b.mpw) for _, b in tiles} == {
                (b.wgs, b.mpw) for _, b in found}


# (th, tw, wgs, mpw, splits) that both choosers take at each of VGG-16's
# wgrads (batch 8, 224x224 entry, relu prologue and db), with its time
# over the fastest candidate's in `python -m
# repro_torch.launch.wgrad_tiles_ab` on an H100 80GB HBM3 at 700 W, window
# and streamed: summed over the 13 layers, 5.206 ms window and 5.512 ms
# streamed against 5.145 and 5.485 for the fastest tile measured at each
# layer.  A change to the cost model that moves a tile shows here; time it
# with that script before repinning.
CHOSEN_WGRAD_TILES = {
    "conv1_1": ((8, 8, 1, 1, 132), 1.016, 1.000),
    "conv1_2": ((7, 8, 3, 2, 66), 1.049, 1.022),
    "conv2_1": ((4, 8, 3, 1, 44), 1.037, 1.016),
    "conv2_2": ((4, 8, 3, 1, 22), 1.000, 1.000),
    "conv3_1": ((3, 8, 3, 1, 11), 1.000, 1.000),
    "conv3_2": ((4, 8, 3, 1, 11), 1.000, 1.000),
    "conv3_3": ((4, 8, 3, 1, 11), 1.000, 1.000),
    "conv4_1": ((4, 6, 3, 1, 5), 1.000, 1.000),
    "conv4_2": ((7, 4, 3, 1, 4), 1.004, 1.000),
    "conv4_3": ((7, 4, 3, 1, 4), 1.004, 1.000),
    "conv5_1": ((7, 3, 3, 1, 4), 1.071, 1.040),
    "conv5_2": ((2, 14, 3, 1, 4), 1.000, 1.000),
    "conv5_3": ((2, 14, 3, 1, 4), 1.000, 1.000),
}


def test_wgrad_choosers_take_the_tiles_timed_on_the_card():
    from repro_torch.launch.wgrad_tiles_ab import wgrad_layers
    for name, ci, co, s, h in wgrad_layers():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        for choose in (blocking.choose_wgrad_blocking,
                       blocking.choose_stream_wgrad_blocking):
            b = choose(8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob,
                       prologue=True)
            assert (b.th, b.tw, b.wgs, b.mpw, b.splits) == \
                CHOSEN_WGRAD_TILES[name][0], (name, choose.__name__)


def test_wgrad_parts_ab_edits_apply_to_the_header():
    # launch/wgrad_parts_ab.py builds the kernel with parts of its work
    # taken out by editing csrc/wgrad_tile.cuh: each edit must still find
    # its text, once
    from repro_torch.kernels._build import CSRC
    from repro_torch.launch.wgrad_parts_ab import BF16_VARIANTS, VARIANTS
    text = (CSRC / "wgrad_tile.cuh").read_text()
    for variants in (VARIANTS, BF16_VARIANTS):
        assert variants["whole"] == ()
        for name, edits in variants.items():
            for old, _ in edits:
                assert text.count(old) == 1, (name, old)


# ---------------------------------------------------------------------------
# the pointwise wgrad: the same tile at a 1x1 filter
# ---------------------------------------------------------------------------

def _tile_wgrad_3xtf32(x, dz, blk):
    """The tile's arithmetic at a 1x1 filter (stride 1, no pads) as a CTA
    runs it, in f32 with the tensor cores' rounding: per CTA (Ci block, Co
    block, m-tile group, share) the tiles of its share in K order, each
    stage's positions padded to ``kpos`` with zeros, per k8 slice the three
    TF32 products (small * big, big * small, big * big of ``_tf32``'s
    halves), each an exact sum of 8 products added to the f32 accumulator
    rounded toward zero; ``db`` summed per Cob lane in position order on the
    first group of Ci block 0; then the shares added in f32 in split order.
    -> ``(dw, db)``."""
    n, ciblk, h, w, cib = x.shape
    _, coblk, _, _, cob = dz.shape
    th, tw, kpos = blk.th, blk.tw, blk.kpos
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    total = n * tiles_h * tiles_w
    assert total == blk.tiles and (blk.hwin, blk.wwin) == (th, tw)
    span = blk.wgs * blk.mpw * 64
    dw_size = coblk * ciblk * cib * cob
    ws = np.full((blk.splits, dw_size + coblk * cob), np.nan, np.float32)
    for ci_b in range(ciblk):
        for co_b in range(coblk):
            for group in range(blk.groups):
                m0, m1 = group * span, min(cib, (group + 1) * span)
                if m0 >= m1:
                    continue
                for split in range(blk.splits):
                    acc = np.zeros((m1 - m0, cob), np.float32)
                    db = np.zeros(cob, np.float32)
                    for t in range(total * split // blk.splits,
                                   total * (split + 1) // blk.splits):
                        img, rem = divmod(t, tiles_h * tiles_w)
                        oh0, ow0 = rem // tiles_w * th, rem % tiles_w * tw
                        a = np.zeros((m1 - m0, kpos), np.float32)
                        b = np.zeros((kpos, cob), np.float32)
                        for p in range(th * tw):
                            oh, ow = oh0 + p // tw, ow0 + p % tw
                            if oh < h and ow < w:
                                a[:, p] = x[img, ci_b, oh, ow, m0:m1]
                                b[p] = dz[img, co_b, oh, ow]
                        for p in range(kpos):
                            db = (db + b[p]).astype(np.float32)
                        ab, bb = _tf32(a), _tf32(b)
                        asm, bsm = _tf32(a - ab), _tf32(b - bb)
                        for k in range(0, kpos, 8):
                            sl = slice(k, k + 8)
                            for u, v in ((asm, bb), (ab, bsm), (ab, bb)):
                                acc = _add_rz(acc, u[:, sl].astype(np.float64)
                                              @ v[sl].astype(np.float64))
                    for c in range(m0, m1):
                        base = ((co_b * ciblk + ci_b) * cib + c) * cob
                        ws[split, base:base + cob] = acc[c - m0]
                    if group == 0 and ci_b == 0:
                        ws[split, dw_size + co_b * cob:
                           dw_size + (co_b + 1) * cob] = db
    out = ws[0].copy()
    for k in range(1, blk.splits):
        out = (out + ws[k]).astype(np.float32)
    return (out[:dw_size].reshape(coblk, ciblk, 1, 1, cib, cob),
            out[dw_size:].reshape(coblk, cob))


# (n, ci, co, h, w, cib, cob, activation): MobileNet's block 1 (Cib 32, a
# half-empty m-tile), 7x7 maps (K padded from 49 to 56), two Ci blocks,
# Cob % 8 != 0, Cib 3 with Cob 6, a linear epilogue
PW_WGRAD_CASES = [
    (2, 32, 64, 6, 9, 32, 64, "relu"),
    (2, 16, 8, 7, 7, 16, 8, "gelu"),
    (2, 128, 16, 5, 6, 64, 16, "relu"),
    (2, 8, 12, 5, 5, 8, 12, "gelu"),
    (1, 3, 6, 7, 7, 3, 6, "relu"),
    (2, 8, 16, 4, 5, 8, 16, None),
]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act", PW_WGRAD_CASES)
def test_pointwise_wgrad_tile_arithmetic_matches_pallas_interpret(
        n, ci, co, h, w, cib, cob, act):
    # the 3xTF32 emulation keeps f32 accuracy: against the pointwise Pallas
    # wgrad (interpret mode, f32 sums in its own order) within 1e-5 of the
    # sum of the terms' magnitudes (chip_smoke.py's WGRAD_REL), plus 1e-7
    # for elements whose terms are all 0, over at most 126 terms an element
    from repro.kernels.conv2d_pointwise import pointwise_wgrad_pallas
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 1, 1, cib, cob))
          / np.sqrt(ci)).astype(np.float32)
    z = direct_conv_preactivation(torch.from_numpy(x), torch.from_numpy(wt),
                                  1, "VALID", None)
    g = rng.normal(size=tuple(z.shape)).astype(np.float32)
    want_dw, want_db = pointwise_wgrad_pallas(
        jnp.asarray(x), jnp.asarray(g), interpret=True,
        z=None if act is None else jnp.asarray(z.numpy()), activation=act,
        with_db=True)
    dz = cotangent_prologue(torch.from_numpy(g), z if act else None,
                            act).numpy()
    scale_dw = np.einsum("nihwc,nohwd->oicd", np.abs(x).astype(np.float64),
                         np.abs(dz).astype(np.float64))[:, :, None, None]
    scale_db = np.abs(dz).astype(np.float64).sum((0, 2, 3))
    chosen = blocking.choose_wgrad_blocking(n, h, w, 1, 1, 1, ci // cib, cib,
                                            co // cob, cob,
                                            prologue=act is not None)
    blks = [chosen]
    for th, tw, splits in ((1, 3, 2), (2, 4, 3), (h, w, 1)):
        tiles = n * -(-h // th) * -(-w // tw)
        blks.append(dataclasses.replace(
            chosen, th=th, tw=tw, hwin=th, wwin=tw, tiles=tiles,
            splits=min(splits, tiles)))
    for blk in blks:
        dw, db = _tile_wgrad_3xtf32(x, dz, blk)
        assert np.all(np.abs(dw - np.asarray(want_dw))
                      <= WGRAD_REL * scale_dw + 1e-7), blk
        assert np.all(np.abs(db - np.asarray(want_db))
                      <= WGRAD_REL * scale_db + 1e-7), blk


def test_pointwise_wgrad_tiles_at_mobilenet_legs():
    # the dense chooser at MobileNet v1's pointwise legs (batch 32, relu):
    # the tile fits, its plan counts the function, and block 1's Cib 32
    # fills half of its one m-tile
    from repro_torch.launch.separable_bwd_ab import mobilenet_legs
    m = blocking.H100_SXM
    for ci, co, s, h in mobilenet_legs():
        ho = -(-h // s)
        cib, cob = min(ci, 128), min(co, 128)
        blk = blocking.choose_wgrad_blocking(32, ho, ho, 1, 1, 1, ci // cib,
                                             cib, co // cob, cob,
                                             prologue=True)
        plan = blocking.wgrad_plan(blk, 32, ho, ho, 1, 1, 1, ci // cib, cib,
                                   co // cob, cob, True)
        assert plan.function_macs == 32 * ho * ho * ci * co
        assert plan.smem <= m.smem_block and blk.lanes == cob
        live = 32 * ho * ho / (blk.tiles * blk.kpos)
        mt = blocking.wgrad_mtiles(1, 1, cib)
        assert 1 - plan.padding_share == pytest.approx(
            cib / (mt * 64) * live)
        if cib == 32:
            assert plan.padding_share >= 0.5


# ---------------------------------------------------------------------------
# the bf16 GEMM's layout and its choosers
# ---------------------------------------------------------------------------

def _bf16_smem_reckoned(th, tw, hf, wf, s, cib, lanes, span):
    """The bf16 tile's shared memory from its layout: the m-tiles (half,
    tap) dealt to CTAs of ``span`` (a half's taps in runs of ``span``, or
    whole halves together where ``span`` covers a half's taps), the most
    halves a CTA touches staged in every column phase its taps read, each
    (half, phase) window ``hwin`` rows of the phase's cells (and at least
    the tile's positions rounded to 8) at 128 bytes, in 1024-byte atoms;
    B one 128-byte row a position (K rounded to 16) a 64-lane block; as many
    slots as fit up to 4; an atom to align, 256 bytes of tables."""
    taps, halves = hf * wf, -(-cib // 64)
    ctas = []
    if span < taps:
        for h in range(halves):
            for t0 in range(0, taps, span):
                ctas.append({h})
    else:
        per = span // taps
        for h0 in range(0, halves, per):
            ctas.append(set(range(h0, min(halves, h0 + per))))
    staged = max(len(c) for c in ctas)
    phases = len({dw % s for dw in range(wf)})
    cells = max(tw - 1 + dw // s + 1 for dw in range(wf))
    hwin = (th - 1) * s + hf
    region = -(-max(hwin * cells, -(-th * tw // 8) * 8) * 128 // 1024) * 1024
    slot = staged * phases * region + lanes // 64 * -(-th * tw // 16) * 16 \
        * 128
    slots = min(4, (232448 - 1024 - 256) // slot)
    return 1024 + slots * slot + 256, slots


def _bf16_shapes():
    """(n, ho, wo, hf, wf, s, ciblk, cib, coblk, cob): VGG-16's 13 layers
    (batch 8), MobileNet v1's conv1 and 13 pointwise legs (batch 32)."""
    from repro_torch.launch.separable_bwd_ab import mobilenet_legs
    out = []
    for ci, co, s, h in _vgg_layers():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        out.append((8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob))
    ci, co, s = MOBILENET_V1_CONV1
    out.append((32, 112, 112, 3, 3, s, 1, ci, 1, co))
    for ci, co, s, h in mobilenet_legs():
        ho = -(-h // s)
        cib, cob = min(ci, 128), min(co, 128)
        out.append((32, ho, ho, 1, 1, 1, ci // cib, cib, co // cob, cob))
    return out


def test_bf16_wgrad_smem_is_its_layout_reckoned():
    for th, tw, hf, wf, s, cib, cob, span in [
            (4, 32, 3, 3, 1, 128, 128, 2), (8, 16, 3, 3, 2, 64, 128, 2),
            (16, 16, 3, 3, 1, 3, 64, 3), (7, 7, 1, 1, 1, 128, 128, 2),
            (2, 112, 1, 1, 1, 32, 64, 4), (1, 8, 3, 3, 1, 128, 6, 6),
            (3, 16, 1, 1, 2, 64, 64, 2), (2, 8, 5, 5, 3, 16, 8, 3)]:
        lanes = blocking.wgrad_bf16_lanes(cob)
        want, slots = _bf16_smem_reckoned(th, tw, hf, wf, s, cib, lanes,
                                          span)
        got = blocking.wgrad_smem_bytes(th, tw, hf, wf, s, cib, cob, lanes,
                                        True, 2, span)
        assert got == want, (th, tw, hf, wf, s, cib, cob, span)
        slot = blocking.wgrad_bf16_slot_bytes(th, tw, hf, wf, s, cib, lanes,
                                              span)
        assert blocking.wgrad_bf16_slots(slot) == slots


@pytest.mark.parametrize("streamed", [False, True])
def test_bf16_wgrad_choosers_fit_every_vgg16_and_mobilenet_shape(streamed):
    # the tile fits 232,448 bytes with two slots at least; 8-position
    # groups of consecutive cells: tw % 8 == 0 but at 1x1 stride 1, where a
    # stage is whole rows; widths 64 and 128; the plan counts the function
    choose = (blocking.choose_stream_wgrad_blocking if streamed
              else blocking.choose_wgrad_blocking)
    for n, ho, wo, hf, wf, s, ciblk, cib, coblk, cob in _bf16_shapes():
        blk = choose(n, ho, wo, hf, wf, s, ciblk, cib, coblk, cob,
                     prologue=True, op_bytes=2)
        span = blk.wgs * blk.mpw
        if blk.narrow:
            # the narrow rows (the window kernel at Cib 3): positions run on
            # across row breaks, an m-tile a group of filter rows
            # (test_torch_narrow_runs reckons their layout)
            from test_torch_narrow_runs import _reckoned_wgrad_smem
            assert not streamed and blocking.narrow_fits(hf, wf, cib)
            smem = _reckoned_wgrad_smem(blk, hf, s, cib)
            mtiles = blocking.narrow_groups(hf, wf, cib)
        else:
            smem, slots = _bf16_smem_reckoned(blk.th, blk.tw, hf, wf, s,
                                              cib, blk.lanes, span)
            assert slots >= 2
            mtiles = -(-cib // 64) * hf * wf
            if hf == wf == s == 1:
                assert blk.tw == wo
            else:
                assert blk.tw % 8 == 0
        assert smem <= 232448
        assert blk.lanes in (64, 128) and blk.lanes >= cob
        assert blk.lanes * blk.mpw <= 128
        assert blk.th * blk.tw <= blocking.WGRAD_BF16_MAX_POSITIONS
        plan = blocking.wgrad_plan(blk, n, ho, wo, hf, wf, s, ciblk, cib,
                                   coblk, cob, True)
        assert plan.smem == smem and plan.products == 1
        assert plan.function_macs == n * ho * wo * hf * wf * cib * ciblk \
            * cob * coblk
        assert plan.issued_macs == (ciblk * coblk * blk.tiles * blk.kpos
                                    * mtiles * 64 * blk.lanes)


def test_wgrad_launch_plan_is_built_once_a_shape():
    # the C entries take the geometry as one int array, built once per
    # shape: the _plan entry's ints, then the activation and db
    from repro_torch.kernels import conv2d_pointwise as pwk
    from repro_torch.kernels import direct_conv2d as dc
    spec = ConvSpec.make(2, 8, 8, 8, 16, 3, 3, 1, "SAME")
    blk = blocking.choose_wgrad_blocking(2, 8, 8, 3, 3, 1, 1, 8, 1, 16,
                                         prologue=True)
    args = (blk, (2, 1, 8, 8, 8), (2, 1, 8, 8, 16), 3, 3, spec, 1, True)
    plan = dc.wgrad_launch_plan(*args)
    assert plan is dc.wgrad_launch_plan(*args)
    assert list(plan.ints) == [*dc._wgrad_ints(blk, args[1], args[2], 3, 3,
                                               spec), 1, 1]
    assert (plan.cols, plan.columns) == (9 * 8 * 16 + 16, blk.groups)
    # the pointwise wgrad's: the dense tile at 1x1, keyed by torch.Size
    x_shape, g_shape = torch.Size((2, 1, 8, 8, 8)), torch.Size((2, 1, 8, 8,
                                                                16))
    pw = pwk._wgrad_plan(x_shape, g_shape, 2, True, False)
    assert pw is pwk._wgrad_plan(tuple(x_shape), tuple(g_shape), 2, True,
                                 False)
    assert pw.blk == blocking.choose_wgrad_blocking(
        2, 8, 8, 1, 1, 1, 1, 8, 1, 16, prologue=True)
    assert pw.cols == 8 * 16 and list(pw.ints)[9:12] == [1, 1, 1]
