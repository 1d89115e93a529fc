"""The dense forward tile of ``csrc/fwd_tile.cuh`` on the CPU.

The kernels' arithmetic written out in numpy CTA by CTA as the window
forward (``fwd_kernel``) and the streamed one (``stream_fwd_kernel``) run
it: the halo window staged zero outside the map and past the pencil, each
row of a tile read at its own offset for each tap (stride 2 only an offset),
the weight chunk in the core-matrix order its producer writes, each k8
slice's three TF32 products (3xTF32) added to a stage's f32 accumulator
rounded toward zero, in one K order (input block, chunk, tap, slice), each
stage's sum added to the running f32 sum (round to nearest), the epilogue
(+ b, activation, + r) and the tiles' GAP sums; the streamed walk computes
each strip of a band on its own m-tile, from the band's rows.  Held against
the reference's jnp oracle (``direct_conv_blocked``), ``conv_lax`` and its
streamed Pallas kernel in interpret mode (``stream=True``; the window
Pallas kernel does not run under the installed jax), ``rtol = atol =
1e-5``: at most 9 * 24 = 216 products of O(1) terms an output, whose
truncating accumulation drifts by an ulp of a stage's sum a k8 slice.

Also: the choosers' tiles at every VGG-16 shape of both buckets and at
MobileNet v1's ``conv1`` (they fit one CTA, route as before), the tiles
pinned as timed on the card, the plan's MAC counts and the candidates that
``launch/fwd_tiles_ab.py`` times.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.core.layout import blocked_to_nhwc as j_unblock  # noqa: E402
from repro.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked_pallas)
from repro_torch.configs.cnn import mobilenet_v1_layers, vgg16_layers  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.dispatch import route_stream  # noqa: E402
from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _tf32(v):
    """Round f32 to TF32's 10-bit mantissa, nearest with ties away from 0
    (``cvt.rna.tf32.f32``), as f32."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x1000) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32: the tensor cores' addition
    of a k8 slice's exact sum into an f32 accumulator."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _core_matrix(b):
    """B [K, N] in the producer's order [K/4][N][4], read back as the wgmma
    descriptor reads it (a k8 slice's two K halves N * 16 bytes apart)."""
    k, n = b.shape
    flat = b.reshape(k // 4, 4, n).transpose(0, 2, 1).reshape(-1)
    return flat.reshape(k // 4, n, 4).transpose(0, 2, 1).reshape(k, n)


def _act(v, act):
    if act == "relu":
        return np.maximum(v, np.float32(0))
    if act == "gelu":
        v64 = v.astype(np.float64)
        k = np.sqrt(2 / np.pi)
        return (0.5 * v64 * (1 + np.tanh(k * (v64 + 0.044715 * v64 ** 3)))
                ).astype(np.float32)
    return v


def _tile_sums(x, wt, pads, stride, blk, streamed):
    """Every CTA's f32 accumulators: ``x`` [N, ciblk, Hi, Wi, Cib], ``wt``
    [coblk, ciblk, Hf, Wf, Cib, Cob] -> [N, coblk, nsplit, tiles, m-tiles,
    64 * wgs or 64 rows, lanes], each m-tile row the position the kernel
    gives it (rows past the tile or the map: NaN, never stored)."""
    n, ciblk, hi, wi, cib = x.shape
    coblk, _, hf, wf, _, cob = wt.shape
    (pt, _), (pl, _) = pads
    ho = (hi + sum(pads[0]) - hf) // stride + 1
    wo = (wi + sum(pads[1]) - wf) // stride + 1
    kpad = -(-cib // 8) * 8
    lanes, chunk, s = blk.lanes, blk.chunk, stride
    # the window kernel's tile is one m-tile of 64 * wgs rows; the streamed
    # band one m-tile a strip, hso * tw positions apart
    mtiles = blk.strips if streamed else 1
    rows = 64 if streamed else 64 * blk.wgs
    across = -(-wo // blk.tw)
    out = np.full((n, coblk, blk.nsplit, blk.tiles, mtiles, rows, lanes),
                  np.nan, np.float32)
    for tile in range(blk.tiles):
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        h0, w0 = oh0 * s - pt, ow0 * s - pl
        # the staged window: zero outside the map and past the pencil
        win = np.zeros((n, ciblk, blk.hwin, blk.wwin, kpad), np.float32)
        for r in range(blk.hwin):
            for j in range(blk.wwin):
                if 0 <= h0 + r < hi and 0 <= w0 + j < wi:
                    win[:, :, r, j, :cib] = x[:, :, h0 + r, w0 + j]
        for mt in range(mtiles):
            q = np.arange(rows)
            p = mt * blk.mstride + q
            live = (q < blk.mstride) & (p < blk.th * blk.tw)
            p = np.where(live, p, 0)          # the kernel reads position 0
            pr, pc = p // blk.tw, p % blk.tw
            for o_b in range(coblk):
                for split in range(blk.nsplit):
                    o0 = split * lanes
                    vn = max(0, min(lanes, cob - o0))
                    total = np.zeros((n, rows, lanes), np.float32)
                    for i_b in range(ciblk):
                        for c0 in range(0, kpad, chunk):
                            acc = np.zeros((n, rows, lanes), np.float32)
                            for dh in range(hf):
                                for dw in range(wf):
                                    a = win[:, i_b, pr * s + dh, pc * s + dw,
                                            c0:c0 + chunk]
                                    b = np.zeros((chunk, lanes), np.float32)
                                    vk = max(0, min(chunk, cib - c0))
                                    b[:vk, :vn] = wt[o_b, i_b, dh, dw,
                                                     c0:c0 + vk, o0:o0 + vn]
                                    b = _core_matrix(b)
                                    a_big, b_big = _tf32(a), _tf32(b)
                                    a_sm = _tf32(a - a_big)
                                    b_sm = _tf32(b - b_big)
                                    for k in range(0, chunk, 8):
                                        sl = slice(k, k + 8)
                                        for u, v in ((a_sm, b_big),
                                                     (a_big, b_sm),
                                                     (a_big, b_big)):
                                            acc = _add_rz(acc, np.einsum(
                                                "nmk,kl->nml",
                                                u[..., sl].astype(np.float64),
                                                v[sl].astype(np.float64)))
                            total = total + acc
                    acc = total
                    oh, ow = oh0 + pr, ow0 + pc
                    keep = live & (oh < ho) & (ow < wo)
                    acc[:, ~keep] = np.nan
                    out[:, o_b, split, tile, mt] = acc
    return out, ho, wo


def _tile_forward(x, wt, b, r, pads, stride, act, gap, blk, streamed):
    """The forward as the tiles store it: + b, activation, + r; with
    ``gap`` each tile's sums of its stored values, added in tile order
    times 1/(Ho*Wo) in f32 (``gap_finalize``)."""
    acc, ho, wo = _tile_sums(x, wt, pads, stride, blk, streamed)
    n, coblk = x.shape[0], wt.shape[0]
    cob = wt.shape[5]
    out = np.full((n, coblk, ho, wo, cob), np.nan, np.float32)
    sums = np.zeros((n, coblk, blk.tiles, cob), np.float32)
    across = -(-wo // blk.tw)
    for tile in range(blk.tiles):
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        for split in range(blk.nsplit):
            o0 = split * blk.lanes
            vn = min(blk.lanes, cob - o0)
            for mt in range(acc.shape[4]):
                for q in range(acc.shape[5]):
                    v = acc[:, :, split, tile, mt, q, :vn]
                    if np.isnan(v).any():
                        continue
                    p = mt * blk.mstride + q
                    oh, ow = oh0 + p // blk.tw, ow0 + p % blk.tw
                    assert np.isnan(out[:, :, oh, ow, o0:o0 + vn]).all()
                    v = _act(v + b[None, :, o0:o0 + vn], act)
                    if r is not None:
                        v = v + r[:, :, oh, ow, o0:o0 + vn]
                    out[:, :, oh, ow, o0:o0 + vn] = v
                    sums[:, :, tile, o0:o0 + vn] += v
    assert not np.isnan(out).any()          # every output stored once
    if gap:
        pooled = sums[:, :, 0].copy()
        for t in range(1, blk.tiles):
            pooled = pooled + sums[:, :, t]
        return (pooled * (np.float32(1) / np.float32(ho * wo))).reshape(n, -1)
    return out


def _operands(seed, n, ci, co, h, w, cib, cob, stride, pads, residual):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
          / np.sqrt(9 * ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    spec = ConvSpec.make(n, h, w, ci, co, 3, 3, stride, pads)
    r = (rng.normal(size=(n, co // cob, spec.ho, spec.wo, cob))
         .astype(np.float32) if residual else None)
    return x, wt, b, r, spec


def _tiles(n, spec, cib, cob, gap, streamed, hso=None):
    """The chooser's tile, then two small ones that overhang the map: a
    2-row tile of 3 columns (the streamed band: strips of 1 row) and a
    1-column tile, at chunk 8 and the lane split of the chosen tile."""
    args = (n, spec.ho, spec.wo, 3, 3, spec.stride, spec.ci // cib, cib,
            spec.co // cob, cob)
    chosen = (blocking.choose_stream_fwd_blocking(*args, gap=gap, hso=hso)
              if streamed else blocking.choose_fwd_blocking(*args, gap=gap))
    out = [chosen]
    for th, tw in ((2, 3), (5, 1)):
        if streamed:
            th = chosen.strips * (th // 2)
        out.append(dataclasses.replace(
            chosen, th=th, tw=tw, chunk=8,
            tiles=-(-spec.ho // th) * -(-spec.wo // tw),
            hwin=(th - 1) * spec.stride + 3,
            wwin=(tw - 1) * spec.stride + 3))
    return out


# (n, ci, co, h, w, cib, cob, stride, padding, activation, residual, gap)
CASES = [
    (2, 8, 16, 8, 8, 8, 16, 1, "SAME", "relu", False, False),
    (2, 8, 16, 8, 8, 8, 16, 2, "SAME", "gelu", True, True),   # pads (0, 1)
    (2, 8, 8, 9, 7, 4, 8, 2, "VALID", None, False, False),
    (1, 8, 8, 7, 9, 8, 8, 1, ((2, 0), (0, 1)), "relu", True, False),
    (2, 3, 16, 11, 10, 3, 16, 2, "SAME", "relu", False, True),  # Cib = 3
    (2, 16, 12, 9, 9, 8, 12, 1, "SAME", "gelu", False, False),  # Cob 12
    (1, 24, 24, 14, 14, 24, 24, 1, "SAME", "relu", True, True),  # conv5's
]


def _jax_forward(x, wt, b, r, stride, padding, act, gap):
    return np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(wt), stride,
                               padding, jnp.asarray(b), act,
                               residual=None if r is None else jnp.asarray(r),
                               gap=gap))


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act,res,gap",
                         CASES)
def test_tile_arithmetic_matches_the_jnp_oracle(streamed, n, ci, co, h, w,
                                                cib, cob, stride, padding,
                                                act, res, gap):
    x, wt, b, r, spec = _operands(0, n, ci, co, h, w, cib, cob, stride,
                                  padding, res)
    want = _jax_forward(x, wt, b, r, stride, padding, act, gap)
    for blk in _tiles(n, spec, cib, cob, gap, streamed):
        got = _tile_forward(x, wt, b, r, spec.pads, stride, act, gap, blk,
                            streamed)
        np.testing.assert_allclose(got, want, **TOL, err_msg=str(blk))


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act,res,gap",
                         [CASES[i] for i in (0, 1, 3, 4)])
def test_tile_arithmetic_matches_conv_lax(n, ci, co, h, w, cib, cob, stride,
                                          padding, act, res, gap):
    x, wt, _, _, spec = _operands(1, n, ci, co, h, w, cib, cob, stride,
                                  padding, False)
    b = np.zeros((co // cob, cob), np.float32)
    nhwc = np.asarray(j_unblock(jnp.asarray(x)))
    hwio = wt.transpose(2, 3, 1, 4, 0, 5).reshape(3, 3, ci, co)
    want = np.asarray(conv_lax(jnp.asarray(nhwc), jnp.asarray(hwio), stride,
                               padding))
    blk = _tiles(n, spec, cib, cob, False, False)[0]
    got = _tile_forward(x, wt, b, None, spec.pads, stride, None, False, blk,
                        False)
    got = got.transpose(0, 2, 3, 1, 4).reshape(want.shape)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act,res,gap",
                         [CASES[i] for i in (0, 1, 4, 6)])
def test_strip_walk_matches_pallas_stream_interpret(n, ci, co, h, w, cib,
                                                    cob, stride, padding, act,
                                                    res, gap):
    x, wt, b, r, spec = _operands(2, n, ci, co, h, w, cib, cob, stride,
                                  padding, res)
    want = np.asarray(direct_conv2d_blocked_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=stride,
        padding=padding, activation=act, stream=True, interpret=True,
        residual=None if r is None else jnp.asarray(r), gap=gap))
    for blk in _tiles(n, spec, cib, cob, gap, True):
        got = _tile_forward(x, wt, b, r, spec.pads, stride, act, gap, blk,
                            True)
        np.testing.assert_allclose(got, want, **TOL, err_msg=str(blk))
    # the port's own streamed wrapper, on its plain version
    port = direct_conv2d_blocked(*(torch.from_numpy(a) for a in (x, wt, b)),
                                 stride, padding, act, residual=None
                                 if r is None else torch.from_numpy(r),
                                 gap=gap, stream=True)
    np.testing.assert_allclose(port.numpy(), want, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_window_and_strip_walks_agree_bit_for_bit_at_one_chunk(stride):
    # the same K order for every output: the two forwards' sums agree to
    # the bit wherever they take the same chunk, whatever the tiles
    x, wt, b, _, spec = _operands(3, 2, 16, 16, 10, 10, 16, 16, stride,
                                  "SAME", False)
    window = _tiles(2, spec, 16, 16, False, False)
    strips = _tiles(2, spec, 16, 16, False, True)
    outs = [_tile_forward(x, wt, b, None, spec.pads, stride, "relu", False,
                          dataclasses.replace(blk, chunk=8), streamed)
            for blk, streamed in ((window[0], False), (window[1], False),
                                  (strips[0], True), (strips[2], True))]
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])


def test_3xtf32_split_keeps_f32_accuracy():
    # big + small holds v to 2^-22 of it; the three products hold a k8
    # slice's sum to the dropped small * small term, far below f32 rounding
    # of the sum's terms
    rng = np.random.default_rng(4)
    a = rng.normal(size=(64, 8)).astype(np.float32)
    b = rng.normal(size=(8, 32)).astype(np.float32)
    for v in (a, b):
        big = _tf32(v)
        small = _tf32(v - big)
        assert (big.view(np.uint32) & 0x1FFF == 0).all()
        assert np.abs(v.astype(np.float64) - big - small).max() <= \
            2.0 ** -22 * np.abs(v).max()
    a_big, b_big = _tf32(a), _tf32(b)
    got = np.zeros((64, 32), np.float32)
    for u, v in ((_tf32(a - a_big), b_big), (a_big, _tf32(b - b_big)),
                 (a_big, b_big)):
        got = _add_rz(got, u.astype(np.float64) @ v.astype(np.float64))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    terms = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert (np.abs(got - exact) <= 2.0 ** -21 * terms).all()
    # one TF32 product alone is three decimal digits off
    one = a_big.astype(np.float64) @ b_big.astype(np.float64)
    assert np.abs(one - exact).max() > 100 * np.abs(got - exact).max()


def test_a_fresh_accumulator_a_stage_holds_f32_accuracy_at_vgg16_k():
    # K = 9 * 512 products into one truncating accumulator drift ~3e-5 of
    # the sum toward zero; the tile's fresh accumulator a stage (9 taps x
    # chunk 8 or 16), added into an f32 sum, keeps it near f32 rounding
    rng = np.random.default_rng(5)
    k, m = 9 * 512, 256
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    a_big, b_big = _tf32(a), _tf32(b)
    a_sm, b_sm = _tf32(a - a_big), _tf32(b - b_big)

    def walk(stage_slices):
        total = np.zeros(m, np.float32)
        acc = np.zeros(m, np.float32)
        for j, k0 in enumerate(range(0, k, 8)):
            sl = slice(k0, k0 + 8)
            for u, v in ((a_sm, b_big), (a_big, b_sm), (a_big, b_big)):
                acc = _add_rz(acc, u[:, sl].astype(np.float64)
                              @ v[sl].astype(np.float64))
            if (j + 1) % stage_slices == 0:
                total = total + acc
                acc = np.zeros(m, np.float32)
        return total + acc

    scale = np.abs(exact).max()
    one = np.abs(walk(k // 8) - exact).max() / scale
    for slices in (9, 18):
        staged = np.abs(walk(slices) - exact).max() / scale
        assert staged < 3e-6 and staged * 5 < one


# ---------------------------------------------------------------------------
# the choosers at the main paths' shapes
# ---------------------------------------------------------------------------

def _main_path_shapes():
    """Every dense forward of the main paths as ``(name, ci, co, stride,
    h)``: VGG-16's 13 at both buckets' entries, MobileNet v1's ``conv1``."""
    out = []
    for entry in (224, 160):
        h = entry
        for i, (ci, co, s) in enumerate(vgg16_layers()):
            out.append((f"vgg16[{i}]@{entry}", ci, co, s, h))
            h = -(-h // s)
        kind, ci, co, s = mobilenet_v1_layers()[0]
        assert kind == "conv"
        out.append((f"mobilenet.conv1@{entry}", ci, co, s, entry))
    return out


@pytest.mark.parametrize("gap", [False, True])
def test_choosers_fit_one_cta_at_every_main_path_shape(gap):
    n = 8
    for name, ci, co, s, h in _main_path_shapes():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        args = (n, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        for blk in (blocking.choose_fwd_blocking(*args, gap=gap),
                    blocking.choose_stream_fwd_blocking(*args, gap=gap)):
            smem = blocking.fwd_smem_bytes(blk.th, blk.tw, 3, 3, s,
                                           blk.chunk, blk.lanes, blk.wgs,
                                           gap)
            assert smem <= blocking.H100_SXM.smem_block == 232448, name
            plan = blocking.fwd_plan(blk, n, ho, ho, 3, 3, s, ci // cib,
                                     cib, co // cob, cob, gap)
            assert plan.smem == smem
            assert plan.function_macs == n * ho * ho * 9 * ci * co
            assert plan.issued_macs >= 3 * plan.function_macs
            # padding: Cib = 3 pads each k8 slice from 3 channels to 8
            if cib == 3:
                assert plan.padding_share >= 1 - 3 / 8


def test_routes_stay_at_every_main_path_shape():
    # the window route by default; the streamed one is asked for
    for name, ci, co, s, h in _main_path_shapes():
        spec = ConvSpec.make(8, h, h, ci, co, 3, 3, s, "SAME")
        for gap in (False, True):
            assert route_stream("fwd", spec, min(ci, 128), min(co, 128),
                                blocking.H100_SXM, gap=gap) is False, name


def test_plan_counts_what_the_tiles_issue():
    # 64 * wgs rows a CTA by `lanes`, over every tap and Cib in k8 slices,
    # three products each, in every (image, tile, output block, split)
    blk = blocking.choose_fwd_blocking(8, 14, 14, 3, 3, 1, 4, 128, 4, 128)
    plan = blocking.fwd_plan(blk, 8, 14, 14, 3, 3, 1, 4, 128, 4, 128)
    assert plan.tiles == blk.tiles == -(-14 // blk.th) * -(-14 // blk.tw)
    assert plan.issued_macs == (3 * 8 * blk.tiles * 4 * blk.nsplit * 64
                                * blk.wgs * blk.lanes * 9 * 512)
    live = 14 * 14 * blk.lanes * blk.nsplit
    assert 1 - plan.padding_share == pytest.approx(
        live / (blk.tiles * 64 * blk.wgs * blk.lanes * blk.nsplit))


# (th, tw, wgs, nsplit, chunk) that the window and streamed choosers take
# at each of VGG-16's 13 layers (batch 8, 224x224, relu), each with its
# time over the fastest candidate's in `python -m
# repro_torch.launch.fwd_tiles_ab` on an H100 80GB HBM3 at 700 W: summed,
# 5.0466 ms window and 5.6466 ms streamed against 5.0014 and 5.5988 for the
# fastest tile measured at each layer.  A change to the cost model that
# moves a tile shows here; time it with that script before repinning.
CHOSEN_FWD_TILES = {
    "conv1_1": ((23, 8, 3, 1, 8), 1.057, (12, 16, 3, 1, 8), 1.000),
    "conv1_2": ((16, 12, 3, 1, 16), 1.005, (12, 16, 3, 1, 16), 1.000),
    "conv2_1": ((14, 13, 3, 2, 8), 1.002, (8, 13, 2, 1, 8), 1.000),
    "conv2_2": ((16, 8, 2, 1, 8), 1.014, (16, 8, 2, 1, 8), 1.004),
    "conv3_1": ((14, 7, 2, 1, 8), 1.000, (14, 7, 2, 1, 8), 1.000),
    "conv3_2": ((19, 10, 3, 2, 16), 1.020, (3, 56, 3, 2, 16), 1.040),
    "conv3_3": ((19, 10, 3, 2, 16), 1.013, (3, 56, 3, 2, 16), 1.038),
    "conv4_1": ((14, 7, 2, 1, 8), 1.008, (14, 7, 2, 1, 8), 1.000),
    "conv4_2": ((14, 7, 2, 1, 8), 1.005, (14, 7, 2, 1, 8), 1.000),
    "conv4_3": ((14, 7, 2, 1, 8), 1.001, (14, 7, 2, 1, 8), 1.000),
    "conv5_1": ((14, 7, 2, 2, 8), 1.008, (14, 7, 2, 2, 8), 1.000),
    "conv5_2": ((14, 7, 2, 2, 16), 1.000, (14, 7, 2, 2, 16), 1.003),
    "conv5_3": ((14, 7, 2, 2, 16), 1.000, (14, 7, 2, 2, 16), 1.000),
}


def test_fwd_choosers_take_the_tiles_timed_on_the_card():
    from repro_torch.launch.fwd_tiles_ab import fwd_layers
    got = {}
    for name, ci, co, s, h in fwd_layers():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        args = (8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        got[name] = tuple((b.th, b.tw, b.wgs, b.nsplit, b.chunk) for b in (
            blocking.choose_fwd_blocking(*args),
            blocking.choose_stream_fwd_blocking(*args)))
    assert got == {name: (w, st) for name, (w, _, st, _)
                   in CHOSEN_FWD_TILES.items()}


def test_fwd_tiles_ab_times_the_chosen_tile_first():
    # launch/fwd_tiles_ab.py: VGG-16's 13 layers, each route's candidates
    # led by the chooser's tile, every (consumer count, split) among them
    from repro_torch.launch import fwd_tiles_ab as ab
    layers = ab.fwd_layers()
    assert [name for name, *_ in layers] == ab.NAMES
    for name, ci, co, s, h in layers:
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        args = (8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        for streamed, choose in ((False, blocking.choose_fwd_blocking),
                                 (True, blocking.choose_stream_fwd_blocking)):
            tiles = ab.tile_candidates(8, ci, co, s, h, streamed, 4, 1)
            assert tiles[0][1] == choose(*args)
            assert len({b for _, b in tiles}) == len(tiles)
            found = blocking.fwd_candidates(*args, blocking.H100_SXM, False,
                                            streamed)
            assert {(b.wgs, b.nsplit) for _, b in tiles} == {
                (b.wgs, b.nsplit) for _, b in found}


def test_fwd_parts_ab_edits_hold_in_the_sources():
    # launch/fwd_parts_ab.py builds variants by text edits: each must still
    # find its text, for the f32 tile and for its bf16 build
    from repro_torch.kernels._build import CSRC
    from repro_torch.launch.fwd_parts_ab import VARIANTS, VARIANTS_BF16
    assert set(VARIANTS) == {"whole", "no_wgmma", "no_a_split", "no_split",
                             "no_copy"}
    assert set(VARIANTS_BF16) == {"whole", "no_wgmma", "no_copy",
                                  "no_epilogue", "no_store", "acc_live",
                                  "a_aligned"}
    for edits in (*VARIANTS.values(), *VARIANTS_BF16.values()):
        for header, old, _ in edits:
            assert (CSRC / header).read_text().count(old) == 1, old
