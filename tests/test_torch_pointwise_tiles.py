"""The separable family's forward-path tiles on the CPU.

The pointwise forward's tile of ``csrc/conv2d_pointwise.cu`` and the dense
dgrad tile at 1x1 that the pointwise dgrad runs (``csrc/dgrad_tile.cuh``),
their arithmetic written out in numpy CTA by CTA as the kernels run it
(input rows staged zero past the map's end and past the pencil, dz = g *
act'(z) formed on the staged rows, the weight chunk in core-matrix order,
each k8 slice's three TF32 products added to one f32 accumulator rounded
toward zero, the epilogue, the tile's GAP sums), held against the
reference's ``pointwise_conv2d_blocked_pallas`` in interpret mode and its
``jax.vjp``; the depthwise forward of
``csrc/conv2d_depthwise.cu``, its item walk (lane splits, tiles, runs of
columns with the tap columns carried along a run, the window's origins and
zero fill), held against the reference's ``direct_conv_blocked(groups=C)``
and ``conv_lax``; the choosers' tiles at MobileNet v1's shapes (the
pointwise forward's, and the dense dgrad tile's at 1x1 that the pointwise
dgrad takes there); and the candidates ``launch/pointwise_tiles_ab.py``
times.

Tolerances, relative to the largest value of the reference's output: 3e-5
for the pointwise tiles, whose truncating accumulation drifts toward zero by
up to an ulp of the running sum a product (three a k8 slice: 384 at Ci =
1024), against an f32 reference summing in another order; 1e-5 for the
depthwise walk, the same nine f32 FMAs a value in another order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.core.layout import (blocked_to_nhwc as j_unblock,  # noqa: E402
                               nhwc_to_blocked as j_block)
from repro.kernels.conv2d_pointwise import (  # noqa: E402
    pointwise_conv2d_blocked_pallas)
from repro_torch.configs.cnn import MOBILENET_V1_BLOCKS  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import direct_conv_preactivation  # noqa: E402

PW_REL = 3e-5
DW_REL = 1e-5


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _act(v, act):
    if act == "relu":
        return np.maximum(v, np.float32(0))
    if act == "gelu":
        v64 = v.astype(np.float64)
        k = np.sqrt(2 / np.pi)
        return (0.5 * v64 * (1 + np.tanh(k * (v64 + 0.044715 * v64 ** 3)))
                ).astype(np.float32)
    return v


# ---------------------------------------------------------------------------
# the pointwise tile's arithmetic
# ---------------------------------------------------------------------------

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


def _mma(acc, a, b):
    """One stage into ``acc`` [M, N]: ``a`` [M, chunk], ``b`` [chunk, N],
    per k8 slice small*big, big*small, big*big (``issue`` in
    dgrad_tile.cuh)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    for k in range(0, a.shape[1], 8):
        sl = slice(k, k + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            acc = _add_rz(acc, x[:, sl].astype(np.float64)
                          @ y[sl].astype(np.float64))
    return acc


def _core_matrix(b):
    """B [chunk, N] in the producer's order [chunk/4][N][4], read back as
    the wgmma descriptor reads it: a k8 slice's two K halves N * 16 bytes
    apart, 8-lane groups 128 bytes apart."""
    chunk, n = b.shape
    flat = b.reshape(chunk // 4, 4, n).transpose(0, 2, 1).reshape(-1)
    return flat.reshape(chunk // 4, n, 4).transpose(0, 2, 1).reshape(chunk, n)


def _tile_gemm(inp, wt, blk):
    """The tile's GEMM CTA by CTA: ``inp`` [N, kblk, hw, kw], ``wt`` [oblk,
    kblk, 1, 1, kw, ow] -> per (image, output block, split, tile) the f32
    accumulator of its rows x lanes; -> [N, oblk, tiles, rows, lanes]."""
    n, kblk, hw, kw = inp.shape
    oblk, ow = wt.shape[0], wt.shape[5]
    kpad = -(-kw // 8) * 8
    lanes, rows, chunk = blk.lanes, blk.rows, blk.chunk
    acc = np.full((n, oblk, blk.nsplit, blk.tiles, rows, lanes), np.nan,
                  np.float32)
    for img in range(n):
        for o_b in range(oblk):
            for split in range(blk.nsplit):
                o0 = split * lanes
                vn = min(lanes, ow - o0)
                for tile in range(blk.tiles):
                    p0 = tile * rows
                    vr = min(rows, hw - p0)
                    c = np.zeros((rows, lanes), np.float32)
                    for kb in range(kblk):
                        wk = wt[o_b, kb, 0, 0]
                        for c0 in range(0, kpad, chunk):
                            vk = max(0, min(chunk, kw - c0))
                            a = np.zeros((rows, chunk), np.float32)
                            b = np.zeros((chunk, lanes), np.float32)
                            a[:vr, :vk] = inp[img, kb, p0:p0 + vr,
                                              c0:c0 + vk]
                            b[:vk, :vn] = wk[c0:c0 + vk, o0:o0 + vn]
                            c = _mma(c, a, _core_matrix(b))
                    acc[img, o_b, split, tile] = c
    return acc


def _tile_forward(x, wt, b, r, act, gap, blk):
    """The forward tile (``pointwise_tile_kernel<N>``) and, with
    ``gap``, its tiles' sums added in tile order times 1/hw in f32
    (``gap_finalize``)."""
    n, kblk, h, w, kw = x.shape
    oblk, ow = wt.shape[0], wt.shape[5]
    hw = h * w
    acc = _tile_gemm(x.reshape(n, kblk, hw, kw), wt, blk)
    out = np.full((n, oblk, hw, ow), np.nan, np.float32)
    sums = np.zeros((n, oblk, blk.tiles, ow), np.float32)
    for split in range(blk.nsplit):
        o0 = split * blk.lanes
        vn = min(blk.lanes, ow - o0)
        for tile in range(blk.tiles):
            p0 = tile * blk.rows
            vr = min(blk.rows, hw - p0)
            v = acc[:, :, split, tile, :vr, :vn] + b[None, :, None,
                                                      o0:o0 + vn]
            v = _act(v.astype(np.float32), act)
            if r is not None:
                v = v + r.reshape(n, oblk, hw, ow)[:, :, p0:p0 + vr,
                                                   o0:o0 + vn]
            out[:, :, p0:p0 + vr, o0:o0 + vn] = v
            sums[:, :, tile, o0:o0 + vn] = v.astype(np.float64).sum(2)
    if gap:
        pooled = sums[:, :, 0].copy()
        for t in range(1, blk.tiles):
            pooled = pooled + sums[:, :, t]
        return (pooled * (np.float32(1) / np.float32(hw))).reshape(n, -1)
    return out.reshape(n, oblk, h, w, ow)


def _prologue(g, z, act):
    """dz = g * act'(z): relu' = 1/2 at z == 0, as jnp.maximum's VJP."""
    if act == "relu":
        return np.where(z > 0, g, np.where(z == 0, np.float32(0.5) * g,
                                           np.float32(0)))
    assert act is None
    return g


def _dense_dgrad_1x1(g, z, wt, act, blk):
    """The pointwise dgrad as the dense dgrad tile runs it at a 1x1 filter
    (``dgrad_kernel``): each ``th x tw`` tile of positions of an image (zero
    past the map's edge) by the ``lanes`` of an input block, its window dz
    formed as staged, K walked (output block, ``chunk`` channels) against
    B = the weight block as stored (``[Cib][Cob]``, K-major)."""
    n, coblk, h, w, cob = g.shape
    ciblk, cib = wt.shape[1], wt.shape[4]
    kpad = -(-cob // 8) * 8
    th, tw, lanes = blk.th, blk.tw, blk.lanes
    dz = _prologue(g, z, act).astype(np.float32)
    dx = np.full((n, ciblk, h, w, cib), np.nan, np.float32)
    for img in range(n):
        for i_b in range(ciblk):
            for t0 in range(0, h, th):
                for s0 in range(0, w, tw):
                    vh, vw = min(th, h - t0), min(tw, w - s0)
                    c = np.zeros((th * tw, lanes), np.float32)
                    for o_b in range(coblk):
                        win = np.zeros((th, tw, kpad), np.float32)
                        win[:vh, :vw, :cob] = dz[img, o_b, t0:t0 + vh,
                                                 s0:s0 + vw]
                        a = win.reshape(th * tw, kpad)
                        b = np.zeros((kpad, lanes), np.float32)
                        b[:cob, :cib] = wt[o_b, i_b, 0, 0].T
                        for c0 in range(0, kpad, blk.chunk):
                            sl = slice(c0, c0 + blk.chunk)
                            c = _mma(c, a[:, sl], b[sl])
                    dx[img, i_b, t0:t0 + vh, s0:s0 + vw] = c.reshape(
                        th, tw, lanes)[:vh, :vw, :cib]
    return dx


def _pw_operands(seed, n, ci, co, h, w, cib, cob, residual, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 1, 1, cib, cob))
          / np.sqrt(ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    if ties:
        # zero inputs at one position and zero bias in half the lanes:
        # there z == 0 exactly, relu's tie
        x[:, :, 1, 2] = 0
        b[:, ::2] = 0
    r = (rng.normal(size=(n, co // cob, h, w, cob)).astype(np.float32)
         if residual else None)
    return x, wt, b, r


def _all_tiles(n, hw, kblk, kw, oblk, ow, gap):
    """The forward chooser's tile first, then every other candidate it
    weighs."""
    chosen = blocking.choose_pointwise_blocking(n, hw, kblk, kw, oblk, ow,
                                                gap=gap)
    found = [b for _, b in blocking.pointwise_candidates(
        n, hw, kblk, kw, oblk, ow, blocking.H100_SXM, gap)]
    return [chosen] + [b for b in dict.fromkeys(found) if b != chosen]


def _all_dgrad_tiles(n, h, w, ciblk, cib, cob, prologue):
    """The dense dgrad chooser's tile at 1x1 first, then every other
    candidate it weighs."""
    chosen = blocking.choose_dgrad_blocking(n, h, w, 1, 1, 1, ciblk, cib,
                                            cob, prologue=prologue)
    found = [b for _, b in blocking.dgrad_candidates(
        n, h, w, 1, 1, 1, ciblk, cib, cob, blocking.H100_SXM, prologue,
        False)]
    return [chosen] + [b for b in dict.fromkeys(found) if b != chosen]


# (n, ci, co, h, w, cib, cob, activation, residual, gap)
PW_FWD_CASES = [
    (1, 1024, 1024, 3, 3, 128, 128, "relu", False, True),   # Ci = Co = 1024
    (2, 24, 40, 5, 7, 12, 20, "gelu", True, True),          # widths % 8 != 0
    (1, 16, 24, 7, 10, 8, 24, "relu", True, False),         # 70 positions
    (2, 12, 20, 9, 9, 4, 4, "gelu", True, False),           # the gpu test's
]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act,res,gap", PW_FWD_CASES)
def test_pointwise_tile_forward_matches_pallas_interpret(n, ci, co, h, w, cib,
                                                         cob, act, res, gap):
    x, wt, b, r = _pw_operands(0, n, ci, co, h, w, cib, cob, res)
    want = np.asarray(pointwise_conv2d_blocked_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), activation=act,
        interpret=True, residual=None if r is None else jnp.asarray(r),
        gap=gap))
    tiles = _all_tiles(n, h * w, ci // cib, cib, co // cob, cob, gap)
    if ci >= 1024:
        tiles = tiles[:2]               # the chosen tile and one other
    for blk in tiles:
        _close(_tile_forward(x, wt, b, r, act, gap, blk), want, PW_REL,
               what=str(blk))


# (n, ci, co, h, w, cib, cob, activation)
PW_DGRAD_CASES = [
    (1, 1024, 1024, 3, 3, 128, 128, "relu"),     # Co = 1024, relu ties
    (2, 24, 40, 5, 7, 12, 20, "relu"),           # widths % 8 != 0
    (1, 24, 16, 7, 10, 24, 8, None),             # 70 positions, linear
]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act", PW_DGRAD_CASES)
def test_pointwise_tile_dgrad_matches_pallas_vjp(n, ci, co, h, w, cib, cob,
                                                 act):
    x, wt, b, _ = _pw_operands(1, n, ci, co, h, w, cib, cob, False,
                               ties=act == "relu")

    def jf(x_):
        return pointwise_conv2d_blocked_pallas(
            x_, jnp.asarray(wt), jnp.asarray(b), activation=act,
            interpret=True)

    out, vjp = jax.vjp(jf, jnp.asarray(x))
    g = np.random.default_rng(2).normal(size=out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    z = direct_conv_preactivation(torch.from_numpy(x), torch.from_numpy(wt),
                                  1, "VALID", torch.from_numpy(b)).numpy()
    if act == "relu":
        assert (z == 0).sum() >= co // 2 * n      # the ties are exercised
    tiles = _all_dgrad_tiles(n, h, w, ci // cib, cib, cob, act is not None)
    if co >= 1024:
        tiles = tiles[:2]
    for blk in tiles:
        _close(_dense_dgrad_1x1(g, z, wt, act, blk), np.asarray(want), PW_REL,
               what=str(blk))


# ---------------------------------------------------------------------------
# the depthwise forward's item walk
# ---------------------------------------------------------------------------

def _dw_walk(x, wt, b, r, stride, pads, dil, act, gap, blk):
    """The forward kernel (``depthwise_fwd_kernel``) item by item: the
    window staged zero outside the map, each position group's runs of
    columns (the three tap columns carried along a run at 3x3, dilation 1,
    stride 1 or 2), one f32 FMA a tap, the epilogue, each item's GAP sums
    by position group in order; -> the output or, with ``gap``, the pooled
    features (``gap_finalize``)."""
    n, cblk, hi, wi, cb = x.shape
    hf, wf = wt.shape[2], wt.shape[3]
    (pt, _), (pl, _) = pads
    dh_, dw_ = dil
    ho = (hi + sum(pads[0]) - (hf - 1) * dh_ - 1) // stride + 1
    wo = (wi + sum(pads[1]) - (wf - 1) * dw_ - 1) // stride + 1
    lanes, hob, wob = blk.lanes, blk.hob, blk.wob
    tiles_w = wo // wob
    tiles = (ho // hob) * tiles_w
    groups = cb // lanes
    npg = blocking.H100_SXM.threads // lanes
    segs = min(wob, max(1, -(-npg // hob)))
    run = -(-wob // segs)
    fast = (hf, wf, dil) == (3, 3, (1, 1)) and stride in (1, 2)
    out = np.full((n, cblk, ho, wo, cb), np.nan, np.float32)
    sums = np.full((n, cblk, tiles, cb), np.nan, np.float32)
    assert blk.items == n * cblk * groups * tiles
    for it in range(blk.items):
        tile, rest = it % tiles, it // tiles
        lane0, m = rest % groups * lanes, rest // groups
        img, c_b = divmod(m, cblk)
        i0, j0 = tile // tiles_w * hob, tile % tiles_w * wob
        win = np.zeros((blk.hwin, blk.wwin, lanes), np.float32)
        for rr in range(blk.hwin):
            for cc in range(blk.wwin):
                ih, iw = i0 * stride - pt + rr, j0 * stride - pl + cc
                if 0 <= ih < hi and 0 <= iw < wi:
                    win[rr, cc] = x[img, c_b, ih, iw, lane0:lane0 + lanes]
        wv = wt[c_b, 0, :, :, 0, lane0:lane0 + lanes].reshape(hf * wf, lanes)
        bv = b[c_b, lane0:lane0 + lanes]
        gsum = np.zeros((npg, lanes), np.float32)
        for u in range(hob * segs):
            i, jb = u // segs, u % segs * run
            for j in range(jb, min(wob, jb + run)):
                acc = np.zeros(lanes, np.float32)
                if fast:
                    taps = [win[i * stride + d, j * stride + e]
                            for d in range(3) for e in range(3)]
                else:
                    taps = [win[i * stride + q // wf * dh_,
                                j * stride + q % wf * dw_]
                            for q in range(hf * wf)]
                for q, a in enumerate(taps):
                    acc = (a.astype(np.float64) * wv[q] + acc).astype(
                        np.float32)
                v = _act((acc + bv).astype(np.float32), act)
                if r is not None:
                    v = v + r[img, c_b, i0 + i, j0 + j, lane0:lane0 + lanes]
                out[img, c_b, i0 + i, j0 + j, lane0:lane0 + lanes] = v
                gsum[u % npg] += v
        total = np.zeros(lanes, np.float32)
        for q in range(npg):
            total += gsum[q]
        sums[img, c_b, tile, lane0:lane0 + lanes] = total
    if gap:
        pooled = sums[:, :, 0].copy()
        for t in range(1, tiles):
            pooled = pooled + sums[:, :, t]
        return (pooled * (np.float32(1) / np.float32(ho * wo))).reshape(n,
                                                                        -1)
    return out


def _dw_operands(seed, n, c, h, w, cb, residual_shape=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c // cb, h, w, cb)).astype(np.float32)
    wt = (rng.normal(size=(c // cb, 1, 3, 3, 1, cb)) / 3).astype(np.float32)
    b = (0.1 * rng.normal(size=(c // cb, cb))).astype(np.float32)
    r = (rng.normal(size=residual_shape).astype(np.float32)
         if residual_shape else None)
    return x, wt, b, r


# (n, c, h, w, cb, stride, padding, dilation, activation, residual, gap)
DW_CASES = [
    (1, 64, 9, 10, 64, 1, "SAME", 1, "relu", False, False),   # lane split
    (2, 16, 8, 8, 16, 2, "SAME", 1, "relu", False, True),     # pads (0, 1)
    (1, 128, 7, 7, 128, 1, "SAME", 1, "gelu", True, True),    # 7x7 pencil
    (2, 8, 12, 12, 8, 1, "SAME", 2, "gelu", True, False),     # dilation 2
    (1, 6, 9, 9, 3, 2, "VALID", 1, None, False, False),       # Cb = 3
]


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,act,res,gap", DW_CASES)
def test_depthwise_walk_matches_jax_oracle_and_lax(n, c, h, w, cb, s, pad,
                                                   dil, act, res, gap):
    spec = ConvSpec.make(n, h, w, c, c, 3, 3, s, pad, groups=c, dilation=dil)
    out_shape = (n, c // cb, spec.ho, spec.wo, cb)
    x, wt, b, r = _dw_operands(3, n, c, h, w, cb, out_shape if res else None)
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(wt), s, pad,
                               jnp.asarray(b), act, groups=c, dilation=dil,
                               residual=None if r is None else jnp.asarray(r),
                               gap=gap))
    for batch_blk in {blocking.choose_depthwise_blocking(
            n, c // cb, spec.ho, spec.wo, cb, 3, 3, s, spec.dilation,
            gap=gap), blocking.choose_depthwise_blocking(
            8 * n, c // cb, spec.ho, spec.wo, cb, 3, 3, s, spec.dilation,
            gap=gap)}:
        # the tiles a batch of 8n takes, walked over these n images
        tiles = (spec.ho // batch_blk.hob) * (spec.wo // batch_blk.wob)
        blk = blocking.DepthwiseBlocking(
            hob=batch_blk.hob, wob=batch_blk.wob, hwin=batch_blk.hwin,
            wwin=batch_blk.wwin, lanes=batch_blk.lanes,
            items=n * c // batch_blk.lanes * tiles, grid=batch_blk.grid)
        got = _dw_walk(x, wt, b, r, s, spec.pads, spec.dilation, act, gap,
                       blk)
        _close(got, want, DW_REL, what=str(blk))
    # the bare conv against XLA's grouped convolution
    w_hwio = np.transpose(wt[:, 0, :, :, 0, :], (1, 2, 0, 3)).reshape(
        3, 3, 1, c)
    lax = np.asarray(j_block(conv_lax(j_unblock(jnp.asarray(x)),
                                      jnp.asarray(w_hwio), s, pad, groups=c,
                                      dilation=dil), cb))
    blk = blocking.choose_depthwise_blocking(n, c // cb, spec.ho, spec.wo,
                                             cb, 3, 3, s, spec.dilation)
    _close(_dw_walk(x, wt, np.zeros_like(b), None, s, spec.pads,
                    spec.dilation, None, False, blk), lax, DW_REL)


# ---------------------------------------------------------------------------
# the choosers at MobileNet v1's shapes, and the tiles timed on the card
# ---------------------------------------------------------------------------

def _legs(entry=224):
    """MobileNet v1's blocks as ``(ci, co, stride, h)``, ``h`` the
    depthwise leg's input extent."""
    h, out = -(-entry // 2), []
    for ci, co, s in MOBILENET_V1_BLOCKS:
        out.append((ci, co, s, h))
        h = -(-h // s)
    return out


# (rows, lanes, nsplit, chunk) the pointwise chooser takes at each distinct
# MobileNet v1 leg (ci, co, h), the forward at batch 8 (the last leg with
# GAP); and the (th, tw, consumer warpgroups, chunk) of the dense dgrad tile
# at 1x1 that the pointwise dgrad launches there (batch 32, relu prologue)
PW_TILES = {
    (32, 64, 112): ((192, 64, 1, 32), (14, 13, 3, 64)),
    (64, 128, 56): ((192, 64, 2, 64), (19, 7, 3, 64)),
    (128, 128, 56): ((192, 64, 2, 64), (56, 3, 3, 32)),
    (128, 256, 28): ((128, 128, 1, 32), (14, 7, 2, 32)),
    (256, 256, 28): ((128, 128, 1, 32), (28, 5, 3, 32)),
    (256, 512, 14): ((128, 64, 2, 64), (14, 7, 2, 32)),
    (512, 512, 14): ((128, 64, 2, 64), (14, 7, 2, 32)),
    (512, 1024, 7): ((64, 64, 2, 64), (7, 7, 1, 64)),
    (1024, 1024, 7): ((64, 64, 2, 64), (7, 7, 1, 64)),
}


def test_pointwise_chooser_pins_mobilenet_tiles():
    for ci, co, s, h in _legs():
        ho = -(-h // s)
        cib, cob = min(ci, 128), min(co, 128)
        fwd = blocking.choose_pointwise_blocking(
            8, ho * ho, ci // cib, cib, co // cob, cob, gap=ci == 1024)
        dgrad = blocking.choose_dgrad_blocking(32, ho, ho, 1, 1, 1, ci // cib,
                                               cib, cob, prologue=True)
        assert ((fwd.rows, fwd.lanes, fwd.nsplit, fwd.chunk),
                (dgrad.th, dgrad.tw, dgrad.wgs, dgrad.chunk)) == \
            PW_TILES[(ci, co, ho)], (ci, co, ho, fwd, dgrad)
        assert fwd.tiles == -(-ho * ho // fwd.rows)


def test_pointwise_issued_macs_count_the_tiles_padding():
    blk = blocking.choose_pointwise_blocking(8, 49, 8, 128, 8, 128, gap=True)
    issued = blocking.pointwise_issued_macs(blk, 8, 8, 128, 8)
    function = 8 * 49 * 1024 * 1024
    # one 64-row m-tile for 49 positions
    assert issued == 3 * function * 64 // 49


def test_depthwise_chooser_walks_every_output_once():
    for ci, _, s, h in _legs():
        ho = -(-h // s)
        cb = min(ci, 128)
        for n in (8, 32):
            blk = blocking.choose_depthwise_blocking(n, ci // cb, ho, ho, cb,
                                                     3, 3, s)
            tiles = (ho // blk.hob) * (ho // blk.wob)
            assert blk.items == n * ci // blk.lanes * tiles
            npg = blocking.H100_SXM.threads // blk.lanes
            assert blk.hob * blk.wob >= npg or blk.hob * blk.wob == ho * ho


def test_pointwise_tiles_ab_times_the_chosen_tile_first():
    from repro_torch.launch import pointwise_tiles_ab as ab
    legs = ab.pointwise_legs()
    assert len(legs) == 9 and legs[-1] == (1024, 1024, 7)
    for ci, co, h in legs:
        cib, cob = min(ci, 128), min(co, 128)
        tiles = ab.tile_candidates(ci, co, h)
        args = (8, h * h, ci // cib, cib, co // cob, cob)
        gap = (ci, co) == (1024, 1024)
        assert tiles[0] == blocking.choose_pointwise_blocking(*args, gap=gap)
        found = blocking.pointwise_candidates(*args, blocking.H100_SXM, gap)
        assert set(tiles) == {b for _, b in found}
        tiles = ab.dgrad_tile_candidates(ci, co, h)
        args = (32, h, h, 1, 1, 1, ci // cib, cib, cob)
        assert tiles[0] == blocking.choose_dgrad_blocking(*args,
                                                          prologue=True)
        found = blocking.dgrad_candidates(*args, blocking.H100_SXM, True,
                                          False)
        assert set(tiles) == {b for _, b in found}


def test_separable_shape_checks_are_cached_by_shape_and_raise_each_call():
    from repro_torch.kernels import conv2d_depthwise as dwk
    from repro_torch.kernels import conv2d_pointwise as pwk
    x, wt, b, _ = _dw_operands(9, 1, 8, 6, 6, 4)
    xt, wtt, bt = map(torch.from_numpy, (x, wt, b))
    want = dwk.depthwise_conv2d_blocked(xt, wtt, bt, 1, "SAME", "relu")
    # a list as padding cannot key the cache: it is checked at every call
    got = dwk.depthwise_conv2d_blocked(xt, wtt, bt, 1, [[1, 1], [1, 1]],
                                       "relu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for _ in range(2):          # a failed check is never cached
        with pytest.raises(ValueError, match="bias shape"):
            dwk.depthwise_conv2d_blocked(xt, wtt, bt.reshape(-1))
        with pytest.raises(ValueError, match="zero-pad only"):
            pwk.pointwise_conv2d_blocked(
                xt, torch.zeros(2, 2, 1, 1, 4, 4), padding=[[1, 1], [0, 0]])
