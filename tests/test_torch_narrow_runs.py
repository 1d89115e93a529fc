"""The narrow rows (``csrc/narrow_rows.cuh``) of the bf16 window forward
and wgrad on the CPU: where a filter row's ``(dw, c)`` run of ``wf * Cib``
values fits one 128-byte operand row at dilation 1 (Cib 3 at 11x11 and 3x3:
the first conv of AlexNet, VGG-16 and MobileNet v1), the producer builds one
row an output position and group of ``r`` filter rows from the tile's input
rows, and both kernels read those rows, the forward K-major against the
weights' rows as they lie, the wgrad MN-major against dz.

Here in numpy: the raw rows as ``narrow_rows::stage`` lands them byte by
byte (the aligned 16-byte chunks covering a row's pixels in the map, each at
its offset mod 16, the neighbours' bytes and a stale slot's left where they
fall) and the rows as ``narrow_rows::build`` reads them (five aligned words
funnel-shifted by the run's 2-byte phase, or a value at a time, zeros past
the map, past the filter and past the row's values), against the runs they
hold; the packed GEMMs as the kernels run them (a k16 slice's exact sum
added into an f32 accumulator rounding toward zero; the forward's one
accumulator, the wgrad's fresh one a stage and its shares in split order)
against the reference's ``direct_conv_blocked`` under ``BF16`` and its
``jax.vjp`` (3x3 and 5x5; the jnp oracle dispatches its taps one by one,
too slow at 49 and 121 taps) and ``conv_lax`` and its VJP (every case),
each on the same bf16-rounded operands: the forward within one bf16 ulp of
each element plus 1e-5 of max|y|, dw within 1e-5 of max|dw|.  Also TMA's
element-strided boxes (the bf16 wgrad's x at odd widths), and the choosers
and plans of both kernels at the three nets' layers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import precision as jprecision  # noqa: E402
from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro_torch.configs.cnn import (alexnet_blocked,  # noqa: E402
                                     mobilenet_v1_layers, vgg16_layers)
from repro_torch.core import blocking, conv2d_common  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.padding import normalize_padding  # noqa: E402


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), as f32."""
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().float() \
        .numpy()


def _bf16_bits(a):
    """The bf16 bit patterns of already-rounded f32 values, as uint16."""
    return (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(
        np.uint16)


def _from_bits(u):
    return (np.asarray(u, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32 (the tensor cores' add)."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


# ---------------------------------------------------------------------------
# narrow_rows::stage and narrow_rows::build, byte by byte
# ---------------------------------------------------------------------------

def _raw_pitch(cib, pixels):
    return -(-(2 * cib * pixels + 32) // 16) * 16


class Memory:
    """x's bf16 bytes at a 16-byte aligned device address, for the
    copies' address arithmetic."""

    def __init__(self, x, base=1 << 20):
        self.bytes = np.frombuffer(_bf16_bits(x).tobytes(), np.uint8)
        self.base = base
        self.shape = x.shape

    def block(self, img, blk):
        """The address of image ``img``'s input block ``blk``."""
        _, ciblk, hi, wi, cib = self.shape
        return self.base + 2 * (img * ciblk + blk) * hi * wi * cib

    def read(self, addr, n):
        off = addr - self.base
        assert 0 <= off and off + n <= len(self.bytes), "outside x"
        return self.bytes[off:off + n]


def stage_raw(mem, xb, hi, wi, cib, ih0, iw0, rows, pixels, rng):
    """``narrow_rows::stage``: the raw buffer (bytes, its stale contents
    random) and the table ``(lead, lo, hi)`` a row."""
    rp = _raw_pitch(cib, pixels)
    raw = rng.integers(0, 256, rows * rp + 64, dtype=np.uint8)
    table = []
    row_bytes = 2 * cib * wi
    for r in range(rows):
        ih = ih0 + r
        inside = 0 <= ih < hi
        plo = (-iw0 if iw0 < 0 else 0) if inside else 0
        phi = min(wi - iw0, pixels) if inside else 0
        phi = max(phi, plo)
        g0 = xb + ih * row_bytes + 2 * cib * iw0
        table.append((g0 & 15, plo, phi))
        if phi <= plo:
            continue
        ge = g0 + 2 * cib * phi
        a = (g0 + 2 * cib * plo) & ~15
        while a < ge:
            n = min(16, ge - a)
            dst = r * rp + (a - (g0 & ~15))
            assert dst % 16 == 0 and dst + 16 <= rows * rp
            raw[dst:dst + n] = mem.read(a, n)
            raw[dst + n:dst + 16] = 0                # cp.async's zero fill
            a += 16
    return raw, table


def clear_raw(raw, table, pixels, cib):
    """``narrow_rows::clear``: each row's pixels outside [lo, hi) zeroed."""
    rp = _raw_pitch(cib, pixels)
    for r, (lead, lo, hi) in enumerate(table):
        for p in list(range(lo)) + list(range(hi, pixels)):
            at = r * rp + lead + 2 * cib * p
            raw[at:at + 2 * cib] = 0


def build_rows(raw, table, pixels, cib, stride, hf, wf, j, tw, npos, nrows,
               rng):
    """``narrow_rows::build`` of group ``j`` into ``nrows`` 128-byte rows
    (swizzled as stored, then read back unswizzled) from cleared raw rows
    -> [nrows, 64] bf16 bits; rows past ``npos`` keep the slot's zeros."""
    L = wf * cib
    cpr = blocking.narrow_run_pad(wf, cib) // 8
    r = blocking.narrow_rows_a_group(hf, wf, cib)
    nq = r * cpr
    rp = _raw_pitch(cib, pixels)
    out = np.zeros(nrows * 128, np.uint8)
    words = raw.view(np.uint32)

    for q in range(nq):
        k, e0 = divmod(q, cpr)
        e0 *= 8
        dead = j * r + k >= hf
        nv = min(8, L - e0)
        mask = [0 if dead else (0xFFFFFFFF if 2 * e + 1 < nv else
                                (0xFFFF if 2 * e < nv else 0))
                for e in range(4)]
        for f in range(npos):
            oh, ow = divmod(f, tw)
            i = 0 if dead else oh * stride + j * r + k
            a = i * rp + table[i][0] + ow * stride * cib * 2 + 2 * e0
            x = [int(words[(a & ~3) // 4 + e]) for e in range(5)]
            sh = (a & 2) * 8
            w4 = [(((x[e + 1] << 32 | x[e]) >> sh) & 0xFFFFFFFF) & mask[e]
                  for e in range(4)]
            chunk = np.array(w4, np.uint32).view(np.uint8)
            at = f * 128 + ((q ^ (f & 7)) << 4)
            out[at:at + 16] = chunk
    # read back through the swizzle
    rows = np.zeros((nrows, 64), np.uint16)
    for f in range(nrows):
        for q in range(8):
            at = f * 128 + ((q ^ (f & 7)) << 4)
            rows[f, 8 * q:8 * q + 8] = out[at:at + 16].view(np.uint16)
    return rows


def runs_of(xp, oy, ox, img, blk, h0, w0, stride, hf, wf, cib, j, th, tw,
            nrows):
    """The rows the kernels read, from their definition: row f (< th tw) of
    group j holds, at k Lp + e (e < L), element e of the run of input row
    s (f // tw) + j r + k from column s (f % tw) (``xp`` framed in zeros,
    origin ``(oy, ox)``), zero past each run, past the filter and past
    r Lp -> f32."""
    L = wf * cib
    Lp = blocking.narrow_run_pad(wf, cib)
    r = blocking.narrow_rows_a_group(hf, wf, cib)
    rows = np.zeros((nrows, 64), np.float32)
    for f in range(th * tw):
        oh, ow = divmod(f, tw)
        for k in range(r):
            dh = j * r + k
            if dh >= hf:
                continue
            ih = oy + h0 + oh * stride + dh
            iw = ox + w0 + ow * stride
            rows[f, k * Lp:k * Lp + L] = xp[img, blk, ih, iw:iw + wf,
                                              :cib].reshape(-1)
    return rows


def _framed(x, frame):
    n, ciblk, hi, wi, cib = x.shape
    xp = np.zeros((n, ciblk, hi + 2 * frame, wi + 2 * frame, cib),
                  np.float32)
    xp[:, :, frame:frame + hi, frame:frame + wi] = x
    return xp


# (n, ci, h, w, f, stride, padding, th, tw): AlexNet's conv1 on a small map
# (227 wide's odd rows: 2-byte aligned), VGG-16's conv1_1 and MobileNet's
# conv1 (SAME), 7x7 stride 2 pads 3, Cib 8 at 5x5 (40-value runs)
BUILD_CASES = [
    (2, 3, 35, 35, 11, 4, "VALID", 2, 7),
    (2, 3, 13, 15, 3, 1, "SAME", 3, 15),
    (2, 3, 15, 13, 3, 2, "SAME", 4, 5),
    (1, 3, 19, 17, 7, 2, ((3, 3), (3, 3)), 3, 6),
    (2, 8, 11, 9, 5, 1, "SAME", 2, 9),
]


@pytest.mark.parametrize("n,ci,h,w,f,s,padding,th,tw", BUILD_CASES)
def test_built_rows_hold_the_runs(n, ci, h, w, f, s, padding, th, tw):
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(size=(n, 1, h, w, ci)))
    mem = Memory(x)
    (pt, _), (pl, _) = normalize_padding(padding, f, f, s, h, w)
    ho = (h + sum(normalize_padding(padding, f, f, s, h, w)[0]) - f) // s + 1
    wo = (w + sum(normalize_padding(padding, f, f, s, h, w)[1]) - f) // s + 1
    hwin, wwin = (th - 1) * s + f, (tw - 1) * s + f
    frame = 2 * (hwin + wwin)
    xp = _framed(x, frame)
    ng = blocking.narrow_groups(f, f, ci)
    nrows = -(-th * tw // 16) * 16 + 16
    for img in range(n):
        for oh0 in range(0, ho, th):
            for ow0 in range(0, wo, tw):
                h0, w0 = oh0 * s - pt, ow0 * s - pl
                raw, table = stage_raw(mem, mem.block(img, 0), h, w, ci, h0,
                                       w0, hwin, wwin, rng)
                clear_raw(raw, table, wwin, ci)
                for j in range(ng):
                    got = build_rows(raw, table, wwin, ci, s, f, f, j, tw,
                                     th * tw, nrows, rng)
                    want = runs_of(xp, frame, frame, img, 0, h0, w0, s, f, f,
                                   ci, j, th, tw, nrows)
                    np.testing.assert_array_equal(_from_bits(got), want)


def test_raw_rows_land_aligned_and_inside_their_buffer():
    # every 16-byte copy's destination is 16-byte aligned and inside its
    # row's pitch, whatever the row's alignment in x (227 pixels of Cib 3:
    # 1362-byte rows, 2-byte aligned) and however far the tile hangs past
    # the map (stage_raw asserts both)
    rng = np.random.default_rng(1)
    x = _bf16(rng.normal(size=(3, 1, 9, 227, 3)))
    mem = Memory(x)
    leads = set()
    for img in range(3):
        for iw0 in (-5, 0, 7, 100, 200):
            raw, table = stage_raw(mem, mem.block(img, 0), 9, 227, 3, -2,
                                   iw0, 13, 59, rng)
            leads |= {lead for lead, _, _ in table}
            for r, (_, lo, hi) in enumerate(table):
                ih = -2 + r
                if not 0 <= ih < 9:
                    assert lo == hi == 0
                else:
                    assert lo == max(0, -iw0) and hi == min(59, 227 - iw0)
    assert len(leads) > 4           # the rows start at many offsets mod 16


# ---------------------------------------------------------------------------
# the packed GEMMs as the kernels run them
# ---------------------------------------------------------------------------

def narrow_forward(x, wt, b, r, pads, stride, act, gap, blk, f32=False):
    """``fwd_kernel_bf16_narrow`` in numpy, item by item in the persistent
    walk's order: each stage (an input block of the group), each group j of
    filter rows a wgmma group of nkpad / 16 k16 slices into the one f32
    accumulator, A the group's rows (a row a position of the tile, row f =
    (f // tw, f % tw), zeros past the tile), B the weights' rows j r L ..
    of the block's [taps * Cib][Cob] as they lie (zeros past the filter
    and past Cob); the epilogue (+ f32 bias, activation, + r in f32)
    rounded once to bf16 on the rows in the tile and the map; with ``gap``
    the pooled features as ``conv2d_common.gap_replay`` pools the stored
    map (``pitch`` tw) -> bf16 torch tensors, or with ``f32`` the f32 sums
    before the epilogue."""
    from test_torch_bf16_fwd import _act
    assert blk.narrow and blk.pitch == blk.tw and blk.strips == 1
    x, wt = _bf16(x), _bf16(wt)
    r_ = None if r is None else _bf16(r)
    n, ciblk, hi, wi, cib = x.shape
    coblk, cigblk, hf, wf, _, cob = wt.shape
    groups = ciblk // cigblk
    (pt, _), (pl, _) = pads
    s = stride
    ho = (hi + sum(pads[0]) - hf) // s + 1
    wo = (wi + sum(pads[1]) - wf) // s + 1
    ng = blocking.narrow_groups(hf, wf, cib)
    kp = blocking.narrow_kpad(hf, wf, cib)
    r = blocking.narrow_rows_a_group(hf, wf, cib)
    L, Lp = wf * cib, blocking.narrow_run_pad(wf, cib)
    lanes, th, tw = blk.lanes, blk.th, blk.tw
    rows = 64 * blk.wgs
    assert th * tw <= rows
    across = -(-wo // tw)
    tiles = -(-ho // th) * across
    assert tiles == blk.tiles
    cols = coblk * blk.nsplit
    frame = 2 * (blk.hwin + blk.wwin)
    xp = _framed(x, frame)
    wrows = wt.reshape(coblk, cigblk, hf * wf * cib, cob)
    fidx = np.arange(rows)
    a_, c_ = fidx // tw, fidx % tw
    out = np.full((n, coblk, ho, wo, cob), np.nan, np.float32)
    for i in range(tiles * cols * n):
        tile, col, img = i % tiles, i // tiles % cols, i // tiles // cols
        o_b, split = divmod(col, blk.nsplit)
        oh0, ow0 = tile // across * th, tile % across * tw
        h0, w0 = oh0 * s - pt, ow0 * s - pl
        o0 = split * lanes
        vn = max(0, min(lanes, cob - o0))
        keep = (a_ < th) & (oh0 + a_ < ho) & (ow0 + c_ < wo)
        acc = np.zeros((rows, lanes), np.float32)
        for i_b in range(cigblk):
            xb = o_b // (coblk // groups) * cigblk + i_b
            for j in range(ng):
                am = runs_of(xp, frame, frame, img, xb, h0, w0, s, hf, wf,
                             cib, j, th, tw, rows)[:, :kp]
                # run k's L weight rows (j r + k) L .. at row k Lp, the
                # gaps and the runs past the filter zero
                bm = np.zeros((kp, lanes), np.float32)
                for k in range(min(r, hf - j * r)):
                    r0 = (j * r + k) * L
                    bm[k * Lp:k * Lp + L, :vn] = wrows[o_b, i_b, r0:r0 + L,
                                                       o0:o0 + vn]
                for k in range(0, kp, 16):
                    sl = slice(k, k + 16)
                    acc = _add_rz(acc, am[:, sl].astype(np.float64)
                                  @ bm[sl].astype(np.float64))
        oh, ow = oh0 + a_[keep], ow0 + c_[keep]
        if f32:
            v = acc[keep, :vn]
        else:
            v = _act(acc[keep, :vn] + b[o_b, o0:o0 + vn].astype(np.float32),
                     act)
            if r_ is not None:
                v = v + r_[img, o_b, oh, ow, o0:o0 + vn]
        assert np.isnan(out[img, o_b, oh, ow, o0:o0 + vn]).all()
        out[img, o_b, oh, ow, o0:o0 + vn] = v
    assert not np.isnan(out).any()
    if f32:
        return out
    stored = torch.from_numpy(out).bfloat16()
    return conv2d_common.gap_replay(stored, blk) if gap else stored


def narrow_wgrad(x, dz, blk, hf, wf, stride, pads, groups=1):
    """``wgrad_kernel_bf16_narrow`` in numpy on dz as the dz pass leaves
    it: per CTA (Ci block of the group, Co block, m-tile group, share) its
    m-tiles the groups of filter rows u0 .. u0 + tpg; each stage (a tile of
    the share) A the group's rows (row p a position, zeros past the tile's
    positions to K padded to 16), B the tile's dz [kpos][lanes] (zeros past
    the map and past Cob); a k16 slice's exact sum into a fresh f32
    accumulator rounding toward zero, the stage's accumulator then added
    into the running f32 sum; rows below r L and the filter stored; the
    shares' rows added in split order -> dw [Co/Cob, Cig/Cib, Hf, Wf, Cib,
    Cob]."""
    assert blk.narrow and blk.kstep == 16
    x, dz = _bf16(x), _bf16(dz)
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = dz.shape
    cigblk = ciblk // groups
    (pt, _), (pl, _) = pads
    th, tw, lanes, kpos = blk.th, blk.tw, blk.lanes, blk.kpos
    span = blk.wgs * blk.mpw
    tpg, gph, _, ngroups = blocking.wgrad_bf16_groups(hf, wf, cib, span, 1)
    assert ngroups == blk.groups
    ng = blocking.narrow_groups(hf, wf, cib)
    r = blocking.narrow_rows_a_group(hf, wf, cib)
    L, Lp = wf * cib, blocking.narrow_run_pad(wf, cib)
    taps = hf * wf
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    total_tiles = n * tiles_h * tiles_w
    assert total_tiles == blk.tiles
    frame = 2 * (blk.hwin + blk.wwin)
    xp = _framed(x, frame)
    dw_size = coblk * cigblk * taps * cib * cob
    ws = np.full((blk.splits, dw_size), np.nan, np.float32)
    for ci_b in range(cigblk):
        for co_b in range(coblk):
            xb = co_b // (coblk // groups) * cigblk + ci_b
            for group in range(ngroups):
                u0 = group % gph * tpg
                units = [u for u in range(u0, u0 + tpg) if u < ng]
                for split in range(blk.splits):
                    first = total_tiles * split // blk.splits
                    last = total_tiles * (split + 1) // blk.splits
                    total = np.zeros((len(units), 64, lanes), np.float32)
                    for t in range(first, last):
                        img, rem = divmod(t, tiles_h * tiles_w)
                        a, bcol = divmod(rem, tiles_w)
                        oh0, ow0 = a * th, bcol * tw
                        h0, w0 = oh0 * stride - pt, ow0 * stride - pl
                        b_op = np.zeros((kpos, lanes), np.float32)
                        for p in range(th * tw):
                            oh, ow = oh0 + p // tw, ow0 + p % tw
                            if oh < ho and ow < wo:
                                b_op[p, :cob] = dz[img, co_b, oh, ow]
                        for m, u in enumerate(units):
                            a_op = runs_of(xp, frame, frame, img, xb, h0, w0,
                                           stride, hf, wf, cib, u, th, tw,
                                           kpos)
                            acc = np.zeros((64, lanes), np.float32)
                            for j in range(kpos // 16):
                                sl = slice(16 * j, 16 * j + 16)
                                acc = _add_rz(acc, a_op[sl].T.astype(
                                    np.float64) @ b_op[sl].astype(np.float64))
                            total[m] = total[m] + acc
                    for m, u in enumerate(units):
                        # row k Lp + e of the m-tile: dw row (u r + k) L + e
                        for k in range(min(r, hf - u * r)):
                            for e in range(L):
                                base = ((co_b * cigblk + ci_b) * taps * cib
                                        + (u * r + k) * L + e) * cob
                                ws[split, base:base + cob] = \
                                    total[m, k * Lp + e, :cob]
    assert not np.isnan(ws).any()            # every (tap, c) written once
    out = ws[0].copy()
    for k in range(1, blk.splits):
        out = out + ws[k]
    return out.reshape(coblk, cigblk, hf, wf, cib, cob)


def _ulp_close(got, want):
    """Every element within one bf16 ulp of its magnitude plus 1e-5 of
    max|want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    bound = ulp + 1e-5 * np.abs(w).max()
    assert (np.abs(g - w) <= bound).all(), float((np.abs(g - w) / bound)
                                                 .max())


def _max_close(got, want, rel):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), (err, np.abs(w).max())


def _nhwc(a):
    n, cblk, h, w, cb = a.shape
    return a.transpose(0, 2, 3, 1, 4).reshape(n, h, w, cblk * cb)


def _hwio(wt):
    coblk, ciblk, hf, wf, cib, cob = wt.shape
    return wt.transpose(2, 3, 1, 4, 0, 5).reshape(hf, wf, ciblk * cib,
                                                  coblk * cob)


def _blocked(y, cob):
    n, ho, wo, co = y.shape
    return y.reshape(n, ho, wo, co // cob, cob).transpose(0, 3, 1, 2, 4)


def _lax_forward(x, wt, stride, padding):
    """conv_lax of the blocked operands -> the blocked f32 sums."""
    y = conv_lax(jnp.asarray(_nhwc(x)), jnp.asarray(_hwio(wt)), stride,
                 padding)
    return _blocked(np.asarray(y, np.float32), wt.shape[5])


# (n, ci, co, h, w, f, cib, cob, stride, padding, activation, oracle): the
# cases of the Tentpole's phase 27 at small maps; ``oracle`` True holds the
# forward and dw to the jnp oracle under BF16 too (3x3 and 5x5 only)
GEMM_CASES = [
    (2, 3, 48, 35, 35, 11, 3, 48, 4, "VALID", "relu", False),
    (2, 3, 16, 12, 13, 3, 3, 16, 1, "SAME", "gelu", True),
    (2, 3, 32, 15, 14, 3, 3, 32, 2, "SAME", "relu", True),
    (1, 3, 16, 17, 19, 7, 3, 16, 2, ((3, 3), (3, 3)), None, False),
    (2, 8, 16, 11, 9, 5, 8, 16, 1, "SAME", "relu", True),
]


def _gemm_operands(seed, n, ci, co, h, w, f, cib, cob):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(n, ci // cib, h, w, cib)))
    wt = _bf16(rng.normal(size=(co // cob, ci // cib, f, f, cib, cob))
               / np.sqrt(f * f * ci))
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    return x, wt, b


def _narrow_fwd_tile(n, ho, wo, f, s, ciblk, cib, coblk, cob, gap):
    """The search's least-cost narrow tile (at a small map the per-tap
    tile may cost less)."""
    found = blocking.fwd_candidates(n, ho, wo, f, f, s, ciblk, cib, coblk,
                                    cob, blocking.H100_SXM, gap, False,
                                    op_bytes=2, narrow=True)
    return min(found, key=lambda kb: kb[0])[1]


def _narrow_wgrad_tile(n, ho, wo, f, s, ciblk, cib, coblk, cob):
    found = blocking.wgrad_candidates(n, ho, wo, f, f, s, ciblk, cib,
                                      coblk, cob, blocking.H100_SXM, False,
                                      False, op_bytes=2, narrow=True)
    return min(found, key=lambda kb: kb[0])[1]


@pytest.mark.parametrize("n,ci,co,h,w,f,cib,cob,s,padding,act,oracle",
                         GEMM_CASES)
def test_narrow_forward_matches_the_reference(n, ci, co, h, w, f, cib, cob,
                                              s, padding, act, oracle):
    x, wt, b = _gemm_operands(1, n, ci, co, h, w, f, cib, cob)
    spec = ConvSpec.make(n, h, w, ci, co, f, f, s, padding)
    pads = spec.pads
    blk = _narrow_fwd_tile(n, spec.ho, spec.wo, f, s, ci // cib, cib,
                           co // cob, cob, False)
    # the chooser's tile and a small one that overhangs the map
    small = dataclasses.replace(
        blk, th=2, tw=3, wgs=1, tiles=-(-spec.ho // 2) * -(-spec.wo // 3),
        hwin=s + f, wwin=2 * s + f, pitch=3)
    for tile in (blk, small):
        sums = narrow_forward(x, wt, b, None, pads, s, act, False, tile,
                              f32=True)
        _ulp_close(_bf16(sums), _bf16(_lax_forward(x, wt, s, padding)))
        got = narrow_forward(x, wt, b, None, pads, s, act, False, tile)
        if oracle:
            want = jax_conv(jnp.asarray(x), jnp.asarray(wt), s, padding,
                            jnp.asarray(b), act, precision=jprecision.BF16)
            _ulp_close(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)))


def test_narrow_forward_gap_and_residual_match_the_oracle():
    # the conv1 shape's GAP folded (``check_gap`` on the card): the stored
    # map's pooled features in the tile's order; and a residual
    n, ci, co, h, w, f, cib, cob, s = 2, 3, 16, 12, 13, 3, 3, 16, 1
    x, wt, b = _gemm_operands(2, n, ci, co, h, w, f, cib, cob)
    spec = ConvSpec.make(n, h, w, ci, co, f, f, s, "SAME")
    res = _bf16(np.random.default_rng(3).normal(
        size=(n, co // cob, spec.ho, spec.wo, cob)))
    blk = _narrow_fwd_tile(n, spec.ho, spec.wo, f, s, 1, cib, 1, cob, True)
    got = narrow_forward(x, wt, b, res, spec.pads, s, "relu", True, blk)
    want = jax_conv(jnp.asarray(x), jnp.asarray(wt), s, "SAME",
                    jnp.asarray(b), "relu", precision=jprecision.BF16,
                    residual=jnp.asarray(res), gap=True)
    _ulp_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _jax_dw(x, dz, f, s, padding, lax):
    """dw of the reference's forward at ``x`` against the cotangent dz:
    ``jax.vjp`` of the jnp oracle under BF16 (its dw rounded to bf16), or
    of ``conv_lax`` on the blocked operands' f32 values (f32 dw)."""
    n, ciblk, h, w, cib = x.shape
    _, coblk, ho, wo, cob = dz.shape
    wt0 = jnp.zeros((coblk, ciblk, f, f, cib, cob), jnp.float32)
    if lax:
        def fwd(wt):
            hwio = wt.transpose(2, 3, 1, 4, 0, 5).reshape(
                f, f, ciblk * cib, coblk * cob)
            return conv_lax(jnp.asarray(_nhwc(x)), hwio, s, padding)
        _, vjp = jax.vjp(fwd, wt0)
        (dw,) = vjp(jnp.asarray(_nhwc(dz)))
    else:
        def fwd(wt):
            return jax_conv(jnp.asarray(x), wt, s, padding,
                            precision=jprecision.BF16).astype(jnp.float32)
        _, vjp = jax.vjp(fwd, wt0)
        (dw,) = vjp(jnp.asarray(dz))
    return np.asarray(dw, np.float32)


@pytest.mark.parametrize("n,ci,co,h,w,f,cib,cob,s,padding,act,oracle",
                         GEMM_CASES)
def test_narrow_wgrad_matches_the_reference(n, ci, co, h, w, f, cib, cob, s,
                                            padding, act, oracle):
    x, _, _ = _gemm_operands(4, n, ci, co, h, w, f, cib, cob)
    spec = ConvSpec.make(n, h, w, ci, co, f, f, s, padding)
    dz = _bf16(np.random.default_rng(5).normal(
        size=(n, co // cob, spec.ho, spec.wo, cob)))
    blk = _narrow_wgrad_tile(n, spec.ho, spec.wo, f, s, ci // cib, cib,
                             co // cob, cob)
    # the chooser's tile and one of odd width across row breaks, two shares
    small = dataclasses.replace(
        blk, th=2, tw=5, splits=2,
        tiles=n * -(-spec.ho // 2) * -(-spec.wo // 5),
        hwin=s + f, wwin=4 * s + f)
    for tile in (blk, small):
        got = narrow_wgrad(x, dz, tile, f, f, s, spec.pads)
        _max_close(got, _jax_dw(x, dz, f, s, padding, True), 1e-5)
        if oracle:
            # the oracle's VJP under BF16 leaves dw rounded to bf16: within
            # one bf16 ulp of each element (and 1e-5 of max|dw|)
            _ulp_close(got, _jax_dw(x, dz, f, s, padding, False))


def test_narrow_wgrad_walks_the_groups_across_ctas():
    # AlexNet's conv1 geometry (11 groups) on CTAs of 4 m-tiles: three m-tile
    # groups (4, 4, 3 groups of filter rows), a Co block past Cob 48 at 64
    # lanes; every (tap, c) row written once
    n, ci, co, h, f, s = 1, 3, 96, 27, 11, 4
    x, _, _ = _gemm_operands(6, n, ci, co, h, h, f, 3, 48)
    spec = ConvSpec.make(n, h, h, ci, co, f, f, s, "VALID")
    dz = _bf16(np.random.default_rng(7).normal(
        size=(n, 2, spec.ho, spec.wo, 48)))
    blk = blocking.WgradBlocking(
        th=2, tw=5, wgs=2, mpw=2, lanes=64, groups=3, splits=2,
        tiles=n * -(-spec.ho // 2) * -(-spec.wo // 5), hwin=s + f,
        wwin=4 * s + f, kstep=16, narrow=1)
    got = narrow_wgrad(x, dz, blk, f, f, s, spec.pads)
    _max_close(got, _jax_dw(x, dz, f, s, "VALID", True), 1e-5)


# ---------------------------------------------------------------------------
# element-strided TMA boxes: the bf16 wgrad's x at any width
# ---------------------------------------------------------------------------

def _strided_box(row, start, step, cells):
    """The cells a box lands that starts at column ``start`` (negative:
    before the map) and steps ``step`` columns: zeros outside the row."""
    out = np.zeros((cells,) + row.shape[1:], row.dtype)
    for k in range(cells):
        iw = start + step * k
        if 0 <= iw < len(row):
            out[k] = row[iw]
    return out


def _split_box(row, start, step, cells):
    """The old map's box: W split into (W / s, s), phase ``start % s`` from
    cell ``start // s`` (W a multiple of s)."""
    w = len(row)
    assert w % step == 0
    split = row.reshape(w // step, step, *row.shape[1:])
    gp = start % step
    c0 = (start - gp) // step
    out = np.zeros((cells,) + row.shape[1:], row.dtype)
    for k in range(cells):
        if 0 <= c0 + k < w // step:
            out[k] = split[c0 + k, gp]
    return out


@pytest.mark.parametrize("w,s", [(56, 2), (112, 2), (27, 4), (55, 2),
                                 (27, 2), (31, 2), (13, 3)])
def test_element_strided_boxes_land_the_phase_cells(w, s):
    rng = np.random.default_rng(w)
    row = rng.normal(size=(w, 4)).astype(np.float32)
    for start in (-3, -1, 0, 1, 2, 5, w - 7):
        for cells in (4, 9):
            got = _strided_box(row, start, s, cells)
            # the cells the kernel's tap reads: input column start + s k
            for k in range(cells):
                iw = start + s * k
                want = row[iw] if 0 <= iw < w else 0
                np.testing.assert_array_equal(got[k], want)
            if w % s == 0:          # the old split map's landing, the same
                np.testing.assert_array_equal(
                    got, _split_box(row, start, s, cells))
    # a box spans s * wph <= 256 elements at element stride <= 8: at
    # AlexNet's conv2 (27 wide, pads 1: start -1) and conv3 the chooser's
    # tiles take it
    for ho, hf, s_, ci in ((27, 5, 2, 48), (13, 3, 2, 64)):
        blk = blocking.choose_wgrad_blocking(8, ho, ho, hf, hf, s_, 1, ci, 1,
                                             64, op_bytes=2)
        wph = blocking.wgrad_bf16_wph(blk.tw, hf, s_)
        assert not blk.narrow and s_ * wph <= 256 and s_ <= 8


# ---------------------------------------------------------------------------
# choosers and plans
# ---------------------------------------------------------------------------

def _net_layers():
    """(name, n, ho, wo, f, s, cigblk, cib, coblk, cob, groups): VGG-16's
    13 convs and MobileNet v1's conv1 at batch 8, 224; AlexNet's five at
    batch 8, 227 (lane 64)."""
    out, h = [], 224
    for i, (ci, co, s) in enumerate(vgg16_layers()):
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        out.append((f"vgg16.{i}", 8, ho, ho, 3, s, ci // cib, cib,
                    co // cob, cob, 1))
        h = ho
    _, ci, co, s = mobilenet_v1_layers()[0]
    out.append(("mobilenet.conv1", 8, 112, 112, 3, s, 1, ci, 1, co, 1))
    model = alexnet_blocked(device="cpu",
                            generator=torch.Generator().manual_seed(0))
    h = 227
    for i, conv in enumerate(model.convs):
        spec = conv.spec(8, h, h)
        cib, cob = conv.in_pencil, conv.w.shape[5]
        out.append((f"alexnet.conv{i + 1}", 8, spec.ho, spec.wo, spec.hf,
                    spec.stride, spec.cig // cib, cib, spec.co // cob, cob,
                    spec.groups))
        h = spec.ho
    return out


def test_narrow_rows_take_the_first_layers_alone():
    taken = []
    for name, n, ho, wo, f, s, cigblk, cib, coblk, cob, groups in \
            _net_layers():
        fwd = blocking.choose_fwd_blocking(n, ho, wo, f, f, s, cigblk, cib,
                                           coblk, cob, op_bytes=2)
        wgr = blocking.choose_wgrad_blocking(n, ho, wo, f, f, s,
                                             cigblk * groups, cib, coblk,
                                             cob, op_bytes=2, groups=groups)
        assert fwd.narrow == wgr.narrow == int(
            blocking.narrow_fits(f, f, cib)), name
        if fwd.narrow:
            taken.append(name)
        else:
            # every other layer weighs no narrow tile
            assert not any(b.narrow for _, b in blocking.fwd_candidates(
                n, ho, wo, f, f, s, cigblk, cib, coblk, cob,
                blocking.H100_SXM, False, False, op_bytes=2))
            assert not blocking.fwd_candidates(
                n, ho, wo, f, f, s, cigblk, cib, coblk, cob,
                blocking.H100_SXM, False, False, op_bytes=2, narrow=True)
    assert taken == ["vgg16.0", "mobilenet.conv1", "alexnet.conv1"]


def test_the_per_tap_choice_is_unchanged_where_the_rows_fit():
    # the best per-tap tile at the first layers is the one the chooser took
    # before the narrow rows (tests/test_torch_bf16_fwd.py's pins of conv1_1
    # and MobileNet's conv1 as timed)
    for args, want in (((8, 224, 224, 3, 3, 1, 1, 3, 1, 64),
                        (7, 25, 3, 1, 16)),
                       ((8, 112, 112, 3, 3, 2, 1, 3, 1, 32),
                        (23, 7, 3, 1, 16))):
        found = blocking.fwd_candidates(*args, blocking.H100_SXM, False,
                                        False, op_bytes=2, narrow=False)
        b = min(found, key=lambda kb: kb[0])[1]
        assert (b.th, b.tw, b.wgs, b.nsplit, b.chunk) == want


def _reckoned_fwd_smem(blk, f, s, cib, gap):
    """The narrow forward's carve-up from its description: an atom, as
    many weight slots (the group's weights, r Lp rows padded to 16, and its
    A rows) as fit beside two raw buffers of the tile's input rows (16-byte
    pitch, the table), up to 4, then up to three raw buffers, each in whole
    1024 bytes; the mbarriers; the GAP's sums."""
    hwin, wwin = (blk.th - 1) * s + f, (blk.tw - 1) * s + f
    pitch = -(-(2 * cib * wwin + 32) // 16) * 16
    raw = hwin * pitch + -(-12 * hwin // 16) * 16
    window = -(-raw // 1024) * 1024
    kp = -(-blocking.narrow_rows_a_group(f, f, cib)
           * blocking.narrow_run_pad(f, cib) // 16) * 16
    row = -(-kp * blk.lanes * 2 // 1024) * 1024 + 64 * blk.wgs * 128
    bars = 8 * (4 * 7 + 2 * 4)
    red = 16 * blk.wgs * blk.lanes + 16 if gap else 0
    room = 232448 - 1024 - bars - red
    rows = min(4, (room - 2 * window) // row)
    windows = min(3, (room - rows * row) // window)
    return 1024 + windows * window + rows * row + bars + red


def _reckoned_wgrad_smem(blk, f, s, cib):
    """The narrow wgrad's: an atom, slots of the CTA's groups' rows and B
    (K rows of 128 bytes each), up to 4 beside two raw buffers (each
    rounded to 128 bytes), 256 bytes of tables."""
    span = blk.wgs * blk.mpw
    tpg = min(span, blocking.narrow_groups(f, f, cib))
    slot = (tpg + blk.lanes // 64) * blk.kpos * 128
    hwin, wwin = (blk.th - 1) * s + f, (blk.tw - 1) * s + f
    raw = 2 * -(-(hwin * -(-(2 * cib * wwin + 32) // 16) * 16
                  + -(-12 * hwin // 16) * 16) // 128) * 128
    slots = min(4, (232448 - 1024 - 256 - raw) // slot)
    assert slots >= 2
    return 1024 + slots * slot + raw + 256


# (name, n, ho, f, s, cib, coblk, cob, stated wgrad and forward issued
# multiples of the function's MACs)
FIRST_LAYERS = [
    ("alexnet.conv1", 8, 55, 11, 4, 3, 2, 48, 2.7, 2.0),
    ("vgg16.conv1_1", 8, 224, 3, 1, 3, 1, 64, 2.4, 1.3),
    ("mobilenet.conv1", 8, 112, 3, 2, 3, 1, 32, 4.7, 1.5),
]


@pytest.mark.parametrize("name,n,ho,f,s,cib,coblk,cob,wmul,fmul",
                         FIRST_LAYERS)
def test_plans_count_what_the_narrow_rows_issue(name, n, ho, f, s, cib,
                                                coblk, cob, wmul, fmul):
    args = (n, ho, ho, f, f, s, 1, cib, coblk, cob)
    wb = blocking.choose_wgrad_blocking(*args, op_bytes=2)
    wp = blocking.wgrad_plan(wb, *args, False)
    ng = blocking.narrow_groups(f, f, cib)
    assert wp.issued_macs == coblk * wb.tiles * wb.kpos * ng * 64 * wb.lanes
    assert wp.smem == _reckoned_wgrad_smem(wb, f, s, cib)
    # the per-tap tile's 121, 9 and 9 m-tiles a layer, now 11, 1 and 1
    old = blocking.wgrad_plan(dataclasses.replace(wb, narrow=0), *args,
                              False)
    assert old.issued_macs // wp.issued_macs == f * f // ng
    assert wp.issued_macs / wp.function_macs == pytest.approx(wmul, rel=0.1)
    for gap in (False, True):
        fb = blocking.choose_fwd_blocking(*args, gap=gap, op_bytes=2)
        fp = blocking.fwd_plan(fb, *args, gap, 2)
        kp = blocking.narrow_kpad(f, f, cib)
        assert fp.issued_macs == (n * fb.tiles * coblk * fb.nsplit * 64
                                  * fb.wgs * fb.lanes * ng * kp)
        assert fp.smem == _reckoned_fwd_smem(fb, f, s, cib, gap)
        assert fb.pitch == fb.tw and fb.strips == 1 and fb.lanes >= 16
        assert fp.issued_macs / fp.function_macs < 1.6 * fmul
    # the narrow rows issue less than the per-tap tiles did, at every layer
    per_tap = min(blocking.fwd_candidates(
        *args, blocking.H100_SXM, False, False, op_bytes=2, narrow=False),
        key=lambda kb: kb[0])[1]
    assert blocking.fwd_plan(per_tap, *args, False, 2).issued_macs > \
        blocking.fwd_plan(blocking.choose_fwd_blocking(*args, op_bytes=2),
                          *args, False, 2).issued_macs


def test_narrow_rows_refuse_what_they_cannot_take():
    # dilation, a 1x1 filter, a run past 64 values, a streamed route: no
    # narrow tile; Cob not a multiple of 8 (no TMA box of the weights or dz)
    assert not blocking.narrow_fits(3, 3, 3, (2, 2))
    assert not blocking.narrow_fits(1, 1, 3)
    assert not blocking.narrow_fits(3, 3, 24)
    assert blocking.narrow_fits(3, 3, 21) and blocking.narrow_fits(11, 11, 3)
    for streamed in (False, True):
        found = blocking.fwd_candidates(8, 56, 56, 3, 3, 1, 1, 3, 1, 12,
                                        blocking.H100_SXM, False, streamed,
                                        op_bytes=2)
        assert found and not any(b.narrow for _, b in found)
    found = blocking.fwd_candidates(8, 56, 56, 3, 3, 1, 1, 3, 1, 64,
                                    blocking.H100_SXM, False, True,
                                    op_bytes=2)
    assert not any(b.narrow for _, b in found)
    assert not blocking.choose_stream_wgrad_blocking(
        8, 56, 56, 3, 3, 1, 1, 3, 1, 64, op_bytes=2).narrow
    assert not blocking.choose_wgrad_blocking(
        8, 56, 56, 3, 3, 1, 1, 3, 1, 12, op_bytes=2).narrow


@pytest.mark.parametrize("f,cib,stride", [(5, 8, 1), (3, 16, 1), (3, 21, 2),
                                          (7, 9, 2), (3, 3, 1), (11, 3, 4)])
def test_narrow_rows_wait_to_be_asked_past_the_timed_widths(f, cib, stride):
    # unasked, the forward takes the rows at Cib 3 and 8 and the wgrad at
    # Cib 3 alone, the widths at which they were timed faster than the
    # per-tap tiles; asked, both take them wherever they fit
    assert blocking.narrow_fits(f, f, cib)
    fwd_takes = cib in blocking.NARROW_FWD_CIBS
    wgrad_takes = cib in blocking.NARROW_WGRAD_CIBS
    assert blocking.narrow_chosen(f, f, cib, widths=blocking.NARROW_FWD_CIBS
                                  ) == fwd_takes
    assert blocking.narrow_chosen(f, f, cib) == wgrad_takes
    assert blocking.narrow_chosen(f, f, cib, narrow=True)
    assert not blocking.narrow_chosen(f, f, cib, narrow=False,
                                      widths=(cib,))
    ho = -(-(24 if f < 11 else 63) // stride)
    args = (8, ho, ho, f, f, stride, 1, cib, 1, 64)
    assert blocking.choose_fwd_blocking(*args, op_bytes=2).narrow == \
        fwd_takes
    assert blocking.choose_wgrad_blocking(*args, op_bytes=2).narrow == \
        wgrad_takes
    asked = blocking.fwd_candidates(*args, blocking.H100_SXM, False, False,
                                    op_bytes=2, narrow=True)
    assert asked and all(b.narrow for _, b in asked)
    asked = blocking.wgrad_candidates(*args, blocking.H100_SXM, True, False,
                                      op_bytes=2, narrow=True)
    assert asked and all(b.narrow for _, b in asked)
