"""The bf16 build of the pointwise forward tile (``csrc/conv2d_pointwise.cu``,
``pointwise_tile_kernel_bf16``, namespace ``pwbf16``) on the CPU.

The kernel's arithmetic written out in numpy item by item, as it runs: the
persistent grid's items (row item fastest, then output block x lane split)
over the flattened (image, position) rows, so an item's rows may span
images and only the batch's last m-tile is ragged; each stage's x rows
landed in the slot box by box as the producer issues them (``brows`` rows
of one image a box, at the row's place after ``front`` spare rows; rows no
box lands stay NaN, so a row read from them shows), a chunk of 128 as two
64-channel halves; the weights in the MN-major order their TMA box lands;
every k16 slice's bf16 products added to the one f32 accumulator rounded
toward zero, stages in (input block, chunk) order; an m-tile past the last
row issuing nothing; the epilogue (+ f32 bias, activation, + r in f32)
rounded once to bf16 on each row below N x H*W, each stored once; and the
GAP of the stored values: per item and image a thread's two rows, a warp's
shfl_xor tree, the warps in order, into the image's slot (its place among
the items that touch it), unused slots 0, the slots summed in order times
the f32 reciprocal of H*W (``conv2d_common.gap_finalize`` of the
partials).  Held against the reference's ``pointwise_conv2d_blocked_pallas
(precision="bf16", interpret=True)``: every element within one bf16 ulp of
its magnitude plus 1e-5 of max|y| (both round f32 sums of the same bf16
products, in other orders, once to bf16).

Also: the box walk at many maps (every row landed once an item, no box past
its image, on whole 128-byte lines where the kernel takes TMA), the plan
model against the tiles, and the chooser at MobileNet's legs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.conv2d_pointwise import (  # noqa: E402
    pointwise_conv2d_blocked_pallas)
from repro_torch.configs.cnn import (MOBILENET_V1_BLOCKS,  # noqa: E402
                                     MOBILENET_V1_CONV1)
from repro_torch.core import blocking, conv2d_common  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.kernels import conv2d_pointwise as pwk  # noqa: E402

BF16_FWD_REL = 1e-5
SMEM_BLOCK = 232448


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32: the tensor cores' addition of
    a k16 slice's sum into an f32 accumulator."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mn_major(b):
    """B [K, N] as the TMA box lands it, [N / nin][K][nin] (nin = min(N, 64)
    lanes a row), read back as the descriptor reads it MN-major."""
    k, n = b.shape
    nin = min(n, 64)
    flat = b.reshape(k, n // nin, nin).transpose(1, 0, 2).reshape(-1)
    return flat.reshape(n // nin, k, nin).transpose(1, 0, 2).reshape(k, n)


def _act(v, act):
    if act == "relu":
        return np.maximum(v, np.float32(0))
    if act == "gelu":
        v64 = v.astype(np.float64)
        k = np.sqrt(2 / np.pi)
        return (0.5 * v64 * (1 + np.tanh(k * (v64 + 0.044715 * v64 ** 3)))
                ).astype(np.float32)
    return v


def _front(blk):
    line = 128 // (2 * min(blk.chunk, 64))
    return -(-blk.brows // line) * line


def _boxes(hw, total, f0, rows, brows):
    """``pwbf16::for_boxes``: the (image, first row) of each box that lands
    item rows [f0, min(f0 + rows, total))."""
    f1 = min(f0 + rows, total)
    out = []
    k = f0 // hw
    while k * hw < f1:
        a, b = max(f0 - k * hw, 0), min(f1 - k * hw, hw)
        nb = -(-(b - a) // brows) if b - a > brows else 1
        for j in range(nb):
            if j < nb - 1:
                q = a + j * brows
            elif b - a >= brows:
                q = b - brows
            else:
                q = min(a, hw - brows)
            out.append((k, q))
        k += 1
    return out


def _walk(x, wt, b, r, act, gap, blk):
    """The bf16 forward as the kernel computes and stores it (module
    docstring) -> (the stored map as bf16, with ``gap`` the partials [N,
    Co/Cob, slots, Cob] f32 and the pooled features as bf16)."""
    x, wt = _bf16(x), _bf16(wt)
    r = None if r is None else _bf16(r)
    n, kblk, h, wd, kw = x.shape
    oblk, _, _, _, _, ow = wt.shape
    hw, total = h * wd, n * h * wd
    rows, lanes, chunk = blk.rows, blk.lanes, blk.chunk
    kpad = -(-kw // 16) * 16
    front = _front(blk)
    slot_rows = front + rows + blk.brows
    # x's flattened rows of each input block, channels padded with zeros
    xf = np.zeros((kblk, total, kpad), np.float32)
    xf[..., :kw] = x.transpose(1, 0, 2, 3, 4).reshape(kblk, total, kw)
    ritems = -(-total // rows)
    cols = oblk * blk.nsplit
    slots = blocking.pointwise_bf16_gap_slots(n, hw, rows)
    assert slots == blk.tiles
    out = np.full((n, oblk, hw, ow), np.nan, np.float32)
    parts = np.full((n, oblk, slots, ow), np.nan, np.float32)
    for i in range(ritems * cols):             # the persistent walk's order
        ri, col = i % ritems, i // ritems
        o_b, split = divmod(col, blk.nsplit)
        f0 = ri * rows
        o0 = split * lanes
        vn = max(0, min(lanes, ow - o0))
        acc = np.zeros((rows, lanes), np.float32)
        for kb in range(kblk):
            for c0 in range(0, kpad, chunk):
                # the stage's slot as its boxes land it
                slot = np.full((slot_rows, chunk), np.nan, np.float32)
                for k, q in _boxes(hw, total, f0, rows, blk.brows):
                    assert 0 <= q and q + blk.brows <= hw
                    at = front + k * hw + q - f0
                    assert 0 <= at and at + blk.brows <= slot_rows
                    src = xf[kb, k * hw + q:k * hw + q + blk.brows,
                             c0:c0 + chunk]
                    slot[at:at + blk.brows] = src
                bm = np.zeros((chunk, lanes), np.float32)
                vk = max(0, min(chunk, kw - c0))
                bm[:vk, :vn] = wt[o_b, kb, 0, 0, c0:c0 + vk, o0:o0 + vn]
                bm = _mn_major(bm)
                for c in range(blk.wgs):
                    if f0 + 64 * c >= total:       # issues nothing
                        continue
                    am = slot[front + 64 * c:front + 64 * c + 64]
                    for k16 in range(0, chunk, 16):
                        sl = slice(k16, k16 + 16)
                        acc[64 * c:64 * c + 64] = _add_rz(
                            acc[64 * c:64 * c + 64],
                            am[:, sl].astype(np.float64)
                            @ bm[sl].astype(np.float64))
        f = f0 + np.arange(rows)
        ok = f < total
        img, pos = f[ok] // hw, f[ok] % hw
        v = _act(acc[ok, :vn] + b[o_b, o0:o0 + vn].astype(np.float32), act)
        if r is not None:
            v = v + r.reshape(n, oblk, hw, ow)[img, o_b, pos, o0:o0 + vn]
        v = _bf16(v)
        assert np.isnan(out[img, o_b, pos, o0:o0 + vn]).all()   # once
        out[img, o_b, pos, o0:o0 + vn] = v
        if gap:
            stored = np.zeros((rows, lanes), np.float32)
            stored[ok, :vn] = v
            rimg = np.where(ok, f // hw, -1)
            for k in range(f0 // hw, (f[ok][-1]) // hw + 1):
                red = []
                for wid in range(4 * blk.wgs):
                    t = []
                    for g in range(8):
                        pair = [stored[16 * wid + g + 8 * hh]
                                if rimg[16 * wid + g + 8 * hh] == k
                                else np.zeros(lanes, np.float32)
                                for hh in range(2)]
                        t.append(pair[0] + pair[1])
                    for m in (1, 2, 4):          # shfl_xor 4, 8, 16 lanes
                        t = [t[g] + t[g ^ m] for g in range(8)]
                    red.append(t[0])
                s = np.zeros(lanes, np.float32)
                for part in red:
                    s = s + part
                first = k * hw // rows
                count = ((k + 1) * hw - 1) // rows - first + 1
                parts[k, o_b, ri - first, o0:o0 + vn] = s[:vn]
                if ri - first == count - 1:
                    parts[k, o_b, count:, o0:o0 + vn] = 0
    assert not np.isnan(out).any()
    stored_map = torch.from_numpy(out.reshape(n, oblk, h, wd, ow)).bfloat16()
    if not gap:
        return stored_map, None, None
    assert not np.isnan(parts).any()
    parts = torch.from_numpy(parts)
    pooled = conv2d_common.gap_finalize(parts, hw).bfloat16()
    return stored_map, parts, pooled


def _bf16_close(got, want, what=""):
    """Every element within one bf16 ulp of its magnitude, plus
    ``BF16_FWD_REL`` of max|want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    bound = ulp + BF16_FWD_REL * np.abs(w).max()
    worst = (np.abs(g - w) / bound).max()
    assert worst <= 1.0, (what, worst)


def _operands(seed, n, ci, co, h, w, cib, cob, residual):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 1, 1, cib, cob))
          / np.sqrt(ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    r = (rng.normal(size=(n, co // cob, h, w, cob)).astype(np.float32)
         if residual else None)
    return x, wt, b, r


def _pallas(x, wt, b, r, act, gap):
    j = (lambda a: None if a is None else jnp.asarray(a))
    y = pointwise_conv2d_blocked_pallas(
        j(x), j(wt), j(b), activation=act, interpret=True, residual=j(r),
        gap=gap, precision="bf16")
    return np.asarray(y.astype(jnp.float32))


# (n, ci, co, h, w, cib, cob, act, residual, gap, changes): the chooser's
# tiles, and others it may take (more consumers, a chunk of 128 as two
# halves, a lane split, boxes shorter than an image's run)
WALK_CASES = [
    (4, 16, 16, 7, 7, 16, 16, "relu", True, True, {}),
    (3, 32, 24, 7, 7, 32, 24, "gelu", False, True, {"wgs": 3}),
    (5, 128, 16, 5, 5, 128, 16, None, True, True, {"chunk": 128}),
    (2, 64, 80, 6, 6, 64, 80, "relu", False, True, {"nsplit": 2}),
    (3, 48, 16, 9, 9, 16, 16, "relu", True, False, {"wgs": 2, "brows": 8}),
    (2, 12, 12, 9, 10, 4, 6, "gelu", True, True, {}),   # the copies path
]


def _blk(n, hw, kblk, kw, oblk, ow, gap, changes):
    blk = blocking.choose_pointwise_blocking(n, hw, kblk, kw, oblk, ow,
                                             gap=gap, op_bytes=2)
    if "wgs" in changes:
        changes = dict(changes, rows=64 * changes["wgs"])
    if "nsplit" in changes:
        changes = dict(changes, lanes=blocking.dgrad_lanes(
            -(-ow // changes["nsplit"])))
    blk = dataclasses.replace(blk, **changes)
    return dataclasses.replace(
        blk, tiles=blocking.pointwise_bf16_gap_slots(n, hw, blk.rows),
        brows=changes.get("brows",
                          blocking.pointwise_bf16_brows(hw, blk.chunk)))


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,act,res,gap,changes",
                         WALK_CASES)
def test_walk_matches_pallas_interpret(n, ci, co, h, w, cib, cob, act, res,
                                       gap, changes):
    x, wt, b, r = _operands(0, n, ci, co, h, w, cib, cob, res)
    blk = _blk(n, h * w, ci // cib, cib, co // cob, cob, gap, changes)
    assert blocking.pointwise_smem_bytes(
        blk.rows, blk.chunk, blk.lanes, blk.wgs, gap, 2, ring=blk.ring,
        brows=blk.brows) <= SMEM_BLOCK
    stored, parts, pooled = _walk(x, wt, b, r, act, gap, blk)
    want = _pallas(x, wt, b, r, act, False)
    _bf16_close(stored.float().numpy(), want, "map")
    if gap:
        _bf16_close(pooled.float().numpy(), _pallas(x, wt, b, r, act, True),
                    "pooled")
        assert tuple(parts.shape) == (n, co // cob, blk.tiles, cob)


def test_items_span_images_and_pad_only_the_last_mtile():
    # 7x7 at batch 8: 392 rows, 448 issued (not 8 x 64 = 512)
    blk = blocking.PointwiseBlocking(rows=192, wgs=3, lanes=128, nsplit=1,
                                     chunk=64, tiles=0, ring=2, brows=32)
    assert blocking.pointwise_issued_macs(blk, 8, 1, 64, 1, 2, 49) == \
        448 * 128 * 64
    f0 = 192
    images = {k for k, _ in _boxes(49, 392, f0, 192, 32)}
    assert images == {3, 4, 5, 6, 7}          # rows 192..383 of 392


@pytest.mark.parametrize("hw,n,rows,chunk", [
    (49, 8, 192, 64), (49, 8, 64, 128), (196, 8, 128, 64), (25, 8, 64, 128),
    (784, 3, 192, 64), (1, 70, 64, 64), (50, 5, 128, 32), (100, 4, 192, 16),
    (12544, 1, 192, 32)])
def test_boxes_land_every_row_of_an_item_once(hw, n, rows, chunk):
    brows = blocking.pointwise_bf16_brows(hw, chunk)
    blk = blocking.PointwiseBlocking(rows=rows, wgs=rows // 64, lanes=64,
                                     nsplit=1, chunk=chunk, tiles=0, ring=2,
                                     brows=brows)
    front = _front(blk)
    line = 128 // (2 * min(chunk, 64))
    tma = blocking.pointwise_bf16_tma(hw, 64, 64, chunk, 64, brows)
    total = n * hw
    for f0 in range(0, total, rows):
        landed = {}
        for k, q in _boxes(hw, total, f0, rows, brows):
            assert 0 <= q and q + brows <= hw or not tma
            at = front + k * hw + q - f0
            if tma:
                assert at % line == 0          # a whole 128-byte line
                assert 0 <= at and at + brows <= front + rows + brows
            for j in range(brows):
                # a cell two boxes land holds the same row of the same image
                assert landed.setdefault(at + j, (k, q + j)) == (k, q + j)
        for f in range(f0, min(f0 + rows, total)):
            assert landed.get(front + f - f0) == (f // hw, f % hw)


def test_plan_model_counts_the_items_and_their_mtiles():
    n, hw, kblk, kw, oblk, ow = 8, 49, 8, 128, 8, 128
    blk = blocking.choose_pointwise_blocking(n, hw, kblk, kw, oblk, ow,
                                             gap=True, op_bytes=2)
    plan = blocking.pointwise_plan(blk, n, hw, kblk, kw, oblk, ow, True)
    assert plan.items == -(-n * hw // blk.rows) * oblk * blk.nsplit
    assert plan.function_macs == n * hw * kblk * kw * oblk * ow
    assert plan.issued_macs == blocking.pointwise_issued_macs(
        blk, n, kblk, kw, oblk, 2, hw)
    assert plan.slots == blk.tiles == blocking.pointwise_bf16_gap_slots(
        n, hw, blk.rows)
    assert plan.ring == blk.ring and 2 <= blk.ring <= 4
    ints = blocking.pointwise_plan_ints(blk, n, hw, kblk, kw, oblk, ow, 1,
                                        True)
    assert ints[-1] == plan.smem and ints[-2] == blk.lanes
    assert len(ints) == 16


def _mobilenet_legs(entry):
    h = ConvSpec.make(1, entry, entry, *MOBILENET_V1_CONV1[:2], 3, 3,
                      MOBILENET_V1_CONV1[2], "SAME").ho
    out = []
    for ci, co, s in MOBILENET_V1_BLOCKS:
        h = -(-h // s)
        out.append((ci, co, h))
    return out


@pytest.mark.parametrize("entry", [160, 224])
@pytest.mark.parametrize("n", [8, 32])
def test_chooser_fits_a_cta_and_takes_tma_at_every_mobilenet_leg(entry, n):
    for ci, co, h in _mobilenet_legs(entry):
        cib, cob = min(ci, 128), min(co, 128)
        for gap in (False, (ci, co) == (1024, 1024)):
            blk = blocking.choose_pointwise_blocking(
                n, h * h, ci // cib, cib, co // cob, cob, gap=gap,
                op_bytes=2)
            assert blocking.pointwise_smem_bytes(
                blk.rows, blk.chunk, blk.lanes, blk.wgs, gap, 2,
                ring=blk.ring, brows=blk.brows) <= SMEM_BLOCK
            assert blocking.pointwise_bf16_tma(h * h, cib, cob, blk.chunk,
                                               blk.lanes, blk.brows)
            assert 2 <= blk.ring <= 4 and blk.chunk in (16, 32, 64, 128)
            # two consumers at most at 128 lanes with GAP (the launch bound)
            assert not (gap and blk.lanes == 128 and blk.wgs > 2)


@pytest.mark.parametrize("n", [8, 32])
def test_chooser_issues_at_most_115_of_the_macs_at_224(n):
    for ci, co, h in _mobilenet_legs(224):
        cib, cob = min(ci, 128), min(co, 128)
        blk = blocking.choose_pointwise_blocking(
            n, h * h, ci // cib, cib, co // cob, cob, op_bytes=2)
        issued = blocking.pointwise_issued_macs(blk, n, ci // cib, cib,
                                                co // cob, 2, h * h)
        assert issued <= 1.15 * n * h * h * ci * co, (ci, co, h)


def test_cpu_wrapper_plan_ints_follow_the_chooser():
    plan = pwk._tile_plan(8, 49, 8, 128, 8, 128, 1, True, op_bytes=2)
    blk = plan.blk
    assert tuple(plan.ints) == blocking.pointwise_plan_ints(
        blk, 8, 49, 8, 128, 8, 128, 1, True)
