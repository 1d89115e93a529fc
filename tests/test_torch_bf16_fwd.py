"""The bf16 build of the dense forward tile (``csrc/fwd_tile.cuh``,
namespace ``bf16``) on the CPU, and the dense main path served in bf16.

The kernels' arithmetic written out in numpy item by item, as the window
forward (``fwd_kernel_bf16``) and the streamed one
(``stream_fwd_kernel_bf16``) run it: the persistent grid's items (tile,
output block x lane split, image) in their walk's order, each output stored
once; x, w and the residual rounded to bf16 once; each stage's window staged
as the slot holds it (``s x s`` phase planes of ``pitch`` cells a row, zero
outside the map and past the pencil, Cib padded to 16), each consumer's 64
m-tile rows consecutive cells, tap (dh, dw) read from plane (dh % s, dw % s)
at (dh // s) * pitch + dw // s cells on; the weights of each filter row in
the MN-major order their TMA box lands (rows of up to 64 lanes); every k16
slice's bf16 products added to the one f32 accumulator rounded toward zero,
in the order stages, filter rows, taps, slices; the epilogue (+ f32 bias,
activation, + r in f32) rounded once to bf16 on the rows whose cell lies in
the tile; and the GAP of the stored bf16 values in the tile's order
(``conv2d_common.gap_replay``).  Held against the reference's jnp oracle
under ``BF16`` (``direct_conv_blocked(precision=BF16)``) and its streamed
Pallas kernel in interpret mode: every element within one bf16 ulp of its
magnitude plus 1e-5 of max|y| (the two round f32 sums of the same bf16
products, taken in other orders, once to bf16).

Also: the one accumulator's drift at VGG-16's longest contraction, the GAP
replay on the flattened rows, the precision policy's fields against the
reference's, the bf16 choosers at every VGG-16 and MobileNet ``conv1`` shape
(they fit one CTA by the kernels' rules, and ``fwd_smem_bytes`` reckons the
layout), the wrappers' bf16 routes and refusals, and a narrow VGG-16 served
in bf16 by ``ConvServer`` against the JAX model under ``BF16``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import precision as jprecision  # noqa: E402
from repro.core.context import ConvContext as JContext  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked_pallas)
from repro.nn import conv as jconv  # noqa: E402
from repro_torch.configs.cnn import (mobilenet_v1_layers,  # noqa: E402
                                     vgg16_blocked, vgg16_layers)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import blocking, conv2d_common, precision  # noqa: E402
from repro_torch.core.context import ConvContext  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.dispatch import route_stream  # noqa: E402
from repro_torch.kernels import conv2d_stream as stk  # noqa: E402
from repro_torch.kernels.direct_conv2d import (LAUNCHES,  # noqa: E402
                                               build_dtype,
                                               direct_conv2d_blocked)
from repro_torch.launch.conv_serve import ConvServer  # noqa: E402
from repro_torch.serve.scheduler import ConvRequest, Outcome  # noqa: E402


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
    """B [K, N] as the TMA box lands a tap, [N / nin][K][nin] (nin = min(N,
    64) lanes a row, as they lie in w), read back as the wgmma descriptor
    reads it MN-major: rows of nin lanes, a k16 step 16 rows, the nin-lane
    blocks K rows apart."""
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


def _mtile_rows(blk, streamed):
    """The window cells of the consumers' m-tile rows, consumer by consumer
    (``fwd_tile::bf16::first_row``), and each row's index in its m-tile."""
    first = [k * blk.hso * blk.pitch if streamed else 64 * k
             for k in range(blk.wgs)]
    f = np.concatenate([s + np.arange(64) for s in first])
    return f, np.tile(np.arange(64), blk.wgs)


def _tile_forward(x, wt, b, r, pads, stride, act, gap, blk, streamed,
                  f32=False):
    """The bf16 forward as the kernels compute and store it (module
    docstring; a narrow-row tile as ``test_torch_narrow_runs`` emulates
    ``fwd_kernel_bf16_narrow``) -> the stored map, or with ``gap`` the
    pooled features, as bf16 torch tensors; with ``f32`` the f32 sums
    before the epilogue, as an f32 numpy map."""
    if blk.narrow:
        from test_torch_narrow_runs import narrow_forward
        assert not streamed
        return narrow_forward(x, wt, b, r, pads, stride, act, gap, blk, f32)
    x, wt = _bf16(x), _bf16(wt)
    r = None if r is None else _bf16(r)
    n, ciblk, hi, wi, cib = x.shape
    coblk, _, hf, wf, _, cob = wt.shape
    (pt, _), (pl, _) = pads
    s = stride
    ho = (hi + sum(pads[0]) - hf) // s + 1
    wo = (wi + sum(pads[1]) - wf) // s + 1
    kpad = -(-cib // 16) * 16
    lanes, chunk, pitch = blk.lanes, blk.chunk, blk.pitch
    assert pitch == blocking.fwd_bf16_pitch(blk.tw, wf, s, chunk, streamed)
    lay = blocking.fwd_bf16_layout(blk.th, blk.tw, hf, wf, s, chunk, lanes,
                                   blk.wgs, blk.strips, gap)
    assert lay.windows >= 2 and lay.rows >= 2
    mh = -(-hf // s)
    prows = blk.th + mh - 1
    cells = lay.window_bytes // (2 * chunk)
    across = -(-wo // blk.tw)
    tiles = -(-ho // blk.th) * across
    assert tiles == blk.tiles
    cols = coblk * blk.nsplit
    f, q = _mtile_rows(blk, streamed)
    a, c = f // pitch, f % pitch
    stored = (c < blk.tw) & (a < blk.th)
    if streamed:                      # a strip's rows past its plane rows
        stored &= q < blk.hso * pitch
    out = np.full((n, coblk, ho, wo, cob), np.nan, np.float32)
    xp = np.zeros((n, ciblk, hi + 2 * s * prows, wi + 2 * s * pitch, kpad),
                  np.float32)          # x inside a frame of zeros
    oy, ox = s * prows, s * pitch
    xp[:, :, oy:oy + hi, ox:ox + wi, :cib] = x
    for i in range(tiles * cols * n):          # the persistent walk's order
        tile, col, img = i % tiles, i // tiles % cols, i // tiles // cols
        o_b, split = divmod(col, blk.nsplit)
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        h0, w0 = oh0 * s - pt, ow0 * s - pl
        o0 = split * lanes
        vn = max(0, min(lanes, cob - o0))
        keep = stored & (oh0 + a < ho) & (ow0 + c < wo)
        acc = np.zeros((len(f), lanes), np.float32)
        for i_b in range(ciblk):
            for c0 in range(0, kpad, chunk):
                # the stage's window slot: plane (ph, pw) row pr, column pc
                # is input (h0 + ph + s pr, w0 + pw + s pc); spare cells 0
                win = np.zeros((cells, chunk), np.float32)
                for p in range(s * s):
                    ph, pw = divmod(p, s)
                    rows = oy + h0 + ph + s * np.arange(prows)
                    cs = ox + w0 + pw + s * np.arange(pitch)
                    plane = xp[img, i_b][rows][:, cs, c0:c0 + chunk]
                    at = p * lay.plane_cells
                    win[at:at + prows * pitch] = plane.reshape(-1, chunk)
                vk = max(0, min(chunk, cib - c0))
                for dh in range(hf):            # a filter row a wgmma group
                    for dw in range(wf):
                        p = (dh % s) * s + dw % s
                        shift = (p * lay.plane_cells + dh // s * pitch
                                 + dw // s)
                        am = win[f + shift]
                        bm = np.zeros((chunk, lanes), np.float32)
                        bm[:vk, :vn] = wt[o_b, i_b, dh, dw, c0:c0 + vk,
                                          o0:o0 + vn]
                        bm = _mn_major(bm)
                        for k in range(0, chunk, 16):
                            sl = slice(k, k + 16)
                            acc = _add_rz(acc, am[:, sl].astype(np.float64)
                                          @ bm[sl].astype(np.float64))
        oh, ow = oh0 + a[keep], ow0 + c[keep]
        if f32:
            v = acc[keep, :vn]
        else:
            v = _act(acc[keep, :vn] + b[o_b, o0:o0 + vn].astype(np.float32),
                     act)
            if r is not None:
                v = v + r[img, o_b, oh, ow, o0:o0 + vn]
        assert np.isnan(out[img, o_b, oh, ow, o0:o0 + vn]).all()  # once
        out[img, o_b, oh, ow, o0:o0 + vn] = v
    assert not np.isnan(out).any()
    if f32:
        return out
    stored_map = torch.from_numpy(out).bfloat16()
    return conv2d_common.gap_replay(stored_map, blk) if gap else stored_map


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


def _reshaped(blk, spec, streamed, **changes):
    """``blk`` with ``changes`` (th, tw, chunk, wgs, ...), its tiles, window
    and pitch made to agree."""
    blk = dataclasses.replace(blk, **changes)
    if streamed:
        blk = dataclasses.replace(blk, strips=blk.wgs)
    s = spec.stride
    return dataclasses.replace(
        blk, tiles=-(-spec.ho // blk.th) * -(-spec.wo // blk.tw),
        hwin=(blk.th - 1) * s + 3, wwin=(blk.tw - 1) * s + 3,
        pitch=blk.tw if blk.narrow else blocking.fwd_bf16_pitch(
            blk.tw, 3, s, blk.chunk, streamed))


def _tiles(n, spec, cib, cob, gap, streamed):
    """The bf16 chooser's tile, then a small one that overhangs the map at
    chunk 16 (the streamed band: strips of one row), then one of three
    consumers with its rows past the map; where the chooser takes the
    narrow rows, the same three of the best per-tap tile too."""
    args = (n, spec.ho, spec.wo, 3, 3, spec.stride, spec.ci // cib, cib,
            spec.co // cob, cob)
    chosen = (blocking.choose_stream_fwd_blocking(*args, gap=gap,
                                                  op_bytes=2)
              if streamed else blocking.choose_fwd_blocking(*args, gap=gap,
                                                            op_bytes=2))
    picks = [chosen]
    if chosen.narrow:
        picks.append(min(blocking.fwd_candidates(
            *args, blocking.H100_SXM, gap, streamed, op_bytes=2,
            narrow=False), key=lambda kb: kb[0])[1])
    out = []
    for pick in picks:
        small = _reshaped(pick, spec, streamed, th=pick.strips if streamed
                          else 2, tw=3, chunk=16)
        three = _reshaped(pick, spec, streamed, wgs=3,
                          th=3 if streamed else 5, tw=5, chunk=16)
        out += [pick, small, three]
    return out


def _bf16_close(got, want):
    """Every element within one bf16 ulp of its magnitude, plus 1e-5 of
    max|want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    bound = ulp + 1e-5 * np.abs(w).max()
    assert (np.abs(g - w) <= bound).all(), float((np.abs(g - w) / bound)
                                                 .max())


def _jax_bf16(x, wt, b, r, stride, padding, act, gap):
    out = jax_conv(jnp.asarray(x), jnp.asarray(wt), stride, padding,
                   jnp.asarray(b), act, precision=jprecision.BF16,
                   residual=None if r is None else jnp.asarray(r), gap=gap)
    return np.asarray(out.astype(jnp.float32))


# (n, ci, co, h, w, cib, cob, stride, padding, activation, residual, gap)
CASES = [
    (2, 16, 16, 8, 8, 16, 16, 1, "SAME", "relu", False, False),
    (2, 16, 16, 8, 8, 16, 16, 2, "SAME", "gelu", True, True),  # pads (0, 1)
    (2, 8, 8, 9, 7, 8, 8, 2, "VALID", None, False, False),
    (1, 16, 8, 7, 9, 8, 8, 1, ((2, 0), (0, 1)), "relu", True, False),
    (2, 3, 16, 11, 10, 3, 16, 2, "SAME", "relu", True, True),   # Cib = 3
    (2, 32, 12, 9, 9, 32, 12, 1, "SAME", "gelu", False, True),  # Cob 12
    (1, 48, 24, 6, 6, 24, 24, 1, "SAME", "relu", True, True),   # Cib 24
    (1, 6, 20, 7, 8, 6, 10, 1, "VALID", "gelu", False, True),   # Cib 6
    (1, 64, 64, 10, 10, 64, 64, 2, ((1, 0), (0, 1)), None, True, False),
]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act,res,gap",
                         CASES)
def test_bf16_tile_arithmetic_matches_the_jnp_oracle(streamed, n, ci, co, h,
                                                     w, cib, cob, stride,
                                                     padding, act, res, gap):
    x, wt, b, r, spec = _operands(0, n, ci, co, h, w, cib, cob, stride,
                                  padding, res)
    want = _jax_bf16(x, wt, b, r, stride, padding, act, gap)
    for blk in _tiles(n, spec, cib, cob, gap, streamed):
        got = _tile_forward(x, wt, b, r, spec.pads, stride, act, gap, blk,
                            streamed)
        assert got.dtype == torch.bfloat16
        _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act,res,gap",
                         [CASES[i] for i in (0, 1, 4, 6)])
def test_bf16_strip_walk_matches_pallas_stream_interpret(n, ci, co, h, w,
                                                         cib, cob, stride,
                                                         padding, act, res,
                                                         gap):
    # the reference's streamed kernel under BF16 in interpret mode
    x, wt, b, r, spec = _operands(2, n, ci, co, h, w, cib, cob, stride,
                                  padding, res)
    want = np.asarray(direct_conv2d_blocked_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=stride,
        padding=padding, activation=act, stream=True, interpret=True,
        precision=jprecision.BF16,
        residual=None if r is None else jnp.asarray(r), gap=gap)
        .astype(jnp.float32))
    for blk in _tiles(n, spec, cib, cob, gap, True):
        got = _tile_forward(x, wt, b, r, spec.pads, stride, act, gap, blk,
                            True)
        _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_window_and_strip_walks_agree_bit_for_bit_at_one_chunk(stride):
    # one K order for every output (stages, filter rows, taps, k16 slices):
    # where both take the same chunk the two walks store the same bits,
    # whatever the tiles
    x, wt, b, _, spec = _operands(3, 2, 32, 16, 10, 10, 32, 16, stride,
                                  "SAME", False)
    outs = [_tile_forward(x, wt, b, None, spec.pads, stride, "relu", False,
                          _reshaped(blk, spec, streamed, chunk=16), streamed)
            for streamed in (False, True)
            for blk in _tiles(2, spec, 32, 16, False, streamed)]
    for other in outs[1:]:
        assert torch.equal(other, outs[0])


def test_the_mn_major_order_is_a_permutation_read_back():
    for n in (8, 16, 32, 64, 128):
        b = np.arange(32 * n, dtype=np.float32).reshape(32, n)
        np.testing.assert_array_equal(_mn_major(b), b)


def test_one_accumulator_drift_stays_within_its_bound_at_vgg16_k():
    # VGG-16's longest contraction, 9 x 512 (288 k16 slices at chunk 64),
    # into the one truncating accumulator: each f32 sum within a rounding
    # toward zero of each slice addition of the exact sum of the same bf16
    # products (2^-23 of the running magnitude, at most the sum of the
    # terms' magnitudes), and far inside the output's bf16 rounding
    # (fwd_tile.cuh bf16: at most 3.4e-5 relative, ~1 % of a half-ulp)
    x, wt, b, _, spec = _operands(5, 1, 512, 16, 5, 5, 128, 16, 1, "SAME",
                                  False)
    blk = blocking.choose_fwd_blocking(1, 5, 5, 3, 3, 1, 4, 128, 1, 16,
                                       op_bytes=2)
    assert blk.chunk == 64
    f32 = _tile_forward(x, wt, b, None, spec.pads, 1, None, False, blk,
                        False, f32=True)
    tx, tw_ = (torch.from_numpy(_bf16(a)).double() for a in (x, wt))
    from repro_torch.core.direct_conv import direct_conv_blocked
    exact = direct_conv_blocked(tx, tw_, 1, "SAME").numpy()
    mag = direct_conv_blocked(tx.abs(), tw_.abs(), 1, "SAME").numpy()
    drift = np.abs(f32.astype(np.float64) - exact)
    steps = 512 // 16 * 9
    assert (drift <= steps * 2.0 ** -23 * mag).all()
    assert drift.max() <= 0.01 * 2.0 ** -8 * np.abs(exact).max()
    # truncation is what drifts: a round-to-nearest accumulator stays
    # closer on the whole
    assert drift.max() > 0


def _kernel_gap(out, blk, streamed):
    """The bf16 tile's GAP written out thread by thread in numpy f32 on
    its flattened rows (``fwd_tile::bf16::store_out``): consumer k's m-tile
    row q is window cell f (``_mtile_rows``), output position (f // pitch,
    f % pitch) of the tile, stored where its column is below tw; each
    thread's two rows, the warp's shfl_xor 4, 8, 16 steps, the warps in
    order, the tiles in index order, times the f32 reciprocal of Ho*Wo."""
    v = out.to(torch.float32).numpy()
    n, coblk, ho, wo, cob = v.shape
    across = -(-wo // blk.tw)
    tiles = -(-ho // blk.th) * across
    zero = np.zeros((n, coblk, cob), np.float32)
    f_all, _ = _mtile_rows(blk, streamed)
    strip = blk.hso * blk.pitch if streamed else 64
    parts = []
    for tile in range(tiles):
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        red = []
        for wid in range(4 * blk.wgs):
            wg, w4 = divmod(wid, 4)
            t = []
            for g in range(8):
                pair = []
                for h in range(2):
                    q = 16 * w4 + g + 8 * h
                    f = f_all[64 * wg + q]
                    a, c = f // blk.pitch, f % blk.pitch
                    live = (q < strip and c < blk.tw and a < blk.th
                            and oh0 + a < ho and ow0 + c < wo)
                    pair.append(v[:, :, oh0 + a, ow0 + c] if live else zero)
                t.append(pair[0] + pair[1])
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


@pytest.mark.parametrize("streamed", [False, True])
def test_gap_replay_follows_the_bf16_tiles_rows(streamed):
    out = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 2, 11, 13, 8)).astype(np.float32)).bfloat16()
    spec = ConvSpec.make(2, 11, 13, 8, 16, 3, 3, 1, "SAME")
    for blk in _tiles(2, spec, 8, 8, True, streamed):
        assert blk.pitch > blk.tw or blk.tw >= 13 or streamed
        got = conv2d_common.gap_replay(out, blk)
        want = torch.from_numpy(_kernel_gap(out, blk, streamed)).bfloat16()
        assert torch.equal(got, want), blk
    # the rows are cells: the f32 tile's position order pools f32 values
    # otherwise (sums of a few bf16 values are exact in f32 in any order)
    f32 = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2, 2, 11, 13, 8)).astype(np.float32))
    assert not all(torch.equal(
        conv2d_common.gap_replay(f32, blk),
        conv2d_common.gap_replay(f32, dataclasses.replace(blk, pitch=0)))
        for blk in _tiles(2, spec, 8, 8, True, streamed))


# ---------------------------------------------------------------------------
# precision policy, choosers and routes at 2-byte operands
# ---------------------------------------------------------------------------

def test_precision_fields_match_the_reference():
    for ours, theirs in ((precision.F32, jprecision.F32),
                         (precision.BF16, jprecision.BF16),
                         (precision.Precision("bfloat16", "float32",
                                              "float32"),
                          jprecision.Precision("bfloat16", "float32",
                                               "float32"))):
        assert ours.name == theirs.name
        assert ours.operand_itemsize == theirs.operand_itemsize
        assert ours.accum_itemsize == theirs.accum_itemsize
        assert str(ours.residual_dtype).split(".")[-1] == \
            theirs.residual_dtype.name


def _vgg16_shapes():
    out = []
    for entry in (224, 160):
        h = entry
        for i, (ci, co, s) in enumerate(vgg16_layers()):
            out.append((f"vgg16[{i}]@{entry}", ci, co, s, -(-h // s)))
            h = -(-h // s)
    return out


def _main_path_shapes():
    """VGG-16's 13 layers and MobileNet v1's ``conv1`` at both buckets'
    entries, as ``(name, ci, co, stride, ho)``."""
    kind, ci, co, s = mobilenet_v1_layers()[0]
    assert kind == "conv"
    return _vgg16_shapes() + [(f"mobilenet.conv1@{e}", ci, co, s, -(-e // s))
                              for e in (224, 160)]


def _kernel_rules(blk, s, gap, streamed, cib=3):
    """``fwd_tile::bf16::valid``'s rules on a chooser's tile (3x3); a
    narrow-row tile's on ``cib`` pencils: a row a position, the window
    kernel's, 16 lanes or more."""
    if blk.narrow:
        lay = blocking.fwd_bf16_layout(blk.th, blk.tw, 3, 3, s, blk.chunk,
                                       blk.lanes, blk.wgs, blk.strips, gap,
                                       narrow=1, cib=cib)
        assert not streamed and blk.strips == 1 and 1 <= blk.wgs <= 3
        assert blocking.narrow_fits(3, 3, cib) and blk.lanes >= 16
        assert blk.pitch == lay.pitch == blk.tw
        assert 2 <= lay.windows <= 3 and lay.rows >= 2
        assert lay.smem <= blocking.H100_SXM.smem_block == 232448
        assert 64 * (blk.wgs - 1) < blk.th * blk.tw <= 64 * blk.wgs
        assert s * blk.tw <= 256
        return lay
    lay = blocking.fwd_bf16_layout(blk.th, blk.tw, 3, 3, s, blk.chunk,
                                   blk.lanes, blk.wgs, blk.strips, gap)
    assert blk.pitch == lay.pitch == blocking.fwd_bf16_pitch(
        blk.tw, 3, s, blk.chunk, streamed)
    assert lay.windows >= 2 and lay.rows >= 2
    assert lay.smem <= blocking.H100_SXM.smem_block == 232448
    assert blk.chunk in blocking.FWD_BF16_CHUNKS
    assert s * blk.pitch <= 256
    if streamed:
        assert blk.strips == blk.wgs >= 2 and blk.th % blk.strips == 0
        assert (blk.hso - 1) * blk.pitch + blk.tw <= 64
        assert s * blk.hso <= 256
    else:
        assert blk.strips == 1 and 1 <= blk.wgs <= 3
        assert 64 * (blk.wgs - 1) < (blk.th - 1) * blk.pitch + blk.tw \
            <= 64 * blk.wgs
        assert s * (blk.th + -(-3 // s) - 1) <= 256
    return lay


@pytest.mark.parametrize("gap", [False, True])
@pytest.mark.parametrize("streamed", [False, True])
def test_bf16_choosers_fit_and_take_no_less_a_stage(gap, streamed):
    choose = (blocking.choose_stream_fwd_blocking if streamed
              else blocking.choose_fwd_blocking)
    for name, ci, co, s, ho in _main_path_shapes():
        cib, cob = min(ci, 128), min(co, 128)
        args = (8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        f32 = choose(*args, gap=gap)
        bf = choose(*args, gap=gap, op_bytes=2)
        lay = _kernel_rules(bf, s, gap, streamed, cib)
        smem = blocking.fwd_smem_bytes(bf.th, bf.tw, 3, 3, s, bf.chunk,
                                       bf.lanes, bf.wgs, gap, 2, bf.strips,
                                       narrow=bf.narrow, cib=cib)
        assert smem == lay.smem, name
        assert blocking.fwd_kpad(cib, 2) % bf.chunk == 0, name
        # never less a stage: no fewer channels contracted a stage than the
        # f32 tile's (a chunk of one swizzle row, 16 to 64)
        assert bf.chunk >= f32.chunk, name
        plan = blocking.fwd_plan(bf, 8, ho, ho, 3, 3, s, ci // cib, cib,
                                 co // cob, cob, gap, 2)
        assert plan.smem == smem and plan.products == 1
        assert (plan.window_slots, plan.weight_slots) == (lay.windows,
                                                          lay.rows)
        assert plan.function_macs == 8 * ho * ho * 9 * ci * co
        assert plan.issued_macs >= plan.function_macs
        if cib == 3 and bf.narrow:        # 27 values of 32 a row
            assert plan.padding_share >= 1 - 27 / 32
        elif cib == 3:                    # k16 slices: 3 channels of 16
            assert plan.padding_share >= 1 - 3 / 16
        # every candidate the search weighs is one the kernels take
        for _, blk in blocking.fwd_candidates(*args, blocking.H100_SXM, gap,
                                              streamed, op_bytes=2):
            _kernel_rules(blk, s, gap, streamed, cib)
        assert route_stream("fwd", ConvSpec.make(8, ho * s, ho * s, ci, co,
                                                 3, 3, s, "SAME"),
                            cib, cob, blocking.H100_SXM, gap=gap,
                            op_bytes=2) is False
    with pytest.raises(ValueError, match="4- or 2-byte"):
        blocking.fwd_kpad(3, 8)


@pytest.mark.parametrize("streamed", [False, True])
def test_bf16_choosers_fit_every_main_path_shape_of_both_buckets(streamed):
    # one CTA's 232,448 bytes at every VGG-16 and MobileNet conv1 shape of
    # both buckets, with and without the GAP, three consumers allowed at
    # every width (one accumulator: no two-consumer cap at 128 lanes)
    choose = (blocking.choose_stream_fwd_blocking if streamed
              else blocking.choose_fwd_blocking)
    widest = 0
    for name, ci, co, s, ho in _main_path_shapes():
        cib, cob = min(ci, 128), min(co, 128)
        for gap in (False, True):
            blk = choose(8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob,
                         gap=gap, op_bytes=2)
            _kernel_rules(blk, s, gap, streamed, cib)
            if blk.lanes == 128:
                widest = max(widest, blk.wgs)
        found = blocking.fwd_candidates(8, ho, ho, 3, 3, s, ci // cib, cib,
                                        co // cob, cob, blocking.H100_SXM,
                                        False, streamed, op_bytes=2)
        # three consumers at 128 lanes wherever the map has the rows
        assert any(b.lanes == 128 and b.wgs == 3 for _, b in found) or \
            cob < 128 or s > 1 or ho < 14, name
    assert widest >= 2


# (th, tw, wgs, nsplit, chunk) that the bf16 window and streamed choosers
# take at each of VGG-16's 13 layers and MobileNet v1's conv1 (batch 8,
# 224x224), each with its time over the fastest candidate's in `python -m
# repro_torch.launch.fwd_tiles_ab --dtype bf16 --mobilenet` on an H100 80GB
# HBM3 at 700 W (PERF.md): summed over VGG-16's layers, 1.027
# (window) and 1.034 (streamed) of the fastest tile measured at each.  The
# window kernel's tiles at conv1_1 and MobileNet's conv1 (Cib 3) are the
# narrow rows' (csrc/narrow_rows.cuh), timed by `python -m
# repro_torch.launch.fwd_tiles_ab --first` beside the per-tap tiles on the
# same card (PERF.md: the per-tap tiles pinned here before, (7, 25,
# 3, 1, 16) and (23, 7, 3, 1, 16), ran 1.40x and 1.60x the narrow tiles'
# time).  A change to the cost model that moves a tile shows here; time it
# with that script before repinning.
CHOSEN_BF16_FWD_TILES = {
    "conv1_1": ((4, 45, 3, 1, 16), 1.008, (12, 14, 3, 1, 16), 1.000),
    "conv1_2": ((4, 46, 3, 1, 64), 1.000, (9, 20, 3, 1, 64), 1.021),
    "conv2_1": ((23, 7, 3, 1, 32), 1.000, (9, 19, 3, 1, 32), 1.015),
    "conv2_2": ((6, 30, 3, 1, 64), 1.006, (6, 31, 3, 1, 64), 1.008),
    "conv3_1": ((19, 7, 3, 1, 32), 1.000, (14, 7, 2, 1, 64), 1.043),
    "conv3_2": ((6, 30, 3, 2, 64), 1.105, (6, 30, 3, 2, 64), 1.134),
    "conv3_3": ((6, 30, 3, 2, 64), 1.113, (6, 30, 3, 2, 64), 1.143),
    "conv4_1": ((14, 7, 2, 1, 64), 1.003, (14, 7, 2, 1, 64), 1.000),
    "conv4_2": ((7, 16, 2, 1, 64), 1.002, (8, 14, 2, 1, 64), 1.015),
    "conv4_3": ((7, 16, 2, 1, 64), 1.009, (8, 14, 2, 1, 64), 1.000),
    "conv5_1": ((14, 7, 2, 2, 64), 1.000, (14, 7, 2, 2, 64), 1.000),
    "conv5_2": ((14, 7, 2, 2, 64), 1.042, (14, 7, 2, 2, 64), 1.002),
    "conv5_3": ((14, 7, 2, 2, 64), 1.033, (14, 7, 2, 2, 64), 1.000),
    "mobilenet.conv1": ((3, 56, 3, 1, 16), 1.000, (9, 19, 3, 1, 16), 1.000),
}


def _timed_layers():
    from repro_torch.launch.fwd_tiles_ab import fwd_layers
    kind, ci, co, s = mobilenet_v1_layers()[0]
    return fwd_layers() + [("mobilenet.conv1", ci, co, s, 224)]


def test_bf16_fwd_choosers_take_the_tiles_timed_on_the_card():
    got = {}
    for name, ci, co, s, h in _timed_layers():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        args = (8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        got[name] = tuple((b.th, b.tw, b.wgs, b.nsplit, b.chunk) for b in (
            blocking.choose_fwd_blocking(*args, op_bytes=2),
            blocking.choose_stream_fwd_blocking(*args, op_bytes=2)))
    assert got == {name: (w, st) for name, (w, _, st, _)
                   in CHOSEN_BF16_FWD_TILES.items()}


def test_fwd_tiles_ab_times_the_bf16_chosen_tile_first():
    # launch/fwd_tiles_ab.py --dtype bf16: each route's candidates led by
    # the chooser's tile, every (consumer count, lane split, chunk) among
    # them
    from repro_torch.launch import fwd_tiles_ab as ab
    for name, ci, co, s, h in _timed_layers():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        args = (8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        for streamed, choose in ((False, blocking.choose_fwd_blocking),
                                 (True, blocking.choose_stream_fwd_blocking)):
            tiles = ab.tile_candidates(8, ci, co, s, h, streamed, 4, 1, 2)
            assert tiles[0][1] == choose(*args, op_bytes=2), name
            assert len({b for _, b in tiles}) == len(tiles)
            found = blocking.fwd_candidates(*args, blocking.H100_SXM, False,
                                            streamed, op_bytes=2)
            assert {(b.wgs, b.nsplit, b.chunk) for _, b in tiles} == {
                (b.wgs, b.nsplit, b.chunk) for _, b in found}


def test_bf16_smem_counts_the_tiles_buffers():
    # a window kernel's tile at stride 2: four phase planes of th + 1 rows
    # of tw + 1 cells (128 bytes at chunk 64), then past the last plane as
    # far as the last consumer's rows read; a filter row's 3 taps x lanes;
    # each in whole 1024 bytes; the rings; the mbarriers; the GAP's sums
    th, tw, s, chunk, lanes, wgs = 5, 9, 2, 64, 64, 1
    pitch = tw + 1
    plane = (th + 1) * pitch
    read = 64 + pitch + 1
    cells = 3 * plane + max(plane, read)
    window = -(-cells * 128 // 1024) * 1024
    row = -(-3 * lanes * 128 // 1024) * 1024
    bars = 8 * (4 * 7 + 2 * 4)
    for gap in (False, True):
        red = 16 * wgs * lanes + 16 if gap else 0
        room = 232448 - 1024 - bars - red
        rows = min(4, (room - 2 * window) // row)
        windows = min(4, (room - rows * row) // window)
        want = 1024 + windows * window + rows * row + bars + red
        lay = blocking.fwd_bf16_layout(th, tw, 3, 3, s, chunk, lanes, wgs,
                                       1, gap)
        assert (lay.pitch, lay.plane_cells, lay.window_bytes, lay.row_bytes,
                lay.windows, lay.rows, lay.smem) == (
                    pitch, plane, window, row, windows, rows, want)
        assert blocking.fwd_smem_bytes(th, tw, 3, 3, s, chunk, lanes, wgs,
                                       gap, 2) == want
    # the streamed band's rows are padded to 128 bytes (chunk 16: 4 cells)
    lay = blocking.fwd_bf16_layout(6, 7, 3, 3, 1, 16, 32, 2, 2)
    assert lay.pitch == 12 and lay.plane_cells == 8 * 12


# ---------------------------------------------------------------------------
# the wrappers and the main path in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True])
def test_bf16_wrappers_run_the_plain_version_on_the_cpu(stream):
    x, wt, b, r, _ = _operands(6, 2, 16, 16, 9, 9, 16, 16, 2, "SAME", True)
    before = (dict(LAUNCHES), dict(stk.LAUNCHES))
    with torch.no_grad():
        got = direct_conv2d_blocked(
            *(torch.from_numpy(a) for a in (x, wt, b)), 2, "SAME", "gelu",
            residual=torch.from_numpy(r), gap=True, precision="bf16",
            stream=stream)
    assert (dict(LAUNCHES), dict(stk.LAUNCHES)) == before
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(),
                _jax_bf16(x, wt, b, r, 2, "SAME", "gelu", True))
    # training runs the f32 policy and BF16 only: a float16 policy is
    # refused (bf16 training, tests/test_torch_bf16_train.py)
    w = torch.from_numpy(wt).requires_grad_()
    with pytest.raises(NotImplementedError, match="f32 policy and BF16"):
        direct_conv2d_blocked(torch.from_numpy(x), w, None, 2, "SAME",
                              precision=precision.Precision(
                                  operand="float16", residual="float16"),
                              stream=stream)


@pytest.mark.parametrize("policy,want", [
    ("f32", torch.float32), ("bf16", torch.bfloat16),
    (precision.Precision(operand="bfloat16"), torch.bfloat16),
    (precision.Precision(operand="float16"), None),
    (precision.Precision(operand="float16", residual="float16"), None)])
def test_the_cuda_build_is_chosen_by_operand_dtype_not_size(policy, want):
    """fp16 operands are two bytes like bf16, but no build reads them: the
    CUDA path refuses them rather than run them in bf16."""
    if want is None:
        with pytest.raises(NotImplementedError, match="float16"):
            build_dtype(policy)
    else:
        assert build_dtype(policy) is want


WIDTH_DIV, N_CLASSES = 16, 10


def _vgg_tree(jmodel, seed=0):
    rng = np.random.default_rng(seed)
    specs = jmodel.specs()
    tree = {}
    for i in range(len(jmodel.convs)):
        s = specs[f"conv{i}"]
        fan_in = 9 * jmodel.convs[i].ci
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) * np.sqrt(2.0 / fan_in))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    tree["head"] = rng.normal(size=specs["head"].shape).astype(np.float32)
    return tree


def test_narrow_vgg16_served_in_bf16_matches_the_jax_model():
    jconvs = tuple(jconv.BlockedConv2D(ci, co, stride=s, padding="SAME",
                                       activation="relu")
                   for ci, co, s in vgg16_layers(WIDTH_DIV))
    jmodel = jconv.BlockedCNN(convs=jconvs, n_classes=N_CLASSES)
    tree = _vgg_tree(jmodel)
    port = vgg16_blocked(N_CLASSES, WIDTH_DIV, device="cpu")
    port.load_state_dict(params_from_jax(tree, device="cpu"))
    rng = np.random.default_rng(1)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    jtree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in tree.items()}
    want = np.asarray(jmodel(jtree, jnp.asarray(images),
                             context=JContext(impl="jnp",
                                              precision="bf16"))
                      .astype(jnp.float32))
    ctx = ConvContext(precision="bf16")
    with torch.no_grad():
        direct = port(torch.from_numpy(images), context=ctx)
    assert direct.dtype == torch.bfloat16
    server = ConvServer(port, [(32, 32)], 2, device="cpu", context=ctx)
    reqs = [ConvRequest(i, images[i]) for i in range(3)]
    for req in reqs:
        server.submit(req)
    server.run()
    assert all(req.outcome is Outcome.OK for req in reqs)
    got = np.stack([req.logits for req in reqs])
    np.testing.assert_array_equal(got, direct.float().numpy())
    _bf16_close(got, want)
