"""bf16 training on the dense main path, on the CPU: the bf16 builds of the
dgrad and wgrad tiles (``csrc/dgrad_tile.cuh`` and ``csrc/wgrad_tile.cuh``,
namespace ``bf16``) and the training path under ``BF16``.

Held against the JAX package's streamed Pallas kernels and their custom VJP
under ``precision="bf16"`` in interpret mode (``stream=True,
interpret=True``), which run under the installed jax; the window Pallas
kernels do not (ROADMAP queue C), and the jnp oracle's autodiff does not keep
the kernels' cast discipline (its dw differs from the kernels' by 2e-3 of
max|dw| at a 2 x 16 x 8 x 8 map), so it is no reference here.

Tolerances, and why:

* the prologue: ``dz`` bit for bit the reference's ``cotangent_prologue``
  for relu and linear (one rounding of an exact product); for gelu within
  one bf16 ulp of |dz| (``act'`` is the reference's autodiff of the tanh
  form against the port's written-out derivative, a few f32 ulps apart
  before the one rounding to bf16), and in f32 within 1e-5 relative plus
  1e-6 (the two derivatives' f32 rounding, |g| ~ 1);
* dx: within one bf16 ulp of |dx| plus 1e-5 of max|dx|: both sides round
  f32 sums of the same exact bf16 products once to bf16, in other orders;
* dw and db (f32): within 1e-5 of their max|.|, the same f32 sums in other
  orders;
* a narrow VGG-16 step: loss within 1e-2 relative, every gradient within
  3e-2 of its max|.| (the reference's ``BF16_TOL``,
  ``tests/test_precision.py``): bf16 activations chained through five
  layers, each rounded once per layer in both, may round apart.

Also here: the kernels' tile arithmetic in numpy against the plain version
(k16 slices, Cob and the positions padded to 16, the phase split; the
dgrad's m-tile rows the window's flattened cells, halo columns computed and
not stored, one f32 accumulator over the whole contraction whose adds round
toward zero, VGG-16's longest contraction and the 1x1 tile among the cases;
the wgrad's fresh accumulator a stage added into a running f32 sum; dz
rounded to bf16 as the producer forms it, the ``db`` pass), the choosers at
2-byte operands at every VGG-16 shape of both routes and the bf16 dgrad's
tiles pinned as timed on the card, the dgrad's parts A/B and chip_smoke.py's
SASS count, and the refusals (float16 training, no build reached from a CPU
tensor).  The separable families' bf16 training is in
``tests/test_torch_separable_bf16.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext as JConvContext  # noqa: E402
from repro.kernels import conv2d_common as jcommon  # noqa: E402
from repro.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_dgrad_pallas, direct_conv2d_wgrad_pallas)
from repro.nn import conv as jconv  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch.configs.cnn import vgg16_layers  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.blocking import H100_SXM  # noqa: E402
from repro_torch.core.context import ConvContext  # noqa: E402
from repro_torch.core.conv2d_common import cotangent_prologue  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_dgrad_blocked, direct_conv_wgrad_blocked)
from repro_torch.core.padding import normalize_padding  # noqa: E402
from repro_torch.core.precision import Precision  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import conv2d_stream as stk  # noqa: E402
from repro_torch.kernels import direct_conv2d as dck  # noqa: E402
from repro_torch.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked, direct_conv2d_dgrad, direct_conv2d_wgrad)
from repro_torch.nn.conv import BlockedCNN, BlockedConv2D  # noqa: E402
from repro_torch.train.trainstep import make_loss_fn  # noqa: E402

BF16_TOL = 3e-2          # the reference's tests/test_precision.py BF16_TOL
JSTREAM_BF16 = JConvContext(impl="stream", stream=True, interpret=True,
                            precision="bf16")


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _tb(a):
    """A numpy array as a bf16 torch tensor (None for None)."""
    return None if a is None else torch.from_numpy(
        np.asarray(a, np.float32)).bfloat16()


def _jb(a):
    """A numpy array as a bf16 jax array (None for None)."""
    return None if a is None else jnp.asarray(a, jnp.float32).astype(
        jnp.bfloat16)


def _bf16_close(got, want, rel=1e-5):
    """Every element within one bf16 ulp of its magnitude, plus ``rel`` of
    max|want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    bound = ulp + rel * np.abs(w).max()
    assert (np.abs(g - w) <= bound).all(), float((np.abs(g - w) / bound)
                                                 .max())


def _close_to_max(got, want, rel):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), (err, np.abs(w).max())


def _operands(seed, n, ci, co, h, cib, cob, stride, padding):
    """bf16-valued numpy operands (f32 arrays holding bf16 values): x, w,
    the pre-activation z of the bf16 forward and a cotangent g."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(n, ci // cib, h, h, cib)))
    w = _bf16(rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
              / np.sqrt(9 * ci))
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    spec = ConvSpec.make(n, h, h, ci, co, 3, 3, stride, padding)
    z = dck.direct_conv_preactivation(_tb(x), _tb(w), stride, padding,
                                      torch.from_numpy(b), precision="bf16")
    g = _bf16(rng.normal(size=z.shape))
    return x, w, z.float().numpy(), g, spec


# ---------------------------------------------------------------------------
# the prologue: the reference's cast order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "gelu", None])
@pytest.mark.parametrize("g_dtype,z_dtype", [
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
    ("float32", "float32")])
def test_cotangent_prologue_keeps_the_reference_cast_order(act, g_dtype,
                                                           z_dtype):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(2, 3, 5, 7, 8)).astype(np.float32)
    z[0, 0, 0] = 0.0                       # relu's tie at z == 0: 1/2
    z[1, 2, 4, :3] = -0.0
    g = rng.normal(size=z.shape).astype(np.float32)
    tz = torch.from_numpy(z).to(getattr(torch, z_dtype))
    tg = torch.from_numpy(g).to(getattr(torch, g_dtype))
    jz = jnp.asarray(z).astype(getattr(jnp, z_dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, g_dtype))
    got = cotangent_prologue(tg, tz, act)
    want = np.asarray(jcommon.cotangent_prologue(jg, jz, act).astype(
        jnp.float32))
    assert got.dtype == tg.dtype
    if act == "gelu" and z_dtype == "bfloat16":
        _bf16_close(got.float().numpy(), want, rel=0.0)
    elif act == "gelu":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_mixed_prologue_rounds_dz_to_the_pre_activation_dtype():
    # an f32 cotangent against a bf16 pre-activation: dz is rounded to bf16
    # (z's dtype), then returned in f32 (g's)
    g = torch.tensor([1.0 + 2.0 ** -12, -3.0 + 2.0 ** -10, 0.7])
    z = torch.tensor([0.5, 2.0, 0.0]).bfloat16()
    got = cotangent_prologue(g, z, "relu")
    assert got.dtype == torch.float32
    assert got.tolist() == [1.0, -3.0, float(torch.tensor(0.35).bfloat16())]


# ---------------------------------------------------------------------------
# the dgrad and wgrad alone, against the streamed Pallas kernels in bf16
# ---------------------------------------------------------------------------

# (n, ci, co, h, cib, cob, stride, padding, activation)
DGRAD_CASES = [
    (2, 8, 16, 8, 8, 16, 1, "SAME", "relu"),
    (2, 8, 16, 9, 8, 8, 2, "SAME", "gelu"),
    (2, 16, 12, 10, 8, 12, 2, "VALID", "relu"),     # Cob 12: % 8 != 0
    (2, 8, 6, 7, 4, 6, 1, "SAME", "gelu"),          # Cob 6
    (1, 16, 16, 8, 16, 16, 1, "VALID", None),
]


def _padded(a, pads):
    (pt, pb), (pl, pr) = pads
    return np.pad(a, ((0, 0), (0, 0), (pt, pb), (pl, pr), (0, 0)))


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,padding,act",
                         DGRAD_CASES)
def test_bf16_dgrad_matches_pallas_stream_interpret(stream, n, ci, co, h,
                                                    cib, cob, stride,
                                                    padding, act):
    x, w, z, g, spec = _operands(1, n, ci, co, h, cib, cob, stride, padding)
    zz = z if act else None
    dxp = np.asarray(direct_conv2d_dgrad_pallas(
        _jb(g), _jb(w), stride=stride, stream=True, interpret=True,
        z=_jb(zz), activation=act).astype(jnp.float32))
    full = np.zeros(_padded(x, spec.pads).shape, np.float32)
    full[:, :, :dxp.shape[2], :dxp.shape[3]] = dxp
    (pt, _), (pl, _) = spec.pads
    want = full[:, :, pt:pt + h, pl:pl + h]
    got = direct_conv2d_dgrad(_tb(g), _tb(w), (h, h), stride, padding,
                              _tb(zz), act, stream=stream, precision="bf16")
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _bf16_close(got.float().numpy(), want)


# (n, ci, co, h, cib, cob, stride, padding, activation, with_db)
WGRAD_CASES = [
    (2, 3, 8, 12, 3, 8, 2, "SAME", "relu", True),     # Cib = 3
    (2, 8, 12, 9, 8, 12, 1, "SAME", "gelu", True),    # Cob 12
    (2, 8, 16, 10, 8, 8, 2, "SAME", "relu", False),
    (1, 16, 8, 8, 16, 8, 1, "VALID", None, True),
]


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,padding,act,with_db",
                         WGRAD_CASES)
def test_bf16_wgrad_matches_pallas_stream_interpret(stream, n, ci, co, h,
                                                    cib, cob, stride,
                                                    padding, act, with_db):
    x, w, z, g, spec = _operands(2, n, ci, co, h, cib, cob, stride, padding)
    zz = z if act else None
    want = direct_conv2d_wgrad_pallas(
        _jb(_padded(x, spec.pads)), _jb(g), 3, 3, stride=stride,
        stream=True, interpret=True, out_dtype=jnp.float32, z=_jb(zz),
        activation=act, with_db=with_db)
    want_dw, want_db = want if with_db else (want, None)
    dw, db = direct_conv2d_wgrad(_tb(x), _tb(g), 3, 3, stride, padding,
                                 _tb(zz), act, with_db, stream=stream,
                                 precision="bf16")
    assert dw.dtype == torch.float32
    _close_to_max(dw.numpy(), np.asarray(want_dw), 1e-5)
    if with_db:
        assert db.dtype == torch.float32
        _close_to_max(db.numpy(), np.asarray(want_db), 1e-5)
    else:
        assert db is None


# ---------------------------------------------------------------------------
# the bf16 builds' tile arithmetic in numpy
# ---------------------------------------------------------------------------

def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32: the tensor cores' addition of
    a k16 slice's sum into an f32 accumulator."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _tile_dgrad_bf16(dz, wt, hw, stride, pads, blk, streamed, f32=False):
    """``dgrad_kernel_bf16`` / ``stream_dgrad_kernel_bf16`` in numpy: per
    CTA the window of bf16 dz (zero outside the map, Cob padded to 16)
    flattened row-major, ``dgrad_bf16_wpitch`` cells a window row; each
    consumer's m-tile 64 consecutive cells (the window tile's consumers 64
    apart, the streamed band's strips ``mstride`` apart); one f32
    accumulator over (Co block, chunk, tap, k16 slice) that takes each
    slice's exact sum rounding toward zero, a tap's rows read ``(mh - t_h)
    * wpitch + mw - t_w`` cells on; rows on the window's halo columns or
    past the tile computed and not stored; dx the sum rounded once to bf16
    (``f32``: the f32 sums).  -> dx as f32."""
    n, coblk, ho, wo, cob = dz.shape
    _, ciblk, hf, wf, cib, _ = wt.shape
    hi, wi = hw
    mh, mw = -(-hf // stride), -(-wf // stride)
    kpad = -(-cob // 16) * 16
    assert blk.chunk in (16, 32, 64) and kpad % blk.chunk == 0
    pitch = blocking.dgrad_bf16_wpitch(blk.wwin, blk.chunk, streamed)
    rows = 64
    starts = ([k * blk.mstride for k in range(blk.strips)] if streamed
              else [rows * k for k in range(blk.wgs)])
    if streamed:
        assert (blk.hso - 1) * pitch + blk.tw <= rows
        assert blk.mstride == blk.hso * pitch
    else:
        assert (blk.th - 1) * pitch + blk.tw <= rows * blk.wgs
    # the slot's cells: the window's and as far as the last m-tile reads
    cells = max(blk.hwin * pitch, starts[-1] + rows + (mh - 1) * pitch
                + mw - 1)
    assert cells * 2 * blk.chunk <= blocking.dgrad_bf16_smem_bytes(
        blk, hf, wf, stride, False)
    dzp = np.zeros(dz.shape[:4] + (kpad,), np.float32)
    dzp[..., :cob] = dz
    wp = np.zeros(wt.shape[:5] + (kpad,), np.float32)
    wp[..., :cob] = wt
    dx = np.full((n, ciblk, hi, wi, cib), np.nan, np.float32)
    for r, c, a0, b0 in blocking.dgrad_tiles(blk, hi, wi, hf, wf, stride,
                                             pads):
        o_h, o_w = r.q0 + a0 - (mh - 1), c.q0 + b0 - (mw - 1)
        win = np.zeros((n, coblk, cells, kpad), np.float32)
        for rr in range(blk.hwin):
            for cc in range(pitch):
                if 0 <= o_h + rr < ho and 0 <= o_w + cc < wo:
                    win[:, :, rr * pitch + cc] = dzp[:, :, o_h + rr, o_w + cc]
        for k, f0 in enumerate(starts):
            acc = np.zeros((n, ciblk, rows, cib), np.float32)
            for o_b in range(coblk):
                for c0 in range(0, kpad, blk.chunk):
                    for th in range(r.taps):
                        for tw in range(c.taps):
                            shift = (mh - 1 - th) * pitch + mw - 1 - tw
                            a = win[:, o_b, f0 + shift:f0 + shift + rows]
                            dh = r.phase + stride * th
                            dw = c.phase + stride * tw
                            for kk in range(c0, c0 + blk.chunk, 16):
                                acc = _add_rz(acc, np.einsum(
                                    "nmk,bck->nbmc",
                                    a[..., kk:kk + 16].astype(np.float64),
                                    wp[o_b, :, dh, dw, :, kk:kk + 16]
                                    .astype(np.float64)))
            for q in range(rows):
                if streamed and q >= blk.mstride:
                    continue                     # the next strip's rows
                ra, rb = divmod(f0 + q, pitch)
                if ra >= blk.th or rb >= blk.tw:
                    continue                     # a halo column or past
                a, bb = a0 + ra, b0 + rb
                if a < r.extent and bb < c.extent:
                    at = (slice(None), slice(None), r.first + stride * a,
                          c.first + stride * bb)
                    assert np.isnan(dx[at]).all()       # stored once
                    dx[at] = acc[:, :, q]
    assert not np.isnan(dx).any()           # every position written once
    return dx if f32 else _bf16(dx)


def _tile_wgrad_bf16(x, dz, blk, hf, wf, stride, pads, streamed):
    """``wgrad_kernel_bf16`` / ``stream_wgrad_kernel_bf16`` in numpy, on dz
    as the dz pass leaves it: per CTA (Ci block, Co block, m-tile group,
    share) each stage's window staged as ``issue`` stages it, a
    ``[hwin][tw + (wf - 1) // s][64]`` block a (64-channel half, column
    phase) the CTA holds (zero outside the map and past Cib), B the tile's
    dz ``[kpos][lanes]`` (zero past the map, past the tile's positions up
    to K padded to 16, and past Cob); an m-tile (half, tap) reads A by its
    descriptors: a k16 step's two 8-position groups from the step tables
    (each group 8 consecutive cells of the tap's phase, the second group's
    offset 0 past the tile), each step's exact sum added into a fresh f32
    accumulator rounding toward zero, the stage's accumulator then added
    into the running f32 sum; the shares' rows added in split order; a
    narrow-row tile as ``test_torch_narrow_runs`` emulates
    ``wgrad_kernel_bf16_narrow``.  -> dw."""
    if blk.narrow:
        from test_torch_narrow_runs import narrow_wgrad
        assert not streamed
        return narrow_wgrad(x, dz, blk, hf, wf, stride, pads)
    n, ciblk, hi, wi, cib = x.shape
    _, coblk, ho, wo, cob = dz.shape
    (pt, _), (pl, _) = pads
    th, tw, lanes, kpos = blk.th, blk.tw, blk.lanes, blk.kpos
    assert blk.kstep == 16 and kpos % 16 == 0 and lanes in (64, 128)
    flat = hf == wf == stride == 1
    assert flat or tw % 8 == 0
    taps, halves = hf * wf, -(-cib // 64)
    phases, wph = min(stride, wf), tw + (wf - 1) // stride
    hwin = (th - 1) * stride + hf
    span = blk.wgs * blk.mpw
    tpg, gph, hpg, groups = blocking.wgrad_bf16_groups(hf, wf, cib, span)
    assert groups == blk.groups
    # a region's cells (the window, and the reads of a flat tile's padding)
    cells = max(hwin * wph, -(-th * tw // 8) * 8)
    region = -(-cells * 128 // 1024) * 1024 // 128

    def cell(p):
        return (p // tw) * stride * wph + p % tw
    steps = [(cell(16 * j), cell(16 * j + 8) if 16 * j + 8 < th * tw
              else cell(16 * j)) for j in range(kpos // 16)]
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    total_tiles = n * tiles_h * tiles_w
    assert total_tiles == blk.tiles

    def tile_of(t):
        img, rem = divmod(t, tiles_h * tiles_w)
        a, b = ((rem % tiles_h, rem // tiles_h) if streamed
                else divmod(rem, tiles_w))
        return img, a * th, b * tw

    dw_size = coblk * ciblk * taps * cib * cob
    ws = np.full((blk.splits, dw_size), np.nan, np.float32)
    for ci_b in range(ciblk):
        for co_b in range(coblk):
            for group in range(groups):
                h0 = group // gph * hpg
                mts = []
                for i in range(span):
                    lh, tp = i // tpg, group % gph * tpg + i % tpg
                    if lh < hpg and h0 + lh < halves and tp < taps:
                        mts.append((lh, h0 + lh, tp))
                for split in range(blk.splits):
                    first = total_tiles * split // blk.splits
                    last = total_tiles * (split + 1) // blk.splits
                    total = np.zeros((len(mts), 64, lanes), np.float32)
                    for t in range(first, last):
                        img, oh0, ow0 = tile_of(t)
                        win = np.zeros((hpg, phases, region, 64), np.float32)
                        for lh in range(min(hpg, halves - h0)):
                            c0 = 64 * (h0 + lh)
                            c1 = min(cib, c0 + 64)
                            for ph in range(phases):
                                for r in range(hwin):
                                    for k in range(wph):
                                        ih = oh0 * stride - pt + r
                                        iw = ow0 * stride - pl + ph \
                                            + stride * k
                                        if 0 <= ih < hi and 0 <= iw < wi:
                                            win[lh, ph, r * wph + k,
                                                :c1 - c0] = x[img, ci_b, ih,
                                                              iw, c0:c1]
                        b_op = np.zeros((kpos, lanes), np.float32)
                        for p in range(th * tw):
                            oh, ow = oh0 + p // tw, ow0 + p % tw
                            if oh < ho and ow < wo:
                                b_op[p, :cob] = dz[img, co_b, oh, ow]
                        for m, (lh, hh, tp) in enumerate(mts):
                            dh, dwi = divmod(tp, wf)
                            shift = dh * wph + dwi // stride
                            acc = np.zeros((64, lanes), np.float32)
                            for j, (g0, g1) in enumerate(steps):
                                rows = [g0 + shift + k for k in range(8)] \
                                    + [g1 + shift + k for k in range(8)]
                                assert max(rows) < region
                                a_op = win[lh, dwi % stride, rows].T
                                acc = _add_rz(acc, a_op.astype(np.float64)
                                              @ b_op[16 * j:16 * j + 16]
                                              .astype(np.float64))
                            total[m] = total[m] + acc
                    for m, (lh, hh, tp) in enumerate(mts):
                        for c in range(64 * hh, min(cib, 64 * hh + 64)):
                            base = (((co_b * ciblk + ci_b) * taps + tp) * cib
                                    + c) * cob
                            ws[split, base:base + cob] = \
                                total[m, c - 64 * hh, :cob]
    assert not np.isnan(ws).any()            # every (tap, c) written once
    out = ws[0].copy()
    for k in range(1, blk.splits):
        out = out + ws[k]
    return out.reshape(coblk, ciblk, hf, wf, cib, cob)


def _dz_pass_bf16(g, z, act, splits):
    """``dz_kernel_bf16`` in numpy: dz = g * act'(z) rounded once to bf16
    (``cotangent_prologue``), and db as the kernel sums it: per Co block
    ``splits`` contiguous shares of the N * Ho * Wo positions; in a share a
    thread a (unit of 8 lanes, or 1 where Cob % 8 != 0) and row of ``256 /
    units`` positions, each summing its positions in order in f32; the rows
    added in order; the shares in split order.  -> (dz, db)."""
    dz = cotangent_prologue(_tb(g), _tb(z) if act else None, act).float() \
        .numpy()
    n, coblk, ho, wo, cob = dz.shape
    u = 8 if cob % 8 == 0 else 1
    rows = 256 // (cob // u)
    flat = dz.transpose(1, 0, 2, 3, 4).reshape(coblk, n * ho * wo, cob)
    total = n * ho * wo
    db = np.zeros((coblk, cob), np.float32)
    for co_b in range(coblk):
        out = None
        for split in range(splits):
            first = total * split // splits
            last = total * (split + 1) // splits
            part = np.zeros((rows, cob), np.float32)
            for r in range(rows):
                for p in range(first + r, last, rows):
                    part[r] = part[r] + flat[co_b, p]
            row = part[0].copy()
            for r in range(1, rows):
                row = row + part[r]
            out = row if out is None else out + row
        db[co_b] = out
    return dz, db


TILE_CASES = [
    (2, 8, 16, 8, 8, 16, 1, "SAME", "relu"),
    (2, 16, 12, 9, 16, 12, 2, "SAME", "gelu"),       # Cob 12, stride 2
    (1, 3, 8, 10, 3, 8, 2, "VALID", "relu"),          # Cib = 3
    (2, 32, 32, 6, 16, 16, 1, "SAME", None),          # two Ci, Co blocks
]
# more for the bf16 GEMM: asymmetric SAME pads at stride 2 (pad (0, 1)),
# Cib 8 at stride 2, a Ci block of two 64-channel halves
TILE_CASES_GEMM = [
    (2, 8, 12, 10, 8, 12, 2, "SAME", "gelu"),
    (1, 128, 8, 6, 128, 8, 1, "SAME", "relu"),
]


# more for the bf16 dgrad: the longest contraction on the main paths
# (VGG-16's 9 x 512: Cob 128, four Co blocks, 288 k16 slices into the one
# accumulator) on a narrow map
DGRAD_TILE_CASES = [
    (1, 8, 512, 5, 8, 128, 1, "SAME", "relu"),
]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,padding,act",
                         TILE_CASES + DGRAD_TILE_CASES)
def test_bf16_dgrad_tile_arithmetic_matches_plain_version(
        streamed, n, ci, co, h, cib, cob, stride, padding, act):
    x, w, z, g, spec = _operands(3, n, ci, co, h, cib, cob, stride, padding)
    zz = _tb(z) if act else None
    dz = cotangent_prologue(_tb(g), zz, act).float().numpy()
    want = direct_conv_dgrad_blocked(_tb(g), _tb(w), (h, h), stride, padding,
                                     zz, act).float().numpy()
    pads = normalize_padding(padding, 3, 3, stride, h, h)
    choose = (blocking.choose_stream_dgrad_blocking if streamed
              else blocking.choose_dgrad_blocking)
    blks = [choose(n, h, h, 3, 3, stride, ci // cib, cib, cob,
                   prologue=act is not None, op_bytes=2)]
    # a small tile overhanging the phases' edges at chunk 16
    rows, tw = 1, 3
    th = rows * blks[0].strips if streamed else 2
    wwin = tw + -(-3 // stride) - 1
    blks.append(dataclasses.replace(
        blks[0], th=th, tw=tw, chunk=16, hwin=th + -(-3 // stride) - 1,
        wwin=wwin,
        mstride=(rows * blocking.dgrad_bf16_wpitch(wwin, 16, True)
                 if streamed else blks[0].mstride)))
    for blk in blks:
        got = _tile_dgrad_bf16(dz, w, (h, h), stride, pads, blk, streamed)
        _bf16_close(got, want)
    if ci // cib * cob * 9 < 9 * 512:
        return
    # the longest contraction: the one truncating accumulator's f32 sums
    # within a rounding toward zero of each of the 288 slice additions of
    # the exact sums (2^-23 of the running magnitude, at most the sum of
    # the terms' magnitudes), and far inside dx's bf16 rounding
    steps = co // 16 * 9
    f32 = _tile_dgrad_bf16(dz, w, (h, h), stride, pads, blks[0], streamed,
                           f32=True)
    td, tw_ = torch.from_numpy(dz).double(), torch.from_numpy(w).double()
    exact = direct_conv_dgrad_blocked(td, tw_, (h, h), stride,
                                      padding).numpy()
    mag = direct_conv_dgrad_blocked(td.abs(), tw_.abs(), (h, h), stride,
                                    padding).numpy()
    drift = np.abs(f32.astype(np.float64) - exact)
    assert (drift <= steps * 2.0 ** -23 * mag).all()
    assert drift.max() <= 0.01 * 2.0 ** -8 * np.abs(exact).max()


PW_DGRAD_CASES = [
    (2, 16, 64, 7, 16, 64, "relu"),
    (1, 64, 256, 5, 64, 128, "gelu"),        # two Co blocks, Cib 64
    (2, 8, 12, 6, 8, 12, None),              # Cob 12: k16 padding
]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,act", PW_DGRAD_CASES)
def test_bf16_dgrad_tile_arithmetic_at_1x1(streamed, n, ci, co, h, cib, cob,
                                           act):
    # MobileNet's pointwise dgrad runs the dense bf16 dgrad at a 1x1
    # filter: no halo, an m-tile's rows the tile's positions
    rng = np.random.default_rng(11)
    x = _bf16(rng.normal(size=(n, ci // cib, h, h, cib)))
    w = _bf16(rng.normal(size=(co // cob, ci // cib, 1, 1, cib, cob))
              / np.sqrt(ci))
    z = dck.direct_conv_preactivation(_tb(x), _tb(w), 1, "VALID",
                                      precision="bf16").float().numpy()
    g = _bf16(rng.normal(size=z.shape))
    zz = _tb(z) if act else None
    dz = cotangent_prologue(_tb(g), zz, act).float().numpy()
    want = direct_conv_dgrad_blocked(_tb(g), _tb(w), (h, h), 1, "VALID", zz,
                                     act).float().numpy()
    pads = normalize_padding("VALID", 1, 1, 1, h, h)
    choose = (blocking.choose_stream_dgrad_blocking if streamed
              else blocking.choose_dgrad_blocking)
    blk = choose(n, h, h, 1, 1, 1, ci // cib, cib, cob,
                 prologue=act is not None, op_bytes=2)
    assert blk.hwin == blk.th and blk.wwin == blk.tw
    _bf16_close(_tile_dgrad_bf16(dz, w, (h, h), 1, pads, blk, streamed),
                want)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,padding,act",
                         TILE_CASES + TILE_CASES_GEMM)
def test_bf16_wgrad_tile_arithmetic_matches_plain_version(
        streamed, n, ci, co, h, cib, cob, stride, padding, act):
    # the GEMM on dz and the dz pass, each held against the reference's
    # streamed Pallas VJP under BF16 in interpret mode (its own cast
    # discipline: dz rounded once, f32 dw and db) and the plain version
    x, w, z, g, spec = _operands(4, n, ci, co, h, cib, cob, stride, padding)
    zz = z if act else None
    dz, db = _dz_pass_bf16(g, zz, act, blocking.dz_splits(
        n, co // cob, spec.ho * spec.wo))
    want_dw, want_db = direct_conv2d_wgrad_pallas(
        _jb(_padded(x, spec.pads)), _jb(g), 3, 3, stride=stride,
        stream=True, interpret=True, out_dtype=jnp.float32, z=_jb(zz),
        activation=act, with_db=True)
    plain_dw, plain_db = direct_conv_wgrad_blocked(
        _tb(x), _tb(g), 3, 3, stride, padding, _tb(zz), act, with_db=True)
    pads = normalize_padding(padding, 3, 3, stride, h, h)
    choose = (blocking.choose_stream_wgrad_blocking if streamed
              else blocking.choose_wgrad_blocking)
    blk = choose(n, spec.ho, spec.wo, 3, 3, stride, ci // cib, cib,
                 co // cob, cob, prologue=act is not None, op_bytes=2)
    picks = [blk]
    if blk.narrow:              # the best per-tap tile as well
        picks.append(min(blocking.wgrad_candidates(
            n, spec.ho, spec.wo, 3, 3, stride, ci // cib, cib, co // cob,
            cob, blocking.H100_SXM, act is not None, streamed, op_bytes=2,
            narrow=False), key=lambda kb: kb[0])[1])
    tiles = []
    for pick in picks:
        # a small tile: two rows of 8 (K 16, no padding group), two shares
        tiles += [pick, dataclasses.replace(
            pick, th=2, tw=8, splits=2,
            tiles=n * -(-spec.ho // 2) * -(-spec.wo // 8))]
    for b in tiles:
        dw = _tile_wgrad_bf16(x, dz, b, 3, 3, stride, pads, streamed)
        _close_to_max(dw, np.asarray(want_dw), 1e-5)
        _close_to_max(dw, plain_dw.numpy(), 1e-5)
    _close_to_max(db, np.asarray(want_db), 1e-5)
    _close_to_max(db, plain_db.numpy(), 1e-5)


# (n, ci, co, h, cib, cob, act) at a 1x1 filter: whole rows a stage,
# positions run on across the row breaks (7x7: 49 padded to 64), Cib 3
# and 8, Cob % 8 != 0, two Ci and Co blocks
PW_TILE_CASES = [
    (2, 16, 12, 7, 16, 12, "relu"),
    (1, 3, 8, 9, 3, 8, "gelu"),
    (2, 16, 16, 6, 8, 8, None),
]


@pytest.mark.parametrize("n,ci,co,h,cib,cob,act", PW_TILE_CASES)
def test_bf16_wgrad_tile_arithmetic_at_1x1_full_rows(n, ci, co, h, cib, cob,
                                                     act):
    rng = np.random.default_rng(5)
    x = _bf16(rng.normal(size=(n, ci // cib, h, h, cib)))
    z = _bf16(rng.normal(size=(n, co // cob, h, h, cob)))
    g = _bf16(rng.normal(size=z.shape))
    zz = z if act else None
    dz, _ = _dz_pass_bf16(g, zz, act, 1)
    want_dw = direct_conv2d_wgrad_pallas(
        _jb(x), _jb(g), 1, 1, stride=1, stream=True, interpret=True,
        out_dtype=jnp.float32, z=_jb(zz), activation=act, with_db=False)
    blk = blocking.choose_wgrad_blocking(n, h, h, 1, 1, 1, ci // cib, cib,
                                         co // cob, cob, op_bytes=2)
    assert blk.tw == h and blk.kpos >= blk.th * h
    for b in (blk, dataclasses.replace(blk, th=1, splits=2, tiles=n * h)):
        dw = _tile_wgrad_bf16(x, dz, b, 1, 1, 1, ((0, 0), (0, 0)), False)
        _close_to_max(dw, np.asarray(want_dw), 1e-5)


@pytest.mark.parametrize("act", ["relu", "gelu", None])
@pytest.mark.parametrize("cob", [16, 6, 3])
def test_dz_pass_plain_version_is_the_prologue_with_an_f64_db(act, cob):
    # cotangent_pass on the CPU: bit for bit cotangent_prologue (f32 g with
    # bf16 z as well: the reference's cast order), db against an f64 sum
    rng = np.random.default_rng(cob)
    g = rng.normal(size=(2, 2, 5, 6, cob)).astype(np.float32)
    z = _bf16(rng.normal(size=g.shape))
    z[0, 0, 0, 0, 0] = 0.0                          # relu's tie
    zz = _tb(z) if act else None
    for gt in (_tb(g), torch.from_numpy(g)):
        dz, db = dck.cotangent_pass(gt, zz, act, True)
        assert torch.equal(dz, cotangent_prologue(gt, zz, act))
        exact = dz.double().sum(dim=(0, 2, 3))
        scale = dz.double().abs().sum(dim=(0, 2, 3))
        assert ((db.double() - exact).abs() <= 1e-6 * scale).all()
        _, none = dck.cotangent_pass(gt, zz, act, False)
        assert none is None
    # the kernel's summation order in numpy (shares, rows, units) meets the
    # same bound
    _, db = _dz_pass_bf16(g, z if act else None, act, 3)
    dz = cotangent_prologue(_tb(g), zz, act).double()
    exact = dz.sum(dim=(0, 2, 3)).numpy()
    scale = dz.abs().sum(dim=(0, 2, 3)).numpy()
    assert (np.abs(db - exact) <= 1e-6 * scale).all()


# ---------------------------------------------------------------------------
# the choosers at 2-byte operands
# ---------------------------------------------------------------------------

def _vgg_shapes(entry=224):
    out, h = [], entry
    for ci, co, s in vgg16_layers():
        out.append((ci, co, s, h))
        h = ConvSpec.make(1, h, h, ci, co, 3, 3, s, "SAME").ho
    return out


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("ci,co,s,h", _vgg_shapes())
def test_bf16_backward_choosers_fit_the_cta_at_vgg16_shapes(streamed, ci, co,
                                                            s, h):
    n, cib, cob = 8, min(ci, 128), min(co, 128)
    ho = -(-h // s)
    blocks = (ci // cib, cib, co // cob, cob)
    wgrad = (blocking.choose_stream_wgrad_blocking if streamed
             else blocking.choose_wgrad_blocking)
    f32, bf = (wgrad(n, ho, ho, 3, 3, s, *blocks, prologue=True,
                     op_bytes=ob) for ob in (4, 2))
    assert bf.kstep == 16 and f32.kstep == 8
    assert blocking.wgrad_smem_bytes(bf.th, bf.tw, 3, 3, s, cib, cob,
                                     bf.lanes, True, 2, bf.wgs * bf.mpw) \
        <= H100_SXM.smem_block
    assert bf.lanes * bf.mpw <= 128 and 1 <= bf.wgs <= (
        2 if bf.lanes * bf.mpw == 128 else 3)
    # no less work a stage: positions x rows a CTA contracts
    assert bf.kpos * bf.wgs * bf.mpw >= f32.th * f32.tw * f32.wgs * f32.mpw \
        or bf.kpos >= f32.kpos
    plan = blocking.wgrad_plan(bf, n, ho, ho, 3, 3, s, *blocks, True)
    assert plan.products == 1 and plan.issued_macs >= plan.function_macs
    if ci == 3:
        return                                  # no dx of the images
    dgrad = (blocking.choose_stream_dgrad_blocking if streamed
             else blocking.choose_dgrad_blocking)
    f32, bf = (dgrad(n, h, h, 3, 3, s, ci // cib, cib, cob, prologue=True,
                     op_bytes=ob) for ob in (4, 2))
    # a chunk of one swizzle row; the tile's flattened window rows (halo
    # columns included) in its m-tiles; three consumers at every width
    assert bf.chunk in (16, 32, 64) and (-(-cob // 16) * 16) % bf.chunk == 0
    assert blocking.dgrad_bf16_smem_bytes(bf, 3, 3, s, True) \
        <= H100_SXM.smem_block
    assert 1 <= bf.wgs <= 3
    pitch = blocking.dgrad_bf16_wpitch(bf.wwin, bf.chunk, streamed)
    assert (bf.hso - 1) * pitch + bf.tw <= 64 * (1 if streamed else bf.wgs)
    assert bf.th * bf.tw * bf.chunk >= f32.th * f32.tw * f32.chunk
    plan = blocking.dgrad_plan(bf, n, h, h, 3, 3, s,
                               ConvSpec.make(n, h, h, ci, co, 3, 3, s,
                                             "SAME").pads,
                               ci // cib, cib, co // cob, cob, 2)
    assert plan.products == 1 and plan.issued_macs >= plan.function_macs


# (th, tw, wgs, chunk) that the bf16 dgrad choosers take at each of VGG-16's
# dgrads (batch 8, 224x224 entry, the relu prologue's tiles: window, then
# streamed) and at MobileNet v1's distinct pointwise legs (batch 32, 1x1),
# each with its time over the fastest candidate's on dz in `python -m
# repro_torch.launch.dgrad_tiles_ab --dtype bf16` and
# `python -m repro_torch.launch.pointwise_tiles_ab --dtype bf16 --kind
# dgrad` on an H100 80GB HBM3 at 700 W: summed, 0.7971 ms window and
# 1.0450 ms streamed against 0.7888 and 1.0279 for the fastest tile timed
# at each layer, and 0.4166 ms over MobileNet's 13 legs against 0.4076.
# A change to the cost model that moves a tile shows here; time it with
# those scripts before repinning.
CHOSEN_BF16_DGRAD_TILES = {
    "conv1_2": ((4, 46, 3, 64), 1.008, (6, 31, 3, 64), 1.010),
    "conv2_1": ((8, 23, 3, 64), 1.000, (9, 19, 3, 64), 1.005),
    "conv2_2": ((7, 25, 3, 64), 1.013, (9, 20, 3, 64), 1.046),
    "conv3_1": ((14, 12, 3, 64), 1.012, (12, 14, 3, 64), 1.023),
    "conv3_2": ((4, 30, 2, 64), 1.024, (4, 31, 2, 64), 1.009),
    "conv3_3": ((4, 30, 2, 64), 1.025, (4, 31, 2, 64), 1.021),
    "conv4_1": ((14, 10, 3, 64), 1.013, (15, 10, 3, 64), 1.014),
    "conv4_2": ((7, 16, 2, 64), 1.011, (8, 14, 2, 64), 1.000),
    "conv4_3": ((7, 16, 2, 64), 1.004, (8, 14, 2, 64), 1.000),
    "conv5_1": ((14, 7, 2, 64), 1.000, (14, 7, 2, 64), 1.002),
    "conv5_2": ((7, 7, 1, 64), 1.004, (8, 14, 2, 64), 1.074),
    "conv5_3": ((7, 7, 1, 64), 1.000, (8, 14, 2, 64), 1.051),
}
CHOSEN_BF16_POINTWISE_DGRAD_TILES = {
    (32, 64, 112): ((23, 8, 3, 64), 1.002),
    (64, 128, 56): ((56, 3, 3, 64), 1.034),
    (128, 128, 56): ((56, 3, 3, 64), 1.080),
    (128, 256, 28): ((14, 7, 2, 64), 1.037),
    (256, 256, 28): ((28, 5, 3, 64), 1.009),
    (256, 512, 14): ((14, 7, 2, 64), 1.021),
    (512, 512, 14): ((14, 7, 2, 64), 1.016),
    (512, 1024, 7): ((7, 7, 1, 64), 1.000),
    (1024, 1024, 7): ((7, 7, 1, 64), 1.000),
}


def test_bf16_dgrad_choosers_take_the_tiles_timed_on_the_card():
    from repro_torch.launch.dgrad_tiles_ab import dgrad_layers
    from repro_torch.launch.pointwise_tiles_ab import pointwise_legs
    got = {}
    for name, ci, co, s, h in dgrad_layers():
        cib, cob = min(ci, 128), min(co, 128)
        tiles = [choose(8, h, h, 3, 3, s, ci // cib, cib, cob, prologue=True,
                        op_bytes=2)
                 for choose in (blocking.choose_dgrad_blocking,
                                blocking.choose_stream_dgrad_blocking)]
        got[name] = tuple((b.th, b.tw, b.wgs, b.chunk) for b in tiles)
    assert got == {name: (w, st) for name, (w, _, st, _)
                   in CHOSEN_BF16_DGRAD_TILES.items()}
    got = {}
    for ci, co, h in pointwise_legs():
        cib, cob = min(ci, 128), min(co, 128)
        b = blocking.choose_dgrad_blocking(32, h, h, 1, 1, 1, ci // cib, cib,
                                           cob, prologue=True, op_bytes=2)
        got[(ci, co, h)] = (b.th, b.tw, b.wgs, b.chunk)
    assert got == {leg: tile for leg, (tile, _)
                   in CHOSEN_BF16_POINTWISE_DGRAD_TILES.items()}
    # the f32 choosers' tiles stay as timed (test_torch_dgrad_phases.py)
    from test_torch_dgrad_phases import CHOSEN_DGRAD_TILES
    for name, ci, co, s, h in dgrad_layers():
        cib, cob = min(ci, 128), min(co, 128)
        b = blocking.choose_dgrad_blocking(8, h, h, 3, 3, s, ci // cib, cib,
                                           cob, prologue=True)
        assert (b.th, b.tw, b.wgs, b.chunk) == CHOSEN_DGRAD_TILES[name][0]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,s,cob", [
    (8, 64, 6, 56, 2, 6),            # Cob 6: 4-byte copies
    (8, 512, 1000, 14, 1, 125),      # Co 1000 at Cob 125: 2-byte copies
    (1, 64, 250, 14, 1, 125),
])
def test_bf16_dgrad_choosers_fit_both_rings_on_the_copies_path(streamed, n,
                                                                ci, co, h, s,
                                                                cob):
    # where Cob is no multiple of 8 the producer copies a slot at a time:
    # the tile chosen must still hold two window slots and two weight slots
    # in the CTA with the rest (a chooser that took this for granted failed
    # a Co 1000 launch on the card)
    cib = min(ci, 128)
    choose = (blocking.choose_stream_dgrad_blocking if streamed
              else blocking.choose_dgrad_blocking)
    blk = choose(n, h, h, 3, 3, s, ci // cib, cib, cob, prologue=True,
                 op_bytes=2)
    windows, rows = blocking.dgrad_bf16_rings(blk, 3, 3, s, True)
    assert windows >= 2 and rows >= 2
    assert blocking.dgrad_bf16_smem_bytes(blk, 3, 3, s, True) \
        <= H100_SXM.smem_block


# ---------------------------------------------------------------------------
# the slice as a whole: a narrow VGG-16 trained one step in bf16
# ---------------------------------------------------------------------------

LAYERS = vgg16_layers(width_div=8)[:5]       # 8, 8, 16, 16, 32; two stride 2
N_CLASSES = 5


def test_narrow_vgg16_bf16_step_matches_the_jax_model_under_bf16():
    assert [s for _, _, s in LAYERS].count(2) == 2
    jmodel = jconv.BlockedCNN(convs=tuple(
        jconv.BlockedConv2D(ci, co, stride=s, padding="SAME",
                            activation="relu", lane=8)
        for ci, co, s in LAYERS), n_classes=N_CLASSES)
    rng = np.random.default_rng(0)
    specs = jmodel.specs()
    tree = {}
    for i, (ci, _, _) in enumerate(LAYERS):
        s = specs[f"conv{i}"]
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) * np.sqrt(2.0 / (9 * ci)))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    tree["head"] = rng.normal(size=specs["head"].shape).astype(np.float32)
    batch = {"images": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
             "targets": rng.integers(0, N_CLASSES, 4).astype(np.int32)}
    jloss_fn = jtrainstep.make_loss_fn(
        jmodel, None, jtrainstep.TrainSettings(context=JSTREAM_BF16))
    (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})

    model = BlockedCNN([BlockedConv2D(ci, co, stride=s, padding="SAME",
                                      activation="relu", lane=8,
                                      device="cpu")
                        for ci, co, s in LAYERS], N_CLASSES, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    before = (dict(dck.LAUNCHES), dict(stk.LAUNCHES))
    loss, _ = make_loss_fn(model, ConvContext(precision="bf16", stream=True))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert (dict(dck.LAUNCHES), dict(stk.LAUNCHES)) == before
    assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl))
    for name, p in model.named_parameters():
        parts = name.split(".")
        want = (np.asarray(jg[f"conv{parts[1]}"][parts[2]])
                if parts[0] == "convs" else np.asarray(jg["head"]))
        assert p.grad.dtype == torch.float32       # the f32 masters' grads
        _close_to_max(p.grad.numpy(), want, BF16_TOL)


def test_bf16_training_saves_bf16_operands_and_returns_master_dtypes():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 1, 6, 6, 8)).astype(np.float32))
    x.requires_grad_()
    w = torch.from_numpy((rng.normal(size=(2, 1, 3, 3, 8, 8)) / 8)
                         .astype(np.float32)).requires_grad_()
    b = torch.zeros((2, 8), requires_grad=True)
    r = torch.from_numpy(rng.normal(size=(2, 2, 6, 6, 8)).astype(np.float32))
    r.requires_grad_()
    out = direct_conv2d_blocked(x, w, b, 1, "SAME", "gelu", residual=r,
                                precision="bf16", stream=True)
    assert out.dtype == torch.bfloat16
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16] * 3
    out.float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == r.grad.dtype \
        == torch.float32
    # the residual's cotangent is the bf16 g, up-cast
    np.testing.assert_array_equal(r.grad.numpy(), np.ones(r.shape))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

FP16 = Precision(operand="float16", residual="float16")


@pytest.mark.parametrize("stream", [False, True])
def test_fp16_training_raises(stream):
    w = torch.zeros((1, 1, 3, 3, 8, 8), requires_grad=True)
    with pytest.raises(NotImplementedError, match="f32 policy and BF16"):
        direct_conv2d_blocked(torch.zeros((1, 1, 6, 6, 8)), w, None, 1,
                              "SAME", "relu", precision=FP16, stream=stream)
    with pytest.raises(NotImplementedError, match="float16"):
        direct_conv2d_dgrad(torch.zeros((1, 1, 6, 6, 8)), w.detach(), (6, 6),
                            1, "SAME", precision=FP16)


def test_cpu_tensors_never_reach_a_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU tensor reached the build of {name}")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(dck, "library", refuse)
    x, w, z, g, spec = _operands(6, 2, 8, 8, 6, 8, 8, 1, "SAME")
    for stream in (False, True):
        direct_conv2d_dgrad(_tb(g), _tb(w), (6, 6), 1, "SAME", _tb(z),
                            "relu", stream=stream, precision="bf16")
        direct_conv2d_wgrad(_tb(x), _tb(g), 3, 3, 1, "SAME", _tb(z), "relu",
                            True, stream=stream, precision="bf16")
        wt = torch.from_numpy(w).requires_grad_()
        direct_conv2d_blocked(torch.from_numpy(x), wt, None, 1, "SAME",
                              "relu", precision="bf16",
                              stream=stream).float().sum().backward()
        assert wt.grad is not None


# ---------------------------------------------------------------------------
# the bf16 dgrad's scripts: its parts A/B and chip_smoke.py's SASS count
# ---------------------------------------------------------------------------

def test_dgrad_parts_ab_parses_its_layers_flags_and_edits():
    # launch/dgrad_parts_ab.py: VGG-16's 12 dgrad layers (3x3, batch 8),
    # then two MobileNet pointwise legs (1x1, batch 32); its edits name
    # this tree's sources
    from repro_torch.kernels._build import CSRC
    from repro_torch.launch import dgrad_parts_ab as ab
    from repro_torch.launch import dgrad_tiles_ab
    layers = ab.layers()
    assert [name for name, *_ in layers[:12]] == dgrad_tiles_ab.NAMES[1:]
    assert [(n, f) for _, n, *_, f in layers] == [(8, 3)] * 12 + [(32, 1)] * 2
    assert set(ab.VARIANTS) == {"whole", "no_wgmma", "no_copy"}
    for edits in ab.VARIANTS.values():
        for name, old, new in edits:
            assert (CSRC / name).read_text().count(old) == 1, (name, old)
            assert new != old
    assert ab.main(["--dtype", "bf16"]) == 1       # no CUDA device here
    with pytest.raises(SystemExit):
        ab.main(["--dtype", "f32"])


SASS_EXCERPT = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117dgrad_kernel_bf16ILi128EEEvPK13__nv_bf16
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0a10*/                   WARPGROUP.ARRIVE ;
        /*0a20*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0a30*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0a40*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
        /*0a50*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\tFunction : _ZN12_GLOBAL__N_112dgrad_kernelILi64EEEvPKf
        /*0100*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   HGMMA.64x64x8.F32.TF32 R24, R16, gdesc[UR4], R24 ;
        /*0120*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
"""


def test_chip_smoke_counts_wgmmas_and_their_waits_in_sass():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_sass", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counts = smoke.sass_counts(SASS_EXCERPT)
    assert counts == {
        "_ZN12_GLOBAL__N_117dgrad_kernel_bf16ILi128EEEvPK13__nv_bf16":
            (2, 0, 2),
        "_ZN12_GLOBAL__N_112dgrad_kernelILi64EEEvPKf": (1, 1, 1)}
    assert smoke.BF16_DGRAD_KERNEL in next(iter(counts))
    assert smoke.sass_counts("") == {}
