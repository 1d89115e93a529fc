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
(k16 slices, Cob and the positions padded to 16, the phase split, a fresh
f32 accumulator a stage whose adds round toward zero, added into a running
f32 sum, dz rounded to bf16 as the producer forms it, the ``db`` pass), the
choosers at 2-byte operands at every VGG-16 shape of both routes, and the
refusals (float16 training, no build reached from a CPU tensor).  The
separable families' bf16 training is in ``tests/test_torch_separable_bf16.py``.
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


def _tile_dgrad_bf16(dz, wt, hw, stride, pads, blk, streamed):
    """``dgrad_kernel_bf16`` / ``stream_dgrad_kernel_bf16`` in numpy: per
    CTA the window of bf16 dz (zero outside the map, Cob padded to 16); per
    stage (Co block, chunk of a multiple of 16 channels) a fresh f32
    accumulator that takes each k16 slice's exact sum rounding toward zero,
    tap by tap of the phase, then is added into the running f32 sum; dx the
    sum rounded once to bf16.  -> dx as f32 holding bf16 values."""
    n, coblk, ho, wo, cob = dz.shape
    _, ciblk, hf, wf, cib, _ = wt.shape
    hi, wi = hw
    mh, mw = -(-hf // stride), -(-wf // stride)
    kpad = -(-cob // 16) * 16
    assert blk.chunk % 16 == 0 and kpad % blk.chunk == 0
    dzp = np.zeros(dz.shape[:4] + (kpad,), np.float32)
    dzp[..., :cob] = dz
    wp = np.zeros(wt.shape[:5] + (kpad,), np.float32)
    wp[..., :cob] = wt
    dx = np.full((n, ciblk, hi, wi, cib), np.nan, np.float32)
    for r, c, a0, b0 in blocking.dgrad_tiles(blk, hi, wi, hf, wf, stride,
                                             pads):
        o_h, o_w = r.q0 + a0 - (mh - 1), c.q0 + b0 - (mw - 1)
        win = np.zeros((n, coblk, blk.hwin, blk.wwin, kpad), np.float32)
        for rr in range(blk.hwin):
            for cc in range(blk.wwin):
                if 0 <= o_h + rr < ho and 0 <= o_w + cc < wo:
                    win[:, :, rr, cc] = dzp[:, :, o_h + rr, o_w + cc]
        mtiles = blk.strips if streamed else 1
        qs = 64 if streamed else 64 * blk.wgs
        positions = [mt * blk.mstride + q for mt in range(mtiles)
                     for q in range(qs) if q < blk.mstride]
        assert sorted(p for p in positions if p < blk.th * blk.tw) == list(
            range(blk.th * blk.tw))
        for p in range(blk.th * blk.tw):
            a, bb = a0 + p // blk.tw, b0 + p % blk.tw
            total = np.zeros((n, ciblk, cib), np.float32)
            for o_b in range(coblk):
                for c0 in range(0, kpad, blk.chunk):
                    acc = np.zeros((n, ciblk, cib), np.float32)
                    for th in range(r.taps):
                        for tw in range(c.taps):
                            cell = win[:, o_b, p // blk.tw + mh - 1 - th,
                                       p % blk.tw + mw - 1 - tw]
                            dh = r.phase + stride * th
                            dw = c.phase + stride * tw
                            for k in range(c0, c0 + blk.chunk, 16):
                                acc = _add_rz(acc, np.einsum(
                                    "nk,bck->nbc",
                                    cell[:, k:k + 16].astype(np.float64),
                                    wp[o_b, :, dh, dw, :, k:k + 16]
                                    .astype(np.float64)))
                    total = total + acc
            if a < r.extent and bb < c.extent:
                dx[:, :, r.first + stride * a, c.first + stride * bb] = total
    assert not np.isnan(dx).any()           # every position written once
    return _bf16(dx)


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
    into the running f32 sum; the shares' rows added in split order.
    -> dw."""
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


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride,padding,act", TILE_CASES)
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
    blks.append(dataclasses.replace(
        blks[0], th=th, tw=tw, chunk=16, hwin=th + -(-3 // stride) - 1,
        wwin=tw + -(-3 // stride) - 1,
        mstride=rows * tw if streamed else blks[0].mstride))
    for blk in blks:
        got = _tile_dgrad_bf16(dz, w, (h, h), stride, pads, blk, streamed)
        _bf16_close(got, want)


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
    # a small tile: two rows of 8 (K 16, no padding group), two shares
    small = dataclasses.replace(blk, th=2, tw=8, splits=2,
                                tiles=n * -(-spec.ho // 2)
                                * -(-spec.wo // 8))
    for b in (blk, small):
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
    assert bf.chunk % 16 == 0 and (-(-cob // 16) * 16) % bf.chunk == 0
    assert blocking.dgrad_smem_bytes(
        3, 3, s, bf.lanes, bf.chunk, bf.hwin, bf.wwin, True, streamed,
        2) <= H100_SXM.smem_block
    assert 1 <= bf.wgs <= (2 if bf.lanes == 128 else 3)
    assert bf.th * bf.tw <= 64 * bf.wgs
    assert bf.th * bf.tw * bf.chunk >= f32.th * f32.tw * f32.chunk
    plan = blocking.dgrad_plan(bf, n, h, h, 3, 3, s,
                               ConvSpec.make(n, h, h, ci, co, 3, 3, s,
                                             "SAME").pads,
                               ci // cib, cib, co // cob, cob, 2)
    assert plan.products == 1 and plan.issued_macs >= plan.function_macs


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
