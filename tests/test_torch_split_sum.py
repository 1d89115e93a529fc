"""The split sums folded into the kernels that write their rows
(``csrc/split_sum.cuh``), written out in numpy: every CTA of a column
stores its row, then arrives once on the column's counter; the CTA that
arrives last sums the column's rows in index order and sets the counter
back to 0.

Under every arrival order (of up to 6 rows, every permutation; at the
split counts the choosers take at VGG-16's and MobileNet's layers, seeded
random orders) the emulation must give bits identical to
``conv2d_common.wgrad_reduce`` / ``gap_finalize`` of the same rows, find
every row stored when it sums, and leave the counter at 0.  The folded
wgrad's dw and db are held against ``jax.vjp`` of the reference's jnp
oracle, its pooled features against the oracle's GAP, at ``rtol = atol =
1e-5``."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro_torch.configs.cnn import (MOBILENET_V1_BLOCKS,  # noqa: E402
                                     MOBILENET_V1_CONV1, vgg16_layers)
from repro_torch.core import blocking, conv2d_common  # noqa: E402
from repro_torch.core.direct_conv import (direct_conv_blocked,  # noqa: E402
                                          direct_conv_wgrad_blocked)

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _fold(rows, order, scale=np.float32(1)):
    """The protocol over one column: ``rows [count, length]`` f32, the
    column's CTAs each storing its row and arriving in ``order`` -> ``(out,
    the counter after the launch)``."""
    count, length = rows.shape
    arrivals = len(order)
    stored = np.zeros(count, bool)
    counter = 0
    out = np.full(length, np.nan, np.float32)
    for cta in order:
        stored[cta % count] = True          # its row, then its arrival
        old, counter = counter, counter + 1
        if old == arrivals - 1:             # the last: sum, then reset
            assert stored.all()
            s = rows[0].copy()
            for k in range(1, count):
                s = s + rows[k]
            out = s * scale
            counter = 0
    return out, counter


def _wgrad_reduce(rows):
    return conv2d_common.wgrad_reduce(torch.from_numpy(rows)).numpy()


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5, 6])
def test_every_arrival_order_gives_the_in_order_bits(count):
    rng = np.random.default_rng(count)
    rows = rng.normal(size=(count, 37)).astype(np.float32)
    want = _wgrad_reduce(rows)
    for order in itertools.permutations(range(count)):
        got, counter = _fold(rows, order)
        assert counter == 0
        np.testing.assert_array_equal(got, want)


def _vgg16_wgrad_columns():
    """(splits, columns, column floats) of every VGG-16 wgrad at batch 8,
    both routes, as the wrappers launch them."""
    out, h = [], 224
    for ci, co, s in vgg16_layers():
        cib, cob = min(ci, 128), min(co, 128)
        ho = -(-h // s)
        for choose in (blocking.choose_wgrad_blocking,
                       blocking.choose_stream_wgrad_blocking):
            blk = choose(8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob,
                         prologue=True)
            out.append((blk.splits, blk.groups * (ci // cib) * (co // cob),
                        min(9 * cib, blk.wgs * blk.mpw * 64) * cob))
        h = ho
    return out


def _mobilenet_wgrad_columns():
    """The same for MobileNet v1's wgrads at batch 32: conv1, then each
    block's depthwise and pointwise legs (their rows' floats, db in)."""
    ci0, co0, s0 = MOBILENET_V1_CONV1
    blk = blocking.choose_wgrad_blocking(32, 112, 112, 3, 3, s0, 1, ci0, 1,
                                         co0, prologue=True)
    out, h = [(blk.splits, blk.groups, 9 * ci0 * co0)], 112
    for ci, co, s in MOBILENET_V1_BLOCKS:
        ho = -(-h // s)
        cb, cob = min(ci, 128), min(co, 128)
        dw = blocking.choose_depthwise_wgrad_blocking(32, ci // cb, ho, ho,
                                                      cb, 3, 3, s)
        # the pointwise wgrad: the dense wgrad tile at 1x1
        pw = blocking.choose_wgrad_blocking(32, ho, ho, 1, 1, 1, ci // cb,
                                            cb, co // cob, cob, prologue=True)
        out += [(dw.splits, ci // cb, 9 * cb + cb),
                (pw.splits, pw.groups * (ci // cb) * (co // cob),
                 min(cb, pw.wgs * pw.mpw * 64) * cob)]
        h = ho
    return out


@pytest.mark.parametrize("model", ["vgg16", "mobilenet_v1"])
def test_chooser_splits_fold_to_the_in_order_bits(model):
    cases = (_vgg16_wgrad_columns() if model == "vgg16"
             else _mobilenet_wgrad_columns())
    rng = np.random.default_rng(7)
    for splits in sorted({splits for splits, _, _ in cases}):
        rows = rng.normal(size=(splits, 53)).astype(np.float32)
        got, counter = _fold(rows, rng.permutation(splits))
        assert counter == 0
        np.testing.assert_array_equal(got, _wgrad_reduce(rows))


def test_separable_splits_keep_a_columns_rows_short():
    # the depthwise wgrad: one wave of CTAs, or one CTA an SM where a wave
    # would give the last CTA of a column more than SPLIT_SUM_COLUMN_BYTES
    # of rows to read; the pointwise wgrad (the dense tile at 1x1): the
    # dense chooser, which prices that read, takes at most one CTA an SM
    # over a leg's columns
    m = blocking.H100_SXM
    for k, (splits, columns, floats) in enumerate(
            _mobilenet_wgrad_columns()[1:]):
        if k % 2:
            assert splits * columns <= m.sms
            continue
        assert splits <= -(-m.wave // columns)
        assert (4 * splits * floats <= blocking.SPLIT_SUM_COLUMN_BYTES
                or splits <= -(-m.sms // columns))
    # MobileNet's 64 -> 128 and 128 -> 128 pointwise legs at 56x56, batch
    # 32: one column each, one CTA an SM
    for ci in (64, 128):
        pw = blocking.choose_wgrad_blocking(32, 56, 56, 1, 1, 1, 1, ci, 1,
                                            128, prologue=True)
        assert pw.splits == m.sms and pw.groups == 1
    # the 112x112 depthwise leg: short rows, a whole wave
    dw = blocking.choose_depthwise_wgrad_blocking(32, 1, 112, 112, 32, 3, 3)
    assert dw.splits == m.wave


@pytest.mark.parametrize("tiles,nsplit", [(1, 1), (3, 2), (5, 1)])
def test_gap_fold_gives_the_finalize_bits(tiles, nsplit):
    rng = np.random.default_rng(tiles)
    n, coblk, cob, hw = 2, 3, 6, 49
    parts = rng.normal(size=(n, coblk, tiles, cob)).astype(np.float32)
    want = conv2d_common.gap_finalize(torch.from_numpy(parts), hw).numpy()
    inv = np.float32(1) / np.float32(hw)
    got = np.empty((n, coblk * cob), np.float32)
    for i in range(n):
        for o in range(coblk):
            # the column's CTAs, tiles x lane halves, in any order
            out, counter = _fold(parts[i, o],
                                 list(rng.permutation(tiles * nsplit)),
                                 scale=inv)
            assert counter == 0
            got[i, o * cob:(o + 1) * cob] = out
    np.testing.assert_array_equal(got, want)


def _case(seed, n, ci, co, h, cib, cob, stride):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, h, cib)).astype(np.float32)
    w = (rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
         / np.sqrt(9 * ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("n,ci,co,h,cib,cob,stride", [
    (4, 4, 8, 8, 4, 8, 1),
    (3, 3, 6, 9, 3, 6, 2),          # Cib = 3, Cob = 6, pads (0, 1)
])
def test_folded_wgrad_matches_jax_vjp(n, ci, co, h, cib, cob, stride):
    x, w, b = _case(3, n, ci, co, h, cib, cob, stride)

    def f(w_, b_):
        return jax_conv(jnp.asarray(x), w_, stride, "SAME", b_, "relu")
    z, vjp = jax.vjp(f, jnp.asarray(w), jnp.asarray(b))
    g = np.random.default_rng(4).normal(size=z.shape).astype(np.float32)
    want_dw, want_db = vjp(jnp.asarray(g))
    # one share an image: each row the wgrad of its image, dw then db
    zt = torch.from_numpy(np.array(jax_conv(
        jnp.asarray(x), jnp.asarray(w), stride, "SAME", jnp.asarray(b))))
    rows = []
    for i in range(n):
        dw, db = direct_conv_wgrad_blocked(
            torch.from_numpy(x[i:i + 1]), torch.from_numpy(g[i:i + 1]), 3, 3,
            stride, "SAME", zt[i:i + 1], "relu", with_db=True)
        rows.append(np.concatenate([dw.numpy().ravel(), db.numpy().ravel()]))
    rows = np.stack(rows)
    out, counter = _fold(rows, list(reversed(range(n))))
    assert counter == 0
    np.testing.assert_array_equal(out, _wgrad_reduce(rows))
    np.testing.assert_allclose(out[:w.size].reshape(w.shape),
                               np.asarray(want_dw), **TOL)
    np.testing.assert_allclose(out[w.size:].reshape(b.shape),
                               np.asarray(want_db), **TOL)


def test_folded_gap_matches_the_jnp_oracle():
    x, w, b = _case(5, 2, 8, 12, 8, 4, 6, 1)
    out = direct_conv_blocked(torch.from_numpy(x), torch.from_numpy(w), 1,
                              "SAME", torch.from_numpy(b), "relu")
    parts = conv2d_common.gap_partials(out, 4, 2).numpy()   # 8 tiles
    inv = np.float32(1) / np.float32(64)
    n, coblk, tiles, cob = parts.shape
    got = np.empty((n, coblk * cob), np.float32)
    for i in range(n):
        for o in range(coblk):
            got[i, o * cob:(o + 1) * cob], counter = _fold(
                parts[i, o], list(reversed(range(tiles))), scale=inv)
            assert counter == 0
    want = jax_conv(jnp.asarray(x), jnp.asarray(w), 1, "SAME",
                    jnp.asarray(b), "relu", gap=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
