"""The depthwise wgrad kernel of ``csrc/conv2d_depthwise.cu``
(``depthwise_wgrad_kernel<kS>``) on the CPU: its walk written out in numpy
as the kernel runs it (columns of (channel block, lane group), each
column's items in contiguous shares, each item's x window staged with zeros
outside the map beside its g and z tiles, dz formed on the staged cells in
a pass, the runs of each position group; at 3x3 stride 1 and 2 the
register order, a row's run with the three tap columns' x in registers, and
the tap loop for every other filter, stride and dilation; the position
groups' sums in group order into the share's row, the rows in split
order), against ``jax.vjp`` of the reference's ``direct_conv_blocked``
(the jnp oracle: the depthwise Pallas kernels do not run in interpret mode
under this jax) and of ``conv_lax``; and the chooser's items at every
MobileNet v1 leg.  The walk sums in f32 as the kernel's FMAs do; against
JAX's f32 VJP ``rtol = atol = 1e-5``: at most a few hundred products of
O(1) terms an element, summed in other orders."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.core.layout import (blocked_to_nhwc as j_unblock,  # noqa: E402
                               nhwc_to_blocked as j_block)
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.conv2d_common import (cotangent_prologue,  # noqa: E402
                                            wgrad_reduce)
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import direct_conv_preactivation  # noqa: E402
from repro_torch.kernels import conv2d_depthwise as dwk  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}
THREADS = blocking.H100_SXM.threads


def _fma(acc, a, w):
    """f32 ``fmaf(a, w, acc)`` over lanes: the exact product and sum,
    rounded once."""
    return (a.astype(np.float64) * w + acc).astype(np.float32)


def _wgrad_walk(x, g, z, hf, wf, stride, pads, dil, act, blk):
    """``depthwise_wgrad_kernel``'s arithmetic in numpy, CTA by CTA ->
    ``(ws, out)`` as the kernel writes them: the workspace ``[splits,
    |dw| + |db|]`` (NaN where no share wrote) and its rows summed in split
    order."""
    n, cblk, hi, wi, cb = x.shape
    _, _, ho, wo, _ = g.shape
    (pt, _), (pl, _) = pads
    s = stride
    variant = blocking.depthwise_dgrad_variant(hf, wf, s, dil)
    L, hob, wob = blk.lanes, blk.hob, blk.wob
    taps = hf * wf
    groups = cb // L
    npg = THREADS // L
    tiles_w = wo // wob
    tiles = (ho // hob) * tiles_w
    segs = min(wob, max(1, -(-npg // hob)))
    run = -(-wob // segs)
    units = hob * segs
    assert blk.per_column == n * tiles
    dw_size = cblk * taps * cb
    cols = dw_size + cblk * cb
    ws = np.full((blk.splits, cols), np.nan, np.float32)
    for column in range(cblk * groups):
        c_b, lane0 = divmod(column, groups)
        lane0 *= L
        for split in range(blk.splits):
            first = blk.per_column * split // blk.splits
            last = blk.per_column * (split + 1) // blk.splits
            acc = np.zeros((npg, taps, L), np.float32)
            db = np.zeros((npg, L), np.float32)
            for it in range(first, last):
                img, tile = divmod(it, tiles)
                i0, j0 = tile // tiles_w * hob, tile % tiles_w * wob
                xw = np.zeros((blk.hwin, blk.wwin, L), np.float32)
                for rr in range(blk.hwin):
                    for cc in range(blk.wwin):
                        r, c = i0 * s - pt + rr, j0 * s - pl + cc
                        if 0 <= r < hi and 0 <= c < wi:
                            xw[rr, cc] = x[img, c_b, r, c, lane0:lane0 + L]
                gt = g[img, c_b, i0:i0 + hob, j0:j0 + wob, lane0:lane0 + L]
                # dz on the staged cells, in a pass
                dz = gt if z is None else cotangent_prologue(
                    torch.from_numpy(np.ascontiguousarray(gt)),
                    torch.from_numpy(np.ascontiguousarray(
                        z[img, c_b, i0:i0 + hob, j0:j0 + wob,
                          lane0:lane0 + L])), act).numpy()
                for pg in range(npg):
                    for u in range(pg, units, npg):
                        i, seg = divmod(u, segs)
                        jb, je = seg * run, min(wob, seg * run + run)
                        if jb >= je:
                            continue
                        if variant:
                            # a[d][e]: tap (d, e)'s x for output j
                            a = [[xw[i * s + d, jb * s + e] for e in range(3)]
                                 for d in range(3)]
                            for j in range(jb, je):
                                if j > jb:
                                    for d in range(3):
                                        row = xw[i * s + d]
                                        a[d] = ([a[d][1], a[d][2], row[j + 2]]
                                                if s == 1 else
                                                [a[d][2], row[2 * j + 1],
                                                 row[2 * j + 2]])
                                dv = dz[i, j]
                                for d in range(3):
                                    for e in range(3):
                                        acc[pg, 3 * d + e] = _fma(
                                            acc[pg, 3 * d + e], a[d][e], dv)
                                db[pg] = (db[pg] + dv).astype(np.float32)
                        else:
                            for j in range(jb, je):
                                dv = dz[i, j]
                                for q in range(taps):
                                    dh, dw_ = divmod(q, wf)
                                    acc[pg, q] = _fma(
                                        acc[pg, q],
                                        xw[i * s + dh * dil[0],
                                           j * s + dw_ * dil[1]], dv)
                                db[pg] = (db[pg] + dv).astype(np.float32)
            # the position groups' sums in group order into the share's row
            red = np.zeros((taps + 1, L), np.float32)
            for pg in range(npg):
                red[:taps] = (red[:taps] + acc[pg]).astype(np.float32)
                red[taps] = (red[taps] + db[pg]).astype(np.float32)
            for q in range(taps):
                at = (c_b * taps + q) * cb + lane0
                ws[split, at:at + L] = red[q]
            at = dw_size + c_b * cb + lane0
            ws[split, at:at + L] = red[taps]
    assert not np.isnan(ws).any()
    # the column's last CTA: the rows in split order
    out = ws[0].copy()
    for k in range(1, blk.splits):
        out = (out + ws[k]).astype(np.float32)
    return ws, out


# (n, c, h, w, cb, stride, padding, dilation, filter, activation)
CASES = [
    (2, 64, 9, 10, 64, 1, "SAME", 1, 3, "relu"),     # lane split
    (2, 16, 8, 8, 16, 2, "SAME", 1, 3, "relu"),      # TF-SAME pads (0, 1)
    (2, 16, 9, 7, 16, 2, "SAME", 1, 3, "gelu"),      # odd: pads (1, 1)
    (1, 128, 7, 7, 128, 1, "SAME", 1, 3, "gelu"),    # 7x7, pencil 128
    (2, 8, 12, 12, 8, 1, "SAME", 2, 3, "gelu"),      # dilation 2
    (2, 12, 9, 9, 6, 2, "SAME", 1, 3, "relu"),       # a pencil of 6
    (1, 6, 9, 9, 3, 2, "VALID", 1, 3, None),         # Cb = 3, VALID
    (2, 8, 10, 10, 8, 1, "SAME", 1, 5, "relu"),      # 5x5
    (2, 8, 11, 11, 8, 3, "SAME", 1, 3, "relu"),      # stride 3
    (2, 32, 14, 14, 32, 2, "SAME", 1, 3, None),      # linear, stride 2
]


def _operands(seed, n, c, h, w, cb, hf, stride, padding, dil):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c // cb, h, w, cb)).astype(np.float32)
    wt = (rng.normal(size=(c // cb, 1, hf, hf, 1, cb)) / hf).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(c // cb, cb))).astype(np.float32)
    z = direct_conv_preactivation(torch.from_numpy(x), torch.from_numpy(wt),
                                  stride, padding, torch.from_numpy(b), c,
                                  dil).numpy()
    g = rng.normal(size=z.shape).astype(np.float32)
    return x, wt, b, z, g


def _blk(n, c, h, w, cb, hf, s, spec, prologue, batch=None):
    """The chooser's items at ``batch`` images, walked over these ``n``."""
    ho, wo = spec.ho, spec.wo
    chosen = blocking.choose_depthwise_wgrad_blocking(
        batch or n, c // cb, ho, wo, cb, hf, hf, s, spec.dilation, prologue)
    per_column = n * (ho // chosen.hob) * (wo // chosen.wob)
    return dataclasses.replace(chosen, per_column=per_column,
                               splits=min(chosen.splits, per_column))


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,hf,act", CASES)
def test_wgrad_walk_matches_jax_vjp_and_lax(n, c, h, w, cb, s, pad, dil, hf,
                                            act):
    spec = ConvSpec.make(n, h, w, c, c, hf, hf, s, pad, groups=c,
                         dilation=dil)
    x, wt, b, z, g = _operands(5, n, c, h, w, cb, hf, s, pad, dil)

    def f(w_, b_):
        return jax_conv(jnp.asarray(x), w_, s, pad, b_, act, groups=c,
                        dilation=dil)
    _, vjp = jax.vjp(f, jnp.asarray(wt), jnp.asarray(b))
    want_w, want_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    zz = z if act else None
    for batch in (n, 8 * n):
        blk = _blk(n, c, h, w, cb, hf, s, spec, act is not None, batch)
        ws, out = _wgrad_walk(x, g, zz, hf, hf, s, spec.pads, spec.dilation,
                              act, blk)
        dw_size = c * hf * hf
        dw = out[:dw_size].reshape(c // cb, hf * hf, cb).reshape(
            c // cb, 1, hf, hf, 1, cb)
        np.testing.assert_allclose(dw, want_w, **TOL, err_msg=str(blk))
        np.testing.assert_allclose(out[dw_size:].reshape(c // cb, cb),
                                   want_b, **TOL, err_msg=str(blk))
        # the fold is the plain in-order reduce of the workspace
        np.testing.assert_array_equal(
            out, wgrad_reduce(torch.from_numpy(ws)).numpy())
    # the bare conv's weight gradient against XLA's grouped convolution
    w_hwio = np.transpose(wt[:, 0, :, :, 0, :], (1, 2, 0, 3)).reshape(
        hf, hf, 1, c)
    _, vjp = jax.vjp(lambda w_: conv_lax(j_unblock(jnp.asarray(x)), w_, s,
                                         pad, groups=c, dilation=dil),
                     jnp.asarray(w_hwio))
    lax = np.asarray(vjp(j_unblock(jnp.asarray(g)))[0])      # [hf, hf, 1, c]
    blk = _blk(n, c, h, w, cb, hf, s, spec, False)
    _, out = _wgrad_walk(x, g, None, hf, hf, s, spec.pads, spec.dilation,
                         None, blk)
    dw = out[:c * hf * hf].reshape(c // cb, hf, hf, cb)
    np.testing.assert_allclose(
        np.transpose(dw, (1, 2, 0, 3)).reshape(hf, hf, 1, c), lax, **TOL)


def test_wgrad_walk_covers_any_share_count():
    # one share a column, or a share an item: the same sums
    n, c, h, cb, s = 2, 16, 8, 16, 1
    spec = ConvSpec.make(n, h, h, c, c, 3, 3, s, "SAME", groups=c)
    x, wt, b, z, g = _operands(3, n, c, h, h, cb, 3, s, "SAME", 1)
    blk = _blk(n, c, h, h, cb, 3, s, spec, True)
    outs = [_wgrad_walk(x, g, z, 3, 3, s, spec.pads, (1, 1), "relu",
                        dataclasses.replace(blk, splits=k))[1]
            for k in (1, blk.per_column)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)


def _legs(entry=224):
    from repro_torch.launch.separable_bwd_ab import mobilenet_legs
    return mobilenet_legs(entry)


@pytest.mark.parametrize("entry", [224, 160])
def test_wgrad_chooser_fits_a_cta_and_covers_every_position(entry):
    # batch 32 and 8 with the relu prologue: tiles dividing the map, every
    # position one item's, every item one share's, the ring and the sums
    # in a CTA's shared memory, every position group busy, about a wave of
    # CTAs, the register path at every leg
    m = blocking.H100_SXM
    for ci, _, s, h in _legs(entry):
        cb = min(ci, 128)
        spec = ConvSpec.make(32, h, h, ci, ci, 3, 3, s, "SAME", groups=ci)
        ho = spec.ho
        for n in (8, 32):
            blk = blocking.choose_depthwise_wgrad_blocking(
                n, ci // cb, ho, ho, cb, 3, 3, s)
            assert ho % blk.hob == 0 and ho % blk.wob == 0
            assert cb % blk.lanes == 0
            assert blk.per_column == n * (ho // blk.hob) * (ho // blk.wob)
            shares = [(blk.per_column * k // blk.splits,
                       blk.per_column * (k + 1) // blk.splits)
                      for k in range(blk.splits)]
            assert shares[0][0] == 0 and shares[-1][1] == blk.per_column
            assert all(a < b for a, b in shares)
            assert all(p[1] == q[0] for p, q in zip(shares, shares[1:]))
            assert (blk.hwin, blk.wwin) == ((blk.hob - 1) * s + 3,
                                            (blk.wob - 1) * s + 3)
            assert blocking.depthwise_wgrad_smem_bytes(
                blk.hwin, blk.wwin, blk.hob, blk.wob, blk.lanes, 9,
                True) <= m.smem_budget
            assert blk.hob * blk.wob >= m.threads // blk.lanes
            columns = blk.columns(ci // cb, cb)
            assert columns <= 65535
            assert blk.splits * columns <= m.wave
            assert blocking.depthwise_dgrad_variant(3, 3, s, (1, 1)) == s


def test_wgrad_plan_is_built_once_a_shape_and_refuses_what_it_cannot_take():
    dwk._wgrad_plan.cache_clear()
    args = ((2, 1, 16, 16, 16), (2, 1, 8, 8, 16), 3, 3, 2, "SAME", 1, 1,
            True, True)
    plan = dwk._wgrad_plan(*args)
    assert plan is dwk._wgrad_plan(*args)
    assert plan.variant == 2 and plan.columns == 16 // plan.blk.lanes
    assert plan.cols == 9 * 16 + 16
    fields = list(plan.ints)
    assert fields[-3:] == [plan.columns, blocking.depthwise_wgrad_smem_bytes(
        plan.blk.hwin, plan.blk.wwin, plan.blk.hob, plan.blk.wob,
        plan.blk.lanes, 9, True), 2]
    assert fields[-6:-3] == [1, 1, 1]      # act, prologue, with_db
    # no prologue: z is not staged, the ring holds x and g alone
    bare = dwk._wgrad_plan(*args[:-2], False, False)
    assert list(bare.ints)[-5:-3] == [0, 0] and bare.cols == 9 * 16
    # items the A/B script times
    other = dataclasses.replace(plan.blk, splits=1)
    assert dwk._wgrad_plan(*args, other).blk.splits == 1
    with pytest.raises(ValueError, match="cotangent"):
        dwk._wgrad_plan((2, 1, 16, 16, 16), (2, 1, 9, 9, 16), *args[2:])
    with pytest.raises(ValueError, match="at most 25 taps"):
        dwk._wgrad_plan((2, 1, 16, 16, 16), (2, 1, 16, 16, 16), 7, 7, 1,
                        "SAME", 1, 1, True, True)


def test_separable_bwd_ab_times_the_chosen_items_first():
    from repro_torch.launch import separable_bwd_ab as ab
    for ci, _, s, h in _legs():
        items = ab.depthwise_wgrad_items(32, ci, s, h)
        cb = min(ci, 128)
        assert items[0] == blocking.choose_depthwise_wgrad_blocking(
            32, ci // cb, -(-h // s), -(-h // s), cb, 3, 3, s)
        assert len(items) == len(set(items)) >= 2
