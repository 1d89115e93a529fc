"""The depthwise dgrad kernel of ``csrc/conv2d_depthwise.cu``
(``depthwise_dgrad_kernel<kS, kAtRead>``) on the CPU: its walk written out
in numpy as the kernel runs it (items of dx over lane splits, each item's
cotangent window staged with zeros outside the map, dz formed on the staged
cells in a pass, the runs of each position group; at 3x3 stride 1 the register order
with the taps turned, at stride 2 the four phases over only their taps, the
tap loop for every other filter, stride and dilation), against
``jax.vjp`` of the reference's ``direct_conv_blocked`` (the jnp oracle: the
depthwise Pallas kernels do not run in interpret mode under this jax) and of
``conv_lax``; and the chooser's items.  The walk sums in f32 as the kernel's
FMAs do; against JAX's f32 VJP ``rtol = atol = 1e-5``: at most 25 products
of O(1) terms a dx element, summed in other orders."""
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
from repro_torch.core.conv2d_common import cotangent_prologue  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import direct_conv_preactivation  # noqa: E402
from repro_torch.kernels import conv2d_depthwise as dwk  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}
THREADS = blocking.H100_SXM.threads


def _fma(acc, a, w):
    """f32 ``fmaf(a, w, acc)`` over lanes: the exact product and sum,
    rounded once."""
    return (a.astype(np.float64) * w + acc).astype(np.float32)


def _dgrad_walk(g, z, wt, hi, wi, stride, pads, dil, act, blk):
    """``depthwise_dgrad_kernel``'s arithmetic in numpy, item by item ->
    dx.  Unwritten cells stay NaN and every cell must be written once."""
    n, cblk, ho, wo, cb = g.shape
    hf, wf = wt.shape[2:4]
    (pt, _), (pl, _) = pads
    dh_, dw_ = dil
    s = stride
    variant = blocking.depthwise_dgrad_variant(hf, wf, s, dil)
    lanes, hob, wob = blk.lanes, blk.hob, blk.wob
    tiles_w = wi // wob
    tiles = (hi // hob) * tiles_w
    groups = cb // lanes
    npg = THREADS // lanes
    parts = 2 if variant == 2 else 1
    per_row = -(-wob // 2) if variant == 2 else wob
    segs = min(per_row, max(1, -(-npg // (parts * hob))))
    units = hob * parts * segs
    dx = np.full((n, cblk, hi, wi, cb), np.nan, np.float32)
    writes = np.zeros(dx.shape[:4] + (groups,), int)
    assert blk.items == n * cblk * groups * tiles
    for it in range(blk.items):
        tile, rest = it % tiles, it // tiles
        lane0, m = rest % groups * lanes, rest // groups
        img, c_b = divmod(m, cblk)
        i0, j0 = tile // tiles_w * hob, tile % tiles_w * wob
        r0 = (i0 + pt - (hf - 1) * dh_) // s
        c0 = (j0 + pl - (wf - 1) * dw_) // s
        gw = np.zeros((blk.hwin, blk.wwin, lanes), np.float32)
        zw = np.zeros_like(gw)
        for rr in range(blk.hwin):
            for cc in range(blk.wwin):
                q, c = r0 + rr, c0 + cc
                if 0 <= q < ho and 0 <= c < wo:
                    gw[rr, cc] = g[img, c_b, q, c, lane0:lane0 + lanes]
                    if z is not None:
                        zw[rr, cc] = z[img, c_b, q, c, lane0:lane0 + lanes]
        # dz on the staged cells, in a pass
        win = (cotangent_prologue(torch.from_numpy(gw), torch.from_numpy(zw),
                                  act).numpy() if z is not None else gw)
        wv = wt[c_b, 0, :, :, 0, lane0:lane0 + lanes].reshape(hf * wf, lanes)

        def out(i, j, acc):
            dx[img, c_b, i0 + i, j0 + j, lane0:lane0 + lanes] = acc
            writes[img, c_b, i0 + i, j0 + j, lane0 // lanes] += 1

        for u in range(units):
            i, rest_u = divmod(u, parts * segs)
            part, seg = divmod(rest_u, segs)
            if variant == 1:
                run = -(-wob // segs)
                jb, je = seg * run, min(wob, seg * run + run)
                if jb >= je:
                    continue
                # a[d][e]: window (i + d, j + e), tap (2 - d, 2 - e)
                a = [[win[i + d, jb + e] for e in range(3)] for d in range(3)]
                for j in range(jb, je):
                    if j > jb:
                        for d in range(3):
                            a[d] = [a[d][1], a[d][2], win[i + d, j + 2]]
                    acc = np.zeros(lanes, np.float32)
                    for d in range(3):
                        for e in range(3):
                            acc = _fma(acc, a[d][e], wv[8 - (3 * d + e)])
                    out(i, j, acc)
            elif variant == 2:
                ut, v0 = i0 + i + pt, j0 + pl
                jf = (part - v0) & 1
                count = (wob - jf + 1) // 2 if jf < wob else 0
                run = -(-count // segs)
                k0, k1 = seg * run, min(count, seg * run + run)
                wr, wc = (ut >> 1) - r0, ((v0 + jf) >> 1) - c0
                # row taps: dh 0 at wr and dh 2 at wr - 1 (ut even), dh 1
                # (odd); columns likewise by the part
                rows = [(0, wr), (2, wr - 1)] if ut % 2 == 0 else [(1, wr)]
                cols = [(0, 0), (2, -1)] if part == 0 else [(1, 0)]
                for k in range(k0, k1):
                    acc = np.zeros(lanes, np.float32)
                    for dh, rr in rows:
                        for dw, off in cols:
                            acc = _fma(acc, win[rr, wc + k + off],
                                       wv[3 * dh + dw])
                    out(i, jf + 2 * k, acc)
            else:
                run = -(-wob // segs)
                ah = i0 + i + pt - s * r0
                for j in range(seg * run, min(wob, seg * run + run)):
                    aw = j0 + j + pl - s * c0
                    acc = np.zeros(lanes, np.float32)
                    for q in range(hf * wf):
                        uh = ah - q // wf * dh_
                        uw = aw - q % wf * dw_
                        if uh % s == 0 and uw % s == 0:
                            acc = _fma(acc, win[uh // s, uw // s], wv[q])
                    out(i, j, acc)
    assert (writes == 1).all()
    return dx


# (n, c, h, w, cb, stride, padding, dilation, filter, activation)
CASES = [
    (1, 64, 9, 10, 64, 1, "SAME", 1, 3, "relu"),     # lane split
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


@pytest.mark.parametrize("n,c,h,w,cb,s,pad,dil,hf,act", CASES)
def test_dgrad_walk_matches_jax_vjp_and_lax(n, c, h, w, cb, s, pad, dil, hf,
                                            act):
    spec = ConvSpec.make(n, h, w, c, c, hf, hf, s, pad, groups=c,
                         dilation=dil)
    x, wt, b, z, g = _operands(5, n, c, h, w, cb, hf, s, pad, dil)
    _, vjp = jax.vjp(lambda x_: jax_conv(x_, jnp.asarray(wt), s, pad,
                                         jnp.asarray(b), act, groups=c,
                                         dilation=dil), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    zz = z if act else None
    prologue = act is not None
    for batch in (n, 8 * n):
        chosen = blocking.choose_depthwise_dgrad_blocking(
            batch, c // cb, h, w, cb, hf, hf, s, spec.dilation, spec.pads,
            prologue)
        # the items a batch of `batch` takes, walked over these n images
        blk = dataclasses.replace(
            chosen, items=n * c // chosen.lanes * (h // chosen.hob)
            * (w // chosen.wob))
        got = _dgrad_walk(g, zz, wt, h, w, s, spec.pads, spec.dilation, act,
                          blk)
        np.testing.assert_allclose(got, want, **TOL, err_msg=str(blk))
    # the bare conv's input gradient against XLA's grouped convolution
    w_hwio = np.transpose(wt[:, 0, :, :, 0, :], (1, 2, 0, 3)).reshape(
        hf, hf, 1, c)
    _, vjp = jax.vjp(lambda x_: conv_lax(x_, jnp.asarray(w_hwio), s, pad,
                                         groups=c, dilation=dil),
                     j_unblock(jnp.asarray(x)))
    lax = np.asarray(j_block(vjp(j_unblock(jnp.asarray(g)))[0], cb))
    blk = blocking.choose_depthwise_dgrad_blocking(
        n, c // cb, h, w, cb, hf, hf, s, spec.dilation, spec.pads, False)
    np.testing.assert_allclose(
        _dgrad_walk(g, None, wt, h, w, s, spec.pads, spec.dilation, None,
                    blk), lax, **TOL)


def test_dgrad_phases_run_only_their_taps():
    # 3x3 at stride 2: the four phases run 2x2, 2x1, 1x2 and 1x1 taps, 9 a
    # 2x2 block of dx, whatever the pads; stride 1 and the tap loop run all
    for pads in (((0, 1), (0, 1)), ((1, 1), (1, 1)), ((1, 0), (0, 1))):
        assert blocking.depthwise_dgrad_taps(112, 112, 3, 3, 2, (1, 1),
                                             pads) == (4, 112 * 112 * 9 // 4)
    # 7 rows at pads (1, 1): i + 1 even at 3 rows (2 taps), odd at 4 (1)
    assert blocking.depthwise_dgrad_taps(7, 7, 3, 3, 2, (1, 1),
                                         ((1, 1), (1, 1))) == (
                                             4, (3 * 2 + 4 * 1) ** 2)
    assert blocking.depthwise_dgrad_taps(56, 56, 3, 3, 1, (1, 1),
                                         ((1, 1), (1, 1))) == (1, 56 * 56 * 9)
    assert blocking.depthwise_dgrad_taps(9, 9, 5, 5, 2, (1, 1),
                                         ((2, 2), (2, 2))) == (1, 81 * 25)
    assert [blocking.depthwise_dgrad_variant(3, 3, s, d) for s, d in (
        (1, (1, 1)), (2, (1, 1)), (3, (1, 1)), (1, (2, 2)))] == [1, 2, 0, 0]
    assert blocking.depthwise_dgrad_variant(5, 5, 1, (1, 1)) == 0


def _legs(entry=224):
    from repro_torch.launch.separable_bwd_ab import mobilenet_legs
    return mobilenet_legs(entry)


@pytest.mark.parametrize("entry", [224, 160])
def test_dgrad_chooser_walks_every_mobilenet_leg(entry):
    # batch 32 and 8 with the relu prologue: every dx cell one item's, the
    # card filled with resident CTAs, two windows of g and z in the budget,
    # the windows within the bound of the cotangent cells a tile can read
    m = blocking.H100_SXM
    for ci, _, s, h in _legs(entry):
        cb = min(ci, 128)
        spec = ConvSpec.make(32, h, h, ci, ci, 3, 3, s, "SAME", groups=ci)
        for n in (8, 32):
            blk = blocking.choose_depthwise_dgrad_blocking(
                n, ci // cb, h, h, cb, 3, 3, s, (1, 1), spec.pads, True)
            assert h % blk.hob == 0 and h % blk.wob == 0
            assert blk.items == n * ci // blk.lanes * (h // blk.hob) * (
                h // blk.wob)
            assert blk.grid == min(blk.items, m.wave)
            assert blocking.depthwise_dgrad_smem_bytes(
                blk.hwin, blk.wwin, blk.lanes, True) <= m.smem_budget
            assert (blk.hwin, blk.wwin) == blocking.depthwise_dgrad_window(
                blk.hob, blk.wob, h, h, 3, 3, s, (1, 1), spec.pads)
            bound = blocking.dgrad_window(blk.hob, blk.wob, 3, 3, s)
            assert blk.hwin <= bound[0] and blk.wwin <= bound[1]
            if s == 1:
                assert (blk.hwin, blk.wwin) == (blk.hob + 2, blk.wob + 2)


def test_dgrad_plan_is_built_once_a_shape_and_refuses_what_it_cannot_take():
    dwk._dgrad_plan.cache_clear()
    args = ((2, 1, 8, 8, 16), (1, 1, 3, 3, 1, 16), (16, 16), 2, "SAME", 1,
            1, True)
    plan = dwk._dgrad_plan(*args)
    assert plan is dwk._dgrad_plan(*args)
    assert plan.variant == 2 and plan.dx_shape == (2, 1, 16, 16, 16)
    fields = list(plan.ints)
    assert fields[-4:] == [1, plan.blk.grid,
                           blocking.depthwise_dgrad_smem_bytes(
                               plan.blk.hwin, plan.blk.wwin, plan.blk.lanes,
                               True), 2]
    # no prologue: z is not staged, the ring holds g alone
    bare = dwk._dgrad_plan(*args[:-1], False)
    assert list(bare.ints)[-4] == 0 and list(bare.ints)[-2] * 2 == \
        blocking.depthwise_dgrad_smem_bytes(bare.blk.hwin, bare.blk.wwin,
                                            bare.blk.lanes, True)
    with pytest.raises(ValueError, match="cotangent"):
        dwk._dgrad_plan((2, 1, 9, 9, 16), *args[1:])
    with pytest.raises(ValueError, match="at most 25 taps"):
        dwk._dgrad_plan((2, 1, 16, 16, 16), (1, 1, 7, 7, 1, 16), (16, 16),
                        1, "SAME", 1, 1, True)
