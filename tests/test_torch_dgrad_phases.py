"""The phase split of the CUDA dgrad kernels (``csrc/dgrad_tile.cuh``) on the
CPU: its geometry (``core.blocking.dgrad_phase_axes``, ``dgrad_tiles``),
the plain phase-split dgrad built on it (``direct_conv_dgrad_phased``), and
the kernels' own tile arithmetic written out in numpy, each against
``jax.vjp`` of the reference's ``direct_conv_blocked``.  f32 on both sides,
``rtol = atol = 1e-5``: at most 9 * Co = 144 products of O(1) terms per
element, summed in other orders."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.direct_conv import direct_conv_blocked as jax_direct_conv  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core.conv2d_common import cotangent_prologue  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_dgrad_blocked, direct_conv_dgrad_phased,
    direct_conv_preactivation)
from repro_torch.core.padding import normalize_padding  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-5}

# (n, ci, co, h, w, cib, cob, stride, padding, activation)
CASES = [
    (2, 4, 8, 8, 8, 4, 8, 1, "SAME", "relu"),
    (2, 4, 8, 8, 8, 4, 8, 2, "SAME", "gelu"),        # pads (0, 1)
    (2, 8, 8, 9, 7, 4, 4, 2, "SAME", "relu"),        # odd extents
    (2, 3, 8, 11, 11, 3, 8, 2, "SAME", "gelu"),      # Cib = 3, odd
    (2, 3, 16, 10, 9, 3, 16, 1, "SAME", None),       # Cib = 3
    (2, 4, 8, 10, 10, 4, 8, 2, "VALID", "relu"),     # rows past the extents
    (1, 4, 12, 9, 11, 4, 12, 1, "VALID", "gelu"),    # Cob % 8 != 0
    (1, 4, 4, 7, 9, 4, 4, 1, ((2, 0), (0, 1)), "relu"),
    # Cob % 4 != 0: the kernels' cp.async path (zero fill past Cob)
    (1, 4, 12, 9, 8, 4, 6, 1, "SAME", "relu"),      # Cob = 6, two Co blocks
    (2, 4, 6, 9, 8, 4, 6, 2, "SAME", "relu"),       # Cob = 6, pads (0, 1)
    (2, 8, 5, 8, 7, 4, 5, 1, "SAME", "relu"),       # Cob = 5
    (1, 4, 10, 11, 9, 4, 5, 2, "SAME", "relu"),     # Cob = 5, odd extents
]


def _operands(seed, n, ci, co, h, w, cib, cob, stride, padding):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci // cib, h, w, cib)).astype(np.float32)
    wt = (rng.normal(size=(co // cob, ci // cib, 3, 3, cib, cob))
          / np.sqrt(9 * ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=(co // cob, cob))).astype(np.float32)
    z = direct_conv_preactivation(torch.from_numpy(x), torch.from_numpy(wt),
                                  stride, padding, torch.from_numpy(b))
    g = rng.normal(size=tuple(z.shape)).astype(np.float32)
    return x, wt, b, z, g


def _jax_dx(x, wt, b, g, stride, padding, act):
    def f(x_):
        return jax_direct_conv(x_, jnp.asarray(wt), stride, padding,
                               jnp.asarray(b), act)
    _, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("f,stride,pad", [
    (3, 1, 1), (3, 2, 0), (3, 2, 1), (3, 2, 2), (3, 3, 1), (3, 4, 0),
    (5, 2, 2), (1, 2, 0), (2, 2, 1), (7, 3, 3)])
def test_phase_taps_partition_the_filter_and_the_rows(f, stride, pad):
    extent = 13
    axes = blocking.dgrad_phase_axes(extent, f, stride, pad)
    assert [a.phase for a in axes] == list(range(stride))
    taps = sorted(a.phase + stride * t for a in axes for t in range(a.taps))
    assert taps == list(range(f))          # every tap in exactly one phase
    rows = sorted(a.first + stride * i for a in axes
                  for i in range(a.extent))
    assert rows == list(range(extent))     # every dx row in exactly one
    for a in axes:
        for i in range(a.extent):
            row = a.first + stride * i
            assert (row + pad) % stride == a.phase
            for t in range(a.taps):
                dh = a.phase + stride * t
                # the tap reads the cotangent row the forward wrote there
                assert (row + pad - dh) % stride == 0
                assert (row + pad - dh) // stride == a.q0 + i - t
            # and no other tap of the filter divides
            others = [dh for dh in range(f)
                      if (row + pad - dh) % stride == 0]
            assert others == [a.phase + stride * t for t in range(a.taps)]


@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act", CASES)
def test_phased_dgrad_matches_jax_vjp(n, ci, co, h, w, cib, cob, stride,
                                      padding, act):
    x, wt, b, z, g = _operands(3, n, ci, co, h, w, cib, cob, stride,
                               padding)
    want = _jax_dx(x, wt, b, g, stride, padding, act)
    zz = z if act is not None else None
    got = direct_conv_dgrad_phased(torch.from_numpy(g),
                                   torch.from_numpy(wt), (h, w), stride,
                                   padding, zz, act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same function as the unsplit plain version
    plain = direct_conv_dgrad_blocked(torch.from_numpy(g),
                                      torch.from_numpy(wt), (h, w), stride,
                                      padding, zz, act)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def _tile_dgrad(dz, wt, hw, stride, pads, blk, streamed):
    """The kernels' own arithmetic in numpy: per CTA (``dgrad_tiles``) the
    window origin ``q0 + a0 - (T - 1)``, its ``hwin x wwin`` cells (zero
    outside the map), and per tile position p and phase tap (th, tw) the
    cell ``(p / tw + T_h - 1 - th, p % tw + T_w - 1 - tw)``, summed over
    the chunks of every Co block; rows past the phase extents not stored."""
    n, coblk, ho, wo, cob = dz.shape
    _, ciblk, hf, wf, cib, _ = wt.shape
    hi, wi = hw
    mh, mw = -(-hf // stride), -(-wf // stride)
    kpad = -(-cob // 8) * 8
    dzp = np.zeros(dz.shape[:4] + (kpad,), np.float64)
    dzp[..., :cob] = dz
    wp = np.zeros(wt.shape[:5] + (kpad,), np.float64)
    wp[..., :cob] = wt
    dx = np.full((n, ciblk, hi, wi, cib), np.nan)
    for r, c, a0, b0 in blocking.dgrad_tiles(blk, hi, wi, hf, wf, stride,
                                             pads):
        o_h, o_w = r.q0 + a0 - (mh - 1), c.q0 + b0 - (mw - 1)
        win = np.zeros((n, coblk, blk.hwin, blk.wwin, kpad))
        for rr in range(blk.hwin):
            for cc in range(blk.wwin):
                if 0 <= o_h + rr < ho and 0 <= o_w + cc < wo:
                    win[:, :, rr, cc] = dzp[:, :, o_h + rr, o_w + cc]
        # the window kernel's warpgroup c holds rows q = 64c + (0..63) of
        # its one m-tile; the streamed kernel's holds rows q = 0..63 of
        # m-tile (strip) c: position mt * mstride + q where q < mstride
        mtiles = blk.strips if streamed else 1
        qs = 64 if streamed else 64 * blk.wgs
        positions = [mt * blk.mstride + q for mt in range(mtiles)
                     for q in range(qs) if q < blk.mstride]
        assert sorted(p for p in positions if p < blk.th * blk.tw) == list(
            range(blk.th * blk.tw))
        for p in range(blk.th * blk.tw):
            a, bb = a0 + p // blk.tw, b0 + p % blk.tw
            acc = np.zeros((n, ciblk, cib))
            for th in range(r.taps):
                for tw in range(c.taps):
                    cell = win[:, :, p // blk.tw + mh - 1 - th,
                               p % blk.tw + mw - 1 - tw]
                    dh, dw = r.phase + stride * th, c.phase + stride * tw
                    for c0 in range(0, kpad, blk.chunk):
                        acc += np.einsum(
                            "nok,obck->nbc", cell[..., c0:c0 + blk.chunk],
                            wp[:, :, dh, dw, :, c0:c0 + blk.chunk])
            if a < r.extent and bb < c.extent:
                dx[:, :, r.first + stride * a, c.first + stride * bb] = acc
    return dx


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n,ci,co,h,w,cib,cob,stride,padding,act",
                         [CASES[i] for i in (1, 2, 3, 5, 6, 8, 9, 10, 11)])
def test_kernel_tile_arithmetic_matches_jax_vjp(streamed, n, ci, co, h, w,
                                                cib, cob, stride, padding,
                                                act):
    x, wt, b, z, g = _operands(5, n, ci, co, h, w, cib, cob, stride,
                               padding)
    want = _jax_dx(x, wt, b, g, stride, padding, act)
    dz = cotangent_prologue(torch.from_numpy(g), z if act else None,
                            act).numpy()
    pads = normalize_padding(padding, 3, 3, stride, h, w)
    choose = (blocking.choose_stream_dgrad_blocking if streamed
              else blocking.choose_dgrad_blocking)
    # the chosen tiles, and small ones that overhang the phases' edges
    blks = [choose(n, h, w, 3, 3, stride, ci // cib, cib, cob,
                   prologue=act is not None)]
    for rows, tw in ((1, 3), (2, 1)):
        # streamed: strips of `rows` phase rows; window: a 2x taller tile
        th = rows * blks[0].strips if streamed else 2 * rows
        blks.append(dataclasses.replace(
            blks[0], th=th, tw=tw, chunk=8, hwin=th + -(-3 // stride) - 1,
            wwin=tw + -(-3 // stride) - 1,
            mstride=rows * tw if streamed else blks[0].mstride))
    for blk in blks:
        got = _tile_dgrad(dz, wt, (h, w), stride, pads, blk, streamed)
        assert not np.isnan(got).any()      # every dx position written once
        np.testing.assert_allclose(got, want, **TOL, err_msg=str(blk))


@pytest.mark.parametrize("hi,ci,co,stride", [
    (224, 64, 64, 1), (224, 64, 128, 2), (112, 128, 128, 1),
    (112, 128, 256, 2), (56, 256, 256, 1), (56, 256, 512, 2),
    (28, 512, 512, 1), (28, 512, 512, 2), (14, 512, 512, 1), (11, 3, 16, 2)])
def test_phase_work_equals_the_function_and_tiles_cover_it(hi, ci, co,
                                                           stride):
    # the phases' positions x reachable taps are the forward's MACs: no
    # stride hole is executed, and the grid's tiles cover every position
    spec_h = -(-hi // stride)
    pads = normalize_padding("SAME", 3, 3, stride, hi, hi)
    axes = [blocking.dgrad_phase_axes(hi, 3, stride, pads[i][0])
            for i in range(2)]
    work = sum(r.extent * c.extent * r.taps * c.taps
               for r in axes[0] for c in axes[1])
    assert work == spec_h * spec_h * 9 or hi % stride    # the forward's
    cib, cob = min(ci, 128), min(co, 128)
    for choose in (blocking.choose_dgrad_blocking,
                   blocking.choose_stream_dgrad_blocking):
        blk = choose(8, hi, hi, 3, 3, stride, ci // cib, cib, cob,
                     prologue=True)
        covered = np.zeros((hi, hi), int)
        for r, c, a0, b0 in blocking.dgrad_tiles(blk, hi, hi, 3, 3, stride,
                                                 pads):
            for p in range(blk.th * blk.tw):
                a, b = a0 + p // blk.tw, b0 + p % blk.tw
                if a < r.extent and b < c.extent:
                    covered[r.first + stride * a, c.first + stride * b] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("hi,ci,co,stride", [
    (224, 64, 64, 1), (224, 64, 128, 2), (56, 256, 512, 2), (28, 512, 512, 2),
    (14, 512, 512, 1), (11, 3, 16, 2), (9, 8, 12, 2)])
def test_dgrad_plan_counts_the_phases_and_what_the_tiles_issue(hi, ci, co,
                                                                stride):
    # the plan's MACs are the phases' (positions x reachable taps), and its
    # issued MACs are their three products over whole m-tiles, lanes and k8
    # slices: what the tiles leave of the m-tile rows, of the lanes past
    # Cib and of the channels past Cob is its padding share
    n = 8
    pads = normalize_padding("SAME", 3, 3, stride, hi, hi)
    axes = [blocking.dgrad_phase_axes(hi, 3, stride, pads[i][0])
            for i in range(2)]
    work = sum(r.extent * c.extent * r.taps * c.taps
               for r in axes[0] for c in axes[1])
    cib, cob = min(ci, 128), min(co, 128)
    ciblk, coblk = ci // cib, co // cob
    for choose in (blocking.choose_dgrad_blocking,
                   blocking.choose_stream_dgrad_blocking):
        blk = choose(n, hi, hi, 3, 3, stride, ciblk, cib, cob, prologue=True)
        plan = blocking.dgrad_plan(blk, n, hi, hi, 3, 3, stride, pads, ciblk,
                                   cib, coblk, cob)
        tiles = blocking.dgrad_tiles(blk, hi, hi, 3, 3, stride, pads)
        assert plan.tiles == len(tiles)
        assert plan.function_macs == n * ci * co * work
        live = sum(r.taps * c.taps * min(blk.th, r.extent - a0)
                   * min(blk.tw, c.extent - b0) for r, c, a0, b0 in tiles)
        assert live == work                 # each position's taps once
        m_rows = (sum(r.taps * c.taps for r, c, _, _ in tiles)
                  * blocking.DGRAD_ROWS * blk.wgs)
        kpad = -(-cob // 8) * 8
        assert plan.issued_macs == (3 * n * ciblk * coblk * m_rows
                                    * blk.lanes * kpad)
        assert 1 - plan.padding_share == pytest.approx(
            live / m_rows * cib / blk.lanes * cob / kpad)


def test_dgrad_tiles_ab_times_the_chosen_tile_first():
    # launch/dgrad_tiles_ab.py: VGG-16's 12 dgrad layers, each route's
    # candidates led by the chooser's tile, every consumer count among them
    from repro_torch.launch import dgrad_tiles_ab as ab
    layers = ab.dgrad_layers()
    assert [name for name, *_ in layers] == ab.NAMES[1:]
    assert sum(s == 2 for _, _, _, s, _ in layers) == 4
    for name, ci, co, s, h in layers:
        cib, cob = min(ci, 128), min(co, 128)
        for streamed, choose in ((False, blocking.choose_dgrad_blocking),
                                 (True, blocking.choose_stream_dgrad_blocking)):
            tiles = ab.tile_candidates(8, ci, co, s, h, streamed, 4, 1)
            assert tiles[0][1] == choose(8, h, h, 3, 3, s, ci // cib, cib,
                                         cob, prologue=True)
            assert len({b for _, b in tiles}) == len(tiles)
            assert {b.wgs for _, b in tiles} == ({2, 3} if streamed
                                                 else {1, 2, 3})


# (th, tw, wgs, chunk) that the window and streamed choosers take at each of
# VGG-16's dgrads (batch 8, 224x224 entry, relu prologue), each with its
# time over the fastest candidate's in `python -m
# repro_torch.launch.dgrad_tiles_ab` on an H100 80GB HBM3 at 700 W: summed,
# 5.329 ms window and 6.602 ms streamed against 5.177 and 6.487 for the
# fastest tile measured at each layer.  A change to the cost model that
# moves a tile shows here; time it with that script before repinning.
CHOSEN_DGRAD_TILES = {
    "conv1_2": ((23, 8, 3, 16), 1.034, (9, 21, 3, 16), 1.000),
    "conv2_1": ((16, 8, 2, 32), 1.005, (6, 23, 3, 32), 1.018),
    "conv2_2": ((16, 8, 2, 8), 1.090, (12, 14, 3, 8), 1.007),
    "conv3_1": ((14, 12, 3, 16), 1.097, (12, 15, 3, 16), 1.084),
    "conv3_2": ((19, 7, 3, 8), 1.002, (12, 14, 3, 8), 1.007),
    "conv3_3": ((19, 7, 3, 8), 1.009, (12, 14, 3, 8), 1.011),
    "conv4_1": ((14, 10, 3, 16), 1.000, (12, 15, 3, 16), 1.094),
    "conv4_2": ((14, 7, 2, 8), 1.046, (8, 14, 2, 8), 1.000),
    "conv4_3": ((14, 7, 2, 8), 1.046, (8, 14, 2, 8), 1.000),
    "conv5_1": ((14, 7, 2, 16), 1.000, (14, 7, 2, 16), 1.000),
    "conv5_2": ((7, 7, 1, 8), 1.000, (14, 6, 2, 8), 1.000),
    "conv5_3": ((7, 7, 1, 8), 1.000, (14, 6, 2, 8), 1.000),
}


def test_dgrad_choosers_take_the_tiles_timed_on_the_card():
    from repro_torch.launch.dgrad_tiles_ab import dgrad_layers
    got = {}
    for name, ci, co, s, h in dgrad_layers():
        cib, cob = min(ci, 128), min(co, 128)
        tiles = [choose(8, h, h, 3, 3, s, ci // cib, cib, cob, prologue=True)
                 for choose in (blocking.choose_dgrad_blocking,
                                blocking.choose_stream_dgrad_blocking)]
        got[name] = tuple((b.th, b.tw, b.wgs, b.chunk) for b in tiles)
    assert got == {name: (w, st) for name, (w, _, st, _)
                   in CHOSEN_DGRAD_TILES.items()}


def test_dgrad_choosers_raise_smem_misfit_on_a_small_block():
    small = dataclasses.replace(blocking.H100_SXM, smem_block=4096)
    with pytest.raises(blocking.SmemMisfitError, match="no dgrad tile fits"):
        blocking.choose_dgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 64, small)
    with pytest.raises(blocking.SmemMisfitError,
                       match="no streamed dgrad tile fits"):
        blocking.choose_stream_dgrad_blocking(1, 8, 8, 3, 3, 1, 1, 64, 64,
                                              small)
    with pytest.raises(blocking.SmemMisfitError, match="widest wgmma"):
        blocking.choose_dgrad_blocking(1, 8, 8, 3, 3, 1, 1, 256, 64)
