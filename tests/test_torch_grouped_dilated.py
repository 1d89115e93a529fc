"""Grouped (``Cig > 1``) and dilated geometry on the dense window forward.

The port's forward of such geometry, against the reference's jnp oracle
(``repro.core.direct_conv.direct_conv_blocked(groups=, dilation=)``) and
``conv_lax`` (XLA's own convolution) on the same numpy inputs: the plain
version (``core.direct_conv.direct_conv_blocked``), the wrapper's CPU path
(``kernels.direct_conv2d.direct_conv2d_blocked``, which runs the window
chooser as on the card), the layer (``nn.conv.BlockedConv2D``) and a narrow
two-tower AlexNet (``configs.cnn.alexnet_blocked``) carried across from the
reference's ``BlockedCNN`` by ``convert.params_from_jax``.  f32 within 1e-5
of max|y|; under ``BF16`` within one bf16 ulp of each element plus 1e-5 of
max|y|.

Also: the bf16 tile's producer map written out in numpy (each dilated tap's
phase plane and offset at stride s, each (co, ci) stage's x and weight
blocks) held against the plain version; the forward choosers at every
AlexNet layer and DeepLab-LargeFOV's dilated shapes; the routing (grouped
or dilated geometry pins the window kernel, a forced stream raises); and
autograd through such a layer, whose gradients are the plain backward's
(tests/test_torch_grouped_dilated_bwd.py holds the backward itself to the
reference).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.context import ConvContext as JContext  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro_torch.configs.cnn import (ALEXNET_LAYERS,  # noqa: E402
                                     alexnet_blocked, alexnet_layers)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core.context import ConvContext  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_blocked, direct_conv_dgrad_blocked,
    direct_conv_preactivation, direct_conv_wgrad_blocked)
from repro_torch.core.dispatch import resolve_stream, route_stream  # noqa: E402
from repro_torch.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked, fwd_launch)
from repro_torch.launch.conv_serve import ConvServer  # noqa: E402
from repro_torch.nn.conv import BlockedConv2D  # noqa: E402
from repro_torch.serve.scheduler import ConvRequest, Outcome  # noqa: E402

# (name, n, ci, co, h, w, filter, stride, padding, groups, dilation, lane)
CASES = [
    # AlexNet's conv2 at width_div 4: groups 2, 5x5, pads (1, 1) at stride 2
    ("conv2", 2, 24, 64, 13, 13, 5, 2, ((1, 1), (1, 1)), 2, 1, 128),
    # tests/test_conv_zoo.py's geometries: groups 4 with dilation 2, and
    # dilation 2 SAME
    ("g4d2", 1, 8, 12, 8, 8, 3, 1, "SAME", 4, 2, 128),
    ("d2", 1, 4, 8, 12, 12, 3, 1, "SAME", 1, 2, 128),
    # dilation at stride 2, even and odd
    ("g2d2s2", 2, 16, 16, 15, 15, 3, 2, "SAME", 2, 2, 8),
    ("d3s2", 2, 16, 24, 15, 14, 3, 2, "SAME", 1, 3, 8),
    # DeepLab-LargeFOV fc6's dilation on a small map
    ("d12", 1, 8, 8, 29, 27, 3, 1, "SAME", 1, 12, 8),
]
IDS = [c[0] for c in CASES]


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _close(got, want, bf16):
    """f32: within 1e-5 of max|want|; bf16: one bf16 ulp of each element's
    magnitude plus 1e-5 of max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    top = np.abs(want).max()
    bound = 1e-5 * top
    if bf16:
        mag = np.maximum(np.abs(want), 1e-30)
        bound = np.exp2(np.floor(np.log2(mag)) - 7) + bound
    excess = np.abs(got - want) / bound
    assert (excess <= 1).all(), float(excess.max())


def _case(seed, n, ci, co, h, w, f, groups, lane):
    """Numpy NHWC images, grouped HWIO weights and a bias, with the layer's
    pencils and their blocked forms."""
    rng = np.random.default_rng(seed)
    cig = ci // groups
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(f, f, cig, co)) / np.sqrt(f * f * cig)).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    lay = L.BlockedConvLayout.choose(ci, co, lane, groups=groups)
    xb = L.nhwc_to_blocked(torch.from_numpy(x), lay.cb_in)
    wb = L.hwio_to_blocked(torch.from_numpy(wt), lay.cb_weight, lay.cb_out)
    bb = torch.from_numpy(b).reshape(-1, lay.cb_out)
    return x, wt, b, lay, xb, wb, bb


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize(
    "name,n,ci,co,h,w,f,stride,pad,groups,dil,lane", CASES, ids=IDS)
def test_twin_wrapper_and_layer_match_the_reference(name, n, ci, co, h, w, f,
                                                    stride, pad, groups, dil,
                                                    lane, prec):
    x, wt, b, lay, xb, wb, bb = _case(0, n, ci, co, h, w, f, groups, lane)
    bf16 = prec == "bf16"
    twin = direct_conv_blocked(xb, wb, stride, pad, bb, "relu", prec, groups,
                               dil)
    want = np.asarray(jax_conv(jnp.asarray(xb.numpy()),
                               jnp.asarray(wb.numpy()), stride, pad,
                               jnp.asarray(bb.numpy()), "relu",
                               precision=prec, groups=groups,
                               dilation=dil).astype(jnp.float32))
    _close(twin.float().numpy(), want, bf16)
    assert twin.dtype == (torch.bfloat16 if bf16 else torch.float32)
    with torch.no_grad():
        wrapped = direct_conv2d_blocked(xb, wb, bb, stride, pad, "relu",
                                        precision=prec, groups=groups,
                                        dilation=dil)
    assert torch.equal(wrapped, twin)
    conv = BlockedConv2D(ci, co, f, f, stride, pad, "relu", groups=groups,
                         dilation=dil, lane=lane, device="cpu")
    assert tuple(conv.w.shape) == tuple(wb.shape)
    conv.load_state_dict({"w": wb, "b": bb})
    with torch.no_grad():
        layered = conv(xb, context=ConvContext(precision=prec))
    assert torch.equal(layered, twin)
    if not bf16:                          # XLA's conv, linear, NHWC
        lin = direct_conv_blocked(xb, wb, stride, pad, None, None,
                                  groups=groups, dilation=dil)
        lax = np.asarray(conv_lax(jnp.asarray(x), jnp.asarray(wt), stride,
                                  pad, groups, dil))
        _close(L.blocked_to_nhwc(lin).numpy(), lax, False)


@pytest.mark.parametrize("name,n,ci,co,h,w,f,stride,pad,groups,dil,lane",
                         CASES, ids=IDS)
def test_gap_on_grouped_and_dilated_geometry(name, n, ci, co, h, w, f,
                                             stride, pad, groups, dil, lane):
    _, _, _, _, xb, wb, bb = _case(1, n, ci, co, h, w, f, groups, lane)
    want = np.asarray(jax_conv(jnp.asarray(xb.numpy()),
                               jnp.asarray(wb.numpy()), stride, pad,
                               jnp.asarray(bb.numpy()), "relu", groups=groups,
                               dilation=dil, gap=True))
    with torch.no_grad():
        got = direct_conv2d_blocked(xb, wb, bb, stride, pad, "relu",
                                    gap=True, groups=groups, dilation=dil)
    _close(got.numpy(), want, False)


# ---------------------------------------------------------------------------
# the bf16 tile's producer map, in numpy
# ---------------------------------------------------------------------------

def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32, as the tensor cores add a k16
    slice's sum into their f32 accumulator."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def tap_place(t: int, d: int, s: int):
    """Where tap ``t`` of a filter row (column) at dilation ``d`` and stride
    ``s`` reads the phase planes (``fwd_tile::bf16::tap_phase``,
    ``tap_shift``): the plane phase ``(t d) % s`` and ``(t d) // s`` plane
    rows (cells) on."""
    return t * d % s, t * d // s


def stage_blocks(o_b: int, i_b: int, coblk: int, ciblk: int, groups: int):
    """The x block and weight block of stage ``i_b`` of output block ``o_b``
    (``fwd_tile::x_block``, the weight's ``o_b * cigblk + i_b``)."""
    cigblk = ciblk // groups
    return o_b // (coblk // groups) * cigblk + i_b, o_b * cigblk + i_b


def _bf16_window_forward(x, wt, b, pads, stride, dil, groups, blk):
    """The window kernel's bf16 build on f32 sums (no epilogue past the bias
    and ReLU): each item's stages over its group's input blocks, the window
    staged as ``s x s`` phase planes of ``pitch`` cells a row, a filter row
    read from its row phase's planes, tap ``(dh, dw)`` from plane
    ``(tap_phase(dh, dil_h), tap_phase(dw, dil_w))`` at its shifts; every
    k16 slice added rounding toward zero."""
    x, wt = _bf16(x), _bf16(wt)
    n, ciblk, hi, wi, cib = x.shape
    coblk, cigblk, hf, wf, _, cob = wt.shape
    (pt, _), (pl, _) = pads
    s, (dh_, dw_) = stride, dil
    ho = (hi + sum(pads[0]) - (hf - 1) * dh_ - 1) // s + 1
    wo = (wi + sum(pads[1]) - (wf - 1) * dw_ - 1) // s + 1
    kpad = -(-cib // 16) * 16
    lanes, chunk, pitch = blk.lanes, blk.chunk, blk.pitch
    assert pitch == blocking.fwd_bf16_pitch(blk.tw, wf, s, chunk, False, dw_)
    lay = blocking.fwd_bf16_layout(blk.th, blk.tw, hf, wf, s, chunk, lanes,
                                   blk.wgs, 1, False, dilation=dil)
    mh = ((hf - 1) * dh_) // s + 1
    prows = blk.th + mh - 1
    cells = lay.window_bytes // (2 * chunk)
    across = -(-wo // blk.tw)
    f = np.arange(64 * blk.wgs)
    a, c = f // pitch, f % pitch
    out = np.full((n, coblk, ho, wo, cob), np.nan, np.float32)
    pad_h, pad_w = s * prows + hi, s * pitch + wi
    xp = np.zeros((n, ciblk, hi + 2 * pad_h, wi + 2 * pad_w, kpad),
                  np.float32)
    xp[:, :, pad_h:pad_h + hi, pad_w:pad_w + wi, :cib] = x
    for i in range(blk.tiles * coblk * blk.nsplit * n):
        tile = i % blk.tiles
        col = i // blk.tiles % (coblk * blk.nsplit)
        img = i // blk.tiles // (coblk * blk.nsplit)
        o_b, split = divmod(col, blk.nsplit)
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        h0, w0 = oh0 * s - pt, ow0 * s - pl
        o0 = split * lanes
        vn = max(0, min(lanes, cob - o0))
        keep = (c < blk.tw) & (a < blk.th) & (oh0 + a < ho) & (ow0 + c < wo)
        acc = np.zeros((len(f), lanes), np.float32)
        for i_b in range(cigblk):
            x_b, w_b = stage_blocks(o_b, i_b, coblk, ciblk, groups)
            assert w_b == o_b * cigblk + i_b
            for c0 in range(0, kpad, chunk):
                win = np.zeros((cells, chunk), np.float32)
                for p in range(s * s):
                    ph, pw = divmod(p, s)
                    rows = pad_h + h0 + ph + s * np.arange(prows)
                    cs = pad_w + w0 + pw + s * np.arange(pitch)
                    plane = xp[img, x_b][rows][:, cs, c0:c0 + chunk]
                    at = p * lay.plane_cells
                    win[at:at + prows * pitch] = plane.reshape(-1, chunk)
                vk = max(0, min(chunk, cib - c0))
                for dh in range(hf):
                    rph, rsh = tap_place(dh, dh_, s)
                    for dw in range(wf):
                        cph, csh = tap_place(dw, dw_, s)
                        shift = ((rph * s + cph) * lay.plane_cells
                                 + rsh * pitch + csh)
                        am = win[f + shift]
                        bm = np.zeros((chunk, lanes), np.float32)
                        bm[:vk, :vn] = wt.reshape(-1, hf, wf, cib, cob)[
                            w_b, dh, dw, c0:c0 + vk, o0:o0 + vn]
                        for k in range(0, chunk, 16):
                            sl = slice(k, k + 16)
                            acc = _add_rz(acc, am[:, sl].astype(np.float64)
                                          @ bm[sl].astype(np.float64))
        oh, ow = oh0 + a[keep], ow0 + c[keep]
        v = np.maximum(acc[keep, :vn] + b[o_b, o0:o0 + vn], np.float32(0))
        assert np.isnan(out[img, o_b, oh, ow, o0:o0 + vn]).all()  # once
        out[img, o_b, oh, ow, o0:o0 + vn] = v
    assert not np.isnan(out).any()
    return torch.from_numpy(out).bfloat16()


def test_tap_places_at_stride_and_dilation():
    # stride 2, dilation 2: every tap in phase 0, one plane row per tap
    assert [tap_place(t, 2, 2) for t in range(3)] == [(0, 0), (0, 1), (0, 2)]
    # stride 2, dilation 3: phases 0, 1, 0 at 0, 1, 3 rows on
    assert [tap_place(t, 3, 2) for t in range(3)] == [(0, 0), (1, 1), (0, 3)]
    # stride 1, dilation 12: one plane, 12 rows a tap
    assert [tap_place(t, 12, 1) for t in range(3)] == [(0, 0), (0, 12),
                                                       (0, 24)]
    # groups 2 of 3 output and 2 input blocks each: block 4 reads x blocks
    # 2, 3 against weight blocks 8, 9
    assert [stage_blocks(4, i, 6, 4, 2) for i in range(2)] == [(2, 8),
                                                               (3, 9)]


@pytest.mark.parametrize("name,n,ci,co,h,w,f,stride,pad,groups,dil,lane", [
    c for c in CASES if c[0] in ("conv2", "g2d2s2", "d3s2", "d12")],
    ids=["conv2", "g2d2s2", "d3s2", "d12"])
def test_bf16_producer_map_matches_the_twin(name, n, ci, co, h, w, f, stride,
                                            pad, groups, dil, lane):
    _, _, _, lay, xb, wb, bb = _case(2, n, ci, co, h, w, f, groups, lane)
    spec = ConvSpec.make(n, h, w, ci, co, f, f, stride, pad, groups, dil)
    # the per-tap tile (at conv2's Cib 12 the chooser takes the narrow rows,
    # which tests/test_torch_narrow_runs.py emulates: held here as well)
    cib, cob = lay.cb_in, lay.cb_out
    per_tap = min(blocking.fwd_candidates(
        n, spec.ho, spec.wo, f, f, stride, spec.cig // cib, cib,
        spec.co // cob, cob, blocking.H100_SXM, False, False, op_bytes=2,
        dilation=spec.dilation, narrow=False), key=lambda kb: kb[0])[1]
    plan = fwd_launch(spec, cib, cob, 1, False, False, blk=per_tap,
                      dtype=torch.bfloat16)
    got = _bf16_window_forward(xb.numpy(), wb.numpy(), bb.numpy(), spec.pads,
                               stride, spec.dilation, groups, plan.blk)
    want = direct_conv_blocked(xb, wb, stride, pad, bb, "relu", "bf16",
                               groups, dil)
    _close(got.float().numpy(), want.float().numpy(), True)
    chosen = fwd_launch(spec, cib, cob, 1, False, False,
                        dtype=torch.bfloat16).blk
    if chosen.narrow:
        from test_torch_narrow_runs import narrow_forward
        got = narrow_forward(xb.numpy(), wb.numpy(), bb.numpy(), None,
                             spec.pads, stride, "relu", False, chosen)
        _close(got.float().numpy(), want.float().numpy(), True)


# ---------------------------------------------------------------------------
# AlexNet, narrow, against the reference's BlockedCNN
# ---------------------------------------------------------------------------

WIDTH_DIV, LANE, N_CLASSES = 4, 16, 10


def _jax_alexnet():
    jconvs = tuple(jconv.BlockedConv2D(ci, co, f, f, stride=s, padding=pad,
                                       activation="relu", groups=g,
                                       lane=LANE)
                   for ci, co, f, s, pad, g in alexnet_layers(WIDTH_DIV))
    return jconv.BlockedCNN(convs=jconvs, n_classes=N_CLASSES)


def _tree(model, seed=0):
    rng = np.random.default_rng(seed)
    specs = model.specs()
    tree = {}
    for i in range(len(model.convs)):
        s = specs[f"conv{i}"]
        fan = np.prod(s["w"].shape[1:5])
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) / np.sqrt(fan))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    tree["head"] = rng.normal(size=specs["head"].shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_narrow_alexnet_served_matches_the_jax_model(prec):
    jmodel = _jax_alexnet()
    tree = _tree(jmodel)
    port = alexnet_blocked(N_CLASSES, WIDTH_DIV, lane=LANE, device="cpu")
    state = params_from_jax(tree, device="cpu")
    # the grouped weights [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob] cross as they
    # lie
    for i, (_, _, _, _, _, g) in enumerate(ALEXNET_LAYERS):
        w = state[f"convs.{i}.w"]
        assert tuple(w.shape) == tuple(port.convs[i].w.shape)
        assert w.shape[1] * w.shape[4] * g == port.convs[i].ci
        np.testing.assert_array_equal(w.numpy(), tree[f"conv{i}"]["w"])
    port.load_state_dict(state)
    rng = np.random.default_rng(1)
    images = rng.normal(size=(3, 67, 67, 3)).astype(np.float32)
    jtree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in tree.items()}
    want = np.asarray(jmodel(jtree, jnp.asarray(images),
                             context=JContext(impl="jnp", precision=prec))
                      .astype(jnp.float32))
    ctx = ConvContext(precision=prec)
    with torch.no_grad():
        direct = port(torch.from_numpy(images), context=ctx)
    server = ConvServer(port, [(67, 67)], 2, device="cpu", context=ctx)
    reqs = [ConvRequest(i, images[i]) for i in range(3)]
    for req in reqs:
        server.submit(req)
    server.run()
    assert all(req.outcome is Outcome.OK for req in reqs)
    got = np.stack([req.logits for req in reqs])
    np.testing.assert_array_equal(got, direct.float().numpy())
    _close(got, want, prec == "bf16")


def test_alexnet_is_the_published_network():
    spec_of = []
    h = 227
    for ci, co, f, s, pad, g in alexnet_layers():
        spec = ConvSpec.make(1, h, h, ci, co, f, f, s, pad, g)
        spec_of.append(spec)
        h = spec.ho
    assert [sp.ho for sp in spec_of] == [55, 27, 13, 13, 13]
    macs = [sp.flops() // 2 for sp in spec_of]
    assert [round(m / 1e6, 1) for m in macs] == [105.4, 223.9, 149.5, 112.1,
                                                 74.8]
    assert round(sum(macs) / 1e6, 1) == 665.8
    model = alexnet_blocked(device="cpu")
    assert [(c.in_pencil, c.out_pencil) for c in model.convs] == [
        (3, 48), (48, 64), (64, 64), (64, 64), (64, 64)]
    # at lane 128 the two towers' pencils do not chain
    with pytest.raises(ValueError, match="pencil mismatch"):
        alexnet_blocked(device="cpu", lane=128)


# ---------------------------------------------------------------------------
# choosers, routing and refusals
# ---------------------------------------------------------------------------

# (n, ho, wo, filter, stride, Cig/Cib, Cib, Co/Cob, Cob, dilation, gap):
# AlexNet's five layers at lane 64, its conv4/conv5 pencils at lane 128
# (Cib 96, Cob 96/128), DeepLab-LargeFOV's conv5 and fc6 (41x41, 321 input
# at output stride 8)
SHAPES = [
    (8, 55, 55, 11, 4, 1, 3, 1, 48, 1, False),
    (8, 27, 27, 5, 2, 1, 48, 4, 64, 1, False),
    (8, 13, 13, 3, 2, 4, 64, 6, 64, 1, False),
    (8, 13, 13, 3, 1, 3, 64, 6, 64, 1, False),
    (8, 13, 13, 3, 1, 3, 64, 4, 64, 1, True),
    (8, 13, 13, 3, 1, 2, 96, 4, 96, 1, False),
    (8, 13, 13, 3, 1, 2, 96, 2, 128, 1, True),
    (8, 41, 41, 3, 1, 4, 128, 4, 128, 2, False),
    (8, 41, 41, 3, 1, 4, 128, 8, 128, 12, False),
]


@pytest.mark.parametrize("op_bytes", [4, 2])
@pytest.mark.parametrize("n,ho,wo,f,s,cigblk,cib,coblk,cob,d,gap", SHAPES)
def test_choosers_fit_alexnet_and_deeplab(n, ho, wo, f, s, cigblk, cib,
                                          coblk, cob, d, gap, op_bytes):
    dil = (d, d)
    blk = blocking.choose_fwd_blocking(n, ho, wo, f, f, s, cigblk, cib,
                                       coblk, cob, blocking.H100_SXM, gap,
                                       op_bytes, dil)
    smem = blocking.fwd_smem_bytes(blk.th, blk.tw, f, f, s, blk.chunk,
                                   blk.lanes, blk.wgs, gap, op_bytes,
                                   blk.strips, dil, blk.frows, blk.narrow,
                                   cib)
    assert smem <= 232448
    # the window counts the dilated reach
    assert blk.hwin == (blk.th - 1) * s + (f - 1) * d + 1
    assert blk.wwin == (blk.tw - 1) * s + (f - 1) * d + 1
    if op_bytes == 2:
        # the bf16 build's planes, or at conv1 the narrow rows: a 128-byte
        # row an output position (tests/test_torch_narrow_runs.py)
        assert blk.narrow == int(blocking.narrow_fits(f, f, cib, dil))
        assert blk.pitch == (blk.tw if blk.narrow
                             else blk.tw + ((f - 1) * d) // s)
        assert blk.frows == 0
    plan = blocking.fwd_plan(blk, n, ho, wo, f, f, s, cigblk, cib, coblk,
                             cob, gap, op_bytes, dil)
    assert plan.function_macs == n * ho * wo * f * f * cigblk * cib * coblk \
        * cob
    assert plan.smem == smem


def test_f32_stages_take_filter_rows_where_all_taps_do_not_fit():
    # AlexNet's conv1: 121 taps' weights a stage exceed a CTA, so a stage
    # takes a divisor of its 11 filter rows
    blk = blocking.choose_fwd_blocking(8, 55, 55, 11, 11, 4, 1, 3, 1, 48)
    assert blk.frows == 1 and blk.stage_rows(11) == 1
    # VGG-16's layers keep every filter row a stage
    assert blocking.choose_fwd_blocking(8, 56, 56, 3, 3, 1, 2, 128, 2,
                                        128).frows == 0
    assert blocking.fwd_smem_bytes(4, 8, 11, 11, 4, 8, 64, 1, frows=1) < \
        blocking.fwd_smem_bytes(4, 8, 11, 11, 4, 8, 64, 1)


def test_grouped_and_dilated_geometry_pins_the_window_kernel():
    for groups, dil in ((2, 1), (1, 2), (4, 2)):
        spec = ConvSpec.make(8, 27, 27, 64, 64, 3, 3, 1, "SAME", groups,
                             dil)
        for d in ("fwd", "dgrad", "wgrad"):
            assert route_stream(d, spec, 16, 16, blocking.H100_SXM) is False
            assert resolve_stream(None, None, d, groups, dil) is False
            with pytest.raises(ValueError, match="dense-only"):
                resolve_stream(True, None, d, groups, dil)
    # a grouped layer's forward misfit still raises
    spec = ConvSpec.make(1, 64, 64, 8, 8, 3, 3, 1, "SAME", 1, 200)
    tiny = blocking.MachineModel("tiny", 256, 8192, smem_block=8192)
    with pytest.raises(blocking.SmemMisfitError):
        route_stream("fwd", spec, 8, 8, tiny)


def test_forced_stream_and_autograd_raise():
    # a forced stream on grouped or dilated geometry still raises, served
    # and trained; autograd itself now runs the grouped and dilated
    # backward, whose gradients are the plain backward's
    _, _, _, _, xb, wb, bb = _case(3, 2, 16, 16, 9, 9, 3, 2, 8)
    with pytest.raises(ValueError, match="dense-only"):
        with torch.no_grad():
            direct_conv2d_blocked(xb, wb, bb, 1, "SAME", "relu", groups=2,
                                  stream=True)
    with pytest.raises(ValueError, match="dense-only"):
        BlockedConv2D(16, 16, groups=2, lane=8, stream=True, device="cpu")
    for kw in (dict(groups=2), dict(groups=2, dilation=2)):
        wg = wb.clone().requires_grad_(True)
        with pytest.raises(ValueError, match="dense-only"):
            direct_conv2d_blocked(xb, wg, bb, 1, "SAME", "relu", stream=True,
                                  **kw)
        y = direct_conv2d_blocked(xb, wg, bb, 1, "SAME", "relu", **kw)
        g = torch.randn_like(y)
        y.backward(g)
        z = direct_conv_preactivation(xb, wb, 1, "SAME", bb, **kw)
        dw, _ = direct_conv_wgrad_blocked(xb, g, 3, 3, 1, "SAME", z, "relu",
                                          **kw)
        torch.testing.assert_close(wg.grad, dw, rtol=0, atol=0)
    conv = BlockedConv2D(16, 16, groups=2, dilation=3, lane=8, device="cpu")
    x = xb.clone().requires_grad_(True)
    conv(x).square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert conv.w.grad.shape == conv.w.shape
    # the plain backward versions take grouped geometry: dx has the map's
    # blocks, dw the group's
    g = torch.randn(2, 2, 9, 9, 8)
    dx = direct_conv_dgrad_blocked(g, wb, (9, 9), 1, "SAME", groups=2)
    dw, _ = direct_conv_wgrad_blocked(xb, g, 3, 3, 1, "SAME", groups=2)
    assert dx.shape == xb.shape and dw.shape == wb.shape


def test_fwd_tiles_ab_weighs_the_grouped_and_dilated_layers():
    # launch/fwd_tiles_ab.py --grouped: AlexNet's five layers and DeepLab's
    # two dilated ones, the chooser's tile first among the timed ones
    from repro_torch.launch import fwd_tiles_ab as ab
    layers = ab.grouped_layers()
    assert [name for name, *_ in layers] == [
        "alexnet.conv1", "alexnet.conv2", "alexnet.conv3", "alexnet.conv4",
        "alexnet.conv5", "deeplab.conv5", "deeplab.fc6"]
    assert [sp.ho for _, sp, _, _ in layers] == [55, 27, 13, 13, 13, 41, 41]
    for _, spec, cib, cob in layers:
        for op_bytes in (4, 2):
            tiles = ab.tile_candidates(8, spec.ci, spec.co, spec.stride,
                                       spec.hi, False, 4, 1, op_bytes, spec,
                                       cib, cob)
            chosen = blocking.choose_fwd_blocking(
                8, spec.ho, spec.wo, spec.hf, spec.wf, spec.stride,
                spec.cig // cib, cib, spec.co // cob, cob, blocking.H100_SXM,
                False, op_bytes, spec.dilation)
            assert tiles[0][1] == chosen and len(tiles) > 1
