"""Grouped (``Cig > 1``) and dilated geometry on the dense window backward.

The port's dgrad and wgrad of such geometry against ``jax.vjp`` of the
reference's jnp oracle (``repro.core.direct_conv.direct_conv_blocked(groups=,
dilation=)``) and of ``conv_lax`` (XLA's own convolution), on the same numpy
inputs: the plain versions (``direct_conv_dgrad_blocked``,
``direct_conv_wgrad_blocked``), the phase-split twin
(``direct_conv_dgrad_phased``, the numpy-level statement of what the CUDA
dgrads compute), the wrappers' CPU paths (``direct_conv2d_dgrad``,
``direct_conv2d_wgrad``, which run the window choosers as on the card) and
``nn.conv.BlockedConv2D`` under autograd.  f32 within 1e-5 of max|grad|;
under ``BF16`` the operands are rounded to bf16 first and the port's bf16
path is held to the reference's f32 ``vjp`` within one bf16 ulp of each
element plus 1e-5 of max (dw and db stay f32).

Also: a narrow two-tower AlexNet's one training step against
``jax.value_and_grad`` of the reference's ``BlockedCNN``; the dilated phase
rule written out in numpy (each phase's taps and the cotangent row of each)
against a brute-force enumeration and against the phase-split twin; the
backward choosers at every AlexNet layer and DeepLab-LargeFOV's dilated
shapes; ``route_stream`` asking the backward's window models.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.context import ConvContext as JContext  # noqa: E402
from repro.core.conv_baselines import conv_lax  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro.train.trainstep import (TrainSettings,  # noqa: E402
                                   make_loss_fn as jax_loss_fn)
from repro_torch.configs.cnn import alexnet_blocked, alexnet_layers  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core.context import ConvContext  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.direct_conv import (  # noqa: E402
    direct_conv_dgrad_blocked, direct_conv_dgrad_phased,
    direct_conv_preactivation, direct_conv_wgrad_blocked)
from repro_torch.kernels.direct_conv2d import (  # noqa: E402
    direct_conv2d_blocked, direct_conv2d_dgrad, direct_conv2d_wgrad)
from repro_torch.nn.conv import BlockedConv2D  # noqa: E402
from repro_torch.train.trainstep import make_loss_fn  # noqa: E402

# (name, n, ci, co, h, w, filter, stride, padding, groups, dilation, lane):
# the geometries of tests/test_torch_grouped_dilated.py's CASES on smaller
# maps, a dilation 2 at stride 2 with VALID pads (gcd(d, s) 2: half the
# phases take no tap), and AlexNet's conv1 geometry (11x11 at stride 4)
CASES = [
    ("conv2", 1, 16, 32, 9, 9, 5, 2, ((1, 1), (1, 1)), 2, 1, 128),
    ("g4d2", 1, 8, 12, 8, 8, 3, 1, "SAME", 4, 2, 128),
    ("d2", 1, 4, 8, 12, 12, 3, 1, "SAME", 1, 2, 128),
    ("g2d2s2", 1, 16, 16, 11, 11, 3, 2, "SAME", 2, 2, 8),
    ("d3s2", 1, 16, 24, 11, 10, 3, 2, "SAME", 1, 3, 8),
    ("d12", 1, 8, 8, 27, 25, 3, 1, "SAME", 1, 12, 8),
    ("g2d2s2v", 1, 8, 8, 12, 12, 3, 2, "VALID", 2, 2, 4),
    ("conv1", 1, 3, 16, 23, 23, 11, 4, "VALID", 1, 1, 16),
]
IDS = [c[0] for c in CASES]
# the twins against the jnp oracle (whose taps JAX dispatches one by one):
# relu at every case but conv1's 121 taps, which is held to conv_lax, and
# gelu at two
TWIN_CASES = ([(c, "relu") for c in CASES]
              + [(c, "gelu") for c in CASES if c[0] in ("g2d2s2", "d12")])


def _close(got, want, bf16):
    """f32: within 1e-5 of max|want|; bf16: one bf16 ulp of each element's
    magnitude plus 1e-5 of max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 1e-5 * np.abs(want).max()
    if bf16:
        mag = np.maximum(np.abs(want), 1e-30)
        bound = np.exp2(np.floor(np.log2(mag)) - 7) + bound
    excess = np.abs(got - want) / bound
    assert (excess <= 1).all(), float(excess.max())


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _case(seed, n, ci, co, h, w, f, groups, lane, bf16=False):
    """Numpy NHWC images, grouped HWIO weights and a bias with their blocked
    forms (rounded to bf16 first where ``bf16``)."""
    rng = np.random.default_rng(seed)
    cig = ci // groups
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(f, f, cig, co)) / np.sqrt(f * f * cig)).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    if bf16:
        x, wt, b = _bf16(x), _bf16(wt), _bf16(b)
    lay = L.BlockedConvLayout.choose(ci, co, lane, groups=groups)
    xb = L.nhwc_to_blocked(torch.from_numpy(x), lay.cb_in)
    wb = L.hwio_to_blocked(torch.from_numpy(wt), lay.cb_weight, lay.cb_out)
    bb = torch.from_numpy(b).reshape(-1, lay.cb_out)
    return x, wt, b, lay, xb, wb, bb


def _reference(xb, wb, bb, g, stride, pad, act, groups, dil):
    """``jax.vjp`` of the reference's oracle: ``(y, dx, dw, db)`` on the
    blocked layouts, ``y = act(conv + b)``."""
    def fn(x_, w_, b_):
        return jax_conv(x_, w_, stride, pad, b_, act, groups=groups,
                        dilation=dil)
    y, vjp = jax.vjp(fn, jnp.asarray(xb.numpy()), jnp.asarray(wb.numpy()),
                     jnp.asarray(bb.numpy()))
    dx, dw, db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    return np.asarray(y), dx, dw, db


def _lax_reference(x, wt, b, g, lay, stride, pad, act, groups, dil):
    """``jax.vjp`` of ``act(conv_lax(x, w) + b)`` (XLA's convolution, NHWC
    and HWIO) at the blocked cotangent ``g`` -> ``(dx, dw, db)`` on the
    blocked layouts of ``lay``."""
    acts = {"relu": lambda v: jnp.maximum(v, 0.0),
            "gelu": lambda v: jax.nn.gelu(v, approximate=True)}

    def fn(x_, w_, b_):
        return acts[act](conv_lax(x_, w_, stride, pad, groups, dil) + b_)
    g_nhwc = L.blocked_to_nhwc(torch.from_numpy(np.asarray(g))).numpy()
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    dx, dw, db = (torch.from_numpy(np.array(t)) for t in vjp(
        jnp.asarray(g_nhwc)))
    return (L.nhwc_to_blocked(dx, lay.cb_in).numpy(),
            L.hwio_to_blocked(dw, lay.cb_weight, lay.cb_out).numpy(),
            db.reshape(-1, lay.cb_out).numpy())


@pytest.mark.parametrize(
    "case,act", TWIN_CASES, ids=[f"{c[0]}-{a}" for c, a in TWIN_CASES])
def test_twins_and_wrappers_match_jax_vjp(case, act):
    name, n, ci, co, h, w, f, stride, pad, groups, dil, lane = case
    x, wt, b, lay, xb, wb, bb = _case(0, n, ci, co, h, w, f, groups, lane)
    spec = ConvSpec.make(n, h, w, ci, co, f, f, stride, pad, groups, dil)
    rng = np.random.default_rng(1)
    g = rng.normal(size=(n, co // lay.cb_out, spec.ho, spec.wo,
                         lay.cb_out)).astype(np.float32)
    z = direct_conv_preactivation(xb, wb, stride, pad, bb, groups, dil)
    if name == "conv1":
        dx_ref, dw_ref, db_ref = _lax_reference(x, wt, b, g, lay, stride,
                                                pad, act, groups, dil)
    else:
        y_ref, dx_ref, dw_ref, db_ref = _reference(xb, wb, bb, g, stride,
                                                   pad, act, groups, dil)
        from repro_torch.core.conv2d_common import apply_activation
        _close(apply_activation(z, act).numpy(), y_ref, False)
    gt = torch.from_numpy(g)
    dx = direct_conv_dgrad_blocked(gt, wb, (h, w), stride, pad, z, act,
                                   groups, dil)
    _close(dx.numpy(), dx_ref, False)
    phased = direct_conv_dgrad_phased(gt, wb, (h, w), stride, pad, z, act,
                                      groups, dil)
    _close(phased.numpy(), dx_ref, False)
    dw, db = direct_conv_wgrad_blocked(xb, gt, f, f, stride, pad, z, act,
                                       True, groups, dil)
    _close(dw.numpy(), dw_ref, False)
    _close(db.numpy(), db_ref, False)
    # the wrappers' CPU paths (the window choosers run as on the card) are
    # the plain versions bit for bit
    assert torch.equal(direct_conv2d_dgrad(gt, wb, (h, w), stride, pad, z,
                                           act, groups=groups,
                                           dilation=dil), dx)
    wdw, wdb = direct_conv2d_wgrad(xb, gt, f, f, stride, pad, z, act, True,
                                   groups=groups, dilation=dil)
    assert torch.equal(wdw, dw) and torch.equal(wdb, db)
    if act == "relu":                 # XLA's own conv, linear, NHWC
        dz = torch.from_numpy(g) * (z > 0)
        lin_dx = direct_conv_dgrad_blocked(dz, wb, (h, w), stride, pad,
                                           groups=groups, dilation=dil)
        lin_dw, _ = direct_conv_wgrad_blocked(xb, dz, f, f, stride, pad,
                                              groups=groups, dilation=dil)
        dz_nhwc = L.blocked_to_nhwc(dz, co).numpy()
        _, vjp = jax.vjp(lambda x_, w_: conv_lax(x_, w_, stride, pad, groups,
                                                 dil),
                         jnp.asarray(x), jnp.asarray(wt))
        lax_dx, lax_dw = (np.asarray(t) for t in vjp(jnp.asarray(dz_nhwc)))
        _close(L.blocked_to_nhwc(lin_dx, ci).numpy(), lax_dx, False)
        _close(L.blocked_to_hwio(lin_dw).numpy(), lax_dw, False)


@pytest.mark.parametrize(
    "name,n,ci,co,h,w,f,stride,pad,groups,dil,lane", CASES, ids=IDS)
def test_layer_under_autograd_matches_jax_vjp(name, n, ci, co, h, w, f,
                                              stride, pad, groups, dil,
                                              lane):
    xn, wt, b, lay, xb, wb, bb = _case(2, n, ci, co, h, w, f, groups, lane)
    conv = BlockedConv2D(ci, co, f, f, stride, pad, "relu", groups=groups,
                         dilation=dil, lane=lane, device="cpu")
    conv.load_state_dict({"w": wb, "b": bb})
    x = xb.clone().requires_grad_(True)
    y = conv(x)
    g = np.random.default_rng(3).normal(size=tuple(y.shape)).astype(
        np.float32)
    y.backward(torch.from_numpy(g))
    dx_ref, dw_ref, db_ref = _lax_reference(xn, wt, b, g, lay, stride, pad,
                                            "relu", groups, dil)
    _close(x.grad.numpy(), dx_ref, False)
    _close(conv.w.grad.numpy(), dw_ref, False)
    _close(conv.b.grad.numpy(), db_ref, False)


@pytest.mark.parametrize(
    "name,n,ci,co,h,w,f,stride,pad,groups,dil,lane", CASES, ids=IDS)
def test_bf16_backward_matches_the_f32_vjp_of_rounded_operands(
        name, n, ci, co, h, w, f, stride, pad, groups, dil, lane):
    xn, wt, b, lay, xb, wb, bb = _case(4, n, ci, co, h, w, f, groups, lane,
                                       bf16=True)
    spec = ConvSpec.make(n, h, w, ci, co, f, f, stride, pad, groups, dil)
    g = _bf16(np.random.default_rng(5).normal(
        size=(n, co // lay.cb_out, spec.ho, spec.wo, lay.cb_out)))
    dx_ref, dw_ref, db_ref = _lax_reference(xn, wt, b, g, lay, stride, pad,
                                            "relu", groups, dil)
    bf = torch.bfloat16
    # the bf16 training path's z: the f32 sum rounded once to bf16 (relu'
    # reads its sign, which the rounding keeps)
    z = direct_conv_preactivation(xb.to(bf), wb.to(bf), stride, pad, bb,
                                  groups, dil, precision="bf16")
    assert z.dtype == bf
    z32 = direct_conv_preactivation(xb, wb, stride, pad, bb, groups, dil)
    np.testing.assert_array_equal(np.sign(z.float().numpy()),
                                  np.sign(z32.numpy()))
    gt = torch.from_numpy(g).to(bf)
    dx = direct_conv2d_dgrad(gt, wb.to(bf), (h, w), stride, pad, z, "relu",
                             precision="bf16", groups=groups, dilation=dil)
    assert dx.dtype == bf
    _close(dx.float().numpy(), dx_ref, True)
    dw, db = direct_conv2d_wgrad(xb.to(bf), gt, f, f, stride, pad, z, "relu",
                                 True, precision="bf16", groups=groups,
                                 dilation=dil)
    assert dw.dtype == db.dtype == torch.float32
    _close(dw.numpy(), dw_ref, False)
    _close(db.numpy(), db_ref, False)


# ---------------------------------------------------------------------------
# a narrow two-tower AlexNet, one step against the reference's BlockedCNN
# ---------------------------------------------------------------------------

WIDTH_DIV, LANE, N_CLASSES = 4, 16, 10


def _leaves(tree):
    return {f"{k}.{kk}" if isinstance(v, dict) else k: np.asarray(vv)
            for k, v in tree.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}


def test_narrow_alexnet_step_gradients_match_jax():
    jconvs = tuple(jconv.BlockedConv2D(ci, co, f, f, stride=s, padding=pad,
                                       activation="relu", groups=g,
                                       lane=LANE)
                   for ci, co, f, s, pad, g in alexnet_layers(WIDTH_DIV))
    jmodel = jconv.BlockedCNN(convs=jconvs, n_classes=N_CLASSES)
    rng = np.random.default_rng(6)
    specs = jmodel.specs()
    tree = {}
    for i in range(len(jmodel.convs)):
        s = specs[f"conv{i}"]
        fan = np.prod(s["w"].shape[1:5])
        tree[f"conv{i}"] = {
            "w": (rng.normal(size=s["w"].shape) * np.sqrt(2.0 / fan))
            .astype(np.float32),
            "b": (0.05 * rng.normal(size=s["b"].shape)).astype(np.float32)}
    tree["head"] = (rng.normal(size=specs["head"].shape) / 8).astype(
        np.float32)
    images = rng.normal(size=(2, 67, 67, 3)).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, size=2).astype(np.int32)
    loss_j = jax_loss_fn(jmodel, None,
                         TrainSettings(context=JContext(impl="jnp")))
    (want_loss, _), want = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {"images": jnp.asarray(images), "targets": jnp.asarray(targets)})
    model = alexnet_blocked(N_CLASSES, WIDTH_DIV, lane=LANE, device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    loss, _ = make_loss_fn(model)({"images": torch.from_numpy(images),
                                   "targets": torch.from_numpy(targets)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {("head" if k == "head" else
            "conv{}.{}".format(*k.split(".")[1:])): p.grad.numpy()
           for k, p in model.named_parameters()}
    want = _leaves(want)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the dilated phase rule in numpy
# ---------------------------------------------------------------------------

def _rule(ph, extent, f, s, pad, d):
    """The phase rule written out: ``(first, rows, taps, row of each)`` of
    phase ``ph``: its taps are the ``dh`` with ``dh d = ph (mod s)``, none
    where ``gcd(d, s)`` does not divide ``ph``, else every ``s / g``-th
    from the least; tap ``t`` reads cotangent row ``q0 + a - (d / g) t``."""
    g = math.gcd(d, s)
    first = (ph - pad) % s
    rows = list(range(first, extent, s))
    if ph % g:
        return first, rows, [], [[] for _ in rows]
    tap0 = next(k for k in range(s // g) if k * d % s == ph)
    taps = list(range(tap0, f, s // g))
    q0 = (first + pad - tap0 * d) // s
    return first, rows, taps, [[q0 + a - (d // g) * t for t in range(
        len(taps))] for a in range(len(rows))]


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_phase_rule_matches_brute_force_and_the_axes(s, d):
    extent = 23
    for f in (1, 3, 5, 11):
        for pad in sorted({0, 1, (f - 1) * d // 2}):
            axes = blocking.dgrad_phase_axes(extent, f, s, pad, d)
            seen = []
            for ph, ax in enumerate(axes):
                first, rows, taps, qrows = _rule(ph, extent, f, s, pad, d)
                assert (ax.first, ax.extent, ax.taps) == (first, len(rows),
                                                          len(taps))
                assert [ax.tap0 + ax.tstep * t for t in range(ax.taps)] \
                    == taps
                for a, i in enumerate(rows):
                    # brute force: every (i, dh) whose division is exact
                    want = [(dh, (i + pad - dh * d) // s) for dh in range(f)
                            if (i + pad - dh * d) % s == 0]
                    assert [(dh, q) for dh, q in zip(taps, qrows[a])] == want
                    assert [ax.q0 + a - ax.qstep * t
                            for t in range(ax.taps)] == qrows[a]
                    seen.append(i)
            assert sorted(seen) == list(range(extent))
            # the most taps a phase takes and the window's reach
            assert max(ax.taps for ax in axes) == blocking.dgrad_max_taps(
                f, s, d)


def _numpy_phased(dz, wt, hw, s, pads, d):
    """The phase-split dgrad by ``_rule`` in numpy, one dense block: dz
    ``[Ho, Wo, Co]``, wt ``[Hf, Wf, Ci, Co]`` -> dx ``[Hi, Wi, Ci]``."""
    hi, wi = hw
    ho, wo, _ = dz.shape
    hf, wf, ci, _ = wt.shape
    dx = np.zeros((hi, wi, ci))
    for ph in range(s):
        fr, rows, tr, qr = _rule(ph, hi, hf, s, pads[0], d)
        for pw in range(s):
            fc, cols, tc, qc = _rule(pw, wi, wf, s, pads[1], d)
            for a, i in enumerate(rows):
                for b, j in enumerate(cols):
                    for th, dh in enumerate(tr):
                        for tw, dw in enumerate(tc):
                            q, r = qr[a][th], qc[b][tw]
                            if 0 <= q < ho and 0 <= r < wo:
                                dx[i, j] += wt[dh, dw] @ dz[q, r]
    return dx


@pytest.mark.parametrize("f", [1, 3, 5])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_numpy_phase_split_matches_the_phased_twin(s, d, f):
    hi = 15
    pads = ((1, 2), (2, 1))
    spec = ConvSpec.make(1, hi, hi, 2, 2, f, f, s, pads, 1, d)
    rng = np.random.default_rng(s * 100 + d * 10 + f)
    dz = rng.normal(size=(spec.ho, spec.wo, 2))
    wt = rng.normal(size=(f, f, 2, 2))
    want = _numpy_phased(dz, wt, (hi, hi), s, (1, 2), d)
    got = direct_conv_dgrad_phased(
        torch.from_numpy(dz)[None, None], torch.from_numpy(wt)[None, None],
        (hi, hi), s, pads, dilation=d)
    np.testing.assert_allclose(got[0, 0].numpy(), want, rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# choosers and routing
# ---------------------------------------------------------------------------

def _backward_shapes():
    """AlexNet's backward layers at batch 8 (the dgrad of conv2-5, the wgrad
    of conv1-5, with the pencils ``alexnet_blocked`` gives them) and
    DeepLab-LargeFOV's conv5 (dilation 2) and fc6 (dilation 12) at 41x41:
    ``(name, spec, cib, cob, dgrad)``."""
    model = alexnet_blocked(device="cpu")
    out, h = [], 227
    for i, conv in enumerate(model.convs):
        spec = conv.spec(8, h, h)
        out.append((f"alexnet.conv{i + 1}", spec, conv.in_pencil,
                    conv.out_pencil, i > 0))
        h = spec.ho
    for name, co, d in (("deeplab.conv5", 512, 2), ("deeplab.fc6", 1024, 12)):
        out.append((name, ConvSpec.make(8, 41, 41, 512, co, 3, 3, 1, "SAME",
                                        1, d), 128, 128, True))
    return out


@pytest.mark.parametrize("op_bytes", [4, 2])
def test_backward_choosers_fit_alexnet_and_deeplab(op_bytes):
    for name, spec, cib, cob, dgrad in _backward_shapes():
        ciblk, coblk = spec.ci // cib, spec.co // cob
        macs = spec.flops() // 2
        wblk = blocking.choose_wgrad_blocking(
            8, spec.ho, spec.wo, spec.hf, spec.wf, spec.stride, ciblk, cib,
            coblk, cob, blocking.H100_SXM, op_bytes == 4, op_bytes,
            spec.groups, spec.dilation)
        wplan = blocking.wgrad_plan(wblk, 8, spec.ho, spec.wo, spec.hf,
                                    spec.wf, spec.stride, ciblk, cib, coblk,
                                    cob, op_bytes == 4, spec.groups,
                                    spec.dilation)
        assert wplan.smem <= 232448, name
        # the grouped MACs: 1 / groups of the dense count
        assert wplan.function_macs == macs, name
        dense = blocking.wgrad_plan(wblk, 8, spec.ho, spec.wo, spec.hf,
                                    spec.wf, spec.stride, ciblk, cib, coblk,
                                    cob, op_bytes == 4, 1, spec.dilation)
        assert dense.function_macs == spec.groups * macs, name
        assert wplan.issued_macs * spec.groups == dense.issued_macs, name
        if not dgrad:
            continue
        dblk = blocking.choose_dgrad_blocking(
            8, spec.hi, spec.wi, spec.hf, spec.wf, spec.stride, ciblk, cib,
            cob, blocking.H100_SXM, op_bytes == 4, op_bytes, spec.dilation)
        dplan = blocking.dgrad_plan(dblk, 8, spec.hi, spec.wi, spec.hf,
                                    spec.wf, spec.stride, spec.pads, ciblk,
                                    cib, coblk, cob, op_bytes, op_bytes == 4,
                                    spec.groups, spec.dilation)
        assert dplan.smem <= 232448, name
        # the phases' (position, reachable tap) pairs, whose cotangent row
        # may lie outside the map (read as zeros), over the group's Co
        (pt, _), (pl, _) = spec.pads
        pairs = [sum(1 for i in range(e) for k in range(f)
                     if (i + p - k * d) % spec.stride == 0)
                 for e, f, p, d in ((spec.hi, spec.hf, pt, spec.dilation[0]),
                                    (spec.wi, spec.wf, pl,
                                     spec.dilation[1]))]
        assert dplan.function_macs == (8 * ciblk * pairs[0] * pairs[1] * cib
                                       * spec.co // spec.groups), name
        if spec.stride == 1 and spec.pads[0] == (spec.hf // 2,) * 2 \
                and spec.dilation == (1, 1):
            assert dplan.function_macs == macs, name
        assert dplan.issued_macs >= dplan.products * dplan.function_macs


def test_dilated_windows_gather_the_bands_the_taps_read():
    # fc6 (dilation 12): the f32 tiles stage only the bands their taps read
    rows, bands, cells = blocking.wgrad_staged(1, 8, 3, 3, 1, (12, 12))
    assert (rows, bands, cells) == (3, 3, 8)
    # a band of 16 columns overlaps the next: the columns stay whole
    assert blocking.wgrad_staged(1, 16, 3, 3, 1, (12, 12)) == (3, 1, 40)
    assert blocking.wgrad_staged(4, 8, 3, 3, 1) == (6, 1, 10)
    assert blocking.dgrad_gathered(3, 3, 1, 12)
    assert blocking.dgrad_rows(3, 3, 1, 12) == 9
    assert blocking.dgrad_rows(3, 3, 1, 1) == 5
    assert not blocking.dgrad_gathered(14, 3, 1, 12)
    # d 2 at stride 2: the taps of a phase are s / g = 1 apart, 1 row apart
    assert blocking.dgrad_tap_steps(2, 2) == (1, 1)
    assert blocking.dgrad_max_taps(3, 2, 2) == 3
    # d 3 at stride 2: as at dilation 1, every other tap, 3 rows apart
    assert blocking.dgrad_tap_steps(2, 3) == (2, 3)


def test_route_stream_asks_the_backward_window_models(monkeypatch):
    spec = ConvSpec.make(8, 27, 27, 64, 64, 3, 3, 1, "SAME", 2, 2)
    calls = []
    for fn in ("choose_dgrad_blocking", "choose_wgrad_blocking"):
        real = getattr(dispatch, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            calls.append((_fn, a))
            return _real(*a, **k)
        monkeypatch.setattr(dispatch, fn, spy)
    for direction in ("fwd", "dgrad", "wgrad"):
        calls.clear()
        assert dispatch.route_stream(direction, spec, 16, 16,
                                     blocking.H100_SXM) is False
        assert [c[0] for c in calls] == ["choose_dgrad_blocking",
                                         "choose_wgrad_blocking"]
        # the dilation and the groups reach the models
        assert calls[0][1][-1] == (2, 2)
        assert calls[1][1][-2:] == (2, (2, 2))
    # a dense spec routes as before, its backward models not asked by fwd
    calls.clear()
    dense = ConvSpec.make(8, 27, 27, 64, 64, 3, 3, 1, "SAME")
    assert dispatch.route_stream("fwd", dense, 16, 16,
                                 blocking.H100_SXM) is False
    assert calls == []

    def misfit(*a, **k):
        raise blocking.SmemMisfitError("the backward does not fit")
    monkeypatch.setattr(dispatch, "choose_wgrad_blocking", misfit)
    with pytest.raises(blocking.SmemMisfitError, match="backward"):
        dispatch.route_stream("fwd", spec, 16, 16, blocking.H100_SXM)
    # a forced stream still raises ValueError
    with pytest.raises(ValueError, match="dense-only"):
        dispatch.resolve_stream(True, None, "dgrad", 2, 2)


def test_tiles_ab_scripts_weigh_the_grouped_and_dilated_layers():
    # launch/{dgrad,wgrad}_tiles_ab.py --grouped: AlexNet's backward layers
    # and DeepLab's two dilated ones, each chooser's tile among the timed
    from repro_torch.launch import dgrad_tiles_ab, wgrad_tiles_ab
    names = [name for name, *_ in dgrad_tiles_ab.grouped_layers()]
    assert names == ["alexnet.conv2", "alexnet.conv3", "alexnet.conv4",
                     "alexnet.conv5", "deeplab.conv5", "deeplab.fc6"]
    names = [name for name, *_ in wgrad_tiles_ab.grouped_layers()]
    assert names == ["alexnet.conv1", "alexnet.conv2", "alexnet.conv3",
                     "alexnet.conv4", "alexnet.conv5", "deeplab.conv5",
                     "deeplab.fc6"]
    for op_bytes in (4, 2):
        for name, spec, cib, cob in dgrad_tiles_ab.grouped_layers():
            tiles = dgrad_tiles_ab.grouped_candidates(spec, cib, cob,
                                                      op_bytes)
            chosen = blocking.choose_dgrad_blocking(
                8, spec.hi, spec.wi, spec.hf, spec.wf, spec.stride,
                spec.ci // cib, cib, cob, blocking.H100_SXM, True, op_bytes,
                spec.dilation)
            assert tiles[0][1] == chosen, name
        for name, spec, cib, cob in wgrad_tiles_ab.grouped_layers():
            tiles = wgrad_tiles_ab.grouped_candidates(spec, cib, cob,
                                                      op_bytes)
            chosen = blocking.choose_wgrad_blocking(
                8, spec.ho, spec.wo, spec.hf, spec.wf, spec.stride,
                spec.ci // cib, cib, spec.co // cob, cob, blocking.H100_SXM,
                op_bytes == 4, op_bytes, spec.groups, spec.dilation)
            assert tiles[0][1] == chosen, name
