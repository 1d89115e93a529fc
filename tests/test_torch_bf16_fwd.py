"""The bf16 build of the dense forward tile (``csrc/fwd_tile.cuh``,
namespace ``bf16``) on the CPU, and the dense main path served in bf16.

The kernels' arithmetic written out in numpy CTA by CTA, as the window
forward (``fwd_kernel_bf16``) and the streamed one
(``stream_fwd_kernel_bf16``) run it: x, w and the residual rounded to
bf16 once, the halo window staged zero outside the map and past the pencil
(Cib padded to 16), the weight chunk in the interleaved MN-major order the
TMA box lands, each k16 slice's bf16 products added to a stage's f32
accumulator rounded toward zero, each stage's sum added to the running f32
sum, the epilogue (+ f32 bias, activation, + r in f32) rounded once to
bf16, and the GAP of the stored bf16 values in the tile's order
(``conv2d_common.gap_replay``).  Held against the reference's jnp oracle
under ``BF16`` (``direct_conv_blocked(precision=BF16)``): every element
within one bf16 ulp of its magnitude plus 1e-5 of max|y| (the two round
f32 sums of the same bf16 products, taken in other orders, once to bf16).

Also: the precision policy's new fields against the reference's, the
forward choosers at 2-byte operands at every VGG-16 shape (they fit one
CTA and never take less work a stage than at f32), the wrappers' bf16
routes and refusals, and a narrow VGG-16 served in bf16 by ``ConvServer``
against the JAX model under ``BF16`` with the same tolerance.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import precision as jprecision  # noqa: E402
from repro.core.context import ConvContext as JContext  # noqa: E402
from repro.core.direct_conv import direct_conv_blocked as jax_conv  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro_torch.configs.cnn import vgg16_blocked, vgg16_layers  # noqa: E402
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
    """B [K, N] as the TMA box lands it, [N/8][K][8], read back as the
    wgmma descriptor reads it: core matrices of 8 lanes by 8 channels, a
    k16 step's two channel halves 128 bytes apart, the lane groups K * 16
    bytes apart."""
    k, n = b.shape
    flat = b.reshape(k, n // 8, 8).transpose(1, 0, 2).reshape(-1)
    return flat.reshape(n // 8, k, 8).transpose(1, 0, 2).reshape(k, n)


def _act(v, act):
    if act == "relu":
        return np.maximum(v, np.float32(0))
    if act == "gelu":
        v64 = v.astype(np.float64)
        k = np.sqrt(2 / np.pi)
        return (0.5 * v64 * (1 + np.tanh(k * (v64 + 0.044715 * v64 ** 3)))
                ).astype(np.float32)
    return v


def _tile_forward(x, wt, b, r, pads, stride, act, gap, blk, streamed):
    """The bf16 forward as the tiles compute and store it (module
    docstring) -> the stored map, or with ``gap`` the pooled features, as
    bf16 torch tensors."""
    x, wt = _bf16(x), _bf16(wt)
    r = None if r is None else _bf16(r)
    n, ciblk, hi, wi, cib = x.shape
    coblk, _, hf, wf, _, cob = wt.shape
    (pt, _), (pl, _) = pads
    ho = (hi + sum(pads[0]) - hf) // stride + 1
    wo = (wi + sum(pads[1]) - wf) // stride + 1
    kpad = -(-cib // 16) * 16
    lanes, chunk, s = blk.lanes, blk.chunk, stride
    mtiles = blk.strips if streamed else 1
    rows = 64 if streamed else 64 * blk.wgs
    across = -(-wo // blk.tw)
    out = np.full((n, coblk, ho, wo, cob), np.nan, np.float32)
    for tile in range(blk.tiles):
        oh0, ow0 = tile // across * blk.th, tile % across * blk.tw
        h0, w0 = oh0 * s - pt, ow0 * s - pl
        win = np.zeros((n, ciblk, blk.hwin, blk.wwin, kpad), np.float32)
        for i in range(blk.hwin):
            for j in range(blk.wwin):
                if 0 <= h0 + i < hi and 0 <= w0 + j < wi:
                    win[:, :, i, j, :cib] = x[:, :, h0 + i, w0 + j]
        for mt in range(mtiles):
            q = np.arange(rows)
            p = mt * blk.mstride + q
            live = (q < blk.mstride) & (p < blk.th * blk.tw)
            p = np.where(live, p, 0)          # the kernel reads position 0
            pr, pc = p // blk.tw, p % blk.tw
            oh, ow = oh0 + pr, ow0 + pc
            keep = live & (oh < ho) & (ow < wo)
            for o_b in range(coblk):
                for split in range(blk.nsplit):
                    o0 = split * lanes
                    vn = max(0, min(lanes, cob - o0))
                    total = np.zeros((n, rows, lanes), np.float32)
                    for i_b in range(ciblk):
                        for c0 in range(0, kpad, chunk):
                            acc = np.zeros((n, rows, lanes), np.float32)
                            vk = max(0, min(chunk, cib - c0))
                            for dh in range(hf):
                                for dw in range(wf):
                                    a = win[:, i_b, pr * s + dh, pc * s + dw,
                                            c0:c0 + chunk]
                                    bm = np.zeros((chunk, lanes), np.float32)
                                    bm[:vk, :vn] = wt[o_b, i_b, dh, dw,
                                                      c0:c0 + vk, o0:o0 + vn]
                                    bm = _mn_major(bm)
                                    for k in range(0, chunk, 16):
                                        sl = slice(k, k + 16)
                                        acc = _add_rz(acc, np.einsum(
                                            "nmk,kl->nml",
                                            a[..., sl].astype(np.float64),
                                            bm[sl].astype(np.float64)))
                            total = total + acc
                    v = _act(total[:, keep, :vn]
                             + b[o_b, o0:o0 + vn].astype(np.float32), act)
                    if r is not None:
                        v = v + r[:, o_b, oh[keep], ow[keep], o0:o0 + vn]
                    block = out[:, o_b, oh[keep], ow[keep], o0:o0 + vn]
                    assert np.isnan(block).all()      # stored once
                    out[:, o_b, oh[keep], ow[keep], o0:o0 + vn] = v
    assert not np.isnan(out).any()
    stored = torch.from_numpy(out).bfloat16()
    return conv2d_common.gap_replay(stored, blk) if gap else stored


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


def _tiles(n, spec, cib, cob, gap, streamed):
    """The bf16 chooser's tile, then a small one that overhangs the map at
    chunk 16 (the streamed band: strips of one row)."""
    args = (n, spec.ho, spec.wo, 3, 3, spec.stride, spec.ci // cib, cib,
            spec.co // cob, cob)
    chosen = (blocking.choose_stream_fwd_blocking(*args, gap=gap,
                                                  op_bytes=2)
              if streamed else blocking.choose_fwd_blocking(*args, gap=gap,
                                                            op_bytes=2))
    th = chosen.strips if streamed else 2
    small = dataclasses.replace(
        chosen, th=th, tw=3, chunk=16,
        tiles=-(-spec.ho // th) * -(-spec.wo // 3),
        hwin=(th - 1) * spec.stride + 3, wwin=2 * spec.stride + 3)
    return [chosen, small]


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


def test_bf16_window_and_strip_walks_agree_bit_for_bit_at_one_chunk():
    # one K order for every output: where both take the same chunk the two
    # walks store the same bits, whatever the tiles
    x, wt, b, _, spec = _operands(3, 2, 32, 16, 10, 10, 32, 16, 1, "SAME",
                                  False)
    outs = [_tile_forward(x, wt, b, None, spec.pads, 1, "relu", False,
                          dataclasses.replace(blk, chunk=16), streamed)
            for streamed in (False, True)
            for blk in _tiles(2, spec, 32, 16, False, streamed)]
    for other in outs[1:]:
        assert torch.equal(other, outs[0])


def test_the_mn_major_order_is_a_permutation_read_back():
    b = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
    np.testing.assert_array_equal(_mn_major(b), b)


def test_a_fresh_accumulator_a_stage_holds_bf16_products_to_f32_sums():
    # K = 9 * 512 bf16 products into one truncating accumulator drift
    # toward zero; a fresh one a stage (9 taps x chunk 32), added into an
    # f32 sum, stays near f32 rounding of the exact sum of the same bf16
    # products
    rng = np.random.default_rng(5)
    k, m = 9 * 512, 256
    a = _bf16(rng.normal(size=(m, k)))
    b = _bf16(rng.normal(size=k) / np.sqrt(k))
    exact = a.astype(np.float64) @ b.astype(np.float64)

    def walk(stage_slices):
        total = np.zeros(m, np.float32)
        acc = np.zeros(m, np.float32)
        for j, k0 in enumerate(range(0, k, 16)):
            sl = slice(k0, k0 + 16)
            acc = _add_rz(acc, a[:, sl].astype(np.float64)
                          @ b[sl].astype(np.float64))
            if (j + 1) % stage_slices == 0:
                total = total + acc
                acc = np.zeros(m, np.float32)
        return total + acc

    scale = np.abs(exact).max()
    one = np.abs(walk(k // 16) - exact).max() / scale
    staged = np.abs(walk(18) - exact).max() / scale
    assert staged < 3e-6 and staged * 5 < one


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


@pytest.mark.parametrize("gap", [False, True])
@pytest.mark.parametrize("streamed", [False, True])
def test_bf16_choosers_fit_and_take_no_less_a_stage(gap, streamed):
    choose = (blocking.choose_stream_fwd_blocking if streamed
              else blocking.choose_fwd_blocking)
    for name, ci, co, s, ho in _vgg16_shapes():
        cib, cob = min(ci, 128), min(co, 128)
        args = (8, ho, ho, 3, 3, s, ci // cib, cib, co // cob, cob)
        f32 = choose(*args, gap=gap)
        bf = choose(*args, gap=gap, op_bytes=2)
        smem = blocking.fwd_smem_bytes(bf.th, bf.tw, 3, 3, s, bf.chunk,
                                       bf.lanes, bf.wgs, gap, 2)
        assert smem <= blocking.H100_SXM.smem_block, name
        assert bf.chunk % 16 == 0 and blocking.fwd_kpad(cib, 2) % bf.chunk \
            == 0, name
        # never less work a stage: positions x channels staged
        assert bf.th * bf.tw * bf.chunk >= f32.th * f32.tw * f32.chunk, name
        plan = blocking.fwd_plan(bf, 8, ho, ho, 3, 3, s, ci // cib, cib,
                                 co // cob, cob, gap, 2)
        assert plan.smem == smem and plan.products == 1
        assert plan.function_macs == 8 * ho * ho * 9 * ci * co
        assert plan.issued_macs >= plan.function_macs
        if cib == 3:                      # k16 slices: 3 channels of 16
            assert plan.padding_share >= 1 - 3 / 16
        # every tile the f32 search weighs fits at bf16, at a chunk no
        # smaller (half the bytes an element, no raw or split buffers)
        f32_found = {(b.th, b.tw, b.wgs, b.nsplit): b.chunk for _, b in
                     blocking.fwd_candidates(*args, blocking.H100_SXM, gap,
                                             streamed)}
        bf_found = {(b.th, b.tw, b.wgs, b.nsplit): b.chunk for _, b in
                    blocking.fwd_candidates(*args, blocking.H100_SXM, gap,
                                            streamed, op_bytes=2)}
        for key, chunk in f32_found.items():
            assert bf_found.get(key, 0) >= chunk, (name, key)
        assert route_stream("fwd", ConvSpec.make(8, ho * s, ho * s, ci, co,
                                                 3, 3, s, "SAME"),
                            cib, cob, blocking.H100_SXM, gap=gap,
                            op_bytes=2) is False
    with pytest.raises(ValueError, match="4- or 2-byte"):
        blocking.fwd_kpad(3, 8)


def test_bf16_smem_counts_the_tiles_buffers():
    # 128 to align; two slots of (window + weights) in bf16; two ints a k16
    # step; two mbarriers; the GAP sums in f32
    th, tw, s, chunk, lanes, wgs = 4, 8, 1, 32, 64, 2
    hwin, wwin = th + 2, tw + 2
    window = -(-hwin * wwin * (chunk + 8) // 64) * 64
    weights = 9 * chunk * lanes
    steps = 9 * chunk // 16
    want = 128 + 2 * 2 * (window + weights) + 8 * steps + 16
    assert blocking.fwd_smem_bytes(th, tw, 3, 3, s, chunk, lanes, wgs, False,
                                   2) == want
    assert blocking.fwd_smem_bytes(th, tw, 3, 3, s, chunk, lanes, wgs, True,
                                   2) == want + 16 * wgs * lanes


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
