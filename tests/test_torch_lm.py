"""The port's language-model serving path against the JAX reference on the
CPU: the plain versions of the flash-attention and conv1d kernels against
the reference's Pallas kernels in interpret mode and its jnp functions, the
SSD scan, the reduced h2o-danube-1.8b and mamba2-780m (prefill, decode and
the continuous batcher) with the reference's parameters carried over by
``params_from_jax``, the configs, and what ``build_model`` refuses.

Inputs are numpy arrays from fixed seeds, handed to both packages.  Small:
reduced configs (d_model 64, 2 layers, vocabulary 211), sequences of 16 to
40 tokens.  Tolerances: f32 results agree within 1e-5 of the largest value
where both sides compute the same sums in another order; the logits of two
whole models within 1e-4 (two layers of f32 matmuls in another order); the
decode path within the reference's own decode-vs-forward tolerance, 2e-3.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import layout as jlayout  # noqa: E402
from repro.core.direct_conv import (  # noqa: E402
    direct_conv1d_depthwise as jax_conv1d)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.conv1d_depthwise import (  # noqa: E402
    conv1d_depthwise_blocked_pallas)
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.nn.attention import attend as jax_attend  # noqa: E402
from repro.nn.models import build_model as jax_build_model  # noqa: E402
from repro.nn.module import Parallelism  # noqa: E402
from repro.serve.scheduler import (  # noqa: E402
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from repro.train.trainstep import (  # noqa: E402
    make_prefill_step as jax_make_prefill_step)
from repro_torch.configs.reduced import reduced_config  # noqa: E402
from repro_torch.configs.registry import get_config, list_archs  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import layout as tlayout  # noqa: E402
from repro_torch.kernels import conv1d_depthwise as c1k  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.nn.models import LM, build_model  # noqa: E402
from repro_torch.serve.decode import greedy, make_prefill  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatcher, Request  # noqa: E402
from repro_torch.train.trainstep import forward, make_prefill_step  # noqa: E402

PX = Parallelism(mesh=None)
LM_ARCHS = ("h2o-danube-1.8b", "mamba2-780m")
# the other decoder-only configs the port serves: gemma2 (local/global
# windows, softcaps, post-norms, embed scale, tied head) and starcoder2
# (layernorm, GELU, biases)
MORE_ARCHS = ("gemma2-27b", "starcoder2-15b")


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# flash attention: the plain versions against the reference
# ---------------------------------------------------------------------------

# b, h, kv, s, dh, bq, bk, causal: the reference's test_flash_attention cases
FLASH_CASES = [
    (1, 4, 2, 32, 16, 8, 8, True),
    (2, 4, 4, 16, 8, 16, 4, True),
    (1, 6, 2, 24, 16, 8, 12, False),
    (1, 8, 1, 32, 32, 32, 16, True),      # MQA
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(case, dtype):
    b, h, kv, s, dh, bq, bk, causal = case
    rng = np.random.default_rng(sum(case) + len(dtype))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((b, h, s, dh), (b, kv, s, dh), (b, kv, s, dh)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = flash_attention_pallas(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        scale=dh ** -0.5, causal=causal, bq=bq, bk=bk, interpret=True)
    tdt = getattr(torch, dtype)
    got = fak.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                              scale=dh ** -0.5, causal=causal)
    assert got.dtype == tdt
    # bf16: both round an f32 result once; they differ by one bf16 ulp
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got.float(), np.asarray(want, np.float32), tol, f"{case}")


def test_flash_plain_softcap_matches_pallas():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.35, causal=True,
                                  bq=8, bk=8, cap=20.0, interpret=True)
    got = fak.flash_attention(_t(q), _t(k), _t(v), scale=0.35, causal=True,
                              cap=20.0)
    _close(got, want, 1e-5)


# sq, skv, window, cap, kv_valid, chunk, offset: chunks that do not divide
# Skv (the -10**9 padding), windows that bite, softcap, kv_valid, positions
# that do not start at 0
ATTEND_CASES = [
    (16, 16, None, None, None, 2048, 0),
    (24, 24, 5, None, None, 7, 0),
    (20, 20, None, 30.0, None, 6, 0),
    (16, 16, 4, 50.0, (11, 16), 5, 0),
    (8, 24, 6, None, (24, 19), 10, 16),
]


@pytest.mark.parametrize("case", ATTEND_CASES)
def test_attend_plain_matches_reference(case):
    sq, skv, window, cap, kv_valid, chunk, offset = case
    b, nkv, g, dh = 2, 2, 3, 16
    rng = np.random.default_rng(sq * 7 + skv)
    q = rng.normal(size=(b, sq, nkv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, nkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, nkv, dh)).astype(np.float32)
    kvp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv))
    qp = np.broadcast_to(np.arange(sq, dtype=np.int32) + offset, (b, sq))
    kvv = None if kv_valid is None else np.asarray(kv_valid, np.int32)
    kw = dict(causal=True, window=window, cap=cap, scale=dh ** -0.5,
              chunk=chunk)
    want = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      q_positions=jnp.asarray(qp),
                      kv_positions=jnp.asarray(kvp),
                      kv_valid=None if kvv is None else jnp.asarray(kvv),
                      **kw)
    got = fak.attend(_t(q), _t(k), _t(v), q_positions=torch.from_numpy(
                         qp.copy()),
                     kv_positions=torch.from_numpy(kvp.copy()),
                     kv_valid=None if kvv is None else torch.from_numpy(kvv),
                     **kw)
    _close(got, want, 1e-5, f"{case}")


@pytest.mark.parametrize("chunk", [2048, 7])
def test_attend_rows_that_see_no_key_average_v_over_the_scan(chunk):
    """A row that sees no key (kv_valid and a window leave it nothing): the
    reference gives every scanned key p = 1, so the row is the sum of v over
    the Skv keys over ``scanned_keys`` (Skv rounded up to the chunk, the
    zero padding counted), the value the CUDA kernels write for it."""
    b, sq, nkv, g, dh = 2, 20, 2, 3, 8
    rng = np.random.default_rng(chunk)
    q = rng.normal(size=(b, sq, nkv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sq, nkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sq, nkv, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq))
    kvv = np.asarray([20, 8], np.int32)
    kw = dict(causal=True, window=3, cap=None, scale=dh ** -0.5, chunk=chunk)
    want = np.asarray(jax_attend(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_positions=jnp.asarray(pos),
                                 kv_positions=jnp.asarray(pos),
                                 kv_valid=jnp.asarray(kvv), **kw))
    got = fak.attend(_t(q), _t(k), _t(v),
                     q_positions=torch.from_numpy(pos.copy()),
                     kv_positions=torch.from_numpy(pos.copy()),
                     kv_valid=torch.from_numpy(kvv), **kw)
    _close(got, want, 1e-5)
    # batch 1's rows at positions >= 8 + 3 see no key
    avg = v[1].sum(axis=0) / fak.scanned_keys(sq, chunk)       # [KV, Dh]
    unseen = np.broadcast_to(avg[None, :, None], (sq - 11, nkv, g, dh))
    np.testing.assert_allclose(want[1, 11:], unseen, rtol=1e-5, atol=1e-6)


def test_attend_refuses_autograd():
    q = torch.zeros((1, 4, 1, 1, 8), requires_grad=True)
    k = torch.zeros((1, 4, 1, 8))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="LM-training"):
        fak.attend(q, k, k, q_positions=pos, kv_positions=pos, scale=1.0)
    with torch.no_grad():
        assert fak.attend(q, k, k, q_positions=pos, kv_positions=pos,
                          scale=1.0).shape == q.shape


# ---------------------------------------------------------------------------
# conv1d: the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,d,k,lb", [(64, 160, 4, 16), (40, 256, 4, 8),
                                      (33, 48, 3, 512)])
def test_conv1d_plain_matches_reference_on_a_strided_slice(l, d, k, lb):
    """x is a column slice of a wider tensor (the Mamba2 xBC view)."""
    rng = np.random.default_rng(l + d)
    wide = rng.normal(size=(2, l, d + 40)).astype(np.float32)
    x = wide[:, :, 24:24 + d]
    w = rng.normal(size=(k, d)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    want_ops = jops.conv1d_depthwise(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(bias), lb=lb,
                                     interpret=True)
    want = jax_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    xt = torch.from_numpy(wide)[:, :, 24:24 + d]
    assert not xt.is_contiguous()
    got = c1k.conv1d_depthwise(xt, torch.from_numpy(w),
                               torch.from_numpy(bias))
    assert got.is_contiguous()
    _close(got, want, 1e-6, "vs direct_conv1d_depthwise")
    _close(got, want_ops, 1e-6, "vs ops.conv1d_depthwise (Pallas)")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_blocked_plain_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    b, l, d, db, k = 2, 32, 96, 32, 4
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    w = rng.normal(size=(k, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xb = jlayout.bld_to_blocked(jnp.asarray(x, jdt), db)
    wb = jlayout.kd_to_blocked(jnp.asarray(w, jdt), db)
    want = conv1d_depthwise_blocked_pallas(xb, wb, lb=8, interpret=True)
    tdt = getattr(torch, dtype)
    xt = tlayout.bld_to_blocked(_t(x, tdt), db)
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xb, np.float32))
    got = c1k.conv1d_depthwise_blocked(xt, tlayout.kd_to_blocked(
        _t(w, tdt), db))
    assert got.dtype == tdt and got.shape == tuple(want.shape)
    tol = 1e-6 if dtype == "float32" else 1e-2
    _close(got.float(), np.asarray(want, np.float32), tol)
    np.testing.assert_array_equal(
        tlayout.blocked_to_bld(xt).float().numpy(),
        np.asarray(jlayout.blocked_to_bld(xb), np.float32))


def test_conv1d_refuses_autograd():
    x = torch.zeros((1, 8, 4), requires_grad=True)
    with pytest.raises(NotImplementedError, match="LM-training"):
        c1k.conv1d_depthwise(x, torch.zeros((4, 4)))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_reference_and_naive(g):
    rng = np.random.default_rng(g)
    bt, l, h, p, n, chunk = 2, 32, 4, 8, 16, 8
    x = rng.normal(size=(bt, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bt, l, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    b = rng.normal(size=(bt, l, g, n)).astype(np.float32)
    c = rng.normal(size=(bt, l, g, n)).astype(np.float32)
    dsk = rng.normal(size=(h,)).astype(np.float32)
    want = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)),
                            d_skip=jnp.asarray(dsk), chunk=chunk)
    args = [torch.from_numpy(t) for t in (x, dt, a, b, c)]
    got = tssm.ssd_chunked(*args, d_skip=torch.from_numpy(dsk), chunk=chunk)
    naive = tssm.ssd_naive(*args, d_skip=torch.from_numpy(dsk))
    _close(got, want, 1e-5, "chunked vs reference")
    _close(naive, want, 1e-5, "naive vs reference")


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_compact_matches_reference(g):
    """``compact=True`` stores C.B and the decay matrix in bf16 and
    contracts the intra-chunk output in f32, as the reference does.  B and
    C lie on a grid of 1/4 in [-2, 2], so every C.B sum is exact in f32 and
    both sides round the same value to bf16; what is left is f32 summation
    order, within 1e-5 of max|y|.  An intra-chunk output rounded to bf16
    is off by ~2e-3."""
    rng = np.random.default_rng(g + 10)
    bt, l, h, p, n, chunk = 2, 32, 4, 8, 16, 8
    x = rng.normal(size=(bt, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bt, l, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    b, c = (rng.integers(-8, 9, size=(bt, l, g, n)).astype(np.float32) / 4
            for _ in range(2))
    want = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)),
                            chunk=chunk, compact=True)
    got = tssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, b, c)),
                           chunk=chunk, compact=True)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, "compact chunked vs reference")


# ---------------------------------------------------------------------------
# the reduced models: prefill, decode, batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The reference's reduced models with their parameters, and the port's
    with the same parameters."""
    out = {}
    for arch in LM_ARCHS + MORE_ARCHS:
        cfg = reduced_config(arch)
        jmodel = jax_build_model(jreduced.reduced_config(arch), PX)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        model = build_model(cfg, "cpu")
        model.load_state_dict(params_from_jax(tree, "cpu"))
        out[arch] = (cfg, jmodel, jparams, model, tree)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS + MORE_ARCHS)
def test_reduced_prefill_matches_reference(arch, models):
    cfg, jmodel, jparams, model, _ = models[arch]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    want = jax_make_prefill_step(jmodel, cfg)(jparams,
                                              {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(model, cfg)({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert got.shape == (2, 32, model.padded_vocab) == tuple(want.shape)
    _close(got, want, 1e-4)
    with pytest.raises(NotImplementedError, match="training"):
        forward(model, {"tokens": torch.from_numpy(toks)}, train=True)


@pytest.mark.parametrize("arch", LM_ARCHS + MORE_ARCHS)
def test_reduced_decode_matches_reference(arch, models):
    cfg, jmodel, jparams, model, _ = models[arch]
    rng = np.random.default_rng(6)
    s = 16
    toks = rng.integers(0, cfg.vocab_size, (2, s), dtype=np.int32)
    jcache = jmodel.init_cache(2, s, dtype=jnp.float32)
    cache = model.init_cache(2, s, dtype=torch.float32)
    jstep = jax.jit(jmodel.decode_step)
    got, want = [], []
    for t in range(s):
        lg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
        with torch.no_grad():
            tl, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(tl[:, 0].numpy())
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # and the port's decode reproduces the port's own forward
    with torch.no_grad():
        fwd, _ = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got, fwd.numpy(), rtol=2e-3, atol=2e-3)
    # the decode-loop prefill ends on the last token's logits
    logits, _, nxt = make_prefill(model, s)(
        torch.from_numpy(toks), model.init_cache(2, s, dtype=torch.float32))
    assert nxt == s
    np.testing.assert_allclose(logits[:, 0].numpy(), got[:, -1], rtol=1e-6,
                               atol=1e-6)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,), dtype=np.int32) for n in lens]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batcher_matches_reference_batcher(arch, models):
    """Four requests in four slots run in step (one position group), where
    the reference's batcher is exact: the same greedy tokens."""
    cfg, jmodel, jparams, model, _ = models[arch]
    prompts = _prompts(cfg.vocab_size, (5, 9, 3, 7), 7)
    jb = JaxBatcher(jmodel, jparams, batch=4, cache_len=32)
    tb = ContinuousBatcher(model, batch=4, cache_len=32)
    for i, p in enumerate(prompts):
        jb.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=5))
        tb.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: r.out_tokens for r in jb.run(max_steps=200)}
    got = {r.rid: r.out_tokens for r in tb.run(max_steps=200)}
    assert len(got) == 4 and all(len(t) == 5 for t in got.values())
    assert got == want


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batcher_out_of_step_slots_match_one_at_a_time(arch, models):
    """Six requests of different lengths through two slots, so slots sit
    at different positions and step in separate groups: each request gets
    the tokens that the reference's one-slot batcher gives it alone."""
    cfg, jmodel, jparams, model, _ = models[arch]
    prompts = _prompts(cfg.vocab_size, (4, 9, 3, 6, 8, 5), 8)
    jb = JaxBatcher(jmodel, jparams, batch=1, cache_len=32)
    tb = ContinuousBatcher(model, batch=2, cache_len=32)
    for i, p in enumerate(prompts):
        jb.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=4))
        tb.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    want = {r.rid: r.out_tokens for r in jb.run(max_steps=500)}
    got = {r.rid: r.out_tokens for r in tb.run(max_steps=500)}
    assert tb.decode_steps > sum(len(p) + 3 for p in prompts) // 2
    assert got == want


def test_greedy_and_topk_sampler():
    logits = torch.tensor([[[0.0, 3.0, 1.0, 2.0]]]).repeat(3, 1, 1)
    assert greedy(logits).tolist() == [1, 1, 1]
    from repro_torch.serve.decode import sample_topk
    gen = torch.Generator().manual_seed(0)
    picks = sample_topk(logits, gen, k=2)
    assert picks.dtype == torch.int32 and set(picks.tolist()) <= {1, 3}


# ---------------------------------------------------------------------------
# parameters, configs, and what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_round_trip(arch, models):
    cfg, _, _, model, tree = models[arch]
    back = params_to_numpy(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_bf16_params_carry_bit_for_bit():
    arch = "mamba2-780m"
    jcfg = dataclasses.replace(jreduced.reduced_config(arch),
                               param_dtype="bfloat16", dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="bfloat16",
                              dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg, PX).init(
        jax.random.PRNGKey(1)))
    model = build_model(cfg, "cpu")
    sd = params_from_jax(tree, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    model.load_state_dict(sd)
    back = params_to_numpy(model)
    np.testing.assert_array_equal(
        back["layers"]["b0"]["mamba"]["conv_w"].view(np.int16),
        tree["layers"]["b0"]["mamba"]["conv_w"].view(np.int16))


def test_configs_match_reference():
    assert list_archs() == jregistry.list_archs()
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jregistry.get_config(arch)), arch
        assert dataclasses.asdict(reduced_config(arch)) == \
            dataclasses.asdict(jreduced.reduced_config(arch)), arch
        assert get_config(arch).n_params() == \
            jregistry.get_config(arch).n_params(), arch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_model_holds_reference_parameter_count(arch, models):
    cfg, _, _, model, tree = models[arch]
    assert sum(t.numel() for t in model.state_dict().values()) == \
        sum(np.asarray(a).size for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", LM_ARCHS + ("gemma2-27b",))
def test_lm_specs_match_reference(arch):
    """The port's spec tree is the reference's: the same paths, shapes,
    inits, scales and dtypes (gemma2: local/global periods, post-norms),
    except Mamba-2's ``a_log``/``dt_bias``, which the port draws as the
    published model does where the reference starts them at 0."""
    cfg = reduced_config(arch)
    want = jax_build_model(jreduced.reduced_config(arch), PX).specs()
    got = build_model(cfg, "cpu").specs()
    flat_w = dict(jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda n: hasattr(n, "axes"))[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda n: hasattr(n, "init"))[0])
    assert set(flat_g) == set(flat_w)
    for path, w in flat_w.items():
        g = flat_g[path]
        if path[-1].key in MAMBA2_PUBLISHED_INIT:
            assert w.init == "zeros", path
            assert (g.shape, g.init, g.bounds) == (
                w.shape, *MAMBA2_PUBLISHED_INIT[path[-1].key]), path
        else:
            assert (g.shape, g.init, g.scale) == (w.shape, w.init,
                                                  w.scale), path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name


# the port's Mamba-2 init where it departs from the reference's zeros
MAMBA2_PUBLISHED_INIT = {"a_log": ("log_uniform", (1.0, 16.0)),
                         "dt_bias": ("softplus_inv_log_uniform",
                                     (1e-3, 1e-1))}


def test_mamba2_init_draws_a_and_dt_as_published():
    """A = exp(a_log) uniform in [1, 16], dt = softplus(dt_bias)
    log-uniform in [1e-3, 1e-1], from the generator (two seeds differ)."""
    from repro_torch.configs.registry import get_config as port_config
    from repro_torch.nn.layers import Init
    from repro_torch.nn.ssm import Mamba2
    cfg = port_config("mamba2-780m")

    def draw(seed):
        return Mamba2(cfg.d_model, cfg.ssm, Init(
            torch.Generator().manual_seed(seed), torch.device("cpu")))
    m = draw(0)
    a = torch.exp(m.a_log.double())
    dt = torch.nn.functional.softplus(m.dt_bias.double())
    assert m.a_log.shape == (cfg.ssm.n_heads(cfg.d_model),)
    assert a.min() >= 1 - 1e-6 and a.max() <= 16 + 1e-5
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert a.max() - a.min() > 5 and dt.max() / dt.min() > 10
    assert not torch.equal(m.a_log, draw(1).a_log)


def test_attention_init_fans_in_over_the_contracted_size():
    """Unlike the reference (fan-in over the heads axis of [D, H, Dh]), the
    port draws q/k/v at std 1/sqrt(d_model) and o at 1/sqrt(H * Dh), so
    that full-width scores start O(1)."""
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.layers import Init
    attn = Attention(512, 8, 2, 32, Init(torch.Generator().manual_seed(0),
                                         torch.device("cpu")))
    for name, fan_in in (("q", 512), ("k", 512), ("v", 512), ("o", 256)):
        std = getattr(attn, name).w.std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std)


def test_decode_writes_the_new_kv_row_in_place():
    from repro_torch.nn.attention import (_decode_update_and_attend,
                                          init_kv_cache)
    gen = torch.Generator().manual_seed(3)
    cache = init_kv_cache(2, 8, 2, 16, dtype=torch.float32)
    q = torch.randn((2, 2, 3, 16), generator=gen)
    k_new, v_new = (torch.randn((2, 2, 16), generator=gen) for _ in "kv")
    _, ck, cv = _decode_update_and_attend(q, k_new, v_new, cache.k, cache.v,
                                          10, window=None, cap=None,
                                          scale=0.25)
    assert ck is cache.k and cv is cache.v
    assert torch.equal(cache.k[:, 10 % 8], k_new)
    assert torch.equal(cache.v[:, 10 % 8], v_new)
    assert not cache.k[:, :2].any() and not cache.k[:, 3:].any()


@pytest.mark.parametrize("arch,what", [
    ("mixtral-8x22b", "MoE"), ("qwen3-moe-235b-a22b", "MoE"),
    ("jamba-v0.1-52b", "MoE"), ("llama-3.2-vision-11b", "cross-attention"),
    ("whisper-medium", "encoder-decoder")])
def test_build_model_refuses_what_is_not_ported(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        build_model(reduced_config(arch), "cpu")


def test_build_model_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(reduced_config("h2o-danube-1.8b"))
    assert isinstance(build_model(reduced_config("h2o-danube-1.8b"), "cpu"),
                      LM)
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "mamba2-780m", "--reduced"])
    assert main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--max-new", "2"]) == 0


# ---------------------------------------------------------------------------
# what the CUDA flash kernels take: a function of shapes, strides and bases
# ---------------------------------------------------------------------------

def _flash_operands(b=2, s=64, kv=8, g=4, dh=80, base=0, q_strides=None,
                    k_strides=None):
    """The wrapper's operand list for contiguous [B, S, KV, G, Dh] q/out
    and [B, S, KV, Dh] k/v, with ``q_strides``/``k_strides`` (elements)
    overriding the contiguous ones."""
    qs = q_strides or (s * kv * g * dh, kv * g * dh, g * dh, dh)
    ks = k_strides or (s * kv * dh, kv * dh, dh)
    return [("q", base, (b, s, kv, g), qs, 1),
            ("k", 0, (b, s, kv), ks, 1), ("v", 0, (b, s, kv), ks, 1),
            ("out", 0, (b, s, kv, g), qs, 1)]


def test_flash_params_ab_pads_the_kernel_parameters():
    """The measurement script's variants: the source as it is, and with
    unused bytes appended to ``HParams`` and the 512-byte assert relaxed;
    without a card it refuses to run."""
    from repro_torch.launch import flash_params_ab as ab
    src = (ab._build.CSRC / "flash_attention.cu").read_text()
    assert ab.variant_source(0) == src
    padded = ab.variant_source(16)
    assert "long long pad_[2];" in padded and ab._ASSERT not in padded
    assert ab._ASSERT in src and ab._BYTES == 512
    if not torch.cuda.is_available():
        assert ab.main([]) == 1


def test_flash_kernels_take_the_model_layouts():
    """danube's q/k/v, [B, H, S, Dh] views, G = 7 at Dh 128, G = 1 (MQA's
    counterpart) and the f32 kernel's multiples of 4 all pass."""
    fak.check_operands(torch.bfloat16, 80, 4, _flash_operands())
    s, h = 100, 32                   # [B, H, S, Dh] views of [B, S, H, Dh]
    fak.check_operands(torch.bfloat16, 80, 4, _flash_operands(
        s=s, q_strides=(s * h * 80, h * 80, 4 * 80, 80),
        k_strides=(s * 8 * 80, 8 * 80, 80)))
    fak.check_operands(torch.bfloat16, 128, 7, _flash_operands(g=7, dh=128))
    fak.check_operands(torch.bfloat16, 64, 1, _flash_operands(g=1, dh=64))
    # an index of extent 1 is never stepped: its stride does not matter
    fak.check_operands(torch.bfloat16, 64, 1, _flash_operands(
        b=1, kv=1, g=1, dh=64, q_strides=(3, 64, 5, 7),
        k_strides=(3, 64, 5)))
    fak.check_operands(torch.float32, 12 * 8, 4, _flash_operands(
        dh=96, q_strides=(4, 4, 4, 4)))


@pytest.mark.parametrize("what,dtype,kwargs,err,match", [
    ("stride of 4 bf16 elements", torch.bfloat16,
     dict(q_strides=(64 * 32 * 84, 32 * 84, 4 * 84 + 4, 84)), ValueError,
     "multiples of 8"),
    ("k's sequence stride odd", torch.bfloat16,
     dict(k_strides=(64 * 8 * 80, 8 * 80 + 2, 80)), ValueError,
     "multiples of 8"),
    ("a zero stride on an index of extent > 1", torch.bfloat16,
     dict(k_strides=(64 * 8 * 80, 0, 80)), ValueError, "positive"),
    ("f32 strides of 2", torch.float32,
     dict(q_strides=(64 * 32 * 80, 32 * 80, 4 * 80, 82)), ValueError,
     "multiples of 4"),
    ("base 8 bytes past 16", torch.bfloat16, dict(base=8), ValueError,
     "misaligned"),
    ("base 4 bytes past 16, f32", torch.float32, dict(base=4), ValueError,
     "misaligned"),
])
def test_flash_kernels_refuse_strides_and_bases(what, dtype, kwargs, err,
                                                match):
    with pytest.raises(err, match=match):
        fak.check_operands(dtype, 80, 4, _flash_operands(**kwargs))


@pytest.mark.parametrize("dh", [4, 12, 260, 264, 0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_refuse_head_dims(dh, dtype):
    """Head dims that are no multiple of 8, or above 256."""
    with pytest.raises(NotImplementedError, match="head dim"):
        fak.check_operands(dtype, dh, 4, _flash_operands(dh=max(dh, 8)))


def test_flash_kernels_refuse_a_contiguity_break_and_too_many_heads():
    ops = _flash_operands()
    ops[1] = ("k", 0, (2, 64, 8), (64 * 8 * 80, 8 * 80, 80), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fak.check_operands(torch.bfloat16, 80, 4, ops)
    with pytest.raises(NotImplementedError, match="query heads"):
        fak.check_operands(torch.bfloat16, 64, fak.BF16_ROWS + 1,
                           _flash_operands(g=fak.BF16_ROWS + 1, dh=64))
    fak.check_operands(torch.float32, 64, fak.BF16_ROWS + 1,
                       _flash_operands(g=fak.BF16_ROWS + 1, dh=64))
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        fak.check_operands(torch.float16, 64, 4, _flash_operands(dh=64))
