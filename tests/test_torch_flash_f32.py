"""The f32 flash-attention kernel on the tensor cores (``csrc/
flash_attention.cu`` ``flash_fwd_tf32``) on the CPU: its arithmetic written
out in numpy as a CTA runs it, against the reference's Pallas kernel in
interpret mode (``flash_attention_pallas``) and its ``attend``; the
fragment layouts that let P feed P @ V with no shuffle; and the wrapper's
route by shape between it and the CUDA-core kernel.

The model: a CTA's 128 rows are G query heads times 128 // G positions
(row = position * G + g, spare rows zero), key blocks of the kernel's
stage size skipped and marked whole as the producer does, S = Q K^T and
each stage's P @ V as three TF32 products a k8 step (small*big, big*small,
big*big of the rounded halves, ``cvt.rna``), each the exact sum of its 8
products added to an accumulator rounded toward zero (the tensor cores'
f32 adds); V's rows within each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7
and P's columns with them; P @ V into a fresh accumulator each stage, added
to O after O is rescaled; the softmax in f32 on the true key positions.
Against JAX's f32: within ``1e-5 * max|out| + 1e-6``, as the card's
tests hold the kernel to the plain version (the same sums in another order,
the split's error near 2^-22 a product)."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.nn.attention import attend as jax_attend  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402

NEG = np.float32(-1e30)
ROWS = fak.TF32_ROWS
# V's rows within each 8 keys as the producer writes V^T
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32(v):
    """Round f32 to TF32's 10-bit mantissa, nearest with ties away from 0
    (``cvt.rna.tf32.f32``), as f32."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x1000) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _add_rz(acc, v):
    """``acc + v`` rounded toward zero to f32 (f64 in, f32 values out)."""
    exact = acc.astype(np.float64) + v
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma3(a, b, acc=None):
    """``acc + a [M, K] @ b [K, N]`` as the kernel's wgmmas compute it, into
    a fresh accumulator where ``acc`` is None: per k8 step three TF32
    products, each the exact sum of 8 products added rounded toward
    zero."""
    ab = _tf32(a)
    asm = _tf32(a - ab)
    bb = _tf32(b)
    bsm = _tf32(b - bb)
    if acc is None:
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        sl = slice(k, k + 8)
        for x, y in ((asm, bb), (ab, bsm), (ab, bb)):
            acc = _add_rz(acc, x[:, sl].astype(np.float64)
                          @ y[sl].astype(np.float64))
    return acc


def _padded(dh):
    return next(d for d in fak.TF32_HEAD_DIMS if dh <= d)


def _stage_keys(dh):
    """Keys a stage, as ``dispatch_tf32`` derives them from the padded
    head dim: 64 up to 80, else 32."""
    return 64 if _padded(dh) <= 80 else 32


def _kernel(q, k, v, qpos, kvpos, *, causal, window, cap, scale, n_scan):
    """``flash_fwd_tf32``'s arithmetic, CTA by CTA: q [B,Sq,KV,G,Dh], k/v
    [B,Skv,KV,Dh], positions with kv_valid folded in (the wrapper's) ->
    out like q.  Rows never written stay NaN."""
    b_, sq, nkv, g, dh = q.shape
    skv = k.shape[1]
    dp = _padded(dh)
    bk = _stage_keys(dh)
    pq = ROWS // g
    out = np.full(q.shape, np.nan, np.float32)
    idx = np.array([8 * (c // 8) + PERM8[c % 8] for c in range(bk)])
    for b in range(b_):
        for kvh in range(nkv):
            for q0 in range(0, sq, pq):
                live = [(r, r // g, r % g) for r in range(pq * g)
                        if q0 + r // g < sq]
                qq = np.zeros((ROWS, dp), np.float32)
                qp = np.zeros(ROWS, np.int64)
                for r, pos, gg in live:
                    qq[r, :dh] = q[b, q0 + pos, kvh, gg]
                    qp[r] = qpos[b, q0 + pos]
                qlo = min(qpos[b, q0:q0 + pq])
                qhi = max(qpos[b, q0:q0 + pq])
                m = np.full(ROWS, NEG, np.float32)
                l = np.zeros(ROWS, np.float32)
                o = np.zeros((ROWS, dp), np.float32)
                for k0 in range(0, skv, bk):
                    keys = np.arange(k0, k0 + bk)
                    kp = np.array([kvpos[b, c] if c < skv else -10 ** 9
                                   for c in keys], np.int64)
                    ok = kp >= 0
                    if not ok.any():
                        continue
                    lo, hi = kp[ok].min(), kp[ok].max()
                    if (causal and lo > qhi) or (
                            window is not None and hi <= qlo - window):
                        continue                   # no row sees a key
                    whole = ok.all() and (not causal or hi <= qlo) and (
                        window is None or lo > qhi - window)
                    kk = np.zeros((bk, dp), np.float32)
                    vv = np.zeros((bk, dp), np.float32)
                    inside = keys < skv
                    kk[inside, :dh] = k[b, keys[inside], kvh]
                    vv[inside, :dh] = v[b, keys[inside], kvh]
                    s = _mma3(qq, kk.T) * np.float32(scale)
                    if cap is not None:
                        s = (np.float32(cap) * np.tanh(s / np.float32(cap))
                             ).astype(np.float32)
                    if not whole:
                        valid = np.broadcast_to(ok, s.shape).copy()
                        if causal:
                            valid &= kp[None, :] <= qp[:, None]
                        if window is not None:
                            valid &= kp[None, :] > qp[:, None] - window
                        s = np.where(valid, s, NEG)
                    mn = np.maximum(m, s.max(axis=1))
                    a = np.exp(m - mn).astype(np.float32)
                    p = np.exp(s - mn[:, None]).astype(np.float32)
                    l = (l * a + p.sum(axis=1, dtype=np.float32)).astype(
                        np.float32)
                    m = mn
                    # a fresh accumulator a stage (past head dim 80 the
                    # kernel keeps O's second half in shared memory: the
                    # same sums)
                    f = _mma3(p[:, idx], vv[idx])
                    o = (o.astype(np.float64) * a[:, None] + f).astype(
                        np.float32)
                inv = np.float32(1) / np.maximum(l, np.float32(1e-37))
                for r, pos, gg in live:
                    if m[r] == NEG:           # the reference's average of v
                        row = (v[b, :, kvh].sum(axis=0, dtype=np.float32)
                               / np.float32(n_scan))
                    else:
                        row = o[r, :dh] * inv[r]
                    out[b, q0 + pos, kvh, gg] = row
    return out


def _agree(got, want):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    bound = 1e-5 * np.abs(want).max() + 1e-6
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= bound, (err, bound)


def _inputs(seed, b, s, nkv, g, dh, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, s, nkv, g, dh)).astype(np.float32),
            rng.normal(size=(b, skv, nkv, dh)).astype(np.float32),
            rng.normal(size=(b, skv, nkv, dh)).astype(np.float32))


# b, s, kv heads, g, dh, causal, softcap; the TPU kernel's layout and mask
PALLAS_CASES = [
    (1, 96, 2, 4, 80, True, None),        # danube's head dim and grouping
    (2, 64, 1, 7, 80, True, 30.0),        # G 7: 18 positions x 7 heads
    (1, 64, 2, 1, 128, True, None),       # G 1, Dh 128 (32-key stages)
    (1, 80, 1, 4, 128, False, 20.0),      # non-causal, softcap
    (1, 80, 1, 4, 64, False, 20.0),       # Dh 64
    (1, 48, 2, 2, 40, True, None),        # Dh 40: zeros to the padded 64
]


@pytest.mark.parametrize("b,s,nkv,g,dh,causal,cap", PALLAS_CASES)
def test_kernel_arithmetic_matches_pallas_interpret(b, s, nkv, g, dh, causal,
                                                    cap):
    q, k, v = _inputs(s + g + dh, b, s, nkv, g, dh)
    pos = np.broadcast_to(np.arange(s), (b, s))
    got = _kernel(q, k, v, pos, pos, causal=causal, window=None, cap=cap,
                  scale=dh ** -0.5, n_scan=s)
    # [B, H, S, Dh] with h = kv * G + g
    qh = q.reshape(b, s, nkv * g, dh).transpose(0, 2, 1, 3)
    bq = 16
    want = flash_attention_pallas(
        jnp.asarray(qh), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), scale=dh ** -0.5,
        causal=causal, bq=bq, bk=bq, cap=cap, interpret=True)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(q.shape)
    _agree(got, want)


# b, sq, kv heads, g, dh, window, softcap, kv_valid, position stride
ATTEND_CASES = [
    (2, 150, 2, 4, 80, None, None, None, 1),        # ragged: 150 = 4 x 32 + 22
    (1, 120, 1, 4, 80, 40, None, None, 1),          # the window
    (2, 100, 2, 7, 128, None, 50.0, (80, 37), 3),   # kv_valid, 3i + 7
    (2, 70, 1, 6, 128, 16, None, (70, 30), 2),      # rows that see no key
    (1, 90, 2, 1, 64, 50, 30.0, None, 1),           # G 1, window, softcap
]


@pytest.mark.parametrize("b,s,nkv,g,dh,window,cap,kv_valid,stride",
                         ATTEND_CASES)
def test_kernel_arithmetic_matches_attend(b, s, nkv, g, dh, window, cap,
                                          kv_valid, stride):
    q, k, v = _inputs(7 * s + g, b, s, nkv, g, dh)
    pos = np.broadcast_to(stride * np.arange(s) + (7 if stride > 1 else 0),
                          (b, s)).astype(np.int64)
    kvpos = pos.copy()
    if kv_valid is not None:
        # the wrapper folds kv_valid into the key positions
        kvpos = np.where(pos < np.asarray(kv_valid)[:, None], pos, -10 ** 9)
    chunk = 64
    got = _kernel(q, k, v, pos, kvpos, causal=True, window=window, cap=cap,
                  scale=dh ** -0.5, n_scan=fak.scanned_keys(s, chunk))
    want = jax_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos, jnp.int32),
        kv_positions=jnp.asarray(pos, jnp.int32), causal=True, window=window,
        cap=cap, scale=dh ** -0.5, chunk=chunk,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    _agree(got, want)
    if window == 16:
        # batch 1's rows past position 2 * 29 + 7 + 16 see no key
        assert np.allclose(got[1, 40:], v[1].sum(axis=0)[None, :, None]
                           / fak.scanned_keys(s, chunk), atol=1e-6)


def test_permuted_v_rows_make_the_s_fragment_the_a_fragment():
    # wgmma's f32 S fragment: thread (lane l, t = l % 4) holds columns
    # 8j + 2t (+1) of rows r and r + 8 in s[4j .. 4j+3]; TF32's A fragment
    # takes a[0..3] = A[r][t], A[r+8][t], A[r][t+4], A[r+8][t+4] of each k8
    # step.  The kernel loads a = (s[4j], s[4j+2], s[4j+1], s[4j+3]); V^T
    # as the producer writes it, [k quad q][column][i] = V[8 (q >> 1) +
    # (q & 1) + 2 i], must give each k slot the key of the S value there.
    def s_key(reg, t, j):            # (row half, key) of s[4j + reg]
        return reg >> 1, 8 * j + 2 * t + (reg & 1)

    def a_slot(i):                   # (row half, k slot) of a[i]
        return i & 1, (i >> 1) * 4

    for j in range(8):
        for t in range(4):
            for i, reg in enumerate((0, 2, 1, 3)):
                half, key = s_key(reg, t, j)
                a_half, slot0 = a_slot(i)
                slot = slot0 + t
                q, lane_i = 2 * j + slot // 4, slot % 4
                vt_key = 8 * (q >> 1) + (q & 1) + 2 * lane_i
                assert half == a_half and key == vt_key
                assert vt_key == 8 * j + PERM8[slot]


def test_fresh_stage_accumulators_hold_the_tolerance_one_accumulator_drifts():
    # rows that average 2048 keys (P in [0, 1], V ~ N(0, 1)), stage by stage
    # (64 keys): into fresh accumulators added in f32, as the kernel, the
    # outputs stay within 1e-5 of their largest value; through one
    # truncating accumulator they drift past it
    rng = np.random.default_rng(3)
    p = rng.random((16, 2048)).astype(np.float32)
    vv = rng.normal(size=(2048, 8)).astype(np.float32)
    exact = p.astype(np.float64) @ vv
    l = p.astype(np.float64).sum(axis=1)[:, None]
    errs = []
    for fresh in (True, False):
        o = np.zeros((16, 8), np.float32)
        for k0 in range(0, 2048, 64):
            if fresh:
                f = _mma3(p[:, k0:k0 + 64], vv[k0:k0 + 64])
                o = (o.astype(np.float64) + f).astype(np.float32)
            else:
                o = _mma3(p[:, k0:k0 + 64], vv[k0:k0 + 64], o)
        errs.append(np.abs((o - exact) / l).max()
                    / np.abs(exact / l).max())
    assert errs[0] < 1e-6 < 1e-5 < errs[1]


# ---------------------------------------------------------------------------
# the route by shape
# ---------------------------------------------------------------------------

def _kv(b=2, s=64, kv=8, dh=80, k_strides=None):
    sizes = (b, s, kv)
    strides = k_strides or (s * kv * dh, kv * dh, dh)
    return ((sizes, strides), (sizes, strides))


def test_f32_route_takes_the_tensor_cores_up_to_dh_128_and_g_128():
    assert fak.f32_route(80, 4, _kv()) == "tf32"
    for dh in (8, 16, 64, 72, 96, 128):
        assert fak.f32_route(dh, 4, _kv(dh=dh)) == "tf32"
    for dh in (136, 256):
        assert fak.f32_route(dh, 4, _kv(dh=dh)) == "fma"
    assert fak.f32_route(64, 128, _kv()) == "tf32"
    assert fak.f32_route(64, 129, _kv()) == "fma"
    # a K/V index longer than 1 that does not step forward: CUDA cores
    assert fak.f32_route(80, 4, _kv(k_strides=(0, 640, 80))) == "fma"
    assert fak.f32_route(80, 4, _kv(k_strides=(5120, 640, -80))) == "fma"
    # an index of extent 1 is never stepped: its stride does not matter
    assert fak.f32_route(80, 4, _kv(b=1, k_strides=(0, 640, 80))) == "tf32"


def _route_of(k, g, dh):
    """:func:`f32_route` on grouped ``k`` (and v like it), as ``attend``
    hands it the strides."""
    sizes = tuple(k.shape[:3])
    return fak.f32_route(dh, g, ((sizes, k.stride()[:3]),) * 2)


def test_f32_route_and_stage_at_the_models_and_phase_18_shapes():
    # chip_smoke.py's phase-18 f32 cases on the tensor cores
    for g, dh in ((4, 80), (2, 64), (4, 128), (6, 128)):
        assert _route_of(torch.zeros((1, 8, 2, dh)), g, dh) == "tf32"
    # and those it sends to CUDA cores: head dim 256 (gemma2's), and one
    # K/V head expanded over 8 (kv-head stride 0, sequence stride 80)
    assert _route_of(torch.zeros((2, 8, 2, 256)), 2, 256) == "fma"
    k = torch.zeros((1, 16, 1, 80)).expand(1, 16, 8, 80)
    assert k.stride()[:3] == (1280, 80, 0)
    assert _route_of(k, 4, 80) == "fma"
    # the [B, H, S, Dh] entry's views: K/V strides (batch, seq, kv head)
    # from a [B, S, KV, Dh] tensor transposed, all positive
    kh = torch.zeros((2, 16, 8, 80)).transpose(1, 2)
    sizes = (2, 16, 8)
    assert fak.f32_route(80, 4, ((sizes, (kh.stride(0), kh.stride(2),
                                          kh.stride(1))),) * 2) == "tf32"
    # the model's stage is the instance dispatch_tf32 launches at each
    # padded head dim (64 keys where two stages fit beside Q, up to 80)
    src = (Path(fak.__file__).parents[1] / "csrc" /
           "flash_attention.cu").read_text()
    for dh, inst in ((64, "<64, 64>"), (80, "<80, FLASH_TF32_STAGE80>"),
                     (128, "<128, 32>")):
        assert f"launch_tf32{inst}" in src
        assert _stage_keys(dh) == (64 if dh <= 80 else 32)


def test_flash_f32_ab_times_the_chosen_stage_first():
    from repro_torch.launch import flash_f32_ab
    runs = flash_f32_ab.candidates()
    assert [(k, f) for _, k, f in runs] == [
        ("tf32", ()), ("tf32", ("-DFLASH_TF32_STAGE80=32",)), ("fma", ())]
    assert [(k, f) for _, k, f in flash_f32_ab.candidates(128)] == [
        ("tf32", ()), ("fma", ())]
    # the flag names the macro that dispatch_tf32 reads at head dim 80
    src = (Path(fak.__file__).parents[1] / "csrc" /
           "flash_attention.cu").read_text()
    assert "launch_tf32<80, FLASH_TF32_STAGE80>" in src
    assert "#define FLASH_TF32_STAGE80 64" in src
