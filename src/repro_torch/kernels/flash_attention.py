"""Wrappers of the flash-attention kernel, and its plain version.

``csrc/flash_attention.cu`` replaces the reference's Pallas kernel
``flash_attention_pallas`` (``repro/kernels/flash_attention.py``) and
computes the reference's chunked online-softmax ``attend``
(``repro/nn/attention.py:49``), mask and arithmetic: GQA without repeated
K/V, f32 ``m``/``l``/``acc``, the optional tanh softcap, the causal and
window masks on explicit positions, and ``kv_valid``.  Two entry points:

* :func:`flash_attention` on ``[B, H, Sq, Dh]`` / ``[B, KV, Skv, Dh]``, the
  counterpart of ``flash_attention_pallas`` (whose causal iota mask is
  ``attend``'s with ``positions = arange``);
* :func:`attend` on the grouped ``[B, Sq, KV, G, Dh]`` / ``[B, Skv, KV,
  Dh]``, the counterpart of ``attend``.

Both launch one kernel on the tensors' strided views, with no transpose or
repeat copy (the kernel takes q/out strides for (batch, seq, kv head,
group) and k/v strides for (batch, seq, kv head)).  On a CPU tensor they
compute the plain version, :func:`attend_plain`, the port of the
reference's chunked scan (``chunk``, the ``-10**9`` padding position,
``compact_probs``); a CUDA tensor launches the kernel or raises.  Three
kernels: bf16 runs on the tensor cores (``flash_fwd_wgmma``: wgmma,
TMA-fed K/V tiles shared by the G query heads of a KV head), f32 on them
too in 3xTF32 (``flash_fwd_tf32``, the same structure) where
:func:`f32_route` says so, and on CUDA cores otherwise
(``flash_fwd_kernel``).  Together they take any head dim ``Dh <= 256``
that is a multiple of 8, and keep their scores in f32 registers, so
``compact_probs=True`` (bf16 score storage, a plain-path option) raises on
CUDA.  :func:`check_operands` states what else each dtype takes: f32 needs
16-byte bases and strides in multiples of 4 elements (float4 loads, TMA's
16 bytes); bf16 needs 16-byte bases, strides in positive multiples of 8
elements (TMA's 16 bytes) and G <= 128.  The f32 route is a rule of shapes
and strides, never a retry: the tensor-core kernel takes ``Dh <= 128``,
G <= 128 and K/V strides that are positive where their index is longer
than 1 (its TMA maps); anything else runs on CUDA cores.  A row that sees no key gets what the reference
gives it: every key it scans has p = 1, so the sum of v over the Skv keys
divided by Skv rounded up to the scan's ``chunk`` (:func:`scanned_keys`).
``kv_valid`` reaches the kernels folded into the key positions: a key at
or past it takes the padding position, which no mask admits.
There is no backward: under autograd with an operand that requires grad
both entry points raise ``NotImplementedError``.

``LAUNCHES["flash_attention"]`` counts launches, and ``KERNEL_LAUNCHES``
counts them by the kernel launched (a key of ``KERNEL_CODES``);
``reset_launches`` sets both to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.direct_conv2d import (_check, _cuda_device, _library,
                                               _no_autograd, _stream)

__all__ = ["LAUNCHES", "reset_launches", "NEG_INF", "attend",
           "attend_plain", "check_operands", "f32_route",
           "KERNEL_CODES", "KERNEL_LAUNCHES", "flash_attention", "flash_attention_plain", "scanned_keys",
           "MAX_HEAD_DIM"]

NEG_INF = -1e30
PAD_POSITION = -(10 ** 9)   # the reference's position of padding keys
LAUNCHES = {"flash_attention": 0}
# the f32 kernel: threads per CTA, q rows per CTA, keys per staged block
THREADS, BLOCK_Q, BLOCK_K = 256, 64, 64
# the bf16 kernel: threads per CTA, rows per CTA (G heads x 128 // G
# positions), keys per K/V tile
BF16_THREADS, BF16_ROWS, BF16_BLOCK_K = 288, 128, 64
# the f32 tensor-core kernel: threads per CTA, rows per CTA, the largest
# head dim; its padded head dims (compiled instances)
TF32_THREADS, TF32_ROWS, TF32_MAX_HEAD_DIM = 384, 128, 128
TF32_HEAD_DIMS = (64, 80, 128)
MAX_HEAD_DIM = 256
# the C entry's kernel codes, and launches by the kernel launched
KERNEL_CODES = {"fma": 0, "bf16": 1, "tf32": 2}
KERNEL_LAUNCHES = dict.fromkeys(KERNEL_CODES, 0)
PLAIN_CHUNK = 2048          # the reference's KV chunk
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _declare(lib, ptr, i32) -> None:
    lib.flash_attention_fwd.argtypes = ([ptr] * 8 + [ctypes.c_float] * 2
                                        + [ptr])
    lib.flash_attention_fwd.restype = i32


def _lib() -> ctypes.CDLL:
    return _library("flash_attention", _declare, (THREADS, BLOCK_Q, BLOCK_K),
                    (("flash_attention_wgmma_geometry",
                      (BF16_THREADS, BF16_ROWS, BF16_BLOCK_K)),
                     ("flash_attention_tf32_geometry",
                      (TF32_THREADS, TF32_ROWS, TF32_MAX_HEAD_DIM))))


# ---------------------------------------------------------------------------
# the plain version: the reference's chunked online softmax
# ---------------------------------------------------------------------------

def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor,
                 causal: bool = True, window: Optional[int] = None,
                 cap: Optional[float] = None, scale: float,
                 kv_valid: Optional[torch.Tensor] = None,
                 chunk: int = PLAIN_CHUNK,
                 compact_probs: bool = False) -> torch.Tensor:
    """q: [B,Sq,KV,G,Dh] grouped; k/v: [B,Skv,KV,Dh] -> [B,Sq,KV,G,Dh].

    Scans KV in chunks with an online softmax: peak memory O(Sq * chunk)
    instead of O(Sq * Skv).  ``compact_probs`` keeps the [.., C]-sized
    scores and probabilities in bf16 storage, m, l and acc in f32."""
    b, sq, nkv, g, dh = q.shape
    skv = k.shape[1]
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=PAD_POSITION)
    kc = k.reshape(b, n_chunks, chunk, nkv, dh)
    vc = v.reshape(b, n_chunks, chunk, nkv, dh)
    pc = kv_positions.reshape(b, n_chunks, chunk)
    sdt = torch.bfloat16 if compact_probs else torch.float32
    qf = q if compact_probs else q.float()

    m = torch.full((b, sq, nkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, nkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, nkv, g, dh), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        kb, vb, pb = kc[:, i], vc[:, i], pc[:, i]
        kb = kb if compact_probs else kb.float()
        vb = vb if compact_probs else vb.float()
        # the scale in the scores' dtype, made on the device (no host sync)
        s = torch.einsum("bskgd,bckd->bskgc", qf.to(sdt), kb.to(sdt)) \
            * torch.full((), scale, dtype=sdt, device=q.device)
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        valid = pb[:, None, :] >= 0                                # [B,Sq,C]
        if kv_valid is not None:
            valid = valid & (pb[:, None, :] < kv_valid[:, None, None])
        if causal:
            valid = valid & (pb[:, None, :] <= q_positions[:, :, None])
        if window is not None:
            valid = valid & (pb[:, None, :] > q_positions[:, :, None] - window)
        s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None].to(sdt))
        l = l * alpha + p.sum(dim=-1, dtype=torch.float32)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", p, vb.to(sdt)).float()
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.to(q.dtype)


def scanned_keys(skv: int, chunk: int) -> int:
    """The keys :func:`attend_plain` scans: Skv rounded up to its chunk.
    A row that sees no key averages v over that many (the padding's v is
    0)."""
    c = max(1, min(chunk, skv))
    return -(-skv // c) * c


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32,
                        device=device)[None].expand(b, s).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True,
                          cap: Optional[float] = None) -> torch.Tensor:
    """The TPU kernel's function through :func:`attend_plain`: q [B, H, Sq,
    Dh], k/v [B, KV, Skv, Dh] -> like q, positions ``arange``."""
    b, h, sq, dh = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    qg = q.permute(0, 2, 1, 3).reshape(b, sq, nkv, h // nkv, dh)
    out = attend_plain(qg, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                       q_positions=_arange_positions(b, sq, q.device),
                       kv_positions=_arange_positions(b, skv, q.device),
                       causal=causal, cap=cap, scale=scale)
    return out.reshape(b, sq, h, dh).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def check_operands(dtype: torch.dtype, head_dim: int, groups: int,
                   operands) -> None:
    """Raise unless the CUDA kernel of ``dtype`` takes these operands.

    A function of shapes, strides and addresses alone, so that the rules
    are testable without a card.  ``operands``: ``(name, address, sizes,
    strides, last_stride)`` per operand, ``sizes`` and ``strides`` (in
    elements) over the indices the kernel steps: (batch, seq, kv head,
    group) for q and out, (batch, seq, kv head) for k and v.  f32 reads
    float4s: bases on 16 bytes, strides in multiples of 4 elements.  bf16
    reads through TMA tensor maps: bases on 16 bytes, the stride of every
    index longer than 1 a positive multiple of 8 elements (16 bytes), and
    at most ``BF16_ROWS`` query heads a KV head (one CTA's rows)."""
    if dtype not in _DTYPES:
        raise NotImplementedError(f"q is {dtype}: the kernel takes f32 or "
                                  "bf16")
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head dim {head_dim}: the kernel takes multiples of 8 up to "
            f"{MAX_HEAD_DIM}")
    bf16 = dtype == torch.bfloat16
    if bf16 and groups > BF16_ROWS:
        raise NotImplementedError(
            f"{groups} query heads a KV head: the bf16 kernel takes up to "
            f"{BF16_ROWS}")
    mult = 8 if bf16 else 4
    for name, address, sizes, strides, last in operands:
        if last != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if address % 16:
            raise ValueError(f"{name} is misaligned: it starts "
                             f"{address % 16} bytes past 16")
        bad = [s for n, s in zip(sizes, strides)
               if (n > 1 or not bf16) and (s % mult or (bf16 and s <= 0))]
        if bad:
            raise ValueError(
                f"{name}'s strides {tuple(strides)} (elements) must be "
                f"{'positive ' if bf16 else ''}multiples of {mult} for the "
                f"{'TMA tiles' if bf16 else 'vector loads'} of the "
                f"{str(dtype)[6:]} kernel")


def f32_route(head_dim: int, groups: int, kv_operands) -> str:
    """The f32 kernel that takes these operands: ``"tf32"`` (the tensor
    cores, ``flash_fwd_tf32``) where the head dim is at most
    ``TF32_MAX_HEAD_DIM``, a CTA's ``TF32_ROWS`` rows hold the ``groups``
    query heads of a KV head, and every K/V stride of an index longer than 1
    is positive (its TMA maps), else ``"fma"`` (CUDA cores,
    ``flash_fwd_kernel``).  ``kv_operands``: ``(sizes, strides)`` of k and
    v over (batch, seq, kv head).  A function of shapes and strides alone,
    tested on the CPU."""
    if head_dim > TF32_MAX_HEAD_DIM or groups > TF32_ROWS:
        return "fma"
    for sizes, strides in kv_operands:
        if any(n > 1 and st <= 0 for n, st in zip(sizes, strides)):
            return "fma"
    return "tf32"


def _launch(q, k, v, out, q_strides, k_strides, v_strides, o_strides, *,
            kv_heads: int, groups: int, sq: int, skv: int,
            q_positions, kv_positions, kv_valid, causal: bool,
            window: Optional[int], cap: Optional[float],
            scale: float, chunk: int, kernel: Optional[str] = None) -> None:
    """One launch; ``*_strides`` in elements: q/out (batch, seq, kv head,
    group), k/v (batch, seq, kv head); ``chunk``: the plain version's, which
    sets the average a row that sees no key gets; ``kernel`` (f32: "tf32"
    or "fma"): the route's by default, the other for
    ``launch/flash_f32_ab.py``.  Counts the launch in ``LAUNCHES`` and, by
    the kernel launched, in ``KERNEL_LAUNCHES``."""
    dev = _cuda_device(q)
    dh = q.shape[-1]
    for t, name in ((k, "k"), (v, "v")):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {dev}")
        if t.shape[-1] != dh:
            raise ValueError(f"{name}'s head dim {t.shape[-1]} != q's {dh}")
    b = q.shape[0]
    q_sizes = (b, sq, kv_heads, groups)
    check_operands(q.dtype, dh, groups, (
        ("q", q.data_ptr(), q_sizes, q_strides, q.stride(-1)),
        ("k", k.data_ptr(), (b, skv, kv_heads), k_strides, k.stride(-1)),
        ("v", v.data_ptr(), (b, skv, kv_heads), v_strides, v.stride(-1)),
        ("out", out.data_ptr(), q_sizes, o_strides, out.stride(-1))))
    qp = q_positions.to(device=dev, dtype=torch.int32).contiguous()
    kp = kv_positions.to(device=dev, dtype=torch.int32).contiguous()
    if tuple(qp.shape) != (b, sq) or tuple(kp.shape) != (b, skv):
        raise ValueError(f"positions {tuple(qp.shape)}/{tuple(kp.shape)} != "
                         f"{(b, sq)}/{(b, skv)}")
    if kv_valid is not None:
        # the kernels read kv_valid through the key positions: a key at or
        # past it takes the padding position, which no mask admits
        kvv = kv_valid.to(device=dev, dtype=torch.int32)
        if tuple(kvv.shape) != (b,):
            raise ValueError(f"kv_valid shape {tuple(kvv.shape)} != ({b},)")
        kp = torch.where(kp < kvv[:, None], kp, PAD_POSITION)
    kv_sizes = (b, skv, kv_heads)
    if kernel is None:
        kernel = ("bf16" if q.dtype == torch.bfloat16 else
                  f32_route(dh, groups, ((kv_sizes, k_strides),
                                         (kv_sizes, v_strides))))
    lib = _lib()
    strides = (ctypes.c_longlong * 14)(*q_strides, *k_strides, *v_strides,
                                       *o_strides)
    ints = (ctypes.c_int * 12)(
        b, kv_heads, groups, sq, skv, dh, int(causal), int(window is not None),
        0 if window is None else int(window), int(cap is not None),
        KERNEL_CODES[kernel], scanned_keys(skv, chunk))
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qp.data_ptr(), kp.data_ptr(), strides, ints, float(scale),
        0.0 if cap is None else float(cap), _stream(dev))
    _check(err, lib, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    KERNEL_LAUNCHES[kernel] += 1


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_positions: torch.Tensor, kv_positions: torch.Tensor,
           causal: bool = True, window: Optional[int] = None,
           cap: Optional[float] = None, scale: float,
           kv_valid: Optional[torch.Tensor] = None,
           chunk: int = PLAIN_CHUNK,
           compact_probs: bool = False) -> torch.Tensor:
    """q: [B,Sq,KV,G,Dh] grouped; k/v: [B,Skv,KV,Dh] -> [B,Sq,KV,G,Dh] in
    q's dtype.  ``q_positions`` [B, Sq], ``kv_positions`` [B, Skv] (int),
    ``kv_valid`` [B] or None.  ``chunk`` is the plain version's KV chunk;
    the kernels stage blocks of ``BLOCK_K`` (f32) or ``BF16_BLOCK_K``
    (bf16) keys whatever it is, and read it only for the rows that see no
    key."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"expected q [B,Sq,KV,G,Dh] and k/v [B,Skv,KV,Dh], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _no_autograd("flash attention", q, k, v)
    if q.device.type == "cpu":
        return attend_plain(q, k, v, q_positions=q_positions,
                            kv_positions=kv_positions, causal=causal,
                            window=window, cap=cap, scale=scale,
                            kv_valid=kv_valid, chunk=chunk,
                            compact_probs=compact_probs)
    if compact_probs:
        raise NotImplementedError("the kernel keeps scores in f32 registers; "
                                  "compact_probs is a plain-path option")
    b, sq, nkv, g, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, q.stride()[:4], k.stride()[:3], v.stride()[:3],
            out.stride()[:4], kv_heads=nkv, groups=g, sq=sq,
            skv=k.shape[1], q_positions=q_positions,
            kv_positions=kv_positions, kv_valid=kv_valid, causal=causal,
            window=window, cap=cap, scale=scale, chunk=chunk)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    cap: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Sq, Dh]; k/v: [B, KV, Skv, Dh] (KV divides H) -> like q.
    Causality by position, ``arange`` on both sides (the TPU kernel's
    mask).  Sq and Skv need not be multiples of any block."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or q.shape[1] % k.shape[1]:
        raise ValueError(f"expected q [B,H,Sq,Dh] and k/v [B,KV,Skv,Dh] with "
                         f"KV | H, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _no_autograd("flash attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     cap=cap)
    b, h, sq, _ = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    g = h // nkv
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sb, sh, ss, _ = q.stride()
    ob, oh, os_, _ = out.stride()
    _launch(q, k, v, out, (sb, ss, g * sh, sh),
            (k.stride(0), k.stride(2), k.stride(1)),
            (v.stride(0), v.stride(2), v.stride(1)), (ob, os_, g * oh, oh),
            kv_heads=nkv, groups=g, sq=sq, skv=skv,
            q_positions=_arange_positions(b, sq, q.device),
            kv_positions=_arange_positions(b, skv, q.device),
            kv_valid=None, causal=causal, window=None, cap=cap, scale=scale,
            chunk=PLAIN_CHUNK)
    return out
