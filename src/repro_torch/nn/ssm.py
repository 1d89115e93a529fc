"""Mamba-2 (SSD, state-space duality) mixer, used by mamba2-780m.

The port of ``repro/nn/ssm.py``.  The chunked SSD algorithm (Dao & Gu 2024)
computes the selective-SSM recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T ;   y_t = C_t h_t + D x_t

as chunk-local attention-like products plus a cross-chunk state scan.
``ssd_naive`` is the step-by-step recurrence oracle the chunked path is
tested against.

The causal depthwise conv1d in front of (x, B, C) is the paper's direct
convolution: ``Mamba2.forward`` hands ``kernels.conv1d_depthwise`` the
``xBC`` columns of ``in_proj``'s output as a strided view (row stride
``2*d_inner + 2*G*N + H``), which the CUDA kernel reads in place.  The SSD
products and the decode step's conv over its ring window are plain torch, as
the reference computes them outside any Pallas kernel.  ``jax.lax.scan``
becomes a Python loop over chunks (or steps).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.conv1d_depthwise import conv1d_depthwise
from repro_torch.nn.layers import Init, SpecModule
from repro_torch.nn.module import ParamSpec

__all__ = ["ssd_chunked", "ssd_naive", "ssd_decode_step", "Mamba2",
           "MambaCache"]


class MambaCache(NamedTuple):
    """Decode state: conv ring (last K-1 inputs) + SSM state."""
    conv: torch.Tensor       # [B, K-1, conv_dim]
    ssm: torch.Tensor        # [B, H, P, N] float32


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def ssd_naive(x, dt, a, b, c, d_skip=None):
    """Step-recurrence oracle.  x:[Bt,L,H,P] dt:[Bt,L,H] a:[H] b,c:[Bt,L,G,N]."""
    bt, l, h, p = x.shape
    rep = h // b.shape[2]
    bf = torch.repeat_interleave(b, rep, dim=2).float()       # [Bt,L,H,N]
    cf = torch.repeat_interleave(c, rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    hstate = torch.zeros((bt, h, p, b.shape[-1]), dtype=torch.float32,
                         device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * a)[..., None, None]     # [Bt,H,1,1]
        upd = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           bf[:, t])
        hstate = decay * hstate + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", hstate, cf[:, t]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunked(x, dt, a, b, c, d_skip=None, chunk: int = 256,
                compact: bool = False):
    """Chunked SSD.  Same shapes as ``ssd_naive``; L/Q sequential steps.

    Group-aware: B/C stay [.., G, N] and heads appear only as the (G, rep)
    split of the H axis, so the C.B Gram matrix is computed once per group
    and no repeated copy of B or C exists.  ``compact`` stores the O(Q^2)
    intra-chunk tensors (decay matrix, C.B products) in bf16; sums are f32.
    """
    bt, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"sequence {l} is not a multiple of the SSD chunk "
                         f"{q}")
    nc = l // q
    rep = h // g

    xf = x.float().reshape(bt, nc, q, g, rep, p)
    dtf = dt.float().reshape(bt, nc, q, g, rep)
    bf = b.float().reshape(bt, nc, q, g, n)
    cf = c.float().reshape(bt, nc, q, g, n)

    da = dtf * a.reshape(g, rep)[None, None, None]            # log-decay
    cs = torch.cumsum(da, dim=2)                              # [Bt,nc,Q,G,R]
    seg = cs[:, :, :, None] - cs[:, :, None, :]               # cs_i - cs_j
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldecay = torch.where(mask[None, None, :, :, None, None], torch.exp(seg),
                         torch.zeros((), device=x.device))

    xb = xf * dtf[..., None]                                  # dt-scaled input
    qdt = torch.bfloat16 if compact else torch.float32
    ldecay = ldecay.to(qdt)
    # intra-chunk: Y1[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xb_j;
    # cb and ldecay are stored in qdt, the contraction is f32 over the
    # stored values (the reference's preferred_element_type=f32)
    cb = torch.einsum("bzign,bzjgn->bzijg", cf.to(qdt), bf.to(qdt))
    y1 = torch.einsum("bzijg,bzijgr,bzjgrp->bzigrp", cb.float(),
                      ldecay.float(), xb.to(qdt).float())

    # chunk states: S_z = sum_j exp(cs_last - cs_j) B_j (x) xb_j
    tail = torch.exp(cs[:, :, -1:] - cs)                      # [Bt,nc,Q,G,R]
    s_z = torch.einsum("bzjgr,bzjgn,bzjgrp->bzgrnp", tail, bf, xb)
    total = torch.exp(cs[:, :, -1])                           # [Bt,nc,G,R]

    hprev = torch.zeros((bt, g, rep, n, p), dtype=torch.float32,
                        device=x.device)
    hprevs = []
    for z in range(nc):
        hprevs.append(hprev)
        hprev = total[:, z][..., None, None] * hprev + s_z[:, z]
    hprevs = torch.stack(hprevs, dim=1)                       # [Bt,nc,G,R,N,P]

    # inter-chunk: Y2[i] = exp(cs_i) * C_i . h_prev(chunk)
    y2 = torch.einsum("bzigr,bzign,bzgrnp->bzigrp", torch.exp(cs), cf,
                      hprevs)

    y = (y1 + y2).reshape(bt, l, h, p)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd_decode_step(hstate, xt, dtt, a, bt_, ct, d_skip=None):
    """One-token recurrence.  hstate: [B,H,P,N] f32 -> (y [B,H,P], hstate)."""
    xf = xt.float()
    dtf = dtt.float()
    decay = torch.exp(dtf * a)[..., None, None]
    upd = torch.einsum("bhp,bhn->bhpn", xf * dtf[..., None], bt_.float())
    hstate = decay * hstate + upd
    y = torch.einsum("bhpn,bhn->bhp", hstate, ct.float())
    if d_skip is not None:
        y = y + d_skip.float()[None, :, None] * xf
    return y, hstate


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------

class Mamba2(SpecModule):
    def __init__(self, d_model: int, cfg: SSMConfig, init: Init,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.d_model, self.cfg, self.norm_eps = d_model, cfg, norm_eps
        self._draw(init)

    @property
    def d_inner(self) -> int:
        return self.cfg.d_inner(self.d_model)

    @property
    def n_heads(self) -> int:
        return self.cfg.n_heads(self.d_model)

    @property
    def conv_dim(self) -> int:
        return self.cfg.conv_dim(self.d_model)

    def specs(self):
        d, di, cd = self.d_model, self.d_inner, self.conv_dim
        h, gn = self.n_heads, self.cfg.n_groups * self.cfg.d_state
        return {
            # in_proj -> [z (di), x (di), B (gn), C (gn), dt (h)]
            "in_proj": {"w": ParamSpec((d, 2 * di + 2 * gn + h))},
            "conv_w": ParamSpec((self.cfg.d_conv, cd)),
            "conv_b": ParamSpec((cd,), init="zeros"),
            # A = -exp(a_log) and dt = softplus(x + dt_bias), drawn as the
            # published Mamba-2 draws them (A in [1, 16], dt in [1e-3,
            # 1e-1]); the reference starts both at 0 (A = -1), which makes
            # the bf16 model drift from the f32 one ~5x more (ROADMAP C)
            "a_log": ParamSpec((h,), init="log_uniform",
                               bounds=(1.0, 16.0)),
            "dt_bias": ParamSpec((h,), init="softplus_inv_log_uniform",
                                 bounds=(1e-3, 1e-1)),
            "d_skip": ParamSpec((h,), init="ones"),
            "norm": {"w": ParamSpec((di,), init="ones")},
            "out_proj": {"w": ParamSpec((di, d))},
        }

    def _split(self, zxbcdt):
        """-> views (z, xBC, dt) of the in_proj output's columns."""
        di = self.d_inner
        gn, h = self.cfg.n_groups * self.cfg.d_state, self.n_heads
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:di + di + 2 * gn]
        dt = zxbcdt[..., di + di + 2 * gn:]
        if dt.shape[-1] != h:
            raise ValueError(f"in_proj output {zxbcdt.shape[-1]} columns do "
                             f"not split into z, xBC and {h} dt")
        return z, xbc, dt

    def _post(self, y, z):
        """Gated RMSNorm + out_proj.  y,z: [B, L, d_inner]."""
        yf = y.float() * F.silu(z.float())
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
        yf = yf * torch.rsqrt(var + self.norm_eps) * self.norm.w.float()
        return yf.to(z.dtype) @ self.out_proj.w.to(z.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, L, D] -> [B, L, D] (prefill)."""
        bsz, l, _ = x.shape
        s = self.cfg
        zxbcdt = x @ self.in_proj.w.to(x.dtype)
        z, xbc, dt = self._split(zxbcdt)
        # the direct depthwise causal conv (the paper's kernel) on the
        # strided xBC view, then SiLU
        xbc = conv1d_depthwise(xbc, self.conv_w, self.conv_b)
        xbc = F.silu(xbc.float()).to(x.dtype)
        di, gn = self.d_inner, s.n_groups * s.d_state
        xi = xbc[..., :di].reshape(bsz, l, self.n_heads, s.head_dim)
        b = xbc[..., di:di + gn].reshape(bsz, l, s.n_groups, s.d_state)
        c = xbc[..., di + gn:].reshape(bsz, l, s.n_groups, s.d_state)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        a = -torch.exp(self.a_log.float())
        y = ssd_chunked(xi, dt, a, b, c, d_skip=self.d_skip, chunk=s.chunk)
        return self._post(y.reshape(bsz, l, di), z)

    # -- decode --------------------------------------------------------
    def init_cache(self, batch: int, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> MambaCache:
        return MambaCache(
            conv=torch.zeros((batch, self.cfg.d_conv - 1, self.conv_dim),
                             dtype=dtype, device=device),
            ssm=torch.zeros((batch, self.n_heads, self.cfg.head_dim,
                             self.cfg.d_state), dtype=torch.float32,
                            device=device))

    def decode(self, x: torch.Tensor, cache: MambaCache
               ) -> Tuple[torch.Tensor, MambaCache]:
        """x: [B, 1, D] -> ([B, 1, D], new cache).  O(1) per token."""
        bsz = x.shape[0]
        s = self.cfg
        zxbcdt = x[:, 0] @ self.in_proj.w.to(x.dtype)
        z, xbc, dt = self._split(zxbcdt)
        # conv ring: window = [cache.conv, xbc]
        # (promoted like jnp.concatenate: an f32 xBC turns a bf16 ring f32)
        wdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
        win = torch.cat([cache.conv.to(wdt), xbc[:, None].to(wdt)],
                        dim=1)                                # [B,K,cd]
        conv_out = torch.einsum("bkc,kc->bc", win.float(),
                                self.conv_w.float())
        conv_out = conv_out + self.conv_b.float()
        xbc_c = F.silu(conv_out).to(x.dtype)
        new_conv = win[:, 1:]

        di, gn = self.d_inner, s.n_groups * s.d_state
        xi = xbc_c[..., :di].reshape(bsz, self.n_heads, s.head_dim)
        b = xbc_c[..., di:di + gn].reshape(bsz, s.n_groups, s.d_state)
        c = xbc_c[..., di + gn:].reshape(bsz, s.n_groups, s.d_state)
        rep = self.n_heads // s.n_groups
        bh = torch.repeat_interleave(b, rep, dim=1)
        ch = torch.repeat_interleave(c, rep, dim=1)
        dtv = F.softplus(dt.float() + self.dt_bias.float())
        a = -torch.exp(self.a_log.float())
        y, hstate = ssd_decode_step(cache.ssm, xi, dtv, a, bh, ch,
                                    d_skip=self.d_skip)
        y = y.reshape(bsz, 1, di).to(x.dtype)
        out = self._post(y, z[:, None])
        return out, MambaCache(conv=new_conv, ssm=hstate)
