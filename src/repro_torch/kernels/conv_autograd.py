"""The custom VJP of the blocked conv kernels, shared by their families.

The reference gives each kernel family its own ``jax.custom_vjp`` of one
shape (``repro/kernels/direct_conv2d.py:655-790`` ``_conv``,
``conv2d_pointwise.py:351-420`` ``_pwconv``, ``conv2d_depthwise.py:354-440``
``_dwconv``): the forward kernel with a linear epilogue gives the
pre-activation ``z``; the activation, the residual add and the GAP follow
outside the kernel; the backward spreads a pooled cotangent over the map,
passes the cotangent on as the residual's gradient, and runs the family's
dgrad and wgrad kernels, which form ``dz = g * act'(z)`` themselves, with
``db`` from the wgrad pass.  ``BlockedConvFunction`` is that shape once;
each family hands it an object with three functions of the family's own
wrappers:

* ``preactivation(x, w, bias, spec)`` -> ``z``;
* ``dgrad(g, w, spec, z, activation)`` -> ``dx`` at the unpadded input's
  shape;
* ``wgrad(x, g, spec, z, activation, with_db)`` -> ``(dw, db)``.

Saved are ``x`` (unpadded; the reference saves its padded copy), ``w`` and
``z`` unless the activation is linear.  The dgrad is skipped when ``x``
needs no grad, as for the images at a network's first layer.  On CPU
tensors the families' wrappers run their plain versions, in the operands'
dtype when that is wider than f32, so gradcheck can run in f64.

Under ``BF16`` (the dense family only; the others refuse it before they
get here) the cast discipline is the reference's ``_conv_fwd`` /
``_conv_bwd`` (``repro/kernels/direct_conv2d.py:680-787``): ``x`` and ``w``
are cast to bf16 once, and those bf16 copies are what is saved (the f32
masters are not); ``z`` (f32 sums plus the f32 bias, rounded once) is saved
at the policy's residual dtype; the activation, the residual add and the
GAP mean are each taken in f32 with one down-cast to ``z``'s dtype.  The
backward spreads a pooled cotangent in f32, casts ``g`` to bf16 once, and
returns ``dx`` at ``x``'s dtype (the dgrad's bf16 ``dx``, up-cast), ``dw``
and ``db`` from the f32 wgrad at the masters' dtypes (never through bf16),
and the residual's cotangent ``g`` at the residual's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv2d_common import (apply_activation,
                                            blocked_global_avg_pool)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.precision import F32, Precision

__all__ = ["BlockedConvFunction"]


def _wide(t: torch.Tensor) -> torch.dtype:
    """f32, or ``t``'s dtype where that is wider (f64 under gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


class BlockedConvFunction(torch.autograd.Function):
    """``act(conv(x, w) + b) + r``, pooled with ``gap``, with the family's
    backward kernels as its VJP, under ``precision`` (F32, or BF16 for the
    dense family)."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, family, spec: ConvSpec,
                activation: Optional[str], gap: bool,
                precision: Precision = F32):
        ctx.dtypes = (x.dtype, w.dtype,
                      None if bias is None else bias.dtype,
                      None if residual is None else residual.dtype)
        narrow = precision.op_dtype != torch.float32
        if narrow:                       # the one down-cast of the forward
            x, w = x.to(precision.op_dtype), w.to(precision.op_dtype)
        z = family.preactivation(x, w, bias, spec)
        linear = activation in (None, "linear")
        out = z if linear else apply_activation(
            z.to(_wide(z)), activation).to(z.dtype)
        if residual is not None:
            out = (out.to(_wide(out)) + residual.to(_wide(out))).to(z.dtype)
        if gap:
            out = blocked_global_avg_pool(out)
        saved_z = None if linear else (z.to(precision.residual_dtype)
                                       if narrow else z)
        ctx.save_for_backward(x, w, saved_z)
        ctx.family, ctx.spec = family, spec
        ctx.activation, ctx.gap = activation, gap
        ctx.op = precision.op_dtype if narrow else None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, z = ctx.saved_tensors
        x_dtype, w_dtype, b_dtype, r_dtype = ctx.dtypes
        spec = ctx.spec
        if ctx.gap:
            n, coblk, cob = x.shape[0], w.shape[0], w.shape[5]
            g = (g.to(_wide(g)).reshape(n, coblk, 1, 1, cob)
                 / (spec.ho * spec.wo)).expand(n, coblk, spec.ho, spec.wo,
                                               cob)
        if ctx.op is not None:           # the backward kernels' operand
            g = g.to(ctx.op)
        g = g.contiguous()
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        dx = dw = db = None
        if need_x:
            dx = ctx.family.dgrad(g, w, spec, z, ctx.activation).to(x_dtype)
        if need_w or need_b:
            dw, db = ctx.family.wgrad(x, g, spec, z, ctx.activation,
                                      b_dtype is not None)
            dw = dw.to(w_dtype)
            db = None if db is None else db.to(b_dtype)
        return (dx, dw if need_w else None, db if need_b else None,
                g.to(r_dtype) if need_r else None, None, None, None, None,
                None)
