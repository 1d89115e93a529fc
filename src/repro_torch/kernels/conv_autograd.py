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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conv2d_common import (apply_activation,
                                            blocked_global_avg_pool)
from repro_torch.core.convspec import ConvSpec

__all__ = ["BlockedConvFunction"]


class BlockedConvFunction(torch.autograd.Function):
    """``act(conv(x, w) + b) + r``, pooled with ``gap``, with the family's
    backward kernels as its VJP."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, family, spec: ConvSpec,
                activation: Optional[str], gap: bool):
        z = family.preactivation(x, w, bias, spec)
        linear = activation in (None, "linear")
        out = z if linear else apply_activation(z, activation)
        if residual is not None:
            out = out + residual
        if gap:
            out = blocked_global_avg_pool(out)
        ctx.save_for_backward(x, w, None if linear else z)
        ctx.family, ctx.spec = family, spec
        ctx.activation, ctx.gap = activation, gap
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, z = ctx.saved_tensors
        spec = ctx.spec
        if ctx.gap:
            n, coblk, cob = x.shape[0], w.shape[0], w.shape[5]
            g = (g.reshape(n, coblk, 1, 1, cob) / (spec.ho * spec.wo)).expand(
                n, coblk, spec.ho, spec.wo, cob)
        g = g.contiguous()
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        dx = dw = db = None
        if need_x:
            dx = ctx.family.dgrad(g, w, spec, z, ctx.activation)
        if need_w or need_b:
            dw, db = ctx.family.wgrad(x, g, spec, z, ctx.activation,
                                      ctx.has_bias)
        return (dx, dw if need_w else None, db if need_b else None,
                g if need_r else None, None, None, None, None)
