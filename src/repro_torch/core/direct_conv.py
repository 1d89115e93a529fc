"""Zero-memory-overhead direct convolution (paper §3), plain PyTorch.

``direct_conv_blocked`` is the plain version of the forward kernels: the
tap loop of the reference (``repro/core/direct_conv.py``) as one product
per filter tap over a strided view of the padded blocked input,
accumulated in f32, followed by the fused epilogue (bias, activation,
residual, one downcast) and the optional GAP rider.  Per tap, a dense conv
contracts the Cib pencil (``torch.einsum``); a depthwise conv (``groups ==
C``, weight ``[C/Cb, 1, Hf, Wf, 1, Cb]``, the reference's depthwise-lanes
geometry) multiplies each lane by its own tap weight.  Filter dilation
strides the tap origins.  The CPU path of every layer runs it, and
``chip_smoke.py`` holds the CUDA kernels against it on the card.

``direct_conv_dgrad_blocked`` and ``direct_conv_wgrad_blocked`` are the
plain versions of the backward kernels, dense, grouped and depthwise, at
any dilation: the transposes of that tap loop (what ``jax.vjp`` of the
reference gives), tap by tap, with the ``dz = g * act'(z)`` prologue and
``db``.  They
accumulate in f32, or in f64 for f64 operands, so that the CPU can check
gradients numerically and ``chip_smoke.py`` can hold the wgrad kernels'
long sums against f64.  They pad and crop copies freely: they are
references, not the main path.  ``direct_conv_dgrad_phased`` computes the
dense or grouped dgrad at any dilation the way the CUDA dgrad kernels split
it, phase by phase against the stride (``core.blocking.dgrad_phase_axes``);
only the tests use it, to hold that geometry to the reference.

A grouped conv (``groups > 1`` with more than one input channel per group,
weight ``[Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob]``) contracts each group's
blocks with that group's weight blocks alone, as the reference's oracle
does and ``jax.vjp`` of it gives: output block ``co`` reads input blocks
``(co // cogblk) * cigblk + ci`` for ``ci < cigblk``; input block ``ci``'s
gradient contracts the cotangent blocks ``(ci // cigblk) * cogblk + co``
for ``co < cogblk``; weight block ``(co, ci)`` takes input block ``(co //
cogblk) * cigblk + ci``.  Cross-group blocks are never formed.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.blocking import dgrad_extents, dgrad_phase_axes
from repro_torch.core import layout as L
from repro_torch.core.conv2d_common import (apply_activation,
                                            cotangent_prologue, epilogue,
                                            gap_finalize, gap_partials,
                                            tap_windows)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.padding import Padding
from repro_torch.core.precision import resolve_precision

__all__ = ["apply_activation", "pad_blocked", "bias_to_blocked",
           "direct_conv_blocked", "direct_conv_nhwc",
           "direct_conv_preactivation",
           "direct_conv_dgrad_blocked", "direct_conv_dgrad_phased",
           "direct_conv_wgrad_blocked",
           "conv_spec", "backward_spec",
           "direct_conv1d_depthwise"]


def pad_blocked(x: torch.Tensor, ph, pw) -> torch.Tensor:
    """Zero-pad the spatial dims of a blocked map ``[N, C/Cb, H, W, Cb]``."""
    if not (any(ph) or any(pw)):
        return x
    # F.pad lists pads from the last dim backwards: (Cb, W, H)
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def bias_to_blocked(bias: torch.Tensor, cb_out: int) -> torch.Tensor:
    """Flat bias ``[Co] -> [Co/Cb, Cb]`` channel pencils, zero-padding Co up
    to a pencil multiple when needed (matching pad-to-block maps)."""
    co = bias.shape[0]
    if co % cb_out:
        bias = F.pad(bias, (0, -co % cb_out))
    return bias.reshape(-1, cb_out)


def _geometry(n: int, hi: int, wi: int, w_shape, stride: int,
              padding: Padding, groups: int, dilation,
              ci: Optional[int] = None) -> ConvSpec:
    """The spec of a conv with blocked weights of ``w_shape`` over an input
    of ``ci`` channels: dense ``[Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob]``,
    grouped ``[Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob]`` (``Cig = Ci /
    groups``) or depthwise ``[C/Cb, 1, Hf, Wf, 1, Cb]``; ``ci`` None takes
    it from the weight (``Cig x groups``, the depthwise ``C``)."""
    coblk, ciblk_w, hf, wf, cib_w, cob = w_shape
    co = coblk * cob
    if ci is None:
        ci = co if groups > 1 and cib_w == 1 else ciblk_w * cib_w * groups
    spec = ConvSpec.make(n, hi, wi, ci, co, hf, wf, stride=stride,
                         padding=padding, groups=groups, dilation=dilation)
    if spec.is_grouped and not spec.is_depthwise:
        if spec.cig != ciblk_w * cib_w or coblk % groups:
            raise ValueError(
                f"a grouped weight is [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob] "
                f"with Cig = {spec.cig} and groups={groups} dividing the "
                f"output blocks; got {tuple(w_shape)}")
    if spec.is_depthwise and (ciblk_w, cib_w) != (1, 1):
        raise ValueError(f"a depthwise weight is [C/Cb, 1, Hf, Wf, 1, Cb]; "
                         f"got {tuple(w_shape)}")
    if spec.ho <= 0 or spec.wo <= 0:
        raise ValueError(f"empty output for input {hi}x{wi}, filter {hf}x{wf}")
    return spec


def conv_spec(x: torch.Tensor, w: torch.Tensor, stride: int,
              padding: Padding, groups: int = 1,
              dilation=1) -> ConvSpec:
    """The conv geometry of blocked operands, dense, grouped or depthwise;
    raises on operands that do not chain."""
    if x.dim() != 5 or w.dim() != 6:
        raise ValueError(f"expected x [N, Ci/Cib, H, W, Cib] and w [Co/Cob, "
                         f"Ci/Cib, Hf, Wf, Cib, Cob]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    n, ciblk, hi, wi, cib = x.shape
    spec = _geometry(n, hi, wi, w.shape, stride, padding, groups, dilation,
                     ciblk * cib)
    # a depthwise conv keeps the map's pencil; a dense or grouped one
    # contracts it, each group its own Cig/Cib blocks
    want = (w.shape[0], w.shape[5]) if spec.is_depthwise else \
        (w.shape[1] * groups, w.shape[4])
    if want != (ciblk, cib):
        raise ValueError(f"weight input blocks {want} do not match the "
                         f"map's {(ciblk, cib)}")
    return spec


def _acc_dtype(*tensors: torch.Tensor) -> torch.dtype:
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _accumulate(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
                dtype: torch.dtype) -> torch.Tensor:
    """``sum_taps x_win @ w[tap]`` (dense; grouped: block-diagonal, each
    group's output blocks over its own input blocks) or ``x_win * w[tap]``
    (depthwise) in ``dtype`` -> ``[N, Co/Cob, Ho, Wo, Cob]``."""
    xp = pad_blocked(x, *spec.pads).to(dtype)
    wd = w.to(dtype)
    g = spec.groups
    acc = None
    for (dh, dw), win in tap_windows(xp, spec.hf, spec.wf, spec.ho, spec.wo,
                                     spec.stride, spec.dilation):
        if spec.is_depthwise:
            term = win * wd[:, 0, dh, dw, 0][None, :, None, None, :]
        elif g > 1:
            # [N, G, Cig/Cib, Ho, Wo, Cib] x [G, Cog/Cob, Cig/Cib, Cib, Cob]
            #   -> [N, G, Cog/Cob, Ho, Wo, Cob]
            n, ciblk, ho, wo, cib = win.shape
            coblk, cigblk, _, _, _, cob = wd.shape
            term = torch.einsum(
                "ngchwb,gocbk->ngohwk",
                win.reshape(n, g, cigblk, ho, wo, cib),
                wd[:, :, dh, dw].reshape(g, coblk // g, cigblk, cib, cob),
            ).reshape(n, coblk, ho, wo, cob)
        else:
            # [N, Ci/Cib, Ho, Wo, Cib] x [Co/Cob, Ci/Cib, Cib, Cob]
            #   -> [N, Co/Cob, Ho, Wo, Cob]
            term = torch.einsum("nchwb,ocbk->nohwk", win, wd[:, :, dh, dw])
        acc = term if acc is None else acc + term
    return acc


def direct_conv_blocked(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                        padding: Padding = "VALID",
                        bias: Optional[torch.Tensor] = None,
                        activation: Optional[str] = None,
                        precision=None, groups: int = 1, dilation=1,
                        residual: Optional[torch.Tensor] = None,
                        gap: bool = False) -> torch.Tensor:
    """Direct convolution on blocked layouts with the fused epilogue.

    x: ``[N, Ci/Cib, Hi, Wi, Cib]``; w: ``[Co/Cob, Ci/Cib, Hf, Wf, Cib,
    Cob]``, or ``[C/Cb, 1, Hf, Wf, 1, Cb]`` with ``groups == C``
    (depthwise); bias: ``[Co/Cob, Cob]`` or None; residual: the output's
    shape or None -> ``[N, Co/Cob, Ho, Wo, Cob]`` in the operand dtype, or
    with ``gap=True`` the pooled ``[N, Co]`` features.

    ``padding`` is TF-SAME aware (asymmetric at stride 2), against the
    dilated filter extent.  ``precision`` casts the operands once; the
    products then run on f32 copies of the cast values, so a bf16 policy is
    bf16 operands with an f32 sum.  The pooled features are the f32 mean
    of the *stored* (downcast) map, cast to the operand dtype.
    """
    spec = conv_spec(x, w, stride, padding, groups, dilation)
    if precision is not None:
        op = resolve_precision(precision).op_dtype
        x, w = x.to(op), w.to(op)
        if residual is not None:
            residual = residual.to(op)
    out_dtype = x.dtype
    acc = _accumulate(x, w, spec, torch.float32)
    out = epilogue(acc, bias, activation, residual, out_dtype)
    if gap:
        pooled = gap_finalize(gap_partials(out, spec.ho, spec.wo),
                              spec.ho * spec.wo)
        return pooled.to(out_dtype)
    return out


def direct_conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: Padding = "VALID",
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None,
                     pad_to_block: bool = False, lane: int = 128,
                     groups: int = 1, dilation=1) -> torch.Tensor:
    """NHWC map and HWIO weights in, NHWC out, through the blocked layouts:
    a layout sandwich around :func:`direct_conv_blocked` (block, convolve,
    unblock) with the pencils of ``layout.BlockedConvLayout.choose`` and
    the bias blocked by :func:`bias_to_blocked`.  ``pad_to_block=True``
    zero-pads non-divisible channel counts up to full pencils and strips
    them on the way out (dense only; the traded bytes are
    ``memory_model.bytes_channel_pad``).  Grouped weights carry the
    per-group input extent, ``w.shape[2] == Ci // groups``."""
    hf, wf, cig, co = w.shape
    ci = x.shape[-1]
    if ci != cig * groups:
        raise ValueError(
            f"weight input extent {cig} x groups {groups} != input "
            f"channels {ci}")
    if pad_to_block:
        if groups != 1:
            raise ValueError("pad_to_block supports dense convs only")
        cb_in = L.choose_pencil(ci, lane, pad_to_block=True)
        cb_out = L.choose_pencil(co, lane, pad_to_block=True)
        cb_w = cb_in
    else:
        lay = L.BlockedConvLayout.choose(ci, co, lane, groups=groups)
        cb_in, cb_out, cb_w = lay.cb_in, lay.cb_out, lay.cb_weight
    xb = L.nhwc_to_blocked(x, cb_in, pad_to_block=pad_to_block)
    wb = L.hwio_to_blocked(w, cb_w, cb_out, pad_to_block=pad_to_block)
    bb = None if bias is None else bias_to_blocked(bias, cb_out)
    yb = direct_conv_blocked(xb, wb, stride, padding, bb, activation,
                             groups=groups, dilation=dilation)
    return L.blocked_to_nhwc(yb, co)


def _cast(policy, *ts):
    """``ts`` cast to ``policy``'s operand dtype (None: unchanged)."""
    if policy is None:
        return ts
    op = resolve_precision(policy).op_dtype
    return tuple(None if t is None else t.to(op) for t in ts)


def direct_conv_preactivation(x: torch.Tensor, w: torch.Tensor,
                              stride: int = 1, padding: Padding = "VALID",
                              bias: Optional[torch.Tensor] = None,
                              groups: int = 1, dilation=1,
                              precision=None) -> torch.Tensor:
    """The training forward's ``z = conv(x, w) + b``, the forward kernels'
    plain version with a linear epilogue, accumulated in f32 (f64 for f64
    operands) and returned in that dtype; with ``precision`` the operands
    are cast to its operand dtype first and ``z``, the f32 sum plus the
    bias, is rounded to it once (bf16 under ``BF16``, as the forward's bf16
    build stores it)."""
    x, w = _cast(precision, x, w)
    spec = conv_spec(x, w, stride, padding, groups, dilation)
    dt = _acc_dtype(x, w)
    z = _accumulate(x, w, spec, dt)
    if bias is not None:
        z = z + bias.to(dt)[None, :, None, None, :]
    return z if precision is None else z.to(x.dtype)


def backward_spec(n: int, hi: int, wi: int, w_shape, stride: int,
                  padding: Padding, g: torch.Tensor,
                  z: Optional[torch.Tensor], groups: int = 1,
                  dilation=1) -> ConvSpec:
    """The forward's geometry for weights of ``w_shape`` over an ``hi x wi``
    input, checked against the cotangent ``g`` (and the saved
    pre-activation ``z``) that the backward is handed."""
    spec = _geometry(n, hi, wi, w_shape, stride, padding, groups, dilation)
    want = (n, w_shape[0], spec.ho, spec.wo, w_shape[5])
    if g.dim() != 5 or tuple(g.shape) != want:
        raise ValueError(f"cotangent shape {tuple(g.shape)} != the forward's "
                         f"output {want}")
    if z is not None and tuple(z.shape) != want:
        raise ValueError(f"pre-activation shape {tuple(z.shape)} != {want}")
    return spec


def direct_conv_dgrad_blocked(g: torch.Tensor, w: torch.Tensor,
                              input_hw, stride: int = 1,
                              padding: Padding = "VALID",
                              z: Optional[torch.Tensor] = None,
                              activation: Optional[str] = None,
                              groups: int = 1, dilation=1,
                              precision=None) -> torch.Tensor:
    """Input gradient of ``act(conv(x, w) + b)`` given the raw cotangent
    ``g [N, Co/Cob, Ho, Wo, Cob]``, the saved pre-activation ``z`` (None
    when the activation is linear) and ``w`` -> ``dx [N, Ci/Cib, Hi, Wi,
    Cib]`` at the unpadded ``input_hw`` in ``g``'s dtype; dense, grouped
    (``w [Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob]``), or depthwise with ``groups
    == C``, at any ``dilation``.  ``precision`` casts ``g``, ``z`` and
    ``w`` to its operand dtype first; bf16 operands are up-cast to f32
    before any product (exact), so under ``BF16`` only the order of the
    f32 sums differs from the bf16 kernels, and ``dx`` is rounded once to
    bf16 as they round it.

    ``dz = g * act'(z)``; every tap adds ``dz @ w[tap]^T`` (depthwise:
    ``dz * w[tap]``; grouped: each group's cotangent blocks against its
    weight blocks) into the padded input rows it read (a strided view),
    over the dgrad extents; the pads are then cropped, and rows past the
    extents stay zero.
    """
    g, z, w = _cast(precision, g, z, w)
    hi, wi = input_hw
    spec = backward_spec(g.shape[0], hi, wi, w.shape, stride, padding, g, z,
                         groups, dilation)
    dt = _acc_dtype(g, w)
    dz = cotangent_prologue(g, z, activation).to(dt)
    wd = w.to(dt)
    eh, ew = dgrad_extents(spec.ho, spec.wo, spec.hf, spec.wf, spec.stride,
                           spec.dilation)
    n = g.shape[0]
    if spec.is_depthwise:
        dx_blocks = (g.shape[1], g.shape[4])
    else:
        dx_blocks = (w.shape[1] * groups, w.shape[4])
    dxp = torch.zeros((n, dx_blocks[0], eh, ew, dx_blocks[1]), dtype=dt,
                      device=g.device)
    for (dh, dw), win in tap_windows(dxp, spec.hf, spec.wf, spec.ho, spec.wo,
                                     spec.stride, spec.dilation):
        if spec.is_depthwise:
            win.add_(dz * wd[:, 0, dh, dw, 0][None, :, None, None, :])
        else:
            win.add_(_grouped_dgrad_term(dz, wd[:, :, dh, dw], groups))
    (pt, pb), (pl, pr) = spec.pads
    dxp = pad_blocked(dxp, (0, spec.padded_hi - eh), (0, spec.padded_wi - ew))
    return dxp[:, :, pt:pt + hi, pl:pl + wi, :].to(g.dtype)


def _grouped_dgrad_term(dz: torch.Tensor, wt: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """One tap's ``dz @ w[tap]^T``: ``dz [N, Co/Cob, H, W, Cob]`` and the
    tap's weights ``[Co/Cob, Cig/Cib, Cib, Cob]`` -> ``[N, Ci/Cib, H, W,
    Cib]``, each group's input blocks from its own cotangent and weight
    blocks (dense at ``groups`` 1)."""
    n, coblk, h, w, cob = dz.shape
    _, cigblk, cib, _ = wt.shape
    # [N, G, Cog/Cob, H, W, Cob] x [G, Cog/Cob, Cig/Cib, Cib, Cob]
    #   -> [N, G, Cig/Cib, H, W, Cib]
    return torch.einsum(
        "ngohwk,gocbk->ngchwb",
        dz.reshape(n, groups, coblk // groups, h, w, cob),
        wt.reshape(groups, coblk // groups, cigblk, cib, cob),
    ).reshape(n, groups * cigblk, h, w, cib)


def direct_conv_dgrad_phased(g: torch.Tensor, w: torch.Tensor, input_hw,
                             stride: int = 1, padding: Padding = "VALID",
                             z: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None,
                             groups: int = 1, dilation=1,
                             precision=None) -> torch.Tensor:
    """The dense or grouped input gradient at any ``dilation`` (as
    ``direct_conv_dgrad_blocked``, with its ``precision``), split by stride
    phase as the CUDA kernels split it: the dx rows ``first + s*a`` of a
    phase take taps ``tap0 + tstep*t`` from cotangent rows ``q0 + a -
    qstep*t`` (``dgrad_phase_axes``), cells outside the map read as 0, a
    phase no tap reaches is zeros, and each phase is written once, so no
    stride hole is read and no dilated or padded cotangent exists."""
    g, z, w = _cast(precision, g, z, w)
    hi, wi = input_hw
    spec = backward_spec(g.shape[0], hi, wi, w.shape, stride, padding, g, z,
                         groups, dilation)
    if spec.is_depthwise:
        raise ValueError("the phase split is the dense and grouped dgrad's; "
                         "the depthwise dgrad has its own walk")
    dt = _acc_dtype(g, w)
    dz = cotangent_prologue(g, z, activation).to(dt)
    wd = w.to(dt)
    (pt, _), (pl, _) = spec.pads
    dil_h, dil_w = spec.dilation
    n, ciblk, cib = g.shape[0], w.shape[1] * groups, w.shape[4]
    dx = torch.zeros((n, ciblk, hi, wi, cib), dtype=dt, device=g.device)

    def taps_of(ax, extent):
        # per tap: (filter index, cotangent index of each phase row, mask)
        out = []
        for t in range(ax.taps):
            o = (ax.q0 + torch.arange(ax.extent, device=g.device)
                 - ax.qstep * t)
            ok = (o >= 0) & (o < extent)
            out.append((ax.tap0 + ax.tstep * t, o.clamp(0, extent - 1), ok))
        return out

    for r in dgrad_phase_axes(hi, spec.hf, stride, pt, dil_h):
        for c in dgrad_phase_axes(wi, spec.wf, stride, pl, dil_w):
            if not (r.extent and c.extent):
                continue
            acc = dx.new_zeros((n, ciblk, r.extent, c.extent, cib))
            for dh, oh, okh in taps_of(r, spec.ho):
                for dw, ow, okw in taps_of(c, spec.wo):
                    cells = dz[:, :, oh][:, :, :, ow]
                    cells = cells * (okh[:, None] & okw[None, :]).to(dt)[
                        None, None, :, :, None]
                    acc += _grouped_dgrad_term(cells, wd[:, :, dh, dw],
                                               groups)
            dx[:, :, r.first::stride, c.first::stride] = acc
    return dx.to(g.dtype)


def direct_conv_wgrad_blocked(x: torch.Tensor, g: torch.Tensor, hf: int,
                              wf: int, stride: int = 1,
                              padding: Padding = "VALID",
                              z: Optional[torch.Tensor] = None,
                              activation: Optional[str] = None,
                              with_db: bool = False, groups: int = 1,
                              dilation=1, precision=None):
    """Weight (and bias) gradient of ``act(conv(x, w) + b)`` given the
    forward's unpadded input ``x``, the raw cotangent ``g`` and the saved
    pre-activation ``z`` -> ``(dw, db [Co/Cob, Cob] or None)``, both f32
    (f64 for f64 operands); ``dw`` is ``[Co/Cob, Ci/Cib, Hf, Wf, Cib,
    Cob]``, grouped ``[Co/Cob, Cig/Cib, Hf, Wf, Cib, Cob]``, or ``[C/Cb, 1,
    Hf, Wf, 1, Cb]`` with ``groups == C``; any ``dilation``.
    ``precision`` casts ``x``, ``g`` and ``z`` to its operand dtype first;
    bf16 operands are up-cast to f32 before any product, ``dz`` is rounded
    to ``z``'s dtype by the prologue, and dw and db stay f32 (``db`` the
    f32 sum of the rounded ``dz``), as the reference's wgrad under
    ``BF16``.

    ``dz = g * act'(z)``; each tap's block is ``x_win^T @ dz`` contracted
    over ``(N, Ho, Wo)`` (depthwise: ``x_win * dz`` summed per lane;
    grouped: each Co block against its group's input blocks); ``db`` sums
    ``dz`` over the same positions.
    """
    x, g, z = _cast(precision, x, g, z)
    n, ciblk, hi, wi, cib = x.shape
    coblk, cob = g.shape[1], g.shape[4]
    if groups > 1 and groups == ciblk * cib:
        w_shape = (coblk, 1, hf, wf, 1, cob)
    else:
        w_shape = (coblk, ciblk // groups, hf, wf, cib, cob)
    spec = backward_spec(n, hi, wi, w_shape, stride, padding, g, z, groups,
                         dilation)
    dt = _acc_dtype(x, g)
    dz = cotangent_prologue(g, z, activation).to(dt)
    xp = pad_blocked(x, *spec.pads).to(dt)
    dw = torch.empty(w_shape, dtype=dt, device=x.device)
    for (dh, dwi), win in tap_windows(xp, hf, wf, spec.ho, spec.wo,
                                      spec.stride, spec.dilation):
        if spec.is_depthwise:
            dw[:, 0, dh, dwi, 0] = (win * dz).sum(dim=(0, 2, 3))
        else:
            # [N, G, Cig/Cib, Ho, Wo, Cib] x [N, G, Cog/Cob, Ho, Wo, Cob]
            #   -> [G, Cog/Cob, Cig/Cib, Cib, Cob]
            _, cigblk, _, _, _, _ = w_shape
            dw[:, :, dh, dwi] = torch.einsum(
                "ngchwb,ngohwk->gocbk",
                win.reshape(n, groups, cigblk, *win.shape[2:]),
                dz.reshape(n, groups, coblk // groups, *dz.shape[2:]),
            ).reshape(coblk, cigblk, cib, cob)
    db = dz.sum(dim=(0, 2, 3)) if with_db else None
    return dw, db


def direct_conv1d_depthwise(x: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            causal: bool = True) -> torch.Tensor:
    """Causal depthwise conv1d (the Mamba short conv), direct form: the
    plain version of ``csrc/conv1d_depthwise.cu`` and the port of the
    reference's ``direct_conv1d_depthwise`` (``repro/core/direct_conv.py``).

    x: [B, L, D], w: [K, D].  out[b, l, d] = sum_k w[k, d] * x[b, l - K + 1
    + k, d] (+ bias[d]).  Taps are added in ascending k, then the bias, in
    f32; the result is cast to x's dtype once."""
    b, l, d = x.shape
    k = w.shape[0]
    if causal:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = F.pad(x, (0, 0, (k - 1) // 2, k - 1 - (k - 1) // 2))
    acc = torch.zeros((b, l, d), dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + xp[:, i:i + l, :].float() * w[i].float()
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)
