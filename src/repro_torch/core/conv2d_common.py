"""Plain PyTorch helpers of the blocked direct-conv kernel family.

These are the pieces of the reference's shared Pallas machinery
(``repro/kernels/conv2d_common.py``) that carry arithmetic, written on
tensors.  They live in ``core`` because the plain version of the forward
kernel (``core.direct_conv.direct_conv_blocked``) and the blocking model
(``core.blocking``) are built from them; ``kernels`` imports them from
here.  The CUDA kernel (``csrc/direct_conv2d_fwd.cu``) performs the same
steps in the same order:

* ``halo_dims`` — input rows/cols feeding one ``hob x wob`` output tile;
* ``tap_windows`` — one strided view per filter tap: the rows of the
  im2col matrix that is never materialized;
* ``epilogue`` — ``acc + bias``, then the activation, then ``+ residual``,
  all in f32, then **one** downcast;
* ``gap_partials`` / ``gap_finalize`` — the global-average-pool rider: f32
  per-tile sums of the *stored* values, then the tiles summed in index
  order and scaled by the f32 reciprocal of ``Ho*Wo`` (the last CTA of
  each image and output block does the second step in the launch that
  writes the sums);
* ``gap_replay`` — the dense forward tile's GAP in its own order, tile by
  tile as ``csrc/fwd_tile.cuh`` sums it, so that the pooled features of a
  stored map are the kernel's bit for bit;
* ``cotangent_prologue`` — the backward kernels' ``dz = g * act'(z)``
  (``csrc/direct_conv2d_bwd.cu`` forms it as it stages ``g``);
* ``blocked_global_avg_pool`` — the unfused GAP of a stored map, which the
  training path applies after the activation, as the reference's custom VJP
  leaves it to XLA;
* ``wgrad_reduce`` — the wgrad kernels' per-split partial sums added in
  split order, as the last CTA of each column of shares adds them
  (``csrc/split_sum.cuh``).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "apply_activation", "halo_dims", "tap_windows",
           "epilogue", "gap_partials", "gap_finalize", "gap_replay",
           "cotangent_prologue", "blocked_global_avg_pool", "wgrad_reduce"]

# Epilogue activations.  "gelu" is the reference's ``jax.nn.gelu``, whose
# default is the tanh approximation; the CUDA epilogue uses the same formula.
# "relu" is the reference's ``jnp.maximum(z, 0)``: the same values as
# ``torch.relu``, and under autograd the same derivative at ``z == 0``, 1/2
# (torch.relu's is 0), so that torch autograd through the plain versions
# agrees with the kernels' ``cotangent_prologue`` where a pre-activation is
# exactly 0, as a depthwise channel whose input was all cut by the previous
# relu is.
ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": lambda x: torch.maximum(x, x.new_zeros(())),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def apply_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    try:
        fn = ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; "
                         f"have {sorted(k for k in ACTIVATIONS if k)}") from None
    return fn(x)


def halo_dims(hob: int, wob: int, hf: int, wf: int, stride: int = 1,
              dilation: Tuple[int, int] = (1, 1)) -> Tuple[int, int]:
    """Input rows/cols feeding one (hob x wob) output tile, halo included
    (the filter's dilated extent)."""
    return ((hob - 1) * stride + (hf - 1) * dilation[0] + 1,
            (wob - 1) * stride + (wf - 1) * dilation[1] + 1)


def tap_windows(xp: torch.Tensor, hf: int, wf: int, ho: int, wo: int,
                stride: int = 1, dilation: Tuple[int, int] = (1, 1),
                ) -> Iterator[Tuple[Tuple[int, int], torch.Tensor]]:
    """Yield ``((dh, dw), view)`` for every filter tap of a padded blocked
    map ``[..., Hi, Wi, Cb]``; each view is ``[..., Ho, Wo, Cb]`` and shares
    storage with ``xp`` (a strided slice, no copy).  Tap ``(dh, dw)``
    starts at ``(dh * dilation[0], dw * dilation[1])``."""
    for dh in range(hf):
        for dw in range(wf):
            h0, w0 = dh * dilation[0], dw * dilation[1]
            yield (dh, dw), xp[..., h0:h0 + (ho - 1) * stride + 1:stride,
                               w0:w0 + (wo - 1) * stride + 1:stride, :]


def epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor],
             activation: Optional[str], residual: Optional[torch.Tensor],
             out_dtype: torch.dtype) -> torch.Tensor:
    """The single output store of a forward conv on an f32 accumulator
    ``[N, Co/Cob, Ho, Wo, Cob]``: ``act(acc + b) + r``, one downcast."""
    if acc.dtype != torch.float32:
        raise TypeError(f"epilogue got a {acc.dtype} accumulator; it must "
                        "stay f32 under every precision policy")
    out = acc
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :, None, None, :]
    out = apply_activation(out, activation)
    if residual is not None:
        out = out + residual.to(torch.float32)
    return out.to(out_dtype)


def gap_partials(out: torch.Tensor, hob: int, wob: int) -> torch.Tensor:
    """Per-tile f32 sums of a *stored* map ``[N, Co/Cob, Ho, Wo, Cob]`` over
    ``hob x wob`` tiles -> ``[N, Co/Cob, n_tiles, Cob]``, tiles in row-major
    order (tile rows outer, tile columns inner), as the CUDA kernel indexes
    them."""
    n, coblk, ho, wo, cob = out.shape
    if ho % hob or wo % wob:
        raise ValueError(f"tile {hob}x{wob} must divide the map {ho}x{wo}")
    t = out.to(torch.float32).reshape(n, coblk, ho // hob, hob, wo // wob,
                                      wob, cob)
    return t.sum(dim=(3, 5)).reshape(n, coblk, -1, cob)


def gap_finalize(partials: torch.Tensor, hw: int) -> torch.Tensor:
    """``[N, Co/Cob, n_tiles, Cob]`` f32 partials -> pooled ``[N, Co]`` f32:
    the tiles summed in index order, times the f32 reciprocal of ``hw``."""
    n, coblk, n_tiles, cob = partials.shape
    acc = partials[:, :, 0]
    for t in range(1, n_tiles):
        acc = acc + partials[:, :, t]
    inv_hw = float(np.float32(1.0) / np.float32(hw))
    return (acc * inv_hw).reshape(n, coblk * cob)


def gap_replay(out: torch.Tensor, blk) -> torch.Tensor:
    """Pool a stored map ``[N, Co/Cob, Ho, Wo, Cob]`` as the dense forward
    tile pools it (``csrc/fwd_tile.cuh`` ``run``, the GAP epilogue, and
    ``split_sum.cuh`` ``gap_fold``) over the tiles ``blk``
    (``core.blocking.FwdBlocking``: ``th``, ``tw``, ``wgs``, ``strips``)
    -> ``[N, Co]`` at the map's dtype.

    In each tile every consumer thread adds its two rows (m-tile rows
    ``16 * warp + lane / 4`` and 8 below), the eight row groups of a warp
    are added by the ``shfl_xor`` 4, 8, 16 tree, and the consumer warps'
    sums are added in warp order from 0; a row past the tile, its m-tile
    or the map adds 0.  The window kernel's m-tile is the tile's ``64 *
    wgs`` rows; the streamed kernel's warpgroup ``k`` holds strip ``k``.
    The tiles' sums are then added in index order and multiplied by the f32
    reciprocal of ``Ho * Wo``, then cast to the map's dtype.  Every step is
    one f32 addition in that order, so the result is the kernel's pooled
    features bit for bit when ``out`` is the map the kernel stored (its
    bf16 values for a bf16 map)."""
    n, coblk, ho, wo, cob = out.shape
    th, tw, wgs = blk.th, blk.tw, blk.wgs
    streamed = blk.strips > 1
    mstride = th // blk.strips * tw if streamed else 64 * wgs
    across = -(-wo // tw)
    tiles = -(-ho // th) * across
    dev = out.device
    tile = torch.arange(tiles, device=dev)[:, None, None, None]
    wid = torch.arange(4 * wgs, device=dev)[None, :, None, None]
    grp = torch.arange(8, device=dev)[None, None, :, None]
    half = torch.arange(2, device=dev)[None, None, None, :]
    wg = wid // 4
    q = (0 if streamed else 64 * wg) + 16 * (wid % 4) + grp + 8 * half
    p = (wg * mstride if streamed else 0) + q
    oh = tile // across * th + p // tw
    ow = tile % across * tw + p % tw
    live = (q < mstride) & (p < th * tw) & (oh < ho) & (ow < wo)
    at = torch.where(live, oh * wo + ow, ho * wo)      # ho * wo: a zero row
    flat = out.to(torch.float32).reshape(n, coblk, ho * wo, cob)
    flat = torch.cat([flat, flat.new_zeros((n, coblk, 1, cob))], dim=2)
    v = flat[:, :, at.reshape(-1)].reshape(n, coblk, tiles, 4 * wgs, 8, 2,
                                           cob)
    t = v[..., 0, :] + v[..., 1, :]            # a thread's two rows
    t = t[..., 0::2, :] + t[..., 1::2, :]      # shfl_xor 4
    t = t[..., 0::2, :] + t[..., 1::2, :]      # shfl_xor 8
    t = t[..., 0, :] + t[..., 1, :]            # shfl_xor 16
    part = torch.zeros_like(t[:, :, :, 0])
    for w in range(4 * wgs):                   # the consumer warps in order
        part = part + t[:, :, :, w]
    return gap_finalize(part, ho * wo).to(out.dtype)


def cotangent_prologue(g: torch.Tensor, z: Optional[torch.Tensor],
                       activation: Optional[str]) -> torch.Tensor:
    """``dz = g * act'(z)`` on a cotangent ``g`` and the saved
    pre-activation ``z`` of the same shape, with the reference's cast order
    (``repro/kernels/conv2d_common.py`` ``cotangent_prologue``): ``g`` taken
    at ``z``'s dtype, ``act'`` evaluated in f32 (f64 for f64 operands), the
    product rounded to ``z``'s dtype, then returned at ``g``'s dtype.
    Under BF16 that is one rounding of the f32 product to bf16; where ``g``
    and ``z`` share a dtype wider than bf16 it is the product in that dtype.
    relu' is 1 where ``z > 0``, 0 where ``z < 0`` and 1/2 at 0, as the VJP
    of the reference's relu (``jnp.maximum(z, 0)``) splits the tie; gelu is
    the tanh form, whose derivative is written out the way the CUDA kernel
    computes it.  Linear, or no ``z``, returns ``g`` unchanged."""
    if z is None or activation in (None, "linear"):
        return g
    dt = torch.promote_types(z.dtype, torch.float32)
    zf, gf = z.to(dt), g.to(z.dtype).to(dt)
    if activation == "relu":
        dz = torch.where(zf > 0, gf, torch.where(zf == 0, 0.5 * gf,
                                                 torch.zeros_like(gf)))
    elif activation == "gelu":
        k, a = 0.7978845608028654, 0.044715          # sqrt(2 / pi)
        z2 = zf * zf
        t = torch.tanh(k * (zf + a * z2 * zf))
        dz = gf * (0.5 * (1.0 + t)
                   + 0.5 * zf * (1.0 - t * t) * k * (1.0 + 3.0 * a * z2))
    else:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"have {sorted(k for k in ACTIVATIONS if k)}")
    return dz.to(z.dtype).to(g.dtype)


def blocked_global_avg_pool(xb: torch.Tensor) -> torch.Tensor:
    """GAP on the blocked layout: ``[N, C/Cb, H, W, Cb] -> [N, C]``, the
    mean taken in f32 (f64 for f64 maps) and returned at the map's dtype."""
    n, cblk, _, _, cb = xb.shape
    acc = torch.promote_types(xb.dtype, torch.float32)
    return xb.to(acc).mean(dim=(2, 3)).reshape(n, cblk * cb).to(xb.dtype)


def wgrad_reduce(partials: torch.Tensor) -> torch.Tensor:
    """``[splits, cols]`` partial sums of the wgrad kernel -> ``[cols]``:
    the rows summed in index order."""
    if partials.dim() != 2:
        raise ValueError(f"partials must be [splits, cols], got "
                         f"{tuple(partials.shape)}")
    acc = partials[0]
    for k in range(1, partials.shape[0]):
        acc = acc + partials[k]
    return acc
