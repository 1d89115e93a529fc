"""Blocked-layout convolution layers as ``nn.Module``s.

``BlockedConv2D`` keeps its input and output in the paper layout
``[N, C/Cb, H, W, Cb]``, so stacked layers chain with no repacking.  Its
weights are stored in the paper's kernel layout ``[Co/Cob, Cig/Cib, Hf, Wf,
Cib, Cob]`` (a depthwise layer's is ``[C/Cb, 1, Hf, Wf, 1, Cb]``) and its
bias as pencils ``[Co/Cob, Cob]``; bias, activation, residual and GAP are
fused into the kernel's epilogue.

Each call routes by geometry, as the reference's prior-tier dispatcher
ranks its candidates (``repro/core/dispatch.py:185-189``): a pointwise
layer (1x1, stride 1, no pads) goes to
``kernels.conv2d_pointwise.pointwise_conv2d_blocked``, a depthwise layer
(``groups == ci == co``) to ``kernels.conv2d_depthwise
.depthwise_conv2d_blocked``, and a dense layer to
``kernels.direct_conv2d.direct_conv2d_blocked``: the CUDA kernels for
tensors on the GPU, the plain versions for tensors on the CPU.  The
measured dispatcher is not ported yet.  A grouped layer with more than one
input channel per group (AlexNet's two towers) and a dilated dense layer
go to the same dense wrapper with their ``groups`` and ``dilation``: the
window kernels' grouped map and dilated taps, in the forward and, under
grad mode, in the dgrad and wgrad (the streamed kernels are dense-only).

A dense layer runs on the window kernels or on the streamed halo-ring
kernels (``kernels.conv2d_stream``): the layer's ``stream`` field, or a
``ConvContext``'s, forces one family (a bool for all three directions, a
``KernelRoute`` per direction), and None lets the blocking models decide
(``core.dispatch.route_stream``).  As in the reference the override acts
inside the dense family only: pointwise and depthwise legs ignore a
context's ``stream``, and an explicit ``stream=True`` on such a layer
raises.  ``machine`` is the model the dense family's tiles are fitted to.

Parameters are trainable.  With grad mode on, a call goes through the
family's autograd path (forward kernel, then the dgrad and wgrad kernels
in the backward); under ``torch.no_grad``/``inference_mode``, as the
server runs it, through the fused inference kernel.  Both run under a
context's precision: f32, or ``BF16`` (every family's bf16 builds, dense,
pointwise and depthwise, in serving and in training).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from repro_torch.core.blocking import H100_SXM, MachineModel
from repro_torch.core.context import ConvContext, as_context
from repro_torch.core.conv2d_common import blocked_global_avg_pool
from repro_torch.core.convspec import ConvSpec, as_dilation
from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch import KernelRoute, Stream
from repro_torch.core.layout import BlockedConvLayout, nhwc_to_blocked
from repro_torch.core.padding import Padding
from repro_torch.core.precision import F32
from repro_torch.kernels.conv2d_depthwise import depthwise_conv2d_blocked
from repro_torch.kernels.conv2d_pointwise import pointwise_conv2d_blocked
from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked
from repro_torch.nn.module import ParamSpec, init_tree

__all__ = ["BlockedConv2D", "ResidualBlock", "DepthwiseSeparableBlock",
           "BlockedCNN", "blocked_global_avg_pool"]


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class BlockedConv2D(nn.Module):
    """Conv whose maps, weights and bias live in the blocked layouts.

    In: ``[N, Ci/Cib, H, W, Cib]`` -> out: ``[N, Co/Cob, Ho, Wo, Cob]``.
    ``groups == ci == co`` makes it depthwise; other ``groups`` make it
    grouped (its weight ``[Co/Cob, Cig/Cib, ...]``, pencils per group); any
    layer may be dilated.
    """

    def __init__(self, ci: int, co: int, hf: int = 3, wf: int = 3,
                 stride: int = 1, padding: Padding = "SAME",
                 activation: Optional[str] = "relu", *, groups: int = 1,
                 dilation=1, lane: int = 128, stream: Stream = None,
                 machine: MachineModel = H100_SXM,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        """``lane`` is the channel-pencil target (the reference's ``lane``):
        128 for real widths, smaller for toy nets.  ``stream`` and
        ``machine`` route a dense layer (module docstring)."""
        super().__init__()
        self.ci, self.co, self.hf, self.wf = ci, co, hf, wf
        self.stride, self.padding, self.activation = stride, padding, activation
        self.groups, self.dilation = groups, as_dilation(dilation)
        self.layout = BlockedConvLayout.choose(ci, co, lane, groups=groups)
        self.stream, self.machine = stream, machine
        geometry = ConvSpec.make(1, hf, wf, ci, co, hf, wf, stride, padding,
                                 groups, self.dilation)
        forced = (any(stream.get(d) for d in ("fwd", "dgrad", "wgrad"))
                  if isinstance(stream, KernelRoute) else bool(stream))
        if forced and not (geometry.is_dense and not geometry.is_pointwise):
            kind = ("pointwise" if geometry.is_pointwise else "depthwise"
                    if geometry.is_depthwise else "grouped or dilated")
            raise ValueError(
                "the streamed halo-ring kernels are dense-only: stream="
                f"{stream!r} on a {kind} layer")
        params = init_tree(self.specs(), _generator(generator),
                           resolve_device(device))
        self.w = nn.Parameter(params["w"])
        self.b = nn.Parameter(params["b"])

    @property
    def in_pencil(self) -> int:
        return self.layout.cb_in

    @property
    def out_pencil(self) -> int:
        return self.layout.cb_out

    def specs(self):
        lay = self.layout
        cig = self.ci // self.groups
        fan_in = self.hf * self.wf * cig
        return {
            "w": ParamSpec((self.co // lay.cb_out, cig // lay.cb_weight,
                            self.hf, self.wf, lay.cb_weight, lay.cb_out),
                           init="normal", scale=1.0 / math.sqrt(fan_in)),
            "b": ParamSpec((self.co // lay.cb_out, lay.cb_out), init="zeros"),
        }

    def spec(self, n: int, hi: int, wi: int) -> ConvSpec:
        """The layer's geometry over an ``n x hi x wi`` input."""
        return ConvSpec.make(n, hi, wi, self.ci, self.co, self.hf, self.wf,
                             self.stride, self.padding, self.groups,
                             self.dilation)

    def forward(self, xb: torch.Tensor, residual: Optional[torch.Tensor] = None,
                gap: bool = False,
                context: Optional[ConvContext] = None) -> torch.Tensor:
        """``residual`` is skip-added after the activation in the epilogue;
        ``gap=True`` returns the pooled ``[N, Co]`` features instead of the
        map, whose values the kernel pools as it stores them.  ``context``
        overrides the layer's ``stream`` and ``machine`` and sets the
        precision policy (f32 by default)."""
        ctx = as_context(context)
        precision = ctx.resolve_precision_for(F32)
        spec = self.spec(xb.shape[0], xb.shape[2], xb.shape[3])
        if spec.is_pointwise:
            return pointwise_conv2d_blocked(xb, self.w, self.b, self.stride,
                                            self.padding, self.activation,
                                            residual=residual, gap=gap,
                                            precision=precision)
        if spec.is_depthwise:
            return depthwise_conv2d_blocked(xb, self.w, self.b, self.stride,
                                            self.padding, self.activation,
                                            residual=residual, gap=gap,
                                            precision=precision,
                                            dilation=self.dilation)
        return direct_conv2d_blocked(
            xb, self.w, self.b, self.stride, self.padding, self.activation,
            residual=residual, gap=gap, precision=precision,
            stream=ctx.resolve_stream_for(self.stream),
            machine=ctx.resolve_machine_for(self.machine),
            groups=self.groups, dilation=self.dilation)


class ResidualBlock(BlockedConv2D):
    """Identity-skip block: ``out = act(conv(x) + b) + x``, fused.

    The port of the reference's ``ResidualBlock`` (``repro/nn/conv.py:
    316-360``): the skip add rides the conv's epilogue (the ``residual=``
    of :class:`BlockedConv2D`), added after the activation in f32 with one
    downcast, so the pre-activation never makes a trip through device
    memory to be re-read for the add.  An identity skip needs a conv that
    keeps the geometry: ``ci == co`` and ``stride == 1``, checked at
    construction (with SAME padding the map keeps its size).  It is the
    conv itself, so its parameters are the conv's ``w`` and ``b``, as the
    reference's ``conv{i}`` holds the inner conv's (``convert`` carries
    them across unchanged).  A caller's own ``residual=`` is refused.
    """

    def __init__(self, ci: int, co: int, hf: int = 3, wf: int = 3,
                 stride: int = 1, padding: Padding = "SAME",
                 activation: Optional[str] = "relu", **kw):
        if ci != co or stride != 1:
            raise ValueError("ResidualBlock needs an identity-shaped conv: "
                             f"ci={ci} co={co} stride={stride}")
        super().__init__(ci, co, hf, wf, stride, padding, activation, **kw)

    def forward(self, xb: torch.Tensor, residual: Optional[torch.Tensor] = None,
                gap: bool = False,
                context: Optional[ConvContext] = None) -> torch.Tensor:
        if residual is not None:
            raise ValueError("ResidualBlock supplies its own skip tensor")
        return super().forward(xb, residual=xb, gap=gap, context=context)


class DepthwiseSeparableBlock(nn.Module):
    """Depthwise conv + pointwise (1x1) conv, chained in the blocked layout.

    The MobileNet factorization on the paper's layout, as the reference's
    block (``repro/nn/conv.py:363-425``): the depthwise leg filters each
    channel spatially (``groups == ci``, weight ``Cig = 1``), the pointwise
    leg mixes channels.  Both legs share the full-lane channel pencil, so
    the block's interior boundary is repack-free.  The activation follows
    each leg; a residual and the GAP ride the pointwise leg, the block's
    output.  Parameters: ``dw.w``, ``dw.b``, ``pw.w``, ``pw.b``, drawn in
    that order.
    """

    def __init__(self, ci: int, co: int, hf: int = 3, wf: int = 3,
                 stride: int = 1, padding: Padding = "SAME",
                 activation: Optional[str] = "relu", *, dilation=1,
                 lane: int = 128, device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        self.ci, self.co = ci, co
        self.dw = BlockedConv2D(ci, ci, hf, wf, stride, padding, activation,
                                groups=ci, dilation=dilation, lane=lane,
                                device=device, generator=gen)
        self.pw = BlockedConv2D(ci, co, 1, 1, 1, "VALID", activation,
                                lane=lane, device=device, generator=gen)

    @property
    def in_pencil(self) -> int:
        return self.dw.in_pencil

    @property
    def out_pencil(self) -> int:
        return self.pw.out_pencil

    def forward(self, xb: torch.Tensor, residual: Optional[torch.Tensor] = None,
                gap: bool = False,
                context: Optional[ConvContext] = None) -> torch.Tensor:
        return self.pw(self.dw(xb, context=context), residual=residual,
                       gap=gap, context=context)


class BlockedCNN(nn.Module):
    """conv -> ... -> conv -> GAP -> linear head, chained in blocked layout.

    Layers are ``BlockedConv2D``s, ``ResidualBlock``s or
    ``DepthwiseSeparableBlock``s, mixed freely.  NHWC images are blocked
    once at entry; every layer boundary after that stays in ``[N, C/Cb, H,
    W, Cb]``.  The last layer pools in its epilogue, so its map is consumed
    as it is stored, and the head is a plain ``torch.matmul`` outside any
    kernel (the reference left it to XLA).
    """

    def __init__(self, convs: Sequence[nn.Module], n_classes: int, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if not convs:
            raise ValueError("a BlockedCNN needs at least one conv")
        for a, b in zip(convs, convs[1:]):
            if a.co != b.ci:
                raise ValueError(f"conv chain breaks: co={a.co} -> ci={b.ci}")
            if a.out_pencil != b.in_pencil:
                raise ValueError(
                    f"pencil mismatch: {a.out_pencil} -> {b.in_pencil}; "
                    "layers must agree on the channel block to chain")
        for c in convs:
            for p in c.parameters():
                if p.device.type != dev.type:
                    raise ValueError(f"layer parameters are on {p.device}, "
                                     f"the model on {dev}")
        self.convs = nn.ModuleList(convs)
        self.n_classes = n_classes
        head = init_tree(ParamSpec((convs[-1].co, n_classes)),
                         _generator(generator), dev)
        self.head = nn.Parameter(head)

    @property
    def in_channels(self) -> int:
        return self.convs[0].ci

    def forward(self, x_nhwc: torch.Tensor,
                context: Optional[ConvContext] = None) -> torch.Tensor:
        """``[N, H, W, C]`` images -> ``[N, n_classes]`` logits; ``context``
        reaches every layer.  Under a context's precision the layers chain
        in its operand dtype, as the reference's ``BlockedCNN.__call__``
        does: the images are cast once at entry, every conv emits the
        operand dtype (bf16 with f32 sums inside), the pooled features come
        out in it, the head's f32 master is cast to it and the logits come
        back in it (a train step takes its loss in f32); under grad mode the
        gradients reach the f32 masters through those casts."""
        op = as_context(context).resolve_precision_for(F32).op_dtype
        h = nhwc_to_blocked(x_nhwc.to(op), self.convs[0].in_pencil)
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            h = conv(h, gap=(i == last), context=context)
        return torch.matmul(h, self.head.to(h.dtype))
