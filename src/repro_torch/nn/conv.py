"""Blocked-layout convolution layers as ``nn.Module``s.

``BlockedConv2D`` keeps its input and output in the paper layout
``[N, C/Cb, H, W, Cb]``, so stacked layers chain with no repacking.  Its
weights are stored in the paper's kernel layout ``[Co/Cob, Ci/Cib, Hf, Wf,
Cib, Cob]`` and its bias as pencils ``[Co/Cob, Cob]``; bias, activation,
residual and GAP are fused into the kernel's epilogue.  Each call goes
straight to ``kernels.direct_conv2d.direct_conv2d_blocked``: the CUDA kernels
for tensors on the GPU, the plain versions for tensors on the CPU.  The
reference's dispatcher (``repro/nn/conv.py:251-312``) is not ported yet;
dense convs are the only geometry.

Parameters are trainable.  With grad mode on, a call goes through the
autograd path (forward kernel, then the dgrad and wgrad kernels in the
backward); under ``torch.no_grad``/``inference_mode``, as the server runs
it, through the fused inference kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from repro_torch.core.conv2d_common import blocked_global_avg_pool
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import BlockedConvLayout, nhwc_to_blocked
from repro_torch.core.padding import Padding
from repro_torch.kernels.direct_conv2d import direct_conv2d_blocked
from repro_torch.nn.module import ParamSpec, init_tree

__all__ = ["BlockedConv2D", "BlockedCNN", "blocked_global_avg_pool"]


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class BlockedConv2D(nn.Module):
    """Dense conv whose maps, weights and bias live in the blocked layouts.

    In: ``[N, Ci/Cib, H, W, Cib]`` -> out: ``[N, Co/Cob, Ho, Wo, Cob]``.
    """

    def __init__(self, ci: int, co: int, hf: int = 3, wf: int = 3,
                 stride: int = 1, padding: Padding = "SAME",
                 activation: Optional[str] = "relu", *, lane: int = 128,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        """``lane`` is the channel-pencil target (the reference's ``lane``):
        128 for real widths, smaller for toy nets."""
        super().__init__()
        self.ci, self.co, self.hf, self.wf = ci, co, hf, wf
        self.stride, self.padding, self.activation = stride, padding, activation
        self.layout = BlockedConvLayout.choose(ci, co, lane)
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
        fan_in = self.hf * self.wf * self.ci
        return {
            "w": ParamSpec((self.co // lay.cb_out, self.ci // lay.cb_in,
                            self.hf, self.wf, lay.cb_in, lay.cb_out),
                           init="normal", scale=1.0 / math.sqrt(fan_in)),
            "b": ParamSpec((self.co // lay.cb_out, lay.cb_out), init="zeros"),
        }

    def forward(self, xb: torch.Tensor, residual: Optional[torch.Tensor] = None,
                gap: bool = False) -> torch.Tensor:
        """``residual`` is skip-added after the activation in the epilogue;
        ``gap=True`` returns the pooled ``[N, Co]`` features instead of the
        map, whose values the kernel pools as it stores them."""
        return direct_conv2d_blocked(xb, self.w, self.b, self.stride,
                                     self.padding, self.activation,
                                     residual=residual, gap=gap)


class BlockedCNN(nn.Module):
    """conv -> ... -> conv -> GAP -> linear head, chained in blocked layout.

    NHWC images are blocked once at entry; every layer boundary after that
    stays in ``[N, C/Cb, H, W, Cb]``.  The last conv pools in its epilogue,
    so its map is consumed as it is stored, and the head is a plain
    ``torch.matmul`` outside any kernel (the reference left it to XLA).
    """

    def __init__(self, convs: Sequence[BlockedConv2D], n_classes: int, *,
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
            if c.w.device.type != dev.type:
                raise ValueError(f"conv parameters are on {c.w.device}, the "
                                 f"model on {dev}")
        self.convs = nn.ModuleList(convs)
        self.n_classes = n_classes
        head = init_tree(ParamSpec((convs[-1].co, n_classes)),
                         _generator(generator), dev)
        self.head = nn.Parameter(head)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """``[N, H, W, C]`` images -> ``[N, n_classes]`` logits."""
        h = nhwc_to_blocked(x_nhwc, self.convs[0].in_pencil)
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            h = conv(h, gap=(i == last))
        return torch.matmul(h, self.head.to(h.dtype))
