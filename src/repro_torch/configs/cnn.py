"""The CNNs of the port's main paths: VGG-16, MobileNet v1 and AlexNet.

VGG-16 (Simonyan & Zisserman 2014, Table 1, configuration D) as a dense
``BlockedCNN``.

The 13 convs run at the published widths ``64,64 | 128,128 | 256x3 |
512x3 | 512x3``, all 3x3 SAME with ReLU.  Two reductions make the network a
``BlockedCNN`` without a new feature:

1. max-pools 1-4 become ``stride=2`` on ``conv2_1``, ``conv3_1``,
   ``conv4_1`` and ``conv5_1`` (TF-SAME, so every output extent equals
   VGG-16's own: 224, 112, 56, 28, 14);
2. ``fc6``-``fc8`` become the fused global average pool and one
   ``512 -> n_classes`` linear head.

Every conv's output extent and FLOP count equal VGG-16's: about 15.35 GMAC
(30.7 GFLOP) of convs per 224x224 image.

MobileNet v1 (Howard et al. 2017, arXiv:1704.04861, Table 1: width
multiplier 1.0, resolution 224) as a ``BlockedCNN`` of one dense conv and
13 ``DepthwiseSeparableBlock``s: ``conv1`` 3x3 stride 2, 3 -> 32, then the
blocks of ``MOBILENET_V1_BLOCKS``, each a 3x3 depthwise conv and a 1x1
pointwise conv with ReLU after each (ReLU, not ReLU6, as the paper
writes).  The last block's pointwise conv pools in its epilogue, and a
``1024 -> n_classes`` head follows.  569 M multiply-adds per 224x224 image
and 4.2 M parameters at 1000 classes.  Three reductions:

1. batch norm is folded into each conv's bias (the port trains without
   it);
2. the fully connected layer is the port's head, a ``torch.matmul``
   outside any kernel;
3. the last depthwise conv runs at stride 1: Table 1 prints "s2" at 7x7
   input and 7x7 output, a known erratum; TF-slim's ``mobilenet_v1`` uses
   stride 1 there.

AlexNet in its two-tower form (Krizhevsky et al. 2012; Caffe's
``bvlc_alexnet`` ``deploy.prototxt`` keeps ``group: 2`` on conv2, conv4
and conv5) as a ``BlockedCNN`` of five ``BlockedConv2D``s, three of them
grouped, at the published widths (``ALEXNET_LAYERS``):

====== ======================================================= ========
conv   geometry                                                map
====== ======================================================= ========
conv1  11x11 stride 4, VALID, 3 -> 96, ReLU                    227 -> 55
conv2  5x5 stride 2, pads (1, 1), groups 2, 96 -> 256, ReLU    55 -> 27
conv3  3x3 stride 2, VALID, 256 -> 384, ReLU                   27 -> 13
conv4  3x3 SAME, groups 2, 384 -> 384, ReLU                    13 -> 13
conv5  3x3 SAME, groups 2, 384 -> 256, ReLU, GAP in the epilogue 13 -> 13
====== ======================================================= ========

and a ``256 -> n_classes`` head: 105.4, 223.9, 149.5, 112.1 and 74.8 M
multiply-adds, 665.8 M an image, each conv's output extent and MAC count
AlexNet's own.  Three reductions make it a ``BlockedCNN`` without a
feature the reference lacks:

1. local response normalization is dropped;
2. max-pools 1 and 2 become the strides of conv2 and conv3 (conv2's
   explicit pads (1, 1) at stride 2 and conv3's VALID keep the extents 27
   and 13);
3. pool5 and ``fc6``-``fc8`` become the fused global average pool and one
   head.

Its channel pencils are chosen at ``lane=64``, not 128: a grouped layer's
pencils divide its per-group widths (48 and 192 input channels a group at
conv2 and conv4), and at 128 conv1's 96-channel output pencil cannot feed
conv2's (a divisor of 48) nor conv3's 128 conv4's (a divisor of 192), so
``BlockedCNN`` refuses the chain, as the reference's does.  At 64 every
boundary chains: Cib 3/48/64/64/64, Cob 48/64/64/64/64.

``width_div`` divides every width of any of these networks and exists only
so that tests can build the same stack narrow.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from repro_torch.nn.conv import (BlockedCNN, BlockedConv2D,
                                 DepthwiseSeparableBlock)

__all__ = ["VGG16_WIDTHS", "VGG16_STRIDE2", "vgg16_layers", "vgg16_blocked",
           "MOBILENET_V1_CONV1", "MOBILENET_V1_BLOCKS", "mobilenet_v1_layers",
           "mobilenet_v1_blocked", "ALEXNET_LAYERS", "ALEXNET_LANE",
           "alexnet_layers", "alexnet_blocked"]

VGG16_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
# first conv of stages 2-5: where VGG-16 max-pools, these convs stride
VGG16_STRIDE2 = (2, 4, 7, 10)


def vgg16_layers(width_div: int = 1, in_channels: int = 3
                 ) -> List[Tuple[int, int, int]]:
    """The 13 convs as ``(ci, co, stride)``."""
    if width_div < 1 or any(c % width_div for c in VGG16_WIDTHS):
        raise ValueError(f"width_div={width_div} must divide every width "
                         f"{VGG16_WIDTHS}")
    layers, ci = [], in_channels
    for i, co in enumerate(VGG16_WIDTHS):
        co //= width_div
        layers.append((ci, co, 2 if i in VGG16_STRIDE2 else 1))
        ci = co
    return layers


def vgg16_blocked(n_classes: int = 1000, width_div: int = 1, *,
                  device: Union[str, torch.device] = "cuda",
                  generator: Optional[torch.Generator] = None) -> BlockedCNN:
    """VGG-16's conv stack with random weights drawn from ``generator``
    (seed 0 when None), on ``device``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    convs = [BlockedConv2D(ci, co, 3, 3, stride=s, padding="SAME",
                           activation="relu", device=device, generator=gen)
             for ci, co, s in vgg16_layers(width_div)]
    return BlockedCNN(convs, n_classes, device=device, generator=gen)


# conv1: (ci, co, stride); then the 13 separable blocks as (ci, co, stride)
MOBILENET_V1_CONV1 = (3, 32, 2)
MOBILENET_V1_BLOCKS = ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                       (128, 256, 2), (256, 256, 1), (256, 512, 2),
                       *((512, 512, 1),) * 5, (512, 1024, 2),
                       (1024, 1024, 1))


def mobilenet_v1_layers(width_div: int = 1
                        ) -> List[Tuple[str, int, int, int]]:
    """``conv1`` and the 13 blocks as ``(kind, ci, co, stride)``, kind
    ``"conv"`` or ``"separable"``; the image's 3 channels are never
    divided."""
    widths = [co for _, co, _ in MOBILENET_V1_BLOCKS]
    if width_div < 1 or any(c % width_div for c in widths + [32]):
        raise ValueError(f"width_div={width_div} must divide every width")
    ci0, co0, s0 = MOBILENET_V1_CONV1
    layers = [("conv", ci0, co0 // width_div, s0)]
    for ci, co, s in MOBILENET_V1_BLOCKS:
        layers.append(("separable", ci // width_div, co // width_div, s))
    return layers


def mobilenet_v1_blocked(n_classes: int = 1000, width_div: int = 1, *,
                         lane: int = 128,
                         device: Union[str, torch.device] = "cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> BlockedCNN:
    """MobileNet v1 with random weights drawn from ``generator`` (seed 0
    when None), on ``device``.  Every conv is 3x3 SAME with ReLU, except
    the blocks' 1x1 pointwise legs."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    layers = []
    for kind, ci, co, s in mobilenet_v1_layers(width_div):
        cls = BlockedConv2D if kind == "conv" else DepthwiseSeparableBlock
        layers.append(cls(ci, co, 3, 3, stride=s, padding="SAME",
                          activation="relu", lane=lane, device=device,
                          generator=gen))
    return BlockedCNN(layers, n_classes, device=device, generator=gen)


# (ci, co, filter, stride, padding, groups) of each conv
ALEXNET_LAYERS = ((3, 96, 11, 4, "VALID", 1),
                  (96, 256, 5, 2, ((1, 1), (1, 1)), 2),
                  (256, 384, 3, 2, "VALID", 1),
                  (384, 384, 3, 1, "SAME", 2),
                  (384, 256, 3, 1, "SAME", 2))
# the widest pencil target at which every boundary of the chain agrees
ALEXNET_LANE = 64


def alexnet_layers(width_div: int = 1) -> List[tuple]:
    """The five convs as ``(ci, co, filter, stride, padding, groups)``; the
    image's 3 channels are never divided."""
    widths = [co for _, co, *_ in ALEXNET_LAYERS]
    if width_div < 1 or any(c % (width_div * 2) for c in widths):
        raise ValueError(f"width_div={width_div} must leave every width "
                         f"{widths} split into two towers")
    out = []
    for ci, co, f, s, pad, g in ALEXNET_LAYERS:
        out.append((ci if ci == 3 else ci // width_div, co // width_div, f,
                    s, pad, g))
    return out


def alexnet_blocked(n_classes: int = 1000, width_div: int = 1, *,
                    lane: int = ALEXNET_LANE,
                    device: Union[str, torch.device] = "cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> BlockedCNN:
    """AlexNet's two-tower conv stack with random weights drawn from
    ``generator`` (seed 0 when None), on ``device``; every conv ReLU."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    convs = [BlockedConv2D(ci, co, f, f, stride=s, padding=pad,
                           activation="relu", groups=g, lane=lane,
                           device=device, generator=gen)
             for ci, co, f, s, pad, g in alexnet_layers(width_div)]
    return BlockedCNN(convs, n_classes, device=device, generator=gen)
