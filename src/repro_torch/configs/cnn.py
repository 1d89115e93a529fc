"""VGG-16 (Simonyan & Zisserman 2014, Table 1, configuration D) as a dense
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
(30.7 GFLOP) of convs per 224x224 image.  ``width_div`` divides every width
and exists only so that tests can build the same stack narrow.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from repro_torch.nn.conv import BlockedCNN, BlockedConv2D

__all__ = ["VGG16_WIDTHS", "VGG16_STRIDE2", "vgg16_layers", "vgg16_blocked"]

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
