"""Unet decoder and segmentation head (models/unet.py in the JAX package).

This is the plain form: nearest up2x → concat [up, skip] → conv. The JAX
package's default FusedUpConvBnRelu is an exact rewrite of it on the same
parameters (kernel channel order [up | skip]).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .encoders import BN_EPS


def conv_bn_relu(cin: int, ch: int) -> nn.Sequential:
    """ConvBnRelu; Sequential indices give the SMP names convJ.0 / convJ.1."""
    return nn.Sequential(nn.Conv2d(cin, ch, 3, 1, 1, bias=False),
                         nn.BatchNorm2d(ch, eps=BN_EPS), nn.ReLU(inplace=True))


class DecoderBlock(nn.Module):
    """up2x → concat skip → (conv-bn-relu) x2."""

    def __init__(self, cin: int, cskip: int, ch: int):
        super().__init__()
        self.conv1 = conv_bn_relu(cin + cskip, ch)
        self.conv2 = conv_bn_relu(ch, ch)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    """5 DecoderBlocks; skips = strides 16, 8, 4, 2, and none for the last."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        skip_ch = [encoder_channels[4], encoder_channels[3],
                   encoder_channels[2], encoder_channels[1], 0]
        cin = [encoder_channels[5]] + list(decoder_channels[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(ci, cs, co)
            for ci, cs, co in zip(cin, skip_ch, decoder_channels))

    def forward(self, feats: List[torch.Tensor]):
        skips = [feats[4], feats[3], feats[2], feats[1], None]
        x = feats[5]
        for block, skip in zip(self.blocks, skips):
            x = block(x, skip)
        return x


class SegmentationHead(nn.Sequential):
    """3x3 conv with bias → logits, cast to fp32."""

    def __init__(self, cin: int, classes: int = 1):
        super().__init__(nn.Conv2d(cin, classes, 3, 1, 1, bias=True))

    def forward(self, x):
        return super().forward(x).float()
