"""Unet and UNet++ decoders and the segmentation head (models/unet.py in
the JAX package).

These are the plain forms: nearest up2x → concat → conv. The JAX package's
default FusedUpConvBnRelu is an exact rewrite of them on the same
parameters. The two decoders concatenate in opposite orders, which the
kernels' input channels follow: the Unet block [up | skip], a UNet++ cell
[skips... | up].

Under a quant context (ops/quant.py) each block's first conv runs as the
JAX package's SplitUpConcatConv instead (QConv2d.forward_split: the
lhs-dilated conv of the lower feature with the fused 4x4 kernel plus the
3x3 conv of the skips, each int8 with its own scale); outside one the
plain forms above run unchanged.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QConv2d, current_mode
from .encoders import BatchNorm2d


def conv_bn_relu(cin: int, ch: int, split=None) -> nn.Sequential:
    """ConvBnRelu; Sequential indices give the SMP names convJ.0 / convJ.1.
    `split` marks a block's first conv (QConv2d.split)."""
    conv = QConv2d(cin, ch, 3, 1, 1, bias=False)
    conv.split = split
    return nn.Sequential(conv, BatchNorm2d(ch), nn.ReLU(inplace=True))


def split_conv_bn_relu(block: nn.Sequential, x_low: torch.Tensor,
                       skip: Optional[torch.Tensor]) -> torch.Tensor:
    """A first conv_bn_relu over concat(up2x(x_low), skip) as
    FusedUpConvBnRelu runs it (QConv2d.forward_split)."""
    conv, bn, relu = block
    return relu(bn(conv.forward_split(x_low, skip)))


class DecoderBlock(nn.Module):
    """up2x → concat skip → (conv-bn-relu) x2."""

    def __init__(self, cin: int, cskip: int, ch: int):
        super().__init__()
        self.conv1 = conv_bn_relu(cin + cskip, ch, split=(cin, True))
        self.conv2 = conv_bn_relu(ch, ch)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        if current_mode() is not None:
            return self.conv2(split_conv_bn_relu(self.conv1, x, skip))
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


class UnetPlusPlusDecoder(nn.Module):
    """The canonical UNet++ grid (Zhou et al. 2018), not SMP's variant.

    X[i][0] is the encoder feature at stride 2^(i+1) (feats[i + 1]) and
    X[i][j] = conv2(conv1(concat(X[i][0..j-1], up2x(X[i+1][j-1])))) for
    i + j <= 4, with row widths decoder_channels[3], [2], [1], [0] for rows
    0-3; a skip-less final_block takes X[0][4] to stride 1 with
    decoder_channels[4] channels. Cells are attributes x_{i}_{j}_conv{1,2},
    the JAX package's names.
    """

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        row_ch = [decoder_channels[3], decoder_channels[2],
                  decoder_channels[1], decoder_channels[0]]
        width = {(i, 0): encoder_channels[i + 1] for i in range(5)}
        for j in range(1, 5):
            for i in range(5 - j):
                cin = sum(width[(i, k)] for k in range(j)) + width[(i + 1,
                                                                   j - 1)]
                setattr(self, f"x_{i}_{j}_conv1", conv_bn_relu(
                    cin, row_ch[i], split=(width[(i + 1, j - 1)], False)))
                setattr(self, f"x_{i}_{j}_conv2",
                        conv_bn_relu(row_ch[i], row_ch[i]))
                width[(i, j)] = row_ch[i]
        self.final_block = DecoderBlock(width[(0, 4)], 0, decoder_channels[4])

    def forward(self, feats: List[torch.Tensor]):
        grid = {(i, 0): feats[i + 1] for i in range(5)}
        quant = current_mode() is not None
        for j in range(1, 5):
            for i in range(5 - j):
                if quant:  # the skips as one tensor with one scale
                    cats = [grid[(i, k)] for k in range(j)]
                    x = split_conv_bn_relu(
                        getattr(self, f"x_{i}_{j}_conv1"),
                        grid[(i + 1, j - 1)],
                        torch.cat(cats, dim=1) if j > 1 else cats[0])
                    grid[(i, j)] = getattr(self, f"x_{i}_{j}_conv2")(x)
                    continue
                up = F.interpolate(grid[(i + 1, j - 1)], scale_factor=2,
                                   mode="nearest")
                x = torch.cat([grid[(i, k)] for k in range(j)] + [up], dim=1)
                x = getattr(self, f"x_{i}_{j}_conv1")(x)
                grid[(i, j)] = getattr(self, f"x_{i}_{j}_conv2")(x)
        return self.final_block(grid[(0, 4)])


ACTIVATIONS = (None, "identity", "sigmoid", "softmax")


class SegmentationHead(nn.Sequential):
    """3x3 conv with bias → `classes` logits, cast to fp32, then the
    activation: None or "identity" keeps the logits, "sigmoid", or
    "softmax" over the channels; any other name raises ValueError, as
    JAX's head does when it is applied."""

    def __init__(self, cin: int, classes: int = 1,
                 activation: Optional[str] = None):
        super().__init__(nn.Conv2d(cin, classes, 3, 1, 1, bias=True))
        self.activation = activation

    def forward(self, x):
        x = super().forward(x).float()
        if self.activation == "sigmoid":
            return torch.sigmoid(x)
        if self.activation == "softmax":
            return torch.softmax(x, dim=1)
        if self.activation not in (None, "identity"):
            raise ValueError(f"unsupported activation {self.activation}")
        return x
