"""Unet and UNet++ decoders (the canonical grid and the SMP layout), the
lane-aligned UnetTPU decoder, and the segmentation heads (models/unet.py in
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

from collections import OrderedDict
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QConv2d, current_mode
from .encoders import BatchNorm2d


def conv_bn_relu(cin: int, ch: int, split=None, kernel: int = 3,
                 named: bool = False) -> nn.Sequential:
    """ConvBnRelu. The kernel-3 conv is a QConv2d (JAX's SmartConv, which
    the int8 tier reaches); another kernel is a plain conv with padding
    kernel // 2, as JAX's nn.Conv. Sequential indices give the names
    convJ.0 / convJ.1 (SMP's, and JAX's _torch_name of a ConvBnRelu whose
    name starts with "conv"); `named` gives X.conv / X.bn, JAX's name for
    any other ConvBnRelu X. `split` marks a block's first conv
    (QConv2d.split)."""
    if kernel == 3:
        conv = QConv2d(cin, ch, 3, 1, 1, bias=False)
        conv.split = split
    else:
        conv = nn.Conv2d(cin, ch, kernel, 1, kernel // 2, bias=False)
    layers = (conv, BatchNorm2d(ch), nn.ReLU(inplace=True))
    if named:
        return nn.Sequential(OrderedDict(zip(("conv", "bn", "relu"),
                                             layers)))
    return nn.Sequential(*layers)


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


class SMPUnetPlusPlusDecoder(nn.Module):
    """The UNet++ decoder of segmentation-models-pytorch, which the
    reference's checkpoints hold (JAX's SMPUnetPlusPlusDecoder).

    The encoder features are indexed deepest-first, f[0] at stride 32 to
    f[4] at stride 2. Block x_{d}_{l} upsamples the block to its left
    (x_{d}_{l-1}, or f[d] in the first column) and concatenates
    [upsampled | x_{d+1}_{l} ... x_{l}_{l} | f[l + 1]]; a block of row 0
    outputs decoder_channels[l], an interior one the width of f[l + 1]. The
    last block, x_0_4, has no skip. Blocks are decoder.blocks.x_{d}_{l},
    smp's state_dict names."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        f_ch = list(encoder_channels[1:])[::-1]
        skip_ch = f_ch[1:] + [0]
        out_ch = list(decoder_channels)
        self.depth = depth = len(out_ch) - 1
        width = {}
        blocks = {}
        for layer in range(depth):
            for d in range(depth - layer):
                li = d + layer
                ch = out_ch[li] if d == 0 else skip_ch[li]
                if layer == 0:
                    cin, cskip = f_ch[d], f_ch[d + 1]
                else:
                    cin = width[(d, li - 1)]
                    cskip = sum(width[(i, li)] for i in range(d + 1, li + 1)
                                ) + f_ch[li + 1]
                blocks[f"x_{d}_{li}"] = DecoderBlock(cin, cskip, ch)
                width[(d, li)] = ch
        blocks[f"x_0_{depth}"] = DecoderBlock(width[(0, depth - 1)], 0,
                                              out_ch[depth])
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, feats: List[torch.Tensor]):
        f = list(feats[1:])[::-1]
        depth = self.depth
        dense = {}
        for layer in range(depth):
            for d in range(depth - layer):
                li = d + layer
                block = self.blocks[f"x_{d}_{li}"]
                if layer == 0:
                    dense[(d, d)] = block(f[d], f[d + 1])
                else:
                    cats = [dense[(i, li)] for i in range(d + 1, li + 1)]
                    cats.append(f[li + 1])
                    dense[(d, li)] = block(dense[(d, li - 1)],
                                           torch.cat(cats, dim=1))
        return self.blocks[f"x_0_{depth}"](dense[(0, depth - 1)])


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space in JAX's channel order, NCHW: input channel
    (ry * r + rx) * cout + c goes to output channel c at (r * y + ry,
    r * x + rx) (the (ry, rx, c) order with c fastest; F.pixel_shuffle's is
    c slowest, the same only for one output channel)."""
    n, ch, h, w = x.shape
    cout = ch // (r * r)
    x = x.reshape(n, r, r, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, cout, h * r, w * r)


class LaneAlignedDecoder(nn.Module):
    """UnetTPU's decoder (JAX's LaneAlignedDecoder, its default plan):
    three up-blocks from stride 32 to stride 4 (256, 128, 64 channels,
    skips at strides 16, 8, 4; a 3x3 refine conv after the first), the
    stride-2 feature brought down to stride 4 by a stride-2 3x3 conv
    (skip2_reduce, skip2_bn), and a 3x3 conv over both (fuse_conv1).
    Output: (N, 64, H/4, W/4), for PixelShuffleHead. Each block{i}_conv1
    is the Unet block's first conv ([up | skip], a QConv2d split into
    ":up" and ":skip" under a quant context); skip2_reduce is a QConv2d."""

    def __init__(self, encoder_channels: Sequence[int],
                 stage_channels: Sequence[int] = (256, 128, 64),
                 stage_refine: Sequence[bool] = (True, False, False),
                 fuse_channels: int = 64, skip2_channels: int = 64):
        super().__init__()
        self.stage_refine = tuple(stage_refine)
        cin = encoder_channels[5]
        for i, ch in enumerate(stage_channels):
            skip = encoder_channels[4 - i]
            setattr(self, f"block{i}_conv1", conv_bn_relu(
                cin + skip, ch, split=(cin, True), named=True))
            if stage_refine[i]:
                setattr(self, f"block{i}_conv2",
                        conv_bn_relu(ch, ch, named=True))
            cin = ch
        self.skip2_reduce = QConv2d(encoder_channels[1], skip2_channels, 3,
                                    2, 1, bias=False)
        self.skip2_bn = BatchNorm2d(skip2_channels)
        self.fuse_conv1 = conv_bn_relu(cin + skip2_channels, fuse_channels,
                                       named=True)
        self.out_channels = fuse_channels

    def forward(self, feats: List[torch.Tensor]):
        x = feats[5]
        quant = current_mode() is not None
        for i, skip in enumerate((feats[4], feats[3], feats[2])):
            block = getattr(self, f"block{i}_conv1")
            if quant:
                x = split_conv_bn_relu(block, x, skip)
            else:
                up = F.interpolate(x, scale_factor=2, mode="nearest")
                x = block(torch.cat([up, skip], dim=1))
            if self.stage_refine[i]:
                x = getattr(self, f"block{i}_conv2")(x)
        s2 = F.relu(self.skip2_bn(self.skip2_reduce(feats[1])))
        return self.fuse_conv1(torch.cat([x, s2], dim=1))


ACTIVATIONS = (None, "identity", "sigmoid", "softmax")


def _activate(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "softmax":
        return torch.softmax(x, dim=1)
    if activation not in (None, "identity"):
        raise ValueError(f"unsupported activation {activation}")
    return x


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
        return _activate(super().forward(x).float(), self.activation)


class PixelShuffleHead(nn.Sequential):
    """UnetTPU's head: a 3x3 conv with bias to ratio² · classes channels
    at 1/ratio of the output size, then pixel_shuffle in fp32 and the
    activation (SegmentationHead's)."""

    def __init__(self, cin: int, classes: int = 1, ratio: int = 4,
                 activation: Optional[str] = None):
        super().__init__(nn.Conv2d(cin, classes * ratio ** 2, 3, 1, 1,
                                   bias=True))
        self.ratio = ratio
        self.activation = activation

    def forward(self, x):
        x = pixel_shuffle(super().forward(x).float(), self.ratio)
        return _activate(x, self.activation)
