"""The other decoder families (models/archs.py in the JAX package): FPN,
Linknet, PSPNet, MAnet, PAN, DeepLabV3 and DeepLabV3Plus, NCHW, over the
same 6-feature encoder pyramid. Each returns a full-resolution map for the
shared SegmentationHead and names its width in `out_channels`.

Module names are JAX's _torch_name of its flax paths: a ConvBnRelu X is
X.conv / X.bn, or X.0 / X.1 where X starts with "conv" (MFAB's conv1 and
conv2, DeepLabV3's conv); blocks{i} are blocks.{i}. Convs that JAX gives a
bias carry one: FPN's laterals, PAB's q/k/v, MFAB's fc1/fc2, FPA's
global/mid and GAU's up_conv. A ConvBnRelu with a 3x3 kernel runs int8
under a quant context (JAX's SmartConv); its 1x1, 5x5 and 7x7 forms, the
ASPP branches and the other plain convs stay in the model dtype, as JAX's
nn.Conv.

Where a straight translation would differ from JAX:
  * upsample_to with a factor that is not an integer is jax.image.resize's
    nearest, which samples at half-pixel centres: F.interpolate's
    "nearest-exact", not "nearest".
  * PSPNet pools with a static window h // b and the same stride (VALID)
    after clamping b to the map, not adaptively: at 16² the 6-bin branch
    is 8 x 8 and the 3-bin branch reads the first 15 rows.
  * FPA builds a pyramid level while its input is at least 2 px: one at
    64², three at 512². JAX creates a level's parameters only where it
    runs, so PANDecoder is built for an input size (SegmentationModel's
    img_size, MODEL's config at DATA.IMG_SIZE) and refuses a larger one.
  * PAB's softmax runs in float32 over q.k / sqrt(mid) and its result is
    cast to the model dtype before the product with v, as JAX's.
  * DeepLabV3 runs ASPP on the stride-32 map (no dilated encoder).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .encoders import BatchNorm2d
from .unet import conv_bn_relu


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return upsample_to(x, 2 * x.shape[2], 2 * x.shape[3])


def upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest upsample of an NCHW map to (h, w): a broadcast where both
    factors are integers, else jax.image.resize's nearest (half-pixel
    centres, F.interpolate's "nearest-exact")."""
    n, c, xh, xw = x.shape
    if (h, w) == (xh, xw):
        return x
    if h % xh == 0 and w % xw == 0:
        fh, fw = h // xh, w // xw
        y = x[:, :, :, None, :, None].expand(n, c, xh, fh, xw, fw)
        return y.reshape(n, c, h, w)
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


# ---------------------------------------------------------------------------
# FPN
# ---------------------------------------------------------------------------
class FPNDecoder(nn.Module):
    """Laterals (1x1 with bias) on strides 32..4 summed top-down, one
    branch a level (seg{i}_conv{u}: conv-bn-relu then up2x, as many times
    as the level is below stride 4, at least one conv), their sum brought
    from stride 4 to the input size."""

    def __init__(self, encoder_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128):
        super().__init__()
        for lvl in (5, 4, 3, 2):
            setattr(self, f"lateral{lvl}",
                    nn.Conv2d(encoder_channels[lvl], pyramid_channels, 1))
        self.ups = (3, 2, 1, 0)
        for i, ups in enumerate(self.ups):
            for u in range(max(ups, 1)):
                cin = pyramid_channels if u == 0 else segmentation_channels
                setattr(self, f"seg{i}_conv{u}", conv_bn_relu(
                    cin, segmentation_channels, named=True))
        self.out_channels = segmentation_channels

    def forward(self, feats: List[torch.Tensor]):
        p5 = self.lateral5(feats[5])
        p4 = self.lateral4(feats[4]) + upsample2x(p5)
        p3 = self.lateral3(feats[3]) + upsample2x(p4)
        p2 = self.lateral2(feats[2]) + upsample2x(p3)
        merged = None
        for i, (p, ups) in enumerate(zip((p5, p4, p3, p2), self.ups)):
            y = p
            for u in range(max(ups, 1)):
                y = getattr(self, f"seg{i}_conv{u}")(y)
                if u < ups:
                    y = upsample2x(y)
            merged = y if merged is None else merged + y
        return upsample_to(merged, 4 * p2.shape[2], 4 * p2.shape[3])


# ---------------------------------------------------------------------------
# LinkNet
# ---------------------------------------------------------------------------
class LinknetBlock(nn.Module):
    """1x1 reduce → up2x → 3x3 up_conv → 1x1 expand, each conv-bn-relu;
    the middle width max(cin // 4, 16)."""

    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        mid = max(cin // 4, 16)
        self.reduce = conv_bn_relu(cin, mid, kernel=1, named=True)
        self.up_conv = conv_bn_relu(mid, mid, named=True)
        self.expand = conv_bn_relu(mid, out_ch, kernel=1, named=True)

    def forward(self, x):
        return self.expand(self.up_conv(upsample2x(self.reduce(x))))


class LinknetDecoder(nn.Module):
    """Blocks 0-3 bring stride 32 to stride 2, each adding the encoder
    feature of its output stride; block 4 goes to the input size with 32
    channels."""

    out_channels = 32

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        widths = [encoder_channels[5], encoder_channels[4],
                  encoder_channels[3], encoder_channels[2],
                  encoder_channels[1], self.out_channels]
        self.blocks = nn.ModuleList(LinknetBlock(widths[i], widths[i + 1])
                                    for i in range(5))

    def forward(self, feats: List[torch.Tensor]):
        x = feats[5]
        for block, skip in zip(self.blocks, (feats[4], feats[3], feats[2],
                                             feats[1])):
            x = block(x) + skip
        return self.blocks[4](x)


# ---------------------------------------------------------------------------
# PSPNet
# ---------------------------------------------------------------------------
class PSPDecoder(nn.Module):
    """Pyramid pooling on the stride-32 map (bins 1, 2, 3, 6, each a
    static h // b window, a 1x1 psp{i} conv-bn-relu and a nearest
    upsample back), concatenated after the map, a 3x3 bottleneck and a
    nearest upsample x32."""

    def __init__(self, encoder_channels: Sequence[int],
                 out_channels: int = 512, bins: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        c = encoder_channels[5]
        branch_ch = max(c // len(bins), 32)
        self.bins = tuple(bins)
        for i in range(len(bins)):
            setattr(self, f"psp{i}", conv_bn_relu(c, branch_ch, kernel=1,
                                                  named=True))
        self.bottleneck = conv_bn_relu(c + len(bins) * branch_ch,
                                       out_channels, named=True)
        self.out_channels = out_channels

    def forward(self, feats: List[torch.Tensor]):
        x = feats[5]
        h, w = x.shape[2:]
        branches = [x]
        for i, b in enumerate(self.bins):
            b = min(b, h, w)
            win = (h // b, w // b)
            pooled = F.avg_pool2d(x, win, stride=win)
            y = getattr(self, f"psp{i}")(pooled)
            branches.append(upsample_to(y, h, w))
        y = self.bottleneck(torch.cat(branches, dim=1))
        return upsample_to(y, 32 * h, 32 * w)


# ---------------------------------------------------------------------------
# MAnet
# ---------------------------------------------------------------------------
class PAB(nn.Module):
    """Position attention: x + softmax(q k^T / sqrt(mid)) v over the map's
    pixels, q/k/v 1x1 convs with bias (mid = max(c // 8, 16)); the scores
    and softmax in float32, their result in the model dtype."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.mid = mid = max(channels // reduction, 16)
        self.q = nn.Conv2d(channels, mid, 1)
        self.k = nn.Conv2d(channels, mid, 1)
        self.v = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        q = self.q(x).reshape(n, self.mid, h * w)
        k = self.k(x).reshape(n, self.mid, h * w)
        v = self.v(x).reshape(n, c, h * w)
        # float32 products of model-dtype values (exact for bf16 inputs)
        attn = torch.bmm(q.transpose(1, 2).float(), k.float())
        attn = torch.softmax(attn / math.sqrt(float(self.mid)),
                             dim=-1).to(x.dtype)
        y = torch.bmm(v.float(), attn.transpose(1, 2).float()).to(x.dtype)
        return x + y.reshape(n, c, h, w)


class MFAB(nn.Module):
    """up2x, concat the skip, conv1 (3x3), channel attention (mean → fc1
    relu → fc2 sigmoid, 1x1 convs with bias, mid max(ch // 16, 8)), conv2."""

    def __init__(self, cin: int, cskip: int, channels: int,
                 reduction: int = 16):
        super().__init__()
        mid = max(channels // reduction, 8)
        self.conv1 = conv_bn_relu(cin + cskip, channels)
        self.fc1 = nn.Conv2d(channels, mid, 1)
        self.fc2 = nn.Conv2d(mid, channels, 1)
        self.conv2 = conv_bn_relu(channels, channels)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        x = upsample2x(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = self.conv1(x)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(_mean_hw(x)))))
        return self.conv2(x * s)


class MAnetDecoder(nn.Module):
    """PAB on the stride-32 map, then an MFAB a stride (skips at strides
    16, 8, 4, 2, none for the last) with decoder_channels."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.pab = PAB(encoder_channels[5])
        skip_ch = [encoder_channels[4], encoder_channels[3],
                   encoder_channels[2], encoder_channels[1], 0]
        cin = [encoder_channels[5]] + list(decoder_channels[:-1])
        self.blocks = nn.ModuleList(
            MFAB(ci, cs, co)
            for ci, cs, co in zip(cin, skip_ch, decoder_channels))
        self.out_channels = decoder_channels[-1]

    def forward(self, feats: List[torch.Tensor]):
        x = self.pab(feats[5])
        for block, skip in zip(self.blocks, (feats[4], feats[3], feats[2],
                                             feats[1], None)):
            x = block(x, skip)
        return x


# ---------------------------------------------------------------------------
# PAN
# ---------------------------------------------------------------------------
FPA_KERNELS = (7, 5, 3)


def fpa_levels(deepest: int) -> int:
    """The pyramid levels FPA builds on a deepest map of that size: one a
    2x2 average pool while the map is at least 2 px, at most three."""
    levels = 0
    while levels < len(FPA_KERNELS) and deepest >= 2:
        deepest //= 2
        levels += 1
    return levels


class FPA(nn.Module):
    """Feature pyramid attention: mid(x) * pyramid + global(mean x), the
    pyramid `levels` rounds of 2x2 average pool and a down{i} conv-bn-relu
    (7x7, 5x5, 3x3), summed back up by up2x, or 1 where no level fits."""

    def __init__(self, cin: int, out_ch: int, levels: int = 3):
        super().__init__()
        setattr(self, "global", nn.Conv2d(cin, out_ch, 1))
        self.mid = nn.Conv2d(cin, out_ch, 1)
        self.levels = levels
        for i in range(levels):
            setattr(self, f"down{i + 1}", conv_bn_relu(
                cin if i == 0 else out_ch, out_ch, kernel=FPA_KERNELS[i],
                named=True))

    def forward(self, x):
        g = getattr(self, "global")(_mean_hw(x))
        mid = self.mid(x)
        levels, y = [], x
        for i in range(len(FPA_KERNELS)):
            if y.shape[2] < 2 or y.shape[3] < 2:
                break
            if i == self.levels:
                raise ValueError(
                    f"FPA was built for {self.levels} pyramid levels and "
                    f"this input makes more (PAN's parameters depend on the "
                    f"input size, as JAX's: build it for this size)")
            y = getattr(self, f"down{i + 1}")(F.avg_pool2d(y, 2, 2))
            levels.append(y)
        pyr = None
        for y in reversed(levels):
            pyr = y if pyr is None else y + upsample2x(pyr)
        if pyr is None:
            return mid + g
        return mid * upsample2x(pyr) + g


class GAU(nn.Module):
    """Global attention upsample: up2x(up_conv(x)) + skip_conv(skip) *
    sigmoid(gate(mean x)), gate without a bias, up_conv with one."""

    def __init__(self, cin: int, cskip: int, out_ch: int):
        super().__init__()
        self.gate = nn.Conv2d(cin, out_ch, 1, bias=False)
        self.skip_conv = conv_bn_relu(cskip, out_ch, named=True)
        self.up_conv = nn.Conv2d(cin, out_ch, 1)

    def forward(self, x, skip):
        g = torch.sigmoid(self.gate(_mean_hw(x)))
        s = self.skip_conv(skip)
        return upsample2x(self.up_conv(x)) + s * g


class PANDecoder(nn.Module):
    """FPA on the stride-32 map, a GAU a stride (skips at strides 16, 8,
    4, 2), up2x to the input size; 32 channels. `img_size` fixes FPA's
    levels (fpa_levels of img_size // 32; None: three)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: int = 32,
                 img_size: Optional[int] = None):
        super().__init__()
        levels = len(FPA_KERNELS) if img_size is None else \
            fpa_levels(img_size // 32)
        self.fpa = FPA(encoder_channels[5], decoder_channels, levels)
        for i in range(4):
            setattr(self, f"gau{i}", GAU(decoder_channels,
                                         encoder_channels[4 - i],
                                         decoder_channels))
        self.out_channels = decoder_channels

    def forward(self, feats: List[torch.Tensor]):
        x = self.fpa(feats[5])
        for i, skip in enumerate((feats[4], feats[3], feats[2], feats[1])):
            x = getattr(self, f"gau{i}")(x, skip)
        return upsample2x(x)


# ---------------------------------------------------------------------------
# DeepLabV3 / DeepLabV3Plus
# ---------------------------------------------------------------------------
class ASPP(nn.Module):
    """b0 (1x1), b{1,2,3} (3x3 dilated at rates 6, 12, 18, no bias, each
    with its BatchNorm and relu), a global branch (mean, 1x1) broadcast
    over the map, concatenated and projected by a 1x1 conv-bn-relu."""

    def __init__(self, cin: int, out_ch: int = 256,
                 rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.rates = tuple(rates)
        self.b0 = conv_bn_relu(cin, out_ch, kernel=1, named=True)
        for i, r in enumerate(self.rates):
            setattr(self, f"b{i + 1}_conv", nn.Conv2d(
                cin, out_ch, 3, padding=r, dilation=r, bias=False))
            setattr(self, f"b{i + 1}_bn", BatchNorm2d(out_ch))
        setattr(self, "global", conv_bn_relu(cin, out_ch, kernel=1,
                                             named=True))
        self.project = conv_bn_relu((len(self.rates) + 2) * out_ch, out_ch,
                                    kernel=1, named=True)

    def forward(self, x):
        branches = [self.b0(x)]
        for i in range(len(self.rates)):
            y = getattr(self, f"b{i + 1}_conv")(x)
            branches.append(F.relu(getattr(self, f"b{i + 1}_bn")(y)))
        g = getattr(self, "global")(_mean_hw(x))
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(branches, dim=1))


class DeepLabV3Decoder(nn.Module):
    """ASPP on the stride-32 map, a 3x3 conv-bn-relu, nearest x32."""

    def __init__(self, encoder_channels: Sequence[int], out_ch: int = 256):
        super().__init__()
        self.aspp = ASPP(encoder_channels[5], out_ch)
        self.conv = conv_bn_relu(out_ch, out_ch)
        self.out_channels = out_ch

    def forward(self, feats: List[torch.Tensor]):
        y = self.conv(self.aspp(feats[5]))
        return upsample_to(y, 32 * y.shape[2], 32 * y.shape[3])


class DeepLabV3PlusDecoder(nn.Module):
    """ASPP on the stride-32 map brought to stride 4, concatenated with the
    stride-4 feature's 48-channel low_proj, two 3x3 conv-bn-relu (fuse1,
    fuse2), nearest x4."""

    def __init__(self, encoder_channels: Sequence[int], out_ch: int = 256,
                 low_ch: int = 48):
        super().__init__()
        self.aspp = ASPP(encoder_channels[5], out_ch)
        self.low_proj = conv_bn_relu(encoder_channels[2], low_ch, kernel=1,
                                     named=True)
        self.fuse1 = conv_bn_relu(out_ch + low_ch, out_ch, named=True)
        self.fuse2 = conv_bn_relu(out_ch, out_ch, named=True)
        self.out_channels = out_ch

    def forward(self, feats: List[torch.Tensor]):
        y = self.aspp(feats[5])
        h, w = y.shape[2:]
        y = upsample_to(y, 8 * h, 8 * w)
        y = torch.cat([y, self.low_proj(feats[2])], dim=1)
        y = self.fuse2(self.fuse1(y))
        return upsample_to(y, 32 * h, 32 * w)


def make_decoder(arch_l: str, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int],
                 img_size: Optional[int] = None) -> nn.Module:
    """The decoder of a lower-case arch name of this module."""
    if arch_l == "fpn":
        return FPNDecoder(encoder_channels)
    if arch_l == "linknet":
        return LinknetDecoder(encoder_channels)
    if arch_l == "pspnet":
        return PSPDecoder(encoder_channels)
    if arch_l == "manet":
        return MAnetDecoder(encoder_channels, tuple(decoder_channels))
    if arch_l == "pan":
        return PANDecoder(encoder_channels, img_size=img_size)
    if arch_l == "deeplabv3":
        return DeepLabV3Decoder(encoder_channels)
    if arch_l == "deeplabv3plus":
        return DeepLabV3PlusDecoder(encoder_channels)
    raise ValueError(f"unsupported architecture '{arch_l}'")
