"""FFC-LaMa inpainting generator (models/lama.py in the JAX package).

  input  = image(3) ⊕ hole-mask(1), holes zeroed
  stem   = reflect pad, 7x7 conv → 64ch
  down   = 3 stride-2 convs → 512ch at /8
  body   = N FFC residual blocks (local 3x3 branch + global spectral branch)
  up     = 3 transposed convs → 64ch at /1
  head   = reflect pad, 7x7 conv → 3ch, sigmoid; composited:
           out * mask + image * (1 - mask)

NHWC in and out at the public boundary, as the JAX module; inside NCHW (a
permuted NHWC tensor is channels-last in memory, which cuDNN takes as it
is). Convs run in the model dtype; the spectral path, the sigmoid and the
discriminator's logits run in float32 (in float64 where the model is
float64, as checks run it; the JAX package casts them to float32 in
any dtype).
Serving casts the model to bf16 (create_lama); training keeps float32
parameters and runs the convs under bf16 autocast, flax's dtype /
param_dtype split (training/train_inpaint.py). The BatchNorms are
encoders.BatchNorm2d: in training their running variance follows flax's
(the biased batch variance), not torch's.

LamaDiscriminator is the PatchGAN the generator trains against.

The JAX package computes the orthonormal 2D DFT as dense matmuls because
its TPU runtime has no FFT; here it is torch.fft (cuFFT on the card), the
same transform. The transform is a full complex DFT, not rfft2: the
fourier conv's output is not Hermitian-symmetric, so the inverse takes
the real part of a full ifft2. The fourier conv sees the channels as
[all real | all imag], and the inverse splits them the same way.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .encoders import BatchNorm2d

# engine name → number of FFC blocks; 'mat' maps to big-lama as in JAX
VARIANTS = {"lama": 9, "big-lama": 18, "mat": 18}
GN_EPS = 1e-6  # flax.linen.GroupNorm's epsilon (torch's default is 1e-5)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in float64 where it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def dft2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal 2D DFT over the last two axes (H, W of NCHW), in
    float32 (float64 for a float64 x). Returns (real, imag)."""
    f = torch.fft.fft2(_f32(x), norm="ortho")
    return f.real, f.imag


def idft2_real(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """Real part of the orthonormal inverse 2D DFT over the last two axes."""
    return torch.fft.ifft2(torch.complex(_f32(real), _f32(imag)),
                           norm="ortho").real


class SpectralTransform(nn.Module):
    """Global branch: 1x1 reduce → DFT → 1x1 conv on stacked (real, imag)
    → inverse DFT → 1x1 project."""

    def __init__(self, cin: int, channels: int):
        super().__init__()
        half = channels // 2
        self.reduce = nn.Conv2d(cin, half, 1, bias=False)
        self.reduce_bn = _bn(half)
        self.fourier_conv = nn.Conv2d(2 * half, channels, 1, bias=False)
        self.fourier_bn = _bn(channels)
        self.project = nn.Conv2d(channels // 2, channels, 1, bias=False)

    def forward(self, x):
        dtype = x.dtype
        y = F.relu(self.reduce_bn(self.reduce(x)))
        fr_r, fr_i = dft2(y)
        fr = torch.cat([fr_r, fr_i], dim=1).to(dtype)
        fr = _f32(F.relu(self.fourier_bn(self.fourier_conv(fr))))
        half = fr.shape[1] // 2
        y2 = idft2_real(fr[:, :half], fr[:, half:]).to(dtype)
        return self.project(y2)


class FFC(nn.Module):
    """Fast Fourier Convolution: local/global split with cross terms."""

    def __init__(self, channels: int, ratio_g: float = 0.5):
        super().__init__()
        cg = int(channels * ratio_g)
        cl = channels - cg
        conv = lambda cin, ch: nn.Conv2d(cin, ch, 3, 1, 1, bias=False)
        self.l2l = conv(cl, cl)
        self.g2l = conv(cg, cl)
        self.l2g = conv(cl, cg)
        self.g2g = SpectralTransform(cg, cg)
        self.bn_l = _bn(cl)
        self.bn_g = _bn(cg)

    def forward(self, x_l, x_g):
        out_l = self.l2l(x_l) + self.g2l(x_g)
        out_g = self.l2g(x_l) + self.g2g(x_g)
        return F.relu(self.bn_l(out_l)), F.relu(self.bn_g(out_g))


class FFCResBlock(nn.Module):
    def __init__(self, channels: int, ratio_g: float = 0.5):
        super().__init__()
        self.ffc1 = FFC(channels, ratio_g)
        self.ffc2 = FFC(channels, ratio_g)

    def forward(self, x_l, x_g):
        y_l, y_g = self.ffc2(*self.ffc1(x_l, x_g))
        return y_l + x_l, y_g + x_g


class LamaGenerator(nn.Module):
    def __init__(self, base_channels: int = 64, num_blocks: int = 9,
                 ratio_g: float = 0.5):
        super().__init__()
        ch = base_channels
        self.stem = nn.Conv2d(4, ch, 7, bias=False)
        self.stem_bn = _bn(ch)
        for i in range(3):
            setattr(self, f"down{i}", nn.Conv2d(ch, 2 * ch, 3, 2, 1,
                                                bias=False))
            setattr(self, f"down{i}_bn", _bn(2 * ch))
            ch *= 2
        self.split = ch - int(ch * ratio_g)  # local channels first
        self.blocks = nn.ModuleList(FFCResBlock(ch, ratio_g)
                                    for _ in range(num_blocks))
        for i in range(3):
            setattr(self, f"up{i}", nn.ConvTranspose2d(ch, ch // 2, 4, 2, 1,
                                                       bias=False))
            setattr(self, f"up{i}_bn", _bn(ch // 2))
            ch //= 2
        self.head = nn.Conv2d(ch, 3, 7)

    def forward(self, image, mask):
        """image (N,H,W,3) [0,1]; mask (N,H,W,1), 1 = hole; H, W multiples
        of 8. Returns the composited image (N,H,W,3) float32: pixels where
        the mask is 0 are the input's."""
        dtype = self.stem.weight.dtype
        masked = image * (1.0 - mask)
        x = torch.cat([masked, mask], dim=-1).permute(0, 3, 1, 2).to(dtype)
        x = F.pad(x, (3, 3, 3, 3), mode="reflect")
        x = F.relu(self.stem_bn(self.stem(x)))
        for i in range(3):
            x = F.relu(getattr(self, f"down{i}_bn")(
                getattr(self, f"down{i}")(x)))
        x_l, x_g = x[:, :self.split], x[:, self.split:]
        for block in self.blocks:
            x_l, x_g = block(x_l, x_g)
        x = torch.cat([x_l, x_g], dim=1)
        for i in range(3):
            x = F.relu(getattr(self, f"up{i}_bn")(getattr(self, f"up{i}")(x)))
        x = self.head(F.pad(x, (3, 3, 3, 3), mode="reflect"))
        out = torch.sigmoid(_f32(x)).permute(0, 2, 3, 1)
        return out * mask + image * (1.0 - mask)


class LamaDiscriminator(nn.Module):
    """PatchGAN discriminator (models/lama.py:223-250 in the JAX package):
    four 4x4 convs with bias and padding 1 at strides 2, 2, 2, 1 to base,
    2, 4 and 8 x base channels, InstanceNorm (flax's GroupNorm with one
    channel a group, affine, epsilon 1e-6) after convs 1-3, leaky_relu
    0.2, and a 4x4 head to one channel. NHWC in; returns (float32 patch
    logits NHWC, the four feature maps NCHW)."""

    def __init__(self, base: int = 64):
        super().__init__()
        cin = 3
        for i, ch in enumerate((base, base * 2, base * 4, base * 8)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, 4, 2 if i < 3
                                                else 1, 1))
            if i > 0:
                setattr(self, f"norm{i}", nn.GroupNorm(ch, ch, eps=GN_EPS))
            cin = ch
        self.head = nn.Conv2d(cin, 1, 4, 1, 1)

    def forward(self, x):
        y = x.permute(0, 3, 1, 2).to(self.conv0.weight.dtype)
        feats = []
        for i in range(4):
            y = getattr(self, f"conv{i}")(y)
            if i > 0:
                y = getattr(self, f"norm{i}")(y)
            y = F.leaky_relu(y, 0.2)
            feats.append(y)
        return _f32(self.head(y)).permute(0, 2, 3, 1), feats


def create_lama(variant: str = "lama", dtype: torch.dtype = torch.bfloat16
                ) -> LamaGenerator:
    """'lama' = 9 FFC blocks; 'big-lama' and 'mat' = 18 (the reference's
    engine names are a quality knob). On the current default device; bf16
    by default, as the JAX factory."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown inpaint model '{variant}'")
    return LamaGenerator(num_blocks=VARIANTS[variant]).to(dtype)
