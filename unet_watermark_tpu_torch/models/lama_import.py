"""The public big-lama checkpoint as a fill engine (models/lama_import.py
in the JAX package).

The reference fills with iopaint's LaMa, the public big-lama checkpoint: a
saicinpainting FFCResNetGenerator (the `models/best.ckpt` training
checkpoint, its keys prefixed `generator.`, or an iopaint export with bare
`model.*` keys). BigLamaGenerator is that module tree, so its state_dict
keys are the checkpoint's own and the import is a prefix strip
(normalize_state_dict) and a strict name-and-shape load (load_big_lama):

  model.0              ReflectionPad2d(3)
  model.1              FFC_BN_ACT(4→64,    k7, ratio 0→0)
  model.2 .. model.4   FFC_BN_ACT k3 s2, reflect padding: 64→128→256→512,
                       the last splitting 0.75 of its output off as the
                       global branch
  model.5 .. model.22  FFCResnetBlock(512, ratio 0.75): conv1, conv2
  model.23             ConcatTupleLayer
  model.24/27/30       ConvTranspose2d(k3, s2, p1, op1) 512→256→128→64
  model.25/28/31       BatchNorm2d, model.26/29/32 ReLU
  model.33             ReflectionPad2d(3), model.34 Conv2d(64→3, k7),
  model.35             Sigmoid

then the composite out * mask + image * (1 - mask), as JAX's generator.
Inside an FFC the branch convs are bias-free with reflect padding;
convg2g is the SpectralTransform: conv1 (1x1 to half, BN, ReLU), the
FourierUnit (rfft2 with norm "ortho", (re, im) interleaved per channel
[c0_re, c0_im, c1_re, ...], 1x1 conv + BN + ReLU, de-interleave, irfft2
to the input's size) and conv2 (1x1) on conv1's output plus the unit's.
JAX computes the two FFTs as dense DFT matmuls for its TPU; torch.fft
computes the same function (cuFFT on the card). BatchNorm runs in eval
mode; the generator runs in float32, as JAX's load_big_lama builds it.
Inputs and outputs are NHWC, as every fill engine's.
"""
from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .torch_import import load_pth

logger = logging.getLogger(__name__)

NGF = 64
N_DOWN = 3
N_BLOCKS = 18
RATIO_G = 0.75


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0):
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False,
                     padding_mode="reflect")


class FourierUnit(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * channels, 2 * channels, 1,
                                    bias=False)
        self.bn = nn.BatchNorm2d(2 * channels)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        n, c, h, w = x.shape
        f = torch.fft.rfftn(x.float(), dim=(-2, -1), norm="ortho")
        f = torch.stack((f.real, f.imag), dim=2).reshape(n, 2 * c, h, -1)
        f = self.relu(self.bn(self.conv_layer(f)))
        f = f.reshape(n, c, 2, h, -1)
        f = torch.complex(f[:, :, 0], f[:, :, 1])
        return torch.fft.irfftn(f, s=(h, w), dim=(-2, -1),
                                norm="ortho").to(x.dtype)


class SpectralTransform(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout // 2, 1, bias=False),
                                   nn.BatchNorm2d(cout // 2),
                                   nn.ReLU(inplace=True))
        self.fu = FourierUnit(cout // 2)
        self.conv2 = nn.Conv2d(cout // 2, cout, 1, bias=False)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(x + self.fu(x))


class FFC(nn.Module):
    """The four cross-branch convs; a branch with no channels on either
    side has no conv (torch's nn.Identity there holds no weights)."""

    def __init__(self, in_cl, in_cg, out_cl, out_cg, k, stride, pad):
        super().__init__()
        conv = lambda ci, co: _conv(ci, co, k, stride, pad)  # noqa: E731
        self.convl2l = conv(in_cl, out_cl) if in_cl and out_cl else None
        self.convl2g = conv(in_cl, out_cg) if in_cl and out_cg else None
        self.convg2l = conv(in_cg, out_cl) if in_cg and out_cl else None
        self.convg2g = SpectralTransform(in_cg, out_cg) \
            if in_cg and out_cg else None

    def forward(self, x_l, x_g):
        out_l = out_g = None
        if self.convl2l is not None:
            out_l = self.convl2l(x_l)
        if self.convg2l is not None:
            t = self.convg2l(x_g)
            out_l = t if out_l is None else out_l + t
        if self.convl2g is not None:
            out_g = self.convl2g(x_l)
        if self.convg2g is not None:
            t = self.convg2g(x_g)
            out_g = t if out_g is None else out_g + t
        return out_l, out_g


class FFCBnAct(nn.Module):
    """FFC_BN_ACT: the FFC, then BatchNorm and ReLU on each branch."""

    def __init__(self, in_cl, in_cg, out_cl, out_cg, k=3, stride=1, pad=1):
        super().__init__()
        self.ffc = FFC(in_cl, in_cg, out_cl, out_cg, k, stride, pad)
        self.bn_l = nn.BatchNorm2d(out_cl) if out_cl else None
        self.bn_g = nn.BatchNorm2d(out_cg) if out_cg else None

    def forward(self, x):
        # the first one takes a tensor, the others a (local, global) pair
        out_l, out_g = self.ffc(*(x if isinstance(x, tuple) else (x, None)))
        if out_l is not None:
            out_l = F.relu(self.bn_l(out_l))
        if out_g is not None:
            out_g = F.relu(self.bn_g(out_g))
        return out_l, out_g


class FFCResnetBlock(nn.Module):
    def __init__(self, channels: int, ratio_g: float = RATIO_G):
        super().__init__()
        cg = int(channels * ratio_g)
        cl = channels - cg
        self.conv1 = FFCBnAct(cl, cg, cl, cg)
        self.conv2 = FFCBnAct(cl, cg, cl, cg)

    def forward(self, x):
        x_l, x_g = self.conv2(self.conv1(x))
        return x[0] + x_l, x[1] + x_g


class _Concat(nn.Module):
    """ConcatTupleLayer."""

    def forward(self, x):
        return torch.cat(x, dim=1)


class BigLamaGenerator(nn.Module):
    """FFCResNetGenerator with big-lama's hyperparameters; `model.N` are
    the checkpoint's module indices. Called as every fill engine:
    (images (N, H, W, 3) [0, 1], masks (N, H, W, 1) {0, 1}) → images."""

    def __init__(self, ngf: int = NGF, n_blocks: int = N_BLOCKS,
                 ratio_g: float = RATIO_G):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), FFCBnAct(4, 0, ngf, 0, k=7, pad=0)]
        ch = ngf
        for i in range(N_DOWN):
            out_cg = int(2 * ch * ratio_g) if i == N_DOWN - 1 else 0
            layers.append(FFCBnAct(ch, 0, 2 * ch - out_cg, out_cg, k=3,
                                   stride=2, pad=1))
            ch *= 2
        layers += [FFCResnetBlock(ch, ratio_g) for _ in range(n_blocks)]
        layers.append(_Concat())
        for _ in range(N_DOWN):
            layers += [nn.ConvTranspose2d(ch, ch // 2, 3, 2, 1, 1),
                       nn.BatchNorm2d(ch // 2), nn.ReLU(inplace=True)]
            ch //= 2
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ch, 3, 7),
                   nn.Sigmoid()]
        self.model = nn.Sequential(*layers)

    def forward(self, image, mask):
        img = image.permute(0, 3, 1, 2).float()
        m = mask.permute(0, 3, 1, 2).float()
        x = torch.cat([img * (1.0 - m), m], dim=1).to(
            self.model[-2].weight.dtype)
        out = self.model(x).float()
        return (out * m + img * (1.0 - m)).permute(0, 2, 3, 1)


def normalize_state_dict(sd: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """The generator's keys of a checkpoint: the 'module.' and
    'generator.' prefixes dropped, and only 'model.*' kept (a
    saicinpainting best.ckpt also holds the discriminator and the losses'
    tensors)."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.startswith("generator."):
            k = k[len("generator."):]
        if k.startswith("model."):
            out[k] = v
    return out


@torch.no_grad()
def import_big_lama(sd: Dict[str, np.ndarray], model: BigLamaGenerator
                    ) -> Dict[str, list]:
    """Copy a (raw or normalized) big-lama state dict into `model` by name
    and shape (the model's tensors are replaced, so a model on the meta
    device gets real ones); returns JAX's report: loaded, missing (the
    model's tensors the file does not give, by their names here) and
    unused (the file's generator keys no tensor took, num_batches_tracked
    left out)."""
    sd = normalize_state_dict(sd)
    report: Dict[str, list] = {"loaded": [], "missing": [], "unused": []}
    target = model.state_dict()
    new = {}
    for name, t in target.items():
        if name.endswith("num_batches_tracked"):
            new[name] = torch.as_tensor(sd.get(name, 0), dtype=torch.long)
            continue
        arr = sd.get(name)
        if arr is not None and tuple(arr.shape) == tuple(t.shape):
            new[name] = torch.as_tensor(np.asarray(arr, np.float32))
            report["loaded"].append(name)
        else:
            report["missing"].append(name)
    model.load_state_dict(new, strict=False, assign=True)
    report["unused"] = sorted(k for k in sd if k not in report["loaded"]
                              and "num_batches_tracked" not in k)
    logger.info("big-lama import: %d loaded, %d missing, %d unused",
                len(report["loaded"]), len(report["missing"]),
                len(report["unused"]))
    return report


def load_big_lama(path, device="cuda") -> Tuple[BigLamaGenerator,
                                                 Dict[str, list]]:
    """A torch checkpoint file → (the generator in eval mode, float32, on
    `device`; the import report). `device` is "cuda" unless the caller
    asks for the CPU. Raises ValueError where the file is not a big-lama
    generator: nothing maps, or a tensor is missing."""
    device = resolve_device(device)
    sd = load_pth(str(path))
    with torch.device("meta"):  # shapes only: the file's tensors replace them
        model = BigLamaGenerator()
    report = import_big_lama(sd, model)
    if not report["loaded"] or report["missing"]:
        raise ValueError(
            f"{path} does not match the big-lama generator layout "
            f"({len(report['loaded'])} loaded, "
            f"{len(report['missing'])} missing)")
    return model.eval().to(device), report
