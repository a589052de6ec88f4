"""ResNet encoder (models/encoders.py in the JAX package), NCHW inside.

Returns the SMP 6-feature pyramid [x, s2, s4, s8, s16, s32]. Module names
follow the torchvision/SMP state_dict (conv1, bn1, layer1..layer4,
downsample.0/.1), which is the name map models/convert.py applies. The
convs are ops/quant.QConv2d: the 36 of resnet34 run int8 under a quant
context, under their flax paths (encoder/conv1, encoder/layer{L}_{B}/conv{1,2},
encoder/layer{L}_0/downsample_conv).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.quant import QConv2d

BN_EPS = 1e-5

# set while torch.utils.checkpoint recomputes a forward in the backward
# pass: the running statistics were updated by the first forward
_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)


class BatchNorm2d(nn.BatchNorm2d):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) in torch's form.

    Normalization and its gradient are torch's (batch statistics in
    training, the running ones in eval). The running variance is flax's:
    it moves toward the biased batch variance (torch's module moves it
    toward the unbiased one). The batch statistics come from the same call
    that normalizes (native_batch_norm's mean and 1/sqrt(var + eps)), and
    each buffer takes one lerp_ toward them. Nothing is updated while a
    checkpointed forward is recomputed."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(invstd.pow(-2).sub_(self.eps),
                                       self.momentum)
        return y


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def remat(fn, *args):
    """fn(*args) under torch.utils.checkpoint (MODEL.REMAT, jax.remat in
    the JAX package): its activations are recomputed in the backward pass,
    with the BatchNorm statistics left as the first forward set them."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch)


class BasicBlock(nn.Module):
    """conv3x3-bn-relu, conv3x3-bn, (+downsample), relu."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = QConv2d(cin, ch, 3, stride, 1, bias=False)
        self.bn1 = _bn(ch)
        self.conv2 = QConv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn2 = _bn(ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != ch:
            self.downsample = nn.Sequential(
                QConv2d(cin, ch, 1, stride, 0, bias=False), _bn(ch))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


_RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
_WIDTHS = (64, 128, 256, 512)


def resnet_out_channels(variant: str) -> Tuple[int, ...]:
    if variant not in _RESNET_LAYERS:
        raise NotImplementedError(
            f"encoder '{variant}' is not ported yet (see ROADMAP.md); "
            f"ported: {sorted(_RESNET_LAYERS)}")
    return (3, 64, 64, 128, 256, 512)


class ResNetEncoder(nn.Module):
    """With `remat` set, each residual block runs under remat() in
    training (the JAX encoder's nn.remat of each block)."""

    remat = False

    def __init__(self, variant: str = "resnet34"):
        super().__init__()
        self.out_channels = resnet_out_channels(variant)
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)  # pads with -inf
        cin = 64
        for i, (blocks, width) in enumerate(zip(_RESNET_LAYERS[variant],
                                                _WIDTHS)):
            stride = 1 if i == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock(cin, width, stride if b == 0 else 1))
                cin = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        y = self.relu(self.bn1(self.conv1(x)))
        feats.append(y)
        y = self.maxpool(y)
        ckpt = self.remat and self.training and torch.is_grad_enabled()
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                y = remat(block, y) if ckpt else block(y)
            feats.append(y)
        return feats
