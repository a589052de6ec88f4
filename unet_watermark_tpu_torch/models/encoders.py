"""Encoder backbones (models/encoders.py in the JAX package), NCHW inside:
ResNet-18/34 (basic blocks), ResNet-50/101/152 (bottlenecks) and
EfficientNet-B0..B7 (MBConv), each returning the SMP 6-feature pyramid
[x, s2, s4, s8, s16, s32].

Module names follow JAX's _torch_name of the flax paths: the ResNets'
torchvision/SMP state_dict (conv1, bn1, layer1..layer4, downsample.0/.1),
EfficientNet's stem_conv, stem_bn and blocks.{i}.{expand,dw,project}_{conv,bn}
and blocks.{i}.se.{reduce,expand} (models/convert.py's name map). The
ResNets' convs are ops/quant.QConv2d, as JAX's are QConv: they run int8
under a quant context, under their flax paths (encoder/conv1,
encoder/layer{L}_{B}/conv{1,2,3}, encoder/layer{L}_0/downsample_conv).
EfficientNet's convs are plain convs in JAX (nn.Conv), so plain
nn.Conv2d here: they stay in the model dtype under a quant context. Its
BatchNorm has epsilon 1e-3, its activation is swish (SiLU), and its MBConv
has no drop-connect, as JAX's.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.quant import QConv2d
from ..parallel.distributed import all_reduce_sum, rank_and_world

BN_EPS = 1e-5

# set while torch.utils.checkpoint recomputes a forward in the backward
# pass: the running statistics were updated by the first forward
_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)

# set by global_batch_stats(): the global statistics' path in a world of
# one too (a plain flag, not a context variable: autograd's threads
# recompute checkpointed forwards and must read it as well)
_FORCE_GLOBAL = False


class BatchNorm2d(nn.BatchNorm2d):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=eps) in torch's form.

    Normalization and its gradient are torch's (batch statistics in
    training, the running ones in eval). The running variance is flax's:
    it moves toward the biased batch variance (torch's module moves it
    toward the unbiased one). The batch statistics come from the same call
    that normalizes (native_batch_norm's mean and 1/sqrt(var + eps)), and
    each buffer takes one lerp_ toward them. Nothing is updated while a
    checkpointed forward is recomputed.

    In a process group of more than one rank (parallel/, data-parallel
    training; or under global_batch_stats()) the batch statistics are the
    global batch's, as under JAX's jit over a sharded batch: flax's mean(x)
    and mean(x²) - mean(x)² from the per-channel sums of every rank's rows,
    reduced by a differentiable all-reduce, so the gradient flows through
    the global statistics; every rank's running buffers take the same
    values. A world of one keeps the library's batch norm."""

    def __init__(self, ch: int, eps: float = BN_EPS):
        super().__init__(ch, eps=eps, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if _FORCE_GLOBAL or rank_and_world()[1] > 1:
            return self._global_forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(invstd.pow(-2).sub_(self.eps),
                                       self.momentum)
        return y

    def _global_forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # as flax
        c = x.shape[1]
        count = x.numel() // c * rank_and_world()[1]
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)),
                                         xf.square().sum((0, 2, 3))]))
        mean, mean2 = sums[:c] / count, sums[c:] / count
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return y.to(x.dtype)


@contextlib.contextmanager
def global_batch_stats():
    """Every BatchNorm2d in train mode takes the global statistics' path
    (the sums' all-reduce, flax's variance) in a world of one as well, as
    a group of more than one rank runs it."""
    global _FORCE_GLOBAL
    before, _FORCE_GLOBAL = _FORCE_GLOBAL, True
    try:
        yield
    finally:
        _FORCE_GLOBAL = before


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


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (the stage's stride), 1x1 expand x4, each with its
    BatchNorm, (+downsample), relu: JAX's ResNetBottleneck."""

    expansion = 4

    def __init__(self, cin: int, ch: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = ch * self.expansion
        self.conv1 = QConv2d(cin, ch, 1, 1, 0, bias=False)
        self.bn1 = _bn(ch)
        self.conv2 = QConv2d(ch, ch, 3, stride, 1, bias=False)
        self.bn2 = _bn(ch)
        self.conv3 = QConv2d(ch, out, 1, 1, 0, bias=False)
        self.bn3 = _bn(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                QConv2d(cin, out, 1, stride, 0, bias=False), _bn(out))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


# name: (block, blocks a stage)
_RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}
_WIDTHS = (64, 128, 256, 512)


def resnet_out_channels(variant: str) -> Tuple[int, ...]:
    if _RESNET_SPECS[variant][0] is BasicBlock:
        return (3, 64, 64, 128, 256, 512)
    return (3, 64, 256, 512, 1024, 2048)


class ResNetEncoder(nn.Module):
    """With `remat` set, each residual block runs under remat() in
    training (the JAX encoder's nn.remat of each block). Block 0 of a
    stage has a downsample where its stride is 2, and in stage 1 of a
    bottleneck ResNet, where 64 channels become 256."""

    remat = False

    def __init__(self, variant: str = "resnet34"):
        super().__init__()
        block_cls, layers = _RESNET_SPECS[variant]
        self.out_channels = resnet_out_channels(variant)
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)  # pads with -inf
        cin = 64
        for i, (blocks, width) in enumerate(zip(layers, _WIDTHS)):
            stride = 1 if i == 0 else 2
            layer = []
            for b in range(blocks):
                if block_cls is BasicBlock:
                    layer.append(BasicBlock(cin, width,
                                            stride if b == 0 else 1))
                else:
                    layer.append(Bottleneck(cin, width,
                                            stride if b == 0 else 1,
                                            downsample=b == 0))
                cin = self.out_channels[i + 2]
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


# ---------------------------------------------------------------------------
# EfficientNet-B0..B7 (the JAX package's copy of timm's feature taps)
# ---------------------------------------------------------------------------
EFFNET_BN_EPS = 1e-3


def _round_channels(ch: float, multiplier: float, divisor: int = 8) -> int:
    ch *= multiplier
    new_ch = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new_ch < 0.9 * ch:
        new_ch += divisor
    return int(new_ch)


def _round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(multiplier * repeats))


# (expand_ratio, kernel, stride, in_ch, out_ch, repeats, se_ratio)
_EFFNET_BASE_BLOCKS = [
    (1, 3, 1, 32, 16, 1, 0.25),
    (6, 3, 2, 16, 24, 2, 0.25),
    (6, 5, 2, 24, 40, 2, 0.25),
    (6, 3, 2, 40, 80, 3, 0.25),
    (6, 5, 1, 80, 112, 3, 0.25),
    (6, 5, 2, 112, 192, 4, 0.25),
    (6, 3, 1, 192, 320, 1, 0.25),
]

_EFFNET_PARAMS = {
    # name: (width_mult, depth_mult)
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
}


def _effnet_bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, EFFNET_BN_EPS)


class SqueezeExcite(nn.Module):
    """x * sigmoid(expand(swish(reduce(mean(x))))), 1x1 convs with bias."""

    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.reduce = nn.Conv2d(ch, reduced, 1)
        self.expand = nn.Conv2d(reduced, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """[1x1 expand-bn-swish] → kxk depthwise-bn-swish → SE (its width a
    quarter of the block's input channels) → 1x1 project-bn, + the input
    where the stride is 1 and the widths agree."""

    def __init__(self, cin: int, out_ch: int, expand_ratio: int,
                 kernel: int, stride: int, se_ratio: float):
        super().__init__()
        mid = cin * expand_ratio
        self.residual = stride == 1 and cin == out_ch
        self.expand_conv = self.expand_bn = None
        if expand_ratio != 1:
            self.expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
            self.expand_bn = _effnet_bn(mid)
        self.dw_conv = nn.Conv2d(mid, mid, kernel, stride, kernel // 2,
                                 groups=mid, bias=False)
        self.dw_bn = _effnet_bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio))) \
            if se_ratio > 0 else None
        self.project_conv = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.project_bn = _effnet_bn(out_ch)

    def forward(self, x):
        y = x
        if self.expand_conv is not None:
            y = F.silu(self.expand_bn(self.expand_conv(y)))
        y = F.silu(self.dw_bn(self.dw_conv(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.project_bn(self.project_conv(y))
        return y + x if self.residual else y


def efficientnet_out_channels(variant: str) -> Tuple[int, ...]:
    width_mult, _ = _EFFNET_PARAMS[variant]
    return (3,) + tuple(_round_channels(c, width_mult)
                        for c in (16, 24, 40, 112, 320))


class EfficientNetEncoder(nn.Module):
    """The stem (3x3/2) and 7 stages of MBConv blocks; the pyramid taps
    the outputs of stages 0, 1, 2, 4 and 6 (strides 2, 4, 8, 16, 32), not
    the stem. MODEL.REMAT does not reach it, as in JAX."""

    remat = False

    def __init__(self, variant: str = "efficientnet-b3"):
        super().__init__()
        width_mult, depth_mult = _EFFNET_PARAMS[variant]
        self.out_channels = efficientnet_out_channels(variant)
        stem_ch = _round_channels(32, width_mult)
        self.stem_conv = nn.Conv2d(3, stem_ch, 3, 2, 1, bias=False)
        self.stem_bn = _effnet_bn(stem_ch)
        blocks, self.stage_ends = [], []
        cin = stem_ch
        for er, k, s, _, cout, reps, se in _EFFNET_BASE_BLOCKS:
            out_ch = _round_channels(cout, width_mult)
            for r in range(_round_repeats(reps, depth_mult)):
                blocks.append(MBConv(cin, out_ch, er, k, s if r == 0 else 1,
                                     se))
                cin = out_ch
            self.stage_ends.append(len(blocks) - 1)
        self.blocks = nn.ModuleList(blocks)
        self.taps = {self.stage_ends[i] for i in (0, 1, 2, 4, 6)}

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        y = F.silu(self.stem_bn(self.stem_conv(x)))
        for i, block in enumerate(self.blocks):
            y = block(y)
            if i in self.taps:
                feats.append(y)
        return feats


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def _canonical(name: str) -> str:
    return name.replace("timm-", "")


def get_encoder(name: str) -> nn.Module:
    """The encoder of that name (a "timm-" prefix is dropped, as in JAX);
    an unknown name raises ValueError with JAX's message."""
    name = _canonical(name)
    if name in _RESNET_SPECS:
        return ResNetEncoder(name)
    if name in _EFFNET_PARAMS:
        return EfficientNetEncoder(name)
    raise ValueError(
        f"unsupported encoder '{name}'. available: "
        f"{sorted(_RESNET_SPECS) + sorted(_EFFNET_PARAMS)}")


def get_encoder_channels(name: str) -> Tuple[int, ...]:
    name = _canonical(name)
    if name in _RESNET_SPECS:
        return resnet_out_channels(name)
    if name in _EFFNET_PARAMS:
        return efficientnet_out_channels(name)
    raise ValueError(f"unsupported encoder '{name}'")


def available_encoders() -> List[str]:
    return sorted(_RESNET_SPECS) + sorted(_EFFNET_PARAMS)
