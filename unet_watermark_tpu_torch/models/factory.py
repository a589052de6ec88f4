"""SegmentationModel, create_model_from_config and init_model
(models/factory.py in the JAX package), for archs "Unet" and "UnetPlusPlus"
(alias "unet++", canonical decoder)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .encoders import ResNetEncoder, remat
from .unet import SegmentationHead, UnetDecoder, UnetPlusPlusDecoder


class SegmentationModel(nn.Module):
    """Encoder + decoder + head. NHWC in, (N, H, W, classes) fp32 out, as
    the JAX model: logits, or their sigmoid or channel softmax under
    `activation` (SegmentationHead). Inside, the convolutions run NCHW (a
    permuted NHWC tensor is channels-last in memory)."""

    def __init__(self, arch: str = "Unet", encoder_name: str = "resnet34",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 classes: int = 1, decoder_impl: str = "canonical",
                 remat: bool = False, activation: Optional[str] = None):
        super().__init__()
        self.remat = remat
        arch_l = arch.lower()
        if arch_l in ("unetplusplus", "unet++") and decoder_impl == "smp":
            raise NotImplementedError(
                "the SMP-layout UNet++ decoder (MODEL.DECODER_IMPL 'smp') is "
                "not ported yet (see ROADMAP.md for the queue)")
        decoders = {"unet": UnetDecoder, "unetplusplus": UnetPlusPlusDecoder,
                    "unet++": UnetPlusPlusDecoder}
        if arch_l not in decoders:
            raise NotImplementedError(
                f"arch '{arch}' is not ported yet; the port has Unet and "
                f"UnetPlusPlus (see ROADMAP.md for the queue)")
        self.encoder = ResNetEncoder(encoder_name)
        self.encoder.remat = remat
        self.decoder = decoders[arch_l](self.encoder.out_channels,
                                        decoder_channels)
        self.segmentation_head = SegmentationHead(decoder_channels[-1],
                                                  classes, activation)

    def forward(self, x):
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"expected NHWC input with 3 channels, got {tuple(x.shape)}")
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(
                f"H and W must be multiples of 32 (5 stride-2 stages); got "
                f"{x.shape[1]}x{x.shape[2]}")
        dtype = next(self.parameters()).dtype
        feats = self.encoder(x.permute(0, 3, 1, 2).to(dtype))
        if self.remat and self.training and torch.is_grad_enabled():
            y = remat(lambda *f: self.decoder(list(f)), *feats)
        else:
            y = self.decoder(feats)
        return self.segmentation_head(y).permute(0, 2, 3, 1)


def create_model_from_config(cfg) -> SegmentationModel:
    """The model of cfg.MODEL, in float32 on the CPU; the caller moves it.
    MODEL.CLASSES sets the head's channels and MODEL.ACTIVATION its
    activation; MODEL.IN_CHANNELS other than 3 raises NotImplementedError,
    as in JAX. The JAX package's MODEL.FUSED_DECODER (its fused up-conv)
    computes the same function as the plain upsample + concat form the
    port runs, so the port does not read it."""
    if cfg.MODEL.IN_CHANNELS != 3:
        raise NotImplementedError("in_channels != 3 not yet supported")
    return SegmentationModel(arch=cfg.MODEL.NAME,
                             encoder_name=cfg.MODEL.ENCODER_NAME,
                             decoder_channels=tuple(
                                 cfg.MODEL.DECODER_CHANNELS),
                             classes=cfg.MODEL.CLASSES,
                             decoder_impl=cfg.MODEL.DECODER_IMPL,
                             remat=cfg.MODEL.REMAT,
                             activation=cfg.MODEL.ACTIVATION)


# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that the truncated samples' std is sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh parameters from the distributions of flax's defaults, as the
    JAX package's init_model and init_lama draw them: every conv,
    transposed conv and dense kernel lecun_normal (fan_in = kh·kw·cin, or
    the dense layer's inputs), biases zero, BatchNorm and GroupNorm scale 1
    and bias 0, running mean 0 and var 1. The draws come from a
    torch.Generator seeded with `seed` (they cannot equal jax.random's)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # ConvTranspose2d's weight is (cin, cout, kh, kw)
            fan_in = (mod.weight.shape[0] * mod.weight[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d)
                      else mod.weight[0].numel())
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
            mod.reset_parameters()
    return model


def torch_dtype(name: str) -> torch.dtype:
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"unsupported MODEL.DTYPE '{name}'")
    return dtypes[name]
