"""The model factory (models/factory.py in the JAX package): the ten
archs of SUPPORTED_MODELS over every encoder of encoders.available_encoders,
SMPModelFactory, create_model_from_config, init_model, count_parameters
and WatermarkSegmentationModel.

Unet and UnetPlusPlus (alias "unet++"; MODEL.DECODER_IMPL "canonical", the
Zhou grid, or "smp", the layout of segmentation-models-pytorch's
checkpoints) and UnetTPU (LaneAlignedDecoder with a x4 PixelShuffleHead)
are models/unet.py's; MAnet, Linknet, FPN, PSPNet, PAN, DeepLabV3 and
DeepLabV3Plus models/archs.py's. An unknown arch or encoder raises
ValueError with JAX's message. PAN's parameters depend on the input size,
as JAX's do (archs.py): create_model_from_config builds it for
DATA.IMG_SIZE, SegmentationModel for `img_size` (None: the largest
pyramid)."""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from . import archs
from .encoders import (available_encoders, get_encoder, get_encoder_channels,
                       remat)
from .unet import (LaneAlignedDecoder, PixelShuffleHead, SegmentationHead,
                   SMPUnetPlusPlusDecoder, UnetDecoder, UnetPlusPlusDecoder)

# JAX's table (models/factory.py:111-122), UnetTPU first
SUPPORTED_MODELS = {
    "UnetTPU": "TPU lane-aligned U-Net: ≥64ch stages, ×4 sub-pixel head",
    "Unet": "U-Net encoder-decoder with skip connections",
    "UnetPlusPlus": "UNet++ nested dense skip connections",
    "MAnet": "Multi-scale attention network",
    "Linknet": "LinkNet residual decoder",
    "FPN": "Feature pyramid network head",
    "PSPNet": "Pyramid scene parsing pooling head",
    "PAN": "Pyramid attention network",
    "DeepLabV3": "ASPP dilated-context head",
    "DeepLabV3Plus": "ASPP + low-level-feature decoder",
}


def canonical_model_name(model_name: str) -> str:
    """A model name in any case, or the alias "unet++", → its
    SUPPORTED_MODELS key; another name raises ValueError."""
    canon = {k.lower(): k for k in SUPPORTED_MODELS}
    canon["unet++"] = "UnetPlusPlus"
    if model_name.lower() not in canon:
        raise ValueError(
            f"unsupported model '{model_name}'. "
            f"supported: {list(SUPPORTED_MODELS)}")
    return canon[model_name.lower()]


def _make_decoder(arch: str, encoder_channels: Sequence[int],
                  decoder_channels: Sequence[int], decoder_impl: str,
                  img_size: Optional[int]) -> nn.Module:
    arch_l = canonical_model_name(arch).lower()
    if arch_l == "unet":
        return UnetDecoder(encoder_channels, decoder_channels)
    if arch_l == "unettpu":
        # a fixed stage plan: decoder_channels describes the 5-stage
        # contract this decoder leaves, as in JAX
        return LaneAlignedDecoder(encoder_channels)
    if arch_l == "unetplusplus":
        cls = (SMPUnetPlusPlusDecoder if decoder_impl == "smp"
               else UnetPlusPlusDecoder)
        return cls(encoder_channels, decoder_channels)
    return archs.make_decoder(arch_l, encoder_channels, decoder_channels,
                              img_size)


class SegmentationModel(nn.Module):
    """Encoder + decoder + head. NHWC in, (N, H, W, classes) fp32 out, as
    the JAX model: logits, or their sigmoid or channel softmax under
    `activation` (SegmentationHead; UnetTPU's PixelShuffleHead). Inside,
    the convolutions run NCHW (a permuted NHWC tensor is channels-last in
    memory)."""

    def __init__(self, arch: str = "Unet", encoder_name: str = "resnet34",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 classes: int = 1, decoder_impl: str = "canonical",
                 remat: bool = False, activation: Optional[str] = None,
                 img_size: Optional[int] = None):
        super().__init__()
        self.remat = remat
        self.arch = canonical_model_name(arch)
        self.encoder = get_encoder(encoder_name)
        self.encoder.remat = remat
        self.decoder = _make_decoder(arch, self.encoder.out_channels,
                                     tuple(decoder_channels), decoder_impl,
                                     img_size)
        cin = getattr(self.decoder, "out_channels", decoder_channels[-1])
        if self.arch == "UnetTPU":
            self.segmentation_head = PixelShuffleHead(cin, classes, 4,
                                                      activation)
        else:
            self.segmentation_head = SegmentationHead(cin, classes,
                                                      activation)

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


class SMPModelFactory:
    """JAX's SMPModelFactory: create_model validates the names (the
    encoder before anything is built) and builds a float32 model on the
    CPU. encoder_weights is accepted and not read, as in JAX (no
    pretrained weights are fetched); in_channels other than 3 raises
    NotImplementedError."""

    SUPPORTED_MODELS = SUPPORTED_MODELS

    @staticmethod
    def create_model(model_name: str = "UnetPlusPlus",
                     encoder_name: str = "resnet34",
                     encoder_weights: Optional[str] = "imagenet",
                     in_channels: int = 3, classes: int = 1,
                     decoder_channels: Sequence[int] = (256, 128, 64, 32,
                                                        16),
                     activation: Optional[str] = None,
                     remat: bool = False, decoder_impl: str = "canonical",
                     img_size: Optional[int] = None,
                     **kwargs) -> SegmentationModel:
        model_name = canonical_model_name(model_name)
        get_encoder_channels(encoder_name)  # validate the encoder early
        if in_channels != 3:
            raise NotImplementedError("in_channels != 3 not yet supported")
        return SegmentationModel(arch=model_name, encoder_name=encoder_name,
                                 decoder_channels=tuple(decoder_channels),
                                 classes=classes, decoder_impl=decoder_impl,
                                 remat=remat, activation=activation,
                                 img_size=img_size)

    @staticmethod
    def get_available_encoders() -> List[str]:
        return available_encoders()


def create_model_from_config(cfg) -> SegmentationModel:
    """The model of cfg.MODEL, in float32 on the CPU; the caller moves it.
    MODEL.CLASSES sets the head's channels and MODEL.ACTIVATION its
    activation; MODEL.IN_CHANNELS other than 3 raises NotImplementedError,
    as in JAX; PAN is built for DATA.IMG_SIZE, the size JAX initializes
    it at. The JAX package's MODEL.FUSED_DECODER (its fused up-conv)
    computes the same function as the plain upsample + concat form the
    port runs, so the port does not read it."""
    return SMPModelFactory.create_model(
        model_name=cfg.MODEL.NAME, encoder_name=cfg.MODEL.ENCODER_NAME,
        encoder_weights=cfg.MODEL.ENCODER_WEIGHTS,
        in_channels=cfg.MODEL.IN_CHANNELS, classes=cfg.MODEL.CLASSES,
        decoder_channels=cfg.MODEL.DECODER_CHANNELS,
        activation=cfg.MODEL.ACTIVATION, remat=cfg.MODEL.REMAT,
        decoder_impl=cfg.MODEL.DECODER_IMPL, img_size=cfg.DATA.IMG_SIZE)


def count_parameters(model: nn.Module) -> int:
    """The number of parameters (running statistics not counted), as JAX
    counts its params collection."""
    return sum(p.numel() for p in model.parameters())


# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that the truncated samples' std is sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0, device=None) -> nn.Module:
    """Fresh parameters from the distributions of flax's defaults, as the
    JAX package's init_model and init_lama draw them: every conv,
    transposed conv and dense kernel lecun_normal (fan_in = kh·kw·cin, or
    the dense layer's inputs), biases zero, BatchNorm and GroupNorm scale 1
    and bias 0, running mean 0 and var 1. The draws come from a
    torch.Generator seeded with `seed` (they cannot equal jax.random's) on
    `device`, the CPU unless given (the model's tensors must be there; a
    card draws other numbers than the CPU, in a fraction of the time)."""
    gen = torch.Generator(device or "cpu").manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # ConvTranspose2d's weight is (cin, cout, kh, kw)
            fan_in = (mod.weight.shape[0] * mod.weight[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d)
                      else mod.weight[0].numel())
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(mod.weight.shape, device=gen.device)
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


class WatermarkSegmentationModel:
    """The config's model (JAX's WatermarkSegmentationModel): built by
    create_model_from_config, drawn by init_model(seed), in MODEL.DTYPE
    and eval mode on `device` ("cuda" unless the caller asks for the CPU);
    called on NHWC images it returns the model's output."""

    def __init__(self, cfg, seed: int = 0, device: str = "cuda"):
        from ..utils.device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = init_model(create_model_from_config(cfg), seed).to(
            self.device, torch_dtype(cfg.MODEL.DTYPE)).eval()

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(torch.as_tensor(x, device=self.device))

    def get_model_info(self) -> dict:
        return {
            "model_name": self.cfg.MODEL.NAME,
            "encoder_name": self.cfg.MODEL.ENCODER_NAME,
            "parameters": count_parameters(self.model),
            "input_size": self.cfg.DATA.IMG_SIZE,
            "classes": self.cfg.MODEL.CLASSES,
        }
