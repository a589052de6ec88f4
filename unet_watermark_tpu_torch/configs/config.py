"""The part of the JAX package's typed config tree that the port reads.

Field names and defaults are copied from unet_watermark_tpu/configs/config.py
(which imports yaml and so cannot be imported here). Only the fields the
detect→repair slice reads are present; YAML loading comes with a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    NAME: str = "UnetPlusPlus"
    ENCODER_NAME: str = "resnet34"
    DECODER_CHANNELS: List[int] = field(
        default_factory=lambda: [256, 128, 64, 32, 16])
    DTYPE: str = "bfloat16"  # compute dtype of the network; logits are fp32
    # UNet++ decoder layout: "canonical" (the Zhou grid of the shipped
    # weights); "smp" (the layout of reference .pth imports) is not ported
    DECODER_IMPL: str = "canonical"


@dataclass
class DataConfig:
    IMG_SIZE: int = 512


@dataclass
class PredictConfig:
    THRESHOLD: float = 0.5  # mask = sigmoid(logit) > THRESHOLD (strict)
    # "parity" = the reference's cv2 chain, "tight" = the
    # precision-preserving chain, "auto" = tight for the repair mask
    # (inference/maskproc.resolve_mask_mode)
    MASK_MODE: str = "auto"
    # trained FFC-LaMa weights for the repair engines; None = auto-resolve
    # (env PREDICT_INPAINT_WEIGHTS, then the shipped weights/lama_ffc.npz)
    INPAINT_WEIGHTS: Optional[str] = None


@dataclass
class Config:
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATA: DataConfig = field(default_factory=DataConfig)
    PREDICT: PredictConfig = field(default_factory=PredictConfig)


def get_cfg_defaults() -> Config:
    return Config()
