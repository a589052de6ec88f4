from .encoders import available_encoders, get_encoder, get_encoder_channels
from .factory import (
    SUPPORTED_MODELS,
    SegmentationModel,
    SMPModelFactory,
    WatermarkSegmentationModel,
    count_parameters,
    create_model_from_config,
    init_model,
)

__all__ = [
    "SegmentationModel",
    "SMPModelFactory",
    "SUPPORTED_MODELS",
    "WatermarkSegmentationModel",
    "count_parameters",
    "create_model_from_config",
    "init_model",
    "available_encoders",
    "get_encoder",
    "get_encoder_channels",
]
