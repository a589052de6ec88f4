from .factory import SegmentationModel, create_model_from_config

__all__ = ["SegmentationModel", "create_model_from_config"]
