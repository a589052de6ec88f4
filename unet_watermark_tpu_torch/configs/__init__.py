from .config import (DEFAULT_CONFIG, Config, DataConfig, ModelConfig,
                     PredictConfig, TextWatermarkConfig, get_cfg_defaults,
                     update_config)

__all__ = ["DEFAULT_CONFIG", "Config", "DataConfig", "ModelConfig",
           "PredictConfig", "TextWatermarkConfig", "get_cfg_defaults",
           "update_config"]
