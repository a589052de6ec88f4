from .config import (Config, DataConfig, ModelConfig, PredictConfig,
                     get_cfg_defaults)

__all__ = ["Config", "DataConfig", "ModelConfig", "PredictConfig",
           "get_cfg_defaults"]
