"""The text-watermark trainer (text/ in the JAX package)."""
from .train_text_watermark import TextWatermarkTrainer

__all__ = ["TextWatermarkTrainer"]
