"""Reader of the shipped-weights .npz format (utils/shipping.py in the
JAX package).

A float leaf is stored as a uint16 view of its bfloat16 bits under the key
"BF16::<flax path>"; every other entry is stored as it is.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "unet_watermark_tpu" / "weights"


def seg_weights_path(model_name: str, encoder_name: str) -> Path:
    """The shipped segmentation weights of one arch/encoder pair, named as
    the JAX package's seg_weights_filename names them (the alias "unet++"
    finds UnetPlusPlus's file)."""
    name = model_name.lower().replace("unet++", "unetplusplus")
    return WEIGHTS_DIR / f"seg_{name}_{encoder_name.lower()}.npz"


def decode_bf16(u16: np.ndarray) -> np.ndarray:
    """bfloat16 bits (as uint16) → the float32 values they denote, exactly."""
    return (u16.astype(np.uint32) << 16).view(np.float32)


def load_npz(path) -> Dict[str, np.ndarray]:
    """{flax path: array}; BF16 entries decoded to float32."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            if k.startswith("BF16::"):
                out[k[len("BF16::"):]] = decode_bf16(v)
            else:
                out[k] = v
    return out
