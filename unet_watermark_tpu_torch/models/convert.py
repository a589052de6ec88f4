"""Flat flax weights (models/torch_import.py's name and layout map in the
JAX package, copied) → the port's state_dict.

  params/encoder/conv1/kernel          → encoder.conv1.weight (HWIO → OIHW)
  params/encoder/bn1/{scale,bias}      → encoder.bn1.{weight,bias}
  batch_stats/.../bn1/{mean,var}       → ...bn1.running_{mean,var}
  params/encoder/layer{L}_{B}/...      → encoder.layer{L}.{B}....
  .../downsample_conv, downsample_bn   → ....downsample.0, .downsample.1
  params/decoder/block{i}/convJ/conv   → decoder.blocks.{i}.convJ.0
  params/decoder/block{i}/convJ/bn     → decoder.blocks.{i}.convJ.1
  params/decoder/x_{i}_{j}_convJ/conv  → decoder.x_{i}_{j}_convJ.0 (UNet++)
  params/decoder/final_block/convJ/bn  → decoder.final_block.convJ.1
  params/segmentation_head/conv        → segmentation_head.0
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
# a ConvBnRelu: convJ of a Unet block or final_block, x_{i}_{j}_convJ of UNet++
_CONV_BN = re.compile(r"(x_\d+_\d+_)?conv\d+")


def torch_name(flax_key: str) -> str:
    """'params/encoder/layer1_0/conv1/kernel' → 'encoder.layer1.0.conv1.weight'."""
    collection, *parts = flax_key.split("/")
    leaf = parts.pop()
    leaf_map = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    if collection not in ("params", "batch_stats") or leaf not in leaf_map:
        raise KeyError(f"no port counterpart for weight '{flax_key}'")
    segs = []
    for p in parts:
        m = re.fullmatch(r"layer(\d+)_(\d+)", p)
        if m:
            segs.append(f"layer{m.group(1)}.{m.group(2)}")
        elif re.fullmatch(r"block\d+", p):
            segs.append("blocks." + p[len("block"):])
        elif p == "downsample_conv":
            segs.append("downsample.0")
        elif p == "downsample_bn":
            segs.append("downsample.1")
        elif p == "conv" and segs and (_CONV_BN.fullmatch(segs[-1])
                                       or segs[-1] == "segmentation_head"):
            segs[-1] += ".0"
        elif p == "bn" and segs and _CONV_BN.fullmatch(segs[-1]):
            segs[-1] += ".1"
        else:
            segs.append(p)
    return ".".join(segs) + "." + leaf_map[leaf]


def to_state_dict(flat: Dict[str, np.ndarray],
                  model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map every flax weight onto `model`'s state_dict.

    Raises if a flax weight has no place in the model, if a shape differs,
    or if a parameter or running statistic of the model gets no weight —
    so a successful return means every key was used exactly once.
    """
    target = model.state_dict()
    out = {}
    for key, arr in flat.items():
        name = torch_name(key)
        if name not in target:
            raise KeyError(f"weight '{key}' → '{name}' is not in the model")
        if name in out:
            raise KeyError(f"two weights map to '{name}'")
        if arr.ndim == 4:  # conv HWIO → OIHW
            arr = np.transpose(arr, (3, 2, 0, 1))
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        if tuple(t.shape) != tuple(target[name].shape):
            raise ValueError(f"shape of '{key}' {tuple(t.shape)} != "
                             f"'{name}' {tuple(target[name].shape)}")
        out[name] = t
    missing = [k for k in target
               if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{len(missing)} model weights got no value, "
                       f"e.g. {missing[:3]}")
    for k in target:
        if k.endswith("num_batches_tracked"):
            out[k] = target[k]
    return out


def load_flax_weights(model: nn.Module, flat: Dict[str, np.ndarray]) -> int:
    """Load flat flax weights into `model` in place; returns the number used."""
    sd = to_state_dict(flat, model)
    model.load_state_dict(sd, strict=True)
    return len(flat)
