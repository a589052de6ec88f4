""".pth checkpoints in and out (models/torch_import.py in the JAX package).

The reference saves a torch dict with model_state_dict, epoch, history
and the config, and loads either that dict or a bare state_dict. The
port's convolution weights are already OIHW, so no layout changes, and its
module names are the file's names (those JAX's _torch_name gives) but in
one place: the canonical UNet++ grid's cells, decoder.x_{i}_{j}_convJ.0
and .1 here, which JAX's exporter writes as decoder.x_{i}_{j}_convJ.conv
and .bn (pth_name):

  export_pth           the reference's payload from a port state_dict:
                       model_state_dict (float32, no num_batches_tracked),
                       epoch, best_val_loss, history, config and JAX's
                       framework tag, so that a file written by either
                       package reads the same in both
  load_pth             name → array of a file holding model_state_dict,
                       state_dict or a bare state_dict, the "module."
                       prefix removed (read_pth: the same and the file's
                       epoch and validation loss, in one read)
  detect_decoder_impl  "smp" where a UNet++ state_dict has smp's
                       decoder.blocks.x_{d}_{l} names, else "canonical"
  import_pth           a file into a built model by name and shape, with
                       JAX's report: loaded (file names), missing (the
                       model's tensors the file does not give, named by
                       their flax path as JAX names them) and unused (the
                       file's names no tensor took, num_batches_tracked
                       left out)

A tensor the file does not give keeps the model's value, as in JAX; the
port's initial values are not flax's (factory.init_model draws from the
same distributions with a torch.Generator), so where a file leaves tensors
out the two packages' models differ there.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.quant import QConv2d
from .convert import flax_name, torch_name

logger = logging.getLogger(__name__)

FRAMEWORK = "unet_watermark_tpu"


def flax_to_state_dict(flat: Dict[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """Flat flax weights (params/..., batch_stats/...; HWIO kernels), as a
    training checkpoint's tree holds them, → state_dict names and OIHW
    float32 tensors."""
    out = {}
    for key, arr in flat.items():
        if not key.startswith(("params/", "batch_stats/")):
            continue
        a = np.asarray(arr, np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        out[torch_name(key)] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def export_pth(path: str, cfg, state_dict, epoch: int = 0,
               best_val_loss: float = float("inf"),
               history: Optional[dict] = None) -> str:
    """Write the reference's .pth dict. `state_dict` is a model or its
    state_dict (name → tensor)."""
    if isinstance(state_dict, nn.Module):
        state_dict = state_dict.state_dict()
    sd = {pth_name(k): v.detach().float().cpu().clone()
          for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    payload = {
        "model_state_dict": sd,
        "epoch": epoch,
        "best_val_loss": best_val_loss,
        "history": history or {},
        "config": cfg.to_dict() if hasattr(cfg, "to_dict")
        else dict(cfg or {}),
        "framework": FRAMEWORK,
    }
    torch.save(payload, path)
    return path


def read_pth(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """One read of a .pth: (load_pth's dict, the file's epoch and
    validation loss as the JAX predictor reports them, "Unknown" where the
    file has none; {} for a bare state_dict)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        sd = obj["model_state_dict"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        sd = obj
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")  # nn.DataParallel's prefix
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else \
            np.asarray(v)
    meta = {}
    if isinstance(obj, dict):
        meta = {"epoch": obj.get("epoch", "Unknown"),
                "val_loss": obj.get("val_loss",
                                    obj.get("best_val_loss", "Unknown"))}
    return out, meta


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A .pth as name → ndarray: its model_state_dict, its state_dict, or
    the file itself when it is a bare state_dict."""
    return read_pth(path)[0]


def detect_decoder_impl(state_dict: Dict[str, np.ndarray]) -> str:
    """"smp" for smp.UnetPlusPlus's decoder.blocks.x_{d}_{l} names, else
    "canonical"."""
    for k in state_dict:
        if re.match(r"decoder\.blocks\.x_\d+_\d+\.", k):
            return "smp"
    return "canonical"


# a cell of the canonical UNet++ grid: decoder.x_{i}_{j}_convJ.0 / .1 here
_CELL = re.compile(r"(decoder\.x_\d+_\d+_conv\d+)\.([01])\.")


def pth_name(name: str) -> str:
    """A port state_dict name → its name in a .pth: the canonical UNet++
    cells' .0 / .1 become .conv / .bn, as JAX's exporter writes them;
    every other name is the same."""
    return _CELL.sub(lambda m: f"{m.group(1)}."
                     f"{'conv' if m.group(2) == '0' else 'bn'}.", name)


def _jax_path(name: str) -> str:
    """A state_dict name as JAX's report names a model tensor: its flax
    path without the collection, joined by dots."""
    return flax_name(name).split("/", 1)[1].replace("/", ".")


def import_pth(path: str, model: nn.Module
               ) -> Tuple[nn.Module, Dict[str, List[str]]]:
    """Copy the file's tensors into `model` (in place) by name and shape;
    returns (model, report)."""
    return import_state_dict(load_pth(path), model)


@torch.no_grad()
def import_state_dict(sd: Dict[str, np.ndarray], model: nn.Module
                      ) -> Tuple[nn.Module, Dict[str, List[str]]]:
    """import_pth on load_pth's dict."""
    report: Dict[str, List[str]] = {"loaded": [], "missing": [],
                                    "unused": []}
    used = set()
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        key = pth_name(name)
        arr = sd.get(key)
        if arr is not None and tuple(arr.shape) == tuple(t.shape):
            t.copy_(torch.from_numpy(np.asarray(arr)).to(t.dtype))
            used.add(key)
            report["loaded"].append(key)
        else:
            report["missing"].append(_jax_path(name))
    report["unused"] = sorted(
        k for k in sd if k not in used and "num_batches_tracked" not in k)
    for mname, mod in model.named_modules():
        if isinstance(mod, QConv2d):  # the int8 tier's sidecar key
            mod.quant_path = flax_name(f"{mname}.weight")[
                len("params/"):-len("/kernel")]
    logger.info(".pth import: %d loaded, %d missing, %d unused",
                len(report["loaded"]), len(report["missing"]),
                len(report["unused"]))
    return model, report
