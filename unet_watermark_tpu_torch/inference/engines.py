"""Inpainting engine registry (inference/engines.py in the JAX package).

Every engine has one interface:

    engine(images (N,H,W,3) f32 [0,1], masks (N,H,W,1) {0,1}) -> images

  * "pushpull" / "fast" / "telea" — ops/inpaint.py's multiscale fill (no
    weights needed; the fallback)
  * "lama" / "big-lama" / "mat" — models/lama.py's FFC generator with
    the shipped (or given) trained weights: a shipped-format .npz or the
    checkpoint directory training/train_inpaint.py writes; or, for a torch
    checkpoint (.pt, .pth, .ckpt), the public big-lama generator
    (models/lama_import.py, float32, named "big-lama-torch"); push-pull
    with a warning when no weights resolve or the file does not import
  * "diffusion" / "latent-diffusion" / "ld" — the latent-diffusion
    inpainter (diffusion/latent_diffusion.py) with the shipped (or
    DIFFUSION_WEIGHTS, or given) weights, 20 DDIM steps; push-pull with a
    warning when no weights resolve
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Tuple

import torch

from ..models.convert import load_lama_weights
from ..models.lama import LamaGenerator, create_lama
from ..models.lama_import import load_big_lama
from ..ops.inpaint import inpaint_pushpull
from ..utils.device import resolve_device
from ..training.checkpoint import read_weights
from ..utils.shipping import resolve

logger = logging.getLogger(__name__)

Engine = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def load_lama(path, variant: str = "lama", device="cuda",
              dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[Optional[LamaGenerator], Optional[str]]:
    """Load a FFC-LaMa checkpoint (the bf16 .npz of utils/shipping, or a
    port checkpoint directory: training/checkpoint.read_weights) into
    whichever variant's parameters it matches: the requested depth first,
    then 'lama', then 'big-lama' (a checkpoint trained as one variant
    serves the other engine names too). Returns (model in eval mode on
    `device` in `dtype`, channels-last on the card, the variant's name),
    or (None, None) when no variant matches. A torch checkpoint (.pt,
    .pth, .ckpt) is the public big-lama generator instead, in float32
    whatever `dtype` says, as JAX runs it, under the name
    "big-lama-torch"; one that does not import logs a warning and gives
    (None, None), as in JAX. `device` is "cuda" unless the caller asks
    for the CPU; without a card "cuda" raises.

    This is the one LaMa loader, shared by get_engine and the fused repair
    fn, so the two cannot disagree about what loads."""
    device = resolve_device(device)
    path = str(path)
    if path.endswith((".pt", ".pth", ".ckpt")):
        try:
            model, _ = load_big_lama(path, device)
        except Exception as e:  # noqa: BLE001 — JAX's "no engine" result
            logger.warning("torch inpaint checkpoint %s failed to import "
                           "as big-lama: %s", path, e)
            return None, None
        logger.info("imported big-lama torch checkpoint %s", path)
        return model, "big-lama-torch"
    flat = read_weights(path)  # an orbax directory raises (§A.7)
    for cand in dict.fromkeys((variant, "lama", "big-lama")):
        with torch.device("meta"):  # shapes only: the weights replace them
            model = create_lama(cand, torch.float32)
        try:
            load_lama_weights(model, flat)
        except (KeyError, ValueError):  # another variant's parameter tree
            continue
        logger.info("loaded %s weights from %s (as '%s')", variant, path,
                    cand)
        model = model.eval().to(device, dtype)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model, cand
    logger.warning("checkpoint %s matches no lama variant", path)
    return None, None


def default_inpaint_weights() -> Optional[str]:
    """The shipped FFC-LaMa checkpoint (utils/shipping.resolve), or None."""
    return resolve("inpaint")


def resolve_inpaint_weights(explicit: Optional[str] = None,
                            cfg=None) -> Optional[str]:
    """Precedence: explicit arg > PREDICT.INPAINT_WEIGHTS config key >
    PREDICT_INPAINT_WEIGHTS env > shipped default."""
    return resolve("inpaint", cfg=cfg, explicit=explicit)


def _on(device: torch.device, fill, name: str) -> Engine:
    """`fill` as an engine: its inputs (arrays or tensors) go to `device`
    as float32 first. `engine.name` names the fill that runs."""
    @torch.inference_mode()
    def engine(images, masks):
        return fill(torch.as_tensor(images, dtype=torch.float32,
                                    device=device),
                    torch.as_tensor(masks, dtype=torch.float32,
                                    device=device))
    engine.name = name
    return engine


def _pushpull(device: torch.device) -> Engine:
    return _on(device, lambda images, masks: inpaint_pushpull(
        images, masks, smooth_iterations=64), "pushpull")


def _make_lama_engine(variant: str, weights_path: Optional[str],
                      device: torch.device) -> Engine:
    model = None
    if weights_path and os.path.exists(weights_path):
        model, cand = load_lama(weights_path, variant, device)
    if model is None:
        logger.warning(
            "no trained weights for inpaint model '%s' — falling back to "
            "the pushpull engine (set PREDICT_INPAINT_WEIGHTS)", variant)
        return _pushpull(device)
    return _on(device, model, f"ffc-{cand}")


def _make_diffusion_engine(weights_path: Optional[str],
                           device: torch.device) -> Engine:
    """The latent-diffusion inpainter as an engine; push-pull with a
    warning when no trained weights resolve. As in the JAX package, the
    weights come from `weights_path`, DIFFUSION_WEIGHTS or the shipped
    file, not from the config."""
    from ..diffusion.latent_diffusion import LatentInpainter

    try:
        inpainter = LatentInpainter(weights_path, device=device)
    except FileNotFoundError:
        logger.warning(
            "no trained weights for the diffusion engine — falling back "
            "to pushpull (train with training/train_latent_diffusion.py)")
        return _pushpull(device)
    return _on(device, inpainter.inpaint, "latent-diffusion")


def get_engine(name: str = "pushpull", weights_path: Optional[str] = None,
               cfg=None, device: str = "cuda") -> Engine:
    """The engine `name` on `device` ("cuda" unless the caller asks for
    the CPU; without a card "cuda" raises)."""
    name = (name or "pushpull").lower()
    dev = resolve_device(device)
    if name in ("pushpull", "fast", "telea"):
        return _pushpull(dev)
    if name in ("lama", "big-lama", "mat"):
        return _make_lama_engine(name, resolve_inpaint_weights(
            weights_path, cfg), dev)
    if name in ("diffusion", "latent-diffusion", "ld"):
        return _make_diffusion_engine(weights_path, dev)
    raise ValueError(f"unknown inpaint engine '{name}'")
