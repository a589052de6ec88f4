"""Shipped weights: where they are (resolve, the unified registry of
utils/shipping.py in the JAX package), the .npz reader and writer.

A float leaf is stored as a uint16 view of its bfloat16 bits under the key
"BF16::<flax path>"; every other entry is stored as it is. The JAX package's
load_params_npz reads what save_params_npz writes.
"""
from __future__ import annotations

import contextlib
import os
import zipfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
WEIGHTS_DIR = REPO_ROOT / "unet_watermark_tpu" / "weights"


def seg_weights_filename(model_name: str, encoder_name: str) -> str:
    """seg_<arch>_<encoder>.npz, as the JAX package's seg_weights_filename
    names it: the arch through factory.canonical_model_name, lower case
    (the alias "unet++" gives UnetPlusPlus's name), an unknown one with
    "+" as "p"."""
    from ..models.factory import canonical_model_name

    try:
        name = canonical_model_name(model_name).lower()
    except ValueError:
        name = model_name.lower().replace("+", "p")
    return f"seg_{name}_{encoder_name.lower()}.npz"


def seg_weights_path(model_name: str, encoder_name: str) -> Path:
    """The shipped segmentation weights of one arch/encoder pair."""
    return WEIGHTS_DIR / seg_weights_filename(model_name, encoder_name)


# kind → (env var, cfg attr under PREDICT, shipped file of a config,
#         legacy fallback paths: "weights:" under WEIGHTS_DIR, "repo:" under
#         the repository root)
_KINDS = {
    "seg": ("PREDICT_SEG_WEIGHTS", "SEG_WEIGHTS",
            lambda cfg: seg_weights_path(cfg.MODEL.NAME,
                                         cfg.MODEL.ENCODER_NAME), ()),
    "inpaint": ("PREDICT_INPAINT_WEIGHTS", "INPAINT_WEIGHTS",
                lambda cfg: WEIGHTS_DIR / "lama_ffc.npz",
                ("weights:lama_ffc", "repo:models/lama_ffc")),
    "diffusion": ("DIFFUSION_WEIGHTS", "DIFFUSION_WEIGHTS",
                  lambda cfg: WEIGHTS_DIR / "latent_diffusion.npz",
                  ("repo:models/latent_diffusion",)),
}


def resolve(kind: str, cfg=None, explicit: Optional[str] = None
            ) -> Optional[str]:
    """The weights path for `kind` in {seg, inpaint, diffusion}.

    Precedence: explicit arg > cfg.PREDICT.<attr> > env var > shipped file
    under unet_watermark_tpu/weights/ > legacy locations. Explicit, config
    and env values come back verbatim (caller errors surface); defaults
    come back only if they exist on disk. None when nothing is found."""
    if kind not in _KINDS:
        raise ValueError(f"unknown weights kind '{kind}' "
                         f"(know {sorted(_KINDS)})")
    env_var, cfg_attr, shipped, legacy = _KINDS[kind]
    cfg_val = getattr(getattr(cfg, "PREDICT", None), cfg_attr, None)
    for cand in (explicit, cfg_val, os.environ.get(env_var)):
        if cand:
            return cand
    cands = [shipped(cfg)] if cfg is not None or kind != "seg" else []
    for spec in legacy:
        base, _, rel = spec.partition(":")
        cands.append((WEIGHTS_DIR if base == "weights" else REPO_ROOT) / rel)
    for path in cands:
        if path.exists():
            return str(path)
    return None


def decode_bf16(u16: np.ndarray) -> np.ndarray:
    """bfloat16 bits (as uint16) → the float32 values they denote, exactly."""
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _decode_npz(path) -> Dict[str, np.ndarray]:
    out = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            if k.startswith("BF16::"):
                out[k[len("BF16::"):]] = decode_bf16(v)
            else:
                out[k] = v
    return out


_KEPT: Optional[Dict[tuple, Dict[str, np.ndarray]]] = None


@contextlib.contextmanager
def keep_loads():
    """Within this context load_npz keeps each file's decoded arrays,
    keyed by its path and its members' names and CRC-32s (the zip's
    directory), and returns copies of them; they are dropped on leaving
    the outermost context. For callers that load the same weights many
    times, as the quality report does."""
    global _KEPT
    outer = _KEPT is not None
    if not outer:
        _KEPT = {}
    try:
        yield
    finally:
        if not outer:
            _KEPT = None


def load_npz(path) -> Dict[str, np.ndarray]:
    """{flax path: array}; BF16 entries decoded to float32 (kept for the
    next call inside keep_loads)."""
    if _KEPT is None:
        return _decode_npz(path)
    with zipfile.ZipFile(path) as zf:
        key = (os.path.realpath(path), tuple(
            (i.filename, i.CRC, i.file_size) for i in zf.infolist()))
    if key not in _KEPT:
        _KEPT[key] = _decode_npz(path)
    return {k: v.copy() for k, v in _KEPT[key].items()}


def encode_bf16(x: np.ndarray) -> np.ndarray:
    """float values → the uint16 bits of their bfloat16 roundings (to
    nearest, ties to even, as jnp's astype)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def save_params_npz(path, flat: Dict[str, np.ndarray]) -> str:
    """{flax path: array} → one .npz in the shipped format: float arrays
    as "BF16::<path>" uint16 views, others as they are. The members are
    stored, not deflated (np.load reads either): trained weights' bf16
    bits deflate by ~20 % at ~15 MB/s, 4 s for the 39 M-parameter LaMa
    generator, which a trainer writes at every snapshot."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for k, v in flat.items():
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                k, v = "BF16::" + k, encode_bf16(v)
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, v, allow_pickle=False)
    return str(path)
