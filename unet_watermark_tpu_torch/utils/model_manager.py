"""Checkpoint inventory and comparison (utils/model_manager.py in the JAX
package): list_checkpoints and compare_models over a directory's entries,
with JAX's columns (name, path, kind, epoch, val_loss, val_iou, val_f1,
size_mb) and table. Three kinds of entry:

  .pth             read with torch.load(map_location="cpu"), as in JAX
  orbax            a JAX checkpoint directory (meta.json beside its tree/),
                   described by its meta.json, as in JAX
  npz              the port's own checkpoint directory (tree.npz beside
                   meta.json, training/checkpoint.py), described by its
                   meta.json the same way; JAX lists such a directory as
                   "orbax", since it goes by meta.json alone
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


def _dir_size(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


def _describe_dir(path: str) -> Optional[Dict]:
    """A checkpoint directory by its meta.json: kind "npz" where it holds
    the port's tree.npz, else "orbax"."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    hist = meta.get("history", {})
    return {
        "name": os.path.basename(path),
        "path": path,
        "kind": ("npz" if os.path.exists(os.path.join(path, "tree.npz"))
                 else "orbax"),
        "epoch": meta.get("epoch"),
        "val_loss": (hist.get("val_loss") or [None])[-1],
        "val_iou": (hist.get("val_iou") or [None])[-1],
        "val_f1": (hist.get("val_f1") or [None])[-1],
        "size_mb": _dir_size(path) / 1e6,
    }


def _describe_pth(path: str) -> Optional[Dict]:
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:  # noqa: BLE001
        logger.warning("cannot read %s: %s", path, e)
        return None
    info = {
        "name": os.path.basename(path),
        "path": path,
        "kind": "pth",
        "epoch": None,
        "val_loss": None,
        "val_iou": None,
        "val_f1": None,
        "size_mb": os.path.getsize(path) / 1e6,
    }
    if isinstance(obj, dict):
        info["epoch"] = obj.get("epoch")
        info["val_loss"] = obj.get("val_loss", obj.get("best_val_loss"))
        metrics = obj.get("val_metrics", {}) or {}
        info["val_iou"] = metrics.get("iou")
        info["val_f1"] = metrics.get("f1")
    return info


def list_checkpoints(directory: str) -> List[Dict]:
    """One row a checkpoint of `directory`, in name order."""
    out: List[Dict] = []
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if name.endswith(".pth"):
            d = _describe_pth(p)
        elif os.path.isdir(p):
            d = _describe_dir(p)
        else:
            d = None
        if d:
            out.append(d)
    return out


def _fmt(v, nd=4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def compare_models(directory: str, print_table: bool = True) -> List[Dict]:
    """list_checkpoints, printed as JAX's table."""
    rows = list_checkpoints(directory)
    if print_table:
        header = (f"{'name':<32}{'kind':<7}{'epoch':<7}{'val_loss':<10}"
                  f"{'iou':<8}{'f1':<8}{'MB':<8}")
        print(header)
        print("-" * len(header))
        for r in rows:
            print(f"{r['name']:<32}{r['kind']:<7}{_fmt(r['epoch']):<7}"
                  f"{_fmt(r['val_loss']):<10}{_fmt(r['val_iou']):<8}"
                  f"{_fmt(r['val_f1']):<8}{r['size_mb']:<8.1f}")
    return rows
