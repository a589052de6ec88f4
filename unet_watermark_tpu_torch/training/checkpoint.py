"""Checkpoints (training/checkpoint.py in the JAX package): a directory
per checkpoint with

  tree.npz   params/<flax path>, batch_stats/<flax path>, step, and the
             optimizer state: opt_state/count, opt_state/{mu,nu}/<path>
             (Adam) or opt_state/trace/<path> (SGD); float32, conv
             kernels HWIO as in the flax tree
  meta.json  epoch, best_val_loss, history, scheduler, early_stopping,
             config: the JAX package's keys

A best-model save is slim (no optimizer state), as in the JAX package;
restoring one, or a checkpoint of another optimizer, keeps the parameters
and statistics with a fresh optimizer state. The JAX package writes orbax
directories (a tree/ folder), which the port cannot read yet.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.convert import flax_name
from ..utils.shipping import load_npz

logger = logging.getLogger(__name__)

CKPT_RE = re.compile(r"^checkpoint_epoch_(\d+)$")


def _abspath(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def _np(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def _torch(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device,
                                                        like.dtype)


def snapshot(state, with_opt: bool = True) -> Dict[str, np.ndarray]:
    """The state as a flat dict of host arrays (a copy: the live state may
    go on training while a worker writes it)."""
    tree = {}
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            tree[flax_name(name)] = _np(t).copy()
    tree["step"] = _np(state.step).copy()
    if with_opt:
        tree["opt_state/count"] = _np(state.opt.count).copy()
        for kind, tensors in state.opt.state_tensors().items():
            for name, t in zip(names, tensors):
                key = flax_name(name)[len("params/"):]
                tree[f"opt_state/{kind}/{key}"] = _np(t).copy()
    return tree


def save_checkpoint(directory: str, name: str, state, meta: Dict[str, Any]
                    ) -> str:
    """Write tree.npz (from a TrainState or a snapshot) and meta.json under
    directory/name; returns the checkpoint's path."""
    path = _abspath(os.path.join(directory, name))
    os.makedirs(path, exist_ok=True)
    tree = state if isinstance(state, dict) else snapshot(state)
    tmp = os.path.join(path, "tree.tmp.npz")
    np.savez(tmp, **tree)
    os.replace(tmp, os.path.join(path, "tree.npz"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=_json_default)
    return path


def _require_port_checkpoint(path: str) -> str:
    """The tree.npz of the port's checkpoint directory `path`. A directory
    without one is taken for an orbax checkpoint of the JAX package (its
    training checkpoints hold a tree/ folder, train_inpaint's and
    train_latent_diffusion's the orbax files themselves) and raises."""
    tree = os.path.join(path, "tree.npz")
    if not os.path.exists(tree):
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path}: an orbax checkpoint of the JAX package; the port "
                f"reads its own tree.npz checkpoints and shipped .npz "
                f"weights only (ROADMAP.md §A.7)")
        raise FileNotFoundError(f"no checkpoint at {path}")
    return tree


def restore_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(tree, meta) of a checkpoint, without a model."""
    path = _abspath(path)
    with np.load(_require_port_checkpoint(path)) as data:
        tree = {k: data[k] for k in data.files}
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def read_weights(path: str) -> Dict[str, np.ndarray]:
    """Flat flax weights from a shipped-format .npz or from the tree.npz
    of a port checkpoint directory (its params/ and batch_stats/ entries
    where it has them, else every array but the step). An orbax directory
    raises naming ROADMAP.md §A.7."""
    if not os.path.isdir(path):
        return load_npz(path)
    tree, _ = restore_raw(path)
    weights = {k: v for k, v in tree.items()
               if k.startswith(("params/", "batch_stats/"))}
    return weights or {k: v for k, v in tree.items()
                       if k != "step" and not k.startswith("opt_state/")}


@torch.no_grad()
def restore_checkpoint(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint into `state` in place; returns (state, meta). The
    optimizer state comes back where the checkpoint has one for this
    optimizer, else it starts fresh (with a warning)."""
    tree, meta = restore_raw(path)
    model, opt = state.model, state.opt
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        key = flax_name(name)
        if key not in tree:
            raise KeyError(f"checkpoint {path} has no '{key}'")
        t.copy_(_torch(tree[key], t))
    state.step.fill_(int(tree.get("step", 0)))
    names = [n for n, _ in model.named_parameters()]
    kinds = opt.state_tensors()
    keys = {kind: [f"opt_state/{kind}/" + flax_name(n)[len("params/"):]
                   for n in names] for kind in kinds}
    if "opt_state/count" in tree and all(
            k in tree for ks in keys.values() for k in ks):
        opt.count.fill_(int(tree["opt_state/count"]))
        for kind, tensors in kinds.items():
            for key, t in zip(keys[kind], tensors):
                t.copy_(_torch(tree[key], t))
    else:
        logger.warning("%s holds no %s optimizer state; restoring params "
                       "and batch_stats with a fresh optimizer state", path,
                       opt.name)
        opt.count.zero_()
        for tensors in kinds.values():
            for t in tensors:
                t.zero_()
    return state, meta


def latest_checkpoint(directory: str) -> Optional[str]:
    directory = _abspath(directory)
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for d in os.listdir(directory):
        m = CKPT_RE.match(d)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(directory, d)
    return best


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
