"""Segmentation losses (ops/losses.py in the JAX package) as torch
functions over fp32 logits (N, H, W, 1) and binary targets; autograd gives
their gradients.

Each loss is the JAX function's formula in the same order of operations.
lovasz_hinge_loss sorts each image's errors with a stable descending sort,
as jnp.argsort(-errors) is stable, so tied errors get the same per-logit
gradients as in JAX.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _flatten(logits: torch.Tensor, targets: torch.Tensor):
    return (logits.reshape(logits.shape[0], -1).float(),
            targets.reshape(targets.shape[0], -1).float())


def _softplus_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x t + log1p(exp(-|x|)): BCE with logits, per element."""
    return (F.relu(logits) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def dice_loss(logits, targets, smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice over probabilities (smp DiceLoss, mode='binary')."""
    logits, targets = _flatten(logits, targets)
    probs = torch.sigmoid(logits)
    inter = torch.sum(probs * targets, dim=1)
    denom = torch.sum(probs, dim=1) + torch.sum(targets, dim=1)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return torch.mean(1.0 - dice)


def jaccard_loss(logits, targets, smooth: float = 1e-5) -> torch.Tensor:
    """Soft IoU loss (smp JaccardLoss)."""
    logits, targets = _flatten(logits, targets)
    probs = torch.sigmoid(logits)
    inter = torch.sum(probs * targets, dim=1)
    union = torch.sum(probs, dim=1) + torch.sum(targets, dim=1) - inter
    iou = (inter + smooth) / (union + smooth)
    return torch.mean(1.0 - iou)


def bce_loss(logits, targets) -> torch.Tensor:
    """Sigmoid BCE with logits (smp SoftBCEWithLogitsLoss, no smoothing)."""
    logits, targets = _flatten(logits, targets)
    return torch.mean(_softplus_ce(logits, targets))


def focal_loss(logits, targets, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Binary focal loss (smp FocalLoss, mode='binary')."""
    logits, targets = _flatten(logits, targets)
    p = torch.sigmoid(logits)
    ce = _softplus_ce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return torch.mean(alpha_t * (1.0 - p_t) ** gamma * ce)


def tversky_loss(logits, targets, alpha: float = 0.5, beta: float = 0.5,
                 smooth: float = 1e-5) -> torch.Tensor:
    """Tversky loss (smp TverskyLoss): Dice with FP/FN weights."""
    logits, targets = _flatten(logits, targets)
    probs = torch.sigmoid(logits)
    tp = torch.sum(probs * targets, dim=1)
    fp = torch.sum(probs * (1.0 - targets), dim=1)
    fn = torch.sum((1.0 - probs) * targets, dim=1)
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return torch.mean(1.0 - tv)


def lovasz_hinge_loss(logits, targets) -> torch.Tensor:
    """Lovasz hinge (Berman et al. 2018), per image, then the mean."""
    logits, targets = _flatten(logits, targets)
    signs = 2.0 * targets - 1.0
    errors = 1.0 - logits * signs
    # descending and stable, as jnp.argsort(-errors)
    order = torch.sort(-errors, dim=1, stable=True).indices
    errors_sorted = torch.gather(errors, 1, order)
    lab_sorted = torch.gather(targets, 1, order)
    gts = torch.sum(lab_sorted, dim=1, keepdim=True)
    intersection = gts - torch.cumsum(lab_sorted, dim=1)
    union = gts + torch.cumsum(1.0 - lab_sorted, dim=1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-8)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], 1)
    return torch.mean(torch.sum(F.relu(errors_sorted) * grad, dim=1))


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


@functools.lru_cache(maxsize=None)
def _sobel(device: torch.device) -> torch.Tensor:
    """The x and y Sobel kernels (2, 1, 3, 3) on `device`, uploaded once
    (an upload is a blocking copy)."""
    kx = np.asarray(_SOBEL_X, np.float32)
    return torch.as_tensor(np.stack([kx, kx.T])[:, None], device=device)


def edge_loss(logits, targets) -> torch.Tensor:
    """L1 between the Sobel gradients (zero border) of the prediction and
    of the target."""
    k = _sobel(logits.device)

    def sobel(x):  # (N, H, W, 1) → (N, 2, H, W)
        return F.conv2d(x.permute(0, 3, 1, 2), k, padding=1)

    probs = torch.sigmoid(logits.float())
    return torch.mean(torch.abs(sobel(probs) - sobel(targets.float())))


class CombinedLoss:
    """Weighted Dice + BCE + Focal (+ edge)."""

    def __init__(self, bce_weight: float = 0.5, dice_weight: float = 0.5,
                 focal_weight: float = 0.0, edge_weight: float = 0.0,
                 smooth: float = 1e-5, focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0):
        self.bce_weight = bce_weight
        self.dice_weight = dice_weight
        self.focal_weight = focal_weight
        self.edge_weight = edge_weight
        self.smooth = smooth
        self.focal_alpha = focal_alpha
        self.focal_gamma = focal_gamma

    def __call__(self, logits, targets) -> torch.Tensor:
        loss = self.bce_weight * bce_loss(logits, targets)
        loss = loss + self.dice_weight * dice_loss(logits, targets,
                                                   self.smooth)
        if self.focal_weight:
            loss = loss + self.focal_weight * focal_loss(
                logits, targets, self.focal_alpha, self.focal_gamma)
        if self.edge_weight:
            loss = loss + self.edge_weight * edge_loss(logits, targets)
        return loss


def get_loss_function(cfg) -> Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]:
    """The loss of cfg.LOSS.NAME, as the JAX package's get_loss_function."""
    name = cfg.LOSS.NAME
    smooth = cfg.LOSS.SMOOTH
    if name == "DiceLoss":
        return lambda lg, tg: dice_loss(lg, tg, smooth)
    if name == "JaccardLoss":
        return lambda lg, tg: jaccard_loss(lg, tg, smooth)
    if name in ("BCELoss", "SoftBCEWithLogitsLoss", "BCEWithLogitsLoss"):
        return bce_loss
    if name == "FocalLoss":
        return lambda lg, tg: focal_loss(lg, tg, cfg.LOSS.FOCAL_ALPHA,
                                         cfg.LOSS.FOCAL_GAMMA)
    if name == "TverskyLoss":
        return lambda lg, tg: tversky_loss(lg, tg, smooth=smooth)
    if name == "LovaszLoss":
        return lovasz_hinge_loss
    if name == "CombinedLoss":
        return CombinedLoss(
            bce_weight=cfg.LOSS.BCE_WEIGHT,
            dice_weight=cfg.LOSS.DICE_WEIGHT,
            focal_weight=cfg.LOSS.FOCAL_WEIGHT,
            edge_weight=cfg.LOSS.EDGE_LOSS_WEIGHT,
            smooth=smooth,
            focal_alpha=cfg.LOSS.FOCAL_ALPHA,
            focal_gamma=cfg.LOSS.FOCAL_GAMMA,
        )
    raise ValueError(f"unsupported loss '{name}'")
