"""Segmentation metrics (ops/metrics.py in the JAX package) as torch
reductions in float32 on the logits' device: the confusion counts of a
batch stay there, and an epoch sums them there, so the history reads one
host sync an epoch."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import morphology


def confusion_stats(logits: torch.Tensor, targets: torch.Tensor,
                    threshold: float = 0.5,
                    valid: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """tp/fp/fn/tn over the whole batch (micro). `valid` is an optional
    (N,) 0/1 weight so a padded last batch does not count its pad."""
    probs = torch.sigmoid(logits.float())
    pred = (probs > threshold).float()
    t = (targets > 0.5).float()
    if valid is not None:
        w = valid.reshape((-1,) + (1,) * (pred.ndim - 1)).float()
        pred = pred * w
        t = t * w
        real = w * torch.ones_like(pred)
    else:
        real = torch.ones_like(pred)
    return {"tp": torch.sum(pred * t), "fp": torch.sum(pred * (real - t)),
            "fn": torch.sum((real - pred) * t),
            "tn": torch.sum((real - pred) * (real - t))}


def metrics_from_stats(stats: Dict[str, torch.Tensor], eps: float = 1e-7
                       ) -> Dict[str, torch.Tensor]:
    tp, fp, fn, tn = stats["tp"], stats["fp"], stats["fn"], stats["tn"]
    iou = tp / (tp + fp + fn + eps)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * tp / (2 * tp + fp + fn + eps)
    accuracy = (tp + tn) / (tp + fp + fn + tn + eps)
    return {"iou": iou, "f1": f1, "accuracy": accuracy,
            "precision": precision, "recall": recall, "dice": f1}


def compute_metrics(logits, targets, threshold: float = 0.5):
    return metrics_from_stats(confusion_stats(logits, targets, threshold))


def dice_coef(pred, target, smooth: float = 1e-5) -> torch.Tensor:
    """Soft dice on probabilities."""
    pred, target = pred.reshape(-1).float(), target.reshape(-1).float()
    inter = torch.sum(pred * target)
    return (2.0 * inter + smooth) / (torch.sum(pred) + torch.sum(target)
                                     + smooth)


def iou_score(pred, target, smooth: float = 1e-5) -> torch.Tensor:
    """Soft IoU on probabilities."""
    pred, target = pred.reshape(-1).float(), target.reshape(-1).float()
    inter = torch.sum(pred * target)
    union = torch.sum(pred) + torch.sum(target) - inter
    return (inter + smooth) / (union + smooth)


def psnr(pred, target, max_val: float = 1.0, mask=None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB; with `mask` (1 = evaluate) over
    the masked region only."""
    pred, target = pred.float(), target.float()
    if mask is not None:
        w = torch.broadcast_to(mask.float(), pred.shape)
        mse = torch.sum(((pred - target) ** 2) * w) / torch.clamp(
            torch.sum(w), min=1.0)
    else:
        mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def ssim(pred, target, max_val: float = 1.0, ksize: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity with an 11 x 1.5 Gaussian window
    (reflect-101 border, as the JAX package's gaussian_blur); NHWC or
    HWC in [0, max_val]."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    pred, target = pred.float(), target.float()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def blur(x):  # per channel over (H, W)
        y = morphology.gaussian_blur(x.permute(0, 3, 1, 2), (ksize, ksize),
                                     sigma)
        return y.permute(0, 2, 3, 1)

    mu_p, mu_t = blur(pred), blur(target)
    var_p = blur(pred * pred) - mu_p * mu_p
    var_t = blur(target * target) - mu_t * mu_t
    cov = blur(pred * target) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def get_metrics():
    return {"stats": confusion_stats, "from_stats": metrics_from_stats,
            "compute": compute_metrics, "dice": dice_coef, "iou": iou_score}
