"""The frozen quality protocol's segmentation evaluation
(scripts/quality_report.py of the JAX package): _load_triads and
eval_segmentation, which the `auto` loop's held-out step runs.

eval_segmentation scores one checkpoint (a shipped-format .npz or a port
checkpoint directory, through WatermarkPredictor) on a folder of triads
(watermarked/ clean/ masks/): the raw network mask at PREDICT.THRESHOLD,
the parity pipeline and the tight pipeline, each as IoU, F1, precision and
recall over all pixels. JAX runs its two pipelines as host cv2 mirrors of
the device chains; the port runs the chains they mirror, on `device`:
`pipeline` is inference/maskproc.optimize_watermark_mask_batch (K1, the
largest-component rule, K2: the hand-written kernels on the card) and
`pipeline_tight` is optimize_watermark_mask_tight. quant=True runs the
int8 tier with the weights' calibrated .quant.json sidecar (ops/quant.py).

The frozen set itself (ensure_frozen_set, which needs data/synth_clean),
the inpaint and end-to-end evaluations and the report are not ported yet
(ROADMAP.md §A.7).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..configs import get_cfg_defaults
from ..inference import maskproc
from ..ops import quant as quant_ops
from ..ops.resize import resize_linear_u8, resize_nearest
from ..utils import image_io
from ..utils.device import resolve_device
from ..utils.shipping import resolve

IMG_SIZE = 512


def _load_triads(root: str, limit: int, img_size: int = IMG_SIZE,
                 device="cuda") -> Iterator[Tuple[str, torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]]:
    """(name, watermarked RGB, clean RGB, mask) uint8 tensors on `device`,
    the first `limit` names in sorted order; an image whose height is not
    img_size is resized to img_size² (the mask by nearest), as JAX does."""
    device = resolve_device(device)
    wm_dir = os.path.join(root, "watermarked")
    cl_dir = os.path.join(root, "clean")
    mk_dir = os.path.join(root, "masks")
    for name in sorted(os.listdir(wm_dir))[:limit]:
        stem = os.path.splitext(name)[0]
        wm = image_io.read_rgb_tensor(os.path.join(wm_dir, name), device)
        cl = image_io.read_rgb_tensor(os.path.join(cl_dir, name), device)
        mk = torch.from_numpy(image_io.read_gray(
            os.path.join(mk_dir, stem + ".png"))).to(device)
        if wm.shape[0] != img_size:
            wm = resize_linear_u8(wm, (img_size, img_size))
            cl = resize_linear_u8(cl, (img_size, img_size))
            mk = resize_nearest(mk, (img_size, img_size))
        yield name, wm, cl, mk


def _stats(t: float, f_p: float, f_n: float) -> Dict[str, float]:
    iou = t / max(t + f_p + f_n, 1e-7)
    prec = t / max(t + f_p, 1e-7)
    rec = t / max(t + f_n, 1e-7)
    f1 = 2 * prec * rec / max(prec + rec, 1e-7)
    return {"iou": round(iou, 4), "f1": round(f1, 4),
            "precision": round(prec, 4), "recall": round(rec, 4)}


def eval_segmentation(root: str, limit: int, batch: int = 8,
                      weights: Optional[str] = None,
                      model_name: Optional[str] = None,
                      encoder: Optional[str] = None,
                      img_size: int = IMG_SIZE,
                      quant: bool = False, device="cuda") -> Dict:
    """Raw-network and pipeline mask quality of one segmentation
    checkpoint, with JAX's keys."""
    from ..inference.predict import WatermarkPredictor

    device = resolve_device(device)
    cfg = get_cfg_defaults()
    cfg.DATA.IMG_SIZE = img_size
    if model_name:
        cfg.MODEL.NAME = model_name
    if encoder:
        cfg.MODEL.ENCODER_NAME = encoder
    path = resolve("seg", cfg=cfg, explicit=weights)
    if not path or not os.path.exists(path):
        return {"error": f"no weights resolve for {cfg.MODEL.NAME}/"
                         f"{cfg.MODEL.ENCODER_NAME}"}
    if quant:
        sidecar = quant_ops.quant_sidecar_path(path)
        if not os.path.exists(sidecar):
            return {"error": f"no calibration sidecar at {sidecar}"}
        cfg.PREDICT.QUANT = True
    pred = WatermarkPredictor(cfg, weights_path=path, device=device)

    counts = {k: torch.zeros(3, dtype=torch.float64, device=device)
              for k in ("raw", "pipeline", "pipeline_tight")}
    buf_img, buf_msk = [], []

    def flush():
        if not buf_img:
            return
        x = torch.stack(buf_img).to(torch.float32) / 255.0
        raw = pred.predict_masks(x)
        gt = torch.stack(buf_msk) > 127
        outs = {"raw": raw,
                "pipeline": maskproc.optimize_watermark_mask_batch(raw),
                "pipeline_tight": maskproc.optimize_watermark_mask_tight(
                    raw)}
        for key, out in outs.items():
            p = out > 0.5
            counts[key] += torch.stack([
                (p & gt).sum(), (p & ~gt).sum(),
                (~p & gt).sum()]).to(torch.float64)
        buf_img.clear()
        buf_msk.clear()

    n = 0
    for _, wm, _, mk in _load_triads(root, limit, img_size, device):
        buf_img.append(wm)
        buf_msk.append(mk)
        n += 1
        if len(buf_img) == batch:
            flush()
    flush()
    c = {k: [float(v) for v in t.tolist()] for k, t in counts.items()}
    return {"weights": path, "model": cfg.MODEL.NAME,
            "encoder": cfg.MODEL.ENCODER_NAME, "n_images": n,
            "quant": bool(pred._quant_scales),
            "raw": _stats(*c["raw"]), "pipeline": _stats(*c["pipeline"]),
            "pipeline_tight": _stats(*c["pipeline_tight"])}
