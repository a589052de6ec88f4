"""Calibrate the int8 tier's activation scales for a shipped segmentation
model (scripts/calibrate_quant.py of the JAX package).

The int8 tier (ops/quant.py) needs one amax per conv input. calibrate
makes a small procedural calibration set (seeds CALIB_*_SEED, disjoint from
the frozen 7700/7701 held-out protocol: data/synth_clean.py's clean images,
half of them textured, and data/gen_data.py's composites), runs the model
in the config's dtype on `device` ("cuda" unless the caller asks for the
CPU) under ops/quant.quant_observe, and writes the scales with the weights'
sha256 as a JSON sidecar to `out`:

    python -m unet_watermark_tpu_torch.scripts.calibrate_quant \\
        --model Unet --encoder resnet34 --out /path/seg_unet.quant.json \\
        [--images 16] [--batch 4] [--img-size 512] [--device cpu]

The one departure from JAX: the port writes only to the path the caller
gives. Without `out`, calibrate and main raise ValueError and write
nothing, where JAX writes the sidecar beside the weights
(quant_sidecar_path, <weights stem>.quant.json): the shipped sidecars there
are the JAX package's files.
"""
from __future__ import annotations

import argparse
import hashlib
import logging
import os
from typing import Iterator, Optional

import torch

from ..configs import get_cfg_defaults
from ..ops import quant
from ..ops.augment import IMAGENET_MEAN, IMAGENET_STD
from ..ops.quant import quant_sidecar_path  # noqa: F401 - JAX's name here
from ..ops.resize import resize_linear_u8
from ..utils import image_io
from ..utils.device import resolve_device
from ..utils.shipping import resolve

logger = logging.getLogger(__name__)

CALIB_CLEAN_SEED = 4242
CALIB_COMPOSE_SEED = 4243


def calibration_batches(workdir: str, n_images: int, img_size: int,
                        batch: int, device="cuda"
                        ) -> Iterator[torch.Tensor]:
    """Normalized float32 NHWC batches on `device` from the procedural
    calibration set under workdir (clean + composited watermarks, the
    training distribution), made on first use."""
    from ..data.gen_data import generate_dataset
    from ..data.synth_clean import generate_clean_dataset, generate_logo_set

    device = resolve_device(device)
    clean_src = os.path.join(workdir, "calib_clean_v2")
    logos = os.path.join(workdir, "calib_logos")
    root = os.path.join(workdir, "calib_set_v2")
    wm_dir = os.path.join(root, "watermarked")
    if not (os.path.isdir(wm_dir) and len(os.listdir(wm_dir)) >= n_images):
        generate_clean_dataset(clean_src, count=max(8, n_images // 2),
                               size=img_size, seed=CALIB_CLEAN_SEED,
                               texture_ratio=0.5, device=device)
        generate_logo_set(logos, count=8, seed=CALIB_CLEAN_SEED + 1)
        generate_dataset(clean_src, root, logos_dir=logos, count=n_images,
                         seed=CALIB_COMPOSE_SEED, device=device)
    names = sorted(os.listdir(wm_dir))[:n_images]
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    for i in range(0, len(names), batch):
        imgs = []
        for name in names[i:i + batch]:
            rgb = image_io.read_rgb_tensor(os.path.join(wm_dir, name),
                                           device)
            if rgb.shape[0] != img_size:
                rgb = resize_linear_u8(rgb, (img_size, img_size))
            imgs.append(rgb.float() / 255.0)
        yield (torch.stack(imgs) - mean) / std


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def calibrate(model_name: str = "Unet", encoder: str = "resnet34",
              weights: Optional[str] = None, img_size: int = 512,
              n_images: int = 16, batch: int = 4,
              workdir: str = "workspace/calib",
              out: Optional[str] = None, device="cuda") -> str:
    """The observe pass over the calibration set; writes the sidecar to
    `out` (required: None raises ValueError before any work) and returns
    its path."""
    from ..inference.predict import WatermarkPredictor

    if out is None:
        raise ValueError(
            "calibrate writes only to the path given as out; it does not "
            "write the shipped <weights>.quant.json beside the JAX "
            "package's weights")
    cfg = get_cfg_defaults()
    cfg.DATA.IMG_SIZE = img_size
    cfg.MODEL.NAME = model_name
    cfg.MODEL.ENCODER_NAME = encoder
    path = resolve("seg", cfg=cfg, explicit=weights)
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"no segmentation weights resolve for {model_name}/{encoder}; "
            f"train or pass --weights")
    pred = WatermarkPredictor(cfg, weights_path=path, device=device)
    store: dict = {}
    with torch.inference_mode(), quant.quant_observe(store):
        for xb in calibration_batches(workdir, n_images, img_size, batch,
                                      pred.device):
            pred.model(xb)
    if not store:
        raise RuntimeError("observe pass recorded no conv paths")
    quant.save_scales(out, store, meta={"weights_sha256": file_sha256(path)})
    logger.info("wrote %d scales to %s", len(store), out)
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="Unet")
    ap.add_argument("--encoder", default="resnet34")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--workdir", default="workspace/calib")
    ap.add_argument("--out", default=None,
                    help="the sidecar to write (required)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the observe pass")
    args = ap.parse_args(argv)
    sidecar = calibrate(args.model, args.encoder, weights=args.weights,
                        img_size=args.img_size, n_images=args.images,
                        batch=args.batch, workdir=args.workdir,
                        out=args.out, device=args.device)
    print(sidecar)


if __name__ == "__main__":
    main()
