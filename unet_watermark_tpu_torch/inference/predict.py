"""WatermarkPredictor (inference/predict.py in the JAX package): the
folder-level repair pipeline and its batched in-memory surfaces.

process_folder_batch(input, output) runs the JAX package's steps 1-5 with
the same folders, file names, skip rules and stats:

  step 1  decode each image (a PNG on the host, then shipped as uint8; a
          JPEG's entropy data on the host and its pixels on the device),
          resize there (cv2-parity, ops/resize.py), one forward a batch,
          type detection and one mask strategy per image (under MASK_MODE
          auto the watermark strategy is the parity chain on K1 → components
          → K2), the predict flags, masks back at each image's size →
          step1_masks/{stem}_mask.png. With PREDICT.TILED, an image larger
          than the model's input takes the sliding-window path at native
          resolution instead (plain mask ops, no kernel).
  step 2  the inpaint engine, `steps` times, on the images whose mask
          covers at least 0.1 %, batched by padded shape →
          step2_watermark_repaired/{stem}.png.
  step 3  (use_ocr) the OCR detector (ocr/; the builtin one runs its image
          ops on this predictor's device) on each step-2 image, its regions
          filled and dilated (5x5 ellipse, twice) →
          step3_text_masks/{stem}_text_mask.png; images without text pixels
          stop here.
  step 4  (use_ocr) the text engine on the step-2 images under their text
          masks → {stem}.png in the output; the other images' step-2 files
          are copied there (without OCR, all of them are).
  step 5  each step-1 mask, merged with its text mask (the per-pixel
          maximum), through the repair surface's chain at its padded
          original size → masks/{stem}.png.

predict_mask answers for the watermark, text and mixed types; the last two
first run _enhance_text_features (CLAHE, Canny, sharpen; ops/imgproc.py) on
the device. With PREDICT.QUANT every forward (step 1, predict_mask, the
tiled path, the fused fn) runs the int8 tier (ops/quant.py) through
_apply_model, with the sidecar next to the weights; without one it warns
and stays in the model dtype, as the JAX package does. The
port decodes PNG and JPEG (utils/image_io.py), each file by its content as
cv2 does (a JPEG copied to {stem}.png by the --no-unet route or a fallback
is read as the JPEG it is): a folder holding BMP, TIFF or WEBP files, an
interlaced PNG or a refused JPEG form raises NotImplementedError before any
work starts.

make_fused_repair_fn is the fused detect→repair path (:931-985), whose
fill is the learned FFC-LaMa generator by default; predict_artifact_masks
is step 1's device part on an in-memory batch.
"""
from __future__ import annotations

import contextlib
import glob
import logging
import os
import random
import shutil
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import Config, get_cfg_defaults
from ..models import create_model_from_config, torch_import
from ..models.convert import load_flax_weights
from ..models.factory import init_model, torch_dtype
from ..ocr import get_ocr_detector
from ..ocr.base import rasterize_regions
from ..ops import components as cc
from ..ops import imgproc
from ..ops import morphology as m
from ..ops import quant
from ..ops.inpaint import inpaint_pushpull
from ..ops.resize import resize_linear_f32, resize_linear_u8, resize_nearest
from ..utils import image_io
from ..utils.device import resolve_device
from ..training.checkpoint import read_weights
from ..utils.shipping import resolve
from . import engines, maskproc
from .tiled import pad_to_multiple, predict_tiled

logger = logging.getLogger(__name__)

# ops/augment.py in the JAX package
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "tiff", "webp")


class StageTimer:
    """Seconds spent in each named stage of a predictor's construction and
    process_folder_batch, each stage's own: a stage entered inside another
    counts in itself and not in the enclosing one. It synchronizes the card
    at the end of each stage, so a stage's device work counts in that
    stage; off (STAGE_TIMER None) the pipeline makes no such syncs.
    `parts` holds the seconds of named parts of a stage (a JPEG decode's
    host entropy decode and device pixel stage), which count in their
    stage as well."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = defaultdict(float)
        self.parts: Dict[str, float] = defaultdict(float)
        self._inner: List[float] = []  # time of inner stages, per level

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - t0
            self.seconds[stage] += elapsed - self._inner.pop()
            if self._inner:
                self._inner[-1] += elapsed

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.parts[name] += time.perf_counter() - t0


# The timer the pipeline's stages report to: None (no timing, no syncs)
# unless the caller sets one, as chip_smoke.py does around the CLI's run.
STAGE_TIMER: Optional[StageTimer] = None


def _stage(name: str):
    timer = STAGE_TIMER
    return timer(name) if timer is not None else contextlib.nullcontext()


def _part(name: str):
    timer = STAGE_TIMER
    return timer.part(name) if timer is not None else \
        contextlib.nullcontext()


def _decode_part(name: str):
    """The parts of a decode (image_io.read_rgb_tensor): a JPEG's entropy
    decode and pixel stage count in "decode", a PNG's upload in
    "upload_resize"."""
    return _stage("upload_resize") if name == "png_upload" else _part(name)


class WatermarkPredictor:
    """Holds the segmentation model on `device` with the shipped (or given)
    weights: a shipped-format .npz, a port checkpoint directory
    (training/checkpoint.read_weights; an orbax directory raises) or a
    reference .pth (_load_pth; an smp-layout UNet++ is detected). A
    float32 model on the card follows the process's TF32 settings
    (`torch.backends.cudnn.allow_tf32`, default on); the caller
    chooses them, as chip_smoke.py does. `engine_used` names the fill
    that the last repair step ran (None before one ran), `ocr_engine_used`
    the text detector step 3 ran; `engine_failures` and `ocr_failures`
    count the images of the last process_folder_batch whose repair batch
    or OCR raised."""

    def __init__(self, cfg: Optional[Config] = None,
                 weights_path: Optional[str] = None, device: str = "cuda"):
        with _stage("predictor_init"):
            self.cfg = cfg if cfg is not None else get_cfg_defaults()
            self.device = resolve_device(device)
            self.dtype = torch_dtype(self.cfg.MODEL.DTYPE)
            path = resolve("seg", cfg=self.cfg, explicit=weights_path)
            if path is None:
                raise FileNotFoundError(
                    f"no segmentation weights for {self.cfg.MODEL.NAME}/"
                    f"{self.cfg.MODEL.ENCODER_NAME}; pass weights_path or "
                    f"set PREDICT_SEG_WEIGHTS")
            self.weights_path = str(path)
            self.model_info: Dict[str, object] = {}
            if self.weights_path.endswith(".pth"):
                model = self._load_pth(self.weights_path)
            else:
                # built on the meta device: the weights file gives every
                # tensor (load_flax_weights raises otherwise)
                with torch.device("meta"):
                    model = create_model_from_config(self.cfg)
                self.n_weights = load_flax_weights(model, read_weights(path))
            model = model.eval().to(self.device, self.dtype)
            if self.device.type == "cuda":
                model = model.to(memory_format=torch.channels_last)
            self.model = model
            self._quant_scales = self._load_quant_scales()
            # the int8 operands of every calibrated conv, built once
            self._quant_plans = quant.build_plans(
                model, self._quant_scales) if self._quant_scales else None
            self.img_size = self.cfg.DATA.IMG_SIZE
            self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
            self._std = torch.tensor(IMAGENET_STD, device=self.device)
            self.engine_failures = 0
            self.engine_used: Optional[str] = None
            self.ocr_failures = 0
            self.ocr_engine_used: Optional[str] = None

    def _load_pth(self, path: str) -> torch.nn.Module:
        """A reference .pth (JAX's predict.py:155-189): for UNet++ the
        file's decoder layout (detect_decoder_impl) sets
        MODEL.DECODER_IMPL where it differs, then the model of the config,
        drawn by init_model (seed 0), takes the file's tensors by name and
        shape (import_state_dict); model_info gets the file's epoch and
        validation loss."""
        sd, self.model_info = torch_import.read_pth(path)
        if self.cfg.MODEL.NAME.lower() in ("unetplusplus", "unet++"):
            impl = torch_import.detect_decoder_impl(sd)
            if impl != self.cfg.MODEL.DECODER_IMPL:
                logger.info("checkpoint uses the '%s' UNet++ decoder layout "
                            "— rebuilding the model to match", impl)
                self.cfg.MODEL.DECODER_IMPL = impl
        model = init_model(create_model_from_config(self.cfg), seed=0)
        model, report = torch_import.import_state_dict(sd, model)
        self.n_weights = len(report["loaded"])
        logger.info("loaded .pth: %d tensors, %d unmatched (epoch %s, "
                    "val_loss %s)", len(report["loaded"]),
                    len(report["missing"]),
                    self.model_info.get("epoch", "?"),
                    self.model_info.get("val_loss", "?"))
        return model

    # ------------------------------------------------------------------
    # forward helpers
    # ------------------------------------------------------------------
    def _load_quant_scales(self) -> Optional[Dict[str, float]]:
        """The sidecar's activation scales under PREDICT.QUANT, else None
        (predict.py:113-130 in the JAX package)."""
        if not self.cfg.PREDICT.QUANT:
            return None
        sidecar = quant.quant_sidecar_path(self.weights_path)
        if not os.path.exists(sidecar):
            logger.warning("PREDICT.QUANT set but no calibration sidecar at "
                           "%s — staying %s", sidecar, self.cfg.MODEL.DTYPE)
            return None
        scales = quant.load_scales(sidecar)
        logger.info("int8 inference tier: %d calibrated conv scales (%s)",
                    len(scales), sidecar)
        return scales

    def _apply_model(self, x: torch.Tensor) -> torch.Tensor:
        """The segmentation forward on normalized NHWC images: the model
        dtype, or the int8 tier when PREDICT.QUANT resolved a sidecar.
        Every forward of the predictor goes through here."""
        if self._quant_scales:
            with quant.quant_int8(self._quant_scales, self._quant_plans):
                return self.model(x)
        return self.model(x)

    def _normalize(self, images_01: torch.Tensor) -> torch.Tensor:
        return (images_01 - self._mean) / self._std

    @torch.inference_mode()
    def _forward_probs(self, images_01: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) [0, 1] → (N, S, S) sigmoid probabilities. The JAX
        package pads a batch to a static size for its compile cache; eager
        torch runs it as it is."""
        return torch.sigmoid(self._apply_model(
            self._normalize(images_01))[..., 0])

    @torch.inference_mode()
    def predict_masks(self, images_01: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) [0, 1] → (N, S, S) float32 {0, 1} raw masks."""
        return (self._forward_probs(images_01)
                > self.cfg.PREDICT.THRESHOLD).float()

    @torch.inference_mode()
    def predict_artifact_masks(self, images_01: torch.Tensor
                               ) -> Tuple[torch.Tensor, List[str]]:
        """(N, S, S, 3) [0, 1] → (optimized masks (N, S, S) float32 {0, 1},
        each image's type name). Type detection sees the images as 8-bit
        RGB values, as step 1 gives it the decoded image."""
        images = torch.as_tensor(images_01, dtype=torch.float32,
                                 device=self.device)
        return self._artifact_masks(torch.round(images * 255.0),
                                    self.predict_masks(images))

    def _artifact_masks(self, rgb255: torch.Tensor, masks: torch.Tensor
                        ) -> Tuple[torch.Tensor, List[str]]:
        """Step 1's order on raw masks: each image's type from its 8-bit RGB
        values (as floats), then one strategy per image under the artifact
        surface's mask mode."""
        scores = maskproc.detect_watermark_type_scores(rgb255, masks)
        types = [maskproc.classify_type(x) for x in scores.tolist()]
        mode = maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                          "artifact")
        opt = maskproc.optimize_mask_batch_partitioned(
            masks, [maskproc.type_code(t) for t in types], mode=mode)
        return opt, types

    # ------------------------------------------------------------------
    # file discovery (predict.py:209-231)
    # ------------------------------------------------------------------
    def _get_image_files(self, input_folder: str,
                         output_folder: Optional[str] = None,
                         limit: Optional[int] = None) -> List[str]:
        """Sorted image files of the folder, without those whose
        {stem}_mask.png is already in output_folder, `limit` of them at
        random. A file the port cannot decode (where cv2 could) raises
        NotImplementedError."""
        files: List[str] = []
        for ext in IMAGE_EXTS:
            files.extend(glob.glob(os.path.join(input_folder, f"*.{ext}")))
            files.extend(glob.glob(os.path.join(input_folder,
                                                f"*.{ext.upper()}")))
        files = sorted(set(files))
        if output_folder and os.path.isdir(output_folder):
            files = [p for p in files if not os.path.exists(os.path.join(
                output_folder, f"{_stem(p)}_mask.png"))]
        if limit is not None and 0 < limit < len(files):
            random.shuffle(files)
            files = files[:limit]
        for p in files:  # an unreadable file passes: step 1 skips it
            image_io.require_decodable(p)
        return files

    def _read_rgb(self, path: str) -> Optional[torch.Tensor]:
        """The decoded (H, W, 3) uint8 image on this predictor's device, or
        None (logged) where cv2.imread would return None."""
        with _stage("decode"):
            try:
                return image_io.read_rgb_tensor(path, self.device,
                                                part=_decode_part)
            except image_io.UNREADABLE as e:
                logger.error("cannot load %s: %s", path, e)
                return None

    @staticmethod
    def _image_size(path: str) -> Optional[Tuple[int, int]]:
        """The (H, W) a decode of the file gives, from its headers, or None
        (logged) where they tell that cv2.imread would return None."""
        with _stage("decode"):
            try:
                return image_io.check_image(path)
            except image_io.UNREADABLE as e:
                logger.error("cannot load %s: %s", path, e)
                return None

    def _write_png(self, path: str, img: np.ndarray) -> None:
        with _stage("encode"):
            image_io.write_png(path, img)

    @torch.inference_mode()
    def _enhance_text_features(self, rgb: torch.Tensor) -> torch.Tensor:
        """CLAHE + Canny-edge boost + sharpen (predict.py:242-260) of an
        (H, W, 3) uint8 RGB image on the device: the cv2 calls of the JAX
        package through ops/imgproc.py, bit for bit."""
        gray = imgproc.gray_u8(rgb, "rgb")
        edges = imgproc.canny(imgproc.clahe(gray, 2.0, (8, 8)), 50, 150)
        edges = imgproc.grey_dilate(edges, m.ellipse_kernel(2, 2))
        out = rgb.float()
        boosted = torch.clamp(out * float(np.float32(1.2)), 0, 255)
        out = torch.where((edges > 0)[..., None], boosted, out)
        return imgproc.filter2d_u8(out.to(torch.uint8), imgproc.SHARPEN)

    # ------------------------------------------------------------------
    # single-image API (predict.py:262-338)
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_mask(self, image_path: str,
                     mask_type: str = "watermark") -> np.ndarray:
        """(H, W) uint8 {0, 255} mask of one image at its own size; the text
        and mixed types see the image after _enhance_text_features."""
        rgb = image_io.read_rgb_tensor(image_path, self.device)
        orig_h, orig_w = rgb.shape[:2]
        if mask_type in ("text", "mixed"):
            rgb = self._enhance_text_features(rgb)
        probs = self._infer_prob_map(rgb)
        probs = resize_linear_f32(probs, (orig_h, orig_w))
        mask_bin = (probs > self.cfg.PREDICT.THRESHOLD).float()
        if not self.cfg.PREDICT.POST_PROCESS:
            return (mask_bin * 255).to(torch.uint8).cpu().numpy()
        padded, (h, w) = pad_to_multiple(mask_bin, 32)
        opt = maskproc.optimize_mask(
            padded, mask_type,
            mode=maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                            "artifact"))
        probs_pad, _ = pad_to_multiple(probs, 32)
        opt = self._apply_predict_flags_batch(opt[None], probs_pad[None])[0]
        return (opt[:h, :w] * 255).to(torch.uint8).cpu().numpy()

    def _tiled(self, h: int, w: int) -> bool:
        p = self.cfg.PREDICT
        return p.TILED and min(h, w) >= p.TILE_SIZE and max(h, w) > \
            self.img_size

    @torch.inference_mode()
    def _infer_prob_map(self, rgb: torch.Tensor) -> torch.Tensor:
        """Probabilities of one (H, W, 3) uint8 image on the device: at
        model resolution (S, S), averaged over PREDICT.TEST_SCALES under
        MULTI_SCALE_TEST, or at (H, W) through the tiled path."""
        h, w = rgb.shape[:2]
        p = self.cfg.PREDICT
        if self._tiled(h, w):
            padded, (oh, ow) = pad_to_multiple(rgb.float() / 255.0, 32,
                                               min_size=p.TILE_SIZE)
            logits = predict_tiled(
                self._apply_model, self._normalize(padded),
                tile=p.TILE_SIZE, overlap=p.TILE_OVERLAP, batch=p.BATCH_SIZE)
            return torch.sigmoid(logits)[:oh, :ow, 0]
        return self._batch_prob_maps([rgb])[0]

    @torch.inference_mode()
    def _batch_prob_maps(self, imgs_rgb: List[torch.Tensor]) -> torch.Tensor:
        """(len(imgs), S, S) probabilities of (H, W, 3) uint8 images on the
        device, averaged over the test scales (one forward a scale), each
        resized to the scale's side there as cv2 resizes it."""
        s = self.img_size
        p = self.cfg.PREDICT
        scales = list(p.TEST_SCALES) if p.MULTI_SCALE_TEST else [1.0]
        acc = torch.zeros((len(imgs_rgb), s, s), dtype=torch.float32,
                          device=self.device)
        for scale in scales:
            side = max(int(round(s * scale / 32)) * 32, 32)
            with _stage("upload_resize"):
                batch = torch.stack([resize_linear_u8(r, (side, side))
                                     for r in imgs_rgb]).float() / 255.0
            probs = self._forward_probs(batch)
            if side != s:
                probs = resize_linear_f32(probs, (s, s))
            acc += probs
        return acc / len(scales)

    def _apply_predict_flags_batch(self, opt: torch.Tensor,
                                   probs: torch.Tensor) -> torch.Tensor:
        """EDGE_REFINEMENT and CONNECTIVITY_CHECK on (N, H, W) masks."""
        p = self.cfg.PREDICT
        if p.EDGE_REFINEMENT:
            soft = m.gaussian_blur(opt, (5, 5), 1.5)
            opt = m.threshold_binary(soft * (0.5 + probs), 0.5)
        if p.CONNECTIVITY_CHECK:
            tw = self.cfg.TEXT_WATERMARK
            opt = cc.filter_components_by_area(
                opt, min_area=tw.MIN_COMPONENT_AREA,
                connectivity=tw.CONNECTIVITY)
        return opt

    # ------------------------------------------------------------------
    # STEP 1 (predict.py:357-530)
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step1_batch_predict_watermark_masks(
            self, input_folder: str, mask_output_folder: str,
            limit: Optional[int] = None) -> List[dict]:
        """Step 1 over a folder: {stem}_mask.png for every image (decoded
        to the device and resized there), and a record
        (paths, mask type, watermark ratio) for each image whose mask is
        not empty."""
        os.makedirs(mask_output_folder, exist_ok=True)
        image_files = self._get_image_files(input_folder, mask_output_folder,
                                            limit=limit)
        if not image_files:
            logger.warning("no unprocessed images in %s", input_folder)
            return []
        logger.info("step1: %d images", len(image_files))
        s = self.img_size
        bs = self.cfg.PREDICT.BATCH_SIZE
        processed: List[dict] = []
        for i in range(0, len(image_files), bs):
            imgs, sizes, ok_paths = [], [], []
            for p in image_files[i:i + bs]:
                rgb = self._read_rgb(p)
                if rgb is None:
                    continue
                if self._tiled(*rgb.shape[:2]):
                    rec = self._step1_tiled_single(p, rgb,
                                                   mask_output_folder)
                    if rec is not None:
                        processed.append(rec)
                    continue
                sizes.append(tuple(rgb.shape[:2]))
                imgs.append(rgb)
                ok_paths.append(p)
            if not ok_paths:
                continue
            with _stage("step1_device"):
                probs = self._batch_prob_maps(imgs)
                masks_bin = (probs > self.cfg.PREDICT.THRESHOLD).float()
                with _stage("upload_resize"):
                    small = torch.stack([resize_linear_u8(r, (s, s))
                                         for r in imgs])
                opt, types = self._artifact_masks(small.float(), masks_bin)
                opt = self._apply_predict_flags_batch(opt, probs)
                opt_u8 = (opt * 255).to(torch.uint8)
                full = [resize_nearest(opt_u8[j], sizes[j]).cpu().numpy()
                        for j in range(len(ok_paths))]
            for j, p in enumerate(ok_paths):
                rec = self._save_step1_mask(p, full[j], types[j],
                                            mask_output_folder)
                if rec is not None:
                    processed.append(rec)
        logger.info("step1 done: %d with watermark / %d total",
                    len(processed), len(image_files))
        return processed

    def _save_step1_mask(self, path: str, mask_full: np.ndarray,
                         mask_type: str, folder: str) -> Optional[dict]:
        """Write {stem}_mask.png; the step-1 record, or None for an image
        without a watermark."""
        stem = _stem(path)
        mask_path = os.path.join(folder, f"{stem}_mask.png")
        self._write_png(mask_path, mask_full)
        wm_px = int((mask_full > 0).sum())
        if wm_px == 0:
            logger.info("no watermark detected, skipping: %s", stem)
            return None
        oh, ow = mask_full.shape
        return {"image_path": path, "original_path": path,
                "mask_path": mask_path, "mask_type": mask_type,
                "watermark_ratio": wm_px / (oh * ow)}

    @torch.inference_mode()
    def _step1_tiled_single(self, path: str, rgb: torch.Tensor,
                            mask_output_folder: str) -> Optional[dict]:
        """One high-res image: the native-resolution probability map of the
        tiled path, its type at model resolution, then its strategy and the
        predict flags at its (padded) size, with plain mask ops."""
        s = self.img_size
        with _stage("step1_device"):
            probs_full = self._infer_prob_map(rgb)
            mask_bin = (probs_full > self.cfg.PREDICT.THRESHOLD).float()
            score = maskproc.detect_watermark_type_scores(
                resize_linear_u8(rgb, (s, s)).float(),
                resize_nearest(mask_bin, (s, s)))
            mask_type = maskproc.classify_type(float(score))
            padded, (h, w) = pad_to_multiple(mask_bin, 32)
            opt = maskproc.optimize_mask(
                padded, mask_type,
                mode=maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                                "artifact"))
            probs_pad, _ = pad_to_multiple(probs_full, 32)
            opt = self._apply_predict_flags_batch(opt[None],
                                                  probs_pad[None])[0]
            mask_full = (opt[:h, :w] * 255).to(torch.uint8).cpu().numpy()
        return self._save_step1_mask(path, mask_full, mask_type,
                                     mask_output_folder)

    # ------------------------------------------------------------------
    # STEP 2 (predict.py:533-658): batched repair in-process
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _batch_inpaint_repair(self, processed_files: List[dict],
                              output_folder: str, mask_key: str,
                              model_name: str = "lama",
                              skip_condition: Optional[str] = None,
                              skip_threshold: Optional[float] = None,
                              steps: int = 1,
                              stage: str = "step2_device") -> List[dict]:
        """Repair each file's image under its mask with the engine, run
        `steps` times, in batches of PREDICT.BATCH_SIZE images that share a
        padded shape; the device work reports to `stage`. The JAX package
        pads each batch to a power of two for its compile cache; eager torch
        runs it as it is. An engine failure is logged at error level,
        counted in self.engine_failures, and the originals are copied, as
        the JAX package copies them."""
        os.makedirs(output_folder, exist_ok=True)
        successful: List[dict] = []
        to_process: List[dict] = []
        for fi in processed_files:
            skip = False
            if skip_condition == "watermark_ratio" and \
                    skip_threshold is not None:
                skip = fi.get("watermark_ratio", 1.0) < skip_threshold
            elif skip_condition == "text_pixels":
                skip = fi.get("text_pixels", 1) == 0
            if skip:
                stem = _stem(fi.get("original_path", fi["image_path"]))
                out = os.path.join(output_folder, f"{stem}.png")
                shutil.copy2(fi["image_path"], out)
                successful.append({**fi, "image_path": out})
                logger.info("skip repair (below threshold): %s", stem)
            else:
                to_process.append(fi)
        if not to_process:
            return successful

        with _stage("engine_load"):
            engine = engines.get_engine(model_name, cfg=self.cfg,
                                        device=self.device)
        self.engine_used = engine.name

        # bucket by padded shape, read from the headers; masks stay on the
        # host and each batch's images are decoded to the device when it
        # runs, so the device holds one batch of images at a time
        buckets: Dict[Tuple[int, int], List[dict]] = {}
        for fi in to_process:
            size = self._image_size(fi["image_path"])
            mask_path = fi.get(mask_key)
            mask = self._read_mask(mask_path) if mask_path else None
            if size is None or mask is None:
                self._fallback_copy(fi, output_folder, successful)
                continue
            key = (-(-size[0] // 32) * 32, -(-size[1] // 32) * 32)
            buckets.setdefault(key, []).append({**fi, "_mask": mask})

        bs = max(1, self.cfg.PREDICT.BATCH_SIZE)
        for items in buckets.values():
            for i in range(0, len(items), bs):
                group = []
                for g in items[i:i + bs]:
                    rgb = self._read_rgb(g["image_path"])
                    if rgb is None:
                        self._fallback_copy(g, output_folder, successful)
                    else:
                        group.append({**g, "_img": rgb})
                if not group:
                    continue
                with _stage("upload_resize"):
                    imgs, msks = [], []
                    for g in group:
                        img = g["_img"]
                        mask = torch.from_numpy(g["_mask"]).to(self.device)
                        if mask.shape != img.shape[:2]:
                            mask = resize_nearest(mask, img.shape[:2])
                        imgs.append(pad_to_multiple(img.float() / 255.0,
                                                    32)[0])
                        msks.append(pad_to_multiple((mask > 127).float(),
                                                    32)[0])
                    imgs = torch.stack(imgs)
                    msks = torch.stack(msks)[..., None]
                try:
                    with _stage(stage):
                        out = imgs
                        for _ in range(max(1, steps)):
                            out = engine(out, msks)
                        out_u8 = (torch.clamp(out, 0, 1) * 255).to(
                            torch.uint8).cpu().numpy()
                except Exception:  # noqa: BLE001 - the file contract holds
                    logger.exception("inpaint engine failed; copying "
                                     "originals")
                    self.engine_failures += len(group)
                    for g in group:
                        self._fallback_copy(g, output_folder, successful)
                    continue
                for j, g in enumerate(group):
                    oh, ow = g["_img"].shape[:2]
                    stem = _stem(g.get("original_path", g["image_path"]))
                    final = os.path.join(output_folder, f"{stem}.png")
                    self._write_png(final, out_u8[j, :oh, :ow])
                    successful.append(
                        {k: v for k, v in g.items()
                         if not k.startswith("_")} | {"image_path": final})
        return successful

    def _read_mask(self, path: str) -> Optional[np.ndarray]:
        """A mask file as cv2.imread(IMREAD_GRAYSCALE) reads it, or None
        (logged) where that would return None."""
        with _stage("decode"):
            try:
                return image_io.read_gray(path)
            except image_io.UNREADABLE as e:
                logger.error("cannot load mask %s: %s", path, e)
                return None

    @staticmethod
    def _fallback_copy(fi: dict, output_folder: str,
                       successful: List[dict]) -> None:
        stem = _stem(fi.get("original_path", fi["image_path"]))
        out = os.path.join(output_folder, f"{stem}.png")
        try:
            shutil.copy2(fi["image_path"], out)
        except OSError as e:
            logger.error("fallback copy failed for %s: %s", stem, e)
            return
        successful.append({k: v for k, v in fi.items()
                           if not k.startswith("_")} | {"image_path": out})
        logger.error("used original as fallback: %s", stem)

    def step2_batch_iopaint_watermark_repair(
            self, processed_files, step2_output_folder,
            model_name: str = "lama", timeout: int = 300,
            steps: int = 1) -> List[dict]:
        """`timeout` is accepted as the JAX package accepts it (the
        reference's subprocess limit) and not used."""
        logger.info("step2: watermark repair (%s)", model_name)
        return self._batch_inpaint_repair(
            processed_files, step2_output_folder, "mask_path", model_name,
            skip_condition="watermark_ratio", skip_threshold=0.001,
            steps=steps)

    # ------------------------------------------------------------------
    # STEP 3 (predict.py:664-726): OCR text masks
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step3_batch_extract_text_masks(
            self, processed_files, text_mask_output_folder,
            ocr_languages=None, ocr_engine: str = "easy") -> List[dict]:
        """{stem}_text_mask.png for each image: the detector's regions filled
        (cv2.rectangle / cv2.fillPoly) and dilated twice with the 5x5
        ellipse; a record for each image with text pixels. A detector that
        cannot be built, or an image whose OCR raises, is logged as the JAX
        package logs it and counted in self.ocr_failures."""
        os.makedirs(text_mask_output_folder, exist_ok=True)
        try:
            detector = get_ocr_detector(ocr_engine, device=self.device)
        except Exception:  # noqa: BLE001 - the JAX contract: no text masks
            logger.exception("OCR unavailable")
            self.ocr_failures += len(processed_files)
            return []
        self.ocr_engine_used = detector.name
        successful = []
        for fi in processed_files:
            image_path = fi["image_path"]
            size = self._image_size(image_path)
            if size is None:
                continue
            h, w = size
            try:
                with _stage("step3_detect"):
                    regions = detector.detect_text_regions(
                        image_path, languages=ocr_languages) \
                        if ocr_languages else \
                        detector.detect_text_regions(image_path)
                    text_mask = rasterize_regions(regions, h, w)
                    if text_mask.any():
                        dil = m.dilate(torch.from_numpy(text_mask > 0).to(
                            self.device).float(), m.ellipse_kernel(5, 5), 2)
                        text_mask = (dil * 255).to(torch.uint8).cpu().numpy()
                stem = _stem(fi["original_path"])
                tm_path = os.path.join(text_mask_output_folder,
                                       f"{stem}_text_mask.png")
                self._write_png(tm_path, text_mask)
            except Exception:  # noqa: BLE001 - one image stops no other
                logger.exception("OCR failed on %s", image_path)
                self.ocr_failures += 1
                continue
            text_pixels = int((text_mask > 0).sum())
            if text_pixels == 0:
                logger.info("no text detected, skipping: %s", stem)
                continue
            successful.append({
                "image_path": image_path,
                "original_path": fi["original_path"],
                "text_mask_path": tm_path,
                "text_pixels": text_pixels,
                "watermark_ratio": fi.get("watermark_ratio", 0.0),
            })
        logger.info("step3 done: %d with text / %d", len(successful),
                    len(processed_files))
        return successful

    def step4_batch_iopaint_text_repair(
            self, processed_files, final_output_folder,
            model_name: str = "lama", timeout: int = 600,
            steps: int = 1) -> List[dict]:
        """`timeout` is accepted as the JAX package accepts it and not
        used."""
        logger.info("step4: text repair (%s)", model_name)
        out = self._batch_inpaint_repair(
            processed_files, final_output_folder, "text_mask_path",
            model_name, skip_condition="text_pixels", steps=steps,
            stage="step4_device")
        return [{
            "original_path": fi["original_path"],
            "final_path": fi["image_path"],
            "watermark_ratio": fi.get("watermark_ratio", 0.0),
            "text_pixels": fi.get("text_pixels", 0),
        } for fi in out]

    # ------------------------------------------------------------------
    # STEP 5 (predict.py:746-797): merge masks
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def merge_masks_for_video(self, step1_results, step3_results,
                              merged_mask_output_folder) -> List[dict]:
        """Each step-1 mask, with its step-3 text mask merged in (the
        per-pixel maximum; a text mask of another size is resized as
        cv2.resize resizes it), through the repair surface's watermark
        chain at its padded original size, with the plain ops (no kernel:
        the size is not square)."""
        os.makedirs(merged_mask_output_folder, exist_ok=True)
        text_by_stem = {_stem(fi["original_path"]): fi["text_mask_path"]
                        for fi in step3_results or []}
        mode = maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                          "repair")
        merged = []
        for fi in step1_results:
            image_path = fi.get("image_path", fi["original_path"])
            stem = _stem(image_path)
            mask_path = fi.get("mask_path")
            if not mask_path or not os.path.exists(mask_path):
                continue  # skipped in step 1 (no watermark detected)
            tm_path = text_by_stem.get(stem)
            try:
                wm = torch.from_numpy(image_io.read_gray(mask_path)).to(
                    self.device)
                tm = self._read_mask(tm_path) if tm_path and \
                    os.path.exists(tm_path) else None
                if tm is not None:
                    tm = torch.from_numpy(tm).to(self.device)
                    if tm.shape != wm.shape:
                        tm = resize_linear_u8(tm[..., None], wm.shape)[..., 0]
                    wm = torch.maximum(wm, tm)
                padded, (h, w) = pad_to_multiple((wm > 127).float(), 32)
                opt = maskproc.optimize_mask(padded, "watermark", mode=mode)
                out_u8 = (opt[:h, :w] * 255).to(torch.uint8).cpu().numpy()
                merged_path = os.path.join(merged_mask_output_folder,
                                           f"{stem}.png")
                image_io.write_png(merged_path, out_u8)
            except Exception:  # noqa: BLE001 - one bad mask stops no other
                logger.exception("mask merge failed: %s", stem)
                continue
            px = int((out_u8 > 0).sum())
            merged.append({
                "original_path": image_path,
                "watermark_mask_path": mask_path,
                "text_mask_path": tm_path,
                "merged_mask_path": merged_path,
                "mask_ratio": px / out_u8.size,
                "mask_pixels": px,
            })
        return merged

    # ------------------------------------------------------------------
    # orchestration (predict.py:799-929)
    # ------------------------------------------------------------------
    def process_folder_batch(self, input_folder: str, output_folder: str,
                             watermark_model: str = "lama",
                             text_model: str = "lama",
                             use_unet: bool = True, use_ocr: bool = True,
                             ocr_languages=None, ocr_engine: str = "easy",
                             timeout: int = 300,
                             save_intermediate: bool = True,
                             merge_masks: bool = True,
                             limit: Optional[int] = None,
                             steps: int = 3) -> Dict:
        """Steps 1-5 over a folder (3-4 with use_ocr); the stats dict has the
        JAX package's keys and four more: "engine_failures", the images
        whose repair batch raised and whose originals were copied instead,
        "engine_used", the fill the last repair step ran (None where it ran
        none), "ocr_engine_used", the text detector step 3 ran (None
        without OCR), and "ocr_failures", the images whose OCR raised."""
        start = time.time()
        self.engine_failures = self.ocr_failures = 0
        self.engine_used = self.ocr_engine_used = None
        os.makedirs(output_folder, exist_ok=True)
        if save_intermediate:
            mask_folder = os.path.join(output_folder, "step1_masks")
            step2_folder = os.path.join(output_folder,
                                        "step2_watermark_repaired")
            text_mask_folder = os.path.join(output_folder,
                                            "step3_text_masks")
        else:
            tmp = tempfile.mkdtemp(prefix="batch_watermark_removal_")
            mask_folder = os.path.join(tmp, "masks")
            step2_folder = os.path.join(tmp, "step2")
            text_mask_folder = os.path.join(tmp, "text_masks")

        step3_results: List[dict] = []
        if use_unet:
            step1_results = self.step1_batch_predict_watermark_masks(
                input_folder, mask_folder, limit=limit)
            if step1_results:
                step2_results = self.step2_batch_iopaint_watermark_repair(
                    step1_results, step2_folder, watermark_model, timeout,
                    steps)
                if not step2_results:
                    return {"status": "error",
                            "message": "step2 failed: watermark repair"}
            else:
                step1_results, step2_results = self._passthrough(
                    input_folder, step2_folder, limit)
        else:
            logger.info("skipping UNet detection")
            step1_results, step2_results = self._passthrough(
                input_folder, step2_folder, limit)
            if not step1_results:
                return {"status": "error", "message": "no images found"}

        if use_ocr:
            step3_results = self.step3_batch_extract_text_masks(
                step2_results, text_mask_folder, ocr_languages, ocr_engine)
        if step3_results:
            step4_results = self.step4_batch_iopaint_text_repair(
                step3_results, output_folder, text_model, timeout, steps)
            done = {fi["original_path"] for fi in step3_results}
            for fi in step2_results:  # no text: step 2's file is final
                if fi["original_path"] not in done:
                    final = os.path.join(output_folder,
                                         f"{_stem(fi['original_path'])}.png")
                    shutil.copy2(fi["image_path"], final)
                    step4_results.append({
                        "original_path": fi["original_path"],
                        "final_path": final,
                        "watermark_ratio": fi.get("watermark_ratio", 0.0),
                        "text_pixels": 0,
                    })
        else:
            if use_ocr:
                logger.warning("step3: no text anywhere; copying step2 out")
            for fi in step2_results:
                shutil.copy2(fi["image_path"], os.path.join(
                    output_folder, f"{_stem(fi['original_path'])}.png"))
            step4_results = step2_results

        merged_results = []
        if merge_masks and step1_results and use_unet:
            with _stage("step5"):
                merged_results = self.merge_masks_for_video(
                    step1_results, step3_results,
                    os.path.join(output_folder, "masks"))

        dt = time.time() - start
        total = len(step1_results)
        ok = len(step4_results)
        avg_ratio = (sum(f.get("watermark_ratio", 0) for f in step1_results)
                     / total if use_unet and total else 0.0)
        avg_text = (sum(f["text_pixels"] for f in step3_results) /
                    len(step3_results) if step3_results else 0.0)
        stats = {
            "status": "success",
            "total_images": total,
            "successful_images": ok,
            "success_rate": ok / total * 100 if total else 0,
            "processing_time": dt,
            "avg_processing_time_per_image": dt / total if total else 0,
            "avg_watermark_ratio": avg_ratio,
            "avg_text_pixels": avg_text,
            "steps_completed": {
                "step1_mask_prediction": len(step1_results),
                "step2_watermark_repair": len(step2_results),
                "step3_text_extraction": len(step3_results),
                "step4_text_repair": len(step4_results),
                "merged_masks": len(merged_results),
            },
            "engine_failures": self.engine_failures,
            "engine_used": self.engine_used,
            "ocr_engine_used": self.ocr_engine_used,
            "ocr_failures": self.ocr_failures,
        }
        logger.info("batch done: %d/%d ok in %.1fs", ok, total, dt)
        return stats

    def _passthrough(self, input_folder, step2_folder, limit):
        image_files = self._get_image_files(input_folder, limit=limit)
        step1, step2 = [], []
        os.makedirs(step2_folder, exist_ok=True)
        for p in image_files:
            out = os.path.join(step2_folder, f"{_stem(p)}.png")
            shutil.copy2(p, out)
            step1.append({"original_path": p, "mask_path": None,
                          "watermark_ratio": 0.0})
            step2.append({"original_path": p, "image_path": out,
                          "watermark_ratio": 0.0})
        return step1, step2

    # ------------------------------------------------------------------
    # fused single-graph detect→repair (predict.py:931-985)
    # ------------------------------------------------------------------
    def make_fused_repair_fn(self, inpaint_engine: str = "lama",
                             smooth_iterations: int = 32):
        """The fused detect→repair callable; `.engine_used` names the fill.

        With inpaint_engine in {lama, big-lama, mat} and weights that
        resolve (engines.resolve_inpaint_weights), the fill is the FFC
        generator, built once here on this predictor's device in bf16
        (whatever MODEL.DTYPE says, as the JAX fn), or for a torch
        checkpoint the public big-lama generator in float32
        (`engine_used` "ffc-big-lama-torch", JAX's name); otherwise, as
        for every other name, push-pull with `smooth_iterations` Jacobi
        sweeps."""
        lama = None
        engine_used = "pushpull"
        if inpaint_engine in ("lama", "big-lama", "mat"):
            wp = engines.resolve_inpaint_weights(cfg=self.cfg)
            if wp and os.path.exists(wp):
                lama, cand = engines.load_lama(wp, inpaint_engine,
                                               self.device, torch.bfloat16)
                if lama is not None:
                    engine_used = f"ffc-{cand}"
            if lama is None:
                logger.warning("fused repair: no trained weights for '%s' "
                               "— using pushpull fill", inpaint_engine)
        mode = maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                          "repair")

        @torch.inference_mode()
        def fused(images_01):
            images = torch.as_tensor(images_01, dtype=torch.float32,
                                     device=self.device)
            masks = self.predict_masks(images)
            if mode == "parity":
                opt = maskproc.optimize_watermark_mask_batch(masks)
            else:
                opt = maskproc.optimize_watermark_mask_tight(masks)
            if lama is not None:
                return lama(images, opt[..., None]), opt
            repaired = inpaint_pushpull(images, opt[..., None],
                                        smooth_iterations=smooth_iterations)
            return repaired, opt

        fused.engine_used = engine_used
        fused.mask_mode = mode
        return fused


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]
