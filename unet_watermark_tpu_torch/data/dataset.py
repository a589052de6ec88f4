"""Dataset: file discovery, mask load-or-generate, the seeded split
(data/dataset.py in the JAX package), with the same directory contract
(ROOT/{watermarked,clean,masks}, extra roots), mask rules and split.

Reads go through utils/image_io (cv2.imread's pixels for PNG and JPEG; a
JPEG decodes on `device`); resizes are ops/resize's cv2-exact INTER_LINEAR
for the image and INTER_NEAREST for the mask. A mask made from the clean
image runs on ops/imgproc and ops/morphology on `device`: absdiff, RGB →
gray, threshold, open with the 3 x 3 ellipse, GaussianBlur 3 x 3 σ 0.5,
threshold at 127; it equals cv2's bytes (on a 0/255 mask that blur moves
no pixel across 127: the centre weight alone is 0.62 of the sum, all the
others 0.38). It is cached as a PNG in mask_dirs[0], as in the JAX
package. Images and masks are read as cv2 reads them
(utils/image_io.py: PNG, JPEG, BMP, TIFF, WEBP; a colour or palette mask
PNG read as gray through libpng's rule). A file cv2 cannot read is
skipped; a folder with a form the port does not decode yet (a BigTIFF, an
animated WEBP, ROADMAP.md §A.5) is refused before any work
(image_io.require_decodable).

With use_blurred_mask the thresholded difference takes the JAX package's
blurred finishing instead (_blurred_mask): open(3) → close(7)x3 →
close(11)x2 → dilate(9)x2, which is kernel K1's chain, so a square mask
of side up to K1_MAX_SIZE runs K1 on `device` and any other shape the
same whole-image ops (morph_chain_plain); the largest-component rule
(ops/components, ties to the first component in raster order as
np.argmax over cv2's labels); on the host, cv2's external contours,
convex hulls, arc lengths and polygon approximations (ops/contours) and
their fill (ops/imgproc.fill_poly); then cv2's 8-bit GaussianBlur
(15 x 15, 5) and (31 x 31, 10) in its fixed point
(imgproc.gaussian_blur_u8), equal to cv2 byte for byte. In train mode
normal noise (sigma 5) is added, clipped and truncated to uint8, as in
JAX, drawn from this dataset's torch.Generator (seed 0) on `device`
where JAX draws from numpy's global generator: the same recipe, other
draws.
"""
from __future__ import annotations

import logging
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import components, contours, imgproc, morphology
from ..ops.kernels.morph_chain import (K1_MAX_SIZE, morph_chain_plain,
                                       morph_chain_watermark)
from ..ops.resize import resize_linear_u8, resize_nearest
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}


class WatermarkDataset:
    """Index-addressable dataset of (image uint8 HWC RGB, mask uint8 HW),
    numpy on the host. Mask priority: a mask file > the absdiff of the
    clean image (cached) > a zero mask; an unreadable image gives the next
    readable index; CACHE_IMAGES keeps samples in memory."""

    def __init__(self, watermarked_dirs, clean_dirs=None, mask_dirs=None,
                 img_size: int = 512, mode: str = "train",
                 generate_mask_threshold: int = 30,
                 cache_images: bool = False,
                 use_blurred_mask: bool = False, device="cuda"):
        as_list = lambda d: (list(d) if isinstance(d, (list, tuple))  # noqa
                             else [d] if d else [])
        self.watermarked_dirs = as_list(watermarked_dirs)
        self.clean_dirs = as_list(clean_dirs)
        self.mask_dirs = as_list(mask_dirs)
        self.img_size = img_size
        self.mode = mode
        self.generate_mask_threshold = generate_mask_threshold
        self.cache_images = cache_images
        self.use_blurred_mask = use_blurred_mask
        self.device = resolve_device(device)
        self._noise_gen: Optional[torch.Generator] = None
        self._cache = {} if cache_images else None
        self.image_files = self._collect_image_files()
        for path in self.image_files:
            image_io.require_decodable(path)

    def _collect_image_files(self) -> List[str]:
        files = []
        for d in self.watermarked_dirs:
            if os.path.isdir(d):
                for fn in os.listdir(d):
                    if os.path.splitext(fn)[1].lower() in IMAGE_EXTENSIONS:
                        files.append(os.path.join(d, fn))
        logger.info("found %d images", len(files))
        return sorted(files)

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        for attempt in range(len(self.image_files)):
            j = (idx + attempt) % len(self.image_files)
            sample = self._load(j)
            if sample is not None:
                if self._cache is not None:
                    self._cache[idx] = sample
                return sample
        raise RuntimeError("no readable images in dataset")

    def _read(self, path: str, gray: bool = False
              ) -> Optional[torch.Tensor]:
        """The file's pixels on self.device, or None where cv2.imread gives
        None."""
        try:
            if gray:
                return torch.from_numpy(image_io.read_gray(path)).to(
                    self.device)
            return image_io.read_rgb_tensor(path, self.device)
        except image_io.UNREADABLE as e:
            logger.warning("failed to read %s: %s", path, e)
            return None

    def _load(self, idx: int):
        path = self.image_files[idx]
        img = self._read(path)
        if img is None:
            logger.warning("skipping corrupted image: %s", path)
            return None
        mask = self._get_or_generate_mask(os.path.basename(path), img)
        s = self.img_size
        if tuple(img.shape[:2]) != (s, s):
            img = resize_linear_u8(img, (s, s))
        if tuple(mask.shape[:2]) != (s, s):
            mask = resize_nearest(mask, (s, s))
        return img.cpu().numpy(), mask.cpu().numpy()

    def _get_or_generate_mask(self, image_name: str,
                              watermarked: torch.Tensor) -> torch.Tensor:
        stem = os.path.splitext(image_name)[0]
        for m_dir in self.mask_dirs:
            p = os.path.join(m_dir, stem + ".png")
            if os.path.exists(p):
                mask = self._read(p, gray=True)
                if mask is not None:
                    return mask
        for c_dir in self.clean_dirs:
            p = os.path.join(c_dir, image_name)
            if os.path.exists(p):
                clean = self._read(p)
                if clean is None:
                    continue
                mask = self.generate_mask(watermarked, clean)
                if self.mask_dirs:
                    os.makedirs(self.mask_dirs[0], exist_ok=True)
                    out = os.path.join(self.mask_dirs[0], stem + ".png")
                    try:
                        image_io.write_png(out, mask.cpu().numpy())
                    except OSError as e:
                        logger.warning("mask cache write failed %s: %s",
                                       out, e)
                return mask
        return torch.zeros(tuple(watermarked.shape[:2]), dtype=torch.uint8,
                           device=watermarked.device)

    def generate_mask(self, watermarked: torch.Tensor,
                      clean: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 RGB pair → (H, W) uint8: absdiff → gray →
        threshold → open(3 x 3 ellipse) → blur 3 x 3 σ 0.5 → threshold 127
        ({0, 255}), or with use_blurred_mask the blurred finishing."""
        if watermarked.shape != clean.shape:
            clean = resize_linear_u8(clean, tuple(watermarked.shape[:2]))
        diff = (watermarked.to(torch.int16) - clean.to(torch.int16)).abs()
        gray = imgproc.gray_u8(diff.to(torch.uint8), "rgb")
        mask = (gray > self.generate_mask_threshold).float()
        if self.use_blurred_mask:
            return self._blurred_mask(mask)
        mask = morphology.morph_open(mask, morphology.ellipse_kernel(3, 3))
        blurred = morphology.gaussian_blur(mask * 255.0, (3, 3), 0.5)
        return torch.where(blurred > 127, 255, 0).to(torch.uint8)

    def _blurred_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """The thresholded (H, W) {0, 1} float mask, before its open →
        (H, W) uint8 soft mask (JAX's open and _blurred_mask)."""
        h, w = mask.shape
        batch = mask[None].contiguous()
        if h == w and h <= K1_MAX_SIZE:
            x = morph_chain_watermark(batch)  # K1 opens first
        else:
            x = morph_chain_plain(batch)
        x = components.keep_largest_component(x, 8, min_keep_area=500,
                                              fallback_min_area=200)[0]
        hard = ((x > 0.5).to(torch.uint8) * 255).cpu().numpy()
        outlines = contours.find_external_contours(hard)
        if outlines:
            hard = np.zeros_like(hard)
            for c in outlines:
                area = contours.contour_area(c)
                if area <= 100:
                    continue
                hull = contours.convex_hull(c)
                hull_area = contours.contour_area(hull)
                if hull_area > 0 and area / hull_area > 0.6:
                    imgproc.fill_poly(hard, hull, 255)
                else:
                    eps = 0.015 * contours.arc_length(c, True)
                    imgproc.fill_poly(
                        hard, contours.approx_poly_dp(c, eps, True), 255)
        soft = torch.from_numpy(hard).to(self.device)
        soft = imgproc.gaussian_blur_u8(soft, 15, 5.0)
        soft = imgproc.gaussian_blur_u8(soft, 31, 10.0)
        if self.mode == "train":
            if self._noise_gen is None:
                self._noise_gen = torch.Generator(
                    self.device).manual_seed(0)
            noise = torch.randn(soft.shape, generator=self._noise_gen,
                                device=self.device) * 5.0
            soft = (soft.float() + noise).clamp(0, 255).to(torch.uint8)
        return soft


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def dataset_dirs_from_config(cfg):
    roots = [cfg.DATA.ROOT_DIR] + list(cfg.DATA.ADDITIONAL_ROOT_DIRS)
    watermarked = [os.path.join(r, "watermarked") for r in roots]
    clean = [os.path.join(r, "clean") for r in roots]
    masks = [os.path.join(r, "masks") for r in roots]
    return watermarked, clean, masks


def create_datasets(cfg, use_blurred_mask: bool = False, device="cuda"
                    ) -> Tuple[Subset, Subset]:
    """The seeded TRAIN_RATIO split: random.Random(DATA.SEED) shuffles the
    sorted file indices, as in the JAX package. Both subsets index a
    decoded cache (data/decoded_cache) where DATA.CACHE_DECODED is set."""
    watermarked, clean, masks = dataset_dirs_from_config(cfg)

    def make(mode):
        return WatermarkDataset(
            watermarked_dirs=watermarked, clean_dirs=clean, mask_dirs=masks,
            img_size=cfg.DATA.IMG_SIZE, mode=mode,
            generate_mask_threshold=cfg.DATA.GENERATE_MASK_THRESHOLD,
            cache_images=cfg.DATA.CACHE_IMAGES,
            use_blurred_mask=use_blurred_mask, device=device)

    full = make("train")
    n = len(full)
    indices = list(range(n))
    if cfg.DATA.SHUFFLE:
        random.Random(cfg.DATA.SEED).shuffle(indices)
    train_size = int(cfg.DATA.TRAIN_RATIO * n)
    train_idx, val_idx = indices[:train_size], indices[train_size:]
    val = make("val")
    logger.info("dataset split: %d train / %d val", len(train_idx),
                len(val_idx))
    from .decoded_cache import maybe_wrap_decoded_cache
    full = maybe_wrap_decoded_cache(full, cfg, use_blurred_mask)
    val = maybe_wrap_decoded_cache(val, cfg, use_blurred_mask)
    return Subset(full, train_idx), Subset(val, val_idx)
