"""Pre-decoded uint8 sample cache on disk (data/decoded_cache.py in the
JAX package), numpy only, with its fingerprint and layout:

    <root>/decoded_<S>_<fingerprint>/
        images.npy   (N, S, S, 3) uint8, np.lib.format memmap
        masks.npy    (N, S, S)    uint8
        present.npy  (N,)         uint8, 1 = slot filled
        meta.json

The fingerprint covers the ordered file list with sizes and mtimes, the
image size and the mask parameters, so a changed dataset gets a fresh
directory. Slots fill lazily, one per index on first access.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _fingerprint(dataset) -> str:
    h = hashlib.sha1()
    h.update(str(dataset.img_size).encode())
    h.update(str(getattr(dataset, "generate_mask_threshold", "")).encode())
    h.update(str(getattr(dataset, "use_blurred_mask", False)).encode())
    for p in dataset.image_files:
        try:
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{int(st.st_mtime)}".encode())
        except OSError:
            h.update(f"{p}:gone".encode())
    return h.hexdigest()[:16]


class DecodedCache:
    """A dataset (.image_files, .img_size, __len__, __getitem__ giving
    (image u8 HWC, mask u8 HW)) behind a lazy disk memmap."""

    def __init__(self, dataset, cache_root: str):
        self.dataset = dataset
        self.img_size = dataset.img_size
        n, s = len(dataset), dataset.img_size
        tag = _fingerprint(dataset)
        self.dir = os.path.join(cache_root, f"decoded_{s}_{tag}")
        os.makedirs(self.dir, exist_ok=True)
        self.images = self._open("images.npy", (n, s, s, 3))
        self.masks = self._open("masks.npy", (n, s, s))
        self.present = self._open("present.npy", (n,))
        meta = os.path.join(self.dir, "meta.json")
        if not os.path.exists(meta):
            with open(meta, "w") as f:
                json.dump({"n": n, "img_size": s, "fingerprint": tag,
                           "first_file": dataset.image_files[0] if n else
                           None}, f)
        logger.info("decoded cache at %s: %d/%d present", self.dir,
                    int(self.present.sum()), n)

    def _open(self, name: str, shape) -> np.memmap:
        path = os.path.join(self.dir, name)
        mode = "r+" if os.path.exists(path) else "w+"
        return np.lib.format.open_memmap(path, mode=mode, dtype=np.uint8,
                                         shape=shape)

    @property
    def image_files(self):
        return self.dataset.image_files

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.present[idx]:
            return np.asarray(self.images[idx]), np.asarray(self.masks[idx])
        img, mask = self.dataset[idx]
        if mask.dtype != np.uint8:
            mask = np.clip(mask, 0, 255).astype(np.uint8)
        self.images[idx] = img
        self.masks[idx] = mask
        self.present[idx] = 1  # set only after both arrays are written
        return img, mask


def maybe_wrap_decoded_cache(dataset, cfg, use_blurred_mask: bool):
    """The dataset behind a DecodedCache where DATA.CACHE_DECODED is set
    (and not in blurred-mask training, whose noise must stay fresh)."""
    if not cfg.DATA.CACHE_DECODED:
        return dataset
    if use_blurred_mask and dataset.mode == "train":
        logger.info("decoded cache disabled: blurred-mask train noise "
                    "must stay fresh per access")
        return dataset
    root = cfg.DATA.CACHE_DIR or os.path.join(cfg.DATA.ROOT_DIR,
                                              ".decoded_cache")
    try:
        return DecodedCache(dataset, root)
    except OSError as e:  # an unwritable cache directory
        logger.warning("decoded cache unavailable (%s); decoding per "
                       "epoch", e)
        return dataset
