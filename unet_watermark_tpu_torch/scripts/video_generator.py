"""Comparison videos of a repair run (scripts/video_generator.py of the JAX
package): switch-style, side by side, and three-way (original, mask heat
map, repaired), with letterboxed frames and text overlays.

The frames are JAX's, built the same way on `device` (torch uint8 BGR, as
cv2 holds them): the images (PNG, JPEG, BMP, WEBP) read as cv2.imread
reads them (utils/image_io.py), resize_image_with_padding by cv2's INTER_LINEAR
(ops/resize.resize_linear_u8), add_text_overlay by ops/draw.py (the
labels' pixels are cv2's at the sizes the products draw, see there),
COLORMAP_HOT for the mask. They are written by utils/mp4v.Mp4vWriter,
MPEG-4 Part 2 like cv2's "mp4v" writer, each image's frame coded once and
held for duration x fps frames: the file's frame count, rate and size are
JAX's, its coded bytes are not (see utils/mp4v.py).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import draw
from ..ops.resize import resize_linear_u8
from ..utils import image_io
from ..utils.device import resolve_device
from ..utils.mp4v import Mp4vWriter

logger = logging.getLogger(__name__)

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _clean_stem(name: str) -> str:
    """Match repaired outputs to originals by their stem without the
    _mask/_repaired/_text_mask/_fixed suffix."""
    stem = os.path.splitext(os.path.basename(name))[0]
    for suffix in ("_mask", "_repaired", "_text_mask", "_fixed"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    return stem


def _list_images(folder: str) -> Dict[str, str]:
    out = {}
    if not os.path.isdir(folder):
        return out
    for f in sorted(os.listdir(folder)):
        if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
            out[_clean_stem(f)] = os.path.join(folder, f)
    return out


class VideoGenerator:
    def __init__(self, width: int = 1920, height: int = 1080,
                 duration_per_image: float = 2.0, fps: int = 30,
                 device="cuda"):
        self.width = width
        self.height = height
        self.duration = duration_per_image
        self.fps = fps
        self.device = resolve_device(device)
        self.frames_written = 0

    def find_image_pairs(self, original_dir: str, repaired_dir: str
                         ) -> List[Tuple[str, str]]:
        orig = _list_images(original_dir)
        rep = _list_images(repaired_dir)
        return [(orig[k], rep[k]) for k in sorted(orig) if k in rep]

    def find_image_triplets(self, original_dir: str, repaired_dir: str,
                            mask_dir: str) -> List[Tuple[str, str, str]]:
        orig = _list_images(original_dir)
        rep = _list_images(repaired_dir)
        msk = _list_images(mask_dir)
        return [(orig[k], rep[k], msk[k]) for k in sorted(orig)
                if k in rep and k in msk]

    # -- frames --------------------------------------------------------------
    def _read_bgr(self, path: str) -> Optional[torch.Tensor]:
        """cv2.imread(path): BGR uint8 on the device, None where cv2 gives
        None."""
        try:
            rgb = image_io.read_rgb_tensor(path, self.device)
        except image_io.UNREADABLE:
            return None
        return rgb.flip(-1).contiguous()

    def _read_gray(self, path: str) -> Optional[torch.Tensor]:
        try:
            return torch.from_numpy(image_io.read_gray(path)).to(self.device)
        except image_io.UNREADABLE:
            return None

    def resize_image_with_padding(self, image: torch.Tensor,
                                  target_w: Optional[int] = None,
                                  target_h: Optional[int] = None
                                  ) -> torch.Tensor:
        tw = target_w or self.width
        th = target_h or self.height
        h, w = image.shape[:2]
        scale = min(tw / w, th / h)
        nw, nh = int(w * scale), int(h * scale)
        resized = resize_linear_u8(image, (nh, nw))
        canvas = torch.zeros((th, tw, 3), dtype=torch.uint8,
                             device=image.device)
        y0, x0 = (th - nh) // 2, (tw - nw) // 2
        canvas[y0:y0 + nh, x0:x0 + nw] = resized
        return canvas

    def add_text_overlay(self, image: torch.Tensor, text: str,
                         position: str = "top") -> torch.Tensor:
        out = image.clone()
        scale = max(out.shape[1] / 1920.0, 0.5) * 1.2
        thickness = max(int(2 * scale), 1)
        (tw, th), _ = draw.get_text_size(text, scale, thickness)
        x = (out.shape[1] - tw) // 2
        y = th + 20 if position == "top" else out.shape[0] - 20
        draw.rectangle_filled(out, (x - 10, y - th - 10),
                              (x + tw + 10, y + 10), (0, 0, 0))
        draw.put_text(out, text, (x, y), scale, (255, 255, 255), thickness)
        return out

    def _writer(self, output_path: str) -> Mp4vWriter:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        return Mp4vWriter(output_path, self.fps, (self.width, self.height))

    def _hold(self, writer: Mp4vWriter, frame: torch.Tensor,
              seconds: Optional[float] = None) -> None:
        n = int((seconds or self.duration) * self.fps)
        if n > 0:
            writer.write(frame, hold=n)
            self.frames_written += n

    # -- products ------------------------------------------------------------
    def comparison_frames(self, original_dir: str, repaired_dir: str):
        """The switch-style video's frames: original, then repaired, per
        image."""
        for op, rp in self.find_image_pairs(original_dir, repaired_dir):
            o, r = self._read_bgr(op), self._read_bgr(rp)
            if o is None or r is None:
                continue
            yield self.add_text_overlay(
                self.resize_image_with_padding(o), "Original")
            yield self.add_text_overlay(
                self.resize_image_with_padding(r), "Repaired")

    def side_by_side_frames(self, original_dir: str, repaired_dir: str):
        half_w = self.width // 2
        for op, rp in self.find_image_pairs(original_dir, repaired_dir):
            o, r = self._read_bgr(op), self._read_bgr(rp)
            if o is None or r is None:
                continue
            of = self.add_text_overlay(self.resize_image_with_padding(
                o, half_w, self.height), "Original")
            rf = self.add_text_overlay(self.resize_image_with_padding(
                r, self.width - half_w, self.height), "Repaired")
            yield torch.cat([of, rf], dim=1)

    def three_way_frames(self, original_dir: str, repaired_dir: str,
                         mask_dir: str):
        third = self.width // 3
        for op, rp, mp in self.find_image_triplets(original_dir,
                                                   repaired_dir, mask_dir):
            o, r, mk = (self._read_bgr(op), self._read_bgr(rp),
                        self._read_gray(mp))
            if o is None or r is None or mk is None:
                continue
            heat = draw.apply_colormap_hot(mk)
            of = self.add_text_overlay(self.resize_image_with_padding(
                o, third, self.height), "Original")
            mf = self.add_text_overlay(self.resize_image_with_padding(
                heat, third, self.height), "Mask")
            rf = self.add_text_overlay(self.resize_image_with_padding(
                r, self.width - 2 * third, self.height), "Repaired")
            yield torch.cat([of, mf, rf], dim=1)

    def _write(self, frames, output_path: str, what: str, n: int
               ) -> Optional[str]:
        if not n:
            logger.warning("no image %s found", what)
            return None
        writer = self._writer(output_path)
        try:
            for frame in frames:
                self._hold(writer, frame)
        finally:
            writer.release()
        logger.info("%s video: %s (%d %s)", what, output_path, n, what)
        return output_path

    def create_comparison_video(self, original_dir: str, repaired_dir: str,
                                output_path: str) -> Optional[str]:
        n = len(self.find_image_pairs(original_dir, repaired_dir))
        return self._write(self.comparison_frames(original_dir,
                                                  repaired_dir),
                           output_path, "pairs", n)

    def create_side_by_side_video(self, original_dir: str,
                                  repaired_dir: str,
                                  output_path: str) -> Optional[str]:
        n = len(self.find_image_pairs(original_dir, repaired_dir))
        return self._write(self.side_by_side_frames(original_dir,
                                                    repaired_dir),
                           output_path, "pairs", n)

    def create_three_way_comparison_video(self, original_dir: str,
                                          repaired_dir: str, mask_dir: str,
                                          output_path: str
                                          ) -> Optional[str]:
        n = len(self.find_image_triplets(original_dir, repaired_dir,
                                         mask_dir))
        return self._write(self.three_way_frames(original_dir, repaired_dir,
                                                 mask_dir),
                           output_path, "triplets", n)
