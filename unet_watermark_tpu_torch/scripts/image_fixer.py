"""Corrupted-image detection and repair (scripts/image_fixer.py in the
JAX package), without PIL or cv2.

ImageFixer.check_image gives the stage JAX's gives, with the port's own
message after the prefix:

  pil_verify       what PIL's Image.open + verify() refuses: a file of no
                   format the readers know (an empty file, random bytes),
                   headers that do not parse (a JPEG's up to its first
                   scan, a BMP's, a TIFF's first IFD, a WEBP's chunks), and
                   for a PNG every chunk's CRC up to IEND (a truncated
                   file, a bad CRC, a missing IEND)
  pil_load         what PIL's load() refuses: a strict full decode, so a
                   JPEG whose data ends before its EOI marker (a truncated
                   file, which cv2 and the port's readers still decode as
                   libjpeg does), and any file the port's reader refuses
  cv2_unreadable   what the port's cv2.imread stand-in refuses

fix_image follows JAX's two branches: where PIL would load the file (a
PNG read as PIL reads it, without CRC checks or IEND), its RGB pixels are
re-encoded in place as PIL's save(quality=95) writes them by extension
(JPEG: the same bytes; PNG and BMP: the same pixels); otherwise cv2's
imread(IMREAD_UNCHANGED) + imwrite (a truncated JPEG's partial decode, gray
kept gray, written at quality 95). A .webp, .tif or .tiff that needs
re-encoding raises NotImplementedError naming ROADMAP.md §A.8: the port
has no WEBP or TIFF encoder.

CLI (decodes on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.image_fixer --folder D \\
        [--fix] [--backup-dir B]
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import bmp, image_io, jpeg, tiff, webp
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif", ".webp"}
NOT_ENCODED = (".webp", ".tif", ".tiff")


class VerifyError(ValueError):
    """What PIL's open or verify() would raise."""


def _png_chunks(data: bytes, check_crc: bool):
    """(kind, body) of each chunk to IEND; VerifyError where one is cut
    off, fails its CRC (check_crc) or IEND never comes."""
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise VerifyError("truncated PNG file")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise VerifyError("Truncated File Read")
        if check_crc and zlib.crc32(kind + body) != struct.unpack(
                ">I", crc)[0]:
            raise VerifyError(f"broken PNG file (bad header checksum in "
                              f"{kind!r})")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _pil_open(path: str, data: bytes, verify: bool = False) -> str:
    """The format, or VerifyError as PIL's Image.open refuses the file
    (verify: or its verify() then does)."""
    kind = image_io.sniff(data[:16])
    if kind is None:
        raise VerifyError(f"cannot identify image file {path!r}")
    try:
        if kind == "png":
            if data[12:16] != b"IHDR":
                raise VerifyError("not a PNG file")
            if verify:
                for _ in _png_chunks(data, True):
                    pass
        elif kind == "jpeg":
            jpeg.parse(data, headers_only=True)
        elif kind == "bmp":
            bmp.parse(data, pil=True)
        elif kind == "tiff":
            tiff.parse(data)
        else:
            webp.parse(data)
    except image_io.UNREADABLE as e:
        raise VerifyError(f"cannot identify image file {path!r} ({e})")
    return kind


def _tolerant_png(data: bytes) -> bytes:
    """The file as PIL's load reads a PNG: each chunk's CRC and a missing
    IEND ignored (the chunks rewritten with their CRCs, IEND added); a cut
    chunk still fails."""
    out = [image_io.SIGNATURE]
    try:
        for kind, body in _png_chunks(data, False):
            if kind != b"IEND":
                out.append(image_io._chunk(kind, body))
    except VerifyError as e:
        if str(e) != "truncated PNG file":
            raise
    return b"".join(out) + image_io._chunk(b"IEND", b"")


def _pil_rgb(path: str, data: bytes, kind: str, device) -> torch.Tensor:
    """Image.open(path).convert("RGB") with PIL's strict load: (H, W, 3)
    uint8 on `device`, or an UNREADABLE error / VerifyError."""
    if kind == "png":
        rgba = image_io.decode_png_rgba(_tolerant_png(data))
        return torch.from_numpy(np.ascontiguousarray(rgba[..., :3])
                                ).to(device)
    if kind == "jpeg":
        last_scan = data.rfind(b"\xff\xda")
        if data.find(b"\xff\xd9", max(last_scan, 0)) < 0:
            raise VerifyError("image file is truncated")
    return image_io.read_rgba_tensor(path, device)[..., :3]


class ImageFixer:
    def __init__(self, backup_dir: Optional[str] = None, device="cuda"):
        self.backup_dir = backup_dir
        self.device = resolve_device(device)

    def check_image(self, path: str) -> Optional[str]:
        """A problem string, "stage: message", or None if healthy."""
        with open(path, "rb") as f:
            data = f.read()
        try:
            kind = _pil_open(path, data, verify=True)
        except VerifyError as e:
            return f"pil_verify: {e}"
        try:
            _pil_rgb(path, data, kind, self.device)
        except (VerifyError, *image_io.UNREADABLE) as e:
            return f"pil_load: {e}"
        try:
            image_io.read_rgb_tensor(path, self.device)
        except image_io.UNREADABLE:
            return "cv2_unreadable"
        return None

    def _unchanged(self, path: str, data: bytes) -> Optional[torch.Tensor]:
        """cv2.imread(path, IMREAD_UNCHANGED) as the port's readers give
        it (a gray JPEG as (H, W)), or None."""
        try:
            if image_io.sniff(data[:16]) == "jpeg" and \
                    len(jpeg.parse(data, headers_only=True).components) == 1:
                return image_io.read_gray_tensor(path, self.device)
            return image_io.read_rgb_tensor(path, self.device)
        except image_io.UNREADABLE:
            return None

    def fix_image(self, path: str) -> bool:
        """Re-encode in place; backs up the original first if configured."""
        if self.backup_dir:
            os.makedirs(self.backup_dir, exist_ok=True)
            try:
                shutil.copy2(path, os.path.join(self.backup_dir,
                                                os.path.basename(path)))
            except OSError as e:
                logger.warning("backup failed for %s: %s", path, e)
        ext = os.path.splitext(path)[1].lower()
        with open(path, "rb") as f:
            data = f.read()
        try:
            rgb = _pil_rgb(path, data, _pil_open(path, data), self.device)
        except (VerifyError, *image_io.UNREADABLE):
            rgb = None
        if rgb is None:
            img = self._unchanged(path, data)
            if img is None:
                return False
        else:
            img = rgb
        if ext in NOT_ENCODED:
            raise NotImplementedError(
                f"{path}: re-encoding a {ext} file needs an encoder the "
                f"port does not have (ROADMAP.md §A.8)")
        image_io.write_image(path, img)
        if rgb is None:
            return True
        try:
            image_io.read_rgb_tensor(path, self.device)
        except image_io.UNREADABLE:
            return False
        return True

    def scan_folder(self, folder: str, fix: bool = False) -> Dict:
        checked = 0
        problems: List[Dict] = []
        for f in sorted(os.listdir(folder)):
            if os.path.splitext(f)[1].lower() not in IMAGE_EXTS:
                continue
            path = os.path.join(folder, f)
            checked += 1
            problem = self.check_image(path)
            if problem:
                fixed = self.fix_image(path) if fix else False
                problems.append({"path": path, "problem": problem,
                                 "fixed": fixed})
        summary = {
            "checked": checked,
            "corrupted": len(problems),
            "fixed": sum(1 for p in problems if p["fixed"]),
            "details": problems,
        }
        logger.info("image check: %d checked, %d corrupted, %d fixed",
                    checked, len(problems), summary["fixed"])
        return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="corrupted image fixer")
    p.add_argument("--folder", required=True)
    p.add_argument("--fix", action="store_true")
    p.add_argument("--backup-dir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fixer = ImageFixer(backup_dir=args.backup_dir, device=args.device)
    s = fixer.scan_folder(args.folder, fix=args.fix)
    print({k: v for k, v in s.items() if k != "details"})
    return s


if __name__ == "__main__":
    main()
