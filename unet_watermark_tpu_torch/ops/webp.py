"""The WEBP pixel stage on the image's device: a VP8 frame's 4:2:0 planes
to RGB as libwebp 1.x gives them (WebPDecodeBGRInto / BGRA, the decoders
cv2 5.0 and Pillow 12 call); utils/webp.py takes the gray (cv2's
BGR2GRAY, ops/imgproc.gray_u8) and RGBA forms from it.

  chroma    libwebp's "fancy" upsampler: each output pixel's U and V are
            (9 a + 3 b + 3 c + d + 8) >> 4 of the nearest chroma sample a,
            its horizontal and vertical neighbours b, c (on the side of the
            pixel; the sample itself past the plane's edge) and the
            diagonal one d; as exact as libwebp's packed (3 a + b + 2) >> 2
            steps, which it equals
  colour    VP8YUVToR/G/B in 14-bit fixed point: MultHi(v, c) = (v c) >> 8,
            R = MultHi(y, 19077) + MultHi(v, 26149) - 14234,
            G = MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708,
            B = MultHi(y, 19077) + MultHi(u, 33050) - 17685, each >> 6 and
            clipped to 0..255; colours are not premultiplied by alpha

On a CUDA device the upload is the planes, 1.5 bytes a pixel.
"""
from __future__ import annotations

import torch


def _neighbours(n: int, m: int, device) -> tuple:
    """For n output positions over m chroma samples: the nearest sample's
    index and its neighbour's on the output's side, clamped."""
    pos = torch.arange(n, device=device)
    near = pos >> 1
    far = (near + torch.where(pos & 1 == 1, 1, -1)).clamp(0, m - 1)
    return near, far


def upsample(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h, w) int32 of a ((h + 1) // 2, (w + 1) // 2) chroma plane."""
    c = c.to(torch.int32)
    ny, fy = _neighbours(h, c.shape[0], c.device)
    nx, fx = _neighbours(w, c.shape[1], c.device)
    near, far = c[ny], c[fy]
    return (9 * near[:, nx] + 3 * near[:, fx] + 3 * far[:, nx]
            + far[:, fx] + 8) >> 4


def _clip8(v: torch.Tensor) -> torch.Tensor:
    return torch.where((v & ~16383) == 0, v >> 6,
                       torch.where(v < 0, 0, 255)).to(torch.uint8)


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of a VP8 frame's planes, on their device."""
    h, w = y.shape
    yy = (y.to(torch.int32) * 19077) >> 8
    uu, vv = upsample(u, h, w), upsample(v, h, w)
    r = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    return torch.stack([r, g, b], dim=2)
