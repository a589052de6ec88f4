"""The port's comparison videos (scripts/video_generator.py, ops/draw.py,
utils/mp4v.py) against the JAX package's on the same folders.

The frames are compared before encoding: JAX's are captured by replacing
cv2.VideoWriter inside the JAX module with a recorder for the test (the
JAX package itself is not touched), the port's come from its frame
generators. They must be equal, byte for byte. The encoded files cannot be
equal (cv2's writer is FFmpeg's encoder), so the port's MP4 is opened with
cv2.VideoCapture: its frame count, rate and size must equal those of
JAX's file, and each decoded frame must be within PSNR_DB of the frame
that was written.
"""

import cv2
import numpy as np
import pytest

from unet_watermark_tpu_torch.scripts import video_generator as pv
from unet_watermark_tpu_torch.utils import image_io, synthetic
from unet_watermark_tpu.scripts import video_generator as jv

PSNR_DB = 35.0  # decoded frame against the frame written


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    orig, rep, masks = (root / d for d in ("orig", "rep", "masks"))
    for d in (orig, rep, masks):
        d.mkdir()
    imgs, logos = synthetic.watermarked_images(3, 96, seed=7)
    u8 = (imgs * 255).astype(np.uint8)
    shapes = ((96, 96), (60, 90), (90, 48))
    for i, (h, w) in enumerate(shapes):
        image_io.write_png(orig / f"im{i}.png", u8[i][:h, :w])
        rep_img = u8[i][:h, :w].copy()
        rep_img[logos[i][:h, :w] > 0] = 128
        image_io.write_png(rep / f"im{i}_repaired.png", rep_img)
        image_io.write_png(masks / f"im{i}_mask.png",
                           (logos[i][:h, :w] * 255).astype(np.uint8))
    image_io.write_png(orig / "lonely.png", u8[0][:32, :32])  # no pair
    return str(orig), str(rep), str(masks)


class _Recorder:
    """cv2.VideoWriter's surface, keeping each written frame."""
    frames = []

    def __init__(self, path, fourcc, fps, size):
        self.size = size

    def isOpened(self):  # noqa: N802
        return True

    def write(self, frame):
        _Recorder.frames.append(frame.copy())

    def release(self):
        pass


def _jax_frames(monkeypatch, product, size, folders, **kw):
    _Recorder.frames = []
    monkeypatch.setattr(jv.cv2, "VideoWriter", _Recorder)
    gen = jv.VideoGenerator(width=size[0], height=size[1], **kw)
    getattr(gen, product)(*folders, "/dev/null")
    monkeypatch.undo()
    return _Recorder.frames


PRODUCTS = (("create_side_by_side_video", "side_by_side_frames", 2),
            ("create_three_way_comparison_video", "three_way_frames", 3),
            ("create_comparison_video", "comparison_frames", 2))


@pytest.mark.parametrize("jax_name,port_name,ndirs", PRODUCTS)
@pytest.mark.parametrize("size", [(640, 360), (1280, 720), (1920, 1080)])
def test_frames_equal_jax(monkeypatch, folders, jax_name, port_name, ndirs,
                          size):
    dirs = folders[:ndirs]
    ref = _jax_frames(monkeypatch, jax_name, size, dirs,
                      duration_per_image=1.0, fps=2)
    gen = pv.VideoGenerator(width=size[0], height=size[1],
                            duration_per_image=1.0, fps=2, device="cpu")
    got = [f.numpy() for f in getattr(gen, port_name)(*dirs)]
    # JAX holds each frame int(1.0 * 2) = 2 times
    assert len(ref) == 2 * len(got) and len(got) > 0
    for i, frame in enumerate(got):
        assert np.array_equal(ref[2 * i], frame), (port_name, size, i)


def _read_all(path):
    cap = cv2.VideoCapture(path)
    meta = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            cap.get(cv2.CAP_PROP_FPS),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return meta, frames


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("jax_name,port_name,ndirs", PRODUCTS)
def test_mp4_opens_with_jax_count_rate_and_size(tmp_path, folders, jax_name,
                                                port_name, ndirs):
    dirs = folders[:ndirs]
    size, kw = (1280, 720), dict(duration_per_image=1.0, fps=15)
    jgen = jv.VideoGenerator(width=size[0], height=size[1], **kw)
    jpath = getattr(jgen, jax_name)(*dirs, str(tmp_path / "jax.mp4"))
    pgen = pv.VideoGenerator(width=size[0], height=size[1], device="cpu",
                             **kw)
    ppath = getattr(pgen, jax_name)(*dirs, str(tmp_path / "port.mp4"))
    jmeta, _ = _read_all(jpath)
    pmeta, decoded = _read_all(ppath)
    assert pmeta == jmeta
    assert len(decoded) == jmeta[0] == pgen.frames_written
    written = [f.numpy() for f in getattr(pgen, port_name)(*dirs)]
    for i, f in enumerate(decoded):
        assert _psnr(f, written[i // 15]) >= PSNR_DB, i


def test_missing_folders_give_none(tmp_path):
    gen = pv.VideoGenerator(640, 360, device="cpu")
    assert gen.create_side_by_side_video(str(tmp_path / "a"),
                                         str(tmp_path / "b"),
                                         str(tmp_path / "v.mp4")) is None
    assert not (tmp_path / "v.mp4").exists()
