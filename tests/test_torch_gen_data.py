"""data/gen_data.py of the port against the JAX package's: generate_dataset
in both on the same clean folder (PNGs and a JPEG with EXIF orientation 6)
and logo folder (an RGBA PNG and a palette PNG with tRNS), seed 1000.

Equal: the file names (so the kinds and sources), the `logo` and `multi`
JPEGs byte for byte with their masks pixel for pixel, and every clean
copy. The text raster is the stated difference (the port's block font
against FreeType): `text` and `mixed` masks are non-empty, and the port's
text ink height over JAX's for the same draws lies in INK_RATIO (median in
INK_MEDIAN; DejaVu's lower-case descenders make JAX's taller on the site
names).
"""
import os
import random

import numpy as np
import pytest
from PIL import Image

import unet_watermark_tpu.data.gen_data as J
import unet_watermark_tpu_torch.data.gen_data as P
from unet_watermark_tpu_torch.utils import image_io, synthetic

INK_RATIO = (0.7, 1.1)
INK_MEDIAN = (0.9, 1.05)
COUNT = 32


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    clean, logos = root / "clean", root / "logos"
    clean.mkdir()
    logos.mkdir()
    imgs, _ = synthetic.watermarked_images(3, 160, seed=3, clean=3)
    u8 = (imgs * 255).astype(np.uint8)
    image_io.write_png(clean / "a.png", u8[0])
    image_io.write_png(clean / "b.png", u8[1][:120, :150])
    (clean / "c.jpg").write_bytes(synthetic.encode_jpeg(
        u8[2][:100, :140], orientation=6))
    lg = np.zeros((40, 60, 4), np.uint8)
    yy, xx = np.mgrid[0:40, 0:60]
    ring = np.abs(np.hypot(yy - 20, xx - 30) - 14) < 4
    lg[ring] = (250, 240, 10, 255)
    lg[np.abs(yy - 20) < 3] = (10, 10, 200, 128)
    image_io.write_png(logos / "l1.png", lg)
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
                    ).quantize(8).save(
        logos / "l2.png", transparency=bytes([0, 255, 128, 64, 255, 255, 0,
                                              200]))
    J.generate_dataset(str(clean), str(root / "jax"), str(logos),
                       count=COUNT, seed=1000)
    stats = P.generate_dataset(str(clean), str(root / "port"), str(logos),
                               count=COUNT, seed=1000, device="cpu")
    return root, stats


def _read(root, pkg, sub, name):
    return (root / pkg / sub / name).read_bytes()


def test_names_kinds_and_files(dirs):
    root, stats = dirs
    names = sorted(os.listdir(root / "jax" / "watermarked"))
    assert sorted(os.listdir(root / "port" / "watermarked")) == names
    assert len(names) == COUNT - stats["skipped"]
    kinds = {n.split("_")[1] for n in names}
    assert kinds == {"logo", "multi", "text", "mixed"}
    assert {n.split("_")[0] for n in names} == {"a", "b", "c"}
    for name in names:
        kind = name.split("_")[1]
        mask = os.path.splitext(name)[0] + ".png"
        mj = np.array(Image.open(root / "jax" / "masks" / mask))
        mp = image_io.read_gray(root / "port" / "masks" / mask)
        assert _read(root, "port", "clean", name) == \
            _read(root, "jax", "clean", name)
        if kind in ("logo", "multi"):
            assert _read(root, "port", "watermarked", name) == \
                _read(root, "jax", "watermarked", name), name
            assert np.array_equal(mj, mp), name
        else:
            assert mp.any() and mj.any(), name
            assert set(np.unique(mp)) <= {0, 255}


def test_resume_skips_existing(dirs):
    root, _ = dirs
    before = {n: (root / "port" / "watermarked" / n).stat().st_mtime_ns
              for n in os.listdir(root / "port" / "watermarked")}
    stats = P.generate_dataset(str(root / "clean"), str(root / "port"),
                               str(root / "logos"), count=COUNT, seed=1000,
                               device="cpu")
    assert stats["skipped"] == COUNT
    assert sum(v for k, v in stats.items() if k != "skipped") == 0
    after = {n: (root / "port" / "watermarked" / n).stat().st_mtime_ns
             for n in os.listdir(root / "port" / "watermarked")}
    assert after == before


def test_render_text_draws_and_ink_height():
    fonts_j, fonts_p = J.load_system_fonts(), P.load_system_fonts()
    assert fonts_j == fonts_p
    ratios = []
    for seed in range(60):
        rj, rp = random.Random(seed), random.Random(seed)
        text = J.generate_text_content(rj)
        assert P.generate_text_content(rp) == text
        a = np.array(J._render_text(text, fonts_j, rj))[..., 3]
        b = P._render_text(text, fonts_p, rp, "cpu").numpy()[..., 3]
        assert rj.getstate() == rp.getstate()
        hj = np.nonzero(a.any(1))[0]
        hp = np.nonzero(b.any(1))[0]
        ratios.append((np.ptp(hp) + 1) / (np.ptp(hj) + 1))
    assert INK_RATIO[0] <= min(ratios) and max(ratios) <= INK_RATIO[1]
    assert INK_MEDIAN[0] <= np.median(ratios) <= INK_MEDIAN[1]


def test_ocr_mask_cli(dirs, tmp_path):
    root, _ = dirs
    P.main(["--clean-dir", str(root / "clean"), "--output", str(tmp_path),
            "--count", "6", "--seed", "7", "--ocr-mask", "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "watermarked"))
    assert names and all("_text_" in n for n in names)  # no logos given
    plain = tmp_path / "plain"
    P.generate_dataset(str(root / "clean"), str(plain), count=6, seed=7,
                       device="cpu")
    assert sorted(os.listdir(plain / "watermarked")) == names
    for n in names:
        m = os.path.splitext(n)[0] + ".png"
        ocr = image_io.read_gray(tmp_path / "masks" / m) > 0
        geo = image_io.read_gray(plain / "masks" / m) > 0
        assert ocr.any()
        # the refined mask lies inside the footprint's 9 x 9 dilation
        import cv2
        near = cv2.dilate(geo.astype(np.uint8), np.ones((9, 9), np.uint8))
        assert not (ocr & (near == 0)).any()


def test_no_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.generate_dataset("x", "y")
