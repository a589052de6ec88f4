"""The port's data path against the JAX package's WatermarkDataset,
create_datasets, DecodedCache and pipelines, on folders the test writes
with cv2: PNG and JPEG images of other sizes than IMG_SIZE (so the
resizes run), mask files, masks made from the clean images (and cached
as PNGs), a file cv2 cannot read, and the seeded split. Pixels must be
equal: the reads are cv2.imread's, the resizes cv2's, the generated
masks cv2's bytes."""
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from unet_watermark_tpu.configs import get_cfg_defaults as jax_defaults
from unet_watermark_tpu.data import dataset as jds
from unet_watermark_tpu.data import pipeline as jpl
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.data import dataset as tds
from unet_watermark_tpu_torch.data import decoded_cache as tdc
from unet_watermark_tpu_torch.data import pipeline as tpl
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

SIZE = 48


def _write(path, rgb):
    cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 90])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """ROOT/{watermarked,clean,masks}: 12 images (PNG and JPEG, 40-72 px a
    side), clean copies of 7 and one that does not decode, mask files for
    4 (one of another size), and a file that is not an image."""
    root = tmp_path_factory.mktemp("data")
    for sub in ("watermarked", "clean", "masks"):
        (root / sub).mkdir()
    sizes = [(40, 56), (72, 64), (48, 48), (64, 40), (56, 72), (48, 64)]
    for i in range(12):
        h, w = sizes[i % len(sizes)]
        marked, logos = watermarked_images(1, max(h, w), seed=i)
        clean, _ = watermarked_images(1, max(h, w), seed=i, clean=1)
        to_u8 = lambda x: np.rint(x[0, :h, :w] * 255).astype(np.uint8)  # noqa
        ext = ".jpg" if i % 3 == 0 else ".png"
        _write(root / "watermarked" / f"im{i:02d}{ext}", to_u8(marked))
        if i < 7:
            _write(root / "clean" / f"im{i:02d}{ext}", to_u8(clean))
        if i == 7:  # a clean copy that does not decode: a zero mask
            (root / "clean" / f"im{i:02d}{ext}").write_bytes(b"\x89PNG?")
        if 8 <= i < 12:
            m = (logos[0, :h, :w] > 0.5).astype(np.uint8) * 255
            if i == 9:  # a mask file of another size than its image
                m = cv2.resize(m, (w + 8, h - 4),
                               interpolation=cv2.INTER_NEAREST)
            cv2.imwrite(str(root / "masks" / f"im{i:02d}.png"), m)
    (root / "watermarked" / "broken.png").write_bytes(b"not an image")
    (root / "watermarked" / "notes.txt").write_text("skipped by extension")
    return root


def _copy(root, dst):
    shutil.copytree(root, dst)
    return dst


def _datasets(path, size=SIZE, threshold=30):
    dirs = [[str(path / s)] for s in ("watermarked", "clean", "masks")]
    kw = dict(img_size=size, generate_mask_threshold=threshold)
    return (tds.WatermarkDataset(*dirs, device="cpu", **kw),
            jds.WatermarkDataset(*dirs, **kw))


def test_samples_equal_jax(root, tmp_path):
    """Every index: the image (read, RGB, INTER_LINEAR to SIZE) and the
    mask (a file, INTER_NEAREST, or made from the clean image, or zeros)
    equal JAX's, bytes for bytes; the unreadable file gives the next
    index as in JAX; the generated masks are cached as PNGs with equal
    pixels."""
    port_root = _copy(root, tmp_path / "port")
    jax_root = _copy(root, tmp_path / "jax")
    t, _ = _datasets(port_root)
    _, j = _datasets(jax_root)
    assert [os.path.basename(p) for p in t.image_files] == \
        [os.path.basename(p) for p in j.image_files]
    assert len(t) == 13  # 12 images and broken.png
    for i in range(len(t)):
        (ti, tm), (ji, jm) = t[i], j[i]
        assert ti.dtype == np.uint8 and ti.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(ti, ji, err_msg=str(i))
        np.testing.assert_array_equal(tm, jm, err_msg=str(i))
    made = sorted(os.listdir(port_root / "masks"))
    assert made == sorted(os.listdir(jax_root / "masks"))
    assert len(made) == 11  # 4 given, 7 made from the clean images
    for name in made:
        np.testing.assert_array_equal(
            cv2.imread(str(port_root / "masks" / name), 0),
            cv2.imread(str(jax_root / "masks" / name), 0), err_msg=name)


@pytest.mark.parametrize("threshold", [5, 15, 30])
@pytest.mark.parametrize("seed", range(3))
def test_generate_mask_equals_cv2(seed, threshold):
    """absdiff → gray → threshold → open(3x3 ellipse) → blur(3x3, 0.5) →
    threshold 127 on speckled differences (isolated pixels, thin lines,
    blobs), a clean image of another size too: JAX's cv2 bytes."""
    rng = np.random.default_rng(seed)
    h, w = 37, 53
    clean = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    marked = clean.copy()
    speck = rng.random((h, w)) < 0.15
    marked[speck] = rng.integers(0, 256, (int(speck.sum()), 3))
    marked[10:20, 5:30] = np.clip(marked[10:20, 5:30].astype(int) + 60,
                                  0, 255)
    t = tds.WatermarkDataset([], device="cpu",
                             generate_mask_threshold=threshold)
    j = jds.WatermarkDataset([], generate_mask_threshold=threshold)
    for c in (clean, cv2.resize(clean, (w + 7, h - 5))):
        want = j.generate_mask(marked, c)
        got = t.generate_mask(torch.from_numpy(marked), torch.from_numpy(c))
        np.testing.assert_array_equal(got.numpy(), want)


def _cfg_pair(path, size=SIZE):
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    for c in (cfg, jcfg):
        c.DATA.ROOT_DIR = str(path)
        c.DATA.IMG_SIZE = size
        c.DATA.CACHE_DIR = str(path / "cache")
        c.TRAIN.BATCH_SIZE = 4
    return cfg, jcfg


def test_split_and_decoded_cache_equal_jax(root, tmp_path):
    """create_datasets: the same train and val indices (random.Random(SEED)
    over the sorted files, TRAIN_RATIO), both behind a DecodedCache whose
    directory (fingerprint) and layout are JAX's: the port reads the
    slots JAX's cache wrote."""
    path = _copy(root, tmp_path / "d")
    cfg, jcfg = _cfg_pair(path)
    tt, tv = tds.create_datasets(cfg, device="cpu")
    jt, jv = jds.create_datasets(jcfg)
    assert tt.indices == jt.indices and tv.indices == jv.indices
    assert isinstance(tt.dataset, tdc.DecodedCache)
    assert tt.dataset.dir == jt.dataset.dir  # one fingerprint, one dir
    for i in range(len(jt)):  # JAX fills the slots
        jt[i]
    fresh = tdc.DecodedCache(tds.WatermarkDataset(
        [str(path / "watermarked")], [str(path / "clean")],
        [str(path / "masks")], img_size=SIZE, device="cpu"),
        str(path / "cache"))
    assert fresh.dir == jt.dataset.dir
    assert fresh.present.sum() == len(jt)
    for i in jt.indices:
        for a, b in zip(fresh[i], jt.dataset[i]):
            np.testing.assert_array_equal(a, b)
    # another size: another fingerprint
    other = tdc.DecodedCache(tds.WatermarkDataset(
        [str(path / "watermarked")], img_size=32, device="cpu"),
        str(path / "cache"))
    assert other.dir != fresh.dir


def test_decoded_cache_is_off_where_configured(root, tmp_path):
    cfg, _ = _cfg_pair(_copy(root, tmp_path / "d"))
    cfg.DATA.CACHE_DECODED = False
    tt, _ = tds.create_datasets(cfg, device="cpu")
    assert isinstance(tt.dataset, tds.WatermarkDataset)


def _batches(pipe):
    out = []
    for b in pipe:
        out.append({k: np.asarray(v) for k, v in b.items()})
    return out


@pytest.mark.parametrize("bs", [4, 5])
def test_pipelines_equal_jax(root, tmp_path, bs):
    """Two epochs of the card-resident pipeline and of the host pipeline:
    the same batches as JAX's DeviceDataPipeline, shuffled by
    default_rng(seed + epoch), the short last batch padded with index 0
    and marked in `valid`; masks bit-packed (48 = 6 bytes a row) and
    unpacked on the device."""
    path = _copy(root, tmp_path / "d")
    cfg, jcfg = _cfg_pair(path)
    tt, _ = tds.create_datasets(cfg, device="cpu")
    jt, _ = jds.create_datasets(jcfg)
    jpipe = jpl.DeviceDataPipeline(jt, bs, shuffle=True, seed=7)
    tdev = tpl.DeviceDataPipeline(tt, bs, "cpu", shuffle=True, seed=7)
    thost = tpl.DataPipeline(tt, bs, "cpu", shuffle=True, seed=7,
                             num_workers=2)
    for _ in range(2):
        want = _batches(jpipe)
        for got in (_batches(tdev), _batches(thost)):
            assert len(got) == len(want) == -(-len(tt) // bs)
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                    assert g[k].dtype == w[k].dtype, k
    assert tdev.masks_packed and jpipe.masks_packed


def test_unpack_mask_bits_inverts_packbits():
    bits = (np.random.default_rng(2).random((3, 16, 40)) < 0.4
            ).astype(np.uint8)
    got = tpl.unpack_mask_bits(torch.from_numpy(np.packbits(bits, -1)))
    np.testing.assert_array_equal(got.numpy(), bits)


def test_make_pipelines_selects_the_resident_one(root, tmp_path):
    cfg, _ = _cfg_pair(_copy(root, tmp_path / "d"))
    tt, tv = tds.create_datasets(cfg, device="cpu")
    train, val = tpl.make_pipelines(cfg, tt, tv, "cpu")
    assert isinstance(train, tpl.DeviceDataPipeline) and train.shuffle
    assert isinstance(val, tpl.DeviceDataPipeline) and not val.shuffle
    cfg.DATA.DEVICE_CACHE_MB = 0
    train, val = tpl.make_pipelines(cfg, tt, tv, "cpu")
    assert isinstance(train, tpl.DataPipeline)
    cfg.DATA.DEVICE_CACHE_MB, cfg.DATA.DEVICE_CACHE = 3072, False
    assert isinstance(tpl.make_pipelines(cfg, tt, tv, "cpu")[0],
                      tpl.DataPipeline)


def test_host_pipeline_stops_its_threads_on_an_early_break(root, tmp_path):
    import threading

    cfg, _ = _cfg_pair(_copy(root, tmp_path / "d"))
    tt, _ = tds.create_datasets(cfg, device="cpu")
    before = threading.active_count()
    pipe = tpl.DataPipeline(tt, 2, "cpu", num_workers=2, prefetch=1)
    for _ in pipe:
        break
    import time
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before


def test_unported_formats_refuse_the_folder(tmp_path):
    """A BMP or TIFF file, which JAX's IMAGE_EXTENSIONS admits and cv2
    reads, makes the port refuse the folder before any work (naming the
    ROADMAP.md item), not skip the file silently."""
    for ext in (".bmp", ".tif"):
        d = tmp_path / ext[1:] / "watermarked"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "a.png"), np.zeros((8, 8, 3), np.uint8))
        cv2.imwrite(str(d / f"b{ext}"), np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(NotImplementedError, match="§A.5"):
            tds.WatermarkDataset([str(d)], device="cpu")


def test_blurred_masks_raise():
    """use_blurred_mask is no longer refused (its masks against JAX's:
    tests/test_torch_blurred_mask.py): the dataset builds on the CPU, and
    without a card its default device raises, as every entry point's."""
    ds = tds.WatermarkDataset([], use_blurred_mask=True, device="cpu")
    assert ds.use_blurred_mask and len(ds) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tds.WatermarkDataset([], use_blurred_mask=True)


def test_an_unreadable_folder_raises(tmp_path):
    d = tmp_path / "watermarked"
    d.mkdir()
    (d / "x.png").write_bytes(b"nothing")
    t = tds.WatermarkDataset([str(d)], device="cpu")
    with pytest.raises(RuntimeError, match="no readable images"):
        t[0]


@pytest.mark.parametrize("entry", ["WatermarkDataset", "create_datasets"])
def test_the_data_entry_points_default_to_the_card(root, monkeypatch, entry):
    """Called without `device`, both entry points put their work on "cuda";
    without a card that raises rather than decoding on the host."""
    cfg = get_cfg_defaults()
    cfg.DATA.ROOT_DIR = str(root)
    cfg.DATA.CACHE_DECODED = False

    def build():
        if entry == "create_datasets":
            return tds.create_datasets(cfg)[0].dataset
        return tds.WatermarkDataset([str(root / "watermarked")])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert build().device == torch.device("cuda")
