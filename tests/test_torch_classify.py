"""scripts/classify_image.py and models/dinov2.py against the JAX package
and transformers on the CPU: the histogram features, the DINOv2 ViT with
weights carried from transformers.Dinov2Model (JAX's small config, and a
518² config whose position embeddings are interpolated at 224²), the
loader (a save_pretrained directory, safetensors and .bin), the feature
chain, each package's feature cache read by the other, the clustering
(PCA + KMeans) and the DBSCAN grouping.

Tolerances: histogram features within 1e-6 (float32 sums in another
order); CLS features within 1e-4 (float32 matmuls in another order);
cluster labels exactly equal. Stated difference: the random DINOv2's
weights come from torch.Generator().manual_seed(seed), not from
transformers' unseeded init (the same recipe: checked on the weights'
statistics; the features are compared with JAX's weights carried over)."""
import os

import cv2
import numpy as np
import pytest
import torch
from transformers import BitImageProcessor, Dinov2Config, Dinov2Model

from unet_watermark_tpu.scripts import classify_image as jci
from unet_watermark_tpu_torch.models import dinov2 as tdino
from unet_watermark_tpu_torch.ops import imgproc
from unet_watermark_tpu_torch.scripts import classify_image as tci
from unet_watermark_tpu_torch.utils import safetensors

HIST_ATOL = 1e-6
CLS_ATOL = 1e-4
SMALL = dict(hidden_size=384, num_hidden_layers=4, num_attention_heads=6)


def _image(seed, h=90, w=120):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    if seed % 3 == 0:
        img = cv2.GaussianBlur(img, (9, 9), 3)
    elif seed % 3 == 1:
        img[:, : w // 2] = rng.integers(0, 255)
        img[h // 3:] //= 2
    return img


@pytest.mark.parametrize("seed,shape", [(0, (90, 120)), (1, (128, 128)),
                                        (2, (300, 41)), (3, (64, 200)),
                                        (4, (129, 127))])
def test_hist_features_equal_jax(seed, shape):
    img = _image(seed, *shape)
    want = jci._hist_features(img)
    got = tci._hist_features(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (tci.HIST_DIMS,)
    np.testing.assert_allclose(got.numpy(), want, atol=HIST_ATOL, rtol=0)


def test_sobel_f32_equals_cv2():
    g = cv2.cvtColor(_image(7, 33, 41), cv2.COLOR_RGB2GRAY)
    dx, dy = imgproc.sobel_f32(torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), cv2.Sobel(g, cv2.CV_32F, 1, 0))
    np.testing.assert_array_equal(dy.numpy(), cv2.Sobel(g, cv2.CV_32F, 0, 1))


def _carried(hf):
    port = tdino.Dinov2Model(tdino.Dinov2Config.from_dict(
        hf.config.to_dict()))
    n = tdino.load_state(port, {k: v.numpy()
                                for k, v in hf.state_dict().items()})
    assert n == len(hf.state_dict())
    return port.eval()


@pytest.mark.parametrize("kwargs", [SMALL, dict(hidden_size=64,
                                                num_hidden_layers=2,
                                                num_attention_heads=4,
                                                image_size=518)])
def test_vit_cls_features_equal_transformers(kwargs, tmp_path):
    torch.manual_seed(0)
    hf = Dinov2Model(Dinov2Config(**kwargs)).eval()
    x = torch.randn(2, 3, 224, 224)
    with torch.no_grad():
        want = hf(pixel_values=x).last_hidden_state
        got = _carried(hf)(x)
    assert got.shape == want.shape
    torch.testing.assert_close(got[:, 0], want[:, 0], atol=CLS_ATOL, rtol=0)
    hf.save_pretrained(tmp_path / "st")
    hf.save_pretrained(tmp_path / "bin", safe_serialization=False)
    for sub in ("st", "bin"):
        loaded = tdino.load_dinov2(str(tmp_path / sub), device="cpu")
        with torch.no_grad():
            torch.testing.assert_close(loaded.cls_features(x), want[:, 0],
                                       atol=CLS_ATOL, rtol=0)


def test_safetensors_reader_reads_every_tensor(tmp_path):
    from safetensors.numpy import save_file

    arrs = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.array([1, -2], np.int64), "c": np.zeros((0,), np.uint8),
            "d": np.array([0.5, 2.0], np.float16)}
    save_file(arrs, str(tmp_path / "x.safetensors"))
    got = safetensors.load(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(arrs)
    for k, v in arrs.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    hf = Dinov2Model(Dinov2Config(hidden_size=32, num_hidden_layers=1,
                                  num_attention_heads=2)).to(torch.bfloat16)
    hf.save_pretrained(tmp_path / "bf16")
    got = safetensors.load(tmp_path / "bf16" / "model.safetensors")
    w = hf.state_dict()["embeddings.position_embeddings"].float().numpy()
    np.testing.assert_array_equal(got["embeddings.position_embeddings"], w)


def test_loader_reads_the_hub_cache_layout(tmp_path, monkeypatch):
    hf = Dinov2Model(Dinov2Config(hidden_size=32, num_hidden_layers=1,
                                  num_attention_heads=2)).eval()
    snap = tmp_path / "hub" / "models--org--tiny" / "snapshots" / "abc123"
    hf.save_pretrained(snap)
    (tmp_path / "hub" / "models--org--tiny" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--tiny" / "refs" / "main").write_text(
        "abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert tdino.resolve("org/tiny") == snap
    x = torch.randn(1, 3, 56, 56)
    with torch.no_grad():
        torch.testing.assert_close(
            tdino.load_dinov2("org/tiny", "cpu").cls_features(x),
            hf(pixel_values=x).last_hidden_state[:, 0], atol=CLS_ATOL,
            rtol=0)
    with pytest.raises(FileNotFoundError):
        tdino.resolve("org/absent")
    with pytest.raises(FileNotFoundError):  # no preprocessor_config.json
        tdino.load_dinov2("org/tiny", "cpu", require_processor=True)


def test_extractor_chain_and_features_equal_jax(tmp_path):
    """Without local weights both chains give the random small DINOv2; with
    JAX's random weights carried over, the same features. Given a directory
    with a processor config, both load it."""
    jfe = jci.FeatureExtractor(model_name=str(tmp_path / "absent"))
    tfe = tci.FeatureExtractor(model_name=str(tmp_path / "absent"),
                               device="cpu")
    assert jfe.backend == tfe.backend == "dinov2-random"
    tfe._model = _carried(jfe._model)
    for seed in (0, 1):
        img = _image(seed, 100, 130)
        np.testing.assert_allclose(tfe.extract(torch.from_numpy(img)),
                                   jfe.extract(img), atol=CLS_ATOL, rtol=0)
    hf = Dinov2Model(Dinov2Config(hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=4,
                                  image_size=518)).eval()
    hf.save_pretrained(tmp_path / "pre")
    BitImageProcessor().save_pretrained(tmp_path / "pre")
    jfe = jci.FeatureExtractor(model_name=str(tmp_path / "pre"))
    tfe = tci.FeatureExtractor(model_name=str(tmp_path / "pre"),
                               device="cpu")
    assert jfe.backend == tfe.backend == "dinov2"
    img = _image(3, 70, 90)
    np.testing.assert_allclose(tfe.extract(torch.from_numpy(img)),
                               jfe.extract(img), atol=CLS_ATOL, rtol=0)
    hist = tci.FeatureExtractor(str(tmp_path / "absent"),
                                allow_random_init=False, device="cpu")
    assert hist.backend == "hist"


def test_random_dinov2_is_seeded_with_transformers_recipe():
    """The stated difference: other draws, the same recipe and shapes."""
    cfg = tdino.Dinov2Config(**SMALL)
    a = tdino.model_from_config(cfg, 0, "cpu")
    b = tdino.model_from_config(cfg, 0, "cpu")
    c = tdino.model_from_config(cfg, 1, "cpu")
    hf = Dinov2Model(Dinov2Config(**SMALL))
    sa, sh = a.state_dict(), hf.state_dict()
    assert {k: tuple(v.shape) for k, v in sa.items()} == \
        {k: tuple(v.shape) for k, v in sh.items()}
    for k in sa:
        torch.testing.assert_close(sa[k], b.state_dict()[k], atol=0, rtol=0)
        if k.endswith("query.weight"):
            assert not torch.equal(sa[k], c.state_dict()[k])
            assert abs(float(sa[k].std()) - float(sh[k].std())) < 2e-3
        if "norm" in k or k.endswith(("bias", "lambda1", "mask_token")):
            torch.testing.assert_close(sa[k], sh[k], atol=0, rtol=0)


def _folder(root, n=20):
    root.mkdir()
    colours = [(200, 40, 40), (40, 200, 40), (40, 40, 200)]
    rng = np.random.default_rng(0)
    for i in range(n):
        base = np.array(colours[i % 3], np.float64)
        img = np.clip(base + rng.normal(0, 25, (48, 64, 3)), 0, 255)
        cv2.imwrite(str(root / f"im{i:02d}.png"), img.astype(np.uint8))
    (root / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")


def _hist_pair():
    return (jci.FeatureExtractor("absent-model", allow_random_init=False),
            tci.FeatureExtractor("absent-model", allow_random_init=False,
                                 device="cpu"))


def test_clusters_and_groups_equal_jax(tmp_path):
    _folder(tmp_path / "in")
    jfe, tfe = _hist_pair()
    jc = jci.StableImageClassifier(jfe, seed=42)
    tc = tci.StableImageClassifier(tfe, seed=42)
    folder = str(tmp_path / "in")
    for pca_dims in (16, 64):
        want = jc.stable_cluster_images(folder, 3, pca_dims=pca_dims)
        got = tc.stable_cluster_images(folder, 3, pca_dims=pca_dims)
        assert got == want and len(set(got.values())) == 3
    assert tci.dbscan_group(folder, 0.05, 2, extractor=tfe) == \
        jci.dbscan_group(folder, 0.05, 2, extractor=jfe)
    tc.copy_clusters(got, str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == [
        f"cluster_{c}" for c in sorted(set(got.values()))]
    videos = tc.cluster_videos({p: c for p, c in list(got.items())[:4]},
                               str(tmp_path / "videos"))
    assert all(os.path.getsize(v) > 0 for v in videos)


def test_each_package_reads_the_others_cache(tmp_path):
    _folder(tmp_path / "in", 6)
    paths = sorted(str(p) for p in (tmp_path / "in").iterdir())
    jfe, tfe = _hist_pair()
    jci.StableImageClassifier(jfe, str(tmp_path / "j.npz"))._features_for(
        paths)
    tci.StableImageClassifier(tfe, str(tmp_path / "t.npz"))._features_for(
        paths)
    reader_t = tci.StableImageClassifier(tfe, str(tmp_path / "j.npz"))
    reader_j = jci.StableImageClassifier(jfe, str(tmp_path / "t.npz"))
    assert sorted(reader_t._cache) == sorted(reader_j._cache) == sorted(
        os.path.abspath(p) for p in paths)
    for k in reader_t._cache:
        assert reader_t._cache[k].dtype == np.float32
        np.testing.assert_allclose(reader_t._cache[k], reader_j._cache[k],
                                   atol=HIST_ATOL, rtol=0)
    broken = os.path.abspath(str(tmp_path / "in" / "broken.png"))
    np.testing.assert_array_equal(reader_t._cache[broken], np.zeros(112))
