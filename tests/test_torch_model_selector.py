"""scripts/model_selector.py of the port against the JAX package's: two
checkpoints converted from the same JAX variables (Unet/resnet18, 64²,
float32), the JAX selector reading them as .pth files, the port's as its
own checkpoint directories (tree.npz + meta.json).

Tolerances: the per-image watermark ratios agree within RATIO_TOL (a mask
pixel flips only where the two packages' float32 probabilities straddle
the threshold); the mask PNGs are equal except at pixels whose JAX
probability lies within EPS of the threshold; the best model and every
detection rate are equal. The vmapped forward equals one forward per
checkpoint within VMAP_TOL.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.configs import get_cfg_defaults as port_cfg
from unet_watermark_tpu_torch.scripts import model_selector as pms
from unet_watermark_tpu_torch.utils import image_io, synthetic

EPS = 1e-4
RATIO_TOL = 2e-3
VMAP_TOL = 1e-5


def _cfgs():
    from unet_watermark_tpu.configs import get_cfg_defaults

    out = []
    for c in (get_cfg_defaults(), port_cfg()):
        c.MODEL.NAME, c.MODEL.ENCODER_NAME = "Unet", "resnet18"
        c.MODEL.DTYPE = "float32"
        c.DATA.IMG_SIZE = 64
        out.append(c)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax.numpy as jnp

    from unet_watermark_tpu.models import SMPModelFactory, init_model
    from unet_watermark_tpu.models.torch_import import export_pth
    from unet_watermark_tpu.utils import shipping as jship

    root = tmp_path_factory.mktemp("selector")
    jdir, pdir, images = root / "jax_models", root / "port_models", \
        root / "images"
    for d in (jdir, pdir, images):
        d.mkdir()
    jcfg, _ = _cfgs()
    model = SMPModelFactory.create_model(
        model_name="Unet", encoder_name="resnet18", dtype="float32")
    variables = []
    for seed, shift in ((0, 0.0), (1, 0.4)):
        v = init_model(model, 64, seed=seed)
        params = dict(v["params"])
        head = dict(params["segmentation_head"])
        conv = dict(head["conv"])
        conv["bias"] = jnp.asarray(conv["bias"]) + shift
        head["conv"] = conv
        params["segmentation_head"] = head
        v = {"params": params, "batch_stats": v["batch_stats"]}
        variables.append(v)
        export_pth(str(jdir / f"m{seed}.pth"), jcfg, v["params"],
                   v["batch_stats"])
        ck = pdir / f"m{seed}"
        ck.mkdir()
        flat = {k: np.array(a) for k, a in jship.flatten_tree(v).items()}
        np.savez(ck / "tree.npz", **flat)
        (ck / "meta.json").write_text(json.dumps({"epoch": 1}))
    imgs, _ = synthetic.watermarked_images(5, 96, seed=3)
    u8 = (imgs * 255).astype(np.uint8)
    for i, (h, w) in enumerate(((96, 96), (70, 90), (96, 50), (64, 64),
                                (80, 80))):
        image_io.write_png(images / f"i{i}.png", u8[i][:h, :w])
    return root, model, variables


def test_selection_matches_jax(setup, tmp_path):
    import jax
    import jax.numpy as jnp

    from unet_watermark_tpu.ops.augment import IMAGENET_MEAN, IMAGENET_STD
    from unet_watermark_tpu.scripts.model_selector import ModelSelector

    root, model, variables = setup
    jcfg, pcfg = _cfgs()
    jres = ModelSelector(str(root / "jax_models"), str(root / "images"),
                         str(tmp_path / "jax"), config=jcfg,
                         num_images=4).run_evaluation()
    psel = pms.ModelSelector(str(root / "port_models"), str(root / "images"),
                             str(tmp_path / "port"), config=pcfg,
                             num_images=4, device="cpu")
    pres = psel.run_evaluation()
    assert psel.vmapped
    assert sorted(pres) == sorted(jres)
    assert pres["summary"]["best_detection_model"]["name"] == os.path.splitext(
        jres["summary"]["best_detection_model"]["name"])[0]
    for name in ("m0", "m1"):
        js = jres["models"][name + ".pth"]
        ps = pres["models"][name]
        assert sorted(ps) == sorted(js)
        assert sorted(ps["statistics"]) == sorted(js["statistics"])
        assert ps["statistics"]["detection_rate"] == \
            js["statistics"]["detection_rate"]
        for jp, pp in zip(js["predictions"], ps["predictions"]):
            assert jp["image_name"] == pp["image_name"]
            assert sorted(jp["metrics"]) == sorted(pp["metrics"])
            assert abs(jp["metrics"]["watermark_ratio"]
                       - pp["metrics"]["watermark_ratio"]) <= RATIO_TOL
    # the masks, except where JAX's probability is within EPS of 0.5
    thr = jcfg.PREDICT.THRESHOLD
    for mi, name in enumerate(("m0", "m1")):
        for jp, pp in zip(jres["models"][name + ".pth"]["predictions"],
                          pres["models"][name]["predictions"]):
            img = cv2.cvtColor(cv2.imread(jp["image_path"]),
                               cv2.COLOR_BGR2RGB)
            x = cv2.resize(img, (64, 64)).astype(np.float32) / 255.0
            norm = (jnp.asarray(x[None]) - IMAGENET_MEAN) / IMAGENET_STD
            p = np.asarray(jax.nn.sigmoid(model.apply(
                variables[mi], norm, train=False)))[0, :, :, 0]
            prob = cv2.resize(p, (img.shape[1], img.shape[0]))
            jm = cv2.imread(jp["mask_path"], cv2.IMREAD_GRAYSCALE)
            pm = cv2.imread(pp["mask_path"], cv2.IMREAD_GRAYSCALE)
            near = np.abs(prob - thr) < EPS
            assert np.array_equal(jm[~near], pm[~near]), pp["image_name"]


def test_vmapped_forward_equals_sequential(setup, tmp_path):
    root, _, _ = setup
    _, pcfg = _cfgs()
    sel = pms.ModelSelector(str(root / "port_models"), str(root / "images"),
                            str(tmp_path), config=pcfg, device="cpu")
    models = [sel._load_model(p) for p in sel.discover_checkpoints()]
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    v = sel.forward_all(models, x, vmap=True)
    s = sel.forward_all(models, x, vmap=False)
    assert v.shape == (2, 3, 64, 64)
    assert (v - s).abs().max().item() <= VMAP_TOL


def test_pth_raises(tmp_path):
    """A .pth is listed as JAX lists it (its scoring against JAX's:
    tests/test_torch_pth.py); one that is not a torch file raises when it
    is loaded, as torch.load raises in JAX's import."""
    (tmp_path / "m.pth").write_bytes(b"")
    sel = pms.ModelSelector(str(tmp_path), str(tmp_path), device="cpu")
    assert sel.discover_checkpoints() == [str(tmp_path / "m.pth")]
    with pytest.raises(EOFError):
        sel._load_model(str(tmp_path / "m.pth"))


def test_metrics_equal_cv2():
    rng = np.random.default_rng(0)
    for _ in range(5):
        m = ((rng.random((40, 50)) > 0.7) * 255).astype(np.uint8)
        n, _, stats, _ = cv2.connectedComponentsWithStats((m > 0).astype(
            np.uint8))
        got = pms.calculate_watermark_metrics(torch.from_numpy(m), (40, 50))
        assert got["num_components"] == n - 1
        assert got["max_component_area"] == stats[1:, cv2.CC_STAT_AREA].max()
        assert got["watermark_pixels"] == int((m > 0).sum())
