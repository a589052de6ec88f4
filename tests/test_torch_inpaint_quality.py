"""scripts/inpaint_quality.evaluate_engines of the port against the JAX
package's, push-pull and LaMa (the shipped weights), on the same clean
crops (load_clean_batches: JAX's numpy draws in both) and the same holes.

The port draws its holes from a torch.Generator where JAX draws them from
jax.random (a stated difference of the draw only): the test hands the
port's evaluate_engines JAX's masks. The scores are means over the
batches, rounded as JAX rounds them (2 decimals of dB, 4 of SSIM): the
push-pull fill is the same float32 arithmetic in both and its scores are
held within PSNR_TOL_PP / SSIM_TOL; JAX's LaMa generator runs its convs
in another order than torch's, held within PSNR_TOL_LAMA (both engines'
rounded scores measured equal to JAX's here).
"""
import json

import jax
import numpy as np
import pytest
import torch

from unet_watermark_tpu.scripts.inpaint_quality import \
    evaluate_engines as jeval
from unet_watermark_tpu.training.train_inpaint import \
    random_mask_batch as jmasks
from unet_watermark_tpu_torch.scripts import inpaint_quality as piq
from unet_watermark_tpu_torch.utils import image_io, synthetic

PSNR_TOL_PP, PSNR_TOL_LAMA, SSIM_TOL = 0.02, 0.05, 2e-4
SIZE, BATCH, LIMIT, SEED = 64, 4, 8, 3


@pytest.fixture(scope="module")
def clean_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clean")
    imgs, _ = synthetic.watermarked_images(3, 96, seed=4, clean=3)
    for i, im in enumerate((imgs * 255).astype(np.uint8)):
        image_io.write_png(d / f"c{i}.png", im[:80 + 8 * i, :96])
    return str(d)


def _jax_masks():
    key = jax.random.PRNGKey(SEED + 1)
    out = []
    for _ in range(LIMIT // BATCH):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jmasks(sub, BATCH, SIZE)))
    return out


@pytest.fixture(scope="module")
def results(clean_dir):
    masks = iter(_jax_masks())
    real = piq.random_mask_batch
    piq.random_mask_batch = lambda gen, n, size, device: torch.from_numpy(
        np.array(next(masks))).to(device)
    try:
        port = piq.evaluate_engines(clean_dir, ["pushpull", "lama"],
                                    img_size=SIZE, batch_size=BATCH,
                                    limit=LIMIT, seed=SEED, device="cpu")
    finally:
        piq.random_mask_batch = real
    want = jeval(clean_dir, ["pushpull", "lama"], img_size=SIZE,
                 batch_size=BATCH, limit=LIMIT, seed=SEED)
    return port, want


def test_scores_match_jax(results):
    port, want = results
    assert sorted(port) == sorted(want) == ["lama", "pushpull", "weights"]
    assert port["weights"] == want["weights"]
    for name, tol in (("pushpull", PSNR_TOL_PP), ("lama", PSNR_TOL_LAMA)):
        p, j = port[name], want[name]
        assert p["n_images"] == j["n_images"] == LIMIT
        assert abs(p["hole_psnr_db"] - j["hole_psnr_db"]) <= tol, name
        assert abs(p["ssim"] - j["ssim"]) <= SSIM_TOL, name
    assert port["lama"]["hole_psnr_db"] > 10  # the fill did something


def test_masks_follow_the_recipe_and_the_seed(clean_dir):
    """Without the patch: the port's own holes, drawn from the generator
    seeded with seed + 1: the same scores on a second run, other holes for
    another seed, and every batch's hole share in the recipe's range."""
    kw = dict(img_size=SIZE, batch_size=BATCH, limit=LIMIT, device="cpu")
    a = piq.evaluate_engines(clean_dir, ["pushpull"], seed=SEED, **kw)
    b = piq.evaluate_engines(clean_dir, ["pushpull"], seed=SEED, **kw)
    c = piq.evaluate_engines(clean_dir, ["pushpull"], seed=SEED + 5, **kw)
    assert a == b and a != c
    gen = torch.Generator().manual_seed(1)
    share = piq.random_mask_batch(gen, 16, SIZE, "cpu").mean().item()
    assert 0.02 < share < 0.6


def test_main_writes_json(clean_dir, tmp_path):
    out = tmp_path / "r.json"
    piq.main(["--clean-dir", clean_dir, "--engines", "pushpull",
              "--img-size", str(SIZE), "--batch-size", "2", "--limit", "2",
              "--output", str(out), "--device", "cpu"])
    r = json.loads(out.read_text())
    assert r["pushpull"]["n_images"] == 2 and "weights" in r
