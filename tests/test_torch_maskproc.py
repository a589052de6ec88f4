"""The port's type-aware mask strategies, partitioned batch, component
stats and watermark-type detection against the JAX package's
inference/maskproc.py and ops/components.py (binary masks at 64² and 100²).

Tolerances: every mask and every component statistic must be equal. The
type score is a sum of band values picked by sharp thresholds on float32
quantities (a Sobel magnitude > 100, the angle variance, area ratios);
the two sides compute the Sobel and arctan2 in another order, so the score
is held within SCORE_ATOL and the class exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.inference import maskproc as jmp
from unet_watermark_tpu.ops import components as jc
from unet_watermark_tpu_torch.inference import maskproc as tmp
from unet_watermark_tpu_torch.ops import components as tc
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

SCORE_ATOL = 1e-5
SIZES = (64, 100)


def _masks(s):
    """(6, s, s) float32: random at three densities, blobs (discs and
    rectangles with speckle), and foreground on every border."""
    rng = np.random.default_rng(s)
    rand = [rng.random((s, s)) < p for p in (0.2, 0.35, 0.5)]
    yy, xx = np.mgrid[0:s, 0:s]
    blobs = []
    for _ in range(2):
        mk = rng.random((s, s)) < 0.03
        for _ in range(6):
            cy, cx = rng.integers(0, s, 2)
            r = rng.integers(2, s // 5)
            if rng.random() < 0.5:
                mk |= np.hypot(yy - cy, xx - cx) < r
            else:
                mk |= (abs(yy - cy) < r) & (abs(xx - cx) < r // 2 + 1)
        blobs.append(mk)
    border = np.zeros((s, s), bool)
    border[:10, :10] = border[-10:, -10:] = border[s // 2:s // 2 + 9, :7] = 1
    border[:6, s // 2:s // 2 + 20] = border[:, -3:] = 1
    return np.stack(rand + blobs + [border]).astype(np.float32)


MASKS = {s: _masks(s) for s in SIZES}


@functools.lru_cache(maxsize=None)
def _jax_strategy(mask_type, mode):
    return jax.jit(jax.vmap(lambda mk: jmp.optimize_mask(mk, mask_type, mode)))


def _jax_optimize(masks, mask_type, mode):
    # text and mixed do not depend on the mode: one compile serves both
    mode = mode if mask_type == "watermark" else "parity"
    return np.asarray(_jax_strategy(mask_type, mode)(jnp.asarray(masks)))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", ["parity", "tight"])
@pytest.mark.parametrize("mask_type", ["watermark", "text", "mixed"])
def test_optimize_mask_matches_jax(mask_type, mode, size):
    masks = MASKS[size]
    ref = _jax_optimize(masks, mask_type, mode)
    ours = tmp.optimize_mask(torch.from_numpy(masks), mask_type, mode)
    assert ours.dtype == torch.float32 and ref.sum() > 0
    np.testing.assert_array_equal(ours.numpy(), ref)
    single = tmp.optimize_mask(torch.from_numpy(masks[-1]), mask_type, mode)
    np.testing.assert_array_equal(single.numpy(), ref[-1])


@pytest.mark.parametrize("size", SIZES)
def test_strategies_match_their_jax_functions(size):
    masks = torch.from_numpy(MASKS[size])
    for ours, ref in ((tmp.optimize_text_mask, jmp.optimize_text_mask),
                      (tmp.optimize_mixed_mask, jmp.optimize_mixed_mask)):
        np.testing.assert_array_equal(
            ours(masks).numpy(),
            _jax_optimize(MASKS[size], ours.__name__.split("_")[1], "parity"))
        np.testing.assert_array_equal(
            ours(masks[1]).numpy(), np.asarray(ref(jnp.asarray(MASKS[size][1]))))


@pytest.mark.parametrize("size", SIZES)
def test_batched_tight_chain_equals_per_image(size):
    masks = torch.from_numpy(MASKS[size])
    batched = tmp.optimize_watermark_mask_tight(masks)
    for i, mk in enumerate(masks):
        assert torch.equal(batched[i], tmp.optimize_watermark_mask_tight(mk))


CODES = [0, 1, 2, 2, 0, 1]


@pytest.mark.parametrize("mode", ["parity", "tight"])
def test_partitioned_matches_jax(mode):
    masks = MASKS[64]
    ref = jmp.optimize_mask_batch_partitioned(masks, CODES, mode=mode)
    ours = tmp.optimize_mask_batch_partitioned(torch.from_numpy(masks), CODES,
                                               mode=mode)
    assert ours.dtype == torch.float32 and ours.shape == masks.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    names = {v: k for k, v in tmp.TYPE_CODES.items()}
    for i, c in enumerate(CODES):
        one = tmp.optimize_mask(torch.from_numpy(masks[i]), names[c], mode)
        assert torch.equal(ours[i], one)


def test_partitioned_one_code_and_errors():
    masks = torch.from_numpy(MASKS[100][:3])
    out = tmp.optimize_mask_batch_partitioned(masks, np.array([2, 2, 2]))
    assert torch.equal(out, tmp.optimize_mixed_mask(masks))
    with pytest.raises(ValueError, match="codes"):
        tmp.optimize_mask_batch_partitioned(masks, [0, 1])


@pytest.mark.parametrize("size", SIZES)
def test_component_stats_and_count_match_jax(size):
    masks = MASKS[size]
    labels = tc.label_components(torch.from_numpy(masks))
    batched = tc.component_stats(labels)
    counts = tc.count_components(torch.from_numpy(masks))
    assert counts.shape == (len(masks),)
    jstats = jax.jit(lambda mk: jc.component_stats(jc.label_components(mk)))
    jcount = jax.jit(jc.count_components)
    for i, mk in enumerate(masks):
        ref = jstats(jnp.asarray(mk))
        ours = tc.component_stats(labels[i])
        for k in ("area", "width", "height", "exists"):
            assert ours[k].shape == (size * size + 1,)
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(batched[k][i].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
        n = int(jcount(jnp.asarray(mk)))
        assert int(tc.count_components(torch.from_numpy(mk))) == n
        assert int(counts[i]) == n
    assert int(counts.sum()) > len(masks)


def _type_cases(s=100):
    """(images (n, s, s, 3) in [0, 255], masks (n, s, s), case names): rows
    of letter-sized rectangles, long bars, a square blob, thin strokes, and
    the random and blob masks, each over a smooth synthetic image and over
    uniform noise."""
    rng = np.random.default_rng(0)
    noise = np.round(rng.random((s, s, 3)) * 255)
    smooth = np.round(watermarked_images(1, s, seed=1)[0][0] * 255)

    def rects(n, h, w):
        mk = np.zeros((s, s), np.float32)
        for i in range(n):
            mk[40:40 + h, 5 + i * (w + 4):5 + i * (w + 4) + w] = 1
        return mk

    bars = np.zeros((s, s), np.float32)
    bars[10:12, 5:95] = bars[50:52, 5:95] = 1
    blob = np.zeros((s, s), np.float32)
    blob[20:80, 20:80] = 1
    shapes = {"rects6": rects(6, 12, 10), "rects2": rects(2, 12, 10),
              "bars": bars, "blob": blob, "strokes": rects(6, 3, 10),
              "empty": np.zeros((s, s), np.float32),
              "random": MASKS[s][0], "blobs": MASKS[s][3]}
    images, masks, names = [], [], []
    for iname, img in (("smooth", smooth), ("noise", noise)):
        for mname, mk in shapes.items():
            images.append(img)
            masks.append(mk)
            names.append(f"{mname}/{iname}")
    return (np.stack(images).astype(np.float32),
            np.stack(masks).astype(np.float32), names)


@pytest.fixture(scope="module")
def type_scores():
    images, masks, names = _type_cases()
    jfn = jax.jit(jax.vmap(jmp.detect_watermark_type_scores))
    ref = np.asarray(jfn(jnp.asarray(images), jnp.asarray(masks)))
    ours = tmp.detect_watermark_type_scores(torch.from_numpy(images),
                                            torch.from_numpy(masks))
    return images, masks, names, ref, ours


def test_type_scores_match_jax(type_scores):
    _, _, names, ref, ours = type_scores
    assert ours.shape == (len(names),) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=SCORE_ATOL)
    classes = [tmp.classify_type(float(x)) for x in ours]
    assert classes == [jmp.classify_type(float(x)) for x in ref]
    # the cases reach all three classes, so each class is held equal
    assert set(classes) == {"watermark", "text", "mixed"}
    assert classes[names.index("empty/smooth")] == "watermark"
    assert float(ours[names.index("empty/noise")]) == 0.0


def test_type_scores_single_image_equals_batch(type_scores):
    images, masks, _, _, ours = type_scores
    for i in (0, 3, 9):
        one = tmp.detect_watermark_type_scores(torch.from_numpy(images[i]),
                                               torch.from_numpy(masks[i]))
        assert one.shape == () and float(one) == float(ours[i])


@pytest.mark.parametrize("score", [0.0, 0.3, 0.30001, 0.5, 0.7, 0.70001, 1.0])
def test_classify_and_codes_match_jax(score):
    name = tmp.classify_type(score)
    assert name == jmp.classify_type(score)
    assert tmp.type_code(name) == jmp.type_code(name)
