"""The port's connected components against the JAX package's, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.ops import components as jc
from unet_watermark_tpu_torch.ops import components as tc

torch.set_num_threads(2)


def _random(seed, s=48, p=0.45):
    return (np.random.default_rng(seed).random((s, s)) < p).astype(np.float32)


def _spiral(s=40):
    """One 1-px corridor spiralling inward: the component's least index is
    at the outside, far along the path from the centre."""
    mk = np.zeros((s, s), np.float32)
    top, left, bottom, right = 0, 0, s - 1, s - 1
    while top <= bottom and left <= right:
        mk[top, left:right + 1] = 1
        mk[top:bottom + 1, right] = 1
        if top + 2 <= bottom:
            mk[bottom, left:right + 1] = 1
        if left + 2 <= right and top + 2 <= bottom:
            mk[top + 2:bottom + 1, left] = 1
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        if top <= bottom:
            mk[top - 1, left] = 1  # step in to the next ring
    return mk


def _blocks(sizes, s=64):
    """Disjoint squares of the given areas (side = sqrt(area)), in a row
    order that gives each a known least linear index."""
    mk = np.zeros((s, s), np.float32)
    x = 0
    for a in sizes:
        side = int(round(a ** 0.5))
        mk[1:1 + side, x:x + side] = 1
        x += side + 1
    return mk


MASKS = {"rand0": _random(0), "rand1": _random(1, p=0.6),
         "sparse": _random(2, p=0.2), "spiral": _spiral(),
         "empty": np.zeros((32, 32), np.float32),
         "full": np.ones((32, 32), np.float32)}


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_labels_match_jax(name, connectivity):
    mk = MASKS[name]
    ours = tc.label_components(torch.from_numpy(mk), connectivity)
    ref = jc.label_components(jnp.asarray(mk), connectivity)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tc.component_areas(ours).numpy(),
        np.asarray(jc.component_areas(ref)))


def test_spiral_needs_many_rounds():
    """The spiral does not converge in a few rounds: a capped run differs
    from the fixpoint, and the fixpoint is one component."""
    mk = torch.from_numpy(MASKS["spiral"])
    full = tc.label_components(mk)
    assert torch.unique(full[full > 0]).numel() == 1
    capped = tc.label_components(mk, max_rounds=3)
    assert not torch.equal(capped, full)
    np.testing.assert_array_equal(
        capped.numpy(),
        np.asarray(jc.label_components(jnp.asarray(MASKS["spiral"]),
                                       max_rounds=3)))


def test_batch_labels_equal_single_image_labels():
    masks = np.stack([MASKS["rand0"], np.pad(MASKS["spiral"], (0, 8)),
                      MASKS["sparse"]])
    ours = tc.label_components(torch.from_numpy(masks))
    for i, mk in enumerate(masks):
        np.testing.assert_array_equal(
            ours[i].numpy(), tc.label_components(torch.from_numpy(mk)).numpy())


@pytest.mark.parametrize("case,sizes", [
    ("largest-wins", [100, 900, 400]),   # largest >= 500: keep it alone
    ("fallback", [100, 256, 400, 196]),  # largest < 500: keep all > 200
    ("tie", [625, 625, 100]),            # equal areas: the first label id
    ("empty", []),
])
def test_keep_largest_component_matches_jax(case, sizes):
    mk = _blocks(sizes)
    ours = tc.keep_largest_component(torch.from_numpy(mk))
    ref = jc.keep_largest_component(jnp.asarray(mk))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if case == "tie":
        assert ours.sum() == 625 and ours[1, 0] == 1


@pytest.mark.parametrize("name", sorted(MASKS))
def test_keep_largest_and_filter_match_jax_on_random(name):
    mk = MASKS[name]
    np.testing.assert_array_equal(
        tc.keep_largest_component(torch.from_numpy(mk), min_keep_area=40,
                                  fallback_min_area=5).numpy(),
        np.asarray(jc.keep_largest_component(jnp.asarray(mk), min_keep_area=40,
                                             fallback_min_area=5)))
    for min_area in (0, 3, 30):
        np.testing.assert_array_equal(
            tc.filter_components_by_area(torch.from_numpy(mk),
                                         min_area).numpy(),
            np.asarray(jc.filter_components_by_area(jnp.asarray(mk),
                                                    min_area)))


def test_batched_keep_largest_matches_vmapped_jax():
    masks = np.stack([_blocks([100, 900, 400]), _blocks([100, 256, 400]),
                      _blocks([625, 625])])
    ours = tc.keep_largest_component(torch.from_numpy(masks))
    ref = jax.vmap(jc.keep_largest_component)(jnp.asarray(masks))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _squares_past_2_24(s, squares):
    """(1, s, s) zeros with the given (row, col, side) squares, and each
    square's expected label: its least linear index + 1."""
    mk = torch.zeros(1, s, s)
    expected = []
    for r, c, side in squares:
        mk[0, r:r + side, c:c + side] = 1
        expected.append((r, c, side, r * s + c + 1))
    return mk, expected


def test_labels_exact_past_2_24_pixels():
    """At 4100² (16.81 M pixels) the labels pass 2^24, where float32 stops
    holding every integer; the corner square's pixels span index 2^24 and
    the strip lies wholly past it, with an odd least index."""
    s = 4100
    squares = [(s - 10, s - 10, 10), (4095, 18, 3), (7, 7, 5)]
    mk, expected = _squares_past_2_24(s, squares)
    assert expected[1][3] > 2 ** 24 and expected[1][3] % 2 == 1
    assert (s - 10) * s + s - 10 < 2 ** 24 < s * s - 1
    labels = tc.label_components(mk)
    areas = tc.component_areas(labels)
    for r, c, side, label in expected:
        block = labels[0, r:r + side, c:c + side]
        assert torch.all(block == label), (r, c)
        assert torch.all(areas[0, r:r + side, c:c + side] == side * side)
    assert int((labels > 0).sum()) == sum(sd * sd for _, _, sd in squares)


def test_watermark_components_stage_at_k1_size_limit():
    """The components stage of optimize_watermark_mask_batch (the
    largest-component rule) at S = 4096, the largest size K1 accepts: the
    largest component, 30 x 30 in the bottom-right corner, is kept alone."""
    s = 4096
    mk, expected = _squares_past_2_24(
        s, [(s - 30, s - 30, 30), (s - 25, 100, 20), (0, 0, 22)])
    out = tc.keep_largest_component(mk, min_keep_area=500,
                                    fallback_min_area=200)
    want = torch.zeros_like(mk)
    want[0, s - 30:, s - 30:] = 1
    assert torch.equal(out, want)
