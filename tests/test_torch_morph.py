"""The port's morphology, plain mask kernels and mask chains against the
JAX package's XLA ops, exactly (binary masks at 64-96²)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.inference import maskproc as jmp
from unet_watermark_tpu.ops import morphology as jm
from unet_watermark_tpu.ops.pallas import morph_chain as jpc
from unet_watermark_tpu_torch.inference import maskproc as tmp
from unet_watermark_tpu_torch.ops import morphology as tm
from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc

torch.set_num_threads(2)


def _random(seed, n=2, s=64, p=0.35):
    rng = np.random.default_rng(seed)
    return (rng.random((n, s, s)) < p).astype(np.float32)


def _border(s=96):
    """Foreground blocks touching all four borders and every corner."""
    mk = np.zeros((2, s, s), np.float32)
    mk[0, :10, :10] = mk[0, -10:, -10:] = 1.0
    mk[0, s // 2 - 5:s // 2 + 5, :7] = mk[0, :6, s // 2:s // 2 + 20] = 1.0
    mk[1, -12:, :] = mk[1, :, -3:] = 1.0
    mk[1, 30:40, 30:40] = 1.0
    return mk


def _blobs(seed, n=2, s=96):
    """Random rectangles and discs of many sizes plus 3% speckle."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s]
    mk = rng.random((n, s, s)) < 0.03
    for i in range(n):
        for _ in range(6):
            cy, cx = rng.integers(0, s, 2)
            r = rng.integers(2, s // 5)
            if rng.random() < 0.5:
                mk[i] |= np.hypot(yy - cy, xx - cx) < r
            else:
                mk[i] |= (abs(yy - cy) < r) & (abs(xx - cx) < r // 2 + 1)
    return mk.astype(np.float32)


MASKS = {
    "blobs0": _blobs(10),
    "blobs1": _blobs(11, s=64),
    "p0.2": _random(0, p=0.2),
    "p0.35": _random(1, p=0.35),
    "p0.5": _random(2, p=0.5),
    "border": _border(),
}


def _jax_chain(x):
    x = jm.morph_open(x, jm.ellipse_kernel(3, 3), 1)
    x = jm.morph_close(x, jm.ellipse_kernel(7, 7), 3)
    x = jm.morph_close(x, jm.ellipse_kernel(11, 11), 2)
    return jm.dilate(x, jm.ellipse_kernel(9, 9), 2)


@pytest.mark.parametrize("size", [(2, 2), (3, 3), (4, 4), (5, 5), (7, 7),
                                  (9, 9), (11, 11), (5, 3), (6, 9), (15, 15)])
def test_structuring_elements_match(size):
    np.testing.assert_array_equal(tm.ellipse_kernel(*size),
                                  jm.ellipse_kernel(*size))
    np.testing.assert_array_equal(tm.rect_kernel(*size),
                                  jm.rect_kernel(*size))


def test_gaussian_kernel_matches():
    for ks, sigma in [(3, 0.5), (5, 1.0), (7, 0.0)]:
        np.testing.assert_array_equal(tm.gaussian_kernel_1d(ks, sigma),
                                      jm.gaussian_kernel_1d(ks, sigma))


@pytest.mark.parametrize("op", ["dilate", "erode", "morph_open",
                                "morph_close"])
@pytest.mark.parametrize("element,iters", [
    (("ellipse", 3, 3), 1), (("ellipse", 7, 7), 2), (("ellipse", 2, 2), 1),
    (("rect", 5, 1), 1), (("ellipse", 11, 11), 1)])
@pytest.mark.parametrize("name", ["p0.35", "border"])
def test_primitive_matches_jax(op, element, iters, name):
    shape, w, h = element
    ours_k = (tm.ellipse_kernel if shape == "ellipse" else tm.rect_kernel)(w, h)
    ref_k = (jm.ellipse_kernel if shape == "ellipse" else jm.rect_kernel)(w, h)
    masks = MASKS[name]
    ours = getattr(tm, op)(torch.from_numpy(masks), ours_k, iters)
    ref = getattr(jm, op)(jnp.asarray(masks), ref_k, iters)
    assert ours.shape == masks.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_gaussian_blur_and_threshold_match():
    img = np.random.default_rng(3).random((2, 64, 80)).astype(np.float32)
    ours = tm.gaussian_blur(torch.from_numpy(img), (3, 3), 0.5)
    ref = jm.gaussian_blur(jnp.asarray(img), (3, 3), 0.5)
    # fp32 sums of three products taken in another order: a few ulp
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(
        tm.threshold_binary(torch.from_numpy(img), 0.5).numpy(),
        np.asarray(jm.threshold_binary(jnp.asarray(img), 0.5)))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_k1_plain_matches_xla_chain(name):
    masks = MASKS[name]
    ours = kc.morph_chain_watermark(torch.from_numpy(masks))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(_jax_chain(jnp.asarray(masks))))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_k2_plain_matches_xla_smooth(name):
    masks = MASKS[name]
    ours = kc.gaussian_smooth_threshold(torch.from_numpy(masks))
    ref = jm.threshold_binary(jm.gaussian_blur(jnp.asarray(masks), (3, 3),
                                               0.5), 0.5)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # on a binary input the blur+threshold is the identity: the centre weight
    # 0.787² = 0.619 > 0.5 and the others sum to 0.381, so a test on binary
    # masks cannot tell this blur from a copy
    np.testing.assert_array_equal(ours.numpy(), masks)


def test_k2_plain_thresholds_its_input_first():
    x = np.random.default_rng(4).random((1, 64, 64)).astype(np.float32)
    ours = kc.gaussian_smooth_threshold(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.numpy(), (x > 0.5).astype(np.float32))


def test_k2_is_the_threshold_on_all_3x3_patterns():
    """Every binary 3x3 neighbourhood, zero-padded: the blur + threshold
    gives back each pattern's centre (and the whole padded input)."""
    bits = (np.arange(512)[:, None] >> np.arange(9)) & 1
    patterns = np.zeros((512, 5, 5), np.float32)
    patterns[:, 1:4, 1:4] = bits.reshape(512, 3, 3)
    out = kc.smooth_threshold_plain(torch.from_numpy(patterns)).numpy()
    np.testing.assert_array_equal(out[:, 2, 2], patterns[:, 2, 2])
    np.testing.assert_array_equal(out, patterns)


def test_k2_is_the_threshold_on_special_floats():
    """NaN, ±inf, 0.5 and its neighbours, and uniform noise: the JAX
    kernel (interpret mode), the plain version and (x > 0.5).float() agree
    exactly, so that expression computes K2's function."""
    rng = np.random.default_rng(5)
    x = (rng.random((2, 37, 37)) * 1.5 - 0.25).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.5,
                        np.nextafter(np.float32(0.5), np.float32(1)),
                        np.nextafter(np.float32(0.5), np.float32(-1)),
                        0.0, 1.0], np.float32)
    x.reshape(-1)[::3] = np.resize(special, x.size)[::3]
    x[1, :, :2] = 0.5
    ref = np.asarray(jpc.gaussian_smooth_threshold(jnp.asarray(x)))
    plain = kc.smooth_threshold_plain(torch.from_numpy(x)).numpy()
    library = (torch.from_numpy(x) > 0.5).float().numpy()
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(library, ref)


def _cu_chain():
    """(op, radius) of each step of K1's compile-time chain, kChain in the
    CUDA source (the kernel itself runs only on the card)."""
    src = (Path(kc.__file__).resolve().parents[2] / "csrc"
           / kc.SOURCE).read_text()
    table = src[src.index("constexpr Step kChain[]"):]
    table = table[:table.index("};")]
    return [(op.lower(), int(r))
            for op, r in re.findall(r"\{k(Erode|Dilate), (\d+)\}", table)]


def test_chain_table_encodes_the_watermark_chain():
    """K1's chain is open(3) → close(7)x3 → close(11)x2 → dilate(9)x2, and
    its integer row rule (largest k with k(k-1) < r² - dy²) gives cv2's
    elliptical elements."""
    chain = _cu_chain()
    assert chain == ([("erode", 1), ("dilate", 1)] + [("dilate", 3)] * 3
                     + [("erode", 3)] * 3 + [("dilate", 5)] * 2
                     + [("erode", 5)] * 2 + [("dilate", 4)] * 2)
    assert sum(r for _, r in chain) == 48  # accumulated radius = the halo
    taps = 0
    for _, r in chain:
        element = np.zeros((2 * r + 1, 2 * r + 1), np.float32)
        for dy in range(-r, r + 1):
            hw = 0
            while (hw + 1) * hw < r * r - dy * dy:
                hw += 1
            element[dy + r, r - hw:r + hw + 1] = 1.0
        np.testing.assert_array_equal(element,
                                      jm.ellipse_kernel(2 * r + 1, 2 * r + 1))
        taps += int(element.sum())
    assert taps == 664 + 14  # 664 max-taps besides each step's own centre


def test_wrappers_reject_bad_inputs():
    ok = torch.zeros(1, 8, 8)
    for fn in kc.KERNELS:
        with pytest.raises(TypeError):
            fn(ok.double())
        with pytest.raises(ValueError):
            fn(torch.zeros(1, 8, 9))
        with pytest.raises(ValueError):
            fn(torch.zeros(8, 8))
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(1, 8, 8).transpose(1, 2))


def test_cpu_wrappers_do_not_count_launches():
    kc.reset_launch_counts()
    for fn in kc.KERNELS:
        fn(torch.from_numpy(MASKS["p0.5"]))
        assert fn.launches == 0


@pytest.mark.parametrize("name", sorted(MASKS))
def test_mask_chains_match_jax(name):
    for mk in MASKS[name]:
        np.testing.assert_array_equal(
            tmp.optimize_watermark_mask(torch.from_numpy(mk)).numpy(),
            np.asarray(jmp.optimize_watermark_mask(jnp.asarray(mk))))
        np.testing.assert_array_equal(
            tmp.optimize_watermark_mask_tight(torch.from_numpy(mk)).numpy(),
            np.asarray(jmp.optimize_watermark_mask_tight(jnp.asarray(mk))))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_batch_chain_matches_jax_chain(name):
    """K1 → per-image largest component → K2 (here their plain versions)
    equals the JAX parity chain on each image."""
    masks = MASKS[name]
    ours = tmp.optimize_watermark_mask_batch(torch.from_numpy(masks))
    ref = np.stack([np.asarray(jmp.optimize_watermark_mask(jnp.asarray(mk)))
                    for mk in masks])
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_resolve_mask_mode_matches_jax():
    for mode in ("auto", "parity", "tight"):
        for surface in ("repair", "artifact"):
            assert tmp.resolve_mask_mode(mode, surface) == \
                jmp.resolve_mask_mode(mode, surface)
    with pytest.raises(ValueError):
        tmp.resolve_mask_mode("fast", "repair")
