"""ops/augment.py of the port against the JAX package's.

The apply step is held against JAX's augment_sample itself: the test takes
a JAX key, recovers every value augment_sample draws from it (the same
jax.random.split / uniform / randint / normal calls as
unet_watermark_tpu/ops/augment.py:381-480), hands them to the port's
apply_params and compares the batch with JAX's augment_batch. The
separable nearest warp is held bit for bit given the same float32
coefficients; the draws of draw_params by their distributions over 4 000
samples."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.ops import augment as ja
from unet_watermark_tpu_torch.ops import augment as ta

POLICY_NAMES = ["basic", "enhanced", "transparent_watermark",
                "text_watermark"]


def jax_draws(key, n, h, w, policy):
    """augment_sample's draws for each sample of augment_batch(key, ...),
    as the port's params dict (effective values)."""
    p = ja.POLICIES[policy] if isinstance(policy, str) else policy
    keys = jax.random.split(key, n)
    rows = []
    for k in keys:
        ks = jax.random.split(k, 12)
        u = jax.random.uniform
        d = {"hflip": bool(u(ks[0]) < p.hflip_p),
             "vflip": bool(u(ks[1]) < p.vflip_p)}
        if p.affine_p > 0 or (h == w and p.rot90_p > 0):
            rot = jnp.float32(0.0)
            if h == w and p.rot90_p > 0:
                do_r = u(ks[2]) < p.rot90_p
                k_r = jax.random.randint(ks[3], (), 1, 4)
                rot = jnp.where(do_r, 90.0 * k_r, 0.0)
            do_a = u(ks[4]) < p.affine_p
            scale = 1.0 + u(ks[5], minval=-p.scale_limit,
                            maxval=p.scale_limit)
            angle = u(ks[6], minval=-p.rotate_limit, maxval=p.rotate_limit)
            shear = u(ks[7], minval=-p.shear_limit, maxval=p.shear_limit)
            shift = u(ks[8], (2,), minval=-p.shift_limit,
                      maxval=p.shift_limit)
            d["scale"] = jnp.where(do_a, scale, 1.0)
            d["angle"] = jnp.where(do_a, angle, 0.0) + rot
            d["shear"] = jnp.where(do_a, shear, 0.0)
            d["shift"] = jnp.where(do_a, shift, jnp.zeros(2))
        kb = jax.random.split(ks[9], 4)
        d["bc"] = bool(u(kb[0]) < p.bc_p)
        d["brightness"] = u(kb[1], minval=-p.brightness_limit,
                            maxval=p.brightness_limit)
        d["contrast"] = u(kb[2], minval=-p.contrast_limit,
                          maxval=p.contrast_limit)
        kh = jax.random.split(ks[10], 4)
        d["hsv"] = bool(u(kh[0]) < p.hsv_p)
        d["dh"] = u(kh[1], minval=-p.hue_limit, maxval=p.hue_limit)
        d["ds"] = u(kh[2], minval=-p.sat_limit, maxval=p.sat_limit)
        d["dv"] = u(kh[3], minval=-p.val_limit, maxval=p.val_limit)
        kn = jax.random.split(ks[11], 5)
        d["noise"] = bool(u(kn[0]) < p.noise_p)
        d["noise_values"] = jax.random.normal(kn[1], (h, w, 3)) * \
            p.noise_std
        d["blur"] = bool(u(kn[2]) < p.blur_p)
        d["jpeg"] = bool(u(kn[3]) < p.jpeg_p)
        d["quality"] = u(kn[4], minval=p.jpeg_quality[0],
                         maxval=p.jpeg_quality[1])
        rows.append(d)
    out = {}
    for key in rows[0]:
        vals = np.stack([np.asarray(r[key]) for r in rows])
        out[key] = torch.from_numpy(vals.astype(
            np.bool_ if vals.dtype == np.bool_ else np.float32))
    return out


def _batch(seed, n, h, w):
    rng = np.random.default_rng(seed)
    images = rng.random((n, h, w, 3)).astype(np.float32)
    masks = np.zeros((n, h, w, 1), np.float32)
    masks[:, h // 4:h // 2, w // 3:w - 4] = 1.0
    masks[:, 2:5, 1:7] = 1.0
    return images, masks


@pytest.fixture(scope="module")
def jax_augment():
    return jax.jit(lambda k, i, m, pol: ja.augment_batch(
        k, i, m, pol, apply_normalize=False), static_argnums=(3,))


# the image: float32 ops in the same order, apart from the blur's conv sums
# and the JPEG simulation's DCT matmuls (another summation order); a
# coefficient at .5 of its quantizer step may round the other way there,
# which moves that 8 x 8 block's pixels by up to the step (counted below,
# at most one block in 50)
IMG_ATOL = 2e-6
JPEG_FLIP_BLOCKS = 0.02


def _compare(got, want, params, h, w):
    diff = np.abs(got - want)  # (n, h, w, 3)
    blocks = diff.reshape(got.shape[0], h // 8, 8, w // 8, 8, 3).max(
        axis=(2, 4, 5))
    flipped = blocks > IMG_ATOL
    # only where the JPEG simulation ran can a block differ by more
    fired = params["jpeg"].numpy()[:, None, None]
    assert not (flipped & ~fired).any()
    assert flipped.mean() <= JPEG_FLIP_BLOCKS, flipped.sum()
    return int(flipped.sum())


@pytest.mark.parametrize("h, w", [(32, 32), (32, 48)], ids=["square",
                                                            "wide"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_apply_matches_jax_augment_sample(jax_augment, policy, seed, h, w):
    n = 8
    images, masks = _batch(seed, n, h, w)
    key = jax.random.PRNGKey(100 + seed)
    ji, jm = jax_augment(key, jnp.asarray(images), jnp.asarray(masks),
                         policy)
    params = jax_draws(key, n, h, w, policy)
    ti, tm = ta.apply_params(torch.from_numpy(images),
                             torch.from_numpy(masks), params, policy)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _compare(ti.numpy(), np.asarray(ji), params, h, w)


def test_apply_every_op_fires(jax_augment):
    """A policy whose every op fires on every sample, so each op's output
    is compared (the random ones fire on some samples only)."""
    pol = dataclasses.replace(
        ja.POLICIES["transparent_watermark"], hflip_p=1.0, vflip_p=1.0,
        rot90_p=1.0, affine_p=1.0, shift_limit=0.1, bc_p=1.0, hsv_p=1.0,
        noise_p=1.0, blur_p=1.0, jpeg_p=1.0)
    tpol = ta.AugmentPolicy(**dataclasses.asdict(pol))
    n, h, w = 8, 32, 32
    images, masks = _batch(9, n, h, w)
    key = jax.random.PRNGKey(7)
    ji, jm = jax_augment(key, jnp.asarray(images), jnp.asarray(masks), pol)
    params = jax_draws(key, n, h, w, pol)
    assert params["jpeg"].all() and params["hsv"].all()
    ti, tm = ta.apply_params(torch.from_numpy(images),
                             torch.from_numpy(masks), params, tpol)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _compare(ti.numpy(), np.asarray(ji), params, h, w)


@pytest.mark.parametrize("h, w", [(32, 32), (24, 40), (64, 64)])
@pytest.mark.parametrize("seed", range(4))
def test_separable_warp_is_bit_exact(seed, h, w):
    """Given JAX's float32 coefficients (any angle, scale, shear, shift;
    multiples of 90°; the transposed |s| > |p| case), the port's gathers
    give JAX's one-hot matmuls and rolls bit for bit."""
    rng = np.random.default_rng(seed)
    n = 12
    img = rng.random((n, h, w, 4)).astype(np.float32)
    angle = rng.uniform(-180, 180, n).astype(np.float32)
    angle[:4] = [90, 180, 270, -90]
    scale = rng.uniform(0.8, 1.2, n).astype(np.float32)
    scale[:4] = 1.0
    shear = rng.uniform(-8, 8, n).astype(np.float32)
    shear[:4] = 0
    shift = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    shift[:4] = 0
    coeffs = jax.jit(jax.vmap(lambda a, s, sh, sf: ja._affine_coeffs(
        h, w, s, a, sh, sf)))(angle, scale, shear, shift)
    warp = jax.jit(jax.vmap(ja._separable_nearest_warp))
    want = np.asarray(warp(jnp.asarray(img), *coeffs))
    got = ta.separable_nearest_warp(
        torch.from_numpy(img), *[torch.tensor(np.asarray(c))
                                 for c in coeffs])
    np.testing.assert_array_equal(got.numpy(), want)
    if h == w:  # a turn of +90° is rot90 by k = 3, and so on, exactly
        for i, k in enumerate((3, 2, 1, 1)):
            np.testing.assert_array_equal(
                want[i], np.rot90(img[i], k=k, axes=(0, 1)))


def test_affine_coefficients_match_jax():
    rng = np.random.default_rng(3)
    n = 64
    args = (rng.uniform(0.9, 1.1, n), rng.uniform(-200, 200, n),
            rng.uniform(-5, 5, n), rng.uniform(-0.1, 0.1, (n, 2)))
    args = [a.astype(np.float32) for a in args]
    want = jax.vmap(lambda s, a, sh, sf: ja._affine_coeffs(
        48, 32, s, a, sh, sf))(*args)
    got = ta._affine_coeffs(48, 32, *[torch.from_numpy(a) for a in args])
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=2e-6,
                                   atol=2e-5)


def test_jpeg_sim_matches_jax_up_to_rounding_flips():
    """jpeg_compression_sim over 8 images x 48 blocks x 3 channels at
    random qualities: equal to JAX's to float32 rounding except in the
    blocks where a coefficient lies at .5 of its step (counted)."""
    rng = np.random.default_rng(5)
    img = rng.random((8, 48, 64, 3)).astype(np.float32)
    q = rng.uniform(20, 100, 8).astype(np.float32)
    want = np.stack([np.asarray(ja.jpeg_compression_sim(
        jnp.asarray(img[i]), jnp.float32(q[i]))) for i in range(8)])
    got = ta.jpeg_compression_sim(torch.from_numpy(img),
                                  torch.from_numpy(q)).numpy()
    diff = np.abs(got - want).reshape(8, 6, 8, 8, 8, 3).max(axis=(2, 4))
    assert (diff > IMG_ATOL).mean() <= JPEG_FLIP_BLOCKS


def test_normalize_and_val_preprocess_match_jax():
    x = np.random.default_rng(0).random((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(ja.val_preprocess(jnp.asarray(x)))
    np.testing.assert_allclose(ta.val_preprocess(torch.from_numpy(x)),
                               want, rtol=1e-6, atol=1e-6)


def test_policies_equal_jax():
    assert list(ta.POLICIES) == list(ja.POLICIES)
    for name, pol in ja.POLICIES.items():
        assert dataclasses.asdict(ta.POLICIES[name]) == \
            dataclasses.asdict(pol)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_draw_distributions(policy):
    """Each op fires at its probability (within 5 binomial standard
    deviations over 4 000 samples), amounts stay within their limits and
    spread over them, rot90 turns by 90/180/270 alone, the noise has the
    policy's standard deviation."""
    n, h = 4000, 16
    gen = torch.Generator().manual_seed(1)
    d = ta.draw_params(gen, n, h, h, policy)
    p = ta.POLICIES[policy]
    for key, prob in (("hflip", p.hflip_p), ("vflip", p.vflip_p),
                      ("bc", p.bc_p), ("hsv", p.hsv_p),
                      ("blur", p.blur_p), ("jpeg", p.jpeg_p)):
        rate = d[key].float().mean().item()
        sd = (prob * (1 - prob) / n) ** 0.5
        assert abs(rate - prob) <= 5 * sd + 1e-9, (key, rate, prob)
    for key, lim in (("brightness", p.brightness_limit),
                     ("contrast", p.contrast_limit), ("dh", p.hue_limit),
                     ("ds", p.sat_limit), ("dv", p.val_limit)):
        v = d[key]
        assert v.abs().max() <= lim and v.max() > 0.9 * lim and \
            v.min() < -0.9 * lim, key
    q = d["quality"]
    assert p.jpeg_quality[0] <= q.min() and q.max() <= p.jpeg_quality[1]
    # angle = affine rotation (fires at affine_p) + a quarter turn (rot90_p)
    turns = torch.round(d["angle"] / 90.0) * 90.0
    affine = (d["scale"] != 1.0)
    rest = d["angle"] - turns
    assert rest.abs().max() <= p.rotate_limit
    assert (rest[~affine] == 0).all() and (d["shear"][~affine] == 0).all()
    rate = affine.float().mean().item()
    sd = (p.affine_p * (1 - p.affine_p) / n) ** 0.5
    assert abs(rate - p.affine_p) <= 5 * sd
    quarter = torch.remainder(turns, 360.0)[~affine]
    assert set(quarter.unique().tolist()) <= {0.0, 90.0, 180.0, 270.0}
    rot_rate = (quarter != 0).float().mean().item()
    sd = (p.rot90_p * (1 - p.rot90_p) / (~affine).sum().item()) ** 0.5
    assert abs(rot_rate - p.rot90_p) <= 5 * sd
    assert (d["scale"] - 1.0).abs().max() <= p.scale_limit + 1e-6
    assert d["shift"].abs().max() <= p.shift_limit
    if p.noise_p > 0:
        rate = d["noise"].float().mean().item()
        sd = (p.noise_p * (1 - p.noise_p) / n) ** 0.5
        assert abs(rate - p.noise_p) <= 5 * sd
        std = d["noise_values"].std().item()
        assert std == pytest.approx(p.noise_std, rel=0.02)


def test_augment_batch_keeps_masks_binary_and_images_in_range():
    images, masks = _batch(0, 6, 32, 32)
    gen = torch.Generator().manual_seed(0)
    for policy in POLICY_NAMES:
        ti, tm = ta.augment_batch(gen, torch.from_numpy(images),
                                  torch.from_numpy(masks), policy,
                                  apply_normalize=False)
        assert set(tm.unique().tolist()) <= {0.0, 1.0}
        assert 0.0 <= ti.min() and ti.max() <= 1.0
        assert ti.shape == images.shape and tm.shape == masks.shape


def test_other_interpolations_raise():
    pol = ta.AugmentPolicy(interpolation="bilinear")
    with pytest.raises(NotImplementedError, match="§A.7"):
        ta.draw_params(torch.Generator(), 2, 8, 8, pol)
