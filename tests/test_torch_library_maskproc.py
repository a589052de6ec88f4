"""The public per-type helpers against the JAX package's: maskproc's
optimize_mask_by_type and optimize_mask_batch_by_type (JAX's
tests/test_maskproc.py:88,133 cases, on the port's mask set), and
ops/augment's augment_sample (fed the draws JAX's augment_sample takes
from its key) and denormalize; and the partitioned batch on masks that
are not square (ROADMAP.md §C.14).

Tolerances: every mask is exactly equal; the augmented image as in
tests/test_torch_augment.py (IMG_ATOL, the JPEG simulation's rounding
flips counted by block); denormalize to one float32 ulp of its values
(the same multiply-add)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import _batch, _compare, jax_draws
from test_torch_maskproc import MASKS
from unet_watermark_tpu.inference import maskproc as jmp
from unet_watermark_tpu.ops import augment as ja
from unet_watermark_tpu_torch.inference import maskproc as tmp
from unet_watermark_tpu_torch.ops import augment as ta

torch.set_num_threads(2)

SQUARE = MASKS[64]
# a wide mask set: the plain chain's route for code 0
WIDE = np.ascontiguousarray(MASKS[64][:, :48, :])


@pytest.mark.parametrize("code", [0, 1, 2])
@pytest.mark.parametrize("masks", [SQUARE, WIDE], ids=["square", "wide"])
def test_optimize_mask_by_type_matches_jax(masks, code):
    for mk in masks[[1, 3, 5]]:
        want = np.asarray(jmp.optimize_mask_by_type(jnp.asarray(mk),
                                                    jnp.int32(code)))
        got = tmp.optimize_mask_by_type(torch.from_numpy(mk), code)
        assert got.dtype == torch.float32 and got.shape == mk.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masks", [SQUARE, WIDE], ids=["square", "wide"])
def test_optimize_mask_batch_by_type_matches_jax(masks):
    codes = np.array([0, 1, 2, 2, 0, 1], np.int32)
    want = np.asarray(jmp.optimize_mask_batch_by_type(jnp.asarray(masks),
                                                      jnp.asarray(codes)))
    for given in (torch.from_numpy(codes), codes.tolist()):
        got = tmp.optimize_mask_batch_by_type(torch.from_numpy(masks), given)
        np.testing.assert_array_equal(got.numpy(), want)
    assert all(want[i].mean() > 0 for i in range(len(codes)))


@pytest.mark.parametrize("mode", ["parity", "tight"])
def test_partitioned_takes_any_shape(mode):
    """ROADMAP.md §C.14: the partitioned batch's parity watermark strategy
    raised for masks that are not square (K1 takes (N, S, S)); JAX's
    returns the plain chain's masks."""
    codes = [0, 1, 2, 0, 1, 2]
    want = jmp.optimize_mask_batch_partitioned(WIDE, codes, mode=mode)
    got = tmp.optimize_mask_batch_partitioned(torch.from_numpy(WIDE), codes,
                                              mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_code_zero_routes_by_shape(monkeypatch):
    """A square batch's code-0 images go through the K1 → components → K2
    function once; another shape takes the plain chain."""
    calls = []
    batch_fn = tmp.optimize_watermark_mask_batch
    monkeypatch.setattr(tmp, "optimize_watermark_mask_batch",
                        lambda x: calls.append(x.shape) or batch_fn(x))
    tmp.optimize_mask_batch_by_type(torch.from_numpy(SQUARE), [0, 1] * 3)
    tmp.optimize_mask_by_type(torch.from_numpy(SQUARE[2]), 0)
    assert calls == [(3, 64, 64), (1, 64, 64)]
    tmp.optimize_mask_by_type(torch.from_numpy(WIDE[2]), 0)
    assert len(calls) == 2


def test_by_type_refuses_bad_codes():
    with pytest.raises(ValueError):
        tmp.optimize_mask_batch_by_type(torch.from_numpy(SQUARE), [0, 1])
    with pytest.raises(ValueError):
        tmp.optimize_mask_by_type(torch.from_numpy(SQUARE[0]), 3)


POLICY_ALL = dataclasses.replace(
    ja.POLICIES["transparent_watermark"], hflip_p=1.0, vflip_p=1.0,
    rot90_p=1.0, affine_p=1.0, shift_limit=0.1, bc_p=1.0, hsv_p=1.0,
    noise_p=1.0, blur_p=1.0, jpeg_p=1.0)


@functools.lru_cache(maxsize=None)
def _jax_sample(policy):
    """JAX's augment_sample for a policy, jitted once (one compile a
    policy)."""
    pol = POLICY_ALL if policy == "every op" else ja.POLICIES[policy]
    return jax.jit(lambda k, i, m: ja.augment_sample(k, i, m, pol))


@pytest.mark.parametrize("policy", ["transparent_watermark", "every op"])
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_sample_matches_jax(policy, seed):
    pol = POLICY_ALL if policy == "every op" else ja.POLICIES[policy]
    tpol = (ta.AugmentPolicy(**dataclasses.asdict(POLICY_ALL))
            if policy == "every op" else policy)
    h = w = 32
    images, masks = _batch(20 + seed, 1, h, w)
    key = jax.random.PRNGKey(300 + seed)
    ji, jm = _jax_sample(policy)(jax.random.split(key, 1)[0],
                                 jnp.asarray(images[0]),
                                 jnp.asarray(masks[0]))
    params = jax_draws(key, 1, h, w, pol)
    ti, tm = ta.augment_sample(None, torch.from_numpy(images[0]),
                               torch.from_numpy(masks[0]), tpol,
                               params=params)
    assert ti.shape == (h, w, 3) and tm.shape == (h, w, 1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _compare(ti.numpy()[None], np.asarray(ji)[None], params, h, w)


def test_augment_sample_draws_from_a_generator():
    images, masks = _batch(5, 1, 32, 32)
    gen = torch.Generator().manual_seed(3)
    a = ta.augment_sample(gen, torch.from_numpy(images[0]),
                          torch.from_numpy(masks[0]))
    gen = torch.Generator().manual_seed(3)
    b = ta.augment_sample(gen, torch.from_numpy(images[0]),
                          torch.from_numpy(masks[0]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(np.unique(a[1].numpy())) <= {0.0, 1.0}


def test_denormalize_matches_jax_and_inverts_normalize():
    x = np.random.default_rng(4).random((2, 8, 8, 3)).astype(np.float32)
    z = (x - 0.5) * 4
    want = np.asarray(ja.denormalize(jnp.asarray(z)))
    got = ta.denormalize(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(
        np.float32(np.abs(want).max())))
    back = ta.denormalize(ta.normalize(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-6)
