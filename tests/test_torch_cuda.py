"""The port's CUDA kernels against their plain versions on the card.

Run on a machine with an NVIDIA H100 and nvcc:
    python -m pytest tests/test_torch_cuda.py -q
Without a card each test skips (the plain versions are held against the
JAX package in tests/test_torch_morph.py).
"""
import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.inference import maskproc
from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none on this machine)")
    return torch.device("cuda")


def _masks(seed, n=3, s=128, p=0.35):
    mk = (np.random.default_rng(seed).random((n, s, s)) < p)
    mk[0, :9, :] = mk[0, :, -9:] = True  # foreground on the borders
    return torch.from_numpy(mk.astype(np.float32))


@pytest.mark.parametrize("s", [64, 96, 128, 200])
@pytest.mark.parametrize("p", [0.2, 0.35, 0.5])
def test_k1_bit_exact(cuda, s, p):
    masks = _masks(int(p * 100) + s, s=s, p=p)
    ref = kc.morph_chain_plain(masks.to(cuda))
    before = kc.morph_chain_watermark.launches
    out = kc.morph_chain_watermark(masks.to(cuda))
    torch.cuda.synchronize()
    assert kc.morph_chain_watermark.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.parametrize("s", [64, 100, 128])
def test_k2_bit_exact(cuda, s):
    x = torch.from_numpy(np.random.default_rng(s).random(
        (3, s, s)).astype(np.float32)).to(cuda)
    before = kc.gaussian_smooth_threshold.launches
    out = kc.gaussian_smooth_threshold(x)
    torch.cuda.synchronize()
    assert kc.gaussian_smooth_threshold.launches == before + 1
    assert torch.equal(out, kc.smooth_threshold_plain(x))


def test_batch_chain_on_card_matches_plain_chain(cuda):
    masks = _masks(9, n=2, s=128, p=0.4)
    out = maskproc.optimize_watermark_mask_batch(masks.to(cuda)).cpu()
    for i, mk in enumerate(masks):
        assert torch.equal(out[i], maskproc.optimize_watermark_mask(mk))
