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


@pytest.mark.parametrize("s", [20, 33, 64, 96, 100, 128, 200, 512, 1000])
@pytest.mark.parametrize("p", [0.2, 0.35, 0.5])
def test_k1_bit_exact(cuda, s, p):
    masks = _masks(int(p * 100) + s, s=s, p=p)
    ref = kc.morph_chain_plain(masks.to(cuda))
    before = kc.morph_chain_watermark.launches
    out = kc.morph_chain_watermark(masks.to(cuda))
    torch.cuda.synchronize()
    assert kc.morph_chain_watermark.launches == before + 1
    assert torch.equal(out, ref)


def test_k1_at_the_size_limit(cuda):
    """S = K1_MAX_SIZE takes the most shared memory (set once per
    device); one above it raises on the card."""
    s = kc.K1_MAX_SIZE
    masks = _masks(4, n=1, s=s, p=0.3).to(cuda)
    for _ in range(2):
        out = kc.morph_chain_watermark(masks)
    assert torch.equal(out, kc.morph_chain_plain(masks))
    before = kc.morph_chain_watermark.launches
    with pytest.raises(ValueError, match="limit"):
        kc.morph_chain_watermark(torch.zeros(1, s + 1, s + 1, device=cuda))
    assert kc.morph_chain_watermark.launches == before


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("s", [64, 100, 101, 128])
def test_k2_bit_exact(cuda, s, aligned):
    x = np.random.default_rng(s).random((3, s, s)).astype(np.float32)
    x.reshape(-1)[::7] = np.resize(np.array(
        [np.nan, np.inf, -np.inf, 0.5, 0.50000006, 0.49999997],
        np.float32), x.size)[::7]
    flat = torch.empty(x.size + 1, device=cuda)  # offset 4 B: no float4
    x = (flat[:x.size] if aligned else flat[1:]).view(x.shape).copy_(
        torch.from_numpy(x))
    before = kc.gaussian_smooth_threshold.launches
    out = kc.gaussian_smooth_threshold(x)
    torch.cuda.synchronize()
    assert kc.gaussian_smooth_threshold.launches == before + 1
    assert torch.equal(out, kc.smooth_threshold_plain(x))
    assert torch.equal(out, (x > 0.5).float())


def test_batch_chain_on_card_matches_plain_chain(cuda):
    masks = _masks(9, n=2, s=128, p=0.4)
    out = maskproc.optimize_watermark_mask_batch(masks.to(cuda)).cpu()
    for i, mk in enumerate(masks):
        assert torch.equal(out[i], maskproc.optimize_watermark_mask(mk))
