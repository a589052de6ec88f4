"""A numpy model of K1's bit-packed algorithm (csrc/morph_chain.cu), held
exactly against the plain chain. The kernel runs only on the card; this
model follows its arithmetic word for word (LSB-first packing as
__ballot_sync gives it, funnel shifts with all-border neighbour words, tail
bits and rows beyond the image set to the next step's border value, bands
of B rows with the chain's halo, segments of kSeg rows with the last one
clamped), so its border and window logic is checked before the card."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc

ALL = 0xFFFFFFFF
SRC = (Path(kc.__file__).resolve().parents[2] / "csrc"
       / kc.SOURCE).read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _chain():
    table = SRC[SRC.index("constexpr Step kChain[]"):]
    table = table[:table.index("};")]
    return [(op == "Erode", int(r))
            for op, r in re.findall(r"\{k(Erode|Dilate), (\d+)\}", table)]


CHAIN = _chain()
HALO = sum(r for _, r in CHAIN)
SEG = _constant("kSeg")


def _half_width(r, dy):
    k = 0
    while (k + 1) * k < r * r - dy * dy:
        k += 1
    return k


def _funnel_l(lo, hi, d):
    """__funnelshift_l(lo, hi, d): the high word of (hi:lo) << d."""
    return ((hi << d) | (lo >> (32 - d))) & ALL


def _funnel_r(lo, hi, d):
    """__funnelshift_r(lo, hi, d): the low word of (hi:lo) >> d."""
    return ((lo >> d) | (hi << (32 - d))) & ALL


def _pack(bits):
    """(R, 32 W) bool → (R, W) words, bit l of word i = pixel 32 i + l."""
    rows, width = bits.shape
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(rows, width // 32, 32) * weights).sum(
        -1, dtype=np.uint64)


def _step(src, dst, erode, r, nxt, lo, y0, s, tail):
    """One step: rows [lo, R - lo) of dst from src, as run_step does it."""
    rows, words = src.shape
    op = np.bitwise_and if erode else np.bitwise_or
    border = np.uint64(ALL if erode else 0)
    side = np.full((rows, 1), border, np.uint64)
    left = np.concatenate([side, src[:, :-1]], 1)
    right = np.concatenate([src[:, 1:], side], 1)
    span = [src]
    for h in range(1, r + 1):
        span.append(op(span[-1], op(_funnel_l(left, src, np.uint64(h)),
                                    _funnel_r(src, right, np.uint64(h)))))
    hi = rows - lo
    first = np.minimum(lo + np.arange(-(-(hi - lo) // SEG)) * SEG, hi - SEG)
    acc = np.full((len(first), SEG, words), border, np.uint64)
    for j in range(SEG + 2 * r):
        for t in range(SEG):
            dy = j - r - t
            if -r <= dy <= r:
                acc[:, t] = op(acc[:, t],
                               span[_half_width(r, dy)][first - r + j])
    for t in range(SEG):
        y = first + t
        v = acc[:, t]
        v[:, -1] = (v[:, -1] | tail) if nxt else (v[:, -1] & ~tail & ALL)
        gy = y0 + y
        v[(gy < 0) | (gy >= s)] = nxt
        dst[y] = v


def k1_model(img, band, seed=0):
    """K1 on one (S, S) float32 image, band by band."""
    s = img.shape[0]
    words = -(-s // 32)
    rows = band + 2 * HALO
    tail = np.uint64(ALL ^ ((1 << (s % 32)) - 1) if s % 32 else 0)
    garbage = np.random.default_rng(seed)  # shared memory is not cleared
    out = np.zeros((s, s), np.float32)
    for y0 in range(-HALO, s - HALO, band):
        gy = y0 + np.arange(rows)
        inside = (gy >= 0) & (gy < s)
        bits = np.full((rows, 32 * words), CHAIN[0][0])
        bits[inside, :s] = img[gy[inside]] > 0.5
        a = _pack(bits)
        b = garbage.integers(0, ALL, a.shape, dtype=np.uint64,
                             endpoint=True)
        lo = 0
        for k, (erode, r) in enumerate(CHAIN):
            nxt = ALL if k + 1 < len(CHAIN) and CHAIN[k + 1][0] else 0
            lo += r
            _step(a, b, erode, r, np.uint64(nxt), lo, y0, s, tail)
            a, b = b, a
        for y in range(HALO, HALO + band):
            if y0 + y < s:
                word = a[y][:, None] >> np.arange(32, dtype=np.uint64)
                out[y0 + y] = (word & np.uint64(1)).reshape(-1)[:s]
    return out


def _masks(kind, s, seed):
    rng = np.random.default_rng(seed)
    if kind == "border":
        mk = rng.random((2, s, s)) < 0.1
        w = max(2, s // 8)
        mk[0, :w, :s // 2] = mk[0, -w:, s // 3:] = True
        mk[0, :, :w] = mk[1, :, -w:] = mk[1, -1, :] = True
        mk[1, :2, :2] = mk[1, -3:, -3:] = True
        return mk.astype(np.float32)
    p = float(kind[1:])
    return (rng.random((2, s, s)) < p).astype(np.float32)


@pytest.mark.parametrize("kind", ["p0.2", "p0.5", "border"])
@pytest.mark.parametrize("band", [8, 32])
@pytest.mark.parametrize("s", [20, 33, 64, 100])
def test_word_model_matches_plain_chain(s, band, kind):
    masks = _masks(kind, s, seed=s + band)
    # some inputs off {0, 1} and at the threshold itself
    masks[0, 0, :3] = [0.5, 0.5000001, np.nan]
    ref = kc.morph_chain_plain(torch.from_numpy(masks)).numpy()
    for mk, want in zip(masks, ref):
        np.testing.assert_array_equal(k1_model(mk, band, seed=s), want)


def test_source_constants_agree_with_the_wrapper():
    """The kernel's band, halo and size limit: the halo is the chain's
    accumulated radius, the band is the one the model runs, the size limit
    is the wrapper's, and two band buffers at that limit fit a block."""
    band, limit = _constant("kBand"), _constant("kMaxSize")
    assert HALO == 48
    assert "constexpr int kHalo = chain_halo();" in SRC
    assert band == 32 and SEG <= 8  # the bands the model test runs
    assert limit == kc.K1_MAX_SIZE
    assert 2 * (band + 2 * HALO) * (limit // 32) * 4 <= 232448
