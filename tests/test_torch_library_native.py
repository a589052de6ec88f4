"""utils/native.py (csrc/maskops.c, built with cc) against
cv2.connectedComponentsWithStats and the JAX package's utils/native.py
(native/maskops.cpp), on seeded masks at connectivity 4 and 8, empty and
full masks among them.

Tolerances: exact. Against cv2, the label sets and the stats rows up to
the order of the labels (cv2's numbering is its own); against the JAX
package's library, the labels and stats array for array (the same
algorithm), and the two filters' masks."""
import cv2
import numpy as np
import pytest

from unet_watermark_tpu.utils import native as jn
from unet_watermark_tpu_torch.utils import native as tn


def _masks():
    rng = np.random.default_rng(11)
    out = {f"random{p}": (rng.random((48, 70)) < p).astype(np.uint8) * 255
           for p in (0.2, 0.45, 0.6)}
    yy, xx = np.mgrid[0:64, 0:64]
    rings = ((np.hypot(yy - 32, xx - 32) % 9) < 3).astype(np.uint8)
    out["rings"] = rings
    checker = ((yy + xx) % 2).astype(np.uint8)  # 4-connected: all apart
    out["checker"] = checker
    out["empty"] = np.zeros((32, 40), np.uint8)
    out["full"] = np.full((32, 40), 7, np.uint8)
    out["line"] = np.ones((1, 57), np.uint8)
    return out


MASKS = _masks()


def _label_sets(labels):
    return {frozenset(map(tuple, np.argwhere(labels == i)))
            for i in np.unique(labels) if i}


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_labels_and_stats_match_cv2_and_jax(name, connectivity):
    mask = MASKS[name]
    n_ref, l_ref, s_ref, _ = cv2.connectedComponentsWithStats(
        (mask > 0).astype(np.uint8), connectivity=connectivity)
    n, labels, stats = tn.connected_components_with_stats(mask,
                                                          connectivity)
    assert labels.dtype == np.int32 and stats.shape == (n, 5)
    assert n == n_ref
    assert _label_sets(labels) == _label_sets(l_ref)
    assert sorted(map(tuple, stats[1:].tolist())) == \
        sorted(map(tuple, s_ref[1:, :5].tolist()))
    assert (stats[0, 4] == s_ref[0, 4])
    jnum, jlabels, jstats = jn.connected_components_with_stats(mask,
                                                               connectivity)
    assert n == jnum
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(stats, jstats)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", ["random0.45", "rings", "checker", "empty",
                                  "full"])
def test_filters_match_jax(name, connectivity):
    mask = MASKS[name]
    for min_area in (0, 3, 40):
        np.testing.assert_array_equal(
            tn.filter_components_by_area(mask, min_area, connectivity),
            jn.filter_components_by_area(mask, min_area, connectivity))
    for keep, fallback in ((500, 200), (30, 2), (10 ** 6, 0)):
        np.testing.assert_array_equal(
            tn.keep_largest_component(mask, keep, fallback, connectivity),
            jn.keep_largest_component(mask, keep, fallback, connectivity))


def test_builds_into_the_build_dir():
    from unet_watermark_tpu_torch.ops.kernels import build

    assert tn.native_available()
    path = tn._lib()._name  # never the JAX package's native/libmaskops.so
    assert path.startswith(str(build.BUILD_DIR))
    assert path.rsplit("/", 1)[-1].startswith("libmaskops_")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No cv2 or Python fallback: a compiler that fails raises."""
    from unet_watermark_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CC", "false")
    tn._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            tn.connected_components_with_stats(MASKS["rings"])
    finally:
        tn._lib.cache_clear()
