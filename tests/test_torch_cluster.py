"""ops/cluster.py against scikit-learn 1.9 on the CPU: DBSCAN's labels
(euclidean and cosine, with noise and border points), KMeans' labels and
centres under the same seed, PCA's projection for each solver that
svd_solver="auto" picks, and the L2 normalization.

Tolerances: labels exactly equal; KMeans centres within 1e-4 (the port
runs Lloyd in float64 where sklearn keeps float32); PCA within 1e-4 of the
largest projected value (float64 decompositions against sklearn's
float32 LAPACK calls)."""
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN, KMeans
from sklearn.decomposition import PCA
from sklearn.preprocessing import normalize

from unet_watermark_tpu_torch.ops import cluster

CENTRE_ATOL = 1e-4
PCA_RTOL = 1e-4


def _blobs(rng, n, d, k, spread=1.0):
    centres = rng.normal(size=(k, d)) * 4
    return (centres[rng.integers(0, k, n)]
            + rng.normal(size=(n, d)) * spread).astype(np.float32)


@pytest.mark.parametrize("eps,min_samples", [(0.8, 3), (1.2, 4), (0.5, 1),
                                             (2.0, 10)])
def test_dbscan_euclidean_equals_sklearn(eps, min_samples):
    x = np.random.default_rng(0).normal(size=(80, 2)) * 3
    want = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(x)
    got = cluster.dbscan(torch.from_numpy(x), eps, min_samples)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", ["a_first", "b_first"])
def test_dbscan_border_point_goes_to_the_first_cluster(order):
    # 1.5 is within eps of a core of each cluster but has only 3
    # neighbours: a border point, taken by the cluster numbered first
    a, b = [0.0, 0.2, 0.4, 0.6], [2.4, 2.6, 2.8, 3.0]
    first, second = (a, b) if order == "a_first" else (b, a)
    x = np.array(first + [1.5] + second + [9.0])[:, None]
    want = DBSCAN(eps=1.0, min_samples=4).fit_predict(x)
    got = cluster.dbscan(torch.from_numpy(x), 1.0, 4)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0] * 5 + [1] * 4 + [-1]


@pytest.mark.parametrize("eps,min_samples", [(0.3, 2), (0.5, 3), (0.1, 2),
                                             (0.05, 2), (0.08, 3)])
def test_dbscan_cosine_equals_sklearn(eps, min_samples):
    rng = np.random.default_rng(1)
    f = rng.normal(size=(60, 16)) + np.repeat(
        rng.normal(size=(4, 16)) * 3, 15, 0)
    f = normalize(f).astype(np.float32)
    want = DBSCAN(eps=eps, min_samples=min_samples,
                  metric="cosine").fit_predict(f)
    got = cluster.dbscan(torch.from_numpy(f), eps, min_samples, "cosine")
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist()) - {-1}) >= 2


@pytest.mark.parametrize("n,d,k,seed", [(60, 8, 4, 42), (200, 112, 5, 42),
                                        (30, 384, 5, 0), (13, 3, 13, 7),
                                        (90, 64, 3, 1)])
def test_kmeans_equals_sklearn(n, d, k, seed):
    x = _blobs(np.random.default_rng(n + d), n, d, k)
    km = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(x)
    labels, centres = cluster.kmeans(torch.from_numpy(x), k, seed)
    np.testing.assert_array_equal(labels, km.labels_)
    assert centres.dtype == torch.float32
    np.testing.assert_allclose(centres.numpy(), km.cluster_centers_,
                               atol=CENTRE_ATOL)


@pytest.mark.parametrize("n,d,nc", [(700, 64, 16), (300, 20, 5),
                                    (200, 112, 64), (100, 384, 64),
                                    (600, 768, 64), (60, 900, 50)])
def test_pca_equals_sklearn_for_each_auto_solver(n, d, nc):
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(n, d)) * np.exp(-np.arange(d) / 8)).astype(
        np.float32)
    want = PCA(n_components=nc, random_state=42).fit_transform(x)
    got = cluster.pca(torch.from_numpy(x), nc, 42).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= PCA_RTOL * np.abs(want).max()


def test_pca_picks_sklearns_solvers():
    picked = {cluster.pca_solver(n, d, k) for n, d, k in
              [(700, 64, 16), (200, 112, 64), (600, 768, 64), (60, 900, 50)]}
    assert picked == {"covariance_eigh", "full", "randomized"}


def test_l2_normalize_equals_sklearn():
    x = np.random.default_rng(2).normal(size=(10, 7)).astype(np.float32)
    x[3] = 0
    np.testing.assert_allclose(
        cluster.l2_normalize(torch.from_numpy(x)).numpy(), normalize(x),
        rtol=1e-6, atol=1e-7)
