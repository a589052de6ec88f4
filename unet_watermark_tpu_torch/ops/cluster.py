"""Clustering and projection with scikit-learn 1.9's semantics, on torch
tensors (the card's machine has no sklearn): the distances, the Lloyd
steps and the decompositions run on the features' device in float64; the
random draws come from numpy's RandomState on the host, in sklearn's
order, so a seed gives sklearn's result.

  dbscan(x, eps, min_samples, metric)   DBSCAN(...).fit_predict(x): a
      point with at least min_samples neighbours within eps (itself
      counted) is a core point; clusters are the core points joined by
      eps-links, numbered by their first core point in index order; a
      border point takes the first cluster that reaches it (the lowest
      number among its core neighbours); noise is -1. "euclidean" compares
      squared distances with eps² (the KD tree's reduced distance),
      "cosine" compares 1 - cos with eps.
  kmeans(x, k, seed, n_init)            KMeans(k, random_state=seed,
      n_init=n_init).fit: k-means++ with 2 + int(log k) local trials, then
      Lloyd on the centred data until the labels stop changing or the
      centres move less than tol × the features' mean variance (squared),
      the best inertia over the runs kept unless it is the same
      clustering; returns (labels, centres).
  pca(x, n_components, seed)            PCA(n_components,
      random_state=seed).fit_transform(x) with svd_solver="auto" as 1.9
      resolves it: covariance_eigh (≤ 1000 features and ≥ 10× as many
      samples), full (max side ≤ 500), randomized (n_components < 0.8 ×
      the smaller side: LU power iterations, 10 oversamples), else full;
      signs by svd_flip on the components' rows.
  l2_normalize(x)                       sklearn.preprocessing.normalize.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MAX_ITER = 300
TOL = 1e-4


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm (a zero row stays zero)."""
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norms == 0, torch.ones_like(norms), norms)


def _neighbours(x: torch.Tensor, eps: float, metric: str) -> torch.Tensor:
    """(N, N) bool: j within eps of i."""
    x = x.to(torch.float64)
    if metric == "euclidean":
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        return d2 <= eps * eps
    if metric == "cosine":
        u = l2_normalize(x)
        return (1.0 - u @ u.T).clamp(0.0, 2.0) <= eps
    raise ValueError(f"metric {metric!r}: 'euclidean' or 'cosine'")


def dbscan(x: torch.Tensor, eps: float, min_samples: int = 5,
           metric: str = "euclidean") -> np.ndarray:
    """(N, D) features → (N,) int64 labels, as sklearn's DBSCAN."""
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    near = _neighbours(x, eps, metric)
    core = near.sum(1) >= min_samples
    # clusters: components of the core points' eps-graph, each named by
    # its smallest core index (min-label propagation to a fixed point)
    idx = torch.arange(n, device=x.device)
    big = torch.full((n,), n, device=x.device, dtype=torch.int64)
    link = near & core[:, None] & core[None, :]
    comp = torch.where(core, idx, big)
    while True:
        cand = torch.where(link, comp[None, :], big[None, :]).amin(1)
        new = torch.where(core, torch.minimum(comp, cand), big)
        if torch.equal(new, comp):
            break
        comp = new
    # a border point joins the cluster of its first-numbered core neighbour
    reach = torch.where(near & core[None, :], comp[None, :],
                        big[None, :]).amin(1)
    root = torch.where(core, comp, reach).cpu().numpy()
    labels = np.full(n, -1, np.int64)
    roots = np.unique(root[root < n])  # cluster k: the k-th smallest root
    labels[root < n] = np.searchsorted(roots, root[root < n])
    return labels


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def _kmeans_plusplus(x: torch.Tensor, k: int,
                     rs: np.random.RandomState) -> torch.Tensor:
    """sklearn's _kmeans_plusplus (unit weights): the first centre by
    rs.choice, then each next one the best of 2 + int(log k) candidates
    drawn by rs.uniform against the running potential."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    w = np.ones(n, np.float32)
    first = rs.choice(n, p=w / w.sum())
    ids = [int(first)]
    closest = _sq_dist(x[first:first + 1], x)[0]
    pot = float(closest.sum())
    for _ in range(1, k):
        rand = rs.uniform(size=trials) * pot
        cum = torch.cumsum(closest, 0).cpu().numpy()
        cand = np.minimum(np.searchsorted(cum, rand), n - 1)
        dist = torch.minimum(closest[None, :],
                             _sq_dist(x[torch.as_tensor(cand,
                                                        device=x.device)], x))
        pots = dist.sum(1)
        best = int(torch.argmin(pots))
        pot = float(pots[best])
        closest = dist[best]
        ids.append(int(cand[best]))
    return x[torch.as_tensor(ids, device=x.device)].clone()


def _assign(x: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    return torch.argmin(_sq_dist(x, centres), dim=1)


def _lloyd(x: torch.Tensor, centres: torch.Tensor, tol: float
           ) -> Tuple[torch.Tensor, float, torch.Tensor]:
    """sklearn's _kmeans_single_lloyd: (labels, inertia, centres)."""
    k = centres.shape[0]
    labels_old = None
    strict = False
    for _ in range(MAX_ITER):
        labels = _assign(x, centres)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        sums = torch.zeros_like(centres).index_add_(0, labels, x)
        empty = torch.nonzero(counts == 0).flatten().tolist()
        if empty:  # _relocate_empty_clusters_dense: the farthest points
            far = torch.argsort(((x - centres[labels]) ** 2).sum(1),
                                descending=True, stable=True)
            for c, p in zip(empty, far[:len(empty)].tolist()):
                old = int(labels[p])
                sums[old] -= x[p]
                sums[c] = x[p]
                counts[old] -= 1
                counts[c] = 1
        new = torch.where(counts[:, None] > 0,
                          sums / counts.clamp(min=1)[:, None], sums)
        shift = float((torch.linalg.vector_norm(new - centres, dim=1)
                       ** 2).sum())
        centres = new
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centres)
    inertia = float(((x - centres[labels]) ** 2).sum())
    return labels, inertia, centres


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """sklearn's _is_same_clustering: b is a relabelling of a."""
    mapping = np.full(k, -1)
    for i, j in zip(a, b):
        if mapping[i] == -1:
            mapping[i] = j
        elif mapping[i] != j:
            return False
    return True


def kmeans(x: torch.Tensor, k: int, seed: int = 0, n_init: int = 10
           ) -> Tuple[np.ndarray, torch.Tensor]:
    """(N, D) features → ((N,) int64 labels, (k, D) centres in x's dtype),
    as sklearn's KMeans(k, random_state=seed, n_init=n_init)."""
    rs = np.random.RandomState(seed)
    xd = x.to(torch.float64)
    tol = float(xd.var(0, unbiased=False).mean()) * TOL
    mean = xd.mean(0)
    xc = xd - mean
    best = None
    for _ in range(n_init):
        labels, inertia, centres = _lloyd(xc, _kmeans_plusplus(xc, k, rs),
                                          tol)
        lab = labels.cpu().numpy()
        if best is None or (inertia < best[1] and not _same_clustering(
                lab, best[0], k)):
            best = (lab, inertia, centres)
    return best[0].astype(np.int64), (best[2] + mean).to(x.dtype)


def _flip(vt: torch.Tensor, u=None):
    """svd_flip(u, vt, u_based_decision=False)."""
    rows = torch.arange(vt.shape[0], device=vt.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(1)])
    vt = vt * signs[:, None]
    return vt, (None if u is None else u * signs[None, :])


def pca_solver(n: int, d: int, n_components: int) -> str:
    """svd_solver="auto" as sklearn 1.9 resolves it for dense data."""
    if d <= 1000 and n >= 10 * d:
        return "covariance_eigh"
    if max(n, d) <= 500:
        return "full"
    if 1 <= n_components < 0.8 * min(n, d):
        return "randomized"
    return "full"


def _range_finder(a: torch.Tensor, size: int, n_iter: int,
                  rs: np.random.RandomState) -> torch.Tensor:
    """sklearn's _randomized_range_finder with the LU normalizer (n_iter >
    2, as "auto" picks), or none."""
    q = torch.as_tensor(rs.normal(size=(a.shape[1], size)),
                        dtype=a.dtype, device=a.device)

    def lu(m):
        if n_iter <= 2:
            return m
        p, low, _ = torch.linalg.lu(m)
        return p @ low

    for _ in range(n_iter):
        q = lu(a @ q)
        q = lu(a.T @ q)
    return torch.linalg.qr(a @ q, mode="reduced")[0]


def pca(x: torch.Tensor, n_components: int, seed: int = 0) -> torch.Tensor:
    """(N, D) → (N, n_components) in x's dtype, as sklearn's
    PCA(n_components, random_state=seed).fit_transform(x)."""
    n, d = x.shape
    xd = x.to(torch.float64)
    mean = xd.mean(0)
    xc = xd - mean
    solver = pca_solver(n, d, n_components)
    if solver == "covariance_eigh":
        c = (xd.T @ xd - n * mean[:, None] * mean[None, :]) / (n - 1)
        _, vecs = torch.linalg.eigh(c)
        vt, _ = _flip(vecs.flip(1).T)
        return (xc @ vt[:n_components].T).to(x.dtype)
    if solver == "full":
        u, s, vt = torch.linalg.svd(xc, full_matrices=False)
        vt, u = _flip(vt, u)
        return (u[:, :n_components] * s[:n_components]).to(x.dtype)
    rs = np.random.RandomState(seed)
    n_iter = 7 if n_components < 0.1 * min(n, d) else 4
    m = xc.T if n < d else xc
    q = _range_finder(m, n_components + 10, n_iter, rs)
    uhat, s, vt = torch.linalg.svd(q.T @ m, full_matrices=False)
    u = q @ uhat
    if n < d:  # the transposed problem: swap the factors back
        u, vt = vt.T, u.T
    u, s, vt = u[:, :n_components], s[:n_components], vt[:n_components]
    vt, u = _flip(vt, u)
    return (u * s).to(x.dtype)
