"""UMAP, implemented from scratch on numpy/scipy.

The PyTorch port's own copy of ``ssrl_vit_mae_jepa_tpu/utils/umap_np.py``
(framework-free), for the representation visualizer, whose default method
is UMAP and whose umap-learn package is optional. The published algorithm
(McInnes, Healy & Melville, 2018):

1. exact k-NN graph (sklearn ``NearestNeighbors`` where sklearn is
   installed, else ``_knn_numpy``, an exact chunked search with the same
   neighbours),
2. per-point fuzzy membership via the smooth-kNN calibration — binary
   search for ``sigma_i`` so that ``sum_j exp(-(d_ij - rho_i)/sigma_i)
   = log2(k)``, with ``rho_i`` the distance to the nearest neighbor,
3. fuzzy-union symmetrization ``P + Pᵀ - P∘Pᵀ``,
4. spectral initialization from the normalized graph Laplacian,
5. SGD over edges with negative sampling, attraction/repulsion gradients
   of the ``1 / (1 + a·d^{2b})`` low-dimensional kernel (``a``/``b``
   fit from ``min_dist``/``spread``), linearly decaying learning rate.

Sized for the visualizer's workload (≤ ~20k points). With sklearn present
it computes what the JAX package's copy computes, bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _fit_ab(min_dist: float, spread: float) -> tuple[float, float]:
    """Least-squares fit of a, b so that ``1/(1 + a x^{2b})`` matches the
    piecewise target: 1 for x < min_dist, exp(-(x - min_dist)/spread)."""
    from scipy.optimize import curve_fit

    x = np.linspace(0.0, 3.0 * spread, 300)
    y = np.where(x < min_dist, 1.0, np.exp(-(x - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2.0 * b))

    (a, b), _ = curve_fit(curve, x, y, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


def _smooth_knn(dists: np.ndarray, k: int, n_iter: int = 64) -> np.ndarray:
    """Per-row binary search for sigma with target log2(k) (paper §3.1)."""
    target = np.log2(k)
    # rows may contain duplicates at distance 0: rho = smallest POSITIVE
    pos = np.where(dists > 0, dists, np.inf)
    rho = np.min(pos, axis=1)
    rho[~np.isfinite(rho)] = 0.0
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    sigma = np.ones(len(dists))
    for _ in range(n_iter):
        val = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
        # self-distance contributes exp(0)=1 in the first column — the
        # paper sums over the k neighbors excluding self
        s = val.sum(axis=1) - 1.0
        too_big = s > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(np.isfinite(hi), (lo + hi) / 2.0, sigma * 2.0)
    return np.maximum(sigma, 1e-12), rho


def _knn_numpy(feats: np.ndarray, k: int, chunk: int = 1024):
    """Exact Euclidean k-NN of every row among all rows (itself first),
    nearest first: (distances, indices), each (n, k)."""
    sq = np.sum(feats * feats, axis=1)
    dists, idx = [], []
    for lo in range(0, len(feats), chunk):
        q = feats[lo:lo + chunk]
        d2 = np.maximum(sq[lo:lo + chunk, None] + sq[None, :] - 2.0 * q @ feats.T, 0.0)
        d2[np.arange(len(q)), np.arange(lo, lo + len(q))] = -1.0  # self first
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(d2, part, axis=1), axis=1, kind="stable")
        nb = np.take_along_axis(part, order, axis=1)
        idx.append(nb)
        dists.append(np.sqrt(np.maximum(np.take_along_axis(d2, nb, axis=1), 0.0)))
    return np.concatenate(dists), np.concatenate(idx)


def _fuzzy_graph(feats: np.ndarray, k: int, rng: np.random.Generator):
    n = len(feats)
    try:
        from sklearn.neighbors import NearestNeighbors
    except ImportError:
        dists, idx = _knn_numpy(feats, min(k, n - 1) + 1)
    else:
        nn = NearestNeighbors(n_neighbors=min(k, n - 1) + 1).fit(feats)
        dists, idx = nn.kneighbors(feats)  # includes self in column 0
    sigma, rho = _smooth_knn(dists, k)
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), idx.shape[1])
    cols = idx.ravel()
    vals = w.ravel()
    keep = rows != cols  # drop self edges
    g = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n))
    g = g.tocsr()
    gt = g.T.tocsr()
    # fuzzy union: P + Pᵀ - P∘Pᵀ
    prod = g.multiply(gt)
    return (g + gt - prod).tocoo()


def _spectral_init(graph: sp.coo_matrix, dim: int, rng: np.random.Generator):
    n = graph.shape[0]
    try:
        from scipy.sparse.linalg import eigsh

        d = np.asarray(graph.sum(axis=1)).ravel()
        d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
        Dh = sp.diags(d_inv_sqrt)
        lap = sp.identity(n) - Dh @ graph.tocsr() @ Dh
        # smallest eigenvectors; k+1 to skip the trivial constant one
        vals, vecs = eigsh(lap, k=dim + 1, sigma=0.0, which="LM")
        order = np.argsort(vals)
        emb = vecs[:, order[1 : dim + 1]]
        scale = 10.0 / (np.abs(emb).max() + 1e-12)
        return (emb * scale) + rng.normal(0, 1e-4, (n, dim))
    except Exception:
        return rng.normal(0, 1.0, (n, dim))


def umap_embed(
    feats: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    spread: float = 1.0,
    n_epochs: int | None = None,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    random_state: int = 73,
) -> np.ndarray:
    """Project (n, d) features to (n, n_components) with UMAP."""
    feats = np.asarray(feats, dtype=np.float64)
    n = len(feats)
    if n <= n_components + 1:
        return np.zeros((n, n_components), np.float32)
    rng = np.random.default_rng(random_state)
    graph = _fuzzy_graph(feats, n_neighbors, rng)
    emb = _spectral_init(graph, n_components, rng).astype(np.float64)
    a, b = _fit_ab(min_dist, spread)

    if n_epochs is None:
        n_epochs = 500 if n < 10000 else 200
    w = graph.data
    heads, tails = graph.row, graph.col
    # edges sampled proportionally to weight: epochs between samples
    eps = np.full(len(w), np.inf)
    mask = w > 0
    eps[mask] = w.max() / w[mask]  # = n_epochs / (n_epochs * w / w.max())
    next_sample = eps.copy()

    clip = 4.0
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        active = next_sample <= epoch + 1
        idx_active = np.nonzero(active)[0]
        if len(idx_active) == 0:
            continue
        # process in vectorized chunks; per-edge serial updates in the
        # original are approximated batch-synchronously, which converges
        # equivalently at these sizes
        h = heads[idx_active]
        t = tails[idx_active]
        diff = emb[h] - emb[t]
        d2 = np.sum(diff * diff, axis=1)
        coeff = np.where(
            d2 > 0.0,
            (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0),
            0.0,
        )
        grad = np.clip(coeff[:, None] * diff, -clip, clip) * alpha
        np.add.at(emb, h, grad)
        np.add.at(emb, t, -grad)
        # negative samples
        n_neg = negative_sample_rate
        for _ in range(n_neg):
            r = rng.integers(0, n, size=len(idx_active))
            diff = emb[h] - emb[r]
            d2 = np.sum(diff * diff, axis=1)
            coeff = (2.0 * b) / ((0.001 + d2) * (a * d2**b + 1.0))
            coeff = np.where(h == r, 0.0, coeff)
            grad = np.clip(coeff[:, None] * diff, -clip, clip) * alpha
            np.add.at(emb, h, grad)
        next_sample[idx_active] += eps[idx_active]
    return emb.astype(np.float32)
