"""Minimal UMAP (Uniform Manifold Approximation and Projection): the
port's copy of ``multimodal_edema_prediction_tpu/analysis/umap_impl.py``,
the published algorithm (McInnes, Healy & Melville 2018) on numpy and
scipy, as the analysis suite's 2-D token projections use it (reference
``analysis/visualize_pathology.py:470-479``: ``umap.UMAP(n_components=2,
random_state=42)``):

1. exact kNN graph (``_knn``: brute force in torch on the input's device,
   in float64; the JAX copy calls sklearn's ``NearestNeighbors``);
2. per-point bandwidth calibration (``rho`` = nearest-neighbor distance,
   ``sigma`` binary-searched so the smoothed neighborhood has effective
   size ``log2(k)``);
3. fuzzy simplicial-set symmetrization ``A ∪ Aᵀ = A + Aᵀ − A∘Aᵀ``;
4. spectral initialization from the symmetric normalized graph Laplacian;
5. stochastic gradient layout with negative sampling, attraction/repulsion
   under the fitted low-dimensional similarity ``1/(1 + a·d^{2b})``.

Everything after the kNN is JAX's code, its ``default_rng`` draws in the
same order: the same input gives the same graph, eigenvector signs and
SGD. scipy is imported inside the functions that need it. Only the surface
the analysis suite uses is provided: ``UMAP(n_components=2,
random_state=…).fit_transform(X)`` (X a numpy array or a tensor on any
device) plus ``n_neighbors``/``min_dist``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["UMAP", "fuzzy_simplicial_set", "find_ab_params"]


def _knn(x, k: int, chunk: int = 1024):
    """Exact brute-force kNN (excluding self) of the rows of ``x`` (numpy
    or a tensor, on its device): Euclidean distances in float64 by
    differences (``torch.cdist``'s ``donot_use_mm_for_euclid_dist``, so
    that no cancellation reorders near neighbors), in chunks of ``chunk``
    rows, each row's ``min(k + 1, n)`` nearest by a stable sort (ties to
    the lower index), the first column dropped. Returns (indices,
    distances) as numpy arrays."""
    xt = torch.as_tensor(x).to(torch.float64)
    m = min(k + 1, xt.shape[0])
    idx, dist = [], []
    for i in range(0, xt.shape[0], chunk):
        d = torch.cdist(xt[i:i + chunk], xt,
                        compute_mode="donot_use_mm_for_euclid_dist")
        d, j = torch.sort(d, dim=1, stable=True)
        idx.append(j[:, :m].cpu())
        dist.append(d[:, :m].cpu())
    idx = torch.cat(idx).numpy()
    dist = torch.cat(dist).numpy()
    return idx[:, 1:], dist[:, 1:]          # drop the self-column


def _smooth_knn_dist(dist: np.ndarray, k: int, n_iter: int = 64,
                     local_connectivity: float = 1.0,
                     bandwidth: float = 1.0):
    """Binary-search per-point sigma so sum_j exp(-(d_j - rho)/sigma) = log2(k).

    Mirrors umap-learn's ``smooth_knn_dist``: ``rho`` is the distance to the
    ``local_connectivity``-th neighbor (ensuring every point is locally
    connected), ``sigma`` normalizes the neighborhood's effective size.
    """
    target = np.log2(k) * bandwidth
    n = dist.shape[0]
    rho = np.zeros(n)
    sigma = np.zeros(n)
    for i in range(n):
        d = dist[i]
        nonzero = d[d > 0.0]
        if len(nonzero) >= local_connectivity:
            rho[i] = nonzero[int(local_connectivity) - 1]
        elif len(nonzero) > 0:
            rho[i] = nonzero[-1]
        lo, hi, mid = 0.0, np.inf, 1.0
        for _ in range(n_iter):
            val = np.exp(-np.maximum(d - rho[i], 0.0) / mid).sum()
            if abs(val - target) < 1e-5:
                break
            if val > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi == np.inf else (lo + hi) / 2.0
        sigma[i] = max(mid, 1e-3 * (d.mean() if d.mean() > 0 else 1.0))
    return rho, sigma


def fuzzy_simplicial_set(x, n_neighbors: int):
    """kNN (``x`` numpy or a tensor) → per-point membership strengths →
    symmetrized fuzzy union.

    Returns a scipy CSR matrix ``A + Aᵀ − A∘Aᵀ`` of edge weights in [0, 1].
    """
    from scipy import sparse
    idx, dist = _knn(x, n_neighbors)
    rho, sigma = _smooth_knn_dist(dist, n_neighbors)
    n = x.shape[0]
    w = np.exp(-np.maximum(dist - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), idx.shape[1])
    a = sparse.csr_matrix((w.ravel(), (rows, idx.ravel())), shape=(n, n))
    at = a.T.tocsr()
    return a + at - a.multiply(at)


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Fit (a, b) of phi(d) = 1/(1 + a d^{2b}) to the desired offset-exponential
    target curve — identical formulation to umap-learn's ``find_ab_params``."""
    from scipy.optimize import curve_fit

    def curve(d, a, b):
        return 1.0 / (1.0 + a * d ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv)
    return float(a), float(b)


def _spectral_init(graph, n_components: int, rng: np.random.Generator):
    """Embedding from the bottom nontrivial eigenvectors of the symmetric
    normalized Laplacian; random fallback when eigsh fails to converge."""
    from scipy import sparse
    from scipy.sparse.linalg import eigsh
    n = graph.shape[0]
    deg = np.asarray(graph.sum(axis=1)).ravel()
    deg[deg == 0] = 1.0
    d_inv_sqrt = sparse.diags(1.0 / np.sqrt(deg))
    lap = sparse.identity(n) - d_inv_sqrt @ graph @ d_inv_sqrt
    k = n_components + 1
    try:
        # shift-invert around 0 for the smallest eigenpairs
        _, vecs = eigsh(lap.tocsc(), k=k, sigma=0.0, which="LM",
                        maxiter=max(5000, 20 * n), tol=1e-4,
                        v0=rng.standard_normal(n))
        emb = vecs[:, 1:k]
        # umap-learn scales the spectral init to ~[-10, 10]
        expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
        return (emb * expansion).astype(np.float32)
    except Exception:
        return rng.uniform(-10.0, 10.0, (n, n_components)).astype(np.float32)


class UMAP:
    """Drop-in for the subset of ``umap.UMAP`` the analysis suite uses."""

    def __init__(self, n_components: int = 2, n_neighbors: int = 15,
                 min_dist: float = 0.1, spread: float = 1.0,
                 n_epochs: int | None = None, learning_rate: float = 1.0,
                 negative_sample_rate: int = 5,
                 random_state: int | None = None):
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate
        self.random_state = random_state
        self.embedding_ = None

    def fit_transform(self, x) -> np.ndarray:
        """``x`` [n, d], numpy or a tensor (the kNN runs on its device)."""
        x = torch.as_tensor(x).to(torch.float64)
        n = x.shape[0]
        if n <= self.n_components:
            return np.zeros((n, self.n_components), dtype=np.float32)
        k = int(min(self.n_neighbors, n - 1))
        rng = np.random.default_rng(self.random_state)

        graph = fuzzy_simplicial_set(x, k).tocoo()
        n_epochs = self.n_epochs or (500 if n < 10_000 else 200)
        # drop edges too weak to ever be sampled (umap-learn semantics)
        keep = graph.data >= graph.data.max() / float(n_epochs)
        head, tail = graph.row[keep], graph.col[keep]
        weight = graph.data[keep]

        emb = _spectral_init(graph.tocsr(), self.n_components, rng)
        a, b = find_ab_params(self.spread, self.min_dist)
        # add a small jitter so coincident spectral coords can separate
        emb = emb + rng.normal(scale=1e-4, size=emb.shape).astype(np.float32)

        self.embedding_ = _optimize_layout(
            emb.astype(np.float64), head.astype(np.int64),
            tail.astype(np.int64), weight, n_epochs, a, b,
            self.learning_rate, self.negative_sample_rate, rng,
        ).astype(np.float32)
        return self.embedding_


def _scatter_add(emb, idx, vals):
    """emb[idx] += vals with duplicate indices accumulated.

    ``np.bincount`` per output dimension is ~20x faster than ``np.add.at``
    (unbuffered ufunc) at the edge counts the analysis suite produces;
    n_components is 2, so this is two bincounts per scatter.
    """
    for d in range(emb.shape[1]):
        emb[:, d] += np.bincount(idx, weights=vals[:, d],
                                 minlength=emb.shape[0])


def _optimize_layout(emb, head, tail, weight, n_epochs, a, b, lr,
                     neg_rate, rng):
    """Vectorized negative-sampling SGD over the graph's edges.

    umap-learn iterates edges one by one in numba; here each epoch samples
    edges by weight in one vectorized batch (same expectation as its
    ``epochs_per_sample`` schedule) and applies the standard attractive /
    repulsive gradients with the ±4 clip.
    """
    n = emb.shape[0]
    n_edges = len(head)
    if n_edges == 0:
        return emb
    p_edge = weight / weight.sum()
    batch = max(1, n_edges)
    for epoch in range(n_epochs):
        alpha = lr * (1.0 - epoch / float(n_epochs))
        e = rng.choice(n_edges, size=batch, p=p_edge)
        h, t = head[e], tail[e]
        d = emb[h] - emb[t]
        dsq = (d * d).sum(axis=1)
        # attractive: grad_coeff = -2ab d^{2(b-1)} / (1 + a d^{2b})
        coeff = (-2.0 * a * b * np.power(np.maximum(dsq, 1e-12), b - 1.0)
                 / (a * np.power(np.maximum(dsq, 1e-12), b) + 1.0))
        grad = np.clip(coeff[:, None] * d, -4.0, 4.0)
        _scatter_add(emb, h, alpha * grad)
        _scatter_add(emb, t, -alpha * grad)
        # repulsive: negative samples for the head points
        for _ in range(neg_rate):
            neg = rng.integers(0, n, size=batch)
            d = emb[h] - emb[neg]
            dsq = (d * d).sum(axis=1)
            coeff = (2.0 * b
                     / ((0.001 + dsq)
                        * (a * np.power(np.maximum(dsq, 1e-12), b) + 1.0)))
            coeff = np.where(neg == h, 0.0, coeff)
            grad = np.clip(coeff[:, None] * d, -4.0, 4.0)
            _scatter_add(emb, h, alpha * grad)
    return emb
