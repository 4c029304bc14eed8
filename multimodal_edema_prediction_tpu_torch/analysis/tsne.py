"""Exact t-SNE in torch, on the input's device: what the analysis suite's
figures take in place of ``sklearn.manifold.TSNE`` (JAX
``analysis/visualize_pathology.py:162`` and ``:215``), with sklearn's
defaults and schedule:

- squared Euclidean distances of the input (float32, as sklearn hands
  them on), and per point a binary search of the Gaussian's precision to
  the perplexity (float64; 100 steps, entropy within 1e-5);
- the joint P: the conditionals symmetrized and normalized, each pair at
  least float64's eps;
- ``init="pca"``: the first two principal components of the centered
  input, signed as sklearn's ``svd_flip`` signs them (each component's
  largest loading positive) and scaled so that column 0 has a std of 1e-4;
- ``learning_rate="auto"``: max(N / 12 / 4, 50);
- gradient descent with momentum and per-parameter gains (+0.2 where the
  gradient changes sign against the step, ×0.8 elsewhere, at least 0.01):
  250 iterations with P exaggerated 12× at momentum 0.5, then to
  ``max_iter`` 1000 at momentum 0.8; every 50 iterations the KL is read
  and the descent stops on a gradient norm of at most 1e-7 or no progress
  for 250 (the first stage) or 300 iterations;
- a Student-t kernel with one degree of freedom.

The embedding and its steps are float32, as sklearn keeps them; P, Q and
the gradient's sums are float64. sklearn's default method is Barnes-Hut,
so no exact t-SNE matches it point for point: the two agree in what t-SNE
optimizes (the final KL, the neighborhoods kept).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.double).eps)
# sklearn's defaults, which no caller changes
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """[N, N] squared Euclidean distances in float64 by differences,
    rounded to float32 (sklearn's ``_joint_probabilities`` casts them),
    back in float64."""
    x = x.to(torch.float64)
    d = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    return (d * d).to(torch.float32).to(torch.float64)


def conditional_probabilities(d2: torch.Tensor, perplexity: float,
                              n_steps: int = 100, tol: float = 1e-5
                              ) -> torch.Tensor:
    """sklearn's ``_binary_search_perplexity`` on every row at once: the
    row's precision β starts at 1 and is doubled, halved or bisected until
    the entropy of p_j|i ∝ exp(−d²·β) (j ≠ i) is within ``tol`` of
    log(perplexity); a row stops at the step where it gets there."""
    n = d2.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d2.device)
    target = math.log(perplexity)
    beta = torch.ones(n, dtype=torch.float64, device=d2.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d2.device)
    P = torch.zeros_like(d2)
    for _ in range(n_steps):
        p = torch.exp(-d2 * beta[:, None]) * off
        s = p.sum(dim=1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s[:, None]
        diff = torch.log(s) + beta * (d2 * p).sum(dim=1) - target
        P = torch.where(done[:, None], P, p)
        done = done | (diff.abs() <= tol)
        if bool(done.all()):
            break
        up = diff > 0.0
        new = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0))
        lo = torch.where(~done & up, beta, lo)
        hi = torch.where(~done & ~up, beta, hi)
        beta = torch.where(done, beta, new)
    return P


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetric [N, N] P of ``x`` (zero diagonal): sklearn's
    ``_joint_probabilities`` as a full matrix (its condensed P is the upper
    triangle of this one)."""
    cond = conditional_probabilities(squared_distances(x), perplexity)
    P = cond + cond.t()
    P = torch.clamp(P / torch.clamp(P.sum(), min=MACHINE_EPSILON),
                    min=MACHINE_EPSILON)
    return P.fill_diagonal_(0.0)


def pca_init(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """The first ``n_components`` principal components of ``x`` (float64
    SVD of the centered input, each component signed so that its largest
    loading is positive: sklearn's ``svd_flip(u_based_decision=False)``),
    as float32, scaled so that column 0 has a std of 1e-4."""
    xc = x.to(torch.float64)
    xc = xc - xc.mean(dim=0)
    U, S, Vh = torch.linalg.svd(xc, full_matrices=False)
    rows = torch.arange(Vh.shape[0], device=Vh.device)
    signs = torch.sign(Vh[rows, Vh.abs().argmax(dim=1)])
    emb = (U[:, :n_components] * signs[:n_components]
           * S[:n_components]).to(torch.float32)
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def kl_and_gradient(Y: torch.Tensor, P: torch.Tensor, dof: float = 1.0,
                    compute_error: bool = True):
    """(KL(P ‖ Q) as a float64 scalar tensor or None, its gradient in
    ``Y``'s dtype) for the embedding ``Y`` [N, c]: sklearn's
    ``_kl_divergence`` on the full matrices."""
    Y64 = Y.to(torch.float64)
    d2 = torch.cdist(Y64, Y64, compute_mode="donot_use_mm_for_euclid_dist")
    dist = (1.0 + d2 * d2 / dof) ** ((dof + 1.0) / -2.0)
    dist.fill_diagonal_(0.0)
    Q = torch.clamp(dist / dist.sum(), min=MACHINE_EPSILON).fill_diagonal_(
        0.0)
    kl = None
    if compute_error:
        off = P > 0
        kl = (P[off] * torch.log(P[off] / Q[off])).sum()
    W = (P - Q) * dist
    grad = (W.sum(dim=1, keepdim=True) * Y64 - W @ Y64).to(Y.dtype)
    return kl, grad * (2.0 * (dof + 1.0) / dof)


def gradient_descent(Y: torch.Tensor, P: torch.Tensor, it: int,
                     max_iter: int, momentum: float, learning_rate: float,
                     n_iter_without_progress: int):
    """sklearn's ``_gradient_descent`` (in place on ``Y``): returns (Y,
    the last KL read, the last iteration)."""
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        kl, grad = kl_and_gradient(Y, P,
                                   compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8),
                            min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        Y = Y + update
        error = float("nan") if kl is None else float(kl)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad.to(
                torch.float64)))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return Y, error, i


class TSNE:
    """The subset of ``sklearn.manifold.TSNE`` the analysis suite calls,
    exact: ``TSNE(n_components=2, perplexity=…, init="pca",
    random_state=…).fit_transform(X)`` with ``X`` a numpy array or a
    tensor (the embedding runs on its device); ``kl_divergence_`` and
    ``n_iter_`` as sklearn's. ``init`` and ``random_state`` are taken as
    the callers pass them to sklearn; the PCA start draws nothing, so
    ``random_state`` is unused."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 init: str = "pca", random_state=None):
        if init != "pca":
            raise ValueError(f"init={init!r}: only 'pca' is implemented")
        self.n_components = n_components
        self.perplexity = perplexity

    def fit_transform(self, x) -> np.ndarray:
        x = torch.as_tensor(x)
        n = x.shape[0]
        if self.perplexity >= n:
            raise ValueError(f"perplexity ({self.perplexity}) must be less "
                             f"than the number of samples ({n})")
        lr = max(n / EARLY_EXAGGERATION / 4, 50.0)
        P = joint_probabilities(x, self.perplexity)
        Y = pca_init(x, self.n_components)
        Y, kl, it = gradient_descent(
            Y, P * EARLY_EXAGGERATION, 0, EXPLORATION_ITER, 0.5, lr,
            n_iter_without_progress=EXPLORATION_ITER)
        Y, kl, it = gradient_descent(
            Y, P, it + 1, MAX_ITER, 0.8, lr,
            n_iter_without_progress=N_ITER_WITHOUT_PROGRESS)
        self.n_iter_ = it
        self.kl_divergence_ = kl
        self.embedding_ = Y.cpu().numpy()
        return self.embedding_
