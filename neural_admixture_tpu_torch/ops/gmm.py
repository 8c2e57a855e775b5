"""Gaussian-mixture initialisation in PCA space.

The JAX package's ops/gmm.py ``fit_gmm``, with the same algorithm and
hyperparameters: k-means++ seeding by plain D^2 sampling, initial
responsibilities one-hot on the nearest seeded centre, full-covariance EM
(reg_covar 1e-6 on the diagonal) until the mean log-likelihood moves by
less than ``tol`` or ``max_iter`` iterations, the best lower bound of
``n_init`` restarts kept. fp32; the restarts run as one batch, each
stopping on its own.

Random draws come from a CPU ``torch.Generator``, so a given seed gives the
same seeding wherever the EM runs; they cannot reproduce the JAX package's
``jax.random`` draws (ROADMAP.md Rules). ``resp0`` hands in the initial
responsibilities instead (the tests start both packages from the same).
"""
from typing import NamedTuple, Optional

import torch

_LOG2PI = 1.8378770664093453


class GMMResult(NamedTuple):
    means: torch.Tensor        # (K, D)
    covariances: torch.Tensor  # (K, D, D)
    weights: torch.Tensor      # (K,)
    lower_bound: torch.Tensor  # scalar, mean log-likelihood of the best run
    n_iter: torch.Tensor       # iterations the best run took


def _kmeans_plusplus(gen: torch.Generator, X: torch.Tensor,
                     K: int) -> torch.Tensor:
    """(K, D) centres: the first uniformly, each next with probability
    proportional to its squared distance to the nearest centre so far."""
    N = X.shape[0]
    i0 = int(torch.randint(N, (), generator=gen))
    centers = [X[i0]]
    d2 = torch.sum(torch.square(X - X[i0]), dim=-1)
    for _ in range(1, K):
        w = (d2 + 1e-30).to(torch.float64).cpu()
        idx = int(torch.multinomial(w / w.sum(), 1, generator=gen))
        centers.append(X[idx])
        d2 = torch.minimum(d2, torch.sum(torch.square(X - X[idx]), dim=-1))
    return torch.stack(centers)


def _log_gauss(X, means, covs):
    """X (N, D), means (R, K, D), covs (R, K, D, D) -> (R, N, K) log
    N(x | mu_k, Sigma_k)."""
    D = X.shape[1]
    L = torch.linalg.cholesky(covs)
    diff = (X[None, None] - means[:, :, None, :]).transpose(-1, -2)
    y = torch.linalg.solve_triangular(L, diff, upper=False)  # (R, K, D, N)
    maha = torch.sum(torch.square(y), dim=-2)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             dim=-1)
    return (-0.5 * (D * _LOG2PI + logdet[..., None] + maha)).transpose(1, 2)


def _m_step(X, resp, reg_covar: float):
    """resp (R, N, K) -> means (R, K, D), covs (R, K, D, D), weights
    (R, K)."""
    N, D = X.shape
    nk = resp.sum(dim=1) + 10.0 * torch.finfo(resp.dtype).eps
    means = (resp.transpose(1, 2) @ X) / nk[..., None]
    diff = X[None, None] - means[:, :, None, :]             # (R, K, N, D)
    w = resp.transpose(1, 2)[..., None]                     # (R, K, N, 1)
    covs = (diff * w).transpose(-1, -2) @ diff / nk[..., None, None]
    covs = covs + reg_covar * torch.eye(D, dtype=X.dtype, device=X.device)
    return means, covs, nk / N


def _e_step(X, means, covs, weights):
    wlp = _log_gauss(X, means, covs) + torch.log(weights)[:, None, :]
    lse = torch.logsumexp(wlp, dim=2)
    return wlp, lse


def fit_gmm(X: torch.Tensor, K: int, gen: Optional[torch.Generator] = None,
            n_init: int = 5, max_iter: int = 100, tol: float = 1e-4,
            reg_covar: float = 1e-6,
            resp0: Optional[torch.Tensor] = None) -> GMMResult:
    """Fit a full-covariance GMM to X (N, D); the best of ``n_init`` runs.

    ``resp0`` (n_init, N, K): the initial responsibilities, in place of the
    k-means++ seeding (then ``gen`` is not read)."""
    X = X.to(torch.float32)
    if resp0 is None:
        resp0 = []
        for _ in range(n_init):
            centers = _kmeans_plusplus(gen, X, K)
            d2 = torch.sum(torch.square(X[:, None, :] - centers[None]), dim=-1)
            resp0.append(torch.nn.functional.one_hot(
                torch.argmin(d2, dim=1), K).to(X.dtype))
        resp0 = torch.stack(resp0)
    resp0 = resp0.to(X)
    R = resp0.shape[0]
    means, covs, weights = _m_step(X, resp0, reg_covar)
    prev_lb = torch.full((R,), -float("inf"), dtype=X.dtype, device=X.device)
    lb = torch.full((R,), float("inf"), dtype=X.dtype, device=X.device)
    n_iter = torch.zeros(R, dtype=torch.int64, device=X.device)
    for _ in range(max_iter):
        active = torch.abs(lb - prev_lb) >= tol
        if not bool(active.any()):
            break
        wlp, lse = _e_step(X, means, covs, weights)
        resp = torch.exp(wlp - lse[..., None])
        m2, c2, w2 = _m_step(X, resp, reg_covar)
        means = torch.where(active[:, None, None], m2, means)
        covs = torch.where(active[:, None, None, None], c2, covs)
        weights = torch.where(active[:, None], w2, weights)
        prev_lb = torch.where(active, lb, prev_lb)
        lb = torch.where(active, lse.mean(dim=1), lb)
        n_iter = n_iter + active.to(n_iter.dtype)
    # One final e-step: the lower bound of the final parameters.
    lb = _e_step(X, means, covs, weights)[1].mean(dim=1)
    best = int(torch.argmax(lb))
    return GMMResult(means[best], covs[best], weights[best], lb[best],
                     n_iter[best])
