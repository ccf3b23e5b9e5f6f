"""Least-squares reconstruction (port of channel_pruning_tpu/ops/lstsq.py).

Centred normal equations, a 1e-6·trace jitter so rank-deficient designs
stay Cholesky-factorisable in f32, and a Cholesky solve. Plain torch
matmuls: the JAX package left this work to XLA outside any kernel. The
intercept path reads nothing on the host, so the pipelined pass can queue
it behind the layer before.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LinearFactors(NamedTuple):
    chol: torch.Tensor      # lower Cholesky of (XcᵀXc + jitter·I)
    x_mean: torch.Tensor    # (d,)
    n: int


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.T)


def _jittered(G: torch.Tensor, ridge: float, jitter: float) -> torch.Tensor:
    scale = torch.clamp(torch.trace(G), min=1e-30)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return G + (ridge + jitter * scale) * eye


def factor(X: torch.Tensor, ridge: float = 0.0, jitter: float = 1e-6
           ) -> LinearFactors:
    """Factor the centred Gram matrix of X (N, d). `cholesky_ex` keeps its
    status on the device (`cholesky` checks it on the host, which on the
    card waits for the queue); a failed factorisation gives NaN factors, as
    the JAX package's does, and shows as a non-finite rMSE where the caller
    reads it."""
    x_mean = X.mean(dim=0)
    Xc = X - x_mean
    G = _jittered(_sym(Xc.T @ Xc), ridge, jitter)
    L, info = torch.linalg.cholesky_ex(G)
    return LinearFactors(chol=torch.where(info == 0, L, float("nan")),
                         x_mean=x_mean, n=X.shape[0])


def solve(f: LinearFactors, X: torch.Tensor, Y: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W (n_out, d), b (n_out,)) with Y ≈ X @ W.T + b, from cached factors,
    by two triangular solves (no host read)."""
    y_mean = Y.mean(dim=0)
    C = (X - f.x_mean).T @ (Y - y_mean)            # (d, n_out)
    Z = torch.linalg.solve_triangular(f.chol, C, upper=False)
    W = torch.linalg.solve_triangular(f.chol.T, Z, upper=True).T
    b = y_mean - W @ f.x_mean
    return W, b


def fit_linear(X: torch.Tensor, Y: torch.Tensor, ridge: float = 0.0,
               fit_intercept: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot least squares: W, b = argmin ||X W.T + b - Y||^2 (+ ridge)."""
    if not fit_intercept:
        G = _jittered(_sym(X.T @ X), ridge, 1e-6)
        W = torch.cholesky_solve(X.T @ Y, torch.linalg.cholesky(G)).T
        n_out = Y.shape[1] if Y.ndim > 1 else 1
        return W, torch.zeros(n_out, dtype=X.dtype, device=X.device)
    return solve(factor(X, ridge=ridge), X, Y)
