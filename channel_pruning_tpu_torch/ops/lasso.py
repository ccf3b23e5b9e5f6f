"""LASSO channel selection (port of channel_pruning_tpu/ops/lasso.py).

1. Z[:, i] = X_i ⊛ W2_i, the per-input-channel partial responses of the
   consumer (one batched matmul);
2. the Gram reduction G = ZᵀZ, b = Zᵀy;
3. Gram-form cyclic coordinate descent over a whole grid of alphas
   (kernels/lasso_cd: the CUDA kernel on the card; its plain version
   `cd_solve_grid_plain`, the port of the reference's `cd_solve` /
   `cd_solve_grid`, on the CPU);
4. the host-stepped grid refinement of `search_alpha`, until some alpha's
   support lands in [rank, rank + rank_tol·rank].

The JAX CLI defaults to the fused one-program search (`_fused_search`);
this port runs the host-stepped search, which the JAX suite pins as exact.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from channel_pruning_tpu_torch.kernels import lasso_cd


class LassoGram(NamedTuple):
    G: torch.Tensor     # (c, c)  ZᵀZ
    b: torch.Tensor     # (c,)    Zᵀy
    n_samples: int      # N rows of Z


def build_channel_response(X: torch.Tensor, W2: torch.Tensor) -> torch.Tensor:
    """X: (N, c, kh, kw) input patches; W2: (n, c, kh, kw) consumer weights.
    Returns Z: (N*n, c) with Z[:, i] = vec(X[:, i] · W2[:, i]ᵀ)."""
    N, c = X.shape[0], X.shape[1]
    n = W2.shape[0]
    xr = X.reshape(N, c, -1).permute(1, 0, 2)          # (c, N, khkw)
    wr = W2.reshape(n, c, -1).permute(1, 2, 0)         # (c, khkw, n)
    return torch.bmm(xr, wr).reshape(c, N * n).T


def lasso_gram(Z: torch.Tensor, y: torch.Tensor) -> LassoGram:
    G = Z.T @ Z
    G = 0.5 * (G + G.T)       # exactly symmetric: the kernel reads row j
    return LassoGram(G=G.contiguous(), b=(Z.T @ y).contiguous(),
                     n_samples=Z.shape[0])


def support_mask(betas: torch.Tensor, rel_eps: float = 1e-6) -> torch.Tensor:
    """Nonzero mask with a relative threshold (CD paths that differ only in
    stopping order leave ~1e-7 residues on coordinates a stricter run keeps
    at exactly 0 — both count as inactive)."""
    scale = torch.clamp(betas.abs().amax(dim=-1, keepdim=True), min=1e-30)
    return betas.abs() > rel_eps * scale


def support_sizes(betas: torch.Tensor) -> torch.Tensor:
    return support_mask(betas).sum(dim=-1)


def search_alpha(gram: LassoGram, rank: int, rank_tol: float,
                 alpha0: float = 1e-3, grid_size: int = 16,
                 max_rounds: int = 8, n_sweeps: int = 200,
                 prefer: str = "top") -> tuple[np.ndarray, float, int]:
    """Find a support of size in [rank, rank + rank_tol*rank]; returns
    (bool mask, alpha, support size). Line for line the JAX package's
    host-stepped search: float64 grid endpoints on the host, a geometric
    bracket, linear refinement toward the `prefer` end of the band, and on
    the "bottom" path the exact-count trim (smallest support >= rank,
    dropping its smallest |beta|) or top-up (highest-energy excluded
    channels)."""
    c = int(gram.G.shape[0])
    if rank >= c:
        return np.ones(c, bool), 0.0, c
    lbound = rank
    rbound = rank + (rank_tol if rank_tol >= 1 else rank_tol * rank)
    N = gram.n_samples
    top = prefer == "top"

    alphas = alpha0 * (2.0 ** np.arange(-2, grid_size - 2, dtype=np.float64))
    lo, hi = 0.0, None
    best_cand = None  # (support, mask, alpha) — best in-band seen so far
    best_over = None  # (support, |beta|, alpha) — smallest support >= rank
    refines = 0
    for _ in range(max_rounds):
        a = torch.as_tensor(alphas * N, dtype=gram.G.dtype).to(gram.G.device)
        betas = lasso_cd.cd_solve_grid(gram.G, gram.b, a, n_sweeps=n_sweeps)
        masks = support_mask(betas).cpu().numpy()
        supports = masks.sum(axis=1)
        if not top:
            ge = np.where(supports >= lbound)[0]
            if ge.size:
                gi = ge[supports[ge].argmin()]
                if best_over is None or supports[gi] < best_over[0]:
                    best_over = (int(supports[gi]),
                                 betas[gi].abs().cpu().numpy(),
                                 float(alphas[gi]))
        in_band = np.where((supports >= lbound) & (supports <= rbound))[0]
        if in_band.size:
            pick = np.argmax if top else np.argmin
            bi = in_band[pick(supports[in_band])]
            better = (best_cand is None or
                      (supports[bi] > best_cand[0] if top
                       else supports[bi] < best_cand[0]))
            if better:
                best_cand = (int(supports[bi]), masks[bi].copy(),
                             float(alphas[bi]))
            if (best_cand[0] >= int(rbound)) if top else \
                    (best_cand[0] <= lbound):
                break
            refines += 1
            if refines > 2:
                break
            if top:
                over_i = np.where(supports > rbound)[0]
                a_hi = best_cand[2]
                a_lo = float(alphas[over_i[supports[over_i].argmin()]]) \
                    if over_i.size else max(lo, a_hi / 2.0)
            else:
                under_i = np.where(supports < lbound)[0]
                a_lo = best_cand[2]
                a_hi = float(alphas[under_i[supports[under_i].argmax()]]) \
                    if under_i.size else (hi if hi is not None else a_lo * 2.0)
            if a_hi - a_lo <= 1e-12 * max(a_hi, 1e-30):
                break
            alphas = np.linspace(a_lo, a_hi, grid_size + 2,
                                 dtype=np.float64)[1:-1]
            continue
        over = np.where(supports > rbound)[0]   # alpha too small
        under = np.where(supports < lbound)[0]  # alpha too big
        if over.size:
            lo = float(alphas[over[supports[over].argmin()]])
        if under.size:
            hi = float(alphas[under[supports[under].argmax()]])
        if hi is None:
            alphas = alphas * (2.0 ** grid_size)
            continue
        if not over.size:
            lo = hi / (2.0 ** grid_size)
        alphas = np.linspace(lo, hi, grid_size + 2, dtype=np.float64)[1:-1]
    if not top and (best_cand is None or best_cand[0] != lbound):
        if best_over is not None:
            absb, alpha = best_over[1], best_over[2]
            mask = np.zeros(c, bool)
            mask[np.argsort(-absb)[:rank]] = True
            return mask, alpha, int(mask.sum())
        dist = np.abs(supports - lbound)
        bi = int(np.argmin(dist))
        mask = masks[bi].copy()
        short = rank - int(mask.sum())
        if short > 0:
            energy = np.where(mask, -np.inf, torch.diagonal(gram.G).cpu()
                              .numpy().astype(np.float64))
            mask[np.argsort(-energy)[:short]] = True
        return mask, float(alphas[bi]), int(mask.sum())
    if best_cand is not None:
        return best_cand[1], best_cand[2], best_cand[0]
    dist = np.minimum(np.abs(supports - lbound), np.abs(supports - rbound))
    best = int(np.argmin(dist))
    return masks[best], float(alphas[best]), int(supports[best])


def select_channels(X: torch.Tensor, W2: torch.Tensor, Y: torch.Tensor,
                    rank: int, *, alpha0: float = 1e-3, rank_tol: float = 0.1,
                    subsample: int = 400, seed: int = 0, grid_size: int = 16,
                    max_rounds: int = 8, n_sweeps: int = 200,
                    prefer: str = "top") -> tuple[np.ndarray, float, int]:
    """End-to-end selection for one layer. X: (N, c, kh, kw) patches,
    W2: (n, c, kh, kw), Y: (N, n) targets, all on one device. The row
    subsample is numpy's `default_rng(seed).integers`, so both packages use
    the same rows."""
    N = X.shape[0]
    n_sub = min(subsample, max(N // 20, 1))
    rows = np.random.default_rng(seed).integers(0, N, size=n_sub)
    idx = torch.as_tensor(rows, device=X.device)
    Xs = X.index_select(0, idx).float()
    Ys = Y.index_select(0, idx).float()
    Z = build_channel_response(Xs, W2.float())
    gram = lasso_gram(Z, Ys.reshape(-1))
    return search_alpha(gram, rank, rank_tol, alpha0=alpha0,
                        grid_size=grid_size, max_rounds=max_rounds,
                        n_sweeps=n_sweeps, prefer=prefer)
