"""LASSO channel selection (port of channel_pruning_tpu/ops/lasso.py).

1. Z[:, i] = X_i ⊛ W2_i, the per-input-channel partial responses of the
   consumer (one batched matmul);
2. the Gram reduction G = ZᵀZ, b = Zᵀy;
3. Gram-form cyclic coordinate descent over a whole grid of alphas
   (kernels/lasso_cd: the CUDA kernel on the card; its plain version
   `cd_solve_grid_plain`, the port of the reference's `cd_solve` /
   `cd_solve_grid`, on the CPU);
4. the grid refinement, until some alpha's support lands in
   [rank, rank + rank_tol·rank]: host-stepped in `search_alpha` (float64
   endpoints, a host read per round), or on the device in `_fused_search`
   (the default, as in the JAX CLI: float32 endpoints, no host read until
   the result is returned).

Also the fixed-alpha selection of the reference's autodet mode
(`cd_solve`, `select_channels_fixed`) and the row-sparse group lasso for
1x1 and FC consumers (`group_gram`, `search_alpha_group` over
kernels/group_cd.group_cd_solve_grid: K3 on the card, its plain version on
the CPU; `select_channels_group`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
from channel_pruning_tpu_torch.utils import trace


class LassoGram(NamedTuple):
    G: torch.Tensor     # (c, c)  ZᵀZ
    b: torch.Tensor     # (c,)    Zᵀy
    n_samples: int      # N rows of Z


def build_channel_response(X: torch.Tensor, W2: torch.Tensor) -> torch.Tensor:
    """X: (N, c, kh, kw) input patches; W2: (n, c, kh, kw) consumer weights.
    Returns Z: (N*n, c) with Z[:, i] = vec(X[:, i] · W2[:, i]ᵀ)."""
    N, c = X.shape[0], X.shape[1]
    n = W2.shape[0]
    xr = X.flatten(2).permute(1, 0, 2)                 # (c, N, khkw)
    wr = W2.reshape(n, c, -1).permute(1, 2, 0)         # (c, khkw, n)
    return torch.bmm(xr, wr).reshape(c, N * n).T


def lasso_gram(Z: torch.Tensor, y: torch.Tensor) -> LassoGram:
    G = Z.T @ Z
    G = 0.5 * (G + G.T)       # exactly symmetric: the kernel reads row j
    return LassoGram(G=G.contiguous(), b=(Z.T @ y).contiguous(),
                     n_samples=Z.shape[0])


def cd_solve(G: torch.Tensor, b: torch.Tensor, alpha_n: float,
             n_sweeps: int = 200, tol: float = 1e-8) -> torch.Tensor:
    """Cyclic coordinate descent for one alpha from beta = 0: (c,) betas.
    The JAX package's `cd_solve` with beta0 = 0 is the grid solve at one
    alpha (the same update and stopping rule, at least one sweep), so this
    is one launch of K1 (c <= 1024) or K2 on the card."""
    a = torch.tensor([alpha_n], dtype=torch.float32).to(G.device)
    return lasso_cd.cd_solve_grid(G, b, a, n_sweeps=n_sweeps, tol=tol)[0]


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
    def solve(a: torch.Tensor) -> torch.Tensor:
        return lasso_cd.cd_solve_grid(gram.G, gram.b, a,
                                      n_sweeps=n_sweeps).abs()

    return _band_search(solve, gram.G, gram.n_samples, rank, rank_tol,
                        alpha0, grid_size, max_rounds, prefer)


def _band_search(solve, G: torch.Tensor, N: int, rank: int, rank_tol: float,
                 alpha0: float, grid_size: int, max_rounds: int,
                 prefer: str) -> tuple[np.ndarray, float, int]:
    """The host-stepped band search of `search_alpha` and
    `search_alpha_group`: `solve(alphas * N)` gives each alpha's (A, c)
    channel magnitudes (|beta|, or B's row norms), whose support is
    `support_mask` of them and whose order trims the bottom band."""
    c = int(G.shape[0])
    if rank >= c:
        return np.ones(c, bool), 0.0, c
    lbound = rank
    rbound = rank + (rank_tol if rank_tol >= 1 else rank_tol * rank)
    top = prefer == "top"

    alphas = alpha0 * (2.0 ** np.arange(-2, grid_size - 2, dtype=np.float64))
    lo, hi = 0.0, None
    best_cand = None  # (support, mask, alpha) — best in-band seen so far
    best_over = None  # (support, magnitudes, alpha) — smallest support >= rank
    refines = 0
    for _ in range(max_rounds):
        mags = solve(torch.as_tensor(alphas * N, dtype=G.dtype).to(G.device))
        masks = support_mask(mags).cpu().numpy()
        supports = masks.sum(axis=1)
        if not top:
            ge = np.where(supports >= lbound)[0]
            if ge.size:
                gi = ge[supports[ge].argmin()]
                if best_over is None or supports[gi] < best_over[0]:
                    best_over = (int(supports[gi]), mags[gi].cpu().numpy(),
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
            mag, alpha = best_over[1], best_over[2]
            mask = np.zeros(c, bool)
            mask[np.argsort(-mag)[:rank]] = True
            return mask, alpha, int(mask.sum())
        dist = np.abs(supports - lbound)
        bi = int(np.argmin(dist))
        mask = masks[bi].copy()
        short = rank - int(mask.sum())
        if short > 0:
            energy = np.where(mask, -np.inf, torch.diagonal(G).cpu()
                              .numpy().astype(np.float64))
            mask[np.argsort(-energy)[:short]] = True
        return mask, float(alphas[bi]), int(mask.sum())
    if best_cand is not None:
        return best_cand[1], best_cand[2], best_cand[0]
    dist = np.minimum(np.abs(supports - lbound), np.abs(supports - rbound))
    best = int(np.argmin(dist))
    return masks[best], float(alphas[best]), int(supports[best])


class FusedSearch(NamedTuple):
    """`_fused_search`'s result, all device tensors."""
    mask: torch.Tensor      # (c,) bool
    alpha: torch.Tensor     # () float32
    support: torch.Tensor   # () int64, mask.sum()
    grids: torch.Tensor     # () int64, the grids the search solved
    # (3,) int64 with tracing on (utils/trace), else None: the sweeps K1/K2
    # ran over the alphas that were not +inf, those alphas, and their
    # nonzero-delta steps (moves)
    cd: torch.Tensor | None = None


def count_sweeps(cd: torch.Tensor | None) -> None:
    """Add a search's `FusedSearch.cd`, read on the host, to the counters
    `cd.sweeps`, `cd.live_alphas` and `cd.moves`."""
    if cd is not None:
        trace.count("cd.sweeps", int(cd[0]))
        trace.count("cd.live_alphas", int(cd[1]))
        trace.count("cd.moves", int(cd[2]))


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor on x's device. Indexing with a tensor
    scalar reads it on the host; index_select does not."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _fused_search(G: torch.Tensor, b: torch.Tensor, n_samples: int,
                  rank: int, rank_tol: float, alpha0: float, grid_size: int,
                  max_rounds: int, n_sweeps: int, prefer: str) -> FusedSearch:
    """The whole alpha search on the device, with no host read: the port of
    the JAX package's one-program search (ops/lasso._fused_search), which
    mirrors `search_alpha`'s probe sequence (geometric bracket, linear
    refinement, band pick, exact-count trim or top-up) with float32 grid
    endpoints.

    The state is a dict of tensors updated as `where(done, old, new)`, over
    exactly `max_rounds` host iterations: a finished state is frozen, so the
    sequence equals `lax.while_loop`'s. A round after `done` still launches
    the CD kernel, with alphas of +inf: every soft-threshold is 0, every
    beta stays exactly 0, each alpha stops after one sweep, and the update
    throws that grid away. `grids` counts the rounds that were not. With
    tracing on, the kernels write each alpha's `stats` into one buffer,
    summed on the device at the end over those rounds into `cd`."""
    c = G.shape[0]
    dt = G.dtype
    dev = G.device
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    top = prefer == "top"
    lbound = int(rank)
    # float32 as the JAX package computes it: rank and rank_tol rounded to
    # f32, one f32 product and one f32 sum
    rb = np.float32(rank_tol) if rank_tol >= 1 else \
        np.float32(rank_tol) * np.float32(lbound)
    rbound = float(np.float32(lbound) + rb)
    rbound_i = int(rbound)
    BIG = 10 ** 9
    inf = float("inf")
    N = float(np.float32(n_samples))
    diag = torch.diagonal(G)
    # separate f32 operations, as in JAX: no fused multiply-add, and a true
    # division (a CUDA division by a Python scalar multiplies by its
    # reciprocal)
    t = torch.arange(1, grid_size + 1, **f32) / \
        torch.full((), grid_size + 1, **f32)
    zero_f = torch.zeros((), **f32)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    s = dict(
        alphas=alpha0 * (2.0 ** torch.arange(-2, grid_size - 2, **f32)),
        lo=zero_f, hi=zero_f, hi_found=false,
        cand_support=torch.full((), -1, **i64),
        cand_mask=torch.zeros(c, dtype=torch.bool, device=dev),
        cand_alpha=zero_f, cand_found=false,
        over_support=torch.full((), BIG, **i64),
        over_absb=torch.zeros(c, dtype=dt, device=dev),
        over_alpha=zero_f, over_found=false,
        last_betas=torch.zeros((grid_size, c), dtype=dt, device=dev),
        last_supports=torch.zeros(grid_size, **i64),
        refines=torch.zeros((), **i64), done=false)
    grids = torch.zeros((), **i64)
    # with tracing on, the kernels' per-alpha stats of every round, and
    # which rounds had live (finite) alphas
    stats = torch.zeros((max_rounds, grid_size, 2), dtype=torch.int32,
                        device=dev) if trace.enabled() else None
    live = []

    for r in range(max_rounds):
        keep_old = s["done"]
        live.append(~keep_old)
        grids = grids + live[-1].long()
        alphas = s["alphas"]
        a_n = (torch.where(keep_old, inf, alphas) * N).to(dt).contiguous()
        betas = lasso_cd.cd_solve_grid(
            G, b, a_n, n_sweeps=n_sweeps,
            stats=None if stats is None else stats[r])
        masks = support_mask(betas)      # row-wise: row i is betas[i]'s mask
        supports = masks.sum(dim=-1)
        sup_f = supports.float()
        in_band = (supports >= lbound) & (sup_f <= rbound)
        any_band = in_band.any()

        # best_over (bottom path): the smallest support >= rank
        if top:
            over_better = false
        else:
            ge = supports >= lbound
            sup_ge = torch.where(ge, supports, BIG)
            gi = torch.argmin(sup_ge)
            over_better = ge.any() & (_pick(sup_ge, gi) < s["over_support"])
            over_gi = (_pick(supports, gi), _pick(betas, gi).abs(),
                       _pick(alphas, gi))
        new = {}
        if top:
            new.update(over_support=s["over_support"],
                       over_absb=s["over_absb"], over_alpha=s["over_alpha"])
        else:
            new.update(
                over_support=torch.where(over_better, over_gi[0],
                                         s["over_support"]),
                over_absb=torch.where(over_better, over_gi[1], s["over_absb"]),
                over_alpha=torch.where(over_better, over_gi[2],
                                       s["over_alpha"]))
        new["over_found"] = over_better | s["over_found"]

        # in-band candidate: the largest (top) / smallest (bottom) support
        if top:
            bi = torch.argmax(torch.where(in_band, supports, -1))
        else:
            bi = torch.argmin(torch.where(in_band, supports, BIG))
        sb = _pick(supports, bi)
        cand_better = any_band & (~s["cand_found"] | (
            sb > s["cand_support"] if top else sb < s["cand_support"]))
        cand_support = torch.where(cand_better, sb, s["cand_support"])
        cand_alpha = torch.where(cand_better, _pick(alphas, bi),
                                 s["cand_alpha"])
        cand_found = s["cand_found"] | cand_better
        new.update(cand_support=cand_support, cand_alpha=cand_alpha,
                   cand_found=cand_found,
                   cand_mask=torch.where(cand_better, _pick(masks, bi),
                                         s["cand_mask"]))

        # band-edge termination and the refinement budget
        edge = (cand_support >= rbound_i if top
                else cand_support <= lbound) & cand_found
        refines = s["refines"] + (any_band & ~edge).long()
        budget_done = refines > 2

        # refinement grid between the best in-band alpha and the nearest
        # out-of-band alpha on the preferred side (support ~decreasing in a)
        if top:
            over_i = sup_f > rbound
            a_hi_r = cand_alpha
            a_lo_r = torch.where(
                over_i.any(),
                _pick(alphas, torch.argmin(torch.where(over_i, supports, BIG))),
                torch.maximum(s["lo"], a_hi_r / 2.0))
        else:
            under_i = supports < lbound
            a_lo_r = cand_alpha
            a_hi_r = torch.where(
                under_i.any(),
                _pick(alphas, torch.argmax(torch.where(under_i, supports, -1))),
                torch.where(s["hi_found"], s["hi"], a_lo_r * 2.0))
        degenerate = (a_hi_r - a_lo_r) <= 1e-12 * torch.clamp(a_hi_r, min=1e-30)
        refine_grid = a_lo_r + (a_hi_r - a_lo_r) * t

        # bracket update (no in-band sample this round)
        over_b = sup_f > rbound
        under_b = supports < lbound
        lo_new = torch.where(
            over_b.any(),
            _pick(alphas, torch.argmin(torch.where(over_b, supports, BIG))),
            s["lo"])
        hi_new = torch.where(
            under_b.any(),
            _pick(alphas, torch.argmax(torch.where(under_b, supports, -1))),
            torch.where(s["hi_found"], s["hi"], 0.0))
        hi_found = s["hi_found"] | under_b.any()
        grow_grid = alphas * (2.0 ** grid_size)
        lo_brk = torch.where(over_b.any(), lo_new, hi_new / (2.0 ** grid_size))
        bracket_grid = lo_brk + (hi_new - lo_brk) * t
        no_band_grid = torch.where(hi_found, bracket_grid, grow_grid)

        new.update(alphas=torch.where(any_band, refine_grid, no_band_grid),
                   lo=torch.where(any_band, s["lo"], lo_new), hi=hi_new,
                   hi_found=hi_found, last_betas=betas,
                   last_supports=supports, refines=refines)
        done = keep_old | edge | (any_band & (budget_done | degenerate))
        s = {k: torch.where(keep_old, s[k], v) for k, v in new.items()}
        s["done"] = done

    # the final selection, the device-side mirror of search_alpha's epilogue;
    # stable sorts, so ties go to the lower index as in jnp.argsort
    def first_k(score: torch.Tensor, k) -> torch.Tensor:
        """Mask of the k largest scores (k an int or a 0-d tensor)."""
        order = torch.argsort(-score, stable=True)
        return torch.argsort(order, stable=True) < k

    trim_mask = first_k(s["over_absb"], lbound)
    dist = (s["last_supports"] - lbound).abs()
    ni = torch.argmin(dist)
    near_mask = support_mask(_pick(s["last_betas"], ni))
    dist2 = torch.minimum(dist.float(),
                          (s["last_supports"].float() - rbound).abs())
    ni2 = torch.argmin(dist2)
    near_mask2 = support_mask(_pick(s["last_betas"], ni2))
    short = lbound - near_mask.sum()
    energy = torch.where(near_mask, -inf, diag.float())
    topped = near_mask | first_k(energy, short)
    if top:
        mask = torch.where(s["cand_found"], s["cand_mask"], near_mask2)
        alpha = torch.where(s["cand_found"], s["cand_alpha"],
                            _pick(s["alphas"], ni2))
    else:
        exact = s["cand_found"] & (s["cand_support"] == lbound)
        mask = torch.where(exact, s["cand_mask"],
                           torch.where(s["over_found"], trim_mask, topped))
        alpha = torch.where(exact, s["cand_alpha"],
                            torch.where(s["over_found"], s["over_alpha"],
                                        _pick(s["alphas"], ni)))
    cd = None
    if stats is not None:
        rounds = torch.stack(live)
        per_round = stats.sum(dim=1) * rounds[:, None]    # (rounds, 2)
        cd = torch.stack([per_round[:, 0].sum(), rounds.sum() * grid_size,
                          per_round[:, 1].sum()])
    return FusedSearch(mask=mask, alpha=alpha, support=mask.sum(), grids=grids,
                       cd=cd)


def fused_search_alpha(gram: LassoGram, rank: int, rank_tol: float,
                       alpha0: float = 1e-3, grid_size: int = 16,
                       max_rounds: int = 8, n_sweeps: int = 200,
                       prefer: str = "top") -> tuple[np.ndarray, float, int]:
    """`search_alpha`'s contract through `_fused_search`: the result is
    read on the host once, at the end."""
    c = int(gram.G.shape[0])
    if rank >= c:
        return np.ones(c, bool), 0.0, c
    out = _fused_search(gram.G, gram.b, gram.n_samples, rank, float(rank_tol),
                        float(alpha0), grid_size, max_rounds, n_sweeps, prefer)
    count_sweeps(out.cd)
    return out.mask.cpu().numpy(), float(out.alpha), int(out.support)


def select_channels(X: torch.Tensor, W2: torch.Tensor, Y: torch.Tensor,
                    rank: int, *, alpha0: float = 1e-3, rank_tol: float = 0.1,
                    subsample: int = 400, seed: int = 0, grid_size: int = 16,
                    max_rounds: int = 8, n_sweeps: int = 200,
                    prefer: str = "top", fused: bool = False, mesh=None
                    ) -> tuple[np.ndarray, float, int]:
    """End-to-end selection for one layer. X: (N, c, kh, kw) patches,
    W2: (n, c, kh, kw), Y: (N, n) targets, all on one device. The row
    subsample is numpy's `default_rng(seed).integers`, so both packages use
    the same rows. `fused` searches with `fused_search_alpha`. With a
    `mesh` of more than one shard the Gram is reduced over row shards
    (parallel/sharded); the search runs once, on the lead device."""
    Xs, Ys = row_subsample(X, Y, subsample, seed)
    Z = build_channel_response(Xs, W2.float())
    gram = _gram(Z, Ys.reshape(-1), mesh)
    search = fused_search_alpha if fused else search_alpha
    return search(gram, rank, rank_tol, alpha0=alpha0, grid_size=grid_size,
                  max_rounds=max_rounds, n_sweeps=n_sweeps, prefer=prefer)


def _gram(Z: torch.Tensor, y: torch.Tensor, mesh) -> LassoGram:
    """lasso_gram, or its row-sharded reduction under a mesh."""
    if mesh is not None and mesh.size > 1:
        from channel_pruning_tpu_torch.parallel.sharded import \
            sharded_lasso_gram
        return sharded_lasso_gram(Z, y, mesh)
    return lasso_gram(Z, y)


def row_subsample(X: torch.Tensor, Y: torch.Tensor, subsample: int,
                   seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows both packages draw: numpy's `default_rng(seed).integers`."""
    N = X.shape[0]
    n_sub = min(subsample, max(N // 20, 1))
    rows = np.random.default_rng(seed).integers(0, N, size=n_sub)
    idx = torch.as_tensor(rows, device=X.device)
    return X.index_select(0, idx).float(), Y.index_select(0, idx).float()


def select_channels_fixed(X: torch.Tensor, W2: torch.Tensor, Y: torch.Tensor,
                          alpha: float, *, subsample: int = 400,
                          seed: int = 0, n_sweeps: int = 200, mesh=None
                          ) -> tuple[np.ndarray, float, int]:
    """Fixed-alpha, support-free selection (the reference's autodet mode):
    one LASSO solve at `alpha` on the row subsample, keeping whatever
    support comes out. The contract of `select_channels`; the caller
    computes alpha = alpha0 / c**layeralpha."""
    Xs, Ys = row_subsample(X, Y, subsample, seed)
    Z = build_channel_response(Xs, W2.float())
    gram = _gram(Z, Ys.reshape(-1), mesh)
    beta = cd_solve(gram.G, gram.b, alpha * gram.n_samples, n_sweeps=n_sweeps)
    mask = support_mask(beta[None, :])[0].cpu().numpy()
    return mask, float(alpha), int(mask.sum())


# ---------------------------------------------------------------------------
# group (multitask) lasso: the reference's MultiTaskLasso branch for 1x1 and
# FC consumers, row-sparse B in
#   min 1/(2N) ||Y - X B||_F^2 + alpha * sum_j ||B_j||_2
# by block coordinate descent on the Gram system, over a grid of alphas
# ---------------------------------------------------------------------------

class GroupGram(NamedTuple):
    G: torch.Tensor     # (c, c)  XᵀX
    C: torch.Tensor     # (c, n)  XᵀY
    n_samples: int


def group_gram(X: torch.Tensor, Y: torch.Tensor) -> GroupGram:
    G = X.T @ X
    return GroupGram(G=(0.5 * (G + G.T)).contiguous(),
                     C=(X.T @ Y).contiguous(), n_samples=X.shape[0])


def group_cd_solve(G: torch.Tensor, C: torch.Tensor, alpha_n: float,
                   n_sweeps: int = 200, tol: float = 1e-8) -> torch.Tensor:
    """(c, n) B for one alpha (the JAX package's `group_cd_solve`)."""
    a = torch.tensor([alpha_n], dtype=torch.float32).to(G.device)
    return group_cd.group_cd_solve_grid(G, C, a, n_sweeps=n_sweeps,
                                        tol=tol)[0]


def group_row_norms(Bs: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(Bs * Bs, dim=-1))


def search_alpha_group(gram: GroupGram, rank: int, rank_tol: float,
                       alpha0: float = 1e-3, grid_size: int = 16,
                       max_rounds: int = 8, n_sweeps: int = 200,
                       prefer: str = "top") -> tuple[np.ndarray, float, int]:
    """The group-lasso variant of `search_alpha`, as the JAX package's: the
    same band search, with supports counted on B's row norms (> 1e-6 of the
    largest) and the bottom band trimmed by them."""
    def solve(a: torch.Tensor) -> torch.Tensor:
        return group_row_norms(group_cd.group_cd_solve_grid(
            gram.G, gram.C, a, n_sweeps=n_sweeps))

    return _band_search(solve, gram.G, gram.n_samples, rank, rank_tol,
                        alpha0, grid_size, max_rounds, prefer)


def select_channels_group(X: torch.Tensor, Y: torch.Tensor, rank: int, *,
                          alpha0: float = 1e-3, rank_tol: float = 0.1,
                          subsample: int = 400, seed: int = 0,
                          grid_size: int = 16, max_rounds: int = 8,
                          n_sweeps: int = 200, prefer: str = "top",
                          mesh=None) -> tuple[np.ndarray, float, int]:
    """Group-lasso channel selection for 1x1 and FC consumers: X (N, c[, 1,
    1]) and Y (N, n) on one device, the row subsample of `select_channels`;
    under a `mesh` the Gram is reduced over row shards."""
    Xs, Ys = row_subsample(X.reshape(X.shape[0], -1), Y, subsample, seed)
    if mesh is not None and mesh.size > 1:
        from channel_pruning_tpu_torch.parallel.sharded import \
            sharded_group_gram
        gram = sharded_group_gram(Xs, Ys, mesh)
    else:
        gram = group_gram(Xs, Ys)
    return search_alpha_group(gram, rank, rank_tol, alpha0=alpha0,
                              grid_size=grid_size, max_rounds=max_rounds,
                              n_sweeps=n_sweeps, prefer=prefer)
