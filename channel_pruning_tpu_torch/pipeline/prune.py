"""Per-layer channel pruning (port of channel_pruning_tpu/pipeline/prune.py).

One layer: LASSO selection of the consumer's input channels on a row
subsample (ops/lasso), least-squares reconstruction of the surviving
weights on all rows (ops/lstsq), and installation into the output graph by
pure graph rewrites (graph/rewrite.py). Single-task selection, with the
host-stepped search or the fused whole-layer solve (`_fused_layer_solve`,
device tensors only); the row-sparse group lasso on 1x1 and FC consumers;
the fixed-alpha selection of the reference's autodet mode; and the
alternating LASSO <-> least-squares refinement (`alter_iters`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from channel_pruning_tpu_torch.graph import rewrite
from channel_pruning_tpu_torch.graph.ir import Graph, LT
from channel_pruning_tpu_torch.ops import lasso, lstsq
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.utils import trace

_CHANNEL_PRESERVING = (LT.RELU, LT.POOL, LT.DROPOUT, LT.BN, LT.SCALE)


def _device_rel_error(X: torch.Tensor, W: torch.Tensor, b, Y: torch.Tensor
                      ) -> torch.Tensor:
    """rel_error(Y, X (*) W + b) as a 0-d tensor on the device."""
    pred = torch.einsum("nchw,ochw->no", X, W) + b
    num = torch.mean((Y - pred) ** 2)
    den = torch.mean(Y ** 2)
    return torch.sqrt(num) / torch.sqrt(den + 1e-30)


def _rel_error(X: torch.Tensor, W: torch.Tensor, b, Y: torch.Tensor) -> float:
    """`_device_rel_error` read on the host (the sequential path)."""
    return float(_device_rel_error(X, W, b, Y))


def _sharded_rel_error(Xs, W: torch.Tensor, b, Ys, mesh) -> torch.Tensor:
    """`_device_rel_error` over row shards: each shard's squared residual
    and squared target sums, reduced on the lead device in shard order."""
    num, den = [], []
    for X, Y in zip(Xs, Ys):
        d = X.device
        pred = torch.einsum("nchw,ochw->no", X, W.to(d)) + \
            (b.to(d) if torch.is_tensor(b) else b)
        num.append(torch.sum((Y - pred) ** 2))
        den.append(torch.sum(Y ** 2))
    count = sum(int(Y.numel()) for Y in Ys)
    num = mesh_mod.reduce_sum(num, mesh) / count
    den = mesh_mod.reduce_sum(den, mesh) / count
    return torch.sqrt(num) / torch.sqrt(den + 1e-30)


def split_rows(rows: np.ndarray, N: int, mesh) -> list[torch.Tensor]:
    """The row subsample `rows` (indices into N rows split evenly over the
    mesh, N a multiple of its size) as each shard's local indices, in the
    order they appear in `rows`, on the shard's device."""
    per = N // mesh.size
    return [torch.as_tensor(rows[rows // per == s] - s * per, device=d)
            for s, d in enumerate(mesh.devices)]


class FusedLayer(NamedTuple):
    """`_fused_layer_solve`'s result, all device tensors."""
    mask: torch.Tensor          # (c,) bool, the kept input channels
    alpha: torch.Tensor         # ()
    Wfull: torch.Tensor         # (n, c, kh, kw), 0 in the dropped channels
    b: torch.Tensor             # (n,)
    rmse_before: torch.Tensor   # ()
    rmse_after: torch.Tensor    # ()
    grids: torch.Tensor         # () the CD grids the search solved
    cd: torch.Tensor | None = None   # the search's `FusedSearch.cd`


def _fused_layer_solve(Xd: torch.Tensor, W2d: torch.Tensor, Yd: torch.Tensor,
                       rows, rank: int, rank_tol: float,
                       alpha0: float, grid_size: int, max_rounds: int,
                       n_sweeps: int, prefer: str, ridge: float,
                       mesh=None) -> FusedLayer:
    """The whole layer solve with no host read (port of the JAX package's
    one-program `_fused_layer_solve`): rMSE before, Z on the row subsample
    `rows`, the Gram, the fused alpha search, a full-width least-squares
    fit with the dropped channels' columns zeroed, and rMSE after.

    Zeroed columns give exactly-zero rows in the normal equations and
    exactly-zero coefficients under the jitter, so the fit equals the
    gather path's up to summation order, and `Wfull` is the zero-scattered
    running weight itself.

    Under a `mesh` of more than one shard, X and Y (N a multiple of its
    size) are split by rows over it and `rows` is `split_rows`' per-shard
    list: the rMSEs, Z, the Gram and the normal equations are per-shard
    partials reduced on the lead device in shard order; the search runs
    once, on the lead, and walks the same path as on one device."""
    N, c, kh, kw = Xd.shape
    n = W2d.shape[0]
    if mesh is not None and mesh.size > 1:
        return _fused_layer_solve_sharded(
            Xd, W2d, Yd, rows, rank, rank_tol, alpha0, grid_size, max_rounds,
            n_sweeps, prefer, ridge, mesh)
    with trace.span("solve.gram"):
        rmse_before = _device_rel_error(Xd, W2d, 0.0, Yd)
        Xs, Ys = Xd.index_select(0, rows), Yd.index_select(0, rows)
        Z = lasso.build_channel_response(Xs, W2d)
        gram = lasso.lasso_gram(Z, Ys.reshape(-1))
    with trace.span("solve.search"):
        found = lasso._fused_search(gram.G, gram.b, gram.n_samples, rank,
                                    rank_tol, alpha0, grid_size, max_rounds,
                                    n_sweeps, prefer)
    with trace.span("solve.fit"):
        # mask[:, None].expand: repeat_interleave would read its size on
        # the host
        colmask = found.mask[:, None].expand(c, kh * kw).reshape(-1) \
            .to(Xd.dtype)
        W, b = lstsq.fit_linear(Xd.reshape(N, c * kh * kw) * colmask, Yd,
                                ridge=ridge)
        Wfull = W.reshape(n, c, kh, kw)
        rmse_after = _device_rel_error(Xd, Wfull, b, Yd)
    return FusedLayer(mask=found.mask, alpha=found.alpha, Wfull=Wfull, b=b,
                      rmse_before=rmse_before, rmse_after=rmse_after,
                      grids=found.grids, cd=found.cd)


def _fused_layer_solve_sharded(Xd, W2d, Yd, rows, rank, rank_tol, alpha0,
                               grid_size, max_rounds, n_sweeps, prefer, ridge,
                               mesh) -> FusedLayer:
    """`_fused_layer_solve` over the mesh's row shards."""
    from channel_pruning_tpu_torch.parallel.sharded import (
        sharded_lasso_gram, sharded_lstsq)

    N, c, kh, kw = Xd.shape
    n = W2d.shape[0]
    Xs, Ys = mesh_mod.shard_rows(Xd, mesh), mesh_mod.shard_rows(Yd, mesh)
    W2s = [W2d.to(d) for d in mesh.devices]
    with trace.span("solve.gram"):
        rmse_before = _sharded_rel_error(Xs, W2d, 0.0, Ys, mesh)
        Z = [lasso.build_channel_response(X.index_select(0, r), W)
             for X, r, W in zip(Xs, rows, W2s)]
        y = [Y.index_select(0, r).reshape(-1) for Y, r in zip(Ys, rows)]
        gram = sharded_lasso_gram(Z, y, mesh)
    with trace.span("solve.search"):
        found = lasso._fused_search(gram.G, gram.b, gram.n_samples, rank,
                                    rank_tol, alpha0, grid_size, max_rounds,
                                    n_sweeps, prefer)
    with trace.span("solve.fit"):
        colmask = found.mask[:, None].expand(c, kh * kw).reshape(-1) \
            .to(Xd.dtype)
        W, b = sharded_lstsq([X.reshape(X.shape[0], -1) * colmask.to(X.device)
                              for X in Xs], Ys, mesh, ridge=ridge)
        Wfull = W.reshape(n, c, kh, kw)
        rmse_after = _sharded_rel_error(Xs, Wfull, b, Ys, mesh)
    return FusedLayer(mask=found.mask, alpha=found.alpha, Wfull=Wfull, b=b,
                      rmse_before=rmse_before, rmse_after=rmse_after,
                      grids=found.grids, cd=found.cd)


def producer_conv(graph: Graph, tensor: str, before: str | None = None) -> str | None:
    """Walk back through channel-preserving layers to the conv producing the
    channel dimension of `tensor`."""
    seen = set()
    cur = tensor
    while cur not in seen:
        seen.add(cur)
        prod = (graph.producer_before(cur, before) if before is not None
                else graph.producer(cur))
        if prod is None:
            return None
        if prod.type == LT.CONV:
            return prod.name
        if prod.type in _CHANNEL_PRESERVING:
            cur = prod.bottoms[0]
            continue
        return None
    return None


@dataclass
class PruneResult:
    keep: np.ndarray          # bool (c,) surviving input channels
    W: np.ndarray             # (n, keep, kh, kw) reconstructed consumer weights
    b: np.ndarray             # (n,)
    alpha: float              # LASSO alpha that hit the support band
    rmse_before: float        # rel rMSE of X*W2 vs Y before pruning
    rmse_after: float         # after selection + reconstruction
    grids: int | None = None  # CD grids the fused search solved (fused only)


def select_and_reconstruct(X: torch.Tensor, W2: np.ndarray, Y: torch.Tensor,
                           rank: int, *, rank_tol: float = 0.1,
                           alpha0: float = 1e-3, subsample: int = 400,
                           n_sweeps: int = 200, grid_size: int = 16,
                           max_rounds: int = 8, ridge: float = 0.0,
                           seed: int = 0, group: bool = False,
                           alter_iters: int = 0, prefer: str = "top",
                           fused: bool = False,
                           pad_to: tuple[int, int] | None = None,
                           autodet: bool = False,
                           layeralpha: float = 1.0, mesh=None) -> PruneResult:
    """One layer's LASSO selection + lstsq reconstruction.

    X: (N, c, kh, kw) consumer input patches of the current net and
    Y: (N, n) ground-truth responses with the bias subtracted, both on the
    solve device; W2: (n, c, kh, kw) consumer weights. `fused` runs the
    whole-layer solve `_fused_layer_solve` (an empty selection falls
    through to the generic path's magnitude fallback); `pad_to` (c_pad,
    n_pad) zero-pads its inputs first, which leaves the selection alone.

    `group=True` selects a 1x1 (kh·kw == 1) consumer's channels with the
    row-sparse group lasso on the (N, c) design instead of the summed
    single-task form; on any other consumer it changes nothing.
    `alter_iters` runs the alternating LASSO <-> least-squares refinement.
    `autodet=True` solves the LASSO once at alpha0 / c**layeralpha and keeps
    whatever support falls out: `rank` then only sizes the magnitude
    fallback of an empty selection.

    Under a `mesh` of more than one shard the fused solve takes X and Y
    split by rows when N is a multiple of its size; on the sequential path
    the selection's Gram and the refit's normal equations are row-sharded
    (parallel/sharded). The search is the one-device search either way."""
    sharded = mesh is not None and mesh.size > 1
    N, c, kh, kw = X.shape
    if autodet:
        fused = False       # one fixed-alpha solve: no band search, and
        alter_iters = 0     # no refinement
    # the group form applies to 1x1 consumers only, so `group` on a k > 1
    # conv keeps the fused path
    group_active = group and kh * kw == 1
    rank = int(min(max(rank, 1), c))
    Xd = X.float()
    Yd = Y.float()
    W2d = torch.as_tensor(np.asarray(W2, np.float32), device=Xd.device)
    if fused and not group_active and not alter_iters and rank < c:
        n_sub = min(subsample, max(N // 20, 1))
        rows = np.random.default_rng(seed).integers(0, N, size=n_sub)
        Xp, Yp, W2p = Xd, Yd, W2d
        n_out = W2d.shape[0]
        if pad_to is not None:
            # padded locals only: the fall-through below works unpadded
            c_pad, n_pad = max(pad_to[0], c), max(pad_to[1], n_out)
            Xp = F.pad(Xp, (0, 0, 0, 0, 0, c_pad - c))
            W2p = F.pad(W2p, (0, 0, 0, 0, 0, c_pad - c, 0, n_pad - n_out))
            Yp = F.pad(Yp, (0, n_pad - n_out))
        on_mesh = sharded and N % mesh.size == 0
        out = _fused_layer_solve(
            Xp, W2p, Yp, split_rows(rows, N, mesh) if on_mesh
            else torch.as_tensor(rows, device=Xd.device), rank,
            float(rank_tol), float(alpha0), grid_size, max_rounds, n_sweeps,
            prefer, float(ridge), mesh=mesh if on_mesh else None)
        keep = out.mask.cpu().numpy()[:c]
        lasso.count_sweeps(out.cd)
        if keep.sum() > 0:
            return PruneResult(
                keep=keep, W=out.Wfull.cpu().numpy()[:n_out, :c][:, keep],
                b=out.b.cpu().numpy()[:n_out], alpha=float(out.alpha),
                rmse_before=float(out.rmse_before),
                rmse_after=float(out.rmse_after), grids=int(out.grids))
    rmse_before = _rel_error(Xd, W2d, 0.0, Yd)

    if rank >= c and not autodet:
        keep = np.ones(c, bool)
        alpha = 0.0
    else:
        if autodet:
            keep, alpha, _ = lasso.select_channels_fixed(
                Xd, W2d, Yd, alpha0 / c ** layeralpha, subsample=subsample,
                seed=seed, n_sweeps=n_sweeps, mesh=mesh)
        elif group_active:
            keep, alpha, _ = lasso.select_channels_group(
                Xd.reshape(N, -1), Yd, rank, alpha0=alpha0,
                rank_tol=rank_tol, subsample=subsample, seed=seed,
                grid_size=grid_size, max_rounds=max_rounds,
                n_sweeps=n_sweeps, prefer=prefer, mesh=mesh)
        else:
            keep, alpha, _ = lasso.select_channels(
                Xd, W2d, Yd, rank, alpha0=alpha0, rank_tol=rank_tol,
                subsample=subsample, seed=seed, grid_size=grid_size,
                max_rounds=max_rounds, n_sweeps=n_sweeps, prefer=prefer,
                fused=fused, mesh=mesh)
        if keep.sum() == 0:
            # degenerate layer (LASSO kills everything at every probed
            # alpha): magnitude selection keeps the graph well-formed
            keep = magnitude_select(W2, rank)
            alpha = float("nan")
        if alter_iters and np.isfinite(alpha):
            refined = _alternate_refine(Xd, W2d, Yd, keep, rank, rank_tol,
                                        alpha, alter_iters,
                                        subsample=subsample, seed=seed,
                                        n_sweeps=n_sweeps)
            if refined is not None and refined.sum() > 0:
                keep = refined

    # least squares on the surviving channels over ALL rows
    keep_idx = torch.as_tensor(np.where(keep)[0], device=Xd.device)
    Xk = Xd.index_select(1, keep_idx).reshape(N, -1)
    if sharded:
        from channel_pruning_tpu_torch.parallel.sharded import sharded_lstsq
        W, b = sharded_lstsq(Xk, Yd, mesh, ridge=ridge)
    else:
        W, b = lstsq.fit_linear(Xk, Yd, ridge=ridge)
    n_keep = int(keep.sum())
    Wfull = torch.zeros((Yd.shape[1], c, kh, kw), dtype=torch.float32,
                        device=Xd.device)
    Wfull[:, keep_idx] = W.reshape(Yd.shape[1], n_keep, kh, kw)
    rmse_after = _rel_error(Xd, Wfull, b, Yd)
    return PruneResult(keep=np.asarray(keep, bool),
                       W=W.reshape(Yd.shape[1], n_keep, kh, kw).cpu().numpy(),
                       b=b.cpu().numpy(), alpha=float(alpha),
                       rmse_before=rmse_before, rmse_after=rmse_after)


def magnitude_select(W2: np.ndarray, rank: int) -> np.ndarray:
    """Keep the `rank` input channels with largest sum|W|."""
    saliency = np.abs(W2).sum(axis=(0, 2, 3))
    keep = np.zeros(W2.shape[1], bool)
    keep[np.argsort(-saliency)[:rank]] = True
    return keep


def apply_pruning(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                  consumer: str, result: PruneResult,
                  shrink_producer: bool = True) -> tuple[Graph, dict]:
    """Install a PruneResult: the consumer gets its reconstructed (W, b);
    the producer conv's output channels are removed when it feeds only this
    consumer (through channel-preserving layers), a depthwise producer
    chain shrinks through, and otherwise a Select gate goes in front of the
    consumer. Traced, it counts `prune.shrinks` (group-1 producers shrunk)
    and `prune.gates` (Selects inserted), and the chain `prune.dw_shrinks`
    and `prune.dw_gates`."""
    g, params = rewrite.prune_conv_inputs(graph, params, consumer,
                                          result.keep, W=result.W, b=result.b)
    bottom = g.layer(consumer).bottoms[0]
    prod = producer_conv(g, bottom, before=consumer)
    safe = depthwise = False
    if shrink_producer and prod is not None and \
            _sole_consumer_chain(g, prod, consumer):
        group = g.layer(prod).conv_geometry()["group"]
        safe = group == 1
        depthwise = group > 1 and group == int(g.layer(prod).attr("num_output"))
    if safe:
        g, params = rewrite.prune_conv_outputs(g, params, prod, result.keep)
        trace.count("prune.shrinks", 1)
    elif depthwise:
        g, params = _shrink_depthwise_chain(g, params, prod, result.keep)
    else:
        g = rewrite.insert_select(g, bottom, consumer, result.keep)
        trace.count("prune.gates", 1)
    return g, params


def _shrink_depthwise_chain(graph: Graph,
                            params: Mapping[str, Mapping[str, np.ndarray]],
                            dw: str, keep: np.ndarray) -> tuple[Graph, dict]:
    """Shrink a depthwise conv to the kept channels, then propagate the mask
    to its producer (a group==1 conv shrinks, a depthwise one recurses,
    anything else gets a Select gate)."""
    g, params = rewrite.prune_conv_outputs(graph, params, dw, keep)
    g, params = rewrite.set_conv(g, params, dw, group=int(keep.sum()))
    trace.count("prune.dw_shrinks", 1)
    bottom = g.layer(dw).bottoms[0]
    up = producer_conv(g, bottom, before=dw)
    if up is not None and _sole_consumer_chain(g, up, dw):
        geo = g.layer(up).conv_geometry()
        if geo["group"] == 1:
            trace.count("prune.shrinks", 1)
            return rewrite.prune_conv_outputs(g, params, up, keep)
        if geo["group"] == int(g.layer(up).attr("num_output")):
            return _shrink_depthwise_chain(g, params, up, keep)
    g = rewrite.insert_select(g, bottom, dw, keep)
    trace.count("prune.gates", 1)
    trace.count("prune.dw_gates", 1)
    return g, params


def _sole_consumer_chain(graph: Graph, prod: str, consumer: str) -> bool:
    """True if prod's output reaches only `consumer` through channel-
    preserving layers (so physically shrinking its outputs is safe)."""
    frontier = [graph.layer(prod).tops[0]]
    visited = set()
    while frontier:
        t = frontier.pop()
        if t in visited:
            continue
        visited.add(t)
        for cons in graph.consumers(t):
            if cons.name == consumer:
                continue
            if cons.type in _CHANNEL_PRESERVING:
                frontier.extend(cons.tops)
            else:
                return False
    return True


def _alternate_refine(X: torch.Tensor, W2: torch.Tensor, Y: torch.Tensor,
                      keep: np.ndarray, rank: int, rank_tol: float,
                      alpha0: float, iters: int, *, subsample: int = 400,
                      seed: int = 0, n_sweeps: int = 200) -> np.ndarray | None:
    """Alternating LASSO <-> least-squares refinement of a selection, as
    the JAX package's `_alternate_refine`: refit the consumer on the
    current support (row subsample), rebuild the per-channel responses with
    the refit weights, and search again for the same support size from the
    last alpha. Returns the refined mask (None if the support emptied)."""
    _, c, kh, kw = X.shape
    n = W2.shape[0]
    Xs, Ys = lasso.row_subsample(X, Y, subsample, seed)
    cur = np.asarray(keep, bool)
    for _ in range(iters):
        if cur.sum() == 0:
            return None
        cur_idx = torch.as_tensor(np.where(cur)[0], device=X.device)
        Wk, _ = lstsq.fit_linear(
            Xs.index_select(1, cur_idx).reshape(Xs.shape[0], -1), Ys)
        W2p = torch.zeros((n, c, kh, kw), dtype=torch.float32,
                          device=X.device)
        W2p[:, cur_idx] = Wk.reshape(n, int(cur.sum()), kh, kw)
        Z = lasso.build_channel_response(Xs, W2p)
        gram = lasso.lasso_gram(Z, Ys.reshape(-1))
        new, alpha0, _ = lasso.search_alpha(gram, rank, rank_tol,
                                            alpha0=max(alpha0, 1e-6),
                                            n_sweeps=n_sweeps)
        if new.sum() == 0:
            return cur
        cur = np.asarray(new, bool)
    return cur
