"""Per-layer channel pruning (port of channel_pruning_tpu/pipeline/prune.py).

One layer: LASSO selection of the consumer's input channels on a row
subsample (ops/lasso), least-squares reconstruction of the surviving
weights on all rows (ops/lstsq), and installation into the output graph by
pure graph rewrites (graph/rewrite.py). Single-task selection, with the
host-stepped search or the fused whole-layer solve (`_fused_layer_solve`,
device tensors only); the group-lasso, alternating-refinement and autodet
paths are not ported yet and raise.
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


class FusedLayer(NamedTuple):
    """`_fused_layer_solve`'s result, all device tensors."""
    mask: torch.Tensor          # (c,) bool, the kept input channels
    alpha: torch.Tensor         # ()
    Wfull: torch.Tensor         # (n, c, kh, kw), 0 in the dropped channels
    b: torch.Tensor             # (n,)
    rmse_before: torch.Tensor   # ()
    rmse_after: torch.Tensor    # ()
    grids: torch.Tensor         # () the CD grids the search solved


def _fused_layer_solve(Xd: torch.Tensor, W2d: torch.Tensor, Yd: torch.Tensor,
                       rows: torch.Tensor, rank: int, rank_tol: float,
                       alpha0: float, grid_size: int, max_rounds: int,
                       n_sweeps: int, prefer: str, ridge: float) -> FusedLayer:
    """The whole layer solve with no host read (port of the JAX package's
    one-program `_fused_layer_solve`): rMSE before, Z on the row subsample
    `rows`, the Gram, the fused alpha search, a full-width least-squares
    fit with the dropped channels' columns zeroed, and rMSE after.

    Zeroed columns give exactly-zero rows in the normal equations and
    exactly-zero coefficients under the jitter, so the fit equals the
    gather path's up to summation order, and `Wfull` is the zero-scattered
    running weight itself."""
    N, c, kh, kw = Xd.shape
    n = W2d.shape[0]
    rmse_before = _device_rel_error(Xd, W2d, 0.0, Yd)
    Xs, Ys = Xd.index_select(0, rows), Yd.index_select(0, rows)
    Z = lasso.build_channel_response(Xs, W2d)
    gram = lasso.lasso_gram(Z, Ys.reshape(-1))
    found = lasso._fused_search(gram.G, gram.b, gram.n_samples, rank,
                                rank_tol, alpha0, grid_size, max_rounds,
                                n_sweeps, prefer)
    # mask[:, None].expand: repeat_interleave would read its size on the host
    colmask = found.mask[:, None].expand(c, kh * kw).reshape(-1).to(Xd.dtype)
    W, b = lstsq.fit_linear(Xd.reshape(N, c * kh * kw) * colmask, Yd,
                            ridge=ridge)
    Wfull = W.reshape(n, c, kh, kw)
    return FusedLayer(mask=found.mask, alpha=found.alpha, Wfull=Wfull, b=b,
                      rmse_before=rmse_before,
                      rmse_after=_device_rel_error(Xd, Wfull, b, Yd),
                      grids=found.grids)


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
                           autodet: bool = False) -> PruneResult:
    """One layer's LASSO selection + lstsq reconstruction.

    X: (N, c, kh, kw) consumer input patches of the current net and
    Y: (N, n) ground-truth responses with the bias subtracted, both on the
    solve device; W2: (n, c, kh, kw) consumer weights. `fused` runs the
    whole-layer solve `_fused_layer_solve` (an empty selection falls
    through to the generic path's magnitude fallback); `pad_to` (c_pad,
    n_pad) zero-pads its inputs first, which leaves the selection alone."""
    N, c, kh, kw = X.shape
    if autodet or alter_iters or (group and kh * kw == 1):
        raise NotImplementedError(
            "only single-task selection is ported; autodet, alternating "
            "refinement and group lasso are not")
    rank = int(min(max(rank, 1), c))
    Xd = X.float()
    Yd = Y.float()
    W2d = torch.as_tensor(np.asarray(W2, np.float32), device=Xd.device)
    if fused and rank < c:
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
        out = _fused_layer_solve(
            Xp, W2p, Yp, torch.as_tensor(rows, device=Xd.device), rank,
            float(rank_tol), float(alpha0), grid_size, max_rounds, n_sweeps,
            prefer, float(ridge))
        keep = out.mask.cpu().numpy()[:c]
        if keep.sum() > 0:
            return PruneResult(
                keep=keep, W=out.Wfull.cpu().numpy()[:n_out, :c][:, keep],
                b=out.b.cpu().numpy()[:n_out], alpha=float(out.alpha),
                rmse_before=float(out.rmse_before),
                rmse_after=float(out.rmse_after), grids=int(out.grids))
    rmse_before = _rel_error(Xd, W2d, 0.0, Yd)

    if rank >= c:
        keep = np.ones(c, bool)
        alpha = 0.0
    else:
        keep, alpha, _ = lasso.select_channels(
            Xd, W2d, Yd, rank, alpha0=alpha0, rank_tol=rank_tol,
            subsample=subsample, seed=seed, grid_size=grid_size,
            max_rounds=max_rounds, n_sweeps=n_sweeps, prefer=prefer,
            fused=fused)
        if keep.sum() == 0:
            # degenerate layer (LASSO kills everything at every probed
            # alpha): magnitude selection keeps the graph well-formed
            keep = magnitude_select(W2, rank)
            alpha = float("nan")

    # least squares on the surviving channels over ALL rows
    keep_idx = torch.as_tensor(np.where(keep)[0], device=Xd.device)
    Xk = Xd.index_select(1, keep_idx).reshape(N, -1)
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
    consumer."""
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
    elif depthwise:
        g, params = _shrink_depthwise_chain(g, params, prod, result.keep)
    else:
        g = rewrite.insert_select(g, bottom, consumer, result.keep)
    return g, params


def _shrink_depthwise_chain(graph: Graph,
                            params: Mapping[str, Mapping[str, np.ndarray]],
                            dw: str, keep: np.ndarray) -> tuple[Graph, dict]:
    """Shrink a depthwise conv to the kept channels, then propagate the mask
    to its producer (a group==1 conv shrinks, a depthwise one recurses,
    anything else gets a Select gate)."""
    g, params = rewrite.prune_conv_outputs(graph, params, dw, keep)
    g, params = rewrite.set_conv(g, params, dw, group=int(keep.sum()))
    bottom = g.layer(dw).bottoms[0]
    up = producer_conv(g, bottom, before=dw)
    if up is not None and _sole_consumer_chain(g, up, dw):
        geo = g.layer(up).conv_geometry()
        if geo["group"] == 1:
            return rewrite.prune_conv_outputs(g, params, up, keep)
        if geo["group"] == int(g.layer(up).attr("num_output")):
            return _shrink_depthwise_chain(g, params, up, keep)
    g = rewrite.insert_select(g, bottom, dw, keep)
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
