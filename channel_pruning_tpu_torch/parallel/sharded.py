"""Sharded solver reductions and the data-parallel forward (port of
channel_pruning_tpu/parallel/sharded.py).

The solver matrices have one big dimension, the sample rows N (50,000 a
layer at the reference's defaults); everything downstream reads only Gram
and cross products (ZᵀZ, Zᵀy, XᵀX, XᵀY). So the rows are split over the
mesh, each shard computes its partial products on its own device, and the
partials are summed on the lead device in shard order (the JAX package
leaves that sum to XLA's psum). Zero-padded rows contribute nothing to a
Gram; the centred moments of `sharded_lstsq` read only the real rows. The
math stays in f32 with TF32 off (`device.fp32_solver`).
"""
from __future__ import annotations

from typing import Sequence

import torch

from channel_pruning_tpu_torch.ops import lasso, lstsq
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.parallel.mesh import Mesh


def _parts(x, mesh: Mesh) -> list[torch.Tensor]:
    """`x` split by rows over the mesh, unless it already is (a list of
    per-shard tensors)."""
    return list(x) if isinstance(x, (list, tuple)) else \
        mesh_mod.shard_rows(x, mesh)


def _rows(x) -> int:
    return sum(int(p.shape[0]) for p in x) if isinstance(x, (list, tuple)) \
        else int(x.shape[0])


def _gram_pair(A, B, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(sym(AᵀA), AᵀB) over row shards, reduced in shard order."""
    pa, pb = _parts(A, mesh), _parts(B, mesh)
    G = mesh_mod.reduce_sum([a.T @ a for a in pa], mesh)
    C = mesh_mod.reduce_sum([a.T @ b for a, b in zip(pa, pb)], mesh)
    return (0.5 * (G + G.T)).contiguous(), C.contiguous()


def sharded_lasso_gram(Z, y, mesh: Mesh) -> lasso.LassoGram:
    """Row-sharded ZᵀZ / Zᵀy on the lead device; n_samples counts real rows
    only."""
    n = _rows(Z)
    G, b = _gram_pair(Z, y, mesh)
    return lasso.LassoGram(G=G, b=b, n_samples=n)


def sharded_group_gram(X, Y, mesh: Mesh) -> lasso.GroupGram:
    """Row-sharded XᵀX / XᵀY for the group lasso (MultiTaskLasso) branch."""
    n = _rows(X)
    G, C = _gram_pair(X, Y, mesh)
    return lasso.GroupGram(G=G, C=C, n_samples=n)


def _real_parts(x, mesh: Mesh) -> list[torch.Tensor]:
    if isinstance(x, (list, tuple)):
        return list(x)
    return mesh_mod.real_rows(mesh_mod.shard_rows(x, mesh), x.shape[0], mesh)


def sharded_lstsq(X, Y, mesh: Mesh, ridge: float = 0.0, jitter: float = 1e-6
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """W, b = argmin ||X Wᵀ + b - Y||² (ops/lstsq.fit_linear's semantics)
    with row-sharded reductions: the column sums give the means, then each
    shard's centred moments (X_s - x̄)ᵀ(X_s - x̄) and (X_s - x̄)ᵀ(Y_s - ȳ)
    over its real rows are summed, jittered by 1e-6·trace and solved by
    Cholesky on the lead device. Centring per shard, not raw moments
    XᵀX - N x̄x̄ᵀ, keeps the f32 Gram as accurate as the one-device fit's
    (raw moments lose the digits the means carry). `X`/`Y` are tensors or
    lists of per-shard real rows; nothing is read on the host."""
    xs, ys = _real_parts(X, mesh), _real_parts(Y, mesh)
    n = sum(int(x.shape[0]) for x in xs)
    x_mean = mesh_mod.reduce_sum([x.sum(0) for x in xs], mesh) / n
    y_mean = mesh_mod.reduce_sum([y.sum(0) for y in ys], mesh) / n
    G, C = [], []
    for x, y in zip(xs, ys):
        xc = x - x_mean.to(x.device)
        G.append(xc.T @ xc)
        C.append(xc.T @ (y - y_mean.to(y.device)))
    G = lstsq._jittered(lstsq._sym(mesh_mod.reduce_sum(G, mesh)), ridge, jitter)
    L, info = torch.linalg.cholesky_ex(G)
    L = torch.where(info == 0, L, float("nan"))   # as lstsq.factor
    Z = torch.linalg.solve_triangular(L, mesh_mod.reduce_sum(C, mesh),
                                      upper=False)
    W = torch.linalg.solve_triangular(L.T, Z, upper=True).T
    return W, y_mean - W @ x_mean


def data_parallel_forward(graph, capture: Sequence[str], mesh: Mesh):
    """fn(params_by_device, x) -> {tensor: capture}: the batch `x` (on any
    device) split by images over the mesh, each shard's forward on its own
    device with its device's parameters (`mesh.replicate`), and each
    capture gathered back on the lead device in image order."""
    from channel_pruning_tpu_torch.ops.forward import run_graph

    capture = tuple(capture)
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph(capture)

    def fn(params_by_device, x):
        outs = {t: [] for t in capture}
        for (lo, hi), dev in zip(mesh_mod.shard_bounds(x.shape[0], mesh),
                                 mesh.devices):
            if hi == lo:
                continue
            _, caps = run_graph(sub, params_by_device[dev],
                                {input_name: x[lo:hi].to(dev)}, capture=capture)
            for t in capture:
                outs[t].append(caps[t])
        return {t: mesh_mod.gather_rows(v, mesh) for t, v in outs.items()}

    return fn
