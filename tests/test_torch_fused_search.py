"""The port's fused alpha search (ops/lasso._fused_search: the whole search
on the device, no host read until the result) against the JAX package's
one-program search, on the battery of tests/test_solvers.py::
test_fused_search_matches_host_path, and against the port's host-stepped
search with that test's bounds. The JAX side runs its XLA CD on the CPU,
as the JAX suite does; the port's its plain CD version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from channel_pruning_tpu.ops import lasso as jax_lasso
from channel_pruning_tpu_torch.kernels import lasso_cd
from channel_pruning_tpu_torch.ops import lasso
from torch_cpu import one_thread  # noqa: F401


def _battery_problem(trial):
    """tests/test_solvers.py:502-512: correlated columns, a 60%-dense w."""
    rng = np.random.default_rng(trial)
    c = [32, 64, 128, 96][trial]
    N = 1600
    base = rng.normal(0, 1, (N, c // 4)).astype(np.float32)
    mix = rng.normal(0, 0.5, (c // 4, c)).astype(np.float32)
    Z = base @ mix + 0.3 * rng.normal(0, 1, (N, c)).astype(np.float32)
    w = (rng.normal(0, 1, c) * (rng.uniform(size=c) < 0.6)).astype(np.float32)
    y = Z @ w + 0.01 * rng.normal(0, 1, N).astype(np.float32)
    return Z, y, max(4, int(c / 2))


def _xla_cd(G, b, alphas_n, n_sweeps=200, **_):
    """The JAX package's CD grid (XLA, as its suite runs on the CPU) in
    the port's signature."""
    out = jax_lasso.cd_solve_grid(jnp.asarray(G.numpy()), jnp.asarray(b.numpy()),
                                  jnp.asarray(alphas_n.numpy()),
                                  n_sweeps=n_sweeps)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("prefer", ["top", "bottom"])
@pytest.mark.parametrize("trial", range(4))
def test_fused_search_matches_jax_and_host_path(trial, prefer, monkeypatch):
    """On one Gram (JAX's):

    * the port's search driven by the JAX package's CD grid: masks
      identical to JAX's fused search, supports equal, alpha within rtol
      1e-6 (both compute f32 endpoints; XLA may contract a multiply-add
      that torch rounds twice);
    * the port's search on its own CD (the kernels' plain version): the
      same support, and the bounds of the JAX test between its two
      searches (IoU >= 0.97). The plain CD rounds otherwise than XLA's,
      and on these correlated columns, after 200 sweeps at the smallest
      alphas, betas differ by up to ~4e-3, enough to move a near-tie
      probe (trial 2, top: one swapped pair);
    * the bottom path returns exactly `rank`; the port's host-stepped
      search (f64 endpoints) gives the same support, IoU >= 0.97."""
    Z, y, rank = _battery_problem(trial)
    gram_j = jax_lasso.lasso_gram(jnp.asarray(Z), jnp.asarray(y))
    m_j, a_j, s_j = jax_lasso.fused_search_alpha(gram_j, rank, 0.1,
                                                 prefer=prefer)
    m_j = np.asarray(m_j)
    gram = lasso.LassoGram(G=torch.from_numpy(np.array(gram_j.G)),
                           b=torch.from_numpy(np.array(gram_j.b)),
                           n_samples=int(gram_j.n_samples))
    with monkeypatch.context() as mp:
        mp.setattr(lasso_cd, "cd_solve_grid", _xla_cd)
        m_x, a_x, s_x = lasso.fused_search_alpha(gram, rank, 0.1,
                                                 prefer=prefer)
    np.testing.assert_array_equal(m_x, m_j)
    assert s_x == s_j and a_x == pytest.approx(float(a_j), rel=1e-6)

    def iou(a, b):
        return (a & b).sum() / max((a | b).sum(), 1)

    m, _, s = lasso.fused_search_alpha(gram, rank, 0.1, prefer=prefer)
    assert s == s_j and iou(m, m_j) >= 0.97
    if prefer == "bottom":
        assert s == rank
    m_h, _, s_h = lasso.search_alpha(gram, rank, 0.1, prefer=prefer)
    assert s_h == s and iou(m, m_h) >= 0.97


def test_fused_search_full_keep_contract():
    gram = lasso.lasso_gram(torch.ones((8, 4)), torch.ones(8))
    m, a, s = lasso.fused_search_alpha(gram, 4, 0.1)
    assert s == 4 and m.all() and a == 0.0


@pytest.mark.parametrize("seed,N,c,n,rank,prefer", [
    (0, 800, 12, 6, 5, "top"), (1, 1200, 24, 10, 9, "bottom")])
def test_select_channels_fused_matches_jax(seed, N, c, n, rank, prefer):
    """Row subsample, Z, Gram and the fused search end to end, as
    tests/test_torch_lasso.py holds the host-stepped path."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, c, 3, 3)).astype(np.float32)
    W2 = rng.normal(size=(n, c, 3, 3)).astype(np.float32)
    Y = np.einsum("nchw,ochw->no", X, W2).astype(np.float32)
    Y += 0.1 * rng.normal(size=Y.shape).astype(np.float32)
    m_j, _, s_j = jax_lasso.select_channels(X, W2, Y, rank, prefer=prefer,
                                            fused=True)
    m, _, s = lasso.select_channels(
        torch.from_numpy(X), torch.from_numpy(W2), torch.from_numpy(Y), rank,
        prefer=prefer, fused=True)
    np.testing.assert_array_equal(m, np.asarray(m_j))
    assert s == s_j


def test_inf_alpha_round_is_one_empty_sweep():
    """A round after the search is done passes alphas of +inf: every
    soft-threshold is 0, so the plain version (the kernels' contract)
    leaves every beta at exactly 0 and stops each alpha after one sweep
    with no nonzero step."""
    Z, y, _ = _battery_problem(1)
    gram = lasso.lasso_gram(torch.from_numpy(Z), torch.from_numpy(y))
    alphas = torch.full((16,), float("inf"))
    stats = torch.zeros((16, 2), dtype=torch.int32)
    betas = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, stats=stats)
    assert torch.equal(betas, torch.zeros_like(betas))
    assert stats[:, 0].tolist() == [1] * 16 and stats[:, 1].tolist() == [0] * 16


def test_fused_search_runs_max_rounds_with_inf_after_done(monkeypatch):
    """The search launches the CD grid exactly `max_rounds` times; once it
    is done every alpha is +inf, and `grids` counts the rounds before."""
    Z, y, rank = _battery_problem(0)
    gram = lasso.lasso_gram(torch.from_numpy(Z), torch.from_numpy(y))
    seen, real = [], lasso_cd.cd_solve_grid

    def spy(G, b, alphas_n, **kw):
        seen.append(alphas_n.clone())
        return real(G, b, alphas_n, **kw)

    monkeypatch.setattr(lasso_cd, "cd_solve_grid", spy)
    out = lasso._fused_search(gram.G, gram.b, gram.n_samples, rank, 0.1,
                              1e-3, 16, 8, 200, "bottom")
    assert len(seen) == 8
    finite = [bool(torch.isfinite(a).all()) for a in seen]
    n = int(out.grids)
    assert 1 <= n < 8 and finite == [True] * n + [False] * (8 - n)
    assert all(bool(torch.isinf(a).all()) for a in seen[n:])
