"""The port's least squares (channel_pruning_tpu_torch/ops/lstsq) against the
JAX package's on the same seeded problems: rtol 1e-4 / atol 1e-5 (f32
normal equations reduced in another order)."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.ops import lstsq as jax_lstsq
from channel_pruning_tpu_torch.ops import lstsq


def _problem(seed, n, d, n_out):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Wtrue = rng.normal(size=(n_out, d)).astype(np.float32)
    Y = (X @ Wtrue.T + rng.normal(size=n_out)
         + 0.01 * rng.normal(size=(n, n_out))).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("seed,n,d,n_out,ridge", [
    (0, 500, 40, 8, 0.0), (1, 300, 72, 16, 0.0), (2, 400, 27, 5, 0.5)])
def test_fit_linear_matches_jax(seed, n, d, n_out, ridge):
    X, Y = _problem(seed, n, d, n_out)
    W, b = lstsq.fit_linear(torch.from_numpy(X), torch.from_numpy(Y),
                            ridge=ridge)
    Wj, bj = jax_lstsq.fit_linear(X, Y, ridge=ridge)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-5)


def test_fit_linear_without_intercept_matches_jax():
    X, Y = _problem(3, 400, 30, 6)
    W, b = lstsq.fit_linear(torch.from_numpy(X), torch.from_numpy(Y),
                            fit_intercept=False)
    Wj, bj = jax_lstsq.fit_linear(X, Y, fit_intercept=False)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))


def test_factor_solve_reuse_matches_jax():
    X, _ = _problem(4, 300, 20, 1)
    rng = np.random.default_rng(5)
    f = lstsq.factor(torch.from_numpy(X))
    fj = jax_lstsq.factor(X)
    np.testing.assert_allclose(f.chol.numpy(), np.asarray(fj.chol),
                               rtol=1e-4, atol=1e-5)
    for _ in range(3):
        Y = rng.normal(size=(300, 5)).astype(np.float32)
        W, b = lstsq.solve(f, torch.from_numpy(X), torch.from_numpy(Y))
        Wj, bj = jax_lstsq.solve(fj, X, Y)
        np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-5)


def test_rank_deficient_design_stays_factorisable():
    """N < d and duplicated columns: the trace-scaled jitter keeps the
    Cholesky finite in f32 in both packages, with the same solution."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(20, 12)).astype(np.float32)
    X = np.concatenate([X, X[:, :12]], axis=1)             # (20, 24), rank 12
    Y = rng.normal(size=(20, 3)).astype(np.float32)
    W, b = lstsq.fit_linear(torch.from_numpy(X), torch.from_numpy(Y))
    Wj, bj = jax_lstsq.fit_linear(X, Y)
    assert torch.isfinite(W).all() and torch.isfinite(b).all()
    pred = X @ W.numpy().T + b.numpy()
    predj = X @ np.asarray(Wj).T + np.asarray(bj)
    np.testing.assert_allclose(pred, predj, rtol=1e-4, atol=1e-5)
