"""The port's LASSO CD grid solver (channel_pruning_tpu_torch/kernels/lasso_cd)
against the JAX package's XLA solver and its two Pallas kernels (K1 and the
HBM-streaming K2) in interpret mode.

Protocol of test_solvers.py::test_pallas_cd_kernel_interpret_parity:
allclose at rtol 1e-4 / atol 1e-5 (f32 sums taken in another order) with
identical support sizes. Both packages get the same Gram matrix.
"""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.kernels import lasso_cd as jax_lasso_cd
from channel_pruning_tpu.ops import lasso as jax_lasso
from channel_pruning_tpu_torch.kernels import lasso_cd
from channel_pruning_tpu_torch.ops import lasso


def _sparse_gram(seed, n, c, k, noise=0.01):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, c)).astype(np.float32)
    beta = np.zeros(c, np.float32)
    idx = rng.choice(c, k, replace=False)
    beta[idx] = rng.normal(0, 1, k).astype(np.float32) + \
        np.sign(rng.normal(size=k)).astype(np.float32)
    y = Z @ beta + noise * rng.normal(size=n).astype(np.float32)
    gram = jax_lasso.lasso_gram(Z, y)
    return np.array(gram.G), np.array(gram.b), int(gram.n_samples)


def _port_grid(G, b, alphas, n_sweeps):
    return lasso_cd.cd_solve_grid(torch.from_numpy(G), torch.from_numpy(b),
                                  torch.from_numpy(alphas),
                                  n_sweeps=n_sweeps).numpy()


@pytest.mark.parametrize("seed,n,c,k", [(0, 400, 24, 6), (1, 600, 48, 20),
                                        (2, 300, 40, 30)])
def test_plain_grid_matches_xla_solver(seed, n, c, k):
    G, b, N = _sparse_gram(seed, n, c, k)
    alphas = (np.geomspace(1e-4, 0.5, 12) * N).astype(np.float32)
    ref = np.asarray(jax_lasso.cd_solve_grid(G, b, alphas, n_sweeps=300))
    got = _port_grid(G, b, alphas, 300)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        lasso.support_sizes(torch.from_numpy(got)).numpy(),
        np.asarray(jax_lasso.support_sizes(ref)))


@pytest.mark.parametrize("kernel,seed,n,c,k", [
    ("cd_solve_grid_pallas", 0, 400, 24, 6),
    ("cd_solve_grid_pallas", 3, 500, 64, 16),
    # K2, the HBM-streaming kernel: the plain version serves it too
    # (protocol of test_solvers.py::test_pallas_hbm_cd_kernel_interpret_parity)
    ("cd_solve_grid_pallas_hbm", 6, 300, 40, 10)])
def test_plain_grid_matches_pallas_interpret(kernel, seed, n, c, k):
    G, b, N = _sparse_gram(seed, n, c, k)
    alphas = (np.geomspace(1e-3, 0.5, 8) * N).astype(np.float32)
    ref = np.asarray(getattr(jax_lasso_cd, kernel)(
        G, b, alphas, n_sweeps=300, interpret=True))
    got = _port_grid(G, b, alphas, 300)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        lasso.support_sizes(torch.from_numpy(got)).numpy(),
        np.asarray(jax_lasso.support_sizes(ref)))


def test_zero_diagonal_padding_is_inert():
    """Appended zero rows/columns (a zero diagonal) stay at beta = 0 and
    leave the real block's solution bit-identical."""
    G, b, N = _sparse_gram(4, 400, 20, 8)
    alphas = (np.geomspace(1e-3, 0.3, 6) * N).astype(np.float32)
    pad = 12
    Gp = np.zeros((20 + pad, 20 + pad), np.float32)
    Gp[:20, :20] = G
    bp = np.concatenate([b, np.zeros(pad, np.float32)])
    got = _port_grid(Gp, bp, alphas, 200)
    np.testing.assert_array_equal(got[:, 20:], 0.0)
    np.testing.assert_array_equal(got[:, :20], _port_grid(G, b, alphas, 200))


def test_per_alpha_stopping_rule():
    """Each alpha stops on its own: solving one alpha alone gives the same
    beta as solving it inside the grid (the reference's XLA rule)."""
    G, b, N = _sparse_gram(5, 400, 32, 10)
    alphas = (np.geomspace(1e-4, 0.5, 8) * N).astype(np.float32)
    grid = _port_grid(G, b, alphas, 200)
    for i in (0, 3, 7):
        alone = _port_grid(G, b, alphas[i:i + 1], 200)
        np.testing.assert_array_equal(alone[0], grid[i])



def test_stream_wrapper_takes_plain_version_on_cpu():
    """K2's wrapper on a CPU tensor is the plain version, like K1's, and
    counts no launch."""
    G, b, N = _sparse_gram(7, 300, 40, 10)
    alphas = (np.geomspace(1e-3, 0.5, 6) * N).astype(np.float32)
    before = (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM)
    got = lasso_cd.cd_solve_grid_stream(torch.from_numpy(G), torch.from_numpy(b),
                                        torch.from_numpy(alphas)).numpy()
    np.testing.assert_array_equal(got, _port_grid(G, b, alphas, 200))
    assert (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM) == before
