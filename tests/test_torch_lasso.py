"""The port's alpha search and channel selection (channel_pruning_tpu_torch/
ops/lasso) against the JAX package's host-stepped path on a seeded battery:
the selected masks must be identical. Each package builds its own Gram from
the same numpy inputs."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.ops import lasso as jax_lasso
from channel_pruning_tpu_torch.ops import lasso


def _sparse_problem(seed, n, c, k, dead=0, noise=0.01):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, c)).astype(np.float32)
    if dead:
        Z[:, rng.choice(c, dead, replace=False)] = 0.0   # dead channels
    beta = np.zeros(c, np.float32)
    idx = rng.choice(c, k, replace=False)
    beta[idx] = rng.normal(0, 1, k).astype(np.float32) + \
        np.sign(rng.normal(size=k)).astype(np.float32)
    y = (Z @ beta + noise * rng.normal(size=n)).astype(np.float32)
    return Z, y


# (seed, c, k, dead, rank, prefer, grid_size, max_rounds): both band ends;
# seed 10 on a coarse 4-alpha grid lands on support 29 for rank 20, so the
# "bottom" path needs the exact-count trim; 26 dead of 40 channels cap the
# reachable support at 14 < 16 and force the top-up; rank == c is the
# keep-all shortcut
BATTERY = [(0, 48, 20, 0, 12, "top", 16, 8), (1, 64, 40, 0, 32, "top", 16, 8),
           (2, 64, 40, 0, 32, "bottom", 16, 8),
           (3, 64, 40, 0, 37, "bottom", 16, 8),
           (10, 64, 40, 0, 20, "bottom", 4, 3),
           (4, 40, 12, 26, 16, "bottom", 16, 8),
           (5, 96, 60, 0, 50, "top", 32, 8), (6, 16, 8, 0, 16, "top", 16, 8)]


@pytest.mark.parametrize("seed,c,k,dead,rank,prefer,grid_size,max_rounds",
                         BATTERY)
def test_search_alpha_masks_match_jax(seed, c, k, dead, rank, prefer,
                                      grid_size, max_rounds):
    Z, y = _sparse_problem(seed, 600, c, k, dead=dead)
    kw = dict(rank_tol=0.1, alpha0=1e-3, prefer=prefer, grid_size=grid_size,
              max_rounds=max_rounds)
    gram_j = jax_lasso.lasso_gram(Z, y)
    mask_j, alpha_j, sup_j = jax_lasso.search_alpha(gram_j, rank, **kw)
    gram = lasso.lasso_gram(torch.from_numpy(Z), torch.from_numpy(y))
    mask, alpha, sup = lasso.search_alpha(gram, rank, **kw)
    np.testing.assert_array_equal(mask, np.asarray(mask_j))
    assert sup == sup_j and alpha == pytest.approx(alpha_j, rel=1e-12)
    if prefer == "bottom":
        assert sup == rank


@pytest.mark.parametrize("seed,N,c,n,rank,prefer", [
    (0, 800, 12, 6, 5, "top"), (1, 1200, 24, 10, 9, "bottom"),
    (2, 600, 16, 8, 16, "top")])
def test_select_channels_matches_jax(seed, N, c, n, rank, prefer):
    """Z build, Gram, row subsample (numpy default_rng) and search."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, c, 3, 3)).astype(np.float32)
    W2 = rng.normal(size=(n, c, 3, 3)).astype(np.float32)
    Y = np.einsum("nchw,ochw->no", X, W2).astype(np.float32)
    Y += 0.1 * rng.normal(size=Y.shape).astype(np.float32)
    mask_j, _, _ = jax_lasso.select_channels(X, W2, Y, rank, prefer=prefer,
                                             grid_size=32)
    mask, _, _ = lasso.select_channels(
        torch.from_numpy(X), torch.from_numpy(W2), torch.from_numpy(Y), rank,
        prefer=prefer, grid_size=32)
    np.testing.assert_array_equal(mask, np.asarray(mask_j))


def test_build_channel_response_and_gram_match_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(20, 6, 3, 3)).astype(np.float32)
    W2 = rng.normal(size=(4, 6, 3, 3)).astype(np.float32)
    y = rng.normal(size=80).astype(np.float32)
    Z = lasso.build_channel_response(torch.from_numpy(X), torch.from_numpy(W2))
    Zj = np.asarray(jax_lasso.build_channel_response(X, W2))
    np.testing.assert_allclose(Z.numpy(), Zj, rtol=1e-5, atol=1e-6)
    gram = lasso.lasso_gram(Z, torch.from_numpy(y))
    gram_j = jax_lasso.lasso_gram(Zj, y)
    np.testing.assert_array_equal(gram.G.numpy(), gram.G.numpy().T)
    np.testing.assert_allclose(gram.G.numpy(), np.asarray(gram_j.G),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gram.b.numpy(), np.asarray(gram_j.b),
                               rtol=1e-5, atol=1e-5)
    assert gram.n_samples == int(gram_j.n_samples) == 80
