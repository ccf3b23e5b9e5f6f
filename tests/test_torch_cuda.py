"""Card-only tests of the port (marker `cuda`): they skip where
torch.cuda is unavailable. This file imports no jax, so it also runs where
jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from channel_pruning_tpu_torch.kernels import lasso_cd
from channel_pruning_tpu_torch.ops import lasso


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    from channel_pruning_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _problem(seed, c, rows):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(rows, c)).astype(np.float32)
    beta = np.zeros(c, np.float32)
    beta[rng.choice(c, c // 4, replace=False)] = rng.normal(size=c // 4)
    y = (Z @ beta + 0.01 * rng.normal(size=rows)).astype(np.float32)
    return torch.from_numpy(Z), torch.from_numpy(y)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 512])
def test_cd_kernel_matches_plain_version(card, c):
    """Same card inputs through the kernel and its plain version: identical
    supports, betas within 1e-5/1e-6 (the kernel keeps the plain version's
    order of f32 operations, so they agree bit for bit in practice)."""
    Z, y = _problem(c, c, 8 * c)
    gram = lasso.lasso_gram(Z.to(card), y.to(card))
    alphas = torch.as_tensor(np.geomspace(1e-4, 0.5, 32) * gram.n_samples,
                             dtype=torch.float32).to(card)
    before = lasso_cd.LAUNCHES
    got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas)
    torch.cuda.synchronize()
    assert lasso_cd.LAUNCHES == before + 1
    ref = lasso_cd.cd_solve_grid_plain(gram.G, gram.b, alphas)
    np.testing.assert_array_equal(lasso.support_mask(got).cpu().numpy(),
                                  lasso.support_mask(ref).cpu().numpy())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cd_kernel_rejects_bad_inputs(card):
    G = torch.eye(8, device=card)
    b = torch.ones(8, device=card)
    a = torch.ones(4, device=card)
    with pytest.raises(TypeError):
        lasso_cd.cd_solve_grid(G.double(), b, a)
    with pytest.raises(ValueError):
        lasso_cd.cd_solve_grid(G, b.cpu(), a)
    with pytest.raises(ValueError):
        lasso_cd.cd_solve_grid(torch.eye(16, device=card)[::2, ::2], b, a)
    with pytest.raises(NotImplementedError):
        big = torch.eye(lasso_cd.MAX_C + 1, device=card)
        lasso.search_alpha(lasso.LassoGram(big, big[0], 10), 4, 0.1)
