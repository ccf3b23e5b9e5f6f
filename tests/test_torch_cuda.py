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
    """Same card inputs through K1 and its plain version: identical supports,
    betas bit for bit (the kernel keeps the plain version's order of f32
    operations), and the same sweeps and nonzero steps for every alpha."""
    Z, y = _problem(c, c, 8 * c)
    gram = lasso.lasso_gram(Z.to(card), y.to(card))
    alphas = torch.as_tensor(np.geomspace(1e-4, 0.5, 32) * gram.n_samples,
                             dtype=torch.float32).to(card)
    stats = torch.zeros((32, 2), dtype=torch.int32, device=card)
    stats_ref = torch.zeros_like(stats)
    before = lasso_cd.LAUNCHES
    got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, stats=stats)
    torch.cuda.synchronize()
    assert lasso_cd.LAUNCHES == before + 1
    ref = lasso_cd.cd_solve_grid_plain(gram.G, gram.b, alphas, stats=stats_ref)
    np.testing.assert_array_equal(lasso.support_mask(got).cpu().numpy(),
                                  lasso.support_mask(ref).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(stats.cpu().numpy(), stats_ref.cpu().numpy())


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
    with pytest.raises(ValueError, match="K2 takes c <= 8192"):
        big = torch.eye(lasso_cd.MAX_C_STREAM + 1, device=card)
        lasso.search_alpha(lasso.LassoGram(big, big[0], 10), 4, 0.1)


def _gate_problem(seed, c, device):
    """A res5-gate-shaped Gram: 1x1 post-ReLU patches against He-init
    weights, as chip_smoke.py builds it."""
    rng = np.random.default_rng(seed)
    X = np.maximum(rng.normal(size=(250, c, 1, 1)), 0).astype(np.float32)
    W2 = (rng.normal(size=(512, c, 1, 1)) * np.sqrt(2.0 / c)).astype(np.float32)
    Z = lasso.build_channel_response(torch.from_numpy(X).to(device),
                                     torch.from_numpy(W2).to(device))
    y = Z.sum(dim=1) + 0.05 * torch.from_numpy(
        rng.normal(size=Z.shape[0]).astype(np.float32)).to(device)
    gram = lasso.lasso_gram(Z, y)
    a_max = float(gram.b.abs().max()) / gram.n_samples
    alphas = torch.as_tensor(np.geomspace(1e-3 * a_max, a_max, 32)
                             * gram.n_samples, dtype=torch.float32).to(device)
    return gram, alphas


@pytest.mark.cuda
def test_stream_kernel_matches_plain_version_at_c2048(card):
    """K2 at a res5 gate's width, dispatched by cd_solve_grid, against the
    plain version over 3 sweeps (a full 200-sweep plain grid takes about a
    minute on the card): identical supports, bit-identical betas."""
    gram, alphas = _gate_problem(0, 2048, card)
    before = (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM)
    got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, n_sweeps=3)
    torch.cuda.synchronize()
    assert (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM) == \
        (before[0], before[1] + 1)
    ref = lasso_cd.cd_solve_grid_plain(gram.G, gram.b, alphas, n_sweeps=3)
    np.testing.assert_array_equal(lasso.support_mask(got).cpu().numpy(),
                                  lasso.support_mask(ref).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_stream_kernel_equals_k1(card):
    """K2 forced at c = 512, where the dispatch takes K1: the same betas bit
    for bit over the full 200 sweeps."""
    gram, alphas = _gate_problem(1, 512, card)
    k1 = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas)
    k2 = lasso_cd.cd_solve_grid_stream(gram.G, gram.b, alphas)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k2.cpu().numpy(), k1.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [512, 2048])
def test_inf_alphas_cost_one_empty_sweep(card, c):
    """The fused search's rounds after it is done pass alphas of +inf: K1
    (c = 512) and K2 (c = 2048) leave every beta at exactly 0 and stop each
    alpha after one sweep with no nonzero step."""
    gram, _ = _gate_problem(c, c, card)
    alphas = torch.full((16,), float("inf"), device=card)
    stats = torch.zeros((16, 2), dtype=torch.int32, device=card)
    before = (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM)
    got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, stats=stats)
    torch.cuda.synchronize()
    k2 = c > lasso_cd.MAX_C
    assert (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM) == \
        (before[0] + (not k2), before[1] + k2)
    assert torch.equal(got, torch.zeros_like(got))
    assert stats[:, 0].tolist() == [1] * 16 and stats[:, 1].tolist() == [0] * 16


@pytest.mark.cuda
@pytest.mark.parametrize("prefer", ["top", "bottom"])
def test_fused_search_on_card_matches_cpu(card, prefer):
    """The fused search on the card (K1, device-side state) and on the CPU
    (the plain version) on one Gram: the same mask, support and alpha."""
    gram, _ = _gate_problem(5, 256, card)
    cpu = lasso.LassoGram(gram.G.cpu(), gram.b.cpu(), gram.n_samples)
    got = lasso.fused_search_alpha(gram, 96, 0.1, prefer=prefer)
    want = lasso.fused_search_alpha(cpu, 96, 0.1, prefer=prefer)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("c,n_sweeps", [(37, 200), (130, 200), (4100, 2)])
def test_kernel_pads_widths_off_the_tma_grain(card, c, n_sweeps):
    """The kernels copy rows in 16-byte units, so a width that is not a
    multiple of 4 goes through inert zero padding; and K2's widest instance
    (32 warps, c > 4096): still the plain version's betas and stats, bit for
    bit."""
    Z, y = _problem(c, c, 8 * c if c < 1024 else 2 * c)
    gram = lasso.lasso_gram(Z.to(card), y.to(card))
    alphas = torch.as_tensor(np.geomspace(1e-4, 0.5, 8) * gram.n_samples,
                             dtype=torch.float32).to(card)
    stats = torch.zeros((8, 2), dtype=torch.int32, device=card)
    stats_ref = torch.zeros_like(stats)
    got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, n_sweeps=n_sweeps,
                                 stats=stats)
    ref = lasso_cd.cd_solve_grid_plain(gram.G, gram.b, alphas,
                                       n_sweeps=n_sweeps, stats=stats_ref)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(stats.cpu().numpy(), stats_ref.cpu().numpy())
