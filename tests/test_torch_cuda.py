"""Card-only tests of the port (marker `cuda`): they skip where
torch.cuda is unavailable. This file imports no jax, so it also runs where
jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
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


def _group_problem(seed, c, n, device, rows=250):
    """A 1x1 consumer's group-lasso Gram (the row subsample of 250 rows of
    post-ReLU inputs against He-init weights, as chip_smoke.py builds it)
    and a 16-alpha grid below the alpha that zeroes every row."""
    rng = np.random.default_rng(seed)
    X = np.maximum(rng.normal(size=(rows, c)), 0).astype(np.float32)
    W = (rng.normal(size=(c, n)) * np.sqrt(2.0 / c)).astype(np.float32)
    Y = (X @ W + 0.05 * rng.normal(size=(rows, n))).astype(np.float32)
    gram = lasso.group_gram(torch.from_numpy(X).to(device),
                            torch.from_numpy(Y).to(device))
    a_max = float(torch.linalg.vector_norm(gram.C, dim=1).max()) / rows
    alphas = torch.as_tensor(np.geomspace(1e-3 * a_max, a_max, 16) * rows,
                             dtype=torch.float32).to(device)
    return gram, alphas


def _group_supports(Bs):
    """Each alpha's rows with a norm above 1e-6 of its largest, as
    search_alpha_group counts them."""
    norms = lasso.group_row_norms(Bs)
    return (norms > 1e-6 * norms.amax(dim=1, keepdim=True)).cpu().numpy()


def _assert_group_equal(got, ref, stats, stats_ref):
    """Bit for bit: the kernel gives every element of Q the plain version's
    f32 updates in its order and sums a row's squares in `_block_sum`'s."""
    np.testing.assert_array_equal(_group_supports(got), _group_supports(ref))
    assert torch.equal(got, ref)
    assert torch.equal(stats, stats_ref)


def _group_vs_plain(gram, alphas, n_sweeps=200):
    """K3 and its plain version on the same card inputs, one launch
    counted: (got, ref, stats, stats_ref)."""
    A = alphas.shape[0]
    stats = torch.zeros((A, 2), dtype=torch.int32, device=alphas.device)
    stats_ref = torch.zeros_like(stats)
    before = group_cd.LAUNCHES
    got = group_cd.group_cd_solve_grid(gram.G, gram.C, alphas,
                                       n_sweeps=n_sweeps, stats=stats)
    torch.cuda.synchronize()
    assert group_cd.LAUNCHES == before + 1
    ref = group_cd.group_cd_solve_grid_plain(gram.G, gram.C, alphas,
                                             n_sweeps=n_sweeps,
                                             stats=stats_ref)
    return got, ref, stats, stats_ref


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,n_sweeps", [(256, 256, 200), (2048, 512, 3),
                                          (512, 2048, 3)])
def test_group_kernel_matches_plain_version(card, c, n, n_sweeps):
    """K3 against its plain version on the same card inputs: identical row
    supports, B bit for bit and the same sweeps and moving rows for every
    alpha; one launch counted."""
    gram, alphas = _group_problem(c + n, c, n, card)
    _assert_group_equal(*_group_vs_plain(gram, alphas, n_sweeps))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,n_sweeps", [(64, 64, 200), (256, 1024, 3),
                                          (1024, 512, 3)])
def test_group_kernel_at_resnet50_grplasso_edge_classes(card, c, n, n_sweeps):
    """ResNet-50 2x's 1x1 classes at the edges of K3's plans: (64, 64), 11
    rows a block of 6, 16 threads a column; (256, 1024), Q in device
    memory, one thread a column; (1024, 512), 110 of a block's 171 rows of
    Q in the spare shared memory. B and stats bit for bit against the
    plain version, one launch counted."""
    gram, alphas = _group_problem(c + 3 * n, c, n, card)
    _assert_group_equal(*_group_vs_plain(gram, alphas, n_sweeps))


@pytest.mark.cuda
@pytest.mark.parametrize("path,name", [("vgg16_3c_4x", "conv4_3"),
                                       ("frcnn_600_5x", "rpn_cls_score"),
                                       ("xception_2x", "mid1_sep3_pw")])
def test_fused_search_on_committed_lasso_designs(card, path, name):
    """One committed full-width LASSO design a path (the G and b the card's
    run gave the search): the fused search on K1 returns the card's
    recorded answer bit for bit and holds the JAX package's within
    `compare_design`'s bars (count equal, at most max(2, 1% of c)
    channels apart)."""
    from channel_pruning_tpu_torch import reference

    d = reference.load_lasso_designs(path)[1][name]
    before = lasso_cd.LAUNCHES
    mask, alpha, count = reference.solve_lasso(d, card)
    assert lasso_cd.LAUNCHES > before
    rec = d.meta["card"]
    np.testing.assert_array_equal(mask, reference.unpack_mask(rec["mask"]))
    assert (alpha, count) == (rec["alpha"], rec["count"])
    gap = reference.compare_design(d, mask, alpha, count)
    assert not gap.faults, gap.line()


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,n_alpha,variant", [
    (37, 64, 16, "smem"),      # c not a multiple of K: blocks of 4 and 5 rows
    (300, 1100, 16, "global"),  # 37-38 rows a block
    (64, 1500, 16, "global"),  # n > 1024 in device memory, 8 rows
    (72, 600, 16, "smem"),     # 9-12 rows of Q a thread in registers
    (50, 5, 16, "smem"),       # n < 32: 204 threads share a column
    (200, 600, 16, "global"),  # 1024 / n = 1: 424 threads idle in Q's update
    (40, 2100, 16, "global"),  # n > 2048: the slot read as Q updates, arrive after
    (256, 256, 1, "smem"),     # one alpha: the widest cluster
    (1, 8, 4, "smem"),         # one row: a cluster of one block
])
def test_group_kernel_awkward_shapes(card, c, n, n_alpha, variant):
    """K3 at shapes off the main path, each variant: B and stats bit for
    bit against the plain version over 200 sweeps."""
    gram, alphas = _group_problem(c * n, c, n, card)
    alphas = alphas[::16 // n_alpha][:n_alpha].contiguous()
    plan = group_cd.launch_plan(c, n, n_alpha, card)
    assert plan.variant == variant and plan.k >= min(c, 2)
    _assert_group_equal(*_group_vs_plain(gram, alphas))


@pytest.mark.cuda
def test_group_kernel_inf_alpha_and_stats(card):
    """An alpha of +inf leaves B at exactly 0 after one sweep with no moving
    row; the other alphas' sweeps stay within the limit; all of it equal to
    the plain version's."""
    gram, alphas = _group_problem(9, 128, 64, card)
    alphas[3] = float("inf")
    got, ref, stats, stats_ref = _group_vs_plain(gram, alphas)
    _assert_group_equal(got, ref, stats, stats_ref)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    st = stats.cpu().numpy()
    assert st[3].tolist() == [1, 0]
    assert (st[:, 0] >= 1).all() and (st[:, 0] <= 200).all()


@pytest.mark.cuda
def test_group_kernel_rejects_bad_inputs(card):
    G = torch.eye(8, device=card)
    C = torch.ones(8, 4, device=card)
    a = torch.ones(2, device=card)
    with pytest.raises(TypeError):
        group_cd.group_cd_solve_grid(G.double(), C, a)
    with pytest.raises(ValueError):
        group_cd.group_cd_solve_grid(G, C.cpu(), a)
    with pytest.raises(ValueError, match="n <= "):
        group_cd.group_cd_solve_grid(
            G, torch.ones(8, group_cd.MAX_N + 1, device=card), a)


@pytest.mark.cuda
def test_group_kernel_refuses_a_bad_plan(card, monkeypatch):
    """A plan the kernel cannot take (too little shared memory, more blocks
    than rows) makes the launch fail and the wrapper raise: no fallback."""
    gram, alphas = _group_problem(3, 64, 32, card)
    good = group_cd.launch_plan(64, 32, 16, card)
    for bad in (dataclasses.replace(good, smem_bytes=good.smem_bytes - 4),
                dataclasses.replace(good, k=65)):
        monkeypatch.setattr(group_cd, "launch_plan", lambda *a, p=bad: p)
        before = group_cd.LAUNCHES
        with pytest.raises(RuntimeError, match="launch failed"):
            group_cd.group_cd_solve_grid(gram.G, gram.C, alphas)
        assert group_cd.LAUNCHES == before


@pytest.mark.cuda
def test_synthetic_chunks_from_the_pinned_set_equal_fresh_draws(card):
    """On the card a synthetic set is drawn once into pinned host memory and
    chunks are copied from there: the same images as drawn batch by batch."""
    from channel_pruning_tpu_torch.sampling import inputs as inputs_mod

    src = inputs_mod.SyntheticInputs(n_batches=5, bs=3, sample_shape=(3, 8, 8),
                                     seed=4)
    got = inputs_mod.device_chunk(src, 1, 4, card)
    want = torch.cat([src.batch(i) for i in range(1, 4)]).to(card)
    assert torch.equal(got, want)
    assert src.pinned.is_pinned()
    assert torch.equal(inputs_mod.device_chunk(src, 0, 5, "cpu"),
                       torch.cat([src.batch(i) for i in range(5)]))


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,hw,o,k,s,group", [
    (16, 64, 56, 64, 3, 1, 1), (8, 256, 28, 512, 3, 1, 1),
    (4, 512, 38, 18, 1, 1, 1), (8, 64, 31, 128, 3, 2, 1),
    (8, 64, 28, 64, 3, 1, 64)],
    ids=["vgg_3x3", "vgg_3x3_wide", "rpn_1x1", "stride2", "depthwise"])
def test_bf16_conv_equals_f32_conv_of_rounded_operands(card, n, c, hw, o, k,
                                                       s, group):
    """The bf16 conv on the card (cuDNN with TF32 for that call where the
    shape is exact, else TF32 off) equals the f32 conv of the bf16-rounded
    operands within 1e-5 of its largest |value|: the JAX package's
    semantics, not the native bf16 conv's rounded output."""
    from channel_pruning_tpu_torch.ops import forward

    gen = torch.Generator(device=card).manual_seed(n + c + o)
    x = torch.randn((n, c, hw, hw), generator=gen, device=card).relu()
    w = torch.randn((o, c // group, k, k), generator=gen, device=card)
    b = torch.randn((o,), generator=gen, device=card)
    geo = dict(kh=k, kw=k, sh=s, sw=s, ph=k // 2, pw=k // 2, group=group)
    got = forward._conv2d(x, w, b, geo, torch.bfloat16)
    route = forward.conv_route(x.shape, w.shape, geo, torch.bfloat16, card)
    with forward.tf32_convs(False):
        ref = torch.nn.functional.conv2d(
            x.bfloat16().float(), w.bfloat16().float(), b, stride=s,
            padding=k // 2, groups=group)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert got.dtype == torch.float32 and route in ("tf32", "f32")
    assert err <= forward.EXACT_RTOL, (route, err)
    native = torch.nn.functional.conv2d(x.bfloat16(), w.bfloat16(), b.bfloat16(),
                                        stride=s, padding=k // 2, groups=group)
    assert float((native.float() - ref).abs().max() / ref.abs().max()) > err
    assert _tf32_flags() == (False, False)


@pytest.mark.cuda
def test_bf16_conv_restores_the_tf32_flags(card):
    """TF32 is on for the bf16 conv's own call only: the process-wide
    `device.fp32_solver` setting holds before, after, and after a conv
    that raises; the route is decided once a shape."""
    from channel_pruning_tpu_torch.ops import forward

    geo = dict(kh=3, kw=3, sh=1, sw=1, ph=1, pw=1, group=1)
    x = torch.randn((2, 16, 12, 12), device=card)
    w = torch.randn((8, 16, 3, 3), device=card)
    assert _tf32_flags() == (False, False)
    forward._conv2d(x, w, None, geo, torch.bfloat16)
    key = forward._route_key(x.shape, w.shape, geo, torch.bfloat16, card)
    assert forward._ROUTES[key] in ("tf32", "f32")
    assert _tf32_flags() == (False, False)
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    with pytest.raises(RuntimeError):
        forward._conv2d(x, w[:, :5], None, geo, torch.bfloat16)
    assert _tf32_flags() == (False, False)
