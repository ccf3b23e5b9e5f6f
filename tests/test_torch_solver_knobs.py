"""The port's solver options against the JAX package, each on the same numpy
inputs: the row-sparse group lasso (group_cd_solve, the group band search,
the group branch of select_and_reconstruct and `dic.grplasso` through the
solve), the fixed-alpha selection of autodet (select_channels_fixed,
`autodet=` and `solve.autodet` through the solve), the alternating
refinement (`alter_iters=`) and fitfc. Analogues of tests/test_solvers.py
(group lasso, group vs summed selection, autodet) and tests/test_pipeline.py
(alter, fitfc, autodet). The JAX side runs as its suite runs on the CPU
(XLA); the port's CD and group CD are their plain versions on CPU tensors.
Each package solves a graph built by its own builders from the same seed."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.rewrite import set_conv as jax_set_conv
from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
from channel_pruning_tpu.models.resnet import \
    build_tiny_resnet as jax_build_tiny_resnet
from channel_pruning_tpu.models.vgg import build_tiny_vgg as jax_build_tiny_vgg
from channel_pruning_tpu.ops import lasso as jax_lasso
from channel_pruning_tpu.ops import oracle
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.pipeline import prune as jax_prune
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.sampling import sample_patches as jax_sample_patches
from channel_pruning_tpu.sampling.sampler import \
    resnet_share_key as jax_share_key
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.rewrite import set_conv, split_relu
from channel_pruning_tpu_torch.kernels import group_cd
from channel_pruning_tpu_torch.models.resnet import build_tiny_resnet
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
from channel_pruning_tpu_torch.ops import lasso
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.pipeline import prune as prune_mod
from channel_pruning_tpu_torch.sampling import sampler
from torch_cpu import one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _multitask_problem(rng, N, c, n, k):
    X = rng.normal(size=(N, c)).astype(np.float32)
    B = np.zeros((c, n), np.float32)
    rows = rng.choice(c, k, replace=False)
    B[rows] = rng.normal(1, 1, (k, n)).astype(np.float32)
    Y = (X @ B + 0.01 * rng.normal(size=(N, n))).astype(np.float32)
    return X, Y


# --------------------------------------------------------------------------
# group lasso (tests/test_solvers.py:295-327)
# --------------------------------------------------------------------------

def test_group_lasso_matches_jax_and_sklearn(rng):
    """tests/test_solvers.py::test_group_lasso_matches_sklearn_multitask on
    the port: the same row support as sklearn's MultiTaskLasso and B within
    its bounds (rtol 5e-3, atol 1e-3); against the JAX package's
    group_cd_solve on the same Gram, B within 1e-5 of max|B| (the sum of
    squares of a row is reduced in another order) and the same support."""
    from sklearn.linear_model import MultiTaskLasso

    N, c, n = 300, 20, 6
    X, Y = _multitask_problem(rng, N, c, n, 7)
    alpha = 0.05
    gram_j = jax_lasso.group_gram(X, Y)
    B_j = np.asarray(jax_lasso.group_cd_solve(gram_j.G, gram_j.C, alpha * N,
                                              n_sweeps=2000))
    gram = lasso.group_gram(_t(X), _t(Y))
    np.testing.assert_array_equal(gram.G.numpy(), np.asarray(gram_j.G))
    np.testing.assert_array_equal(gram.C.numpy(), np.asarray(gram_j.C))
    B = lasso.group_cd_solve(gram.G, gram.C, alpha * N, n_sweeps=2000).numpy()
    assert np.abs(B - B_j).max() <= 1e-5 * np.abs(B_j).max()
    np.testing.assert_array_equal(
        lasso.group_row_norms(torch.from_numpy(B)).numpy() > 1e-8,
        np.asarray(jax_lasso.group_row_norms(B_j)) > 1e-8)
    sk = MultiTaskLasso(alpha=alpha, tol=1e-10, max_iter=5000).fit(X, Y)
    np.testing.assert_allclose(B, sk.coef_.T, rtol=5e-3, atol=1e-3)
    np.testing.assert_array_equal(
        lasso.group_row_norms(torch.from_numpy(B)).numpy() > 1e-8,
        np.linalg.norm(sk.coef_.T, axis=1) > 1e-8)


@pytest.mark.parametrize("prefer", ["top", "bottom"])
def test_group_search_alpha_band_matches_jax(rng, prefer):
    """tests/test_solvers.py::test_group_search_alpha_band: the support in
    the band [10, 12] (exactly 10 on the bottom end), and the port's mask,
    alpha and support equal to the JAX package's."""
    X, Y = _multitask_problem(rng, 400, 32, 8, 16)
    got = lasso.search_alpha_group(lasso.group_gram(_t(X), _t(Y)), 10, 0.1,
                                   prefer=prefer)
    want = jax_lasso.search_alpha_group(jax_lasso.group_gram(X, Y), 10, 0.1,
                                        prefer=prefer)
    assert 10 <= got[2] <= 12 and got[0].sum() == got[2]
    if prefer == "bottom":
        assert got[2] == 10
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_group_grid_plain_stats_and_stopping():
    """The plain version of K3 per alpha: an alpha of +inf leaves B at
    exactly 0 after one sweep with no moving row; each alpha's result is
    the one it reaches solved alone (the per-alpha stop freezes it)."""
    rng = np.random.default_rng(4)
    X, Y = _multitask_problem(rng, 200, 12, 5, 4)
    gram = lasso.group_gram(_t(X), _t(Y))
    alphas = torch.tensor([0.01 * 200, float("inf"), 0.2 * 200])
    stats = torch.zeros((3, 2), dtype=torch.int32)
    Bs = group_cd.group_cd_solve_grid(gram.G, gram.C, alphas, stats=stats)
    assert torch.equal(Bs[1], torch.zeros_like(Bs[1]))
    assert stats[1].tolist() == [1, 0]
    assert stats[0, 0] > 1 and stats[0, 1] > 0
    for i in (0, 2):
        alone = lasso.group_cd_solve(gram.G, gram.C, float(alphas[i]))
        assert torch.equal(Bs[i], alone)


def test_group_grid_refuses_no_cpu_fallback():
    """On the card the wrapper launches K3 or raises; a CPU tensor takes the
    plain version, and a non-CPU, non-CUDA device is refused."""
    G, C = torch.eye(4), torch.ones(4, 3)
    a = torch.ones(2)
    out = group_cd.group_cd_solve_grid(G, C, a)
    assert out.shape == (2, 4, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        group_cd._check_inputs(G.to("meta"), C.to("meta"), a.to("meta"), 1,
                               None)


# --------------------------------------------------------------------------
# group vs summed selection and the grplasso knob (tests/test_solvers.py:395-460)
# --------------------------------------------------------------------------

def test_group_vs_summed_selection_1x1_consumer(rng):
    """tests/test_solvers.py::test_group_vs_summed_selection_1x1_consumer:
    both branches recover the planted support with the exact count on the
    bottom band and rMSE < 0.1; the port's keep masks equal the JAX
    package's, rMSE within 1e-4 relative."""
    N, c, n, rank = 3000, 64, 128, 24
    planted = np.sort(rng.choice(c, rank, replace=False))
    X = rng.normal(0, 1, (N, c, 1, 1)).astype(np.float32)
    W2 = np.zeros((n, c, 1, 1), np.float32)
    W2[:, planted] = rng.normal(0, 1, (n, rank, 1, 1)).astype(np.float32) / rank
    Y = (np.einsum("nchw,ochw->no", X, W2)
         + 0.01 * rng.normal(size=(N, n))).astype(np.float32)
    want = np.zeros(c, bool)
    want[planted] = True
    for group in (False, True):
        r = prune_mod.select_and_reconstruct(_t(X), W2, _t(Y), rank,
                                             group=group, prefer="bottom",
                                             seed=0)
        rj = jax_prune.select_and_reconstruct(X, W2, Y, rank, group=group,
                                              prefer="bottom", seed=0)
        assert int(r.keep.sum()) == rank
        np.testing.assert_array_equal(r.keep, want)
        np.testing.assert_array_equal(r.keep, rj.keep)
        assert r.alpha == pytest.approx(rj.alpha, rel=1e-6)
        assert r.rmse_after < 0.1
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-4)


@pytest.fixture(scope="module")
def resnet():
    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    g_j, p_j = jax_c3.preprocess(*jax_build_tiny_resnet(batch=4, image_size=32))
    inputs = np.random.default_rng(0).normal(0, 1, (6, 4, 3, 32, 32)) \
        .astype(np.float32)
    cache_j = jax_freeze(g_j, to_device_params(p_j), inputs, n_points=4,
                         seed=0, chunk_batches=3, share_key=jax_share_key(g_j))
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device="cpu",
                           n_points=4, seed=0, chunk_batches=3,
                           share_key=sampler.resnet_share_key(g))
    return (g, g_j), (p, p_j), cache_j, cache


def test_grplasso_knob_through_the_solve_matches_jax(resnet):
    """tests/test_solvers.py::test_grplasso_knob_routes_through_pipeline:
    `dic.grplasso` on a graph with 1x1 convs takes the sequential path, the
    1x1 branch2c consumer keeps exactly its target on the bottom band, and
    the port selects as the JAX package does."""
    (g, g_j), (p, p_j), cache_j, cache = resnet
    consumer = next(c for c in g.convs if c.endswith("branch2c"))
    prod = next(c for c in g.convs if c.endswith("branch2b"))
    t = max(2, int(g.layer(prod).attr("num_output")) // 2)
    cfg = default_config().replace_nested("dic.grplasso", "true") \
        .replace_nested("solve.band", "bottom")
    res = c3.solve_prune(g, p, cache, cfg, channel_targets={prod: t},
                         device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, p_j, cache_j, cfg,
                               channel_targets={prod: t}, verbose=False)
    assert not res.pipelined
    assert int(res.selections[consumer].sum()) == t
    res.graph.validate()
    assert res.selections.keys() == res_j.selections.keys()
    for name, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name], keep,
                                      err_msg=name)
    for r, rj in zip(res.reports, res_j.reports):
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-4,
                                             abs=1e-6)


def _tiny_vgg_1x1(build, set_conv_, split_relu_, params=None):
    """The tiny VGG with conv3_1 cut to its centre tap (1x1, no padding), so
    that the 3C arm of conv2_2 prunes a 1x1 consumer; `params` (the port's
    numpy params) replace the builder's."""
    g, p = build(batch=4, image_size=16)
    p = params if params is not None else p
    W = np.asarray(p["conv3_1"]["W"])[:, :, 1:2, 1:2]
    g, p = set_conv_(g, p, "conv3_1", W=W, pad_h=0, pad_w=0)
    return split_relu_(g), p


def test_grplasso_3c_arm_on_1x1_consumer_matches_jax(monkeypatch):
    """`dic.grplasso` in 3C (JAX c3.py:1188): with ranks {conv2_1: 9,
    conv2_2: 9} the arms prune conv2_2 (3x3, the single-task search) and
    conv3_1 (1x1 here, the group lasso). The group solve runs, and the
    port's decomposition and selections equal the JAX package's; rMSEs
    within 1e-3 relative, as tests/test_torch_3c.py holds 3C."""
    import dataclasses

    g, p = _tiny_vgg_1x1(build_tiny_vgg, set_conv, split_relu)
    g_j, _ = _tiny_vgg_1x1(jax_build_tiny_vgg, jax_set_conv, jax_split_relu,
                           params=build_tiny_vgg(batch=4, image_size=16)[1])
    assert g.layer("conv3_1").conv_geometry()["kh"] == 1
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)) \
        .astype(np.float32)
    cfg = default_config().replace_nested("dic.grplasso", "true")
    cfg = dataclasses.replace(cfg, solve=dataclasses.replace(
        cfg.solve, nonlinear_iters=(4, 2), itq_iters=(4, 2)))
    ranks = {"conv2_1": 9, "conv2_2": 9}
    cache_j = jax_freeze(g_j, to_device_params(p), inputs, n_points=10,
                         seed=0, chunk_batches=4)
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs,
                           device="cpu", n_points=10, seed=0, chunk_batches=4)
    calls = []
    real = group_cd.group_cd_solve_grid
    monkeypatch.setattr(group_cd, "group_cd_solve_grid",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    res = c3.solve_3c(g, p, cache, cfg, ranks, device="cpu", verbose=False)
    res_j = jax_c3.solve_3c(g_j, p, cache_j, cfg, ranks, verbose=False)
    assert calls and all(shape == (12, 12) for shape in calls)
    assert res.selections.keys() == res_j.selections.keys() == \
        {"conv2_2", "conv3_1"}
    for name, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name], keep,
                                      err_msg=name)
    shapes = {l.name: res.params[l.name]["W"].shape
              for l in res.graph.layers if l.type == "Convolution"}
    assert shapes == {l.name: np.asarray(res_j.params[l.name]["W"]).shape
                      for l in res_j.graph.layers if l.type == "Convolution"}
    for r, rj in zip(res.reports, res_j.reports):
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3), r.conv


# --------------------------------------------------------------------------
# autodet (tests/test_solvers.py:614-662)
# --------------------------------------------------------------------------

def test_select_channels_fixed_matches_jax_and_sklearn(rng):
    """tests/test_solvers.py::test_select_channels_fixed_matches_sklearn:
    the fixed-alpha support agrees with sklearn's Lasso on > 90% of the
    channels, is neither empty nor full, and equals the JAX package's."""
    import jax.numpy as jnp

    N, c, n, k = 3000, 24, 16, 3
    X = rng.normal(size=(N, c, k, k)).astype(np.float32)
    Wtrue = (rng.normal(size=(n, c, k, k))
             * (rng.uniform(size=(1, c, 1, 1)) < 0.5)).astype(np.float32)
    Y = oracle.conv_response_at_points(X, Wtrue).astype(np.float32)
    W2 = Wtrue + 0.05 * rng.normal(size=Wtrue.shape).astype(np.float32)
    alpha = 1e-1 / c
    mask, got_alpha, support = lasso.select_channels_fixed(
        _t(X), _t(W2), _t(Y), alpha, subsample=400, seed=0, n_sweeps=2000)
    mask_j, _, support_j = jax_lasso.select_channels_fixed(
        X, W2, Y, alpha, subsample=400, seed=0, n_sweeps=2000)
    assert got_alpha == alpha
    assert 0 < support < c
    np.testing.assert_array_equal(mask, mask_j)
    assert support == support_j
    rows = np.random.default_rng(0).integers(0, N, size=min(400, N // 20))
    Z = np.asarray(jax_lasso.build_channel_response(
        jnp.asarray(X[rows]), jnp.asarray(W2)))
    sk_mask, _ = oracle.sklearn_lasso_support(Z, Y[rows].reshape(-1), alpha)
    assert (mask == sk_mask).mean() > 0.9


def test_cd_solve_is_one_grid_launch(rng):
    """The port's one-alpha cd_solve is the grid solve at that alpha, and
    matches the JAX package's cd_solve from beta = 0 (same support, betas
    within 1e-5 of the largest)."""
    Z = rng.normal(size=(400, 16)).astype(np.float32)
    y = (Z[:, :5] @ rng.normal(size=5) + 0.01 * rng.normal(size=400)) \
        .astype(np.float32)
    gram = lasso.lasso_gram(_t(Z), _t(y))
    gram_j = jax_lasso.lasso_gram(Z, y)
    a_n = 0.05 * 400
    beta = lasso.cd_solve(gram.G, gram.b, a_n)
    grid = lasso.lasso_cd.cd_solve_grid(gram.G, gram.b,
                                        torch.tensor([a_n], dtype=torch.float32))
    assert torch.equal(beta, grid[0])
    beta_j = np.asarray(jax_lasso.cd_solve(gram_j.G, gram_j.b, np.float32(a_n),
                                           np.zeros(16, np.float32)))
    np.testing.assert_array_equal(
        lasso.support_mask(beta[None])[0].numpy(),
        np.asarray(jax_lasso.support_mask(beta_j[None])[0]))
    assert np.abs(beta.numpy() - beta_j).max() <= 1e-5 * np.abs(beta_j).max()


def test_autodet_through_select_and_reconstruct_matches_jax(rng):
    """tests/test_solvers.py::test_autodet_knob_through_select_and_reconstruct:
    the kept count is alpha-determined (not forced to rank 4), a larger
    layeralpha keeps at least as much, the reconstruction fits (rMSE <
    1e-2), the recorded alpha is exactly alpha0 / c**layeralpha even with
    `fused=True` asked for; and the port keeps the JAX package's channels."""
    N, c, n, k = 2000, 16, 12, 3
    X = np.maximum(rng.normal(size=(N, c, k, k)).astype(np.float32), 0)
    W2 = (rng.normal(size=(n, c, k, k))
          * (rng.uniform(size=(1, c, 1, 1)) < 0.6)).astype(np.float32) / c
    Y = np.einsum("nchw,ochw->no", X, W2).astype(np.float32)
    out = {}
    for la in (1.0, 2.0):
        r = prune_mod.select_and_reconstruct(_t(X), W2, _t(Y), rank=4,
                                             autodet=True, alpha0=3e-2,
                                             layeralpha=la, fused=True)
        rj = jax_prune.select_and_reconstruct(X, W2, Y, rank=4, autodet=True,
                                              alpha0=3e-2, layeralpha=la)
        np.testing.assert_array_equal(r.keep, rj.keep)
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-4,
                                             abs=1e-6)
        np.testing.assert_allclose(r.alpha, 3e-2 / 16 ** la, rtol=1e-6)
        assert r.grids is None          # not the fused search
        out[la] = r
    assert out[1.0].keep.sum() != 4 or out[2.0].keep.sum() != 4
    assert out[2.0].keep.sum() >= out[1.0].keep.sum()
    assert out[1.0].rmse_after < 1e-2


# --------------------------------------------------------------------------
# the tiny VGG: alter, fitfc, autodet (tests/test_pipeline.py:266,285,432)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg():
    g, params = build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    g_j = jax_split_relu(jax_build_tiny_vgg(batch=4, image_size=16)[0])
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)) \
        .astype(np.float32)
    cache_j = jax_freeze(g_j, to_device_params(params), inputs, n_points=10,
                         seed=0, chunk_batches=4)
    cache = sampler.freeze(g, params_to_torch(params, "cpu"), inputs,
                           device="cpu", n_points=10, seed=0, chunk_batches=4)
    return (g, g_j), params, inputs, default_config(), cache_j, cache


def _probs(graph, params, x):
    outs, _ = run_graph(graph, params_to_torch(params, "cpu"),
                        {"data": torch.from_numpy(x)})
    return outs["prob"].numpy()


def test_alter_refinement_matches_jax(vgg):
    """tests/test_pipeline.py::test_alter_refinement_runs: two alternating
    refinements keep >= 4 channels at no worse than 1.5x the plain rMSE,
    and the port refines to the JAX package's mask (rMSE within 1e-4
    relative) from the same patches."""
    (g, g_j), params, inputs, _, cache_j, cache = vgg
    conv = "conv2_2"
    top = g.layer(conv).tops[0]
    X = jax_sample_patches(g_j, to_device_params(params), inputs, conv,
                           cache_j.plan, chunk_batches=4)
    X = np.asarray(X)
    Y = cache_j.feats[top] - params[conv]["b"]
    base = prune_mod.select_and_reconstruct(_t(X), params[conv]["W"], _t(Y),
                                            8, seed=0)
    alt = prune_mod.select_and_reconstruct(_t(X), params[conv]["W"], _t(Y),
                                           8, seed=0, alter_iters=2)
    alt_j = jax_prune.select_and_reconstruct(X, params[conv]["W"], Y, 8,
                                             seed=0, alter_iters=2)
    assert alt.keep.sum() >= 4
    assert alt.rmse_after <= base.rmse_after * 1.5
    np.testing.assert_array_equal(alt.keep, alt_j.keep)
    assert alt.rmse_after == pytest.approx(alt_j.rmse_after, rel=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_fitfc_prunes_last_conv_as_jax(vgg, fused):
    """tests/test_pipeline.py::test_fitfc_prunes_last_conv, after the
    pipelined pass and after the sequential one: fc6 is in the selections,
    the last conv keeps fc6's count, fc6's weight columns are sliced to
    match, the pruned net gives probabilities; the port selects as the JAX
    package in every layer, fc6 included."""
    (g, g_j), params, inputs, cfg, cache_j, cache = vgg
    last_conv = g.convs[-1]
    n_out = params[last_conv]["W"].shape[0]
    cfg2 = cfg.replace_nested("dic.fitfc", True) \
        .replace_nested("solve.fused_search", fused)
    targets = {last_conv: max(2, int(n_out * 0.6))}
    res = c3.solve_prune(g, params, cache, cfg2, channel_targets=targets,
                         device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg2,
                               channel_targets=targets, verbose=False)
    fc = g.fcs[0]
    assert res.pipelined == fused
    keep = res.selections[fc]
    assert res.params[last_conv]["W"].shape[0] == keep.sum() < n_out
    hw = res.params[fc]["W"].shape[1] // int(keep.sum())
    assert res.params[fc]["W"].shape[1] == keep.sum() * hw
    np.testing.assert_allclose(_probs(res.graph, res.params, inputs[0])
                               .sum(-1), 1.0, rtol=1e-4)
    assert res.selections.keys() == res_j.selections.keys()
    for name, keep_j in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name], keep_j,
                                      err_msg=name)
    r, rj = res.reports[-1], res_j.reports[-1]
    assert (r.conv, r.kind) == (fc, "fc") and rj.conv == fc
    # fc6's input is exact before its own prune (only the last conv has a
    # target): both rMSEs before are ~0
    assert r.rmse_before == pytest.approx(rj.rmse_before, rel=1e-4, abs=1e-6)
    assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-4, abs=1e-6)
    # fc6's refit has more columns (kept x 2 x 2) than images (32): the
    # jitter decides it, and f32 normal equations amplify another
    # summation order to ~4e-3 of the largest |W| (as in
    # tests/test_torch_resnet_pipeline.py), while the rMSE agrees to 1e-4
    want = np.asarray(res_j.params[fc]["W"])
    np.testing.assert_allclose(res.params[fc]["W"], want, rtol=5e-3,
                               atol=5e-3 * np.abs(want).max())


def test_autodet_pipeline_knob_matches_jax(vgg):
    """tests/test_pipeline.py::test_autodet_pipeline_knob: `solve.autodet`
    selects with one fixed-alpha LASSO a layer (alpha = solve.alpha /
    c**layeralpha), on the sequential path although the pipelined pass is
    the default; the pruned net gives probabilities, and every layer keeps
    the JAX package's channels."""
    (g, g_j), params, inputs, cfg, cache_j, cache = vgg
    targets = {"conv1_1": 5, "conv1_2": 6, "conv2_1": 8}
    cfg2 = cfg.replace_nested("solve.autodet", True) \
        .replace_nested("solve.alpha", 1e-4)
    res = c3.solve_prune(g, params, cache, cfg2, channel_targets=targets,
                         device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg2,
                               channel_targets=targets, verbose=False)
    assert not res.pipelined and res.selections
    res.graph.validate()
    for r in res.reports:
        np.testing.assert_allclose(r.alpha, 1e-4 / r.total, rtol=1e-6)
    np.testing.assert_allclose(_probs(res.graph, res.params, inputs[0])
                               .sum(-1), 1.0, rtol=1e-4)
    assert res.selections.keys() == res_j.selections.keys()
    for name, keep_j in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name], keep_j,
                                      err_msg=name)


# --------------------------------------------------------------------------
# the port's `cli prune` refuses only bf16 replays
# --------------------------------------------------------------------------

def _cli_prune(tmp_path, *extra):
    from channel_pruning_tpu_torch import cli

    return cli.main(["prune", "--model", "tiny_vgg", "--batch", "4",
                     "--cal-batches", "4", "--cal-batch", "4", "--speed",
                     "2.0", "--device", "cpu", "--work-dir", str(tmp_path),
                     *extra])


@pytest.mark.parametrize("knob,pipelined", [("dic.fitfc=true", True),
                                            ("solve.autodet=true", False),
                                            ("dic.grplasso=true", True)])
def test_cli_prune_runs_each_knob(tmp_path, knob, pipelined):
    """`cli prune --set <knob>` on the tiny VGG runs to an export that
    reloads and gives probabilities: fitfc prunes conv3_2 through fc6,
    autodet skips the pipelined pass (one fixed-alpha solve a layer), and
    grplasso keeps it (the tiny VGG has no 1x1 conv)."""
    from channel_pruning_tpu_torch.io import caffe as cio

    res = _cli_prune(tmp_path, "--set", knob)
    assert res.pipelined == pipelined
    if knob.startswith("dic.fitfc"):
        assert "fc6" in res.selections
        assert res.params["conv3_2"]["W"].shape[0] == res.selections["fc6"].sum()
    g, p = cio.import_model(tmp_path / "cp_tiny_vgg.prototxt",
                            tmp_path / "cp_tiny_vgg.caffemodel")
    x = np.random.default_rng(0).normal(size=(4, 3, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(_probs(g, p, x).sum(-1), 1.0, rtol=1e-5)


def test_cli_prune_refuses_bf16_before_the_freeze(tmp_path, monkeypatch):
    """A `solve.dtype` the replays do not run (float16: neither package
    replays in it) is refused before the calibration set is frozen;
    bfloat16 runs (tests/test_torch_bf16.py)."""
    def no_freeze(*a, **k):
        raise AssertionError("the freeze ran before the refusal")

    monkeypatch.setattr(sampler, "freeze", no_freeze)
    with pytest.raises(ValueError, match="solve.dtype=float16"):
        _cli_prune(tmp_path, "--set", "solve.dtype=float16")
    assert not list(tmp_path.glob("frozen_*"))
    cfg = default_config()
    for knob in ("dic.fitfc", "solve.autodet", "dic.grplasso"):
        c3.check_supported(None, cfg.replace_nested(knob, True))
