"""The port's ResNet path against the JAX package: the DAG frontier, Select
gates in front of each block's branch2a (`input_targets`), and residual
compensation, in the sequential host-stepped solve
(`solve.fused_search=False` on both sides; the port's CD is its plain
version on the CPU). Targets as in tests/test_resnet_pipeline.py:56-69."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.ir import LT
from channel_pruning_tpu.models.resnet import build_tiny_resnet
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.sampling.sampler import \
    resnet_share_key as jax_share_key
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.sampling import sampler


def _targets(g, p):
    """Shrink branch2a/2b to 70%; gate 70% of every block input."""
    channel_targets, input_targets = {}, {}
    for conv in g.convs:
        n = int(g.layer(conv).attr("num_output"))
        if conv.endswith(("branch2a", "branch2b")):
            channel_targets[conv] = max(2, int(n * 0.7))
        if conv.endswith("branch2a"):
            input_targets[conv] = max(2, int(p[conv]["W"].shape[1] * 0.7))
    return channel_targets, input_targets


@pytest.fixture(scope="module")
def setup():
    g0, p0 = build_tiny_resnet(batch=4, image_size=32)
    g, p = c3.preprocess(g0, p0)
    inputs = np.random.default_rng(11).normal(0, 1, (8, 4, 3, 32, 32)) \
        .astype(np.float32)
    cfg = default_config().replace_nested("solve.fused_search", False)
    cache_j = jax_freeze(g, to_device_params(p), inputs, n_points=8, seed=0,
                         chunk_batches=4, share_key=jax_share_key(g))
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device="cpu",
                           n_points=8, seed=0, chunk_batches=4,
                           share_key=sampler.resnet_share_key(g))
    return g, p, inputs, cfg, cache_j, cache, _targets(g, p)


def test_resnet_freeze_matches_jax(setup):
    g, _, _, _, cache_j, cache, _ = setup
    assert cache.plan.keys() == cache_j.plan.keys()
    for t, (ys, xs) in cache_j.plan.items():
        np.testing.assert_array_equal(cache.plan[t][0], ys)
        np.testing.assert_array_equal(cache.plan[t][1], xs)
    assert cache.feats.keys() == cache_j.feats.keys()
    for t, f in cache_j.feats.items():
        np.testing.assert_allclose(cache.feats[t], f, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("band,residual_compensate",
                         [("top", True), ("bottom", True), ("top", False),
                          ("bottom", False)])
def test_solve_prune_matches_jax(setup, band, residual_compensate):
    """Selections identical to the JAX package's layer for layer, one Select
    gate per branch2a in both, the same rMSE, weights close, and the pruned
    net gives probabilities in the port.

    The weights come from f32 normal equations (ops/lstsq), which square the
    design's condition number: the last-bit differences of another summation
    order (torch's CPU matmul against XLA's) grow to ~1e-3 absolute on
    weights up to ~3 in the 3x3 layers of this problem (up to 8e-4 of the
    layer's largest |W|). So the absolute tolerance of
    tests/test_resnet_pipeline.py:200-203 (5e-5, for two XLA paths) is
    scaled to each layer's largest |W| here, at 5e-3 of it."""
    g, p, inputs, cfg, cache_j, cache, (ct, it) = setup
    cfg = cfg.replace_nested("solve.band", band)
    res_j = jax_c3.solve_prune(g, p, cache_j, cfg, channel_targets=ct,
                               input_targets=it,
                               residual_compensate=residual_compensate,
                               verbose=False)
    res = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                         input_targets=it,
                         residual_compensate=residual_compensate,
                         device="cpu", verbose=False)
    assert [r.conv for r in res.reports] == [r.conv for r in res_j.reports]
    for name, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name], keep,
                                      err_msg=name)
    for r, rj in zip(res.reports, res_j.reports):
        assert r.kind == ("gate" if r.conv in it else "prune")
        assert r.rmse_before == pytest.approx(rj.rmse_before, rel=1e-3, abs=1e-5)
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3, abs=1e-5)
    gates = res.graph.by_type(LT.SELECT)
    assert len(gates) == len(res_j.graph.by_type(LT.SELECT)) == len(it)
    for s in gates:
        cons = res.graph.consumers(s.tops[0])
        assert len(cons) == 1 and cons[0].name.endswith("branch2a")
    res.graph.validate()
    for name in res_j.selections:
        want = np.asarray(res_j.params[name]["W"])
        np.testing.assert_allclose(res.params[name]["W"], want, rtol=5e-3,
                                   atol=5e-3 * np.abs(want).max(),
                                   err_msg=name)
    if band == "bottom":
        for prod, t in ct.items():
            assert res.params[prod]["W"].shape[0] == t, prod
    outs, _ = run_graph(res.graph, params_to_torch(res.params, "cpu"),
                        {"data": torch.from_numpy(inputs[0])})
    np.testing.assert_allclose(outs["prob"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_full_replay_path_selects_like_the_frontier(setup, monkeypatch):
    """With the frontier refused (`_maybe_rolling` -> None) the solve
    replays from the input and samples the shortcut with sample_features
    (host result uploaded): the same selections as the DAG frontier."""
    g, p, _, cfg, _, cache, (ct, it) = setup
    cfg = cfg.replace_nested("solve.band", "bottom")
    rolled = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                            input_targets=it, device="cpu", verbose=False)
    monkeypatch.setattr(c3, "_maybe_rolling", lambda *a, **k: None)
    replayed = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                              input_targets=it, device="cpu", verbose=False)
    assert rolled.selections.keys() == replayed.selections.keys()
    for name, keep in rolled.selections.items():
        np.testing.assert_array_equal(replayed.selections[name], keep,
                                      err_msg=name)


@pytest.mark.slow
def test_resnet50_64px_selections_match_jax():
    """Full-width ResNet-50 at 64 px, 100 host images, the released 2x
    tables with the bottom band: both packages keep the same number of
    channels in all 40 layers, the two c = 2048 gates (res5b/res5c)
    included, and select the same channels in all of res2 and res3.

    The two sides differ in summation order only, and f32 normal equations
    amplify that: the relative gap in a layer's starting rMSE grows from
    ~1e-7 at res2 to ~1e-5 at the end of res3 and ~4e-3 at res5. From res4
    on, where it passes ~1e-5, a LASSO coefficient at the selection's
    threshold can change sides: a few layers swap one or two channels for
    near-equal ones, which layers depends on the thread count of the host
    matmuls. So from res4 on the selections may differ by at most two
    swapped pairs a layer, and the rMSE after by 2% relative. Takes ~40
    minutes on a CPU, most of it in the JAX package's solve."""
    from channel_pruning_tpu.models.resnet import (build_resnet50,
                                                   resnet50_2x_targets)
    from channel_pruning_tpu.models.vgg import init_params
    from channel_pruning_tpu.sampling.sampler import (freeze_tensor_set,
                                                      params_for_tensors)

    g = build_resnet50(batch=10, image_size=64)
    g, params = jax_c3.preprocess(g, init_params(g, seed=0))
    inputs = np.random.default_rng(0).normal(size=(10, 10, 3, 64, 64)) \
        .astype(np.float32)
    cfg = default_config().replace_nested("solve.fused_search", False) \
        .replace_nested("solve.band", "bottom")
    tensors = freeze_tensor_set(g, include_fc=False)
    fp = params_for_tensors(g, params, tensors)
    cache_j = jax_freeze(g, to_device_params(fp), inputs, tensors=tensors,
                         n_points=10, seed=0, chunk_batches=20,
                         share_key=jax_share_key(g))
    cache = sampler.freeze(g, params_to_torch(fp, "cpu"), inputs, device="cpu",
                           tensors=tensors, n_points=10, seed=0,
                           chunk_batches=20,
                           share_key=sampler.resnet_share_key(g))
    ct, it = resnet50_2x_targets()
    res_j = jax_c3.solve_prune(g, params, cache_j, cfg, channel_targets=ct,
                               input_targets=it, verbose=False)
    res = c3.solve_prune(g, params, cache, cfg, channel_targets=ct,
                         input_targets=it, device="cpu", verbose=False)
    assert [r.conv for r in res.reports] == [r.conv for r in res_j.reports]
    assert len(res.reports) == 40
    for r, rj in zip(res.reports, res_j.reports):
        keep, keep_j = res.selections[r.conv], res_j.selections[r.conv]
        assert r.kept == rj.kept, r.conv
        if r.conv.startswith(("res2", "res3")):
            np.testing.assert_array_equal(keep, keep_j, err_msg=r.conv)
            assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3,
                                                 abs=1e-5), r.conv
        else:
            assert int((keep != keep_j).sum()) <= 4, r.conv
            assert r.rmse_after == pytest.approx(rj.rmse_after, rel=2e-2), \
                r.conv
    wide = [r.conv for r in res.reports if r.total == 2048]
    assert wide == ["res5b_branch2a", "res5c_branch2a"]
