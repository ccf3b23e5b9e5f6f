"""The port's fused whole-layer solve and pipelined pass against the JAX
package and against the port's sequential path: `_fused_layer_solve`
through `select_and_reconstruct(fused=True)`, `pad_to` inertness, the
pipelined chain pass (tiny VGG) and DAG pass (tiny ResNet: gates,
residual compensation), the restart after a degenerate layer, a crash and
resume inside the pipelined pass, and the phase timing. Each package
solves a graph built by its own builders from the same seed; the JAX side
runs as its suite runs on the CPU (XLA CD), the port's on the plain CD."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
from channel_pruning_tpu.models.resnet import \
    build_tiny_resnet as jax_build_tiny_resnet
from channel_pruning_tpu.models.vgg import build_tiny_vgg as jax_build_tiny_vgg
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.pipeline import prune as jax_prune
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.sampling.sampler import \
    resnet_share_key as jax_share_key
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.ir import LT
from channel_pruning_tpu_torch.graph.rewrite import split_relu
from channel_pruning_tpu_torch.models.resnet import build_tiny_resnet
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.pipeline import prune as prune_mod
from channel_pruning_tpu_torch.sampling import sampler
from torch_cpu import one_thread  # noqa: F401

VGG_TARGETS = {"conv1_1": 5, "conv1_2": 6, "conv2_1": 8, "conv2_2": 9,
               "conv3_1": 10}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("prefer", ["top", "bottom"])
def test_fused_layer_solve_matches_jax(prefer):
    """tests/test_pipeline.py::test_fused_layer_solve_matches_default's
    problem: the port's fused layer solve keeps the JAX package's fused
    channels, W within 1e-4 of its largest |W|, rMSE within 1e-3; and
    against the port's own host-stepped path the JAX test's bounds."""
    rng = np.random.default_rng(0)
    N, c, n, k = 4000, 64, 128, 3
    base = rng.normal(0, 1, (N, c // 4, k, k)).astype(np.float32)
    mix = rng.normal(0, 0.5, (c // 4, c)).astype(np.float32)
    X = np.maximum(np.einsum("nqhw,qc->nchw", base, mix)
                   + 0.3 * rng.normal(0, 1, (N, c, k, k)).astype(np.float32), 0)
    W2 = ((rng.normal(0, 1, (n, c, k, k))
           * (rng.uniform(size=(1, c, 1, 1)) < 0.7)).astype(np.float32)
          / (c * k))
    Y = np.einsum("nchw,ochw->no", X, W2).astype(np.float32)
    rj = jax_prune.select_and_reconstruct(X, W2, Y, 40, prefer=prefer,
                                          fused=True)
    r = prune_mod.select_and_reconstruct(_t(X), W2, _t(Y), 40, prefer=prefer,
                                         fused=True)
    np.testing.assert_array_equal(r.keep, rj.keep)
    assert np.max(np.abs(r.W - rj.W)) / np.max(np.abs(rj.W)) < 1e-4
    assert abs(r.rmse_after - rj.rmse_after) < 1e-3
    assert abs(r.rmse_before - rj.rmse_before) < 1e-5    # both ~0: Y = X*W2
    seq = prune_mod.select_and_reconstruct(_t(X), W2, _t(Y), 40,
                                           prefer=prefer)
    np.testing.assert_array_equal(seq.keep, r.keep)
    assert np.max(np.abs(seq.W - r.W)) / np.max(np.abs(seq.W)) < 1e-4
    assert abs(seq.rmse_after - r.rmse_after) < 1e-3


def test_pad_to_is_inert():
    """tests/test_pipeline.py::test_select_and_reconstruct_pad_to_inert:
    zero-padding the fused solve's inputs changes no selection."""
    rng = np.random.default_rng(3)
    N, c, n, k = 2000, 24, 40, 3
    X = np.maximum(rng.normal(0, 1, (N, c, k, k)).astype(np.float32), 0)
    W2 = (rng.normal(0, 1, (n, c, k, k)).astype(np.float32)) / (c * k)
    Y = np.einsum("nchw,ochw->no", X, W2).astype(np.float32)
    r1 = prune_mod.select_and_reconstruct(_t(X), W2, _t(Y), 12, fused=True)
    r2 = prune_mod.select_and_reconstruct(_t(X), W2, _t(Y), 12, fused=True,
                                          pad_to=(64, 64))
    np.testing.assert_array_equal(r1.keep, r2.keep)
    assert r2.W.shape == r1.W.shape and r2.b.shape == (n,)
    np.testing.assert_allclose(r1.W, r2.W, rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(r1.rmse_after, r2.rmse_after, rtol=1e-4)


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
    cfg = default_config().replace_nested("solve.band", "bottom")
    assert cfg.solve.fused_search
    return (g, g_j), params, cfg, cache_j, cache


@pytest.fixture(scope="module")
def resnet():
    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    g_j, p_j = jax_c3.preprocess(*jax_build_tiny_resnet(batch=4, image_size=32))
    inputs = np.random.default_rng(11).normal(0, 1, (8, 4, 3, 32, 32)) \
        .astype(np.float32)
    cache_j = jax_freeze(g_j, to_device_params(p_j), inputs, n_points=8,
                         seed=0, chunk_batches=4, share_key=jax_share_key(g_j))
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device="cpu",
                           n_points=8, seed=0, chunk_batches=4,
                           share_key=sampler.resnet_share_key(g))
    ct, it = {}, {}
    for conv in g.convs:       # tests/test_resnet_pipeline.py:156-163
        n = int(g.layer(conv).attr("num_output"))
        if conv.endswith(("branch2a", "branch2b")):
            ct[conv] = max(2, int(n * 0.7))
        if conv.endswith("branch2a"):
            it[conv] = max(2, int(p[conv]["W"].shape[1] * 0.7))
    cfg = default_config().replace_nested("solve.band", "bottom")
    return (g, g_j), (p, p_j), inputs, cfg, cache_j, cache, (ct, it)


def _spy_pass(monkeypatch):
    """Records each pipelined pass that ran to its end."""
    done, real = [], c3._pipelined_conv_pass

    def spy(*a, **kw):
        out = real(*a, **kw)        # raises _PipelineDegenerate on a bail-out
        done.append(True)
        return out

    monkeypatch.setattr(c3, "_pipelined_conv_pass", spy)
    return done


def test_pipelined_chain_pass_matches_sequential_and_jax(vgg, monkeypatch,
                                                         capsys):
    """tests/test_pipeline.py::test_pipelined_pass_matches_sequential on
    the port, and the JAX package's pipelined pass: identical selections;
    W and rMSE within that test's tolerances against the port's sequential
    pass; against JAX, rMSE within tests/test_torch_pipeline.py's and W
    within tests/test_torch_resnet_pipeline.py's (5e-3 of the layer's
    largest |W|: f32 normal equations amplify another summation order)."""
    (g, g_j), params, cfg, cache_j, cache = vgg
    done = _spy_pass(monkeypatch)
    piped = c3.solve_prune(g, params, cache, cfg, channel_targets=VGG_TARGETS,
                           device="cpu")
    assert done == [True] and piped.pipelined
    out = capsys.readouterr().out
    assert out.count("s pipelined)") == len(piped.reports) == 5
    assert "[pipeline]" not in out
    assert all(r.grids is not None and 1 <= r.grids <= cfg.lasso.max_rounds
               for r in piped.reports)
    seq = c3.solve_prune(g, params, cache, cfg, channel_targets=VGG_TARGETS,
                         device="cpu", verbose=False, _no_pipeline=True)
    assert not seq.pipelined
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg,
                               channel_targets=VGG_TARGETS, verbose=False)
    assert set(piped.selections) == set(seq.selections) == set(res_j.selections)
    for name in seq.selections:
        np.testing.assert_array_equal(piped.selections[name],
                                      seq.selections[name], err_msg=name)
        np.testing.assert_array_equal(piped.selections[name],
                                      res_j.selections[name], err_msg=name)
        np.testing.assert_allclose(piped.params[name]["W"],
                                   seq.params[name]["W"], rtol=1e-2, atol=1e-4)
        want = np.asarray(res_j.params[name]["W"])
        np.testing.assert_allclose(piped.params[name]["W"], want, rtol=5e-3,
                                   atol=5e-3 * np.abs(want).max(),
                                   err_msg=name)
    for pr, sr, jr in zip(piped.reports, seq.reports, res_j.reports):
        assert pr.conv == sr.conv == jr.conv
        np.testing.assert_allclose(pr.rmse_after, sr.rmse_after, rtol=1e-4)
        assert pr.rmse_after == pytest.approx(jr.rmse_after, rel=1e-3, abs=1e-5)
    for prod, t in VGG_TARGETS.items():
        assert piped.params[prod]["W"].shape[0] == t


def test_pipelined_dag_pass_matches_sequential_and_jax(resnet, monkeypatch):
    """tests/test_resnet_pipeline.py::test_pipelined_dag_pass_matches_
    sequential on the port: gate-only targets, residual-compensated
    block-ending consumers and shrink targets give exactly the sequential
    pass's selections and the JAX package's pipelined ones, and the pass
    runs to its end. W against the sequential pass within that test's
    tolerances; against JAX within tests/test_torch_resnet_pipeline.py's
    (f32 normal equations amplify another summation order)."""
    (g, g_j), (p, p_j), inputs, cfg, cache_j, cache, (ct, it) = resnet
    done = _spy_pass(monkeypatch)
    piped = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                           input_targets=it, device="cpu", verbose=False)
    assert done == [True] and piped.pipelined
    seq = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                         input_targets=it, device="cpu", verbose=False,
                         _no_pipeline=True)
    res_j = jax_c3.solve_prune(g_j, p_j, cache_j, cfg, channel_targets=ct,
                               input_targets=it, verbose=False)
    assert set(piped.selections) == set(seq.selections) == set(res_j.selections)
    for name in seq.selections:
        np.testing.assert_array_equal(piped.selections[name],
                                      seq.selections[name], err_msg=name)
        np.testing.assert_array_equal(piped.selections[name],
                                      res_j.selections[name], err_msg=name)
        np.testing.assert_allclose(piped.params[name]["W"],
                                   seq.params[name]["W"], rtol=5e-3, atol=5e-5)
        want = np.asarray(res_j.params[name]["W"])
        np.testing.assert_allclose(piped.params[name]["W"], want, rtol=5e-3,
                                   atol=5e-3 * np.abs(want).max(),
                                   err_msg=name)
    assert [r.kind for r in piped.reports] == \
        ["gate" if r.conv in it else "prune" for r in seq.reports]
    piped.graph.validate()
    assert len(piped.graph.by_type(LT.SELECT)) == len(it)
    outs, _ = run_graph(piped.graph, params_to_torch(piped.params, "cpu"),
                        {"data": torch.from_numpy(inputs[0])})
    np.testing.assert_allclose(outs["prob"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_pipelined_degenerate_restarts_sequential(vgg, monkeypatch, capsys):
    """tests/test_pipeline.py::test_pipelined_degenerate_falls_back: an
    empty fused selection aborts the pipelined pass, and the solve restarts
    on the sequential path (magnitude fallback), still well-formed."""
    (g, _), params, cfg, _, cache = vgg
    targets = {"conv1_1": 5, "conv1_2": 6}
    real, calls = prune_mod._fused_layer_solve, []

    def sabotaged(*a, **kw):
        calls.append(1)
        out = real(*a, **kw)
        return out._replace(mask=torch.zeros_like(out.mask))

    monkeypatch.setattr(prune_mod, "_fused_layer_solve", sabotaged)
    res = c3.solve_prune(g, params, cache, cfg, channel_targets=targets,
                         device="cpu", verbose=False)
    assert calls and not res.pipelined
    assert "restarting on the sequential path" in capsys.readouterr().out
    res.graph.validate()
    assert len(res.selections) == 2
    for prod, t in targets.items():
        assert res.params[prod]["W"].shape[0] == t


def test_pipelined_checkpoint_resume(vgg, tmp_path, monkeypatch):
    """tests/test_pipeline.py::test_solve_checkpoint_resume in the
    pipelined pass: a crash at the third layer's dispatch leaves the
    snapshot of the layer drained before it; the resumed pass ends with
    the uninterrupted run's selections and weights, and clears it."""
    from channel_pruning_tpu_torch.pipeline.checkpoint import SolveCheckpoint

    (g, _), params, cfg, _, cache = vgg
    ref = c3.solve_prune(g, params, cache, cfg, channel_targets=VGG_TARGETS,
                         device="cpu", verbose=False)
    ck = SolveCheckpoint(tmp_path / "state.pkl", every=1)
    real, calls = prune_mod._fused_layer_solve, []

    def crashing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("simulated device fault")
        return real(*a, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(prune_mod, "_fused_layer_solve", crashing)
        with pytest.raises(RuntimeError, match="simulated"):
            c3.solve_prune(g, params, cache, cfg, channel_targets=VGG_TARGETS,
                           device="cpu", checkpoint=ck, verbose=False)
    assert ck._pending is None
    first = g.convs.index(ref.reports[0].conv)
    assert ck.load()[0] == first             # the one layer drained
    done = _spy_pass(monkeypatch)
    resumed = c3.solve_prune(g, params, cache, cfg,
                             channel_targets=VGG_TARGETS, device="cpu",
                             checkpoint=ck, verbose=False)
    assert done == [True]
    assert not (tmp_path / "state.pkl").exists()
    assert set(resumed.selections) == set(ref.selections)
    for k in ref.selections:
        np.testing.assert_array_equal(resumed.selections[k], ref.selections[k])
    for k, v in ref.params.items():
        np.testing.assert_allclose(resumed.params[k]["W"], v["W"], rtol=1e-5)


def test_pipelined_fenced_phase_timing(vgg, monkeypatch, capsys):
    """With CP_TPU_PHASE_TIMING on, the solve traces itself (utils/trace)
    and prints a line a solved layer and a line of totals, each with the
    host self time and device time of every span of the pass; it fences
    nothing (a synchronize raises), turns tracing off again, and the
    selections do not change."""
    from channel_pruning_tpu_torch.utils import trace

    (g, _), params, cfg, _, cache = vgg
    targets = {"conv1_1": 5, "conv1_2": 6}
    base = c3.solve_prune(g, params, cache, cfg, channel_targets=targets,
                          device="cpu", verbose=False)
    capsys.readouterr()

    def fence(*a, **kw):
        raise AssertionError("a synchronize() fence in the timed pass")

    monkeypatch.setattr(c3, "_PHASE_TIMING", True)
    monkeypatch.setattr(torch.cuda, "synchronize", fence)
    timed = c3.solve_prune(g, params, cache, cfg, channel_targets=targets,
                           device="cpu", verbose=False)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[phase-timing]")]
    assert [l.split(":")[0] for l in lines] == [
        "[phase-timing] conv1_2", "[phase-timing] conv2_1",
        "[phase-timing] totals over 2 layers"]
    for line in lines:
        for name in c3.PASS_SPANS:
            assert f" {name} host " in line, (name, line)
        assert "dev -" in line           # no card: no device time
    assert not trace.enabled()
    for name in base.selections:
        np.testing.assert_array_equal(timed.selections[name],
                                      base.selections[name])


def test_frontier_gathers_with_its_uploaded_plan(vgg, monkeypatch):
    """A frontier given the solve's plan uploads it once, at construction:
    its gathers then make no host-to-device copy (torch.as_tensor fails
    here) and equal those of a frontier that uploads per call."""
    from channel_pruning_tpu_torch.sampling.rolling import RollingReplay

    (g, _), params, _, _, cache = vgg
    dev = params_to_torch(params, "cpu")
    bound = RollingReplay(g, cache.inputs, device="cpu", plan=cache.plan)
    plain = RollingReplay(g, cache.inputs, device="cpu")
    conv = "conv2_2"
    bottom, top = g.layer(conv).bottoms[0], g.layer(conv).tops[0]
    plain.advance_to(dev, bottom)
    want = (plain.patches_at(cache.plan, conv),
            plain.features_at(dev, cache.plan, top, device=True))

    def no_upload(*a, **kw):
        raise AssertionError("a host-to-device copy in the gather")

    monkeypatch.setattr(torch, "as_tensor", no_upload)
    bound.advance_to(dev, bottom)
    got = (bound.patches_at(cache.plan, conv),
           bound.features_at(dev, cache.plan, top, device=True))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
