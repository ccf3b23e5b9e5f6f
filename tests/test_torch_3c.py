"""The port's 3C pass (channel_pruning_tpu_torch/pipeline/c3.solve_3c) on the
tiny VGG against the JAX package's: the same host inputs frozen on both
sides, ranks {conv2_1: 9, conv2_2: 9} with ALS and ITQ schedules of (4, 2)
(tests/test_pipeline.py:406). Also: `ranks_for_speed`, `--mode 2c`, a
resume from a checkpoint, and the CLI chain prune --mode 3c -> combine ->
flop in a process where neither jax nor the JAX package can be imported."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.rewrite import combine_hp as jax_combine_hp
from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
from channel_pruning_tpu.io import caffe as jax_cio
from channel_pruning_tpu.models import vgg as jax_vgg
from channel_pruning_tpu.ops import forward as jax_forward
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.rewrite import combine_hp, split_relu
from channel_pruning_tpu_torch.io import caffe as cio
from channel_pruning_tpu_torch.models import vgg
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.sampling import sampler

REPO = Path(__file__).resolve().parent.parent
RANKS = {"conv2_1": 9, "conv2_2": 9}


def _fast(cfg):
    return dataclasses.replace(cfg, solve=dataclasses.replace(
        cfg.solve, nonlinear_iters=(4, 2), itq_iters=(4, 2)))


def _jax_cache(params, inputs):
    g_j = jax_split_relu(jax_vgg.build_tiny_vgg(batch=4, image_size=16)[0])
    return jax_freeze(g_j, jax_forward.to_device_params(params), inputs,
                      n_points=10, seed=0, chunk_batches=4)


@pytest.fixture(scope="module")
def setup():
    g, params = vgg.build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    g_j, _ = jax_vgg.build_tiny_vgg(batch=4, image_size=16)
    g_j = jax_split_relu(g_j)
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)) \
        .astype(np.float32)
    cfg = _fast(default_config())
    cache_j = _jax_cache(params, inputs)
    cache = sampler.freeze(g, params_to_torch(params, "cpu"), inputs,
                           device="cpu", n_points=10, seed=0, chunk_batches=4)
    res_j = jax_c3.solve_3c(g_j, params, cache_j, cfg, RANKS, verbose=False)
    res = c3.solve_3c(g, params, cache, cfg, RANKS, device="cpu",
                      verbose=False)
    return g, params, inputs, cfg, cache, res, res_j


def _probs(graph, params, x):
    outs, _ = run_graph(graph, params_to_torch(params, "cpu"),
                        {"data": torch.from_numpy(np.asarray(x))})
    return outs["prob"].numpy()


def _lasso_scores(g, params, cache, res, consumer):
    """|beta| of each input channel at the arm's alpha, on `consumer`'s
    patches of the original net (the running net is not returned): the
    scores a swapped pair's report prints."""
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.ops import lasso

    rep = next(r for r in res.reports if r.conv == consumer and r.kept)
    X = sampler.sample_patches(g, params_to_torch(params, "cpu"),
                               cache.inputs, consumer, cache.plan,
                               device="cpu")
    W = torch.as_tensor(params[consumer]["W"])
    Z = lasso.build_channel_response(X, W)
    y = torch.as_tensor(cache.feats[g.layer(consumer).tops[0]]) \
        - torch.as_tensor(params[consumer]["b"])
    gram = lasso.lasso_gram(Z, y.reshape(-1))
    beta = lasso_cd.cd_solve_grid_plain(
        gram.G, gram.b, torch.tensor([rep.alpha * gram.n_samples]))[0]
    return beta.abs().numpy()


def test_3c_matches_jax(setup):
    g, params, inputs, cfg, cache, res, res_j = setup
    res.graph.validate()
    conv_shapes = {l.name: res.params[l.name]["W"].shape
                   for l in res.graph.layers if l.type == "Convolution"}
    conv_shapes_j = {l.name: np.asarray(res_j.params[l.name]["W"]).shape
                     for l in res_j.graph.layers if l.type == "Convolution"}
    assert conv_shapes == conv_shapes_j
    for conv, r in RANKS.items():
        for part in ("V", "H", "P"):
            assert f"{conv}_{part}" in conv_shapes
        assert conv not in conv_shapes
        assert conv_shapes[f"{conv}_V"][0] == r
    assert res.selections.keys() == res_j.selections.keys() == \
        {"conv2_2", "conv3_1"}
    for consumer, keep in res_j.selections.items():
        if not np.array_equal(res.selections[consumer], keep):
            beta = _lasso_scores(g, params, cache, res, consumer)
            swapped = np.where(res.selections[consumer] != keep)[0]
            print(f"{consumer}: swapped channels {swapped.tolist()}, port "
                  f"|beta| {beta[swapped].tolist()}")
        np.testing.assert_array_equal(res.selections[consumer], keep,
                                      err_msg=consumer)
    assert [(r.conv, r.rank, r.kept, r.total) for r in res.reports] == \
        [(r.conv, r.rank, r.kept, r.total) for r in res_j.reports]
    for r, rj in zip(res.reports, res_j.reports):
        assert r.rmse_before == pytest.approx(rj.rmse_before, rel=1e-3), r.conv
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3), r.conv
    assert res.itq_degraded == res_j.itq_degraded == []
    assert res.undecomposed == res_j.undecomposed == []
    p = _probs(res.graph, res.params, inputs[0])
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)
    # the 3C net computes what the JAX package's does, up to the solves'
    # f32 rounding
    np.testing.assert_allclose(
        p, _probs(res_j.graph, {k: {n: np.asarray(a) for n, a in v.items()}
                                for k, v in res_j.params.items()}, inputs[0]),
        atol=2e-3)


def test_3c_report_phases(setup):
    """Each decomposed layer reports its stages' seconds; the arm reports
    the CD grids the fused search solved."""
    *_, res, _ = setup
    layers = [r for r in res.reports if r.kind == "3c"]
    arms = [r for r in res.reports if r.kind == "prune"]
    assert [r.conv for r in layers] == list(RANKS)
    for r in layers:
        assert {"replay", "svd_host", "spatial", "itq_loop", "itq_svd_host",
                "channel"} <= r.phases.keys()
        assert r.seconds == pytest.approx(r.phases["spatial"]
                                          + r.phases["channel"])
    assert all(r.grids and r.grids > 0 for r in arms)


def test_ranks_for_speed_and_tables():
    base = {"conv2_1": 37, "conv5_1": 398}
    assert c3.ranks_for_speed(base, 4.0) == {"conv2_1": 37, "conv5_1": 398}
    r2 = c3.ranks_for_speed(base, 2.0)
    assert r2["conv2_1"] == 74 and r2["conv5_1"] == 398   # conv5 exempt
    assert vgg.VGG16_RANKS_4X == jax_vgg.VGG16_RANKS_4X
    for speed in (2.0, 4.0, 5.0):
        assert c3.ranks_for_speed(vgg.VGG16_RANKS_4X, speed) == \
            jax_c3.ranks_for_speed(jax_vgg.VGG16_RANKS_4X, speed)


def test_2c_decomposes_without_pruning(setup):
    """dic.vh=False (`--mode 2c`): V/H/P for every ranked conv, no arm, the
    same structure as the JAX package's."""
    g, params, inputs, cfg, cache, _, _ = setup
    cfg2 = cfg.replace_nested("dic.vh", False)
    res = c3.solve_3c(g, params, cache, cfg2, RANKS, device="cpu",
                      verbose=False)
    res_j = jax_c3.solve_3c(jax_split_relu(jax_vgg.build_tiny_vgg(
        batch=4, image_size=16)[0]), params, _jax_cache(params, inputs),
        cfg2, RANKS, verbose=False)
    assert not res.selections and not res_j.selections
    assert [r.kind for r in res.reports] == ["3c", "3c"]
    assert [(r.conv, r.rank) for r in res.reports] == \
        [(r.conv, r.rank) for r in res_j.reports]
    widths = {c: int(params[c]["W"].shape[0]) for c in ("conv2_1", "conv2_2")}
    assert res.params["conv2_2_V"]["W"].shape[1] == widths["conv2_1"]
    assert res.params["conv3_1"]["W"].shape[1] == widths["conv2_2"]
    for name, v in res_j.params.items():
        assert res.params[name]["W"].shape == np.asarray(v["W"]).shape, name
    for r, rj in zip(res.reports, res_j.reports):
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3), r.conv
    p = _probs(res.graph, res.params, inputs[0])
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)


def test_3c_resume_gives_uninterrupted_result(setup, tmp_path, monkeypatch):
    """Killed in the second layer's arm, the pass resumes from the
    checkpoint written after the first layer (every=1) and ends as the
    uninterrupted run did."""
    from channel_pruning_tpu_torch.pipeline import prune as prune_mod
    from channel_pruning_tpu_torch.pipeline.checkpoint import SolveCheckpoint

    g, params, _, cfg, cache, full, _ = setup
    real, calls = prune_mod.select_and_reconstruct, []

    def dies_on_second(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        return real(*a, **kw)

    ck = SolveCheckpoint(tmp_path / "state.pkl", every=1)
    monkeypatch.setattr(prune_mod, "select_and_reconstruct", dies_on_second)
    with pytest.raises(KeyboardInterrupt):
        c3.solve_3c(g, params, cache, cfg, RANKS, device="cpu",
                    checkpoint=ck, verbose=False)
    monkeypatch.setattr(prune_mod, "select_and_reconstruct", real)
    assert ck._pending is None
    assert ck.load()[0] == g.convs.index("conv2_1")
    assert len(ck.write_seconds) == 1
    resumed = c3.solve_3c(g, params, cache, cfg, RANKS, device="cpu",
                          checkpoint=ck, verbose=False)
    assert not (tmp_path / "state.pkl").exists()
    assert resumed.selections.keys() == full.selections.keys()
    for k, keep in full.selections.items():
        np.testing.assert_array_equal(resumed.selections[k], keep)
    assert [(r.conv, r.kept) for r in resumed.reports] == \
        [(r.conv, r.kept) for r in full.reports]
    for k, v in full.params.items():
        for n, a in v.items():
            np.testing.assert_allclose(resumed.params[k][n], a, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}.{n}")


def test_combine_keeps_the_merged_bias(setup):
    """combine_hp on the 3C output: the merged H conv carries P's bias and
    computes the chain's output. The JAX package's copy leaves the merged
    conv's bias flag off, so its forward drops that bias; the port repairs
    it (ROADMAP Queue 3)."""
    _, _, inputs, _, _, res, _ = setup
    g2, p2 = combine_hp(res.graph, res.params)
    assert not any(l.name.endswith("_P") for l in g2.layers)
    for conv in RANKS:
        assert g2.layer(f"{conv}_H").attr("bias") is True
    want = _probs(res.graph, res.params, inputs[0])
    np.testing.assert_allclose(_probs(g2, p2, inputs[0]), want, atol=1e-5)
    g_j, p_j = jax_combine_hp(res.graph, res.params)
    assert g_j.layer("conv2_1_H").attr("bias") is False
    assert np.abs(_probs(g_j, p_j, inputs[0]) - want).max() > 1e-3


def test_cli_3c_combine_flop_without_jax(tmp_path):
    """`prune --mode 3c`, `combine` and `flop` in a subprocess where
    `import jax` and `import channel_pruning_tpu` fail; the 3C model
    reloads in the JAX package's codec and gives the port's probabilities,
    and the merged model gives the 3C model's."""
    wd = str(tmp_path)
    prog = (
        "import sys\n"
        "def jax_mods():\n"
        "    return {m for m, v in sys.modules.items() if v is not None\n"
        "            and m.split('.')[0] in ('jax', 'channel_pruning_tpu')}\n"
        "before = jax_mods()\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['channel_pruning_tpu'] = None\n"
        "from channel_pruning_tpu_torch import cli\n"
        "res = cli.main(['prune', '--model', 'tiny_vgg', '--mode', '3c',"
        " '--batch', '4', '--cal-batches', '4', '--cal-batch', '4',"
        " '--speed', '2.0', '--device', 'cpu', '--work-dir', %r])\n"
        "_, _, err = cli.main(['combine', '--prototxt', %r, '--weights', %r,"
        " '--batch', '4', '--device', 'cpu', '--work-dir', %r])\n"
        "assert err < 1e-5, err\n"
        "total = cli.main(['flop', '--prototxt', %r, '--batch', '4'])\n"
        "assert total > 0\n"
        "assert jax_mods() <= before, jax_mods() - before\n"
        % (wd, f"{wd}/3C_tiny_vgg.prototxt", f"{wd}/3C_tiny_vgg.caffemodel",
           wd, f"{wd}/cb_tiny_vgg.prototxt"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", prog], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[3c] 5/5 layers fully decomposed (VH+ITQ)" in out.stdout
    assert "[combine] conv mults" in out.stdout
    assert "[flop] conv mults" in out.stdout
    assert (tmp_path / "cb_tiny_vgg.caffemodel").exists()
    assert np.load(tmp_path / "3C_tiny_vgg_selections.npz").files
    x = np.random.default_rng(0).normal(size=(4, 3, 16, 16)).astype(np.float32)
    g, p = cio.import_model(tmp_path / "3C_tiny_vgg.prototxt",
                            tmp_path / "3C_tiny_vgg.caffemodel")
    want = _probs(g, p, x)
    np.testing.assert_allclose(want.sum(-1), 1.0, rtol=1e-5)
    g_j, p_j = jax_cio.import_model(tmp_path / "3C_tiny_vgg.prototxt",
                                    tmp_path / "3C_tiny_vgg.caffemodel")
    outs_j, _ = jax_forward.run_graph(g_j, jax_forward.to_device_params(p_j),
                                      {"data": x})
    np.testing.assert_allclose(np.asarray(outs_j["prob"]), want, atol=1e-5)


@pytest.mark.slow
def test_vgg16_64px_3c_matches_jax():
    """Full-width VGG-16 at 64 px, 100 images, the 4x ranks and the CLI's
    schedules, on both packages (~6 min each on the CPU). Both decompose
    12/12 layers and keep every arm in band. The first two arms select
    identically; from the third on the two may land elsewhere in the band
    (measured: conv3_1 keeps 122 in the port, 118 in the JAX package, on
    relative rMSE differences of 8e-4 at its input), since the ITQ loop
    amplifies f32 rounding through the Gram's condition number. The VH-only
    rMSE stays within 2e-2 relative at every layer (measured worst 9.0e-3,
    conv3_2)."""
    from channel_pruning_tpu.models.vgg import build_vgg16 as jax_build_vgg16
    from channel_pruning_tpu.sampling.sampler import (freeze_tensor_set,
                                                      params_for_tensors)

    g = vgg.build_vgg16(batch=10, image_size=64)
    g, params = c3.preprocess(g, vgg.init_params(g, seed=0))
    g_j, _ = jax_c3.preprocess(jax_build_vgg16(batch=10, image_size=64), {})
    inputs = np.random.default_rng(0).normal(size=(10, 10, 3, 64, 64)) \
        .astype(np.float32)
    cfg = default_config()
    ranks = c3.ranks_for_speed(vgg.VGG16_RANKS_4X, 4.0)
    tensors_j = freeze_tensor_set(g_j, include_fc=False)
    cache_j = jax_freeze(g_j, jax_forward.to_device_params(
        params_for_tensors(g_j, params, tensors_j)), inputs, tensors=tensors_j,
        n_points=10, seed=0, chunk_batches=20)
    tensors = sampler.freeze_tensor_set(g, include_fc=False)
    cache = sampler.freeze(g, params_to_torch(sampler.params_for_tensors(
        g, params, tensors), "cpu"), inputs, device="cpu", tensors=tensors,
        n_points=10, seed=0, chunk_batches=20)
    res_j = jax_c3.solve_3c(g_j, params, cache_j, cfg, ranks, verbose=False)
    res = c3.solve_3c(g, params, cache, cfg, ranks, device="cpu",
                      verbose=False)
    assert [(r.conv, r.rank, r.total) for r in res.reports] == \
        [(r.conv, r.rank, r.total) for r in res_j.reports]
    for r in (res, res_j):
        assert not r.itq_degraded and not r.undecomposed
    arms = [(r, rj) for r, rj in zip(res.reports, res_j.reports) if r.kept]
    assert len(arms) == 11
    for i, (r, rj) in enumerate(arms):
        d_c = int(np.floor(r.total / cfg.dic.c_ratio))
        for kept in (r.kept, rj.kept):
            assert d_c <= kept <= d_c + cfg.dic.rank_tol * d_c, r.conv
        if i < 2:
            np.testing.assert_array_equal(res.selections[r.conv],
                                          res_j.selections[r.conv])
    for r, rj in zip(res.reports, res_j.reports):
        if r.kept is None:
            assert r.rmse_before == pytest.approx(rj.rmse_before, rel=2e-2), \
                r.conv
    x = cache.inputs[0]
    np.testing.assert_allclose(_probs(res.graph, res.params, x).sum(-1), 1.0,
                               rtol=1e-5)
