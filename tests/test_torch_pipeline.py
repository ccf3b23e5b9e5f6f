"""The port's whole slice on the tiny VGG against the JAX package: freeze,
the sequential host-stepped solve (`solve.fused_search=False` set on both
sides: the default is the pipelined pass, held in
tests/test_torch_fused_pipeline.py), the per-layer selections, a
JAX-frozen cache solved by the port, and the port's CLI (its default, the
pipelined pass) in a process where neither jax nor the JAX package can be
imported. Each package solves a graph built by its own builders from the
same seed."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
from channel_pruning_tpu.models.vgg import build_tiny_vgg as jax_build_tiny_vgg
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.rewrite import split_relu
from channel_pruning_tpu_torch.io import caffe as cio
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.sampling import sampler
from torch_cpu import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TARGETS = {"conv1_1": 5, "conv1_2": 6, "conv2_1": 8, "conv2_2": 9,
           "conv3_1": 10}


@pytest.fixture(scope="module")
def setup():
    g, params = build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    g_j, params_j = jax_build_tiny_vgg(batch=4, image_size=16)
    g_j = jax_split_relu(g_j)
    assert [(l.name, l.type, l.bottoms, l.tops, l.attrs) for l in g.layers] == \
        [(l.name, l.type, l.bottoms, l.tops, l.attrs) for l in g_j.layers]
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)) \
        .astype(np.float32)
    cfg = default_config().replace_nested("solve.fused_search", False)
    cache_j = jax_freeze(g_j, to_device_params(params_j), inputs, n_points=10,
                         seed=0, chunk_batches=4)
    cache = sampler.freeze(g, params_to_torch(params, "cpu"), inputs,
                           device="cpu", n_points=10, seed=0, chunk_batches=4)
    return (g, g_j), params, cfg, cache_j, cache


def test_freeze_matches_jax(setup):
    _, _, _, cache_j, cache = setup
    assert cache.plan.keys() == cache_j.plan.keys()
    for t, (ys, xs) in cache_j.plan.items():
        np.testing.assert_array_equal(cache.plan[t][0], ys)
        np.testing.assert_array_equal(cache.plan[t][1], xs)
    assert cache.feats.keys() == cache_j.feats.keys()
    for t, f in cache_j.feats.items():
        np.testing.assert_allclose(cache.feats[t], f, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("band", ["top", "bottom"])
def test_solve_prune_selections_match_jax(setup, band):
    (g, g_j), params, cfg, cache_j, cache = setup
    cfg = cfg.replace_nested("solve.band", band)
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg,
                               channel_targets=TARGETS, verbose=False)
    res = c3.solve_prune(g, params, cache, cfg, channel_targets=TARGETS,
                         device="cpu", verbose=False)
    assert res.selections.keys() == res_j.selections.keys()
    for consumer, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[consumer], keep,
                                      err_msg=consumer)
    for i, (r, rj) in enumerate(zip(res.reports, res_j.reports)):
        assert r.conv == rj.conv and r.kept == rj.kept
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3, abs=1e-5)
        # the first consumer's input is unpruned, so it starts from ~0 error;
        # every later layer's reconstruction must beat its accumulated error
        assert r.rmse_before < 1e-5 if i == 0 else r.rmse_after < r.rmse_before
    for prod, t in TARGETS.items():
        assert res.params[prod]["W"].shape == res_j.params[prod]["W"].shape
        if band == "bottom":
            assert res.params[prod]["W"].shape[0] == t
    # the pruned net computes normalised probabilities in the port
    x = torch.from_numpy(np.asarray(cache.inputs[0]))
    outs, _ = run_graph(res.graph, params_to_torch(res.params, "cpu"),
                        {"data": x})
    np.testing.assert_allclose(outs["prob"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_port_solves_jax_frozen_cache(setup, tmp_path):
    """A cache frozen by the JAX package and saved to npz loads in the port,
    and the port's solve on it gives the JAX package's masks."""
    (g, g_j), params, cfg, cache_j, _ = setup
    path = tmp_path / "frozen.npz"
    cache_j.save(path)
    loaded = sampler.FrozenCache.load(path)
    res = c3.solve_prune(g, params, loaded, cfg, channel_targets=TARGETS,
                         device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg,
                               channel_targets=TARGETS, verbose=False)
    for consumer, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[consumer], keep,
                                      err_msg=consumer)


def test_sample_patches_matches_frontier_and_jax(setup):
    """The full-replay patch gather (used when the frontier does not fit)
    equals the rolling frontier's and the JAX package's."""
    from channel_pruning_tpu.sampling import sampler as jax_sampler
    from channel_pruning_tpu_torch.sampling.rolling import RollingReplay

    (g, g_j), params, _, cache_j, cache = setup
    dev_params = params_to_torch(params, "cpu")
    consumer = g.convs[2]
    full = sampler.sample_patches(g, dev_params, cache.inputs, consumer,
                                  cache.plan, device="cpu", chunk_batches=2)
    roll = RollingReplay(g, cache.inputs, device="cpu", group_batches=4)
    roll.advance_to(dev_params, g.layer(consumer).bottoms[0])
    np.testing.assert_array_equal(full.numpy(),
                                  roll.patches_at(cache.plan, consumer).numpy())
    ref = jax_sampler.sample_patches(g_j, to_device_params(params),
                                     cache_j.inputs, consumer, cache_j.plan,
                                     chunk_batches=2)
    np.testing.assert_allclose(full.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_synthetic_inputs_chunking_and_cache_round_trip(tmp_path):
    """Each batch depends only on (seed, batch index), so any chunking sees
    the same images; a cache keeps only the spec, under the port's own key."""
    from channel_pruning_tpu_torch.sampling.inputs import (SyntheticInputs,
                                                           device_chunk)

    src = SyntheticInputs(n_batches=4, bs=2, sample_shape=(3, 8, 8), seed=3)
    whole = device_chunk(src, 0, 4, "cpu")
    parts = torch.cat([device_chunk(src, 0, 1, "cpu"),
                       device_chunk(src, 1, 4, "cpu")])
    np.testing.assert_array_equal(whole.numpy(), parts.numpy())
    assert not torch.equal(whole[:2], whole[2:4])
    path = tmp_path / "syn.npz"
    sampler.FrozenCache(inputs=src, plan={}, feats={}).save(path)
    assert "inputs_spec_torch" in np.load(path).files
    assert sampler.FrozenCache.load(path).inputs == src


def test_checkpoint_resume_gives_same_selections(setup, tmp_path,
                                                 monkeypatch):
    """A solve killed after two layers resumes from the port's
    SolveCheckpoint and ends with the uninterrupted run's selections."""
    from channel_pruning_tpu_torch.pipeline import prune as prune_mod
    from channel_pruning_tpu_torch.pipeline.checkpoint import SolveCheckpoint

    (g, _), params, cfg, _, cache = setup
    full = c3.solve_prune(g, params, cache, cfg, channel_targets=TARGETS,
                          device="cpu", verbose=False)
    real, calls = prune_mod.select_and_reconstruct, []

    def dies_on_third(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt("killed")
        return real(*a, **kw)

    ck = SolveCheckpoint(tmp_path / "state.pkl", every=1)
    monkeypatch.setattr(prune_mod, "select_and_reconstruct", dies_on_third)
    with pytest.raises(KeyboardInterrupt):
        c3.solve_prune(g, params, cache, cfg, channel_targets=TARGETS,
                       device="cpu", checkpoint=ck, verbose=False)
    monkeypatch.setattr(prune_mod, "select_and_reconstruct", real)
    assert ck._pending is None                    # joined before raising
    assert ck.load()[0] == 2                      # conv1_2 and conv2_1 done
    resumed = c3.solve_prune(g, params, cache, cfg, channel_targets=TARGETS,
                             device="cpu", checkpoint=ck, verbose=False)
    for consumer, keep in full.selections.items():
        np.testing.assert_array_equal(resumed.selections[consumer], keep)
    assert not (tmp_path / "state.pkl").exists()


def test_device_is_explicit():
    from channel_pruning_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_cache_refuses_jax_synthetic_spec(tmp_path):
    path = tmp_path / "jax_synthetic.npz"
    np.savez(path, inputs_spec=np.asarray([2, 4, 0, 3, 16, 16]))
    with pytest.raises(ValueError, match="threefry"):
        sampler.FrozenCache.load(path)


def test_unported_options_raise(setup):
    """Every option of the JAX package's solve runs in the port: bf16
    replays (the sequential pass here; the JAX package's masks, in
    tests/test_torch_bf16.py) and the fused search."""
    (g, _), params, cfg, _, cache = setup
    res = c3.solve_prune(g, params, cache,
                         cfg.replace_nested("solve.dtype", "bfloat16"),
                         channel_targets=TARGETS, device="cpu", verbose=False)
    assert not res.pipelined and len(res.selections) == len(TARGETS)
    assert all(np.isfinite(r.rmse_after) for r in res.reports)
    res = c3.solve_prune(g, params, cache,
                         cfg.replace_nested("solve.fused_search", "True"),
                         channel_targets=TARGETS, device="cpu", verbose=False)
    assert res.pipelined and len(res.selections) == len(TARGETS)


def _cli_prune_without_jax(tmp_path, model: str, image_size: int,
                           speed: str) -> None:
    """`cli prune` end to end in a subprocess where `import jax` and
    `import channel_pruning_tpu` fail; the exported model reloads through
    the port's codec and gives probabilities."""
    prog = (
        "import sys\n"
        "def jax_mods():\n"
        "    return {m for m, v in sys.modules.items() if v is not None\n"
        "            and m.split('.')[0] in ('jax', 'channel_pruning_tpu')}\n"
        "before = jax_mods()\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['channel_pruning_tpu'] = None\n"
        "from channel_pruning_tpu_torch import cli\n"
        f"cli.main(['prune', '--model', {model!r}, '--batch', '4',"
        f" '--cal-batches', '4', '--cal-batch', '4', '--speed', {speed!r},"
        f" '--device', 'cpu', '--work-dir', {str(tmp_path)!r}])\n"
        "assert jax_mods() <= before, jax_mods() - before\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", prog], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "conv mults" in out.stdout
    assert "s pipelined)" in out.stdout and "[pipeline]" not in out.stdout
    g, params = cio.import_model(tmp_path / f"cp_{model}.prototxt",
                                 tmp_path / f"cp_{model}.caffemodel")
    sel = np.load(tmp_path / f"cp_{model}_selections.npz")
    assert sel.files
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3, image_size, image_size)).astype(np.float32))
    outs, _ = run_graph(g, params_to_torch(params, "cpu"), {"data": x})
    np.testing.assert_allclose(outs["prob"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_cli_prune_runs_without_jax(tmp_path):
    _cli_prune_without_jax(tmp_path, "tiny_vgg", 16, "2.0")


def test_cli_prune_resnet_runs_without_jax(tmp_path):
    """The residual path (DAG frontier, Select gates, residual
    compensation) in the same subprocess, with both imports blocked."""
    _cli_prune_without_jax(tmp_path, "tiny_resnet", 32, "1.2")


def test_port_never_imports_jax():
    offenders = [str(p) for p in (REPO / "channel_pruning_tpu_torch").rglob("*.py")
                 if any(line.strip().startswith(("import jax", "from jax"))
                        for line in p.read_text().splitlines())]
    assert not offenders, offenders


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the graph IR, models, codec and config
    through the port's own copies, never through the JAX package."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert {"channel_pruning_tpu_torch.models.vgg",
            "channel_pruning_tpu_torch.io.caffe"} <= mods
    bad = {m for m in mods if m.split(".")[0] in ("jax", "channel_pruning_tpu")}
    assert not bad, bad


@pytest.mark.slow
def test_vgg16_64px_rmse_matches_jax():
    """Full-width VGG-16 at 64 px, 100 images, the 5x table with the bottom
    band: both packages select the same channels and give the same per-layer
    rMSE. On random weights conv2_1 ends above its starting rMSE in both,
    which is why chip_smoke.py holds it to a bound and not to after < before."""
    from channel_pruning_tpu.models.vgg import build_vgg16 as jax_build_vgg16
    from channel_pruning_tpu.sampling.sampler import (freeze_tensor_set,
                                                      params_for_tensors)
    from channel_pruning_tpu_torch.models.vgg import (VGG16_5X_CHANNELS,
                                                      build_vgg16, init_params)

    g = build_vgg16(batch=10, image_size=64)
    g, params = c3.preprocess(g, init_params(g, seed=0))
    g_j, _ = jax_c3.preprocess(jax_build_vgg16(batch=10, image_size=64), {})
    inputs = np.random.default_rng(0).normal(size=(10, 10, 3, 64, 64)) \
        .astype(np.float32)
    cfg = default_config().replace_nested("solve.fused_search", False) \
        .replace_nested("solve.band", "bottom")
    tensors_j = freeze_tensor_set(g_j, include_fc=False)
    fp_j = params_for_tensors(g_j, params, tensors_j)
    cache_j = jax_freeze(g_j, to_device_params(fp_j), inputs, tensors=tensors_j,
                         n_points=10, seed=0, chunk_batches=20)
    tensors = sampler.freeze_tensor_set(g, include_fc=False)
    fp = sampler.params_for_tensors(g, params, tensors)
    cache = sampler.freeze(g, params_to_torch(fp, "cpu"), inputs, device="cpu",
                           tensors=tensors, n_points=10, seed=0,
                           chunk_batches=20)
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg,
                               channel_targets=VGG16_5X_CHANNELS, verbose=False)
    res = c3.solve_prune(g, params, cache, cfg,
                         channel_targets=VGG16_5X_CHANNELS, device="cpu",
                         verbose=False)
    assert [r.conv for r in res.reports] == [r.conv for r in res_j.reports]
    for r, rj in zip(res.reports, res_j.reports):
        np.testing.assert_array_equal(res.selections[r.conv],
                                      res_j.selections[r.conv], err_msg=r.conv)
        assert r.rmse_before == pytest.approx(rj.rmse_before, rel=1e-3, abs=1e-5)
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3, abs=1e-5)
    conv2_1 = next(r for r in res_j.reports if r.conv == "conv2_1")
    assert conv2_1.rmse_after > conv2_1.rmse_before
