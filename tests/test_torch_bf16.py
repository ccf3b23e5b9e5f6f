"""bf16 replays (`solve.dtype=bfloat16`, the JAX CLI's default for every
graph whose name contains "vgg") against the JAX package, on the CPU.

The JAX package's conv (channel_pruning_tpu/ops/forward.py:30-47) rounds x
and W to bf16, takes the products and their sums in f32 and returns an f32
output; the port's `_conv2d` computes the same, so the two differ only by
summation order: 1e-5 of the output's largest |value| (a conv that rounds
its output to bf16 sits ~3e-3 off). The same numpy inputs go through both
packages at every level: the conv, the rolling frontiers and the full
replays, the solves of the tiny VGG (pipelined and sequential, on one
JAX-frozen cache), the tiny ResNet, the tiny Faster-RCNN and tiny 3C, the
CLI's preset (its refusal of float16 is in
tests/test_torch_solver_knobs.py) and `cli time`'s peak. The card's route
(cuDNN with TF32 for that call, checked exact per shape) is held in
tests/test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
from channel_pruning_tpu.models import faster_rcnn as jax_frcnn
from channel_pruning_tpu.models import resnet as jax_resnet
from channel_pruning_tpu.models import vgg as jax_vgg
from channel_pruning_tpu.ops import forward as jax_forward
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.sampling import rolling as jax_rolling
from channel_pruning_tpu.sampling import sampler as jax_sampler
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch import cli
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.ir import LT
from channel_pruning_tpu_torch.graph.rewrite import split_relu
from channel_pruning_tpu_torch.models import faster_rcnn, resnet, vgg
from channel_pruning_tpu_torch.ops import forward
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.sampling import rolling, sampler
from torch_cpu import one_thread  # noqa: F401

BF16 = "bfloat16"
VGG_TARGETS = {"conv1_1": 5, "conv1_2": 6, "conv2_1": 8, "conv2_2": 9,
               "conv3_1": 10}


def _close(got, want, rel=1e-5):
    """Within `rel` of the reference's largest |value|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("c,o,k,s,p,group", [
    (64, 32, 3, 1, 1, 1), (16, 24, 3, 2, 1, 1), (48, 40, 1, 1, 0, 1),
    (32, 32, 3, 1, 1, 32)], ids=["3x3_pad1", "stride2", "1x1", "depthwise"])
def test_conv2d_bf16_matches_jax(c, o, k, s, p, group, bias):
    """The port's bf16 conv is the JAX package's: f32 output, within 1e-5
    of its largest |value| (summation order only)."""
    rng = np.random.default_rng(c + o + k + s + group)
    x = rng.normal(size=(2, c, 15, 15)).astype(np.float32)
    w = rng.normal(size=(o, c // group, k, k)).astype(np.float32)
    b = rng.normal(size=o).astype(np.float32) if bias else None
    geo = dict(kh=k, kw=k, sh=s, sw=s, ph=p, pw=p, group=group)
    got = forward._conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), geo,
                          torch.bfloat16)
    want = jax_forward._conv2d(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w),
        None if b is None else jnp.asarray(b), geo, jnp.bfloat16)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    # the bf16 rounding is really there: an f32 conv sits further off
    f32 = forward._conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), geo, None)
    assert np.abs(f32.numpy() - got.numpy()).max() > 1e-4


def test_replay_dtype_names_match_jax():
    """`_dtype_of` takes the JAX package's names; float32 means none."""
    for name in (None, "float32", "bfloat16", "bf16"):
        assert (sampler._dtype_of(name) is None) == \
            (jax_sampler._dtype_of(name) is None)
    assert sampler._dtype_of("bf16") == torch.bfloat16
    with pytest.raises(KeyError):
        sampler._dtype_of("float16")


@pytest.fixture(scope="module")
def tiny_vgg():
    g, params = vgg.build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    g_j = jax_split_relu(jax_vgg.build_tiny_vgg(batch=4, image_size=16)[0])
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)) \
        .astype(np.float32)
    cache_j = jax_freeze(g_j, to_device_params(params), inputs, n_points=10,
                         seed=0, chunk_batches=4)
    return (g, g_j), params, inputs, cache_j


def _port_cache(cache_j, tmp_path):
    """The JAX-frozen cache, saved and loaded by the port: one cache for
    both packages."""
    path = tmp_path / "frozen.npz"
    cache_j.save(path)
    return sampler.FrozenCache.load(path)


@pytest.mark.parametrize("dtype", ["bfloat16", "bf16"])
def test_chain_frontier_bf16_matches_jax(tiny_vgg, dtype):
    """`RollingReplay` in bf16: every conv's patches and a response ahead
    of the frontier against the JAX frontier's, after a weight update;
    the frontier stays f32."""
    (g, g_j), params, inputs, cache_j = tiny_vgg
    p2 = {k: dict(v) for k, v in params.items()}
    p2["conv1_2"]["W"] = np.asarray(p2["conv1_2"]["W"]) * 0.5
    dev, dev_j = params_to_torch(p2, "cpu"), to_device_params(p2)
    roll = rolling.RollingReplay(g, inputs, device="cpu", group_batches=4,
                                 compute_dtype=dtype)
    roll_j = jax_rolling.RollingReplay(g_j, inputs, compute_dtype=dtype,
                                       group_batches=4)
    for conv in list(g.convs)[1:]:
        bottom = g.layer(conv).bottoms[0]
        roll.advance_to(dev, bottom)
        roll_j.advance_to(dev_j, bottom)
        assert all(t.dtype == torch.float32 for t in roll.groups)
        _close(roll.patches_at(cache_j.plan, conv).numpy(),
               roll_j.patches_at(cache_j.plan, conv), rel=1e-4)
        if conv == "conv2_2":
            top = g.layer("conv3_1").tops[0]
            _close(roll.features_at(dev, cache_j.plan, top),
                   roll_j.features_at(dev_j, cache_j.plan, top), rel=1e-4)


@pytest.fixture(scope="module")
def tiny_resnet():
    g, p = c3.preprocess(*resnet.build_tiny_resnet(batch=4, image_size=32))
    g_j, p_j = jax_c3.preprocess(*jax_resnet.build_tiny_resnet(batch=4,
                                                               image_size=32))
    inputs = np.random.default_rng(11).normal(0, 1, (8, 4, 3, 32, 32)) \
        .astype(np.float32)
    cache_j = jax_freeze(g_j, to_device_params(p_j), inputs, n_points=8,
                         seed=0, chunk_batches=4,
                         share_key=jax_sampler.resnet_share_key(g_j))
    ct, it = {}, {}
    for conv in g.convs:       # tests/test_resnet_pipeline.py:156-163
        n = int(g.layer(conv).attr("num_output"))
        if conv.endswith(("branch2a", "branch2b")):
            ct[conv] = max(2, int(n * 0.7))
        if conv.endswith("branch2a"):
            it[conv] = max(2, int(p[conv]["W"].shape[1] * 0.7))
    return (g, g_j), (p, p_j), inputs, cache_j, (ct, it)


def test_dag_frontier_bf16_matches_jax(tiny_resnet):
    """`RollingReplayDAG` in bf16 through the Eltwise junctions: every
    conv's patches against the JAX DAG frontier's and the port's own full
    replay in bf16 (`sample_patches`)."""
    (g, g_j), (p, _), inputs, cache_j, _ = tiny_resnet
    dev, dev_j = params_to_torch(p, "cpu"), to_device_params(p)
    roll = rolling.RollingReplayDAG(g, inputs, device="cpu", group_batches=4,
                                    compute_dtype=BF16)
    roll_j = jax_rolling.RollingReplayDAG(g_j, inputs, compute_dtype=BF16,
                                          group_batches=4)
    for conv in list(g.convs)[1:]:
        bottom = g.layer(conv).bottoms[0]
        roll.advance_to(dev, bottom)
        roll_j.advance_to(dev_j, bottom)
        got = roll.patches_at(cache_j.plan, conv).numpy()
        _close(got, roll_j.patches_at(cache_j.plan, conv), rel=1e-4)
        full = sampler.sample_patches(g, dev, inputs, conv, cache_j.plan,
                                      device="cpu", chunk_batches=2,
                                      compute_dtype=BF16)
        _close(got, full.numpy(), rel=1e-5)


def test_full_replays_bf16_match_jax(tiny_resnet):
    """`sample_patches` and `sample_features` in bf16 against the JAX
    package's, and both off their f32 replays by more than rounding."""
    (g, g_j), (p, p_j), inputs, cache_j, _ = tiny_resnet
    dev, dev_j = params_to_torch(p, "cpu"), to_device_params(p_j)
    conv = "res2b_branch2a"
    got = sampler.sample_patches(g, dev, inputs, conv, cache_j.plan,
                                 device="cpu", chunk_batches=4,
                                 compute_dtype=BF16).numpy()
    want = jax_sampler.sample_patches(g_j, dev_j, inputs, conv, cache_j.plan,
                                      chunk_batches=4, compute_dtype=BF16)
    _close(got, want, rel=1e-4)
    tensors = tuple(e.tops[0] for e in g.by_type(LT.ELTWISE)) + \
        (g.layer(conv).tops[0],)
    feats = sampler.sample_features(g, dev, inputs, cache_j.plan, tensors,
                                    device="cpu", chunk_batches=4,
                                    compute_dtype=BF16)
    feats_j = jax_sampler.sample_features(g_j, dev_j, inputs, cache_j.plan,
                                          tensors, chunk_batches=4,
                                          compute_dtype=BF16)
    f32 = sampler.sample_features(g, dev, inputs, cache_j.plan, tensors,
                                  device="cpu", chunk_batches=4)
    for t in tensors:
        _close(feats[t], feats_j[t], rel=1e-4)
        assert np.abs(feats[t] - f32[t]).max() > 1e-4 * np.abs(f32[t]).max()


def _same_solve(res, res_j, rel):
    """The same layers, masks and kept counts; rMSEs within `rel`.

    bf16 replays round each refit weight, and the two packages' f32
    refits differ in their last bits (summation order), so a weight near a
    bf16 rounding boundary lands on a neighbouring value in one of them:
    rMSEs drift further apart than in f32. Within the port alone, weights
    scaled by 1 + 1e-6 noise move the tiny ResNet's bf16 rMSEs by up to
    4.3e-3 relative (f32: 3.7e-5), the same masks kept."""
    assert [r.conv for r in res.reports] == [r.conv for r in res_j.reports]
    for name, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name], keep,
                                      err_msg=name)
    for r, rj in zip(res.reports, res_j.reports):
        assert r.kept == rj.kept, r.conv
        assert r.rmse_before == pytest.approx(rj.rmse_before, rel=rel,
                                              abs=1e-6), r.conv
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=rel,
                                             abs=1e-6), r.conv


@pytest.mark.parametrize("fused", [True, False],
                         ids=["pipelined", "sequential"])
def test_tiny_vgg_bf16_selects_as_jax(tiny_vgg, tmp_path, fused):
    """The tiny VGG in bf16 on one JAX-frozen cache: the JAX package's
    masks, pipelined and sequential; the f32 ground truth and solver math
    are untouched (the first layer starts from the same error)."""
    (g, g_j), params, _, cache_j = tiny_vgg
    cache = _port_cache(cache_j, tmp_path)
    cfg = default_config().replace_nested("solve.band", "bottom") \
        .replace_nested("solve.dtype", BF16) \
        .replace_nested("solve.fused_search", fused)
    res = c3.solve_prune(g, params, cache, cfg, channel_targets=VGG_TARGETS,
                         device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, params, cache_j, cfg,
                               channel_targets=VGG_TARGETS, verbose=False)
    assert res.pipelined == fused
    _same_solve(res, res_j, rel=1e-3)
    for prod, t in VGG_TARGETS.items():
        assert res.params[prod]["W"].shape[0] == t
    # bf16 replays move the errors against an f32 solve of the same cache
    f32 = c3.solve_prune(g, params, cache,
                         cfg.replace_nested("solve.dtype", "float32"),
                         channel_targets=VGG_TARGETS, device="cpu",
                         verbose=False)
    assert [r.rmse_after for r in f32.reports] != \
        [r.rmse_after for r in res.reports]


def test_tiny_resnet_bf16_selects_as_jax(tiny_resnet, tmp_path):
    """Gates, residual compensation (the shortcut's features from the
    bf16 frontier) and the DAG frontier in bf16, pipelined."""
    (g, g_j), (p, p_j), _, cache_j, (ct, it) = tiny_resnet
    cfg = default_config().replace_nested("solve.band", "bottom") \
        .replace_nested("solve.dtype", BF16)
    res = c3.solve_prune(g, p, _port_cache(cache_j, tmp_path), cfg,
                         channel_targets=ct, input_targets=it, device="cpu",
                         verbose=False)
    res_j = jax_c3.solve_prune(g_j, p_j, cache_j, cfg, channel_targets=ct,
                               input_targets=it, verbose=False)
    assert res.pipelined
    _same_solve(res, res_j, rel=1e-2)


def test_tiny_frcnn_bf16_selects_as_jax(tmp_path, monkeypatch):
    """The tiny Faster-RCNN backbone in bf16 with its frontier refused, so
    every layer replays from the input (`sample_patches`), as the
    full-size 600² run does on the card; the RPN heads' producer is left
    out of the targets, as in tests/test_torch_xception_frcnn.py."""
    g, p = c3.preprocess(*faster_rcnn.build_tiny_frcnn(batch=2, image_size=48))
    g_j, p_j = jax_c3.preprocess(*jax_frcnn.build_tiny_frcnn(batch=2,
                                                             image_size=48))
    inputs = np.random.default_rng(0).normal(
        0, 1, (8,) + tuple(g.inputs[0].shape)).astype(np.float32)
    targets = c3.plan_uniform_targets(g, 5.0, rank_tol=0.1)
    targets.pop("rpn_conv/3x3", None)
    cache_j = jax_freeze(g_j, to_device_params(p_j), inputs, n_points=10,
                         seed=0, chunk_batches=4)
    cfg = default_config().replace_nested("solve.dtype", BF16)
    monkeypatch.setattr(c3, "_maybe_rolling", lambda *a, **k: None)
    monkeypatch.setattr(jax_c3, "_maybe_rolling", lambda *a, **k: None)
    res = c3.solve_prune(g, p, _port_cache(cache_j, tmp_path), cfg,
                         channel_targets=targets, device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, p_j, cache_j, cfg, channel_targets=targets,
                               verbose=False)
    assert not res.pipelined
    _same_solve(res, res_j, rel=1e-4)


def test_tiny_3c_bf16_matches_jax(tiny_vgg, tmp_path):
    """3C in bf16 (VH, ITQ and the arms on bf16 patches): the JAX
    package's structure, arm selections and errors."""
    (g, g_j), params, _, cache_j = tiny_vgg
    ranks = {"conv2_1": 9, "conv2_2": 9}
    cfg = default_config().replace_nested("solve.dtype", BF16)
    cfg = dataclasses.replace(cfg, solve=dataclasses.replace(
        cfg.solve, nonlinear_iters=(4, 2), itq_iters=(4, 2)))
    res = c3.solve_3c(g, params, _port_cache(cache_j, tmp_path), cfg, ranks,
                      device="cpu", verbose=False)
    res_j = jax_c3.solve_3c(g_j, params, cache_j, cfg, ranks, verbose=False)
    assert res.selections.keys() == res_j.selections.keys() == \
        {"conv2_2", "conv3_1"}
    for consumer, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[consumer], keep,
                                      err_msg=consumer)
    assert [(r.conv, r.rank, r.kept, r.total) for r in res.reports] == \
        [(r.conv, r.rank, r.kept, r.total) for r in res_j.reports]
    for r, rj in zip(res.reports, res_j.reports):
        assert r.rmse_before == pytest.approx(rj.rmse_before, rel=1e-3), r.conv
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-3), r.conv


def _cli_dtype(tmp_path, monkeypatch, model, *extra):
    """`cli prune` on a tiny model; the `solve.dtype` its solve ran with."""
    seen = []
    real = c3.solve_prune

    def spy(graph, params, cache, cfg, **kw):
        seen.append(cfg.solve.dtype)
        return real(graph, params, cache, cfg, **kw)

    monkeypatch.setattr(c3, "solve_prune", spy)
    speed = "2.0" if model == "tiny_vgg" else "1.2"
    cli.main(["prune", "--model", model, "--batch", "4", "--cal-batches", "4",
              "--cal-batch", "4", "--speed", speed, "--device", "cpu",
              "--work-dir", str(tmp_path), *extra])
    return seen


@pytest.mark.parametrize("model,extra,want", [
    ("tiny_vgg", (), "bfloat16"),
    ("tiny_resnet", (), "float32"),
    ("tiny_vgg", ("--set", "solve.dtype=float32"), "float32"),
    ("tiny_resnet", ("--set", "solve.dtype=bf16"), "bf16")],
    ids=["vgg_preset", "resnet_f32", "vgg_forced_f32", "resnet_forced_bf16"])
def test_cli_preset_follows_jax_rule(tmp_path, monkeypatch, capsys, model,
                                     extra, want):
    """The JAX CLI's rule (channel_pruning_tpu/cli.py:161-165): bf16 for a
    graph whose name contains "vgg" unless `--set solve.dtype=...` names
    one; the dtype in force is printed on the model line."""
    assert set(_cli_dtype(tmp_path, monkeypatch, model, *extra)) == {want}
    assert f"replays in {want}" in capsys.readouterr().out


@pytest.mark.parametrize("route", ["tf32", "f32"])
def test_time_peak_follows_the_conv_routes(monkeypatch, route):
    """`cli time --dtype bfloat16` reads MFU against the peak of the routes
    its convs ran: every conv on TF32 gives the FLOPs over their time at
    495 TFLOP/s plus the FC layers' at f32's 67; every conv on f32 gives
    67 TFLOP/s; an f32 forward 67; no card, no peak."""
    from channel_pruning_tpu_torch.graph.ir import shapes_of
    from channel_pruning_tpu_torch.utils import flops, profiling

    g = vgg.build_vgg16()
    assert profiling.peak_flops("cpu", BF16, g, 4) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(profiling, "conv_routes", lambda graph, b, cd, dev: (
        {c: route for c in graph.convs} if cd else {}))
    peak = profiling.peak_flops("cuda", BF16, g, 4)
    shapes = shapes_of(g, batch=1)
    conv = sum(flops.layer_flops(g, shapes, c) for c in g.convs)
    rest = flops.total_flops(g) - conv
    rate = {"tf32": 495e12, "f32": 67e12}[route]
    assert peak == pytest.approx((conv + rest) / (conv / rate + rest / 67e12),
                                 rel=1e-9)
    assert profiling.peak_flops("cuda", None, g, 4) == 67e12
