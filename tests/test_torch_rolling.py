"""The port's rolling frontiers (channel_pruning_tpu_torch/sampling/rolling)
against the port's full replays and the JAX package's frontiers, on the tiny
ResNet (DAG cut) and the tiny VGG (chain). Protocol of tests/test_rolling.py:
allclose at rtol 1e-4 / atol 1e-5 (f32 convolutions summed in another
order); the same numpy inputs and point plan go to both packages, and each
package's graph comes from its own builders."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph import rewrite as jax_rewrite
from channel_pruning_tpu.models import resnet as jax_resnet
from channel_pruning_tpu.models import vgg as jax_vgg
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.sampling import rolling as jax_rolling
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.ir import LT
from channel_pruning_tpu_torch.graph.rewrite import split_relu
from channel_pruning_tpu_torch.models.resnet import (build_resnet50,
                                                     build_tiny_resnet)
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg, build_vgg16
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.sampling import rolling, sampler
from torch_cpu import one_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def resnet():
    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    g_j, _ = jax_c3.preprocess(*jax_resnet.build_tiny_resnet(batch=4,
                                                             image_size=32))
    inputs = np.random.default_rng(4).normal(0, 1, (6, 4, 3, 32, 32)) \
        .astype(np.float32)
    dev = params_to_torch(p, "cpu")
    cache = sampler.freeze(g, dev, inputs, device="cpu", n_points=4, seed=0,
                           chunk_batches=3,
                           share_key=sampler.resnet_share_key(g))
    return (g, g_j), p, inputs, dev, to_device_params(p), cache


def test_dag_patches_match_full_replay_and_jax(resnet):
    """Every conv's input patches from the DAG cut, through the Eltwise
    junctions and after a weight update, equal the full replay's and the
    JAX DAG frontier's."""
    (g, g_j), p, inputs, dev, dev_j, cache = resnet
    # the running net's first block has been reconstructed already
    p2 = {k: dict(v) for k, v in p.items()}
    p2["res2a_branch2b"]["W"] = np.asarray(p2["res2a_branch2b"]["W"]) * 0.5
    dev, dev_j = params_to_torch(p2, "cpu"), to_device_params(p2)
    roll = rolling.RollingReplayDAG(g, inputs, device="cpu", group_batches=3)
    roll_j = jax_rolling.RollingReplayDAG(g_j, inputs, group_batches=3)
    for conv in list(g.convs)[1:]:
        bottom = g.layer(conv).bottoms[0]
        roll.advance_to(dev, bottom)
        roll_j.advance_to(dev_j, bottom)
        got = roll.patches_at(cache.plan, conv).numpy()
        full = sampler.sample_patches(g, dev, inputs, conv, cache.plan,
                                      device="cpu", chunk_batches=2)
        np.testing.assert_allclose(got, full.numpy(), **TOL, err_msg=conv)
        np.testing.assert_allclose(got, np.asarray(
            roll_j.patches_at(cache.plan, conv)), **TOL, err_msg=conv)
        assert sorted(roll.state) == sorted(roll_j.state), conv


@pytest.mark.parametrize("where", ["in_cut", "ahead_of_cut"])
def test_dag_features_match_full_replay_and_jax(resnet, where):
    """Sampled responses of a residual block's bottoms: the shortcut straight
    from the cut, and the branch output computed forward from it (state
    unchanged), against sample_features and the JAX frontier."""
    (g, g_j), p, inputs, dev, dev_j, cache = resnet
    e = g.by_type(LT.ELTWISE)[1]                 # res2b: identity shortcut
    shortcut, branch = e.bottoms
    # the frontier at the branch's last conv's bottom, as when that conv
    # is solved with residual compensation
    last_conv = g.producer(branch).name
    at = g.layer(last_conv).bottoms[0]
    tensor = shortcut if where == "in_cut" else branch
    roll = rolling.RollingReplayDAG(g, inputs, device="cpu", group_batches=3)
    roll_j = jax_rolling.RollingReplayDAG(g_j, inputs, group_batches=3)
    roll.advance_to(dev, at)
    roll_j.advance_to(dev_j, at)
    assert (tensor in roll.state) == (where == "in_cut")
    state = {t: [v.clone() for v in vs] for t, vs in roll.state.items()}
    got = roll.features_at(dev, cache.plan, tensor, device=True)
    assert isinstance(got, torch.Tensor)
    want = sampler.sample_features(g, dev, inputs, cache.plan, (tensor,),
                                   device="cpu", chunk_batches=2)[tensor]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        roll.features_at(dev, cache.plan, tensor),
        np.asarray(roll_j.features_at(dev_j, cache.plan, tensor)), **TOL)
    assert roll.state.keys() == state.keys()
    for t, vs in state.items():
        for a, b in zip(roll.state[t], vs):
            assert torch.equal(a, b), t


def test_dag_frontier_error_is_narrow(resnet):
    """A rewind, a patch request for a tensor dropped from the cut, and a
    feature request behind the cut raise FrontierError (the only fall-back
    signal), and leave the frontier as it was."""
    (g, _), p, inputs, dev, _, cache = resnet
    convs = list(g.convs)
    dag = rolling.RollingReplayDAG(g, inputs[:3], device="cpu",
                                   group_batches=3)
    dag.advance_to(dev, g.layer(convs[3]).bottoms[0])
    cut = sorted(dag.state)
    with pytest.raises(rolling.FrontierError):
        dag.advance_to(dev, g.layer(convs[1]).bottoms[0])
    with pytest.raises(rolling.FrontierError):
        dag.patches_at(cache.plan, convs[2])
    with pytest.raises(rolling.FrontierError):    # consumed by its ReLU
        dag.features_at(dev, cache.plan, g.layer(convs[2]).tops[0])
    # the first block's projection shortcut is still live: served
    assert dag.features_at(dev, cache.plan, g.layer(convs[1]).tops[0]).shape \
        == cache.feats[g.layer(convs[1]).tops[0]][:48].shape
    assert sorted(dag.state) == cut


def test_chain_features_at_matches_full_replay_and_jax():
    g, params = build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    inputs = np.random.default_rng(3).normal(0, 1, (6, 4, 3, 16, 16)) \
        .astype(np.float32)
    dev = params_to_torch(params, "cpu")
    cache = sampler.freeze(g, dev, inputs, device="cpu", n_points=5, seed=0,
                           chunk_batches=3)
    conv = "conv2_2"
    top = g.layer(conv).tops[0]
    roll = rolling.RollingReplay(g, inputs, device="cpu")
    roll.advance_to(dev, g.layer(conv).bottoms[0])
    got = roll.features_at(dev, cache.plan, top)
    want = sampler.sample_features(g, dev, inputs, cache.plan, (top,),
                                   device="cpu", chunk_batches=3)[top]
    np.testing.assert_allclose(got, want, **TOL)
    g_j = jax_rewrite.split_relu(jax_vgg.build_tiny_vgg(batch=4, image_size=16)[0])
    roll_j = jax_rolling.RollingReplay(g_j, inputs)
    roll_j.advance_to(to_device_params(params), g.layer(conv).bottoms[0])
    np.testing.assert_allclose(
        got, np.asarray(roll_j.features_at(to_device_params(params),
                                           cache.plan, top)), **TOL)
    with pytest.raises(rolling.FrontierError):
        roll.features_at(dev, cache.plan, g.layer("conv1_2").tops[0])


@pytest.mark.parametrize("model", ["tiny_resnet", "resnet50", "vgg16"])
def test_estimate_cut_bytes_matches_jax(model):
    """Shapes only, no compute: the live cut's footprint equals the JAX
    package's, and ResNet-50 at 224 px with 500 images fits the 8 GB budget,
    so the CLI's ResNet-50 run takes the DAG frontier."""
    if model == "tiny_resnet":
        g = build_tiny_resnet(batch=1, image_size=32)[0]
        g_j = jax_resnet.build_tiny_resnet(batch=1, image_size=32)[0]
    elif model == "resnet50":
        g, g_j = build_resnet50(batch=1), jax_resnet.build_resnet50(batch=1)
    else:
        g, g_j = build_vgg16(batch=1), jax_vgg.build_vgg16(batch=1)
    g, g_j = split_relu(g), jax_rewrite.split_relu(g_j)
    for n in (24, 500):
        assert rolling.estimate_cut_bytes(g, n) == \
            jax_rolling.estimate_cut_bytes(g_j, n)
    assert rolling._last_use(g) == jax_rolling._last_use(g_j)
    if model == "resnet50":
        assert 3e9 < rolling.estimate_cut_bytes(g, 500) < 8 << 30


def test_maybe_rolling_picks_the_frontier_by_topology(resnet):
    (g, _), _, _, _, _, cache = resnet
    assert isinstance(c3._maybe_rolling(g, cache, "cpu"),
                      rolling.RollingReplayDAG)
    assert c3._maybe_rolling(g, cache, "cpu", budget=1) is None
    gv = split_relu(build_tiny_vgg(batch=4, image_size=16)[0])
    cv = sampler.FrozenCache(inputs=np.zeros((2, 4, 3, 16, 16), np.float32),
                             plan={}, feats={})
    assert isinstance(c3._maybe_rolling(gv, cv, "cpu"), rolling.RollingReplay)
