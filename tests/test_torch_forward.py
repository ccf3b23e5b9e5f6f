"""The port's executor and point gathers (channel_pruning_tpu_torch/ops/
forward.py, ops/patches.py) against the JAX package's on the same numpy
inputs. Forwards: rtol 1e-4 / atol 1e-5 (convolutions summed in another
order). Gathers: bit-equal (pure indexing and a 0/1 mask). Each package
runs a graph built by its own builders from the same seed."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph import ir as jax_ir
from channel_pruning_tpu.models import resnet as jax_resnet
from channel_pruning_tpu.models import vgg as jax_vgg
from channel_pruning_tpu.models import xception as jax_xception
from channel_pruning_tpu.ops import forward as jax_forward
from channel_pruning_tpu.ops import patches as jax_patches
from channel_pruning_tpu_torch.convert import params_to_numpy, params_to_torch
from channel_pruning_tpu_torch.graph import ir
from channel_pruning_tpu_torch.graph.ir import LT
from channel_pruning_tpu_torch.models import resnet, vgg, xception
from channel_pruning_tpu_torch.ops import forward, patches
from torch_cpu import one_thread  # noqa: F401


def _graph(name, inputs, layers):
    """(JAX package's Graph, port's Graph) of the same layers; `inputs` is
    ((name, shape), ...), `layers` ((name, type, bottoms, tops, attrs), ...)."""
    return tuple(
        m.Graph(name, tuple(m.TensorSpec(n, s) for n, s in inputs),
                tuple(m.Layer.make(n, t, b, tp, **a) for n, t, b, tp, a in layers))
        for m in (jax_ir, ir))


def _both(graphs, params, x, capture=()):
    graph_j, graph = graphs
    outs_j, caps_j = jax_forward.run_graph(graph_j, params, {"data": x},
                                           capture=capture)
    outs, caps = forward.run_graph(graph, params_to_torch(params, "cpu"),
                                   {"data": torch.from_numpy(x)},
                                   capture=capture)
    return outs_j, caps_j, outs, caps


@pytest.mark.parametrize("build,image", [
    ((jax_vgg.build_tiny_vgg, vgg.build_tiny_vgg), 16),
    ((jax_resnet.build_tiny_resnet, resnet.build_tiny_resnet), 32),
    ((jax_xception.build_tiny_xception, xception.build_tiny_xception), 32)])
def test_run_graph_matches_jax(build, image):
    """Conv (grouped/depthwise), ceil-mode pools, BN with the moving-average
    factor, Scale, Eltwise, FC and softmax; captures at production time."""
    g_j, params = build[0](batch=2, image_size=image)
    g, params_port = build[1](batch=2, image_size=image)
    for k in params:
        for n in params[k]:
            np.testing.assert_array_equal(params_port[k][n], params[k][n])
    x = np.random.default_rng(0).normal(size=(2, 3, image, image)).astype(np.float32)
    capture = tuple(g.layer(c).tops[0] for c in g.convs[:3])
    outs_j, caps_j, outs, caps = _both((g_j, g), params, x, capture)
    assert set(outs) == set(outs_j) and set(caps) == set(caps_j)
    for k in outs_j:
        np.testing.assert_allclose(outs[k].numpy(), np.asarray(outs_j[k]),
                                   rtol=1e-4, atol=1e-5)
    for k in caps_j:
        np.testing.assert_allclose(caps[k].numpy(), np.asarray(caps_j[k]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pool,k,s,p,size", [("max", 3, 2, 0, 11),
                                             ("max", 3, 2, 1, 12),
                                             ("ave", 3, 2, 1, 11),
                                             ("ave", 2, 2, 0, 7)])
def test_caffe_pooling_matches_jax(pool, k, s, p, size):
    """Caffe ceil mode; average pooling divides by the in-image count."""
    g = _graph("p", (("data", (2, 4, size, size)),),
               (("pool", LT.POOL, ["data"], ["pool"],
                 dict(pool=pool, kernel_size=k, stride=s, pad=p)),))
    x = np.random.default_rng(1).normal(size=(2, 4, size, size)).astype(np.float32)
    outs_j, _, outs, _ = _both(g, {}, x)
    assert tuple(outs["pool"].shape) == np.asarray(outs_j["pool"]).shape
    np.testing.assert_allclose(outs["pool"].numpy(), np.asarray(outs_j["pool"]),
                               rtol=1e-6, atol=1e-6)


def test_select_concat_bn_factor_match_jax():
    rng = np.random.default_rng(2)
    g = _graph("m", (("data", (2, 6, 5, 5)),), (
        ("sel", LT.SELECT, ["data"], ["s"], dict(indices=(1, 3, 4), num_output=3)),
        ("bn", LT.BN, ["s"], ["n"], dict(eps=1e-5)),
        ("cat", LT.CONCAT, ["n", "data"], ["c"], dict(axis=1)),
        ("flat", LT.FLATTEN, ["c"], ["f"], {})))
    params = {"bn": {"mean": rng.normal(size=3).astype(np.float32),
                     "var": rng.uniform(0.5, 2, 3).astype(np.float32),
                     "factor": np.float32(2.0)}}
    x = rng.normal(size=(2, 6, 5, 5)).astype(np.float32)
    outs_j, _, outs, _ = _both(g, params, x)
    np.testing.assert_allclose(outs["f"].numpy(), np.asarray(outs_j["f"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel,stride,pad,size", [((3, 3), (1, 1), (1, 1), 9),
                                                    ((3, 3), (2, 2), (1, 1), 10),
                                                    ((1, 1), (1, 1), (0, 0), 6),
                                                    ((7, 7), (2, 2), (3, 3), 15)])
def test_point_gathers_bit_equal(kernel, stride, pad, size):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, size, size)).astype(np.float32)
    out_size = (size + 2 * pad[0] - kernel[0]) // stride[0] + 1
    ys = rng.integers(0, out_size, 7).astype(np.int32)
    xs = rng.integers(0, out_size, 7).astype(np.int32)
    got = patches.gather_patches_at_points(
        torch.from_numpy(x), torch.from_numpy(ys).long(),
        torch.from_numpy(xs).long(), kernel, stride, pad)
    ref = jax_patches.gather_patches_at_points(x, ys, xs, kernel, stride, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    yc = rng.integers(0, size, 7).astype(np.int32)
    xc = rng.integers(0, size, 7).astype(np.int32)
    got = patches.gather_channels_at_points(
        torch.from_numpy(x), torch.from_numpy(yc).long(),
        torch.from_numpy(xc).long())
    ref = jax_patches.gather_channels_at_points(x, yc, xc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kernel,stride,pad,size", [((3, 3), (1, 1), (1, 1), 9),
                                                    ((1, 1), (2, 2), (0, 0), 10),
                                                    ((7, 7), (2, 2), (3, 3), 15)])
def test_grouped_gathers_equal_per_chunk_gathers(kernel, stride, pad, size):
    """The grouped gathers (one indexing op for all chunks) give the
    per-chunk point gathers' values and rows, g*P*B + p*B + b, bit for bit;
    those are held to the JAX package's above."""
    rng = np.random.default_rng(5)
    G, B, P = 3, 2, 4
    v = torch.from_numpy(rng.normal(size=(G * B, 5, size, size))
                         .astype(np.float32))
    out_size = (size + 2 * pad[0] - kernel[0]) // stride[0] + 1
    ys = torch.from_numpy(rng.integers(0, out_size, (G, P)))
    xs = torch.from_numpy(rng.integers(0, out_size, (G, P)))
    got = patches.gather_patches_grouped(v, ys, xs, kernel, stride, pad)
    want = torch.cat([patches.gather_patches_at_points(
        v[g * B:(g + 1) * B], ys[g], xs[g], kernel, stride, pad)
        for g in range(G)])
    assert torch.equal(got, want)
    yc = torch.from_numpy(rng.integers(0, size, (G, P)))
    xc = torch.from_numpy(rng.integers(0, size, (G, P)))
    got = patches.gather_channels_grouped(v, yc, xc)
    want = torch.cat([patches.gather_channels_at_points(
        v[g * B:(g + 1) * B], yc[g], xc[g]) for g in range(G)])
    assert torch.equal(got, want)


def test_params_round_trip():
    _, params = vgg.build_tiny_vgg()
    back = params_to_numpy(params_to_torch(params, "cpu"))
    assert back.keys() == params.keys()
    for k in params:
        for n in params[k]:
            np.testing.assert_array_equal(back[k][n], params[k][n])
