"""The port's two remaining model families against the JAX package: the tiny
Xception (depthwise chains: a depthwise consumer is skipped, a pointwise one
shrinks the depthwise conv before it and that conv's producer; Select gates
at the residual junctions) and the tiny Faster-RCNN backbone (as built,
and with its RPN conv cut to 32 outputs so that the two 1x1 heads it feeds
are solved too), through the pipelined pass and the sequential one, from the same numpy inputs; and the
planner's uniform targets on the full-size `xception` and `frcnn_vgg16` at
600². The JAX side runs as its suite runs on the CPU (XLA CD), the port's on
the plain CD. Each package solves a graph built by its own builders from the
same seed.

The calibration sets are sized so that every least-squares refit has at
least as many distinct rows as columns: with fewer, the jitter decides the
refit, f32 summation order then moves the next layer's input, and the two
packages may select differently for reasons that are not the port's."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.models import faster_rcnn as jax_frcnn
from channel_pruning_tpu.models import xception as jax_xception
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.sampling import freeze as jax_freeze
from channel_pruning_tpu.sampling.sampler import \
    resnet_share_key as jax_share_key
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.ir import LT
from channel_pruning_tpu_torch.models import faster_rcnn, xception
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.sampling import sampler
from torch_cpu import one_thread  # noqa: F401


def _narrow_rpn(family, g, p, width):
    """The tiny Faster-RCNN with its RPN conv cut to its first `width`
    outputs (and the two heads' inputs to match), with either package's
    rewrite: the same structure, a producer feeding two 1x1 heads, at a
    width whose LASSO the calibration set determines."""
    p = {k: dict(v) for k, v in p.items()}
    rpn = {k: np.asarray(v) for k, v in p["rpn_conv/3x3"].items()}
    g, p = family.set_conv(g, p, "rpn_conv/3x3", W=rpn["W"][:width],
                           b=rpn["b"][:width])
    for head in ("rpn_cls_score", "rpn_bbox_pred"):
        g, p = family.set_conv(g, p, head,
                               W=np.asarray(p[head]["W"])[:, :width])
    return g, p


def _family(name):
    """(port graph and params, JAX graph and params, inputs, targets, speed)
    after preprocess. tiny_xception at 64² keeps 2x2 maps in its exit flow,
    so 64 images give 256 distinct rows for its widest (192) refit; the
    tiny Faster-RCNN backbone's RPN heads are 1x1 consumers of a 512-wide
    conv (its width is the published one): with 160 rows their LASSO has
    more columns than rows, and the plain CD takes ~20 s a grid at c = 512
    on the CPU, so in `frcnn` the planner's target for `rpn_conv/3x3` (the
    heads' producer) is left out; `frcnn_rpn` cuts that conv to 32 outputs
    in both packages and keeps its target, so the heads are solved too."""
    from channel_pruning_tpu.graph import rewrite as jax_rewrite
    from channel_pruning_tpu_torch.graph import rewrite

    if name == "xception":
        g, p = c3.preprocess(*xception.build_tiny_xception(batch=4,
                                                           image_size=64))
        g_j, p_j = jax_c3.preprocess(*jax_xception.build_tiny_xception(
            batch=4, image_size=64))
        n_batches, n_points, speed = 16, 8, 2.0
    else:
        g, p = faster_rcnn.build_tiny_frcnn(batch=2, image_size=48)
        g_j, p_j = jax_frcnn.build_tiny_frcnn(batch=2, image_size=48)
        if name == "frcnn_rpn":
            g, p = _narrow_rpn(rewrite, g, p, 32)
            g_j, p_j = _narrow_rpn(jax_rewrite, g_j, p_j, 32)
        g, p = c3.preprocess(g, p)
        g_j, p_j = jax_c3.preprocess(g_j, p_j)
        n_batches, n_points, speed = 8, 10, 5.0
    spec = g.inputs[0].shape
    inputs = np.random.default_rng(0).normal(
        0, 1, (n_batches,) + tuple(spec)).astype(np.float32)
    targets = c3.plan_uniform_targets(g, speed, rank_tol=0.1)
    assert targets == jax_c3.plan_uniform_targets(g_j, speed, rank_tol=0.1)
    if name == "frcnn":
        targets.pop("rpn_conv/3x3", None)
    return (g, p), (g_j, p_j), inputs, n_points, targets


@pytest.fixture(scope="module", params=["xception", "frcnn", "frcnn_rpn"])
def family(request):
    (g, p), (g_j, p_j), inputs, n_points, targets = _family(request.param)
    cache_j = jax_freeze(g_j, to_device_params(p_j), inputs, n_points=n_points,
                         seed=0, chunk_batches=4,
                         share_key=jax_share_key(g_j) if g_j.sums else None)
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device="cpu",
                           n_points=n_points, seed=0, chunk_batches=4,
                           share_key=sampler.resnet_share_key(g)
                           if g.sums else None)
    return request.param, (g, p), (g_j, p_j), inputs, cache, cache_j, targets


def _conv_shapes(graph, params):
    return {l.name: (int(l.attr("num_output")), int(l.attr("group", 1)),
                     tuple(np.asarray(params[l.name]["W"]).shape))
            for l in graph.layers if l.type == LT.CONV}


def _gates(graph):
    return sorted((l.name, tuple(l.bottoms), tuple(l.tops),
                   int(l.attr("num_output")))
                  for l in graph.layers if l.type == LT.SELECT)


def test_freeze_matches_jax(family):
    """Both packages' forwards on the same numpy params and images (grouped
    and depthwise convs, BN folded into them, the RPN's two heads): the
    same point plan and the same frozen responses at every conv top."""
    _, _, _, _, cache, cache_j, _ = family
    assert cache.plan.keys() == cache_j.plan.keys()
    for t, (ys, xs) in cache_j.plan.items():
        np.testing.assert_array_equal(cache.plan[t][0], ys)
        np.testing.assert_array_equal(cache.plan[t][1], xs)
    assert cache.feats.keys() == cache_j.feats.keys()
    # an f32 forward 30 convs deep: an entry near 0 carries the absolute
    # rounding of its neighbours, so atol is 1e-5 of the tensor's largest
    # |value| (up to ~7 in the middle flow)
    for t, f in cache_j.feats.items():
        np.testing.assert_allclose(cache.feats[t], f, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(f).max()),
                                   err_msg=t)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["pipelined", "sequential"])
def test_family_selects_as_jax(family, fused):
    """Pipelined (the default, fused search) and sequential passes: the
    same layers solved in the same order, identical selections, rMSEs
    within 1e-4 relative (abs 1e-6: some refits are exact), the same conv
    widths and groups in the output graph (the shrunk depthwise convs'
    num_output and group included) and the same Select gates; the pruned
    net reloads its shapes and gives probabilities (Xception) or finite RPN
    outputs (Faster-RCNN; with the narrow RPN, both heads selected behind
    Select gates)."""
    name, (g, p), (g_j, p_j), inputs, cache, cache_j, targets = family
    cfg = default_config().replace_nested("solve.fused_search", fused)
    res = c3.solve_prune(g, p, cache, cfg, channel_targets=targets,
                         device="cpu", verbose=False)
    res_j = jax_c3.solve_prune(g_j, p_j, cache_j, cfg,
                               channel_targets=targets, verbose=False)
    assert res.pipelined == fused
    assert [r.conv for r in res.reports] == [r.conv for r in res_j.reports]
    for name_, keep in res_j.selections.items():
        np.testing.assert_array_equal(res.selections[name_], keep,
                                      err_msg=name_)
    for r, rj in zip(res.reports, res_j.reports):
        assert r.rmse_before == pytest.approx(rj.rmse_before, rel=1e-4,
                                              abs=1e-6), r.conv
        assert r.rmse_after == pytest.approx(rj.rmse_after, rel=1e-4,
                                             abs=1e-6), r.conv
    shapes = _conv_shapes(res.graph, res.params)
    assert shapes == _conv_shapes(res_j.graph, res_j.params)
    assert _gates(res.graph) == _gates(res_j.graph)
    res.graph.validate()
    if name == "xception":
        shrunk = [n for n, (c_out, group, _) in shapes.items()
                  if group > 1 and c_out < int(g.layer(n).attr("num_output"))]
        assert shrunk and all(shapes[n][0] == shapes[n][1] for n in shrunk)
        assert _gates(res.graph)
    if name == "frcnn_rpn":
        # each RPN head selects its own inputs of the shared conv, behind a
        # Select gate of its own
        heads = ("rpn_cls_score", "rpn_bbox_pred")
        assert all(h in res.selections for h in heads)
        assert len(_gates(res.graph)) == 2
    outs, _ = run_graph(res.graph, params_to_torch(res.params, "cpu"),
                        {"data": torch.from_numpy(inputs[0])})
    if name == "xception":
        np.testing.assert_allclose(outs["prob"].sum(-1).numpy(), 1.0,
                                   rtol=1e-5)
    else:
        assert all(torch.isfinite(v).all() for v in outs.values())


@pytest.mark.parametrize("model,image_size,speed", [
    ("xception", 224, 2.0), ("frcnn_vgg16", 600, 5.0)])
def test_plan_uniform_targets_full_size(model, image_size, speed):
    """The planner on the full-size graphs of `cli prune --model xception
    --speed 2.0` and `--model frcnn_vgg16 --image-size 600 --speed 5.0`:
    the same targets and the same predicted conv-mult ratio as the JAX
    package (pure numpy on both sides)."""
    from channel_pruning_tpu.models.vgg import init_params as jax_init_params
    from channel_pruning_tpu.models.zoo import get_model as jax_get_model
    from channel_pruning_tpu_torch.models.vgg import init_params
    from channel_pruning_tpu_torch.models.zoo import get_model

    g0 = get_model(model, batch=10, image_size=image_size)
    g_j0 = jax_get_model(model, batch=10, image_size=image_size)
    # preprocess folds BN and splits ReLUs: the planner walks that graph
    g, _ = c3.preprocess(g0, init_params(g0, seed=0))
    g_j, _ = jax_c3.preprocess(g_j0, jax_init_params(g_j0, seed=0))
    got = c3.plan_uniform_targets(g, speed, rank_tol=0.1,
                                  with_prediction=True)
    want = jax_c3.plan_uniform_targets(g_j, speed, rank_tol=0.1,
                                       with_prediction=True)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[0]) == len(g.convs)
