"""The port's training and evaluation (train/finetune.py, train/evaluate.py,
train/checkpoint.py, the train mode of ops/forward.py, sampler.channel_stats)
against the JAX package's on the same numpy inputs and parameters, on the
CPU. Dropout is off (no generator / rng None): the two packages draw masks
from different generators.

Tolerances: gradients to 1e-4 of the largest entry per blob (the convs sum
in another order); after each of 5 SGD steps the losses to rtol 1e-5, and
after the 5 steps each blob's change to 1e-3 of its largest change (an
input-scale blob's gradient sums over every pixel, so rounding shows there
first); head losses rtol 1e-5; eval counts exact; channel statistics rtol
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channel_pruning_tpu.graph.rewrite import add_bn_after_convs as jax_add_bn
from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
from channel_pruning_tpu.models import faster_rcnn as jax_frcnn
from channel_pruning_tpu.models import vgg as jax_vgg
from channel_pruning_tpu.ops.forward import logits_fn as jax_logits_fn
from channel_pruning_tpu.ops.forward import to_device_params
from channel_pruning_tpu.sampling.sampler import channel_stats as jax_channel_stats
from channel_pruning_tpu.train import evaluate as jax_ev
from channel_pruning_tpu.train import finetune as jax_ft
from channel_pruning_tpu.utils.config import FinetuneConfig
from channel_pruning_tpu_torch.convert import GraphParams, params_to_torch
from channel_pruning_tpu_torch.graph.ir import Graph, Layer, LT, TensorSpec
from channel_pruning_tpu_torch.graph.rewrite import add_bn_after_convs, split_relu
from channel_pruning_tpu_torch.models import faster_rcnn, vgg
from channel_pruning_tpu_torch.ops.forward import logits_fn, run_graph
from channel_pruning_tpu_torch.sampling.sampler import channel_stats
from channel_pruning_tpu_torch.train import evaluate as ev
from channel_pruning_tpu_torch.train import finetune as ft
from channel_pruning_tpu_torch.train.checkpoint import Checkpointer
from torch_cpu import one_thread  # noqa: F401


def _models(name: str, batch: int = 4):
    """(port graph, JAX graph, numpy params) from the same seed."""
    if name == "tiny_vgg":
        g, p = vgg.build_tiny_vgg(batch=batch, image_size=16)
        g_j, _ = jax_vgg.build_tiny_vgg(batch=batch, image_size=16)
        return g, g_j, p
    g = vgg.build_digits_vgg(batch=batch, image_size=16)
    g_j = jax_vgg.build_digits_vgg(batch=batch, image_size=16)
    return g, g_j, vgg.init_params(g, seed=0)


def _batch(seed: int, n: int, size: int, scale: float = 1.0, classes: int = 10):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, scale, (n, 3, size, size))).astype(np.float32)
    return x, rng.integers(0, classes, (n,)).astype(np.int32)


def _addbn_pair(g, g_j, params, x):
    """Both packages' addbn graphs from the port's statistics on x."""
    g, g_j = split_relu(g), jax_split_relu(g_j)
    tops = {c: g.layer(c).tops[0] for c in g.convs}
    by_top = channel_stats(g, params_to_torch(params, "cpu"), x[None],
                           tuple(tops.values()), device="cpu")
    stats = {c: by_top[t] for c, t in tops.items()}
    g2, p2 = add_bn_after_convs(g, params, stats)
    g2_j, _ = jax_add_bn(g_j, params, stats)
    return g2, g2_j, p2


def test_gradients_match_jax_grad():
    g, g_j, params = _models("tiny_vgg")
    x, y = _batch(0, 4, 16)
    model = GraphParams(params, "cpu")
    logits = logits_fn(g)(model.as_dict(), torch.from_numpy(x), train=True)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()

    fn_j = jax_logits_fn(g_j)

    def loss_j(p):
        import optax
        return optax.softmax_cross_entropy_with_integer_labels(
            fn_j(p, jnp.asarray(x), train=True), jnp.asarray(y)).mean()

    grads_j = jax.grad(loss_j)(to_device_params(params))
    for layer, blobs in grads_j.items():
        for k, gj in blobs.items():
            gj = np.asarray(gj)
            got = model.layer(layer)[k].grad.numpy()
            np.testing.assert_allclose(got, gj, rtol=0,
                                       atol=1e-4 * np.abs(gj).max() + 1e-9,
                                       err_msg=f"{layer}.{k}")


SETTINGS = {
    "plain": {},
    # the clip fires (the global norm is well above 0.5 here), decay is on
    # and the lr drops twice inside the 5 steps (counts 2 and 4)
    "clip_decay_lr_step": dict(clip_gradients=0.5, weight_decay=5e-3,
                               stepsize=2, gamma=0.5),
}
LR = {"tiny_vgg": 1e-2, "digits_vgg": 1e-3}


@pytest.mark.parametrize("setting", ["plain", "clip_decay_lr_step", "addbn"])
@pytest.mark.parametrize("name", ["tiny_vgg", "digits_vgg"])
def test_five_train_steps_match_jax(name, setting):
    g, g_j, params = _models(name)
    scale = 1.0 if name == "tiny_vgg" else 60.0   # digits_vgg scales by 1/128
    batches = [_batch(10 + i, 4, 16, scale) for i in range(5)]
    if setting == "addbn":
        g, g_j, params = _addbn_pair(g, g_j, params, batches[0][0])
        cfg = FinetuneConfig(base_lr=LR[name], clip_gradients=35.0)
    else:
        cfg = FinetuneConfig(base_lr=LR[name], **SETTINGS[setting])

    state = ft.init_state(g, params, cfg, device="cpu")
    step = ft.build_train_step(g, cfg)
    state_j = jax_ft.init_state(g_j, params, cfg)
    step_j = jax_ft.build_train_step(g_j, cfg, donate=False)
    for x, y in batches:
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        state_j, m_j = step_j(state_j, jnp.asarray(x), jnp.asarray(y), None)
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
        assert float(m["top1"]) == float(m_j["top1"])
        assert float(m["top5"]) == float(m_j["top5"])
    got = state.model.to_numpy()
    for layer, blobs in state_j.params.items():
        for k, v in blobs.items():
            moved = np.asarray(v) - params[layer][k]
            np.testing.assert_allclose(got[layer][k] - params[layer][k], moved,
                                       rtol=0, atol=1e-3 * np.abs(moved).max(),
                                       err_msg=f"{layer}.{k}")
    if setting == "addbn":
        bns = [l.name for l in g.by_type(LT.BN)]
        assert bns
        for bn in bns:          # frozen in both
            for k in ("mean", "var", "factor"):
                np.testing.assert_array_equal(got[bn][k], params[bn][k])


def test_clip_and_schedule_are_optax_s():
    """The hand-written clip (t / norm * max, no epsilon) and the step
    schedule, on their own."""
    import optax

    rng = np.random.default_rng(3)
    grads = [rng.normal(0, 3, (4, 5)).astype(np.float32),
             rng.normal(0, 3, (7,)).astype(np.float32)]
    for max_norm in (0.5, 1e3):
        t = [torch.from_numpy(g.copy()) for g in grads]
        ft._clip_by_global_norm(t, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        for a, b in zip(t, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    cfg = FinetuneConfig(base_lr=0.1, stepsize=3, gamma=0.5)
    assert [ft.lr_at(cfg, c) for c in range(7)] == \
        [0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.025]


def _head_pair(kind: str, classes: int = 0):
    return (ft.HeadSpec("t", kind=kind, classes=classes),
            jax_ft.HeadSpec("t", kind=kind, classes=classes))


@pytest.mark.parametrize("kind,classes,shape", [
    ("softmax_ce", 0, (6, 10)),
    ("softmax_distill", 0, (6, 10)),
    ("softmax_distill", 2, (2, 6, 4, 4)),      # the RPN anchor fold
    ("smooth_l1", 0, (2, 12, 4, 4)),
])
def test_head_loss_matches_jax(kind, classes, shape):
    rng = np.random.default_rng(1)
    pred = (rng.normal(0, 1.5, shape)).astype(np.float32)
    target = (rng.integers(0, shape[1], shape[0]).astype(np.int32)
              if kind == "softmax_ce" else
              rng.normal(0, 1.5, shape).astype(np.float32))
    spec, spec_j = _head_pair(kind, classes)
    loss, agree = ft.head_loss(spec, torch.from_numpy(pred), torch.from_numpy(target))
    loss_j, agree_j = jax_ft.head_loss(spec_j, jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(agree), float(agree_j), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown head kind"):
        ft.head_loss(ft.HeadSpec("t", kind="l2"), torch.zeros(2), torch.zeros(2))


def _frcnn():
    g, params = faster_rcnn.build_tiny_frcnn(batch=4, image_size=32)
    g_j, _ = jax_frcnn.build_tiny_frcnn(batch=4, image_size=32)
    return split_relu(g), jax_split_relu(g_j), params


def test_multihead_distillation_on_tiny_frcnn_matches_jax():
    """Three distillation steps of perturbed weights against the frozen
    original (RPN 2-way softmax + SmoothL1), clip 35."""
    g, g_j, params = _frcnn()
    heads, heads_j = faster_rcnn.frcnn_heads(g), jax_frcnn.frcnn_heads(g_j)
    assert [h.tensor for h in ft.distill_heads(g)] == [h.tensor for h in heads]
    rng = np.random.default_rng(1)
    noisy = {k: {b: (v + rng.normal(0, 0.05, v.shape).astype(v.dtype)
                     if b == "W" else v) for b, v in blobs.items()}
             for k, blobs in params.items()}
    teacher = ft.make_teacher_fn(g, params, heads, device="cpu")
    teacher_j = jax_ft.make_teacher_fn(g_j, params, heads_j)
    cfg = FinetuneConfig(base_lr=1e-2, clip_gradients=35.0)
    state = ft.init_state(g, noisy, cfg, device="cpu")
    step = ft.build_train_step(g, cfg, heads=heads)
    state_j = jax_ft.init_state(g_j, noisy, cfg)
    step_j = jax_ft.build_train_step(g_j, cfg, donate=False, heads=heads_j)
    for i in range(3):
        x = rng.normal(0, 1, (4, 3, 32, 32)).astype(np.float32)
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        state, m = step(state, xt, teacher(xt))
        state_j, m_j = step_j(state_j, xj, teacher_j(xj), None)
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    batches = [rng.normal(0, 1, (4, 3, 32, 32)).astype(np.float32) for _ in range(2)]
    got = ev.evaluate_heads(g, state.model.to_numpy(), teacher, heads,
                            iter(batches), device="cpu")
    want = jax_ev.evaluate_heads(
        g_j, jax.tree_util.tree_map(np.asarray, state_j.params), teacher_j,
        heads_j, iter(batches))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def _dropout_graph(n_drop: int = 2):
    layers = tuple(Layer.make(f"drop{i}", LT.DROPOUT, ["data"], [f"d{i}"],
                              dropout_ratio=0.3) for i in range(n_drop))
    return Graph("d", (TensorSpec("data", (64, 8, 16, 16)),), layers)


def test_dropout_keep_share_salts_and_seed():
    g = _dropout_graph()
    x = torch.ones((64, 8, 16, 16))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return run_graph(g, {}, {"data": x}, train=True, generator=gen)[0]

    a, b, c = run(7), run(7), run(8)
    for t in ("d0", "d1"):
        kept = a[t] != 0
        # keep probability 0.7 over 131k draws; kept values scaled by 1/0.7
        assert abs(float(kept.float().mean()) - 0.7) < 0.01
        np.testing.assert_allclose(a[t][kept].numpy(), 1 / 0.7, rtol=1e-6)
        assert torch.equal(a[t], b[t])               # reproducible from the seed
        assert not torch.equal(a[t], c[t])
    assert not torch.equal(a["d0"] != 0, a["d1"] != 0)   # per-layer salts
    # identity without a generator, and out of train mode
    for kw in ({"train": True}, {"train": False,
                                 "generator": torch.Generator().manual_seed(7)}):
        out = run_graph(g, {}, {"data": x}, **kw)[0]
        assert torch.equal(out["d0"], x)


def test_gradients_only_in_train_mode():
    g, _, params = _models("tiny_vgg")
    model = GraphParams(params, "cpu")
    x = torch.from_numpy(_batch(0, 4, 16)[0])
    out = run_graph(g, model.as_dict(), {"data": x})[0]["prob"]
    assert not out.requires_grad
    out = run_graph(g, model.as_dict(), {"data": x}, train=True)[0]["prob"]
    assert out.requires_grad


def test_evaluate_counts_equal_jax():
    g, g_j, params = _models("tiny_vgg", batch=6)
    batches = [_batch(20 + i, 6, 16) for i in range(4)]
    got = ev.evaluate(g, params, iter(batches), device="cpu", max_batches=3)
    want = jax_ev.evaluate(g_j, params, iter(batches), max_batches=3)
    assert got == want and got["n_images"] == 18


def test_evaluate_cache_needs_labels():
    from channel_pruning_tpu_torch.sampling.sampler import FrozenCache

    g, g_j, params = _models("tiny_vgg", batch=6)
    x = np.stack([_batch(30 + i, 6, 16)[0] for i in range(2)])
    y = np.stack([_batch(30 + i, 6, 16)[1] for i in range(2)])
    got = ev.evaluate_cache(g, params, FrozenCache(x, {}, {}, y), device="cpu")
    assert got == jax_ev.evaluate(g_j, params, zip(x, y))
    with pytest.raises(ValueError, match="no labels"):
        ev.evaluate_cache(g, params, FrozenCache(x, {}, {}), device="cpu")


def test_finetune_loop_and_checkpoint_round_trip(tmp_path):
    g, _, params = _models("tiny_vgg")
    cfg = FinetuneConfig(base_lr=1e-2, snapshot_every=2)
    data = ft.synthetic_batches(4, image=16, classes=10, seed=1)
    state = ft.finetune(g, params, data, cfg, device="cpu", max_steps=4,
                        snapshot_dir=str(tmp_path), log_every=2)
    assert state.step == 4 and len(state.history) == 4
    assert len(ft.step_ms(state)) == 3
    ck = Checkpointer(tmp_path)
    assert ck.steps() == [2, 4]
    snap = ck.latest()
    assert snap["step"] == 4
    for layer, blobs in state.model.as_dict().items():
        for k, v in blobs.items():
            assert torch.equal(snap["params"][layer][k], v.detach())
    # the optimizer's momentum resumes
    opt = ft.make_optimizer(cfg, GraphParams(snap["params"], "cpu"))
    opt.load_state_dict(snap["opt_state"])
    assert len(opt.state) == len(state.optimizer.state)
    assert Checkpointer(tmp_path / "empty").latest() is None


def test_synthetic_batches_equal_jax():
    a = ft.synthetic_batches(3, image=8, classes=7, seed=4)
    b = jax_ft.synthetic_batches(3, image=8, classes=7, seed=4)
    for _ in range(2):
        (x, y), (xj, yj) = next(a), next(b)
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)


def test_channel_stats_and_addbn_match_jax():
    g, g_j, params = _models("tiny_vgg")
    g, g_j = split_relu(g), jax_split_relu(g_j)
    inputs = np.random.default_rng(5).normal(0, 1, (6, 4, 3, 16, 16)).astype(np.float32)
    tops = tuple(g.layer(c).tops[0] for c in g.convs)
    got = channel_stats(g, params_to_torch(params, "cpu"), inputs, tops,
                        device="cpu", chunk_batches=4)
    want = jax_channel_stats(g_j, to_device_params(params), inputs, tops,
                             chunk_batches=4)
    for t in tops:
        for a, b in zip(got[t], want[t]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=t)
    stats = {c: want[g.layer(c).tops[0]] for c in g.convs}
    g2, p2 = add_bn_after_convs(g, params, stats)
    g2_j, p2_j = jax_add_bn(g_j, params, stats)
    assert [(l.name, l.type, l.bottoms, l.tops, l.attrs) for l in g2.layers] == \
        [(l.name, l.type, l.bottoms, l.tops, l.attrs) for l in g2_j.layers]
    for layer in p2_j:
        for k in p2_j[layer]:
            np.testing.assert_array_equal(p2[layer][k], p2_j[layer][k])
    # the BN graph computes the original function
    x = torch.from_numpy(inputs[0])
    before = run_graph(g, params_to_torch(params, "cpu"), {"data": x})[0]["prob"]
    after = run_graph(g2, params_to_torch(p2, "cpu"), {"data": x})[0]["prob"]
    np.testing.assert_allclose(after.numpy(), before.numpy(), atol=1e-5)


def test_compute_dtype_runs_convs_in_bf16():
    g, g_j, params = _models("tiny_vgg")
    x = _batch(0, 4, 16)[0]
    dev = params_to_torch(params, "cpu")
    f32 = run_graph(g, dev, {"data": torch.from_numpy(x)})[0]["prob"]
    bf = run_graph(g, dev, {"data": torch.from_numpy(x)},
                   compute_dtype="bfloat16")[0]["prob"]
    assert bf.dtype == torch.float32 and not torch.equal(bf, f32)
    from channel_pruning_tpu.ops.forward import run_graph as jax_run_graph
    want = jax_run_graph(g_j, to_device_params(params), {"data": jnp.asarray(x)},
                         compute_dtype=jnp.bfloat16)[0]["prob"]
    # the JAX conv's semantics (bf16 operands, f32 products, sums and
    # outputs): only summation order separates the two
    want = np.asarray(want)
    np.testing.assert_allclose(bf.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """utils/profiling.device_trace around a forward: a Chrome trace whose
    events name the forward's convolutions."""
    import json

    from channel_pruning_tpu_torch.utils.profiling import device_trace

    g, _, params = _models("tiny_vgg")
    x = torch.from_numpy(_batch(0, 4, 16)[0])
    with device_trace(str(tmp_path / "trace")) as prof:
        run_graph(g, params_to_torch(params, "cpu"), {"data": x})
    assert any("conv" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
