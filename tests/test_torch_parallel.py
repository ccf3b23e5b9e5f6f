"""The port's mesh (parallel/mesh, parallel/sharded) on the CPU: a logical
mesh of 8 shards on one device against the port's one-device runs, and the
port's 8-shard prune and 3C against the JAX package's 8-device mesh runs
(tests/conftest.py's virtual devices) on the same numpy inputs. Each case
cites the tolerance of the JAX package's own mesh test it mirrors
(tests/test_parallel.py); a case without one holds bit equality."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph.rewrite import split_relu
from channel_pruning_tpu_torch.models.resnet import build_tiny_resnet
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
from channel_pruning_tpu_torch.ops import lasso, lstsq
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.parallel import sharded
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.pipeline import prune as prune_mod
from channel_pruning_tpu_torch.sampling import rolling, sampler
from channel_pruning_tpu_torch.train import evaluate, finetune
from channel_pruning_tpu_torch.utils.config import FinetuneConfig, default_config
from torch_cpu import one_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_mesh(8, device="cpu")


def test_mesh_api():
    m = mesh_mod.make_mesh(4, device="cpu")
    assert m.size == 4 and m.lead == CPU and m.distinct == (CPU,)
    assert mesh_mod.shard_bounds(10, m) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert mesh_mod.shard_bounds(2, m) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    x = torch.arange(10.0)[:, None]
    parts = mesh_mod.shard_rows(x, m)
    assert [p.shape[0] for p in parts] == [3, 3, 3, 3]
    assert torch.equal(parts[3], torch.tensor([[9.0], [0.0], [0.0]]))
    assert torch.equal(mesh_mod.gather_rows(parts, m, 10), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device="):
            mesh_mod.make_mesh()
    from channel_pruning_tpu_torch import cli
    assert cli._solver_mesh(CPU) is None     # the CLI meshes cards only


def test_reduce_sum_is_the_serial_sum_in_shard_order(rng, mesh):
    """The shard-order reduction equals a serial left-to-right sum bit for
    bit (a fixed order: the result does not depend on timing)."""
    parts = [torch.as_tensor(rng.normal(size=(7, 5)).astype(np.float32))
             for _ in range(mesh.size)]
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    assert torch.equal(mesh_mod.reduce_sum(parts, mesh), want)


def test_sharded_lasso_gram_matches_local(rng, mesh):
    """tests/test_parallel.py::test_sharded_lasso_gram_matches_local: rtol
    1e-4, atol 1e-3; 203 rows, deliberately not a multiple of 8."""
    Z = torch.as_tensor(rng.normal(size=(203, 24)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=203).astype(np.float32))
    g_local = lasso.lasso_gram(Z, y)
    g_shard = sharded.sharded_lasso_gram(Z, y, mesh)
    assert g_shard.n_samples == 203
    assert torch.equal(g_shard.G, g_shard.G.T)
    np.testing.assert_allclose(g_shard.G.numpy(), g_local.G.numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g_shard.b.numpy(), g_local.b.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_sharded_group_gram_matches_local(rng, mesh):
    """The group-lasso Gram, at the lasso Gram's tolerance."""
    X = torch.as_tensor(rng.normal(size=(203, 24)).astype(np.float32))
    Y = torch.as_tensor(rng.normal(size=(203, 5)).astype(np.float32))
    got = sharded.sharded_group_gram(X, Y, mesh)
    want = lasso.group_gram(X, Y)
    assert got.n_samples == 203
    np.testing.assert_allclose(got.G.numpy(), want.G.numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got.C.numpy(), want.C.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_sharded_lstsq_matches_local(rng, mesh):
    """tests/test_parallel.py::test_sharded_lstsq_matches_local: W rtol
    1e-3 atol 1e-4, b rtol 1e-3 atol 1e-3; 317 rows (padded on 8 shards),
    columns with a mean far from 0, where raw moments would lose digits."""
    X = torch.as_tensor((rng.normal(size=(317, 20)) + 30.0).astype(np.float32))
    Y = torch.as_tensor(rng.normal(size=(317, 6)).astype(np.float32))
    W_s, b_s = sharded.sharded_lstsq(X, Y, mesh)
    W_l, b_l = lstsq.fit_linear(X, Y)
    np.testing.assert_allclose(W_s.numpy(), W_l.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(b_s.numpy(), b_l.numpy(), rtol=1e-3, atol=1e-3)


def test_data_parallel_forward_matches_one_device(rng, mesh):
    from channel_pruning_tpu_torch.ops.forward import run_graph

    g, p = build_tiny_vgg(batch=4, image_size=16)
    dev = params_to_torch(p, "cpu")
    x = torch.as_tensor(rng.normal(size=(12, 3, 16, 16)).astype(np.float32))
    fn = sharded.data_parallel_forward(g, ("conv2_1", "fc8"), mesh)
    got = fn(mesh_mod.replicate(dev, mesh), x)
    _, want = run_graph(g, dev, {g.inputs[0].name: x},
                        capture=("conv2_1", "fc8"))
    # 12 images: 2 a shard, 2 shards of padding only; the convs' outputs
    # are bit-identical, the FC's matmul blocks its rows by their count on
    # the CPU (a gap of 1.2e-6 measured, values ~2): rtol and atol 1e-5
    assert torch.equal(got["conv2_1"], want["conv2_1"])
    torch.testing.assert_close(got["fc8"], want["fc8"], rtol=1e-5, atol=1e-5)


def _tiny_vgg(batch, n_batches, seed, image=16):
    g, params = build_tiny_vgg(batch=batch, image_size=image)
    g = split_relu(g)
    inputs = np.random.default_rng(seed).normal(
        0, 1, (n_batches, batch, 3, image, image)).astype(np.float32)
    return g, params, params_to_torch(params, "cpu"), inputs


def test_sharded_freeze_matches_single_device(mesh):
    """tests/test_parallel.py::test_sharded_freeze_matches_single_device:
    the frozen features bit-identical (4 images a shard)."""
    g, _, dev, inputs = _tiny_vgg(4, 8, 3)
    c_single = sampler.freeze(g, dev, inputs, device=CPU, n_points=5, seed=0,
                              chunk_batches=8)
    c_mesh = sampler.freeze(g, dev, inputs, device=CPU, n_points=5, seed=0,
                            chunk_batches=8, mesh=mesh)
    assert c_single.feats.keys() == c_mesh.feats.keys()
    for t in c_single.feats:
        np.testing.assert_array_equal(c_single.feats[t], c_mesh.feats[t]), t


def test_mesh_sample_patches_and_dense_match_single_device(mesh):
    """tests/test_parallel.py::test_mesh_sample_patches_matches_single_device:
    identical patch rows from the full replay; and the dense capture."""
    g, _, dev, inputs = _tiny_vgg(4, 8, 23)
    cache = sampler.freeze(g, dev, inputs, device=CPU, n_points=4, seed=0,
                           chunk_batches=8)
    conv = list(g.convs)[2]
    X_solo = sampler.sample_patches(g, dev, inputs, conv, cache.plan,
                                    device=CPU, chunk_batches=8)
    X_mesh = sampler.sample_patches(g, dev, inputs, conv, cache.plan,
                                    device=CPU, chunk_batches=8, mesh=mesh)
    assert torch.equal(X_solo, X_mesh)
    d_solo = sampler.sample_dense(g, dev, inputs, ("pool3",), device=CPU,
                                  chunk_batches=4)
    d_mesh = sampler.sample_dense(g, dev, inputs, ("pool3",), device=CPU,
                                  chunk_batches=4, mesh=mesh)
    assert torch.equal(d_solo["pool3"], d_mesh["pool3"])


# (batch, tolerance): 3 batches of 2 images are the JAX test's shape and
# put one image on each shard; the CPU's convolution takes another path for
# a one-image batch (a gap of ~2e-6 measured at |x| ~ 1, summation order),
# so that case holds rows to 1e-5 of the largest value; with 4 images a
# batch every shard holds 2 and the rows are bit-identical
@pytest.mark.parametrize("batch,tol", [(2, 1e-5), (4, 0.0)])
def test_mesh_rolling_frontier_matches_single_device(mesh, batch, tol):
    """tests/test_parallel.py::test_mesh_rolling_frontier_matches_single_
    device: the chain frontier's patches and features, the group padded to
    a shard multiple."""
    g, _, dev, inputs = _tiny_vgg(batch, 3, 21)
    cache = sampler.freeze(g, dev, inputs, device=CPU, n_points=4, seed=0,
                           chunk_batches=3)
    r_solo = rolling.RollingReplay(g, inputs, device=CPU, plan=cache.plan)
    r_mesh = rolling.RollingReplay(g, inputs, device=CPU, plan=cache.plan,
                                   mesh=mesh)
    assert r_mesh._g.per * mesh.size >= 3 * batch
    for conv in list(g.convs)[1:4]:
        bottom = g.layer(conv).bottoms[0]
        r_solo.advance_to(dev, bottom)
        r_mesh.advance_to(dev, bottom)
        pairs = [(r_solo.patches_at(cache.plan, conv),
                  r_mesh.patches_at(cache.plan, conv))]
        top = g.layer(conv).tops[0]
        pairs.append((torch.as_tensor(r_solo.features_at(dev, cache.plan, top)),
                      torch.as_tensor(r_mesh.features_at(dev, cache.plan, top))))
        for a, b in pairs:
            assert a.shape == b.shape
            gap = float((a - b).abs().max())
            assert gap <= tol * float(a.abs().max()), (conv, gap)


def test_mesh_rolling_dag_matches_single_device(mesh):
    """tests/test_parallel.py::test_mesh_rolling_dag_matches_single_device:
    the DAG frontier's patches and live features, bit-identical."""
    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    inputs = np.random.default_rng(22).normal(0, 1, (3, 4, 3, 32, 32)) \
        .astype(np.float32)
    dev = params_to_torch(p, "cpu")
    cache = sampler.freeze(g, dev, inputs, device=CPU, n_points=3, seed=0,
                           chunk_batches=3,
                           share_key=sampler.resnet_share_key(g))
    r_solo = rolling.RollingReplayDAG(g, inputs, device=CPU, plan=cache.plan)
    r_mesh = rolling.RollingReplayDAG(g, inputs, device=CPU, plan=cache.plan,
                                      mesh=mesh)
    checked = 0
    for conv in list(g.convs)[1:8]:
        bottom = g.layer(conv).bottoms[0]
        r_solo.advance_to(dev, bottom)
        r_mesh.advance_to(dev, bottom)
        assert torch.equal(r_solo.patches_at(cache.plan, conv),
                           r_mesh.patches_at(cache.plan, conv)), conv
        for t in [t for t in r_solo.state if t in cache.plan] + \
                [g.layer(conv).tops[0]]:
            assert torch.equal(
                r_solo.features_at(dev, cache.plan, t, device=True),
                r_mesh.features_at(dev, cache.plan, t, device=True)), (conv, t)
            checked += 1
    assert checked > 7


def test_frontier_budget_scales_with_distinct_devices():
    """A logical mesh on one device keeps one device's budget: 8 shards on
    the CPU must not get 8 x the frontier's memory; two distinct devices
    (cpu and cpu:0 count as two) get twice it."""
    g, _, _, inputs = _tiny_vgg(4, 8, 3)
    cache = sampler.FrozenCache(inputs=inputs, plan={}, feats={})
    need = rolling.estimate_peak_bytes(g, 32)
    logical = mesh_mod.make_mesh(8, device="cpu")
    assert c3._maybe_rolling(g, cache, CPU, budget=need - 1,
                             mesh=logical) is None
    assert c3._maybe_rolling(g, cache, CPU, budget=need,
                             mesh=logical) is not None
    two = mesh_mod.Mesh((CPU, torch.device("cpu", 0)))
    assert len(two.distinct) == 2
    assert c3._maybe_rolling(g, cache, CPU, budget=need // 2 + 1,
                             mesh=two) is not None


def _spy_pipelined(monkeypatch):
    """Record the mesh each pipelined pass was given (tests/test_parallel.py
    :85-106: a silent fall back to the sequential path would pass the mask
    asserts too)."""
    seen = []
    orig = c3._pipelined_conv_pass

    def spy(*args, **kwargs):
        seen.append(kwargs.get("mesh"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(c3, "_pipelined_conv_pass", spy)
    return seen


@pytest.fixture(scope="module")
def vgg_case():
    """tests/test_parallel.py::test_solve_prune_on_mesh_matches_single_device's
    inputs: 4 batches of 4 images, 6 points, targets 2/3 of each conv."""
    g, params, dev, inputs = _tiny_vgg(4, 4, 11)
    cache = sampler.freeze(g, dev, inputs, device=CPU, n_points=6, seed=0,
                           chunk_batches=2)
    targets = {c: max(2, int(g.layer(c).attr("num_output")) * 2 // 3)
               for c in list(g.convs)[:-1]}
    return g, params, inputs, cache, targets


@pytest.mark.parametrize("fused", [True, False])
def test_solve_prune_on_mesh_matches_single_device(mesh, vgg_case, fused,
                                                   monkeypatch):
    """Masks exact on the pipelined pass (taken under the mesh: spied) and
    on the sequential path; reconstructions at the JAX test's rtol 5e-2,
    atol 2e-2 (reduction order)."""
    g, params, _, cache, targets = vgg_case
    cfg = default_config().replace_nested("solve.fused_search", fused)
    seen = _spy_pipelined(monkeypatch)
    res_mesh = c3.solve_prune(g, params, cache, cfg, channel_targets=targets,
                              device=CPU, mesh=mesh, verbose=False)
    res_solo = c3.solve_prune(g, params, cache, cfg, channel_targets=targets,
                              device=CPU, verbose=False)
    assert res_mesh.pipelined == res_solo.pipelined == fused
    if fused:
        assert seen[0] is mesh and seen[1] is None
    assert res_mesh.selections.keys() == res_solo.selections.keys()
    for k in res_solo.selections:
        np.testing.assert_array_equal(res_mesh.selections[k],
                                      res_solo.selections[k]), k
    for k in res_solo.params:
        for kk, v in res_solo.params[k].items():
            np.testing.assert_allclose(np.asarray(res_mesh.params[k][kk]),
                                       np.asarray(v), rtol=5e-2, atol=2e-2)


def test_solve_prune_resnet_on_mesh_matches_single_device(mesh, monkeypatch):
    """The DAG-pipelined pass (Select gates, residual compensation) under
    the mesh: taken, and the masks exact."""
    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    inputs = np.random.default_rng(11).normal(0, 1, (8, 4, 3, 32, 32)) \
        .astype(np.float32)
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device=CPU,
                           n_points=8, seed=0, chunk_batches=4,
                           share_key=sampler.resnet_share_key(g))
    ct = {c: max(2, int(int(g.layer(c).attr("num_output")) * 0.7))
          for c in g.convs if c.endswith(("branch2a", "branch2b"))}
    it = {c: max(2, int(p[c]["W"].shape[1] * 0.7))
          for c in g.convs if c.endswith("branch2a")}
    cfg = default_config().replace_nested("solve.band", "bottom")
    seen = _spy_pipelined(monkeypatch)
    res_mesh = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                              input_targets=it, device=CPU, mesh=mesh,
                              verbose=False)
    res_solo = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                              input_targets=it, device=CPU, verbose=False)
    assert seen[0] is mesh and res_mesh.pipelined and res_solo.pipelined
    assert res_mesh.selections.keys() == res_solo.selections.keys()
    for k in res_solo.selections:
        np.testing.assert_array_equal(res_mesh.selections[k],
                                      res_solo.selections[k]), k


@pytest.fixture(scope="module")
def c3_case():
    """tests/test_parallel.py::test_solve_3c_on_mesh_matches_single_device's
    inputs: 8 batches of 4 images, 6 points, three ranked layers."""
    g, params, dev, inputs = _tiny_vgg(4, 8, 13)
    cache = sampler.freeze(g, dev, inputs, device=CPU, n_points=6, seed=0,
                           chunk_batches=4)
    return g, params, inputs, cache, {"conv1_2": 6, "conv2_1": 8, "conv2_2": 9}


def test_solve_3c_on_mesh_matches_single_device(mesh, c3_case):
    """Masks exact; the VH-only and final rMSEs at the JAX test's rtol
    1e-4, atol 1e-6 (reduction order, amplified by the ALS loops: ~5e-5
    at the last arm measured)."""
    g, params, _, cache, ranks = c3_case
    cfg = default_config()
    r_mesh = c3.solve_3c(g, params, cache, cfg, ranks, device=CPU, mesh=mesh,
                         verbose=False)
    r_solo = c3.solve_3c(g, params, cache, cfg, ranks, device=CPU,
                         verbose=False)
    assert not r_mesh.itq_degraded and not r_mesh.undecomposed
    assert r_mesh.selections.keys() == r_solo.selections.keys()
    for k in r_solo.selections:
        np.testing.assert_array_equal(r_mesh.selections[k],
                                      r_solo.selections[k]), k
    solo = {(r.conv, r.rank): r for r in r_solo.reports}
    for r in r_mesh.reports:
        s = solo[(r.conv, r.rank)]
        np.testing.assert_allclose(r.rmse_before, s.rmse_before, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(r.rmse_after, s.rmse_after, rtol=1e-4,
                                   atol=1e-6)
    r_mesh.graph.validate()


@pytest.mark.parametrize("fused", [True, False])
def test_select_and_reconstruct_on_mesh(rng, mesh, fused):
    """One layer: the same mask, alpha and rMSEs as one device (rtol 1e-4)."""
    X = torch.as_tensor(rng.normal(size=(400, 12, 3, 3)).astype(np.float32))
    W2 = rng.normal(size=(10, 12, 3, 3)).astype(np.float32)
    Y = torch.einsum("nchw,ochw->no", X, torch.as_tensor(W2)) + \
        torch.as_tensor(rng.normal(0, 0.1, (400, 10)).astype(np.float32))
    kw = dict(fused=fused, subsample=200)
    solo = prune_mod.select_and_reconstruct(X, W2, Y, 6, **kw)
    on = prune_mod.select_and_reconstruct(X, W2, Y, 6, mesh=mesh, **kw)
    np.testing.assert_array_equal(on.keep, solo.keep)
    assert on.alpha == pytest.approx(solo.alpha, rel=1e-4)
    np.testing.assert_allclose([on.rmse_before, on.rmse_after],
                               [solo.rmse_before, solo.rmse_after], rtol=1e-4)
    np.testing.assert_allclose(on.W, solo.W, rtol=1e-3, atol=1e-4)


def test_select_channels_group_on_mesh(rng, mesh):
    """The group lasso's Gram row-sharded: the same selection."""
    X = torch.as_tensor(rng.normal(size=(600, 16)).astype(np.float32))
    B = np.zeros((16, 5), np.float32)
    B[[1, 4, 6, 9, 13]] = rng.normal(size=(5, 5))
    Y = X @ torch.as_tensor(B) + torch.as_tensor(
        rng.normal(0, 0.05, (600, 5)).astype(np.float32))
    solo = lasso.select_channels_group(X, Y, 5, subsample=300)
    on = lasso.select_channels_group(X, Y, 5, subsample=300, mesh=mesh)
    np.testing.assert_array_equal(on[0], solo[0])
    assert on[2] == solo[2]


def test_dp_train_step_runs_and_learns(mesh):
    """tests/test_parallel.py::test_dp_train_step_runs_and_learns."""
    g, params = build_tiny_vgg(batch=8, image_size=16)
    cfg = FinetuneConfig(base_lr=1e-2, max_iter=10, snapshot_every=10**9)
    state = finetune.init_state(g, params, cfg, device=CPU, mesh=mesh)
    step = finetune.build_train_step(g, cfg, mesh=mesh)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 1, (16, 3, 16, 16)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 16).astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        state, m = step(state, x, y, gen)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 8


def test_dp_grads_match_single_device(mesh):
    """tests/test_parallel.py::test_dp_grads_match_single_device: loss rtol
    1e-5, weights rtol 1e-4 atol 1e-6, over three steps with dropout (one
    seed a step, each shard slicing the whole batch's mask)."""
    g, params = build_tiny_vgg(batch=8, image_size=16)
    cfg = FinetuneConfig(base_lr=1e-2)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(0, 1, (16, 3, 16, 16)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 16).astype(np.int32))
    s_mesh = finetune.init_state(g, params, cfg, device=CPU, mesh=mesh)
    s_solo = finetune.init_state(g, params, cfg, device=CPU)
    step_mesh = finetune.build_train_step(g, cfg, mesh=mesh)
    step_solo = finetune.build_train_step(g, cfg)
    g_mesh, g_solo = (torch.Generator().manual_seed(3) for _ in range(2))
    for _ in range(3):
        s_mesh, m1 = step_mesh(s_mesh, x, y, g_mesh)
        s_solo, m2 = step_solo(s_solo, x, y, g_solo)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-5)
    for layer in ("conv1_1", "fc6", "fc8"):
        np.testing.assert_allclose(
            s_mesh.params[layer]["W"].detach().numpy(),
            s_solo.params[layer]["W"].detach().numpy(), rtol=1e-4, atol=1e-6)


def test_finetune_loop_on_mesh(tmp_path, mesh):
    """`finetune(mesh=)` over numpy batches: the one-device loop's losses
    (rtol 1e-5) and a snapshot at its step."""
    g, params = build_tiny_vgg(batch=8, image_size=16)
    cfg = FinetuneConfig(base_lr=1e-2, snapshot_every=3)
    runs = []
    for m in (None, mesh):
        data = finetune.synthetic_batches(8, image=16, classes=10, seed=0)
        st = finetune.finetune(g, params, data, cfg, device=CPU, max_steps=3,
                               snapshot_dir=str(tmp_path / str(m is None)),
                               log_every=0, mesh=m)
        runs.append([float(h["loss"]) for h in st.history])
        assert st.step == 3
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)


def test_evaluate_counts(mesh):
    """tests/test_parallel.py::test_evaluate_counts, and the counts equal
    the one-device run's."""
    g, params = build_tiny_vgg(batch=8, image_size=16)

    def batches():
        rng = np.random.default_rng(2)
        for _ in range(3):
            yield (rng.normal(0, 1, (16, 3, 16, 16)).astype(np.float32),
                   rng.integers(0, 10, 16).astype(np.int32))

    res = evaluate.evaluate(g, params, batches(), device=CPU, mesh=mesh)
    assert res["n_images"] == 48
    assert 0.0 <= res["accuracy@1"] <= res["accuracy@5"] <= 1.0
    assert res == evaluate.evaluate(g, params, batches(), device=CPU)


def test_evaluate_cache_on_mesh(mesh):
    """tests/test_parallel.py::test_evaluate_cache_replay under the mesh."""
    g, params = build_tiny_vgg(batch=4, image_size=16)
    rng = np.random.default_rng(5)
    inputs = rng.normal(0, 1, (3, 4, 3, 16, 16)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 4)).astype(np.int32)
    cache = sampler.freeze(g, params_to_torch(params, "cpu"), inputs,
                           device=CPU, n_points=2, chunk_batches=3,
                           labels=labels, mesh=mesh)
    res = evaluate.evaluate_cache(g, params, cache, device=CPU, mesh=mesh)
    assert res["n_images"] == 12
    assert res == evaluate.evaluate_cache(g, params, cache, device=CPU)


# ---------------------------------------------------------------------------
# the port's 8-shard mesh against the JAX package's 8-device mesh
# ---------------------------------------------------------------------------

def _jax_mesh_and_cache(inputs, n_points, chunk_batches):
    import jax

    from channel_pruning_tpu.graph.rewrite import split_relu as jax_split_relu
    from channel_pruning_tpu.models.vgg import build_tiny_vgg as jax_tiny_vgg
    from channel_pruning_tpu.ops.forward import to_device_params
    from channel_pruning_tpu.parallel import mesh as jax_mesh
    from channel_pruning_tpu.sampling import freeze as jax_freeze

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    g_j, p_j = jax_tiny_vgg(batch=inputs.shape[1], image_size=16)
    g_j = jax_split_relu(g_j)
    cache_j = jax_freeze(g_j, to_device_params(p_j), inputs,
                         n_points=n_points, seed=0, chunk_batches=chunk_batches)
    return g_j, p_j, cache_j, jax_mesh.make_mesh(8)


def test_solve_prune_on_mesh_matches_jax_mesh(mesh, vgg_case):
    """The pipelined prune on 8 shards against the JAX package's pipelined
    prune on 8 devices: equal masks (each package freezes its own cache
    from the same numpy inputs)."""
    from channel_pruning_tpu.pipeline import c3 as jax_c3
    from channel_pruning_tpu.utils.config import \
        default_config as jax_default_config

    g, params, inputs, cache, targets = vgg_case
    g_j, p_j, cache_j, jax_mesh = _jax_mesh_and_cache(inputs, 6, 2)
    res_j = jax_c3.solve_prune(g_j, p_j, cache_j, jax_default_config(),
                               channel_targets=targets, mesh=jax_mesh,
                               verbose=False)
    res = c3.solve_prune(g, params, cache, default_config(),
                         channel_targets=targets, device=CPU, mesh=mesh,
                         verbose=False)
    assert res.pipelined
    assert res.selections.keys() == res_j.selections.keys()
    for k in res_j.selections:
        np.testing.assert_array_equal(res.selections[k],
                                      np.asarray(res_j.selections[k])), k


def test_solve_3c_on_mesh_matches_jax_mesh(mesh, c3_case):
    """3C on 8 shards against the JAX package's 3C on 8 devices: equal
    masks."""
    from channel_pruning_tpu.pipeline import c3 as jax_c3
    from channel_pruning_tpu.utils.config import \
        default_config as jax_default_config

    g, params, inputs, cache, ranks = c3_case
    g_j, p_j, cache_j, jax_mesh = _jax_mesh_and_cache(inputs, 6, 4)
    r_j = jax_c3.solve_3c(g_j, p_j, cache_j, jax_default_config(), ranks,
                          mesh=jax_mesh, verbose=False)
    r = c3.solve_3c(g, params, cache, default_config(), ranks, device=CPU,
                    mesh=mesh, verbose=False)
    assert r.selections.keys() == r_j.selections.keys()
    for k in r_j.selections:
        np.testing.assert_array_equal(r.selections[k],
                                      np.asarray(r_j.selections[k])), k
