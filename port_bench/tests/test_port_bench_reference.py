"""The plain reference against the port on the CPU, on the tiny VGG, the
tiny ResNet and the tiny Xception: the same forward, the same point plan and the same frozen
ground truth from the same weights and images. The reference's copies of
the plan and the arithmetic are pinned here, not imported from the port."""
import numpy as np
import pytest
import torch

from port_bench import checks, generate, harness, job
from port_bench.reference import plain


@pytest.fixture(params=["tvgg.tcp", "tres.trcp", "txc.txcp"])
def cell(request, tiny_root):
    return harness.load_cell(tiny_root, request.param)


def test_forward_matches_the_port(cell):
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.pipeline import c3

    prog = job.Program(cell.config, cell.traffic, "cpu")
    orig, params, sets, held = harness.make_inputs(cell, prog, 5, "cpu", 1)
    g, p = c3.preprocess(prog.graph, params)        # BN folded, ReLUs split
    x = torch.as_tensor(sets[0][0])
    head = next(l for l in orig if l["name"] == cell.config["head"])["bottoms"][0]
    want = run_graph(g, params_to_torch(p, "cpu"), {"data": x}, capture=[head])[1][head]
    got = plain.run(orig, checks._device_params(params, "cpu"), x,
                    {head: lambda v: v})[head]
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_plan_and_freeze_match_the_port(cell):
    prog = job.Program(cell.config, cell.traffic, "cpu")
    orig, params, sets, held = harness.make_inputs(cell, prog, 6, "cpu", 1)
    res = prog.run(params, sets[0], job.Spans(), job=0)
    include = {t for t, v in res.cache.feats.items() if np.ndim(v) == 2}
    s = harness.job_settings(prog)
    _, plan, gt = checks.reference_freeze(
        orig, checks._device_params(params, "cpu"), sets[0], s["n_points"],
        s["seed"], include, "cpu")
    gap, where = checks.freeze_gap(res.cache.feats, res.cache.plan, plan, gt)
    assert gap < 1e-5, where
    for t in gt:
        assert np.array_equal(plan[t][0], res.cache.plan[t][0])


def test_point_plan_draws():
    shapes = {"a": (2, 3, 5, 7), "b": (2, 3, 4, 4), "c": (2, 3, 5, 7), "f": (2, 9)}
    plan = plain.point_plan(shapes, ["a", "b", "c", "f"], 2, 3, seed=0,
                            share_key=lambda t: "a" if t == "c" else t)
    rng = np.random.default_rng(0)
    ys, xs = rng.integers(0, 5, (2, 3)), rng.integers(0, 7, (2, 3))
    assert np.array_equal(plan["a"][0], ys) and np.array_equal(plan["a"][1], xs)
    assert np.array_equal(plan["b"][0], rng.integers(0, 4, (2, 3)))
    assert plan["c"] is plan["a"]
    assert plan["f"][0].shape == (2, 0)


def test_gathers_follow_the_row_order():
    v = torch.arange(2 * 2 * 3 * 3, dtype=torch.float32).reshape(2, 2, 3, 3)
    ys, xs = np.array([[0, 2]]), np.array([[1, 0]])
    rows = plain.gather_points(v, ys, xs, bs=2)        # row = p * bs + b
    assert rows.tolist() == [[1, 10], [19, 28], [6, 15], [24, 33]]
    pat = plain.gather_patches(v, ys, xs, 2, {"kernel_size": 3, "pad": 1})
    assert pat.shape == (4, 2, 3, 3)
    assert pat[0, 0].tolist() == [[0, 0, 0], [0, 1, 2], [3, 4, 5]]


def test_the_seed_orders_the_same_pool(tiny_root):
    cell = harness.load_cell(tiny_root, "tvgg.tcp")
    prog = job.Program(cell.config, cell.traffic, "cpu")
    seeds = [2 ** 31 + i for i in range(8)]
    orders = [generate.pool_order(2, s) for s in seeds]
    assert sorted(map(tuple, orders)) != [tuple(orders[0])] * 8   # both orders occur
    got = {}
    for s, order in zip(seeds, orders):
        _, params, sets, held = harness.make_inputs(cell, prog, s, "cpu", 2)
        for k, x in zip(order, sets):
            if k in got:
                assert np.array_equal(got[k], x)
            got[k] = x
        assert np.array_equal(params["conv1_1"]["W"], got.setdefault(
            "w", params["conv1_1"]["W"]))
    assert not np.array_equal(got[0], got[1])


def test_weights_are_seeded_and_he_scaled():
    layers = [plain.layer("c", "Convolution", ["data"], num_output=64,
                          kernel_size=3, pad=1)]
    a = generate.weights(layers, (1, 32, 8, 8), 2 ** 31 + 7, "cpu")
    b = generate.weights(layers, (1, 32, 8, 8), 2 ** 31 + 7, "cpu")
    c = generate.weights(layers, (1, 32, 8, 8), 2 ** 31 + 8, "cpu")
    assert np.array_equal(a["c"]["W"], b["c"]["W"])
    assert not np.array_equal(a["c"]["W"], c["c"]["W"])
    assert a["c"]["W"].std() == pytest.approx((2 / (32 * 9)) ** 0.5, rel=0.05)
    assert not a["c"]["b"].any()


def test_roundings():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0e3])
    assert plain.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0e3]
    assert plain.round_bf16(x).tolist() == [1.0, 1.0, 1.0, 3008.0]
    y = plain.round_fp8(torch.linspace(-3, 3, 101))
    assert float((y - torch.linspace(-3, 3, 101)).abs().max()) < 3 * 2 ** -4


def _cd(G, b, lam, sweeps=20000):
    """Cyclic coordinate descent to convergence at one lam (float64)."""
    beta = torch.zeros(G.shape[0], dtype=torch.float64)
    for _ in range(sweeps):
        old = beta.clone()
        for j in range(G.shape[0]):
            r = float(b[j] - G[j] @ beta + G[j, j] * beta[j])
            beta[j] = np.sign(r) * max(abs(r) - lam, 0.0) / float(G[j, j])
        if float((beta - old).abs().max()) < 1e-15:
            break
    return beta


def test_lasso_on_a_diagonal_gram_soft_thresholds():
    b = torch.tensor([0.3, -2.0, 1.1, 0.05, -0.7, 1.6], dtype=torch.float64)
    d = torch.tensor([1.0, 4.0, 0.5, 2.0, 1.0, 3.0], dtype=torch.float64)
    for lam in (2.5, 1.0, 0.5, 0.01):
        want = torch.sign(b) * torch.clamp(b.abs() - lam, min=0) / d
        assert torch.allclose(plain.lasso_at(torch.diag(d), b, lam), want)
    assert plain.top_k(torch.tensor([0.2, 0.9, 0.9, 0.1]), 2).tolist() == \
        [False, True, True, False]


@pytest.mark.parametrize("frac", [0.6, 0.2, 0.05, 0.002])
def test_lasso_path_equals_converged_descent(frac):
    g = torch.Generator().manual_seed(11)
    Z = torch.randn(400, 14, generator=g, dtype=torch.float64) + 0.4
    y = Z[:, :4] @ torch.tensor([1.0, -0.5, 0.8, 0.3], dtype=torch.float64) \
        + 0.5 * torch.randn(400, generator=g, dtype=torch.float64)
    G, b = Z.T @ Z, Z.T @ y
    lam = frac * float(b.abs().max())
    got = plain.lasso_at(G, b, lam)
    want = _cd(G, b, lam)
    assert torch.equal(got != 0, want != 0)
    assert torch.allclose(got, want, rtol=1e-8, atol=1e-10)


def test_channel_response_columns():
    X = torch.randn(5, 3, 2, 2, dtype=torch.float64)
    W = torch.randn(4, 3, 2, 2, dtype=torch.float64)
    Z = plain.channel_response(X, W)
    assert Z.shape == (20, 3)
    for i in range(3):
        want = X[:, i].reshape(5, -1) @ W[:, i].reshape(4, -1).T   # (N, n)
        assert torch.allclose(Z[:, i], want.reshape(-1))
    assert torch.allclose(Z.sum(1), (X.reshape(5, -1) @ W.reshape(4, -1).T).reshape(-1))


def test_a_problem_seed_draws_another_problem(tiny_root):
    cell = harness.load_cell(tiny_root, "tvgg.tcp")
    prog = job.Program(cell.config, cell.traffic, "cpu")
    _, p0, s0, h0 = harness.make_inputs(cell, prog, 9, "cpu", 1)
    _, p1, s1, h1 = harness.make_inputs(cell, prog, 9, "cpu", 1, problem=0)
    _, p2, s2, h2 = harness.make_inputs(cell, prog, 9, "cpu", 1, problem=5)
    assert np.array_equal(p0["conv1_1"]["W"], p1["conv1_1"]["W"])
    assert np.array_equal(s0[0], s1[0]) and torch.equal(h0, h1)
    assert not np.array_equal(p0["conv1_1"]["W"], p2["conv1_1"]["W"])
    assert not np.array_equal(s0[0], s2[0]) and not torch.equal(h0, h2)


def test_the_running_net_computes_what_the_compressed_model_does(cell):
    """At full width, with every dropped channel read through zero columns,
    the running net's head input equals the compressed model's."""
    prog = job.Program(cell.config, cell.traffic, "cpu")
    orig, params, sets, held = harness.make_inputs(cell, prog, 4, "cpu", 1)
    res = prog.run(params, sets[0], job.Spans(), job=0)
    out = job.plain_layers(res.graph)
    s = harness.job_settings(prog)
    params_t = checks._device_params(params, "cpu")
    _, plan, gt = checks.reference_freeze(orig, params_t, sets[0], s["n_points"],
                                          s["seed"], set(), "cpu")
    items = checks.solved_layers(orig, cell.traffic)
    out_t = checks._device_params(res.params, "cpu")
    rows = checks.layer_rows(out, out_t, sets[0], plan, items, orig, "cpu")
    run_layers, run_params = checks.running_net(
        out, res.params, orig, params_t, items, res.selections, rows, gt, 0.0, "cpu")
    assert any(l["type"] == "Select" for l in out) == (cell.name != "tvgg.tcp")
    for it in items:                      # every solved layer reads all channels
        W = run_params[it["consumer"]]["W"]
        assert W.shape[1] == len(res.selections[it["consumer"]])
        for d in it["depthwise"]:         # and every depthwise conv all of its
            assert run_params[d]["W"].shape[0] == len(res.selections[it["consumer"]])
    head = cell.config["head"]
    tap = {next(l for l in out if l["name"] == head)["bottoms"][0]: lambda v: v}
    want = plain.run(out, out_t, held, tap)
    got = plain.run(run_layers, run_params, held, tap)
    for t in want:
        assert torch.allclose(got[t], want[t], rtol=1e-4,
                              atol=1e-5 * float(want[t].abs().max()))
