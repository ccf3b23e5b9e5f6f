"""The port's low-rank decompositions (channel_pruning_tpu_torch/ops/lowrank
and lstsq.solve_relu) against the JAX package's on the same seeded numpy
inputs, on the problems of tests/test_solvers.py. SVD and eigh factors are
sign- and rotation-ambiguous, so VH is held on V up to the host SVD (the
same numpy call in both) and on its reconstructions, and ITQ on the
reconstructed responses G·T + U_mean and composed operators."""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.ops import lowrank as jax_lowrank
from channel_pruning_tpu.ops import lstsq as jax_lstsq
from channel_pruning_tpu.ops import oracle
from channel_pruning_tpu_torch.ops import lowrank, lstsq


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("lam", [0.1, 1.0, 10.0])
def test_solve_relu_matches_jax(lam):
    rng = np.random.default_rng(0)
    RU = rng.normal(size=(50, 7)).astype(np.float32)
    Z = np.maximum(rng.normal(size=(50, 7)), 0).astype(np.float32)
    got = lstsq.solve_relu(_t(RU), _t(Z), lam).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_lstsq.solve_relu(RU, Z, lam)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, oracle.solve_relu(RU, Z, lam),
                               rtol=1e-5, atol=1e-6)


def test_solve_relu_tie_takes_u0():
    """cost0 == cost1 (RU = 0, Z = 0: both branches cost 0) takes u0, as
    the JAX package does; a positive target takes the relaxed branch."""
    RU = np.array([[0.0, 0.0, -1.0]], np.float32)
    Z = np.array([[0.0, 1.0, 0.0]], np.float32)
    got = lstsq.solve_relu(_t(RU), _t(Z), 1.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_lstsq.solve_relu(RU, Z, 1.0)))
    np.testing.assert_array_equal(got, [[0.0, 0.5, -1.0]])


def test_nonlinear_fit_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 10)).astype(np.float32)
    Wt = rng.normal(size=(4, 10)).astype(np.float32)
    Y = (X @ Wt.T + 0.05 * rng.normal(size=(300, 4))).astype(np.float32)
    W, b = lowrank.nonlinear_fit(X, Y, (0.1, 1.0), (10, 5))
    Wj, bj = jax_lowrank.nonlinear_fit(X, Y, (0.1, 1.0), (10, 5))
    Wo, bo = oracle.nonlinear_fc(X.astype(np.float64), Y.astype(np.float64),
                                 (0.1, 1.0), (10, 5))
    pred = oracle.relu(X @ W.numpy().T + b.numpy())
    assert oracle.rel_error(oracle.relu(X @ np.asarray(Wj).T + np.asarray(bj)),
                            pred) < 1e-4
    assert oracle.rel_error(oracle.relu(X @ Wo.T + bo), pred) < 1e-2


@pytest.mark.parametrize("rank", [24, 12, 5])
def test_vh_decompose_without_data_matches_jax(rank):
    rng = np.random.default_rng(0)
    W = rng.normal(size=(16, 8, 3, 3)).astype(np.float32)
    res = lowrank.vh_decompose(W, rank)
    ref = jax_lowrank.vh_decompose(W, rank)
    assert res.V.shape == (rank, 8, 3, 1) and res.H.shape == (16, rank, 1, 3)
    np.testing.assert_allclose(res.V.numpy(), np.asarray(ref.V), atol=1e-6)
    np.testing.assert_allclose(res.H.numpy(), np.asarray(ref.H), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res.VHr.numpy(), np.asarray(ref.VHr), rtol=1e-5,
                               atol=1e-5)
    # V then H composed as convs is VHr
    comp = np.einsum("nrw,rch->nchw", res.H.numpy()[:, :, 0, :],
                     res.V.numpy()[:, :, :, 0])
    np.testing.assert_allclose(comp, res.VHr.numpy(), rtol=1e-4, atol=1e-5)
    _, _, VHr_o = oracle.vh_svd(W, rank)
    assert abs(oracle.rel_error(W, res.VHr.numpy())
               - oracle.rel_error(W, VHr_o)) < 1e-3
    if rank == 24:                                   # full rank: exact
        np.testing.assert_allclose(res.VHr.numpy(), W, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,c,rank,iters", [(12, 6, 8, (5, 3)),
                                            (20, 9, 14, (30, 20))])
def test_vh_decompose_with_data_matches_jax_pad_to(n, c, rank, iters):
    """The data refit against the JAX package's bucket-padded path (the one
    its CLI takes): VHr, b and the responses feat at rtol 1e-4."""
    rng = np.random.default_rng(n)
    W = rng.normal(size=(n, c, 3, 3)).astype(np.float32)
    X = rng.normal(size=(400, c, 3, 3)).astype(np.float32)
    Y = oracle.conv_response_at_points(X, W).astype(np.float32)
    res = lowrank.vh_decompose(W, rank, X=X, Y=Y, iters=iters)
    ref = jax_lowrank.vh_decompose(W, rank, X=X, Y=Y, iters=iters,
                                   pad_to=(c + 10, n + 12, 64))
    np.testing.assert_allclose(res.V.numpy(), np.asarray(ref.V), atol=1e-6)
    np.testing.assert_allclose(res.VHr.numpy(), np.asarray(ref.VHr),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.b.numpy(), np.asarray(ref.b), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.feat.numpy(), np.asarray(ref.feat)[:, :n],
                               rtol=1e-4, atol=1e-4)
    pred = oracle.conv_response_at_points(X, res.VHr.numpy()) + res.b.numpy()
    np.testing.assert_allclose(res.feat.numpy(), pred, rtol=1e-3, atol=1e-3)
    # the refit does not fit the ReLU'd responses worse than the plain SVD
    plain = oracle.conv_response_at_points(
        X, lowrank.vh_decompose(W, rank).VHr.numpy())
    assert oracle.rel_error(oracle.relu(Y), oracle.relu(pred)) <= \
        oracle.rel_error(oracle.relu(Y), oracle.relu(plain)) * 1.05


def _low_rank_problem(seed, N=300, d=24, rank=10):
    rng = np.random.default_rng(seed)
    low = rng.normal(size=(N, rank)) @ rng.normal(size=(rank, d))
    feature = (low + 0.05 * rng.normal(size=(N, d))).astype(np.float32)
    gt = (low + 0.05 * rng.normal(size=(N, d))).astype(np.float32)
    return feature, gt


def _responses(feature, T, U_mean):
    G = feature - feature.mean(0)
    return G.astype(np.float64) @ _np(T).astype(np.float64) + \
        _np(U_mean).astype(np.float64)


@pytest.mark.parametrize("seed,iters", [(0, (5, 3)), (1, (30, 20))])
def test_itq_solve_T_matches_jax_and_host_stepped(seed, iters):
    feature, gt = _low_rank_problem(seed)
    T, _, Um = lowrank._itq_solve_T(feature, gt, 10, (0.1, 1.0), iters)
    Tj, _, Umj = jax_lowrank._itq_solve_T(feature, gt, 10, (0.1, 1.0), iters)
    Th, _, Umh = lowrank._itq_solve_T_host(feature, gt, 10, (0.1, 1.0), iters)
    got = _responses(feature, T, Um)
    assert oracle.rel_error(_responses(feature, Tj, Umj), got) < 5e-3
    assert oracle.rel_error(_responses(feature, Th, Umh), got) < 5e-3
    if iters == (5, 3):      # the N-sized-SVD oracle, as test_solvers.py:195
        T_o, _, Um_o = oracle.itq_reference(feature.astype(np.float64),
                                            gt.astype(np.float64), 10,
                                            lambdas=(0.1, 1.0), iters=iters)
        assert oracle.rel_error(_responses(feature, T_o, Um_o), got) < 5e-3


def test_itq_decompose_shapes_and_composition():
    rng = np.random.default_rng(0)
    N, d, rank, r_h, kw = 400, 16, 8, 6, 3
    H = rng.normal(size=(d, r_h, 1, kw)).astype(np.float32)
    feature = rng.normal(size=(N, d)).astype(np.float32)
    gt = feature + 0.01 * rng.normal(size=(N, d)).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    res = lowrank.itq_decompose(feature, gt, H, rank, bias=bias, iters=(5, 3))
    assert res.W1.shape == (rank, r_h, 1, kw)
    assert res.W2.shape == (d, rank, 1, 1)
    assert res.B.shape == (d,) and res.W12.shape == H.shape
    assert res.feat2.shape == (N, d)
    comp = np.einsum("or,rabc->oabc", res.W2.numpy()[:, :, 0, 0], res.W1.numpy())
    np.testing.assert_allclose(comp, res.W12.numpy(), rtol=1e-3, atol=1e-4)


def test_itq_chain_and_merged_bias_match():
    """The emitted V->H'->P chain (H' biasless, P carries B) computes the
    merged W12 conv with bias B, both approximate the ITQ target, and the
    port's factored responses equal the JAX package's."""
    rng = np.random.default_rng(0)
    N, d, rank, r_h, kw = 500, 16, 12, 6, 3
    H = rng.normal(size=(d, r_h, 1, kw)).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    Xh = rng.normal(size=(N, r_h, 1, kw)).astype(np.float32)
    feature = (oracle.conv_response_at_points(Xh, H) + bias).astype(np.float32)
    gt = feature + 0.02 * rng.normal(size=(N, d)).astype(np.float32)
    res = lowrank.itq_decompose(feature, gt, H, rank, bias=bias, iters=(8, 4))
    h_resp = oracle.conv_response_at_points(Xh, res.W1.numpy())   # (N, rank)
    chain = h_resp @ res.W2.numpy()[:, :, 0, 0].T + res.B.numpy()
    merged = oracle.conv_response_at_points(Xh, res.W12.numpy()) + res.B.numpy()
    np.testing.assert_allclose(chain, merged, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res.feat2.numpy(), merged, rtol=1e-3, atol=1e-3)
    assert oracle.rel_error(oracle.relu(gt), oracle.relu(chain)) < 0.15
    ref = jax_lowrank.itq_decompose(feature, gt, H, rank, bias=bias,
                                    iters=(8, 4))
    chain_j = oracle.conv_response_at_points(Xh, np.asarray(ref.W12)) + \
        np.asarray(ref.B)
    assert oracle.rel_error(chain_j, merged) < 5e-3


def test_itq_decompose_matches_jax_true_shape_path():
    """Against the JAX package's bucket-padded fold (`true_shape`, its
    CLI's path) on zero-padded inputs, on the composed responses at the
    calibration points, feat2 = (feature - b)(LR) + B, at JAX's own bound
    (5e-3). Not on the factors: the Gram's condition number (~1e4 here)
    amplifies f32 rounding, ~3e-4 apart after the first iteration, and
    most in the directions the data hardly spans."""
    rng = np.random.default_rng(0)
    N, d, rank, kw, c, kh = 400, 16, 6, 3, 8, 3
    low = rng.normal(size=(N, rank)) @ rng.normal(size=(rank, d))
    feature = (low + 0.05 * rng.normal(size=(N, d))).astype(np.float32)
    gt = (low + 0.05 * rng.normal(size=(N, d))).astype(np.float32)
    H = rng.normal(size=(d, rank, 1, kw)).astype(np.float32)
    Wr = rng.normal(size=(d, c, kh, kw)).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    res = lowrank.itq_decompose(feature, gt, H, rank, bias=bias, Wr=Wr,
                                iters=(5, 3))
    d_pad, c_pad, r_pad = d + 8, c + 4, 64
    fp = np.zeros((N, d_pad), np.float32); fp[:, :d] = feature
    gp = np.zeros((N, d_pad), np.float32); gp[:, :d] = gt
    Hp = np.zeros((d_pad, r_pad, 1, kw), np.float32); Hp[:d, :rank] = H
    Wrp = np.zeros((d_pad, c_pad, kh, kw), np.float32); Wrp[:d, :c] = Wr
    bp = np.zeros(d_pad, np.float32); bp[:d] = bias
    ref = jax_lowrank.itq_decompose(fp, gp, Hp, rank, bias=bp, Wr=Wrp,
                                    iters=(5, 3), true_shape=(d, c))
    assert oracle.rel_error(np.asarray(ref.feat2)[:, :d],
                            res.feat2.numpy()) < 5e-3
    assert res.W1.shape == np.asarray(ref.W1).shape == (rank, rank, 1, kw)
    assert res.W12.shape == np.asarray(ref.W12).shape == (d, c, kh, kw)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_itq_divergence_salvage_and_failure(package, capsys):
    """λ = inf from the second stage on makes every later iterate NaN: the
    device loop returns the last finite iterate (the fifth, as the
    host-stepped oracle does) and says so; with no finite iterate at all it
    raises LinAlgError. Both packages."""
    mod = lowrank if package == "port" else jax_lowrank
    feature, gt = _low_rank_problem(3)
    T, _, Um = mod._itq_solve_T(feature, gt, 10, (0.1, float("inf")), (5, 3))
    assert "salvaged last finite iterate" in capsys.readouterr().out
    T5, _, Um5 = mod._itq_solve_T(feature, gt, 10, (0.1,), (5,))
    Th, _, Umh = mod._itq_solve_T_host(feature, gt, 10,
                                       (0.1, float("inf")), (5, 3))
    got = _responses(feature, T, Um)
    assert np.isfinite(got).all()
    assert oracle.rel_error(_responses(feature, T5, Um5), got) < 1e-6
    assert oracle.rel_error(_responses(feature, Th, Umh), got) < 5e-3
    with pytest.raises(np.linalg.LinAlgError):
        mod._itq_solve_T(feature, gt, 10, (float("inf"),), (3,))
