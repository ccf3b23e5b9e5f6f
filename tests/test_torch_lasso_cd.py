"""The port's LASSO CD grid solver (channel_pruning_tpu_torch/kernels/lasso_cd)
against the JAX package's XLA solver and its two Pallas kernels (K1 and the
HBM-streaming K2) in interpret mode.

Protocol of test_solvers.py::test_pallas_cd_kernel_interpret_parity:
allclose at rtol 1e-4 / atol 1e-5 (f32 sums taken in another order) with
identical support sizes. Both packages get the same Gram matrix.
"""
import numpy as np
import pytest
import torch

from channel_pruning_tpu.kernels import lasso_cd as jax_lasso_cd
from channel_pruning_tpu.ops import lasso as jax_lasso
from channel_pruning_tpu_torch.kernels import lasso_cd
from channel_pruning_tpu_torch.ops import lasso
from torch_cpu import one_thread  # noqa: F401


def _sparse_gram(seed, n, c, k, noise=0.01):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, c)).astype(np.float32)
    beta = np.zeros(c, np.float32)
    idx = rng.choice(c, k, replace=False)
    beta[idx] = rng.normal(0, 1, k).astype(np.float32) + \
        np.sign(rng.normal(size=k)).astype(np.float32)
    y = Z @ beta + noise * rng.normal(size=n).astype(np.float32)
    gram = jax_lasso.lasso_gram(Z, y)
    return np.array(gram.G), np.array(gram.b), int(gram.n_samples)


def _port_grid(G, b, alphas, n_sweeps):
    return lasso_cd.cd_solve_grid(torch.from_numpy(G), torch.from_numpy(b),
                                  torch.from_numpy(alphas),
                                  n_sweeps=n_sweeps).numpy()


@pytest.mark.parametrize("seed,n,c,k", [(0, 400, 24, 6), (1, 600, 48, 20),
                                        (2, 300, 40, 30)])
def test_plain_grid_matches_xla_solver(seed, n, c, k):
    G, b, N = _sparse_gram(seed, n, c, k)
    alphas = (np.geomspace(1e-4, 0.5, 12) * N).astype(np.float32)
    ref = np.asarray(jax_lasso.cd_solve_grid(G, b, alphas, n_sweeps=300))
    got = _port_grid(G, b, alphas, 300)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        lasso.support_sizes(torch.from_numpy(got)).numpy(),
        np.asarray(jax_lasso.support_sizes(ref)))


@pytest.mark.parametrize("kernel,seed,n,c,k", [
    ("cd_solve_grid_pallas", 0, 400, 24, 6),
    ("cd_solve_grid_pallas", 3, 500, 64, 16),
    # K2, the HBM-streaming kernel: the plain version serves it too
    # (protocol of test_solvers.py::test_pallas_hbm_cd_kernel_interpret_parity)
    ("cd_solve_grid_pallas_hbm", 6, 300, 40, 10)])
def test_plain_grid_matches_pallas_interpret(kernel, seed, n, c, k):
    G, b, N = _sparse_gram(seed, n, c, k)
    alphas = (np.geomspace(1e-3, 0.5, 8) * N).astype(np.float32)
    ref = np.asarray(getattr(jax_lasso_cd, kernel)(
        G, b, alphas, n_sweeps=300, interpret=True))
    got = _port_grid(G, b, alphas, 300)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        lasso.support_sizes(torch.from_numpy(got)).numpy(),
        np.asarray(jax_lasso.support_sizes(ref)))


def test_zero_diagonal_padding_is_inert():
    """Appended zero rows/columns (a zero diagonal) stay at beta = 0 and
    leave the real block's solution bit-identical."""
    G, b, N = _sparse_gram(4, 400, 20, 8)
    alphas = (np.geomspace(1e-3, 0.3, 6) * N).astype(np.float32)
    pad = 12
    Gp = np.zeros((20 + pad, 20 + pad), np.float32)
    Gp[:20, :20] = G
    bp = np.concatenate([b, np.zeros(pad, np.float32)])
    got = _port_grid(Gp, bp, alphas, 200)
    np.testing.assert_array_equal(got[:, 20:], 0.0)
    np.testing.assert_array_equal(got[:, :20], _port_grid(G, b, alphas, 200))


def test_per_alpha_stopping_rule():
    """Each alpha stops on its own: solving one alpha alone gives the same
    beta as solving it inside the grid (the reference's XLA rule)."""
    G, b, N = _sparse_gram(5, 400, 32, 10)
    alphas = (np.geomspace(1e-4, 0.5, 8) * N).astype(np.float32)
    grid = _port_grid(G, b, alphas, 200)
    for i in (0, 3, 7):
        alone = _port_grid(G, b, alphas[i:i + 1], 200)
        np.testing.assert_array_equal(alone[0], grid[i])



def test_stream_wrapper_takes_plain_version_on_cpu():
    """K2's wrapper on a CPU tensor is the plain version, like K1's, and
    counts no launch."""
    G, b, N = _sparse_gram(7, 300, 40, 10)
    alphas = (np.geomspace(1e-3, 0.5, 6) * N).astype(np.float32)
    before = (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM)
    got = lasso_cd.cd_solve_grid_stream(torch.from_numpy(G), torch.from_numpy(b),
                                        torch.from_numpy(alphas)).numpy()
    np.testing.assert_array_equal(got, _port_grid(G, b, alphas, 200))
    assert (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM) == before


def _f64_quotient(x, d):
    """The kernels' division x / d (csrc/lasso_cd.cu, `cd_candidate`): both
    widened to f64 (exact), rinv = 1/d rounded to f64 (`__ddiv_rn`), one
    f64 product (`__dmul_rn`), rounded to f32 (`__double2float_rn`)."""
    with np.errstate(over="ignore"):
        rinv = np.float64(1.0) / np.asarray(d, np.float32).astype(np.float64)
        return (np.asarray(x, np.float32).astype(np.float64) * rinv) \
            .astype(np.float32)


def _kernel_candidate(bk, qk, dkb, dk, alpha):
    """`cd_candidate` in numpy, operation for operation: c = (b - q) + d·beta
    (d·beta given), mag = max(|c| - alpha, 0), the sign a select (c = ±0
    gives +0), the division by `_f64_quotient` with 1 in place of d <= 0."""
    f32 = np.float32
    live = dk > 0
    cj = ((bk - qk) + dkb).astype(f32)
    mag = np.maximum(np.abs(cj) - alpha, f32(0)).astype(f32)
    num = np.where(live & (cj < 0), -mag,
                   np.where(live & (cj > 0), mag, f32(0))).astype(f32)
    return _f64_quotient(num, np.where(live, dk, f32(1)))


def _skip_ahead_grid(G, b, alphas_n, n_sweeps=200, tol=1e-8, lanes=32, ring=4,
                     queue=None):
    """A numpy model of the kernels' exact skip-ahead (csrc/lasso_cd.cu), one
    alpha at a time: each sweep walks chunks of `lanes` columns; in a chunk
    every lane from the window start s computes its candidate beta from the
    current q with the kernels' arithmetic (`_kernel_candidate`, d·beta taken
    at the chunk's start), the first lane f with delta != 0 moves, lanes
    s..f commit, and the window restarts at f + 1; a window with no mover
    commits all its lanes. The mover's row updates this chunk's q at once.
    The replicated form (`queue` None: every warp runs the chain and
    updates its own chunks between two of its steps) updates every other
    chunk's q through a ring of `ring` deferred rows: the oldest is applied
    when the ring is full, all of them in order when the chunk ends. The
    split form takes the moves into a queue of depth
    `queue` that outlives the chunk: each other chunk applies them in
    order, at any lag up to `queue` moves (the split kernels' update warps),
    and a chunk's q catches up when it becomes the window.
    Returns (betas, [sweeps, nonzero steps])."""
    f32 = np.float32
    c = b.shape[0]
    diag = np.diag(G).copy()
    out = np.zeros((alphas_n.shape[0], c), f32)
    stats = np.zeros((alphas_n.shape[0], 2), np.int32)
    starts = list(range(0, c, lanes))
    cols = [np.arange(base, min(base + lanes, c)) for base in starts]
    for a, alpha in enumerate(alphas_n):
        beta, q = np.zeros(c, f32), np.zeros(c, f32)
        log, applied = [], [0] * len(starts)    # the split form's queue

        def catch_up(j, upto):
            while applied[j] < upto:
                row, dj = log[applied[j]]
                q[cols[j]] = q[cols[j]] + G[row, cols[j]] * dj
                applied[j] += 1

        sweeps = moves = 0
        while True:
            max_delta = f32(0)
            for ci, base in enumerate(starts):
                k = cols[ci]
                if queue is not None:
                    catch_up(ci, len(log))
                d = diag[k]
                dkb = d * beta[k]
                others = np.ones(c, bool)
                others[k] = False
                pending = []
                s = 0
                while True:
                    old = beta[k]
                    bj = _kernel_candidate(b[k], q[k], dkb, d, alpha)
                    delta = bj - old
                    moved = np.flatnonzero(delta[s:] != 0)
                    if moved.size == 0:
                        beta[k[s:]] = bj[s:]
                        break
                    f = s + int(moved[0])
                    beta[k[s:f + 1]] = bj[s:f + 1]
                    max_delta = max(max_delta, abs(delta[f]))
                    q[k] = q[k] + G[k[f], k] * delta[f]
                    moves += 1
                    s = f + 1
                    if queue is not None:
                        log.append((k[f], delta[f]))
                        applied[ci] = len(log)
                        for j in range(len(starts)):
                            catch_up(j, len(log) - queue)
                    else:
                        if len(pending) == ring:
                            j, dj = pending.pop(0)
                            q[others] = q[others] + G[j, others] * dj
                        pending.append((k[f], delta[f]))
                    if s == k.size:
                        break
                for j, dj in pending:
                    q[others] = q[others] + G[j, others] * dj
            sweeps += 1
            scale = max(np.abs(beta).max(), f32(1e-12))
            if not (sweeps < n_sweeps and max_delta > f32(tol) * scale):
                break
        out[a], stats[a] = beta, (sweeps, moves)
    return out, stats


@pytest.mark.parametrize("c,zero_diag,ring", [(5, (), 8), (37, (3, 36), 2),
                                              (64, (0, 31, 32), 8),
                                              (130, (7, 64, 129), 4),
                                              (200, (5, 192, 199), 4),
                                              (37, (3, 36), "queue1"),
                                              (130, (7, 64, 129), "queue8"),
                                              (200, (5, 192, 199), "queue32"),
                                              (20, (3, 19), "queue128")])
def test_skip_ahead_model_equals_plain_bit_for_bit(c, zero_diag, ring):
    """The kernels' window skip-ahead and deferred row updates change no
    value: the numpy model above equals cd_solve_grid_plain bit for bit,
    betas and stats, with some coordinates inert (zero diagonal) and alphas
    from nearly all to no coordinates moving; replicated (a ring of 2-8
    rows) and split ("queueN": a move queue of depth 1, 8 or 32, and the
    kernels' 128 at one chunk, c <= 32, which the split kernel serves
    too)."""
    queue = int(ring[5:]) if isinstance(ring, str) else None
    G, b, N = _sparse_gram(10 + c, 6 * c, c, max(2, c // 4))
    for j in zero_diag:
        G[j, :] = 0.0
        G[:, j] = 0.0
    alphas = (np.geomspace(1e-4, 0.8, 7) * N).astype(np.float32)
    stats = torch.zeros((7, 2), dtype=torch.int32)
    want = lasso_cd.cd_solve_grid_plain(torch.from_numpy(G), torch.from_numpy(b),
                                        torch.from_numpy(alphas), n_sweeps=60,
                                        stats=stats).numpy()
    got, got_stats = _skip_ahead_grid(G, b, alphas, n_sweeps=60,
                                      ring=4 if queue else ring, queue=queue)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_stats, stats.numpy())
    assert np.all(got[:, list(zero_diag)] == 0)
    assert got_stats[:, 1].max() > 0 and got_stats[:, 0].min() >= 1


def _f32_bits(rng, n, lo_exp, hi_exp):
    """n positive floats with exponents drawn from [lo_exp, hi_exp] (the
    biased field, 0 = subnormal) and random significands."""
    e = rng.integers(lo_exp, hi_exp + 1, n, dtype=np.uint32)
    m = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    return ((e << 23) | m).view(np.float32)


def _quotient_pairs(kind, rng, n):
    f32 = np.float32
    sign = np.where(rng.random(n) < 0.5, f32(-1), f32(1))
    if kind == "random_bits":          # every finite pair, by bit pattern
        return sign * _f32_bits(rng, n, 0, 254), _f32_bits(rng, n, 0, 254)
    if kind == "cell_ranges":          # |c| - alpha and the cells' diagonals
        x = (10.0 ** rng.uniform(-9, 5, n)).astype(f32)
        return sign * x, (10.0 ** rng.uniform(-4, 7, n)).astype(f32)
    if kind == "subnormal_quotients":  # results near and under 2^-126
        return sign * _f32_bits(rng, n, 0, 30), _f32_bits(rng, n, 100, 140)
    if kind == "overflowing_quotients":  # results near and over the top
        return sign * _f32_bits(rng, n, 230, 254), _f32_bits(rng, n, 0, 40)
    if kind == "special_divisors":     # powers of two, the smallest normal,
        x = sign * _f32_bits(rng, n, 0, 254)       # all-ones significands
        d = np.concatenate([
            (2.0 ** rng.integers(-149, 128, n // 4)).astype(f32),
            np.full(n // 4, np.finfo(f32).tiny, f32),
            ((2 ** 24 - 1) * 2.0 ** rng.integers(-149, 104, n // 4)).astype(f32),
            np.nextafter(_f32_bits(rng, n - 3 * (n // 4), 1, 254), f32(0))])
        return x, d
    raise ValueError(kind)


@pytest.mark.parametrize("kind,n,seed", [
    ("random_bits", 1_500_000, 0), ("cell_ranges", 1_500_000, 1),
    ("subnormal_quotients", 500_000, 2), ("overflowing_quotients", 500_000, 3),
    ("special_divisors", 500_000, 4)])
def test_f64_reciprocal_quotient_is_the_f32_division(kind, n, seed):
    """The kernels' division (an f64 product with the f64 reciprocal,
    rounded to f32) equals float32 division bit for bit: seeded random
    pairs over every exponent, the ranges the cells' |c| - alpha and Gram
    diagonals take, subnormal and overflowing quotients, and divisors at
    powers of two, the smallest normal and all-ones significands."""
    x, d = _quotient_pairs(kind, np.random.default_rng(seed), n)
    assert np.isfinite(x).all() and (d > 0).all() and np.isfinite(d).all()
    with np.errstate(over="ignore", under="ignore"):
        want = x / d
    got = _f64_quotient(x, d)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_f64_reciprocal_quotient_edge_cases():
    """Zero numerators keep their sign, a zero or subnormal quotient is
    exact, and the edges of the range round as division does."""
    f32 = np.float32
    tiny, big = np.finfo(f32).tiny, np.finfo(f32).max
    sub = np.float32(2.0 ** -149)
    x = np.array([0.0, -0.0, 0.0, -0.0, sub, -sub, sub, 3 * sub, tiny, big,
                  big, -big, 1.0, 1.0, 3.0, 1.0, 2.0 ** -126, 7.0], f32)
    d = np.array([1.0, 1.0, tiny, big, 2.0, 2.0, 3.0, 2.0, 2.0, 0.5, tiny,
                  big, 3.0, 2.0 ** 127, 2.0 ** -127, sub, 2.0 ** 24, sub], f32)
    with np.errstate(over="ignore", under="ignore"):
        want = x / d
    np.testing.assert_array_equal(_f64_quotient(x, d).view(np.uint32),
                                  want.view(np.uint32))
    assert np.signbit(_f64_quotient(x[:4], d[:4])).tolist() == \
        [False, True, False, True]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_candidate_equals_plain_soft_threshold(seed):
    """`cd_candidate`'s arithmetic (the sign a select, the division an f64
    product) equals the plain version's sign(c) * clamp(|c| - alpha, 0) / d,
    0 where d <= 0, bit for bit: c of either sign and ±0, alphas 0, +inf and
    above |c|, zero and negative diagonals."""
    rng = np.random.default_rng(seed)
    n, f32 = 400_000, np.float32
    bk = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 4, n)).astype(f32)
    qk = np.where(rng.random(n) < 0.1, bk,
                  (rng.normal(size=n) * 10.0 ** rng.integers(-6, 4, n))
                  .astype(f32))
    dk = (10.0 ** rng.uniform(-3, 6, n)).astype(f32)
    dk[rng.random(n) < 0.05] = 0.0
    dk[rng.random(n) < 0.01] = -1.0
    bw = np.where(rng.random(n) < 0.5, f32(0),
                  rng.normal(size=n).astype(f32))
    bw[rng.random(n) < 0.05] = -0.0
    dkb = (dk * bw).astype(f32)
    alpha = np.where(rng.random(n) < 0.1, f32(0), (10.0 ** rng.uniform(
        -6, 4, n)).astype(f32))
    alpha[rng.random(n) < 0.02] = np.inf
    assert {x.dtype for x in (bk, qk, dk, bw, dkb, alpha)} == {np.dtype(f32)}
    got = _kernel_candidate(bk, qk, dkb, dk, alpha)
    t = torch.from_numpy
    cj = (t(bk) - t(qk)) + t(dk) * t(bw)
    assert bool((cj == 0).any())
    want = torch.sign(cj) * torch.clamp(cj.abs() - t(alpha), min=0.0) \
        / torch.where(t(dk) > 0, t(dk), torch.ones_like(t(dk)))
    want = torch.where(t(dk) > 0, want, torch.zeros_like(want)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _cd_cell_grids():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / "cd_cell_grids.py"
    spec = importlib.util.spec_from_file_location("cd_cell_grids", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cd_cell_grids_readers():
    """tools/cd_cell_grids.py's readers: the width class of c, the slowest
    alpha of a grid (moves + sweeps x chunks), the per-class fit that
    recovers the ms a grid, a move and a window from exact data, and a
    `--widths` grid with its widths as the classes."""
    tool = _cd_cell_grids()
    assert [tool.width_class(c) for c in (1, 128, 129, 1024, 1025, 8192)] == \
        [128, 128, 256, 1024, 2048, 8192]
    stats = np.array([[3, 10], [2, 40], [5, 0]], np.int32)
    assert tool.slowest_alpha(stats, 64) == (40, 4)     # 40 + 2·2 > 3·2 + 10
    rng = np.random.default_rng(0)
    moves = rng.integers(100, 10_000, 12)
    windows = rng.integers(10, 1_000, 12)
    t = 0.05 + 2e-4 * moves + 1.5e-3 * windows
    a, m, w = tool.fit_steps(t, moves, windows)
    assert abs(a - 0.05) < 1e-9 and abs(m - 2e-4) < 1e-12 \
        and abs(w - 1.5e-3) < 1e-12
    assert tool.fit_steps(t[:3], moves[:3], windows[:3]) is None
    grids = [{"c": 256, "stats": np.array([[2, m_], [1, 0]], np.int32)}
             for m_ in moves[:6]]
    times = {"package": list(0.1 + 1e-3 * moves[:6])}
    (row,) = tool.class_rows(grids, times, sm_mhz=1000.0)
    assert row["class"] == "c<=256" and row["grids"] == 6
    assert row["moves"] == int(moves[:6].sum())
    assert abs(row["cyc_move"] - 1e-3 * 1e-3 * 1e9) < 1e-3
    assert [tool.width_class(c, (728, 4100)) for c in (1, 728, 729)] == \
        [728, 728, 4100]
    (w_grid,) = tool.width_grids([12], seed=3, device="cpu")
    assert w_grid["c"] == 12 and tuple(w_grid["G"].shape) == (12, 12)
    assert w_grid["a"].shape == (16,) and bool((w_grid["a"] > 0).all())
    w_grid["stats"] = np.array([[2, 5]] * 16, np.int32)
    rows = tool.class_rows([w_grid], {"package": [0.5]}, 1000.0, (12, 64))
    assert [(r["class"], r["c"], r["grids"]) for r in rows] == \
        [("c<=12", [12], 1)]
