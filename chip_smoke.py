#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (channel_pruning_tpu_torch) on one
NVIDIA card:

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises (exit code != 0):
  1. the card: torch.cuda must be available; nvidia-smi name and power limit;
  2. build the LASSO CD kernels K1 and K2 (csrc/lasso_cd.cu) from the
     checkout, and print ptxas's registers / shared memory per kernel;
  3. K1 against its plain PyTorch version on the card at c = 256 and
     c = 512 with a 16-alpha grid (the search's grid) over the full 200
     sweeps: identical supports, max|K1-plain| = 0, the same sweeps and
     nonzero steps for every alpha; then K1 alone at c = 512 and 1024, timed
     with CUDA events, each time printed beside the sweeps and nonzero
     steps (min/median/max over the alphas), the FLOPs and bytes that work
     needs, and the bound they give on this card; and alphas of +inf (the
     fused search's rounds after it is done): betas exactly 0, one sweep
     and no nonzero step for every alpha;
  3b. the same for K2 at c = 2048 and c = 4096 (1x1 patches, the shape of
     a res5 gate), against the plain version over 3 sweeps (a full plain
     grid at c = 2048 takes about a minute), timed over 3 and 200 sweeps;
  4. the tiny VGG and the tiny ResNet (Select gates, residual compensation,
     DAG frontier, band=bottom) through the default pipelined pass on the
     card and on the CPU, and the sequential pass on the card: identical
     selections, and the pipelined pass runs to its end;
  4b. the tiny VGG through 3C (VH, ITQ and the pruning arm, full schedules)
     on the card and on the CPU: the same structure and selections;
  5. the main path, `cli prune --model vgg16 --mode prune --speed 5.0
     --device cuda` with its defaults (the pipelined pass with the fused
     search; 50 x 10 synthetic calibration images, random He-init weights):
     the pass runs to its end with no restart, every layer's dispatch under
     torch.cuda.set_sync_debug_mode("error") (a host sync there raises),
     keep counts equal the released 5x table, the first layer starts from
     an exact input, reconstruction beats the accumulated error from the
     third pruned layer on (the first two end above their start on random
     weights in the JAX package too, and are held to fixed bounds near
     their observed values), the kernel was launched, and the exported
     model reloads and runs to finite probabilities that sum to 1;
  5b. the second main path, `cli prune --model resnet50 --mode prune
     --speed 2.0 --device cuda`, the same way: all 32 branch2a/2b widths
     inside the released band [t, round(1.1 t)] (tools/band_check.py's
     rule), 16 Select gates with keep counts inside the same band against
     the released Filter table, K2 (res5b/res5c gates, c = 2048) and K1
     both launched, every rMSE finite (on random weights after < before
     does not hold in the JAX package either), and the exported model
     reloads and gives probabilities;
  5d. the 3C path, `cli prune --model vgg16 --mode 3c --speed 4.0 --device
     cuda` from scratch with its defaults (the VGG-16 4x ranks, conv1_1
     skipped, the pruning arms on the fused search), then `cli combine` and
     `cli flop` on its export: 12/12 layers fully decomposed (VH+ITQ), each
     of the 11 arms keeps a count in the search's band [d_c, d_c + rank_tol
     d_c] above d_c = floor(C_out / dic.c_ratio), every rMSE finite, K1
     launched on the arms, the export reloads and gives probabilities, and
     the combined model gives the same probabilities on one batch (1e-4);
     the per-layer table (rank, rMSE VH -> final, arm keep and rMSE, the
     seconds of each stage with the host SVDs, the ITQ loop and the
     checkpoint split out), the conv-mult ratios and the wall are printed;
  5c. the two channel-pruning main paths once more on the sequential path
     (`--set solve.fused_search=False`): the same keep counts and bands;
     how many layers select as the pipelined pass and the lowest per-layer
     IoU are printed (float32 against float64 grid endpoints may move a
     near-tie probe on random weights);
  6. with --profile only: each main path (the 3C path too) once more under
     torch.profiler, with the device's busy time, idle share, the CD
     kernels' share and the top kernels.
The next-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Nothing of JAX or of the JAX package is
imported here, nor by the port: it has its own copies of the numpy modules
(graph IR, Caffe codec, models, config, FLOPs).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "work" / "chip_smoke"      # .gitignore lists work/
TINY_TARGETS = {"conv1_1": 5, "conv1_2": 6, "conv2_1": 8, "conv2_2": 9,
                "conv3_1": 10}


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


A_GRID = 16     # the search's grid (lasso.grid_size), the main path's shape


def _cd_problem(seed: int, c: int, device, k: int = 3, n: int | None = None):
    """A LASSO Gram at main-path shape: Z from post-ReLU k x k patches of 250
    rows (the layer's row subsample) against He-init weights of an n-wide
    consumer (n = c by default), and a 16-alpha geometric grid."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    rng = np.random.default_rng(seed)
    n = c if n is None else n
    X = np.maximum(rng.normal(size=(250, c, k, k)), 0).astype(np.float32)
    W2 = (rng.normal(size=(n, c, k, k)) * np.sqrt(2.0 / (k * k * c))).astype(np.float32)
    Xd, Wd = torch.from_numpy(X).to(device), torch.from_numpy(W2).to(device)
    Z = lasso.build_channel_response(Xd, Wd)
    y = Z.sum(dim=1) + 0.05 * torch.from_numpy(
        rng.normal(size=Z.shape[0]).astype(np.float32)).to(device)
    gram = lasso.lasso_gram(Z, y)
    a_max = float(gram.b.abs().max()) / gram.n_samples
    alphas = torch.as_tensor(np.geomspace(1e-3 * a_max, a_max, A_GRID)
                             * gram.n_samples, dtype=torch.float32).to(device)
    return gram, alphas


def _time_ms(fn, reps: int):
    """(mean ms per call from CUDA events, the last call's result)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 and f32 outside the
# tensor cores, the units of the CD kernels' work
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _cd_bound(c: int, n_alpha: int, stats) -> dict:
    """The least time a grid could take for this run's work: G, b and the
    alphas read once, the betas written once; ~8 FLOPs a coordinate step
    (the candidate beta, its delta and the running max), 2c a nonzero step
    (q's row update) and c a sweep (max|beta|), from the sweeps and nonzero
    steps these inputs needed (the kernel's stats)."""
    sweeps = stats[:, 0].astype(np.int64)
    moves = stats[:, 1].astype(np.int64)
    flops = int((sweeps * 9 * c + moves * 2 * c).sum())
    nbytes = 4 * (c * c + c + n_alpha + n_alpha * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _spread(x) -> str:
    return f"{int(np.min(x))}/{int(np.median(x))}/{int(np.max(x))}"


def _timed(label: str, c: int, solve, reps: int) -> dict:
    """One kernel alone: a warm-up, then the mean of `reps` launches from
    CUDA events, printed beside the work its stats count and the bound."""
    import torch

    A = A_GRID
    stats = torch.zeros((A, 2), dtype=torch.int32, device="cuda")
    solve(stats)                                                   # warm-up
    ms, _ = _time_ms(lambda: solve(None), reps)
    st = stats.cpu().numpy()
    bound = _cd_bound(c, A, st)
    print(f"[kernel] {label} c={c} A={A}: {ms:.3f} ms; sweeps min/median/max "
          f"{_spread(st[:, 0])}, nonzero steps {_spread(st[:, 1])}; "
          f"{bound['flops']:,} FLOP, {bound['bytes']:,} B, bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"({100 * bound['bound_ms'] / ms:.2f}% of it)", flush=True)
    return {"ms": ms, **bound}


def _check_vs_plain(label: str, c: int, got, ref, stats, stats_ref) -> float:
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    if not torch.equal(lasso.support_mask(got), lasso.support_mask(ref)):
        raise AssertionError(f"{label} c={c}: kernel and plain supports differ")
    err = float((got - ref).abs().max())
    if err != 0.0:
        raise AssertionError(f"{label} c={c}: max|kernel-plain| = {err}, want 0")
    if not torch.equal(stats, stats_ref):
        raise AssertionError(f"{label} c={c}: sweeps / nonzero steps differ "
                             "from the plain version's")
    return err


def _inf_skip(label: str, gram, device) -> None:
    """Alphas of +inf, as the fused search passes once it is done: betas
    exactly 0 and one sweep with no nonzero step for every alpha."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd

    alphas = torch.full((A_GRID,), float("inf"), device=device)
    stats = torch.zeros((A_GRID, 2), dtype=torch.int32, device=device)
    ms, got = _time_ms(lambda: lasso_cd.cd_solve_grid(gram.G, gram.b, alphas,
                                                      stats=stats), 1)
    st = stats.cpu().numpy()
    if not (torch.equal(got, torch.zeros_like(got)) and (st[:, 0] == 1).all()
            and (st[:, 1] == 0).all()):
        raise AssertionError(f"{label}: +inf alphas gave betas max "
                             f"{float(got.abs().max())}, stats {st.tolist()}")
    print(f"[kernel] {label} alphas +inf: betas all 0, one sweep and no "
          f"nonzero step for each of {A_GRID} alphas ({ms:.3f} ms)", flush=True)


def phase_kernel_vs_plain(device) -> dict:
    """K1 against its plain version over the full 200 sweeps at c = 256 and
    c = 512 (bit for bit, the same stats), K1 alone timed at c = 512 and
    1024, and the +inf skip. The returned numbers are those at c = 512, the
    widest consumer input of the VGG path."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd

    A = A_GRID
    for seed, c in ((0, 256), (1, 512)):
        gram, alphas = _cd_problem(seed, c, device)
        stats = torch.zeros((A, 2), dtype=torch.int32, device=device)
        stats_ref = torch.zeros_like(stats)
        got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, stats=stats)
        plain_ms, ref = _time_ms(lambda: lasso_cd.cd_solve_grid_plain(
            gram.G, gram.b, alphas, stats=stats_ref), 1)
        err = _check_vs_plain("K1", c, got, ref, stats, stats_ref)
        print(f"[kernel] K1 c={c} A={A}, 200 sweeps: supports and stats "
              f"identical, max|K1-plain| {err:.1e}; plain {plain_ms:.1f} ms",
              flush=True)
    out = {"max_abs_err": err, "plain_ms": plain_ms, "c": 512, "n_sweeps": 200}
    for seed, c in ((1, 512), (4, 1024)):
        gram, alphas = _cd_problem(seed, c, device)
        t = _timed("K1", c, lambda st: lasso_cd.cd_solve_grid(
            gram.G, gram.b, alphas, stats=st), 5)
        if c == 512:
            out.update(t)
            _inf_skip("K1 c=512", gram, device)
        else:
            out["ms_c1024"] = t["ms"]
    return out


def phase_stream_vs_plain(device) -> dict:
    """K2, through the dispatch, against the plain version over 3 sweeps at
    c = 2048 (res5b/res5c) and c = 4096 (bit for bit, the same stats), K2
    alone timed over 3 and over the full 200 sweeps, and the +inf skip. The
    returned numbers are those at c = 2048 over 3 sweeps, where the plain
    version can be timed (a full plain grid takes about a minute), with the
    200-sweep times beside them."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd

    A, out = A_GRID, {}
    for seed, c in ((2, 2048), (3, 4096)):
        gram, alphas = _cd_problem(seed, c, device, k=1, n=512)
        stats = torch.zeros((A, 2), dtype=torch.int32, device=device)
        stats_ref = torch.zeros_like(stats)
        before = (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM)
        got = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, n_sweeps=3,
                                     stats=stats)
        if (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM) != (before[0], before[1] + 1):
            raise AssertionError(f"c={c}: the dispatch did not launch K2 alone")
        plain3, ref = _time_ms(lambda: lasso_cd.cd_solve_grid_plain(
            gram.G, gram.b, alphas, n_sweeps=3, stats=stats_ref), 1)
        err = _check_vs_plain("K2", c, got, ref, stats, stats_ref)
        print(f"[kernel] K2 c={c} A={A}, 3 sweeps: supports and stats "
              f"identical, max|K2-plain| {err:.1e}; plain {plain3:.1f} ms",
              flush=True)
        t3 = _timed("K2 3 sweeps", c, lambda st: lasso_cd.cd_solve_grid(
            gram.G, gram.b, alphas, n_sweeps=3, stats=st), 5)
        t200 = _timed("K2 200 sweeps", c, lambda st: lasso_cd.cd_solve_grid(
            gram.G, gram.b, alphas, stats=st), 3)
        if c == 2048:
            out.update(t3, max_abs_err=err, plain_ms=plain3, c=2048,
                       n_sweeps=3, ms_200_sweeps=t200["ms"],
                       bound_ms_200_sweeps=t200["bound_ms"])
            _inf_skip("K2 c=2048", gram, device)
        else:
            out.update(ms_200_sweeps_c4096=t200["ms"],
                       max_abs_err=max(out["max_abs_err"], err))
        del gram, alphas, got, ref
    return out


def _tiny_agree(label: str, g, p, inputs, cfg, device, n_points: int,
                share_key=None, **targets) -> dict:
    """The pipelined pass on the card and on the CPU and the sequential pass
    on the card: identical selections, and the pipelined runs end without a
    restart."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling import sampler

    runs = {}
    for name, dev, fused in (("card", device, True),
                             ("cpu", torch.device("cpu"), True),
                             ("card sequential", device, False)):
        cache = sampler.freeze(g, params_to_torch(p, dev), inputs, device=dev,
                               n_points=n_points, seed=0, chunk_batches=4,
                               share_key=share_key)
        runs[name] = c3.solve_prune(
            g, p, cache, cfg.replace_nested("solve.fused_search", fused),
            device=dev, verbose=False, **targets)
    sel = {k: r.selections for k, r in runs.items()}
    ref = sel["cpu"]
    if any(s.keys() != ref.keys() or any(not np.array_equal(s[k], ref[k])
                                         for k in ref) for s in sel.values()):
        raise AssertionError(f"{label} selections differ: {sel}")
    if not (runs["card"].pipelined and runs["cpu"].pipelined):
        raise AssertionError(f"{label}: the pipelined pass did not run to its end")
    print(f"[{label}] pipelined on the card, pipelined on the CPU and "
          f"sequential on the card select identically in {len(ref)} layers",
          flush=True)
    return runs


def phase_tiny_vgg(device) -> None:
    from channel_pruning_tpu_torch.graph.rewrite import split_relu
    from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
    from channel_pruning_tpu_torch.utils.config import default_config

    g, params = build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)).astype(np.float32)
    _tiny_agree("tiny_vgg", g, params, inputs, default_config(), device, 10,
                channel_targets=TINY_TARGETS)


def phase_tiny_resnet(device) -> None:
    """Gates on every block input and shrink targets on branch2a/2b, as in
    tests/test_resnet_pipeline.py, band=bottom."""
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling import sampler
    from channel_pruning_tpu_torch.graph.ir import LT
    from channel_pruning_tpu_torch.models.resnet import build_tiny_resnet
    from channel_pruning_tpu_torch.utils.config import default_config

    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    inputs = np.random.default_rng(11).normal(0, 1, (8, 4, 3, 32, 32)).astype(np.float32)
    cfg = default_config().replace_nested("solve.band", "bottom")
    ct = {c: max(2, int(int(g.layer(c).attr("num_output")) * 0.7))
          for c in g.convs if c.endswith(("branch2a", "branch2b"))}
    it = {c: max(2, int(p[c]["W"].shape[1] * 0.7))
          for c in g.convs if c.endswith("branch2a")}
    runs = _tiny_agree("tiny_resnet", g, p, inputs, cfg, device, 8,
                       share_key=sampler.resnet_share_key(g),
                       channel_targets=ct, input_targets=it)
    gates = len(runs["card"].graph.by_type(LT.SELECT))
    if gates != len(it):
        raise AssertionError(f"{gates} Select gates, want {len(it)}")
    print(f"[tiny_resnet] {gates} Select gates", flush=True)


def phase_tiny_3c(device) -> None:
    """The tiny VGG through 3C (every conv after the first decomposed at
    the CLI's rank, the full ALS/ITQ schedules, the arms on the fused
    search) on the card and on the CPU: the same structure and selections."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.graph.rewrite import split_relu
    from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling import sampler
    from channel_pruning_tpu_torch.utils.config import default_config

    g, params = build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)).astype(np.float32)
    ranks = {c: int(g.layer(c).attr("num_output")) for c in g.convs[1:]}
    runs = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        cache = sampler.freeze(g, params_to_torch(params, dev), inputs,
                               device=dev, n_points=10, seed=0, chunk_batches=4)
        runs[name] = c3.solve_3c(g, params, cache, default_config(), ranks,
                                 device=dev, verbose=False)
    card, cpu = runs["card"], runs["cpu"]
    shapes = [{l.name: r.params[l.name]["W"].shape for l in r.graph.layers
               if l.type == "Convolution"} for r in (card, cpu)]
    if shapes[0] != shapes[1]:
        raise AssertionError(f"tiny 3C structure differs: {shapes}")
    sel = (card.selections, cpu.selections)
    if sel[0].keys() != sel[1].keys() or any(
            not np.array_equal(sel[0][k], sel[1][k]) for k in sel[1]):
        raise AssertionError(f"tiny 3C selections differ: {sel}")
    if card.itq_degraded or card.undecomposed:
        raise AssertionError(f"tiny 3C on the card: VH-only {card.itq_degraded}, "
                             f"untouched {card.undecomposed}")
    worst = max(abs(a.rmse_after - b.rmse_after) / max(b.rmse_after, 1e-12)
                for a, b in zip(card.reports, cpu.reports))
    print(f"[tiny_3c] 3C on the card and on the CPU: the same {len(shapes[0])} "
          f"convs and shapes and the same selections in {len(sel[1])} arms; "
          f"largest relative rMSE difference {worst:.2e}", flush=True)


def _prune(model: str, speed: str, work: Path, *extra: str, mode: str = "prune"):
    from channel_pruning_tpu_torch import cli

    shutil.rmtree(work, ignore_errors=True)
    return cli.main(["prune", "--model", model, "--mode", mode,
                     "--speed", speed, "--device", "cuda",
                     "--work-dir", str(work), *extra])


def _prune_vgg16(work: Path, *extra: str):
    return _prune("vgg16", "5.0", work, *extra)


def _prune_resnet50(work: Path, *extra: str):
    return _prune("resnet50", "2.0", work, *extra)


def _check_pipelined(label: str, res) -> None:
    """The pipelined pass ran to its end (no restart on the sequential
    path), with each layer's dispatch under the sync check."""
    from channel_pruning_tpu_torch.pipeline import c3

    if not c3.CHECK_DISPATCH_SYNC:
        raise AssertionError("the dispatch sync check is off")
    if not res.pipelined or any(r.grids is None for r in res.reports):
        raise AssertionError(f"{label}: the pipelined pass did not run to "
                             "its end")
    grids = [r.grids for r in res.reports]
    print(f"[{label}] pipelined pass ran to its end, no restart; every "
          f"layer's dispatch passed set_sync_debug_mode('error'); CD grids "
          f"solved per layer min/median/max {_spread(grids)}, total "
          f"{sum(grids)}", flush=True)


def phase_profile(label: str, prune, wall: float) -> None:
    """`--profile`: a main path once more under torch.profiler (device
    activity only). Device busy time is the sum of the kernels' and copies'
    self device times; the idle share is given against the profiled run's
    wall and against the unprofiled main-path run's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prune(WORK / f"{label}_profiled")
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e6, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    cd = [r for r in rows if "lasso_cd" in r[2]]
    cd_s = sum(r[0] for r in cd)
    print(f"[profile] {label}: device busy {busy:.3f}s; profiled wall "
          f"{pwall:.2f}s (idle {1 - busy / pwall:.1%}); unprofiled wall "
          f"{wall:.2f}s (idle {1 - busy / wall:.1%}); CD kernels {cd_s:.3f}s "
          f"({cd_s / busy:.1%} of busy, {sum(r[1] for r in cd)} launches)")
    for s, n, key in rows[:10]:
        print(f"[profile] {label} {s:8.3f}s {100 * s / busy:5.1f}% {n:6d}x {key[:100]}")


def _probs_on(device, prefix: Path, x=None):
    """Reload an exported model and run one batch to its probabilities: `x`,
    or a synthetic batch of the model's input shape. Returns (graph, the
    batch, the probabilities)."""
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs

    g, p = import_model(f"{prefix}.prototxt", f"{prefix}.caffemodel")
    spec = g.inputs[0]
    if x is None:
        x = SyntheticInputs(1, spec.shape[0], tuple(spec.shape[1:])).batch(0).to(device)
    outs, _ = run_graph(g, params_to_torch(p, device), {spec.name: x})
    return g, x, outs["prob"]


def _gives_probabilities(prob) -> bool:
    """Finite rows that sum to 1."""
    import torch

    return bool(torch.isfinite(prob).all() and torch.allclose(
        prob.sum(-1), torch.ones_like(prob[:, 0]), atol=1e-4))


def phase_main_path(device):
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.models.vgg import build_vgg16
    from channel_pruning_tpu_torch.utils.flops import total_flops

    work = WORK / "vgg16"
    torch.cuda.reset_peak_memory_stats(device)
    lasso_cd.LAUNCHES = lasso_cd.LAUNCHES_STREAM = 0
    t0 = time.perf_counter()
    res = _prune_vgg16(work)
    wall = time.perf_counter() - t0
    launches = {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM}
    peak = torch.cuda.max_memory_allocated(device)

    _check_pipelined("main", res)
    _check_vgg_counts(work, res)
    # conv1_2 starts from an exact input (rMSE ~0, 0.345 after on the card);
    # conv2_1, keeping 22 of 64 random-weight channels, ends above its start
    # in the JAX package too (tests/test_torch_pipeline.py::
    # test_vgg16_64px_rmse_matches_jax), 0.261 -> 0.325 on the card; from
    # conv2_2 on, reconstruction must beat the accumulated error
    if res.reports[0].rmse_before >= 1e-4:
        raise AssertionError(f"first layer starts at rMSE {res.reports[0].rmse_before}")
    for i, r in enumerate(res.reports):
        bound = (0.5, 1.5 * r.rmse_before)[i] if i < 2 else r.rmse_before
        if not (r.rmse_after < bound and np.isfinite(r.rmse_after)):
            raise AssertionError(f"{r.conv}: rMSE {r.rmse_before} -> "
                                 f"{r.rmse_after}, bound {bound}")
    if launches["k1"] <= 0:
        raise AssertionError("the main path never launched the CD kernel")

    g, _, prob = _probs_on(device, work / "cp_vgg16")
    if not _gives_probabilities(prob):
        raise AssertionError("exported model does not give probabilities")

    orig = total_flops(build_vgg16(), include_fc=False)
    new = total_flops(g, include_fc=False)
    print("[main] layer       keep      rMSE before -> after   grids  dispatch-to-drain s")
    for r in res.reports:
        print(f"[main] {r.conv:<10s} {r.kept:>4d}/{r.total:<4d} {r.rmse_before:.4f} -> "
              f"{r.rmse_after:.4f}      {r.grids:5d}  {r.seconds:7.3f}")
    print("[main] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; conv mults {orig:,} -> {new:,} "
          f"({orig / new:.2f}x); kernel launches K1 {launches['k1']} "
          f"K2 {launches['k2']}; "
          f"peak device memory {peak / 2**30:.2f} GiB; exported model reloads, "
          f"probabilities sum to 1", flush=True)
    return launches, wall, res


def _check_band(name: str, target: int, got, tol: float = 0.1) -> bool:
    """tools/band_check.py's rule: target <= got <= round(target * 1.1)."""
    return got is not None and target <= got <= int(round(target * (1 + tol)))


def _resnet50_structure(work: Path, res) -> tuple[list[str], str]:
    """(failures, summary) of the ResNet-50 2x structure checks on the
    exported model: widths and Select gates in the released band."""
    from channel_pruning_tpu_torch.graph.ir import LT
    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.models.resnet import (RESNET50_2X_BRANCH2A,
                                                         RESNET50_2X_BRANCH2B,
                                                         RESNET50_2X_FILTERS)

    failures = []
    if len(res.reports) != 40:
        failures.append(f"{len(res.reports)} layers solved, want 40")
    bad = [r.conv for r in res.reports
           if not (np.isfinite(r.rmse_before) and np.isfinite(r.rmse_after))]
    if bad:
        failures.append(f"rMSE not finite in {bad}")
    wide = sorted(r.conv for r in res.reports if r.total > lasso_cd.MAX_C)
    if wide != ["res5b_branch2a", "res5c_branch2a"]:
        failures.append(f"layers wider than K1's limit: {wide}")
    g, _ = import_model(work / "cp_resnet50.prototxt", work / "cp_resnet50.caffemodel")
    widths = {l.name: int(l.attr("num_output")) for l in g.by_type(LT.CONV)}
    branches = {**RESNET50_2X_BRANCH2A, **RESNET50_2X_BRANCH2B}
    out_band = {n: (t, widths.get(n)) for n, t in branches.items()
                if not _check_band(n, t, widths.get(n))}
    exact = sum(widths.get(n) == t for n, t in branches.items())
    if out_band:
        failures.append(f"branch widths outside the band (released, got): {out_band}")
    gates = {g.consumers(l.tops[0])[0].name: int(l.attr("num_output"))
             for l in g.by_type(LT.SELECT) if not l.attr("passthrough", False)}
    gates_out = {n: (t, gates.get(n)) for n, t in RESNET50_2X_FILTERS.items()
                 if not _check_band(n, t, gates.get(n))}
    gates_exact = sum(gates.get(n) == t for n, t in RESNET50_2X_FILTERS.items())
    if len(gates) != 16 or gates_out:
        failures.append(f"{len(gates)} Select gates; outside the band: {gates_out}")
    summary = (f"branch widths in the released band {len(branches) - len(out_band)}"
               f"/{len(branches)} ({exact} exact); Select gates {len(gates)}, in "
               f"band {len(RESNET50_2X_FILTERS) - len(gates_out)}/16 "
               f"({gates_exact} exact)")
    return failures, summary


def phase_resnet50(device):
    """The ResNet-50 2x main path through the CLI with its defaults."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.models.resnet import build_resnet50
    from channel_pruning_tpu_torch.utils.flops import total_flops

    work = WORK / "resnet50"
    torch.cuda.reset_peak_memory_stats(device)
    lasso_cd.LAUNCHES = lasso_cd.LAUNCHES_STREAM = 0
    t0 = time.perf_counter()
    res = _prune_resnet50(work)
    wall = time.perf_counter() - t0
    launches = {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM}
    peak = torch.cuda.max_memory_allocated(device)

    _check_pipelined("resnet50", res)
    print("[resnet50] layer            kind  keep       rMSE before -> after   grids  dispatch-to-drain s")
    for r in res.reports:
        print(f"[resnet50] {r.conv:<16s} {r.kind:<5s} {r.kept:>4d}/{r.total:<4d} "
              f"{r.rmse_before:.4f} -> {r.rmse_after:.4f}      {r.grids:5d}  "
              f"{r.seconds:7.3f}")
    failures, summary = _resnet50_structure(work, res)
    if launches["k1"] <= 0 or launches["k2"] <= 0:
        failures.append(f"K1 launches {launches['k1']}, K2 {launches['k2']}")
    g, _, prob = _probs_on(device, work / "cp_resnet50")
    if not _gives_probabilities(prob):
        failures.append("exported model does not give probabilities")
    orig = total_flops(build_resnet50(), include_fc=False)
    new = total_flops(g, include_fc=False)
    print(f"[resnet50] {summary}")
    print("[resnet50] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; conv mults {orig:,} -> {new:,} "
          f"({orig / new:.2f}x); kernel launches K1 {launches['k1']} K2 "
          f"{launches['k2']}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    if failures:
        raise AssertionError("ResNet-50 2x: " + "; ".join(failures))
    print("[resnet50] exported model reloads, probabilities sum to 1", flush=True)
    return launches, wall, res


def phase_vgg16_3c(device):
    """The 3C main path, `cli prune --model vgg16 --mode 3c --speed 4.0`
    from scratch with its defaults, then `cli combine` and `cli flop` on
    its export."""
    import warnings

    import torch

    from channel_pruning_tpu_torch import cli
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.models.vgg import build_vgg16
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.utils.config import default_config
    from channel_pruning_tpu_torch.utils.flops import total_flops

    work = WORK / "vgg16_3c"
    torch.cuda.reset_peak_memory_stats(device)
    lasso_cd.LAUNCHES = lasso_cd.LAUNCHES_STREAM = 0
    real_solve, syncs = c3.solve_3c, []

    def counted_solve(*a, **kw):
        """The solve under set_sync_debug_mode("warn"): each host sync
        warns once, and the warnings are counted."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real_solve(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.append(sum("synchroniz" in str(w.message) for w in caught))

    c3.solve_3c = counted_solve
    t0 = time.perf_counter()
    try:
        res = _prune("vgg16", "4.0", work, mode="3c")
    finally:
        c3.solve_3c = real_solve
    wall = time.perf_counter() - t0
    launches = {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM}
    peak = torch.cuda.max_memory_allocated(device)

    failures = []
    cfg = default_config()
    layers = [r for r in res.reports if r.kind == "3c"]
    arms = [r for r in res.reports if r.kind == "prune"]
    full = len(layers) - len(res.itq_degraded) - len(res.undecomposed)
    if (len(layers), full) != (12, 12):
        failures.append(f"{full}/{len(layers)} layers fully decomposed, want 12/12")
    bad_band = []
    for r in arms:
        d_c = int(np.floor(r.total / cfg.dic.c_ratio))
        if not d_c <= r.kept <= d_c + cfg.dic.rank_tol * d_c:
            bad_band.append((r.conv, d_c, r.kept))
    if len(arms) != 11 or bad_band:
        failures.append(f"{len(arms)} arms, out of band (d_c, kept): {bad_band}")
    bad = [r.conv for r in res.reports
           if not (np.isfinite(r.rmse_before) and np.isfinite(r.rmse_after))]
    if bad:
        failures.append(f"rMSE not finite in {bad}")
    if launches["k1"] <= 0 or any(not r.grids for r in arms):
        failures.append(f"K1 launches {launches['k1']}, grids "
                        f"{[r.grids for r in arms]}")

    g3, x, prob = _probs_on(device, work / "3C_vgg16")
    if not _gives_probabilities(prob):
        failures.append("the 3C export does not give probabilities")
    t = time.perf_counter()
    _, _, err = cli.main(["combine", "--prototxt", str(work / "3C_vgg16.prototxt"),
                          "--weights", str(work / "3C_vgg16.caffemodel"),
                          "--device", "cuda", "--work-dir", str(work)])
    t_combine = time.perf_counter() - t
    _, _, prob_cb = _probs_on(device, work / "cb_vgg16", x)
    cb_err = float((prob_cb - prob).abs().max())
    if not (err < 1e-4 and cb_err < 1e-4):
        failures.append(f"combine changes the output: in memory {err}, "
                        f"reloaded {cb_err}")
    mults_cb = cli.main(["flop", "--prototxt", str(work / "cb_vgg16.prototxt")])
    orig = total_flops(build_vgg16(), include_fc=False)
    mults_3c = total_flops(g3, include_fc=False)

    print("[vgg16_3c] layer    rank  rMSE VH -> final   arm keep     arm rMSE "
          "before -> after  grids  s spatial (svd) channel (itq loop, svd) arm ckpt-wait")
    arm_of, last = {}, None        # each decomposed layer's arm report
    for r in res.reports:
        if r.kind == "3c":
            last = r.conv
            arm_of[last] = None
        else:
            arm_of[last] = r
    for r in layers:
        a, ph = arm_of[r.conv], r.phases
        arm = (f"{a.conv:<8s} {a.kept:>3d}/{a.total:<3d} {a.rmse_before:.4f} -> "
               f"{a.rmse_after:.4f}  {a.grids:5d}" if a else " " * 41)
        print(f"[vgg16_3c] {r.conv:<8s} {r.rank:>4d}  {r.rmse_before:.4f} -> "
              f"{r.rmse_after:.4f}   {arm}  {ph['spatial']:6.2f} "
              f"({ph['svd_host']:.2f}) {ph['channel']:6.2f} ({ph['itq_loop']:.2f}, "
              f"{ph['itq_svd_host']:.2f}) {a.seconds if a else 0.0:5.2f} "
              f"{ph.get('checkpoint', 0.0):5.2f}")
    writes = res.checkpoint_writes
    phase_sum = {k: sum(r.phases.get(k, 0.0) for r in layers)
                 for k in ("replay", "svd_host", "spatial", "itq_loop",
                           "itq_svd_host", "channel", "checkpoint")}
    print(f"[vgg16_3c] totals: spatial {phase_sum['spatial']:.2f}s (replay "
          f"{phase_sum['replay']:.2f}, host SVD {phase_sum['svd_host']:.2f}), "
          f"channel {phase_sum['channel']:.2f}s (ITQ loop "
          f"{phase_sum['itq_loop']:.2f}, host SVD {phase_sum['itq_svd_host']:.2f}), "
          f"arms {sum(a.seconds for a in arms):.2f}s, checkpoint waits "
          f"{phase_sum['checkpoint']:.2f}s; {len(writes)} background checkpoint "
          f"writes {sum(writes):.2f}s (min/max {min(writes or [0]):.2f}/"
          f"{max(writes or [0]):.2f}); host syncs in the solve {syncs[0]} "
          f"(set_sync_debug_mode), of which ITQ eigh "
          f"{(len(layers) - len(res.undecomposed)) * sum(cfg.solve.itq_iters)}",
          flush=True)
    print(f"[vgg16_3c] {full}/{len(layers)} layers fully decomposed (VH+ITQ), "
          f"{len(res.itq_degraded)} VH-only, {len(res.undecomposed)} untouched; "
          f"{len(arms) - len(bad_band)}/{len(arms)} arms in band on K1 "
          f"({launches['k1']} launches, {sum(r.grids or 0 for r in arms)} grids "
          f"solved); conv mults {orig:,} -> {mults_3c:,} ({orig / mults_3c:.2f}x) "
          f"-> combine {mults_cb:,} ({orig / mults_cb:.2f}x); combine "
          f"{t_combine:.2f}s, max |prob difference| {err:.2e} in memory, "
          f"{cb_err:.2e} reloaded", flush=True)
    print("[vgg16_3c] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; kernel launches K1 {launches['k1']} K2 "
          f"{launches['k2']}; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    if failures:
        raise AssertionError("VGG-16 3C 4x: " + "; ".join(failures))
    print("[vgg16_3c] the 3C export reloads, its probabilities sum to 1, and "
          "the combined model gives them", flush=True)
    return launches, wall, res


def phase_sequential(label: str, prune, piped, check) -> None:
    """A main path once more on the sequential path (host-stepped search,
    float64 grid endpoints): `check` holds its structure; how many layers
    select as the pipelined pass did, and the lowest IoU, are printed."""
    work = WORK / f"{label}_sequential"
    t0 = time.perf_counter()
    res = prune(work, "--set", "solve.fused_search=False")
    wall = time.perf_counter() - t0
    if res.pipelined:
        raise AssertionError(f"{label}: the sequential run took the pipelined pass")
    check(work, res)
    same, ious = 0, []
    for name, keep in piped.selections.items():
        other = res.selections[name]
        same += bool(np.array_equal(keep, other))
        ious.append((keep & other).sum() / max((keep | other).sum(), 1))
    worst = int(np.argmin(ious))
    print(f"[{label}] sequential pass: wall {wall:.2f}s (solve "
          f"{res.wall['solve']:.2f}s); {same}/{len(ious)} layers select as the "
          f"pipelined pass, lowest IoU {ious[worst]:.3f} "
          f"({list(piped.selections)[worst]})", flush=True)


def _check_vgg_counts(work: Path, res) -> None:
    from channel_pruning_tpu_torch.models.vgg import VGG16_5X_CHANNELS

    pruned = {p: t for p, t in VGG16_5X_CHANNELS.items() if t < 512}
    got = {p: int(res.params[p]["W"].shape[0]) for p in pruned}
    if got != pruned:
        raise AssertionError(f"keep counts {got} != released table {pruned}")


def _check_resnet_bands(work: Path, res) -> None:
    failures, summary = _resnet50_structure(work, res)
    if failures:
        raise AssertionError("ResNet-50 2x sequential: " + "; ".join(failures))
    print(f"[resnet50] sequential: {summary}")


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke run of the port on one card")
    parser.add_argument("--profile", action="store_true",
                        help="also run the main paths under torch.profiler and "
                             "print device busy time, idle share and top kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.pipeline import c3

    card = _card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    device = resolve_device("cuda")

    t = time.perf_counter()
    lasso_cd.build()
    print(f"[build] lasso_cd.cu (K1, K2) -> sm_90a in {time.perf_counter() - t:.2f}s",
          flush=True)
    for line in lasso_cd.ptxas_report().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    stats = phase_kernel_vs_plain(device)
    stream = phase_stream_vs_plain(device)
    # every pipelined dispatch from here on runs under the sync check
    c3.CHECK_DISPATCH_SYNC = True
    phase_tiny_vgg(device)
    phase_tiny_resnet(device)
    phase_tiny_3c(device)
    vgg, wall, vgg_res = phase_main_path(device)
    r50, r50_wall, r50_res = phase_resnet50(device)
    v3c, v3c_wall, _ = phase_vgg16_3c(device)
    phase_sequential("main", _prune_vgg16, vgg_res, _check_vgg_counts)
    phase_sequential("resnet50", _prune_resnet50, r50_res, _check_resnet_bands)
    if args.profile:
        phase_profile("vgg16", _prune_vgg16, wall)
        phase_profile("resnet50", _prune_resnet50, r50_wall)
        phase_profile("vgg16_3c", lambda work: _prune("vgg16", "4.0", work,
                                                      mode="3c"), v3c_wall)

    print(card)
    source = "channel_pruning_tpu_torch/csrc/lasso_cd.cu"
    # library_ms: no PyTorch call computes Gram-form coordinate descent
    print(json.dumps({"kernels": [
        {"name": "lasso_cd_grid", "route": "cuda", "source": source,
         "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:85",
         "launches": vgg["k1"] + r50["k1"] + v3c["k1"],
         "launches_by_path": {"vgg16_5x": vgg["k1"], "resnet50_2x": r50["k1"],
                              "vgg16_3c_4x": v3c["k1"]},
         "library_ms": None, **stats},
        {"name": "lasso_cd_grid_stream", "route": "cuda", "source": source,
         "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:209",
         "launches": vgg["k2"] + r50["k2"] + v3c["k2"],
         "launches_by_path": {"vgg16_5x": vgg["k2"], "resnet50_2x": r50["k2"],
                              "vgg16_3c_4x": v3c["k2"]},
         "library_ms": None, **stream}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
