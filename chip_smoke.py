#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (channel_pruning_tpu_torch) on one
NVIDIA card:

    python3 chip_smoke.py [--profile] [--seed N]

Phases, each printing its own lines; any failure raises (exit code != 0):
  1. the card: torch.cuda must be available; nvidia-smi name and power limit;
  2. build the LASSO CD kernels K1 and K2 (csrc/lasso_cd.cu) and the group
     lasso's block CD kernel K3 (csrc/group_cd.cu) from the checkout, one
     nvcc a source side by side, and print ptxas's registers / shared
     memory per kernel;
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
  3c. K3 against its plain version on seeded 1x1-consumer problems, 16
     alphas: (c, n) = (256, 256) over 200 sweeps, (2048, 512) and (512,
     2048) (ResNet-50's res5 shapes) over 3: B bit for bit and the same
     per-alpha sweeps and moving rows; each shape's launch plan (variant,
     K blocks a cluster, clusters resident at once) and ptxas's registers
     and shared memory for K3; K3 timed with CUDA events beside its
     sweeps, moving rows and bound, the plain version at each shape, and
     K3 alone over 20 sweeps at the res5 shapes;
  3d. the bf16 replay conv (`ops/forward._conv2d`, the JAX package's
     semantics: operands rounded to bf16, f32 products, sums and output) at
     every distinct conv shape of VGG-16 at 224² (the frontier's 100-image
     groups) and of the Faster-RCNN backbone at 600² (40 images a replay
     step, the RPN conv and heads included): within 1e-5 of the largest
     |value| of the f32 conv (TF32 off) of the same rounded operands; per
     shape the route (cuDNN with TF32 for that call, or TF32 off where TF32
     was not exact) and the ms of that route, of the f32 conv and of the
     native bf16 conv (timed for comparison only); TF32 off afterwards, and
     after every `cli prune` of the later phases;
  4. the tiny VGG (in f32 and in bf16) and the tiny ResNet (Select gates,
     residual compensation, DAG frontier, band=bottom) through the default
     pipelined pass on the card and on the CPU, and the sequential pass on
     the card: identical selections, and the pipelined pass runs to its
     end;
  4b. the tiny VGG through 3C (VH, ITQ and the pruning arm, full schedules)
     on the card and on the CPU: the same structure and selections;
  4c. `cli prune --model tiny_resnet --speed 1.2 --set dic.grplasso=true` on
     the card and on the CPU (the sequential path; the 1x1 consumers on
     K3): identical selections; and 4b with dic.grplasso on the tiny VGG
     with conv3_1 cut to 1x1 and left undecomposed, so that conv2_2's arm
     prunes a 1x1 consumer by group lasso (K3 launched on the card);
  5. the main path, `cli prune --model vgg16 --mode prune --speed 5.0
     --device cuda` with its defaults (the pipelined pass with the fused
     search, bf16 replays as for every VGG-family graph; 50 x 10 synthetic
     calibration images, random He-init weights):
     the pass runs to its end with no restart, every layer's dispatch under
     torch.cuda.set_sync_debug_mode("error") (a host sync there raises),
     keep counts equal the released 5x table, the first layer starts from
     an input exact but for bf16's rounding (rMSE below 2^-8),
     reconstruction beats the accumulated error from the third pruned
     layer on (the first two end above their start on random
     weights in the JAX package too, and are held to fixed bounds near
     their observed values), the kernel was launched, and the exported
     model reloads and runs to finite probabilities that sum to 1; then
     once more with `--set solve.dtype=float32` on a copy of its frozen
     cache: the same masks in every layer, every final rMSE within 1e-3,
     the first layer from an exact input (rMSE below 1e-4), both walls
     printed;
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
     skipped, the pruning arms on the fused search, bf16 replays), then
     `cli combine` and `cli flop` on its export: 12/12 layers fully
     decomposed (VH+ITQ), each of the 11 arms keeps a count in the search's
     band [d_c, d_c + rank_tol d_c] above d_c = floor(C_out / dic.c_ratio),
     every rMSE finite, K1
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
  5e. the mesh (parallel/mesh, parallel/sharded), right after 5b: 4
     logical shards on the card, and every card too when there are more:
     the LASSO Gram and the least-squares fit at conv3_1's scale (N =
     50,000 rows of 3x3 patches, c = 256, n = 512) sharded against local
     at tests/test_parallel.py's tolerances, both timed; `cli prune` of
     VGG-16 5x and of ResNet-50 2x with the solve on the mesh, on copies
     of 5's and 5b's frozen caches: the pipelined pass to its end under
     the sync check, the released 5x counts exactly, every ResNet-50 width
     and gate in its band, K1 (and K2) launched, how many layers select as
     the one-device run (a differing layer prints both runs' rMSEs) and
     both walls; one finetune step of cp_vgg16 at batch 32 over the mesh
     against the one-device step (dropout on, one generator): loss rtol
     1e-5, weights rtol 1e-4 atol 1e-6;
  5f. the native host codecs (csrc/caffemodel.cpp, csrc/preprocess.cpp,
     built with g++ beside the nvcc builds): the He-init VGG-16 exported
     (~553 MB) and read back by the native indexer and by the Python walk,
     equal records, no counted fallback, both times; the C++/OpenMP
     preprocess of 50 seeded 375x500 images against pipeline.preprocess,
     both timed, within tests/test_native.py's bounds;
  6. training at full VGG-16 width, from the main path's cp_vgg16: one train
     step (dropout off) at batch 2 on the card and on the CPU from the same
     parameters and batch: in f64 the losses to 1e-10 and each blob's change
     to 1e-6 of its largest change; in f32, against the CPU's f64 step, the
     loss to 1e-4 and the gradients as one vector to 2e-2; `cli finetune` 20 steps at batch 32 on
     synthetic batches, lr 1e-5, Nesterov (every loss finite; ms/step,
     images/s, peak memory), and the train step alone on one device-resident
     batch; `cli eval` over 5 batches (160 images); `cli time --per-layer
     --compare-prototxt` (VGG-16 against cp_vgg16 at batch 32: the per-layer
     table and the measured speed-up beside the conv-mult ratio); `cli
     time --loop-steps` of both nets in f32 and bf16 (images/s, MFU); `cli
     deploy` of cp_vgg16, whose reloaded .pt2 gives run_graph's
     probabilities to 1e-5;
  7. the accuracy loop on a seeded, learnable task (`--seed`): raw-Datum
     LMDBs written with the port's write_lmdb (1,280 training and 320
     held-out 32x32 records, one smooth template per class plus noise of a
     strength drawn per record), then `cli finetune` of digits_vgg from
     scratch, `cli eval`, `cli prune --data-dir --speed 16.0` (K1), `cli
     eval`, `cli finetune` to recover and `cli eval`: trained top-1 >= 0.9,
     the prune costs held-out top-1 and the recovery wins some of it back
     (pruned < trained, recovered > pruned), and every artifact reloads and
     gives probabilities (their held-out cross-entropy is printed);
  8. `cli addbn` on the 3C 4x export of 5d, then one `cli finetune` step
     with clip 35: the BN count, and a finite loss;
  9. with --profile only: each main path (the 3C, Xception and
     Faster-RCNN paths too) once more under torch.profiler, with the device's busy time, idle
     share, the CD kernels' share and the top kernels;
  10. `cli prune --model xception --mode prune --speed 2.0` at 224² with
     its defaults (the pipelined pass, DAG frontier): no restart and no
     host sync in any layer's dispatch, every consumer's kept count in
     [t, round(1.1 t)] of its planned target, conv mults at least 0.97 of
     the planner's prediction, K1 and K2 (exit_sep4_pw, c = 1536) launched,
     the export reloads and gives probabilities; the depthwise convs
     shrunk, the Select gates, the wall split and the peak memory printed;
  11. `cli prune --model frcnn_vgg16 --image-size 600 --speed 5.0`: the
     calibration set's activations outgrow the frontier's 8 GB budget, so
     the sequential path replays from the input for every layer, at the
     images a step `clamp_chunk_for_hbm` allows: the same band and ratio
     checks, the RPN convs pruned, the export reloads with finite outputs;
     the split of the solve (replays, solves, the host's draws of the
     synthetic images and their copies) printed; the replays in bf16 (the
     VGG-family default), then once more in f32 on a copy of the frozen
     cache: its band and ratio checks, the count of masks that differ,
     both walls and the replays' seconds;
  12. `cli prune --model vgg16 --speed 4.0 --set dic.fitfc=true`: the
     pipelined conv pass, then conv5_3 pruned through fc6 (a dense capture,
     the single-task search on K1 over 7x7 patches, the refit of fc6 on
     kept x 49 columns): conv5_3's width equals fc6's kept count, fc6's
     weight columns are sliced to match, the export gives probabilities;
  13. `cli prune --model vgg16 --speed 5.0 --set solve.autodet=true`: the
     sequential path with one fixed-alpha LASSO a layer (K1 once a layer),
     every keep count above 0, the export reloads.
The next-to-last line is a JSON record of the kernels (K1, K2, K3, with
launches per path, the mesh runs' among them); the last line is
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


def _zero_launches() -> None:
    """Set every kernel's launch count to 0 (just before a main path)."""
    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd

    lasso_cd.LAUNCHES = lasso_cd.LAUNCHES_STREAM = group_cd.LAUNCHES = 0


def _launches() -> dict:
    """Every kernel's launch count since `_zero_launches` (K1, K2, K3)."""
    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd

    return {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM,
            "k3": group_cd.LAUNCHES}


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
    _tiny_agree("tiny_vgg_bf16", g, params, inputs,
                default_config().replace_nested("solve.dtype", "bfloat16"),
                device, 10, channel_targets=TINY_TARGETS)
    _tf32_off()


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


def phase_tiny_3c(device, grplasso: bool = False) -> dict:
    """The tiny VGG through 3C (every conv after the first decomposed at
    the CLI's rank, the full ALS/ITQ schedules, the arms on the fused
    search) on the card and on the CPU: the same structure and selections.
    With `grplasso`, conv3_1 is cut to its centre tap (1x1) and left
    undecomposed, so conv2_2's arm prunes a 1x1 consumer by group lasso:
    K3 must launch on the card. Returns the card run's launches."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.graph.rewrite import set_conv, split_relu
    from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling import sampler
    from channel_pruning_tpu_torch.utils.config import default_config

    label = "tiny_3c_grplasso" if grplasso else "tiny_3c"
    g, params = build_tiny_vgg(batch=4, image_size=16)
    cfg = default_config()
    if grplasso:
        g, params = set_conv(g, params, "conv3_1",
                             W=params["conv3_1"]["W"][:, :, 1:2, 1:2],
                             pad_h=0, pad_w=0)
        cfg = cfg.replace_nested("dic.grplasso", True)
    g = split_relu(g)
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)).astype(np.float32)
    ranks = {c: int(g.layer(c).attr("num_output")) for c in g.convs[1:]
             if not (grplasso and c == "conv3_1")}
    runs = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        cache = sampler.freeze(g, params_to_torch(params, dev), inputs,
                               device=dev, n_points=10, seed=0, chunk_batches=4)
        _zero_launches()
        runs[name] = c3.solve_3c(g, params, cache, cfg, ranks,
                                 device=dev, verbose=False)
        if name == "card":
            launches = _launches()
    card, cpu = runs["card"], runs["cpu"]
    shapes = [{l.name: r.params[l.name]["W"].shape for l in r.graph.layers
               if l.type == "Convolution"} for r in (card, cpu)]
    if shapes[0] != shapes[1]:
        raise AssertionError(f"{label} structure differs: {shapes}")
    sel = (card.selections, cpu.selections)
    if sel[0].keys() != sel[1].keys() or any(
            not np.array_equal(sel[0][k], sel[1][k]) for k in sel[1]):
        raise AssertionError(f"{label} selections differ: {sel}")
    if card.itq_degraded or card.undecomposed:
        raise AssertionError(f"{label} on the card: VH-only {card.itq_degraded}, "
                             f"untouched {card.undecomposed}")
    if grplasso and not (launches["k3"] > 0 and "conv3_1" in sel[0]):
        raise AssertionError(f"{label}: K3 launches {launches['k3']}, arms "
                             f"{sorted(sel[0])}")
    worst = max(abs(a.rmse_after - b.rmse_after) / max(b.rmse_after, 1e-12)
                for a, b in zip(card.reports, cpu.reports))
    print(f"[{label}] 3C on the card and on the CPU: the same {len(shapes[0])} "
          f"convs and shapes and the same selections in {len(sel[1])} arms; "
          f"largest relative rMSE difference {worst:.2e}; card launches "
          f"K1 {launches['k1']} K3 {launches['k3']}", flush=True)
    return launches


def _tf32_off() -> None:
    """TF32 stays off process-wide (`device.fp32_solver`): the bf16 conv
    turns it on for its own call only."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if flags != (False, False):
        raise AssertionError(f"TF32 flags (cudnn, matmul) left at {flags}")


def _prune(model: str, speed: str, work: Path, *extra: str, mode: str = "prune",
           cache_from: Path | None = None):
    """`cli prune` in a fresh work dir; with `cache_from`, on a copy of that
    run's frozen cache (so two runs solve one cache). The TF32 flags must
    be off after it."""
    from channel_pruning_tpu_torch import cli

    shutil.rmtree(work, ignore_errors=True)
    if cache_from is not None:
        work.mkdir(parents=True)
        for f in cache_from.glob("frozen_*.npz"):
            shutil.copy(f, work / f.name)
    res = cli.main(["prune", "--model", model, "--mode", mode,
                    "--speed", speed, "--device", "cuda",
                    "--work-dir", str(work), *extra])
    _tf32_off()
    return res


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
    # fitfc's FC report comes after the pass, from no grid search
    convs = [r for r in res.reports if r.kind != "fc"]
    if not res.pipelined or any(r.grids is None for r in convs):
        raise AssertionError(f"{label}: the pipelined pass did not run to "
                             "its end")
    grids = [r.grids for r in convs]
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

    from channel_pruning_tpu_torch.models.vgg import build_vgg16
    from channel_pruning_tpu_torch.utils.flops import total_flops

    work = WORK / "vgg16"
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    res = _prune_vgg16(work)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(device)

    _check_pipelined("main", res)
    _check_vgg_counts(work, res)
    # conv1_2's input is exact but for the bf16 replay's rounding of
    # conv1_1's operands (rMSE 2.3e-3, held below bf16's relative spacing
    # 2^-8; the f32 leg holds it below 1e-4), 0.345 after on the card;
    # conv2_1, keeping 22 of 64 random-weight channels, ends above its start
    # in the JAX package too (tests/test_torch_pipeline.py::
    # test_vgg16_64px_rmse_matches_jax), 0.261 -> 0.325 on the card; from
    # conv2_2 on, reconstruction must beat the accumulated error
    if res.reports[0].rmse_before >= 2.0 ** -8:
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

    from channel_pruning_tpu_torch.models.resnet import build_resnet50
    from channel_pruning_tpu_torch.utils.flops import total_flops

    work = WORK / "resnet50"
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    res = _prune_resnet50(work)
    wall = time.perf_counter() - t0
    launches = _launches()
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
    from channel_pruning_tpu_torch.models.vgg import build_vgg16
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.utils.config import default_config
    from channel_pruning_tpu_torch.utils.flops import total_flops

    work = WORK / "vgg16_3c"
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
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
    launches = _launches()
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


# The accuracy loop's seeded task: 10 classes, each one smooth template
# (mid-grey plus `contrast` times a uniform [-1, 1] pattern of 4 x 4 blocks,
# in BGR) plus Gaussian pixel noise whose standard deviation is drawn per
# record from `noise`, clipped to uint8. The noisy records keep the
# held-out top-1 below 1, so that what a prune costs shows there. Set on
# the CPU (tools/task_calibration.py) so that the JAX package's CLI,
# trained on the same LMDB with the same schedule, also reaches top-1 >= 0.9
# on the held-out records. A 4x prune costs this task no held-out top-1 on
# the CPU, and 24x and more can kill the net: the loop prunes at 16x.
TASK = {"size": 32, "classes": 10, "n_train": 1280, "n_val": 320,
        "contrast": 40.0, "noise": (30.0, 120.0)}
TASK_TRAIN = ["--batch", "64", "--lr", "1e-3", "--steps", "800"]
TASK_PRUNE = ["--speed", "16.0", "--batch", "16", "--cal-batches", "20",
              "--cal-batch", "16"]
TASK_RECOVER = ["--batch", "64", "--lr", "3e-4", "--steps", "400"]


def write_task_lmdbs(root: Path, seed: int) -> tuple[Path, Path]:
    """(train, held-out) LMDBs of raw Datums for TASK, from `seed`."""
    from channel_pruning_tpu_torch.data.lmdb import Datum, encode_datum, write_lmdb

    size, classes = TASK["size"], TASK["classes"]
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (classes, 3, 4, 4))
    templates = 127.5 + TASK["contrast"] * np.kron(
        base, np.ones((1, 1, size // 4, size // 4)))
    out = []
    for name in ("train", "val"):
        n = TASK[f"n_{name}"]
        labels = rng.integers(0, classes, n)
        sigma = rng.uniform(*TASK["noise"], (n, 1, 1, 1))
        imgs = np.clip(templates[labels] + sigma * rng.normal(
            0, 1, (n, 3, size, size)), 0, 255)
        imgs = imgs.astype(np.uint8)
        write_lmdb(root / name, [(f"{i:08d}".encode(), encode_datum(Datum(
            channels=3, height=size, width=size, data=imgs[i].tobytes(),
            label=int(labels[i])))) for i in range(n)])
        out.append(root / name)
    return out[0], out[1]


def _one_train_step(graph, params, x, y, cfg, device, dtype):
    """(loss, updated numpy params, numpy gradients) of one train step in
    `dtype`, dropout off."""
    import torch

    from channel_pruning_tpu_torch.train import finetune as ft

    params = {n: {k: np.asarray(v, dtype) for k, v in b.items()}
              for n, b in params.items()}
    state = ft.init_state(graph, params, cfg, device=device)
    grads = {}
    # read the gradients before the update: the optimizer's multi-tensor
    # SGD adds the Nesterov term into them in place
    state.optimizer.register_step_pre_hook(lambda *_: grads.update({
        n: {k: v.grad.cpu().numpy().copy() for k, v in b.items()
            if v.grad is not None}
        for n, b in state.params.items()}))
    step = ft.build_train_step(graph, cfg)
    state, m = step(state, torch.from_numpy(x.astype(dtype)).to(device),
                    torch.from_numpy(y).to(device))
    return float(m["loss"]), state.model.to_numpy(), grads


def _blob_gaps(a, b) -> tuple[float, str, float]:
    """(the largest |a - b| of a blob over that blob's largest |b|, the
    blob, the L2 norm of a - b over all blobs over that of b) for two
    {layer: {blob: array}} dicts of the same blobs."""
    worst, where, d2, n2 = 0.0, "", 0.0, 0.0
    for n in b:
        for k in b[n]:
            d, ref = a[n][k] - b[n][k], b[n][k]
            gap = float(np.abs(d).max()) / max(float(np.abs(ref).max()), 1e-300)
            if gap > worst:
                worst, where = gap, f"{n}.{k}"
            d2 += float((d.astype(np.float64) ** 2).sum())
            n2 += float((ref.astype(np.float64) ** 2).sum())
    return worst, where, float(np.sqrt(d2 / max(n2, 1e-300)))


def phase_train_vgg16(device, seed: int) -> dict:
    """Training, eval, timing and deploy at full VGG-16 width on the main
    path's cp_vgg16 (5x): see the module docstring, phase 6."""
    import torch

    from channel_pruning_tpu_torch import cli, deploy
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.train import finetune as ft
    from channel_pruning_tpu_torch.utils.config import FinetuneConfig

    cp = WORK / "vgg16" / "cp_vgg16"
    cp_args = ["--prototxt", f"{cp}.prototxt", "--weights", f"{cp}.caffemodel"]
    out = {}

    # one step, card against CPU. The f64 step checks the function: each
    # blob's change on the card to 1e-6 of that blob's largest change on
    # the CPU (f64 rounding is far below), which a wrong gradient or update
    # on either device would break. The f32 step, the precision the port
    # trains in, is held to the CPU's f64 step: the loss to 1e-4 and each
    # device's gradients, as one vector, to 2e-2. The card's f32 backward
    # runs the deterministic cuDNN algorithms its heuristics pick
    # (benchmark off), which round more than the CPU's, and a bias whose
    # gradient is a sum that nearly cancels keeps few correct digits.
    g, params = import_model(f"{cp}.prototxt", f"{cp}.caffemodel", batch=2)
    x, y = next(ft.synthetic_batches(2, image=224, classes=1000, seed=seed))
    cfg = FinetuneConfig(base_lr=1e-2)
    t = time.perf_counter()
    cpu = torch.device("cpu")
    runs = {(d.type, np.dtype(dt).name): _one_train_step(g, params, x, y, cfg, d, dt)
            for dt in (np.float64, np.float32) for d in (cpu, device)}
    ref_loss, ref_p, ref_g = runs["cpu", "float64"]
    card_p = runs["cuda", "float64"][1]

    def change(p):
        return {n: {k: p[n][k] - np.asarray(params[n][k], p[n][k].dtype)
                    for k in p[n]} for n in p}

    c_worst, c_where, _ = _blob_gaps(change(card_p), change(ref_p))
    agree = {"float64": {
        "loss_rel": abs(runs["cuda", "float64"][0] - ref_loss) / abs(ref_loss),
        "change_blob_worst": [c_worst, c_where]}}
    for dev in ("cpu", "cuda"):
        loss, _, grads = runs[dev, "float32"]
        g_worst, g_where, g_norm = _blob_gaps(grads, ref_g)
        agree[f"float32 {dev}"] = {"loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                                   "grad_norm_rel": g_norm,
                                   "grad_blob_worst": [g_worst, g_where]}
    del runs, ref_p, card_p
    a64, c32, p32 = agree["float64"], agree["float32 cuda"], agree["float32 cpu"]
    print(f"[train] one step at batch 2, dropout off, card against CPU: f64 loss "
          f"relative {a64['loss_rel']:.1e} (bound 1e-10), worst blob change "
          f"{c_worst:.1e} of that blob's largest ({c_where}; bound 1e-6); f32 "
          f"against the CPU's f64: card loss {c32['loss_rel']:.1e}, CPU loss "
          f"{p32['loss_rel']:.1e} (bound 1e-4), card gradients as one vector "
          f"{c32['grad_norm_rel']:.1e}, CPU {p32['grad_norm_rel']:.1e} (bound "
          f"2e-2), worst blob gradient card {c32['grad_blob_worst'][0]:.1e} "
          f"({c32['grad_blob_worst'][1]}), CPU {p32['grad_blob_worst'][0]:.1e} "
          f"({p32['grad_blob_worst'][1]}); {time.perf_counter() - t:.1f}s", flush=True)
    if not (a64["loss_rel"] < 1e-10 and c_worst < 1e-6
            and c32["loss_rel"] < 1e-4 and c32["grad_norm_rel"] < 2e-2):
        raise AssertionError(f"train step: card and CPU disagree ({agree})")
    out["step_card_vs_cpu"] = agree

    # cli finetune, 20 steps at batch 32 on synthetic batches
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    state = cli.main(["finetune", *cp_args, "--batch", "32", "--steps", "20",
                      "--lr", "1e-5", "--seed", str(seed), "--device", "cuda",
                      "--work-dir", str(WORK / "vgg16_ft")])
    wall = time.perf_counter() - t
    losses = torch.stack([m["loss"] for m in state.history]).cpu().numpy()
    peak = torch.cuda.max_memory_allocated(device)
    ms = float(np.mean(state.step_ms))
    out["finetune"] = {"steps": state.step, "ms_per_step": ms,
                       "images_per_s": 32e3 / ms, "peak_gib": peak / 2**30,
                       "wall_s": wall, "loss_first": float(losses[0]),
                       "loss_last": float(losses[-1])}
    if len(losses) != 20 or not np.isfinite(losses).all():
        raise AssertionError(f"finetune losses {losses}")
    # the train step alone, on one device-resident batch
    xb, yb = next(ft.synthetic_batches(32, image=224, classes=1000, seed=seed + 1))
    xb, yb = torch.from_numpy(xb).to(device), torch.from_numpy(yb).to(device)
    step = ft.build_train_step(g, FinetuneConfig(base_lr=1e-5))
    step(state, xb, yb)
    step_ms, _ = _time_ms(lambda: step(state, xb, yb), 10)
    out["finetune"]["device_step_ms"] = step_ms
    print(f"[train] cli finetune cp_vgg16: 20 steps at batch 32 in {wall:.2f}s "
          f"(export included): {ms:.2f} ms/step from the second step on "
          f"(synthetic batches drawn on the host), {32e3 / ms:.1f} images/s; "
          f"the train step alone on one device batch {step_ms:.2f} ms "
          f"({32e3 / step_ms:.1f} images/s); peak device memory "
          f"{peak / 2**30:.2f} GiB; losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"all 20 finite", flush=True)
    del state, step, xb, yb

    ft_prefix = WORK / "vgg16_ft" / "ft_vgg16"
    res = cli.main(["eval", "--prototxt", f"{ft_prefix}.prototxt", "--weights",
                    f"{ft_prefix}.caffemodel", "--batch", "32", "--eval-batches",
                    "5", "--device", "cuda"])
    if res["n_images"] != 160:
        raise AssertionError(f"eval saw {res['n_images']} images, want 160")
    print(f"[train] cli eval of the finetuned cp_vgg16: {res}", flush=True)

    # per-layer: the original VGG-16 against cp_vgg16 at batch 32
    per = cli.main(["time", "--model", "vgg16", "--batch", "32", "--per-layer",
                    "--compare-prototxt", f"{cp}.prototxt", "--compare-weights",
                    f"{cp}.caffemodel", "--device", "cuda"])
    other = per["compare"]
    conv, mults = ([sum(r[key] for r in t["layers"] if r["type"] == "Convolution")
                    for t in (per, other)] for key in ("ms", "mults"))
    out["per_layer"] = {
        "total_ms": [per["sum_ms"], other["sum_ms"]], "conv_ms": conv,
        "speedup": per["sum_ms"] / other["sum_ms"], "conv_speedup": conv[0] / conv[1],
        "conv_mult_ratio": mults[0] / mults[1],
        "layers": {r["layer"]: [r["ms"], o["ms"]] for r in per["layers"]
                   for o in other["layers"] if o["layer"] == r["layer"]}}
    print(f"[train] per-layer forward at batch 32: VGG-16 {per['sum_ms']:.3f} ms, "
          f"cp_vgg16 {other['sum_ms']:.3f} ms, measured speed-up "
          f"{out['per_layer']['speedup']:.2f}x (convs alone {conv[0]:.3f} -> "
          f"{conv[1]:.3f} ms, {out['per_layer']['conv_speedup']:.2f}x) against "
          f"the conv-mult ratio {mults[0] / mults[1]:.2f}x", flush=True)

    # forward throughput and MFU of both nets, f32 and bf16 convs
    out["time"] = {}
    for label, model in (("vgg16", ["--model", "vgg16"]), ("cp_vgg16", cp_args)):
        for dtype in ("float32", "bfloat16"):
            r = cli.main(["time", *model, "--batch", "32", "--loop-steps", "20",
                          "--dtype", dtype, "--device", "cuda"])
            out["time"][f"{label} {dtype}"] = {
                "ms": r["device_ms_per_step"], "images_per_s": r["images_per_sec"],
                "mfu": r["mfu"]}
            mfu = "not measured (no peak for this card)" if r["mfu"] is None \
                else (f"{r['mfu']:.4f} of the H100's dense peak for its conv "
                      f"routes {r['conv_routes'] or 'f32'}")
            print(f"[train] forward {label} {dtype} at batch 32: "
                  f"{r['device_ms_per_step']:.3f} ms, {r['images_per_sec']:.1f} "
                  f"images/s, MFU {mfu}; flags {r['flags']}", flush=True)

    # deploy: the reloaded .pt2 against run_graph
    path = cli.main(["deploy", *cp_args, "--batch", "8", "--device", "cuda",
                     "--work-dir", str(WORK / "vgg16_deploy")])
    fn = deploy.load_serialized(path)
    g8, p8 = import_model(f"{cp}.prototxt", f"{cp}.caffemodel", batch=8)
    xd = torch.from_numpy(next(ft.synthetic_batches(8, seed=seed))[0]).to(device)
    want = run_graph(g8, params_to_torch(p8, device), {"data": xd})[0]["prob"]
    err = float((fn(xd) - want).abs().max())
    out["deploy_max_abs_err"] = err
    print(f"[train] cli deploy: {path} reloads; max |prob(.pt2) - prob(run_graph)| "
          f"{err:.2e} on the card (bound 1e-5)", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"deploy reload differs by {err}")
    return out


def accuracy_loop(root: Path, seed: int, device: str) -> dict:
    """train -> eval -> prune -> eval -> recover -> eval on the seeded task,
    all through the CLI on `device`, in `root`: held-out top-1 and
    cross-entropy of each stage, and the walls."""
    from channel_pruning_tpu_torch import cli
    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.utils.flops import total_flops

    shutil.rmtree(root, ignore_errors=True)
    train, val = write_task_lmdbs(root, seed)
    run = ["--device", device, "--seed", str(seed)]
    stages = {"trained": root / "train" / "ft_digits_vgg",
              "pruned": root / "prune" / "cp_digits_vgg",
              "recovered": root / "recover" / "ft_digits_vgg"}
    walls = {}

    def timed(name, argv):
        t = time.perf_counter()
        out = cli.main(argv)
        walls[name] = time.perf_counter() - t
        return out

    timed("train", ["finetune", "--model", "digits_vgg", "--data-dir", str(train),
                    *TASK_TRAIN, *run, "--work-dir", str(root / "train")])
    res = timed("prune", ["prune", "--prototxt", f"{stages['trained']}.prototxt",
                          "--weights", f"{stages['trained']}.caffemodel",
                          "--data-dir", str(train), *TASK_PRUNE, *run,
                          "--work-dir", str(root / "prune")])
    timed("recover", ["finetune", "--prototxt", f"{stages['pruned']}.prototxt",
                      "--weights", f"{stages['pruned']}.caffemodel",
                      "--data-dir", str(train), *TASK_RECOVER, *run,
                      "--work-dir", str(root / "recover")])
    out = {"walls": walls, "layers": len(res.reports)}
    for name, prefix in stages.items():
        ev = cli.main(["eval", "--prototxt", f"{prefix}.prototxt", "--weights",
                       f"{prefix}.caffemodel", "--data-dir", str(val),
                       "--batch", "32", "--device", device])
        if ev["n_images"] != TASK["n_val"]:
            raise AssertionError(f"eval of {prefix.name}: {ev}")
        out[name] = ev["accuracy@1"]
        out[f"{name}_xent"] = _heldout_xent(device, prefix, val)
    mults = [total_flops(import_model(f"{stages[k]}.prototxt")[0], include_fc=False)
             for k in ("trained", "pruned")]
    out["conv_mult_ratio"] = mults[0] / mults[1]
    return out


def _heldout_xent(device, prefix: Path, val: Path) -> float:
    """Reload an artifact and return its mean cross-entropy over the
    held-out records; raises unless every row is a probability vector."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.data.lmdb import lmdb_batches
    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.ops.forward import run_graph

    g, p = import_model(f"{prefix}.prototxt", f"{prefix}.caffemodel")
    params = params_to_torch(p, device)
    total, n = 0.0, 0
    for x, y in lmdb_batches(val, 32, crop=TASK["size"]):
        prob = run_graph(g, params, {g.inputs[0].name: torch.from_numpy(x).to(device)}
                         )[0]["prob"]
        if not _gives_probabilities(prob):
            raise AssertionError(f"{prefix} does not reload to probabilities")
        picked = prob.double()[torch.arange(len(y)), torch.from_numpy(y).long()]
        total += float(-picked.clamp_min(1e-300).log().sum())
        n += len(y)
    return total / n


def phase_accuracy_loop(device, seed: int) -> dict:
    """The accuracy loop on the card: see the module docstring, phase 7."""
    _zero_launches()
    res = accuracy_loop(WORK / "digits", seed, str(device))
    res["launches"] = _launches()
    print(f"[accuracy] seeded task (seed {seed}; {TASK}; {' '.join(TASK_PRUNE)}): "
          + ", ".join(f"{k} top-1 {res[k]:.4f} (held-out cross-entropy "
                      f"{res[k + '_xent']:.5f})"
                      for k in ("trained", "pruned", "recovered"))
          + f"; conv mults {res['conv_mult_ratio']:.2f}x fewer over "
          f"{res['layers']} layers; K1 launches {res['launches']['k1']} (all in "
          "the prune); walls " + " ".join(f"{k} {v:.2f}s" for k, v in
                                            res["walls"].items())
          + "; every artifact reloads and gives probabilities", flush=True)
    if not (res["trained"] >= 0.9 and res["pruned"] < res["trained"]
            and res["recovered"] > res["pruned"] and res["launches"]["k1"] > 0):
        raise AssertionError(f"accuracy loop: {res}")
    return res


def phase_addbn_3c(device) -> dict:
    """`cli addbn` on the 3C 4x export, then one finetune step, clip 35."""
    from channel_pruning_tpu_torch import cli
    from channel_pruning_tpu_torch.graph.ir import LT

    src = WORK / "vgg16_3c" / "3C_vgg16"
    work = WORK / "vgg16_3c_bn"
    g2, _ = cli.main(["addbn", "--prototxt", f"{src}.prototxt", "--weights",
                      f"{src}.caffemodel", "--batch", "8", "--cal-batches", "5",
                      "--cal-batch", "10", "--device", "cuda", "--work-dir", str(work)])
    n_bn = len(g2.by_type(LT.BN))
    state = cli.main(["finetune", "--prototxt", str(work / "bn_vgg16.prototxt"),
                      "--weights", str(work / "bn_vgg16.caffemodel"), "--batch", "8",
                      "--steps", "1", "--lr", "1e-5", "--clip-gradients", "35",
                      "--device", "cuda", "--work-dir", str(work)])
    loss = float(state.history[0]["loss"])
    print(f"[addbn_3c] {n_bn} BatchNorm layers inserted into the 3C 4x model; one "
          f"finetune step (clip 35) at batch 8: loss {loss:.4f}", flush=True)
    if not (n_bn > 0 and np.isfinite(loss)):
        raise AssertionError(f"addbn on 3C: {n_bn} BN layers, loss {loss}")
    return {"bn_layers": n_bn, "loss": loss}


def _group_problem(seed: int, c: int, n: int, device, rows: int = 250):
    """A 1x1 consumer's group-lasso Gram at main-path shape: the 250-row
    subsample of post-ReLU inputs against He-init weights, and a 16-alpha
    geometric grid below the alpha that zeroes every row."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    rng = np.random.default_rng(seed)
    X = np.maximum(rng.normal(size=(rows, c)), 0).astype(np.float32)
    W = (rng.normal(size=(c, n)) * np.sqrt(2.0 / c)).astype(np.float32)
    Y = (X @ W + 0.05 * rng.normal(size=(rows, n))).astype(np.float32)
    gram = lasso.group_gram(torch.from_numpy(X).to(device),
                            torch.from_numpy(Y).to(device))
    a_max = float(torch.linalg.vector_norm(gram.C, dim=1).max()) / rows
    alphas = torch.as_tensor(np.geomspace(1e-3 * a_max, a_max, A_GRID) * rows,
                             dtype=torch.float32).to(device)
    return gram, alphas


def _group_bound(c: int, n: int, n_alpha: int, stats) -> dict:
    """The least time a K3 grid could take for this run's work: G, C and
    the alphas read once, B written once; 8n FLOPs a row visit (R_j, its
    squared norm, the new row, its delta and the running max) and cn a
    sweep (max|B|), 2cn a moving row (Q's update), from the sweeps and
    moving rows these inputs needed (the kernel's stats)."""
    sweeps = stats[:, 0].astype(np.int64)
    moves = stats[:, 1].astype(np.int64)
    flops = int((sweeps * 9 * c * n + moves * 2 * c * n).sum())
    nbytes = 4 * (c * c + c * n + n_alpha + n_alpha * c * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _ptxas_kernels(report: str) -> list[str]:
    """ptxas's registers, stack, spills and shared memory per kernel
    entry of a build report, one string each."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for mangled, short in (("group_cd_grid_kernelILb1E", "<smem>"),
                                   ("group_cd_grid_kernelILb0E", "<global>")):
                if mangled in name:
                    name = "group_cd_grid_kernel" + short
        elif name and ("stack frame" in line or "Used" in line):
            text = line.split(":", 1)[-1].strip() if "Used" in line else line.strip()
            out.append(f"{name}: {text}")
            if "Used" in line:
                name = None
    return out


def phase_group_vs_plain(device) -> dict:
    """K3 against its plain version on seeded 1x1-consumer problems: (c, n)
    = (256, 256) over the full 200 sweeps, and ResNet-50's res5 shapes
    (2048, 512) and (512, 2048) over 3 sweeps, 16 alphas each: B bit for
    bit (torch.equal) and the same sweeps and moving rows for every alpha;
    each shape's launch plan (variant, K, rows a block, shared memory,
    clusters resident at once); K3 alone timed with CUDA events beside the
    sweeps, moving rows and bound; the plain version timed at each shape;
    then K3 alone over 20 sweeps at the res5 shapes (what a 200-sweep res5
    grid costs, without a plain run of that length). The returned numbers
    are those at (256, 256), the others beside them."""
    import torch

    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
    from channel_pruning_tpu_torch.ops import lasso

    for line in _ptxas_kernels(lasso_cd.ptxas_report(group_cd.SOURCE)):
        print(f"[kernel] K3 ptxas {line}", flush=True)

    def supports(Bs):
        norms = lasso.group_row_norms(Bs)
        return norms > 1e-6 * norms.amax(dim=1, keepdim=True)

    out, A = {}, A_GRID
    for seed, (c, n, sweeps, reps) in enumerate(((256, 256, 200, 3),
                                                 (2048, 512, 3, 2),
                                                 (512, 2048, 3, 2))):
        gram, alphas = _group_problem(seed, c, n, device)
        plan = group_cd.launch_plan(c, n, A, gram.G.device)
        print(f"[kernel] K3 c={c} n={n} A={A} plan: variant {plan.variant}, "
              f"K={plan.k} blocks a cluster ({A * plan.k} blocks), "
              f"{c // plan.k}-{plan.rows} rows a block (r, r + K, ...), "
              f"{plan.smem_bytes:,} B dynamic "
              f"shared memory a block, cudaOccupancyMaxActiveClusters "
              f"{plan.active_clusters}, {plan.waves} wave(s)", flush=True)
        stats = torch.zeros((A, 2), dtype=torch.int32, device=device)
        stats_ref = torch.zeros_like(stats)
        before = group_cd.LAUNCHES
        got = group_cd.group_cd_solve_grid(gram.G, gram.C, alphas,
                                           n_sweeps=sweeps, stats=stats)
        if group_cd.LAUNCHES != before + 1:
            raise AssertionError(f"K3 ({c}, {n}): not launched once")
        plain_ms, ref = _time_ms(lambda: group_cd.group_cd_solve_grid_plain(
            gram.G, gram.C, alphas, n_sweeps=sweeps, stats=stats_ref), 1)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not torch.equal(supports(got), supports(ref)):
            raise AssertionError(f"K3 ({c}, {n}): row supports differ from "
                                 "the plain version's")
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 ({c}, {n}): B differs from the plain "
                                 f"version's (max|K3-plain| {err})")
        if not torch.equal(stats, stats_ref):
            raise AssertionError(f"K3 ({c}, {n}): sweeps / moving rows "
                                 f"{stats.tolist()}, plain "
                                 f"{stats_ref.tolist()}")
        ms, _ = _time_ms(lambda: group_cd.group_cd_solve_grid(
            gram.G, gram.C, alphas, n_sweeps=sweeps), reps)
        st = stats.cpu().numpy()
        bound = _group_bound(c, n, A, st)
        rows_run = int(st[:, 0].astype(np.int64).max()) * c
        print(f"[kernel] K3 c={c} n={n} A={A}, {sweeps} sweeps: supports "
              f"identical, B equal bit for bit (max|K3-plain| {err:.1e}), "
              f"stats equal; plain {plain_ms:.1f} ms; K3 {ms:.3f} ms "
              f"({1e3 * ms / rows_run:.3f} us a row step of the longest "
              f"alpha); sweeps min/median/max {_spread(st[:, 0])}, moving "
              f"rows {_spread(st[:, 1])}; {bound['flops']:,} FLOP, "
              f"{bound['bytes']:,} B, bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']} ({100 * bound['bound_ms'] / ms:.3f}% of "
              "it)", flush=True)
        key = f"c{c}_n{n}_{sweeps}_sweeps"
        plan_info = {"variant": plan.variant, "k": plan.k,
                     "active_clusters": plan.active_clusters,
                     "smem_bytes": plan.smem_bytes}
        if not out:
            out.update(ms=ms, plain_ms=plain_ms, max_abs_err=err, c=c, n=n,
                       n_sweeps=sweeps, plan=plan_info, **bound)
        else:
            out[f"ms_{key}"] = ms
            out[f"bound_ms_{key}"] = bound["bound_ms"]
            out[f"plain_ms_{key}"] = plain_ms
            out[f"plan_{key}"] = plan_info
            out["max_abs_err"] = max(out["max_abs_err"], err)
        if sweeps < 20:         # a res5 shape: K3 alone over 20 sweeps
            ms20, _ = _time_ms(lambda: group_cd.group_cd_solve_grid(
                gram.G, gram.C, alphas, n_sweeps=20, stats=stats), 1)
            st = stats.cpu().numpy()
            bound20 = _group_bound(c, n, A, st)
            print(f"[kernel] K3 c={c} n={n} A={A}, 20 sweeps (kernel only): "
                  f"{ms20:.1f} ms; sweeps min/median/max {_spread(st[:, 0])}, "
                  f"moving rows {_spread(st[:, 1])}; bound "
                  f"{bound20['bound_ms']:.4f} ms by {bound20['bound_by']} "
                  f"({100 * bound20['bound_ms'] / ms20:.3f}% of it)",
                  flush=True)
            out[f"ms_c{c}_n{n}_20_sweeps"] = ms20
            out[f"bound_ms_c{c}_n{n}_20_sweeps"] = bound20["bound_ms"]
        del gram, alphas, got, ref
    return out


def phase_tiny_grplasso(device) -> dict:
    """`cli prune --model tiny_resnet --speed 1.2 --set dic.grplasso=true`
    on the card and on the CPU: the 1x1 consumers select by group lasso
    (K3 on the card), the solve takes the sequential path, and both devices
    select identically. Returns the card run's launches."""
    from channel_pruning_tpu_torch import cli

    runs = {}
    for dev in ("cuda", "cpu"):
        work = WORK / f"tiny_resnet_grplasso_{dev}"
        shutil.rmtree(work, ignore_errors=True)
        _zero_launches()
        runs[dev] = cli.main(["prune", "--model", "tiny_resnet", "--batch", "4",
                              "--cal-batches", "4", "--cal-batch", "4",
                              "--speed", "1.2", "--device", dev,
                              "--set", "dic.grplasso=true",
                              "--work-dir", str(work)])
        if dev == "cuda":
            launches = _launches()
    card, cpu = runs["cuda"], runs["cpu"]
    if card.pipelined or cpu.pipelined:
        raise AssertionError("tiny_resnet grplasso took the pipelined pass")
    if card.selections.keys() != cpu.selections.keys() or any(
            not np.array_equal(card.selections[k], cpu.selections[k])
            for k in cpu.selections):
        raise AssertionError("tiny_resnet grplasso: card and CPU select "
                             "differently")
    if launches["k3"] <= 0:
        raise AssertionError("tiny_resnet grplasso never launched K3")
    print(f"[tiny_grplasso] cli prune tiny_resnet --set dic.grplasso=true: "
          f"card and CPU select identically in {len(cpu.selections)} layers "
          f"(sequential path); K3 {launches['k3']} launches, K1 "
          f"{launches['k1']}", flush=True)
    return launches


def _band_checks(res, failures: list) -> list:
    """Every solved layer's kept count in the released band [t, round(1.1
    t)] of its target, and every rMSE finite. Returns the layers outside
    the band."""
    out_band = [(r.conv, r.target, r.kept) for r in res.reports
                if not _check_band(r.conv, r.target, r.kept)]
    if out_band:
        failures.append(f"outside the band (layer, target, kept): {out_band}")
    bad = [r.conv for r in res.reports
           if not (np.isfinite(r.rmse_before) and np.isfinite(r.rmse_after))]
    if bad:
        failures.append(f"rMSE not finite in {bad}")
    return out_band


def _ratio_check(res, orig_graph, speed: float, failures: list
                 ) -> tuple[float, float]:
    """(the conv-mult ratio, the planner's prediction on the preprocessed
    graph, as `cli prune` plans it): the ratio held to at least 0.97 of the
    prediction."""
    from channel_pruning_tpu_torch.models.vgg import init_params
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.utils.config import default_config
    from channel_pruning_tpu_torch.utils.flops import total_flops

    g, _ = c3.preprocess(orig_graph, init_params(orig_graph, seed=0))
    _, predicted = c3.plan_uniform_targets(
        g, speed, rank_tol=default_config().dic.rank_tol, with_prediction=True)
    orig = total_flops(orig_graph, include_fc=False)
    ratio = orig / total_flops(res.graph, include_fc=False)
    if ratio < 0.97 * predicted:
        failures.append(f"conv mults {ratio:.3f}x against the plan's "
                        f"{predicted:.3f}x")
    return ratio, predicted


def _layer_table(label: str, res) -> None:
    print(f"[{label}] layer             kind   target  keep       rMSE before "
          "-> after   grids  s (replay + solve)")
    for r in res.reports:
        grids = r.grids if r.grids is not None else "-"
        split = (f" ({r.replay_seconds:.2f} + {r.solve_seconds:.2f})"
                 if r.grids is None else "")
        print(f"[{label}] {r.conv:<17s} {r.kind:<6s} {r.target!s:>6s}  "
              f"{r.kept:>4d}/{r.total:<5d} {r.rmse_before:.4f} -> "
              f"{r.rmse_after:.4f}  {grids!s:>5s}  {r.seconds:.3f}{split}")


def phase_xception(device) -> dict:
    """`cli prune --model xception --mode prune --speed 2.0` at 224² with
    its defaults (the pipelined pass): see the module docstring, phase 10."""
    import torch

    from channel_pruning_tpu_torch.graph.ir import LT
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.models.xception import build_xception

    work = WORK / "xception"
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    res = _prune("xception", "2.0", work)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(device)
    _check_pipelined("xception", res)
    _layer_table("xception", res)
    failures: list[str] = []
    out_band = _band_checks(res, failures)
    ratio, predicted = _ratio_check(res, build_xception(), 2.0, failures)
    if launches["k1"] <= 0 or launches["k2"] <= 0:
        failures.append(f"K1 launches {launches['k1']}, K2 {launches['k2']}")
    g, _, prob = _probs_on(device, work / "cp_xception")
    if not _gives_probabilities(prob):
        failures.append("exported model does not give probabilities")
    dw = [l for l in g.by_type(LT.CONV)
          if int(l.attr("group", 1)) > 1]
    shrunk = sum(int(l.attr("num_output")) < int(build_xception().layer(
        l.name).attr("num_output")) for l in dw)
    gates = len(g.by_type(LT.SELECT))
    wide = [r.conv for r in res.reports if r.total > lasso_cd.MAX_C]
    print(f"[xception] {len(res.reports) - len(out_band)}/{len(res.reports)} "
          f"consumers in the band [t, round(1.1 t)]; {shrunk}/{len(dw)} "
          f"depthwise convs shrunk (num_output = group); {gates} Select gates; "
          f"K2 layers {wide}; conv mults {ratio:.3f}x (plan "
          f"{predicted:.2f}x)", flush=True)
    print("[xception] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; kernel launches K1 {launches['k1']} K2 "
          f"{launches['k2']}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    if failures:
        raise AssertionError("Xception 2x: " + "; ".join(failures))
    print("[xception] exported model reloads, probabilities sum to 1", flush=True)
    return {"launches": launches, "wall": wall, "phases": res.wall,
            "ratio": ratio, "predicted": predicted,
            "peak_gib": peak / 2**30}


def _timed_draws():
    """Wrap the calibration source's host draws and the chunk uploads with
    host clocks: returns (seconds and count of batch draws, seconds in
    device_chunk (draws, concatenation and the copy to the card), restore)."""
    from channel_pruning_tpu_torch.sampling import inputs as inputs_mod
    from channel_pruning_tpu_torch.sampling import sampler

    real_batch, real_chunk = inputs_mod.SyntheticInputs.batch, sampler.device_chunk
    acc = {"draw_s": 0.0, "draws": 0, "chunk_s": 0.0, "chunks": 0}

    def batch(self, i):
        t = time.perf_counter()
        x = real_batch(self, i)
        acc["draw_s"] += time.perf_counter() - t
        acc["draws"] += 1
        return x

    def chunk(*a, **k):
        t = time.perf_counter()
        x = real_chunk(*a, **k)
        acc["chunk_s"] += time.perf_counter() - t
        acc["chunks"] += 1
        return x

    def restore():
        inputs_mod.SyntheticInputs.batch = real_batch
        sampler.device_chunk = real_chunk

    inputs_mod.SyntheticInputs.batch = batch
    sampler.device_chunk = chunk
    return acc, restore


def _outputs_finite(device, prefix: Path) -> dict:
    """Reload an export and run one synthetic batch: {output: shape}, with
    every output finite."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs

    g, p = import_model(f"{prefix}.prototxt", f"{prefix}.caffemodel")
    spec = g.inputs[0]
    x = SyntheticInputs(1, spec.shape[0], tuple(spec.shape[1:])).batch(0).to(device)
    outs, _ = run_graph(g, params_to_torch(p, device), {spec.name: x})
    if not all(bool(torch.isfinite(v).all()) for v in outs.values()):
        raise AssertionError(f"{prefix}: non-finite outputs")
    return {k: tuple(v.shape) for k, v in outs.items()}


def phase_frcnn(device) -> dict:
    """`cli prune --model frcnn_vgg16 --image-size 600 --speed 5.0`: see the
    module docstring, phase 11."""
    import torch

    from channel_pruning_tpu_torch.models.faster_rcnn import build_frcnn_backbone
    from channel_pruning_tpu_torch.sampling import rolling, sampler
    from channel_pruning_tpu_torch.utils.config import default_config

    work = WORK / "frcnn"
    g0 = build_frcnn_backbone(batch=10, image_size=600)
    cfg = default_config()
    n_images = 500
    cut = rolling.estimate_peak_bytes(g0, n_images)
    step = sampler.clamp_chunk_for_hbm(
        g0, 10, max(cfg.sample.device_batch // 10, 1)) * 10
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    acc, restore = _timed_draws()
    t0 = time.perf_counter()
    try:
        res = _prune("frcnn_vgg16", "5.0", work, "--image-size", "600")
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(device)
    _layer_table("frcnn", res)
    failures: list[str] = []
    if res.pipelined:
        failures.append("took the pipelined pass, want full replays")
    if cut <= 8 << 30:
        failures.append(f"the frontier's estimate {cut / 1e9:.1f} GB fits "
                        "the 8 GB budget")
    out_band = _band_checks(res, failures)
    ratio, predicted = _ratio_check(
        res, build_frcnn_backbone(image_size=600), 5.0, failures)
    rpn = ("rpn_conv/3x3", "rpn_cls_score", "rpn_bbox_pred")
    if not all(k in res.selections for k in rpn):
        failures.append(f"rpn convs pruned: {[k for k in rpn if k in res.selections]}")
    if launches["k1"] <= 0:
        failures.append("K1 never launched")
    shapes = _outputs_finite(device, work / "cp_frcnn_vgg16")
    replay = sum(r.replay_seconds for r in res.reports)
    solve = sum(r.solve_seconds for r in res.reports)
    print(f"[frcnn] {len(res.reports) - len(out_band)}/{len(res.reports)} "
          f"consumers in the band; rpn convs pruned "
          f"({', '.join(f'{k} {int(res.selections[k].sum())}' for k in rpn if k in res.selections)}); "
          f"conv mults {ratio:.3f}x (plan {predicted:.2f}x); "
          f"frontier estimate {cut / 1e9:.1f} GB > 8 GB: full replays, "
          f"{step} images a replay step; outputs {shapes}", flush=True)
    print(f"[frcnn] solve split: replays {replay:.2f}s, solves {solve:.2f}s; "
          f"host draws {acc['draw_s']:.2f}s in {acc['draws']} batches, "
          f"device_chunk {acc['chunk_s']:.2f}s in {acc['chunks']} chunks "
          "(draws, concatenation, copy to the card)", flush=True)
    print("[frcnn] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; kernel launches K1 {launches['k1']} K2 "
          f"{launches['k2']}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    if failures:
        raise AssertionError("Faster-RCNN 600² 5x: " + "; ".join(failures))
    print("[frcnn] exported model reloads, RPN outputs finite", flush=True)
    return {"launches": launches, "wall": wall, "phases": res.wall,
            "ratio": ratio, "predicted": predicted,
            "peak_gib": peak / 2**30, "replay_s": replay, "solve_s": solve,
            "images_per_step": step, **acc}, res


def phase_vgg16_fitfc(device) -> dict:
    """`cli prune --model vgg16 --speed 4.0 --set dic.fitfc=true`: see the
    module docstring, phase 12."""
    import torch

    work = WORK / "vgg16_fitfc"
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    res = _prune("vgg16", "4.0", work, "--set", "dic.fitfc=true")
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(device)
    _check_pipelined("vgg16_fitfc", res)
    failures: list[str] = []
    _band_checks(res, failures)
    fc = [r for r in res.reports if r.kind == "fc"]
    if [r.conv for r in fc] != ["fc6"] or "fc6" not in res.selections:
        failures.append(f"fitfc reports {[r.conv for r in fc]}")
    else:
        kept = int(res.selections["fc6"].sum())
        w53 = res.params["conv5_3"]["W"].shape[0]
        w6 = res.params["fc6"]["W"].shape[1]
        if not (w53 == kept < 512 and w6 == kept * 49):
            failures.append(f"conv5_3 keeps {w53}, fc6 {kept} of 512, fc6 "
                            f"weight columns {w6}")
        r = fc[0]
        print(f"[vgg16_fitfc] fc6: keep {kept}/512 (target {r.target}) rMSE "
              f"{r.rmse_before:.4f} -> {r.rmse_after:.4f}; dense capture "
              f"{r.replay_seconds:.2f}s + solve {r.solve_seconds:.2f}s "
              f"(refit on {kept * 49} columns); conv5_3 keeps {w53}, fc6 "
              f"weight ({res.params['fc6']['W'].shape[0]}, {w6})", flush=True)
    g, _, prob = _probs_on(device, work / "cp_vgg16")
    if not _gives_probabilities(prob):
        failures.append("exported model does not give probabilities")
    print("[vgg16_fitfc] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; kernel launches K1 {launches['k1']} K2 "
          f"{launches['k2']}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    if failures:
        raise AssertionError("VGG-16 4x fitfc: " + "; ".join(failures))
    print("[vgg16_fitfc] conv5_3 pruned through fc6; the export reloads, "
          "probabilities sum to 1", flush=True)
    return {"launches": launches, "wall": wall, "phases": res.wall,
            "peak_gib": peak / 2**30}


def phase_vgg16_autodet(device) -> dict:
    """`cli prune --model vgg16 --speed 5.0 --set solve.autodet=true`: see
    the module docstring, phase 13."""
    import torch

    work = WORK / "vgg16_autodet"
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    res = _prune_vgg16(work, "--set", "solve.autodet=true")
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(device)
    failures: list[str] = []
    if res.pipelined:
        failures.append("took the pipelined pass")
    kept = {r.conv: r.kept for r in res.reports}
    if not res.reports or any(not (k and k > 0) for k in kept.values()) or any(
            not (np.isfinite(r.rmse_before) and np.isfinite(r.rmse_after))
            for r in res.reports):
        failures.append(f"keep counts {kept}")
    if launches != {"k1": len(res.reports), "k2": 0, "k3": 0}:
        failures.append(f"launches {launches} for {len(res.reports)} layers")
    _, _, prob = _probs_on(device, work / "cp_vgg16")
    if not _gives_probabilities(prob):
        failures.append("exported model does not give probabilities")
    print("[vgg16_autodet] " + ", ".join(
        f"{r.conv} {r.kept}/{r.total} (alpha {r.alpha:.2e}, rMSE "
        f"{r.rmse_after:.4f})" for r in res.reports), flush=True)
    print("[vgg16_autodet] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; kernel launches K1 {launches['k1']} for "
          f"{len(res.reports)} layers (sequential path); peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if failures:
        raise AssertionError("VGG-16 autodet: " + "; ".join(failures))
    print("[vgg16_autodet] one fixed-alpha K1 launch a layer; the export "
          "reloads, probabilities sum to 1", flush=True)
    return {"launches": launches, "wall": wall, "phases": res.wall,
            "peak_gib": peak / 2**30, "kept": kept}


def _replay_conv_cases() -> list:
    """(label, layer names, x shape, W shape, geometry) of every distinct
    conv shape of the two bf16 replay paths at the batch they replay:
    VGG-16 at 224² in the frontier's groups (10 batches of the CLI's 10
    images) and the Faster-RCNN backbone at 600² (RPN conv and heads
    included) in the full replays' steps (`clamp_chunk_for_hbm`)."""
    from channel_pruning_tpu_torch.models.faster_rcnn import build_frcnn_backbone
    from channel_pruning_tpu_torch.models.vgg import build_vgg16
    from channel_pruning_tpu_torch.ops.forward import conv_shapes
    from channel_pruning_tpu_torch.sampling import sampler
    from channel_pruning_tpu_torch.utils.config import default_config

    frcnn = build_frcnn_backbone(batch=10, image_size=600)
    step = sampler.clamp_chunk_for_hbm(
        frcnn, 10, max(default_config().sample.device_batch // 10, 1))
    cases: dict[tuple, list] = {}
    for label, g, batch in (("vgg16", build_vgg16(), 10 * 10),
                            ("frcnn", frcnn, step * 10)):
        for l, x, w, geo in conv_shapes(g, batch):
            key = (label, x, w, tuple(sorted(geo.items())))
            cases.setdefault(key, [label, [], x, w, geo])[1].append(l.name)
    return list(cases.values())


def phase_bf16_conv(device) -> dict:
    """The bf16 replay conv (`ops/forward._conv2d` with compute_dtype
    bfloat16) at every distinct conv shape of the bf16 replay paths,
    against the f32 conv (TF32 off) of the same bf16-rounded operands:
    within EXACT_RTOL of its largest |value| at each shape. Per shape: the
    route taken and the ms (CUDA events) of that route, of the f32 conv of
    the unrounded operands and of the native bf16 conv (which rounds its
    output; timed for comparison only, the port never runs it)."""
    import torch
    import torch.nn.functional as F

    from channel_pruning_tpu_torch.ops import forward

    bf16 = torch.bfloat16
    rows, failures = [], []
    for label, names, xs, ws, geo in _replay_conv_cases():
        gen = torch.Generator(device=device).manual_seed(len(rows))
        x = torch.randn(xs, generator=gen, device=device)
        if names[0] not in ("conv1_1",):
            x = x.relu_()                 # a replay's post-ReLU activations
        w = torch.randn(ws, generator=gen, device=device) * (
            2.0 / (ws[1] * ws[2] * ws[3])) ** 0.5
        b = 0.1 * torch.randn(ws[:1], generator=gen, device=device)
        kw = dict(stride=(geo["sh"], geo["sw"]), padding=(geo["ph"], geo["pw"]),
                  groups=geo["group"])
        route = forward.conv_route(xs, ws, geo, bf16, device)
        got = forward._conv2d(x, w, b, geo, bf16)
        with forward.tf32_convs(False):
            ref = F.conv2d(x.to(bf16).float(), w.to(bf16).float(), None,
                           **kw) + b[:, None, None]
        err = float((got - ref).abs().max() / ref.abs().max())
        del got, ref
        if not err <= forward.EXACT_RTOL:
            failures.append(f"{label} {names}: {err:.2e}")
        reps = 5
        ms_route, _ = _time_ms(lambda: forward._conv2d(x, w, b, geo, bf16), reps)
        with forward.tf32_convs(False):
            ms_f32, _ = _time_ms(lambda: F.conv2d(x, w, b, **kw), reps)
        xb, wb, bb = x.to(bf16), w.to(bf16), b.to(bf16)
        ms_native, _ = _time_ms(lambda: F.conv2d(xb, wb, bb, **kw), reps)
        del x, w, b, xb, wb, bb
        oh = (xs[2] + 2 * geo["ph"] - geo["kh"]) // geo["sh"] + 1
        ow = (xs[3] + 2 * geo["pw"] - geo["kw"]) // geo["sw"] + 1
        flop = 2 * xs[0] * oh * ow * ws[0] * ws[1] * ws[2] * ws[3]
        rows.append({"path": label, "layers": names, "x": xs, "w": ws,
                     "route": route, "max_rel_err": err, "ms_route": ms_route,
                     "ms_f32": ms_f32, "ms_native_bf16": ms_native,
                     "gflop": flop / 1e9})
        print(f"[bf16_conv] {label} {','.join(names)} x {xs} w {ws}: route "
              f"{route}, max|conv - f32 conv of rounded operands| "
              f"{err:.2e} of max; ms {route} route {ms_route:.3f}, f32 "
              f"{ms_f32:.3f}, native bf16 {ms_native:.3f}; "
              f"{flop / ms_route / 1e9:.1f} TFLOP/s on the route", flush=True)
        torch.cuda.empty_cache()
    _tf32_off()
    if failures:
        raise AssertionError("bf16 conv off the f32 conv of its rounded "
                             "operands: " + "; ".join(failures))
    f32 = [f"{r['path']} {','.join(r['layers'])}" for r in rows
           if r["route"] != "tf32"]
    for path in ("vgg16", "frcnn"):
        sel = [r for r in rows if r["path"] == path]
        print(f"[bf16_conv] {path}: {len(sel)} shapes, "
              f"{sum(r['route'] == 'tf32' for r in sel)} on TF32; summed ms "
              f"route {sum(r['ms_route'] for r in sel):.2f}, f32 "
              f"{sum(r['ms_f32'] for r in sel):.2f}, native bf16 "
              f"{sum(r['ms_native_bf16'] for r in sel):.2f}", flush=True)
    print(f"[bf16_conv] every shape within {forward.EXACT_RTOL:.0e} of the "
          f"f32 conv of its rounded operands; shapes on the f32 route: "
          f"{f32 or 'none'}; TF32 flags off after the phase", flush=True)
    return {"shapes": rows}


def _legs(label: str, res, other, eps: float = 1e-3) -> tuple[list, float]:
    """(layers whose masks differ, largest |difference| of the rMSE each
    layer ends at) of two solves of one cache, printed layer by layer (the
    rMSE a layer starts from differs by the replays' own rounding)."""
    differ = [k for k in res.selections
              if not np.array_equal(res.selections[k], other.selections.get(k))]
    gap = 0.0
    for r, o in zip(res.reports, other.reports):
        d = abs(r.rmse_after - o.rmse_after)
        gap = max(gap, d)
        print(f"[{label}] {r.conv:<14s} keep {r.kept}/{r.total} vs {o.kept}; "
              f"rMSE {r.rmse_before:.5f} -> {r.rmse_after:.5f} vs "
              f"{o.rmse_before:.5f} -> {o.rmse_after:.5f} ({d:.1e}"
              f"{' > ' + str(eps) if d > eps else ''})", flush=True)
    return differ, gap


def phase_vgg16_f32_leg(device, bf16_res, bf16_wall) -> dict:
    """VGG-16 5x once more with `--set solve.dtype=float32` on a copy of the
    bf16 main path's frozen cache: the same masks, every layer's final rMSE
    within 1e-3 of the bf16 run's (BENCH_NOTES.md:61-64's claim for the
    TPU), the first layer from an exact input; both walls printed."""
    work = WORK / "vgg16_f32"
    _zero_launches()
    t0 = time.perf_counter()
    res = _prune("vgg16", "5.0", work, "--set", "solve.dtype=float32",
                 cache_from=WORK / "vgg16")
    wall = time.perf_counter() - t0
    launches = _launches()
    _check_pipelined("vgg16_f32", res)
    _check_vgg_counts(work, res)
    if res.reports[0].rmse_before >= 1e-4:      # f32: an exact input
        raise AssertionError(f"f32: first layer starts at rMSE "
                             f"{res.reports[0].rmse_before}")
    differ, gap = _legs("vgg16_f32", bf16_res, res)
    walls = {"bfloat16": bf16_res.wall, "float32": res.wall}
    print(f"[vgg16_f32] bf16 (main path) against f32 on one frozen cache: "
          f"masks differ in {len(differ)}/{len(res.selections)} layers "
          f"{differ}; largest rMSE difference {gap:.2e}; wall bf16 "
          f"{bf16_wall:.2f}s (solve {bf16_res.wall['solve']:.2f}s), f32 "
          f"{wall:.2f}s (solve {res.wall['solve']:.2f}s, the cache loaded); "
          f"K1 {launches['k1']}", flush=True)
    if differ or gap > 1e-3:
        raise AssertionError(f"VGG-16 5x bf16 against f32: masks differ in "
                             f"{differ}, largest rMSE difference {gap:.2e}")
    return {"launches": launches, "wall": wall, "walls": walls,
            "rmse_gap": gap, "masks_differ": differ}


def phase_frcnn_f32_leg(device, bf16_res) -> dict:
    """Faster-RCNN 600² 5x once more with `--set solve.dtype=float32` on a
    copy of the bf16 run's frozen cache: the band and ratio checks, the
    count of masks that differ, both walls and the replays' seconds."""
    from channel_pruning_tpu_torch.models.faster_rcnn import build_frcnn_backbone

    work = WORK / "frcnn_f32"
    _zero_launches()
    acc, restore = _timed_draws()
    t0 = time.perf_counter()
    try:
        res = _prune("frcnn_vgg16", "5.0", work, "--image-size", "600", "--set",
                     "solve.dtype=float32", cache_from=WORK / "frcnn")
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = _launches()
    failures: list[str] = []
    _band_checks(res, failures)
    ratio, _ = _ratio_check(res, build_frcnn_backbone(image_size=600), 5.0,
                            failures)
    differ, gap = _legs("frcnn_f32", bf16_res, res, eps=float("inf"))
    replay = sum(r.replay_seconds for r in res.reports)
    replay_bf16 = sum(r.replay_seconds for r in bf16_res.reports)
    print(f"[frcnn_f32] bf16 against f32 on one frozen cache: masks differ in "
          f"{len(differ)}/{len(res.selections)} layers {differ}; largest "
          f"rMSE difference {gap:.2e}; f32 conv mults {ratio:.3f}x; replays "
          f"bf16 {replay_bf16:.2f}s, f32 {replay:.2f}s; solve bf16 "
          f"{bf16_res.wall['solve']:.2f}s, f32 {res.wall['solve']:.2f}s; f32 "
          "wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f" total {wall:.2f}s (the cache loaded); K1 {launches['k1']}",
          flush=True)
    if failures:
        raise AssertionError("Faster-RCNN 600² 5x f32 leg: " + "; ".join(failures))
    return {"launches": launches, "wall": wall, "phases": res.wall,
            "replay_s": replay, "replay_bf16_s": replay_bf16,
            "masks_differ": differ, "rmse_gap": gap, **acc}


def _mesh_prune(label: str, mesh, model: str, speed: str, cache_from: Path):
    """`cli prune` of `model` with its solve on `mesh` (on one device when
    None), on a copy of the one-device run's frozen cache: the CLI builds a
    mesh only from more than one card, so its `_solver_mesh` is pointed at
    this one. Returns (result, wall, launches)."""
    from channel_pruning_tpu_torch import cli

    def solver_mesh(device):
        if mesh is not None:
            print(f"[prune] sharding solver reductions over {mesh.size} "
                  f"shards ({len(mesh.distinct)} devices)")
        return mesh

    orig = cli._solver_mesh
    cli._solver_mesh = solver_mesh
    _zero_launches()
    t0 = time.perf_counter()
    try:
        res = _prune(model, speed, WORK / f"{label}", cache_from=cache_from)
    finally:
        cli._solver_mesh = orig
    return res, time.perf_counter() - t0, _launches()


def _agreement(label: str, res, solo) -> tuple[int, list[str]]:
    """(layers whose masks equal the one-device run's, those that differ),
    each differing layer printed with both runs' rMSEs."""
    differ = [k for k in solo.selections
              if not np.array_equal(res.selections[k], solo.selections[k])]
    rm = {r.conv: r for r in res.reports}
    for r in solo.reports:
        if r.conv in differ:
            m = rm[r.conv]
            print(f"[{label}] {r.conv}: mask differs (keep {m.kept} vs "
                  f"{r.kept}); rMSE {m.rmse_before:.5f} -> {m.rmse_after:.5f} "
                  f"on the mesh, {r.rmse_before:.5f} -> {r.rmse_after:.5f} on "
                  "one device", flush=True)
    return len(solo.selections) - len(differ), differ


def _sharded_reductions(tag: str, mesh, device) -> dict:
    """The solver's reductions at conv3_1's scale (N = 50,000 rows of
    3x3 patches of c = 256 channels, an n = 512 consumer): the LASSO Gram
    of Z on the 400-row subsample and the least-squares fit on all rows,
    sharded against local, at tests/test_parallel.py's tolerances."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso, lstsq
    from channel_pruning_tpu_torch.parallel import sharded

    g = torch.Generator(device=device).manual_seed(0)
    N, c, n, k = 50_000, 256, 512, 3
    X = torch.relu(torch.randn((N, c, k, k), generator=g, device=device))
    W2 = torch.randn((n, c, k, k), generator=g, device=device) * \
        (2.0 / (k * k * c)) ** 0.5
    Y = torch.einsum("nchw,ochw->no", X, W2) + 0.05 * torch.randn(
        (N, n), generator=g, device=device)
    Xs, Ys = lasso.row_subsample(X, Y, 400, 0)
    Z = lasso.build_channel_response(Xs, W2)
    y = Ys.reshape(-1)
    ms_local, g_local = _time_ms(lambda: lasso.lasso_gram(Z, y), 5)
    ms_shard, g_shard = _time_ms(
        lambda: sharded.sharded_lasso_gram(Z, y, mesh), 5)
    torch.testing.assert_close(g_shard.G, g_local.G, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(g_shard.b, g_local.b, rtol=1e-4, atol=1e-3)
    X2 = X.reshape(N, -1)
    ms_fit, (W_l, b_l) = _time_ms(lambda: lstsq.fit_linear(X2, Y), 2)
    ms_sfit, (W_s, b_s) = _time_ms(lambda: sharded.sharded_lstsq(X2, Y, mesh), 2)
    torch.testing.assert_close(W_s, W_l, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(b_s, b_l, rtol=1e-3, atol=1e-3)
    gap_g = float((g_shard.G - g_local.G).abs().max() / g_local.G.abs().max())
    gap_w = float((W_s - W_l).abs().max() / W_l.abs().max())
    print(f"[{tag}] Gram of Z {tuple(Z.shape)}: sharded {ms_shard:.3f} ms, "
          f"local {ms_local:.3f} ms, max gap {gap_g:.1e} of max|G|; lstsq of "
          f"X {tuple(X2.shape)} on Y {tuple(Y.shape)}: sharded {ms_sfit:.2f} "
          f"ms, local {ms_fit:.2f} ms, max gap {gap_w:.1e} of max|W|; both "
          "within tests/test_parallel.py's tolerances", flush=True)
    return {"gram_ms": ms_shard, "gram_local_ms": ms_local, "gram_gap": gap_g,
            "lstsq_ms": ms_sfit, "lstsq_local_ms": ms_fit, "lstsq_gap": gap_w}


def _dp_step(tag: str, mesh, device) -> dict:
    """One finetune step of cp_vgg16 (the main path's export) at batch 32
    over the mesh against the one-device step on the same batch and
    generator (dropout on): loss rtol 1e-5, weights rtol 1e-4 atol 1e-6
    (tests/test_parallel.py:135-153)."""
    import torch

    from channel_pruning_tpu_torch.io.caffe import import_model
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs
    from channel_pruning_tpu_torch.train import finetune as ft
    from channel_pruning_tpu_torch.utils.config import FinetuneConfig

    g, p = import_model(WORK / "vgg16" / "cp_vgg16.prototxt",
                        WORK / "vgg16" / "cp_vgg16.caffemodel")
    cfg = FinetuneConfig()               # the reference's solver: lr 1e-5
    x = SyntheticInputs(1, 32, (3, 224, 224), seed=5).batch(0)
    y = torch.as_tensor(np.random.default_rng(5).integers(0, 1000, 32))
    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        state = ft.init_state(g, p, cfg, device=device, mesh=m)
        step = ft.build_train_step(g, cfg, mesh=m)
        grads = []
        # read the gradients before the update (SGD adds Nesterov's term
        # into them in place)
        state.optimizer.register_step_pre_hook(lambda *_: grads.append(
            torch.cat([q.grad.reshape(-1) for q in state.model.parameters()
                       if q.grad is not None])))
        gen = torch.Generator(device=device).manual_seed(7)
        xs, ys = (x, y) if m is not None else (x.to(device), y.to(device))
        times = []
        for _ in range(2):        # the second step timed warm; the first held
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, xs, ys, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if len(times) == 1:
                loss = float(metrics["loss"])
                weights = {n: b["W"].detach().clone()
                           for n, b in state.params.items() if "W" in b}
        out[name] = (loss, times[1], weights, grads[0])
        del state
    (l_m, t_m, w_m, g_m), (l_o, t_o, w_o, g_o) = out["mesh"], out["one"]
    np.testing.assert_allclose(l_m, l_o, rtol=1e-5)
    gaps = []
    for n in w_o:
        torch.testing.assert_close(w_m[n], w_o[n], rtol=1e-4, atol=1e-6)
        gaps.append(float((w_m[n] - w_o[n]).abs().max()))
    # the f32 card gradients of two orders of summation, as one vector: at
    # most phase 6's bound for f32 card gradients against f64 (2e-2)
    g_gap = float((g_m - g_o).norm() / g_o.norm())
    if not g_gap <= 2e-2:
        raise AssertionError(f"DP gradients {g_gap:.2e} from one device's")
    print(f"[{tag}] DP finetune step of cp_vgg16 at batch 32 (lr 1e-5) over "
          f"{mesh.size} shards against one device: loss {l_m:.6f} vs "
          f"{l_o:.6f}; largest weight gap {max(gaps):.1e} over {len(gaps)} "
          f"layers; gradients as one vector {g_gap:.2e} apart; warm step "
          f"{t_m * 1e3:.1f} ms vs {t_o * 1e3:.1f} ms", flush=True)
    return {"loss": l_m, "loss_one": l_o, "weight_gap": max(gaps),
            "grad_gap": g_gap, "step_ms": t_m * 1e3, "step_one_ms": t_o * 1e3}


def phase_mesh(device, vgg_res, r50_res) -> dict:
    """The mesh (parallel/mesh, parallel/sharded) on the card: 4 logical
    shards on it, and every card when there is more than one. Per mesh:
    the sharded Gram and least squares at conv3_1's scale against local;
    VGG-16 5x and ResNet-50 2x through `cli prune` with the solve on the
    mesh (the pipelined pass taken, under the sync check) on copies of the
    one-device runs' frozen caches: the released 5x counts exactly, every
    ResNet-50 width and gate in its band, the masks against the one-device
    runs (a differing layer prints both rMSEs), the walls beside a warm
    one-device run on the same cache; and one DP finetune step against the
    one-device step."""
    import torch

    from channel_pruning_tpu_torch.parallel.mesh import make_mesh

    meshes = [("mesh4", make_mesh(4, device=device))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"cards{torch.cuda.device_count()}", make_mesh()))
    # one device on the same cache copies, warm: the walls to compare with
    _, vgg_wall, _ = _mesh_prune("vgg16_one", None, "vgg16", "5.0",
                                 WORK / "vgg16")
    _, r50_wall, _ = _mesh_prune("resnet50_one", None, "resnet50", "2.0",
                                 WORK / "resnet50")
    out = {"one_device": {"vgg16_5x_wall": vgg_wall,
                          "resnet50_2x_wall": r50_wall}}
    for tag, mesh in meshes:
        rec = {"reductions": _sharded_reductions(tag, mesh, device)}
        res, wall, launches = _mesh_prune(f"vgg16_{tag}", mesh, "vgg16", "5.0",
                                          WORK / "vgg16")
        _check_pipelined(f"vgg16_{tag}", res)
        _check_vgg_counts(WORK / f"vgg16_{tag}", res)
        same, differ = _agreement(f"vgg16_{tag}", res, vgg_res)
        print(f"[vgg16_{tag}] keep counts equal the released 5x table; "
              f"{same}/{len(vgg_res.selections)} layers select as the "
              f"one-device run on its frozen cache; wall {wall:.2f}s (solve "
              f"{res.wall['solve']:.2f}s) against {vgg_wall:.2f}s on one "
              f"device (the same cache loaded, warm); K1 {launches['k1']}",
              flush=True)
        rec["vgg16_5x"] = {"launches": launches, "wall": wall,
                           "solve_s": res.wall["solve"], "same": same,
                           "differ": differ}
        res, wall, launches = _mesh_prune(f"resnet50_{tag}", mesh, "resnet50",
                                          "2.0", WORK / "resnet50")
        _check_pipelined(f"resnet50_{tag}", res)
        failures, summary = _resnet50_structure(WORK / f"resnet50_{tag}", res)
        if launches["k1"] <= 0 or launches["k2"] <= 0:
            failures.append(f"K1 launches {launches['k1']}, K2 {launches['k2']}")
        same, differ = _agreement(f"resnet50_{tag}", res, r50_res)
        print(f"[resnet50_{tag}] {summary}; {same}/{len(r50_res.selections)} "
              f"layers select as the one-device run on its frozen cache; "
              f"wall {wall:.2f}s (solve {res.wall['solve']:.2f}s) against "
              f"{r50_wall:.2f}s on one device (the same cache loaded, warm); "
              f"K1 {launches['k1']} K2 {launches['k2']}", flush=True)
        if failures:
            raise AssertionError(f"ResNet-50 2x on {tag}: " + "; ".join(failures))
        rec["resnet50_2x"] = {"launches": launches, "wall": wall,
                              "solve_s": res.wall["solve"], "same": same,
                              "differ": differ}
        rec["dp_step"] = _dp_step(tag, mesh, device)
        out[tag] = rec
    return out


def phase_native() -> dict:
    """The native host codecs (built with g++ beside the nvcc builds): the
    He-init VGG-16 exported once (~553 MB) and read back through the
    native indexer and through the Python walk, records equal (names,
    types, shapes, every blob's bytes), the native path taken (no counted
    fallback), both times; and the C++/OpenMP preprocess of 50 seeded
    375x500 images against the port's `pipeline.preprocess`, both timed,
    within tests/test_native.py's bounds."""
    from channel_pruning_tpu_torch.data import native_preprocess as npp
    from channel_pruning_tpu_torch.data.pipeline import preprocess
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.io import caffemodel as cm
    from channel_pruning_tpu_torch.models.vgg import build_vgg16, init_params

    work = WORK / "native"
    work.mkdir(parents=True, exist_ok=True)
    g = build_vgg16()
    path = work / "vgg16.caffemodel"
    t0 = time.perf_counter()
    cio.export_model(g, init_params(g, seed=0), work / "vgg16.prototxt", path)
    t_export = time.perf_counter() - t0
    before = cm.native_fallbacks
    t_native, t_python = [], []
    for _ in range(2):                     # alternated, the faster of two
        t0 = time.perf_counter()
        name, native = cm.load_caffemodel(path)
        t_native.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        name_py, walk = cm.load_caffemodel_python(path)
        t_python.append(time.perf_counter() - t0)
    t_native, t_python = min(t_native), min(t_python)
    if cm.native_fallbacks != before:
        raise AssertionError("the VGG-16 load fell back to the Python walk")
    if name != name_py or len(native) != len(walk):
        raise AssertionError(f"records differ: {name}/{len(native)} vs "
                             f"{name_py}/{len(walk)}")
    n_blobs = 0
    for a, b in zip(native, walk):
        if (a.name, a.type, len(a.blobs)) != (b.name, b.type, len(b.blobs)) \
                or any(u.shape != v.shape or u.tobytes() != v.tobytes()
                       for u, v in zip(a.blobs, b.blobs)):
            raise AssertionError(f"layer {a.name}: native and Python records differ")
        n_blobs += len(a.blobs)
    size = path.stat().st_size
    print(f"[native] VGG-16 caffemodel {size / 1e6:.1f} MB (export "
          f"{t_export:.2f}s): native load {t_native:.3f}s, Python walk "
          f"{t_python:.3f}s ({t_python / t_native:.1f}x); {len(native)} layers, "
          f"{n_blobs} blobs equal in names, types, shapes and bytes; no "
          "fallback", flush=True)
    imgs = np.random.default_rng(0).integers(0, 256, (50, 375, 500, 3)).astype(np.uint8)
    t_npp, t_pp = [], []
    for _ in range(2):                     # alternated, the faster of two
        t0 = time.perf_counter()
        got = npp.preprocess_batch(imgs)
        t_npp.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = np.stack([preprocess(im).numpy() for im in imgs])
        t_pp.append(time.perf_counter() - t0)
    t_npp, t_pp = min(t_npp), min(t_pp)
    diff = np.abs(got[:, :, 4:-4, 4:-4] - want[:, :, 4:-4, 4:-4])
    if not (diff.max() < 1.5 and diff.mean() < 0.1):
        raise AssertionError(f"native preprocess off the pipeline's: max "
                             f"{diff.max()}, mean {diff.mean()}")
    print(f"[native] preprocess of 50 375x500 images: C++/OpenMP "
          f"({npp.num_threads()} threads) {t_npp * 1e3:.1f} ms, the port's "
          f"pipeline.preprocess {t_pp * 1e3:.1f} ms; interior max |gap| "
          f"{diff.max():.4f}, mean {diff.mean():.5f}", flush=True)
    path.unlink()
    return {"caffemodel_mb": size / 1e6, "native_load_s": t_native,
            "python_load_s": t_python, "export_s": t_export,
            "preprocess_native_ms": t_npp * 1e3,
            "preprocess_pipeline_ms": t_pp * 1e3, "preprocess_gap_max":
            float(diff.max()), "threads": npp.num_threads()}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke run of the port on one card")
    parser.add_argument("--profile", action="store_true",
                        help="also run the main paths under torch.profiler and "
                             "print device busy time, idle share and top kernels")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the accuracy loop's task and of the "
                             "training phases' batches")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from channel_pruning_tpu_torch.data import native_preprocess
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.io import native_caffemodel
    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.utils import native

    card = _card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    device = resolve_device("cuda")

    t = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:      # one compiler a source, side by side
        for f in [pool.submit(lasso_cd.build), pool.submit(group_cd.build),
                  pool.submit(native.build, native_caffemodel.SOURCE),
                  pool.submit(native.build, native_preprocess.SOURCE)]:
            f.result()
    print(f"[build] lasso_cd.cu (K1, K2) and group_cd.cu (K3) -> sm_90a, "
          f"caffemodel.cpp and preprocess.cpp -> g++ in "
          f"{time.perf_counter() - t:.2f}s", flush=True)
    for line in (lasso_cd.ptxas_report()
                 + lasso_cd.ptxas_report(group_cd.SOURCE)).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    stats = phase_kernel_vs_plain(device)
    stream = phase_stream_vs_plain(device)
    group = phase_group_vs_plain(device)
    bf16_conv = phase_bf16_conv(device)
    # every pipelined dispatch from here on runs under the sync check
    c3.CHECK_DISPATCH_SYNC = True
    phase_tiny_vgg(device)
    phase_tiny_resnet(device)
    phase_tiny_3c(device)
    grpl = phase_tiny_grplasso(device)
    grpl_3c = phase_tiny_3c(device, grplasso=True)
    vgg, wall, vgg_res = phase_main_path(device)
    vgg_f32 = phase_vgg16_f32_leg(device, vgg_res, wall)
    r50, r50_wall, r50_res = phase_resnet50(device)
    mesh = phase_mesh(device, vgg_res, r50_res)
    native_rec = phase_native()
    v3c, v3c_wall, _ = phase_vgg16_3c(device)
    phase_sequential("main", _prune_vgg16, vgg_res, _check_vgg_counts)
    phase_sequential("resnet50", _prune_resnet50, r50_res, _check_resnet_bands)
    train = phase_train_vgg16(device, args.seed)
    acc = phase_accuracy_loop(device, args.seed)
    addbn = phase_addbn_3c(device)
    digits = acc["launches"]
    xcp = phase_xception(device)
    frcnn, frcnn_res = phase_frcnn(device)
    frcnn_f32 = phase_frcnn_f32_leg(device, frcnn_res)
    fitfc = phase_vgg16_fitfc(device)
    autodet = phase_vgg16_autodet(device)
    if args.profile:
        phase_profile("vgg16", _prune_vgg16, wall)
        phase_profile("resnet50", _prune_resnet50, r50_wall)
        phase_profile("vgg16_3c", lambda work: _prune("vgg16", "4.0", work,
                                                      mode="3c"), v3c_wall)
        phase_profile("xception", lambda work: _prune("xception", "2.0", work),
                      xcp["wall"])
        phase_profile("frcnn", lambda work: _prune(
            "frcnn_vgg16", "5.0", work, "--image-size", "600"), frcnn["wall"])

    (WORK / "train_phases.json").write_text(json.dumps(
        {"card": card, "train": train, "accuracy": acc, "addbn_3c": addbn}, indent=1))
    (WORK / "mesh_phases.json").write_text(json.dumps(
        {"card": card, "mesh": mesh, "native": native_rec}, indent=1,
        default=str))
    print(f"[train] phase numbers -> {WORK / 'train_phases.json'}")
    (WORK / "prune_phases.json").write_text(json.dumps(
        {"card": card, "xception_2x": xcp, "frcnn_600_5x": frcnn,
         "frcnn_600_5x_f32": frcnn_f32, "vgg16_5x_f32": vgg_f32,
         "bf16_conv": bf16_conv, "vgg16_fitfc_4x": fitfc,
         "vgg16_autodet_5x": autodet, "k3": group}, indent=1, default=str))
    print(card)
    source = "channel_pruning_tpu_torch/csrc/lasso_cd.cu"
    by_path = {"vgg16_5x": vgg, "resnet50_2x": r50, "vgg16_3c_4x": v3c,
               "digits_vgg_16x": digits, "tiny_resnet_grplasso": grpl,
               "tiny_3c_grplasso": grpl_3c,
               "xception_2x": xcp["launches"], "frcnn_600_5x": frcnn["launches"],
               "vgg16_fitfc_4x": fitfc["launches"],
               "vgg16_autodet_5x": autodet["launches"]}
    for tag, rec in mesh.items():
        if tag == "one_device":
            continue
        by_path[f"vgg16_5x_{tag}"] = rec["vgg16_5x"]["launches"]
        by_path[f"resnet50_2x_{tag}"] = rec["resnet50_2x"]["launches"]

    def launches(k):
        per = {name: n[k] for name, n in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    # library_ms: no PyTorch call computes Gram-form coordinate descent, nor
    # the group lasso's block coordinate descent
    print(json.dumps({"kernels": [
        {"name": "lasso_cd_grid", "route": "cuda", "source": source,
         "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:85",
         **launches("k1"), "library_ms": None, **stats},
        {"name": "lasso_cd_grid_stream", "route": "cuda", "source": source,
         "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:209",
         **launches("k2"), "library_ms": None, **stream},
        {"name": "group_cd_grid", "route": "cuda",
         "source": "channel_pruning_tpu_torch/csrc/group_cd.cu",
         "replaces": "channel_pruning_tpu/ops/lasso.py:612",
         **launches("k3"), "library_ms": None, **group}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
