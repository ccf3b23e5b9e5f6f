#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (channel_pruning_tpu_torch) on one
NVIDIA card:

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises (exit code != 0):
  1. the card: torch.cuda must be available; nvidia-smi name and power limit;
  2. build the LASSO CD kernel (csrc/lasso_cd.cu) from the checkout;
  3. the kernel against its plain PyTorch version on the card at c = 256
     and c = 512 with a 32-alpha grid: identical supports, betas within
     rtol 1e-5 / atol 1e-6; times from CUDA events;
  4. the port on the card against the port on the CPU on the tiny VGG:
     identical selections;
  5. the main path, `cli prune --model vgg16 --mode prune --speed 5.0
     --device cuda` with its defaults (50 x 10 synthetic calibration
     images, random He-init weights): keep counts equal the released 5x
     table, the first layer starts from an exact input, reconstruction
     beats the accumulated error from the third pruned layer on (the first
     two end above their start on random weights in the JAX package too,
     and are held to fixed bounds near their observed values), the kernel
     was launched, and the exported model reloads and runs to finite
     probabilities that sum to 1;
  6. with --profile only: the main path once more under torch.profiler,
     with the device's busy time, idle share and top kernels.
The next-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Nothing of JAX or of the JAX package is
imported here: the shared jax-free pieces come through
channel_pruning_tpu_torch.shared.
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


def _cd_problem(seed: int, c: int, device):
    """A LASSO Gram at main-path shape: Z from post-ReLU 3x3 patches of 250
    rows (the layer's row subsample) against He-init consumer weights."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    rng = np.random.default_rng(seed)
    n = c
    X = np.maximum(rng.normal(size=(250, c, 3, 3)), 0).astype(np.float32)
    W2 = (rng.normal(size=(n, c, 3, 3)) * np.sqrt(2.0 / (9 * c))).astype(np.float32)
    Xd, Wd = torch.from_numpy(X).to(device), torch.from_numpy(W2).to(device)
    Z = lasso.build_channel_response(Xd, Wd)
    y = Z.sum(dim=1) + 0.05 * torch.from_numpy(
        rng.normal(size=Z.shape[0]).astype(np.float32)).to(device)
    gram = lasso.lasso_gram(Z, y)
    a_max = float(gram.b.abs().max()) / gram.n_samples
    alphas = torch.as_tensor(np.geomspace(1e-3 * a_max, a_max, 32) * gram.n_samples,
                             dtype=torch.float32).to(device)
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


def phase_kernel_vs_plain(device) -> dict:
    """Kernel against plain version; the returned times are those at
    c = 512, the widest consumer input of the main path."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.ops import lasso

    worst = 0.0
    for seed, c in ((0, 256), (1, 512)):
        gram, alphas = _cd_problem(seed, c, device)
        lasso_cd.cd_solve_grid(gram.G, gram.b, alphas)              # warm-up
        ms, got = _time_ms(lambda: lasso_cd.cd_solve_grid(gram.G, gram.b, alphas), 5)
        plain_ms, ref = _time_ms(
            lambda: lasso_cd.cd_solve_grid_plain(gram.G, gram.b, alphas), 1)
        sup, sup_ref = lasso.support_mask(got), lasso.support_mask(ref)
        if not torch.equal(sup, sup_ref):
            raise AssertionError(f"c={c}: kernel and plain supports differ")
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        sizes = lasso.support_sizes(got).cpu().tolist()
        print(f"[kernel] c={c} A=32: supports {min(sizes)}..{max(sizes)} "
              f"identical; max|kernel-plain| {err:.3e}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_tiny_vgg(device) -> None:
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling import sampler
    from channel_pruning_tpu_torch.shared import (build_tiny_vgg,
                                                  default_config, split_relu)

    g, params = build_tiny_vgg(batch=4, image_size=16)
    g = split_relu(g)
    inputs = np.random.default_rng(7).normal(0, 1, (8, 4, 3, 16, 16)).astype(np.float32)
    cfg = default_config().replace_nested("solve.fused_search", False)
    sel = {}
    for dev in (device, torch.device("cpu")):
        cache = sampler.freeze(g, params_to_torch(params, dev), inputs,
                               device=dev, n_points=10, seed=0, chunk_batches=4)
        sel[dev.type] = c3.solve_prune(g, params, cache, cfg,
                                       channel_targets=TINY_TARGETS,
                                       device=dev, verbose=False).selections
    if sel["cuda"].keys() != sel["cpu"].keys() or any(
            not np.array_equal(sel["cuda"][k], sel["cpu"][k]) for k in sel["cpu"]):
        raise AssertionError(f"tiny VGG selections differ: {sel}")
    print(f"[tiny_vgg] card and CPU select identically in "
          f"{len(sel['cpu'])} layers", flush=True)


def _prune_vgg16(work: Path):
    from channel_pruning_tpu_torch import cli

    shutil.rmtree(work, ignore_errors=True)
    return cli.main(["prune", "--model", "vgg16", "--mode", "prune",
                     "--speed", "5.0", "--device", "cuda",
                     "--work-dir", str(work)])


def phase_profile(wall: float) -> None:
    """`--profile`: the main path once more under torch.profiler (device
    activity only). Device busy time is the sum of the kernels' and copies'
    self device times; the idle share is given against the profiled run's
    wall and against the unprofiled main-path run's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _prune_vgg16(WORK / "vgg16_profiled")
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e6, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    print(f"[profile] device busy {busy:.3f}s; profiled wall {pwall:.2f}s "
          f"(idle {1 - busy / pwall:.1%}); unprofiled wall {wall:.2f}s "
          f"(idle {1 - busy / wall:.1%})")
    for s, n, key in rows[:10]:
        print(f"[profile] {s:8.3f}s {100 * s / busy:5.1f}% {n:6d}x {key[:100]}")


def phase_main_path(device) -> tuple[int, float]:
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs
    from channel_pruning_tpu_torch.shared import (VGG16_5X_CHANNELS,
                                                  build_vgg16, import_model,
                                                  total_flops)

    work = WORK / "vgg16"
    torch.cuda.reset_peak_memory_stats(device)
    lasso_cd.LAUNCHES = 0
    t0 = time.perf_counter()
    res = _prune_vgg16(work)
    wall = time.perf_counter() - t0
    launches = lasso_cd.LAUNCHES
    peak = torch.cuda.max_memory_allocated(device)

    pruned = {p: t for p, t in VGG16_5X_CHANNELS.items() if t < 512}
    got = {p: int(res.params[p]["W"].shape[0]) for p in pruned}
    if got != pruned:
        raise AssertionError(f"keep counts {got} != released table {pruned}")
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
    if launches <= 0:
        raise AssertionError("the main path never launched the CD kernel")

    g, p = import_model(work / "cp_vgg16.prototxt", work / "cp_vgg16.caffemodel")
    x = SyntheticInputs(1, g.inputs[0].shape[0], tuple(g.inputs[0].shape[1:])).batch(0)
    outs, _ = run_graph(g, params_to_torch(p, device), {"data": x.to(device)})
    prob = outs["prob"]
    if not (torch.isfinite(prob).all() and
            torch.allclose(prob.sum(-1), torch.ones(prob.shape[0], device=device),
                           atol=1e-4)):
        raise AssertionError("exported model does not give probabilities")

    orig = total_flops(build_vgg16(), include_fc=False)
    new = total_flops(g, include_fc=False)
    print("[main] layer       keep      rMSE before -> after   replay s  solve s")
    for r in res.reports:
        print(f"[main] {r.conv:<10s} {r.kept:>4d}/{r.total:<4d} {r.rmse_before:.4f} -> "
              f"{r.rmse_after:.4f}      {r.replay_seconds:7.3f}  {r.solve_seconds:7.3f}")
    print("[main] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; conv mults {orig:,} -> {new:,} "
          f"({orig / new:.2f}x); kernel launches {launches}; "
          f"peak device memory {peak / 2**30:.2f} GiB; exported model reloads, "
          f"probabilities sum to 1", flush=True)
    return launches, wall


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke run of the port on one card")
    parser.add_argument("--profile", action="store_true",
                        help="also run the main path under torch.profiler and "
                             "print device busy time, idle share and top kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.kernels import lasso_cd

    card = _card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    device = resolve_device("cuda")

    t = time.perf_counter()
    lasso_cd.build()
    print(f"[build] lasso_cd.cu -> sm_90a in {time.perf_counter() - t:.2f}s",
          flush=True)

    stats = phase_kernel_vs_plain(device)
    phase_tiny_vgg(device)
    launches, wall = phase_main_path(device)
    if args.profile:
        phase_profile(wall)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "lasso_cd_grid", "route": "cuda",
        "source": "channel_pruning_tpu_torch/csrc/lasso_cd.cu",
        "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:85",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
