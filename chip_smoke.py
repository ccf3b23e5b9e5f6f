#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (channel_pruning_tpu_torch) on one
NVIDIA card:

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises (exit code != 0):
  1. the card: torch.cuda must be available; nvidia-smi name and power limit;
  2. build the LASSO CD kernels K1 and K2 (csrc/lasso_cd.cu) from the
     checkout, and print ptxas's registers / shared memory per kernel;
  3. K1 against its plain PyTorch version on the card at c = 256
     and c = 512 with a 32-alpha grid: identical supports, betas within
     rtol 1e-5 / atol 1e-6; times from CUDA events;
  3b. K2 against the plain version at c = 2048 and c = 4096 (1x1 patches,
     the shape of a res5 gate), 32 alphas, over 3 sweeps (a full plain grid
     at c = 2048 takes about a minute): identical supports, max|K2-plain|
     = 0; then K2's time over the full 200 sweeps; and K2 against K1 at
     c = 512 and c = 1024 with full sweeps: equal bit for bit;
  4. the port on the card against the port on the CPU on the tiny VGG:
     identical selections; the same on the tiny ResNet (Select gates,
     residual compensation, DAG frontier, band=bottom);
  5. the main path, `cli prune --model vgg16 --mode prune --speed 5.0
     --device cuda` with its defaults (50 x 10 synthetic calibration
     images, random He-init weights): keep counts equal the released 5x
     table, the first layer starts from an exact input, reconstruction
     beats the accumulated error from the third pruned layer on (the first
     two end above their start on random weights in the JAX package too,
     and are held to fixed bounds near their observed values), the kernel
     was launched, and the exported model reloads and runs to finite
     probabilities that sum to 1;
  5b. the second main path, `cli prune --model resnet50 --mode prune
     --speed 2.0 --device cuda` with its defaults: all 32 branch2a/2b widths
     inside the released band [t, round(1.1 t)] (tools/band_check.py's
     rule), 16 Select gates with keep counts inside the same band against
     the released Filter table, K2 (res5b/res5c gates, c = 2048) and K1
     both launched, every rMSE finite (on random weights after < before
     does not hold in the JAX package either), and the exported model
     reloads and gives probabilities;
  6. with --profile only: each main path once more under torch.profiler,
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


def _cd_problem(seed: int, c: int, device, k: int = 3, n: int | None = None):
    """A LASSO Gram at main-path shape: Z from post-ReLU k x k patches of 250
    rows (the layer's row subsample) against He-init weights of an n-wide
    consumer (n = c by default)."""
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
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "c": 512, "n_sweeps": 200}


def phase_stream_vs_plain(device) -> dict:
    """K2, through the dispatch, against the plain version over 3 sweeps at
    c = 2048 (res5b/res5c) and c = 4096, then K2 alone over the full 200
    sweeps; K2 against K1 at c <= 1024. The returned times are those at
    c = 2048."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.ops import lasso

    worst, stats = 0.0, {}
    for seed, c in ((2, 2048), (3, 4096)):
        gram, alphas = _cd_problem(seed, c, device, k=1, n=512)
        before = (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM)
        lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, n_sweeps=3)       # warm-up
        ms3, got = _time_ms(
            lambda: lasso_cd.cd_solve_grid(gram.G, gram.b, alphas, n_sweeps=3), 5)
        if (lasso_cd.LAUNCHES, lasso_cd.LAUNCHES_STREAM) != (before[0], before[1] + 6):
            raise AssertionError(f"c={c}: the dispatch did not launch K2 alone")
        plain3, ref = _time_ms(lambda: lasso_cd.cd_solve_grid_plain(
            gram.G, gram.b, alphas, n_sweeps=3), 1)
        if not torch.equal(lasso.support_mask(got), lasso.support_mask(ref)):
            raise AssertionError(f"c={c}: K2 and plain supports differ")
        err = float((got - ref).abs().max())
        if err != 0.0:
            raise AssertionError(f"c={c}: max|K2-plain| = {err}, want 0")
        worst = max(worst, err)
        ms200, full = _time_ms(lambda: lasso_cd.cd_solve_grid(gram.G, gram.b, alphas), 5)
        sizes = lasso.support_sizes(full).cpu().tolist()
        print(f"[kernel] K2 c={c} A=32: 3 sweeps: supports identical, "
              f"max|K2-plain| {err:.1e}, K2 {ms3:.3f} ms, plain {plain3:.3f} ms; "
              f"200 sweeps: K2 {ms200:.3f} ms (supports {min(sizes)}..{max(sizes)})",
              flush=True)
        stats[c] = (ms3, plain3, ms200)
        del gram, alphas, got, ref, full
    for seed, c in ((1, 512), (4, 1024)):
        gram, alphas = _cd_problem(seed, c, device)
        k1 = lasso_cd.cd_solve_grid(gram.G, gram.b, alphas)
        k2 = lasso_cd.cd_solve_grid_stream(gram.G, gram.b, alphas)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"c={c}: K2 differs from K1 by "
                                 f"{float((k1 - k2).abs().max())}")
        print(f"[kernel] K2 = K1 bit for bit at c={c} A=32, 200 sweeps", flush=True)
    ms3, plain3, ms200 = stats[2048]
    return {"max_abs_err": worst, "ms": ms3, "plain_ms": plain3, "c": 2048,
            "n_sweeps": 3, "ms_200_sweeps": ms200,
            "ms_200_sweeps_c4096": stats[4096][2]}


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


def phase_tiny_resnet(device) -> None:
    """Gates on every block input and shrink targets on branch2a/2b, as in
    tests/test_resnet_pipeline.py, band=bottom: card and CPU select alike."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling import sampler
    from channel_pruning_tpu_torch.shared import (LT, build_tiny_resnet,
                                                  default_config)

    g, p = c3.preprocess(*build_tiny_resnet(batch=4, image_size=32))
    inputs = np.random.default_rng(11).normal(0, 1, (8, 4, 3, 32, 32)).astype(np.float32)
    cfg = default_config().replace_nested("solve.fused_search", False) \
        .replace_nested("solve.band", "bottom")
    ct = {c: max(2, int(int(g.layer(c).attr("num_output")) * 0.7))
          for c in g.convs if c.endswith(("branch2a", "branch2b"))}
    it = {c: max(2, int(p[c]["W"].shape[1] * 0.7))
          for c in g.convs if c.endswith("branch2a")}
    res = {}
    for dev in (device, torch.device("cpu")):
        cache = sampler.freeze(g, params_to_torch(p, dev), inputs, device=dev,
                               n_points=8, seed=0, chunk_batches=4,
                               share_key=sampler.resnet_share_key(g))
        res[dev.type] = c3.solve_prune(g, p, cache, cfg, channel_targets=ct,
                                       input_targets=it, device=dev, verbose=False)
    sel = {k: r.selections for k, r in res.items()}
    if sel["cuda"].keys() != sel["cpu"].keys() or any(
            not np.array_equal(sel["cuda"][k], sel["cpu"][k]) for k in sel["cpu"]):
        raise AssertionError(f"tiny ResNet selections differ: {sel}")
    gates = len(res["cuda"].graph.by_type(LT.SELECT))
    if gates != len(it):
        raise AssertionError(f"{gates} Select gates, want {len(it)}")
    print(f"[tiny_resnet] card and CPU select identically in "
          f"{len(sel['cpu'])} layers ({gates} Select gates)", flush=True)


def _prune_vgg16(work: Path):
    from channel_pruning_tpu_torch import cli

    shutil.rmtree(work, ignore_errors=True)
    return cli.main(["prune", "--model", "vgg16", "--mode", "prune",
                     "--speed", "5.0", "--device", "cuda",
                     "--work-dir", str(work)])


def _prune_resnet50(work: Path):
    from channel_pruning_tpu_torch import cli

    shutil.rmtree(work, ignore_errors=True)
    return cli.main(["prune", "--model", "resnet50", "--mode", "prune",
                     "--speed", "2.0", "--device", "cuda",
                     "--work-dir", str(work)])


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
    print(f"[profile] {label}: device busy {busy:.3f}s; profiled wall "
          f"{pwall:.2f}s (idle {1 - busy / pwall:.1%}); unprofiled wall "
          f"{wall:.2f}s (idle {1 - busy / wall:.1%})")
    for s, n, key in rows[:10]:
        print(f"[profile] {label} {s:8.3f}s {100 * s / busy:5.1f}% {n:6d}x {key[:100]}")


def phase_main_path(device) -> tuple[dict[str, int], float]:
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
    lasso_cd.LAUNCHES = lasso_cd.LAUNCHES_STREAM = 0
    t0 = time.perf_counter()
    res = _prune_vgg16(work)
    wall = time.perf_counter() - t0
    launches = {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM}
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
    if launches["k1"] <= 0:
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
          f"({orig / new:.2f}x); kernel launches K1 {launches['k1']} "
          f"K2 {launches['k2']}; "
          f"peak device memory {peak / 2**30:.2f} GiB; exported model reloads, "
          f"probabilities sum to 1", flush=True)
    return launches, wall


def _check_band(name: str, target: int, got, tol: float = 0.1) -> bool:
    """tools/band_check.py's rule: target <= got <= round(target * 1.1)."""
    return got is not None and target <= got <= int(round(target * (1 + tol)))


def phase_resnet50(device) -> tuple[dict[str, int], float]:
    """The ResNet-50 2x main path through the CLI with its defaults."""
    import torch

    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs
    from channel_pruning_tpu_torch.shared import (LT, RESNET50_2X_BRANCH2A,
                                                  RESNET50_2X_BRANCH2B,
                                                  RESNET50_2X_FILTERS,
                                                  build_resnet50, import_model,
                                                  total_flops)

    work = WORK / "resnet50"
    torch.cuda.reset_peak_memory_stats(device)
    lasso_cd.LAUNCHES = lasso_cd.LAUNCHES_STREAM = 0
    t0 = time.perf_counter()
    res = _prune_resnet50(work)
    wall = time.perf_counter() - t0
    launches = {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM}
    peak = torch.cuda.max_memory_allocated(device)

    print("[resnet50] layer            kind  keep       rMSE before -> after   replay s  solve s")
    for r in res.reports:
        print(f"[resnet50] {r.conv:<16s} {r.kind:<5s} {r.kept:>4d}/{r.total:<4d} "
              f"{r.rmse_before:.4f} -> {r.rmse_after:.4f}      "
              f"{r.replay_seconds:7.3f}  {r.solve_seconds:7.3f}")
    failures = []
    if len(res.reports) != 40:
        failures.append(f"{len(res.reports)} layers solved, want 40")
    bad = [r.conv for r in res.reports
           if not (np.isfinite(r.rmse_before) and np.isfinite(r.rmse_after))]
    if bad:
        failures.append(f"rMSE not finite in {bad}")
    wide = sorted(r.conv for r in res.reports if r.total > lasso_cd.MAX_C)
    if wide != ["res5b_branch2a", "res5c_branch2a"] or launches["k2"] <= 0:
        failures.append(f"K2 launches {launches['k2']} for layers {wide}")
    if launches["k1"] <= 0:
        failures.append("K1 never launched")

    g, p = import_model(work / "cp_resnet50.prototxt", work / "cp_resnet50.caffemodel")
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

    x = SyntheticInputs(1, g.inputs[0].shape[0], tuple(g.inputs[0].shape[1:])).batch(0)
    outs, _ = run_graph(g, params_to_torch(p, device), {"data": x.to(device)})
    prob = outs["prob"]
    if not (torch.isfinite(prob).all() and
            torch.allclose(prob.sum(-1), torch.ones(prob.shape[0], device=device),
                           atol=1e-4)):
        failures.append("exported model does not give probabilities")
    orig = total_flops(build_resnet50(), include_fc=False)
    new = total_flops(g, include_fc=False)
    print(f"[resnet50] branch widths in the released band {len(branches) - len(out_band)}"
          f"/{len(branches)} ({exact} exact); Select gates {len(gates)}, in band "
          f"{len(RESNET50_2X_FILTERS) - len(gates_out)}/16 ({gates_exact} exact)")
    print("[resnet50] wall " + " ".join(f"{k} {v:.2f}s" for k, v in res.wall.items())
          + f"; total {wall:.2f}s; replay {sum(r.replay_seconds for r in res.reports):.2f}s"
          f" solve {sum(r.solve_seconds for r in res.reports):.2f}s over the layers; "
          f"conv mults {orig:,} -> {new:,} ({orig / new:.2f}x); kernel launches "
          f"K1 {launches['k1']} K2 {launches['k2']}; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if failures:
        raise AssertionError("ResNet-50 2x: " + "; ".join(failures))
    print("[resnet50] exported model reloads, probabilities sum to 1", flush=True)
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
    print(f"[build] lasso_cd.cu (K1, K2) -> sm_90a in {time.perf_counter() - t:.2f}s",
          flush=True)
    for line in lasso_cd.ptxas_report().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    stats = phase_kernel_vs_plain(device)
    stream = phase_stream_vs_plain(device)
    phase_tiny_vgg(device)
    phase_tiny_resnet(device)
    vgg, wall = phase_main_path(device)
    r50, r50_wall = phase_resnet50(device)
    if args.profile:
        phase_profile("vgg16", _prune_vgg16, wall)
        phase_profile("resnet50", _prune_resnet50, r50_wall)

    print(card)
    source = "channel_pruning_tpu_torch/csrc/lasso_cd.cu"
    print(json.dumps({"kernels": [
        {"name": "lasso_cd_grid", "route": "cuda", "source": source,
         "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:85",
         "launches": vgg["k1"] + r50["k1"],
         "launches_by_path": {"vgg16_5x": vgg["k1"], "resnet50_2x": r50["k1"]},
         **stats},
        {"name": "lasso_cd_grid_stream", "route": "cuda", "source": source,
         "replaces": "channel_pruning_tpu/kernels/lasso_cd.py:209",
         "launches": vgg["k2"] + r50["k2"],
         "launches_by_path": {"vgg16_5x": vgg["k2"], "resnet50_2x": r50["k2"]},
         **stream}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
