#!/usr/bin/env python3
"""K1/K2 on the alpha grids of one benchmark cell's compression job, on one
NVIDIA card:

    python3 tools/cd_cell_grids.py --workload resnet50.cp2x \\
        [--other path/to/other/lasso_cd.cu ...] [--reps 3] [--seed N]
    python3 tools/cd_cell_grids.py --designs [--other ...]
    python3 tools/cd_cell_grids.py --widths 728,1536,4100 [--other ...]

It sets the cell up as `port_bench/run.py` does, runs one job with every
grid of a live round (an alpha not +inf, as `cd.live_alphas` counts them)
that the searches hand to
`kernels/lasso_cd.cd_solve_grid` captured (G, b, alphas_n, n_sweeps), and
times each grid on the package's build of `csrc/lasso_cd.cu` and on a
build of each `--other` source (the parent commit's, say), in turns (the
builds' order reversed every other round), with CUDA events, one launch
each, and checks that every build gives the package's betas and stats bit
for bit. One JSON line per width class (c <= 128, 256, 512, 1024, 2048,
8192) and build:

  grids, grid_ms        the class's grids and their summed median time
  densest_moves_sweep   moves a sweep of the densest alpha of any grid
  moves, windows        summed over each grid's slowest alpha (the most
                        steps: nonzero-delta steps + sweeps x chunks)
  cyc_move, cyc_window  a least-squares fit of each grid's time on its
                        slowest alpha's moves and windows, in SM cycles
  move_share            cyc_move x moves over the class's time

then a line with each build's `ptxas_report()`. `--designs` takes the
grids of the searches on every committed LASSO design
(`reference.solve_lasso`, as chip_smoke.py's phase 5i runs them) in place
of a cell's job; `--widths` one seeded grid a width (a random Gram, 16
alphas from dense to empty, 200 sweeps). Lines also go to
work/cd_cell_grids/<workload | designs | widths>.jsonl (git-ignored).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CLASSES = (128, 256, 512, 1024, 2048, 8192)


def width_class(c: int, classes=CLASSES) -> int:
    """The smallest class bound at or above c."""
    return next(b for b in classes if c <= b)


def slowest_alpha(stats: np.ndarray, c: int) -> tuple[int, int]:
    """(moves, windows) of the alpha with the most serial steps, from a
    grid's (A, 2) stats: a sweep has one window a chunk that ends with no
    move, and one step a move."""
    windows = stats[:, 0].astype(np.int64) * ((c + 31) // 32)
    moves = stats[:, 1].astype(np.int64)
    i = int(np.argmax(moves + windows))
    return int(moves[i]), int(windows[i])


def fit_steps(t_ms, moves, windows) -> tuple[float, float, float] | None:
    """(ms a grid, ms a move, ms a window) from the least-squares fit
    t = a + m * moves + w * windows; None with fewer than 4 grids."""
    if len(t_ms) < 4:
        return None
    A = np.stack([np.ones(len(t_ms)), np.asarray(moves, float),
                  np.asarray(windows, float)], axis=1)
    sol, *_ = np.linalg.lstsq(A, np.asarray(t_ms, float), rcond=None)
    return float(sol[0]), float(sol[1]), float(sol[2])


def class_rows(grids, times: dict[str, list[float]], sm_mhz: float,
               classes=CLASSES) -> list[dict]:
    """One row a width class and build from the captured `grids` (dicts
    with c, stats) and each build's median ms a grid."""
    rows = []
    for bound in classes:
        idx = [i for i, g in enumerate(grids)
               if width_class(g["c"], classes) == bound]
        if not idx:
            continue
        mw = [slowest_alpha(grids[i]["stats"], grids[i]["c"]) for i in idx]
        dens = max(float((grids[i]["stats"][:, 1]
                          / np.maximum(grids[i]["stats"][:, 0], 1)).max())
                   for i in idx)
        for build, t in times.items():
            ts = [t[i] for i in idx]
            row = {"class": f"c<={bound}", "build": build, "grids": len(idx),
                   "c": sorted({grids[i]["c"] for i in idx}),
                   "grid_ms": sum(ts), "densest_moves_sweep": dens,
                   "moves": sum(m for m, _ in mw),
                   "windows": sum(w for _, w in mw)}
            fit = fit_steps(ts, [m for m, _ in mw], [w for _, w in mw])
            if fit is not None:
                a, m, w = fit
                row.update(fixed_ms=a, cyc_move=m * 1e-3 * sm_mhz * 1e6,
                           cyc_window=w * 1e-3 * sm_mhz * 1e6,
                           move_share=m * row["moves"] / max(sum(ts), 1e-12))
            rows.append(row)
    return rows


def capture(run) -> list[dict]:
    """The grids of the live rounds that `run()` hands to the kernels."""
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd

    grids = []
    real = lasso_cd.cd_solve_grid

    def spy(G, b, a_n, n_sweeps=200, tol=1e-8, stats=None):
        if bool(torch.isfinite(a_n).any()):
            grids.append({"G": G.clone(), "b": b.clone(), "a": a_n.clone(),
                          "n_sweeps": n_sweeps, "tol": tol,
                          "c": int(G.shape[0])})
        return real(G, b, a_n, n_sweeps=n_sweeps, tol=tol, stats=stats)

    lasso_cd.cd_solve_grid = spy
    try:
        run()
    finally:
        lasso_cd.cd_solve_grid = real
    torch.cuda.synchronize()
    return grids


def cell_grids(workload: str, seed: int, device) -> list[dict]:
    """One job of the cell, after a warm one, with its grids captured."""
    from port_bench import generate, harness, job

    cell = harness.load_cell(ROOT, workload)
    program = job.Program(cell.config, cell.traffic, device)
    order = generate.pool_order(harness.POOL, seed)
    _, params, pool, _ = harness.make_inputs(cell, program, seed, device,
                                             len(order))
    spans = job.Spans()
    program.run(params, pool[0], spans, job=-1)      # warm
    return capture(lambda: program.run(params, pool[0], spans, job=0))


def design_grids(device) -> list[dict]:
    """The searches on every committed LASSO design, grids captured."""
    from channel_pruning_tpu_torch import reference

    designs = [d for path in reference.LASSO_DESIGN_PATHS
               for d in reference.load_lasso_designs(path)[1].values()]

    def run():
        for d in designs:
            reference.solve_lasso(d, device)
    return capture(run)


def width_grids(widths: list[int], seed: int, device) -> list[dict]:
    """One grid a width: G = ZᵀZ of 2c normal rows, b = Zᵀy with y a sum of
    a quarter of the columns plus noise, 16 alphas from 1e-4 to 1 of
    max|b|, 200 sweeps."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    grids = []
    for c in widths:
        rng = np.random.default_rng([seed, c])
        Z = rng.normal(size=(2 * c, c)).astype(np.float32)
        y = (Z[:, : max(c // 4, 1)].sum(axis=1)
             + 0.05 * rng.normal(size=2 * c)).astype(np.float32)
        gram = lasso.lasso_gram(torch.from_numpy(Z).to(device),
                                torch.from_numpy(y).to(device))
        a = np.geomspace(1e-4, 1.0, 16) * float(gram.b.abs().max())
        grids.append({"G": gram.G, "b": gram.b,
                      "a": torch.as_tensor(a, dtype=torch.float32).to(device),
                      "n_sweeps": 200, "tol": 1e-8, "c": c})
    return grids


def solve(lib, g, stats=None):
    """One grid on the build `lib` (kernels/lasso_cd's launch path)."""
    from channel_pruning_tpu_torch.kernels import lasso_cd
    saved = lasso_cd._lib
    lasso_cd._lib = lib
    try:
        return lasso_cd.cd_solve_grid(g["G"], g["b"], g["a"],
                                      n_sweeps=g["n_sweeps"], tol=g["tol"],
                                      stats=stats)
    finally:
        lasso_cd._lib = saved


def sm_clock_mhz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True)
    try:
        return float(r.stdout.split()[0])
    except (IndexError, ValueError):
        return float("nan")


def main() -> int:
    import torch

    from channel_pruning_tpu_torch.kernels import lasso_cd
    from port_bench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--workload")
    src.add_argument("--designs", action="store_true")
    src.add_argument("--widths", type=lambda v: [int(x) for x in v.split(",")])
    ap.add_argument("--seed", type=int, default=2147483999)
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(f"[grids] card: {harness.card_line()}", flush=True)
    builds = {"package": (lasso_cd.build(), lasso_cd.SOURCE)}
    for path in args.other:
        builds[str(path)] = (lasso_cd.bind(lasso_cd.compile_source(path)),
                             path)
    if args.workload:
        label, grids = args.workload, cell_grids(args.workload, args.seed,
                                                 device)
    elif args.designs:
        label, grids = "designs", design_grids(device)
    else:
        label, grids = "widths", width_grids(args.widths, args.seed, device)
    first = {}
    for name, (lib, _) in builds.items():
        first[name] = []
        for g in grids:
            st = torch.zeros((g["a"].shape[0], 2), dtype=torch.int32,
                             device=device)
            first[name].append((solve(lib, g, st), st))
    torch.cuda.synchronize()
    for g, (_, st) in zip(grids, first["package"]):
        g["stats"] = st.cpu().numpy()
    equal = {name: all(torch.equal(a, b) and torch.equal(sa, sb)
                       for (a, sa), (b, sb) in zip(first["package"], got))
             for name, got in first.items() if name != "package"}
    order = list(builds)
    turns = [order if r % 2 == 0 else order[::-1] for r in range(args.reps)]
    ev = {name: [[] for _ in grids] for name in builds}
    for turn in turns:
        for name in turn:
            lib = builds[name][0]
            for i, g in enumerate(grids):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                solve(lib, g)
                e1.record()
                ev[name][i].append((e0, e1))
    torch.cuda.synchronize()
    mhz = sm_clock_mhz()
    times = {name: [statistics.median(a.elapsed_time(b) for a, b in pairs)
                    for pairs in per] for name, per in ev.items()}
    head = {"workload": label, "grids": len(grids),
            "bit_equal_builds": equal, "sm_mhz_after": mhz,
            "clocks": harness.clock_line(),
            "total_ms": {n: sum(t) for n, t in times.items()}}
    classes = sorted(set(args.widths)) if args.widths else CLASSES
    lines = [head] + class_rows(grids, times, mhz, classes) + [
        {"ptxas": {n: lasso_cd.ptxas_report(src) for n, (_, src)
                   in builds.items()}}]
    out_dir = ROOT / "work" / "cd_cell_grids"
    out_dir.mkdir(parents=True, exist_ok=True)
    with (out_dir / f"{label}.jsonl").open("a") as f:
        for line in lines:
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
