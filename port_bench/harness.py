"""One run of one cell: set-up, the measured window of back-to-back
compression jobs, the check against the plain reference, and the result
line. Everything a cell needs is found by name: its configuration
(`configs/<config>.json` and the plain builder `configs/<reference>.py`),
its traffic (`traffic/<traffic>.json`), its limits (`limits/<cell>.json`)
and each metric's reader (`metrics/<metric>.py`, `read(ctx)` returning a
number or None)."""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path


HERE = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "channel_pruning_tpu"}
# The check judges the window's latest job on this calibration set of the
# problem, so that what is judged hangs neither on how many jobs the window
# held nor on the order of the pool.
JUDGED_SET = 0
# The pool of calibration sets the window's jobs cycle through, and the
# held-out images the compressed model is judged on.
POOL = 2
HELD_OUT_IMAGES = 50


def process_start() -> float:
    """This process's start on the `time.time` clock (Linux), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + start / ticks
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclass
class Cell:
    """A cell of BENCHMARK.json with the files it names, read as data."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    reference: object                   # the config's plain builder module

    def layers(self) -> list[dict]:
        return self.reference.layers(self.config)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    base = root / bench["paths"][0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    ref = importlib.import_module(f"port_bench.configs.{config['reference']}")
    return Cell(name=name, chips=int(cell["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                reference=ref)


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    window_jobs: list[int] = field(default_factory=list)
    job_seconds: list[float] = field(default_factory=list)
    cd_searches: list[list[tuple[int, int]]] = field(default_factory=list)
    spans: object = None
    trace: object = None
    orig: list[dict] = field(default_factory=list)
    out: list[dict] = field(default_factory=list)
    check: dict = field(default_factory=dict)

    @property
    def job_s(self) -> float:
        return self.window_s / len(self.window_jobs)

    def span_mean(self, label: str) -> float | None:
        s = self.spans.seconds(label, self.window_jobs)
        return sum(s) / len(self.window_jobs) if s else None

    def setting(self, key: str, default: str) -> str:
        for kv in self.cell.traffic.get("set", []):
            k, _, v = kv.partition("=")
            if k == key:
                return v
        return default


def read_metrics(ctx: Context, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"port_bench.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not available ({exc})"


def clock_line() -> str:
    """The card's clocks, temperature, power draw and throttle reasons, and
    the host's load averages: read beside each window, so that a drift
    between runs can be placed."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                            "temperature.gpu,power.draw,"
                            "clocks_throttle_reasons.active",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        card = r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        card = f"nvidia-smi not available ({exc})"
    try:
        load = " ".join(Path("/proc/loadavg").read_text().split()[:3])
    except OSError:
        load = "?"
    return f"{card}; host load {load}"


def finite(v: float) -> float | None:
    """A reading for the JSON line: None where it is not finite."""
    return v if math.isfinite(v) else None


def banned_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & BANNED)


def report_alphas(reports: list[dict]) -> dict[str, float]:
    """{solved layer: the LASSO alpha its search reports}."""
    return {r["conv"]: float(r["alpha"]) for r in reports
            if r.get("alpha") is not None}


def cd_searches(reports: list[dict]) -> list[tuple[int, int]]:
    """(c, grids) of each fused search a job ran."""
    return [(int(r["total"]), int(r["grids"])) for r in reports
            if r.get("grids") and r.get("total")]


def gap_breakdown(trace, spans, jobs) -> list[list]:
    """The ten longest idle gaps, each named by the span it fell in."""
    named = []
    for s, e in trace.idle_gaps():
        mid = 0.5 * (s + e)
        label = next((f"{l} (job {j})" for l, j, t0, t1 in spans.items
                      if j in jobs and t0 <= mid <= t1), "between spans")
        named.append([label, e - s])
    return sorted(named, key=lambda x: -x[1])[:10]


def make_inputs(cell: Cell, program, seed: int, device, pool: int,
                problem: int | None = None):
    """(original layers, weights, `pool` calibration sets in the order the
    jobs cycle through them, held-out images): the problem from the
    configuration's `problem_seed` (or `problem`), the order from `seed`;
    the weights checked against the layout the program takes. Set k of
    the problem is at `order.index(k)`."""
    from port_bench import generate
    cfg = cell.config
    orig = cell.layers()
    bs, nb = int(cfg["batch_size"]), int(cfg["n_batches"])
    sample = (3, int(cfg["image_size"]), int(cfg["image_size"]))
    problem = int(cfg["problem_seed"]) if problem is None else int(problem)
    params = generate.weights(orig, (bs,) + sample, problem, device)
    for name, d in program.param_shapes().items():
        got = params.get(name, {}).get("W")
        if got is None or tuple(got.shape) != d["W"]:
            raise RuntimeError(f"{name}: the program takes W {d['W']}, the "
                               f"configuration gives "
                               f"{None if got is None else got.shape}")
    sets = [generate.calibration_set((nb, bs) + sample, problem, k, device)
            for k in generate.pool_order(pool, seed)]
    held = generate.held_out(HELD_OUT_IMAGES, sample, problem, device)
    return orig, params, sets, held


def job_settings(program) -> dict:
    """The job settings the check needs: the program's config with the
    traffic's settings."""
    c = program.cfg
    return {"n_points": c.sample.n_points_per_layer, "seed": c.sample.seed,
            "rank_tol": c.dic.rank_tol, "subsample_rows": c.lasso.subsample_rows,
            "ridge": c.solve.ls_ridge}


def run(args, root: Path, t_start: float) -> int:
    cell = load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    return measure(cell, args, torch.device("cuda"), t_start)


def measure(cell: Cell, args, device, t_start: float) -> int:
    """Set-up, window, check and result on `device` (the card; the tests
    drive it on the CPU at a tiny size)."""
    import torch

    from port_bench import checks, job
    on_card = device.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    program = job.Program(cfg, tr, device)
    from port_bench import generate
    order = generate.pool_order(POOL, args.seed)
    orig, params, pool, held = make_inputs(cell, program, args.seed, device,
                                           len(order))
    judged_at = order.index(JUDGED_SET)
    spans = job.Spans()
    # One warm job on each calibration set, in the window's cycle order.
    # Each is held while the next runs, and the judged set's is kept as the
    # window keeps it, so that the host memory of two jobs' outputs is
    # taken in set-up: else the window's first job that runs beside a held
    # output takes it, 0.3-0.5 s slow on ResNet-50.
    judged = prev = None
    for k in range(-len(pool), 0):
        out = program.run(params, pool[k % len(pool)], spans, job=k)
        if k % len(pool) == judged_at:
            judged = out
        prev, out = out, None
    prev = None
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    launches0 = job.launch_counts()

    clocks0 = clock_line() if on_card else "none (cpu)"
    rec = None
    if args.trace:
        from port_bench.devtrace import Recorder
        rec = Recorder()
        rec.start()
    ctx = Context(cell=cell, spans=spans, orig=orig, setup_s=setup_s)
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    k = 0
    judged_done = False               # the window judges a job of its own
    while True:
        # job k calibrates on set k mod pool: no two jobs in a row see the
        # same images
        out = program.run(params, pool[k % len(pool)], spans, job=k)
        ctx.window_jobs.append(k)
        ctx.job_seconds.append(out.seconds)
        ctx.cd_searches.append(cd_searches(out.reports))
        if k % len(pool) == judged_at:
            judged = out              # the latest job on the judged set
            judged_done = True
        out = None
        k += 1
        if time.perf_counter() >= deadline and judged_done:
            break
    t1 = time.perf_counter()
    ctx.window_s = t1 - t0
    if rec is not None:
        ctx.trace = rec.stop(t0, t1)
    clocks1 = clock_line() if on_card else "none (cpu)"
    launches = {kk: v - launches0[kk] for kk, v in job.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    images = pool[judged_at]
    out_layers = job.plain_layers(judged.graph)
    ctx.out = out_layers
    cache_feats, cache_plan = judged.cache.feats, judged.cache.plan
    out_params, selections = judged.params, judged.selections
    alphas = report_alphas(judged.reports)
    cfgv = job_settings(program)
    del judged, program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    ctx.check = checks.judge(orig, params, images, held, cfg, tr, cfgv,
                             out_layers, out_params, selections, cache_feats,
                             cache_plan, alphas, device)
    check_s = time.perf_counter() - t_chk
    ok, rows = checks.verdict(ctx.check["numbers"], cell.limits)

    metrics = read_metrics(ctx, cell.per_layer if args.trace else cell.end_to_end)
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    print(f"[bench] card: {card_line() if on_card else 'none (cpu)'}")
    print(f"[bench] clocks before the window: {clocks0}; after: {clocks1}")
    print(f"[bench] cell {cell.name}, seed {args.seed}: setup {setup_s:.4f} s; "
          f"{k} jobs in {ctx.window_s:.4f} s: "
          + " ".join(f"{s:.4f}" for s in ctx.job_seconds))
    print("[bench] phase split (s a job): " + " ".join(
        f"{lab} {ctx.span_mean(lab):.4f}" for lab in
        ("preprocess", "upload", "freeze", "prune_pass")
        if ctx.span_mean(lab) is not None))
    print(f"[bench] peak device memory {peak} bytes; CD launches in the "
          f"window {launches}; check {check_s:.2f} s; head error "
          f"{ctx.check['detail']['model_rel_err']:.6g}")
    print(f"[bench] check detail: {json.dumps(ctx.check['detail'], default=str)}")
    result = {"correct": bool(ok), "attempted": k, "failed": 0 if ok else 1,
              "metrics": metrics, "device": dev_info}
    if ctx.trace is not None:
        busy = ctx.trace.busy_seconds()
        dev_info.update(busy_s=busy, window_s=ctx.window_s)
        result["breakdown"] = {
            "device_ops": ctx.trace.top_ops(10),
            "idle_gaps": gap_breakdown(ctx.trace, spans, set(ctx.window_jobs))}
    result["checks"] = {n: {k: finite(v) for k, v in r.items()} for n, r in rows.items()}
    banned = banned_modules()
    if banned:
        print(f"[bench] modules that must not load: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, r in rows.items():
        print(f"[check] {name} {r['value']:.6g} limit {r['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def main(argv=None, t_start: float | None = None) -> int:
    t_start = process_start() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    # one process with few threads: the job's host work is one thread's
    # dispatch and numpy, and idle pools of BLAS and OpenMP threads only
    # contend with it on a host whose cores are shared
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    return run(args, root, t_start)

