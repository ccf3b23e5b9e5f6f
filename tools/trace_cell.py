#!/usr/bin/env python3
"""The port's own spans and counters (utils/trace) over windows of one
benchmark cell's compression jobs, on one NVIDIA card:

    python3 tools/trace_cell.py --workload vgg16.cp5x [--seed N] [--seconds 25]

It sets the cell up as `port_bench/run.py` does (the same program, inputs,
pool and warm jobs) and runs four windows of back-to-back jobs, each under
the benchmark's device trace (`port_bench/devtrace.Recorder`): traced,
untraced, untraced, traced, where "traced" turns the port's tracing on.
Each window prints one JSON line with its `job_s`, `idle_pct`, `cd_ms`
and `dwconv_ms` as the benchmark reads them; a traced window adds, a job
each:

  replay_ms      device busy in `pass.advance` (frontier replay, gathers)
  search_ms      device busy in `solve.search` (K1/K2 and the search's ops)
  upload_ms      device busy in `freeze.upload` and `pass.upload`
  drain_wait_ms  host ms in `pass.drain_wait`
  cd_sweeps      `cd.sweeps` / `cd.live_alphas` over the window
  cd_moves       `cd.moves` / `cd.sweeps`: nonzero-delta steps a sweep of
                 a live alpha, over the window
  dw_ms          device busy in `forward.depthwise` (the depthwise convs
                 of the freeze and the replays)
  cd_split_share `cd.split_launches` over K1's and K2's launches: the share
                 run on a split instance (one chain warp, update warps)
  cd_stalls_per_move  `cd.queue_stalls` over `cd.moves`: the share of
                 moves at which the chain warp waited for room in its move
                 queue (it checks for room only at a step's start, for the
                 whole step, so a stall is a step that waited, counted at
                 its first move)
  shrinks, gates, dw_shrinks, dw_gates
                 the `prune.*` counters a job: group-1 producers shrunk,
                 Selects inserted, depthwise convs shrunk, Selects in
                 front of a depthwise conv
  dw_alignment   the share of the `conv_depthwise2d` kernels' time inside
                 the `forward.depthwise` spans' device extents, as recorded
                 and at the shift of the extents that holds most: a check
                 of the two clocks on spans of a fraction of a millisecond

"Device busy" is the union of the trace's operations clipped to the
spans' device extents. It also checks the shared clock (device starts
after host starts, the pass spans of a job disjoint on the device and
inside the job's `prune_pass`), names the ten longest idle gaps by the
innermost program span open on the host at their midpoint, splits device
time by operation inside the main spans, and gives each job's split.
Lines also go to work/trace_cell/<workload>.jsonl (git-ignored).
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.devtrace import merged  # noqa: E402

PASS = ("pass.upload", "pass.advance", "pass.target", "pass.solve",
        "pass.to_host", "pass.drain_wait", "pass.bookkeep")
SPLIT = ("freeze.upload", "freeze.forward", "freeze.to_host", "pass.upload",
         "pass.advance", "pass.target", "solve.gram", "solve.search",
         "solve.fit", "pass.to_host", "forward.depthwise")
PRUNE_COUNTERS = ("shrinks", "gates", "dw_shrinks", "dw_gates")
CLOCK_SLACK = 1e-4          # seconds: the events' launch latency


def extents(spans, names) -> list[tuple[float, float]]:
    """The merged device extents of the spans called one of `names`."""
    return merged([(s.dev_start, s.dev_end) for s in spans
                   if s.name in names and s.dev_start is not None])


def overlap_seconds(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals (`b` the shorter: each of its intervals is found in `a` by
    bisection)."""
    ends = [e for _, e in a]
    out = 0.0
    for lo, hi in b:
        i = bisect.bisect_right(ends, lo)
        while i < len(a) and a[i][0] < hi:
            out += max(0.0, min(a[i][1], hi) - max(a[i][0], lo))
            i += 1
    return out


def busy_ms(spans, names, ops, n_jobs: int) -> float:
    """Device ms a job in which an operation ran inside the spans called
    one of `names`."""
    busy = merged([(s, e) for _, s, e in ops])
    return 1e3 * overlap_seconds(busy, extents(spans, names)) / n_jobs


def host_ms(spans, names, n_jobs: int) -> float:
    return 1e3 * sum(s.host_s for s in spans if s.name in names) / n_jobs


def ops_in(spans, name: str, ops, n: int = 3) -> list[list]:
    """The `n` operation names with the most device seconds inside the
    spans called `name`."""
    ext = extents(spans, (name,))
    by: dict[str, list] = {}
    for op, s, e in ops:
        by.setdefault(op, []).append((s, e))
    secs = {op: overlap_seconds(merged(v), ext) for op, v in by.items()}
    return [[op[:60], v] for op, v in
            sorted(secs.items(), key=lambda kv: -kv[1])[:n] if v > 0]


def clock_checks(spans, harness_items, jobs) -> dict:
    """The shared clock held to what causality and one stream imply."""
    timed = [s for s in spans if s.dev_start is not None]
    after = sum(s.dev_start >= s.host_start - CLOCK_SLACK for s in timed)
    overlaps = outside = 0
    for j in jobs:
        win = [(t0, t1) for l, jj, t0, t1 in harness_items
               if l == "prune_pass" and jj == j]
        own = sorted((s.dev_start, s.dev_end) for s in timed
                     if s.job == j and s.name in PASS)
        overlaps += sum(b[0] < a[1] - 1e-6 for a, b in zip(own, own[1:]))
        if win and own:
            t0, t1 = win[0]
            outside += sum(s < t0 - CLOCK_SLACK or e > t1 + CLOCK_SLACK
                           for s, e in own)
    return {"spans_timed": len(timed),
            "dev_after_host_share": after / len(timed) if timed else None,
            "pass_overlaps": overlaps, "pass_outside_prune_pass": outside}


def named_gaps(dtrace, harness_items, spans, jobs, n: int = 10) -> list[list]:
    """The `n` longest idle gaps, each named by the harness span and the
    innermost program span open on the host at its midpoint."""
    starts = sorted((s.host_start, i) for i, s in enumerate(spans))
    keys = [t for t, _ in starts]
    out = []
    for s, e in sorted(dtrace.idle_gaps(), key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (s + e)
        label = next((f"{l} (job {j})" for l, j, t0, t1 in harness_items
                      if j in jobs and t0 <= mid <= t1), "between spans")
        inner = None
        for _, i in reversed(starts[:bisect.bisect_right(keys, mid)]):
            if spans[i].host_end >= mid:
                inner = spans[i]
                break
        if inner is not None:
            label += f" / {inner.name}" + (f" {inner.layer}" if inner.layer
                                           else "")
        out.append([label, e - s])
    return out


def job_split(spans, ops, jobs, job_seconds) -> list[dict]:
    """Each job's seconds, and for each span name its host self ms and
    its device busy ms."""
    busy = merged([(s, e) for _, s, e in ops])
    rows = []
    for j, sec in zip(jobs, job_seconds):
        own = [s for s in spans if s.job == j]
        row = {"job": j, "job_s": sec}
        for name in sorted({s.name for s in own}):
            mine = [s for s in own if s.name == name]
            row[name] = [1e3 * sum(s.self_s for s in mine),
                         1e3 * overlap_seconds(busy, extents(mine, (name,)))]
        rows.append(row)
    return rows


def kernel_alignment(spans, name: str, ops, kernel: str,
                     max_shift: float = 2e-3, step: float = 2e-5) -> dict | None:
    """The share of the device time of the kernels whose names hold
    `kernel` that lies inside the device extents of the spans called
    `name`: as recorded, and at the shift of the extents (within
    +-`max_shift` seconds) that holds the most."""
    ext = extents(spans, (name,))
    kern = [(s, e) for n, s, e in ops if kernel in n]
    busy = merged(kern)
    total = sum(e - s for s, e in busy)
    if not ext or total <= 0:
        return None

    def share(d: float) -> float:
        return overlap_seconds(busy, [(s + d, e + d) for s, e in ext]) / total

    n = int(round(max_shift / step))
    best = max((k * step for k in range(-n, n + 1)), key=share)
    return {"share": share(0.0), "best_shift_ms": 1e3 * best,
            "share_at_best": share(best), "kernels": len(kern)}


def launch_readings(counts, n_jobs: int) -> dict:
    """`cd_split_share` and `cd_stalls_per_move` over the window, and each
    `prune.*` counter a job."""
    launches = counts.get("cd.k1_launches", 0) + counts.get("cd.k2_launches", 0)
    moves = counts.get("cd.moves", 0)
    out = {"cd_split_share": (counts.get("cd.split_launches", 0) / launches
                              if launches else None),
           "cd_stalls_per_move": (counts.get("cd.queue_stalls", 0) / moves
                                  if moves else None)}
    for name in PRUNE_COUNTERS:
        out[name] = counts.get(f"prune.{name}", 0) / n_jobs
    return out


def lead_ms(spans) -> list[float]:
    """The least, 1st percentile and median of device start less host
    start, in ms."""
    lead = sorted(1e3 * (s.dev_start - s.host_start) for s in spans
                  if s.dev_start is not None)
    if not lead:
        return []
    return [lead[0], lead[len(lead) // 100], lead[len(lead) // 2]]


def windows(root: Path, workload: str, seed: int, seconds: float, device,
            recorder) -> list[dict]:
    """Set the cell up and run the four windows on `device` under one
    `recorder()` (start(), stop(lo, hi) -> a DeviceTrace), whose
    operations are then split by window."""
    import torch

    from channel_pruning_tpu_torch.utils import trace
    from port_bench import generate, harness, job
    from port_bench.devtrace import DeviceTrace

    cell = harness.load_cell(root, workload)
    program = job.Program(cell.config, cell.traffic, device)
    order = generate.pool_order(harness.POOL, seed)
    _, params, pool, _ = harness.make_inputs(cell, program, seed, device,
                                             len(order))
    hspans = job.Spans()
    for k in range(-len(pool), 0):
        program.run(params, pool[k % len(pool)], hspans, job=k)
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec = recorder()
    rec.start()
    done = []
    k = 0
    for traced in (True, False, False, True):
        if traced:
            trace.enable(device)
        jobs, secs = [], []
        t0 = time.perf_counter()
        while True:
            trace.set_job(k)
            out = program.run(params, pool[k % len(pool)], hspans, job=k)
            jobs.append(k)
            secs.append(out.seconds)
            out = None
            k += 1
            if time.perf_counter() >= t0 + seconds:
                break
        t1 = time.perf_counter()
        trace.disable()
        done.append((traced, jobs, secs, t0, t1,
                     (trace.records(), trace.counters()) if traced else None,
                     harness.clock_line() if device.type == "cuda"
                     else "none (cpu)"))
    whole = rec.stop(done[0][3], done[-1][4])
    results = []
    for traced, jobs, secs, t0, t1, rc, clocks in done:
        dt = DeviceTrace(ops=[o for o in whole.ops if o[2] > t0 and o[1] < t1],
                         lo=t0, hi=t1)
        n = len(jobs)
        res = {"workload": workload, "traced": traced, "jobs": n,
               "job_s": (t1 - t0) / n,
               "idle_pct": 100.0 * (1 - dt.busy_seconds() / (t1 - t0)),
               "cd_ms": 1e3 * dt.seconds_of("lasso_cd") / n,
               "dwconv_ms": 1e3 * dt.seconds_of("conv_depthwise2d") / n,
               "clocks": clocks}
        if traced:
            spans, counts = rc
            res.update(
                replay_ms=busy_ms(spans, ("pass.advance",), dt.ops, n),
                search_ms=busy_ms(spans, ("solve.search",), dt.ops, n),
                upload_ms=busy_ms(spans, ("freeze.upload", "pass.upload"),
                                  dt.ops, n),
                drain_wait_ms=host_ms(spans, ("pass.drain_wait",), n),
                cd_sweeps=(counts.get("cd.sweeps", 0)
                           / max(counts.get("cd.live_alphas", 0), 1)),
                cd_moves=(counts.get("cd.moves", 0)
                          / max(counts.get("cd.sweeps", 0), 1)),
                dw_ms=busy_ms(spans, ("forward.depthwise",), dt.ops, n),
                dw_alignment=kernel_alignment(spans, "forward.depthwise",
                                              dt.ops, "conv_depthwise2d"),
                **launch_readings(counts, n),
                counters=counts, spans=len(spans),
                clock=clock_checks(spans, hspans.items, jobs),
                lead_ms=lead_ms(spans),
                idle_gaps=named_gaps(dt, hspans.items, spans, set(jobs)),
                ops_in_spans={name: ops_in(spans, name, dt.ops)
                              for name in SPLIT},
                per_job=job_split(spans, dt.ops, jobs, secs))
        results.append(res)
        print(json.dumps(res), flush=True)
    return results


def main() -> int:
    import torch

    from port_bench import harness
    from port_bench.devtrace import Recorder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147483999)
    ap.add_argument("--seconds", type=float, default=25.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    print(f"[trace] card: {harness.card_line()}", flush=True)
    results = windows(ROOT, args.workload, args.seed, args.seconds,
                      torch.device("cuda"), Recorder)
    out_dir = ROOT / "work" / "trace_cell"
    out_dir.mkdir(parents=True, exist_ok=True)
    with (out_dir / f"{args.workload}.jsonl").open("a") as f:
        for res in results:
            f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
