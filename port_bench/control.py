"""The readings the limits under `limits/` are set from, on the card:

    python3 port_bench/control.py --workload <cell> --problems 0,1,2,... \\
        --control-problems 0,1,2 [--roundings fp8,tf32] [--out <file>.jsonl]

A run of the benchmark judges one fixed problem (the configuration's
`problem_seed`: its weights, calibration pool and held-out images); its
`--seed` only orders the pool. So that the limits hold for more than that
one problem, this draws a problem from each seed of `--problems` in its
place, runs one whole job of the program on its judged calibration set and
judges it as a run does (the lower readings); for each seed of
`--control-problems` it also judges the control, the reference in the
program's place in the next lower precision (the upper readings), once for
each precision of `--roundings` (default: the traffic's
`control_rounding`). Problem `problem_seed` is the one every run judges.
One JSON line a problem. The benchmark's runs never run this."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--problems", default="")
    ap.add_argument("--control-problems", default="")
    ap.add_argument("--roundings", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from port_bench import checks, harness, job
    root = harness.HERE.parent
    cell = harness.load_cell(root, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    program = job.Program(cell.config, cell.traffic, device)
    problems = _seeds(args.problems)
    ctrl = set(_seeds(args.control_problems))
    roundings = [r for r in args.roundings.split(",") if r] or \
        [cell.traffic["control_rounding"]]
    # a warm job first, so that each problem's job_s is a warm job's
    orig, params, sets, held = harness.make_inputs(cell, program, 0, device, 1)
    program.run(params, sets[0], job.Spans(), job=-1)
    out = open(args.out, "a") if args.out else None
    try:
        for problem in sorted(set(problems) | ctrl,
                              key=lambda s: (s not in problems, s)):
            t = time.perf_counter()
            orig, params, sets, held = harness.make_inputs(
                cell, program, 0, device, 1, problem=problem)
            res = program.run(params, sets[0], job.Spans(), job=0)
            kinds = [("program", None)]
            if problem in ctrl:
                kinds += [(f"control_{r}", r) for r in roundings]
            judged = {}
            for kind, rounding in kinds:
                judged[kind] = checks.judge(
                    orig, params, sets[0], held, cell.config, cell.traffic,
                    harness.job_settings(program), job.plain_layers(res.graph),
                    res.params, res.selections, res.cache.feats, res.cache.plan,
                    harness.report_alphas(res.reports),
                    device, control=rounding is not None, rounding=rounding)
            line = {"workload": cell.name, "problem": problem,
                    "job_s": res.seconds, "wall_s": time.perf_counter() - t,
                    **{k: v["numbers"] for k, v in judged.items()},
                    "detail": {k: v["detail"] for k, v in judged.items()}}
            text = json.dumps(line, default=str)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
