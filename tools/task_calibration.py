#!/usr/bin/env python3
"""Runs the accuracy loop of chip_smoke.py (train digits_vgg from scratch on
the seeded raw-Datum task, prune with `--data-dir`, recover, evaluate each
stage on the held-out records) with the port's CLI, for several seeds and
prune speeds, and prints each run's held-out top-1 and cross-entropy. With
--jax it first trains the same task with the JAX package's CLI on the CPU
and prints its held-out top-1: the check that the task lets the JAX package
reach the smoke's bar of 0.9.

    python3 tools/task_calibration.py --device cpu --jax [--seeds 3]
    python3 tools/task_calibration.py --speeds 4,8,16,24,32 --seeds 5

Defaults are chip_smoke.TASK, TASK_TRAIN, TASK_PRUNE and TASK_RECOVER, on
the card (`--device cuda`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def jax_trained_top1(work: Path, seed: int) -> float:
    """Train the task with the JAX package's CLI on the CPU; held-out top-1."""
    import chip_smoke
    import jax

    jax.config.update("jax_platforms", "cpu")
    from channel_pruning_tpu import cli as jax_cli

    train, val = chip_smoke.write_task_lmdbs(work, seed)
    jax_cli.main(["finetune", "--model", "digits_vgg", "--data-dir", str(train),
                  *chip_smoke.TASK_TRAIN, "--seed", str(seed),
                  "--work-dir", str(work)])
    res = jax_cli.main(["eval", "--prototxt", str(work / "ft_digits_vgg.prototxt"),
                        "--weights", str(work / "ft_digits_vgg.caffemodel"),
                        "--data-dir", str(val), "--batch", "32"])
    return res["accuracy@1"]


def main() -> None:
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=1, help="seeds 0 .. N-1")
    ap.add_argument("--speeds", default=chip_smoke.TASK_PRUNE[1],
                    help="comma-separated prune speeds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax", action="store_true",
                    help="also train with the JAX package's CLI (CPU)")
    ap.add_argument("--work", default=str(ROOT / "work" / "task_calibration"))
    ap.add_argument("--noise", type=float, nargs=2, metavar=("LO", "HI"),
                    default=chip_smoke.TASK["noise"],
                    help="range of the per-record noise's standard deviation")
    ap.add_argument("--contrast", type=float, default=chip_smoke.TASK["contrast"])
    args = ap.parse_args()
    chip_smoke.TASK.update(noise=tuple(args.noise), contrast=args.contrast)
    work = Path(args.work)
    print(f"[calibration] task {chip_smoke.TASK}; train "
          f"{' '.join(chip_smoke.TASK_TRAIN)}; prune {' '.join(chip_smoke.TASK_PRUNE)} "
          f"at speeds {args.speeds}; recover {' '.join(chip_smoke.TASK_RECOVER)}; "
          f"port on {args.device}", flush=True)
    if args.device != "cpu":
        print(chip_smoke._card_line(), flush=True)
    for seed in range(args.seeds):
        if args.jax:
            t = time.perf_counter()
            top1 = jax_trained_top1(work / f"jax_seed{seed}", seed)
            print(f"[calibration] jax CLI, seed {seed}: trained held-out top-1 "
                  f"{top1:.4f} ({time.perf_counter() - t:.1f}s on the CPU)",
                  flush=True)
        for speed in args.speeds.split(","):
            chip_smoke.TASK_PRUNE[1] = speed
            out = chip_smoke.accuracy_loop(work / f"port_seed{seed}", seed,
                                           args.device)
            print(f"[calibration] port CLI, seed {seed}, speed {speed}: "
                  f"{json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
