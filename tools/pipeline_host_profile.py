#!/usr/bin/env python3
"""Where the host time of the port's solve goes, on one NVIDIA card.

    python3 tools/pipeline_host_profile.py [--models vgg16,resnet50]
    python3 tools/pipeline_host_profile.py --count-ops    # on the CPU

For each model (VGG-16 5x, ResNet-50 2x, through the port's CLI with its
defaults) the pipelined pass and the sequential pass
(`--set solve.fused_search=False`) each run once to warm up and once under
torch.profiler with CPU and CUDA activities and the port's tracing on
(utils/trace), so the profiler's ranges are the program's own spans
(`freeze.upload`, `pass.advance`, `solve.search`, `pass.drain_wait`, ...);
the lines give each span's host seconds and calls, the CUDA runtime calls
(launches, copies, syncs), the kernels' device seconds and the program's
counters (CD launches and sweeps). Work directories go under work/
(git-ignored).
`--count-ops` instead counts the torch ops the fused alpha search
dispatches per round (the CD grid stubbed out), on the CPU. Imports only
the port.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def count_search_ops() -> None:
    """Torch ops `_fused_search` dispatches for 1 and for 8 rounds, per
    band end, on a seeded 64-channel problem (the CD grid stubbed out:
    its launch is one call whatever the round)."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from channel_pruning_tpu_torch.kernels import lasso_cd
    from channel_pruning_tpu_torch.ops import lasso

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(0)
    Z = torch.from_numpy(rng.normal(size=(600, 64)).astype(np.float32))
    gram = lasso.lasso_gram(Z, Z[:, :20].sum(dim=1))
    lasso_cd.cd_solve_grid = lambda G, b, a, **kw: torch.zeros(
        (a.shape[0], G.shape[0]))
    for prefer in ("top", "bottom"):
        counts = []
        for rounds in (1, 8):
            Count.n = 0
            with Count():
                lasso._fused_search(gram.G, gram.b, gram.n_samples, 20, 0.1,
                                    1e-3, 16, rounds, 200, prefer)
            counts.append(Count.n)
        print(f"[ops] fused search, band {prefer}: {counts[0]} torch ops for "
              f"1 round, {counts[1]} for 8 ({(counts[1] - counts[0]) / 7:.0f} "
              "a round)")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from channel_pruning_tpu_torch import cli
    from channel_pruning_tpu_torch.utils import trace

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default="vgg16,resnet50")
    parser.add_argument("--count-ops", action="store_true",
                        help="count the fused search's torch ops on the CPU")
    args = parser.parse_args()
    if args.count_ops:
        count_search_ops()
        return 0
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    speeds = {"vgg16": "5.0", "resnet50": "2.0"}
    for model in args.models.split(","):
        for name, extra in (("pipelined", []),
                            ("sequential", ["--set", "solve.fused_search=False"])):
            work = ROOT / "work" / f"host_profile_{model}"
            argv = ["prune", "--model", model, "--speed", speeds[model],
                    "--device", "cuda", "--work-dir", str(work), *extra]
            shutil.rmtree(work, ignore_errors=True)
            cli.main(argv)                                   # warm-up
            shutil.rmtree(work, ignore_errors=True)
            trace.enable("cuda")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            trace.disable()
            spans = {s.name for s in trace.records()}
            events = prof.key_averages()
            # device-side kernels and copies; the spans' ranges also show
            # on the device timeline and are not work
            kernels = [e for e in events if e.device_type.name == "CUDA"
                       and e.self_device_time_total > 0
                       and e.key not in spans]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            print(f"[host] {model} {name}: profiled wall {wall:.2f}s, solve "
                  f"{res.wall['solve']:.2f}s; device busy {busy:.3f}s")
            rows = sorted(events, key=lambda e: -e.cpu_time_total)
            for e in rows:
                if e.device_type.name == "CPU" and (e.key in spans or e.key in (
                        "cudaLaunchKernel", "cudaMemcpyAsync",
                        "cudaStreamSynchronize", "cudaEventSynchronize",
                        "cudaDeviceSynchronize")):
                    print(f"[host] {model} {name} {e.key:28s} calls "
                          f"{e.count:7d} host {e.cpu_time_total / 1e6:7.3f}s "
                          f"(self {e.self_cpu_time_total / 1e6:7.3f}s)")
            print(f"[host] {model} {name} counters {trace.counters()}")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
                print(f"[host] {model} {name} device {e.self_device_time_total / 1e6:7.3f}s "
                      f"{e.count:6d}x {e.key[:80]}")
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
