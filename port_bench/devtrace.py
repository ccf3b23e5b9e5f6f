"""The device trace of a `--trace 1` run: torch.profiler with CUDA activity
only over the measured window, its device operations (kernels, copies,
sets) moved onto the host's `time.perf_counter` clock by a marker kernel
launched at a known host time, the union of their intervals (so two
streams never count twice), the idle gaps between them, and the time by
operation name."""
from __future__ import annotations

import time
from dataclasses import dataclass

MARKER = "spin_kernel"           # the kernel torch.cuda._sleep launches


@dataclass
class DeviceTrace:
    ops: list[tuple[str, float, float]]    # (name, start, end), host seconds
    lo: float                              # the traced window, host seconds
    hi: float

    def busy_seconds(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.ops], self.lo, self.hi)

    def seconds_of(self, substring: str) -> float:
        return sum(e - s for n, s, e in self.ops if substring in n)

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self) -> list[tuple[float, float]]:
        return gaps([(s, e) for _, s, e in self.ops], self.lo, self.hi)


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals clipped to [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in time order."""
    out, cur = [], lo
    for s, e in merged(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


class Recorder:
    """Profile the device from `start()` to `stop()`."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._mark_host = 0.0

    def start(self) -> None:
        torch = self._torch
        self._prof.start()
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()

    def stop(self, lo: float, hi: float) -> DeviceTrace:
        self._torch.cuda.synchronize()
        self._prof.stop()
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")]
        mark = [e for e in events if MARKER in e.name()]
        if not mark:
            raise RuntimeError("the marker kernel is missing from the trace")
        offset = mark[0].start_ns() * 1e-9 - self._mark_host
        ops = [(e.name(), e.start_ns() * 1e-9 - offset,
                (e.start_ns() + e.duration_ns()) * 1e-9 - offset)
               for e in events if e is not mark[0]]
        return DeviceTrace(ops=ops, lo=lo, hi=hi)
