"""Spans and counters inside the port, on one clock with the device.

    trace.enable(device)          # clears the records of any earlier window
    trace.set_job(k)
    with trace.span("pass.solve", layer="conv2_1"):
        ...
    trace.count("cd.sweeps", n)
    trace.disable()
    spans, counts = trace.records(), trace.counters()

Off (the default), `span()` returns one shared no-op context: no
allocation, no CUDA call, no profiler range, and `count()` does nothing.
On, each span records its name, its layer (its parent's when not given),
the job `set_job` names, its parent span, and its start and end on the
host's `time.perf_counter` clock. With a CUDA `device` it also records a
timing event at entry and at exit on the stream that was that device's
current stream at `enable` (the port's work runs on it), with no host
sync. Anchor events, recorded on the idle stream right after a
`synchronize()` by `enable` and again by `disable`, put the events on
the host clock; the second corrects the drift of the card's clock
against the host's over the window. The events are read lazily, by
`records()` after the work.
A span also enters `torch.profiler.record_function(name)`, so the same
names appear in any profiler trace. Spans open and close on one thread.

`counters()` gives the host counters added since `enable`, and the CD
kernels' launch counters (`kernels/lasso_cd.LAUNCHES`, `LAUNCHES_STREAM`,
`LAUNCHES_SPLIT`, `kernels/group_cd.LAUNCHES`, which stay where they
are) and the CD kernels' queue stalls, counted on the
card while tracing is on (`lasso_cd.queue_stalls()`, a host read), as
their increase since `enable`.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass

import torch

_OFF = contextlib.nullcontext()


@dataclass
class Span:
    name: str
    layer: str | None
    job: int | None
    parent: int | None            # index of the enclosing span in records()
    host_start: float             # time.perf_counter seconds
    host_end: float = math.nan    # nan while the span is open
    dev_start: float | None = None    # on the host clock; None without a card
    dev_end: float | None = None
    self_s: float = math.nan      # host seconds less its children's

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start

    @property
    def dev_s(self) -> float | None:
        return None if self.dev_start is None else self.dev_end - self.dev_start


def _launches() -> dict[str, int]:
    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
    return {"cd.k1_launches": lasso_cd.LAUNCHES,
            "cd.k2_launches": lasso_cd.LAUNCHES_STREAM,
            "cd.split_launches": lasso_cd.LAUNCHES_SPLIT,
            "cd.queue_stalls": lasso_cd.queue_stalls(),
            "cd.k3_launches": group_cd.LAUNCHES}


def _event():
    return torch.cuda.Event(enable_timing=True)


class Tracer:
    """The state of one traced window (module functions below drive the
    process's tracer)."""

    def __init__(self) -> None:
        self.on = False
        self._clear(None, {})

    def _clear(self, device, launch0: dict[str, int]) -> None:
        self.device = device              # a CUDA device, or None
        self._stream = None if device is None else \
            torch.cuda.current_stream(device)
        self.job: int | None = None
        self._spans: list[Span] = []
        self._events: list[tuple | None] = []
        self._stack: list[int] = []
        self._counts: dict[str, int] = {}
        self._launch0 = launch0
        self._anchors: list[tuple[float, object]] = []   # (host time, event)

    def enable(self, device=None) -> None:
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type != "cuda":
            dev = None
        self._clear(dev, _launches())
        self._anchor()
        self.on = True

    def _anchor(self) -> None:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            ev = _event()
            t0 = time.perf_counter()
            ev.record(self._stream)
            ev.synchronize()
            # on an idle stream the event completes between the two reads
            self._anchors.append((0.5 * (t0 + time.perf_counter()), ev))

    def disable(self) -> None:
        if self.on:
            self._anchor()
        self.on = False

    @contextlib.contextmanager
    def _open(self, name: str, layer: str | None):
        parent = self._stack[-1] if self._stack else None
        if layer is None and parent is not None:
            layer = self._spans[parent].layer
        rec = Span(name, layer, self.job, parent, time.perf_counter())
        evs = None
        if self.device is not None:
            evs = (_event(), _event())
            evs[0].record(self._stream)
        self._stack.append(len(self._spans))
        self._spans.append(rec)
        self._events.append(evs)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if evs is not None:
                evs[1].record(self._stream)
            rec.host_end = time.perf_counter()
            self._stack.pop()

    def count(self, name: str, n: int) -> None:
        if self.on:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def records(self) -> list[Span]:
        """The window's spans in the order they opened, the closed ones
        with their device times (each end event is waited for, so call
        this after the work) and self times."""
        spans = self._spans
        if self._anchors:
            t0, a0 = self._anchors[0]
            rate = 1.0                # host seconds a device second
            if len(self._anchors) > 1:
                t1, a1 = self._anchors[-1]
                a1.synchronize()
                rate = (t1 - t0) / (a0.elapsed_time(a1) * 1e-3)
        for s, evs in zip(spans, self._events):
            if evs is not None and s.dev_start is None \
                    and not math.isnan(s.host_end):
                evs[1].synchronize()
                s.dev_start = t0 + a0.elapsed_time(evs[0]) * 1e-3 * rate
                s.dev_end = t0 + a0.elapsed_time(evs[1]) * 1e-3 * rate
        child = [0.0] * len(spans)
        for s in spans:
            if s.parent is not None and not math.isnan(s.host_end):
                child[s.parent] += s.host_s
        for s, c in zip(spans, child):
            s.self_s = s.host_s - c
        return list(spans)

    def counters(self) -> dict[str, int]:
        out = dict(self._counts)
        for k, v in _launches().items():
            out[k] = v - self._launch0.get(k, 0)
        return out


_TRACER = Tracer()


def enable(device=None) -> None:
    """Turn tracing on and clear the records of any earlier window; with a
    CUDA `device`, spans also time the device on its current stream."""
    _TRACER.enable(device)


def disable() -> None:
    """Turn tracing off; the records stay readable until `enable`."""
    _TRACER.disable()


def enabled() -> bool:
    return _TRACER.on


def set_job(k: int | None) -> None:
    """Tag the spans opened from now on with job `k`."""
    _TRACER.job = k


def span(name: str, layer: str | None = None):
    """A context that records one span when tracing is on."""
    return _TRACER._open(name, layer) if _TRACER.on else _OFF


def count(name: str, n: int) -> None:
    """Add `n` to the host counter `name` when tracing is on."""
    _TRACER.count(name, n)


def records() -> list[Span]:
    return _TRACER.records()


def counters() -> dict[str, int]:
    return _TRACER.counters()


def layer_table(spans: list[Span], names: tuple[str, ...], tag: str
                ) -> list[str]:
    """One line a layer, and one of totals, with each of `names`' host self
    seconds and device seconds (its summed spans; "-" without a card)."""
    by: dict[str | None, dict[str, list[float]]] = {}
    for s in spans:
        if s.name in names and not math.isnan(s.host_end):
            row = by.setdefault(s.layer, {}).setdefault(s.name, [0.0, 0.0])
            row[0] += s.self_s
            row[1] += s.dev_s if s.dev_s is not None else math.nan
    total: dict[str, list[float]] = {}
    for row in by.values():
        for n, (h, d) in row.items():
            t = total.setdefault(n, [0.0, 0.0])
            t[0] += h
            t[1] += d

    def cells(row):
        return " | ".join(
            f"{n} host {row[n][0]:.4f}s dev "
            + ("-" if math.isnan(row[n][1]) else f"{row[n][1]:.4f}s")
            for n in names if n in row)

    lines = [f"[{tag}] {layer}: {cells(row)}" for layer, row in by.items()]
    lines.append(f"[{tag}] totals over {len(by)} layers: {cells(total)}")
    return lines
