"""Mid-solve checkpoint/resume.

The reference's only resumability is artifact-level (stage prototxt/
caffemodel pairs + the frozen pickle, SURVEY.md §5 'Checkpoint / resume');
a crash inside the per-layer solve loop loses the whole pass. Here the solve
drivers (pipeline/c3.py) snapshot their full state every K layers, so a
killed process — including a device fault mid-run — resumes
from the last completed layer with identical results (everything downstream
of the snapshot is recomputed deterministically).

Writes are ASYNC: `maybe_save` takes a cheap shallow snapshot of the state
tree (the solve drivers REPLACE param arrays rather than mutating them, so
a two-level dict copy pins a consistent view) and serialises it on a
background thread. At 3C scale the state is ~1 GB and a synchronous pickle
sat ~5 s per layer on the critical path — on a single-core host the write
now overlaps the device waits of the next layer. The atomic tmp-then-rename
pattern is kept, so a crash mid-write leaves the previous snapshot intact.
"""
from __future__ import annotations

import pickle
import threading
import time
from pathlib import Path
from typing import Any


def _shallow_snapshot(v: Any, depth: int = 0) -> Any:
    """Copy the dict/list spine of a solve-state tree (params pytrees are
    two levels of dicts over numpy leaves); leaves are shared, which is safe
    because the drivers never mutate arrays in place."""
    if isinstance(v, dict) and depth < 3:
        return {k: _shallow_snapshot(x, depth + 1) for k, x in v.items()}
    if isinstance(v, list):
        return list(v)
    return v


class SolveCheckpoint:
    """Pickle-based solve-state snapshotter. `path=None` disables it."""

    def __init__(self, path: str | Path | None, every: int = 3) -> None:
        self.path = Path(path) if path else None
        self.every = max(1, every)
        self._pending: threading.Thread | None = None
        # seconds of each completed write, in order (read after `wait`)
        self.write_seconds: list[float] = []

    def wait(self) -> None:
        """Block until the in-flight async write (if any) completes."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None

    def load(self) -> tuple[int, dict[str, Any]] | None:
        self.wait()
        if self.path is None or not self.path.exists():
            return None
        with open(self.path, "rb") as f:
            snap = pickle.load(f)
        return snap["layer_index"], snap["state"]

    def maybe_save(self, layer_index: int, state: dict[str, Any],
                   force: bool = False) -> None:
        if self.path is None:
            return
        if not force and (layer_index + 1) % self.every:
            return
        snap = {"layer_index": layer_index,
                "state": _shallow_snapshot(state)}
        self.wait()                      # one write in flight at a time
        t = threading.Thread(target=self._write, args=(snap,), daemon=True)
        self._pending = t
        t.start()

    def _write(self, snap: dict[str, Any]) -> None:
        t0 = time.perf_counter()
        tmp = self.path.with_suffix(".tmp")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(snap, f, protocol=4)
        tmp.replace(self.path)           # atomic: crash keeps the old snap
        self.write_seconds.append(time.perf_counter() - t0)

    def clear(self) -> None:
        self.wait()
        if self.path is not None and self.path.exists():
            self.path.unlink()
