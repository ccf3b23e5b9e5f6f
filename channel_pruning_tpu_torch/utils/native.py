"""Build and load the port's host C++ libraries (csrc/caffemodel.cpp,
csrc/preprocess.cpp) with the host's g++, at first use, never at import.

The flags are native/Makefile's. Each library is built once per (source,
flags, target CPU) into `_build/`, under a name that carries their hash,
and moved into place with an atomic rename, so processes that build at once
(test workers) never load half a library, and a library built for one CPU
is never loaded on another (`-march=native`). The first compiler that
builds the source is used; when none does, or the library does not load,
`build` raises with the compilers' output: nothing falls back quietly.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-std=c++17")


def _compilers() -> list[str]:
    """The host's C++ compilers to try, in order: $CXX, g++ on PATH, the
    system's /usr/bin/g++ (a toolchain on PATH may lack OpenMP's runtime,
    which csrc/preprocess.cpp needs)."""
    seen = []
    for c in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++"):
        if c and Path(c).exists() and c not in seen:
            seen.append(c)
    if not seen:
        raise RuntimeError("no C++ compiler: g++ is not on PATH and CXX is "
                           "not set")
    return seen


@functools.lru_cache(maxsize=None)
def _target_key(cxx: str) -> str:
    """What `-march=native` resolves to on this host, from the compiler."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    return proc.stdout + proc.stderr


def library_path(source: Path, cxx: str | None = None) -> Path:
    cxx = cxx or _compilers()[0]
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join((cxx,) + CXXFLAGS).encode())
    h.update(_target_key(cxx).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _compile(source: Path, cxx: str, so: Path) -> str | None:
    """Build `so`; None on success, else the command and its output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent load never sees half
    return None


@functools.lru_cache(maxsize=None)
def build(source: Path) -> ctypes.CDLL:
    """Compile `source` into a shared library under `_build/` (once per
    hash) with the first of `_compilers()` that builds it, and load it
    (once per process). Raises with every compiler's output when none
    does."""
    errors = []
    for cxx in _compilers():
        so = library_path(source, cxx)
        if not so.exists():
            err = _compile(source, cxx, so)
            if err is not None:
                errors.append(err)
                continue
        try:
            return ctypes.CDLL(str(so))
        except OSError as exc:
            raise RuntimeError(f"cannot load {so}: {exc}") from exc
    raise RuntimeError("\n".join(errors))
