"""LASSO coordinate descent over an alpha grid: the CUDA kernels and their
plain PyTorch version.

Two kernels in csrc/lasso_cd.cu, one block per alpha, with one contract:

* K1 replaces channel_pruning_tpu/kernels/lasso_cd.py::cd_solve_grid_pallas
  (c <= MAX_C);
* K2 replaces ...::cd_solve_grid_pallas_hbm (MAX_C < c <= MAX_C_STREAM).

Both run each alpha's coordinate chain in one warp, skip runs of
zero-delta coordinates exactly (a ballot over a window of 32 coordinates
finds the first that moves), and feed the moves through a queue in shared
memory to update warps that hold q in registers: every instance is split
so. The soft threshold's division is an f64 product with the diagonal's reciprocal,
which rounds to the same float as the division. Their contract is the
same, so `cd_solve_grid_plain` is the plain version of both, and both
match it bit for bit. The source is built with nvcc for sm_90a on first
use into `_build/` and bound through ctypes. `cd_solve_grid` launches K1
or K2 for CUDA tensors and takes the plain version only for tensors on the
CPU; a failed build or launch raises. `LAUNCHES` counts K1's launches and
`LAUNCHES_STREAM` K2's; `LAUNCHES_SPLIT` those of either on a split
instance, which every width takes. With tracing on (utils/trace), the
blocks add the steps at whose start the chain warp waited for room in its
move queue to a counter on the card, read by `queue_stalls()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from channel_pruning_tpu_torch.utils import trace

MAX_C = 1024          # K1 (the JAX dispatch's threshold); larger c is K2's
MAX_C_STREAM = 8192   # K2
LAUNCHES = 0
LAUNCHES_STREAM = 0
LAUNCHES_SPLIT = 0
_STALLS: dict = {}    # device -> the blocks' stall counter (int64)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lasso_cd.cu"
BUILD_DIR = _PKG / "_build"
_lib: ctypes.CDLL | None = None


def cd_solve_grid_plain(G: torch.Tensor, b: torch.Tensor,
                        alphas_n: torch.Tensor, n_sweeps: int = 200,
                        tol: float = 1e-8,
                        stats: torch.Tensor | None = None) -> torch.Tensor:
    """(A, c) betas; each alpha stops on its own, as ops/lasso.cd_solve in
    the JAX package does. Vectorised over alphas with an `active` mask.
    `stats`, an (A, 2) int32 tensor, receives each alpha's sweeps run and
    nonzero-delta steps, as the kernels write them."""
    c, A = G.shape[0], alphas_n.shape[0]
    sweeps = torch.zeros(A, dtype=torch.int32, device=G.device)
    moves = torch.zeros_like(sweeps)
    diag = torch.diagonal(G)
    safe_diag = torch.where(diag > 0, diag, torch.ones_like(diag))
    beta = torch.zeros((A, c), dtype=G.dtype, device=G.device)
    q = torch.zeros_like(beta)
    zero = torch.zeros(A, dtype=G.dtype, device=G.device)
    active = torch.ones(A, dtype=torch.bool, device=G.device)
    it = 0
    while it < n_sweeps and bool(active.any()):
        sweeps += active
        max_delta = torch.zeros(A, dtype=G.dtype, device=G.device)
        for j in range(c):
            bj_old = beta[:, j]
            cj = (b[j] - q[:, j]) + diag[j] * bj_old
            bj = torch.sign(cj) * torch.clamp(cj.abs() - alphas_n, min=0.0) \
                / safe_diag[j]
            bj = torch.where(diag[j] > 0, bj, zero)
            bj = torch.where(active, bj, bj_old)
            delta = bj - bj_old
            q = q + delta[:, None] * G[j][None, :]
            beta[:, j] = bj
            max_delta = torch.maximum(max_delta, delta.abs())
            if stats is not None:
                moves += delta != 0
        it += 1
        scale = torch.clamp(beta.abs().amax(dim=1), min=1e-12)
        active = active & (max_delta > tol * scale)
    if stats is not None:
        stats.copy_(torch.stack([sweeps, moves], dim=1))
    return beta


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the LASSO CD "
                           "kernel is built from csrc/lasso_cd.cu at first use")
    return found


def _so_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def ptxas_report(source: Path = SOURCE) -> str:
    """ptxas's registers, shared memory and spills for each kernel of
    `source`, from its build ("" before it is built here)."""
    path = _so_path(source).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def compile_source(source: Path) -> ctypes.CDLL:
    """Compile one CUDA source of csrc/ with nvcc for sm_90a into a shared
    library under `_build/` (once per source hash) and load it. Sources
    built from several threads at once run their nvcc side by side."""
    so = _so_path(source)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        # ptxas's registers / shared memory / spills for each kernel
        so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)       # atomic: a concurrent build never sees half
    return ctypes.CDLL(str(so))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a build's C entry points (the
    stall counter last: a build without it ignores the pointer)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("cp_lasso_cd_grid", "cp_lasso_cd_grid_stream"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32, i32, i32, ctypes.c_float, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.cp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> ctypes.CDLL:
    """Compile csrc/lasso_cd.cu, both kernels (once per source hash), and
    load it."""
    global _lib
    if _lib is None:
        _lib = bind(compile_source(SOURCE))
    return _lib


def _check_inputs(G: torch.Tensor, b: torch.Tensor, alphas_n: torch.Tensor,
                  n_sweeps: int) -> int:
    """Device, dtype, shape and contiguity checks for a kernel launch;
    returns c."""
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    c = G.shape[0]
    for name, t, shape in (("G", G, (c, c)), ("b", b, (c,)),
                           ("alphas_n", alphas_n, (alphas_n.shape[0],))):
        if t.device != G.device:
            raise ValueError(f"{name} on {t.device}, G on {G.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape or t.dim() != len(shape):
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c < 1:
        raise ValueError("empty Gram matrix")
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    return c


def _check_stats(stats: torch.Tensor | None, G: torch.Tensor, A: int) -> None:
    if stats is not None and (stats.device != G.device or stats.dtype != torch.int32
                              or tuple(stats.shape) != (A, 2)
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous ({A}, 2) int32 tensor "
                         f"on {G.device}")


def _stall_counter(device: torch.device) -> torch.Tensor:
    if device not in _STALLS:
        _STALLS[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _STALLS[device]


def queue_stalls() -> int:
    """The steps at whose start a block's chain warp waited for room in
    its move queue, over the launches made with tracing on (a host read of
    the card's counters: call it after the work). The chain checks for room
    only there, for a whole step, so this is also the moves (or empty
    steps) at which it waited."""
    return sum(int(t.item()) for t in _STALLS.values())


def _launch(entry: str, G: torch.Tensor, b: torch.Tensor,
            alphas_n: torch.Tensor, n_sweeps: int, tol: float,
            stats: torch.Tensor | None = None) -> torch.Tensor:
    """Launch one of the C entry points on the current stream; raises if the
    launch is refused. The kernels copy the diagonal blocks in 16-byte
    units from 16-byte aligned addresses: a width that is not a multiple
    of 4 is padded with inert zero rows and columns (a zero diagonal never
    moves). Nothing here reads the card on the host."""
    global LAUNCHES_SPLIT
    c, A = G.shape[0], alphas_n.shape[0]
    if c % 4 or G.data_ptr() % 16 or b.data_ptr() % 16:
        cp = c + (-c % 4)
        Gp = torch.zeros((cp, cp), dtype=G.dtype, device=G.device)
        bp = torch.zeros(cp, dtype=b.dtype, device=b.device)
        Gp[:c, :c], bp[:c] = G, b
        return _launch(entry, Gp, bp, alphas_n, n_sweeps, tol,
                       stats)[:, :c].contiguous()
    out = torch.empty((A, c), dtype=torch.float32, device=G.device)
    fn = getattr(build(), entry)
    ptrs = [G.data_ptr(), b.data_ptr(), alphas_n.data_ptr(), out.data_ptr(),
            stats.data_ptr() if stats is not None else None]
    stalls = _stall_counter(G.device).data_ptr() if trace.enabled() else None
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(*ptrs, c, A, int(n_sweeps), float(tol), stream, stalls)
    if rc != 0:
        msg = build().cp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({rc})")
    LAUNCHES_SPLIT += 1
    return out


def _checked(G, b, alphas_n, n_sweeps, stats, max_c: int) -> int:
    c = _check_inputs(G, b, alphas_n, n_sweeps)
    if c > max_c:
        raise ValueError(
            f"c={c} > {max_c}: K1 takes c <= {MAX_C}; K2 takes "
            f"c <= {MAX_C_STREAM}")
    _check_stats(stats, G, alphas_n.shape[0])
    return c


def cd_solve_grid(G: torch.Tensor, b: torch.Tensor, alphas_n: torch.Tensor,
                  n_sweeps: int = 200, tol: float = 1e-8,
                  stats: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the alpha grid: (A, c) betas. G (c, c) symmetric f32, b (c,),
    alphas_n (A,) thresholds in Gram units (alpha * n_samples). A CPU
    tensor takes the plain version; on the card c <= MAX_C launches K1 and
    MAX_C < c <= MAX_C_STREAM launches K2 (the JAX dispatch's threshold,
    ops/lasso._solve_grid). `stats`, an (A, 2) int32 tensor on G's device,
    receives each alpha's sweeps run and nonzero-delta steps."""
    global LAUNCHES
    if G.device.type == "cpu":
        return cd_solve_grid_plain(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol,
                                   stats=stats)
    if G.shape[0] > MAX_C:
        return cd_solve_grid_stream(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol,
                                    stats=stats)
    c = _checked(G, b, alphas_n, n_sweeps, stats, MAX_C)
    if alphas_n.shape[0] == 0:
        return torch.empty((0, c), dtype=torch.float32, device=G.device)
    out = _launch("cp_lasso_cd_grid", G, b, alphas_n, n_sweeps, tol, stats)
    LAUNCHES += 1
    return out


def cd_solve_grid_stream(G: torch.Tensor, b: torch.Tensor,
                         alphas_n: torch.Tensor, n_sweeps: int = 200,
                         tol: float = 1e-8,
                         stats: torch.Tensor | None = None) -> torch.Tensor:
    """K2 at any c <= MAX_C_STREAM. `cd_solve_grid` sends it only c > MAX_C;
    called directly it can be held against K1 at c <= MAX_C. A CPU tensor
    takes the plain version."""
    global LAUNCHES_STREAM
    if G.device.type == "cpu":
        return cd_solve_grid_plain(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol,
                                   stats=stats)
    c = _checked(G, b, alphas_n, n_sweeps, stats, MAX_C_STREAM)
    if alphas_n.shape[0] == 0:
        return torch.empty((0, c), dtype=torch.float32, device=G.device)
    out = _launch("cp_lasso_cd_grid_stream", G, b, alphas_n, n_sweeps, tol,
                  stats)
    LAUNCHES_STREAM += 1
    return out
