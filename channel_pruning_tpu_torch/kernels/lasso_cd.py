"""LASSO coordinate descent over an alpha grid: the CUDA kernels and their
plain PyTorch version.

Two kernels in csrc/lasso_cd.cu, one block per alpha, with one contract:

* K1 replaces channel_pruning_tpu/kernels/lasso_cd.py::cd_solve_grid_pallas
  (c <= MAX_C; G read from global memory, state in shared memory);
* K2 replaces ...::cd_solve_grid_pallas_hbm (MAX_C < c <= MAX_C_STREAM;
  G's rows streamed into double-buffered shared memory with cp.async).

Their contract is the same, so `cd_solve_grid_plain` is the plain version of
both, and both match it bit for bit. The source is built with nvcc for
sm_90a on first use into `_build/` and bound through ctypes.
`cd_solve_grid` launches K1 or K2 for CUDA tensors and takes the plain
version only for tensors on the CPU; a failed build or launch raises.
`LAUNCHES` counts K1's launches and `LAUNCHES_STREAM` K2's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

MAX_C = 1024          # K1 (the JAX dispatch's threshold); larger c is K2's
MAX_C_STREAM = 8192   # K2 keeps 6·c floats in shared memory: 192 KB of 227 KB
LAUNCHES = 0
LAUNCHES_STREAM = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lasso_cd.cu"
BUILD_DIR = _PKG / "_build"
_lib: ctypes.CDLL | None = None


def cd_solve_grid_plain(G: torch.Tensor, b: torch.Tensor,
                        alphas_n: torch.Tensor, n_sweeps: int = 200,
                        tol: float = 1e-8) -> torch.Tensor:
    """(A, c) betas; each alpha stops on its own, as ops/lasso.cd_solve in
    the JAX package does. Vectorised over alphas with an `active` mask."""
    c, A = G.shape[0], alphas_n.shape[0]
    diag = torch.diagonal(G)
    safe_diag = torch.where(diag > 0, diag, torch.ones_like(diag))
    beta = torch.zeros((A, c), dtype=G.dtype, device=G.device)
    q = torch.zeros_like(beta)
    zero = torch.zeros(A, dtype=G.dtype, device=G.device)
    active = torch.ones(A, dtype=torch.bool, device=G.device)
    it = 0
    while it < n_sweeps and bool(active.any()):
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
        it += 1
        scale = torch.clamp(beta.abs().amax(dim=1), min=1e-12)
        active = active & (max_delta > tol * scale)
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


def _so_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblasso_cd_{digest}.so"


def ptxas_report() -> str:
    """ptxas's registers, shared memory and spills for each kernel, from
    the build of the current source ("" before it is built here)."""
    path = _so_path().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build() -> ctypes.CDLL:
    """Compile csrc/lasso_cd.cu, both kernels (once per source hash), and
    load it."""
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        # ptxas's registers / shared memory / spills for each kernel
        so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)       # atomic: a concurrent build never sees half
    lib = ctypes.CDLL(str(so))
    for fn in (lib.cp_lasso_cd_grid, lib.cp_lasso_cd_grid_stream):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cp_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


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


def _launch(entry: str, G: torch.Tensor, b: torch.Tensor,
            alphas_n: torch.Tensor, n_sweeps: int, tol: float) -> torch.Tensor:
    """Launch one of the C entry points on the current stream; raises if the
    launch is refused."""
    c, A = G.shape[0], alphas_n.shape[0]
    out = torch.empty((A, c), dtype=torch.float32, device=G.device)
    fn = getattr(build(), entry)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), b.data_ptr(), alphas_n.data_ptr(),
                out.data_ptr(), c, A, int(n_sweeps), float(tol), stream)
    if rc != 0:
        msg = build().cp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({rc})")
    return out


def cd_solve_grid(G: torch.Tensor, b: torch.Tensor, alphas_n: torch.Tensor,
                  n_sweeps: int = 200, tol: float = 1e-8) -> torch.Tensor:
    """Solve the alpha grid: (A, c) betas. G (c, c) symmetric f32, b (c,),
    alphas_n (A,) thresholds in Gram units (alpha * n_samples). A CPU
    tensor takes the plain version; on the card c <= MAX_C launches K1 and
    MAX_C < c <= MAX_C_STREAM launches K2 (the JAX dispatch's threshold,
    ops/lasso._solve_grid)."""
    global LAUNCHES
    if G.device.type == "cpu":
        return cd_solve_grid_plain(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol)
    if G.shape[0] > MAX_C:
        return cd_solve_grid_stream(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol)
    c = _check_inputs(G, b, alphas_n, n_sweeps)
    if alphas_n.shape[0] == 0:
        return torch.empty((0, c), dtype=torch.float32, device=G.device)
    out = _launch("cp_lasso_cd_grid", G, b, alphas_n, n_sweeps, tol)
    LAUNCHES += 1
    return out


def cd_solve_grid_stream(G: torch.Tensor, b: torch.Tensor,
                         alphas_n: torch.Tensor, n_sweeps: int = 200,
                         tol: float = 1e-8) -> torch.Tensor:
    """K2 at any c <= MAX_C_STREAM. `cd_solve_grid` sends it only c > MAX_C;
    called directly it can be held against K1 at c <= MAX_C. A CPU tensor
    takes the plain version."""
    global LAUNCHES_STREAM
    if G.device.type == "cpu":
        return cd_solve_grid_plain(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol)
    c = _check_inputs(G, b, alphas_n, n_sweeps)
    if c > MAX_C_STREAM:
        raise ValueError(
            f"c={c}: the streaming CD kernel keeps 6·c floats in shared "
            f"memory ({24 * c} bytes), so it takes c <= {MAX_C_STREAM} "
            "(227 KB a block on Hopper)")
    if alphas_n.shape[0] == 0:
        return torch.empty((0, c), dtype=torch.float32, device=G.device)
    out = _launch("cp_lasso_cd_grid_stream", G, b, alphas_n, n_sweeps, tol)
    LAUNCHES_STREAM += 1
    return out
