"""LASSO coordinate descent over an alpha grid: the CUDA kernel and its plain
PyTorch version.

Replaces channel_pruning_tpu/kernels/lasso_cd.py::cd_solve_grid_pallas.
The kernel (csrc/lasso_cd.cu, one block per alpha) is built with nvcc for
sm_90a on first use into `_build/` and bound through ctypes. `cd_solve_grid`
launches it for CUDA tensors and takes the plain version only for tensors on
the CPU; a failed build or launch raises. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

MAX_C = 1024          # shared memory holds 4·c floats; larger c is K2's job
LAUNCHES = 0

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


def build() -> ctypes.CDLL:
    """Compile csrc/lasso_cd.cu (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"liblasso_cd_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)       # atomic: a concurrent build never sees half
    lib = ctypes.CDLL(str(so))
    lib.cp_lasso_cd_grid.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.cp_lasso_cd_grid.restype = ctypes.c_int
    lib.cp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cp_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def cd_solve_grid(G: torch.Tensor, b: torch.Tensor, alphas_n: torch.Tensor,
                  n_sweeps: int = 200, tol: float = 1e-8) -> torch.Tensor:
    """Solve the alpha grid: (A, c) betas. G (c, c) symmetric f32, b (c,),
    alphas_n (A,) thresholds in Gram units (alpha * n_samples)."""
    global LAUNCHES
    if G.device.type == "cpu":
        return cd_solve_grid_plain(G, b, alphas_n, n_sweeps=n_sweeps, tol=tol)
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
    if not 1 <= c <= MAX_C:
        raise NotImplementedError(
            f"c={c}: the shared-memory CD kernel takes c <= {MAX_C}; larger "
            "problems need the HBM-streaming kernel (K2, "
            "cd_solve_grid_pallas_hbm), not ported yet")
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    A = alphas_n.shape[0]
    out = torch.empty((A, c), dtype=torch.float32, device=G.device)
    if A == 0:
        return out
    lib = build()
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.cp_lasso_cd_grid(G.data_ptr(), b.data_ptr(),
                                  alphas_n.data_ptr(), out.data_ptr(), c, A,
                                  int(n_sweeps), float(tol), stream)
    if rc != 0:
        msg = lib.cp_cuda_error_string(rc).decode()
        raise RuntimeError(f"lasso_cd launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out
