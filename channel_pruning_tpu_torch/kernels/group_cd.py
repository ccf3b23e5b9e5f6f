"""Group-lasso block coordinate descent over an alpha grid: the CUDA kernel
K3 and its plain PyTorch version.

K3 (csrc/group_cd.cu) computes what the JAX package leaves to XLA in
channel_pruning_tpu/ops/lasso.py `group_cd_solve_grid` (`group_cd_solve`
vmapped over the alphas): the row-sparse group lasso
  min_B 1/(2N) ||Y - X B||_F^2 + alpha * sum_j ||B_j||_2
from G = XᵀX and C = XᵀY, one block per alpha, each alpha stopping on its
own. `group_cd_solve_grid_plain` is its plain version, in the same row order
and order of f32 operations, the block reduction of a row's squares
included (`_block_sum`), so the two agree bit for bit. The source is built with nvcc
for sm_90a at first use into `_build/` (the path of kernels/lasso_cd) and
bound through ctypes. `group_cd_solve_grid` launches K3 for CUDA tensors
and takes the plain version only for tensors on the CPU; a failed build or
launch raises. `LAUNCHES` counts K3's launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from channel_pruning_tpu_torch.kernels import lasso_cd

MAX_N = 32768         # a row of R lives in shared memory (128 KB)
THREADS = 1024        # K3's block
LAUNCHES = 0

SOURCE = lasso_cd._PKG / "csrc" / "group_cd.cu"
_lib: ctypes.CDLL | None = None


def _tree_sum(v: torch.Tensor) -> torch.Tensor:
    """v (..., P), P a power of two, summed over its last axis as the
    butterfly of `__shfl_xor_sync` does (offsets P/2 to 1: slot s adds slot
    s + off, and lane l ^ off holds the same sum, a + b being b + a)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _pow2(k: int) -> int:
    return 1 << (k - 1).bit_length()


def _block_sum(sq: torch.Tensor) -> torch.Tensor:
    """(A,) sums of the rows of sq (A, n) in K3's order: thread t adds
    elements t, t + 1024, ... in turn, each warp reduces its 32 threads'
    sums, and warp 0 the 32 warps'. Slots past n hold zeros, and x + 0 ==
    x, so only the smallest power of two of lanes (and of warps) that
    holds them is reduced. Summed in another order, the dense alphas of a
    rank-deficient Gram (more channels than rows), which do not converge
    in 200 sweeps, drift along another path: ~1e-3 of max|B| apart at
    (c, n) = (256, 256) over 250 rows."""
    A, n = sq.shape
    if n <= 32:
        return _tree_sum(F.pad(sq, (0, _pow2(n) - n)))
    m = -(-n // THREADS)
    parts = F.pad(sq, (0, m * THREADS - n)).view(A, m, THREADS)
    acc = parts[:, 0]
    for i in range(1, m):
        acc = acc + parts[:, i]
    warps = _pow2(min(32, -(-n // 32)))
    return _tree_sum(_tree_sum(acc.view(A, 32, 32)[:, :warps]))


def group_cd_solve_grid_plain(G: torch.Tensor, C: torch.Tensor,
                              alphas_n: torch.Tensor, n_sweeps: int = 200,
                              tol: float = 1e-8,
                              stats: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """(A, c, n) B for each alpha; each alpha stops on its own, as the JAX
    package's vmapped `group_cd_solve` does. Vectorised over alphas with an
    `active` mask. `stats`, an (A, 2) int32 tensor, receives each alpha's
    sweeps run and row updates with a nonzero delta, as K3 writes them."""
    c, n = C.shape
    A = alphas_n.shape[0]
    dev, dt = G.device, G.dtype
    sweeps = torch.zeros(A, dtype=torch.int32, device=dev)
    moves = torch.zeros_like(sweeps)
    diag = torch.diagonal(G)
    safe_diag = torch.where(diag > 0, diag, torch.ones_like(diag))
    B = torch.zeros((A, c, n), dtype=dt, device=dev)
    Q = torch.zeros_like(B)
    active = torch.ones(A, dtype=torch.bool, device=dev)
    alphas_col = alphas_n.to(dt)
    it = 0
    while it < n_sweeps and bool(active.any()):
        sweeps += active
        max_delta = torch.zeros(A, dtype=dt, device=dev)
        for j in range(c):
            Bj_old = B[:, j]
            Rj = (C[j] - Q[:, j]) + diag[j] * Bj_old
            norm = torch.sqrt(_block_sum(Rj * Rj) + 1e-30)
            scale = torch.clamp(1.0 - alphas_col / norm, min=0.0) / safe_diag[j]
            Bj = torch.where(diag[j] > 0, scale[:, None] * Rj,
                             torch.zeros_like(Rj))
            Bj = torch.where(active[:, None], Bj, Bj_old)
            delta = Bj - Bj_old
            Q = Q + G[:, j][None, :, None] * delta[:, None, :]
            B[:, j] = Bj
            max_delta = torch.maximum(max_delta, delta.abs().amax(dim=-1))
            if stats is not None:
                moves += (delta != 0).any(dim=-1)
        it += 1
        scale = torch.clamp(B.abs().amax(dim=(1, 2)), min=1e-12)
        active = active & (max_delta > tol * scale)
    if stats is not None:
        stats.copy_(torch.stack([sweeps, moves], dim=1))
    return B


def build() -> ctypes.CDLL:
    """Compile csrc/group_cd.cu (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = lasso_cd.compile_source(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cp_group_cd_grid.argtypes = [ptr] * 6 + [i32] * 4 + [ctypes.c_float,
                                                             ptr]
    lib.cp_group_cd_grid.restype = ctypes.c_int
    lib.cp_group_cd_error_string.argtypes = [ctypes.c_int]
    lib.cp_group_cd_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_inputs(G: torch.Tensor, C: torch.Tensor, alphas_n: torch.Tensor,
                  n_sweeps: int, stats: torch.Tensor | None) -> None:
    """Device, dtype, shape and contiguity checks for a launch."""
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    if C.dim() != 2:
        raise ValueError(f"C must be (c, n), got shape {tuple(C.shape)}")
    c, n = C.shape
    for name, t, shape in (("G", G, (c, c)), ("C", C, (c, n)),
                           ("alphas_n", alphas_n, (alphas_n.shape[0],))):
        if t.device != G.device:
            raise ValueError(f"{name} on {t.device}, G on {G.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c < 1 or not 1 <= n <= MAX_N:
        raise ValueError(f"(c, n) = ({c}, {n}): K3 takes c >= 1 and "
                         f"1 <= n <= {MAX_N} (a row in shared memory)")
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    A = alphas_n.shape[0]
    if stats is not None and (stats.device != G.device
                              or stats.dtype != torch.int32
                              or tuple(stats.shape) != (A, 2)
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous ({A}, 2) int32 tensor "
                         f"on {G.device}")


def group_cd_solve_grid(G: torch.Tensor, C: torch.Tensor,
                        alphas_n: torch.Tensor, n_sweeps: int = 200,
                        tol: float = 1e-8,
                        stats: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the alpha grid: (A, c, n) B. G (c, c) symmetric f32, C (c, n),
    alphas_n (A,) thresholds in Gram units (alpha * n_samples). A CPU
    tensor takes the plain version; a CUDA tensor launches K3 on the
    current stream, with no host read. `stats`, an (A, 2) int32 tensor on
    G's device, receives each alpha's sweeps and moving rows."""
    global LAUNCHES
    if G.device.type == "cpu":
        return group_cd_solve_grid_plain(G, C, alphas_n, n_sweeps=n_sweeps,
                                         tol=tol, stats=stats)
    _check_inputs(G, C, alphas_n, n_sweeps, stats)
    c, n = C.shape
    A = alphas_n.shape[0]
    if A == 0:
        return torch.empty((0, c, n), dtype=torch.float32, device=G.device)
    B = torch.empty((A, c, n), dtype=torch.float32, device=G.device)
    Q = torch.empty_like(B)
    lib = build()
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.cp_group_cd_grid(
            G.data_ptr(), C.data_ptr(), alphas_n.data_ptr(), B.data_ptr(),
            Q.data_ptr(), stats.data_ptr() if stats is not None else None,
            c, n, A, int(n_sweeps), float(tol), stream)
    if rc != 0:
        msg = lib.cp_group_cd_error_string(rc).decode()
        raise RuntimeError(f"cp_group_cd_grid launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return B
