"""Group-lasso block coordinate descent over an alpha grid: the CUDA kernel
K3 and its plain PyTorch version.

K3 (csrc/group_cd.cu) computes what the JAX package leaves to XLA in
channel_pruning_tpu/ops/lasso.py `group_cd_solve_grid` (`group_cd_solve`
vmapped over the alphas): the row-sparse group lasso
  min_B 1/(2N) ||Y - X B||_F^2 + alpha * sum_j ||B_j||_2
from G = XᵀX and C = XᵀY, one thread-block cluster of K blocks per alpha
(block r owns rows r, r + K, ...), each alpha stopping on its own.
`plan_launch` chooses K and the variant (Q in registers beside slices in
shared memory, or all in device memory) from the shape and the card's
limits.
`group_cd_solve_grid_plain` is its plain version, in the same row order
and order of f32 operations, the block reduction of a row's squares
included (`_block_sum`), so the two agree bit for bit. The source is built
with nvcc for sm_90a at first use into `_build/` (the path of
kernels/lasso_cd) and bound through ctypes. `group_cd_solve_grid` launches
K3 for CUDA tensors and takes the plain version only for tensors on the
CPU; a failed build or launch raises. `LAUNCHES` counts K3's launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from channel_pruning_tpu_torch.kernels import lasso_cd

MAX_N = 19328         # three rows live in shared memory (~226 KB)
THREADS = 1024        # K3's block
SMEM_LIMIT = 232448   # shared memory a block may use on an H100
STATIC_SMEM = 512     # K3's static shared memory at most (the kernel checks)
MAX_K = 8             # blocks a cluster, portable
MAX_K_ONE_ALPHA = 16  # non-portable, for a single alpha
REG_ROWS = 12         # smem variant: Q's rows a thread holds in registers
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


@dataclass(frozen=True)
class LaunchPlan:
    """How K3 runs one grid: `k` blocks a cluster, one cluster an alpha;
    block r owns rows block_rows(c, k, r), at most `rows`; `variant` "smem"
    keeps the block's slices of G, C and B in shared memory and its rows
    of Q in registers, "global" keeps them in device memory but for the
    first rows of Q, in the spare shared memory; `smem_bytes` of dynamic
    shared memory a block; `active_clusters` clusters resident at once,
    `waves` = ceil(A / active_clusters)."""
    k: int
    rows: int
    variant: str
    smem_bytes: int
    active_clusters: int
    waves: int


def block_rows(c: int, k: int, r: int) -> range:
    """The rows block r of k owns: r, r + k, ... (so consecutive rows have
    different owners)."""
    return range(r, c, k)


def smem_bytes(variant: str, c: int, n: int, rows: int,
               smem_limit: int = SMEM_LIMIT) -> int:
    """Dynamic shared memory of a block of `rows` rows: two slots for the
    deltas pushed by the rows' owners and the row being solved; in the
    smem variant the slices of G's columns (c x rows) and of C and B
    (rows x n each); in the global variant as many of the block's rows of
    Q as the rest of `smem_limit` holds."""
    floats = 3 * n
    if variant == "smem":
        floats += rows * (c + 2 * n)
    else:
        spare = (smem_limit - STATIC_SMEM) // 4 - floats
        floats += min(rows, max(0, spare // n)) * n
    return 4 * floats


def registers_hold(n: int, rows: int) -> bool:
    """Whether a block's rows of Q fit the smem variant's registers: n <=
    1024 columns, 1024 // n threads a column, at most REG_ROWS rows a
    thread."""
    return n <= THREADS and -(-rows // (THREADS // n)) <= REG_ROWS


def plan_launch(c: int, n: int, n_alpha: int,
                max_active: Callable[[str, int, int], int],
                smem_limit: int = SMEM_LIMIT) -> LaunchPlan:
    """K3's launch for (c, n) and n_alpha alphas. `max_active(variant, k,
    smem_bytes)` is the number of such clusters the card holds at once
    (cudaOccupancyMaxActiveClusters). For each k (2 to 8, to 16 for one
    alpha; at most c; 1 when c is 1) the variant is "smem" where Q's rows
    fit the registers and the slices the shared memory, else "global".
    The plan takes the largest k whose clusters all fit in one wave, else
    the one with the fewest waves per block (ties: the larger k). Raises
    ValueError for what the kernel cannot take."""
    if c < 1 or not 1 <= n <= MAX_N or n_alpha < 1:
        raise ValueError(f"(c, n, A) = ({c}, {n}, {n_alpha}): K3 takes "
                         f"c >= 1, 1 <= n <= {MAX_N} and A >= 1")
    k_max = min(c, MAX_K_ONE_ALPHA if n_alpha == 1 else MAX_K)
    options = []
    for k in range(min(2, k_max), k_max + 1):
        rows = len(block_rows(c, k, 0))
        variant = "smem"
        nbytes = smem_bytes(variant, c, n, rows)
        if not registers_hold(n, rows) or nbytes + STATIC_SMEM > smem_limit:
            variant = "global"
            nbytes = smem_bytes(variant, c, n, rows, smem_limit)
        if nbytes + STATIC_SMEM > smem_limit:
            continue
        active = max_active(variant, k, nbytes)
        if active >= 1:
            options.append(LaunchPlan(k, rows, variant, nbytes, active,
                                      -(-n_alpha // active)))
    if not options:
        raise ValueError(f"(c, n, A) = ({c}, {n}, {n_alpha}): no cluster "
                         "of K3 fits on this card")
    one_wave = [p for p in options if p.waves == 1]
    if one_wave:
        return max(one_wave, key=lambda p: p.k)
    return min(options, key=lambda p: (p.waves / p.k, -p.k))


def build() -> ctypes.CDLL:
    """Compile csrc/group_cd.cu (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = lasso_cd.compile_source(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cp_group_cd_grid.argtypes = [ptr] * 6 + [i32] * 4 + [
        ctypes.c_float, i32, i32, i32, ptr]
    lib.cp_group_cd_grid.restype = ctypes.c_int
    lib.cp_group_cd_max_active_clusters.argtypes = [i32, i32, i32, ptr]
    lib.cp_group_cd_max_active_clusters.restype = ctypes.c_int
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
                         f"1 <= n <= {MAX_N} (two rows in shared memory)")
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    A = alphas_n.shape[0]
    if stats is not None and (stats.device != G.device
                              or stats.dtype != torch.int32
                              or tuple(stats.shape) != (A, 2)
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous ({A}, 2) int32 tensor "
                         f"on {G.device}")


_ACTIVE: dict[tuple, int] = {}


def _max_active(device: torch.device, variant: str, k: int,
                nbytes: int) -> int:
    """cudaOccupancyMaxActiveClusters for K3's variant on `device`,
    queried once per (device, variant, k, bytes)."""
    key = (device.index, variant, k, nbytes)
    if key not in _ACTIVE:
        lib = build()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.cp_group_cd_max_active_clusters(
                int(variant == "smem"), k, nbytes, ctypes.byref(out))
        if rc != 0:
            msg = lib.cp_group_cd_error_string(rc).decode()
            raise RuntimeError(f"cp_group_cd_max_active_clusters failed: "
                               f"{msg} ({rc})")
        _ACTIVE[key] = out.value
    return _ACTIVE[key]


def launch_plan(c: int, n: int, n_alpha: int,
                device: torch.device) -> LaunchPlan:
    """`plan_launch` with the limits of the card `device`."""
    return plan_launch(c, n, n_alpha,
                       lambda v, k, b: _max_active(device, v, k, b))


def group_cd_solve_grid(G: torch.Tensor, C: torch.Tensor,
                        alphas_n: torch.Tensor, n_sweeps: int = 200,
                        tol: float = 1e-8,
                        stats: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the alpha grid: (A, c, n) B. G (c, c) symmetric f32, C (c, n),
    alphas_n (A,) thresholds in Gram units (alpha * n_samples). A CPU
    tensor takes the plain version; a CUDA tensor launches K3 on the
    current stream as `launch_plan` says, with no host read. `stats`, an
    (A, 2) int32 tensor on G's device, receives each alpha's sweeps and
    moving rows."""
    global LAUNCHES
    if G.device.type == "cpu":
        return group_cd_solve_grid_plain(G, C, alphas_n, n_sweeps=n_sweeps,
                                         tol=tol, stats=stats)
    _check_inputs(G, C, alphas_n, n_sweeps, stats)
    c, n = C.shape
    A = alphas_n.shape[0]
    if A == 0:
        return torch.empty((0, c, n), dtype=torch.float32, device=G.device)
    plan = launch_plan(c, n, A, G.device)
    B = torch.empty((A, c, n), dtype=torch.float32, device=G.device)
    Q = torch.empty_like(B) if plan.variant == "global" else None
    lib = build()
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.cp_group_cd_grid(
            G.data_ptr(), C.data_ptr(), alphas_n.data_ptr(), B.data_ptr(),
            Q.data_ptr() if Q is not None else None,
            stats.data_ptr() if stats is not None else None,
            c, n, A, int(n_sweeps), float(tol), int(plan.variant == "smem"),
            plan.k, plan.smem_bytes, stream)
    if rc != 0:
        msg = lib.cp_group_cd_error_string(rc).decode()
        raise RuntimeError(f"cp_group_cd_grid launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return B
