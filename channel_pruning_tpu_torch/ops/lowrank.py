"""Low-rank decompositions (port of channel_pruning_tpu/ops/lowrank.py):
spatial (VH) SVD with its data-driven ReLU-aware refit, ReLU-aware channel
decomposition (ITQ), and the nonlinear (ReLU-ALS) least-squares fit.

The math is the JAX package's, outside any kernel there too: host float64
SVDs and eigendecompositions in numpy (the same calls on the same inputs),
and torch matmuls, Cholesky and eigh on the device. Each layer runs at its
own shapes: the JAX package pads every layer to one bucket only so that XLA
compiles one program for the model, and torch compiles nothing. ITQ's
per-iteration rank-k truncation is the eigendecomposition of the (d x d)
projected Gram, as in the reference design, so no N-sized SVD runs in the
loop. SVD factors are sign- and rotation-ambiguous, so parity is held on
reconstructions, not on factors.

Every function here runs its matmuls in full f32: the caller selects the
device through `device.resolve_device`, which turns TF32 off (reduced
precision broke ITQ on a trained net, channel_pruning_tpu/ops/lstsq.py:18).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from channel_pruning_tpu_torch.ops import lstsq


def _f32(x, device=None) -> torch.Tensor:
    """numpy or torch -> f32 tensor (on `device` when given)."""
    t = torch.as_tensor(x)
    if device is not None:
        t = t.to(device)
    return t.float()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _lams(lambdas, iters, device):
    """(λ as an f32 device tensor, iteration count) per stage of the
    schedule: the tensors go up once, not once per iteration."""
    return [(torch.tensor(float(lam), dtype=torch.float32).to(device), n_it)
            for lam, n_it in zip(lambdas, iters)]


# ---------------------------------------------------------------------------
# nonlinear (ReLU-aware) linear fit
# ---------------------------------------------------------------------------

def nonlinear_fit(X, Y, lambdas: tuple[float, ...] = (0.1, 1.0),
                  iters: tuple[int, ...] = (30, 20)
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit relu(X W.T + b) ≈ relu(Y) by alternating least squares with the
    closed-form ReLU relaxation (decompose.py:671-685 schedule); one
    Cholesky factor of the design serves every refit. Returns W (n_out, d)
    and b (n_out,) on X's device."""
    X = _f32(X)
    Y = _f32(Y, X.device)
    f = lstsq.factor(X)
    Z = torch.clamp(Y, min=0.0)
    U = Y
    for lam, n_it in _lams(lambdas, iters, X.device):
        for _ in range(n_it):
            W, b = lstsq.solve(f, X, U)
            U = lstsq.solve_relu(X @ W.T + b, Z, lam)
    return lstsq.solve(f, X, U)


# ---------------------------------------------------------------------------
# spatial decomposition (VH)
# ---------------------------------------------------------------------------

class VHResult(NamedTuple):
    V: torch.Tensor              # (rank, c, kh, 1) vertical conv
    H: torch.Tensor              # (n, rank, 1, kw) horizontal conv
    VHr: torch.Tensor            # (n, c, kh, kw) rank-limited reconstruction
    b: torch.Tensor | None       # refit bias when data given
    feat: torch.Tensor | None = None   # (N, n) responses X ⊛ VHr + b (data)
    svd_seconds: float = 0.0     # the host f64 SVD


def vh_decompose(W, rank: int, X=None, Y=None,
                 lambdas: tuple[float, ...] = (0.1, 1.0),
                 iters: tuple[int, ...] = (30, 20)) -> VHResult:
    """Split a (n, c, kh, kw) conv into vertical (rank, c, kh, 1) and
    horizontal (n, rank, 1, kw) convs through the SVD of the (c*kh, n*kw)
    unfolding (decompose.py:85-147). With calibration data (X patches
    (N, c, kh, kw), Y responses (N, n), on the solve device) the horizontal
    factor and a bias are refit with the ReLU-aware ALS, and `feat` is the
    refit layer's response at the calibration points, which `c3.solve_3c`
    hands to ITQ. The data path is the JAX package's `_vh_refit_fused` (the
    one its CLI takes) at the layer's own shapes."""
    n, c, kh, kw = W.shape
    t0 = time.perf_counter()
    M = _host(W).astype(np.float64).transpose(1, 2, 0, 3).reshape(c * kh, n * kw)
    # host f64 SVD, as the reference pins scipy gesvd (decompose.py:155)
    U, s, Vt = np.linalg.svd(M, full_matrices=False)
    t_svd = time.perf_counter() - t0

    if X is not None:
        X = _f32(X)
        dev = X.device
        Uk = U[:, :rank].astype(np.float32)                     # (c*kh, rank)
        V = _f32(np.transpose(Uk.reshape(c, 1, kh, rank), (3, 0, 2, 1)), dev)
        N = X.shape[0]
        Xv = torch.einsum("nchp,rch->npr", X, V[..., 0])
        # layout (rank, kw) row-major per sample, matching H's (r, 1, kw) axes
        Xflat = Xv.permute(0, 2, 1).reshape(N, rank * kw)
        Wh, b = nonlinear_fit(Xflat, Y, lambdas, iters)
        feat = Xflat @ Wh.T + b
        H = Wh.reshape(n, rank, 1, kw)
        VHr = torch.einsum("rch,nrw->nchw", V[..., 0], H[:, :, 0, :])
        return VHResult(V=V, H=H, VHr=VHr, b=b, feat=feat, svd_seconds=t_svd)

    dev = W.device if isinstance(W, torch.Tensor) else None
    Uk = _f32(U, dev)[:, :rank]                                 # (c*kh, rank)
    Hk = _f32(s, dev)[:rank, None] * _f32(Vt, dev)[:rank]       # (rank, n*kw)
    V = Uk.reshape(c, 1, kh, rank).permute(3, 0, 2, 1)
    H = Hk.reshape(rank, n, kw, 1).permute(1, 0, 3, 2)
    VHr = (Uk @ Hk).reshape(c, kh, n, kw).permute(2, 0, 1, 3)
    return VHResult(V=V, H=H, VHr=VHr, b=None, svd_seconds=t_svd)


# ---------------------------------------------------------------------------
# ReLU-aware channel decomposition (ITQ)
# ---------------------------------------------------------------------------

class ITQResult(NamedTuple):
    W1: torch.Tensor     # folded producer weights: (rank,) + weight.shape[1:]
    W2: torch.Tensor     # new 1x1 conv: (d, rank, 1, 1)
    B: torch.Tensor      # bias (d,)
    W12: torch.Tensor    # merged low-rank producer (the running overwrite)
    feat2: torch.Tensor  # (N, d) factored responses (feature - bias)(LR) + B
    loop_seconds: float = 0.0   # the alternating loop, to its host read
    svd_seconds: float = 0.0    # the host f64 SVD of T


def _host_eigh(A) -> tuple[np.ndarray, np.ndarray]:
    """eigh on the host in f64 (the reference ran these in numpy), with
    eigenvalues clipped to the f32 range (diverging iterates)."""
    w, v = np.linalg.eigh(_host(A).astype(np.float64))
    f32max = np.finfo(np.float32).max
    w = np.clip(w, -f32max, f32max)
    return w.astype(np.float32), v.astype(np.float32)


def _pinv_psd(A, rcond: float = 1e-6) -> np.ndarray:
    """Pseudo-inverse of a PSD matrix through host eigh (scipy.linalg.pinv
    analogue, decompose.py:149-152)."""
    w, v = _host_eigh(A)
    cutoff = rcond * np.max(np.abs(w))
    inv_w = np.zeros_like(w)
    nz = w > cutoff
    inv_w[nz] = 1.0 / w[nz]
    return ((v * inv_w) @ v.T).astype(np.float32)


def _itq_moments(feature: torch.Tensor):
    Y_mean = feature.mean(dim=0)
    G = feature - Y_mean
    GtG = G.T @ G
    return Y_mean, G, 0.5 * (GtG + GtG.T)


def _itq_loop_device(G, GtG, PG, Z, Y_mean, rank: int, lambdas, iters):
    """The alternating schedule (decompose.py:204-247) as a host loop of
    device ops: (a) the rank-`rank` projection of the ridge solution,
    through the top-`rank` eigenvectors of the (d x d) projected Gram (a
    mask over eigh's ascending order), (b) the closed-form ReLU regression.
    The last finite (T, U_mean) is tracked on the device, so a diverging
    tail is salvaged as in the JAX package. A non-finite Gram goes to eigh
    as the identity (torch's eigh raises or returns garbage on it on CUDA).
    On CUDA each eigh waits for the card: one host sync an iteration."""
    d = G.shape[1]
    sel = (torch.arange(d, device=G.device) >= d - rank).to(G.dtype)
    eye = torch.eye(d, dtype=G.dtype, device=G.device)
    UU, U_mean = G, Y_mean
    T_good, Um_good = torch.zeros_like(GtG), Y_mean
    ok = torch.ones((), dtype=torch.bool, device=G.device)
    for lam, n_it in _lams(lambdas, iters, G.device):
        for _ in range(n_it):
            M = PG @ (G.T @ UU)
            XtX = M.T @ GtG @ M
            XtX = 0.5 * (XtX + XtX.T)
            finite_in = torch.isfinite(XtX).all()
            _, v = torch.linalg.eigh(torch.where(finite_in, XtX, eye))
            T = M @ ((v * sel) @ v.T)
            U = lstsq.solve_relu(G @ T + U_mean, Z, lam)
            U_mean2 = U.mean(dim=0)
            ok_now = (finite_in & torch.isfinite(T).all()
                      & torch.isfinite(U_mean2).all())
            T_good = torch.where(ok_now, T, T_good)
            Um_good = torch.where(ok_now, U_mean2, Um_good)
            ok = ok & ok_now
            UU, U_mean = U - U_mean2, U_mean2
    return T_good, Um_good, ok


def _itq_solve_T(feature, gt_feature, rank: int,
                 lambdas: tuple[float, ...], iters: tuple[int, ...]):
    """Core ITQ alternating solve. Returns (T, Y_mean, U_mean).

    feature: (N, d) current responses; gt_feature: (N, d) ground truth. The
    pinv of the (d x d) Gram runs on the host in f64 up front
    (decompose.py:149-152 pins scipy pinv(…, 1e-6)); the loop runs on the
    device. Raises np.linalg.LinAlgError when no iterate was finite."""
    feature = _f32(feature)
    Z = torch.clamp(_f32(gt_feature, feature.device), min=0.0)
    Y_mean, G, GtG = _itq_moments(feature)
    PG = _f32(_pinv_psd(GtG), feature.device)
    T, U_mean, all_ok = _itq_loop_device(G, GtG, PG, Z, Y_mean, rank,
                                         lambdas, iters)
    T_h, Um_h = _host(T), _host(U_mean)
    if not (np.isfinite(T_h).all() and np.isfinite(Um_h).all()) or \
            not np.abs(T_h).any():
        raise np.linalg.LinAlgError("ITQ ALS diverged with no finite iterate")
    if not bool(all_ok):
        print("[itq] ALS diverged mid-schedule; salvaged last finite iterate")
    return T, Y_mean, U_mean


def _itq_solve_T_host(feature, gt_feature, rank: int,
                      lambdas: tuple[float, ...], iters: tuple[int, ...]):
    """Host-stepped variant of `_itq_solve_T` (eigh per iteration on the
    host in f64): the numerical oracle of the device loop, for the tests.
    It stops at the first non-finite Gram and returns the last finite
    iterate it kept (every fifth)."""
    feature = _f32(feature)
    dev = feature.device
    Z = torch.clamp(_f32(gt_feature, dev), min=0.0)
    Y_mean, G, GtG = _itq_moments(feature)
    PG = _f32(_pinv_psd(GtG), dev)
    UU, U_mean = G, Y_mean
    T = None
    last_good = None                              # (T, Y_mean, U_mean)
    it_count = 0
    for lam, n_it in _lams(lambdas, iters, dev):
        for _ in range(n_it):
            M = PG @ (G.T @ UU)
            XtX = M.T @ GtG @ M
            XtX_h = _host(0.5 * (XtX + XtX.T))
            if not np.isfinite(XtX_h).all():
                if last_good is not None:
                    return last_good
                raise np.linalg.LinAlgError("ITQ ALS diverged at iteration "
                                            f"{it_count}")
            _, v = _host_eigh(XtX_h)
            Vk = _f32(v[:, -rank:], dev)          # top-k right singular vecs
            T = M @ Vk @ Vk.T
            U = lstsq.solve_relu(G @ T + U_mean, Z, lam)
            U_mean = U.mean(dim=0)
            UU = U - U_mean
            it_count += 1
            if it_count % 5 == 0 and np.isfinite(_host(U_mean)).all():
                last_good = (T, Y_mean, U_mean)
    return T, Y_mean, U_mean


def itq_decompose(feature, gt_feature, weight, rank: int, bias=None, Wr=None,
                  lambdas: tuple[float, ...] = (0.1, 1.0),
                  iters: tuple[int, ...] = (30, 20)) -> ITQResult:
    """ReLU-aware channel decomposition (decompose.py:163-319).

    feature (N, d): responses of the current (spatially decomposed) conv;
    gt_feature (N, d): ground-truth responses; weight: the H conv
    (d, r, 1, kw) that takes the left factor; Wr: the merged VHr weights
    (d, c, kh, kw) for the running overwrite (default: weight); bias: the
    producer's bias (default 0). Produces the rank-`rank` factorisation
    d -> rank (folded into H and Wr) and a 1x1 conv rank -> d with bias B,
    and the factored responses `feat2`, as the JAX package's
    `_itq_fold_fused` does. Tensors stay on feature's device."""
    feature = _f32(feature)
    dev = feature.device
    weight = _f32(weight, dev)
    d = feature.shape[1]
    assert weight.shape[0] == d, (weight.shape, d)
    t0 = time.perf_counter()
    T, Y_mean, U_mean = _itq_solve_T(feature, gt_feature, rank, lambdas, iters)
    t_loop = time.perf_counter() - t0

    # the factor split on the host in f64
    t0 = time.perf_counter()
    L64, s64, Rt64 = np.linalg.svd(_host(T).astype(np.float64),
                                   full_matrices=False)
    t_svd = time.perf_counter() - t0
    L = _f32(L64[:, :rank].astype(np.float32), dev)              # (d, rank)
    R = _f32((s64[:rank, None] * Rt64[:rank]).astype(np.float32), dev)
    Wr = weight if Wr is None else _f32(Wr, dev)
    bias = torch.zeros(d, dtype=torch.float32, device=dev) if bias is None \
        else _f32(bias, dev)

    Wt_w = weight.permute(1, 2, 3, 0).reshape(-1, d)
    W1 = (Wt_w @ L).reshape(weight.shape[1:] + (rank,)).permute(3, 0, 1, 2)
    LR = L @ R
    Wt_r = Wr.permute(1, 2, 3, 0).reshape(-1, d)
    W12 = (Wt_r @ LR).reshape(Wr.shape[1:] + (d,)).permute(3, 0, 1, 2)
    W2 = R.T.reshape(d, rank, 1, 1)
    # the producer's bias enters the factored response through T: chain
    # output (feature - b) @ T + B reproduces feature @ T + U_mean - Y_mean @ T
    B = -Y_mean @ T + U_mean + bias @ T
    feat2 = (feature - bias) @ LR + B
    return ITQResult(W1=W1, W2=W2, B=B, W12=W12, feat2=feat2,
                     loop_seconds=t_loop, svd_seconds=t_svd)
