"""The plain reference: a Caffe-semantics forward pass in plain torch over a
plain layer list, the ground-truth sampling it implies, and the
least-squares optimum a refit is judged against.

It imports torch and numpy only: nothing of the program under test and
nothing of JAX. Every conv and inner product runs in f32 with TF32 off;
`round_operands` (an f32 -> f32 rounding of each conv's and inner
product's two operands) emulates a lower precision for the controls.

Layer lists are dicts {name, type, bottoms, tops, attrs} with Caffe's
type strings and attribute names. A tensor is captured where it is
produced, before an in-place successor overwrites its name.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def layer(name: str, type_: str, bottoms: Sequence[str], tops: Sequence[str]
          | None = None, **attrs) -> dict:
    return {"name": name, "type": type_, "bottoms": list(bottoms),
            "tops": list(tops if tops is not None else [name]), "attrs": attrs}


def _geometry(a: dict) -> tuple:
    kh = int(a.get("kernel_h", a.get("kernel_size", 1)))
    kw = int(a.get("kernel_w", a.get("kernel_size", 1)))
    sh = int(a.get("stride_h", a.get("stride", 1)))
    sw = int(a.get("stride_w", a.get("stride", 1)))
    ph = int(a.get("pad_h", a.get("pad", 0)))
    pw = int(a.get("pad_w", a.get("pad", 0)))
    return kh, kw, sh, sw, ph, pw, int(a.get("group", 1))


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2)) if ndim > 2 else v


def _pool(x: torch.Tensor, a: dict) -> torch.Tensor:
    """Caffe pooling: ceil-mode windows, a last window that would start in
    the padding dropped, max over the window, or the mean over the window's
    part inside the image."""
    if a.get("global_pooling", False):
        return x.mean(dim=(2, 3), keepdim=True)
    k, s, p = int(a["kernel_size"]), int(a.get("stride", 1)), int(a.get("pad", 0))
    h, w = x.shape[2], x.shape[3]

    def out(n):
        if not a.get("ceil_mode", True):
            return (n + 2 * p - k) // s + 1
        o = -(-(n + 2 * p - k) // s) + 1
        return o - 1 if p > 0 and (o - 1) * s >= n + p else o

    oh, ow = out(h), out(w)
    # pad left/top by p and right/bottom as far as the last window reaches
    pad = (p, max(0, (ow - 1) * s + k - w - p), p, max(0, (oh - 1) * s + k - h - p))
    if a.get("pool", "max") == "max":
        return F.max_pool2d(F.pad(x, pad, value=float("-inf")), k, s)
    total = F.avg_pool2d(F.pad(x, pad), k, s, divisor_override=1)
    inside = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pad), k, s,
                          divisor_override=1)
    return total / inside


def _compute(l: dict, env: dict, params: Mapping, rnd) -> torch.Tensor | None:
    t, a = l["type"], l["attrs"]
    x = env[l["bottoms"][0]] if l["bottoms"] else None
    p = params.get(l["name"], {})
    if t == "Convolution":
        kh, kw, sh, sw, ph, pw, g = _geometry(a)
        W = p["W"]
        out = F.conv2d(rnd(x), rnd(W), None, stride=(sh, sw), padding=(ph, pw),
                       groups=g)
        if a.get("bias", True) and "b" in p:
            out = out + _per_channel(p["b"], 4)
        return out
    if t == "InnerProduct":
        return rnd(x.reshape(x.shape[0], -1)) @ rnd(p["W"]).T + p["b"]
    if t == "ReLU":
        return torch.relu(x)
    if t == "Pooling":
        return _pool(x, a)
    if t == "Eltwise":
        if a.get("operation", "sum") != "sum":
            raise NotImplementedError(a.get("operation"))
        coeff = a.get("coeff") or [1.0] * len(l["bottoms"])
        out = env[l["bottoms"][0]] * coeff[0]
        for b, c in zip(l["bottoms"][1:], coeff[1:]):
            out = out + env[b] * c
        return out
    if t == "BatchNorm":
        f = float(p["factor"]) if "factor" in p else 1.0
        inv = 1.0 if f == 0 else 1.0 / f
        mean, var = p["mean"] * inv, p["var"] * inv
        eps = float(a.get("eps", 1e-5))
        return (x - _per_channel(mean, x.ndim)) / torch.sqrt(
            _per_channel(var, x.ndim) + eps)
    if t == "Scale":
        out = x * _per_channel(p["W"], x.ndim)
        return out + _per_channel(p["b"], x.ndim) if "b" in p else out
    if t == "Select":
        idx = a.get("indices")
        if idx is None or a.get("passthrough", False):
            return x
        return x.index_select(1, torch.as_tensor(idx, dtype=torch.long,
                                                 device=x.device))
    if t in ("Dropout", "Flatten"):
        return x if t == "Dropout" else x.reshape(x.shape[0], -1)
    if t == "Softmax":
        return torch.softmax(x, dim=1)
    if t in ("Input", "Data"):
        return None
    raise NotImplementedError(t)


def run(layers: list[dict], params: Mapping, x: torch.Tensor,
        taps: Mapping[str, Callable[[torch.Tensor], object]],
        input_name: str = "data",
        round_operands: Callable[[torch.Tensor], torch.Tensor] | None = None
        ) -> dict[str, object]:
    """Run the net on `x` and return {tensor: taps[tensor](value)} for every
    tapped tensor, taken where it is produced. Layers after the last one
    that a tap needs are not run; maps are freed after their last use."""
    rnd = round_operands or (lambda v: v)
    want = set(taps)
    needed: set[str] = set()
    for l in reversed(layers):
        if want & set(l["tops"]):
            needed.add(l["name"])
            want |= set(l["bottoms"])
    order = [l for l in layers if l["name"] in needed]
    last_use = {b: i for i, l in enumerate(order) for b in l["bottoms"]}
    env = {input_name: x}
    out: dict[str, object] = {}
    with torch.no_grad():
        for i, l in enumerate(order):
            v = _compute(l, env, params, rnd)
            if v is None:
                continue
            for top in l["tops"]:
                env[top] = v
                if top in taps and top not in out:
                    out[top] = taps[top](v)
            for b in l["bottoms"]:
                if last_use.get(b) == i and b not in l["tops"]:
                    env.pop(b, None)
    missing = set(taps) - set(out)
    if missing:
        raise KeyError(f"tensors never produced: {sorted(missing)}")
    return out


# ---------------------------------------------------------------------------
# rounding to a lower precision (the controls)
# ---------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 explicit significand bits (to
    nearest, ties away from zero), kept in f32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 values scaled so the largest magnitude is float8_e4m3's largest
    finite value, rounded to float8_e4m3, and scaled back to f32."""
    amax = x.abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x.clone()
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bfloat16 (to nearest even), kept in f32."""
    return x.to(torch.bfloat16).float()


ROUNDINGS = {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}


# ---------------------------------------------------------------------------
# sampled points, the plan and gathers
# ---------------------------------------------------------------------------

def point_plan(shapes: Mapping[str, tuple], tensors: Sequence[str],
               n_batches: int, n_points: int, seed: int,
               share_key: Callable[[str], str] | None = None
               ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Per-(batch, tensor) sample coordinates {tensor: (ys, xs)}, int32
    (n_batches, n_points), drawn with numpy's default_rng(seed) in tensor
    order, rows then columns; tensors with the same share key share their
    points; a 2-D tensor gets no points (one dense row per image)."""
    rng = np.random.default_rng(seed)
    drawn: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    plan = {}
    for t in tensors:
        shp = shapes[t]
        if len(shp) != 4:
            plan[t] = (np.zeros((n_batches, 0), np.int32),) * 2
            continue
        key = share_key(t) if share_key else t
        if key not in drawn:
            drawn[key] = (
                rng.integers(0, shp[2], (n_batches, n_points)).astype(np.int32),
                rng.integers(0, shp[3], (n_batches, n_points)).astype(np.int32))
        plan[t] = drawn[key]
    return plan


def sampled_tensors(layers: list[dict], include_fc: bool) -> tuple[str, ...]:
    """The tensors the ground truth samples, in plan order: every conv's top;
    then each Eltwise's top and bottoms; then InnerProduct tops if asked."""
    names = [l["tops"][0] for l in layers if l["type"] == "Convolution"]
    for l in layers:
        if l["type"] == "Eltwise":
            names.append(l["tops"][0])
            names.extend(l["bottoms"])
    if include_fc:
        names.extend(l["tops"][0] for l in layers if l["type"] == "InnerProduct")
    seen: set = set()
    return tuple(t for t in names if not (t in seen or seen.add(t)))


def junction_key(layers: list[dict]) -> Callable[[str], str]:
    """Each Eltwise's top and bottoms share the junction's points."""
    groups = {}
    for l in layers:
        if l["type"] == "Eltwise":
            for b in l["bottoms"]:
                groups[b] = l["tops"][0]
            groups[l["tops"][0]] = l["tops"][0]
    return lambda t: groups.get(t, t)


def gather_points(v: torch.Tensor, ys: np.ndarray, xs: np.ndarray,
                  bs: int) -> torch.Tensor:
    """v: (G*bs, C, H, W) of G batches; ys/xs: (G, P). Rows of each batch
    point-major (row = p*bs + b), batches in order -> (G*P*bs, C). A 2-D v
    (G*bs, D) is returned as it is."""
    if v.dim() != 4 or ys.shape[1] == 0:
        return v.reshape(v.shape[0], -1)
    rows = []
    for g in range(ys.shape[0]):
        yi = torch.as_tensor(ys[g], dtype=torch.long, device=v.device)
        xi = torch.as_tensor(xs[g], dtype=torch.long, device=v.device)
        sub = v[g * bs:(g + 1) * bs][:, :, yi, xi]                # (bs, C, P)
        rows.append(sub.permute(2, 0, 1).reshape(-1, v.shape[1]))
    return torch.cat(rows)


def gather_patches(v: torch.Tensor, ys: np.ndarray, xs: np.ndarray, bs: int,
                   attrs: dict) -> torch.Tensor:
    """The input patch of a conv (attributes `attrs`) under each sampled
    output point, zero outside the image: (G*P*bs, C, kh, kw) in
    `gather_points`' row order."""
    kh, kw, sh, sw, ph, pw, _ = _geometry(attrs)
    vp = F.pad(v, (pw, pw, ph, ph))
    rows = []
    for g in range(ys.shape[0]):
        r = torch.as_tensor(ys[g], dtype=torch.long)[:, None] * sh + torch.arange(kh)
        c = torch.as_tensor(xs[g], dtype=torch.long)[:, None] * sw + torch.arange(kw)
        sub = vp[g * bs:(g + 1) * bs][:, :, r.to(v.device)[:, :, None],
                                      c.to(v.device)[:, None, :]]   # (bs, C, P, kh, kw)
        rows.append(sub.permute(2, 0, 1, 3, 4).reshape(-1, v.shape[1], kh, kw))
    return torch.cat(rows)


def freeze(layers: list[dict], params: Mapping, images: np.ndarray,
           tensors: Sequence[str], plan: Mapping, device, chunk: int = 5,
           round_operands=None) -> dict[str, torch.Tensor]:
    """The ground truth: each tensor's values at its planned points over the
    calibration set (n_batches, bs, C, H, W), rows as `gather_points`,
    computed `chunk` batches at a time on `device`. Results on the CPU."""
    nb, bs = images.shape[:2]
    out: dict[str, list] = {t: [] for t in tensors}
    for lo in range(0, nb, chunk):
        hi = min(nb, lo + chunk)
        x = torch.as_tensor(np.ascontiguousarray(images[lo:hi])).to(device) \
            .reshape((-1,) + tuple(images.shape[2:])).float()

        def tap(t):
            return lambda v: gather_points(v, plan[t][0][lo:hi],
                                           plan[t][1][lo:hi], bs).cpu()

        got = run(layers, params, x, {t: tap(t) for t in tensors},
                  round_operands=round_operands)
        for t in tensors:
            out[t].append(got[t])
    return {t: torch.cat(v) for t, v in out.items()}


def max_gap(got: Mapping[str, np.ndarray], ref: Mapping[str, torch.Tensor]
            ) -> tuple[float, str]:
    """(the largest max|got - ref| / rms(ref) over the tensors, its tensor);
    inf where a tensor is missing or shaped otherwise."""
    worst, where = 0.0, ""
    for t, r in ref.items():
        g = got.get(t)
        if g is None or tuple(np.shape(g)) != tuple(r.shape):
            return float("inf"), t
        r64 = r.double()
        rms = float(torch.sqrt(torch.mean(r64 ** 2)))
        gap = float((torch.as_tensor(np.asarray(g)).double() - r64).abs().max())
        gap = gap / max(rms, 1e-30)
        if not np.isfinite(gap):
            return float("inf"), t
        if gap > worst:
            worst, where = gap, t
    return worst, where


# ---------------------------------------------------------------------------
# least squares
# ---------------------------------------------------------------------------

def lstsq_fit(X: torch.Tensor, Y: torch.Tensor, jitter: float, ridge: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(W (n, d), b (n,), lam) minimising ||X W^T + b - Y||^2 + lam ||W||^2
    with lam = jitter * trace(Xc^T Xc) + ridge (Xc: X less its column
    means; b free), in float64 by the normal equations."""
    X64, Y64 = X.double(), Y.double()
    xm, ym = X64.mean(0), Y64.mean(0)
    Xc, Yc = X64 - xm, Y64 - ym
    G = Xc.T @ Xc
    lam = float(jitter * torch.trace(G) + ridge)
    if lam <= 0:
        lam = 1e-12 * max(float(torch.trace(G)), 1e-300)
    G = G + lam * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    W = torch.cholesky_solve(Xc.T @ Yc, torch.linalg.cholesky(G)).T
    return W, ym - W @ xm, lam


def objective(X: torch.Tensor, Y: torch.Tensor, W: torch.Tensor,
              b: torch.Tensor, lam: float) -> float:
    """||X W^T + b - Y||^2 + lam ||W||^2 in float64."""
    W64 = W.double()
    r = X.double() @ W64.T + b.double() - Y.double()
    return float(torch.sum(r * r) + lam * torch.sum(W64 * W64))


# ---------------------------------------------------------------------------
# channel selection
# ---------------------------------------------------------------------------

def channel_response(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """X (N, c, kh, kw) input patches, W (n, c, kh, kw) a conv's weights:
    Z (N*n, c) in float64, column i the response of input channel i alone,
    rows point-major then output."""
    N, c = X.shape[:2]
    xr = X.double().reshape(N, c, -1).permute(1, 0, 2)          # (c, N, khkw)
    wr = W.double().reshape(W.shape[0], c, -1).permute(1, 2, 0)   # (c, khkw, n)
    return torch.bmm(xr, wr).reshape(c, -1).T


def lasso_at(G: torch.Tensor, b: torch.Tensor, lam: float) -> torch.Tensor:
    """The LASSO solution of min_beta 1/2 beta^T G beta - b^T beta +
    lam ||beta||_1, in float64, by its path (the homotopy) from
    lam_max = max |b| down to `lam`: a channel joins where its correlation
    reaches the path's lam, leaves where its coefficient reaches 0; between
    events the active coefficients are G_AA^-1 (b_A - lam s_A). The inverse
    of the active block is updated a channel at a time and recomputed every
    64 events. G must be positive definite on every active set."""
    G, b = G.double(), b.double()
    c = int(G.shape[0])
    beta = torch.zeros(c, dtype=G.dtype, device=G.device)
    j = int(torch.argmax(b.abs()))
    lam_path = float(b[j].abs())
    if lam >= lam_path or lam_path <= 0:
        return beta
    active, signs = [j], [1.0 if float(b[j]) > 0 else -1.0]
    inv = 1.0 / G[j:j + 1, j:j + 1]
    inside = torch.zeros(c, dtype=torch.bool, device=G.device)
    inside[j] = True
    none = float("-inf")
    for step in range(1, 8 * c + 64):
        A = torch.as_tensor(active, device=G.device)
        if step % 64 == 0:
            inv = torch.linalg.inv(G[A][:, A])
        s = torch.as_tensor(signs, dtype=G.dtype, device=G.device)
        u, v = inv @ b[A], inv @ s
        GA = G[:, A]
        p, q = b - GA @ u, GA @ v
        ceiling = lam_path * (1.0 - 1e-12)
        # joins: p_j + lam' q_j = +lam' (first row) or -lam' (second row)
        cand = torch.stack([p / (1.0 - q), -p / (1.0 + q)])
        ok = (cand > 0) & (cand < ceiling) & torch.isfinite(cand) & ~inside
        cand = torch.where(ok, cand, torch.full_like(cand, none))
        flat = int(torch.argmax(cand))
        lam_join = float(cand.reshape(-1)[flat])
        # leaves: u_i - lam' v_i = 0
        out = u / v
        ok_out = (out > 0) & (out < ceiling) & torch.isfinite(out)
        out = torch.where(ok_out, out, torch.full_like(out, none))
        i_out = int(torch.argmax(out))
        lam_leave = float(out[i_out])
        lam_next = max(lam_join, lam_leave)
        if lam_next <= lam:
            beta[A] = u - lam * v
            return beta
        if lam_join >= lam_leave:
            sign, jj = (1.0, flat) if flat < c else (-1.0, flat - c)
            g = G[A, jj]
            w = inv @ g
            d = G[jj, jj] - g @ w
            top = torch.cat([inv + torch.outer(w, w) / d, (-w / d)[:, None]], 1)
            bottom = torch.cat([-w / d, (1.0 / d).reshape(1)])[None, :]
            inv = torch.cat([top, bottom], 0)
            active.append(jj)
            signs.append(sign)
            inside[jj] = True
        else:
            keep = torch.as_tensor([i for i in range(len(active)) if i != i_out],
                                   device=G.device)
            f = inv[keep, i_out]
            inv = inv[keep][:, keep] - torch.outer(f, f) / inv[i_out, i_out]
            inside[active[i_out]] = False
            del active[i_out], signs[i_out]
        lam_path = lam_next
    raise RuntimeError("the LASSO path did not reach lam")


def top_k(score: torch.Tensor, k: int) -> np.ndarray:
    """(c,) bool mask of the k largest scores, ties to the lower index."""
    order = torch.argsort(-score.cpu(), stable=True)[:k]
    mask = np.zeros(score.shape[0], bool)
    mask[order.numpy()] = True
    return mask
