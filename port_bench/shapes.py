"""The benchmark's own shape, operation and byte arithmetic, and the table
of peaks it divides by. It works on plain layer lists (dicts with `name`,
`type`, `bottoms`, `tops` and `attrs`, Caffe's layer types and attribute
names), so it counts the same whatever program produced the graph.

Conv output sizes follow Caffe: floor((H + 2p - k) / s) + 1; pooling walks
in ceil mode and clips a last window that would start in the padding. A
conv's multiplies are out_h * out_w * kh * kw * c_in / group * c_out.
"""
from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at 700 W.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def conv_geometry(attrs: dict) -> dict[str, int]:
    """(kh, kw, sh, sw, ph, pw, group) of a Convolution's attributes."""
    a = attrs
    return {"kh": int(a.get("kernel_h", a.get("kernel_size", 1))),
            "kw": int(a.get("kernel_w", a.get("kernel_size", 1))),
            "sh": int(a.get("stride_h", a.get("stride", 1))),
            "sw": int(a.get("stride_w", a.get("stride", 1))),
            "ph": int(a.get("pad_h", a.get("pad", 0))),
            "pw": int(a.get("pad_w", a.get("pad", 0))),
            "group": int(a.get("group", 1))}


def _pool_out(n: int, k: int, s: int, p: int, ceil_mode: bool) -> int:
    if not ceil_mode:
        return (n + 2 * p - k) // s + 1
    out = -(-(n + 2 * p - k) // s) + 1
    if p > 0 and (out - 1) * s >= n + p:
        out -= 1
    return out


def tensor_shapes(layers: list[dict], input_shape: tuple[int, ...],
                  input_name: str = "data") -> dict[str, tuple[int, ...]]:
    """Every tensor's shape (NCHW, or (N, D) after an InnerProduct)."""
    env = {input_name: tuple(int(d) for d in input_shape)}
    for l in layers:
        t, a = l["type"], l["attrs"]
        x = env[l["bottoms"][0]] if l["bottoms"] else None
        if t == "Convolution":
            g = conv_geometry(a)
            n, _, h, w = x
            out = (n, int(a["num_output"]),
                   (h + 2 * g["ph"] - g["kh"]) // g["sh"] + 1,
                   (w + 2 * g["pw"] - g["kw"]) // g["sw"] + 1)
        elif t == "Pooling":
            n, c, h, w = x
            if a.get("global_pooling", False):
                out = (n, c, 1, 1)
            else:
                k, s = int(a["kernel_size"]), int(a.get("stride", 1))
                p, cm = int(a.get("pad", 0)), bool(a.get("ceil_mode", True))
                out = (n, c, _pool_out(h, k, s, p, cm), _pool_out(w, k, s, p, cm))
        elif t == "InnerProduct":
            out = (x[0], int(a["num_output"]))
        elif t == "Select":
            idx = a.get("indices")
            out = x if idx is None or a.get("passthrough", False) else \
                (x[0], len(idx)) + tuple(x[2:])
        elif t in ("Input", "Data"):
            continue
        else:
            out = x
        for top in l["tops"]:
            env[top] = out
    return env


def conv_mults(layers: list[dict], input_shape: tuple[int, ...],
               input_name: str = "data") -> dict[str, int]:
    """Each conv's multiplies for one image."""
    one = (1,) + tuple(input_shape[1:])
    shapes = tensor_shapes(layers, one, input_name)
    out = {}
    for l in layers:
        if l["type"] != "Convolution":
            continue
        g = conv_geometry(l["attrs"])
        _, c_out, oh, ow = shapes[l["tops"][0]]
        c_in = shapes[l["bottoms"][0]][1]
        out[l["name"]] = oh * ow * g["kh"] * g["kw"] * (c_in // g["group"]) * c_out
    return out


def ancestors(layers: list[dict], tensors) -> set[str]:
    """Names of the layers that any of `tensors` depends on."""
    want = set(tensors)
    names: set[str] = set()
    for l in reversed(layers):
        if want & set(l["tops"]):
            names.add(l["name"])
            want |= set(l["bottoms"])
    return names


def cd_grid_least_seconds(c: int, alphas: int) -> float:
    """The least time of one CD grid over `alphas` alphas of a c x c Gram:
    the larger of its bytes (the f32 Gram and right-hand side read once,
    the `alphas` coefficient vectors written once) over HBM bandwidth and
    its operations (one sweep an alpha, 2 c^2 each) over the f32 peak."""
    nbytes = 4 * (c * c + c + alphas * c)
    flops = alphas * 2 * c * c
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])


def lstsq_flops(rows: int, d: int, n_out: int) -> float:
    """The least operations of a least-squares fit of (rows, d) inputs to
    (rows, n_out) targets by the normal equations: the symmetric Gram, the
    right-hand side, the Cholesky factor and two triangular solves."""
    return (rows * d * (d + 1) + 2.0 * rows * d * n_out + d ** 3 / 3.0
            + 2.0 * d * d * n_out)
