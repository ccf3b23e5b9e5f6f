"""Plain reference of Xception (Chollet, Xception: Deep Learning with
Depthwise Separable Convolutions, CVPR 2017, Fig. 5): a stem of two 3x3
convs with ReLU; an entry flow of three blocks, each a 1x1 stride-2
projection shortcut beside two separable convs and a 3x3 stride-2 max
pool, summed; a middle flow of residual blocks of three separable convs
each preceded by a ReLU; an exit flow of one more pooled block, then two
separable convs with ReLU, global average pooling and one inner product.
A separable conv is a 3x3 depthwise conv (`group` equal to its input
channels, one output a channel) and a 1x1 pointwise conv. Every conv is
followed by BatchNorm and Scale acting in place on its tensor; each ReLU
writes a tensor named after itself, as the port's preprocessed graph names
them.

The program runs the port's `models/xception.py`, which departs from the
paper in three places; this builder follows the port, so that both run the
same net:
  - `conv1` and `conv2` pad 1 where the paper has none: at 299², 150²
    after `conv1` and `conv2`, not 149² and 147², and 75² and 38² after
    the first two entry blocks, not 74² and 37²;
  - BatchNorm and Scale after each depthwise conv as well as after each
    pointwise one, where the paper has one BatchNorm a separable conv;
  - the max pools pad 1 on every side and round down (Caffe's floor mode),
    where the paper's "same" pooling pads only the bottom and right."""
from __future__ import annotations

from port_bench.reference.plain import layer


def _conv_bn(out: list, name: str, bottom: str, width: int, k: int, s: int,
             p: int, eps: float, group: int = 1) -> str:
    out.append(layer(name, "Convolution", [bottom], num_output=width,
                     kernel_size=k, stride=s, pad=p, group=group, bias=False))
    out.append(layer(f"{name}_bn", "BatchNorm", [name], [name], eps=eps))
    out.append(layer(f"{name}_scale", "Scale", [name], [name], bias=True))
    return name


def _sep_conv(out: list, name: str, bottom: str, c_in: int, c_out: int,
              eps: float, relu_first: bool) -> str:
    """[ReLU], a 3x3 depthwise conv and a 1x1 pointwise conv, each with its
    BatchNorm and Scale."""
    if relu_first:
        out.append(layer(f"{name}_prerelu", "ReLU", [bottom]))
        bottom = f"{name}_prerelu"
    _conv_bn(out, f"{name}_dw", bottom, c_in, 3, 1, 1, eps, group=c_in)
    return _conv_bn(out, f"{name}_pw", f"{name}_dw", c_out, 1, 1, 0, eps)


def _pool(out: list, name: str, bottom: str) -> str:
    out.append(layer(name, "Pooling", [bottom], pool="max", kernel_size=3,
                     stride=2, pad=1, ceil_mode=False))
    return name


def layers(cfg: dict) -> list[dict]:
    eps = float(cfg["bn_eps"])
    out: list[dict] = []
    w1, w2 = cfg["stem_widths"]
    _conv_bn(out, "conv1", "data", w1, 3, 2, 1, eps)
    out.append(layer("conv1_relu", "ReLU", ["conv1"]))
    _conv_bn(out, "conv2", "conv1_relu", w2, 3, 1, 1, eps)
    out.append(layer("conv2_relu", "ReLU", ["conv2"]))
    prev, ch = "conv2_relu", w2
    for i, width in enumerate(cfg["entry_widths"], start=1):
        blk = f"entry{i}"
        sc = _conv_bn(out, f"{blk}_shortcut", prev, width, 1, 2, 0, eps)
        t = _sep_conv(out, f"{blk}_sep1", prev, ch, width, eps, relu_first=i > 1)
        t = _sep_conv(out, f"{blk}_sep2", t, width, width, eps, relu_first=True)
        out.append(layer(blk, "Eltwise", [sc, _pool(out, f"{blk}_pool", t)],
                         operation="sum"))
        prev, ch = blk, width
    for i in range(1, int(cfg["middle_blocks"]) + 1):
        blk = f"mid{i}"
        t = prev
        for j in (1, 2, 3):
            t = _sep_conv(out, f"{blk}_sep{j}", t, ch, ch, eps, relu_first=True)
        out.append(layer(blk, "Eltwise", [prev, t], operation="sum"))
        prev = blk
    e1, e2, e3, e4 = cfg["exit_widths"]
    sc = _conv_bn(out, "exit_shortcut", prev, e2, 1, 2, 0, eps)
    t = _sep_conv(out, "exit_sep1", prev, ch, e1, eps, relu_first=True)
    t = _sep_conv(out, "exit_sep2", t, e1, e2, eps, relu_first=True)
    out.append(layer("exit", "Eltwise", [sc, _pool(out, "exit_pool", t)],
                     operation="sum"))
    t = _sep_conv(out, "exit_sep3", "exit", e2, e3, eps, relu_first=False)
    out.append(layer("exit_sep3_relu", "ReLU", [t]))
    t = _sep_conv(out, "exit_sep4", "exit_sep3_relu", e3, e4, eps,
                  relu_first=False)
    out.append(layer("exit_sep4_relu", "ReLU", [t]))
    out.append(layer("global_pool", "Pooling", ["exit_sep4_relu"], pool="ave",
                     global_pooling=True))
    out.append(layer("fc", "InnerProduct", ["global_pool"],
                     num_output=cfg["num_classes"]))
    out.append(layer("prob", "Softmax", ["fc"]))
    return out
