"""Plain reference of ResNet-50 (He et al. 2016; the ResNet-50 deploy
prototxt of KaimingHe/deep-residual-networks): a 7x7 stride-2 stem with
BatchNorm, Scale and ReLU, a 3x3 stride-2 max pool, bottleneck blocks
(1x1 -> 3x3 -> 1x1, the stride on branch2a, a 1x1 projection shortcut
`branch1` in each stage's first block), an Eltwise sum and ReLU, global
average pooling and one inner product. BatchNorm and Scale act in place on
their conv's tensor; each ReLU writes a tensor named after itself."""
from __future__ import annotations

from port_bench.reference.plain import layer

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _conv_bn(out: list, name: str, bottom: str, width: int, k: int, s: int,
             p: int, tag: str, eps: float) -> None:
    out.append(layer(name, "Convolution", [bottom], num_output=width,
                     kernel_size=k, stride=s, pad=p, bias=False))
    out.append(layer(f"bn{tag}", "BatchNorm", [name], [name], eps=eps))
    out.append(layer(f"scale{tag}", "Scale", [name], [name], bias=True))


def layers(cfg: dict) -> list[dict]:
    eps = float(cfg["bn_eps"])
    out: list[dict] = []
    _conv_bn(out, "conv1", "data", cfg["stem_width"], 7, 2, 3, "_conv1", eps)
    out.append(layer("conv1_relu", "ReLU", ["conv1"]))
    out.append(layer("pool1", "Pooling", ["conv1_relu"], pool="max",
                     kernel_size=3, stride=2))
    prev = "pool1"
    for stage, blocks, width, out_width in cfg["stages"]:
        for bi in range(blocks):
            tag = f"{stage}{_LETTERS[bi]}"
            block = f"res{tag}"
            stride = 2 if (bi == 0 and stage > 2) else 1
            shortcut = prev
            if bi == 0:
                shortcut = f"{block}_branch1"
                _conv_bn(out, shortcut, prev, out_width, 1, stride, 0,
                         f"{tag}_branch1", eps)
            a, b, c = (f"{block}_branch2{x}" for x in "abc")
            _conv_bn(out, a, prev, width, 1, stride, 0, f"{tag}_branch2a", eps)
            out.append(layer(f"{a}_relu", "ReLU", [a]))
            _conv_bn(out, b, f"{a}_relu", width, 3, 1, 1, f"{tag}_branch2b", eps)
            out.append(layer(f"{b}_relu", "ReLU", [b]))
            _conv_bn(out, c, f"{b}_relu", out_width, 1, 1, 0, f"{tag}_branch2c", eps)
            out.append(layer(block, "Eltwise", [shortcut, c], operation="sum"))
            out.append(layer(f"{block}_relu", "ReLU", [block]))
            prev = f"{block}_relu"
    out.append(layer("pool5", "Pooling", [prev], pool="ave", global_pooling=True))
    out.append(layer("fc1000", "InnerProduct", ["pool5"],
                     num_output=cfg["num_classes"]))
    out.append(layer("prob", "Softmax", ["fc1000"]))
    return out
