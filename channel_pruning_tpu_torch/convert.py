"""Parameter transfer between the numpy dicts both packages start from
(models/vgg.init_params, io/caffe.load_weights), device tensors, and the
nn.Module that training and export hold them in."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def params_to_torch(params_np: Mapping[str, Mapping[str, np.ndarray]],
                    device: torch.device | str) -> dict[str, dict[str, torch.Tensor]]:
    return {layer: {k: torch.tensor(np.asarray(v), device=device)
                    for k, v in p.items()}
            for layer, p in params_np.items()}


def params_to_numpy(params_t: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> dict[str, dict[str, np.ndarray]]:
    return {layer: {k: v.detach().cpu().numpy() for k, v in p.items()}
            for layer, p in params_t.items()}


def params_on(params: Mapping[str, Mapping], device: torch.device | str
              ) -> dict[str, dict[str, torch.Tensor]]:
    """A params dict of numpy arrays or tensors, as tensors on `device`
    (tensors already there are not copied)."""
    return {layer: {k: v.to(device) if torch.is_tensor(v)
                    else torch.tensor(np.asarray(v), device=device)
                    for k, v in p.items()}
            for layer, p in params.items()}


def _copy_to(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to(device, copy=True)
    return torch.tensor(np.asarray(v), device=device)


def _key(name: str) -> str:
    """A layer name as a module key: nn.Module keys cannot hold "." and
    layer names may hold "/" (rpn_conv/3x3), so both are escaped, and "%"
    with them so the escape reverses."""
    return name.replace("%", "%25").replace(".", "%2E").replace("/", "%2F")


class GraphParams(nn.Module):
    """A graph's parameters ({layer: {blob: array}}, Caffe layout) as an
    nn.Module of one ParameterDict per layer, for the optimizer and for
    torch.export. `as_dict()` gives the dict the executor reads."""

    def __init__(self, params: Mapping[str, Mapping], device: torch.device | str,
                 requires_grad: bool = True):
        super().__init__()
        self.names = list(params)
        self.layers = nn.ModuleDict({
            _key(layer): nn.ParameterDict({
                k: nn.Parameter(_copy_to(v, device), requires_grad=requires_grad)
                for k, v in p.items()})
            for layer, p in params.items()})

    def layer(self, name: str) -> nn.ParameterDict:
        return self.layers[_key(name)]

    def as_dict(self) -> dict[str, dict[str, torch.Tensor]]:
        return {n: dict(self.layers[_key(n)].items()) for n in self.names}

    def to_numpy(self) -> dict[str, dict[str, np.ndarray]]:
        return params_to_numpy(self.as_dict())
