"""Parameter transfer between the numpy dicts both packages start from
(models/vgg.init_params, io/caffe.load_weights) and device tensors."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_to_torch(params_np: Mapping[str, Mapping[str, np.ndarray]],
                    device: torch.device | str) -> dict[str, dict[str, torch.Tensor]]:
    return {layer: {k: torch.tensor(np.asarray(v), device=device)
                    for k, v in p.items()}
            for layer, p in params_np.items()}


def params_to_numpy(params_t: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> dict[str, dict[str, np.ndarray]]:
    return {layer: {k: v.detach().cpu().numpy() for k, v in p.items()}
            for layer, p in params_t.items()}
