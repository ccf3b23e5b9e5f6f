"""Snapshot / resume of a finetune (port of
channel_pruning_tpu/train/checkpoint.py, with `torch.save` in place of
orbax): one `step_XXXXXXXX.pt` file per snapshot holding the parameters
(host tensors, keyed by layer name), the optimizer's state and the step."""
from __future__ import annotations

from pathlib import Path

import torch


class Checkpointer:
    def __init__(self, directory: str | Path) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.pt"

    def save(self, state, step: int) -> Path:
        path = self._path(step)
        params = {n: {k: v.detach().cpu() for k, v in blobs.items()}
                  for n, blobs in state.model.as_dict().items()}
        tmp = path.with_suffix(".tmp")
        torch.save({"params": params, "opt_state": state.optimizer.state_dict(),
                    "step": int(state.step)}, tmp)
        tmp.replace(path)
        return path

    def steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.pt"))

    def restore(self, step: int) -> dict:
        """{"params": {layer: {blob: tensor}}, "opt_state": optimizer
        state_dict, "step": int}."""
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def latest(self) -> dict | None:
        steps = self.steps()
        return self.restore(steps[-1]) if steps else None
