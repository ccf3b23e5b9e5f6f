"""The system under test: one compression job of the PyTorch port, driven
through its library as `cli prune` runs it after its load and without its
file writes (no frozen-cache file, no solve checkpoint, no export):

  c3.preprocess -> the parameters' upload -> sampler.freeze ->
  c3.solve_prune

with the job settings of the cell's traffic file. The result stays on the
host: the compressed graph and parameters, the frozen cache, the reports.
This is the one module of the benchmark that imports the program, and it
imports it only inside functions."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


class Spans:
    """Host-clock spans around the calls into each layer of the program:
    (label, job index, start, end) in `time.perf_counter` seconds."""

    def __init__(self) -> None:
        self.items: list[tuple[str, int, float, float]] = []

    @contextlib.contextmanager
    def span(self, label: str, job: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((label, job, t0, time.perf_counter()))

    def seconds(self, label: str, jobs) -> list[float]:
        jobs = set(jobs)
        return [t1 - t0 for l, j, t0, t1 in self.items if l == label and j in jobs]


@dataclass
class JobOutput:
    seconds: float
    graph: object                       # the program's compressed Graph
    params: dict                        # its parameters (numpy)
    cache: object                       # the program's FrozenCache
    reports: list = field(default_factory=list)
    selections: dict = field(default_factory=dict)


def plain_layers(graph) -> list[dict]:
    """A program Graph as the plain layer list the reference reads."""
    return [{"name": l.name, "type": l.type, "bottoms": list(l.bottoms),
             "tops": list(l.tops), "attrs": dict(l.attr_dict)}
            for l in graph.layers]


def launch_counts() -> dict[str, int]:
    """The program's kernel launch counters (K1/K2, K3)."""
    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
    return {"K1": lasso_cd.LAUNCHES, "K2": lasso_cd.LAUNCHES_STREAM,
            "K3": group_cd.LAUNCHES}


class Program:
    """The port, set up for one cell: its graph of the configuration, its
    config with the traffic's settings, and its CD kernels loaded."""

    def __init__(self, config: dict, traffic: dict, device) -> None:
        from channel_pruning_tpu_torch.device import resolve_device
        from channel_pruning_tpu_torch.models import zoo
        from channel_pruning_tpu_torch.utils.config import default_config

        if traffic["mode"] != "prune":
            raise ValueError(f"traffic mode {traffic['mode']!r}: the benchmark "
                             "drives `cli prune --mode prune` jobs only")
        self.device = resolve_device(str(device))
        self.traffic = traffic
        kw = {"batch": int(config["batch_size"])}
        if config.get("image_size"):
            kw["image_size"] = int(config["image_size"])
        self.graph = zoo.get_model(config["program_model"], **kw)
        cfg = default_config()
        for kv in traffic.get("set", []):
            key, _, val = kv.partition("=")
            cfg = cfg.replace_nested(key, val)
        self.cfg = cfg
        if self.device.type == "cuda":
            from channel_pruning_tpu_torch.kernels import lasso_cd
            lasso_cd.build()

    def param_shapes(self) -> dict[str, dict[str, tuple]]:
        """The parameter layout the program's graph takes (its own init)."""
        from channel_pruning_tpu_torch.graph.ir import LT, shapes_of
        shapes = shapes_of(self.graph)
        out = {}
        for l in self.graph.layers:
            if l.type == LT.CONV:
                g = l.conv_geometry()
                cin = shapes[l.bottoms[0]][1] // g["group"]
                out[l.name] = {"W": (int(l.attr("num_output")), cin, g["kh"], g["kw"])}
            elif l.type == LT.FC:
                out[l.name] = {"W": (int(l.attr("num_output")),
                                     int(np.prod(shapes[l.bottoms[0]][1:])))}
        return out

    def run(self, params: dict, images: np.ndarray, spans: Spans,
            job: int) -> JobOutput:
        """One whole compression job on calibration images (n_batches,
        batch, C, H, W) and the original parameters (numpy)."""
        from channel_pruning_tpu_torch.convert import params_to_torch
        from channel_pruning_tpu_torch.pipeline import c3
        from channel_pruning_tpu_torch.pipeline.checkpoint import SolveCheckpoint
        from channel_pruning_tpu_torch.sampling.sampler import (
            freeze, freeze_tensor_set, params_for_tensors, resnet_share_key)

        cfg, tr, dev = self.cfg, self.traffic, self.device
        t0 = time.perf_counter()
        with spans.span("preprocess", job):
            graph, p = c3.preprocess(self.graph, params)
        # the CLI's rule: sample the FC stack when it is small or fitfc needs it
        fc_bytes = sum(int(np.asarray(v).nbytes)
                       for f in graph.fcs for v in p.get(f, {}).values())
        tensors = freeze_tensor_set(graph, include_fc=cfg.dic.fitfc
                                    or fc_bytes < (64 << 20))
        with spans.span("upload", job):
            dparams = params_to_torch(params_for_tensors(graph, p, tensors), dev)
        with spans.span("freeze", job):
            cache = freeze(graph, dparams, images, device=dev, tensors=tensors,
                           n_points=cfg.sample.n_points_per_layer,
                           seed=cfg.sample.seed,
                           share_key=resnet_share_key(graph) if graph.sums else None,
                           chunk_batches=max(cfg.sample.freeze_device_batch
                                             // images.shape[1], 1))
        del dparams
        with spans.span("prune_pass", job):
            res = c3.solve_prune(graph, p, cache, cfg,
                                 channel_targets=tr.get("channel_targets"),
                                 input_targets=tr.get("input_targets"),
                                 device=dev, checkpoint=SolveCheckpoint(None),
                                 verbose=False)
        return JobOutput(seconds=time.perf_counter() - t0, graph=res.graph,
                         params=res.params, cache=cache,
                         reports=[dict(vars(r)) for r in res.reports],
                         selections=res.selections)
