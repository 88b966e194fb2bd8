"""ECC training pattern (paper §2): federated-style collaborative training.

ECs train locally on private data; model updates cross the WAN through the
file service (data plane) announced over the bridged message service
(control plane); the CC aggregates (FedAvg) and redistributes. The
averaging (``fedavg``) is wired into ACE components here.

The port's copy: ``fedavg`` walks nested dicts and lists of tensors or
numpy arrays itself, and each averaged leaf keeps its input's dtype.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.registry import image
from repro_torch.utils.tree import tree_map


def fedavg(param_sets: List[Any], weights: Optional[List[float]] = None):
    """Weighted average of parameter trees."""
    n = len(param_sets)
    assert n > 0
    w = np.asarray(weights if weights is not None else [1.0] * n, np.float64)
    w = [float(wi) for wi in w / w.sum()]

    def avg(*leaves):
        out = sum(wi * leaf for wi, leaf in zip(w, leaves))
        if isinstance(leaves[0], torch.Tensor):
            return out.to(leaves[0].dtype)
        return np.asarray(out).astype(np.asarray(leaves[0]).dtype)

    return tree_map(avg, *param_sets)


@image("repro/pattern/fed-worker")
class FedWorker:
    """EC-side trainer: local steps on local data, then upload."""

    def __init__(self, local_train: Callable = None, data=None,
                 model_bytes: int = 1_000_000, rounds: int = 1):
        self.local_train = local_train
        self.data = data
        self.model_bytes = model_bytes
        self.rounds_left = rounds
        self.params = None
        self.history: List[float] = []

    def start(self, ctx) -> None:
        self.ctx = ctx
        files = ctx.services["file"]
        files.on_available(ctx.cluster, "fed/global-*",
                           lambda meta: self._on_global(meta))

    def _on_global(self, meta: dict) -> None:
        files = self.ctx.services["file"]
        files.get(meta["bucket"], meta["key"], self.ctx.cluster,
                  self._train_round)

    def _train_round(self, global_params) -> None:
        if self.rounds_left <= 0:
            return
        self.rounds_left -= 1
        params, loss = self.local_train(global_params, self.data)
        self.params = params
        self.history.append(float(loss))
        files = self.ctx.services["file"]
        files.put("fed", f"update-{self.ctx.instance_id}-{self.rounds_left}",
                  (params, len(self.data[0]) if self.data else 1),
                  self.model_bytes, self.ctx.cluster)


@image("repro/pattern/fed-aggregator")
class FedAvgAggregator:
    """CC-side aggregator: collects EC updates, FedAvgs, redistributes."""

    def __init__(self, init_params=None, num_workers: int = 1,
                 rounds: int = 1, model_bytes: int = 1_000_000):
        self.global_params = init_params
        self.num_workers = num_workers
        self.rounds_left = rounds
        self.model_bytes = model_bytes
        self.pending: List = []
        self.round_idx = 0

    def start(self, ctx) -> None:
        self.ctx = ctx
        files = ctx.services["file"]
        files.on_available(ctx.cluster, "fed/update-*", self._on_update)
        self._broadcast()

    def _broadcast(self) -> None:
        files = self.ctx.services["file"]
        files.put("fed", f"global-{self.round_idx}",
                  self.global_params, self.model_bytes, self.ctx.cluster,
                  lifecycle="temporary")

    def _on_update(self, meta: dict) -> None:
        files = self.ctx.services["file"]
        files.get(meta["bucket"], meta["key"], self.ctx.cluster,
                  self._collect)

    def _collect(self, payload) -> None:
        params, nsamples = payload
        self.pending.append((params, nsamples))
        if len(self.pending) >= self.num_workers:
            sets = [p for p, _ in self.pending]
            weights = [float(n) for _, n in self.pending]
            self.global_params = fedavg(sets, weights)
            self.pending = []
            self.round_idx += 1
            self.rounds_left -= 1
            self.ctx.log("fed_round", round=self.round_idx)
            if self.rounds_left > 0:
                self._broadcast()
