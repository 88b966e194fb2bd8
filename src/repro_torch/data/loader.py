"""Host-side sharded loading: numpy batches -> this rank's rows on its
device.

The port of ``repro.data.loader``. ``repro`` lays a host batch out over
the mesh with ``NamedSharding``s (the leading dim over the batch axes
when it divides, ``launch.sharding_rules.batch_pspecs``' rule); under the
port's one process per rank each rank keeps its contiguous B/D rows of
every leaf whose leading dim divides by D (data rank d: rows ``[d B/D,
(d + 1) B/D)``) and the whole leaf otherwise, as tensors on its mesh's
device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch


class ShardedLoader:
    """Iterate ``it``'s host batches (dicts of arrays) as dicts of tensors:
    the whole batch without a mesh (on ``device``, default the CPU), this
    rank's rows on a ``launch.mesh.HostMesh``."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], mesh=None,
                 batch_axes: tuple = ("data",), device=None):
        self.it = it
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.device = torch.device(device if device is not None else (
            mesh.device if mesh is not None else "cpu"))

    def __iter__(self):
        return self

    def rows(self, leaf):
        """This rank's rows of one host leaf (a view; the whole leaf when
        its leading dim does not divide)."""
        if self.mesh is None:
            return leaf
        axes = [a for a in self.batch_axes if a in self.mesh.shape]
        size, index = 1, 0
        for a in axes:
            size *= self.mesh.shape[a]
            index = index * self.mesh.shape[a] + self.mesh.axis_rank(a)
        n = np.shape(leaf)[0] if np.ndim(leaf) else 0
        if np.ndim(leaf) == 0 or n % size:
            return leaf
        per = n // size
        return leaf[index * per:(index + 1) * per]

    def __next__(self) -> Dict[str, torch.Tensor]:
        host = next(self.it)
        return {k: torch.as_tensor(np.ascontiguousarray(self.rows(v))).to(
            self.device) for k, v in host.items()}
