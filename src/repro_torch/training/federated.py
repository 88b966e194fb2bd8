"""Tensor-level federated trainer (ECC training pattern, paper §2): FedAvg
over a mesh's ``data`` axis.

The port of ``repro.training.federated``. Each edge cloud (EC) is one
index of the mesh's ``data`` axis; its local steps run independently (no
gradient sync, no collective), and a round ends with one FedAvg all-reduce
over the EC axis that averages the diverged replicas: the WAN round.
``repro`` stacks the replicas on a leading axis sharded over ``data`` and
runs the round under ``shard_map``; the port is explicit SPMD, one
process a rank, so a rank of data index d holds EC d's replica itself
(with ``model > 1`` every rank of the EC's model group holds the whole
replica and computes the same steps, as ``shard_map`` over ``data``
replicates over ``model``), and ``round`` takes that EC's batch.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim import sgd_init, sgd_update
from repro_torch.utils.tree import flat_paths, tree_leaves, tree_map, \
    tree_map_with_path


class FederatedTrainer:
    """FedAvg over the mesh's ``axis`` (each index one EC): ``loss_fn(
    params, batch)`` is a 0-dim loss of this EC's batch; a round takes
    ``local_steps`` SGD steps (``optim.sgd_update``, momentum 0.9, as
    ``repro``'s) and then averages the params, in f32, over the ECs. The
    momentum stays local, as ``repro``'s ``pmean`` touches the params
    alone."""

    def __init__(self, loss_fn: Callable, mesh, *, lr: float = 0.05,
                 local_steps: int = 4, axis: str = "data"):
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.lr = lr
        self.local_steps = local_steps
        self.axis = axis

    # -- host API ---------------------------------------------------------------
    def replicate(self, params):
        """This rank's EC replica of ``params`` (a copy on the mesh's
        device; ``repro`` stacks one a EC on a sharded axis)."""
        return tree_map(lambda x: torch.as_tensor(x).detach().to(
            self.mesh.device).clone(), params)

    def init_opt(self, replica):
        """This EC's optimizer state (every leaf local, the step too)."""
        return sgd_init(replica)

    def local_step(self, params, opt, batch):
        """One SGD step of this EC on ``batch``: (params, opt, loss)."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        keys = list(flat_paths(params))
        by_key = dict(zip(keys, leaves))
        live = tree_map_with_path(lambda k, _: by_key[k], params)
        with torch.enable_grad():
            loss = self.loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = {k: torch.zeros_like(p) if d is None else d
             for k, p, d in zip(keys, leaves, grads)}
        gtree = tree_map_with_path(lambda k, _: g[k], params)
        params, opt = sgd_update(params, gtree, opt, lr=self.lr)
        return params, opt, loss.detach()

    def round(self, params, opt, batch):
        """``local_steps`` steps of this EC on its ``batch`` with no
        collective, then FedAvg: one f32 all-reduce over the ECs of the
        params and the last local loss together, each divided by the EC
        count. Returns (params, opt, the ECs' mean last loss)."""
        loss = None
        for _ in range(self.local_steps):
            params, opt, loss = self.local_step(params, opt, batch)
        leaves = tree_leaves(params)
        flat = torch.cat([p.float().reshape(-1) for p in leaves]
                         + [loss.float().reshape(1)])
        n = self.mesh.axis_size(self.axis)
        mean = self.mesh.all_reduce(flat, axis=self.axis) / n
        out, off = {}, 0
        for key, p in zip(flat_paths(params), leaves):
            out[key] = mean[off:off + p.numel()].reshape(p.shape).to(p.dtype)
            off += p.numel()
        params = tree_map_with_path(lambda k, _: out[k], params)
        return params, opt, mean[-1]

    def unreplicate(self, params):
        """The averaged params (every EC holds them after a round)."""
        return params
