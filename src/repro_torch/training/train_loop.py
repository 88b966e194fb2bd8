"""Training on one device: the train-step factory (gradients of
``LM.loss`` through the rematerialised layers, then AdamW) and a host-side
``Trainer`` with checkpointing and metric logging.

The port of ``repro.training.train_loop``. ``repro`` jits the step; the
port runs it eagerly (no graph capture): ``torch.autograd.grad`` of
``lm.loss(params, batch, train=True)`` over every parameter leaf, whose
backward goes through the hand-written backward kernels on the card
(``kernels.flash_attention``'s and ``kernels.rglru_scan``'s autograd
Functions), then ``optim.adamw_update`` with its global-norm clip. Params
and optimizer state are the same trees as ``repro``'s, and a checkpoint of
``(params, opt)`` has ``repro``'s key paths, so either package restores
the other's. Training on a mesh and federated training are later slices
of the port (serving on a mesh is ported: ``serving.sharding``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.models.model import LM
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map


def loss_and_grads(lm: LM, params, batch):
    """``lm.loss(params, batch, train=True)``, its metrics and its gradient
    (a tree like ``params``; zeros for a leaf the loss does not read), all
    detached."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, metrics = lm.loss(params, batch, train=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], params))


def make_train_step(lm: LM, lr_schedule: Callable,
                    weight_decay: float = 0.01,
                    grad_clip: float = 1.0) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): forward (+ MoE aux, + MTP) with every layer rematerialised,
    backward, global grad-norm clip, AdamW. ``metrics`` holds 0-dim
    tensors ``loss``, ``lr``, ``ce``, ``aux`` (and ``mtp``) on the model's
    device; reading them syncs the host, so the step itself never does."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(lm, params, batch)
        lr = lr_schedule(opt_state.step)
        params_new, opt_new = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            grad_clip=grad_clip)
        return params_new, opt_new, {"loss": loss, "lr": lr, **metrics}

    return train_step


def make_eval_step(lm: LM) -> Callable:
    """eval_step(params, batch) -> {"loss", "ce", "aux"}: the loss without
    remat or MTP, no gradient."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = lm.loss(params, batch, train=False)
        return {"loss": loss, **metrics}
    return eval_step


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    """Host loop: iterate batches (moved to the model's device), step,
    checkpoint every ``ckpt_every`` steps, log every ``log_every`` (and
    the last) step into ``history``."""

    def __init__(self, lm: LM, lr_schedule, *, ckpt_dir: Optional[str] = None,
                 opt_state_dtype=torch.float32, weight_decay: float = 0.01,
                 log_every: int = 10, ckpt_every: int = 100):
        self.lm = lm
        self.ckpt_dir = ckpt_dir
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.opt_state_dtype = opt_state_dtype
        self.train_step = make_train_step(lm, lr_schedule, weight_decay)
        self.history: list = []

    def init_state(self, seed: int):
        """Random params from ``seed`` (``LM.init``, drawn on the model's
        device) and a fresh AdamW state."""
        params = self.lm.init(seed, on_device=True)
        return params, adamw_init(params, self.opt_state_dtype)

    def restore_or_init(self, seed: int):
        """The newest checkpoint in ``ckpt_dir`` (into the structure,
        dtypes and device of a fresh state), or the fresh state."""
        params, opt = self.init_state(seed)
        if self.ckpt_dir and latest_step(self.ckpt_dir) is not None:
            (params, opt), step = load_checkpoint(self.ckpt_dir,
                                                  (params, opt))
            print(f"[trainer] restored step {step} from {self.ckpt_dir}")
        return params, opt

    def fit(self, params, opt, batches: Iterator[Dict[str, Any]],
            num_steps: int, echo: bool = True):
        t0 = time.time()
        for i in range(num_steps):
            batch = to_device(next(batches), self.lm.device)
            params, opt, metrics = self.train_step(params, opt, batch)
            if i % self.log_every == 0 or i == num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = round(time.time() - t0, 2)
                self.history.append(m)
                if echo:
                    print(f"[trainer] step {i:5d} loss {m['loss']:.4f} "
                          f"lr {m['lr']:.2e} ({m['wall_s']}s)")
            if (self.ckpt_dir and self.ckpt_every
                    and (i + 1) % self.ckpt_every == 0):
                save_checkpoint(self.ckpt_dir, i + 1, (params, opt))
        return params, opt
