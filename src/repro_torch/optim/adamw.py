"""AdamW and SGD over the port's nested-dict parameters.

The port of ``repro.optim.adamw``: the same update in the same precision
(global-norm clip, moments and bias correction in f32; moments stored in
f32 or bf16), written as tensor ops on each leaf's own device so a step
never syncs the host. Updates are functional: new parameter and state
trees are returned, the inputs are left as they are.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _zeros_like(params, state_dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                          device=p.device), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    return AdamWState(step=_step0(params),
                      mu=_zeros_like(params, state_dtype),
                      nu=_zeros_like(params, state_dtype))


def _pick(tree, i: int):
    """Entry ``i`` of each tuple leaf of a tree of dicts and lists (the
    per-leaf results of an update)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 grad_clip: Optional[float] = 1.0, mesh=None, split=None):
    """Returns (new_params, new_state). ``lr`` may be a scalar or a
    schedule value already resolved for this step. On a mesh (``mesh``, a
    ``launch.mesh.HostMesh``) ``params``, ``grads`` and the moments are
    this rank's shards, and ``split`` (a tree like ``params`` of bools)
    says which leaves are cut over 'data': the clip's global norm sums
    their squares over the data ranks and adds the whole leaves' squares
    once."""
    step = state.step + 1
    if grad_clip is not None:
        gnorm = torch.sqrt(_global_sq(grads, mesh, split))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    sdt = tree_leaves(state.mu)[0].dtype
    t = step.float()
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=t.device), t)

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * torch.square(g32)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(sdt), v_new.to(sdt)

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_params, new_mu, new_nu = (_pick(out, i) for i in range(3))
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu)


def _global_sq(grads, mesh, split):
    """The sum of every gradient element's square, of the whole tree (on a
    mesh: each data-split leaf's shards summed over the data ranks, each
    replicated leaf counted once)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if mesh is None:
        return sum(sq)
    cut = tree_leaves(split)
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    parts = sum((q for q, c in zip(sq, cut) if c), zero)
    whole = sum((q for q, c in zip(sq, cut) if not c), zero)
    return mesh.all_reduce(parts, axis="data") + whole


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd_init(params, state_dtype=torch.float32) -> SGDState:
    return SGDState(step=_step0(params),
                    momentum=_zeros_like(params, state_dtype))


@torch.no_grad()
def sgd_update(params, grads, state: SGDState, *, lr, momentum: float = 0.9):
    def upd(p, g, m):
        m_new = momentum * m.float() + g.float()
        return (p.float() - lr * m_new).to(p.dtype), m_new.to(m.dtype)

    out = tree_map(upd, params, grads, state.momentum)
    return _pick(out, 0), SGDState(step=state.step + 1,
                                   momentum=_pick(out, 1))
