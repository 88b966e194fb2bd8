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
    this rank's shards, and ``split`` (a tree like ``params``) says which
    mesh axes each leaf is cut over: "data", "model", "data,model" or ""
    (``training.train_loop.clip_axes``). The clip's global norm sums each
    leaf's squares over the axes that cut it and counts it once on the
    others.

    A leaf is updated ``_CHUNK`` elements at a time along its first dim
    (the update is elementwise, so the values are those of one pass), and
    the clip's scale is applied inside that pass: a step's transient
    memory is a chunk's, not a multiple of the largest leaf's."""
    step = state.step + 1
    scale = None
    if grad_clip is not None:
        gnorm = torch.sqrt(_global_sq(grads, mesh, split))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

    sdt = tree_leaves(state.mu)[0].dtype
    t = step.float()
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=t.device), t)

    def one(p, g, m, v):
        g32 = (g if scale is None else g * scale.to(g.dtype)).float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * torch.square(g32)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(sdt), v_new.to(sdt)

    def upd(p, g, m, v):
        if p.numel() <= _CHUNK or p.dim() == 0:
            return one(p, g, m, v)
        out = (torch.empty_like(p), torch.empty_like(m, dtype=sdt),
               torch.empty_like(v, dtype=sdt))
        rows = max(1, _CHUNK * p.shape[0] // p.numel())
        for i in range(0, p.shape[0], rows):
            part = slice(i, i + rows)
            for o, x in zip(out, one(p[part], g[part], m[part], v[part])):
                o[part] = x
        return out

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_params, new_mu, new_nu = (_pick(out, i) for i in range(3))
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu)


# elements of a leaf that one pass of the AdamW update takes (256 MiB of f32)
_CHUNK = 1 << 26


def _global_sq(grads, mesh, split):
    """The sum of every gradient element's square, of the whole tree (on a
    mesh: each leaf's shards summed over the axes that cut it, 'data',
    'model' or both, and counted once on an axis that holds it whole; one
    all-reduce over 'data', then one over 'model')."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if mesh is None:
        return sum(sq)
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    by = {}
    for q, axes in zip(sq, tree_leaves(split)):
        key = tuple(a in axes.split(",") for a in ("data", "model"))
        by[key] = by.get(key, zero) + q
    # [cut on both, cut on data] over 'data'; then [the first, cut on
    # model] over 'model' (on a 1-way axis its call returns its input)
    d = mesh.all_reduce(torch.stack([by.get((True, True), zero),
                                     by.get((True, False), zero)]),
                        axis="data")
    m = mesh.all_reduce(torch.stack([d[0], by.get((False, True), zero)]),
                        axis="model")
    return m[0] + d[1] + m[1] + by.get((False, False), zero)


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
