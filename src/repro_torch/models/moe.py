"""Mixture-of-Experts channel mixer: routing, grouped capacity dispatch and
SwiGLU experts. Port of ``repro.models.moe``.

Each batch row is a dispatch group with its own per-expert capacity
(GShard-style): a (token, choice) pair's slot within its expert is a
cumulative count over the row's pairs in (token, choice) order, pairs past
the capacity are dropped, the kept tokens are gathered into an (E, C, D)
buffer per row, the experts run as one batched product, and the results
are gathered back and weighted by the router. Whether a pair is dropped so
depends on how many tokens share the call: one-token decode never drops
(each row's capacity is 1 and a token picks an expert once), a short chunk
may. A ``capacity_factor`` of E / k makes every capacity equal the row's
token count when that ratio is a power of two: nothing drops.

Routing: softmax top-k (Mixtral), or sigmoid top-k normalised by its sum
with shared experts (DeepSeek-V3, inferred from ``num_shared_experts``),
plus the switch load-balance auxiliary loss. The router's logits are f32
from an f32 router. Every shape is fixed by (B, S), so a CUDA graph
captures the whole function.

On a mesh (``tp``, a ``sharding.TensorParallel``) a rank holds its E/N
routed experts (or, where the experts do not divide, every expert's d_ff
slice), its E/N router columns and its d_ff slice of the shared expert.
It gathers the (T, E) logits from every rank before the top-k (exact, so
every rank routes alike), keeps the slot bookkeeping over all E experts at
the global capacity (so a pair drops on every rank as under ``tp=None``),
runs its own experts' slots, combines with weight 0 for a pair whose
expert lives elsewhere, and sums the routed and shared partials over the
ranks in one f32 all-reduce.

On a mesh with a data axis the decode rules put the experts on ("data",
"model"): each rank runs its E/(D·M) whole experts on the replicated
tokens, and the routed partials are summed over the whole mesh. The
router's and the shared expert's D rows split on 'data', so their
products are one reduction over 'data' each (``layers.project``). The
shared expert's ``w_down`` partial is the same on every rank of a model
column: data rank 0 alone adds it to the mesh-wide sum. Where the
experts do not divide by D·M, every expert's D splits on 'data' and its
d_ff on 'model', and the routed partial is a model sum, as the shared
one.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import project


def capacity(s: int, k: int, e: int, capacity_factor: float) -> int:
    """Per-row, per-expert capacity of an ``s``-token group (``repro``'s
    expression, evaluated in the same order)."""
    return max(int(s * k / e * capacity_factor), 1) if s > 1 else 1


def _one_hot(idx, n: int) -> torch.Tensor:
    """(..., n) bool: a comparison, so no value check syncs the host."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def router_logits(params, x_flat, tp=None) -> torch.Tensor:
    """The (T, E) f32 router logits of x_flat (T, D). On a mesh whose
    router columns split, this rank's E/N columns joined with every
    other rank's (an exact gather), so every rank routes alike."""
    logits, = project(x_flat.float(), [params["router"].float()], tp,
                      tp is not None and tp.data_router)
    if tp is not None and tp.router:
        logits = tp.gather(logits, -1)
    return logits


def route(params, cfg, x_flat, tp=None,
          over_data=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat (T, D) -> (topk_idx (T, k) int64, topk_w (T, k) f32, aux
    loss, a 0-dim f32 tensor). The top-k is in descending order: the
    flattened (token, choice) order decides which pairs a capacity keeps.
    ``over_data(t)``, when given, sums a tensor over the data ranks of a
    data-parallel step: the aux loss is then this rank's share of the
    global batch's, ``E · Σ_e frac_e · mean_p_e`` over every rank's tokens
    (one collective a MoE layer). The shares add up to the global loss and
    their gradients to its gradient."""
    m = cfg.moe
    logits = router_logits(params, x_flat, tp)
    if m.num_shared_experts > 0:        # DeepSeek-style sigmoid routing
        scores = torch.sigmoid(logits)
        topk_w, topk_idx = torch.topk(scores, m.num_experts_per_tok, dim=-1)
        topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:                               # Mixtral-style softmax routing
        topk_l, topk_idx = torch.topk(logits, m.num_experts_per_tok, dim=-1)
        topk_w = torch.softmax(topk_l, dim=-1)
        probs = torch.softmax(logits, dim=-1)
    # switch load-balance loss: E * sum_e fraction_e * mean_prob_e, the
    # fractions' counts and the token count summed over the data ranks
    top1 = _one_hot(topk_idx[:, 0], m.num_experts).float()
    sums = torch.cat([top1.sum(dim=0), top1.new_full((1,), top1.shape[0])])
    if over_data is not None:
        sums = over_data(sums)
    frac = sums[:-1] / sums[-1]
    aux = m.num_experts * torch.sum(frac * probs.sum(dim=0) / sums[-1])
    return topk_idx, topk_w, aux


def dispatch(topk_idx, b: int, s: int, e: int, cap: int):
    """Slot bookkeeping of the grouped dispatch. topk_idx (B*S, k) ->
    (keep (B, S*k) bool: the pair fits its expert's capacity; target
    (B, S*k) int64: its column ``expert * cap + slot`` of the row's
    (E*C) buffer, ``E*C`` when dropped)."""
    k = topk_idx.shape[-1]
    flat_e = topk_idx.reshape(b, s * k)
    onehot = _one_hot(flat_e, e).to(torch.int32)             # (B, S*k, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - 1
    slot = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0].long()
    keep = slot < cap
    target = torch.where(keep, flat_e * cap + slot,
                         torch.full_like(slot, e * cap))
    return keep, target


def _experts(x_pad, src_tok, b: int, e: int, cap: int, params, tp=None):
    """Gather each expert slot's token (row S of ``x_pad``, zeros, for an
    empty slot) and run SwiGLU over every expert's slots: -> (E, B*C, D),
    the gate's silu in f32. The (E, B*C, D) buffers are the call's
    largest (E*C is S*E at the dropless factor): the gathered input is
    freed before the f32 gate and the output are made. Where the mesh
    ``tp`` splits the experts' D on 'data', the gate and up products are
    partials of this rank's columns, summed over 'data' in one f32
    all-reduce."""
    d = x_pad.shape[-1]
    xe = torch.gather(x_pad, 1, src_tok[..., None].expand(b, e * cap, d))
    xe = xe.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    if tp is not None and tp.expert_data_in:
        xe = tp.mesh.shard(xe, -1, axis="data")
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    del xe
    if tp is not None and tp.expert_data_in:
        f = g.shape[-1]
        g, u = tp.mesh.all_reduce(torch.cat([g, u], -1),
                                  axis="data").split(f, -1)
    h = F.silu(g.float(), inplace=True).to(u.dtype).mul_(u)
    del g, u
    return torch.bmm(h, params["w_down"])


def region_reads(names, tp) -> set:
    """Which of a MoE layer's leaves (``names``) a rank reads inside a
    region split over 'model', each entered in ``moe_forward``: the
    router when its columns split, the routed experts when they split (by
    expert or by d_ff), the shared expert when its d_ff splits; as
    ``attention.region_reads``. A part every rank runs whole reads the
    input as it is, outside any region."""
    routed = tp.experts or tp.expert_mlp
    return {n for n in names if {"router": tp.router,
                                 "shared": tp.shared_mlp}.get(n, routed)}


def moe_forward(params, cfg, x, *, capacity_factor: float = 1.25,
                tp=None, over_data=None):
    """x (B, S, D) -> (y (B, S, D), aux loss). On a mesh ``params`` are
    this rank's shards and y is summed over the ranks (module
    docstring); ``over_data`` as ``route``'s."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.num_experts_per_tok, m.num_experts
    routed = tp is not None and (tp.experts or tp.expert_mlp)
    if tp is not None and (routed or tp.router or tp.shared_mlp):
        # the split regions (the router's columns, the routed experts, the
        # shared expert's d_ff) read the input through one entry; a part
        # that every rank runs whole reads it as it is (region_reads)
        xs = tp.enter(x, True)
        pick = {True: xs, False: x}
    else:
        pick = {False: x}
    topk_idx, topk_w, aux = route(
        params, cfg, pick[tp is not None and tp.router].reshape(b * s, d),
        tp, over_data)
    if routed:
        # the combine weights are replicated; each rank weighs its part
        topk_w = tp.enter(topk_w, True)
    cap = capacity(s, k, e, capacity_factor)
    keep, target = dispatch(topk_idx, b, s, e, cap)
    # this rank's experts: a run of ``count`` from ``first`` (all of them
    # without a mesh, or where d_ff splits inside every expert)
    first, count = (0, e) if tp is None else tp.expert_range

    # the source pair of each expert slot (sentinel S*k: an empty slot);
    # ``repro`` scatters into E*C + 1 columns and slices the last one off
    pairs = torch.arange(s * k, device=x.device).expand(b, s * k)
    src = torch.full((b, e * cap + 1), s * k, dtype=torch.int64,
                     device=x.device)
    src.scatter_(1, target, pairs)
    src = src[:, first * cap:(first + count) * cap]          # (B, E'*C)
    src_tok = torch.where(src >= s * k, torch.full_like(src, s),
                          torch.clamp(src, 0, s * k - 1) // k)
    xr = pick[routed]
    x_pad = torch.cat([xr, xr.new_zeros((b, 1, d))], dim=1)  # row S: zeros
    ye = _experts(x_pad, src_tok, b, count, cap, params, tp)
    ye = ye.reshape(count, b, cap, d).transpose(0, 1).reshape(
        b, count * cap, d)

    # combine: gather back in (token, choice) order, weight, sum over k.
    # ``repro`` gathers a dropped pair from an appended zero row; here it
    # reads any row and its weight is zeroed, which gives the same 0; so
    # does a pair whose expert lives on another rank
    col = target - first * cap
    gathered = torch.gather(ye, 1, torch.clamp(col, 0, count * cap - 1)[
        ..., None].expand(b, s * k, d))
    w = topk_w.reshape(b, s * k) * keep
    if count != e:
        w = w * ((col >= 0) & (col < count * cap))
    y = (gathered * w[..., None].to(x.dtype)).reshape(b, s, k, d).sum(dim=2)

    ys = None
    if m.num_shared_experts > 0:
        sp = params["shared"]
        xsh = pick[tp is not None and tp.shared_mlp].reshape(b * s, d)
        gs, us = project(xsh, [sp["w_gate"], sp["w_up"]], tp,
                         tp is not None and tp.data_proj)
        hs = F.silu(gs.float()).to(x.dtype) * us
        ys = (hs @ sp["w_down"]).reshape(b, s, d)
    if tp is None:
        return (y if ys is None else y + ys), aux
    # one f32 sum over the ranks of every split partial; a part that is
    # whole on every rank joins after it. On a mesh of one this is
    # ``tp=None``'s arithmetic: the bf16 sum of two values is their f32
    # sum rounded once
    if tp.data_experts:
        # the routed partial is this rank's experts': one sum over the
        # mesh, which the shared partial (a model sum, equal on every data
        # rank) joins from data rank 0 alone; a whole shared part after it
        out = y.float()
        if ys is not None and tp.shared_mlp and tp.data_rank == 0:
            out = out + ys.float()
        out = tp.mesh.all_reduce(out, axis="world").to(x.dtype)
        if ys is not None and not tp.shared_mlp:
            out = out + ys
        return out, aux
    parts = [(y, tp.experts or tp.expert_mlp)]
    if ys is not None:
        parts.append((ys, tp.shared_mlp))
    split = [p.float() for p, cut in parts if cut]
    whole = [p for p, cut in parts if not cut]
    out = None
    if split:
        out = tp.reduce(sum(split[1:], split[0]), True).to(x.dtype)
    for p in whole:
        out = p if out is None else out + p
    return out, aux


def dropped_pairs(params, cfg, x, *, capacity_factor: float = 1.25,
                  length=None, tp=None) -> torch.Tensor:
    """How many (token, choice) pairs ``moe_forward`` drops on ``x``
    (B, S, D), counting only each row's first ``length`` tokens when given
    ((B,) or an int; right-pad tokens come last in the cumulative count,
    so they never take a real token's slot). A 0-dim int64 tensor, the
    same on every rank of a mesh (``tp``)."""
    m = cfg.moe
    b, s, _ = x.shape
    k, e = m.num_experts_per_tok, m.num_experts
    topk_idx, _, _ = route(params, cfg, x.reshape(b * s, -1), tp)
    keep, _ = dispatch(topk_idx, b, s, e,
                       capacity(s, k, e, capacity_factor))
    real = torch.ones((b, s), dtype=torch.bool, device=x.device)
    if length is not None:
        n = torch.as_tensor(length, device=x.device).reshape(-1, 1)
        real = torch.arange(s, device=x.device)[None, :] < n
    real = real[:, :, None].expand(b, s, k).reshape(b, s * k)
    return (real & ~keep).sum()
