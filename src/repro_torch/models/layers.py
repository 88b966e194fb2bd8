"""Core layers: RMSNorm, SwiGLU, GeGLU, embeddings, RoPE, soft-capping.

Port of ``repro.models.layers`` with the same numerics: norms and the
SwiGLU and GeGLU gates run in float32 and cast back, RoPE angles are
float32.

On a mesh (``tp``, a ``sharding.TensorParallel``) the layers take this
rank's shards and end each split with its collective, Megatron-style:
the MLPs are column-parallel in ``w_gate``/``w_up`` (a d_ff slice) and
row-parallel in ``w_down``, whose partial sums are all-reduced in f32;
the embedding is vocab-parallel (a masked lookup of this rank's rows,
then an all-reduce) and the unembedding gathers each rank's logits over
the vocab. Where the mesh's data axis splits d_model's contraction side
(``tp.data_proj``, ``tp.data_table``), an input projection multiplies
this rank's columns of the replicated activation by its rows and sums
the partials over 'data' in one f32 all-reduce (``project``); the
embedding's D/data columns are joined into the whole row, and the
unembedding's partial logits summed over 'data' before the vocab gather.
Every collective is ``launch.mesh``'s differentiable one, and each split
region starts with ``tp.enter`` (the identity, whose backward sums the
ranks' partial gradients of its replicated input), so a loss on a mesh
differentiates as on one device (training on a model axis above 1).
``tp=None`` is the one-device code, unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(params, x, eps: float):
    """(1+scale) RMSNorm computed in f32 (Gemma-style zero-centred scale)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + params["scale"].float())
    return y.to(dtype)


def norm_only(x, eps: float):
    """Scale-free RMS normalization (used by qk-norm)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype)


def project(x, ws, tp=None, split: bool = False):
    """``[x @ w for w in ws]``; on a mesh whose data axis splits the
    weights' rows (``split``), one reduction of the partials over 'data'
    (``sharding.TensorParallel.project``)."""
    if tp is None or not split:
        return [x @ w for w in ws]
    return tp.project(x, ws, True)


def mlp_region_reads(names, tp) -> set:
    """Which of a dense MLP's leaves (``names``) a rank reads inside its
    region split over 'model': all of them when d_ff splits (the region
    starts at ``_gate_up``), as ``attention.region_reads``."""
    return set(names) if tp.mlp else set()


def _gate_up(params, x, tp):
    if tp is not None:
        x = tp.enter(x, tp.mlp)          # the region of mlp_region_reads
    return project(x, [params["w_gate"], params["w_up"]], tp,
                   tp is not None and tp.data_proj)


def swiglu(params, x, tp=None):
    g, u = _gate_up(params, x, tp)
    h = F.silu(g.float()).to(x.dtype) * u
    y = h @ params["w_down"]
    return y if tp is None else tp.reduce(y, tp.mlp)


def gelu_mlp(params, x, tp=None):
    """GeGLU: the tanh-approximate GELU of the gate in f32, cast back, times
    the up projection, then projected down."""
    g, u = _gate_up(params, x, tp)
    h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    y = h @ params["w_down"]
    return y if tp is None else tp.reduce(y, tp.mlp)


def embed(params, tokens, tp=None):
    table = params["table"]
    if tp is None or not (tp.vocab or tp.data_table):
        return table[tokens]
    if not tp.vocab:
        return join_rows(table[tokens], tp)
    # vocab-parallel: this rank holds rows [rank * V/N, (rank + 1) * V/N)
    rows = table.shape[0]
    local = tokens.long() - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return join_rows(x, tp)


def join_rows(x, tp):
    """Embedding rows looked up on a mesh into the whole replicated rows:
    ``x`` holds this rank's vocab rows (zero where another rank owns the
    token, when ``tp.vocab``) and, with ``tp.data_table``, its D/data
    columns of them. Model-split rows are summed over 'model'; data-split
    columns are placed at this rank's offset of a zero row and summed
    over the whole mesh at once (exact: each element has one nonzero
    term), or gathered over 'data' where the vocab is whole."""
    if not tp.data_table:
        return tp.reduce(x, tp.vocab)
    if not tp.vocab:
        return tp.gather(x, -1, axis="data")
    w = x.shape[-1]
    full = x.new_zeros(x.shape[:-1] + (w * tp.data_ways,))
    full.narrow(-1, tp.data_rank * w, w).copy_(x)
    return tp.reduce(full, True, axis="world")


def unembed(table, x, tp=None, local: bool = False):
    """x (..., D) @ table^T (V, D) -> (..., V) logits (on a mesh, each
    rank's vocab slice gathered; a data-split D summed over 'data'
    first). ``local``: this rank's vocab slice alone, ungathered (the
    vocab-parallel loss's input)."""
    if tp is not None:
        x = tp.enter(x, tp.vocab)
    logits, = project(x, [table.t()], tp, tp is not None and tp.data_table)
    if tp is None or not tp.vocab or local:
        return logits
    return tp.gather(logits, -1)


def rope(x, positions, theta: float):
    """Apply RoPE. x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq          # (..., S, half)
    if x.dim() == angles.dim() + 1:                       # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float):
    """Gemma-style logit soft-capping; no-op when cap == 0."""
    if cap and cap > 0:
        return (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
    return logits
