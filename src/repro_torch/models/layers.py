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
the vocab. ``tp=None`` is the one-device code, unchanged.
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


def swiglu(params, x, tp=None):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    y = h @ params["w_down"]
    return y if tp is None else tp.reduce(y, tp.mlp)


def gelu_mlp(params, x, tp=None):
    """GeGLU: the tanh-approximate GELU of the gate in f32, cast back, times
    the up projection, then projected down."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    y = h @ params["w_down"]
    return y if tp is None else tp.reduce(y, tp.mlp)


def embed(params, tokens, tp=None):
    table = params["table"]
    if tp is None or not tp.vocab:
        return table[tokens]
    # vocab-parallel: this rank holds rows [rank * V/N, (rank + 1) * V/N)
    rows = table.shape[0]
    local = tokens.long() - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return tp.reduce(x, True)


def unembed(table, x, tp=None):
    """x (..., D) @ table^T (V, D) -> (..., V) logits (on a mesh, each
    rank's vocab slice gathered)."""
    logits = x @ table.t()
    if tp is None or not tp.vocab:
        return logits
    return tp.mesh.gather(logits, -1)


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
