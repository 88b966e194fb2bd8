"""Core layers: RMSNorm, SwiGLU, GeGLU, embeddings, RoPE, soft-capping.

Port of ``repro.models.layers`` with the same numerics: norms and the
SwiGLU and GeGLU gates run in float32 and cast back, RoPE angles are
float32.
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


def swiglu(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def gelu_mlp(params, x):
    """GeGLU: the tanh-approximate GELU of the gate in f32, cast back, times
    the up projection, then projected down."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    return h @ params["w_down"]


def embed(params, tokens):
    return params["table"][tokens]


def unembed(table, x):
    """x (..., D) @ table^T (V, D) -> (..., V) logits."""
    return x @ table.t()


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
