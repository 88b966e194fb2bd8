"""GQA attention: projections with qk-norm and RoPE, full-sequence prefill
through the flash kernel, cached decode through the ring layout, and the
per-layer KV cache. Port of the GQA half of ``repro.models.attention``
(MLA is a later slice).

``repro`` prefills through the jnp ``blockwise_attention`` on arange
positions; the port calls ``kernels.flash_attention``, which computes the
same function (causal or windowed, keys and queries both at 0..S-1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import norm_only, rope


def _ring_layout():
    """The default cache layout, imported lazily: ``serving.kv_cache``
    sits above the models in the import graph."""
    from repro_torch.serving.kv_cache import RING
    return RING


def init_kv_cache(batch: int, width: int, kv_heads: int, head_dim: int,
                  dtype, device) -> dict:
    return {
        "k": torch.zeros((batch, width, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, width, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, width), -1, dtype=torch.int32,
                          device=device),
    }


def positions_1d(cur_pos, batch: int, device) -> torch.Tensor:
    """Normalize a scalar-or-(B,) position to a (B,) int32 tensor."""
    if isinstance(cur_pos, torch.Tensor):
        return cur_pos.to(device=device, dtype=torch.int32).reshape(
            -1).expand(batch).contiguous()
    return torch.full((batch,), int(cur_pos), dtype=torch.int32,
                      device=device)


def _fill_slots(width: int, b: int, s: int, lengths, device):
    """Ring-fill bookkeeping: each row keeps its trailing ``width`` real
    positions ``[length - width, length)`` at ring index ``t % width``;
    right-pads and evicted tokens are not kept. ``repro`` scatters every
    token to ``t % width`` and routes the rest to the out-of-bounds index
    ``width``, which the scatter drops; the port gathers instead, at a
    shape fixed by B and W (a CUDA graph captures no data-dependent
    shape): ring column ``j`` takes the last ``t < length`` with ``t % width
    == j``, or stays empty. Returns (src (B, W) int64: the position each
    column takes, 0 where it stays empty; keep (B, W) bool)."""
    j = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    if lengths is None:
        length = torch.full((b, 1), s, dtype=torch.int64, device=device)
    else:
        length = lengths.to(device=device, dtype=torch.int64).reshape(b, 1)
    back = length - 1 - j                # >= 0 iff column j holds a token
    keep = back >= 0
    src = j + width * torch.div(back.clamp_min(0), width,
                                rounding_mode="floor")
    return torch.where(keep, src, torch.zeros_like(src)), keep


def cache_fill(cache: dict, k, v, seq_len: int, lengths=None) -> dict:
    """Populate a fresh cache from prefill outputs k, v (B, S, KV, hd), in
    place. ``lengths``: optional (B,) true prompt lengths; positions >=
    length are right-pad and never occupy a ring slot. Every path has
    shapes fixed by B, S and the ring width."""
    width = cache["k"].shape[1]
    b, s = k.shape[0], k.shape[1]
    if lengths is None and s <= width:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32,
                                           device=k.device)[None, :]
        return cache
    if s <= width:
        # slots t % width = t are distinct: a masked copy of the first S
        cache["k"].zero_()
        cache["v"].zero_()
        cache["pos"].fill_(-1)
        t = torch.arange(s, dtype=torch.int32, device=k.device)[None, :]
        keep = t < lengths.to(device=k.device,
                              dtype=torch.int32).reshape(b, 1)
        m = keep[:, :, None, None]
        cache["k"][:, :s] = torch.where(m, k, torch.zeros_like(k))
        cache["v"][:, :s] = torch.where(m, v, torch.zeros_like(v))
        cache["pos"][:, :s] = torch.where(keep, t, torch.full_like(t, -1))
        return cache
    src, keep = _fill_slots(width, b, s, lengths, k.device)
    rows = torch.arange(b, device=k.device)[:, None]
    m = keep[:, :, None, None]
    kk, vv = k[rows, src], v[rows, src]                  # (B, W, KV, hd)
    cache["k"].copy_(torch.where(m, kk, torch.zeros_like(kk)))
    cache["v"].copy_(torch.where(m, vv, torch.zeros_like(vv)))
    cache["pos"].copy_(torch.where(keep, src.to(torch.int32),
                                   torch.full_like(cache["pos"], -1)))
    return cache


def _proj(x, w):
    """x (B, S, D) @ w (D, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def _qkv(params, cfg, x, positions):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.use_qk_norm:
        q = norm_only(q, cfg.rms_eps) * (1.0 + params["q_scale"]).to(q.dtype)
        k = norm_only(k, cfg.rms_eps) * (1.0 + params["k_scale"]).to(k.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(out, wo):
    """out (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D)."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def attn_forward(params, cfg, x, positions, *, window: Optional[int]):
    """Full-sequence causal attention (prefill). x: (B, S, D); positions:
    (B, S), the arange 0..S-1 of every full-sequence call."""
    q, k, v = _qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True, window=window,
                          scale=cfg.resolved_head_dim ** -0.5)
    return _out(out, params["wo"]), (k, v)


def attn_decode(params, cfg, x, cache, cur_pos, *, window: Optional[int],
                layout=None, block_tables=None, valid=None):
    """Cached-attention step: one decode token or a T-token prompt chunk.
    x: (B, T, D); ``cur_pos``: scalar or (B,) start positions (token i at
    ``cur_pos + i``); ``valid``: optional (B, T) write mask. The chunk's
    K/V are appended before attending, so intra-chunk causality is
    position masking. The layout updates ``cache`` in place."""
    layout = _ring_layout() if layout is None else layout
    b, t = x.shape[0], x.shape[1]
    start = positions_1d(cur_pos, b, x.device)
    positions = start[:, None] + torch.arange(t, dtype=torch.int32,
                                              device=x.device)[None, :]
    q, k1, v1 = _qkv(params, cfg, x, positions)
    cache = layout.append(cache, {"k": k1, "v": v1}, start, block_tables,
                          valid=valid)
    out = layout.attend(q, cache, positions, block_tables, window=window,
                        scale=cfg.resolved_head_dim ** -0.5)
    return _out(out, params["wo"]), cache
