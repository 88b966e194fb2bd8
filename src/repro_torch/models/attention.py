"""Attention mixers: GQA (projections with qk-norm and RoPE) and DeepSeek's
multi-head latent attention (MLA), each with full-sequence prefill through
the flash kernel, cached decode through a cache layout (ring or paged),
and its per-layer cache. Port of ``repro.models.attention``.

On a mesh (``tp``, a ``sharding.TensorParallel``) the GQA mixer runs this
rank's shards: its query heads and its KV heads (all of them where the KV
heads do not split), then ``wo``'s partial sums all-reduced in f32. Where
its query heads share KV heads that every rank keeps whole (glm4-9b's 2
over 4 ranks), they attend ``tp.kv_range``: the kernels read that range of
the cache in place; prefill hands the flash kernel a copy of it. Where
the mesh's data axis splits d_model's contraction side, the input
projections (GQA's ``wq``/``wk``/``wv``, MLA's ``w_dq``/``w_dkv``/
``w_krope``) are one joined reduction over 'data' (``layers.project``).

``repro`` prefills through the jnp ``blockwise_attention`` on arange
positions; the port calls ``kernels.flash_attention``, which computes the
same function (causal or windowed, keys and queries both at 0..S-1). MLA
prefills in the expanded form (128 heads of 192 dims, V zero-padded from
128 to 192) through the same kernel; its decode is the absorbed form over
the compressed latent cache in plain torch, as ``repro``'s is jnp.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models.layers import norm_only, project, rmsnorm, rope


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


def _fill(cache: dict, updates: dict, lengths=None) -> dict:
    """Populate a fresh cache from a prefill's per-token leaves ``updates``
    ({name: (B, S, ...)}), in place: token ``t`` at ring column ``t %
    width``. ``lengths``: optional (B,) true prompt lengths; positions >=
    length are right-pad and never occupy a ring slot. Every path has
    shapes fixed by B, S and the ring width."""
    first = next(iter(updates.values()))
    width = cache["pos"].shape[1]
    b, s, device = first.shape[0], first.shape[1], first.device

    def mask(keep, u):
        return keep.reshape(keep.shape + (1,) * (u.dim() - 2))

    if lengths is None and s <= width:
        for key, u in updates.items():
            cache[key][:, :s] = u
        cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32,
                                           device=device)[None, :]
        return cache
    if s <= width:
        # slots t % width = t are distinct: a masked copy of the first S
        for key in updates:
            cache[key].zero_()
        cache["pos"].fill_(-1)
        t = torch.arange(s, dtype=torch.int32, device=device)[None, :]
        keep = t < lengths.to(device=device, dtype=torch.int32).reshape(b, 1)
        for key, u in updates.items():
            cache[key][:, :s] = torch.where(mask(keep, u), u,
                                            torch.zeros_like(u))
        cache["pos"][:, :s] = torch.where(keep, t, torch.full_like(t, -1))
        return cache
    src, keep = _fill_slots(width, b, s, lengths, device)
    rows = torch.arange(b, device=device)[:, None]
    for key, u in updates.items():
        kept = u[rows, src]                               # (B, W, ...)
        cache[key].copy_(torch.where(mask(keep, kept), kept,
                                     torch.zeros_like(kept)))
    cache["pos"].copy_(torch.where(keep, src.to(torch.int32),
                                   torch.full_like(cache["pos"], -1)))
    return cache


def cache_fill(cache: dict, k, v, seq_len: int, lengths=None) -> dict:
    """Populate a fresh GQA cache from prefill outputs k, v (B, S, KV, hd),
    in place (``_fill``)."""
    return _fill(cache, {"k": k, "v": v}, lengths)


def _proj(x, w):
    """x (B, S, D) @ w (D, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def _projs(x, ws, tp):
    """x (B, S, D) @ each w (D, ...) -> (B, S, ...), one reduction over
    'data' for all of them where the mesh ``tp`` splits D there."""
    outs = project(x, [w.reshape(w.shape[0], -1) for w in ws], tp,
                   tp is not None and tp.data_proj)
    return [o.reshape(*x.shape[:-1], *w.shape[1:]) for o, w in zip(outs, ws)]


def region_reads(names, tp, mla: bool = False) -> set:
    """Which of an attention mixer's leaves (``names``) a rank reads inside
    its region split over 'model': all of them when the heads split, for
    the region starts at the mixer's input (``tp.enter`` in ``_qkv`` and
    ``mla_forward``). One that the rules keep whole there (a wk/wv over KV
    heads that do not divide, of which a rank reads its ``kv_range``; the
    q/k norm scales; MLA's down-projections and latent norms) gets a
    partial gradient on each rank (``training.train_loop.
    partial_leaves``)."""
    return set(names) if (tp.mla_heads if mla else tp.heads) else set()


def _qkv(params, cfg, x, positions, tp=None):
    if tp is not None:
        x = tp.enter(x, tp.heads)        # the heads' region (region_reads)
    q, k, v = _projs(x, [params["wq"], params["wk"], params["wv"]], tp)
    if cfg.use_qk_norm:
        q = norm_only(q, cfg.rms_eps) * (1.0 + params["q_scale"]).to(q.dtype)
        k = norm_only(k, cfg.rms_eps) * (1.0 + params["k_scale"]).to(k.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(out, wo, tp=None, mla: bool = False):
    """out (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D), summed over the
    ranks where the heads (of attention, or with ``mla`` of MLA) split."""
    h, hd, d = wo.shape
    y = out.reshape(*out.shape[:-2], h * hd) @ wo.reshape(h * hd, d)
    if tp is None:
        return y
    return tp.reduce(y, tp.mla_heads if mla else tp.heads)


def _kv_range(tp, kv: int):
    """The KV heads this rank's queries attend, or None for all ``kv``."""
    if tp is None or tp.kv_range == (0, kv):
        return None
    return tp.kv_range


def attn_forward(params, cfg, x, positions, *, window: Optional[int],
                 tp=None):
    """Full-sequence causal attention (prefill). x: (B, S, D); positions:
    (B, S), the arange 0..S-1 of every full-sequence call. Returns the
    output and this rank's (k, v) for the cache."""
    q, k, v = _qkv(params, cfg, x, positions, tp)
    kq, vq = k, v
    rng = _kv_range(tp, k.shape[2])
    if rng is not None:
        kq = k[:, :, rng[0]:rng[0] + rng[1]].contiguous()
        vq = v[:, :, rng[0]:rng[0] + rng[1]].contiguous()
    out = flash_attention(q, kq, vq, causal=True, window=window,
                          scale=cfg.resolved_head_dim ** -0.5)
    return _out(out, params["wo"], tp), (k, v)


def attn_decode(params, cfg, x, cache, cur_pos, *, window: Optional[int],
                layout=None, block_tables=None, valid=None, tp=None):
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
    q, k1, v1 = _qkv(params, cfg, x, positions, tp)
    cache = layout.append(cache, {"k": k1, "v": v1}, start, block_tables,
                          valid=valid)
    out = layout.attend(q, cache, positions, block_tables, window=window,
                        scale=cfg.resolved_head_dim ** -0.5,
                        kv_range=_kv_range(tp, k1.shape[2]))
    return _out(out, params["wo"], tp), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_downs(params, x, tp=None):
    """The down-projections of x: (x @ w_dq, x @ w_dkv, x @ w_krope), one
    reduction over 'data' where the mesh ``tp`` splits D there."""
    return _projs(x, [params["w_dq"], params["w_dkv"], params["w_krope"]],
                  tp)


def _mla_q(params, cfg, dq, positions):
    """Queries through the low-rank path from ``dq = x @ w_dq``:
    (q_nope, q_rope), (B, S, H, *)."""
    m = cfg.mla
    cq = rmsnorm({"scale": params["q_norm"]}, dq, cfg.rms_eps)
    q = _proj(cq, params["w_uq"])
    q_rope = rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_kv_latent(params, cfg, dkv, kr, positions):
    """The compressed cache entries from ``dkv = x @ w_dkv`` and ``kr = x
    @ w_krope``: ckv (B, S, kv_lora) and the shared rotary key krope
    (B, S, rope)."""
    ckv = rmsnorm({"scale": params["kv_norm"]}, dkv, cfg.rms_eps)
    krope = rope(kr, positions, cfg.rope_theta)
    return ckv, krope


def mla_forward(params, cfg, x, positions, *, window: Optional[int],
                tp=None):
    """Expanded-form MLA (prefill) through the flash kernel: q = [q_nope,
    q_rope], k = [k_nope, krope broadcast to every head], H = KV (G = 1),
    V zero-padded to the qk width as ``repro`` pads it, scale qk^-0.5, the
    output cut back to ``v_head_dim``. Returns (y, (ckv, krope)). On a
    mesh (``tp``) the heads are this rank's (``w_uq``, ``w_uk``, ``w_uv``,
    ``wo`` split), the latents whole, and y is summed over the ranks."""
    m = cfg.mla
    h = params["w_uk"].shape[1]                 # this rank's heads
    if tp is not None:
        x = tp.enter(x, tp.mla_heads)    # the heads' region (region_reads)
    dq, dkv, kr = _mla_downs(params, x, tp)
    q_nope, q_rope = _mla_q(params, cfg, dq, positions)
    ckv, krope = _mla_kv_latent(params, cfg, dkv, kr, positions)
    k_nope = _proj(ckv, params["w_uk"])
    v = _proj(ckv, params["w_uv"])
    k_rope = krope[:, :, None, :].expand(-1, -1, h, -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    vpad = F.pad(v, (0, qk - m.v_head_dim))
    out = flash_attention(q, k, vpad, causal=True, window=window,
                          scale=qk ** -0.5)
    return _out(out[..., :m.v_head_dim], params["wo"], tp, mla=True), \
        (ckv, krope)


def init_mla_cache(cfg, batch: int, width: int, dtype, device) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, width, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, width, m.qk_rope_head_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((batch, width), -1, dtype=torch.int32,
                          device=device),
    }


def mla_cache_fill(cache: dict, ckv, krope, seq_len: int,
                   lengths=None) -> dict:
    """Populate a fresh MLA cache from prefill latents ckv (B, S, r) and
    krope (B, S, rope), in place (``_fill``)."""
    return _fill(cache, {"ckv": ckv, "krope": krope}, lengths)


def mla_decode(params, cfg, x, cache, cur_pos, *, window: Optional[int],
               layout=None, block_tables=None, valid=None, tp=None):
    """Absorbed-form MLA step: one decode token or a T-token chunk from
    ``cur_pos``. W_uk is folded into the query and W_uv applied after the
    attend, so scores and values stay in the latent space and the cache
    keeps only (ckv, krope) a token. The attend runs over
    ``layout.context`` (the ring itself, or a block-table gather on the
    paged layout): MQA over a (kv_lora + rope)-wide key, with f32 scores
    and accumulation. ``valid``: optional (B, T) write mask. On a mesh
    (``tp``) the heads are this rank's and the latent cache whole, as in
    ``mla_forward``."""
    layout = _ring_layout() if layout is None else layout
    m = cfg.mla
    b, t = x.shape[0], x.shape[1]
    start = positions_1d(cur_pos, b, x.device)
    positions = start[:, None] + torch.arange(t, dtype=torch.int32,
                                              device=x.device)[None, :]
    dq, dkv, kr = _mla_downs(params, x, tp)
    q_nope, q_rope = _mla_q(params, cfg, dq, positions)        # (B,T,H,*)
    ckv1, krope1 = _mla_kv_latent(params, cfg, dkv, kr, positions)
    cache = layout.append(cache, {"ckv": ckv1, "krope": krope1}, start,
                          block_tables, valid=valid)
    ctx = layout.context(cache, block_tables)
    ckv_c = ctx["ckv"].to(x.dtype)
    krope_c = ctx["krope"].to(x.dtype)
    pos_c = ctx["pos"]
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope, params["w_uk"])
    s_nope = torch.einsum("bthr,bcr->bthc", q_lat.float(), ckv_c.float())
    s_rope = torch.einsum("bthk,bck->bthc", q_rope.float(), krope_c.float())
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = (s_nope + s_rope) * (qk ** -0.5)
    ok = (pos_c[:, None, :] <= positions[:, :, None]) \
        & (pos_c[:, None, :] >= 0)
    if window is not None:
        ok &= pos_c[:, None, :] > (positions[:, :, None] - window)
    s = torch.where(ok[:, :, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bthc,bcr->bthr", p.to(ckv_c.dtype).float(),
                         ckv_c.float())
    out = torch.einsum("bthr,rhk->bthk", o_lat.to(x.dtype), params["w_uv"])
    return _out(out, params["wo"], tp, mla=True), cache
