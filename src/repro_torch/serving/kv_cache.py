"""KV-cache layout and backend for the serving engine (ring only).

Port of the ring half of ``repro.serving.kv_cache``. ``RingLayout`` is
what the model programs against (``append`` writes a chunk's K/V into a
layer's ring, ``attend`` runs the decode-attention kernel over it,
``context`` is the per-slot view); ``RingCache`` is what the engine owns
(device cache state, slot install at admission, accounting).

Where ``repro`` returns new cache arrays (and the engine donates the old
buffers to XLA), the port updates the cache tensors in place: an append
writes one token per slot into the existing ring, an admission copies the
prefilled line into its slot. The returned dicts alias the inputs.

The paged backend (block-table pool, prefix sharing, swap) is the next
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models.attention import positions_1d


def _chunk_index(cur_pos, updates, valid, batch: int, device):
    """Per-token positions (B, T) of a chunk starting at ``cur_pos`` plus
    the write mask (True = real token)."""
    t = next(iter(updates.values())).shape[1]
    start = positions_1d(cur_pos, batch, device)
    pos = start[:, None] + torch.arange(t, dtype=torch.int32,
                                        device=device)[None, :]
    if valid is None:
        ok = torch.ones((batch, t), dtype=torch.bool, device=device)
    else:
        ok = valid.to(device=device, dtype=torch.bool).expand(batch, t)
    return start, pos, ok


@dataclasses.dataclass(frozen=True)
class RingLayout:
    """Per-slot ring: cache tensors are (B, W, ...); the token at position
    ``p`` lives at slot ``p % W`` and ``pos`` records which position each
    slot holds (-1 = empty)."""

    def append(self, cache: Dict[str, torch.Tensor], updates, cur_pos,
               block_tables=None, valid=None) -> Dict[str, torch.Tensor]:
        """Write a T-token chunk (T = 1 for decode) at positions
        ``cur_pos + i``, in place. Invalid tokens leave the cache
        untouched; when a chunk is longer than the ring only each slot's
        newest token is kept. ``repro`` drops the rest by scattering them
        to the out-of-bounds index ``width``; here they are masked: with
        T <= W every token has its own slot and a dropped token writes the
        slot's old contents back, else the kept tokens are selected."""
        b, width = cache["pos"].shape
        device = cache["pos"].device
        start, pos, ok = _chunk_index(cur_pos, updates, valid, b, device)
        t = pos.shape[1]
        length = ok.sum(dim=1, keepdim=True, dtype=torch.int32)
        keep = ok & (pos + width > start[:, None] + length - 1)
        slot = (pos % width).long()
        rows = torch.arange(b, device=device)[:, None].expand(b, t)
        if t <= width:
            for key, u in updates.items():
                old = cache[key][rows, slot]
                m = keep.reshape(b, t, *([1] * (u.dim() - 2)))
                cache[key][rows, slot] = torch.where(
                    m, u.to(cache[key].dtype), old)
            cache["pos"][rows, slot] = torch.where(
                keep, pos, cache["pos"][rows, slot])
            return cache
        r, s = rows[keep], slot[keep]
        for key, u in updates.items():
            cache[key][r, s] = u[keep].to(cache[key].dtype)
        cache["pos"][r, s] = pos[keep]
        return cache

    def attend(self, q, cache, q_pos, block_tables=None, *,
               window: Optional[int], scale: float):
        return decode_attention(q, cache["k"], cache["v"], q_pos,
                                cache["pos"], window=window, scale=scale)

    def context(self, cache, block_tables=None) -> Dict[str, torch.Tensor]:
        """Per-slot contiguous view (identity for the ring)."""
        return cache


RING = RingLayout()


def _install(dst, src, slot: int) -> None:
    """Copy each (L, 1, W, ...) tensor of ``src`` into slot ``slot`` of the
    matching (L, B, W, ...) tensor of ``dst`` (the model's cache nesting:
    list of stages -> tuple of blocks -> dict of stacked tensors)."""
    if isinstance(dst, dict):
        for key, g in dst.items():
            g[:, slot].copy_(src[key][:, 0])
        return
    for d, s in zip(dst, src):
        _install(d, s, slot)


class RingCache:
    """Every slot owns a full ``max_seq_len``-wide line (or a window-wide
    one for windowed layers) in each layer's ring."""

    def __init__(self, lm, *, batch_slots: int, max_seq_len: int):
        self.layout = RING
        self.lm = lm
        self.batch_slots = batch_slots
        self.max_seq_len = max_seq_len

    def init(self) -> Dict[str, Any]:
        return {"caches": self.lm.init_cache(self.batch_slots,
                                             self.max_seq_len),
                "tables": None}

    def can_admit(self, prompt, max_new: int) -> bool:
        return True                       # a granted slot is the only gate

    def alloc_slot(self, slot, prompt, max_new) -> np.ndarray:
        return np.zeros((1,), np.int32)   # no tables: fixed dummy row

    def prefill_fill(self, cache_state, one_caches, slot, length, table_row):
        """Copy a single-request prefilled cache into ``slot`` of the
        engine's caches, in place."""
        _install(cache_state["caches"], one_caches, slot)
        return cache_state

    def free_slot(self, cache_state, slot):
        return cache_state                # rings are reused in place


def make_backend(kind, lm, *, batch_slots: int, max_seq_len: int):
    if isinstance(kind, RingCache):
        return kind
    if kind == "ring":
        return RingCache(lm, batch_slots=batch_slots,
                         max_seq_len=max_seq_len)
    if kind == "paged":
        raise NotImplementedError(
            "the paged KV backend (block tables, paged_decode_attention, "
            "prefix sharing, swap) is the next slice of the port; use "
            "cache_backend='ring'")
    raise ValueError(f"unknown cache backend {kind!r} "
                     "(expected 'ring' or 'paged')")
