"""KV-cache layouts and backends for the serving engine.

Port of ``repro.serving.kv_cache``. The seam has two levels:

**Layouts** (``RingLayout`` / ``PagedLayout``) are what the *model*
programs against: ``append`` writes a chunk's K/V into a layer's cache,
``attend`` runs cached attention over it (the ring or the paged kernel),
``context`` is a per-slot contiguous view.

**Backends** (``RingCache`` / ``PagedCache``) are what the *engine* owns:
device cache state, slot admission (``alloc_slot`` -> ``prefill_fill``, or
``begin_slot`` plus chunks through ``slot_view``/``slot_update``),
completion (``free_slot``) and accounting. ``PagedCache`` is vLLM-style:
one global pool of fixed-size blocks per layer plus a per-slot block table,
a host-side allocator that commits each request's worst case at admission
and draws blocks lazily (``reserve_lookahead`` before each K-step decode
round), a refcounted prefix index with copy-on-write and retained blocks,
and swap preemption to host memory.

Paged conventions (shared with the kernel and the plain version): pool
block 0 is a trash block, never allocated, where writes of free slots and
pad tokens land with position -1; table entries are block ids >= 1 or -1;
a pool position is -1 until written.

Where ``repro`` returns new cache arrays (and the engine donates the old
buffers to XLA), the port updates the cache tensors in place and the
returned dicts alias the inputs. ``repro`` drops writes by scattering them
out of bounds, which JAX ignores; ``index_put_`` raises there, so the port
masks them explicitly. What ``repro`` keeps only for XLA compiles
(``warm_swap``) is not ported here.

On a mesh (``note_placement``, before ``init``) a backend's device state
is this rank's shard: each K/V leaf holds its KV heads when they split,
each recurrent state its channels or heads (``serving.sharding``'s
``SPLIT_DIMS``), and the byte accounting has ``repro``'s
per-device walkers (``kv_shards``, ``hbm_bytes_per_device``,
``block_bytes_per_device``). The allocator, the tables and the positions
are the same on every rank. A swap keeps each rank's own shard on its
host; a slot checkpoint leaves in the host-global wire format
(``wire_caches`` gathers the KV heads) and comes back as this rank's
shard (``local_wire``).

A slot's K/V checkpoint crosses a process boundary in ``repro``'s wire
format (``PagedCache.checkpoint_slot``, ``wire_caches``): the cache tree
restricted to the slot's table row padded to ``blocks_per_slot`` blocks,
(L, M, block_size, ...) per leaf, ``n_blocks`` of them real. ``swap_in``
takes that padded row or ``swap_out``'s unpadded one.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  gather_paged_kv,
                                                  paged_decode_attention)
from repro_torch.models.attention import positions_1d
from repro_torch.serving.sharding import (block_mixer, model_axis_size,
                                          shard_divisor, split_dims)


def _map_block_dicts(fn, tree, other=None):
    """Apply ``fn`` at each per-block cache dict (every dict of the tree:
    its leaves are (L, B, ...) tensors), keeping the model's list/tuple
    nesting around them. Which mixers a backend may hold is its
    constructor's check."""
    if isinstance(tree, dict):
        return fn(tree) if other is None else fn(tree, other)
    if isinstance(tree, (list, tuple)):
        if other is None:
            sub = [_map_block_dicts(fn, x) for x in tree]
        else:
            sub = [_map_block_dicts(fn, x, y) for x, y in zip(tree, other)]
        return type(tree)(sub)
    raise NotImplementedError(f"unsupported cache node: {type(tree)}")


def _leaves(tree):
    """The tensors (or (shape, dtype) protos) of a cache tree with their
    dict key, in order."""
    out = []
    _map_block_dicts(lambda d: out.extend(d.items()), tree)
    return out


def _split_leaves(tree):
    """(key, leaf, split dim or None, block mixer) of every leaf of a
    cache tree, in order (``serving.sharding.SPLIT_DIMS``)."""
    out = []

    def walk(d):
        mixer = block_mixer(d)
        out.extend((key, d[key], dim, mixer)
                   for key, dim in split_dims(d).items())
    _map_block_dicts(walk, tree)
    return out


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host. numpy has no bfloat16: a
    bf16 tensor becomes its 2-byte words (``|V2``), as numpy stores a JAX
    bf16 array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")).copy()
    return t.numpy().copy()


def host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``; a 2-byte array (``|V2``,
    bfloat16 or 16-bit integer words) into bf16 by its bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind != "f":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy()).to(dtype)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

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
               window: Optional[int], scale: float, kv_range=None):
        return decode_attention(q, cache["k"], cache["v"], q_pos,
                                cache["pos"], window=window, scale=scale,
                                kv_range=kv_range)

    def context(self, cache, block_tables=None) -> Dict[str, torch.Tensor]:
        """Per-slot contiguous view (identity for the ring)."""
        return cache


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Global block pool: cache tensors are (N, block_size, ...) shared by
    every slot; ``block_tables`` (B, M) maps a slot's logical block
    ``pos // block_size`` to a pool block."""
    block_size: int

    def append(self, cache: Dict[str, torch.Tensor], updates, cur_pos,
               block_tables=None, valid=None) -> Dict[str, torch.Tensor]:
        """Write a T-token chunk (T = 1 for decode) at positions
        ``cur_pos + i``, in place. Tokens of free slots and invalid (pad,
        inactive) tokens are parked in the trash block (0, offset 0) with
        position -1: many writes to one index, harmless because no table
        ever holds block 0. The engine's look-ahead reservation makes
        every position a real token reaches covered by a block."""
        if block_tables is None:
            raise ValueError("the paged layout needs block tables")
        b, m = block_tables.shape
        device = cache["pos"].device
        _, pos, ok = _chunk_index(cur_pos, updates, valid, b, device)
        logical = torch.clamp(pos // self.block_size, 0, m - 1).long()
        row = torch.gather(block_tables, 1, logical)             # (B, T)
        ok = ok & (row >= 0)
        phys = torch.where(ok, row, torch.zeros_like(row)).long()
        off = torch.where(ok, pos % self.block_size,
                          torch.zeros_like(pos)).long()
        for key, u in updates.items():
            cache[key][phys, off] = u.to(cache[key].dtype)
        cache["pos"][phys, off] = torch.where(ok, pos, torch.full_like(pos,
                                                                       -1))
        return cache

    def attend(self, q, cache, q_pos, block_tables=None, *,
               window: Optional[int], scale: float, kv_range=None):
        return paged_decode_attention(q, cache["k"], cache["v"], q_pos,
                                      cache["pos"], block_tables,
                                      window=window, scale=scale,
                                      kv_range=kv_range)

    def context(self, cache, block_tables=None) -> Dict[str, torch.Tensor]:
        """Gather each slot's blocks into a contiguous (B, M*bs, ...) view;
        table holes surface as position -1 (fully masked)."""
        out = {}
        pos = None
        for key, leaf in cache.items():
            if key == "pos":
                continue
            out[key], pos = gather_paged_kv(leaf, cache["pos"], block_tables)
        out["pos"] = pos
        return out


RING = RingLayout()


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class KVCacheBackend:
    """Engine-side cache owner.

    ``init`` returns the device cache state: {"caches": the model's cache
    tree, "tables": the (B, M) int32 block tables or None}. Monolithic
    admission is ``alloc_slot`` (reserve, may refuse) then
    ``prefill_fill``; chunked admission is ``alloc_slot``, ``begin_slot``
    (wipe the slot's stale positions, install its table row), then any
    number of ``slot_view`` -> model chunk -> ``slot_update``.
    ``alloc_slot`` may be given the prompt tokens instead of a length;
    sharing backends then report through ``shared_prefill_start`` how many
    leading tokens are already installed. ``free_slot`` returns the slot's
    storage."""

    layout: Any
    prefix_sharing = False      # alloc_slot wants the prompt tokens
    supports_swap = False       # swap_out / swap_in / can_resume exist

    def init(self) -> Dict[str, Any]:
        raise NotImplementedError

    def can_admit(self, prompt, max_new: int) -> bool:
        """``prompt``: a length, or the token array (prefix-aware)."""
        raise NotImplementedError

    def can_ever_admit(self, prompt_len: int, max_new: int) -> bool:
        """Whether the request would fit an idle backend; False means
        waiting can never help and the engine rejects it."""
        return True

    def alloc_slot(self, slot: int, prompt, max_new: int) -> np.ndarray:
        """Host-side reservation; returns the slot's table row (a dummy
        without tables). Call only after ``can_admit`` said yes."""
        raise NotImplementedError

    def prefill_fill(self, cache_state, one_caches, slot, length, table_row):
        """Install a single-request prefilled cache into ``slot``."""
        raise NotImplementedError

    def free_slot(self, cache_state, slot: int) -> Dict[str, Any]:
        raise NotImplementedError

    def begin_slot(self, cache_state, slot, table_row, shared_blocks):
        """Prepare ``slot`` for chunked install: wipe its stale positions
        (the previous tenant's would alias into the new request's causal
        mask) and install its table row; the ``shared_blocks`` leading
        blocks hold live shared content and are left alone."""
        raise NotImplementedError

    def slot_view(self, cache_state, slot, ctx=None):
        """(caches, tables) for a single-slot model chunk; ``ctx`` bounds
        the visible context to positions below it."""
        raise NotImplementedError

    def slot_update(self, cache_state, slot, view_caches):
        """Write a ``slot_view``'s caches back."""
        raise NotImplementedError

    def reserve_lookahead(self, slot: int, tokens: int):
        """Top ``slot``'s reservation up to ``tokens`` total tokens ahead of
        a K-step decode round. Returns ``(new_table_row, covered_entries)``
        when blocks were added, else ``(None, 0)`` (always, for backends
        whose slots pin worst-case storage)."""
        return None, 0

    def shared_prefill_start(self, slot: int) -> int:
        """First prompt position the engine must compute for ``slot``."""
        return 0

    def shared_block_count(self, slot: int) -> int:
        """Leading table entries of ``slot`` already holding live content
        (shared or copied); ``begin_slot`` must not wipe them."""
        return 0

    def register_prefix(self, slot: int, prompt) -> None:
        """``slot``'s prefill completed: its full prompt blocks may now be
        shared."""

    def take_pending_copies(self) -> List:
        """Drain the (src, dst) block copies the allocator scheduled
        (copy-on-write); the engine replays them on the device."""
        return []

    def preemption_can_cover(self, prompt_len: int, max_new: int,
                             victims) -> bool:
        """Whether evicting every slot in ``victims`` could ever free room
        for the request; False means preempting would not unblock it."""
        return True

    def assert_invariants(self, cache_state=None) -> None:
        """Check the backend's allocator invariants (none by default)."""

    def hbm_bytes(self) -> int:
        raise NotImplementedError

    def hbm_bytes_per_slot(self) -> float:
        raise NotImplementedError

    # -- mesh placement (tensor-parallel decode) -----------------------------
    # Each cache leaf splits on the dim its block's mixer names
    # (``serving.sharding.SPLIT_DIMS``: the KV heads of K/V, the RG-LRU
    # width, the xLSTM heads) over the mesh's 'model' axis when it divides;
    # tables, positions and the allocator stay host-global.
    kv_shards: int = 1
    mesh = None

    def note_placement(self, mesh) -> None:
        """Place this backend on ``mesh`` (call before ``init``): its state
        becomes this rank's shard, and the per-device walkers divide each
        leaf whose split dim divides ``kv_shards`` ways."""
        self.mesh = mesh
        self.kv_shards = model_axis_size(mesh)

    def _shard_shape(self, dim, shape) -> tuple:
        """A global cache-leaf shape cut to this rank's shard on ``dim``."""
        shape = list(shape)
        if dim is not None:
            shape[dim] //= shard_divisor(dim, shape, self.kv_shards)
        return tuple(shape)

    def _bytes(self, rows: int, cols: Optional[int],
               per_device: bool) -> int:
        """Bytes of the per-request proto's leaves (L, 1, W, ...) at
        ``rows`` in place of 1 and, in attention and MLA blocks, ``cols``
        in place of the window W (None keeps each leaf's W; a recurrent
        leaf's dim 2 is its width or heads, never a window): the global
        leaves, or one rank's shards."""
        total = 0
        for _, (shape, dtype), dim, mixer in _split_leaves(self._proto):
            full = list(shape)
            full[1] = rows
            if cols is not None and mixer in ("attn", "mla"):
                full[2] = cols
            n = math.prod(full)
            if per_device:
                n //= shard_divisor(dim, full, self.kv_shards)
            total += n * dtype.itemsize
        return total

    def hbm_bytes_per_device(self) -> int:
        """Per-device KV footprint (== ``hbm_bytes`` without a mesh)."""
        return self.hbm_bytes()

    def local_wire(self, caches):
        """A slot checkpoint's caches in the host-global wire format (CPU
        tensors), cut to this rank's shard of each split leaf."""
        if self.mesh is None or self.kv_shards == 1:
            return caches

        def cut(d):
            out = {}
            for key, dim in split_dims(d).items():
                t = d[key]
                out[key] = (self.mesh.shard(t, dim).contiguous()
                            if shard_divisor(dim, t.shape,
                                             self.kv_shards) > 1 else t)
            return out
        return _map_block_dicts(cut, caches)

    def _gather_kv(self, d, proto):
        """One block dict of this rank's checkpoint (CPU tensors) with the
        leaves that split (by the global ``proto`` dict) gathered over the
        ranks: the host-global leaves."""
        if self.mesh is None or self.kv_shards == 1:
            return d
        out = {}
        for key, dim in split_dims(d).items():
            t = d[key]
            if shard_divisor(dim, proto[key][0], self.kv_shards) > 1:
                t = self.mesh.gather(t.to(self.mesh.device), dim).cpu()
            out[key] = t
        return out


def _prompt_spec(prompt):
    """A length (int) or a token array -> (length, tokens or None)."""
    if isinstance(prompt, (int, np.integer)):
        return int(prompt), None
    tokens = np.asarray(prompt, np.int32)
    return int(tokens.shape[0]), tokens


def _cache_proto(lm, max_seq_len: int):
    """The per-request cache structure as (shape, dtype) leaves, from the
    model's own ``init_cache(1, max_seq_len)``: (L, 1, W, ...) per leaf."""
    caches = lm.init_cache(1, max_seq_len)
    return _map_block_dicts(
        lambda d: {k: (tuple(v.shape), v.dtype) for k, v in d.items()},
        caches)


def _install(dst, src, slot) -> None:
    """Copy each (L, 1, W, ...) tensor of ``src`` into slot ``slot`` (a (1,)
    int64 device tensor) of the matching (L, B, W, ...) tensor of
    ``dst``."""
    def put(d, s):
        for key, g in d.items():
            g.index_copy_(1, slot, s[key])
        return d
    _map_block_dicts(put, dst, src)


class RingCache(KVCacheBackend):
    """Every slot owns a full ``max_seq_len``-wide line (or a window-wide
    one for windowed layers) in each attention layer's ring, and its row
    of each RG-LRU layer's state; admission overwrites both."""

    def __init__(self, lm, *, batch_slots: int, max_seq_len: int):
        self.layout = RING
        self.lm = lm
        self.batch_slots = batch_slots
        self.max_seq_len = max_seq_len
        self._proto = _cache_proto(lm, max_seq_len)

    def init(self) -> Dict[str, Any]:
        return {"caches": self.lm.init_cache(self.batch_slots,
                                             self.max_seq_len,
                                             mesh=self.mesh),
                "tables": None}

    def can_admit(self, prompt, max_new: int) -> bool:
        return True                       # a granted slot is the only gate

    def alloc_slot(self, slot, prompt, max_new) -> np.ndarray:
        return np.zeros((1,), np.int32)   # no tables: fixed dummy row

    def prefill_fill(self, cache_state, one_caches, slot, length, table_row):
        """Copy a single-request prefilled cache into ``slot``, in place.
        Like every ``slot`` the engine's programs pass (``slot_view``,
        ``slot_update``), a (1,) int64 device tensor: a Python int would
        be frozen into a captured CUDA graph."""
        _install(cache_state["caches"], one_caches, slot)
        return cache_state

    def free_slot(self, cache_state, slot):
        return cache_state                # rings are reused in place

    def begin_slot(self, cache_state, slot, table_row, shared_blocks):
        """Wipe the slot's positions: chunked install writes only the
        chunks' positions, so the previous tenant's would stay visible."""
        def wipe(d):
            d["pos"][:, slot] = -1
            return d
        _map_block_dicts(wipe, cache_state["caches"])
        return cache_state

    def slot_view(self, cache_state, slot, ctx=None):
        """The slot's line, first ``ctx`` columns, as a contiguous copy
        (the ring kernel takes contiguous K/V). Chunked prefill needs
        unwindowed attention layers only (the engine checks), so position
        ``p`` is at column ``p`` and the first ``ctx`` columns are the
        positions below ``ctx``."""
        def view(d):
            out = {}
            for key, g in d.items():
                width = g.shape[2] if ctx is None else min(ctx, g.shape[2])
                out[key] = g[:, :, :width].index_select(1, slot)
            return out
        return _map_block_dicts(view, cache_state["caches"]), None

    def slot_update(self, cache_state, slot, view_caches):
        def upd(d, v):
            for key, g in d.items():
                g[:, :, :v[key].shape[2]].index_copy_(1, slot, v[key])
            return d
        _map_block_dicts(upd, cache_state["caches"], view_caches)
        return cache_state

    def hbm_bytes(self) -> int:
        return self._bytes(self.batch_slots, None, per_device=False)

    def hbm_bytes_per_slot(self) -> float:
        return self.hbm_bytes() / self.batch_slots

    def hbm_bytes_per_device(self) -> int:
        return self._bytes(self.batch_slots, None, per_device=True)


class HostSwapHandle:
    """A device-to-host copy of a swapped-out slot's K/V in flight.

    The gather has already landed in fresh device tensors (so the released
    blocks may be reused at once); the constructor queues their copies into
    pinned host tensors with ``non_blocking=True`` and records a CUDA event
    after them. ``resolve()`` waits on that event before handing the host
    tensors out: pinned memory read before the copy completes holds garbage
    and raises nothing. CPU tensors are already host-side."""

    def __init__(self, dev_caches):
        leaves = _leaves(dev_caches)
        self._event = None
        if leaves and leaves[0][1].is_cuda:
            def pin(d):
                out = {}
                for key, t in d.items():
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    out[key] = host.copy_(t, non_blocking=True)
                return out
            self._host = _map_block_dicts(pin, dev_caches)
            self._event = torch.cuda.Event()
            self._event.record()
            self._dev = dev_caches      # alive until the copy is done
        else:
            self._host = dev_caches
            self._dev = None

    def resolve(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._dev = None
        return self._host


def resolve_swap_caches(host_kv):
    """A swap checkpoint's ``caches``, resolved (waiting for a deferred
    copy) and stored back in place."""
    caches = host_kv["caches"]
    if isinstance(caches, HostSwapHandle):
        caches = caches.resolve()
        host_kv["caches"] = caches
    return caches


class PagedCache(KVCacheBackend):
    """Block-table backend: a global pool of ``num_blocks`` blocks of
    ``block_size`` tokens per layer, committed per request at admission
    and returned at completion.

    Allocation is lazy with worst-case commitment: admission debits
    ``ceil((prompt + budget) / block_size)`` from a ledger (so a look-ahead
    top-up can never fail mid-decode) but draws only the blocks covering
    the prompt; ``reserve_lookahead`` draws the rest just ahead of the
    decode round that writes them.

    Blocks are refcounted: requests whose prompts share a full-block
    prefix point their leading entries at the same blocks
    (``prefix_sharing``). A prefix index maps ``tokens[:k*bs]`` (registered
    when the owner's prefill completes) to the block holding block k-1. At
    refcount 0 an indexed block is retained: it keeps its index entry and
    parks at the LRU end of the free list, so a later admission can revive
    it with its K/V intact. Plain free blocks are reclaimed first, then
    retained ones least-recently-freed first. When a prompt is covered
    entirely by shared blocks, the engine recomputes its last token into a
    private copy of the last block (copy-on-write)."""

    supports_swap = True

    def __init__(self, lm, *, batch_slots: int, max_seq_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_sharing: bool = True):
        for stage in lm.cfg.stages:
            for bdef in stage.blocks:
                if bdef.mixer not in ("attn", "mla"):
                    raise NotImplementedError(
                        f"paged KV backend supports attention mixers only "
                        f"(got {bdef.mixer!r}); use cache_backend='ring'")
        self.layout = PagedLayout(block_size)
        self.device = lm.device
        self.batch_slots = batch_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.prefix_sharing = prefix_sharing
        self.blocks_per_slot = -(-max_seq_len // block_size)   # table width M
        if num_blocks is None:
            # ring-equivalent capacity, plus the trash block
            num_blocks = batch_slots * self.blocks_per_slot + 1
        if num_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks (block 0 is trash)")
        self.num_blocks = num_blocks
        self._proto = _cache_proto(lm, max_seq_len)
        # free blocks in two tiers: plain blocks are reclaimed first;
        # refcount-0 blocks retaining indexed prefix K/V sit in freed order
        # and are reclaimed least-recently-freed first, i.e. last overall
        self._free_plain: List[int] = list(range(1, num_blocks))  # 0 = trash
        self._free_cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._slot_blocks: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}                # block -> refcount
        self._index: Dict[bytes, int] = {}            # prefix hash -> block
        self._block_key: Dict[int, bytes] = {}        # reverse index
        self._slot_shared: Dict[int, int] = {}        # slot -> live blocks
        self._slot_start: Dict[int, int] = {}         # slot -> prefill start
        self._slot_cap: Dict[int, int] = {}           # slot -> max entries
        self._slot_gap: Dict[int, int] = {}           # committed, not drawn
        self._gap_total = 0                           # sum of _slot_gap
        self._pending_copies: List = []               # (src, dst) for COW
        self.admitted = 0
        self.blocks_allocated_total = 0
        self.peak_blocks_in_use = 0
        self.cow_copies = 0
        self.lookahead_topups = 0
        self.retained_block_hits = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.preempt_swap_bytes = 0      # host<->device bytes moved by swaps

    @property
    def _free(self) -> List[int]:
        """All reclaimable blocks, in reclaim order (a read-only view)."""
        return self._free_plain + list(self._free_cached)

    # -- device state --------------------------------------------------------
    def init(self) -> Dict[str, Any]:
        n, bs, dev = self.num_blocks, self.block_size, self.device

        def pool(d):
            out = {}
            for key, dim in split_dims(d).items():
                shape, dtype = d[key]
                # (L, 1, W, ...) per-request line -> (L, N, bs, ...) pool,
                # on a mesh this rank's shard of it
                if key == "pos":
                    out[key] = torch.full((shape[0], n, bs), -1,
                                          dtype=dtype, device=dev)
                else:
                    full = (shape[0], n, bs) + shape[3:]
                    out[key] = torch.zeros(self._shard_shape(dim, full),
                                           dtype=dtype, device=dev)
            return out

        caches = _map_block_dicts(pool, self._proto)
        tables = torch.full((self.batch_slots, self.blocks_per_slot), -1,
                            dtype=torch.int32, device=dev)
        return {"caches": caches, "tables": tables}

    # -- host-side allocator -------------------------------------------------
    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return max(1, -(-(prompt_len + max_new) // self.block_size))

    def _plan(self, prompt, max_new: int):
        """(total_blocks, shared_blocks, fresh_worst, prefill_start) for a
        prospective admission: the longest chain of full prompt blocks in
        the prefix index is shared (retained blocks included); the engine
        always recomputes at least the last prompt token, and when that
        token's block is shared one extra block is committed for the
        copy-on-write. ``fresh_worst`` is the worst-case fresh draw over
        the request's life."""
        length, tokens = _prompt_spec(prompt)
        total = self.blocks_needed(length, max_new)
        shared = []
        if self.prefix_sharing and tokens is not None:
            bs = self.block_size
            while (len(shared) + 1) * bs <= length:
                blk = self._index.get(tokens[:(len(shared) + 1) * bs]
                                      .tobytes())
                if blk is None:
                    break
                shared.append(blk)
        k = len(shared)
        prefill_start = k * self.block_size
        cow = 0
        if prefill_start >= length:            # fully covered, block-aligned
            prefill_start = length - 1
            cow = 1                            # last block must go private
        return total, shared, total - k + cow, prefill_start

    def _revivals(self, shared) -> int:
        """Shared blocks parked refcount-0 in the free list: reviving them
        takes them out of the free list without a fresh draw."""
        return sum(1 for blk in shared if blk not in self._ref)

    def _available(self) -> int:
        """Free blocks not spoken for by admitted requests' commitments."""
        return (len(self._free_plain) + len(self._free_cached)
                - self._gap_total)

    def can_admit(self, prompt, max_new: int) -> bool:
        _, shared, fresh_worst, _ = self._plan(prompt, max_new)
        return fresh_worst + self._revivals(shared) <= self._available()

    def can_ever_admit(self, prompt_len: int, max_new: int) -> bool:
        # block 0 is the trash block: the usable pool is num_blocks - 1
        return self.blocks_needed(prompt_len, max_new) <= self.num_blocks - 1

    def _take_free(self, n: int, exclude=()) -> List[int]:
        """Draw ``n`` blocks: plain first, then retained blocks LRU-first,
        dropping their index entries. ``exclude`` protects retained blocks
        the caller is about to revive in the same admission."""
        out: List[int] = []
        while self._free_plain and len(out) < n:
            out.append(self._free_plain.pop())
        if len(out) < n:
            for blk in list(self._free_cached):              # LRU eviction
                if len(out) >= n:
                    break
                if blk in exclude:
                    continue
                del self._free_cached[blk]
                key = self._block_key.pop(blk, None)
                if key is not None and self._index.get(key) == blk:
                    del self._index[key]
                out.append(blk)
        assert len(out) == n, "commitment ledger violated: free list short"
        return out

    def _release_block(self, blk: int) -> None:
        """Park a refcount-0 block: retained (index kept, LRU end) when it
        holds registered prefix K/V, plain otherwise."""
        key = self._block_key.get(blk)
        if key is not None:
            self._free_cached[blk] = None     # most recent = reclaimed last
            return
        self._free_plain.append(blk)

    def _row(self, blocks) -> np.ndarray:
        row = np.full((self.blocks_per_slot,), -1, np.int32)
        row[:len(blocks)] = blocks
        return row

    def alloc_slot(self, slot, prompt, max_new) -> np.ndarray:
        length, _ = _prompt_spec(prompt)
        total, shared, fresh_worst, prefill_start = self._plan(prompt,
                                                               max_new)
        revive = self._revivals(shared)
        if fresh_worst + revive > self._available():
            raise RuntimeError(
                f"paged pool exhausted: need {fresh_worst + revive} blocks, "
                f"{self._available()} available")
        if slot in self._slot_blocks:
            raise RuntimeError(f"slot {slot} already holds blocks")
        k = len(shared)
        cow = 1 if (shared and prefill_start < k * self.block_size) else 0
        # draw now only the blocks covering the prompt
        entries_now = max(1, -(-length // self.block_size))
        fresh_now = cow + max(0, entries_now - k)
        fresh = self._take_free(fresh_now, exclude=set(shared))
        for blk in shared:
            if blk in self._free_cached:      # revive a retained block
                del self._free_cached[blk]
                self.retained_block_hits += 1
            self._ref[blk] = self._ref.get(blk, 0) + 1
        for blk in fresh:
            self._ref[blk] = 1
        blocks = list(shared)
        if cow:
            # the last prompt token lives in the last shared block: this
            # slot gets a private copy of it instead
            src, dst = blocks[-1], fresh[0]
            blocks[-1] = dst
            self._ref[src] -= 1                # undo the share of that block
            if self._ref[src] == 0:            # was a revived retained block
                del self._ref[src]
                self._release_block(src)
            self._pending_copies.append((src, dst))
            self.cow_copies += 1
            blocks.extend(fresh[1:])
        else:
            blocks.extend(fresh)
        self._slot_blocks[slot] = blocks
        self._slot_shared[slot] = k
        self._slot_start[slot] = prefill_start
        self._slot_cap[slot] = total
        self._slot_gap[slot] = fresh_worst - fresh_now
        self._gap_total += fresh_worst - fresh_now
        self.admitted += 1
        self.blocks_allocated_total += fresh_now
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return self._row(blocks)

    def reserve_lookahead(self, slot, tokens: int):
        """Top the slot's table up to cover ``tokens`` tokens, drawing at
        most its remaining commitment (so the ledger guarantees the draw).
        Returns ``(row, previously_covered)``, or ``(None, 0)``."""
        blocks = self._slot_blocks.get(slot)
        if blocks is None:
            return None, 0
        need = min(max(1, -(-tokens // self.block_size)),
                   self._slot_cap[slot])
        have = len(blocks)
        if need <= have:
            return None, 0
        take = need - have
        assert take <= self._slot_gap[slot], (
            f"look-ahead past slot {slot}'s committed budget "
            f"({take} > {self._slot_gap[slot]})")
        fresh = self._take_free(take)
        for blk in fresh:
            self._ref[blk] = 1
        blocks.extend(fresh)
        self._slot_gap[slot] -= take
        self._gap_total -= take
        self.blocks_allocated_total += take
        self.lookahead_topups += 1
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return self._row(blocks), have

    def shared_prefill_start(self, slot: int) -> int:
        return self._slot_start.get(slot, 0)

    def shared_block_count(self, slot: int) -> int:
        return self._slot_shared.get(slot, 0)

    def register_prefix(self, slot: int, prompt) -> None:
        """Publish the slot's full prompt blocks into the prefix index.
        Only once its prefill completed: earlier, a concurrent admission
        could share blocks whose K/V are not installed yet."""
        if not self.prefix_sharing:
            return
        length, tokens = _prompt_spec(prompt)
        blocks = self._slot_blocks.get(slot)
        if tokens is None or blocks is None:
            return
        bs = self.block_size
        for i in range(length // bs):
            key = tokens[:(i + 1) * bs].tobytes()
            blk = blocks[i]
            if key in self._index or blk in self._block_key:
                continue
            self._index[key] = blk
            self._block_key[blk] = key

    def take_pending_copies(self) -> List:
        copies, self._pending_copies = self._pending_copies, []
        return copies

    def copy_block(self, cache_state, src: int, dst: int):
        """Copy-on-write on the device: every layer's pool block ``src``
        -> ``dst``, positions included, in place."""
        def copy(d):
            for leaf in d.values():
                leaf[:, dst] = leaf[:, src]
            return d
        _map_block_dicts(copy, cache_state["caches"])
        return cache_state

    @property
    def blocks_in_use(self) -> int:
        """Blocks held by live slots (retained refcount-0 blocks are
        reclaimable, so they count as free)."""
        return (self.num_blocks - 1) - len(self._free_plain) \
            - len(self._free_cached)

    def reset_stats(self) -> None:
        """Zero the admission accounting (e.g. after a warm-up)."""
        self.admitted = 0
        self.blocks_allocated_total = 0
        self.peak_blocks_in_use = self.blocks_in_use
        self.cow_copies = 0
        self.lookahead_topups = 0
        self.retained_block_hits = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.preempt_swap_bytes = 0

    def free_slot(self, cache_state, slot):
        blocks = self._slot_blocks.pop(slot, None)
        if blocks is None:
            return cache_state
        self._slot_shared.pop(slot, None)
        self._slot_start.pop(slot, None)
        self._slot_cap.pop(slot, None)
        # release the commitment never drawn (early EOS, unspent budget)
        self._gap_total -= self._slot_gap.pop(slot, 0)
        for blk in blocks:
            self._ref[blk] = self._ref.get(blk, 1) - 1
            if self._ref[blk] > 0:
                continue                      # still shared by another slot
            del self._ref[blk]
            self._release_block(blk)
        cache_state["tables"][slot] = -1
        return cache_state

    # -- preemption: host K/V swap -------------------------------------------
    def swap_out(self, cache_state, slot):
        """Checkpoint ``slot``'s drawn blocks (every layer's K/V and
        positions) to the host and release them through ``free_slot``:
        refcounts, ledger and retention behave as at completion; shared
        blocks are copied, not taken. The gather is an ``index_select``
        into fresh tensors, so the released blocks may be handed out again
        at once; the host copy is left in flight (``HostSwapHandle``).
        Returns ``(host_kv, cache_state)``."""
        blocks = self._slot_blocks.get(slot)
        if blocks is None:
            raise RuntimeError(f"slot {slot} holds no blocks to swap out")
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        gathered = _map_block_dicts(
            lambda d: {k: leaf.index_select(1, idx) for k, leaf in d.items()},
            cache_state["caches"])
        host = {"n_blocks": len(blocks), "caches": HostSwapHandle(gathered)}
        self.swap_outs += 1
        self.preempt_swap_bytes += len(blocks) * self.block_bytes()
        return host, self.free_slot(cache_state, slot)

    def checkpoint_slot(self, cache_state, slot):
        """A live slot's K/V on the host, without releasing anything
        (refcounts, ledger and table row untouched): ``swap_out``'s
        checkpoint in ``repro``'s padded form, the table row's blocks then
        the trash block up to ``blocks_per_slot``. An engine snapshot
        persists each decoding slot this way while the engine serves on;
        ``swap_in`` restores it into a cold engine."""
        blocks = self._slot_blocks.get(slot)
        if blocks is None:
            raise RuntimeError(f"slot {slot} holds no blocks to checkpoint")
        idx = np.zeros((self.blocks_per_slot,), np.int64)   # pad: trash
        idx[:len(blocks)] = blocks
        idx = torch.from_numpy(idx).to(self.device)
        return {"n_blocks": len(blocks), "caches": _map_block_dicts(
            lambda d: {k: leaf.index_select(1, idx).cpu()
                       for k, leaf in d.items()}, cache_state["caches"])}

    def wire_caches(self, host_kv):
        """A swap or slot checkpoint's caches as numpy in ``repro``'s wire
        format: each leaf (L, ``blocks_per_slot``, block_size, ...); a
        ``swap_out`` row (its drawn blocks only) is padded with empty
        blocks (positions -1)."""
        m = self.blocks_per_slot

        def pad(d, proto):
            out = {}
            for key, t in self._gather_kv(d, proto).items():
                n = t.shape[1]
                if n < m:
                    fill = torch.full((t.shape[0], m - n) + tuple(t.shape[2:]),
                                      -1 if key == "pos" else 0,
                                      dtype=t.dtype)
                    t = torch.cat([t.cpu(), fill], dim=1)
                out[key] = host_array(t)
            return out

        return _map_block_dicts(pad, resolve_swap_caches(host_kv),
                                self._proto)

    def available_blocks(self) -> int:
        """Free blocks not spoken for by commitments (what ``can_admit``
        and ``can_resume`` gate on)."""
        return self._available()

    def slot_commitment(self, slot: int) -> int:
        """Upper bound on the blocks preempting ``slot`` would recover: its
        drawn blocks plus its undrawn commitment."""
        return (len(self._slot_blocks.get(slot, ()))
                + self._slot_gap.get(slot, 0))

    def preemption_can_cover(self, prompt_len: int, max_new: int,
                             victims) -> bool:
        worst = self.blocks_needed(prompt_len, max_new)
        return worst <= self.available_blocks() + sum(
            self.slot_commitment(s) for s in victims)

    def can_resume(self, prompt_len: int, max_new: int) -> bool:
        """A swapped-out request returns into private blocks, so it needs
        its full worst case against the uncommitted free list."""
        return self.blocks_needed(prompt_len, max_new) <= self._available()

    def swap_in(self, cache_state, slot, host_kv, prompt_len: int,
                max_new: int):
        """Restore a swapped-out request into ``slot``: draw fresh private
        blocks, copy the checkpoint back byte for byte (its first
        ``n_blocks`` blocks: ``swap_out``'s row, or a padded snapshot row),
        and re-commit the undrawn budget. Call only after ``can_resume``
        said yes."""
        total = self.blocks_needed(prompt_len, max_new)
        n_now = host_kv["n_blocks"]
        if total > self._available():
            raise RuntimeError(
                f"paged pool exhausted on resume: need {total} blocks, "
                f"{self._available()} available")
        if slot in self._slot_blocks:
            raise RuntimeError(f"slot {slot} already holds blocks")
        fresh = self._take_free(n_now)
        for blk in fresh:
            self._ref[blk] = 1
        self._slot_blocks[slot] = fresh
        self._slot_shared[slot] = 0
        self._slot_start[slot] = prompt_len
        self._slot_cap[slot] = total
        self._slot_gap[slot] = total - n_now
        self._gap_total += total - n_now
        self.blocks_allocated_total += n_now
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        self.swap_ins += 1
        self.preempt_swap_bytes += n_now * self.block_bytes()
        idx = torch.tensor(fresh, dtype=torch.long, device=self.device)

        def scatter(d, h):
            for key, leaf in d.items():
                leaf.index_copy_(1, idx, h[key][:, :n_now].to(leaf.device))
            return d

        _map_block_dicts(scatter, cache_state["caches"],
                      resolve_swap_caches(host_kv))
        cache_state["tables"][slot] = torch.from_numpy(self._row(fresh)).to(
            cache_state["tables"].device)
        return cache_state

    def assert_invariants(self, cache_state=None) -> None:
        """Allocator invariants: block conservation across slots and free
        tiers, ledger consistency, per-slot bounds, and index/retention
        coherence. With ``cache_state``, also that no table holds the trash
        block and each live slot's row equals its block list."""
        held = [b for blocks in self._slot_blocks.values() for b in blocks]
        # every non-trash block is held by exactly the slots that refcount
        # it, or parked in exactly one free tier
        assert sorted(held + list(self._free_plain)
                      + list(self._free_cached)) == sorted(
            list(range(1, self.num_blocks)) + [
                b for b, r in self._ref.items() for _ in range(r - 1)])
        assert all(r > 0 for r in self._ref.values())
        assert set(self._ref) == set(held)
        # ledger: outstanding commitments never exceed the free list
        assert self._gap_total == sum(self._slot_gap.values())
        assert 0 <= self._gap_total <= (len(self._free_plain)
                                        + len(self._free_cached))
        # per slot: drawn <= worst case (+1 for a COW block), drawn +
        # undrawn covers the worst case
        for slot, blocks in self._slot_blocks.items():
            cap = self._slot_cap[slot]
            gap = self._slot_gap[slot]
            assert 0 <= gap and cap >= 1
            assert len(blocks) <= cap + 1, (slot, len(blocks), cap)
            assert len(blocks) + gap >= cap, (slot, len(blocks), gap, cap)
        # retention: every cached free block is indexed; the index and its
        # reverse map agree
        for blk in self._free_cached:
            assert self._block_key.get(blk) is not None
        for key, blk in self._index.items():
            assert self._block_key.get(blk) == key
        for blk, key in self._block_key.items():
            assert self._index.get(key) == blk
        if cache_state is not None:
            tables = cache_state["tables"].cpu().numpy()
            assert not (tables == 0).any(), "a table holds the trash block"
            for slot, blocks in self._slot_blocks.items():
                row = tables[slot]
                assert row[:len(blocks)].tolist() == blocks, (slot, row)
            self._assert_pool_placement(cache_state)

    def _assert_pool_placement(self, cache_state) -> None:
        """Sharded-pool accounting (``repro``'s): the device pool is still
        the ledger's (width ``num_blocks``), each K/V leaf is this rank's
        ``kv_shards``-way shard of its KV-head dim (or whole when it does
        not divide), and its leaves' bytes add up to
        ``hbm_bytes_per_device()``."""
        per_dev = 0
        for (key, leaf), (_, (shape, dtype), dim, _) in zip(
                _leaves(cache_state["caches"]),
                _split_leaves(self._proto)):
            assert leaf.shape[1] == self.num_blocks, (
                f"pool width {leaf.shape[1]} != ledger's {self.num_blocks}")
            full = (shape[0], self.num_blocks, self.block_size) + shape[3:]
            want = self._shard_shape(dim, full)
            assert tuple(leaf.shape) == want and leaf.dtype == dtype, (
                f"pool leaf {key}: {tuple(leaf.shape)} {leaf.dtype}, the "
                f"ledger expects the {self.kv_shards}-way shard {want} "
                f"{dtype}")
            per_dev += leaf.numel() * leaf.element_size()
        assert per_dev == self.hbm_bytes_per_device(), (
            per_dev, self.hbm_bytes_per_device())

    # -- chunked-prefill admission seam --------------------------------------
    def begin_slot(self, cache_state, slot, table_row, shared_blocks):
        return self.begin_slots(cache_state, [slot], [table_row],
                                [shared_blocks])

    def begin_slots(self, cache_state, slots, table_rows, shared_blocks):
        """Install many slots' table rows at once and wipe the positions of
        each row's fresh blocks (entries at or after its ``shared_blocks``):
        they may come from a longer tenant whose stale positions would sit
        in the new request's causal mask. ``repro`` sends the rest of the
        scatter to the out-of-bounds index ``num_blocks``; here the wiped
        blocks are selected on the host."""
        rows = np.asarray(table_rows, np.int32).reshape(
            -1, self.blocks_per_slot)
        shared = np.asarray(shared_blocks).reshape(-1, 1)
        wipe = (np.arange(self.blocks_per_slot)[None, :] >= shared) \
            & (rows >= 0)
        dev = cache_state["tables"].device
        blocks = torch.from_numpy(np.unique(rows[wipe]).astype(np.int64)).to(
            dev)
        if blocks.numel():
            def clear(d):
                d["pos"][:, blocks] = -1
                return d
            _map_block_dicts(clear, cache_state["caches"])
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        cache_state["tables"][idx] = torch.from_numpy(rows).to(dev)
        return cache_state

    def slot_view(self, cache_state, slot, ctx=None):
        """The global pool and the slot's (1, M) table row, cut to the
        entries covering positions below ``ctx``."""
        tables = cache_state["tables"].index_select(0, slot)
        if ctx is not None:
            m = min(-(-ctx // self.block_size), self.blocks_per_slot)
            tables = tables[:, :m]
        return cache_state["caches"], tables

    def slot_update(self, cache_state, slot, view_caches):
        return cache_state    # the view is the pool: chunks wrote there

    # -- monolithic install --------------------------------------------------
    def prefill_fill(self, cache_state, one_caches, slot, length, table_row):
        """Scatter a prefilled per-request cache into the slot's blocks,
        routing each token by its position (block ``pos // bs``, offset
        ``pos % bs``), so window-wide rings install too. The row's blocks
        may come from a finished request, so their positions are wiped
        first. ``slot``, ``length`` and ``table_row`` are device tensors
        ((1,) int64, (1,) and (M,) int32: the engine's staged arguments).

        The scatter has a fixed shape, so a CUDA graph can capture it: a
        token that is not installed (a pad, an empty ring column, a
        position without a block) is parked in the trash block 0 at offset
        0, as ``repro``'s is, and block 0's positions are reset to -1
        afterwards, so no kernel ever sees a position there."""
        bs = self.block_size
        row = table_row
        own = torch.where(row >= 0, row, torch.zeros_like(row)).long()

        def fill(c, o):
            src_pos = o["pos"][0, 0]                      # (W,) layer-0 row
            logical = torch.clamp(src_pos, 0, self.max_seq_len - 1) // bs
            row_phys = row[logical.long()]
            ok = (src_pos >= 0) & (src_pos < length) & (row_phys >= 0)
            zero = torch.zeros_like(src_pos)
            phys = torch.where(ok, row_phys, zero).long()
            off = torch.where(ok, src_pos % bs, zero).long()
            for key, leaf in c.items():
                if key == "pos":
                    # index_fill_ takes -1 as a kernel argument; an indexed
                    # assignment of -1 copies a CPU scalar, which a CUDA
                    # graph capture refuses
                    leaf.index_fill_(1, own, -1)
                    leaf[:, phys, off] = torch.where(
                        ok, src_pos, zero - 1)[None, :].to(leaf.dtype)
                    leaf[:, 0] = -1                       # the trash block
                else:
                    leaf[:, phys, off] = o[key][:, 0].to(leaf.dtype)
            return c

        _map_block_dicts(fill, cache_state["caches"], one_caches)
        cache_state["tables"].index_copy_(0, slot, row[None])
        return cache_state

    # -- accounting ----------------------------------------------------------
    def block_bytes(self) -> int:
        """Bytes one pool block costs across all layers."""
        return self._bytes(1, self.block_size, per_device=False)

    def block_bytes_per_device(self) -> int:
        """Per-device bytes of one pool block: K/V leaves split their
        KV-head dim ``kv_shards`` ways when it divides; positions are
        whole on every device."""
        return self._bytes(1, self.block_size, per_device=True)

    def hbm_bytes(self) -> int:
        return self.block_bytes() * self.num_blocks

    def hbm_bytes_per_device(self) -> int:
        return self.block_bytes_per_device() * self.num_blocks

    def hbm_bytes_per_slot(self) -> float:
        """Average bytes drawn per admitted request (blocks committed but
        never drawn do not count)."""
        if self.admitted == 0:
            return float(self.block_bytes() * self.blocks_per_slot)
        return self.block_bytes() * self.blocks_allocated_total / self.admitted


def make_backend(kind, lm, *, batch_slots: int, max_seq_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_sharing: bool = True) -> KVCacheBackend:
    if kind == "ring":
        return RingCache(lm, batch_slots=batch_slots, max_seq_len=max_seq_len)
    if kind == "paged":
        return PagedCache(lm, batch_slots=batch_slots,
                          max_seq_len=max_seq_len, block_size=block_size,
                          num_blocks=num_blocks,
                          prefix_sharing=prefix_sharing)
    raise ValueError(f"unknown cache backend {kind!r} "
                     "(expected 'ring' or 'paged')")
