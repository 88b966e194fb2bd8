"""Serving engine: continuous batching over per-slot request state.

Port of ``repro.serving.engine.ServingEngine``. A fixed pool of
``batch_slots`` decode slots shares one device cache; requests are admitted
into free slots as others finish. Each decode step samples, appends and
attends for every slot on the device; with ``max_decode_steps=K`` the
engine runs up to K such steps back to back and synchronises with the host
once per K tokens (the (B,) active mask), so outputs are token-for-token
those of K = 1.

Admission is monolithic by default: the prompt is right-padded to a
power-of-two bucket and prefilled whole (the flash kernel), its K/V
installed into the slot. With ``chunk_tokens`` the scheduler plans prompt
*chunks* under a token budget instead, run through ``LM.prefill_chunk``
against the slot's cache view (append, then cached attention at T =
chunk), so long prompts no longer stall in-flight decodes.

The KV cache is pluggable (``serving.kv_cache``): the ring backend pins a
``max_seq_len`` line per slot; the paged backend commits
``ceil((prompt + budget) / block_size)`` pool blocks per request, draws
them lazily (a look-ahead reservation before each K-step round) and, with
chunked prefill, lets requests that share a full-block prompt prefix share
its blocks (refcounted, copy-on-write, retained after completion) and skip
computing them.

Scheduling is SLO-aware (``scheduler.request_rank``): when a higher-class
request is blocked, the engine preempts the worst-ranked decoding slot.
Its decode state (generated tokens, step count, next-sample logits) is
checkpointed on the host and its cache is swapped out (paged) or freed and
rebuilt at resume by re-prefilling prompt + generated tokens (ring, or
``preempt_mode='recompute'``); the resumed stream continues token for
token. Sampling keys are a pure function of (seed, request id, step), so
sampled streams do not depend on co-scheduling, chunking or preemption
either.

Speculative decoding, fault injection, snapshots, the journal and meshes
are later slices: their constructor arguments raise
``NotImplementedError`` when set.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.serving.kv_cache import RingLayout, make_backend
from repro_torch.serving.sampler import request_keys, sample_logits_keyed
from repro_torch.serving.scheduler import (MONOLITHIC, PrefillProgress,
                                           Scheduler, bucket_for,
                                           prompt_buckets, request_rank)


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray           # (S_prompt,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    priority: int = 0            # SLO class: higher = more critical
    deadline_s: Optional[float] = None   # relative SLO deadline (from submit)
    output: Optional[np.ndarray] = None
    submit_s: float = 0.0        # wall-clock at submit()
    admit_s: float = 0.0         # wall-clock at the first slot grant (a
    #                              resume never restamps it)
    finish_s: float = 0.0        # wall-clock at completion
    latency_s: float = 0.0       # finish - submit (queue + service)
    ttft_s: float = 0.0          # submit -> first generated token exists
    preemptions: int = 0         # times evicted under SLO pressure
    resume: Optional["_ResumeState"] = dataclasses.field(
        default=None, repr=False)     # checkpoint while preempted
    # "queued"/"active" while live, then one of done | rejected | cancelled
    status: str = "queued"
    failure_reason: Optional[str] = None
    enqueue_s: float = 0.0       # wall-clock at engine queue entry


@dataclasses.dataclass
class _ResumeState:
    """What a preempted request needs to resume token for token: the host
    decode checkpoint (generated tokens, step count, the logits the next
    sample reads) and, on the swap path, the backend's K/V checkpoint.
    ``kv`` is None on the recompute path: the engine rebuilds the cache by
    re-prefilling prompt + generated tokens, and the saved ``last`` logits
    make the next sampled token exact either way."""
    steps: int
    tokens: np.ndarray           # (steps,) generated so far
    last: np.ndarray             # (V,) f32 logits to sample the next token
    kv: Optional[object] = None  # PagedCache.swap_out checkpoint


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _has_windowed_blocks(lm: LM) -> bool:
    return any(bdef.window is not None
               for stage in lm.cfg.stages for bdef in stage.blocks)


def validate_prompt(prompt: np.ndarray, max_new_tokens: int,
                    max_seq_len: int, truncate: bool) -> np.ndarray:
    """Prompt + budget must fit the cache: raise, or with ``truncate`` keep
    the trailing ``max_seq_len - max_new_tokens`` prompt tokens. Prompts
    become int32, the dtype the prefix index hashes."""
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 1:
        raise ValueError(f"prompt must be 1-D (got shape {prompt.shape})")
    room = max_seq_len - max_new_tokens
    if room <= 0:
        raise ValueError(
            f"max_new_tokens ({max_new_tokens}) leaves no room for a prompt "
            f"within max_seq_len ({max_seq_len})")
    if len(prompt) > room:
        if not truncate:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds max_seq_len ({max_seq_len}); shorten the prompt,"
                f" raise max_seq_len, or construct the engine with"
                f" truncate_prompts=True to keep the prompt tail")
        prompt = prompt[-room:]
    return prompt


class ServingEngine:
    """Continuous-batching autoregressive serving on the model's device."""

    def __init__(self, lm: LM, params, *, batch_slots: int = 8,
                 max_seq_len: int = 512, seed: int = 0,
                 eos_id: Optional[int] = None, min_bucket: int = 16,
                 cache_backend="ring", block_size: int = 16,
                 num_pool_blocks: Optional[int] = None,
                 truncate_prompts: bool = False,
                 chunk_tokens: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_sharing: bool = True,
                 max_decode_steps: int = 1,
                 preempt_mode: str = "auto",
                 admission_policy: Optional[str] = None,
                 draft_model=None, draft_params=None,
                 speculative_tokens: int = 0, fault_plan=None,
                 mesh=None, rules=None):
        later = {"draft_model": draft_model, "draft_params": draft_params,
                 "speculative_tokens": speculative_tokens or None,
                 "fault_plan": fault_plan, "mesh": mesh, "rules": rules}
        for name, value in later.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}: speculative decoding, fault injection and "
                    f"meshes are later slices of the port")
        self.lm = lm
        self.params = params
        self.device = lm.device
        self.batch_slots = batch_slots
        self.max_seq_len = max_seq_len
        self.seed = seed
        self.eos_id = eos_id
        self.truncate_prompts = truncate_prompts
        self.buckets = prompt_buckets(max_seq_len, min_bucket)
        self._windowed = _has_windowed_blocks(lm)
        self._queue: List[Request] = []
        self._next_id = 0
        self._slots: Dict[int, Request] = {}
        self._free: List[int] = list(range(batch_slots))
        self._prefilling: Dict[int, PrefillProgress] = \
            collections.OrderedDict()
        self._done: Dict[int, Request] = {}
        # host mirror of each live slot's completed decode steps (exact at
        # every sync): the scheduler's budget headroom and the look-ahead
        # reservation's positions
        self._scanned: Dict[int, int] = {}
        # counters: decode_steps counts token rounds (a K-step round adds
        # K), host_syncs counts active-mask transfers (one per round),
        # decode_s the host wall time of decode rounds, sync included;
        # admissions counts slot grants (resumes included)
        self.decode_steps = 0
        self.host_syncs = 0
        self.generated_tokens = 0
        self.peak_active_slots = 0
        self.admissions = 0
        self.decode_s = 0.0
        self.prefill_tokens_total = 0
        self.prefill_tokens_skipped = 0
        self.planned_token_slots = 0
        self.useful_prefill_tokens = 0
        self.preemptions = 0
        self.lookahead_dispatches = 0   # decode rounds with table top-ups
        self._pending_swaps: List[object] = []
        self._status_counts = collections.Counter()
        if chunk_tokens is not None:
            self._validate_chunk_mixers(chunk_tokens)
        self.backend = make_backend(
            cache_backend, lm, batch_slots=batch_slots,
            max_seq_len=max_seq_len, block_size=block_size,
            num_blocks=num_pool_blocks, prefix_sharing=prefix_sharing)
        if chunk_tokens is not None:
            self._validate_chunk_layout()
        self.scheduler = Scheduler(batch_slots=batch_slots,
                                   chunk_tokens=chunk_tokens,
                                   token_budget=token_budget,
                                   max_decode_steps=max_decode_steps,
                                   admission_policy=admission_policy)
        # prefix sharing hashes prompt tokens at admission; only chunked
        # install can skip the shared part (monolithic recomputes it all)
        self._admit_with_tokens = (
            self.scheduler.chunked
            and self.backend.prefix_sharing)
        if preempt_mode not in ("auto", "swap", "recompute"):
            raise ValueError(f"preempt_mode must be 'auto', 'swap' or "
                             f"'recompute' (got {preempt_mode!r})")
        if preempt_mode == "swap" and not self.backend.supports_swap:
            raise ValueError(
                "preempt_mode='swap' needs a backend with swap_out/swap_in "
                "(paged); the ring backend resumes by recompute")
        self._preempt_swap = (preempt_mode in ("auto", "swap")
                              and self.backend.supports_swap)
        self._cache_state = self.backend.init()
        b, v, dev = batch_slots, lm.cfg.padded_vocab, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._state = {
            "last": torch.zeros((b, v), dtype=torch.float32, device=dev),
            "pos": torch.zeros((b,), **i32),
            "steps": torch.zeros((b,), **i32),
            "budget": torch.zeros((b,), **i32),
            "temp": torch.zeros((b,), dtype=torch.float32, device=dev),
            "rid": torch.zeros((b,), **i32),
            "active": torch.zeros((b,), dtype=torch.bool, device=dev),
            "out": torch.zeros((b, max_seq_len), **i32),
        }

    def _validate_chunk_mixers(self, chunk_tokens: int) -> None:
        if not (1 <= chunk_tokens <= self.max_seq_len):
            raise ValueError(f"chunk_tokens ({chunk_tokens}) must be in "
                             f"[1, max_seq_len={self.max_seq_len}]")
        for stage in self.lm.cfg.stages:
            for bdef in stage.blocks:
                if bdef.mixer != "attn":
                    raise NotImplementedError(
                        f"chunked prefill needs attention mixers (got "
                        f"{bdef.mixer!r}); recurrent state folds tokens "
                        f"sequentially — use chunk_tokens=None")

    def _validate_chunk_layout(self) -> None:
        if isinstance(self.backend.layout, RingLayout) and self._windowed:
            raise NotImplementedError(
                "chunked prefill over windowed layers needs the paged "
                "backend: a window-wide ring evicts tokens the chunk's own "
                "queries still attend to")

    # -- queue API ------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its id. ``priority`` is its SLO class
        (higher = admitted first, never preempted by a lower class);
        ``deadline_s`` orders within a class."""
        r = self.make_request(prompt, max_new_tokens, temperature,
                              priority=priority, deadline_s=deadline_s)
        self.enqueue(r)
        return r.request_id

    def make_request(self, prompt: np.ndarray, max_new_tokens: int = 16,
                     temperature: float = 0.0, priority: int = 0,
                     deadline_s: Optional[float] = None) -> Request:
        """Validate and stamp a request without queueing it."""
        prompt = validate_prompt(prompt, max_new_tokens, self.max_seq_len,
                                 self.truncate_prompts)
        rid = self._next_id
        self._next_id += 1
        r = Request(rid, prompt, max_new_tokens, temperature,
                    priority=priority, deadline_s=deadline_s)
        r.submit_s = time.perf_counter()
        return r

    def enqueue(self, r: Request) -> None:
        """Admission-control gate + queue insert: with an
        ``admission_policy``, a deadline the measured service rate cannot
        meet is rejected ("reject") or stripped ("downgrade")."""
        policy = self.scheduler.admission_policy
        if policy is not None and r.deadline_s is not None:
            mine = request_rank(r)
            ahead = len(self._slots) + len(self._prefilling) + sum(
                1 for q in self._queue if request_rank(q) <= mine)
            remaining = r.deadline_s - (time.perf_counter() - r.submit_s)
            if not self.scheduler.deadline_feasible(
                    deadline_s=remaining, ahead=ahead, priority=r.priority):
                if policy == "reject":
                    self._terminal(
                        r, "rejected",
                        f"deadline_infeasible: {ahead} requests ahead at "
                        f"the measured class service rate cannot finish "
                        f"within {remaining:.3f}s")
                    return
                r.deadline_s = None
        r.enqueue_s = time.perf_counter()
        self._queue.append(r)

    def queue_depth(self) -> int:
        """Requests waiting in the engine's own queue (resumes included)."""
        return len(self._queue)

    @property
    def pending(self) -> bool:
        """Work outstanding: queued, prefilling or decoding requests."""
        return bool(self._queue or self._slots or self._prefilling)

    def step(self) -> None:
        """Execute one scheduler plan: admissions and prompt chunks first,
        then one decode round of ``plan.decode_steps`` fused steps."""
        slots, free, prefilling = self._slots, self._free, self._prefilling
        # repro's chaos-cancel seam (here) and its decode-fault recovery
        # (around the round below) are not ported: faults are a later slice
        min_headroom = min(
            (r.max_new_tokens - self._scanned.get(s, 0)
             for s, r in slots.items()), default=None)
        plan = self.scheduler.plan_step(
            n_active=len(slots), prefilling=prefilling,
            try_admit=lambda: self._try_admit(slots, free, prefilling),
            min_headroom=min_headroom,
            try_preempt=lambda: self._try_preempt(slots))
        for c in plan.chunks:
            self._run_chunk(c, prefilling, slots)
        if self._pending_swaps:
            # swap-outs left their host copies in flight; the plan and the
            # chunks above overlapped them. Finish them before anything can
            # read a checkpoint.
            for h in self._pending_swaps:
                h.resolve()
            self._pending_swaps.clear()
        if slots or prefilling:
            self.peak_active_slots = max(self.peak_active_slots,
                                         len(slots) + len(prefilling))
        if slots:
            self._decode_round(slots, free, self._done, plan.decode_steps)

    def run(self) -> Dict[int, Request]:
        """Serve until the queue and all slots drain; returns every request
        finished since the last ``run``/``take_done``."""
        while self.pending:
            self.step()
        return self.take_done()

    def take_done(self) -> Dict[int, Request]:
        done, self._done = self._done, {}
        return done

    # -- device-side programs -------------------------------------------------
    def _arm(self, slot: int, *, pos: int, max_new: int, temp: float,
             rid: int, active: bool) -> None:
        st = self._state
        st["pos"][slot] = pos
        st["steps"][slot] = 0
        st["budget"][slot] = max_new
        st["temp"][slot] = temp
        st["rid"][slot] = rid
        st["active"][slot] = active

    def _admit_impl(self, tokens, length: int, slot: int, max_new: int,
                    temp: float, rid: int, table_row) -> None:
        """Prefill one bucketed prompt and install it into ``slot``. True
        lengths are threaded only for windowed models (a window-wide ring
        would otherwise keep the padded bucket's tail)."""
        lengths = (torch.full((1,), length, dtype=torch.int32,
                              device=self.device)
                   if self._windowed else None)
        logits, one_caches = self.lm.prefill(
            self.params, {"tokens": tokens}, cache_width=self.max_seq_len,
            lengths=lengths, logits_index=length - 1)
        self._cache_state = self.backend.prefill_fill(
            self._cache_state, one_caches, slot, length, table_row)
        self._state["last"][slot] = logits[0, 0].float()
        self._arm(slot, pos=length, max_new=max_new, temp=temp, rid=rid,
                  active=max_new > 0)

    def _chunk_impl(self, tokens, start: int, length: int, slot: int,
                    prompt_len: int, max_new: int, temp: float, rid: int,
                    final: bool, ctx: int) -> None:
        """Run one prompt chunk for ``slot``: install its K/V through the
        slot's cache view and, on the final chunk, arm the slot for decode
        with the last real token's logits. ``ctx`` bounds the visible cache
        to the live prefix: the chunk sees nothing at or above its own
        padded end."""
        view, tables = self.backend.slot_view(self._cache_state, slot, ctx)
        t = tokens.shape[1]
        valid = (torch.arange(t, device=self.device) < length)[None, :]
        logits, view = self.lm.prefill_chunk(
            self.params, view, tokens,
            torch.full((1,), start, dtype=torch.int32, device=self.device),
            layout=self.backend.layout, block_tables=tables, valid=valid,
            logits_index=torch.full((1,), length - 1, dtype=torch.int32,
                                    device=self.device))
        self._cache_state = self.backend.slot_update(self._cache_state, slot,
                                                     view)
        if final:
            self._state["last"][slot] = logits[0, 0].float()
        self._arm(slot, pos=prompt_len, max_new=max_new, temp=temp, rid=rid,
                  active=final and max_new > 0)

    def _step_impl(self) -> None:
        """Fused decode step on the device: sample -> append -> attend ->
        done-detect, for every slot (inactive rows compute but neither
        write the cache nor emit)."""
        st = self._state
        active = st["active"]
        keys = request_keys(self.seed, st["rid"], st["steps"])
        nxt = sample_logits_keyed(keys, st["last"], st["temp"])
        rows = torch.arange(self.batch_slots, device=self.device)
        idx = torch.clamp(st["steps"], 0, self.max_seq_len - 1).long()
        st["out"][rows, idx] = torch.where(active, nxt, st["out"][rows, idx])
        steps = st["steps"] + active.to(torch.int32)
        feed = torch.where(active, nxt, torch.zeros_like(nxt))[:, None]
        logits, _ = self.lm.decode_step(
            self.params, self._cache_state["caches"], feed, st["pos"],
            layout=self.backend.layout,
            block_tables=self._cache_state["tables"], valid=active[:, None])
        finished = steps >= st["budget"]
        if self.eos_id is not None:
            finished |= nxt == self.eos_id
        st["last"] = logits[:, 0, :].float()
        st["pos"] = st["pos"] + active.to(torch.int32)
        st["steps"] = steps
        st["active"] = active & ~finished

    # -- host-side management -------------------------------------------------
    def _try_admit(self, slots, free, prefilling):
        """Scheduler admission callback: grant the best-ranked waiting
        request a slot plus its cache reservation, or return None. Ordering
        is strict: a lower class never backfills in front of a blocked
        higher one. A request that could never fit an idle pool is
        rejected (``exceeds_pool_capacity``). Chunked admissions return a
        ``PrefillProgress``; monolithic and swap-resumed ones MONOLITHIC.
        (``repro``'s fault seams, the backoff filter and the pool and
        swap-in faults, are not ported: faults are a later slice.)"""
        if not free:
            return None
        while True:
            if not self._queue:
                return None
            r = min(self._queue, key=request_rank)
            if not self.backend.can_ever_admit(len(r.prompt),
                                               r.max_new_tokens):
                self._queue.remove(r)
                self._terminal(
                    r, "rejected",
                    f"exceeds_pool_capacity: prompt {len(r.prompt)} + "
                    f"budget {r.max_new_tokens} needs more KV blocks than "
                    f"the whole pool holds; enlarge num_pool_blocks")
                continue
            break
        if r.resume is not None and r.resume.kv is not None:
            # swap path: restore the checkpointed blocks, no prefill at all
            if not self.backend.can_resume(len(r.prompt), r.max_new_tokens):
                return None
            self._queue.remove(r)
            slot = free.pop()
            self._cache_state = self.backend.swap_in(
                self._cache_state, slot, r.resume.kv, len(r.prompt),
                r.max_new_tokens)
            self._note_grant(r)
            self._arm_resumed(r, slot, slots)
            return MONOLITHIC
        # fresh admission, or recompute-resume (re-prefill prompt + the
        # generated tokens; the decode checkpoint is restored at arming)
        tokens = r.prompt if r.resume is None else np.concatenate(
            [r.prompt, r.resume.tokens]).astype(np.int32)
        remaining = r.max_new_tokens - (r.resume.steps if r.resume else 0)
        key = tokens if (self._admit_with_tokens and r.resume is None) \
            else len(tokens)
        if not self.backend.can_admit(key, remaining):
            return None
        self._queue.remove(r)
        slot = free.pop()
        if not self.scheduler.chunked:
            self._admit(r, slot, slots, tokens, remaining)
            return MONOLITHIC
        table_row = self.backend.alloc_slot(slot, key, remaining)
        start = self.backend.shared_prefill_start(slot)
        shared_blocks = self.backend.shared_block_count(slot)
        for src, dst in self.backend.take_pending_copies():
            self._cache_state = self.backend.copy_block(self._cache_state,
                                                        src, dst)
        self._cache_state = self.backend.begin_slot(
            self._cache_state, slot, table_row, shared_blocks)
        self._note_grant(r)
        self.prefill_tokens_total += len(tokens)
        self.prefill_tokens_skipped += start
        pp = PrefillProgress(request=r, slot=slot, next=start,
                             total=len(tokens),
                             tokens=tokens if r.resume is not None else None)
        prefilling[slot] = pp
        return pp

    def _run_chunk(self, c, prefilling, slots) -> None:
        pp = prefilling[c.slot]
        r = pp.request
        src = pp.tokens if pp.tokens is not None else r.prompt
        self.planned_token_slots += c.bucket
        self.useful_prefill_tokens += c.length
        tokens = np.zeros((1, c.bucket), np.int32)
        tokens[0, :c.length] = src[c.start:c.start + c.length]
        # context bound: the next power of two covering the padded chunk end
        ctx = min(self.max_seq_len, _next_pow2(c.start + c.bucket))
        self._chunk_impl(torch.from_numpy(tokens).to(self.device), c.start,
                         c.length, c.slot, len(src), r.max_new_tokens,
                         r.temperature, r.request_id, c.final, ctx)
        pp.next = c.start + c.length
        if c.final:
            del prefilling[c.slot]
            if r.resume is None:
                # the slot's full prompt blocks now hold real K/V: publish
                # them for sharing (a resumed request's stream includes
                # generated tokens, never published as a prompt)
                self.backend.register_prefix(c.slot, r.prompt)
                self._scanned[c.slot] = 0
            else:
                self._restore_checkpoint(r, c.slot)
            slots[c.slot] = r

    def _admit(self, r: Request, slot: int, slots: Dict[int, Request],
               tokens_1d: np.ndarray, remaining: int) -> None:
        """Monolithic admission: prefill ``tokens_1d`` (the prompt, or
        prompt + generated on a recompute-resume) into the slot and arm it
        for decode. ``remaining`` sizes the cache reservation."""
        length = len(tokens_1d)
        bucket = bucket_for(length, self.buckets)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :length] = tokens_1d                   # right-pad (exact)
        table_row = self.backend.alloc_slot(slot, length, remaining)
        self._admit_impl(torch.from_numpy(tokens).to(self.device), length,
                         slot, r.max_new_tokens, r.temperature, r.request_id,
                         table_row)
        self._note_grant(r)
        self.prefill_tokens_total += length
        self.planned_token_slots += bucket
        self.useful_prefill_tokens += length
        if r.resume is None:
            self._scanned[slot] = 0
        else:
            self._restore_checkpoint(r, slot)
        slots[slot] = r

    def _edit_state(self, **rows) -> None:
        """Single-slot state edits, written into the device rows in place
        (``repro`` round-trips whole arrays through the host to avoid an
        XLA compile per shape; eager PyTorch has none)."""
        for key, (slot, value) in rows.items():
            dst = self._state[key]
            dst[slot] = torch.as_tensor(np.asarray(value), dtype=dst.dtype,
                                        device=dst.device)

    def _restore_checkpoint(self, r: Request, slot: int) -> None:
        """Re-arm a resumed slot's decode state: step counter, generated
        tokens and the saved ``last`` logits, so the next sampled token is
        exact whichever way the K/V came back."""
        rs = r.resume
        out = np.zeros((self.max_seq_len,), np.int32)
        out[:rs.steps] = rs.tokens
        self._edit_state(steps=(slot, rs.steps), last=(slot, rs.last),
                         out=(slot, out))
        self._scanned[slot] = rs.steps
        r.resume = None

    def _arm_resumed(self, r: Request, slot: int, slots) -> None:
        """Swap-path resume: the K/V blocks are already back, so the whole
        slot state is armed from the host; no prefill runs."""
        rs = r.resume
        self._edit_state(pos=(slot, len(r.prompt) + rs.steps),
                         budget=(slot, r.max_new_tokens),
                         temp=(slot, r.temperature),
                         rid=(slot, r.request_id),
                         active=(slot, rs.steps < r.max_new_tokens))
        self._restore_checkpoint(r, slot)
        slots[slot] = r

    def _rollback_slot(self, slot: int) -> Request:
        """Evict ``slot`` to a host checkpoint: decode state (generated
        tokens, step count, next-sample logits) to the host, and the cache
        swapped out (paged: the blocks return to the pool, the host copy
        finishes after the next plan) or freed for a recompute-resume.
        (``repro``'s swap-out fault seam is not ported.)"""
        r = self._slots.pop(slot)
        st = self._state
        steps = int(st["steps"][slot])
        r.resume = _ResumeState(
            steps=steps,
            tokens=st["out"][slot, :steps].cpu().numpy().copy(),
            last=st["last"][slot].cpu().numpy().copy())
        self._edit_state(active=(slot, False))
        if self._preempt_swap:
            r.resume.kv, self._cache_state = self.backend.swap_out(
                self._cache_state, slot)
            self._pending_swaps.append(r.resume.kv["caches"])
        else:
            self._cache_state = self.backend.free_slot(self._cache_state,
                                                       slot)
        self._scanned.pop(slot, None)
        self._free.append(slot)
        return r

    def preempt(self, slot: int) -> None:
        """Evict the request decoding in ``slot`` and requeue it; it
        resumes token for token. Called under SLO pressure; public so
        drivers and tests can force preemption schedules."""
        r = self._rollback_slot(slot)
        r.preemptions += 1
        self.preemptions += 1
        self._queue.append(r)

    def _try_preempt(self, slots) -> bool:
        """Scheduler preemption callback: when the best-ranked waiting
        request is blocked, evict the worst-ranked decoding slot, strictly
        lower class only, and only if the blocks eviction could ever
        recover cover the blocked request's worst case."""
        if not self._queue or not slots:
            return False
        blocked = min(self._queue, key=request_rank)
        if not self.backend.preemption_can_cover(
                len(blocked.prompt), blocked.max_new_tokens,
                [s for s, req in slots.items()
                 if req.priority < blocked.priority]):
            return False
        victim = max(slots, key=lambda s: request_rank(slots[s]))
        if slots[victim].priority >= blocked.priority:
            return False
        self.preempt(victim)
        return True

    def _reserve_lookahead(self, slots, k: int) -> None:
        """Top every decoding slot's reservation up to ``pos + k`` tokens
        before a K-step round, so every append in the round lands in an
        allocated block (reserved up front, as ``repro`` must inside its
        scan). All slots that crossed a block boundary are installed in one
        ``begin_slots`` update."""
        ups = []
        for slot, r in slots.items():
            row, covered = self.backend.reserve_lookahead(
                slot, len(r.prompt) + self._scanned[slot] + k)
            if row is not None:
                ups.append((slot, row, covered))
        if not ups:
            return
        self.lookahead_dispatches += 1
        s, rows, cov = zip(*ups)
        self._cache_state = self.backend.begin_slots(
            self._cache_state, list(s), np.stack(rows), list(cov))

    def _note_grant(self, r: Request) -> None:
        """Slot-grant bookkeeping shared by every admission path; the first
        admission stamp is sticky across preemption."""
        self.admissions += 1
        r.status = "active"
        if r.admit_s == 0.0:
            r.admit_s = time.perf_counter()

    def _terminal(self, r: Request, status: str, reason: Optional[str],
                  output: Optional[np.ndarray] = None) -> None:
        r.status = status
        r.failure_reason = reason
        if r.output is None:
            r.output = output if output is not None \
                else np.zeros((0,), np.int32)
        r.finish_s = time.perf_counter()
        r.latency_s = r.finish_s - r.submit_s
        self._status_counts[status] += 1
        self._done[r.request_id] = r

    def cancel(self, request_id: int) -> bool:
        """Cancel a request wherever it lives: queued (preempted included),
        mid-prefill or mid-decode. Its slot and blocks are released at
        once, partial output is kept, and it lands in ``run()``'s results
        with status "cancelled". False when the id is not in flight."""
        for r in self._queue:
            if r.request_id == request_id:
                self._queue.remove(r)
                out = (r.resume.tokens if r.resume is not None
                       else np.zeros((0,), np.int32))
                r.resume = None
                self._terminal(r, "cancelled", "cancelled: while queued",
                               output=out)
                return True
        for slot, pp in list(self._prefilling.items()):
            if pp.request.request_id == request_id:
                del self._prefilling[slot]
                # the installed chunks are abandoned: the blocks return to
                # the pool and the next tenant's begin_slot wipes them
                self._cache_state = self.backend.free_slot(
                    self._cache_state, slot)
                self._free.append(slot)
                r = pp.request
                out = (r.resume.tokens if r.resume is not None
                       else np.zeros((0,), np.int32))
                r.resume = None
                self._terminal(r, "cancelled", "cancelled: mid-prefill",
                               output=out)
                return True
        for slot, r in list(self._slots.items()):
            if r.request_id == request_id:
                self._slots.pop(slot)
                st = self._state
                steps = int(st["steps"][slot])
                out = st["out"][slot, :steps].cpu().numpy().copy()
                self._edit_state(active=(slot, False))
                self._cache_state = self.backend.free_slot(
                    self._cache_state, slot)
                self._scanned.pop(slot, None)
                self._free.append(slot)
                self._terminal(r, "cancelled", "cancelled: mid-decode",
                               output=out)
                return True
        return False

    def metrics(self) -> Dict[str, object]:
        """Monitoring snapshot: live/terminal request counts and the core
        serving counters."""
        return {
            "live": {"queued": len(self._queue),
                     "prefilling": len(self._prefilling),
                     "decoding": len(self._slots)},
            "terminal": dict(self._status_counts),
            "admissions": self.admissions,
            "preemptions": self.preemptions,
            "generated_tokens": self.generated_tokens,
            "prefill_tokens_total": self.prefill_tokens_total,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "decode_steps": self.decode_steps,
            "host_syncs": self.host_syncs,
            "lookahead_dispatches": self.lookahead_dispatches,
            "decode_s": self.decode_s,
            "peak_active_slots": self.peak_active_slots,
            "occupancy": self.occupancy(),
            "deadline_hits": self.scheduler.deadline_hit_rates(),
        }

    def _decode_round(self, slots, free, done, k: int = 1) -> None:
        t0 = time.perf_counter()
        # repro's hang and decode-fault seams sit here; faults are a later
        # slice of the port
        self._reserve_lookahead(slots, k)
        for _ in range(k):
            self._step_impl()
        self.decode_steps += k
        self.host_syncs += 1
        self.planned_token_slots += len(slots) * k
        for slot in slots:
            self._scanned[slot] += k
        self._finish_round(slots, free, done)
        self.decode_s += time.perf_counter() - t0

    def _finish_round(self, slots, free, done) -> None:
        """Post-round bookkeeping: TTFT stamps and completions. The
        active-mask transfer is the round's one host sync."""
        active = self._state["active"].cpu().numpy()
        now = time.perf_counter()
        for r in slots.values():
            if r.ttft_s == 0.0 and r.max_new_tokens > 0:
                r.ttft_s = now - r.submit_s
        finished = [s for s in slots if not active[s]]
        if not finished:
            return
        steps_h = self._state["steps"].cpu().numpy()
        out_h = self._state["out"].cpu().numpy()
        for slot in finished:
            r = slots.pop(slot)
            self._scanned.pop(slot, None)
            n = int(steps_h[slot])
            r.output = np.array(out_h[slot, :n])
            r.status = "done"
            r.finish_s = time.perf_counter()
            r.latency_s = r.finish_s - r.submit_s
            self.generated_tokens += n
            self._status_counts["done"] += 1
            self.scheduler.observe_service(r.priority,
                                           r.finish_s - r.admit_s)
            if r.deadline_s is not None:
                self.scheduler.observe_deadline(
                    r.priority, r.latency_s <= r.deadline_s)
            self._cache_state = self.backend.free_slot(self._cache_state,
                                                       slot)
            free.append(slot)
            done[r.request_id] = r

    # -- stats ----------------------------------------------------------------
    def occupancy(self) -> float:
        """Useful tokens per scheduled token-slot: decode rounds schedule
        ``len(slots) x K`` token-slots, prompt work its padded bucket."""
        useful = self.generated_tokens + self.useful_prefill_tokens
        return useful / max(self.planned_token_slots, 1)

    def hbm_bytes(self) -> int:
        """Device-resident KV-cache footprint of this engine."""
        return self.backend.hbm_bytes()

    def assert_invariants(self) -> None:
        """The backend's allocator invariants, checked against the live
        device tables (no mesh in the port yet)."""
        self.backend.assert_invariants(self._cache_state)
