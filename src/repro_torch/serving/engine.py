"""Serving engine: continuous batching over per-slot request state.

Port of the core of ``repro.serving.engine.ServingEngine`` on the ring KV
cache. A fixed pool of ``batch_slots`` decode slots shares one device
cache; requests are admitted into free slots as others finish. A prompt is
right-padded to a power-of-two bucket and prefilled whole (the flash
kernel), its K/V copied into the slot's ring line, and its last real
token's logits armed for sampling. Each decode step samples, appends and
attends (the decode-attention kernel) for every slot on the device; with
``max_decode_steps=K`` the engine runs up to K such steps back to back and
synchronises with the host once per K tokens (the (B,) active mask), so
outputs are token-for-token those of K = 1.

Sampling keys are a pure function of (seed, request id, step), so sampled
streams do not depend on co-scheduling either.

Chunked prefill, speculative decoding, fault injection, snapshots, the
journal and meshes are later slices: their constructor arguments raise
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
from repro_torch.serving.kv_cache import make_backend
from repro_torch.serving.sampler import request_keys, sample_logits_keyed
from repro_torch.serving.scheduler import (MONOLITHIC, Scheduler, bucket_for,
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
    admit_s: float = 0.0         # wall-clock at slot grant
    finish_s: float = 0.0        # wall-clock at completion
    latency_s: float = 0.0       # finish - submit (queue + service)
    ttft_s: float = 0.0          # submit -> first generated token exists
    # "queued"/"active" while live, then one of done | rejected | cancelled
    status: str = "queued"
    failure_reason: Optional[str] = None
    enqueue_s: float = 0.0       # wall-clock at engine queue entry


def _has_windowed_blocks(lm: LM) -> bool:
    return any(bdef.window is not None
               for stage in lm.cfg.stages for bdef in stage.blocks)


def validate_prompt(prompt: np.ndarray, max_new_tokens: int,
                    max_seq_len: int, truncate: bool) -> np.ndarray:
    """Prompt + budget must fit the cache: raise, or with ``truncate`` keep
    the trailing ``max_seq_len - max_new_tokens`` prompt tokens."""
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
                 cache_backend="ring", truncate_prompts: bool = False,
                 max_decode_steps: int = 1,
                 admission_policy: Optional[str] = None,
                 chunk_tokens: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 draft_model=None, draft_params=None,
                 speculative_tokens: int = 0, fault_plan=None,
                 mesh=None, rules=None):
        later = {"chunk_tokens": chunk_tokens, "token_budget": token_budget,
                 "draft_model": draft_model, "draft_params": draft_params,
                 "speculative_tokens": speculative_tokens or None,
                 "fault_plan": fault_plan, "mesh": mesh, "rules": rules}
        for name, value in later.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}: chunked prefill, speculative decoding, fault "
                    f"injection and meshes are later slices of the port")
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
        self._done: Dict[int, Request] = {}
        # host mirror of each live slot's completed decode steps (exact at
        # every sync): the scheduler's budget headroom
        self._scanned: Dict[int, int] = {}
        # counters: decode_steps counts token rounds (a K-step round adds
        # K), host_syncs counts active-mask transfers (one per round),
        # decode_s the host wall time of decode rounds, sync included
        self.decode_steps = 0
        self.host_syncs = 0
        self.generated_tokens = 0
        self.peak_active_slots = 0
        self.admissions = 0
        self.decode_s = 0.0
        self.planned_token_slots = 0
        self.useful_prefill_tokens = 0
        self._status_counts = collections.Counter()
        self.backend = make_backend(cache_backend, lm,
                                    batch_slots=batch_slots,
                                    max_seq_len=max_seq_len)
        self.scheduler = Scheduler(batch_slots=batch_slots,
                                   max_decode_steps=max_decode_steps,
                                   admission_policy=admission_policy)
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

    # -- queue API ------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its id. ``priority`` is its SLO class
        (higher = admitted first); ``deadline_s`` orders within a class."""
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
            ahead = len(self._slots) + sum(
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

    @property
    def pending(self) -> bool:
        """Work outstanding: queued or decoding requests."""
        return bool(self._queue or self._slots)

    def step(self) -> None:
        """Execute one scheduler plan: admissions first, then one decode
        round of ``plan.decode_steps`` fused steps."""
        slots, free = self._slots, self._free
        min_headroom = min(
            (r.max_new_tokens - self._scanned.get(s, 0)
             for s, r in slots.items()), default=None)
        plan = self.scheduler.plan_step(
            n_active=len(slots), prefilling={},      # monolithic admission
            try_admit=lambda: self._try_admit(slots, free),
            min_headroom=min_headroom)
        if slots:
            self.peak_active_slots = max(self.peak_active_slots, len(slots))
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
    def _admit_impl(self, tokens, length: int, slot: int, max_new: int,
                    temp: float, rid: int) -> None:
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
            self._cache_state, one_caches, slot, length, None)
        st = self._state
        st["last"][slot] = logits[0, 0].float()
        st["pos"][slot] = length
        st["steps"][slot] = 0
        st["budget"][slot] = max_new
        st["temp"][slot] = temp
        st["rid"][slot] = rid
        st["active"][slot] = max_new > 0

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
            layout=self.backend.layout, valid=active[:, None])
        finished = steps >= st["budget"]
        if self.eos_id is not None:
            finished |= nxt == self.eos_id
        st["last"] = logits[:, 0, :].float()
        st["pos"] = st["pos"] + active.to(torch.int32)
        st["steps"] = steps
        st["active"] = active & ~finished

    # -- host-side management -------------------------------------------------
    def _try_admit(self, slots, free):
        """Scheduler admission callback: grant the best-ranked waiting
        request a slot and prefill it (MONOLITHIC), or return None."""
        if not free or not self._queue:
            return None
        r = min(self._queue, key=request_rank)
        if not self.backend.can_admit(len(r.prompt), r.max_new_tokens):
            return None
        self._queue.remove(r)
        self._admit(r, free.pop(), slots)
        return MONOLITHIC

    def _admit(self, r: Request, slot: int, slots: Dict[int, Request]):
        length = len(r.prompt)
        bucket = bucket_for(length, self.buckets)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :length] = r.prompt                    # right-pad (exact)
        self.backend.alloc_slot(slot, length, r.max_new_tokens)
        self._admit_impl(torch.from_numpy(tokens).to(self.device), length,
                         slot, r.max_new_tokens, r.temperature, r.request_id)
        r.admit_s = time.perf_counter()
        r.status = "active"
        self.admissions += 1
        self.planned_token_slots += bucket
        self.useful_prefill_tokens += length
        self._scanned[slot] = 0
        slots[slot] = r

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
        """Cancel a queued or decoding request: its slot is released at
        once, partial output is kept, and it lands in ``run()``'s results
        with status "cancelled". False when the id is not in flight."""
        for r in self._queue:
            if r.request_id == request_id:
                self._queue.remove(r)
                self._terminal(r, "cancelled", "cancelled: while queued")
                return True
        for slot, r in list(self._slots.items()):
            if r.request_id == request_id:
                self._slots.pop(slot)
                st = self._state
                steps = int(st["steps"][slot])
                out = st["out"][slot, :steps].cpu().numpy().copy()
                st["active"][slot] = False
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
            "live": {"queued": len(self._queue), "prefilling": 0,
                     "decoding": len(self._slots)},
            "terminal": dict(self._status_counts),
            "admissions": self.admissions,
            "generated_tokens": self.generated_tokens,
            "decode_steps": self.decode_steps,
            "host_syncs": self.host_syncs,
            "decode_s": self.decode_s,
            "peak_active_slots": self.peak_active_slots,
            "occupancy": self.occupancy(),
            "deadline_hits": self.scheduler.deadline_hit_rates(),
        }

    def _decode_round(self, slots, free, done, k: int = 1) -> None:
        t0 = time.perf_counter()
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
        ``len(slots) x K`` token-slots, prefills their padded bucket."""
        useful = self.generated_tokens + self.useful_prefill_tokens
        return useful / max(self.planned_token_slots, 1)
