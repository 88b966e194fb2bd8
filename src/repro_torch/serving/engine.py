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
token. Sampling keys fold (request id, step) into ``prng_key(seed)``
with JAX's threefry, as ``repro``'s do, so sampled streams do not depend on
co-scheduling, chunking or preemption either.

With a ``draft_model`` and ``speculative_tokens=k`` the engine speculates:
the draft proposes k tokens per slot on its own ring cache and the target
verifies them in one (k+1)-token chunk (``_spec_impl``). Verification is
key-coupled, so the streams are the non-speculative engine's at every
temperature.

The engine is chaos-hardened as ``repro``'s is: with a ``fault_plan``
(``serving.faults.FaultPlan``) its named seams (the decode dispatch
``step``/``scan``, the speculative ``draft``, ``swap_out``, ``swap_in``,
``pool``, the non-raising ``hang`` and chaos ``cancel``) are consulted in
``repro``'s order and count, so one plan fires at the same calls in both
packages. Recovery reuses preemption: a poisoned dispatch fails before its
program runs, so every decoding slot rolls back to a host checkpoint and
requeues with step-indexed exponential backoff; past ``max_retries`` a
request is quarantined (status ``failed``). A failed swap degrades to a
recompute-resume, a failed draft round is served plain. ``on_tokens`` taps
each round's new tokens after its one host sync (the gateway's stream).
``snapshot``/``restore`` carry every request across a process restart in
``repro``'s wire format (``save_snapshot``/``load_snapshot``, the .npz
envelope of ``repro_torch.checkpoint``): live slots resume token for token
from their decode checkpoint and, on the paged backend, their K/V.

With ``mesh`` (a ``launch.mesh.HostMesh``) the engine serves
tensor-parallel, one process per rank (SPMD): every rank runs this same
host scheduler on the same calls and holds its shards, the params cut by
the decode-mode rules (``serving.sharding.place_params``) and the K/V
pools split on the KV-head dim where it divides; tables, positions and
the allocator stay whole on every rank. The model's collectives leave
every rank the same full logits, so the same keys sample the same tokens
everywhere, and ``assert_invariants`` checks that the ranks' streams and
host state agree. The draft rides the same mesh. A snapshot gathers the
KV heads into ``repro``'s host-global wire format and a restore takes
this rank's shard of it, so snapshots cross between a mesh and
``mesh=None`` both ways; a swap or a fault rollback keeps each rank's
own shard. Under NCCL ``warm_compile`` captures each rank's programs
with their collectives inside; gloo's cannot be captured, so a gloo mesh
on the card serves eager and ``warm_compile`` raises. Dense GQA, MoE
(experts split by expert or by d_ff, the router's logits gathered before
the top-k), MLA (heads split, latents whole on every rank, so a
snapshot takes them from any rank), RG-LRU (its width split, the state a
rank's channels) and xLSTM (heads split, the states a rank's heads; the
ring engine's snapshots carry no state, so a restore recomputes it)
models; the recurrent ones keep their one-device limits (ring backend,
monolithic prefill, no speculation). A split whose query heads straddle
KV groups raises ``NotImplementedError`` at construction
(``sharding.tensor_parallel``).
``params`` may be whole or already this rank's shards (``LM.init(...,
mesh=)``). ``rules`` (``repro``'s activation hints) are accepted and
dropped: explicit collectives make them moot.

Where ``repro`` jits its serving programs for XLA (the single step, the
K-step scan, the speculative round, the admission per bucket, the prompt
chunk per (bucket, context), the draft fill per bucket), the port keeps a
registry of programs keyed the same way. On the card each is captured
once as a CUDA graph (``warm_compile`` captures them all before traffic)
and replayed; the engine's state, caches, tables and staged arguments
keep their storage for the engine's life, so the graphs' fixed addresses
stay valid, and a program reads the request it serves (slot, length,
tokens, ...) from the staged arguments, never from a Python scalar that a
capture would freeze. On the CPU each program is the eager call.

``DrainBatchEngine`` is the static batcher that continuous batching is
measured against.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (json_leaf, json_unleaf,
                                       load_checkpoint_tree, save_checkpoint)
from repro_torch.kernels import (FLOPS, LAUNCHES, build, cascade_gate,
                                 rglru_scan)
from repro_torch.launch.mesh import (COLLECTIVE_BYTES, COLLECTIVES, HostMesh,
                                     same_device)
from repro_torch.models.model import LM
from repro_torch.sharding import tensor_parallel
from repro_torch.serving.faults import FaultError, FaultPlan
from repro_torch.serving.kv_cache import (RingCache, RingLayout,
                                          _map_block_dicts, host_tensor,
                                          make_backend)
from repro_torch.serving.sampler import (accepted_prefix_length, prng_key,
                                         request_keys, sample_logits_batch,
                                         sample_logits_keyed, split)
from repro_torch.serving.scheduler import (MONOLITHIC, PrefillProgress,
                                           Scheduler, bucket_for,
                                           prompt_buckets, request_rank)
from repro_torch.serving.sharding import assert_cache_placement, place_params
from repro_torch.utils.tree import flat_paths


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
    # "queued"/"active" while live, then one of done | failed (retry
    # budget exhausted) | rejected | cancelled
    status: str = "queued"
    failure_reason: Optional[str] = None
    retries: int = 0             # fault-triggered rollbacks so far
    last_fault: Optional[str] = None  # seam of the most recent fault
    downgraded: bool = False     # deadline stripped by admission control
    not_before_step: int = 0     # backoff: ineligible before this step
    fault_s: float = 0.0         # wall-clock of the last fault requeue
    #                              (recovery latency = next grant - fault_s)
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


def _any_sampled(slots) -> bool:
    """Whether any decoding slot samples at a temperature above 0."""
    return any(r.temperature > 0.0 for r in slots.values())


class _Program:
    """One program of an engine (a decode round, an admission, a prompt
    chunk, a draft fill, the cascade's gate, a drain batch's prefill or
    step), captured as a CUDA graph.

    Capture records the launches; it executes nothing. A replay runs the
    kernels without calling their wrappers, so the ``LAUNCHES`` (and
    ``FLOPS``) that the capture recorded are taken back out at capture and
    added on every replay: the counters still say what ran on the card. The graph shares
    its engine's memory pool, and no tensor of that pool outlives a
    replay (every program writes its results into the engine's state).
    Captures run on one stream per device (``capture_stream``), whose
    kernel state (the scan's look-back, the gate's counting workspace) is
    made before the first capture.

    Destroying a CUDA graph while another one captures invalidates the
    capture, and the collector may free an unreachable engine's graphs at
    any allocation: so the collector is off during a capture. The capture
    is begun and ended directly rather than through ``torch.cuda.graph``,
    which empties the allocator's cache (and may collect) before every
    capture: an engine captures dozens of programs in a row.

    On a mesh (``meshed``) the program's NCCL collectives are captured with
    it, counted in ``collectives`` by kind and axis as launches are
    (``launch.mesh.COLLECTIVES``, their bytes in ``collective_bytes``), and
    the capture is thread-local: the process group's watchdog thread polls
    its events while a capture is open."""

    def __init__(self, key, pool, stream, body, meshed: bool = False):
        rglru_scan.prepare_stream(stream.device, stream)
        cascade_gate.prepare_stream(stream.device, stream)
        before = dict(LAUNCHES)
        before_f = dict(FLOPS)
        before_c = dict(COLLECTIVES)
        before_b = dict(COLLECTIVE_BYTES)
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.synchronize(stream.device)
            with torch.cuda.stream(stream):
                if meshed:
                    self.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                else:
                    self.graph.capture_begin(pool=pool)
                try:
                    body()
                finally:
                    self.graph.capture_end()
        except RuntimeError as err:
            raise RuntimeError(f"capturing the program {key} as a CUDA "
                               f"graph failed: {err}") from err
        finally:
            if collecting:
                gc.enable()
            self.launches = {name: LAUNCHES[name] - n
                             for name, n in before.items()
                             if LAUNCHES[name] != n}
            LAUNCHES.update(before)
            self.flops = {name: FLOPS[name] - n for name, n in
                          before_f.items() if FLOPS[name] != n}
            FLOPS.update(before_f)
            self.collectives, self.collective_bytes = (
                {name: n - was.get(name, 0) for name, n in now.items()
                 if n != was.get(name, 0)}
                for now, was in ((COLLECTIVES, before_c),
                                 (COLLECTIVE_BYTES, before_b)))
            for now, was in ((COLLECTIVES, before_c),
                             (COLLECTIVE_BYTES, before_b)):
                now.clear()
                now.update(was)

    def replay(self, key) -> None:
        try:
            self.graph.replay()
        except RuntimeError as err:
            raise RuntimeError(f"replaying the program {key} failed: "
                               f"{err}") from err
        for name, n in self.launches.items():
            LAUNCHES[name] += n
        for name, n in self.flops.items():
            FLOPS[name] += n
        for counts, add in ((COLLECTIVES, self.collectives),
                            (COLLECTIVE_BYTES, self.collective_bytes)):
            for name, n in add.items():
                counts[name] = counts.get(name, 0) + n


_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The one stream of ``device`` that every engine captures on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


class _GraphedPrograms:
    """An engine's registry of programs, keyed by tuples whose first entry
    names the body (``_program_body(key)``). On the card each program is
    captured once as a CUDA graph in one memory pool per engine and
    replayed; on the CPU, or with ``_use_graphs`` off (eager A/B legs), it
    is the eager call (registered as None). The subclass sets ``device``
    and calls ``_init_programs`` in its constructor."""

    def _init_programs(self) -> None:
        self._programs: Dict[tuple, Optional[_Program]] = {}
        self._use_graphs = self.device.type == "cuda"
        self._graph_pool = None

    def _program_body(self, key) -> None:
        raise NotImplementedError

    def _build_program(self, key) -> Optional[_Program]:
        """Register program ``key``: on the card, captured into the
        engine's graph pool (a failed capture raises and registers
        nothing); else the eager call."""
        prog = None
        if self._use_graphs:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            try:
                prog = _Program(key, self._graph_pool,
                                capture_stream(self.device),
                                lambda: self._program_body(key),
                                meshed=getattr(self, "mesh", None)
                                is not None)
            except RuntimeError:
                # the allocator still counts a failed capture's pool as
                # recording: later programs capture into a fresh pool
                self._graph_pool = None
                raise
        self._programs[key] = prog
        return prog

    def _run_program(self, key) -> None:
        """Run a program: replay its graph, capturing it first if
        ``warm_compile`` did not (capture executes nothing, so the state is
        untouched until the replay), or call it eagerly."""
        prog = (self._programs[key] if key in self._programs
                else self._build_program(key))
        if prog is None:
            self._program_body(key)
        else:
            prog.replay(key)

    def _warm_programs(self, keys) -> None:
        """Register (capture) each program of ``keys`` not yet registered,
        in order, after one eager run for each shape: programs that differ
        only in a chunk's context bound or a greedy or sampled draw run the
        same GEMMs and kernels (the last such key runs), and every decode
        program repeats one sampled step. On the card the eager runs go to
        the capture stream, so libraries, handles, allocator blocks and
        that stream's kernel state exist, at the sizes these programs
        need, before any capture."""
        keys = [key for key in keys if key not in self._programs]
        shapes = list({
            key[:1] if key[0] == "decode" else key[:2]:
            ("decode", 1, True) if key[0] == "decode" else key
            for key in keys}.values())
        if self.device.type == "cuda":
            gc.collect()                 # once, not before every capture
            stream = capture_stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for key in shapes:
                    self._program_body(key)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            # the eager runs leave the caching allocator holding blocks
            # sized for the largest shapes, on this stream and the
            # caller's; a graph pool cannot draw on them, so they are
            # handed back before the captures fill the engine's pool
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        else:
            for key in shapes:
                self._program_body(key)
        for key in keys:
            self._build_program(key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def graphs(self) -> int:
        """Programs captured as CUDA graphs."""
        return sum(p is not None for p in self._programs.values())

    def graph_pool_bytes(self) -> int:
        """Device bytes the engine's graph memory pool holds."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)


class _DeviceClock:
    """Seconds of device work per counter, read without adding a host
    sync. On the card a span is a pair of CUDA events on the current
    stream: it runs on the device's clock from the start event (work
    queued before the span is not in it) to the end event, and is added
    to its counter once a later sync has passed both (``settle``). On the
    CPU, where every op is synchronous, a span is host wall time."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self._seconds: Dict[str, float] = collections.defaultdict(float)
        self._open: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self._cuda:
            t0 = time.perf_counter()
            yield
            self._seconds[name] += time.perf_counter() - t0
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self._open.append((name, start, end))

    def settle(self, wait: bool = False) -> None:
        """Add the open spans to their counters: after a host sync that
        passed them, or, with ``wait``, once their end events complete."""
        for name, start, end in self._open:
            if wait:
                end.synchronize()
            self._seconds[name] += start.elapsed_time(end) / 1e3
        self._open.clear()

    def seconds(self, name: str) -> float:
        self.settle(wait=True)
        return self._seconds[name]


class _Staged:
    """Program arguments at fixed device addresses: one int32 device
    buffer cut into named fields (float fields hold float32 bits), and a
    pinned host twin. ``put`` writes the given fields on the host and
    moves the whole buffer in one copy ahead of the program that reads
    it, in stream order. The twin is not rewritten while its last copy
    may still be in flight: ``put`` first waits on that copy's event (the
    copy, not the program after it)."""

    def __init__(self, device, floats=(), **sizes):
        self._at, n = {}, 0
        for name, size in sizes.items():
            self._at[name] = (n, size)
            n += size
        self._floats = set(floats)
        cuda = device.type == "cuda"
        self.dev = torch.zeros((n,), dtype=torch.int32, device=device)
        self._host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        self._np = self._host.numpy()
        self._copied = torch.cuda.Event() if cuda else None
        self._in_flight = False

    def __getitem__(self, name: str) -> torch.Tensor:
        at, size = self._at[name]
        view = self.dev[at:at + size]
        return view.view(torch.float32) if name in self._floats else view

    def put(self, **values) -> None:
        if self._in_flight:
            self._copied.synchronize()
        for name, value in values.items():
            at, size = self._at[name]
            seg = self._np[at:at + size]
            if name in self._floats:
                seg = seg.view(np.float32)
            value = np.asarray(value).reshape(-1)
            seg[:len(value)] = value
            seg[len(value):] = 0
        self.dev.copy_(self._host, non_blocking=self._copied is not None)
        if self._copied is not None:
            self._copied.record()
            self._in_flight = True


def _has_windowed_blocks(lm: LM) -> bool:
    return any(bdef.window is not None
               for stage in lm.cfg.stages for bdef in stage.blocks)


def check_text_model(lm: LM, role: str = "engine") -> None:
    """The engines serve text-token streams. Audio is refused with
    ``repro``'s messages ("engine serves text-token streams", "draft model
    must serve text-token streams"). ``repro``'s engines accept a vision
    model and then fail on it with a ``KeyError`` on ``image_embeds``: its
    cache backend traces a prefill of tokens alone for the cache's
    structure, as its monolithic admission and its drain batcher prefill
    tokens alone, and its chunked prefill embeds the text without the
    image. No path takes a per-request image, so the port refuses vision
    at construction."""
    kind = lm.cfg.frontend.kind
    if kind == "audio":
        raise NotImplementedError(
            "engine serves text-token streams" if role == "engine"
            else f"{role} must serve text-token streams")
    if kind == "vision":
        raise NotImplementedError(
            f"{role}: a vision model's image prefix has no per-request "
            f"path: repro's engines prefill tokens alone (KeyError on "
            f"'image_embeds') and its chunked prefill embeds the text "
            f"without the image; serve vision through LM.prefill / "
            f"decode_step or CascadeEngine.query(tokens, "
            f"extra={{'image_embeds': ...}})")


def _needs_lengths(lm: LM) -> bool:
    """Whether a right-padded prefill must know the true lengths: a
    window-wide ring would keep pad rows, and recurrent state would fold
    the pads in."""
    return _has_windowed_blocks(lm) or lm.chunk_incompatible_mixer() \
        is not None


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


class ServingEngine(_GraphedPrograms):
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
                 speculative_tokens: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: int = 3,
                 backoff_base_steps: int = 1,
                 backoff_cap_steps: int = 8,
                 mesh=None, rules=None):
        check_text_model(lm)
        self.lm = lm
        self.params = params
        self.device = lm.device
        # tensor-parallel serving: this rank's shards of the params (and,
        # below, of the pools); mesh=None keeps every one-device path
        self.mesh = mesh
        del rules
        if mesh is not None:
            if not isinstance(mesh, HostMesh):
                raise TypeError(f"mesh must be a launch.mesh.HostMesh (got "
                                f"{type(mesh).__name__})")
            tensor_parallel(lm.cfg, mesh)      # refuses what cannot split
            if not same_device(lm.device, mesh.device):
                raise ValueError(f"the model is on {lm.device}, this rank's "
                                 f"mesh device is {mesh.device}")
            self.params = place_params(mesh, lm, params)
        self.batch_slots = batch_slots
        self.max_seq_len = max_seq_len
        self.seed = seed
        self._base_key = prng_key(seed, device=lm.device)
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
        # admissions counts slot grants (resumes included); decode_s and
        # prefill_s are device time (``_DeviceClock``)
        self.decode_steps = 0
        self.host_syncs = 0
        self.generated_tokens = 0
        self.peak_active_slots = 0
        self.admissions = 0
        self._clock = _DeviceClock(self.device)
        self.prefill_tokens_total = 0
        self.prefill_tokens_skipped = 0
        self.planned_token_slots = 0
        self.useful_prefill_tokens = 0
        self.preemptions = 0
        self.lookahead_dispatches = 0   # decode rounds with table top-ups
        self.warm_compile_s: Optional[float] = None  # last warm_compile()
        self._pending_swaps: List[object] = []
        self._status_counts = collections.Counter()
        # fault tolerance: a fault rolls the affected slots back to their
        # host checkpoint and requeues them with exponential backoff
        # counted in engine steps (deterministic under test); past
        # ``max_retries`` a request is quarantined ("failed")
        self._faults = fault_plan
        self.max_retries = max_retries
        self.backoff_base_steps = backoff_base_steps
        self.backoff_cap_steps = backoff_cap_steps
        self._step_count = 0
        self.fault_recoveries = 0     # decode rounds rolled back
        self.retries_total = 0        # per-request retries, summed
        self.recovery_latencies: List[float] = []  # fault -> re-grant, s
        self.restores = 0             # restore()s into this engine
        self.hang_recoveries = 0      # watchdog escalations (note_hang)
        # the stream tap: after each round's host sync, called with the
        # round's new tokens [(request_id, np.ndarray), ...]. Monotone per
        # request: a rollback checkpoints every generated token, so a
        # resumed stream continues where it stopped
        self.on_tokens = None
        self._emitted: Dict[int, int] = {}     # rid -> tokens tapped
        # pinned host buffers a round's state reads land in (``_host``)
        self._pinned: Dict[str, torch.Tensor] = {}
        self._pulled = (torch.cuda.Event() if self.device.type == "cuda"
                        else None)
        if chunk_tokens is not None:
            self._validate_chunk_mixers(chunk_tokens)
        self.backend = make_backend(
            cache_backend, lm, batch_slots=batch_slots,
            max_seq_len=max_seq_len, block_size=block_size,
            num_blocks=num_pool_blocks, prefix_sharing=prefix_sharing)
        if chunk_tokens is not None:
            self._validate_chunk_layout()
        self.speculative = self._validate_speculation(
            draft_model, draft_params, speculative_tokens)
        self.scheduler = Scheduler(
            batch_slots=batch_slots, chunk_tokens=chunk_tokens,
            token_budget=token_budget, max_decode_steps=max_decode_steps,
            admission_policy=admission_policy,
            speculative_tokens=speculative_tokens if self.speculative else 0)
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
        if mesh is not None:
            self.backend.note_placement(mesh)
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
        # speculative accounting (zeroed without a draft too, so metrics()
        # keeps one shape): drafted = proposals issued (slots x k),
        # accepted = proposals the target kept, committed = accepted + the
        # anchor token every speculative round banks per slot
        self.spec_rounds = 0
        self.spec_slot_rounds = 0           # active slots summed over rounds
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_committed_tokens = 0
        self.spec_fallbacks = 0             # draft-seam faults served plain
        self._spec_class: Dict[int, tuple] = {}  # priority -> (drafted, acc)
        if self.speculative:
            self.draft_lm = draft_model
            self.draft_params = draft_params
            # the draft always rides a ring cache whatever the target's
            # backend: one max_seq_len line per slot is its whole state
            self._draft_backend = RingCache(draft_model,
                                            batch_slots=batch_slots,
                                            max_seq_len=max_seq_len)
            if mesh is not None:
                # the draft rides the same mesh, split by the same rules
                tensor_parallel(draft_model.cfg, mesh)
                self.draft_params = place_params(mesh, draft_model,
                                                 draft_params)
                self._draft_backend.note_placement(mesh)
            self._draft_state = self._draft_backend.init()
            # slots whose draft cache missed tokens that plain decode
            # rounds generated: re-synced by a draft prefill before the
            # next speculative round reads them
            self._draft_dirty: set = set()
        # the arguments of the admission, chunk and draft-fill programs,
        # staged at fixed addresses: the slot's scalars, the paged table
        # row (one dummy entry on the ring) and the bucketed tokens
        tables = self._cache_state["tables"]
        self._args = _Staged(
            dev, floats=("temp",), slot=1, length=1, start=1, prompt_len=1,
            max_new=1, rid=1, final=1, temp=1,
            row=1 if tables is None else tables.shape[1],
            tokens=max_seq_len)
        # programs by key: ("decode", K, sampled) runs K fused steps (K = 1
        # the single step), ("spec", k, sampled) one speculative round at
        # draft depth k, ("admit", bucket) a monolithic admission,
        # ("chunk", bucket, ctx) a prompt chunk and ("draft_fill", bucket)
        # a draft-cache fill. On the card each is a CUDA graph (a
        # _Program) in one memory pool per engine; on the CPU, or with
        # _use_graphs off (eager A/B legs), the eager call (None). A gloo
        # mesh's collectives run on the host: they cannot be captured
        self._init_programs()
        if mesh is not None and not mesh.capturable:
            self._use_graphs = False

    def _validate_chunk_mixers(self, chunk_tokens: int) -> None:
        if not (1 <= chunk_tokens <= self.max_seq_len):
            raise ValueError(f"chunk_tokens ({chunk_tokens}) must be in "
                             f"[1, max_seq_len={self.max_seq_len}]")
        bad = self.lm.chunk_incompatible_mixer()
        if bad is not None:
            raise NotImplementedError(
                f"chunked prefill needs attention mixers (got "
                f"{bad!r}); recurrent state folds tokens "
                f"sequentially — use chunk_tokens=None")

    def _validate_chunk_layout(self) -> None:
        if isinstance(self.backend.layout, RingLayout) and self._windowed:
            raise NotImplementedError(
                "chunked prefill over windowed layers needs the paged "
                "backend: a window-wide ring evicts tokens the chunk's own "
                "queries still attend to")

    def _validate_speculation(self, draft_model, draft_params,
                              speculative_tokens: int) -> bool:
        """``repro``'s checks of a draft, and one of the port's own: the
        verify chunk appends all k+1 tokens before it attends, so over a
        ring narrower than ``max_seq_len`` (a windowed layer's) its tail
        would overwrite keys that the chunk's earlier rows still see.
        ``repro`` serves that case and its streams go wrong; the port
        refuses it, as both refuse chunked prefill over windowed rings."""
        if speculative_tokens > 0 and draft_model is None:
            raise ValueError("speculative_tokens > 0 needs a draft_model")
        if draft_model is None or speculative_tokens <= 0:
            return False
        if draft_params is None:
            raise ValueError("draft_model needs draft_params")
        check_text_model(draft_model, "draft model")
        if draft_model.cfg.padded_vocab != self.lm.cfg.padded_vocab:
            raise ValueError(
                f"draft vocab ({draft_model.cfg.padded_vocab}) must match "
                f"the target's ({self.lm.cfg.padded_vocab}): verification "
                f"compares token ids")
        bad = self.lm.chunk_incompatible_mixer()
        if bad is not None:
            raise NotImplementedError(
                f"speculative verification is a multi-token chunk query;"
                f" the target's {bad!r} mixer folds tokens sequentially "
                f"— use speculative_tokens=0")
        if isinstance(self.backend.layout, RingLayout) and any(
                bdef.window is not None and bdef.window < self.max_seq_len
                for stage in self.lm.cfg.stages for bdef in stage.blocks):
            raise NotImplementedError(
                "speculative verification over a windowed layer whose ring "
                "is narrower than max_seq_len needs the paged backend "
                "(cache_backend='paged'): the verify chunk's tail would "
                "evict keys its own earlier rows still attend to")
        return True

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

    def enqueue(self, r: Request, *, ahead_extra: int = 0) -> None:
        """Admission-control gate + queue insert: with an
        ``admission_policy``, a deadline the measured service rate cannot
        meet is rejected ("reject") or stripped ("downgrade").
        ``ahead_extra`` counts work queued upstream of the engine (the
        gateway's bounded queue), so feasibility prices the whole line."""
        policy = self.scheduler.admission_policy
        if policy is not None and r.deadline_s is not None:
            mine = request_rank(r)
            ahead = (len(self._slots) + len(self._prefilling) + ahead_extra
                     + sum(1 for q in self._queue
                           if request_rank(q) <= mine))
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
                r.deadline_s = None          # downgrade: serve best-effort
                r.downgraded = True
        r.enqueue_s = time.perf_counter()
        self._queue.append(r)

    def replay_enqueue(self, r: Request) -> None:
        """Take a request as another rank's ``enqueue`` left it (the mesh
        gateway's followers): its id, its stamps and its admission verdict
        come with it, so no rank judges a deadline by its own clock."""
        self._next_id = max(self._next_id, r.request_id + 1)
        if r.status == "rejected":
            self._terminal(r, "rejected", r.failure_reason)
        else:
            self._queue.append(r)

    def queue_depth(self) -> int:
        """Requests waiting in the engine's own queue (resumes included)."""
        return len(self._queue)

    @property
    def decode_s(self) -> float:
        """Device seconds of decode rounds: each round from its start
        (look-ahead top-ups, a speculative round's draft re-sync) to its
        last program, so admissions queued before it are not in it."""
        return self._clock.seconds("decode")

    @property
    def prefill_s(self) -> float:
        """Device seconds of admissions and prompt chunks (and the draft
        fill that arms a new slot's draft)."""
        return self._clock.seconds("prefill")

    @property
    def pending(self) -> bool:
        """Work outstanding: queued, prefilling or decoding requests."""
        return bool(self._queue or self._slots or self._prefilling)

    def step(self) -> None:
        """Execute one scheduler plan: admissions and prompt chunks first,
        then one decode round of ``plan.decode_steps`` fused steps."""
        self._step_count += 1
        slots, free, prefilling = self._slots, self._free, self._prefilling
        if self._faults is not None and self._faults.fire("cancel"):
            # chaos cancellation: a deterministic in-flight victim hangs up
            live = sorted([r.request_id for r in self._queue]
                          + [pp.request.request_id
                             for pp in prefilling.values()]
                          + [r.request_id for r in slots.values()])
            if live:
                self.cancel(self._faults.pick("cancel", live))
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
        if not slots:
            return
        try:
            if plan.spec_tokens > 0 and self.speculative:
                try:
                    self._spec_round(slots, free, self._done,
                                     plan.spec_tokens)
                except FaultError as e:
                    if e.seam != "draft":
                        raise
                    # the draft dispatch is down: serve this round plain.
                    # Commits are target samples under the same keys
                    # either way, so the streams are unchanged
                    self.spec_fallbacks += 1
                    self._decode_round(slots, free, self._done,
                                       plan.decode_steps)
            else:
                self._decode_round(slots, free, self._done,
                                   plan.decode_steps)
        except FaultError as e:
            # the decode dispatch failed before its program ran, so every
            # decoding slot still holds its pre-round state: roll them all
            # back to a host checkpoint and requeue with backoff
            self._recover_decode_fault(e.seam)

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
    def _arm(self, slot, *, pos, max_new, temp, rid, active) -> None:
        """Arm one slot for decode. Every argument is a (1,) device tensor
        (the staged slot as int64): the writes are index copies, which a
        CUDA graph replays for whichever slot was staged."""
        st = self._state
        st["pos"].index_copy_(0, slot, pos)
        st["steps"].index_fill_(0, slot, 0)
        st["budget"].index_copy_(0, slot, max_new)
        st["temp"].index_copy_(0, slot, temp)
        st["rid"].index_copy_(0, slot, rid)
        st["active"].index_copy_(0, slot, active)

    def _admit_impl(self, bucket: int) -> None:
        """Prefill the staged prompt at ``bucket`` tokens and install it
        into the staged slot. The true length keeps the bucket's pad
        tokens out of what is kept: a window-wide ring would keep the
        padded tail, and recurrent state would fold the pads in. Reads
        only staged arguments: program ("admit", bucket)."""
        a = self._args
        slot, length, max_new = a["slot"].long(), a["length"], a["max_new"]
        logits, one_caches = self.lm.prefill(
            self.params, {"tokens": a["tokens"][:bucket][None]},
            cache_width=self.max_seq_len, lengths=length,
            logits_index=length - 1, mesh=self.mesh)
        self._cache_state = self.backend.prefill_fill(
            self._cache_state, one_caches, slot, length, a["row"])
        self._state["last"].index_copy_(0, slot, logits[:, 0].float())
        self._arm(slot, pos=length, max_new=max_new, temp=a["temp"],
                  rid=a["rid"], active=max_new > 0)

    def _chunk_impl(self, bucket: int, ctx: int) -> None:
        """Run the staged prompt chunk (``bucket`` tokens, ``length`` of
        them real, from ``start``) for the staged slot: install its K/V
        through the slot's cache view and, on the final chunk, arm the slot
        for decode with the last real token's logits. ``ctx`` bounds the
        visible cache to the live prefix: the chunk sees nothing at or
        above its own padded end. Program ("chunk", bucket, ctx)."""
        a = self._args
        slot, length, max_new = a["slot"].long(), a["length"], a["max_new"]
        final = a["final"] != 0
        view, tables = self.backend.slot_view(self._cache_state, slot, ctx)
        valid = (torch.arange(bucket, device=self.device) < length)[None, :]
        logits, view = self.lm.prefill_chunk(
            self.params, view, a["tokens"][:bucket][None], a["start"],
            layout=self.backend.layout, block_tables=tables, valid=valid,
            logits_index=length - 1, mesh=self.mesh)
        self._cache_state = self.backend.slot_update(self._cache_state, slot,
                                                     view)
        last = self._state["last"]
        last.index_copy_(0, slot, torch.where(
            final[:, None], logits[:, 0].float(), last.index_select(0, slot)))
        self._arm(slot, pos=a["prompt_len"], max_new=max_new, temp=a["temp"],
                  rid=a["rid"], active=final & (max_new > 0))

    def _sample(self, rid, steps, logits, temp, sampled: bool):
        """Keyed samples of (B, V) ``logits`` at the (request id, step)
        keys. With ``sampled`` False the host knows that no live slot
        samples, so the threefry draw is skipped: every row a live slot
        reads is greedy either way."""
        if not sampled:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_logits_keyed(
            request_keys(self._base_key, rid, steps), logits, temp)

    def _step_impl(self, sampled: bool = True) -> None:
        """Fused decode step on the device: sample -> append -> attend ->
        done-detect, for every slot (inactive rows compute but neither
        write the cache nor emit)."""
        st = self._state
        active = st["active"]
        nxt = self._sample(st["rid"], st["steps"], st["last"], st["temp"],
                           sampled)
        rows = torch.arange(self.batch_slots, device=self.device)
        idx = torch.clamp(st["steps"], 0, self.max_seq_len - 1).long()
        st["out"][rows, idx] = torch.where(active, nxt, st["out"][rows, idx])
        steps = st["steps"] + active.to(torch.int32)
        feed = torch.where(active, nxt, torch.zeros_like(nxt))[:, None]
        logits, _ = self.lm.decode_step(
            self.params, self._cache_state["caches"], feed, st["pos"],
            layout=self.backend.layout,
            block_tables=self._cache_state["tables"], valid=active[:, None],
            mesh=self.mesh)
        finished = steps >= st["budget"]
        if self.eos_id is not None:
            finished |= nxt == self.eos_id
        # in place: a captured program reads and writes fixed addresses
        st["last"].copy_(logits[:, 0, :])
        st["pos"].add_(active.to(torch.int32))
        st["steps"].copy_(steps)
        st["active"].copy_(active & ~finished)

    def _draft_fill_impl(self, bucket: int) -> None:
        """Install the staged slot's visible stream into the draft ring at
        ``bucket`` tokens: the staged tokens up to ``prompt_len``, then the
        slot's generated tokens (``out``, on the device) up to ``length``.
        At admission the whole stream is staged; a re-sync stages only the
        prompt and reads the rest where decode wrote it. The draft's
        ``_admit_impl`` without the sampling state (the speculative round
        reads everything else from the target's). Program ("draft_fill",
        bucket)."""
        a = self._args
        slot, length, plen = a["slot"].long(), a["length"], a["prompt_len"]
        i = torch.arange(bucket, device=self.device)
        gen = self._state["out"].index_select(0, slot)[0]
        after = gen[torch.clamp(i - plen, 0, self.max_seq_len - 1)]
        tokens = torch.where(i < plen, a["tokens"][:bucket],
                             torch.where(i < length, after,
                                         torch.zeros_like(after)))
        _, one_caches = self.draft_lm.prefill(
            self.draft_params, {"tokens": tokens[None]},
            cache_width=self.max_seq_len, last_only=True, lengths=length,
            mesh=self.mesh)
        self._draft_state = self._draft_backend.prefill_fill(
            self._draft_state, one_caches, slot, length, None)

    def _spec_impl(self, k: int, sampled: bool = True) -> None:
        """One fused propose-k/verify round on the device.

        Verification is key-coupled. The anchor ``t0`` is sampled from
        ``last`` with the key the plain step would fold; the draft proposes
        ``d_1..d_k`` with the keys of the following steps; the target
        attends the chunk ``[t0, d_1..d_k]`` in one ``prefill_chunk``; and
        ``s_i``, sampled from the target's verify logits with ``d_i``'s
        key, is the token the plain engine would emit there. A proposal is
        accepted iff it equals its ``s_i``, so every committed token is a
        plain-engine token, at every temperature. A rejected position's
        token is not committed: it comes back as the next round's anchor,
        from the same key and logits.

        The draft runs k+1 steps (the last consumes ``d_k``, so its cache
        stays contiguous through a fully accepted round). Both caches mask
        appends to ``i < headroom``: a token at or past the budget never
        commits, and every append stays inside the slot's reservation."""
        b = self.batch_slots
        st = self._state
        active = st["active"]
        rid, steps, temp, pos = st["rid"], st["steps"], st["temp"], st["pos"]
        headroom = st["budget"] - steps           # >= 1 on active rows
        tok = self._sample(rid, steps, st["last"], temp, sampled)
        t0 = tok
        drafted = []
        dcaches = self._draft_state["caches"]
        for i in range(k + 1):
            ok = active & (i < headroom)
            feed = torch.where(active, tok, torch.zeros_like(tok))[:, None]
            dlogits, dcaches = self.draft_lm.decode_step(
                self.draft_params, dcaches, feed, pos + i,
                layout=self._draft_backend.layout, valid=ok[:, None],
                mesh=self.mesh)
            tok = self._sample(rid, steps + i + 1, dlogits[:, 0].float(),
                               temp, sampled)
            drafted.append(tok)
        proposals = torch.stack(drafted[:k], dim=1)              # (B, k)

        chunk = torch.cat([t0[:, None], proposals], dim=1)       # (B, k+1)
        offs = torch.arange(k + 1, dtype=torch.int32, device=self.device)
        ok = active[:, None] & (offs[None, :] < headroom[:, None])
        logits, _ = self.lm.prefill_chunk(
            self.params, self._cache_state["caches"], chunk, pos,
            layout=self.backend.layout,
            block_tables=self._cache_state["tables"], valid=ok,
            mesh=self.mesh)
        logits = logits.float()                                  # (B, k+1, V)
        # s_i reads logits row i-1 (the plain engine's ``last`` at step
        # steps + i); the B*k verifications sample as one flattened batch
        ksteps = (steps[:, None] + offs[None, 1:]).reshape(-1)
        krid = rid[:, None].expand(b, k).reshape(-1)
        ktemp = temp[:, None].expand(b, k).reshape(-1)
        target = self._sample(krid, ksteps,
                              logits[:, :k].reshape(b * k, -1), ktemp,
                              sampled).reshape(b, k)
        j = accepted_prefix_length(proposals, target)            # (B,)
        commit = torch.minimum(1 + j, headroom)
        eos_hit = torch.zeros((b,), dtype=torch.bool, device=self.device)
        if self.eos_id is not None:
            is_eos = chunk == self.eos_id
            has_eos = is_eos.any(dim=1)
            eos_idx = torch.argmax(is_eos.to(torch.int32), dim=1).to(
                torch.int32)                      # first EOS in the chunk
            commit = torch.where(has_eos, torch.minimum(commit, eos_idx + 1),
                                 commit)
            eos_hit = has_eos & (eos_idx < commit)

        rows = torch.arange(b, device=self.device)[:, None]
        write = ok & (offs[None, :] < commit[:, None])
        idx = torch.clamp(steps[:, None] + offs[None, :], 0,
                          self.max_seq_len - 1).long()
        st["out"][rows, idx] = torch.where(write, chunk, st["out"][rows, idx])
        # logits row commit-1 is the distribution after the last committed
        # token: the ``last`` the plain engine would carry there
        sel = torch.clamp(commit - 1, 0, k).long()
        last = logits[torch.arange(b, device=self.device), sel]
        dcommit = torch.where(active, commit, torch.zeros_like(commit))
        new_steps = steps + dcommit
        finished = (new_steps >= st["budget"]) | eos_hit
        st["last"].copy_(torch.where(active[:, None], last, st["last"]))
        st["pos"].add_(dcommit)
        st["steps"].copy_(new_steps)
        st["active"].copy_(active & ~finished)

    def _program_body(self, key) -> None:
        """The eager body of program ``key``: K fused decode steps, one
        speculative round at depth k, an admission, a prompt chunk or a
        draft fill."""
        kind = key[0]
        if kind == "decode":
            for _ in range(key[1]):
                self._step_impl(key[2])
        elif kind == "spec":
            self._spec_impl(key[1], key[2])
        elif kind == "admit":
            self._admit_impl(key[1])
        elif kind == "chunk":
            self._chunk_impl(key[1], key[2])
        else:
            self._draft_fill_impl(key[1])

    def program_keys(self) -> List[tuple]:
        """Every program ``warm_compile`` builds, as ``repro``'s jits would
        compile them: the single step and the K-step scan at every horizon
        of ``scheduler.k_schedule`` and, with a draft, the speculative
        round at every depth of ``scheduler.spec_schedule``, each greedy
        and sampled; the admission at every prompt bucket (monolithic
        prefill) or the chunk at every (chunk bucket, context bound) pair
        that ``repro``'s ``warm_compile`` enumerates (chunked); and, with a
        draft, the draft fill at every prompt bucket."""
        keys = [("decode", k, s) for k in self.scheduler.k_schedule
                for s in (False, True)]
        if self.speculative:
            keys += [("spec", k, s) for k in self.scheduler.spec_schedule
                     for s in (False, True)]
        if self.scheduler.chunked:
            for bucket in self.scheduler.buckets:
                ctx = _next_pow2(bucket)
                while ctx < self.max_seq_len:
                    keys.append(("chunk", bucket, ctx))
                    ctx *= 2
                keys.append(("chunk", bucket, self.max_seq_len))
        else:
            keys += [("admit", b) for b in self.buckets]
        if self.speculative:
            keys += [("draft_fill", b) for b in self.buckets]
        return keys

    def warm_compile(self) -> None:
        """Build every program before traffic (``program_keys``), as
        ``repro``'s ``warm_compile`` compiles its executables. Each runs
        once eagerly first, a no-op: decode programs run with every slot
        inactive (appends are masked, outputs and positions stay; ``last``
        takes junk logits that every admission re-arms), and the prefill
        programs admit into idle slot 0 with ``max_new = 0`` and no table
        row (the paged install parks every token in the trash block; a
        ring line and a draft line take junk that the slot's next
        admission overwrites). On the card every kernel library is loaded
        (built if missing) too, so no request pays ``nvcc``. Call while no
        slot is live, before serving traffic. The wall time lands in
        ``warm_compile_s`` (and ``metrics()``)."""
        if self._slots or self._prefilling:
            raise RuntimeError("warm_compile needs an idle engine: its "
                               "warm-up runs would advance live slots")
        if self.mesh is not None and self.device.type == "cuda" \
                and not self.mesh.capturable:
            raise RuntimeError(
                f"warm_compile: a {self.mesh.backend} mesh's collectives "
                f"run on the host and cannot be captured in a CUDA graph; "
                f"this engine serves eager (use NCCL, one card a rank, to "
                f"capture)")
        if self.warm_compile_s is not None and set(self._programs) >= set(
                self.program_keys()):
            return                     # warm already (the gateway calls it)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            build.build_all()
            for name in build.sources():
                build.load(name)
        self._args.put(slot=0, length=1, start=0, prompt_len=1, max_new=0,
                       rid=0, final=0, temp=0.0, tokens=[],
                       row=np.full(self._args["row"].numel(), -1))
        self._warm_programs(self.program_keys())
        self.warm_compile_s = time.perf_counter() - t0

    # -- host-side management -------------------------------------------------
    def _try_admit(self, slots, free, prefilling):
        """Scheduler admission callback: grant the best-ranked waiting
        request a slot plus its cache reservation, or return None. Ordering
        is strict: a lower class never backfills in front of a blocked
        higher one. A request that could never fit an idle pool is
        rejected (``exceeds_pool_capacity``). Chunked admissions return a
        ``PrefillProgress``; monolithic and swap-resumed ones MONOLITHIC.
        A request under fault backoff (``not_before_step``) is skipped
        until its backoff expires."""
        if not free:
            return None
        while True:
            eligible = [q for q in self._queue
                        if q.not_before_step <= self._step_count]
            if not eligible:
                return None
            r = min(eligible, key=request_rank)
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
        if self._faults is not None and self._faults.fire("pool"):
            # transient pool exhaustion: no blocks this step, retry next
            return None
        if r.resume is not None and r.resume.kv is not None:
            # swap path: restore the checkpointed blocks, no prefill at all
            if not self.backend.can_resume(len(r.prompt), r.max_new_tokens):
                return None
            if self._faults is not None and self._faults.fire("swap_in"):
                # the K/V checkpoint failed to come back (before any block
                # is drawn): drop it and resume by recompute, exact too
                r.resume.kv = None
                self._record_retry(r, "swap_in")
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
        # context bound: the next power of two covering the padded chunk end
        ctx = min(self.max_seq_len, _next_pow2(c.start + c.bucket))
        self._args.put(slot=c.slot, start=c.start, length=c.length,
                       prompt_len=len(src), max_new=r.max_new_tokens,
                       temp=r.temperature, rid=r.request_id,
                       final=int(c.final),
                       tokens=src[c.start:c.start + c.length])
        with self._clock.span("prefill"):
            self._run_program(("chunk", c.bucket, ctx))
            if c.final and self.speculative:
                # arm the draft with the slot's whole visible stream
                # (prompt, or prompt + generated on a recompute-resume)
                self._draft_fill(c.slot, np.asarray(src, np.int32))
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
        table_row = self.backend.alloc_slot(slot, length, remaining)
        # right-padded to the bucket (exact)
        self._args.put(slot=slot, length=length, max_new=r.max_new_tokens,
                       temp=r.temperature, rid=r.request_id, row=table_row,
                       tokens=tokens_1d)
        with self._clock.span("prefill"):
            self._run_program(("admit", bucket))
            self._note_grant(r)
            if self.speculative:
                self._draft_fill(slot, tokens_1d)
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
        if self.speculative:
            # the swap checkpoint restores only the target's K/V; the
            # draft cache is rebuilt from the host token stream
            self._draft_fill(slot, np.concatenate(
                [r.prompt, rs.tokens]).astype(np.int32))
        self._restore_checkpoint(r, slot)
        slots[slot] = r

    def _rollback_slot(self, slot: int) -> Request:
        """Evict ``slot`` to a host checkpoint: decode state (generated
        tokens, step count, next-sample logits) to the host, and the cache
        swapped out (paged: the blocks return to the pool, the host copy
        finishes after the next plan) or freed for a recompute-resume. A
        ``swap_out`` fault takes the recompute path: slower, as exact."""
        r = self._slots.pop(slot)
        st = self._state
        steps = int(st["steps"][slot])
        r.resume = _ResumeState(
            steps=steps,
            tokens=st["out"][slot, :steps].cpu().numpy().copy(),
            last=st["last"][slot].cpu().numpy().copy())
        self._edit_state(active=(slot, False))
        swap = self._preempt_swap
        if swap and self._faults is not None \
                and self._faults.fire("swap_out"):
            r.last_fault = "swap_out"    # checkpoint transport failed:
            swap = False                 # recompute-resume instead (exact)
        if swap:
            r.resume.kv, self._cache_state = self.backend.swap_out(
                self._cache_state, slot)
            self._pending_swaps.append(r.resume.kv["caches"])
        else:
            self._cache_state = self.backend.free_slot(self._cache_state,
                                                       slot)
        self._scanned.pop(slot, None)
        if self.speculative:
            self._draft_dirty.discard(slot)
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
        """Slot-grant bookkeeping shared by every admission path: the first
        admission stamp is sticky across preemption, and after a fault
        requeue the recovery latency (fault -> re-grant) is recorded."""
        self.admissions += 1
        r.status = "active"
        if r.admit_s == 0.0:
            r.admit_s = time.perf_counter()
        if r.fault_s:
            self.recovery_latencies.append(time.perf_counter() - r.fault_s)
            r.fault_s = 0.0

    def _terminal(self, r: Request, status: str, reason: Optional[str],
                  output: Optional[np.ndarray] = None) -> None:
        """Move ``r`` (already detached from queue, slots and prefill)
        to a terminal status in ``_done``."""
        r.status = status
        r.failure_reason = reason
        if r.output is None:
            r.output = output if output is not None \
                else np.zeros((0,), np.int32)
        r.finish_s = time.perf_counter()
        r.latency_s = r.finish_s - r.submit_s
        self._emitted.pop(r.request_id, None)
        if status == "failed" and r.deadline_s is not None:
            # quarantine misses the deadline; a cancel or a rejection is
            # the client's withdrawal, not a miss
            self.scheduler.observe_deadline(r.priority, False)
        self._status_counts[status] += 1
        self._done[r.request_id] = r

    # -- fault tolerance ------------------------------------------------------
    def _recover_decode_fault(self, seam: str) -> None:
        """A decode dispatch failed before its program ran: roll every
        decoding slot back to a host checkpoint and requeue it with
        backoff, or quarantine it past its retry budget."""
        self.fault_recoveries += 1
        for slot in list(self._slots):
            r = self._rollback_slot(slot)
            self._record_retry(r, seam, in_queue=False)

    def _record_retry(self, r: Request, seam: str,
                      in_queue: bool = True) -> None:
        """Count one fault-triggered retry of ``r``: backoff and requeue
        within the budget, quarantine past it. ``in_queue`` says whether
        ``r`` sits in the queue (a swap-in fault) or was just rolled out
        of a slot."""
        r.retries += 1
        r.last_fault = seam
        r.fault_s = time.perf_counter()
        self.retries_total += 1
        if r.retries > self.max_retries:
            if in_queue:
                self._queue.remove(r)
            self._quarantine(r, seam)
            return
        r.not_before_step = self._step_count + min(
            self.backoff_cap_steps,
            self.backoff_base_steps << (r.retries - 1))
        if not in_queue:
            self._queue.append(r)

    def _quarantine(self, r: Request, seam: str) -> None:
        """Terminal failure past the retry budget: the tokens generated
        before the last fault are kept, the checkpoint is dropped."""
        out = (r.resume.tokens if r.resume is not None
               else np.zeros((0,), np.int32))
        r.resume = None
        self._terminal(
            r, "failed",
            f"retry_budget_exhausted: {r.retries} retries > "
            f"max_retries={self.max_retries} (last fault: {seam})",
            output=out)

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
                if self.speculative:
                    self._draft_dirty.discard(slot)
                self._free.append(slot)
                self._terminal(r, "cancelled", "cancelled: mid-decode",
                               output=out)
                return True
        return False

    def metrics(self) -> Dict[str, object]:
        """Monitoring snapshot: live/terminal request counts, fault and
        recovery accounting and the core serving counters (what
        ``core.monitoring.MonitoringService.record_serving`` ingests)."""
        lat = sorted(self.recovery_latencies)

        def pct(p: float) -> float:
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        return {
            "live": {"queued": len(self._queue),
                     "prefilling": len(self._prefilling),
                     "decoding": len(self._slots)},
            "terminal": dict(self._status_counts),
            "quarantined": self._status_counts.get("failed", 0),
            "retries_total": self.retries_total,
            "fault_recoveries": self.fault_recoveries,
            "faults_injected": (self._faults.fired()
                                if self._faults is not None else {}),
            "recovery": {"count": len(lat), "p50_s": pct(0.50),
                         "p99_s": pct(0.99)},
            "restores": self.restores,
            "hang_recoveries": self.hang_recoveries,
            "admissions": self.admissions,
            "preemptions": self.preemptions,
            "generated_tokens": self.generated_tokens,
            "prefill_tokens_total": self.prefill_tokens_total,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "decode_steps": self.decode_steps,
            "host_syncs": self.host_syncs,
            "lookahead_dispatches": self.lookahead_dispatches,
            "decode_s": self.decode_s,
            "prefill_s": self.prefill_s,
            "peak_active_slots": self.peak_active_slots,
            "occupancy": self.occupancy(),
            "deadline_hits": self.scheduler.deadline_hit_rates(),
            "speculative": self.speculative_metrics(),
            "warm_compile_s": self.warm_compile_s,
            "graphs": self.graphs(),
            "mesh_devices": self.mesh.size if self.mesh is not None else 1,
        }

    def speculative_metrics(self) -> Dict[str, object]:
        """Drafted and accepted proposals overall and per SLO class, and
        committed tokens per speculative dispatch (1 + the accepted
        proposals a slot-round: what must beat a plain step's 1 for
        drafting to pay). All zeros, same shape, without a draft."""
        drafted, accepted = self.spec_drafted_tokens, self.spec_accepted_tokens
        return {
            "enabled": self.speculative,
            "rounds": self.spec_rounds,
            "slot_rounds": self.spec_slot_rounds,
            "fallbacks": self.spec_fallbacks,
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "committed_tokens": self.spec_committed_tokens,
            "acceptance_rate": accepted / drafted if drafted else 0.0,
            "committed_per_dispatch": (
                self.spec_committed_tokens / self.spec_slot_rounds
                if self.spec_slot_rounds else 0.0),
            "per_class": {
                p: {"drafted": d, "accepted": a,
                    "rate": a / d if d else 0.0}
                for p, (d, a) in sorted(self._spec_class.items())},
        }

    def _decode_round(self, slots, free, done, k: int = 1) -> None:
        with self._clock.span("decode"):
            self._reserve_lookahead(slots, k)
            if self._faults is not None:
                if self._faults.fire("hang"):
                    # a hung dispatch stalls without raising: only the
                    # gateway's wall-clock watchdog sees it (note_hang)
                    time.sleep(self._faults.hang_s)
                # a poisoned dispatch fails before its program runs, so
                # the state the rollback checkpoints is intact (the
                # look-ahead above returns through the free/swap path)
                self._faults.check("scan" if k > 1 else "step",
                                   f"decode round over {len(slots)} slots")
            self._run_program(("decode", k, _any_sampled(slots)))
        self.decode_steps += k
        self.host_syncs += 1
        self.planned_token_slots += len(slots) * k
        for slot in slots:
            self._scanned[slot] += k
        if self.speculative:
            # the draft cache saw none of this round's tokens: the next
            # speculative round re-syncs these slots first
            self._draft_dirty.update(slots.keys())
        self._finish_round(slots, free, done)

    def _spec_round(self, slots, free, done, k: int) -> None:
        """One speculative propose-k/verify round (``_spec_impl``). The
        look-ahead reservation covers the anchor plus all k proposals, so
        the verify append always lands in a reserved block; rejected tails
        were masked out of the cache and cost only the token-slots
        ``occupancy`` charges for them."""
        if self._faults is not None:
            # the draft seam fails the whole speculative dispatch before
            # any state is touched; step() serves the round plain
            self._faults.check(
                "draft", f"speculative round over {len(slots)} slots, k={k}")
        with self._clock.span("decode"):
            self._resync_draft(slots)
            self._reserve_lookahead(slots, k + 1)
            self._run_program(("spec", k, _any_sampled(slots)))
        before = dict(self._scanned)
        steps_h = self._state["steps"].cpu().numpy()     # the one host sync
        self.host_syncs += 1
        self.planned_token_slots += len(slots) * (k + 1)
        self.spec_rounds += 1
        accepted_total = 0
        for slot, r in slots.items():
            committed = int(steps_h[slot]) - before[slot]
            self._scanned[slot] = int(steps_h[slot])
            self.decode_steps += committed
            self.spec_slot_rounds += 1
            self.spec_drafted_tokens += k
            self.spec_committed_tokens += committed
            acc = max(0, committed - 1)   # the anchor is never "accepted"
            self.spec_accepted_tokens += acc
            accepted_total += acc
            d, a = self._spec_class.get(r.priority, (0, 0))
            self._spec_class[r.priority] = (d + k, a + acc)
        self.scheduler.observe_speculation(len(slots), len(slots) * k,
                                           accepted_total)
        self._finish_round(slots, free, done, steps_h=steps_h)

    def _resync_draft(self, slots) -> None:
        """Rebuild the draft cache of slots that advanced through plain
        decode rounds (the draft saw none of those tokens): one bucketed
        draft fill of prompt + generated per dirty slot. The host knows
        how many tokens each slot generated (``_scanned``), so only the
        prompt is staged; the fill reads the generated tokens on the
        device."""
        for slot in [s for s in slots if s in self._draft_dirty]:
            self._draft_fill(slot, slots[slot].prompt, self._scanned[slot])

    def _draft_fill(self, slot: int, tokens_1d: np.ndarray,
                    generated: int = 0) -> None:
        """Prefill the draft cache of ``slot`` with its whole visible
        stream: ``tokens_1d`` (the prompt, plus generated tokens on a
        resume), then the ``generated`` tokens decode left in ``out``,
        bucketed like the target's prefill."""
        length = len(tokens_1d) + generated
        self._args.put(slot=slot, prompt_len=len(tokens_1d), length=length,
                       tokens=tokens_1d)
        self._run_program(("draft_fill", bucket_for(length, self.buckets)))
        self._draft_dirty.discard(slot)

    def _host(self, *names) -> Dict[str, np.ndarray]:
        """The named state tensors on the host, for this round only. On the
        card they land in pinned buffers (reused every round) behind one
        event: several tensors, one wait."""
        st = self._state
        if self._pulled is None:
            return {n: st[n].numpy() for n in names}
        out = {}
        for n in names:
            if n not in self._pinned:
                self._pinned[n] = torch.empty(st[n].shape, dtype=st[n].dtype,
                                              pin_memory=True)
            out[n] = self._pinned[n].copy_(st[n], non_blocking=True)
        self._pulled.record()
        self._pulled.synchronize()
        return {n: t.numpy() for n, t in out.items()}

    def _finish_round(self, slots, free, done, steps_h=None) -> None:
        """Post-round bookkeeping: TTFT stamps, the stream tap and
        completions. The active mask's transfer is the round's one host
        sync; with a tap (or a completion) the step counts and outputs
        come in the same transfer (a speculative round has already brought
        the step counts)."""
        tap = self.on_tokens
        host = self._host(*(("active", "steps", "out") if tap is not None
                            else ("active",)))
        active = host["active"]
        now = time.perf_counter()
        self._clock.settle()         # the sync passed every open span
        for r in slots.values():
            if r.ttft_s == 0.0 and r.max_new_tokens > 0:
                r.ttft_s = now - r.submit_s
        finished = [s for s in slots if not active[s]]
        if finished and "out" not in host:
            host.update(self._host("steps", "out"))
        if steps_h is None and "steps" in host:
            steps_h = host["steps"]
        out_h = host.get("out")
        if tap is not None:
            # this round's new tokens per live request (a row that finished
            # mid-round stopped at its true step count)
            events = []
            for slot, r in slots.items():
                n = int(steps_h[slot])
                seen = self._emitted.get(r.request_id, 0)
                if n > seen:
                    events.append((r.request_id,
                                   np.array(out_h[slot, seen:n])))
                    self._emitted[r.request_id] = n
            if events:
                tap(events)
        for slot in finished:
            r = slots.pop(slot)
            self._scanned.pop(slot, None)
            self._emitted.pop(r.request_id, None)
            if self.speculative:
                self._draft_dirty.discard(slot)
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

    def hbm_bytes_per_device(self) -> int:
        """Per-device KV footprint: on a mesh the pools split their KV-head
        dim ``kv_shards`` ways where it divides, so each device pays that
        share of the K/V bytes (positions and tables are whole). Equals
        ``hbm_bytes()`` without a mesh."""
        return self.backend.hbm_bytes_per_device()

    def assert_invariants(self) -> None:
        """The backend's allocator invariants, checked against the live
        device tables and pool; on a mesh also the placement of every
        cache leaf (this rank's shard of what ``cache_pspecs`` splits) and
        lockstep: every rank's tokens, sampling state and host state equal
        this rank's (``_lockstep_digest``)."""
        self.backend.assert_invariants(self._cache_state)
        if self.mesh is None:
            return
        assert_cache_placement(self.mesh, self._cache_state,
                               self.backend._proto)
        if self.speculative:
            assert_cache_placement(self.mesh, self._draft_state,
                                   self._draft_backend._proto)
        mine = torch.tensor([self._lockstep_digest()], dtype=torch.int64,
                            device=self.mesh.device)
        every = self.mesh.gather(mine, 0, axis="world").cpu().tolist()
        assert len(set(every)) == 1, (
            f"ranks out of lockstep: state digests {every} (rank "
            f"{self.mesh.rank})")

    def _lockstep_digest(self) -> int:
        """A digest of what must be equal on every rank: the device
        sampling state (tokens, positions, steps, budgets, ids, the active
        mask and the ``last`` logits), the tables and the host scheduler's
        slots, queue, free list, counters and allocator."""
        h = hashlib.sha256()
        for name in sorted(self._state):
            h.update(self._state[name].cpu().numpy().tobytes())
        if self._cache_state["tables"] is not None:
            h.update(self._cache_state["tables"].cpu().numpy().tobytes())
        host = (sorted((s, r.request_id) for s, r in self._slots.items()),
                [r.request_id for r in self._queue], list(self._prefilling),
                sorted(self._scanned.items()), list(self._free),
                self._next_id, self._step_count, sorted(self._done),
                sorted(getattr(self.backend, "_slot_blocks", {}).items()))
        h.update(repr(host).encode())
        return int.from_bytes(h.digest()[:7], "little")

    # -- durability -----------------------------------------------------------
    def note_hang(self) -> None:
        """Watchdog escalation: a dispatch overran its wall-clock deadline.
        The stall raised nothing, so the recovery the raising seams get is
        made here: every decoding slot rolls back to its host checkpoint
        and requeues through the retry ladder. If the stalled round did
        land, its work is redone; the checkpoint keeps the stream exact."""
        self.hang_recoveries += 1
        self._recover_decode_fault("hang")

    def _live_requests(self) -> List[Request]:
        """Every non-terminal request: queued (preempted and resuming
        included), mid-prefill and decoding."""
        live = list(self._queue)
        live.extend(pp.request for pp in self._prefilling.values())
        live.extend(self._slots.values())
        return live

    def known_request_ids(self) -> set:
        """Request ids this engine accounts for, live or terminal (journal
        replay re-queues the acknowledged ones it lacks)."""
        ids = {r.request_id for r in self._live_requests()}
        ids.update(self._done.keys())
        return ids

    def snapshot(self) -> Dict[str, object]:
        """Every request the engine owns, live and terminal, as nested
        string-keyed dicts of numpy leaves in ``repro``'s wire format (fit
        for ``save_snapshot``). It changes nothing: a decoding slot is
        checkpointed as preemption checkpoints it (generated tokens, step
        count, ``last`` logits and, on the paged backend with swap, its
        K/V through ``checkpoint_slot``), so ``restore`` into a cold engine
        resumes token for token. Ages are stored relative (``age_s``) and
        re-anchored at restore; stream watermarks are not kept (a
        restarted gateway replays each stream from its first token)."""
        now = time.perf_counter()
        requests: Dict[str, Dict[str, object]] = {}

        def base_meta(r: Request, phase: str, steps: int) -> dict:
            return {"rid": r.request_id, "phase": phase, "steps": steps,
                    "max_new_tokens": r.max_new_tokens,
                    "temperature": r.temperature, "priority": r.priority,
                    "deadline_s": r.deadline_s,
                    "age_s": now - r.submit_s if r.submit_s else 0.0,
                    "ttft_s": r.ttft_s, "preemptions": r.preemptions,
                    "status": r.status, "failure_reason": r.failure_reason,
                    "retries": r.retries, "last_fault": r.last_fault,
                    "downgraded": r.downgraded, "latency_s": r.latency_s}

        def record(r: Request, steps: int, tokens, last, kv) -> None:
            rec: Dict[str, object] = {
                "meta": json_leaf(base_meta(r, "live", steps)),
                "prompt": np.asarray(r.prompt, np.int32)}
            if tokens is not None and len(tokens):
                rec["tokens"] = np.asarray(tokens, np.int32)
            if last is not None:
                rec["last"] = np.asarray(last, np.float32)
            if kv is not None:
                rec["kv"] = {"n_blocks": np.int32(kv["n_blocks"]),
                             "caches": self.backend.wire_caches(kv)}
            requests[f"r{r.request_id:08d}"] = rec

        if self._slots:
            st = self._state
            steps_h = st["steps"].cpu().numpy()
            out_h = st["out"].cpu().numpy()
            last_h = st["last"].cpu().numpy()
            for slot, r in self._slots.items():
                steps = int(steps_h[slot])
                kv = (self.backend.checkpoint_slot(self._cache_state, slot)
                      if self._preempt_swap else None)
                record(r, steps, np.array(out_h[slot, :steps]),
                       np.array(last_h[slot]), kv)
        # queued and mid-prefill: installed chunks are abandoned (the
        # restored engine prefills again), a carried checkpoint is kept
        for r in list(self._queue) + [pp.request
                                      for pp in self._prefilling.values()]:
            rs = r.resume
            if rs is not None:
                record(r, rs.steps, rs.tokens, rs.last, rs.kv)
            else:
                record(r, 0, None, None, None)
        for r in self._done.values():
            rec = {"meta": json_leaf(base_meta(r, "terminal", 0)),
                   "prompt": np.asarray(r.prompt, np.int32)}
            if r.output is not None and len(r.output):
                rec["output"] = np.asarray(r.output, np.int32)
            requests[f"r{r.request_id:08d}"] = rec
        engine_meta = {"kind": type(self).__name__,
                       "backend": type(self.backend).__name__,
                       "next_id": self._next_id,
                       "step_count": self._step_count,
                       "status_counts": dict(self._status_counts),
                       "batch_slots": self.batch_slots,
                       "max_seq_len": self.max_seq_len,
                       "vocab": self.lm.cfg.padded_vocab}
        return {"engine": json_leaf(engine_meta), "requests": requests}

    def restore(self, snap: Dict[str, object]) -> Dict[str, int]:
        """Load a ``snapshot`` (this package's or ``repro``'s) into this
        cold engine. Live requests re-enter the queue with their decode
        checkpoint, and admission resumes them through the swap or
        recompute path preemption uses: token for token, given the same
        ``seed``. A K/V checkpoint is kept when this backend can swap it
        in, else dropped for a recompute-resume. Terminal requests go to
        the done map. Nothing on the device is touched here: the K/V
        reaches the pool at admission, by an in-place scatter. Scheduler
        estimates are reset (they described a process that is gone)."""
        if self._slots or self._prefilling or self._queue or self._done:
            raise RuntimeError("restore() needs a cold engine: this one "
                               "already owns requests")
        eng = json_unleaf(snap["engine"])
        if eng.get("vocab") != self.lm.cfg.padded_vocab:
            raise ValueError(
                f"snapshot vocab {eng.get('vocab')} != engine vocab "
                f"{self.lm.cfg.padded_vocab}: the saved logits checkpoints "
                f"cannot be restored into this model")
        if eng.get("max_seq_len") != self.max_seq_len:
            raise ValueError(
                f"snapshot max_seq_len {eng.get('max_seq_len')} != engine "
                f"max_seq_len {self.max_seq_len}")
        now = time.perf_counter()
        template = (self._cache_state["caches"] if self.backend.supports_swap
                    else None)
        live = terminal = 0
        for key in sorted(snap["requests"]):
            rec = snap["requests"][key]
            meta = json_unleaf(rec["meta"])
            r = Request(int(meta["rid"]),
                        np.asarray(rec["prompt"], np.int32),
                        int(meta["max_new_tokens"]),
                        float(meta["temperature"]),
                        priority=int(meta["priority"]),
                        deadline_s=meta["deadline_s"])
            r.submit_s = now - float(meta["age_s"])
            r.ttft_s = float(meta["ttft_s"])
            r.preemptions = int(meta["preemptions"])
            r.retries = int(meta["retries"])
            r.last_fault = meta["last_fault"]
            r.downgraded = bool(meta["downgraded"])
            if meta["phase"] == "terminal":
                r.status = meta["status"]
                r.failure_reason = meta["failure_reason"]
                r.latency_s = float(meta["latency_s"])
                r.finish_s = now
                out = rec.get("output")
                r.output = (np.asarray(out, np.int32) if out is not None
                            else np.zeros((0,), np.int32))
                self._done[r.request_id] = r
                terminal += 1
                continue
            steps = int(meta["steps"])
            if steps > 0:
                kv = None
                if template is not None and "kv" in rec:
                    kv = {"n_blocks": int(np.asarray(rec["kv"]["n_blocks"])),
                          "caches": self.backend.local_wire(_rebuild_like(
                              template, rec["kv"]["caches"]))}
                tokens = rec.get("tokens")
                r.resume = _ResumeState(
                    steps=steps,
                    tokens=(np.asarray(tokens, np.int32)
                            if tokens is not None
                            else np.zeros((0,), np.int32)),
                    last=np.asarray(rec["last"], np.float32), kv=kv)
            r.enqueue_s = now
            self._queue.append(r)
            live += 1
        self._queue.sort(key=request_rank)
        self._next_id = max(self._next_id, int(eng["next_id"]))
        self._step_count = max(self._step_count, int(eng["step_count"]))
        self._status_counts.update(eng["status_counts"])
        self.scheduler.reset_estimates()
        self.restores += 1
        return {"live": live, "terminal": terminal}

    def requeue_lost(self, request_id: int, prompt: np.ndarray,
                     max_new_tokens: int = 16, temperature: float = 0.0,
                     priority: int = 0,
                     deadline_s: Optional[float] = None) -> Request:
        """Journal replay: re-queue an acknowledged submission that no
        snapshot holds, under its original id (so the handle, the journal's
        terminal record and the sampling keys line up); it starts over
        from its prompt."""
        prompt = validate_prompt(prompt, max_new_tokens, self.max_seq_len,
                                 self.truncate_prompts)
        r = Request(int(request_id), prompt, max_new_tokens, temperature,
                    priority=priority, deadline_s=deadline_s)
        r.submit_s = time.perf_counter()
        r.enqueue_s = r.submit_s
        self._next_id = max(self._next_id, int(request_id) + 1)
        self._queue.append(r)
        return r


def _rebuild_like(template, loaded):
    """``loaded`` (nested string-keyed dicts, as ``load_checkpoint_tree``
    or a snapshot gives them) rebuilt into the structure of the cache tree
    ``template`` as CPU tensors of its dtypes: ``flat_paths`` spells a list
    index and a same-named dict key alike, so the paths match."""
    tpl = flat_paths(template)
    got = flat_paths(loaded)
    missing = set(tpl) - set(got)
    if missing:
        raise ValueError(f"snapshot K/V missing paths: "
                         f"{sorted(missing)[:5]}")

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (str(i),))
                              for i, v in enumerate(node))
        return host_tensor(got["/".join(path)], node.dtype)

    return build(template, ())


def save_snapshot(directory: str, snapshot: Dict[str, object],
                  step: int = 0, keep: int = 3) -> str:
    """Persist an engine snapshot through the checkpoint envelope (atomic
    rename, bounded retention)."""
    return save_checkpoint(directory, step, snapshot, keep=keep)


def load_snapshot(directory: str, step: Optional[int] = None):
    """Load a persisted engine snapshot: ``(snapshot_tree, step)``."""
    return load_checkpoint_tree(directory, step)


class DrainBatchEngine(_GraphedPrograms):
    """The static batcher, kept as the measured baseline (port of
    ``repro.serving.engine.DrainBatchEngine``): drain the queue in FIFO
    batches of ``batch_slots`` right-padded to a power-of-two bucket of the
    longest prompt, decode everyone for the longest budget, and bring every
    sampled token to the host. As ``repro``'s, it splits one threefry key
    per token off ``prng_key(seed)`` and samples the whole batch from it,
    so its sampled streams are ``repro``'s drain streams (and depend on the
    batch). Right-padding is exact: attention is causal, the first token's
    logits come from each row's last real position, a pad's cache entry
    sits above every query until decode overwrites it, and a recurrent
    layer keeps each row's state after its last real token (``repro``'s
    folds the pads in, ROADMAP Queue 3).

    Where ``repro`` jits its prefill and decode, the engine keeps a
    (``batch_slots``, ``max_seq_len``) cache and its decode state at fixed
    addresses and registers three kinds of program: ("prefill", bucket)
    for every prompt bucket, ("sample", sampled), which splits the key in
    place and samples the batch, and ("forward",), one decode step on the
    sampled tokens. On the card ``warm_compile`` captures them all as CUDA
    graphs; on the CPU each is the eager call. As in ``repro``, the host
    reads each sampled token before the decode step that follows it (one
    sync a token), so TTFT ends at the first sample."""

    def __init__(self, lm: LM, params, *, batch_slots: int = 8,
                 max_seq_len: int = 512, seed: int = 0,
                 truncate_prompts: bool = False):
        check_text_model(lm)
        self.lm = lm
        self.params = params
        self.device = dev = lm.device
        self.batch_slots = b = batch_slots
        self.max_seq_len = max_seq_len
        self.buckets = prompt_buckets(max_seq_len)
        self.rng = prng_key(seed, device=dev)       # split in place a token
        self.truncate_prompts = truncate_prompts
        self._lengths = _needs_lengths(lm)
        self._queue: List[Request] = []
        self._next_id = 0
        self.generated_tokens = 0
        self.host_syncs = 0     # one token round-trip per decoded token
        self.warm_compile_s: Optional[float] = None
        self._caches = lm.init_cache(b, max_seq_len)
        self._last = torch.zeros((b, lm.cfg.padded_vocab),
                                 dtype=torch.float32, device=dev)
        self._pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._nxt = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._args = _Staged(dev, floats=("temp",), lengths=b, temp=b,
                             tokens=b * max_seq_len)
        self._init_programs()

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request. ``priority``/``deadline_s`` are recorded for
        per-class reporting; the drain batcher stays strictly FIFO."""
        prompt = validate_prompt(prompt, max_new_tokens, self.max_seq_len,
                                 self.truncate_prompts)
        rid = self._next_id
        self._next_id += 1
        r = Request(rid, prompt, max_new_tokens, temperature,
                    priority=priority, deadline_s=deadline_s)
        r.submit_s = time.perf_counter()
        self._queue.append(r)
        return rid

    def run(self) -> Dict[int, Request]:
        done: Dict[int, Request] = {}
        while self._queue:
            batch = self._queue[:self.batch_slots]
            self._queue = self._queue[self.batch_slots:]
            self._serve_batch(batch)
            for r in batch:
                done[r.request_id] = r
        return done

    def _program_body(self, key) -> None:
        if key[0] == "prefill":
            self._prefill_impl(key[1])
        elif key[0] == "sample":
            self._sample_impl(key[1])
        else:
            self._forward_impl()

    def _prefill_impl(self, bucket: int) -> None:
        """Prefill the staged batch at ``bucket`` tokens into the engine's
        cache; arm ``last`` and ``pos``. Program ("prefill", bucket)."""
        a = self._args
        lengths = a["lengths"]
        tokens = a["tokens"].view(self.batch_slots, -1)[:, :bucket]
        # lengths matter only where a window-wide ring could keep pad rows
        # or recurrent state would fold them in; the first token's logits
        # come from each row's last real position
        logits, caches = self.lm.prefill(
            self.params, {"tokens": tokens}, cache_width=self.max_seq_len,
            lengths=lengths if self._lengths else None,
            logits_index=lengths - 1)
        _map_block_dicts(_copy_leaves, self._caches, caches)
        self._last.copy_(logits[:, 0].float())
        self._pos.copy_(lengths)

    def _sample_impl(self, sampled: bool) -> None:
        """Split the key in place and sample the batch from the split-off
        key into ``_nxt`` (an all-greedy batch skips the draw; the key is
        split anyway). Program ("sample", sampled)."""
        keys = split(self.rng)
        self.rng.copy_(keys[0])
        nxt = (sample_logits_batch(keys[1], self._last, self._args["temp"])
               if sampled else torch.argmax(self._last, dim=-1).to(
                   torch.int32))
        self._nxt.copy_(nxt)

    def _forward_impl(self) -> None:
        """Decode the sampled tokens ``_nxt`` one step: the next ``last``
        and ``pos``. Program ("forward",)."""
        logits, _ = self.lm.decode_step(self.params, self._caches,
                                        self._nxt[:, None], self._pos)
        self._pos.add_(1)
        self._last.copy_(logits[:, 0].float())

    def program_keys(self) -> List[tuple]:
        """The prefill at every prompt bucket, the sample greedy and
        sampled, and the decode step: what ``repro``'s jits compile across
        batches."""
        return ([("prefill", b) for b in self.buckets]
                + [("sample", False), ("sample", True), ("forward",)])

    def warm_compile(self) -> None:
        """Build every program (``program_keys``) before traffic. The
        eager warm-ups write junk into the cache and the decode state,
        which the next batch's prefill overwrites; the key is put back,
        so the key schedule stays ``repro``'s."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            build.build_all()
            for name in build.sources():
                build.load(name)
        key = self.rng.clone()
        self._args.put(lengths=np.ones(self.batch_slots), temp=[],
                       tokens=[])
        self._warm_programs(self.program_keys())
        self.rng.copy_(key)
        self.warm_compile_s = time.perf_counter() - t0

    def _serve_batch(self, requests: List[Request]) -> None:
        b = self.batch_slots
        admit = time.perf_counter()          # batch enters service together
        for r in requests:
            r.admit_s = admit
        plen = max(len(r.prompt) for r in requests)
        tokens = np.zeros((b, self.max_seq_len), np.int32)
        for i, r in enumerate(requests):
            tokens[i, :len(r.prompt)] = r.prompt         # right-pad (exact)
        self._args.put(
            lengths=[len(r.prompt) for r in requests]
            + [plen] * (b - len(requests)),
            temp=[r.temperature for r in requests], tokens=tokens)
        self._run_program(("prefill", bucket_for(plen, self.buckets)))
        max_new = max(r.max_new_tokens for r in requests)
        outs = np.zeros((b, max_new), np.int32)
        sampled = any(r.temperature > 0.0 for r in requests)
        for t in range(max_new):
            self._run_program(("sample", sampled))
            outs[:, t] = self._nxt.cpu().numpy()         # per-token host trip
            self.host_syncs += 1
            if t == 0:
                first = time.perf_counter()
                for r in requests:
                    r.ttft_s = first - r.submit_s
            self._run_program(("forward",))
        finish = time.perf_counter()
        for i, r in enumerate(requests):
            r.output = outs[i, :r.max_new_tokens]
            r.status = "done"
            r.finish_s = finish
            r.latency_s = finish - r.submit_s
            self.generated_tokens += r.max_new_tokens


def _copy_leaves(dst: dict, src: dict) -> dict:
    for key, leaf in dst.items():
        leaf.copy_(src[key])
    return dst
