"""Async serving gateway: the service layer over the serving engine.

``ServingGateway`` owns a ``ServingEngine`` (or ``CascadeServingEngine``)
and runs its ``step()`` loop as a single asyncio driver task, exposing
the transport the engine never had:

- ``await gateway.submit(prompt, ...) -> RequestHandle``
- ``async for token in handle.stream()`` — tokens surface as each
  step's host sync lands (the engine's per-round token tap)
- ``await handle.result()`` — the terminal ``Request`` in any status
- ``await gateway.cancel(rid)`` — cancellation in every phase, gateway
  queue included; an abandoned stream iterator cancels implicitly
- ``await gateway.drain()`` — graceful shutdown that quiesces streams
  and leaves the paged pool's invariants intact

Threading model: the asyncio loop thread owns every engine mutation
(make_request / enqueue / cancel / take_done); the engine's ``step()``
itself runs in the default executor so token streams, submissions and
cancels stay live while the device works. The engine's ``on_tokens``
tap fires on the executor thread and only appends to a plain list; the
driver dispatches it to handles after the step returns, so handles and
events are touched by the loop thread alone.

Backpressure: the gateway's bounded inbox is the real queue — the
engine's own queue is kept shallow (``forward_depth``) so load shedding
still has something to shed. Three policies on a full inbox:

- ``block``            submitters wait for room (open-loop clients
                       become closed-loop under overload)
- ``reject``           newcomer refused immediately
                       (``gateway_overload``)
- ``shed``             the worst-ranked queued request is evicted iff
                       it ranks strictly worse than the newcomer
                       (class desc -> EDF -> FIFO, the scheduler's own
                       ordering); otherwise the newcomer is refused

Gateway-level refusals are stamped terminal by the gateway and never
reach the engine's counters; engine-level admission control (deadline
feasibility) still runs at forward time with the gateway queue
priced in via ``ahead_extra``.

Durability: three optional hooks make the gateway crash-
restartable with token-exact survivors —

- a write-ahead ``RequestJournal``: every accepted submit is journaled
  *before* it is acknowledged, first-token and terminal transitions
  after; a journaled duplicate id is refused
- ``step_timeout_s``: a wall-clock watchdog on each engine step. A
  stall raises nothing (the ``hang`` fault seam sleeps), so the driver
  times the executor future itself: timeout → bounded grace wait → a
  late-completing step is rolled back through ``engine.note_hang()``
  (the retry ladder); a still-stuck one raises
  ``EngineWedgedError`` so a supervisor can restart from snapshot
- ``snapshot_dir`` + ``snapshot_every``: periodic engine snapshots
  between steps, each followed by journal compaction (records covered
  by the snapshot are dropped)

``recover_engine`` is the restart half: restore the newest snapshot
into a cold engine, then replay the journal to re-queue acknowledged
submissions the snapshot missed.

On a mesh (one process per rank) rank 0 runs the gateway, the journal
and the watchdog over a ``MeshLeader``, its engine as the gateway sees it:
the engine calls that change host state (make_request, enqueue, cancel,
take_done, note_hang) are logged, and the calls that run the model
(step, snapshot, warm_compile, restore) first broadcast the log and
themselves to ``follow``, the loop of every other rank, which replays
them in order on its own engine. So every rank steps the same scheduler
on the same calls, and a follower takes each request with rank 0's
admission verdict (``replay_enqueue``). A journal replay's
``requeue_lost`` is logged too, and ``run`` drains through broadcast
steps. After a wedge, ``MeshLeader.rebuild`` writes every rank's engine
off (weights, caches and CUDA graphs released) before it builds a fresh
one on the same mesh, so two engines never share a rank's memory;
``recover_engine`` over the leader then sends the snapshot on to the
followers (``restore``), each cutting its own shards.

A copy of ``repro.serving.gateway`` (numpy and asyncio only) over the
port's engines, journal and scheduler. On the card ``step()`` replays the
engine's CUDA graphs in the executor thread, and so does ``warm_compile``,
which captures them; the loop thread makes no CUDA call while a step is
out. A wedged step's thread stays asleep in the ``hang`` seam until its
stall ends, then replays on the old engine: ``asyncio.run`` joins it on
exit, so a supervisor that builds and warms the fresh engine after that
(as ``launch/serve.py --supervise`` does) captures with no other thread
on the card.
"""

from __future__ import annotations

import asyncio
import gc
import pickle
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import load_snapshot, save_snapshot
from repro_torch.serving.journal import RequestJournal
from repro_torch.serving.scheduler import request_rank

_DONE = object()        # stream sentinel: the handle reached a terminal state

_POLICY_ALIASES = {
    "reject-overload": "reject",
    "shed-lowest-class": "shed",
}
BACKPRESSURE_POLICIES = ("block", "reject", "shed")


class EngineWedgedError(RuntimeError):
    """The watchdog's terminal verdict: a dispatch blew its wall-clock
    deadline *and* its grace window — the engine thread is presumed
    stuck, so in-process recovery (which needs that thread back) is off
    the table. The driver refuses every open handle and re-raises this;
    a supervisor restarts from snapshot + journal (``recover_engine``,
    ``launch/serve.py --supervise``)."""


class RequestHandle:
    """Client-side view of one submitted request: a token stream plus a
    terminal-result future. Created by ``ServingGateway.submit``; all
    mutation happens on the gateway's loop thread."""

    def __init__(self, gateway: "ServingGateway", request) -> None:
        self._gw = gateway
        self.request = request
        self._chunks: deque = deque()       # np arrays, then _DONE
        self._new = asyncio.Event()
        self._terminal = asyncio.Event()
        self._first_s: Optional[float] = None
        self._last_s: Optional[float] = None
        self.streamed = 0                   # tokens delivered to _chunks

    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def status(self) -> str:
        return self.request.status

    def _push(self, arr: np.ndarray) -> None:
        now = time.perf_counter()
        if self._first_s is None:
            self._first_s = now
        self._last_s = now
        self.streamed += int(arr.shape[0])
        self._chunks.append(arr)
        self._new.set()

    def _finish(self) -> None:
        self._chunks.append(_DONE)
        self._terminal.set()
        self._new.set()

    async def stream(self):
        """Async-iterate generated token ids as each engine step's host
        sync lands. Leaving the iterator before it is exhausted (client
        disconnect, ``break``, task cancellation) cancels the request so
        an abandoned stream stops burning decode budget. The stream ends
        at the terminal state whatever its status — a quarantined or
        cancelled request's stream simply stops after its partial
        output; inspect ``(await handle.result()).status``."""
        try:
            while True:
                if self._chunks:
                    arr = self._chunks.popleft()
                    if arr is _DONE:
                        return
                    for t in arr.tolist():
                        yield int(t)
                    continue
                self._new.clear()
                if self._chunks:
                    continue
                await self._new.wait()
        finally:
            if not self._terminal.is_set():
                # fire-and-forget: GeneratorExit forbids awaiting here
                asyncio.ensure_future(self._gw.cancel(self.request_id))

    async def result(self):
        """Wait for (and return) the terminal ``Request`` — any status:
        done / failed / rejected / cancelled."""
        await self._terminal.wait()
        return self.request


class ServingGateway:
    """Asyncio front end owning one engine and its driver loop. See the
    module docstring for the model; typical use::

        async with ServingGateway(engine, max_queue=64,
                                  policy="shed") as gw:
            h = await gw.submit(prompt, max_new_tokens=32)
            async for tok in h.stream():
                ...
            r = await h.result()
    """

    def __init__(self, engine, *, max_queue: int = 64,
                 policy: str = "block",
                 forward_depth: Optional[int] = None,
                 journal: Optional[RequestJournal] = None,
                 step_timeout_s: Optional[float] = None,
                 hang_grace: float = 1.0,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0) -> None:
        policy = _POLICY_ALIASES.get(policy, policy)
        if policy not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"policy must be one of {BACKPRESSURE_POLICIES} "
                f"(or aliases {tuple(_POLICY_ALIASES)}), got {policy!r}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue})")
        if step_timeout_s is not None and step_timeout_s <= 0:
            raise ValueError(
                f"step_timeout_s must be positive (got {step_timeout_s})")
        self.engine = engine
        self.policy = policy
        self.max_queue = max_queue
        self.forward_depth = (
            forward_depth if forward_depth is not None
            else max(1, getattr(engine, "batch_slots", 1)))
        # durability knobs (all optional; see module docstring)
        self._journal = journal
        self.step_timeout_s = step_timeout_s
        self.hang_grace = hang_grace
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self._inbox: deque = deque()    # made Requests awaiting the engine
        self._handles: Dict[int, RequestHandle] = {}
        self._cancels: List[Tuple[int, asyncio.Future]] = []
        self._tap_buf: List[Tuple[int, np.ndarray]] = []
        self._wake: Optional[asyncio.Event] = None
        self._room: Optional[asyncio.Condition] = None
        self._draining = False
        self._task: Optional[asyncio.Task] = None
        # service counters (bench + tests read these)
        self.submitted = 0
        self.shed_count = 0
        self.reject_count = 0
        self.peak_queue = 0
        self.watchdog_timeouts = 0      # dispatches past step_timeout_s
        self.snapshots_taken = 0
        self.steps_driven = 0
        engine.on_tokens = self._tap

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        """Start the driver task (idempotent; ``submit`` calls this)."""
        if self._wake is None:
            self._wake = asyncio.Event()
            self._room = asyncio.Condition()
        if self._task is None and not self._draining:
            self._task = asyncio.get_running_loop().create_task(
                self._drive())

    async def drain(self) -> None:
        """Graceful shutdown: refuse new submits, wake blocked
        submitters (they are rejected ``gateway_draining``), serve
        everything already accepted to its terminal state, then stop the
        driver. The engine drains through its normal step loop, so
        slot/pool invariants (free list full, zero ledger gaps) hold
        afterwards."""
        self._draining = True
        if self._wake is None:
            return
        async with self._room:
            self._room.notify_all()
        self._wake.set()
        if self._task is not None:
            task, self._task = self._task, None
            await task

    async def __aenter__(self) -> "ServingGateway":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.drain()

    # -- client API -----------------------------------------------------------

    async def submit(self, prompt, max_new_tokens: int = 16,
                     temperature: float = 0.0, priority: int = 0,
                     deadline_s: Optional[float] = None) -> RequestHandle:
        """Submit one request and return its handle immediately (or, for
        policy ``block`` on a full queue, after room opens up). A
        refused request still gets a handle — its ``result()`` resolves
        with status ``rejected`` and a machine-readable reason — so
        open-loop drivers account every arrival uniformly. Request ids
        are allocated here, in submission order, which keeps sampled
        outputs replayable against a closed-loop engine run."""
        await self.start()
        r = self.engine.make_request(
            np.asarray(prompt, np.int32), max_new_tokens, temperature,
            priority=priority, deadline_s=deadline_s)
        h = RequestHandle(self, r)
        self._handles[r.request_id] = h
        self.submitted += 1
        if self._draining:
            self._refuse(h, "rejected",
                         "gateway_draining: drain() in progress")
            return h
        if self._task is not None and self._task.done():
            # the driver died (EngineWedgedError or a real bug): nothing
            # will ever drive this request, so fail it now instead of
            # handing back a handle that never resolves. Not journaled —
            # it was never acknowledged, so the supervisor's replay
            # rightly skips it (the client saw the failure)
            self._refuse(h, "failed",
                         "gateway_down: driver task terminated")
            return h
        if len(self._inbox) >= self.max_queue:
            if self.policy == "block":
                async with self._room:
                    await self._room.wait_for(
                        lambda: len(self._inbox) < self.max_queue
                        or self._draining)
                if self._draining:
                    self._refuse(h, "rejected",
                                 "gateway_draining: drain() in progress")
                    return h
            elif self.policy == "reject":
                self.reject_count += 1
                self._refuse(h, "rejected",
                             "gateway_overload: submit queue full")
                return h
            else:   # shed: evict strictly-worse-ranked queued work
                victim = max(self._inbox, key=request_rank)
                if request_rank(victim) > request_rank(r):
                    self._inbox.remove(victim)
                    self.shed_count += 1
                    self._refuse(
                        self._handles[victim.request_id], "rejected",
                        f"shed_overload: displaced by better-ranked "
                        f"request {r.request_id}", journal=True)
                else:
                    self.reject_count += 1
                    self._refuse(
                        h, "rejected",
                        "gateway_overload: queue full of "
                        "better-or-equal-ranked work")
                    return h
        if self._journal is not None and not self._journal.record_submit(r):
            # write-ahead: journaled before the ack, so a crash after this
            # point can never lose an acknowledged request. A duplicate id
            # (possible after a restart replays the id space) is refused —
            # serving it twice would corrupt the journal's id -> outcome map
            self._refuse(h, "rejected",
                         f"duplicate_rid: request id {r.request_id} is "
                         f"already journaled")
            return h
        self._inbox.append(r)
        self.peak_queue = max(self.peak_queue,
                              len(self._inbox) + self.engine.queue_depth())
        self._wake.set()
        return h

    async def cancel(self, request_id: int) -> bool:
        """Cancel wherever the request lives — gateway queue, engine
        queue, mid-prefill or mid-decode. Returns False when it is not
        in flight (already terminal, or unknown)."""
        h = self._handles.get(request_id)
        if h is None or h._terminal.is_set():
            return False
        for q in self._inbox:
            if q.request_id == request_id:
                self._inbox.remove(q)
                self._refuse(h, "cancelled", "cancelled: in gateway queue",
                             journal=True)
                async with self._room:
                    self._room.notify(1)
                return True
        fut = asyncio.get_running_loop().create_future()
        self._cancels.append((request_id, fut))
        self._wake.set()
        return await fut

    def queue_depth(self) -> int:
        """Total waiting line: gateway inbox + engine queue."""
        return len(self._inbox) + self.engine.queue_depth()

    def stats(self) -> Dict[str, object]:
        """Service-level counters, with the owned engine's fault/retry/
        breaker accounting and the durability counters merged in — one
        call answers both "how is the service doing" and "how hard is
        the engine fighting underneath it"."""
        s: Dict[str, object] = {
            "policy": self.policy,
            "submitted": self.submitted,
            "queue_depth": self.queue_depth(),
            "peak_queue": self.peak_queue,
            "shed": self.shed_count,
            "rejected_overload": self.reject_count,
            "watchdog_timeouts": self.watchdog_timeouts,
            "snapshots_taken": self.snapshots_taken,
        }
        if self._journal is not None:
            s["journal"] = self._journal.stats()
        eng = self.engine
        keys = ("retries_total", "fault_recoveries", "quarantined",
                "preemptions", "restores", "hang_recoveries")
        if hasattr(eng, "engine_metrics"):     # cascade: breaker + legs
            m = eng.engine_metrics()
            s["engine"] = {
                "breaker": m["breaker"],
                "rerouted": m["rerouted"],
                "edge_failures": m["edge_failures"],
                "restores": m.get("restores", 0),
                "hang_recoveries": m.get("hang_recoveries", 0),
                "edge": {k: m["edge"].get(k, 0) for k in keys},
                "cloud": {k: m["cloud"].get(k, 0) for k in keys},
            }
        elif callable(getattr(eng, "metrics", None)):
            m = eng.metrics()
            s["engine"] = {k: m.get(k, 0) for k in keys}
        return s

    # -- internals (loop thread unless noted) ---------------------------------

    def _tap(self, events: List[Tuple[int, np.ndarray]]) -> None:
        # executor thread: append only; the driver dispatches after the
        # step returns so handles see loop-thread-only mutation
        self._tap_buf.extend(events)

    def _dispatch_taps(self) -> None:
        buf, self._tap_buf = self._tap_buf, []
        for rid, arr in buf:
            h = self._handles.get(rid)
            if h is not None and not h._terminal.is_set():
                if (h.streamed == 0 and self._journal is not None
                        and self._journal.seen(rid)):
                    self._journal.record_first_token(rid)
                h._push(arr)

    def _refuse(self, h: RequestHandle, status: str, reason: str,
                journal: bool = False) -> None:
        """Gateway-level terminal stamp (never reaches engine counters).
        ``journal`` closes out the request's journal entry too — only for
        deliberate per-request refusals of *accepted* work (shed victims,
        gateway-queue cancels). Crash-path refusals must leave the journal
        open: those are exactly the submissions replay re-queues."""
        r = h.request
        r.status = status
        r.failure_reason = reason
        if r.output is None:
            r.output = np.zeros((0,), np.int32)
        r.finish_s = time.perf_counter()
        r.latency_s = r.finish_s - r.submit_s
        if journal and self._journal is not None \
                and self._journal.seen(r.request_id):
            self._journal.record_terminal(r.request_id, status, reason)
        h._finish()

    def _resolve(self, done: Dict) -> None:
        for rid, r in done.items():
            if self._journal is not None and self._journal.seen(rid):
                self._journal.record_terminal(rid, r.status,
                                              r.failure_reason)
            h = self._handles.get(rid)
            if h is None or h._terminal.is_set():
                continue
            if r.status == "done" and h._first_s is not None:
                # stream-boundary accounting: TTFT/latency are what the
                # client observed (submit -> token surfaced on the
                # loop), not the engine's internal completion stamp
                r.ttft_s = h._first_s - r.submit_s
                r.finish_s = h._last_s
                r.latency_s = h._last_s - r.submit_s
            h.request = r
            h._finish()

    async def _step_watched(self, loop, eng) -> None:
        """One engine step under the wall-clock watchdog. A hang raises
        nothing inside the engine (the ``hang`` seam *sleeps*), so the
        deadline lives out here, on the executor future:

        - on time: nothing to do
        - late but within the grace window: the step's work is real, but
          the dispatch broke its latency contract — escalate through
          ``note_hang()``, which rolls every slot back to its checkpoint
          and re-queues through the retry/backoff/quarantine ladder
          (token-exact, so the only cost is redone compute)
        - still stuck after grace: the engine thread is presumed wedged;
          raise ``EngineWedgedError`` for the supervisor. The future is
          shielded, never cancelled — a cancelled step would leave the
          engine's state half-updated."""
        fut = loop.run_in_executor(None, eng.step)
        if self.step_timeout_s is None:
            await fut
            return
        try:
            await asyncio.wait_for(asyncio.shield(fut),
                                   self.step_timeout_s)
            return
        except asyncio.TimeoutError:
            pass
        self.watchdog_timeouts += 1
        done, _ = await asyncio.wait(
            {fut}, timeout=self.step_timeout_s * self.hang_grace)
        if not done:
            raise EngineWedgedError(
                f"engine step exceeded step_timeout_s="
                f"{self.step_timeout_s}s plus grace "
                f"({self.step_timeout_s * self.hang_grace:.3f}s); "
                f"restart from snapshot + journal")
        fut.result()       # surface a real exception from the late step
        if hasattr(eng, "note_hang"):
            eng.note_hang()

    def _checkpoint(self) -> None:
        """Periodic durability point (loop thread, engine idle): persist
        an engine snapshot, then compact the journal down to records the
        snapshot does not cover. No awaits between the two, so the
        snapshot/journal pair is consistent by construction."""
        save_snapshot(self.snapshot_dir, self.engine.snapshot(),
                      step=self.steps_driven)
        self.snapshots_taken += 1
        if self._journal is not None:
            self._journal.compact(self.engine.known_request_ids())

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        eng = self.engine
        try:
            on_card = getattr(getattr(eng, "device", None), "type",
                              None) == "cuda"
            if (self.step_timeout_s is not None or on_card) \
                    and hasattr(eng, "warm_compile"):
                # arm the watchdog only after the programs are warm: a
                # first-step graph capture (seconds) is indistinguishable
                # from a hang by wall-clock alone, and a watchdog that
                # trips on it would roll back (or declare wedged) a
                # perfectly healthy engine at startup. On the card warm
                # before any step too: a graph captured at first use in an
                # executor thread fails there (that thread's first cuBLAS
                # call would fall inside the capture)
                await loop.run_in_executor(None, eng.warm_compile)
            while True:
                # cancels first: the engine is idle on this thread
                # between steps, so these apply atomically
                cancels, self._cancels = self._cancels, []
                for rid, fut in cancels:
                    ok = eng.cancel(rid)
                    if not fut.done():
                        fut.set_result(ok)
                # forward inbox -> engine while its queue is shallow;
                # admission control prices the better-ranked gateway
                # tail via ahead_extra
                forwarded = False
                while (self._inbox
                       and eng.queue_depth() < self.forward_depth):
                    r = self._inbox.popleft()
                    mine = request_rank(r)
                    ahead = sum(1 for q in self._inbox
                                if request_rank(q) <= mine)
                    eng.enqueue(r, ahead_extra=ahead)
                    forwarded = True
                if forwarded:
                    async with self._room:
                        self._room.notify_all()
                self._resolve(eng.take_done())
                if eng.pending:
                    await self._step_watched(loop, eng)
                    self._dispatch_taps()
                    self._resolve(eng.take_done())
                    self.steps_driven += 1
                    if (self.snapshot_dir is not None and self.snapshot_every
                            and self.steps_driven % self.snapshot_every == 0):
                        self._checkpoint()
                    continue
                if self._inbox or self._cancels:
                    continue
                if self._draining:
                    break
                self._wake.clear()
                if self._inbox or self._cancels or self._draining:
                    continue
                await self._wake.wait()
        except BaseException as e:
            # never wedge a stream: every unresolved handle terminates.
            # Deliberately NOT journaled as terminal — these are exactly
            # the acknowledged submissions a restart must replay
            for h in list(self._handles.values()):
                if not h._terminal.is_set():
                    self._refuse(h, "failed", f"gateway_error: {e!r}")
            raise


def recover_engine(engine, *, snapshot_dir: Optional[str] = None,
                   journal: Optional[RequestJournal] = None
                   ) -> Dict[str, object]:
    """Crash-restart recovery, in dependency order: restore the newest
    snapshot into the cold ``engine`` (live requests re-queue with their
    token-exact resume checkpoints, terminal ones keep their results),
    then replay the write-ahead ``journal`` to re-queue acknowledged
    submissions the snapshot never saw. Either half is optional — no
    snapshot directory yet (crash before the first checkpoint) degrades
    to journal-only recovery; no journal degrades to snapshot-only.
    Returns what happened, for logs/tests."""
    info: Dict[str, object] = {
        "restored": {"live": 0, "terminal": 0},
        "replayed": {"replayed": 0, "covered": 0, "duplicates": 0},
    }
    if snapshot_dir is not None:
        try:
            snap, step = load_snapshot(snapshot_dir)
        except FileNotFoundError:
            snap = None
        if snap is not None:
            info["restored"] = engine.restore(snap)
            info["snapshot_step"] = step
    if journal is not None:
        info["replayed"] = journal.replay(engine)
    return info


class MeshLeader:
    """Rank 0's engine on a mesh, for the gateway (module docstring).
    Attributes it does not define are the engine's own (reads only).
    ``stop`` releases the followers; call it once rank 0 is done."""

    def __init__(self, engine, mesh) -> None:
        self.__dict__.update(_engine=engine, _mesh=mesh, _log=[],
                             _lock=threading.Lock())

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value) -> None:
        setattr(self._engine, name, value)     # on_tokens: rank 0's tap

    def _note(self, name: str, *args, **kw) -> None:
        with self._lock:
            self._log.append(pickle.dumps((name, args, kw)))

    def _broadcast(self, name: str, *args):
        """Send the log and this call to the followers, then make it."""
        self._note(name, *args)
        with self._lock:
            log, self._log[:] = list(self._log), []
        self._mesh.broadcast_object(log)
        return None if name == "stop" else getattr(self._engine,
                                                    name)(*args)

    def make_request(self, *args, **kw):
        r = self._engine.make_request(*args, **kw)
        self._note("make_request", *args, **kw)
        return r

    def enqueue(self, r, **kw) -> None:
        self._engine.enqueue(r, **kw)
        self._note("replay_enqueue", r)

    def requeue_lost(self, *args, **kw):
        r = self._engine.requeue_lost(*args, **kw)
        self._note("requeue_lost", *args, **kw)
        return r

    def cancel(self, request_id: int) -> bool:
        ok = self._engine.cancel(request_id)
        self._note("cancel", request_id)
        return ok

    def take_done(self):
        done = self._engine.take_done()
        if done:
            self._note("take_done")
        return done

    def note_hang(self) -> None:
        self._engine.note_hang()
        self._note("note_hang")

    def step(self) -> None:
        self._broadcast("step")

    def warm_compile(self) -> None:
        self._broadcast("warm_compile")

    def snapshot(self):
        return self._broadcast("snapshot")

    def restore(self, snap):
        return self._broadcast("restore", snap)

    def assert_invariants(self) -> None:
        self._broadcast("assert_invariants")

    def run(self):
        """Step every rank until nothing is pending; rank 0's finished
        requests (``ServingEngine.run``)."""
        while self._engine.pending:
            self.step()
        return self.take_done()

    def rebuild(self, build) -> None:
        """Write off every rank's engine and build a fresh one on the same
        mesh: the followers rebuild with their own callable (``follow``),
        rank 0 with ``build()``, each only after its old engine is
        released. Calls logged for the old engine are dropped with it."""
        with self._lock:
            self._log[:] = []
        self._mesh.broadcast_object([pickle.dumps(("rebuild", (), {}))])
        self.__dict__["_engine"] = None
        _release(self._mesh.device)
        self.__dict__["_engine"] = build()

    def stop(self) -> None:
        self._broadcast("stop")


def _release(device) -> None:
    """Free what a dropped engine held: cycles first (an engine's counted
    methods form some), then the allocator's cache on a card."""
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def follow(engine, mesh, rebuild=None) -> None:
    """The loop of a rank other than 0: replay rank 0's engine calls, in
    order, until it stops. On a ``rebuild`` record (``MeshLeader
    .rebuild``) the engine is dropped, its memory released, and
    ``rebuild()`` builds the one followed from then on; without the
    callable that record raises. Pass the only reference to ``engine``:
    a caller that keeps one keeps the written-off engine alive."""
    while True:
        for blob in mesh.broadcast_object():
            name, args, kw = pickle.loads(blob)
            if name == "stop":
                return
            if name == "rebuild":
                if rebuild is None:
                    raise RuntimeError(
                        f"rank {mesh.rank}: rank 0 rebuilt its engine, and "
                        f"follow was given no rebuild callable")
                engine = None
                _release(mesh.device)
                engine = rebuild()
                continue
            getattr(engine, name)(*args, **kw)
