"""Cascade serving engines: the ACE edge/cloud LM cascade over the serving
layer.

Port of ``repro.serving.cascade_engine``. ``CascadeEngine`` answers
batched one-shot queries (one forward per model, the video-query analog).
``CascadeServingEngine`` is the generative version on two continuous-
batching ``ServingEngine``s: the edge draft prefills each prompt once and
the ``cascade_gate`` kernel routes the request on its last-token logits —
accepted prompts generate on the edge engine, escalated ones on the cloud
engine, dropped ones are answered at the gate with an empty output. A
circuit breaker guards the edge: repeated edge outages (the ``edge`` seam
of a ``FaultPlan``) send requests straight to the cloud until a half-open
probe succeeds. With ``speculative_tokens=k`` the cloud engine speculates
with the edge model as its draft.

For the gateway it has ``repro``'s protocol: ``on_tokens`` (the legs' taps,
inner request ids translated to cascade ids), ``enqueue(ahead_extra=)``,
``note_hang``, ``known_request_ids``, and ``snapshot``/``restore``/
``requeue_lost`` in ``repro``'s wire format (both legs' snapshots, the
cascade's request table, routing maps, breaker and metrics). With a
``mesh`` both legs serve tensor-parallel on it (``ServingEngine``'s mesh),
and the gate reads the edge's logits gathered over the vocab, so the
``cascade_gate`` kernel is the one-device kernel; ``replay_enqueue`` takes
the mesh gateway's requests on the follower ranks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cascade.ecc_infer import CascadeLM
from repro_torch.cascade.gate import (ACCEPT, ESCALATE, GateThresholds,
                                      gate_logits)
from repro_torch.checkpoint.io import json_leaf, json_unleaf
from repro_torch.serving.engine import (ServingEngine, _GraphedPrograms,
                                        _Staged, validate_prompt)
from repro_torch.serving.faults import FaultError
from repro_torch.serving.scheduler import bucket_for


@dataclasses.dataclass
class CascadeMetrics:
    queries: int = 0
    escalated: int = 0
    accepted: int = 0
    dropped: int = 0
    wan_bytes: int = 0
    agreement: float = 0.0      # edge-vs-final agreement rate (running)
    edge_failures: int = 0      # edge attempts that faulted
    rerouted: int = 0           # requests failed over edge -> cloud


@dataclasses.dataclass
class CircuitBreaker:
    """Classic three-state breaker guarding the edge path.

    closed: every request may try the edge. ``failure_threshold``
    *consecutive* edge failures trip it open (one success resets the
    count). open: requests go straight to the cloud without touching the
    edge; after ``cooldown`` denials the breaker goes half-open and lets
    the next request through as a probe. half-open: the probe's outcome
    decides — success closes the breaker, failure re-opens it (and
    restarts the cooldown). Counting in *requests*, not wall-clock,
    keeps chaos tests deterministic."""
    failure_threshold: int = 3
    cooldown: int = 4
    state: str = "closed"            # closed | open | half_open
    consecutive_failures: int = 0
    trips: int = 0                   # closed/half-open -> open transitions
    _denied: int = 0

    def allow(self) -> bool:
        """May this request try the edge? (Consumes one cooldown tick
        while open.)"""
        if self.state == "closed":
            return True
        if self.state == "open":
            self._denied += 1
            if self._denied >= self.cooldown:
                self.state = "half_open"
                return True          # this request is the probe
            return False
        return True                  # half-open: probe in flight

    def success(self) -> None:
        self.consecutive_failures = 0
        self.state = "closed"

    def failure(self) -> None:
        self.consecutive_failures += 1
        if (self.state == "half_open"
                or self.consecutive_failures >= self.failure_threshold):
            if self.state != "open":
                self.trips += 1
            self.state = "open"
            self._denied = 0


class CascadeEngine:
    """One-shot queries through ``CascadeLM.serve_step`` (``compact``) or
    ``lockstep_step``, with running ``CascadeMetrics``."""

    def __init__(self, cascade: CascadeLM, edge_params, cloud_params, *,
                 compact: bool = True):
        self.cascade = cascade
        self.edge_params = edge_params
        self.cloud_params = cloud_params
        self.metrics = CascadeMetrics()
        self._step = cascade.serve_step if compact else cascade.lockstep_step

    def query(self, tokens: np.ndarray, extra: Dict = None) -> dict:
        """tokens: (B, S) one-shot queries -> predictions + route info, as
        numpy arrays. ``extra``: the models' other inputs by name (a
        vision model's ``image_embeds`` (B, P, E)), as arrays or
        tensors."""
        dev = self.cascade.edge.device
        batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int32),
                                           device=dev)}
        for k, v in (extra or {}).items():
            batch[k] = torch.as_tensor(v, device=dev)
        t0 = time.time()
        out = self._step(self.edge_params, self.cloud_params, batch)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out["latency_s"] = time.time() - t0
        m = self.metrics
        b = tokens.shape[0]
        agree = float(np.mean(out["pred"] == out["edge_pred"]))
        m.agreement = ((m.agreement * m.queries + agree * b)
                       / max(m.queries + b, 1))
        m.queries += b
        m.escalated += int(out["escalate"])
        m.accepted += int(out["accept"])
        m.dropped += int(out["drop"])
        m.wan_bytes += int(out["wan_bytes"])
        return out


@dataclasses.dataclass
class CascadeRequest:
    request_id: int
    prompt: np.ndarray
    route: str = ""                  # accept | escalate | drop | failover
    conf: float = 0.0
    priority: int = 0                # SLO class, forwarded to the routed engine
    deadline_s: Optional[float] = None   # relative to *cascade* submit time
    submit_s: float = 0.0
    enqueue_s: float = 0.0           # cascade-queue entry
    output: Optional[np.ndarray] = None
    ttft_s: float = 0.0              # from cascade submit (gate wait included)
    finish_s: float = 0.0
    latency_s: float = 0.0
    status: str = "queued"           # terminal: done|rejected|cancelled
    failure_reason: Optional[str] = None
    max_new_tokens: int = 16
    temperature: float = 0.0


class CascadeServingEngine(_GraphedPrograms):
    """Generative ACE cascade on continuous-batching engines.

    One edge prefill gates every prompt (the ``cascade_gate`` kernel on its
    last-token logits against the BP thresholds); generation then runs on
    the routed engine. The WAN cost model matches ``CascadeLM.serve_step``:
    escalations ship their token ids up and their generated ids down. The
    edge engine samples with ``seed``, the cloud engine with ``seed + 1``.

    The gate is a program of its own, ("gate", edge bucket, hi, lo): the
    edge forward of the staged prompt and the kernel on its last real
    row, writing conf, route and counts into fixed tensors. On the card
    ``warm_compile`` captures it at every edge bucket as a CUDA graph,
    beside both legs' programs; thresholds other than those it was
    captured for make a program of their own.
    """

    def __init__(self, cascade: CascadeLM, edge_params, cloud_params, *,
                 batch_slots: int = 8, max_seq_len: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0,
                 cache_backend="ring", block_size: int = 16,
                 num_pool_blocks: Optional[int] = None,
                 truncate_prompts: bool = False,
                 chunk_tokens: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_sharing: bool = True,
                 max_decode_steps: int = 1,
                 fault_plan=None,
                 breaker_failure_threshold: int = 3,
                 breaker_cooldown: int = 4,
                 admission_policy: Optional[str] = None,
                 speculative_tokens: int = 0,
                 mesh=None, rules=None):
        self.cascade = cascade
        self.mesh = mesh
        self.batch_slots = batch_slots
        self.max_seq_len = max_seq_len
        self.truncate_prompts = truncate_prompts
        self.metrics = CascadeMetrics()
        # the ``edge`` seam of ``fault_plan`` models an edge-engine outage
        # at the gate; the breaker turns repeated outages into wholesale
        # cloud failover, and ``_degradation_s`` tracks an EWMA of the wall
        # clock each failed edge attempt burned, by which failover
        # deadlines are shrunk on top of the gate delay
        self._faults = fault_plan
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_failure_threshold,
            cooldown=breaker_cooldown)
        self._degradation_s = 0.0
        # both engines run the same scheduler policy (pool size, token
        # budget, chunked prefill, prefix sharing, decode horizon and
        # deadline admission), as in ``repro``; prompts reach them already
        # cut by ``make_request``
        engine_kw = dict(batch_slots=batch_slots, max_seq_len=max_seq_len,
                         eos_id=eos_id, cache_backend=cache_backend,
                         block_size=block_size,
                         num_pool_blocks=num_pool_blocks,
                         chunk_tokens=chunk_tokens, token_budget=token_budget,
                         prefix_sharing=prefix_sharing,
                         max_decode_steps=max_decode_steps,
                         admission_policy=admission_policy,
                         # both legs ride the same mesh, each placing its
                         # own params and pool
                         mesh=mesh, rules=rules)
        self.edge_engine = ServingEngine(cascade.edge, edge_params,
                                         seed=seed, **engine_kw)
        # speculative cloud decode drafts with the cascade's own edge model:
        # the ACE edge/cloud split used as a draft/verify pair. The edge
        # engine never speculates (no smaller model drafts for it).
        spec = speculative_tokens > 0
        self.cloud_engine = ServingEngine(
            cascade.cloud, cloud_params, seed=seed + 1,
            draft_model=cascade.edge if spec else None,
            draft_params=edge_params if spec else None,
            speculative_tokens=speculative_tokens, **engine_kw)
        # the edge leg's params, this rank's shards on a mesh
        self._edge_params = self.edge_engine.params
        # the gate program's staged prompt and its outputs
        self.device = cascade.edge.device
        self._gate_args = _Staged(self.device, length=1,
                                  tokens=max_seq_len)
        self._gate_out = {
            "conf": torch.zeros((1,), dtype=torch.float32,
                                device=self.device),
            "route": torch.zeros((1,), dtype=torch.int32, device=self.device),
            "counts": torch.zeros((3,), dtype=torch.int32,
                                  device=self.device)}
        self._init_programs()
        if mesh is not None and not mesh.capturable:
            self._use_graphs = False
        self._requests: List[CascadeRequest] = []
        self._next_id = 0
        # routed-but-live requests by *inner* request id, and terminal
        # requests awaiting take_done
        self._edge_map: Dict[int, CascadeRequest] = {}
        self._cloud_map: Dict[int, CascadeRequest] = {}
        self._done: Dict[int, CascadeRequest] = {}
        self._on_tokens = None
        # durability counters (the cascade's own; the legs keep theirs)
        self.restores = 0
        self.hang_recoveries = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        r = self.make_request(prompt, max_new_tokens, temperature,
                              priority=priority, deadline_s=deadline_s)
        self.enqueue(r)
        return r.request_id

    def make_request(self, prompt: np.ndarray, max_new_tokens: int = 16,
                     temperature: float = 0.0, priority: int = 0,
                     deadline_s: Optional[float] = None) -> CascadeRequest:
        """Validate and stamp a request without queueing it (same contract
        as ``ServingEngine.make_request``). The gate prefills through the
        edge engine's buckets, so an over-long prompt fails here with the
        engine-level message, or keeps its tail with ``truncate_prompts``."""
        prompt = validate_prompt(prompt, max_new_tokens, self.max_seq_len,
                                 self.truncate_prompts)
        rid = self._next_id
        self._next_id += 1
        r = CascadeRequest(rid, prompt, priority=priority,
                           deadline_s=deadline_s,
                           max_new_tokens=max_new_tokens,
                           temperature=temperature)
        r.submit_s = time.perf_counter()
        return r

    def enqueue(self, r: CascadeRequest, *, ahead_extra: int = 0) -> None:
        """Queue a made request for the next gate round. Admission is the
        inner engines' job at route time (their deadline budgets are
        already shrunk by the gate wait), so this never refuses;
        ``ahead_extra`` is taken for the gateway's protocol."""
        del ahead_extra
        r.enqueue_s = time.perf_counter()
        self._requests.append(r)

    def replay_enqueue(self, r: CascadeRequest) -> None:
        """Take a request as another rank's ``enqueue`` left it (the mesh
        gateway's followers)."""
        self._next_id = max(self._next_id, r.request_id + 1)
        self._requests.append(r)

    @property
    def on_tokens(self):
        return self._on_tokens

    @on_tokens.setter
    def on_tokens(self, cb) -> None:
        """Install a per-round token tap on both legs; inner request ids
        are translated to cascade ids through the live routing maps."""
        self._on_tokens = cb
        if cb is None:
            self.edge_engine.on_tokens = None
            self.cloud_engine.on_tokens = None
            return

        def translated(mapping):
            def tap(events):
                out = [(mapping[rid].request_id, arr)
                       for rid, arr in events if rid in mapping]
                if out:
                    cb(out)
            return tap

        self.edge_engine.on_tokens = translated(self._edge_map)
        self.cloud_engine.on_tokens = translated(self._cloud_map)

    def queue_depth(self) -> int:
        return (len(self._requests) + self.edge_engine.queue_depth()
                + self.cloud_engine.queue_depth())

    def _inner_deadline(self, r: CascadeRequest) -> Optional[float]:
        """Deadline for the routed engine, shrunk by the time the request
        already spent queued at the gate: the inner engine stamps its own
        submit time, so forwarding the raw relative deadline would extend
        the SLO by the gate delay. May go negative — EDF then ranks the
        already-late request first in its class."""
        if r.deadline_s is None:
            return None
        return r.deadline_s - (time.perf_counter() - r.submit_s)

    def _failover_deadline(self, r: CascadeRequest) -> Optional[float]:
        """Deadline on the edge -> cloud failover path: the gate delay
        (``_inner_deadline``) *plus* the observed edge degradation, the
        EWMA of wall clock burned per failed edge attempt."""
        d = self._inner_deadline(r)
        if d is None:
            return None
        return d - self._degradation_s

    def _gate(self, prompt: np.ndarray):
        """Edge prefill of the prompt right-padded to its edge bucket (as
        the engine's prefill), unembedding only the last real position,
        then the ``cascade_gate`` kernel on that (1, V) row: program
        ("gate", bucket, hi, lo). Returns (conf, route) as host numbers."""
        bucket = bucket_for(len(prompt), self.edge_engine.buckets)
        th = self.cascade.thresholds
        self._gate_args.put(length=len(prompt), tokens=prompt)
        self._run_program(("gate", bucket, th.hi, th.lo))
        out = self._gate_out
        return float(out["conf"][0]), int(out["route"][0])

    def _program_body(self, key) -> None:
        _, bucket, hi, lo = key
        a = self._gate_args
        logits, _ = self.cascade.edge.forward(
            self._edge_params, {"tokens": a["tokens"][:bucket][None]},
            logits_index=a["length"] - 1, mesh=self.mesh)
        for name, x in zip(("conf", "route", "counts"),
                           gate_logits(logits[:, 0],
                                       GateThresholds(hi, lo))):
            self._gate_out[name].copy_(x)

    def _route_pending(self) -> None:
        """Gate every queued request and hand it to its routed engine.

        The circuit breaker guards the edge attempt: while it is open,
        requests skip the gate and fail over to the cloud (route
        "failover") with a deadline shrunk by the observed degradation;
        an injected edge outage (``FaultPlan`` seam ``edge``) feeds the
        breaker's failure count, and a half-open probe closes it again
        once the edge recovers."""
        pending, self._requests = self._requests, []
        for r in pending:
            max_new, temp = r.max_new_tokens, r.temperature
            m = self.metrics
            m.queries += 1
            route = None
            if self.breaker.allow():
                attempt0 = time.perf_counter()
                try:
                    if self._faults is not None:
                        self._faults.check("edge", "edge gate prefill")
                    r.conf, route = self._gate(r.prompt)
                    self.breaker.success()
                except FaultError:
                    self.breaker.failure()
                    m.edge_failures += 1
                    lost = time.perf_counter() - attempt0
                    a = 0.25
                    self._degradation_s = lost if m.edge_failures == 1 \
                        else (1.0 - a) * self._degradation_s + a * lost
            if route is None:
                # breaker open, or this edge attempt failed: cloud failover
                r.route = "failover"
                m.rerouted += 1
                m.wan_bytes += len(r.prompt) * 4 + max_new * 4
                self._cloud_map[self.cloud_engine.submit(
                    r.prompt, max_new, temp, priority=r.priority,
                    deadline_s=self._failover_deadline(r))] = r
            elif route == ESCALATE:
                r.route = "escalate"
                m.escalated += 1
                # token ids up + generated ids down (cf. serve_step)
                m.wan_bytes += len(r.prompt) * 4 + max_new * 4
                self._cloud_map[self.cloud_engine.submit(
                    r.prompt, max_new, temp, priority=r.priority,
                    deadline_s=self._inner_deadline(r))] = r
            elif route == ACCEPT:
                r.route = "accept"
                m.accepted += 1
                self._edge_map[self.edge_engine.submit(
                    r.prompt, max_new, temp, priority=r.priority,
                    deadline_s=self._inner_deadline(r))] = r
            else:
                r.route = "drop"
                m.dropped += 1
                r.output = np.zeros((0,), np.int32)
                r.status = "done"
                r.finish_s = time.perf_counter()   # answered at the gate
                r.latency_s = r.finish_s - r.submit_s
                self._done[r.request_id] = r

    def _collect(self) -> None:
        """Translate inner-engine terminal requests to cascade terms.
        Latency and TTFT re-baseline onto the *cascade* submit stamp, so
        gate wait (and breaker cooldown) counts toward the client-visible
        numbers."""
        for ids, eng in ((self._edge_map, self.edge_engine),
                         (self._cloud_map, self.cloud_engine)):
            for rid, served in eng.take_done().items():
                r = ids.pop(rid, None)
                if r is None:
                    continue
                r.output = served.output
                r.status = served.status
                r.failure_reason = served.failure_reason
                if served.ttft_s > 0.0:
                    r.ttft_s = (served.submit_s - r.submit_s
                                + served.ttft_s)
                r.finish_s = (served.finish_s if served.finish_s
                              else time.perf_counter())
                r.latency_s = r.finish_s - r.submit_s
                self._done[r.request_id] = r

    @property
    def pending(self) -> bool:
        """Work outstanding anywhere in the cascade: ungated requests,
        routed-but-uncollected ones, or live inner-engine work."""
        return bool(self._requests or self._edge_map or self._cloud_map
                    or self.edge_engine.pending or self.cloud_engine.pending)

    def step(self) -> None:
        """One cascade round: gate whatever queued since the last round,
        advance each inner engine one step, collect terminals."""
        self._route_pending()
        for eng in (self.edge_engine, self.cloud_engine):
            if eng.pending:
                eng.step()
        self._collect()

    def take_done(self) -> Dict[int, CascadeRequest]:
        """Drain terminal cascade requests accumulated since last call."""
        done, self._done = self._done, {}
        return done

    def cancel(self, request_id: int) -> bool:
        """Cancel a cascade request wherever it lives: awaiting the gate,
        or in flight on its routed engine (any phase — the inner engine
        handles queued, prefill and decode)."""
        for r in self._requests:
            if r.request_id == request_id:
                self._requests.remove(r)
                r.output = np.zeros((0,), np.int32)
                r.status = "cancelled"
                r.failure_reason = "cancelled: awaiting gate"
                r.finish_s = time.perf_counter()
                r.latency_s = r.finish_s - r.submit_s
                self._done[r.request_id] = r
                return True
        for ids, eng in ((self._edge_map, self.edge_engine),
                         (self._cloud_map, self.cloud_engine)):
            for irid, r in list(ids.items()):
                if r.request_id == request_id:
                    ok = eng.cancel(irid)
                    self._collect()   # surface the terminal immediately
                    return ok
        return False

    def run(self) -> Dict[int, CascadeRequest]:
        """Drain loop: gate + generate until nothing is in flight."""
        while self.pending:
            self.step()
        return self.take_done()

    def program_keys(self) -> List[tuple]:
        """The gate at every edge bucket, at the current thresholds."""
        th = self.cascade.thresholds
        return [("gate", b, th.hi, th.lo) for b in self.edge_engine.buckets]

    def warm_compile(self) -> None:
        """Build both legs' programs (``ServingEngine.warm_compile``), as
        ``repro``'s does, then the gate's at every edge bucket (its
        warm-up gates an empty prompt of one token: it changes no
        state)."""
        self.edge_engine.warm_compile()
        self.cloud_engine.warm_compile()
        self._gate_args.put(length=1, tokens=[])
        self._warm_programs(self.program_keys())

    def engine_metrics(self) -> Dict[str, object]:
        """Monitoring snapshot across the cascade: routing and WAN
        counters, breaker state, and both inner engines' ``metrics()``."""
        m = self.metrics
        return {
            "queries": m.queries, "accepted": m.accepted,
            "escalated": m.escalated, "dropped": m.dropped,
            "rerouted": m.rerouted, "edge_failures": m.edge_failures,
            "wan_bytes": m.wan_bytes,
            "breaker": {"state": self.breaker.state,
                        "trips": self.breaker.trips,
                        "consecutive_failures":
                            self.breaker.consecutive_failures},
            "degradation_s": self._degradation_s,
            "restores": self.restores,
            "hang_recoveries": self.hang_recoveries,
            "edge": self.edge_engine.metrics(),
            "cloud": self.cloud_engine.metrics(),
        }

    # -- durability -----------------------------------------------------------
    def note_hang(self) -> None:
        """Watchdog escalation across the cascade: a wall-clock deadline
        cannot tell which leg stalled, so both roll back (token-exact
        either way)."""
        self.hang_recoveries += 1
        for eng in (self.edge_engine, self.cloud_engine):
            if eng._slots:
                eng.note_hang()

    def _live_cascade_requests(self) -> List[CascadeRequest]:
        return (list(self._requests) + list(self._edge_map.values())
                + list(self._cloud_map.values()))

    def known_request_ids(self) -> set:
        ids = {r.request_id for r in self._live_cascade_requests()}
        ids.update(self._done.keys())
        return ids

    def snapshot(self) -> Dict[str, object]:
        """The whole cascade in ``repro``'s wire format: both legs'
        snapshots (routed requests resume on their leg, token for token)
        and the cascade's request table, routing maps, breaker state and
        running metrics. Changes nothing."""
        now = time.perf_counter()
        requests: Dict[str, Dict[str, object]] = {}

        def record(r: CascadeRequest, phase: str, leg: Optional[str],
                   inner_rid: Optional[int]) -> None:
            rec: Dict[str, object] = {"meta": json_leaf({
                "rid": r.request_id, "phase": phase, "leg": leg,
                "inner_rid": inner_rid, "route": r.route,
                "conf": r.conf, "priority": r.priority,
                "deadline_s": r.deadline_s,
                "age_s": now - r.submit_s if r.submit_s else 0.0,
                "ttft_s": r.ttft_s, "status": r.status,
                "failure_reason": r.failure_reason,
                "latency_s": r.latency_s,
                "max_new_tokens": r.max_new_tokens,
                "temperature": r.temperature}),
                "prompt": np.asarray(r.prompt, np.int32)}
            if phase == "terminal" and r.output is not None \
                    and len(r.output):
                rec["output"] = np.asarray(r.output, np.int32)
            requests[f"r{r.request_id:08d}"] = rec

        for r in self._requests:
            record(r, "pending", None, None)
        for leg, mapping in (("edge", self._edge_map),
                             ("cloud", self._cloud_map)):
            for inner_rid, r in mapping.items():
                record(r, "routed", leg, inner_rid)
        for r in self._done.values():
            record(r, "terminal", None, None)
        meta = {"kind": type(self).__name__, "next_id": self._next_id,
                "degradation_s": self._degradation_s,
                "breaker": {"state": self.breaker.state,
                            "consecutive_failures":
                                self.breaker.consecutive_failures,
                            "trips": self.breaker.trips,
                            "denied": self.breaker._denied},
                "metrics": dataclasses.asdict(self.metrics)}
        return {"engine": json_leaf(meta), "requests": requests,
                "edge": self.edge_engine.snapshot(),
                "cloud": self.cloud_engine.snapshot()}

    def restore(self, snap: Dict[str, object]) -> Dict[str, object]:
        """Load a cascade ``snapshot`` into this cold cascade: the legs
        restore their requests first, then the cascade's table re-links
        routed requests to them by inner id. The breaker, the degradation
        EWMA and the routing metrics carry over."""
        if (self._requests or self._edge_map or self._cloud_map
                or self._done):
            raise RuntimeError("restore() needs a cold cascade engine")
        inner = {"edge": self.edge_engine.restore(snap["edge"]),
                 "cloud": self.cloud_engine.restore(snap["cloud"])}
        eng = json_unleaf(snap["engine"])
        now = time.perf_counter()
        live = terminal = 0
        for key in sorted(snap.get("requests", {})):
            rec = snap["requests"][key]
            meta = json_unleaf(rec["meta"])
            r = CascadeRequest(int(meta["rid"]),
                               np.asarray(rec["prompt"], np.int32),
                               route=meta["route"] or "",
                               conf=float(meta["conf"]),
                               priority=int(meta["priority"]),
                               deadline_s=meta["deadline_s"],
                               max_new_tokens=int(meta["max_new_tokens"]),
                               temperature=float(meta["temperature"]))
            r.submit_s = now - float(meta["age_s"])
            r.enqueue_s = now
            r.ttft_s = float(meta["ttft_s"])
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
            if meta["phase"] == "routed":
                mapping = (self._edge_map if meta["leg"] == "edge"
                           else self._cloud_map)
                mapping[int(meta["inner_rid"])] = r
            else:
                self._requests.append(r)
            live += 1
        self._next_id = max(self._next_id, int(eng["next_id"]))
        self._degradation_s = float(eng["degradation_s"])
        bk = eng["breaker"]
        self.breaker.state = bk["state"]
        self.breaker.consecutive_failures = bk["consecutive_failures"]
        self.breaker.trips = bk["trips"]
        self.breaker._denied = bk["denied"]
        self.metrics = CascadeMetrics(**eng["metrics"])
        self.restores += 1
        return {"live": live, "terminal": terminal, "inner": inner}

    def requeue_lost(self, request_id: int, prompt: np.ndarray,
                     max_new_tokens: int = 16, temperature: float = 0.0,
                     priority: int = 0,
                     deadline_s: Optional[float] = None) -> CascadeRequest:
        """Journal replay: re-queue a lost submission under its original
        id, back at the gate (it routes from scratch)."""
        prompt = validate_prompt(prompt, max_new_tokens, self.max_seq_len,
                                 self.truncate_prompts)
        r = CascadeRequest(int(request_id), prompt, priority=priority,
                           deadline_s=deadline_s,
                           max_new_tokens=max_new_tokens,
                           temperature=temperature)
        r.submit_s = time.perf_counter()
        r.enqueue_s = r.submit_s
        self._next_id = max(self._next_id, int(request_id) + 1)
        self._requests.append(r)
        return r
