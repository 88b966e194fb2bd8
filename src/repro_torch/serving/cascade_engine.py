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
probe succeeds.

Not ported yet (later slices of the port): the per-step token tap
(``on_tokens``; gateway), ``warm_compile``, ``note_hang``, ``snapshot``,
``restore``, ``requeue_lost`` and ``known_request_ids`` (durability), and
the ``speculative_tokens``, ``mesh`` and ``rules`` arguments, which raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cascade.ecc_infer import CascadeLM
from repro_torch.cascade.gate import ACCEPT, ESCALATE, gate_logits
from repro_torch.serving.engine import ServingEngine, validate_prompt
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

    def query(self, tokens: np.ndarray) -> dict:
        """tokens: (B, S) one-shot queries -> predictions + route info, as
        numpy arrays."""
        batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int32),
                                           device=self.cascade.edge.device)}
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


class CascadeServingEngine:
    """Generative ACE cascade on continuous-batching engines.

    One edge prefill gates every prompt (the ``cascade_gate`` kernel on its
    last-token logits against the BP thresholds); generation then runs on
    the routed engine. The WAN cost model matches ``CascadeLM.serve_step``:
    escalations ship their token ids up and their generated ids down. The
    edge engine samples with ``seed``, the cloud engine with ``seed + 1``.
    """

    def __init__(self, cascade: CascadeLM, edge_params, cloud_params, *,
                 batch_slots: int = 8, max_seq_len: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0,
                 cache_backend="ring", block_size: int = 16,
                 chunk_tokens: Optional[int] = None,
                 prefix_sharing: bool = True,
                 max_decode_steps: int = 1,
                 fault_plan=None,
                 breaker_failure_threshold: int = 3,
                 breaker_cooldown: int = 4,
                 speculative_tokens: int = 0,
                 mesh=None, rules=None):
        later = {"speculative_tokens": speculative_tokens or None,
                 "mesh": mesh, "rules": rules}
        for name, value in later.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}: speculative cloud decode and meshes are later "
                    f"slices of the port")
        self.cascade = cascade
        self.max_seq_len = max_seq_len
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
        engine_kw = dict(batch_slots=batch_slots, max_seq_len=max_seq_len,
                         eos_id=eos_id, cache_backend=cache_backend,
                         block_size=block_size, chunk_tokens=chunk_tokens,
                         prefix_sharing=prefix_sharing,
                         max_decode_steps=max_decode_steps)
        self.edge_engine = ServingEngine(cascade.edge, edge_params,
                                         seed=seed, **engine_kw)
        self.cloud_engine = ServingEngine(cascade.cloud, cloud_params,
                                          seed=seed + 1, **engine_kw)
        self._edge_params = edge_params
        self._requests: List[CascadeRequest] = []
        self._next_id = 0
        # routed-but-live requests by *inner* request id, and terminal
        # requests awaiting take_done
        self._edge_map: Dict[int, CascadeRequest] = {}
        self._cloud_map: Dict[int, CascadeRequest] = {}
        self._done: Dict[int, CascadeRequest] = {}

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
        engine-level message."""
        prompt = validate_prompt(prompt, max_new_tokens, self.max_seq_len,
                                 truncate=False)
        rid = self._next_id
        self._next_id += 1
        r = CascadeRequest(rid, prompt, priority=priority,
                           deadline_s=deadline_s,
                           max_new_tokens=max_new_tokens,
                           temperature=temperature)
        r.submit_s = time.perf_counter()
        return r

    def enqueue(self, r: CascadeRequest) -> None:
        """Queue a made request for the next gate round. Admission is the
        inner engines' job at route time (their deadline budgets are
        already shrunk by the gate wait), so this never refuses."""
        r.enqueue_s = time.perf_counter()
        self._requests.append(r)

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
        then the ``cascade_gate`` kernel on that (1, V) row. Returns
        (conf, route) as host numbers."""
        edge = self.cascade.edge
        length = len(prompt)
        bucket = bucket_for(length, self.edge_engine.buckets)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :length] = prompt
        logits, _ = edge.forward(
            self._edge_params,
            {"tokens": torch.from_numpy(tokens).to(edge.device)},
            logits_index=length - 1)
        conf, routes, _ = gate_logits(logits[:, 0], self.cascade.thresholds)
        return float(conf[0]), int(routes[0])

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
            "edge": self.edge_engine.metrics(),
            "cloud": self.cloud_engine.metrics(),
        }
