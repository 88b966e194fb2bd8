"""Token-budget step scheduler: the serving-engine policy layer.

Each engine step used to be "admit every queued prompt that fits (one
monolithic prefill each), then run one decode round" — a burst of long
prompts stalls every in-flight decode for the whole burst's prefill time,
exactly the tail-latency behavior ACE's performance-optimization layer is
meant to remove. The ``Scheduler`` pulls that policy out of
``ServingEngine.run()`` and composes each step as a *mixed batch* under a
configurable token budget:

- one decode token for every active slot (decode always proceeds), plus
- one or more *prompt chunks* for admitting requests, consuming whatever
  budget the decodes left.

Chunks are bucketed to a small power-of-two shape set (bounding retraces),
and in-flight prefills are continued before new admissions so a request's
time-to-first-token is never starved by later arrivals. With
``chunk_tokens=None`` the scheduler degenerates to the legacy policy
(whole-bucket admission), which stays the default; engines *execute*
scheduler decisions either way — they no longer decide anything.

Ordering is **SLO-aware**, not FIFO: every request carries a priority
*class* (higher = more latency-critical) and an optional relative
deadline, and ``request_rank`` orders by class first, earliest absolute
deadline second (EDF within a class), submission order last — so with no
priorities or deadlines set the policy is exactly the old FIFO. The rank
governs *both* levers the scheduler holds: which queued request is offered
admission (the engine's ``try_admit`` considers the best-ranked waiting
request, strictly — no lower-class backfill in front of a blocked
higher-class request) and which in-flight prefill gets chunk budget first.
When the best-ranked waiting request cannot be admitted (no free slot, or
the paged pool is out of blocks), ``plan_step`` asks the engine to
**preempt** via the ``try_preempt`` callback: the engine swaps out its
worst-ranked active slot — strictly lower class than the blocked request,
never a peer — and retries admission with the freed resources.

The scheduler also picks the **decode horizon**: how many fused decode
steps the engine scans per host sync (``StepPlan.decode_steps``). With
``max_decode_steps=K`` the engine pays one dispatch and one ``active``-mask
sync per K generated tokens instead of per token — the dominant residual
cost on weak hosts once the per-op compute is kernel-bound. The horizon is
dynamic: it collapses to 1 whenever prefill work is pending or a request
was just admitted (so chunked-prefill TTFT wins — and every request's
*first* token — are never delayed by a long scan), and is otherwise capped
by the smallest remaining per-slot budget headroom (a slot finishing its
budget mid-scan would occupy its slot as dead weight until the sync).
Horizons are rounded down to a power-of-two schedule (``k_schedule``) so
the engine compiles at most ``log2(K)`` scan variants.

Chunking is output-exact: a chunk attends to previously installed chunks
through the cache layout with ordinary position masking, so the logits at
the final prompt token — the only ones sampling ever reads — are identical
to the monolithic prefill's (``tests/test_scheduler.py`` pins this
token-for-token against the unchunked engine, shared prefixes and
copy-on-write divergence included).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

# sentinel returned by an engine's try_admit for legacy whole-prompt
# admissions (nothing to chunk; the engine already ran the prefill)
MONOLITHIC = object()


def prompt_buckets(max_seq_len: int, min_bucket: int = 16) -> List[int]:
    """Power-of-two prefill shapes: [min_bucket, ..., max_seq_len]."""
    buckets = []
    b = min_bucket
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return buckets


def bucket_for(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt length {n} exceeds the largest prefill bucket "
        f"{buckets[-1]} (= max_seq_len); engines validate this at submit() "
        f"— either raise max_seq_len or submit with truncation enabled")


def request_rank(r) -> Tuple:
    """Scheduling rank: smaller = served first. Class descending (higher
    ``priority`` wins), then earliest absolute deadline (``submit_s +
    deadline_s``; no deadline sorts after every deadline in its class),
    then submission order — so with neither priorities nor deadlines set
    the policy degenerates to exactly the old FIFO. ``None`` (plan-only
    unit tests) ranks constant: a stable sort preserves FIFO."""
    if r is None:
        return (0, math.inf, 0.0, -1)
    deadline = getattr(r, "deadline_s", None)
    abs_deadline = (r.submit_s + deadline) if deadline is not None \
        else math.inf
    return (-getattr(r, "priority", 0), abs_deadline, r.submit_s,
            r.request_id)


@dataclasses.dataclass
class PrefillProgress:
    """A request mid-prefill: ``next`` is the first prompt position not yet
    computed (> 0 at admission when a shared prefix was already installed).
    ``tokens`` overrides the token source (a resumed request re-prefills
    its prompt *plus* the tokens it already generated; the engine restores
    its decode state when the final chunk lands)."""
    request: Any
    slot: int
    next: int
    total: int
    tokens: Optional[Any] = None

    @property
    def done(self) -> bool:
        return self.next >= self.total


@dataclasses.dataclass(frozen=True)
class ChunkTask:
    """One prompt chunk to run this step: ``length`` real tokens starting at
    prompt position ``start``, padded to ``bucket`` (a compile shape), for
    the request prefilling in ``slot``. ``final`` marks the chunk that
    completes the prompt (its last-token logits seed decode)."""
    slot: int
    start: int
    length: int
    bucket: int
    final: bool


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Chunks to execute this step plus admission count. Whether a decode
    round follows is the *engine's* call at execution time: a final chunk
    in this very plan can activate a slot, so any decode flag computed at
    plan time would already be stale. ``decode_steps`` is the decode
    horizon: how many fused decode steps the engine scans before its next
    host sync (1 unless multi-step decode is enabled and no prefill work
    is pending). ``spec_tokens`` is the speculative draft depth: > 0 asks
    a draft-equipped engine to run one propose-k/verify round instead of
    the scan (``decode_steps`` is then its non-speculative fallback)."""
    chunks: Tuple[ChunkTask, ...]
    admitted: int         # requests granted a slot this step
    decode_steps: int = 1  # fused decode steps per host sync this round
    spec_tokens: int = 0   # draft depth k for a speculative decode round


def chunk_buckets(chunk_tokens: int, min_bucket: int = 8) -> List[int]:
    """Power-of-two chunk shapes: [min_bucket, ..., chunk_tokens]."""
    return prompt_buckets(chunk_tokens, min(min_bucket, chunk_tokens))


def slots_for_hbm(hbm_bytes_per_device: int, slot_bytes: float,
                  mesh_size: int = 1,
                  cap: Optional[int] = None) -> int:
    """Concurrent-slot budget from a *per-device* KV HBM budget.

    A pool sharded over ``mesh_size`` devices on the KV-head axis holds
    ``mesh_size ×`` the per-device budget in global K/V bytes, so at fixed
    per-device HBM the slot count scales linearly with the mesh —
    ``slot_bytes`` is the request's *global* footprint (e.g.
    ``blocks_needed × PagedCache.block_bytes()``). This is the sizing
    rule behind ``BENCH_serving.json``'s ``sharded_decode`` section."""
    total = int(hbm_bytes_per_device) * max(int(mesh_size), 1)
    slots = int(total // max(int(slot_bytes), 1))
    return min(slots, cap) if cap is not None else slots


class Scheduler:
    """Per-step admission + chunk policy under a token budget.

    ``token_budget`` is the target tokens *computed* per engine step:
    active-slot decodes count 1 each, prompt chunks their real length.
    Defaults to ``batch_slots + chunk_tokens`` (decodes never crowd out
    prefill entirely, and vice versa). Must exceed ``batch_slots`` so a
    fully decoding engine still advances the head prefill every step.

    ``max_decode_steps`` enables multi-step decode: each pure-decode step
    may scan up to that many fused decode steps per host sync (see
    ``StepPlan.decode_steps`` and ``_decode_horizon``).

    ``admission_policy`` enables submit-time deadline-feasibility control:
    the engine reports completed requests' service times per class
    (``observe_service``, an EWMA), and a deadline-carrying submit is
    checked against the measured rate and the work ranked ahead of it
    (``deadline_feasible``). "reject" turns an infeasible submit into a
    terminal rejection, "downgrade" strips its deadline (best-effort
    within its class); ``None`` (default) admits everything, exactly the
    old behavior.
    """

    def __init__(self, *, batch_slots: int, chunk_tokens: Optional[int] = None,
                 token_budget: Optional[int] = None, min_bucket: int = 8,
                 max_decode_steps: int = 1,
                 admission_policy: Optional[str] = None,
                 service_ewma_alpha: float = 0.25,
                 deadline_margin_target: float = 0.95,
                 deadline_margin_min_obs: int = 4,
                 deadline_margin_cap: float = 4.0,
                 speculative_tokens: int = 0,
                 spec_min_commit: float = 1.25,
                 spec_probe_every: int = 32):
        self.batch_slots = batch_slots
        self.chunk_tokens = chunk_tokens
        if admission_policy not in (None, "reject", "downgrade"):
            raise ValueError(
                f"admission_policy must be None, 'reject' or 'downgrade' "
                f"(got {admission_policy!r})")
        self.admission_policy = admission_policy
        self._ewma_alpha = service_ewma_alpha
        self._service_s: dict = {}      # priority class -> EWMA service s
        self._deadline_obs: dict = {}   # priority class -> [hits, total]
        # measured-outcome feedback on feasibility (see
        # ``deadline_safety_margin``): below-target observed hit rates
        # inflate the admission estimate, bounded by the cap
        self.deadline_margin_target = deadline_margin_target
        self.deadline_margin_min_obs = deadline_margin_min_obs
        self.deadline_margin_cap = deadline_margin_cap
        if max_decode_steps < 1:
            raise ValueError(
                f"max_decode_steps must be >= 1 (got {max_decode_steps})")
        self.max_decode_steps = max_decode_steps
        # horizons the engine may be asked to run (hence must compile):
        # powers of two up to — and always including — the max
        ks: List[int] = []
        k = 1
        while k < max_decode_steps:
            ks.append(k)
            k *= 2
        ks.append(max_decode_steps)
        self.k_schedule = ks
        # speculative draft depths the engine may be asked to run: same
        # pow2-up-to-and-including-max shape as k_schedule, empty when the
        # engine carries no draft model
        if speculative_tokens < 0:
            raise ValueError(
                f"speculative_tokens must be >= 0 (got {speculative_tokens})")
        self.speculative_tokens = speculative_tokens
        sk: List[int] = []
        k = 1
        while k < speculative_tokens:
            sk.append(k)
            k *= 2
        if speculative_tokens > 0:
            sk.append(speculative_tokens)
        self.spec_schedule = sk
        self.spec_min_commit = spec_min_commit
        self.spec_probe_every = max(1, spec_probe_every)
        self._spec_ewma: Optional[float] = None  # accepted proposals / slot-round
        self._spec_suppressed = 0
        if chunk_tokens is None:
            self.token_budget = None
            self.buckets: List[int] = []
            return
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1 (got {chunk_tokens})")
        if token_budget is None:
            token_budget = batch_slots + chunk_tokens
        if token_budget <= batch_slots:
            raise ValueError(
                f"token_budget ({token_budget}) must exceed batch_slots "
                f"({batch_slots}): a saturated decode batch would starve "
                f"prefill forever")
        self.token_budget = token_budget
        self.buckets = chunk_buckets(chunk_tokens, min_bucket)

    @property
    def chunked(self) -> bool:
        return self.chunk_tokens is not None

    # -- deadline-feasibility admission control -------------------------------
    def observe_service(self, priority: int, service_s: float) -> None:
        """Fold one completed request's service time (first slot grant →
        finish) into its class's EWMA. The engine calls this at every
        completion; the estimate then prices future admissions."""
        prev = self._service_s.get(priority)
        a = self._ewma_alpha
        self._service_s[priority] = service_s if prev is None \
            else (1.0 - a) * prev + a * service_s

    def service_estimate(self, priority: int) -> Optional[float]:
        """Expected service seconds for one request of ``priority``:
        the class EWMA, falling back to the mean across observed classes
        (a new class is better priced by neighbors than not at all), or
        None before any completion (cold start: admission cannot judge,
        so it admits)."""
        if priority in self._service_s:
            return self._service_s[priority]
        if self._service_s:
            return sum(self._service_s.values()) / len(self._service_s)
        return None

    def reset_estimates(self) -> None:
        """Drop the service EWMAs and deadline observations — for
        callers that warm/compile through real requests before the
        measured (or served) traffic begins. A warm-up completion's
        service time is dominated by XLA compiles that steady-state
        serving never pays again; pricing admission with it would refuse
        perfectly feasible deadlines (cold start admits instead)."""
        self._service_s.clear()
        self._deadline_obs.clear()

    def observe_deadline(self, priority: int, hit: bool) -> None:
        """Record one deadline outcome for ``priority``: completion within
        the deadline counts as a hit, completion after it (or quarantine)
        as a miss. Cancelled/rejected requests are never recorded — the
        hit *rate* is the feedback signal that tells us whether
        ``deadline_feasible``'s first-order admission estimate is honest,
        and refusals are its output, not its ground truth."""
        hits, total = self._deadline_obs.get(priority, (0, 0))
        self._deadline_obs[priority] = (hits + (1 if hit else 0), total + 1)

    def deadline_hit_rates(self) -> dict:
        """Per-class deadline outcomes: ``{priority: {"hits", "total",
        "rate"}}`` over every deadlined request that reached a counted
        terminal state (done or quarantined)."""
        return {
            p: {"hits": h, "total": t, "rate": (h / t if t else 0.0)}
            for p, (h, t) in sorted(self._deadline_obs.items())
        }

    def absorb_deadline_hits(self, table: Optional[dict]) -> None:
        """Seed the per-class deadline observations from an externally
        measured table — ``MonitoringService.deadline_hit_rates``'s
        ``{priority: {"hits", "total", ...}}`` shape — closing the loop
        between monitored outcomes and the admission estimator (and, on a
        restart, letting a recovered engine inherit the previous
        incarnation's evidence instead of cold-starting the margin).
        Absorbed counts *replace* the class's local tally: the monitoring
        table is the superset view."""
        if not table:
            return
        for p, row in table.items():
            self._deadline_obs[int(p)] = (int(row["hits"]),
                                          int(row["total"]))

    def deadline_safety_margin(self, priority: int) -> float:
        """Multiplier on the feasibility estimate from *measured* deadline
        outcomes: 1.0 while the class's observed hit rate meets
        ``deadline_margin_target`` (or while fewer than
        ``deadline_margin_min_obs`` outcomes exist — too little evidence
        to second-guess the EWMA), otherwise ``target / rate`` capped at
        ``deadline_margin_cap``. A class that keeps missing in practice —
        preemption churn, fault retries, estimator bias — thus needs
        proportionally more headroom before "feasible", so admission
        tracks observed per-class outcomes, not just the service-time
        EWMA. Cleared with ``reset_estimates`` (restarts included)."""
        hits, total = self._deadline_obs.get(priority, (0, 0))
        if total < self.deadline_margin_min_obs:
            return 1.0
        rate = hits / total
        if rate >= self.deadline_margin_target:
            return 1.0
        floor = self.deadline_margin_target / self.deadline_margin_cap
        return self.deadline_margin_target / max(rate, floor)

    def deadline_feasible(self, *, deadline_s: float, ahead: int,
                          priority: int) -> bool:
        """Whether a submit with ``deadline_s`` can plausibly meet it:
        ``ahead`` requests (active + queued at better-or-equal rank) must
        drain through ``batch_slots`` concurrent slots at the measured
        class service rate before this one finishes, with the estimate
        inflated by the class's measured-outcome safety margin
        (``deadline_safety_margin``). Deliberately first-order — the
        point is refusing submits that are *hopeless* at the observed
        rate, not shaving the marginal ones."""
        s = self.service_estimate(priority)
        if s is None:
            return True
        wait = ahead * s / self.batch_slots
        return (wait + s) * self.deadline_safety_margin(priority) \
            <= deadline_s

    # -- speculative draft-depth policy ---------------------------------------
    def observe_speculation(self, slot_rounds: int, drafted: int,
                            accepted: int) -> None:
        """Fold one speculative round's outcome into the acceptance EWMA.
        ``slot_rounds`` is how many active slots the round covered,
        ``drafted`` the proposals issued (slots × k), ``accepted`` how
        many of them the target kept. The tracked quantity is accepted
        proposals per slot-round: a speculative dispatch commits
        ``1 + that`` tokens per slot, which is what ``_spec_horizon``
        compares against a plain step's guaranteed 1."""
        if slot_rounds <= 0:
            return
        m = accepted / slot_rounds
        a = self._ewma_alpha
        self._spec_ewma = m if self._spec_ewma is None \
            else (1.0 - a) * self._spec_ewma + a * m

    def speculative_acceptance(self) -> Optional[float]:
        """Current acceptance EWMA (accepted proposals per slot-round),
        or None before any speculative round ran."""
        return self._spec_ewma

    def _spec_horizon(self, busy_prefill: bool,
                      min_headroom: Optional[int]) -> int:
        """Draft depth k for this round, 0 meaning run non-speculative.
        Collapses while prefill work is pending (same TTFT argument as
        ``_decode_horizon``), when the smallest active budget leaves no
        room to commit more than the anchor token, and when the
        acceptance EWMA says a speculative dispatch commits fewer than
        ``spec_min_commit`` tokens per slot — drafting then costs draft
        FLOPs for less than a plain step delivers. Suppression re-probes
        every ``spec_probe_every`` suppressed plans so a workload shift
        (e.g. the repetitive tail of a trace) can win speculation back."""
        if not self.spec_schedule or busy_prefill:
            return 0
        cap = self.speculative_tokens
        if min_headroom is not None:
            # committing k proposals + the anchor never overruns the
            # tightest budget: clamp k to headroom - 1
            cap = min(cap, min_headroom - 1)
        if cap < 1:
            return 0
        if self._spec_ewma is not None \
                and 1.0 + self._spec_ewma < self.spec_min_commit:
            self._spec_suppressed += 1
            if self._spec_suppressed % self.spec_probe_every:
                return 0
        return max(k for k in self.spec_schedule if k <= cap)

    def _decode_horizon(self, busy_prefill: bool,
                        min_headroom: Optional[int]) -> int:
        """Fused decode steps for this round. Collapses to 1 while prefill
        work is pending (or a request was just admitted) so a scan never
        delays anyone's first token; otherwise the largest schedule entry
        within the smallest active slot's remaining budget — a slot never
        finishes its budget mid-scan and then squats on its slot waiting
        for the sync."""
        if busy_prefill or self.max_decode_steps == 1:
            return 1
        cap = self.max_decode_steps
        if min_headroom is not None:
            cap = max(1, min(cap, min_headroom))
        return max(k for k in self.k_schedule if k <= cap)

    # -- the per-step decision ------------------------------------------------
    def plan_step(self, *, n_active: int, prefilling,
                  try_admit: Callable[[], Any],
                  min_headroom: Optional[int] = None,
                  try_preempt: Optional[Callable[[], bool]] = None
                  ) -> StepPlan:
        """Compose one step. ``prefilling`` maps slot -> PrefillProgress;
        ``try_admit`` is the engine's admission effect: it grants the
        best-``request_rank``ed waiting request a slot (plus cache
        reservation) and returns its PrefillProgress, MONOLITHIC for legacy
        (and resumed) admissions, or None when nothing further can be
        admitted. ``try_preempt`` is the engine's preemption effect: swap
        out one active slot strictly lower-class than the best-ranked
        waiting request and return True (False when no eligible victim) —
        it is consulted only when admission is blocked, and every success
        retries admission with the freed slot/blocks. ``min_headroom`` is
        the smallest remaining decode budget across the engine's active
        slots (None when none are active) — it caps the multi-step decode
        horizon. The engine executes the returned chunks in order, then
        scans ``decode_steps`` fused decode rounds over whatever is
        active."""
        admitted = 0
        if not self.chunked:
            while True:
                if try_admit() is not None:
                    admitted += 1
                    continue
                if try_preempt is not None and try_preempt():
                    continue                 # freed a slot: retry admission
                break
            return StepPlan((), admitted,
                            self._decode_horizon(admitted > 0, min_headroom),
                            self._spec_horizon(admitted > 0, min_headroom))

        budget = self.token_budget
        spent = n_active                     # decode tokens this step
        chunks: List[ChunkTask] = []

        def plan_for(pp: PrefillProgress, spent: int) -> int:
            at = pp.next
            while at < pp.total and spent < budget:
                room = budget - spent
                t = min(self.chunk_tokens, pp.total - at)
                if t > room and chunks:
                    # no runt chunks: a truncated chunk costs a full device
                    # dispatch for a sliver of tokens — leave the budget's
                    # tail unspent and let the next step issue a full chunk
                    # (the first chunk of a step always proceeds, so an
                    # over-budget decode load can't starve prefill)
                    break
                chunks.append(ChunkTask(
                    slot=pp.slot, start=at, length=t,
                    bucket=bucket_for(t, self.buckets),
                    final=at + t >= pp.total))
                at += t
                spent += t
            return spent

        # continue in-flight prefills first, best rank first (class, then
        # deadline, then admission order — a latency-critical prefill gets
        # chunk budget ahead of bulk work; the sort is stable, so untagged
        # traffic keeps the old FIFO order)
        for pp in sorted(prefilling.values(),
                         key=lambda pp: request_rank(pp.request)):
            spent = plan_for(pp, spent)
        # admit new requests into the remaining budget; when the best-
        # ranked waiting request is blocked on resources, try preempting a
        # lower-class slot and retry
        while spent < budget:
            pp = try_admit()
            if pp is None:
                if try_preempt is not None and try_preempt():
                    continue
                break
            admitted += 1
            if pp is MONOLITHIC:
                continue
            spent = plan_for(pp, spent)
        busy_prefill = bool(chunks) or bool(prefilling) or admitted > 0
        return StepPlan(tuple(chunks), admitted,
                        self._decode_horizon(busy_prefill, min_headroom),
                        self._spec_horizon(busy_prefill, min_headroom))
