"""Deterministic, seeded fault injection for the serving stack.

A copy of ``repro.serving.faults`` (numpy only; the port cannot import the
original, whose package loads the JAX engine), so a plan fires on the same
schedule in both packages. In the port only ``CascadeServingEngine``
consults a seam so far, ``edge``; the engine's own seams belong to the
durability slice, and ``ServingEngine(fault_plan=...)`` still raises
``NotImplementedError``. The rest of this docstring is ``repro``'s.

ACE's claim of user-transparent edge-cloud service is only as strong as
the serving loop's behavior when something breaks: a failed KV swap, a
poisoned device dispatch, a flaky WAN hop, an edge engine that stops
answering, a client that hangs up mid-generation. This module provides
the *injection* half of that story — a ``FaultPlan`` that trips named
seams on a reproducible schedule — so the recovery paths in
``ServingEngine`` / ``CascadeServingEngine`` / ``core.network`` can be
exercised deterministically in tests and benchmarks (see
``tests/test_faults.py`` and ``benchmarks/bench_serving.py``'s
``chaos_recovery`` section).

Named seams (the consumer documents which it consults):

====================  =====================================================
seam                  trips
====================  =====================================================
``step``              the single-step decode dispatch (``_step_impl``)
``scan``              the multi-step decode dispatch (``_scan_impl``)
``draft``             the speculative draft+verify dispatch
                      (``_spec_impl``) — the engine serves the round
                      through the plain decode path instead (token
                      streams are unchanged; throughput degrades)
``swap_out``          ``PagedCache.swap_out`` during preemption/rollback
``swap_in``           ``PagedCache.swap_in`` during a swap-path resume
``pool``              transient block-pool exhaustion at admission
``hang``              a *non-raising* stall at the decode dispatch: the
                      consulting site sleeps ``hang_s`` seconds instead
                      of raising, so no exception-based recovery path
                      ever sees it — only the gateway's wall-clock
                      watchdog can (see ``ServingGateway``)
``cancel``            cancellation of a random in-flight request
``edge``              edge-engine outage at the cascade gate
``wan_spike``         a latency spike on a ``core.network.Link`` transfer
``wan_outage``        a dead window on a ``core.network.Link``
====================  =====================================================

Determinism: each seam owns an independent ``numpy`` generator seeded
from ``(seed, crc32(seam))``, and faults fire by *opportunity index* —
the Nth consultation of a seam always resolves the same way for a given
plan, regardless of what any other seam did. A schedule can be given
explicitly (``at=(2, 5)`` — fire on those opportunity indices) or
probabilistically (``prob=0.05``), optionally bounded (``max_fires``) so
chaos runs provably terminate. Both forms can mix.

Injected failures surface as ``FaultError`` (a ``RuntimeError`` carrying
the seam name); consumers that *check* rather than *raise* use
``fire()`` directly (e.g. the pool seam makes admission answer "no
blocks" instead of raising).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


class FaultError(RuntimeError):
    """An injected failure, carrying the seam it came from."""

    def __init__(self, seam: str, detail: str = ""):
        self.seam = seam
        super().__init__(f"injected fault at seam {seam!r}"
                         + (f": {detail}" if detail else ""))


@dataclasses.dataclass(frozen=True)
class SeamSpec:
    """Schedule for one seam: explicit opportunity indices (``at``), a
    per-opportunity probability (``prob``), or both; ``max_fires`` caps
    total fires (None = unbounded — prefer a bound in drain loops so
    termination doesn't rest on probability alone)."""
    prob: float = 0.0
    at: Tuple[int, ...] = ()
    max_fires: Optional[int] = None

    def __post_init__(self):
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1] (got {self.prob})")


SpecLike = Union[SeamSpec, float, dict, Sequence[int]]


def _coerce(seam: str, spec: SpecLike) -> SeamSpec:
    if isinstance(spec, SeamSpec):
        return spec
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return SeamSpec(prob=float(spec))
    if isinstance(spec, dict):
        d = dict(spec)
        if "at" in d:
            d["at"] = tuple(d["at"])
        return SeamSpec(**d)
    if isinstance(spec, (list, tuple)):
        return SeamSpec(at=tuple(int(i) for i in spec))
    raise TypeError(f"seam {seam!r}: cannot build a SeamSpec from "
                    f"{spec!r} (want SeamSpec, float prob, index list, "
                    f"or kwargs dict)")


class FaultPlan:
    """A seeded, per-seam fault schedule.

    >>> plan = FaultPlan(seed=7, step={"prob": 0.2, "max_fires": 3},
    ...                  swap_in=[1])        # fire on the 2nd swap_in
    >>> plan.fire("step")                   # consult one opportunity
    False

    The same ``(seed, specs)`` always yields the same schedule; replaying
    a run with the same plan injects the same faults at the same
    opportunities, which is what makes the chaos tests' token-exactness
    assertions meaningful.
    """

    def __init__(self, seed: int = 0, hang_s: float = 0.25,
                 **seams: SpecLike):
        self.seed = seed
        # stall duration for the non-raising ``hang`` seam: how long the
        # consulting dispatch site sleeps when it fires. Long enough to
        # trip a watchdog deadline, short enough that chaos runs finish.
        self.hang_s = float(hang_s)
        self._specs: Dict[str, SeamSpec] = {
            name: _coerce(name, spec) for name, spec in seams.items()}
        self._rng: Dict[str, np.random.Generator] = {}
        self._opportunities: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        # (seam, opportunity_index) in firing order — the audit trail the
        # bench's chaos report and the tests' determinism checks read
        self.log: List[Tuple[str, int]] = []

    def _seam_rng(self, seam: str) -> np.random.Generator:
        if seam not in self._rng:
            self._rng[seam] = np.random.default_rng(
                [self.seed, zlib.crc32(seam.encode())])
        return self._rng[seam]

    # -- consultation ---------------------------------------------------------
    def fire(self, seam: str) -> bool:
        """Consume one opportunity at ``seam``; True = inject a fault."""
        idx = self._opportunities.get(seam, 0)
        self._opportunities[seam] = idx + 1
        spec = self._specs.get(seam)
        if spec is None:
            return False
        # always draw when a probability is set, so the schedule at
        # opportunity N never depends on max_fires having been hit earlier
        drew = (spec.prob > 0.0
                and float(self._seam_rng(seam).random()) < spec.prob)
        hit = idx in spec.at or drew
        if not hit:
            return False
        if spec.max_fires is not None \
                and self._fired.get(seam, 0) >= spec.max_fires:
            return False
        self._fired[seam] = self._fired.get(seam, 0) + 1
        self.log.append((seam, idx))
        return True

    def check(self, seam: str, detail: str = "") -> None:
        """Raise ``FaultError`` when the seam fires (the raising seams)."""
        if self.fire(seam):
            raise FaultError(seam, detail)

    def pick(self, seam: str, items: Sequence):
        """Deterministic victim choice for a seam that just fired (e.g.
        which in-flight request the ``cancel`` seam kills)."""
        if not items:
            raise ValueError(f"pick({seam!r}): no candidates")
        i = int(self._seam_rng(seam + ".pick").integers(len(items)))
        return items[i]

    # -- accounting -----------------------------------------------------------
    def fired(self, seam: Optional[str] = None):
        """Fire count for one seam, or the per-seam dict (copy)."""
        if seam is not None:
            return self._fired.get(seam, 0)
        return dict(self._fired)

    def opportunities(self, seam: str) -> int:
        return self._opportunities.get(seam, 0)

    def total_fired(self) -> int:
        return sum(self._fired.values())
