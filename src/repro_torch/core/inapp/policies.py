"""In-app control policies for the cascade (paper §5.1.2).

Basic Policy (BP): pure confidence thresholds —
  conf >= accept_threshold  -> identified at the edge (metadata to RS)
  conf <  drop_threshold    -> dropped
  otherwise                 -> escalated to COC on the CC.

Advanced Policy (AP), inheriting BP (the paper's customization mechanism):
  * collects and EWMA-estimates the E2E inference latencies (EIL) of EOC and
    COC from monitoring reports;
  * load-balances OD crop uploads toward the lower-EIL classifier
    ('always sent to the one with a lower estimated EIL');
  * shrinks the confidence band when either EIL deteriorates, reducing
    EOC->COC escalations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Decision:
    route: str                 # "accept" | "drop" | "escalate"
    target: str = "eoc"        # initial upload target: "eoc" | "coc"


class BasicPolicy:
    def __init__(self, accept_threshold: float = 0.8,
                 drop_threshold: float = 0.1):
        self.accept0 = accept_threshold
        self.drop0 = drop_threshold
        self.accept = accept_threshold
        self.drop = drop_threshold

    # -- crop scheduling at the edge classifier --------------------------------
    def classify_decision(self, confidence: float) -> Decision:
        if confidence >= self.accept:
            return Decision("accept")
        if confidence < self.drop:
            return Decision("drop")
        return Decision("escalate")

    # -- OD upload target (BP always uses the edge classifier) -----------------
    def upload_target(self, now: float = 0.0) -> str:
        return "eoc"

    def observe_eil(self, component: str, eil_s: float,
                    now: float = 0.0) -> None:
        pass  # BP is static


class AdvancedPolicy(BasicPolicy):
    def __init__(self, accept_threshold: float = 0.8,
                 drop_threshold: float = 0.1, *, ewma: float = 0.2,
                 deteriorate_s: float = 0.3, shrink: float = 0.25,
                 recover: float = 0.05, stale_tau_s: float = 3.0):
        super().__init__(accept_threshold, drop_threshold)
        self.ewma = ewma
        self.deteriorate_s = deteriorate_s
        self.shrink = shrink
        self.recover = recover
        self.stale_tau_s = stale_tau_s
        self.eil: dict = {"eoc": None, "coc": None}
        self.last_obs: dict = {"eoc": 0.0, "coc": 0.0}
        self.adapt_interval_s = 1.0
        self._last_adapt = -1e9

    def observe_eil(self, component: str, eil_s: float,
                    now: float = 0.0) -> None:
        prev = self.eil.get(component)
        self.eil[component] = (eil_s if prev is None
                               else (1 - self.ewma) * prev + self.ewma * eil_s)
        self.last_obs[component] = now
        # rate-limit threshold adaptation: one step per adapt interval,
        # otherwise per-crop observations compound the shrink within ms
        if now - self._last_adapt >= self.adapt_interval_s:
            self._last_adapt = now
            self._adapt()

    def _estimate(self, component: str, now: float = 0.0) -> float:
        """EWMA estimate, decayed when stale — an unobserved classifier is
        re-probed rather than starved forever."""
        v = self.eil.get(component)
        if v is None:
            return 0.0
        import math
        age = max(0.0, now - self.last_obs.get(component, 0.0))
        return v * math.exp(-age / self.stale_tau_s)

    def upload_target(self, now: float = 0.0) -> str:
        """Load balancing (paper: 'always sent to the one with a lower
        estimated EIL')."""
        return ("eoc" if self._estimate("eoc", now) <=
                self._estimate("coc", now) else "coc")

    def _adapt(self) -> None:
        """Shrink the (drop, accept) band when either EIL deteriorates —
        fewer EOC->COC escalations; relax back toward BP when healthy."""
        worst = max(self._estimate("eoc"), self._estimate("coc"))
        if worst > self.deteriorate_s:
            band = self.accept - self.drop
            self.accept = max(0.5, self.accept - self.shrink * band)
            self.drop = min(0.45, self.drop + self.shrink * band)
        else:
            self.accept = min(self.accept0, self.accept + self.recover)
            self.drop = max(self.drop0, self.drop - self.recover)
