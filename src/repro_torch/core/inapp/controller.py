"""The reusable in-app controller (paper §4.4.2).

ACE 'constructs a series of general in-app control operations (e.g., start,
filter, aggregate, and terminate), component monitoring operations, and a
basic control policy. ... The CC controller conducts global coordination
related operations, and the EC controller coordinates components within the
EC. Resource-level services support interactions between CC and EC
controllers.'

Developers inherit :class:`InAppController` and override the policy for
customized optimizations — exactly how the video query's AP is built.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from repro_torch.core.inapp.policies import BasicPolicy


class InAppController:
    """Control-plane component (deployable like any workload component)."""

    def __init__(self, policy: Optional[BasicPolicy] = None,
                 scope: str = "ec"):
        self.policy = policy or BasicPolicy()
        self.scope = scope          # "ec" (local) | "cc" (global)
        self.ctx = None
        self._filters: Dict[str, Callable[[Any], bool]] = {}
        self._aggregates: Dict[str, list] = {}
        self.started = False

    # -- component lifecycle ----------------------------------------------------
    def start(self, ctx) -> None:
        self.ctx = ctx
        self.started = True
        # component monitoring: EIL reports flow in over the local broker
        ctx.subscribe("app/*/eil", self._on_eil)
        ctx.log("controller_started", scope=self.scope)

    def stop(self) -> None:
        self.started = False

    # -- general control operations (paper: start/filter/aggregate/terminate) --
    def op_start(self, component: str, payload=None) -> None:
        self.ctx.publish(f"app/{component}/start", payload or {})

    def op_terminate(self, component: str) -> None:
        self.ctx.publish(f"app/{component}/terminate", {})

    def op_filter(self, stream: str, pred: Callable[[Any], bool]) -> None:
        self._filters[stream] = pred

    def passes(self, stream: str, item) -> bool:
        pred = self._filters.get(stream)
        return True if pred is None else bool(pred(item))

    def op_aggregate(self, stream: str, item) -> list:
        self._aggregates.setdefault(stream, []).append(item)
        return self._aggregates[stream]

    # -- monitoring feedback -----------------------------------------------------
    def _on_eil(self, msg) -> None:
        comp = msg.topic.split("/")[1]
        self.policy.observe_eil(comp, float(msg.payload))

    # -- the decision surface used by workload components -----------------------
    def decide(self, confidence: float):
        return self.policy.classify_decision(confidence)

    def upload_target(self) -> str:
        return self.policy.upload_target()


class ECController(InAppController):
    """Local (per-EC) coordination; forwards summaries to the CC controller
    through the bridged message service."""

    def __init__(self, policy=None):
        super().__init__(policy, scope="ec")

    def report_to_cc(self, kind: str, payload) -> None:
        self.ctx.publish(f"app/cc/{kind}", payload)


class CCController(InAppController):
    """Global coordination: receives EC summaries, may push policy updates."""

    def __init__(self, policy=None):
        super().__init__(policy, scope="cc")

    def start(self, ctx) -> None:
        super().start(ctx)
        ctx.subscribe("app/cc/*", self._on_report)
        self.reports = []

    def _on_report(self, msg) -> None:
        self.reports.append((msg.topic, msg.payload))

    def broadcast_policy(self, update: dict) -> None:
        """Push new thresholds to every EC controller (bridged topic)."""
        self.ctx.publish("app/policy/update", update)
