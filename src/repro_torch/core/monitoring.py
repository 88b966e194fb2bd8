"""Monitoring service (paper §4.2.1): collects status, performance metrics,
and runtime logs of ACE, user nodes and applications; queried by users and by
in-app controllers (the AP policy reads EIL estimates from here).

A copy of ``repro.core.monitoring`` over the port's own ``EventLog``; it
ingests the port's ``ServingEngine.metrics()`` and
``CascadeServingEngine.engine_metrics()``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from repro_torch.utils.logging import EventLog


class MonitoringService(EventLog):
    def __init__(self):
        super().__init__(name="ace-monitor")

    # -- metric helpers --------------------------------------------------------
    def record_latency(self, component: str, latency_s: float, **fields):
        self.log("latency", component=component, latency_s=latency_s, **fields)

    def latency_stats(self, component: str,
                      since: float = 0.0) -> Optional[dict]:
        vals = [e["latency_s"] for e in self.query("latency", component=component)
                if e["t"] >= since]
        if not vals:
            return None
        return {"n": len(vals), "mean": statistics.fmean(vals),
                "p50": statistics.median(vals), "max": max(vals)}

    def counters(self, kind: str) -> int:
        return len(self.query(kind))

    # -- serving-engine snapshots ---------------------------------------------
    def record_serving(self, component: str, snapshot: Dict) -> None:
        """Ingest a ``ServingEngine.metrics()`` (or
        ``CascadeServingEngine.engine_metrics()``) snapshot for
        ``component`` — the serving stack's health feed (terminal request
        dispositions, fault/retry accounting, breaker state)."""
        self.log("serving_metrics", component=component, snapshot=snapshot)

    def serving_snapshot(self, component: str) -> Optional[Dict]:
        """Latest serving snapshot recorded for ``component``."""
        evs = self.query("serving_metrics", component=component)
        return evs[-1]["snapshot"] if evs else None

    def feed_deadline_admission(self, component: str, scheduler) -> bool:
        """Close the admission loop: push the latest *measured*
        per-class deadline-hit table back into the scheduler's admission
        estimator (``Scheduler.absorb_deadline_hits``), where it widens
        the feasibility safety margin for classes that are missing in
        practice. Call after ``record_serving``; after a crash-restart,
        call it again once the recovered engine has fresh observations —
        ``restore()`` resets the estimator (pre-crash rates describe a
        dead process), so the margin re-learns from the monitor's feed.
        Returns False when no snapshot exists yet for ``component``."""
        table = self.deadline_hit_rates(component)
        if not table:
            return False
        scheduler.absorb_deadline_hits(table)
        return True

    # -- durability events ----------------------------------------------------
    def record_restart(self, component: str, info: Dict) -> None:
        """One supervised crash-restart: ``info`` is what
        ``serving.recover_engine`` returned (snapshot counts + journal
        replay counts)."""
        self.log("restart", component=component, info=info)

    def record_hang(self, component: str, detail: str = "") -> None:
        """One watchdog-detected hang (timeout fired, whether the step
        later completed or the engine was declared wedged)."""
        self.log("hang", component=component, detail=detail)

    def record_journal(self, component: str, counts: Dict) -> None:
        """A journal replay's outcome (``RequestJournal.replay``)."""
        self.log("journal_replay", component=component, counts=counts)

    def durability_counters(self) -> Dict[str, int]:
        """Fleet-wide durability tallies for dashboards/tests."""
        return {"restarts": self.counters("restart"),
                "hangs": self.counters("hang"),
                "journal_replays": self.counters("journal_replay")}

    def deadline_hit_rates(self, component: str) -> Optional[Dict]:
        """Per-class deadline-hit rates from the latest serving snapshot:
        ``{priority: {"hits", "total", "rate"}}`` — the feedback signal
        closing the loop on deadline-feasibility admission (does the
        estimator's 'feasible' actually finish in time?). For cascade
        snapshots the inner engines' tables are merged."""
        snap = self.serving_snapshot(component)
        if snap is None:
            return None
        if "deadline_hits" in snap:
            return snap["deadline_hits"]
        merged: Dict = {}
        for side in ("edge", "cloud"):
            for p, row in snap.get(side, {}).get("deadline_hits",
                                                 {}).items():
                m = merged.setdefault(p, {"hits": 0, "total": 0})
                m["hits"] += row["hits"]
                m["total"] += row["total"]
        for m in merged.values():
            m["rate"] = m["hits"] / m["total"] if m["total"] else 0.0
        return merged or None

    def speculative_acceptance(self, component: str) -> Optional[Dict]:
        """Per-class speculative acceptance from the latest serving
        snapshot: ``{priority: {"drafted", "accepted", "rate"}}`` — how
        well the draft model is earning its FLOPs per SLO class. For
        cascade snapshots the inner engines' tables are merged (in
        practice only the cloud engine drafts, but the merge keeps the
        accessor shape-agnostic like ``deadline_hit_rates``)."""
        snap = self.serving_snapshot(component)
        if snap is None:
            return None
        if "speculative" in snap:
            return snap["speculative"].get("per_class", {})
        merged: Dict = {}
        for side in ("edge", "cloud"):
            table = snap.get(side, {}).get("speculative", {})
            for p, row in table.get("per_class", {}).items():
                m = merged.setdefault(p, {"drafted": 0, "accepted": 0})
                m["drafted"] += row["drafted"]
                m["accepted"] += row["accepted"]
        for m in merged.values():
            m["rate"] = (m["accepted"] / m["drafted"]
                         if m["drafted"] else 0.0)
        return merged or None

    def component_status(self) -> Dict[str, str]:
        status: Dict[str, str] = {}
        for ev in self.events:
            if ev["kind"] == "deployed":
                status[ev["instance"]] = "running"
            elif ev["kind"] == "removed":
                status[ev["instance"]] = "removed"
        return status
