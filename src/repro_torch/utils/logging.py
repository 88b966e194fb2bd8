"""Minimal structured logging for platform events and benchmarks (a copy
of ``repro.utils.logging``)."""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional


class EventLog:
    """Append-only structured event log (the monitoring substrate)."""

    def __init__(self, name: str = "ace", echo: bool = False):
        self.name = name
        self.echo = echo
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.monotonic()

    def log(self, kind: str, **fields) -> Dict[str, Any]:
        ev = {"t": round(time.monotonic() - self._t0, 6), "kind": kind,
              **fields}
        self.events.append(ev)
        if self.echo:
            print(f"[{self.name}] {kind}: {fields}", file=sys.stderr)
        return ev

    def query(self, kind: Optional[str] = None,
              **match) -> List[Dict[str, Any]]:
        out = []
        for ev in self.events:
            if kind is not None and ev["kind"] != kind:
                continue
            if all(ev.get(k) == v for k, v in match.items()):
                out.append(ev)
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
