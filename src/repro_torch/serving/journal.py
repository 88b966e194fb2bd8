"""Write-ahead request journal: the gateway's durability log.

An engine snapshot (``ServingEngine.snapshot``) captures requests the
*engine* owns at one instant. A crash between a client's acknowledged
``submit`` and the next snapshot would silently lose the request — the
client holds a handle for work no recovered engine knows about. The
journal closes that window: the gateway appends a ``submit`` record
*before* acknowledging, a ``first_token`` record when the stream starts,
and a ``terminal`` record at resolution. On restart, ``replay`` walks
the log and re-queues every acknowledged-but-unfinished request the
snapshot missed (under its original id, so handles and terminal records
still line up), refusing duplicate ids along the way.

Format: JSON lines, one record per line, append-only. A torn final line
(crash mid-write) is skipped at replay — everything before it is intact
because records are written with a single ``write`` + flush. Compaction
(``compact``) drops records fully covered by a newer snapshot via an
atomic rewrite, bounding log growth; the gateway runs it right after
each periodic snapshot.

A copy of ``repro.serving.journal`` (numpy only): the same record format,
so a journal written by one package replays into the other's engine.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Iterator, Optional, Set

import numpy as np


class RequestJournal:
    """Append-only JSON-lines journal keyed by request id.

    ``fsync=True`` makes every append durable against host power loss;
    the default (flush only) survives process crashes — the failure mode
    the serving stack's chaos tests model — without paying a disk sync
    per request.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._seen: Set[int] = set()     # rids with a submit record
        self._terminal: Set[int] = set()
        for rec in self._scan():
            if rec.get("kind") == "submit":
                self._seen.add(int(rec["rid"]))
            elif rec.get("kind") == "terminal":
                self._terminal.add(int(rec["rid"]))
        self._f = open(path, "a", encoding="utf-8")
        # counters (surfaced through ServingGateway.stats())
        self.appended = 0
        self.duplicates_refused = 0
        self.compactions = 0
        self.replayed = 0

    # -- append side ----------------------------------------------------------
    def _append(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.appended += 1

    def record_submit(self, r) -> bool:
        """Journal one acknowledged submission *before* the ack. Returns
        False — and writes nothing — when the id is already journaled
        (a duplicate submission must be refused, not double-served)."""
        rid = int(r.request_id)
        if rid in self._seen:
            self.duplicates_refused += 1
            return False
        self._seen.add(rid)
        self._append({
            "kind": "submit", "rid": rid, "t": time.time(),
            "prompt": np.asarray(r.prompt, np.int32).tolist(),
            "max_new_tokens": int(r.max_new_tokens),
            "temperature": float(r.temperature),
            "priority": int(r.priority),
            "deadline_s": r.deadline_s})
        return True

    def record_first_token(self, rid: int) -> None:
        self._append({"kind": "first_token", "rid": int(rid),
                      "t": time.time()})

    def record_terminal(self, rid: int, status: str,
                        reason: Optional[str] = None) -> None:
        rid = int(rid)
        self._terminal.add(rid)
        self._append({"kind": "terminal", "rid": rid, "t": time.time(),
                      "status": status, "reason": reason})

    def seen(self, rid: int) -> bool:
        return int(rid) in self._seen

    # -- recovery side --------------------------------------------------------
    def _scan(self) -> Iterator[dict]:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    # torn tail from a crash mid-append: everything after
                    # it is unreadable by construction — stop here
                    return

    def unfinished(self) -> Dict[int, dict]:
        """Submit records with no terminal record, submission order."""
        subs: Dict[int, dict] = {}
        terminal: Set[int] = set()
        for rec in self._scan():
            kind = rec.get("kind")
            if kind == "submit":
                subs.setdefault(int(rec["rid"]), rec)
            elif kind == "terminal":
                terminal.add(int(rec["rid"]))
        return {rid: rec for rid, rec in subs.items()
                if rid not in terminal}

    def replay(self, engine) -> Dict[str, int]:
        """Re-queue every journaled-but-unfinished request the recovered
        ``engine`` cannot account for (``known_request_ids`` — i.e. the
        snapshot predates the submit, or there was no snapshot at all).
        Requests the snapshot *does* cover are left alone: their resume
        checkpoints are strictly better than a from-scratch re-queue.
        Duplicate submit records for one id count once."""
        counts = {"replayed": 0, "covered": 0, "duplicates": 0}
        seen_here: Set[int] = set()
        known = engine.known_request_ids()
        for rid, rec in sorted(self.unfinished().items()):
            if rid in seen_here:
                counts["duplicates"] += 1
                continue
            seen_here.add(rid)
            if rid in known:
                counts["covered"] += 1
                continue
            engine.requeue_lost(
                rid, np.asarray(rec["prompt"], np.int32),
                max_new_tokens=rec["max_new_tokens"],
                temperature=rec["temperature"],
                priority=rec["priority"],
                deadline_s=rec["deadline_s"])
            counts["replayed"] += 1
        self.replayed += counts["replayed"]
        return counts

    # -- maintenance ----------------------------------------------------------
    def compact(self, covered_rids) -> Dict[str, int]:
        """Atomically drop records for ids a just-written snapshot fully
        covers (live *or* terminal there): replay would route them through
        the snapshot anyway, so the log only needs the ids submitted after
        it. Keeps the journal O(snapshot interval), not O(uptime)."""
        covered = {int(x) for x in covered_rids}
        kept = dropped = 0
        self._f.close()
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as out:
            for rec in self._scan():
                if int(rec.get("rid", -1)) in covered:
                    dropped += 1
                    continue
                out.write(json.dumps(rec) + "\n")
                kept += 1
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        self.compactions += 1
        return {"kept": kept, "dropped": dropped}

    def stats(self) -> Dict[str, int]:
        return {"appended": self.appended,
                "duplicates_refused": self.duplicates_refused,
                "compactions": self.compactions,
                "replayed": self.replayed}

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
