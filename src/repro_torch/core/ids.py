"""Hierarchical IDs (paper §4.3.1).

ACE assigns a unique infrastructure ID per user, a second-layer ID per EC /
CC affiliated to it, and a third-layer ID per node affiliated to its
cluster:  ``infra-3 / infra-3.ec-1 / infra-3.ec-1.n-2``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InfraId:
    num: int

    def __str__(self):
        return f"infra-{self.num}"


@dataclasses.dataclass(frozen=True)
class ClusterId:
    infra: InfraId
    kind: str        # "ec" | "cc"
    num: int

    def __str__(self):
        return f"{self.infra}.{self.kind}-{self.num}"

    @property
    def is_cloud(self) -> bool:
        return self.kind == "cc"


@dataclasses.dataclass(frozen=True)
class NodeId:
    cluster: ClusterId
    num: int

    def __str__(self):
        return f"{self.cluster}.n-{self.num}"


class IdAllocator:
    """Monotonic allocator for the three ID layers."""

    def __init__(self):
        self._infra = itertools.count(1)
        self._clusters = {}
        self._nodes = {}

    def new_infra(self) -> InfraId:
        return InfraId(next(self._infra))

    def new_cluster(self, infra: InfraId, kind: str) -> ClusterId:
        assert kind in ("ec", "cc")
        key = (infra, kind)
        self._clusters.setdefault(key, itertools.count(1))
        return ClusterId(infra, kind, next(self._clusters[key]))

    def new_node(self, cluster: ClusterId) -> NodeId:
        self._nodes.setdefault(cluster, itertools.count(1))
        return NodeId(cluster, next(self._nodes[cluster]))


def parse_node_id(s: str) -> Optional[dict]:
    """'infra-1.ec-2.n-3' -> {'infra': 1, 'kind': 'ec', 'cluster': 2, 'node': 3}."""
    parts = s.split(".")
    if len(parts) != 3:
        return None
    try:
        infra = int(parts[0].split("-")[1])
        kind, cnum = parts[1].split("-")
        node = int(parts[2].split("-")[1])
        return {"infra": infra, "kind": kind, "cluster": int(cnum),
                "node": node}
    except (IndexError, ValueError):
        return None
