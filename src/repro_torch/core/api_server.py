"""Platform-layer API server (paper §4.2.1): uniform APIs for querying and
manipulating ACE entities (users, infrastructures, clusters, nodes,
applications, deployments) used by the other platform-manager components.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core.ids import ClusterId, IdAllocator, InfraId, NodeId
from repro_torch.core.topology import Resources, Topology


@dataclasses.dataclass
class NodeRecord:
    node_id: NodeId
    labels: List[str]
    capacity: Resources
    allocated: Resources = dataclasses.field(
        default_factory=lambda: Resources(cpu=0.0, memory_mb=0))
    status: str = "ready"        # ready | failed | shielded

    @property
    def cluster(self) -> ClusterId:
        return self.node_id.cluster

    def free(self) -> Resources:
        return Resources(
            cpu=self.capacity.cpu - self.allocated.cpu,
            memory_mb=self.capacity.memory_mb - self.allocated.memory_mb,
            accelerator=self.capacity.accelerator)

    def allocate(self, req: Resources) -> None:
        self.allocated = Resources(
            cpu=self.allocated.cpu + req.cpu,
            memory_mb=self.allocated.memory_mb + req.memory_mb,
            accelerator=self.allocated.accelerator)

    def release(self, req: Resources) -> None:
        self.allocated = Resources(
            cpu=max(0.0, self.allocated.cpu - req.cpu),
            memory_mb=max(0, self.allocated.memory_mb - req.memory_mb),
            accelerator=self.allocated.accelerator)


@dataclasses.dataclass
class InfraRecord:
    infra_id: InfraId
    user: str
    clusters: List[ClusterId] = dataclasses.field(default_factory=list)
    nodes: Dict[str, NodeRecord] = dataclasses.field(default_factory=dict)

    @property
    def cc(self) -> ClusterId:
        return next(c for c in self.clusters if c.is_cloud)

    @property
    def ecs(self) -> List[ClusterId]:
        return [c for c in self.clusters if not c.is_cloud]

    def nodes_in(self, cluster: ClusterId) -> List[NodeRecord]:
        return [n for n in self.nodes.values() if n.cluster == cluster]


@dataclasses.dataclass
class AppRecord:
    app: str
    user: str
    infra_id: InfraId
    topology: Topology
    status: str = "submitted"    # submitted | planned | deployed | removed
    plan: Optional[Any] = None   # DeploymentPlan


class ApiServer:
    """In-memory entity store with a uniform query/manipulate API."""

    def __init__(self):
        self.ids = IdAllocator()
        self.users: Dict[str, dict] = {}
        self.infras: Dict[str, InfraRecord] = {}
        self.apps: Dict[str, AppRecord] = {}

    # -- users ----------------------------------------------------------------
    def register_user(self, name: str) -> dict:
        if name in self.users:
            raise ValueError(f"user {name!r} already registered")
        self.users[name] = {"name": name, "infras": [], "apps": []}
        return self.users[name]

    def delete_user(self, name: str) -> None:
        user = self.users.pop(name)
        for iid in user["infras"]:
            self.infras.pop(iid, None)
        for app in user["apps"]:
            self.apps.pop(app, None)

    # -- infrastructure ---------------------------------------------------------
    def register_infra(self, user: str) -> InfraRecord:
        assert user in self.users, f"unknown user {user!r}"
        infra = InfraRecord(self.ids.new_infra(), user)
        self.infras[str(infra.infra_id)] = infra
        self.users[user]["infras"].append(str(infra.infra_id))
        return infra

    def register_cluster(self, infra: InfraRecord, kind: str) -> ClusterId:
        cid = self.ids.new_cluster(infra.infra_id, kind)
        if kind == "cc" and any(c.is_cloud for c in infra.clusters):
            raise ValueError("an infrastructure has exactly one CC")
        infra.clusters.append(cid)
        return cid

    def register_node(self, infra: InfraRecord, cluster: ClusterId,
                      labels: Optional[List[str]] = None,
                      capacity: Optional[Resources] = None) -> NodeRecord:
        nid = self.ids.new_node(cluster)
        rec = NodeRecord(nid, labels or [],
                         capacity or Resources(cpu=4.0, memory_mb=4096))
        infra.nodes[str(nid)] = rec
        return rec

    def shield_node(self, infra: InfraRecord, node_id: str) -> None:
        """Controller shields failed nodes (paper §4.2.1)."""
        infra.nodes[node_id].status = "shielded"

    # -- applications -------------------------------------------------------
    def submit_app(self, user: str, infra_id: str, topo: Topology) -> AppRecord:
        key = f"{user}/{topo.app}"
        rec = AppRecord(topo.app, user, self.infras[infra_id].infra_id, topo)
        self.apps[key] = rec
        self.users[user]["apps"].append(key)
        return rec

    def get_app(self, user: str, app: str) -> AppRecord:
        return self.apps[f"{user}/{app}"]

    def remove_app(self, user: str, app: str) -> None:
        rec = self.apps[f"{user}/{app}"]
        rec.status = "removed"

    # -- queries --------------------------------------------------------------
    def query_nodes(self, infra: InfraRecord, *, placement: str = "any",
                    labels: Optional[List[str]] = None,
                    min_free: Optional[Resources] = None) -> List[NodeRecord]:
        out = []
        for n in infra.nodes.values():
            if n.status != "ready":
                continue
            if placement == "edge" and n.cluster.is_cloud:
                continue
            if placement == "cloud" and not n.cluster.is_cloud:
                continue
            if labels and not set(labels).issubset(set(n.labels)):
                continue
            if min_free and not min_free.fits(n.free()):
                continue
            out.append(n)
        return out
