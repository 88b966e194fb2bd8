"""Platform-layer orchestrator (paper §4.2.1, §4.4.3): binds every component
of a topology to concrete nodes such that resource (cpu/memory/accelerator),
user (edge/cloud placement), and label requirements are all satisfied.

The deployment plan is 'a topology replica modified by the orchestrator'
(Fig. 4): the same structure extended with ``instances``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.api_server import InfraRecord, NodeRecord
from repro_torch.core.topology import Component, Resources, Topology


class PlanningError(Exception):
    pass


@dataclasses.dataclass
class Instance:
    instance_id: str
    component: str
    image: str
    node: str                       # NodeId string
    cluster: str                    # ClusterId string
    resources: Resources
    params: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"instance_id": self.instance_id, "component": self.component,
                "image": self.image, "node": self.node,
                "cluster": self.cluster, "params": self.params}


@dataclasses.dataclass
class DeploymentPlan:
    app: str
    version: int
    instances: Dict[str, List[Instance]]   # component -> instances

    def all_instances(self) -> List[Instance]:
        return [i for insts in self.instances.values() for i in insts]

    def to_dict(self) -> dict:
        return {"app": self.app, "version": self.version,
                "instances": {c: [i.to_dict() for i in insts]
                              for c, insts in self.instances.items()}}


class Orchestrator:
    """Best-fit binder with EC-delegation support (paper §5.1.3: 'ACE can
    delegate node-level orchestration to the EC')."""

    def __init__(self, api):
        self.api = api

    def plan(self, topo: Topology, infra: InfraRecord) -> DeploymentPlan:
        # free capacity is tracked against a scratch copy so a failed plan
        # leaves the infrastructure untouched
        scratch: Dict[str, Resources] = {
            k: n.free() for k, n in infra.nodes.items()}
        plan = DeploymentPlan(topo.app, topo.version, {})
        for name, comp in topo.components.items():
            plan.instances[name] = self._bind(comp, infra, scratch)
        return plan

    # -- binding -------------------------------------------------------------
    def _bind(self, comp: Component, infra: InfraRecord,
              scratch: Dict[str, Resources]) -> List[Instance]:
        targets = self._target_sets(comp, infra)
        instances = []
        for idx, candidates in enumerate(targets):
            node = self._pick(comp, candidates, scratch)
            if node is None:
                raise PlanningError(
                    f"component {comp.name!r}: no node satisfies "
                    f"placement={comp.placement} labels={comp.labels} "
                    f"resources=(cpu={comp.resources.cpu},"
                    f"mem={comp.resources.memory_mb})")
            free = scratch[str(node.node_id)]
            scratch[str(node.node_id)] = Resources(
                cpu=free.cpu - comp.resources.cpu,
                memory_mb=free.memory_mb - comp.resources.memory_mb,
                accelerator=free.accelerator)
            instances.append(Instance(
                instance_id=f"{comp.name}-{idx}", component=comp.name,
                image=comp.image, node=str(node.node_id),
                cluster=str(node.cluster), resources=comp.resources,
                params=dict(comp.params)))
        return instances

    def _target_sets(self, comp: Component,
                     infra: InfraRecord) -> List[List[NodeRecord]]:
        """One candidate set per required replica."""
        ready = [n for n in infra.nodes.values() if n.status == "ready"]
        if comp.placement == "edge":
            ready = [n for n in ready if not n.cluster.is_cloud]
        elif comp.placement == "cloud":
            ready = [n for n in ready if n.cluster.is_cloud]
        if comp.replicas == "one":
            return [ready]
        if comp.replicas == "per_ec":
            return [[n for n in ready if n.cluster == ec]
                    for ec in infra.ecs]
        if comp.replicas == "per_label":
            # one replica on every node carrying all required labels
            labelled = [n for n in ready
                        if set(comp.labels).issubset(set(n.labels))]
            if not labelled:
                raise PlanningError(
                    f"component {comp.name!r}: no node has labels {comp.labels}")
            return [[n] for n in labelled]
        raise PlanningError(f"unknown replicas mode {comp.replicas!r}")

    def _pick(self, comp: Component, candidates: List[NodeRecord],
              scratch: Dict[str, Resources]) -> Optional[NodeRecord]:
        best, best_free = None, None
        for n in candidates:
            if comp.labels and not set(comp.labels).issubset(set(n.labels)):
                continue
            free = scratch[str(n.node_id)]
            if not comp.resources.fits(free):
                continue
            # best fit: most free cpu after allocation (load spreading)
            if best is None or free.cpu > best_free:
                best, best_free = n, free.cpu
        return best
