"""Node agents (paper §4.3.1): deployed on every node, they inform ACE of
node status, execute deployment instructions from the platform controller,
and collect application status for the monitoring service.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core import registry
from repro_torch.core.api_server import NodeRecord
from repro_torch.core.ids import ClusterId, NodeId
from repro_torch.core.pubsub import Broker, MessageService
from repro_torch.core.sim import SimClock
from repro_torch.utils.logging import EventLog


@dataclasses.dataclass
class Context:
    """Everything a deployed component may touch at runtime."""
    node: NodeRecord
    clock: SimClock
    broker: Broker                   # the node's *local* cluster broker
    services: Dict[str, Any]         # resource-level services by name
    monitor: EventLog
    params: Dict[str, Any]
    instance_id: str = ""

    @property
    def cluster(self) -> ClusterId:
        return self.node.cluster

    def publish(self, topic: str, payload, nbytes: int = 256) -> None:
        self.broker.publish(topic, payload, nbytes=nbytes,
                            src=self.instance_id)

    def subscribe(self, pattern: str, fn) -> None:
        self.broker.subscribe(pattern, fn)

    def log(self, kind: str, **fields) -> None:
        self.monitor.log(kind, instance=self.instance_id,
                         node=str(self.node.node_id), **fields)


class NodeAgent:
    """Executes deploy/remove instructions (the docker-compose analog of
    paper Fig. 4 step ②) and reports node/app status."""

    def __init__(self, node: NodeRecord, clock: SimClock,
                 msg: MessageService, monitor: EventLog,
                 services: Optional[Dict[str, Any]] = None):
        self.node = node
        self.clock = clock
        self.msg = msg
        self.monitor = monitor
        self.services = services or {}
        self.instances: Dict[str, Any] = {}
        # the agent listens for controller instructions on its own topic
        self.broker = msg.broker(node.cluster)
        self.broker.subscribe(f"ace/deploy/{node.node_id}", self._on_deploy)
        self.broker.subscribe(f"ace/remove/{node.node_id}", self._on_remove)

    # -- instruction handlers -------------------------------------------------
    def _on_deploy(self, msg) -> None:
        inst = msg.payload
        self.deploy(inst["instance_id"], inst["image"], inst["params"],
                    inst.get("resources"))

    def _on_remove(self, msg) -> None:
        self.remove(msg.payload["instance_id"])

    # -- direct API (used by controller in instant mode) ---------------------
    def deploy(self, instance_id: str, image: str, params: dict,
               resources=None) -> Any:
        comp = registry.instantiate(image, params.get("init", {}))
        ctx = Context(node=self.node, clock=self.clock, broker=self.broker,
                      services=self.services, monitor=self.monitor,
                      params=params, instance_id=instance_id)
        if resources is not None:
            self.node.allocate(resources)
        comp_ctx = (comp, ctx, resources)
        self.instances[instance_id] = comp_ctx
        comp.start(ctx)
        self.monitor.log("deployed", instance=instance_id, image=image,
                         node=str(self.node.node_id))
        return comp

    def remove(self, instance_id: str) -> None:
        comp, _, resources = self.instances.pop(instance_id)
        if hasattr(comp, "stop"):
            comp.stop()
        if resources is not None:
            self.node.release(resources)
        self.monitor.log("removed", instance=instance_id,
                         node=str(self.node.node_id))

    def status(self) -> dict:
        return {"node": str(self.node.node_id),
                "instances": sorted(self.instances),
                "cpu_allocated": self.node.allocated.cpu,
                "mem_allocated": self.node.allocated.memory_mb}
