"""Platform-layer controller (paper §4.2.1, Fig. 4 step ②): transforms the
orchestrator's deployment plan into per-node deployment instructions
(the docker-compose analog) and distributes them to node agents through the
Pub/Sub service. Also executes thorough and incremental updates (§4.4.3) and
shields failed nodes.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.api_server import ApiServer, AppRecord, InfraRecord
from repro_torch.core.orchestrator import (DeploymentPlan, Instance,
                                          Orchestrator)
from repro_torch.core.pubsub import MessageService
from repro_torch.core.topology import Topology
from repro_torch.utils.logging import EventLog


class Controller:
    def __init__(self, api: ApiServer, msg: MessageService,
                 orchestrator: Orchestrator, monitor: EventLog):
        self.api = api
        self.msg = msg
        self.orchestrator = orchestrator
        self.monitor = monitor

    # -- deployment (Fig. 4) --------------------------------------------------
    def deploy(self, app: AppRecord, infra: InfraRecord) -> DeploymentPlan:
        plan = self.orchestrator.plan(app.topology, infra)
        app.plan = plan
        app.status = "planned"
        # deploy in dependency order: a component's 'connections' (the
        # components it talks to) come up before it does, so no message from
        # a fresh component is lost on a not-yet-subscribed peer
        for name in self._dependency_order(app.topology):
            for inst in plan.instances.get(name, []):
                self._send_deploy(infra, inst)
        app.status = "deployed"
        self.monitor.log("app_deployed", app=app.app,
                         instances=len(plan.all_instances()))
        return plan

    @staticmethod
    def _dependency_order(topo: Topology) -> List[str]:
        """Topological order with dependencies (connections) first."""
        order: List[str] = []
        seen: set = set()

        def visit(name: str, stack: tuple) -> None:
            if name in seen or name in stack:
                return          # already placed, or a cycle -> stable order
            for dep in topo.components[name].connections:
                visit(dep, stack + (name,))
            seen.add(name)
            order.append(name)

        for name in topo.components:
            visit(name, ())
        return order

    def remove(self, app: AppRecord, infra: InfraRecord) -> None:
        if app.plan is None:
            return
        for inst in app.plan.all_instances():
            self._send_remove(infra, inst)
        app.status = "removed"
        self.monitor.log("app_removed", app=app.app)

    # -- updates (paper §4.4.3) -----------------------------------------------
    def thorough_update(self, app: AppRecord, infra: InfraRecord,
                        new_topo: Topology) -> DeploymentPlan:
        """Delete the previous application and repeat the entire deployment."""
        self.remove(app, infra)
        app.topology = new_topo
        return self.deploy(app, infra)

    def incremental_update(self, app: AppRecord, infra: InfraRecord,
                           new_topo: Topology) -> DeploymentPlan:
        """Deploy only updated components according to the new topology."""
        assert app.plan is not None
        diff = app.topology.diff(new_topo)
        old_plan = app.plan
        for name in diff["removed"] + diff["changed"]:
            for inst in old_plan.instances.get(name, []):
                self._send_remove(infra, inst)
        partial = Topology(
            app=new_topo.app, version=new_topo.version,
            components={n: c for n, c in new_topo.components.items()
                        if n in diff["added"] + diff["changed"]})
        new_part = self.orchestrator.plan(partial, infra) if \
            partial.components else DeploymentPlan(new_topo.app,
                                                   new_topo.version, {})
        for inst in new_part.all_instances():
            self._send_deploy(infra, inst)
        merged: Dict[str, List[Instance]] = {
            n: insts for n, insts in old_plan.instances.items()
            if n not in diff["removed"] + diff["changed"]}
        merged.update(new_part.instances)
        app.plan = DeploymentPlan(new_topo.app, new_topo.version, merged)
        app.topology = new_topo
        self.monitor.log("app_updated", app=app.app, **{
            k: len(v) for k, v in diff.items()})
        return app.plan

    # -- node failure ---------------------------------------------------------
    def shield_node(self, infra: InfraRecord, node_id: str) -> None:
        self.api.shield_node(infra, node_id)
        self.monitor.log("node_shielded", node=node_id)

    # -- wire format ----------------------------------------------------------
    def _send_deploy(self, infra: InfraRecord, inst: Instance) -> None:
        node = infra.nodes[inst.node]
        broker = self.msg.broker(node.cluster)
        broker.publish(f"ace/deploy/{inst.node}", {
            "instance_id": inst.instance_id, "image": inst.image,
            "params": inst.params, "resources": inst.resources,
        }, nbytes=1024, src="ace-controller")

    def _send_remove(self, infra: InfraRecord, inst: Instance) -> None:
        node = infra.nodes[inst.node]
        broker = self.msg.broker(node.cluster)
        broker.publish(f"ace/remove/{inst.node}",
                       {"instance_id": inst.instance_id},
                       nbytes=256, src="ace-controller")
