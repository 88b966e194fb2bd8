"""The ACE platform facade (paper §4.1): user registration, infrastructure
organization, service deployment, application development & deployment.

    ace = AcePlatform()                               # instant mode
    user = ace.register_user("alice")
    infra = ace.register_infrastructure(
        "alice", num_ecs=3, nodes_per_ec=4, cc_nodes=1,
        edge_labels=[["camera"], [], [], []])
    ace.deploy_services(infra)                        # message/file services
    app = ace.submit_app("alice", infra, topology)
    plan = ace.deploy_app("alice", topology.app)

For the Fig. 5 experiment the platform runs on a :class:`SimClock` with a
:class:`NetworkModel` so transmissions and queues occupy simulated time.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import patterns as _patterns  # noqa: F401 (images)
from repro_torch.core.agent import NodeAgent
from repro_torch.core.api_server import ApiServer, AppRecord, InfraRecord
from repro_torch.core.controller import Controller
from repro_torch.core.monitoring import MonitoringService
from repro_torch.core.network import NetworkModel
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.pubsub import MessageService
from repro_torch.core.services.file_service import FileService
from repro_torch.core.services.object_store import ObjectStore
from repro_torch.core.sim import InstantClock, SimClock
from repro_torch.core.topology import Resources, Topology


class AcePlatform:
    def __init__(self, clock: Optional[SimClock] = None,
                 network_factory=None):
        """``network_factory(clock) -> NetworkModel`` enables the validation
        testbed; None means instant (zero-latency) links."""
        self.clock = clock or InstantClock()
        self.network_factory = network_factory
        self.api = ApiServer()
        self.monitor = MonitoringService()
        self.orchestrator = Orchestrator(self.api)
        # per-infrastructure runtime state
        self._msg: Dict[str, MessageService] = {}
        self._net: Dict[str, Optional[NetworkModel]] = {}
        self._agents: Dict[str, Dict[str, NodeAgent]] = {}
        self._controllers: Dict[str, Controller] = {}
        self._services: Dict[str, dict] = {}

    # -- phase 1: user registration (paper §4.1) -------------------------------
    def register_user(self, name: str) -> dict:
        return self.api.register_user(name)

    def register_infrastructure(
            self, user: str, *, num_ecs: int, nodes_per_ec: int,
            cc_nodes: int = 1,
            edge_labels: Optional[List[List[str]]] = None,
            edge_capacity: Optional[Resources] = None,
            cloud_capacity: Optional[Resources] = None) -> InfraRecord:
        """Organize the user's nodes into ECs + one CC (paper §4.3.1)."""
        infra = self.api.register_infra(user)
        cc = self.api.register_cluster(infra, "cc")
        for _ in range(cc_nodes):
            self.api.register_node(
                infra, cc, labels=["gpu"],
                capacity=cloud_capacity or Resources(
                    cpu=32.0, memory_mb=131072, accelerator=True))
        for _ in range(num_ecs):
            ec = self.api.register_cluster(infra, "ec")
            for j in range(nodes_per_ec):
                labels = (edge_labels[j] if edge_labels and j < len(edge_labels)
                          else [])
                self.api.register_node(
                    infra, ec, labels=labels,
                    capacity=edge_capacity or Resources(cpu=4.0,
                                                        memory_mb=4096))
        self.monitor.log("infra_registered", infra=str(infra.infra_id),
                         ecs=num_ecs, nodes=len(infra.nodes))
        return infra

    # -- resource-level services ------------------------------------------------
    def deploy_services(self, infra: InfraRecord,
                        bridged_topics: Optional[List[str]] = None) -> dict:
        iid = str(infra.infra_id)
        network = (self.network_factory(self.clock)
                   if self.network_factory else None)
        msg = MessageService(infra.clusters, self.clock, network,
                             bridged_topics)
        store = ObjectStore()
        files = FileService(msg, store, network, self.clock, infra.cc)
        services = {"message": msg, "object_store": store, "file": files,
                    "monitor": self.monitor}
        self._msg[iid] = msg
        self._net[iid] = network
        self._services[iid] = services
        # node agents come up with the services in reach
        agents = {}
        for key, node in infra.nodes.items():
            agents[key] = NodeAgent(node, self.clock, msg, self.monitor,
                                    services)
        self._agents[iid] = agents
        self._controllers[iid] = Controller(self.api, msg, self.orchestrator,
                                            self.monitor)
        self.monitor.log("services_deployed", infra=iid)
        return services

    # -- phase 2/3: application development & deployment ------------------------
    def submit_app(self, user: str, infra: InfraRecord,
                   topo: Topology) -> AppRecord:
        return self.api.submit_app(user, str(infra.infra_id), topo)

    def deploy_app(self, user: str, app_name: str):
        rec = self.api.get_app(user, app_name)
        infra = self.api.infras[str(rec.infra_id)]
        controller = self._controllers[str(rec.infra_id)]
        return controller.deploy(rec, infra)

    def remove_app(self, user: str, app_name: str) -> None:
        rec = self.api.get_app(user, app_name)
        infra = self.api.infras[str(rec.infra_id)]
        self._controllers[str(rec.infra_id)].remove(rec, infra)

    def update_app(self, user: str, app_name: str, new_topo: Topology,
                   incremental: bool = False):
        rec = self.api.get_app(user, app_name)
        infra = self.api.infras[str(rec.infra_id)]
        ctl = self._controllers[str(rec.infra_id)]
        if incremental:
            return ctl.incremental_update(rec, infra, new_topo)
        return ctl.thorough_update(rec, infra, new_topo)

    # -- runtime access -----------------------------------------------------------
    def agents(self, infra: InfraRecord) -> Dict[str, NodeAgent]:
        return self._agents[str(infra.infra_id)]

    def message_service(self, infra: InfraRecord) -> MessageService:
        return self._msg[str(infra.infra_id)]

    def network(self, infra: InfraRecord) -> Optional[NetworkModel]:
        return self._net[str(infra.infra_id)]

    def services(self, infra: InfraRecord) -> dict:
        return self._services[str(infra.infra_id)]

    def instances(self, infra: InfraRecord, component: str) -> list:
        """All live instances of a component across agents."""
        out = []
        for agent in self._agents[str(infra.infra_id)].values():
            for iid, (comp, ctx, _res) in agent.instances.items():
                if iid.startswith(component + "-"):
                    out.append((iid, comp, ctx))
        return out

    def run(self, until: Optional[float] = None) -> int:
        return self.clock.run(until)
