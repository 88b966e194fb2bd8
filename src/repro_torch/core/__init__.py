"""ACE platform core — the paper's primary contribution.

Three layers (paper §4): platform layer (controller, orchestrator, API
server, pub/sub, monitoring), resource layer (EC/CC infrastructure, node
agents, resource-level services), application layer (topology-driven
deployment automation, reusable in-app controller, the four ECCI patterns).

The port's copy of ``repro.core``: the platform and the application layer
are pure Python; the models behind the ECCI patterns run on the port's
kernels (``patterns.inference``) and its optimizers.
"""
from repro_torch.core.platform import AcePlatform
from repro_torch.core.topology import Topology, Component
from repro_torch.core.orchestrator import Orchestrator, DeploymentPlan
from repro_torch.core.pubsub import Broker

__all__ = ["AcePlatform", "Topology", "Component", "Orchestrator",
           "DeploymentPlan", "Broker"]
