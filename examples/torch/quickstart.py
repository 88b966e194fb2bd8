"""ACE quickstart on the PyTorch port (paper §4.1's three phases).

1. register a user + an ECC infrastructure (2 ECs + 1 CC),
2. develop an application as components with a topology file,
3. deploy through the orchestrator and watch it run.

The port of ``examples/quickstart.py``; it prints the same lines. The
platform is a host simulation, so nothing runs on the card, but ``--device``
is checked as every example's is.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch import resolve_device
from repro_torch.core.platform import AcePlatform
from repro_torch.core.registry import image
from repro_torch.core.topology import Component, Resources, Topology


# -- a tiny application: edge sensors -> cloud aggregator --------------------

@image("quickstart/sensor")
class Sensor:
    def __init__(self, n: int = 5):
        self.n = n

    def start(self, ctx):
        for i in range(self.n):
            # publish on the LOCAL broker; topic bridging carries it to CC
            ctx.publish("qs/readings", {"node": str(ctx.node.node_id),
                                        "value": i * i}, nbytes=64)


@image("quickstart/aggregator")
class Aggregator:
    def __init__(self):
        self.total = 0
        self.count = 0

    def start(self, ctx):
        ctx.subscribe("qs/readings", self._on_reading)

    def _on_reading(self, msg):
        self.total += msg.payload["value"]
        self.count += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    # --- phase 1: user registration + infrastructure organization
    ace = AcePlatform()
    ace.register_user("alice")
    infra = ace.register_infrastructure("alice", num_ecs=2, nodes_per_ec=3,
                                        edge_labels=[["sensor"], ["sensor"],
                                                     []])
    ace.deploy_services(infra)   # message/file services with EC<->CC bridges
    print(f"infrastructure: {[str(c) for c in infra.clusters]}")

    # --- phase 2: application development (topology file)
    topo = Topology(app="quickstart", version=1, components={
        "sensor": Component(name="sensor", image="quickstart/sensor",
                            placement="edge", replicas="per_label",
                            labels=["sensor"],
                            resources=Resources(cpu=0.1, memory_mb=32),
                            connections=["agg"]),
        "agg": Component(name="agg", image="quickstart/aggregator",
                         placement="cloud",
                         resources=Resources(cpu=1.0, memory_mb=128)),
    })
    print("\ntopology file:\n" + topo.to_yaml())

    # --- phase 3: deployment (orchestrator -> controller -> node agents)
    ace.submit_app("alice", infra, topo)
    plan = ace.deploy_app("alice", "quickstart")
    for comp, insts in plan.instances.items():
        for inst in insts:
            print(f"  {inst.instance_id:12s} -> {inst.node}")

    agg = ace.instances(infra, "agg")[0][1]
    n_sensors = len(ace.instances(infra, "sensor"))
    print(f"\n{n_sensors} sensors x 5 readings -> aggregator saw "
          f"{agg.count} readings, total={agg.total}")
    assert agg.count == n_sensors * 5
    print("quickstart OK")


if __name__ == "__main__":
    main()
