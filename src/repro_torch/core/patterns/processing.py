"""ECC processing pattern (paper §2): collaborative data-processing
pipelines / DAGs (the Steel-style streaming analytics example).

Each :class:`PipelineStage` is an ACE component: it subscribes to its input
topic(s) on the *local* broker, applies a user function with a simulated
processing time, and publishes downstream. Because topics are bridged
EC<->CC, a pipeline can span edge and cloud without the developer handling
any edge-cloud interaction — the paper's user-transparency claim.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.registry import image
from repro_torch.core.topology import Topology, Component, Resources


@image("repro/pattern/pipeline-stage")
class PipelineStage:
    def __init__(self, fn: Optional[Callable[[Any], Any]] = None,
                 in_topics: Sequence[str] = (), out_topic: str = "",
                 proc_time_s: float = 0.0, out_bytes: int = 256):
        self.fn = fn or (lambda x: x)
        self.in_topics = list(in_topics)
        self.out_topic = out_topic
        self.proc_time_s = proc_time_s
        self.out_bytes = out_bytes
        self.processed = 0
        self.outputs: List[Any] = []

    def start(self, ctx) -> None:
        self.ctx = ctx
        for t in self.in_topics:
            ctx.subscribe(t, self._on_item)

    def _on_item(self, msg) -> None:
        def finish():
            result = self.fn(msg.payload)
            self.processed += 1
            if result is None:
                return                      # filtered out
            self.outputs.append(result)
            if self.out_topic:
                self.ctx.publish(self.out_topic, result,
                                 nbytes=self.out_bytes)
        self.ctx.clock.schedule(self.proc_time_s, finish)


def pipeline_topology(app: str, stages: List[dict]) -> Topology:
    """Build a linear-pipeline topology. Each stage dict:
    {name, placement, fn?, proc_time_s?, resources?}. Topics are wired
    ``<app>/s0 -> <app>/s1 -> ...`` automatically."""
    comps: Dict[str, Component] = {}
    for i, st in enumerate(stages):
        in_topics = [f"{app}/s{i - 1}"] if i > 0 else [f"{app}/in"]
        out_topic = f"{app}/s{i}" if i < len(stages) - 1 else f"{app}/out"
        comps[st["name"]] = Component(
            name=st["name"],
            image="repro/pattern/pipeline-stage",
            placement=st.get("placement", "edge"),
            resources=st.get("resources", Resources()),
            connections=[stages[i - 1]["name"]] if i > 0 else [],
            params={"init": {
                "fn": st.get("fn"),
                "in_topics": in_topics,
                "out_topic": out_topic,
                "proc_time_s": st.get("proc_time_s", 0.0),
                "out_bytes": st.get("out_bytes", 256),
            }},
        )
    return Topology(app=app, version=1, components=comps)
