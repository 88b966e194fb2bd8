"""Resource-level message service: topic pub/sub with EC<->CC bridging
(paper §4.3.2, Figure 2).

Each cluster (every EC and the CC) runs a local :class:`Broker`; application
clients only ever talk to their *local* broker with a dedicated interface
(link ① in Fig. 2). A long-lasting :class:`Bridge` — the MQTT topic-bridging
analog (link ②) — forwards matching topics between an EC broker and the CC
broker across the WAN model, so edge-cloud interactions are user-transparent.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.ids import ClusterId
from repro_torch.core.network import NetworkModel
from repro_torch.core.sim import SimClock


@dataclasses.dataclass
class Message:
    topic: str
    payload: Any
    nbytes: int
    src: str                 # node or component id
    msg_id: int = 0


class Broker:
    """A per-cluster topic broker (Mosquitto analog)."""

    def __init__(self, cluster: ClusterId, clock: SimClock):
        self.cluster = cluster
        self.clock = clock
        self._subs: List[Tuple[str, Callable[[Message], None]]] = []
        self._seq = itertools.count()
        self.delivered = 0

    def subscribe(self, pattern: str, fn: Callable[[Message], None]) -> None:
        """``pattern`` supports MQTT-ish wildcards via fnmatch ('*', '?')."""
        self._subs.append((pattern, fn))

    def unsubscribe(self, pattern: str, fn) -> None:
        self._subs = [(p, f) for (p, f) in self._subs
                      if not (p == pattern and f is fn)]

    def publish(self, topic: str, payload: Any, *, nbytes: int = 256,
                src: str = "") -> Message:
        msg = Message(topic, payload, nbytes, src, next(self._seq))
        self._deliver(msg)
        return msg

    def _deliver(self, msg: Message) -> None:
        for pattern, fn in list(self._subs):
            if fnmatch.fnmatch(msg.topic, pattern):
                self.delivered += 1
                fn(msg)


class Bridge:
    """Long-lasting EC<->CC topic bridge over the WAN model (Fig. 2 link ②).

    Topics matching ``up_patterns`` published on the EC broker are forwarded
    to the CC broker (and vice versa for ``down_patterns``), incurring the
    WAN transfer time. Loop suppression via a bridge marker on the message
    source.
    """

    def __init__(self, ec_broker: Broker, cc_broker: Broker,
                 network: Optional[NetworkModel],
                 up_patterns: List[str], down_patterns: List[str]):
        self.ec = ec_broker
        self.cc = cc_broker
        self.network = network
        self._marker = f"bridge:{ec_broker.cluster}"
        for p in up_patterns:
            self.ec.subscribe(p, self._up)
        for p in down_patterns:
            self.cc.subscribe(p, self._down)

    def _up(self, msg: Message) -> None:
        if msg.src == self._marker:
            return
        self._forward(msg, self.ec.cluster, self.cc.cluster, self.cc)

    def _down(self, msg: Message) -> None:
        # forward CC traffic to this EC unless it originated here (loop
        # guard); traffic bridged up from ANOTHER EC does flow down — that
        # is how edge-edge collaboration transits the CC (paper §4.3.1)
        if msg.src == self._marker:
            return
        self._forward(msg, self.cc.cluster, self.ec.cluster, self.ec)

    def _forward(self, msg: Message, src: ClusterId, dst: ClusterId,
                 target: Broker) -> None:
        def deliver():
            target.publish(msg.topic, msg.payload, nbytes=msg.nbytes,
                           src=self._marker)
        if self.network is None:
            deliver()
        else:
            self.network.send(src, dst, msg.nbytes, deliver)


class MessageService:
    """The E2E resource-level message service: one broker per cluster plus
    bridges EC<->CC. Clients address only their local broker."""

    def __init__(self, clusters: List[ClusterId], clock: SimClock,
                 network: Optional[NetworkModel] = None,
                 bridged_topics: Optional[List[str]] = None):
        self.clock = clock
        self.network = network
        self.brokers: Dict[str, Broker] = {
            str(c): Broker(c, clock) for c in clusters}
        self.bridges: List[Bridge] = []
        cc = [c for c in clusters if c.is_cloud]
        assert len(cc) == 1, "exactly one CC required (paper §4.3.1)"
        self.cc_cluster = cc[0]
        patterns = bridged_topics if bridged_topics is not None else ["*"]
        for c in clusters:
            if not c.is_cloud:
                self.bridges.append(Bridge(
                    self.brokers[str(c)], self.brokers[str(cc[0])],
                    network, up_patterns=patterns, down_patterns=patterns))

    def broker(self, cluster: ClusterId) -> Broker:
        return self.brokers[str(cluster)]
