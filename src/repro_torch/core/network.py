"""Edge-cloud network model (the 'validation testbed' of paper §4.2.2).

Models the paper's §5.1.1 setup: each EC has a 100 Mbps WLAN; each EC↔CC WAN
path has software-limited bandwidth (20 Mbps up / 40 Mbps down) and a one-way
delay (0 ms ideal / 50 ms practical). Links are serializing FIFO pipes —
transfers queue behind each other, which is what produces the CI queue
backlog the paper observes under high system load.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Optional, Tuple

from repro_torch.core.ids import ClusterId
from repro_torch.core.sim import SimClock


@dataclasses.dataclass
class Link:
    """``fault_plan`` (a ``repro_torch.serving.faults.FaultPlan``, duck-typed —
    anything with ``fire(seam)``) injects WAN pathologies per transfer:
    seam ``wan_spike`` adds ``spike_s`` one-way latency to that transfer,
    seam ``wan_outage`` takes the link down for ``outage_s`` first (the
    transfer — and everything queued behind it — starts after the outage
    window, matching a dead-then-recovered pipe)."""
    bandwidth_mbps: float
    delay_s: float = 0.0
    jitter_s: float = 0.0
    _busy_until: float = 0.0
    bytes_sent: int = 0
    fault_plan: Optional[object] = None
    spike_s: float = 0.25
    outage_s: float = 1.0
    outages: int = 0
    spikes: int = 0

    def transfer(self, clock: SimClock, nbytes: int,
                 rng: Optional[random.Random] = None) -> float:
        """Enqueue a transfer; returns the arrival time."""
        tx = nbytes * 8.0 / (self.bandwidth_mbps * 1e6)
        start = max(clock.now, self._busy_until)
        extra = 0.0
        if self.fault_plan is not None:
            if self.fault_plan.fire("wan_outage"):
                self.outages += 1
                start += self.outage_s
            if self.fault_plan.fire("wan_spike"):
                self.spikes += 1
                extra = self.spike_s
        self._busy_until = start + tx
        jitter = rng.uniform(0, self.jitter_s) if (rng and self.jitter_s) else 0.0
        self.bytes_sent += nbytes
        return self._busy_until + self.delay_s + jitter + extra

    @property
    def queue_s(self) -> float:
        return max(0.0, self._busy_until)


class NetworkModel:
    """Routes (src_cluster -> dst_cluster) over LAN/WAN links and meters
    edge-cloud bandwidth consumption (the paper's BWC metric)."""

    def __init__(self, clock: SimClock, *, lan_mbps: float = 100.0,
                 uplink_mbps: float = 20.0, downlink_mbps: float = 40.0,
                 wan_delay_s: float = 0.0, jitter_s: float = 0.0,
                 seed: int = 0, fault_plan: Optional[object] = None):
        self.clock = clock
        self.rng = random.Random(seed)
        self.lan_mbps = lan_mbps
        self.uplink_mbps = uplink_mbps
        self.downlink_mbps = downlink_mbps
        self.wan_delay_s = wan_delay_s
        self.jitter_s = jitter_s
        # WAN chaos: spikes/outages apply to cross-boundary links only
        # (the LAN inside a cluster is not the fragile part of the story)
        self.fault_plan = fault_plan
        self._links: Dict[Tuple[str, str], Link] = {}

    def link(self, src: ClusterId, dst: ClusterId) -> Link:
        key = (str(src), str(dst))
        if key not in self._links:
            if src == dst:
                l = Link(self.lan_mbps, 0.0)
            elif dst.is_cloud and not src.is_cloud:
                l = Link(self.uplink_mbps, self.wan_delay_s, self.jitter_s,
                         fault_plan=self.fault_plan)
            elif src.is_cloud and not dst.is_cloud:
                l = Link(self.downlink_mbps, self.wan_delay_s, self.jitter_s,
                         fault_plan=self.fault_plan)
            else:  # EC <-> EC goes through the CC in the paper's topology
                l = Link(self.uplink_mbps, 2 * self.wan_delay_s, self.jitter_s,
                         fault_plan=self.fault_plan)
            self._links[key] = l
        return self._links[key]

    def send(self, src: ClusterId, dst: ClusterId, nbytes: int, fn) -> None:
        """Deliver ``fn`` at the simulated arrival time of the transfer."""
        if src == dst:
            # same-cluster LAN hop
            arrival = self.link(src, dst).transfer(self.clock, nbytes, self.rng)
        else:
            arrival = self.link(src, dst).transfer(self.clock, nbytes, self.rng)
        self.clock.schedule_at(arrival, fn)

    # -- metering ------------------------------------------------------------
    def wan_bytes(self) -> int:
        """Total bytes crossing any EC<->CC boundary (the BWC metric)."""
        total = 0
        for (src, dst), link in self._links.items():
            if (".cc-" in src) != (".cc-" in dst):
                total += link.bytes_sent
        return total
