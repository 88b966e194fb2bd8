"""Resource-level file service (paper §4.3.2, Fig. 2 links ③—⑥).

Control flow (offers, requests, completions) is *separated from the data
flow* and carried by the resource-level message service over its bridged
links; the data flow goes through the object store across the network model.
This is exactly the paper's design: directly bridging file services (e.g.
by file synchronization) would be expensive, so the message service carries
control and object storage carries data.

Typical use: an EC component ``put``s a locally-trained model; the CC (or
another EC) is notified via the bridged ``ace/file/*`` topic and ``get``s it.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional

from repro_torch.core.ids import ClusterId
from repro_torch.core.network import NetworkModel
from repro_torch.core.pubsub import MessageService
from repro_torch.core.services.object_store import ObjectStore
from repro_torch.core.sim import SimClock


class FileService:
    def __init__(self, msg: MessageService, store: ObjectStore,
                 network: Optional[NetworkModel], clock: SimClock,
                 cc_cluster: ClusterId):
        self.msg = msg
        self.store = store
        self.network = network
        self.clock = clock
        self.cc = cc_cluster
        self._seq = itertools.count()

    # -- write path (Fig. 2: ③ control, ⑤ data) ------------------------------
    def put(self, bucket: str, key: str, data: Any, nbytes: int,
            src_cluster: ClusterId, *, lifecycle: str = "temporary",
            on_done: Optional[Callable[[], None]] = None) -> None:
        """Upload an object; control message announces availability after the
        (simulated) data transfer to the CC-hosted store completes."""
        def complete():
            self.store.put(bucket, key, data, nbytes, lifecycle)
            # control-plane notification on the bridged message service
            self.msg.broker(src_cluster).publish(
                f"ace/file/available/{bucket}/{key}",
                {"bucket": bucket, "key": key, "nbytes": nbytes},
                nbytes=200, src="file-service")
            if on_done:
                on_done()

        if self.network is None or src_cluster == self.cc:
            complete()
        else:
            self.network.send(src_cluster, self.cc, nbytes, complete)

    # -- read path (Fig. 2: ④ control, ⑥ data) -------------------------------
    def get(self, bucket: str, key: str, dst_cluster: ClusterId,
            callback: Callable[[Any], None]) -> None:
        """Fetch an object to ``dst_cluster``; callback fires when the data
        transfer lands (control request + object download)."""
        obj = self.store.get(bucket, key)
        if obj is None:
            raise KeyError(f"{bucket}/{key} not in object store")

        def deliver():
            callback(obj.data)

        if self.network is None or dst_cluster == self.cc:
            deliver()
        else:
            self.network.send(self.cc, dst_cluster, obj.nbytes, deliver)

    def on_available(self, cluster: ClusterId, pattern: str,
                     fn: Callable[[dict], None]) -> None:
        """Subscribe to availability notifications (control plane)."""
        self.msg.broker(cluster).subscribe(
            f"ace/file/available/{pattern}", lambda m: fn(m.payload))
