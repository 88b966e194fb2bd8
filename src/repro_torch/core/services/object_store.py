"""Object storage service — the data plane used by the file service
(paper Fig. 2 links ⑤/⑥: 'the proverbial object storage service is used to
handle the data flow for transmission simplification').
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional


@dataclasses.dataclass
class StoredObject:
    key: str
    data: Any
    nbytes: int
    lifecycle: str = "temporary"    # temporary | permanent (paper §4.3.2)
    created_at: float = 0.0


class ObjectStore:
    """A bucketed key-value object store hosted on the CC."""

    def __init__(self):
        self._buckets: Dict[str, Dict[str, StoredObject]] = {}

    def put(self, bucket: str, key: str, data: Any, nbytes: int,
            lifecycle: str = "temporary") -> StoredObject:
        obj = StoredObject(key, data, nbytes, lifecycle, time.monotonic())
        self._buckets.setdefault(bucket, {})[key] = obj
        return obj

    def get(self, bucket: str, key: str) -> Optional[StoredObject]:
        return self._buckets.get(bucket, {}).get(key)

    def delete(self, bucket: str, key: str) -> bool:
        return self._buckets.get(bucket, {}).pop(key, None) is not None

    def gc_temporary(self, bucket: str) -> int:
        """Drop temporary objects (end-of-application cleanup)."""
        b = self._buckets.get(bucket, {})
        victims = [k for k, o in b.items() if o.lifecycle == "temporary"]
        for k in victims:
            del b[k]
        return len(victims)

    def keys(self, bucket: str):
        return sorted(self._buckets.get(bucket, {}))
