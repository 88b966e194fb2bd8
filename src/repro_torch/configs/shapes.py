"""Assigned input shapes.

``mode`` selects which step gets lowered in the dry-run:
  train   -> train_step (forward + backward + optimizer update)
  prefill -> prefill_step (full-sequence forward, cache populated)
  decode  -> serve_step (ONE new token against a seq_len KV cache)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown input shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
