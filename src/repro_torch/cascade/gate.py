"""Confidence gate (paper §5.1.2 BP/AP) on batched tensors.

Port of ``repro.cascade.gate``. BP: accept conf >= hi; drop conf < lo;
escalate otherwise. AP: the thresholds are state, updated from edge and
cloud latency (EIL) estimates. Thresholds are host floats rounded to
float32 (``repro`` keeps them as float32 scalars), and the AP update does
its arithmetic in float32, so both packages move them identically.

``gate_logits`` is how the cascade gates: one call of the ``cascade_gate``
kernel (its plain version for CPU tensors) gives the confidences, routes
and route counts. ``confidence_from_logits`` and ``basic_gate`` are the
unfused steps of the kernel's plain version, which they share.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.cascade_gate import (as_f32, cascade_gate,
                                              max_softmax_conf,
                                              routes_from_conf)

ACCEPT, DROP, ESCALATE = 0, 1, 2

_f32 = np.float32


class GateThresholds(NamedTuple):
    hi: float                # accept threshold (a float32 value)
    lo: float                # drop threshold


def make_thresholds(hi: float = 0.8, lo: float = 0.1) -> GateThresholds:
    return GateThresholds(as_f32(hi), as_f32(lo))


def basic_gate(conf: torch.Tensor, th: GateThresholds) -> torch.Tensor:
    """conf: (...,) f32 in [0, 1] -> route codes (ACCEPT/DROP/ESCALATE)."""
    return routes_from_conf(conf, th.hi, th.lo)


def gate_counts(routes: torch.Tensor) -> dict:
    return {"accept": (routes == ACCEPT).sum(),
            "drop": (routes == DROP).sum(),
            "escalate": (routes == ESCALATE).sum()}


class APState(NamedTuple):
    th: GateThresholds
    eil_edge: float          # EWMA of the edge latency estimate (float32)
    eil_cloud: float


def ap_init(hi: float = 0.8, lo: float = 0.1) -> APState:
    return APState(make_thresholds(hi, lo), 0.0, 0.0)


def adaptive_thresholds(state: APState, eil_edge: float, eil_cloud: float, *,
                        ewma: float = 0.2, deteriorate_s: float = 0.3,
                        shrink: float = 0.1, recover: float = 0.02,
                        hi0: float = 0.8, lo0: float = 0.1) -> APState:
    """One AP update step, in float32: a latency EWMA above
    ``deteriorate_s`` shrinks the band, else it recovers toward BP."""
    e = _f32(1 - ewma) * _f32(state.eil_edge) + _f32(ewma) * _f32(eil_edge)
    c = _f32(1 - ewma) * _f32(state.eil_cloud) + _f32(ewma) * _f32(eil_cloud)
    hi, lo = _f32(state.th.hi), _f32(state.th.lo)
    band = hi - lo
    if max(e, c) > _f32(deteriorate_s):
        hi = max(_f32(0.5), hi - _f32(shrink) * band)
        lo = min(_f32(0.45), lo + _f32(shrink) * band)
    else:
        hi = min(_f32(hi0), hi + _f32(recover))
        lo = max(_f32(lo0), lo - _f32(recover))
    return APState(GateThresholds(float(hi), float(lo)), float(e), float(c))


def confidence_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Max-softmax confidence over the final axis, f32."""
    return max_softmax_conf(logits)


def gate_logits(logits: torch.Tensor, th: GateThresholds):
    """(T, V) logits -> (conf (T,) f32, routes (T,) int32, counts (3,)
    int32 in ACCEPT/DROP/ESCALATE order) through the ``cascade_gate``
    kernel."""
    return cascade_gate(logits, hi=th.hi, lo=th.lo)
