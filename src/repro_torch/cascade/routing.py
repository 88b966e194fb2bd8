"""Static-shape escalation routing.

Port of ``repro.cascade.routing``. Escalated rows are moved to the front
in a stable order, the cloud model runs on the first ``capacity`` rows
only, and its results scatter back onto the rows they came from.
Escalations beyond the capacity keep the edge result (graceful
degradation). The cloud slice always has ``capacity`` rows, as in
``repro``, so the cloud forward's shape never depends on the data and no
count leaves the device. The gather of compacted rows is the edge -> cloud
WAN transfer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Routing(NamedTuple):
    order: torch.Tensor          # (B,) permutation: escalated first
    inverse: torch.Tensor        # (B,) inverse permutation
    num_escalated: torch.Tensor  # scalar int32
    kept: torch.Tensor           # (capacity,) bool: slot holds an escalation


def compact_escalations(escalate_mask: torch.Tensor,
                        capacity: int) -> Routing:
    """escalate_mask: (B,) bool. Stable-sort escalated rows to the front."""
    # stable argsort of (not escalated): escalated rows (key 0) sort first
    key = (~escalate_mask).to(torch.int32)
    order = torch.argsort(key, stable=True)
    inverse = torch.argsort(order)
    num = escalate_mask.to(torch.int32).sum().to(torch.int32)
    kept = (torch.arange(capacity, device=escalate_mask.device)
            < torch.clamp(num, max=capacity))
    return Routing(order, inverse, num, kept)


def gather_compacted(x: torch.Tensor, routing: Routing,
                     capacity: int) -> torch.Tensor:
    """Rows for the cloud model: the first ``capacity`` rows in
    escalated-first order. x: (B, ...) -> (min(capacity, B), ...)."""
    return x.index_select(0, routing.order[:capacity])


def scatter_back(edge_result: torch.Tensor, cloud_result: torch.Tensor,
                 routing: Routing) -> torch.Tensor:
    """Overlay cloud results onto escalated rows (within capacity).

    edge_result: (B, ...); cloud_result: (capacity, ...)."""
    b = edge_result.shape[0]
    capacity = cloud_result.shape[0]
    if capacity < b:
        pad = cloud_result.new_zeros((b - capacity,) + cloud_result.shape[1:])
        padded = torch.cat([cloud_result, pad], dim=0)
        used = torch.cat([routing.kept, routing.kept.new_zeros(b - capacity)])
    else:
        padded, used = cloud_result[:b], routing.kept[:b]
    in_order = padded.index_select(0, routing.inverse)
    used_in_order = used.index_select(0, routing.inverse)
    shape = (b,) + (1,) * (edge_result.dim() - 1)
    return torch.where(used_in_order.reshape(shape), in_order, edge_result)
