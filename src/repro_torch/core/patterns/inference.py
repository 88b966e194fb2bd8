"""ECC inference pattern (paper §2): intra-model partitioning and
inter-model cascades.

Intra-model (Neurosurgeon/SPINN/JointDNN class): a single model is split by
layers; the edge runs the bottom, ships the boundary activation across the
WAN, the cloud finishes. :func:`best_partition` is the in-app control policy
deciding the split point from napkin latency math — the paper's Principle
Four example.

Inter-model (VideoEdge/SurveilEdge class): a small edge model and a large
cloud model collaborate through a confidence gate — :class:`CascadePair`
(the tensor-level LM version lives in ``repro_torch.cascade``).

The port's copy over the port's ``LM``: the partition runs ``LM``'s own
layer loop over a range of scanned layers (``LM._layer_range``), so the
edge and cloud halves launch the same kernels as the monolithic forward.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LM


# ---------------------------------------------------------------------------
# Intra-model partitioning
# ---------------------------------------------------------------------------

def _itemsize(dtype_name: str) -> int:
    """Bytes per element of a config's ``param_dtype`` (torch's table:
    numpy has no bfloat16 of its own)."""
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()


@dataclasses.dataclass
class PartitionedLM:
    """Split an LM at a scanned-layer boundary: layers [0, split) on the
    edge, [split, L_scan) plus head on the cloud."""
    lm: LM
    split: int           # in scanned-layer units (stage repeats)

    def edge_forward(self, params, batch):
        """Bottom of the network on the edge; returns the boundary tensor."""
        lm = self.lm
        x, positions = lm._embed_inputs(params, batch)
        return lm._layer_range(params, x, positions, 0, self.split), \
            positions

    def cloud_forward(self, params, hidden, positions):
        lm = self.lm
        x = lm._layer_range(params, hidden, positions, self.split)
        return lm._head(params, x, False, None)

    def boundary_bytes(self, batch_size: int, seq_len: int) -> int:
        d = self.lm.cfg.d_model
        itemsize = _itemsize(self.lm.cfg.param_dtype)
        return batch_size * seq_len * d * itemsize


def layer_flops(cfg: ModelConfig, seq_len: int) -> float:
    """Per-scanned-layer forward FLOPs estimate (weights-dominated)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    attn_proj = 2 * seq_len * d * (h + 2 * kv) * hd + 2 * seq_len * h * hd * d
    attn_score = 4 * seq_len * seq_len * h * hd
    if cfg.moe is not None:
        f = cfg.moe.d_ff_expert * cfg.moe.num_experts_per_tok
        f += cfg.moe.d_ff_shared
    else:
        f = cfg.d_ff
    mlp = 6 * seq_len * d * f
    return float(attn_proj + attn_score + mlp)


def best_partition(cfg: ModelConfig, *, batch: int, seq_len: int,
                   edge_flops_s: float, cloud_flops_s: float,
                   uplink_mbps: float, delay_s: float) -> Tuple[int, float]:
    """Neurosurgeon-style split search: argmin_k edge(k) + wan(k) + cloud(k).

    Returns (best split in scanned layers, estimated E2E seconds)."""
    total = sum(st.repeat for st in cfg.stages)
    per_layer = layer_flops(cfg, seq_len) * batch
    d = cfg.d_model
    itemsize = _itemsize(cfg.param_dtype)
    hidden_bytes = batch * seq_len * d * itemsize
    token_bytes = batch * seq_len * 4
    best_k, best_t = 0, float("inf")
    for k in range(total + 1):
        edge_t = k * per_layer / edge_flops_s
        cloud_t = (total - k) * per_layer / cloud_flops_s
        wire = token_bytes if k == 0 else (0 if k == total else hidden_bytes)
        wan_t = (wire * 8 / (uplink_mbps * 1e6)) + (delay_s if wire else 0.0)
        t = edge_t + wan_t + cloud_t
        if t < best_t:
            best_k, best_t = k, t
    return best_k, best_t


# ---------------------------------------------------------------------------
# Inter-model cascade over classifiers (paper §5 EOC/COC shape)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CascadePair:
    """Edge/cloud classifier cascade with the BP confidence gate."""
    edge_apply: object          # params, images -> logits
    cloud_apply: object
    accept: float = 0.8
    drop: float = 0.1

    def edge_step(self, edge_params, images):
        logits = self.edge_apply(edge_params, images)
        probs = torch.softmax(logits, dim=-1)
        conf = torch.max(probs, dim=-1).values
        pred = torch.argmax(probs, dim=-1)
        accept = (conf >= self.accept) & (pred == 1)
        drop = conf < self.drop
        escalate = ~accept & ~drop
        # crops predicted 'negative' confidently are also drops
        neg = (conf >= self.accept) & (pred != 1)
        return {"pred": pred, "conf": conf, "accept": accept,
                "drop": drop | neg, "escalate": escalate & ~neg}

    def cloud_step(self, cloud_params, images, target_class: int):
        logits = self.cloud_apply(cloud_params, images)
        top5 = torch.topk(logits, min(5, logits.shape[-1])).indices
        hit = torch.any(top5 == target_class, dim=-1)
        return {"hit": hit}
