"""Edge/cloud collaborative LM inference: the video-query cascade
transposed to the LM workloads ACE hosts (inter-model ECC inference, §2).

Port of ``repro.cascade.ecc_infer``. Requests are one-shot queries: the
*edge* model (a shallow same-vocab draft) prefills every request and
emits a next-token distribution; its last-position logits go through the
``cascade_gate`` kernel (``gate.gate_logits``), and requests whose
confidence falls inside the BP band are *escalated*: compacted to a
fixed-capacity slice and prefilled by the *cloud* model, whose prediction
overrides the edge one. Both forwards unembed only the last position.
A batch may carry more than ``tokens``: a vision model's
``image_embeds``. Both models read the whole batch, and the cloud's slice
gathers every such input with the tokens, as ``repro``'s does; the WAN
count stays ``repro``'s (token ids up, one int32 down).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.cascade.gate import (ACCEPT, DROP, ESCALATE, GateThresholds,
                                      gate_logits, make_thresholds)
from repro_torch.cascade.routing import (compact_escalations,
                                         gather_compacted, scatter_back)
from repro_torch.configs.base import ModelConfig, Stage
from repro_torch.models.model import LM


def edge_variant(cfg: ModelConfig, *, layers: int = 4,
                 d_model: Optional[int] = None) -> ModelConfig:
    """A shallow same-vocab draft of ``cfg`` to play EOC against its COC."""
    d = d_model or max(256, cfg.d_model // 4)
    heads = max(1, cfg.num_heads // 4)
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    stages = []
    remaining = layers
    for st in cfg.stages:
        if remaining <= 0:
            break
        take = min(remaining, st.repeat)
        stages.append(Stage(blocks=st.blocks, repeat=take))
        remaining -= take
    # pad with the first stage's block type if the model is too shallow
    if remaining > 0:
        stages.append(Stage(blocks=cfg.stages[0].blocks, repeat=remaining))
    n_layers = sum(len(s.blocks) * s.repeat for s in stages)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            num_experts_per_tok=min(cfg.moe.num_experts_per_tok, 2),
            d_ff_expert=max(256, cfg.moe.d_ff_expert // 4),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_shared=max(256, cfg.moe.d_ff_shared // 4)
            if cfg.moe.num_shared_experts else 0)
    mla = None
    if cfg.mla is not None:
        mla = dataclasses.replace(cfg.mla, q_lora_rank=256, kv_lora_rank=128)
    return dataclasses.replace(
        cfg, name=cfg.name + "-edge", num_layers=n_layers, d_model=d,
        num_heads=heads, num_kv_heads=max(1, heads // min(ratio, heads)),
        head_dim=64, d_ff=max(256, cfg.d_ff // 4) if cfg.d_ff else 0,
        stages=tuple(stages), moe=moe, mla=mla, mtp_depth=0)


def _wan_row_bytes(seq_len: int) -> int:
    """Boundary traffic of one escalation: its token ids up, the answer
    (one int32) down."""
    return seq_len * 4 + 4


@dataclasses.dataclass
class CascadeLM:
    """The ACE inter-model cascade over two LMs sharing a tokenizer."""
    edge: LM
    cloud: LM
    thresholds: GateThresholds = None
    capacity_frac: float = 0.25     # cloud slice size as a fraction of B

    def __post_init__(self):
        if self.edge.cfg.padded_vocab != self.cloud.cfg.padded_vocab:
            raise ValueError("cascade models must share a vocabulary")
        if self.thresholds is None:
            self.thresholds = make_thresholds()

    def capacity(self, batch: int) -> int:
        return max(1, int(batch * self.capacity_frac))

    def _edge_gate(self, edge_params, batch: dict, mesh=None):
        edge_logits, _ = self.edge.forward(edge_params, batch,
                                           last_only=True, mesh=mesh)
        edge_last = edge_logits[:, 0]                         # (B, V)
        conf, routes, counts = gate_logits(edge_last, self.thresholds)
        return edge_last, conf, routes, counts

    def _result(self, final, edge_last, conf, routes, counts, wan_bytes):
        return {"pred": final.argmax(dim=-1), "conf": conf, "routes": routes,
                "edge_pred": edge_last.argmax(dim=-1), "wan_bytes": wan_bytes,
                "accept": counts[ACCEPT], "drop": counts[DROP],
                "escalate": counts[ESCALATE]}

    def serve_step(self, edge_params, cloud_params, batch: dict, mesh=None):
        """batch['tokens']: (B, S) one-shot queries, and any other input
        the models take (``image_embeds``; ``labels`` is not one). Returns
        a dict of final predictions, per-request route codes and counts
        (from the kernel), and boundary-traffic bytes, all as device
        tensors. ``mesh``: both models' params are this rank's shards and
        their forwards run on it (``LM.forward``'s ``mesh``)."""
        tokens = batch["tokens"]
        b, s = tokens.shape[:2]
        cap = self.capacity(b)
        edge_last, conf, routes, counts = self._edge_gate(edge_params, batch,
                                                          mesh)
        routing = compact_escalations(routes == ESCALATE, cap)
        cloud_batch = {k: gather_compacted(v, routing, cap)
                       for k, v in batch.items() if k != "labels"}
        cloud_logits, _ = self.cloud.forward(cloud_params, cloud_batch,
                                             last_only=True, mesh=mesh)
        final = scatter_back(edge_last, cloud_logits[:, 0], routing)
        wan_bytes = torch.clamp(counts[ESCALATE], max=cap) * _wan_row_bytes(s)
        return self._result(final, edge_last, conf, routes, counts,
                            wan_bytes)

    def lockstep_step(self, edge_params, cloud_params, batch: dict,
                      mesh=None):
        """Paper-faithful baseline (no compaction): the cloud model sees the
        full batch; the gate only selects which logits win. Same accuracy,
        strictly more cloud compute and boundary bytes. ``mesh``: as in
        ``serve_step``."""
        tokens = batch["tokens"]
        b, s = tokens.shape[:2]
        edge_last, conf, routes, counts = self._edge_gate(edge_params, batch,
                                                          mesh)
        cloud_logits, _ = self.cloud.forward(cloud_params, batch,
                                             last_only=True, mesh=mesh)
        esc = (routes == ESCALATE)[:, None]
        final = torch.where(esc, cloud_logits[:, 0], edge_last)
        wan_bytes = torch.tensor(b * _wan_row_bytes(s), dtype=torch.int32,
                                 device=tokens.device)
        return self._result(final, edge_last, conf, routes, counts,
                            wan_bytes)
