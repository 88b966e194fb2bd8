"""The paper's confidence-gated cascade in PyTorch (static shapes).

``gate``      — BP/AP threshold logic, and ``gate_logits`` through the
                ``cascade_gate`` kernel.
``routing``   — sort-based compaction of escalated rows (the cloud model
                touches only a bounded slice).
``ecc_infer`` — edge-model/cloud-model collaborative inference.
"""
from repro_torch.cascade.gate import (GateThresholds, adaptive_thresholds,
                                      basic_gate, gate_logits,
                                      make_thresholds)
from repro_torch.cascade.routing import compact_escalations, scatter_back
from repro_torch.cascade.ecc_infer import CascadeLM, edge_variant

__all__ = ["GateThresholds", "basic_gate", "adaptive_thresholds",
           "gate_logits", "make_thresholds", "compact_escalations",
           "scatter_back", "CascadeLM", "edge_variant"]
