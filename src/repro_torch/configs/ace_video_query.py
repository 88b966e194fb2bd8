"""Paper §5 — the ACE intelligent video query application config.

The paper deploys:
  OD   frame-differencing object detector (per edge node, not a DNN),
  EOC  MobileNetV2-class binary classifier trained on-the-fly (edge),
  COC  ResNet152-class multi-class classifier (cloud),
with the Basic Policy thresholds (accept >= 0.8, drop < 0.1) and the
Advanced Policy (EIL-driven load balancing + threshold shrinking).

We keep the roles and capacity *ratio* (COC ~40x EOC params, matching
ResNet152:MobileNetV2 ~58M:3.5M) with compact conv classifiers; the paper's
claims are about the cascade, not the specific CNNs (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    name: str
    image_size: int            # input crops are (size, size, 3)
    widths: Tuple[int, ...]    # conv channel widths (stride-2 stages)
    num_classes: int
    num_blocks_per_stage: int = 1


@dataclasses.dataclass(frozen=True)
class VideoQueryConfig:
    """The full application (paper §5.1.2 component set + §5.1.1 infra)."""
    # models
    eoc: ClassifierConfig = ClassifierConfig(
        name="eoc", image_size=32, widths=(16, 32, 64), num_classes=2)
    coc: ClassifierConfig = ClassifierConfig(
        name="coc", image_size=32, widths=(64, 128, 256, 512), num_classes=10,
        num_blocks_per_stage=2)
    # Basic Policy thresholds (paper: 80% accept, 10% drop)
    accept_threshold: float = 0.80
    drop_threshold: float = 0.10
    # infrastructure (paper §5.1.1)
    num_edge_clouds: int = 3
    nodes_per_ec: int = 4              # 1 x86 mini-PC + 3 Raspberry Pi
    uplink_mbps: float = 20.0
    downlink_mbps: float = 40.0
    wan_delay_ms: float = 50.0         # "practical"; 0.0 = "ideal"
    lan_mbps: float = 100.0
    # workload (paper §5.2)
    crop_bytes: int = 12_000           # JPEG crop ~12 KB
    eoc_infer_ms: float = 44.0         # paper: ">44ms on edge node"
    coc_infer_ms: float = 32.3         # paper: "about 32.3ms on CC"
    frame_interval_s: float = 0.5      # sampling interval, swept 0.5 -> 0.1


def config() -> VideoQueryConfig:
    return VideoQueryConfig()


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("ace-video-query", config)


register()
