"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Module names mirror ``repro`` (``repro_torch.models.attention`` is the
counterpart of ``repro.models.attention``), and parameters keep ``repro``'s
nested-dict layout with stacked layer axes, so ``repro_torch.bridge`` can
carry weights across by name. The package imports neither JAX nor
``repro``. Entry points run on the GPU (``device="cuda"``) unless the
caller asks for the CPU; without a GPU they raise instead of moving.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate a requested device: "cuda" needs a visible GPU (no silent
    move to the CPU) unless a ``FakeTensorMode`` is active (fake CUDA
    tensors need no card: ``launch.dryrun``), and only "cuda" and "cpu"
    are supported."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from torch._guards import detect_fake_mode
        if not torch.cuda.is_available() and detect_fake_mode() is None:
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device "
                "is visible; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


__all__ = ["resolve_device"]
