"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; nothing falls back from one to the
other. ``LAUNCHES`` counts kernel launches per wrapper (a launch adds one,
the plain path adds nothing), so a run can show it went through the
kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"cascade_gate": 0, "decode_attention": 0,
                             "flash_attention": 0,
                             "paged_decode_attention": 0}

_SUPPORTED = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_cuda_tensors(name: str, floats: dict, ints: dict) -> None:
    """Validate what every kernel takes: one CUDA device, one float dtype
    (bf16 or f32) for ``floats``, int32 for ``ints``, all contiguous."""
    tensors = {**floats, **ints}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all inputs must be on one CUDA device "
                         f"(got {sorted(map(str, devices))})")
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _SUPPORTED:
        raise TypeError(f"{name}: {'/'.join(floats)} must share one dtype "
                        f"of bfloat16 or float32 (got {dtypes})")
    for key, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32 (got {t.dtype})")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_cuda_inputs(name: str, floats: dict, ints: dict, head_dim: int):
    """The attention kernels' inputs: ``check_cuda_tensors``, and K and V
    16-byte aligned (the kernels read them in 16-byte vectors), head_dim a
    multiple of 8 and at most 256."""
    check_cuda_tensors(name, floats, ints)
    for key in ("k", "v"):
        if floats[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if head_dim % 8 or not 8 <= head_dim <= 256:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 in "
                         f"[8, 256] (got {head_dim})")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")
