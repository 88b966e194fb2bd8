"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; nothing falls back from one to the
other. ``LAUNCHES`` counts kernel launches per wrapper (a launch adds one,
the plain path adds nothing), so a run can show it went through the
kernels. A serving engine's CUDA graph replays its captured launches
without calling the wrappers; the engine adds what the capture counted
on every replay (``serving.engine._Program``).

``FLOPS`` is what ``torch.utils.flop_counter.FlopCounterMode`` cannot see:
it counts aten's matrix products, and a kernel launched through ``ctypes``
runs none. So each attention wrapper adds, where it launches, the matrix
products of its plain version at the same shapes (``*_flops`` in its
module), which is what the mode counts when the plain version runs on
the CPU: a step's count (``analysis.roofline.step_record``) is the same on
both paths. The scan and the gate compute elementwise, which the mode
counts as nothing, and add nothing.

``TRACED`` counts the calls that met a fake tensor (``torch._subclasses.
FakeTensor``, the production-mesh dry run of ``launch.dryrun``): each
wrapper's CUDA branch runs its input checks, returns empty outputs with the
launch's shapes, dtypes and strides, adds to ``FLOPS`` what the launch
adds, and counts the call here (``traced``), never in ``LAUNCHES``. It
reads no data pointer, asks the device nothing and runs no plain version.
This is the kernel's shape rule, not a fallback: a real CUDA tensor still
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

LAUNCHES: Dict[str, int] = {"cascade_gate": 0, "decode_attention": 0,
                             "flash_attention": 0, "flash_attention_bwd": 0,
                             "paged_decode_attention": 0, "rglru_scan": 0,
                             "rglru_scan_bwd": 0}

# matrix-product FLOPs of the attention kernels' launches
FLOPS: Dict[str, int] = {"decode_attention": 0, "flash_attention": 0,
                         "flash_attention_bwd": 0,
                         "paged_decode_attention": 0}

# calls of each wrapper on fake tensors (shape rules, no launch)
TRACED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_SUPPORTED = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        TRACED[name] = 0
    for name in FLOPS:
        FLOPS[name] = 0


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no storage)."""
    return isinstance(t, FakeTensor)


def traced(name: str, outputs, flops: int = 0):
    """A kernel's call on fake tensors: counted in ``TRACED``, its
    ``flops`` added to ``FLOPS`` as its launch adds them; returns
    ``outputs``."""
    TRACED[name] += 1
    if flops:
        FLOPS[name] += flops
    return outputs


def check_cuda_tensors(name: str, floats: dict, ints: dict) -> None:
    """Validate what every kernel takes: one CUDA device, one float dtype
    (bf16 or f32) for ``floats``, int32 for ``ints``, all contiguous. A
    kernel that takes f32 only checks that on top."""
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


def misaligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s first element is off a 16-byte boundary. A fake
    tensor has no address: its offset into its storage tells, as the
    allocator aligns every storage."""
    if is_fake(t):
        return bool(t.storage_offset() * t.element_size() % 16)
    return bool(t.data_ptr() % 16)


def check_cuda_inputs(name: str, floats: dict, ints: dict, head_dim: int):
    """The attention kernels' inputs: ``check_cuda_tensors``, and K and V
    16-byte aligned (the kernels read them in 16-byte vectors), head_dim a
    multiple of 8 and at most 256."""
    check_cuda_tensors(name, floats, ints)
    for key in ("k", "v"):
        if misaligned(floats[key]):
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if head_dim % 8 or not 8 <= head_dim <= 256:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 in "
                         f"[8, 256] (got {head_dim})")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")
