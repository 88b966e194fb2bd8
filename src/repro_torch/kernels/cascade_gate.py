"""Fused confidence gate of the ACE cascade: max-softmax confidence, route
code and route counts over (T, V) logits in one pass.

Port of ``repro.kernels.cascade_gate.cascade_gate``. The kernel is
``csrc/cascade_gate.cu``: one launch that cuts each row's vocab into
``gate_splits`` splits, one CTA each, streaming its split with a running
(max, sum-exp) pair; the CTAs of a row form a thread-block cluster whose
rank 0 merges their pairs in rank order through distributed shared memory
and counts the route in a persistent per-stream workspace (no memset).
``cascade_gate_plain`` is the same function in plain PyTorch: the CPU path
and the kernel's reference.

Contract shared by both: logits (T, V) bf16 or f32 -> conf (T,) f32 =
1 / max(sum_v exp(x_v - max_v x_v), 1e-30), routes (T,) int32 (0 accept
when conf >= hi, 1 drop when conf < lo, else 2 escalate) and counts (3,)
int32, the number of rows on each route. Every one of the V columns counts
(the padded vocab too, as in ``repro``). ``hi`` and ``lo`` are rounded to
float32 first, so the kernel, the plain version and JAX compare against
the same value.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import (LAUNCHES, build, check_cuda_tensors,
                                 is_fake, raise_on_error, traced)

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_THREADS = 256          # threads per CTA (csrc/cascade_gate.cu kThreads)
_UNROLL = 4             # 16-byte loads in flight per thread in a round
_MAX_SPLITS = 8         # the portable thread-block cluster size
# per (device, stream): three route accumulators and a row ticket, zeroed
# once, then kept: each launch leaves them zero for the next on its stream
_WORK: Dict[Tuple[int, int], torch.Tensor] = {}


def as_f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (the thresholds' type)."""
    return float(np.float32(x))


def max_softmax_conf(logits):
    """Max-softmax confidence over the final axis, f32.

    softmax's entry at the row max is exp(0) / sum_v exp(x_v - m), i.e.
    the kernel's 1 / sum_v exp(x_v - m); the sum is at least 1, so the
    kernel's clamp at 1e-30 never binds. (Not ``torch.exp``: on the CPU
    build with MKL, its first multithreaded call in a process can return
    elements off by ~1e-4 relative; softmax's own exp does not.)"""
    return torch.softmax(logits.float(), dim=-1).max(dim=-1).values


def routes_from_conf(conf, hi: float, lo: float):
    """Route codes, int32: 0 accept (conf >= hi), 1 drop (conf < lo), else
    2 escalate, against ``hi`` and ``lo`` rounded to float32."""
    hi, lo = as_f32(hi), as_f32(lo)
    return torch.where(conf >= hi, 0,
                       torch.where(conf < lo, 1, 2)).to(torch.int32)


def cascade_gate_plain(logits, hi: float, lo: float):
    """f32 version with the kernel's formula: (conf, routes, counts)."""
    conf = max_softmax_conf(logits)
    routes = routes_from_conf(conf, hi, lo)
    counts = torch.stack([(routes == r).sum() for r in range(3)])
    return conf, routes, counts.to(torch.int32)


def gate_splits(t: int, v: int, elem_bytes: int, sms: int) -> Tuple[int, int]:
    """(splits, split_len): the CTAs that share a row's V columns, and the
    columns each reads (the last split reads the rest).

    A split holds at most one round of loads in flight, 256 threads x 4 x
    16 B (8,192 bf16 or 4,096 f32 entries), so a CTA pays one dependent
    trip to memory; splits are capped at the portable cluster size of 8
    (where V needs more, the kernel keeps 8 loads a thread in flight), and
    a row takes one CTA once T alone fills about two waves of the SMs.
    ``split_len`` is a whole number of 16-byte vectors."""
    vec = 16 // elem_bytes
    splits = 1 if t >= 2 * sms else min(
        _MAX_SPLITS, -(-v // (_THREADS * _UNROLL * vec)))
    split_len = -(-v // splits)
    split_len = -(-split_len // vec) * vec
    return -(-v // split_len), split_len


def _work(dev, stream: int):
    """The persistent counting workspace for this device and stream. Never
    made while the stream captures a CUDA graph (the zeroing would be
    recorded into that one graph): a capture stream's workspace is made
    beforehand (``prepare_stream``); every replay leaves it zero."""
    key = (dev.index, stream)
    got = _WORK.get(key)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "cascade_gate: the capturing stream has no counting "
                "workspace; prepare it before the capture (prepare_stream)")
        got = _WORK[key] = torch.zeros(4, dtype=torch.int32, device=dev)
    return got


def prepare_stream(dev, stream) -> None:
    """Make ``stream``'s counting workspace before a CUDA graph is captured
    on it."""
    _work(torch.device(dev), stream.cuda_stream)


def _lib():
    lib = build.load("cascade_gate")
    for fn in (lib.cascade_gate_bf16, lib.cascade_gate_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch(logits, hi: float, lo: float):
    check_cuda_tensors("cascade_gate", {"logits": logits}, {})
    t, v = logits.shape
    dev = logits.device
    conf = torch.empty((t,), dtype=torch.float32, device=dev)
    routes = torch.empty((t,), dtype=torch.int32, device=dev)
    counts = torch.empty((3,), dtype=torch.int32, device=dev)
    if t == 0:
        return conf, routes, counts.zero_()
    if is_fake(logits):
        return traced("cascade_gate", (conf, routes, counts))
    splits, split_len = gate_splits(
        t, v, logits.element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = _work(dev, stream)
    lib = _lib()
    fn = (lib.cascade_gate_bf16 if logits.dtype == torch.bfloat16
          else lib.cascade_gate_f32)
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), conf.data_ptr(), routes.data_ptr(),
                 counts.data_ptr(), work.data_ptr(), t, v, splits, split_len,
                 hi, lo, stream)
    raise_on_error("cascade_gate", err)
    LAUNCHES["cascade_gate"] += 1
    return conf, routes, counts


def cascade_gate(logits, hi: float = 0.8, lo: float = 0.1):
    """Launch the CUDA kernel for a CUDA tensor, run the plain version for
    a CPU tensor. logits (T, V) -> (conf, routes, counts)."""
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"cascade_gate: logits must be (T, V) with V > 0 "
                         f"(got {tuple(logits.shape)})")
    hi, lo = as_f32(hi), as_f32(lo)
    if logits.device.type == "cpu":
        return cascade_gate_plain(logits, hi, lo)
    if logits.is_cuda:
        return _launch(logits.contiguous(), hi, lo)
    raise ValueError(f"cascade_gate: unsupported device {logits.device}")
