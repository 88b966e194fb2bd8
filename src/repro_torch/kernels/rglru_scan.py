"""RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t over time: the
port's recurrent prefill.

Port of ``repro.kernels.rglru_scan.rglru_scan``. The kernel is
``csrc/rglru_scan.cu`` (the time axis split into chunks: each chunk is
reduced to one affine map, the maps are carried across chunks from h0, and
each chunk is scanned again from its incoming state); ``rglru_scan_plain``
is the same function in plain PyTorch, a sequential loop over time: the CPU
path and the kernel's reference.

Contract shared by both: a, b (B, S, W) f32 and h0 (B, W) f32 -> (h
(B, S, W) f32, h_last (B, W) f32), for any S, W >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LAUNCHES, build, check_cuda_tensors,
                                 raise_on_error)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_THREADS = 128          # channels per CTA (csrc/rglru_scan.cu kThreads)
_CTAS_PER_SM = 8        # the grid the chunk length aims for
_MIN_CHUNK = 16         # steps per chunk at least


def rglru_scan_plain(a, b, h0):
    """Sequential f32 loop over time (``repro.kernels.ref.rglru_scan_ref``'s
    semantics): returns (h, h_last)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1), h


def chunk_len(batch: int, s: int, w: int, sms: int) -> int:
    """Steps per time chunk: enough chunks that the grid has ~8 CTAs per
    SM, each chunk at least 16 steps."""
    tiles = batch * -(-w // _THREADS)
    chunks = max(1, min(-(-s // _MIN_CHUNK),
                        -(-_CTAS_PER_SM * sms // tiles)))
    return -(-s // chunks)


def _lib():
    lib = build.load("rglru_scan")
    lib.rglru_scan_f32.argtypes = _ARGTYPES
    lib.rglru_scan_f32.restype = ctypes.c_int
    return lib


def _launch(a, b, h0):
    check_cuda_tensors("rglru_scan", {"a": a, "b": b, "h0": h0}, {})
    if a.dtype != torch.float32:
        raise TypeError(f"rglru_scan: a/b/h0 must be float32 (got {a.dtype})")
    bsz, s, w = a.shape
    if b.shape != a.shape or h0.shape != (bsz, w) or not (s and w and bsz):
        raise ValueError(
            f"rglru_scan: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, h0 "
            f"{tuple(h0.shape)} do not form (B,S,W)/(B,W) with B, S, W >= 1")
    dev = a.device
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    chunk = chunk_len(bsz, s, w,
                      torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    nchunks = -(-s // chunk)
    if nchunks > 1:
        red_a, red_h, carry = (torch.empty((bsz, nchunks, w),
                                           dtype=torch.float32, device=dev)
                               for _ in range(3))
        scratch = (red_a.data_ptr(), red_h.data_ptr(), carry.data_ptr())
    else:
        scratch = (None, None, None)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rglru_scan_f32(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                 h.data_ptr(), h_last.data_ptr(), *scratch,
                                 bsz, s, w, chunk,
                                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("rglru_scan", err)
    LAUNCHES["rglru_scan"] += 1
    return h, h_last


def rglru_scan(a, b, h0):
    """Launch the CUDA kernel for CUDA tensors, run the plain version for
    CPU tensors. a, b (B, S, W), h0 (B, W), all f32 -> (h, h_last)."""
    if a.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"rglru_scan: a must be (B, S, W) and h0 (B, W) "
                         f"(got {tuple(a.shape)}, {tuple(h0.shape)})")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.is_cuda:
        return _launch(a.contiguous(), b.contiguous(), h0.contiguous())
    raise ValueError(f"rglru_scan: unsupported device {a.device}")
