"""RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t over time: the
port's recurrent prefill.

Port of ``repro.kernels.rglru_scan.rglru_scan``. The kernel is
``csrc/rglru_scan.cu``: one launch that cuts time into chunks of at most
32 steps, one CTA per (batch row, 128-channel tile, chunk), and joins a
chain's chunks by a chained scan with look-back in a fixed order (so that
it gives the same bits on every call), reading a and b from device memory
once. ``rglru_scan_plain`` is the same function in plain PyTorch, a
sequential loop over time: the CPU path and the kernel's reference.

Contract shared by both: a, b (B, S, W) f32 and h0 (B, W) f32 -> (h
(B, S, W) f32, h_last (B, W) f32), for any S, W >= 1.

Training: when grad is enabled and an input requires it, ``rglru_scan``
goes through ``RGLRUScan`` (a ``torch.autograd.Function``), whose backward
is the same kernel's reverse mode (``rglru_scan_bwd_f32``; ``LAUNCHES
["rglru_scan_bwd"]``): with g the gradient of the running state, g_t =
dh_t + a_{t+1} g_{t+1} from g_{S-1} = dh_{S-1} + dh_last, da_t = g_t
h_{t-1} (h_{-1} = h0), db_t = g_t, dh0 = a_0 g_0, in one launch. It keeps
the forward's look-back protocol and shares its per-stream state. On CPU
tensors ``rglru_scan_bwd_plain`` (a sequential reverse loop) runs instead.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import (LAUNCHES, build, check_cuda_tensors,
                                 is_fake, raise_on_error, traced)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_THREADS = 128          # channels per CTA (csrc/rglru_scan.cu kThreads)
_MAX_CHUNK = 32         # steps a CTA holds in shared memory (kMaxChunk)
_MIN_CHUNK = 8          # steps per chunk at least, where S allows
# chunks per look-back group: a chunk applies the maps of the chunks before
# it in its group to the state after the group before
_GROUP = 16
# per (device, stream): the look-back's ticket counter, retired-CTA count
# and epoch, and its flags (one per CTA); zeroed once, then kept: each
# launch leaves them ready for the next on its stream
_STATE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# states a growth replaced: CUDA graphs captured before the growth keep
# their addresses, so those states live as long as the process
_RETIRED: List[Tuple[torch.Tensor, torch.Tensor]] = []
_MIN_FLAGS = 4096


def rglru_scan_plain(a, b, h0):
    """Sequential f32 loop over time (``repro.kernels.ref.rglru_scan_ref``'s
    semantics): returns (h, h_last)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_bwd_plain(a, h, h0, dh, dh_last):
    """Sequential f32 reverse loop: the gradient (da, db, dh0) of
    ``rglru_scan_plain``'s (h, h_last) with respect to (a, b, h0), given
    the forward's states ``h`` and the output gradients ``dh`` (B, S, W)
    and ``dh_last`` (B, W)."""
    s = a.shape[1]
    g = dh_last.float()
    das, dbs = [], []
    for t in range(s - 1, -1, -1):
        if t + 1 < s:
            g = a[:, t + 1].float() * g
        g = g + dh[:, t].float()
        prev = h[:, t - 1].float() if t > 0 else h0.float()
        das.append(g * prev)
        dbs.append(g)
    da = torch.stack(das[::-1], dim=1)
    db = torch.stack(dbs[::-1], dim=1)
    return da, db, a[:, 0].float() * g


def chunk_len(batch: int, s: int, w: int, sms: int) -> int:
    """Steps per time chunk: ``_MAX_CHUNK`` (a CTA holds its chunk of a and
    b in shared memory: 32 steps x 128 channels x 8 B = 32 KB), or fewer
    where that leaves SMs without a CTA, down to ``_MIN_CHUNK``. Each chunk
    pays its look-back, so the longest chunk that fills the card is the
    fastest (``chip_smoke.py``'s scan sweep times 8, 16 and 32 steps)."""
    chains = batch * -(-w // _THREADS)
    chunks = max(-(-s // _MAX_CHUNK),
                 min(-(-s // _MIN_CHUNK), -(-sms // chains)))
    return -(-s // chunks)


def _state(dev, stream: int, ctas: int):
    """The persistent look-back state (ctl, flags) for ``ctas`` CTAs on this
    device and stream; grown (zeroed anew) when a launch needs more flags.

    Never made while the stream captures a CUDA graph: the zeroing would be
    recorded into that one graph and the tensors taken from its pool. A
    capture stream's state is made beforehand (``prepare_stream``, or an
    eager launch on that stream). A graph keeps the state it was captured
    with: a growth puts a new state in place for later launches and keeps
    the old one alive (``_RETIRED``) for the graphs that hold it. Every
    launch of a state, replayed or eager, leaves it as the next launch of
    that state expects (the epoch tags the flags), whatever their sizes."""
    key = (dev.index, stream)
    got = _STATE.get(key)
    if got is None or got[1].numel() < ctas:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"rglru_scan: the capturing stream has no look-back state "
                f"for {ctas} CTAs; prepare it before the capture "
                f"(prepare_stream, or an eager launch on that stream)")
        n = max(ctas, _MIN_FLAGS, 2 * got[1].numel() if got else 0)
        if got is not None:
            _RETIRED.append(got)
        got = _STATE[key] = (torch.zeros(3, dtype=torch.int32, device=dev),
                             torch.zeros(n, dtype=torch.int32, device=dev))
    return got


def prepare_stream(dev, stream) -> None:
    """Make ``stream``'s look-back state (for up to ``_MIN_FLAGS`` CTAs)
    before a CUDA graph is captured on it."""
    _state(torch.device(dev), stream.cuda_stream, 0)


def _lib():
    lib = build.load("rglru_scan")
    lib.rglru_scan_f32.argtypes = _ARGTYPES
    lib.rglru_scan_f32.restype = ctypes.c_int
    lib.rglru_scan_bwd_f32.argtypes = _BWD_ARGTYPES
    lib.rglru_scan_bwd_f32.restype = ctypes.c_int
    return lib


def _check(name, seqs: dict, lasts: dict):
    """f32 CUDA inputs: ``seqs`` (B, S, W) and ``lasts`` (B, W), B, S, W
    >= 1."""
    check_cuda_tensors(name, {**seqs, **lasts}, {})
    a = next(iter(seqs.values()))
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: {'/'.join({**seqs, **lasts})} must be "
                        f"float32 (got {a.dtype})")
    bsz, s, w = a.shape
    if any(t.shape != a.shape for t in seqs.values()) \
            or any(t.shape != (bsz, w) for t in lasts.values()) \
            or not (s and w and bsz):
        shapes = ", ".join(f"{k} {tuple(t.shape)}"
                           for k, t in {**seqs, **lasts}.items())
        raise ValueError(f"{name}: shapes {shapes} do not form (B,S,W)/"
                         f"(B,W) with B, S, W >= 1")


def _scratch(dev, bsz: int, s: int, w: int):
    """(chunk, the stream's look-back state, vals) of a launch over (B, S,
    W): the same for the forward and the reverse mode."""
    chunk = chunk_len(bsz, s, w,
                      torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    ctas = bsz * -(-w // _THREADS) * -(-s // chunk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ctl, flags = _state(dev, stream, ctas)
    vals = torch.empty(2 * ctas * _THREADS, dtype=torch.float32, device=dev)
    return chunk, stream, ctl, flags, vals


def _launch(a, b, h0):
    _check("rglru_scan", {"a": a, "b": b}, {"h0": h0})
    bsz, s, w = a.shape
    dev = a.device
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if is_fake(a):
        return traced("rglru_scan", (h, h_last))
    chunk, stream, ctl, flags, vals = _scratch(dev, bsz, s, w)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rglru_scan_f32(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                 h.data_ptr(), h_last.data_ptr(),
                                 ctl.data_ptr(), flags.data_ptr(),
                                 vals.data_ptr(), bsz, s, w, chunk, _GROUP,
                                 stream)
    raise_on_error("rglru_scan", err)
    LAUNCHES["rglru_scan"] += 1
    return h, h_last


def _launch_bwd(a, h, h0, dh, dh_last):
    _check("rglru_scan_bwd", {"a": a, "h": h, "dh": dh},
           {"h0": h0, "dh_last": dh_last})
    bsz, s, w = a.shape
    dev = a.device
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if is_fake(a):
        return traced("rglru_scan_bwd", (da, db, dh0))
    chunk, stream, ctl, flags, vals = _scratch(dev, bsz, s, w)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rglru_scan_bwd_f32(
            a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
            dh_last.data_ptr(), da.data_ptr(), db.data_ptr(), dh0.data_ptr(),
            ctl.data_ptr(), flags.data_ptr(), vals.data_ptr(), bsz, s, w,
            chunk, _GROUP, stream)
    raise_on_error("rglru_scan_bwd", err)
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db, dh0


def _forward(a, b, h0):
    """(h, h_last) on the inputs' device: the kernel for CUDA tensors, the
    plain loop for CPU tensors."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.is_cuda:
        return _launch(a.contiguous(), b.contiguous(), h0.contiguous())
    raise ValueError(f"rglru_scan: unsupported device {a.device}")


def rglru_scan_bwd(a, h, h0, dh, dh_last):
    """(da, db, dh0) of the scan: the kernel's reverse mode for CUDA
    tensors, the plain reverse loop for CPU tensors."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_plain(a, h, h0, dh, dh_last)
    if a.is_cuda:
        return _launch_bwd(*(t.contiguous() for t in (a, h, h0, dh,
                                                      dh_last)))
    raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with its gradient (see the module docstring). Saves
    a, h0 and the states h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _forward(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h0, h = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.float()
        dh_last = (torch.zeros_like(h0) if dh_last is None
                   else dh_last.float())
        return rglru_scan_bwd(a, h, h0, dh, dh_last)


def rglru_scan(a, b, h0):
    """Launch the CUDA kernel for CUDA tensors, run the plain version for
    CPU tensors; through ``RGLRUScan`` when a gradient is needed. a, b
    (B, S, W), h0 (B, W), all f32 -> (h, h_last)."""
    if a.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"rglru_scan: a must be (B, S, W) and h0 (B, W) "
                         f"(got {tuple(a.shape)}, {tuple(h0.shape)})")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        return RGLRUScan.apply(a, b, h0)
    return _forward(a, b, h0)
