"""Full-sequence GQA flash attention (causal or windowed): the port's prefill.

Port of ``repro.kernels.flash_attention.flash_attention``. The kernel is
``csrc/flash_attention.cu``: one CTA per (batch, query tile, q head),
streaming softmax over the key tiles inside the causal/window band, on the
tensor cores in bf16 (16 query rows a warp, the query tile and key
groups chosen by ``flash_launch_shape``) and on the CUDA cores in f32
(16-query tiles).
``flash_attention_plain`` is the same function in plain PyTorch: the CPU
path and the kernel's reference.

Contract shared by both: q (B, Sq, H, hd), k, v (B, Sk, KV, hd) ->
(B, Sq, H, hd). Queries are right-aligned to keys (query i sits at
position i + Sk - Sq), query head h reads KV head h // (H / KV). Rows with
no visible key are 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (LAUNCHES, build, check_cuda_inputs,
                                 raise_on_error)

NEG_INF = -1e30

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_BF16_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                  + [ctypes.c_float, ctypes.c_void_p])
_WARPS = 4                  # per CTA of the bf16 kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_launch_shape(b: int, sq: int, h: int, hd: int, sms: int):
    """(query rows per CTA, key groups) of the bf16 kernel. A CTA has 4
    warps: row tiles of 16 query rows times groups that split each query
    tile's keys between them (merged in shared memory at the end). The
    most row tiles (64, 32, then 16 rows) whose grid of (B, query tiles, H)
    CTAs has at least one CTA per SM, else 16 rows: short prompts trade
    rows for groups and so halve or quarter their longest chain of key
    tiles. At most 2 groups above 64 dims (shared memory: two stages of
    groups x 64 keys, 32 above 128 dims)."""
    max_groups = 4 if hd <= 64 else 2
    for row_tiles in (4, 2, 1):
        if b * h * _cdiv(sq, 16 * row_tiles) >= sms:
            break
    return 16 * row_tiles, min(_WARPS // row_tiles, max_groups)


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
             device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > (qpos - window)
    return valid


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense f32 version (``repro.kernels.ref.flash_attention_ref``'s
    arithmetic), with rows that see no key pinned to 0."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, kv, g, hd).float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * scale
    valid = _visible(sq, sk, causal, window, q.device)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1) * valid.any(dim=-1)[:, None]
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _lib():
    lib = build.load("flash_attention")
    for fn, args in ((lib.flash_attention_bf16, _BF16_ARGTYPES),
                     (lib.flash_attention_f32, _ARGTYPES)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, causal: bool, window: Optional[int], scale: float):
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if q.data_ptr() % 16:       # the kernel stages q by 16-byte copies
        q = q.clone()
    check_cuda_inputs("flash_attention", {"q": q, "k": k, "v": v}, {}, hd)
    if k.shape != (b, sk, kv, hd) or v.shape != k.shape or h % kv:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
            f", v {tuple(v.shape)} do not form (B,Sq,H,hd)/(B,Sk,KV,hd)")
    out = torch.empty_like(q)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    lib = _lib()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kv, hd, int(causal), window if window is not None else 0]
    if q.dtype == torch.bfloat16:
        fn = lib.flash_attention_bf16
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        args += flash_launch_shape(b, sq, h, hd, sms)
    else:
        fn = lib.flash_attention_f32
    with torch.cuda.device(q.device):
        err = fn(*args, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel for CUDA tensors, run the plain version for
    CPU tensors."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None (got {window})")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.is_cuda:
        return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal, window, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
