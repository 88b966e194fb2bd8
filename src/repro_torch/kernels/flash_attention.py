"""Full-sequence GQA flash attention (causal or windowed): the port's prefill.

Port of ``repro.kernels.flash_attention.flash_attention``. The kernel is
``csrc/flash_attention.cu``: one CTA per (batch, query tile, q head),
streaming softmax over the key tiles inside the causal/window band, on the
tensor cores in bf16 (16 query rows a warp, the query tile and key
groups chosen by ``flash_launch_shape``) and on the CUDA cores in f32
(16-query tiles).
``flash_attention_plain`` is the same function in plain PyTorch: the CPU
path and the kernel's reference.

Training: when grad is enabled and an input requires it,
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``). Its forward launches the same kernel with an
f32 log-sum-exp output (B, Sq, H); its backward launches
``csrc/flash_attention_bwd.cu`` (dq, dk, dv; bf16 on the tensor cores,
f32 on the CUDA cores; ``LAUNCHES["flash_attention_bwd"]``, one a
backward). On CPU tensors both run their plain versions,
``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``, the
arithmetic of ``repro``'s ``_flash_bwd`` (the custom VJP of
``repro.models.attention.blockwise_attention``). Serving never asks for a
gradient and so never writes the log-sum-exp.

Contract shared by both: q (B, Sq, H, hd), k, v (B, Sk, KV, hd) ->
(B, Sq, H, hd). Queries are right-aligned to keys (query i sits at
position i + Sk - Sq), query head h reads KV head h // (H / KV). Rows with
no visible key are 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (FLOPS, LAUNCHES, build, check_cuda_inputs,
                                 is_fake, misaligned, raise_on_error, traced)

NEG_INF = -1e30

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_BF16_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                  + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
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


def flash_attention_flops(b: int, sq: int, sk: int, h: int,
                          hd: int) -> int:
    """The matrix-product FLOPs of the plain forward (with or without its
    log-sum-exp): Q K^T and P V over the whole (Sq, Sk) rectangle."""
    return 4 * b * sq * sk * h * hd


def flash_attention_bwd_flops(b: int, sq: int, sk: int, h: int,
                              hd: int) -> int:
    """The matrix-product FLOPs of the plain backward: Q K^T recomputed,
    then dV, dP, dQ and dK, each over the whole (Sq, Sk) rectangle."""
    return 10 * b * sq * sk * h * hd


def _plain_forward(q, k, v, causal: bool, window: Optional[int],
                   scale: Optional[float]):
    """The dense f32 forward: the output, the scaled scores (B, KV, G, Sq,
    Sk) and the (Sq, Sk) mask of valid pairs."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, kv, g, hd).float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * scale
    valid = _visible(sq, sk, causal, window, q.device)
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1) \
        * valid.any(dim=-1)[:, None]
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype), s, valid


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense f32 version (``repro.kernels.ref.flash_attention_ref``'s
    arithmetic), with rows that see no key pinned to 0."""
    return _plain_forward(q, k, v, causal, window, scale)[0]


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None):
    """``flash_attention_plain``'s output and the rows' f32 log-sum-exp
    (B, Sq, H) of the scaled scores over their valid keys, -inf for a row
    with no valid key; the scores are computed once for both."""
    b, sq, h, _ = q.shape
    out, s, valid = _plain_forward(q, k, v, causal, window, scale)
    lse = torch.logsumexp(s.masked_fill(~valid, -torch.inf), dim=-1)
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None):
    """Dense f32 gradient (dq, dk, dv) of ``flash_attention`` from its
    output and log-sum-exp: ``repro``'s ``_flash_bwd`` arithmetic. D =
    rowsum(dout * out), P = exp(s * scale - lse) on valid pairs (0
    elsewhere), dv = P^T dout, dS = P (dout v^T - D) scale, dq = dS k,
    dk = dS^T q; each cast to its input's dtype."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, kv, g, hd).float()
    dog = dout.reshape(b, sq, kv, g, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kf) * scale
    valid = _visible(sq, sk, causal, window, q.device)[:, None, None, :]
    lse_g = lse.reshape(b, sq, kv, g, 1).float()
    p = torch.exp(torch.where(valid, s - lse_g, -torch.inf))
    delta = (dog * out.reshape(b, sq, kv, g, hd).float()).sum(-1)
    dv = torch.einsum("bqkgc,bqkgd->bckd", p, dog)
    dp = torch.einsum("bqkgd,bckd->bqkgc", dog, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqkgc,bckd->bqkgd", ds, kf).reshape(b, sq, h, hd)
    dk = torch.einsum("bqkgc,bqkgd->bckd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = build.load("flash_attention")
    for fn, args in ((lib.flash_attention_bf16, _BF16_ARGTYPES),
                     (lib.flash_attention_f32, _ARGTYPES)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    for fn in (lib.flash_attention_bwd_bf16, lib.flash_attention_bwd_f32):
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_shapes(name, q, k, v):
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, hd) or v.shape != k.shape or h % kv:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not form (B,Sq,H,hd)/(B,Sk,KV,hd)")


def _launch(q, k, v, causal: bool, window: Optional[int], scale: float,
            with_lse: bool = False):
    """The forward kernel: out, and with ``with_lse`` (out, lse)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if misaligned(q):           # the kernel stages q by 16-byte copies
        q = q.clone()
    check_cuda_inputs("flash_attention", {"q": q, "k": k, "v": v}, {}, hd)
    _check_shapes("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or sk == 0:
        out.zero_()
        return (out, lse.fill_(-torch.inf)) if with_lse else out
    if is_fake(q):
        return traced("flash_attention", (out, lse) if with_lse else out,
                      flash_attention_flops(b, sq, sk, h, hd))
    lib = _lib()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, sq, sk, h, kv, hd,
            int(causal), window if window is not None else 0]
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
    FLOPS["flash_attention"] += flash_attention_flops(b, sq, sk, h, hd)
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, out, lse, dout, causal: bool,
                window: Optional[int], scale: float):
    """The backward kernels (dq, then dk and dv) as one launch."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    # the tensor-core variant stages q, out and dout by 16-byte copies
    q, out, dout = (t.clone() if misaligned(t) else t
                    for t in (q, out, dout))
    check_cuda_inputs("flash_attention_bwd",
                      {"q": q, "k": k, "v": v, "out": out, "dout": dout}, {},
                      hd)
    _check_shapes("flash_attention_bwd", q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, sq, h) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: out and dout must be shaped "
                         "like q, lse a contiguous f32 (B, Sq, H) on its "
                         "device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if is_fake(q):
        return traced("flash_attention_bwd", (dq, dk, dv),
                      flash_attention_bwd_flops(b, sq, sk, h, hd))
    delta = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    fn = (lib.flash_attention_bwd_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_bwd_f32)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
                 kv, hd, int(causal), window if window is not None else 0,
                 scale, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("flash_attention_bwd", err)
    LAUNCHES["flash_attention_bwd"] += 1
    FLOPS["flash_attention_bwd"] += flash_attention_bwd_flops(b, sq, sk, h,
                                                              hd)
    return dq, dk, dv


def _forward(q, k, v, causal: bool, window: Optional[int], scale: float,
             with_lse: bool = False):
    """The forward on the inputs' device: the kernel for CUDA tensors, the
    plain version for CPU tensors; out, or (out, lse) with
    ``with_lse``."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window, scale=scale)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.is_cuda:
        return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal, window, scale, with_lse=with_lse)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """(dq, dk, dv) from the forward's out and lse: the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         scale=scale)
    if q.is_cuda:
        return _launch_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           out.contiguous(), lse.contiguous(),
                           dout.contiguous(), causal, window, scale)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel with the
    log-sum-exp, the backward kernels (CUDA), or both plain versions
    (CPU). Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.to(q.dtype), causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel for CUDA tensors, run the plain version for
    CPU tensors; through ``FlashAttention`` when a gradient is needed."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None (got {window})")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)
