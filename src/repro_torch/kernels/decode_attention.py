"""Cached GQA attention of a T-token chunk against a per-slot ring cache
or a paged block pool.

Port of ``repro.kernels.decode_attention.decode_attention`` and
``paged_decode_attention``. The kernels are ``csrc/decode_attention.cu``
and ``csrc/paged_decode_attention.cu`` (one CTA per (slot, KV head, key
split) folding the T x G query rows of that KV head; streaming softmax
over key tiles; keys and tiles no row may see are not read; the splits are
combined by log-sum-exp in a second kernel). The paged kernel differs only
in where key j lives: token j % bs of pool block ``block_tables[b, j //
bs]``. Both run bf16 on the tensor cores, each with its split rule
(``ring_split_len``, ``paged_split_len``); their f32 variants run the
scalar body with ``split_len``. ``decode_attention_plain`` and
``paged_decode_attention_plain`` are the same functions in plain PyTorch:
the CPU path and the kernels' references.

Ring contract: q (B, T, H, hd) or (B, H, hd) (T = 1); k, v (B, W, KV, hd);
q_pos (B,) chunk start positions (token i sits at start + i) or (B, T)
per-token positions; k_pos (B, W) int32 with -1 = empty slot. A key is
visible to a query iff 0 <= k_pos <= q_pos (and k_pos > q_pos - window).
Rows with no visible key are 0. Paged contract: the same, with k, v the
pool (N, bs, KV, hd), k_pos (N, bs) and block_tables (B, M) int32 (-1 = a
hole: no key). ``kv_range=(first, count)`` attends only KV heads first ..
first + count - 1 of the KV in k, v (H / count query heads each), read in
place: a tensor-parallel rank whose query heads share KV heads that every
rank keeps whole (``sharding.TensorParallel.kv_range``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (FLOPS, LAUNCHES, build, check_cuda_inputs,
                                 is_fake, misaligned, raise_on_error, traced)

NEG_INF = -1e30

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
_TILE_K = 32          # keys per tile in the scalar body
_ROWS_PER_CTA = 64    # query rows per CTA in either body
_SPLIT_MIN_KEYS = 256  # keys a split of a bf16 decode kernel walks at least
_SPLIT_MAX_KEYS = 2048  # and at most: it stages their positions (12 B each)


def query_positions(q_pos, t: int) -> torch.Tensor:
    """(B,) chunk starts -> (B, T) per-token positions (a view at T = 1);
    (B, T) as-is."""
    qp = q_pos.to(torch.int32)
    if qp.dim() == 1:
        qp = qp[:, None]
        if t > 1:
            qp = qp + torch.arange(t, dtype=torch.int32,
                                   device=qp.device)[None, :]
    return qp


def _visible(k_pos, qp, window: Optional[int]) -> torch.Tensor:
    """(B, T, W) key visibility for per-token query positions qp (B, T)."""
    kp = k_pos[:, None, :]
    valid = (kp >= 0) & (kp <= qp[:, :, None])
    if window is not None:
        valid &= kp > (qp[:, :, None] - window)
    return valid


def _kv_heads(k, v, kv_range):
    """The K/V heads a call attends (views)."""
    if kv_range is None:
        return k, v
    first, count = kv_range
    return k[..., first:first + count, :], v[..., first:first + count, :]


def decode_attention_flops(b: int, t: int, h: int, w: int, hd: int) -> int:
    """The matrix-product FLOPs of the plain version (ring or paged, W the
    keys it attends over: the ring's width, or M * bs gathered blocks): Q
    K^T and P V over every key, visible or not."""
    return 4 * b * t * h * w * hd


def decode_attention_plain(q, k, v, q_pos, k_pos, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           kv_range=None) -> torch.Tensor:
    """Dense f32 version (``repro.kernels.ref.decode_attention_ref``'s
    arithmetic), with rows that see no key pinned to 0 as the kernel
    writes them. q: (B, T, H, hd)."""
    k, v = _kv_heads(k, v, kv_range)
    b, t, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qp = query_positions(q_pos, t)
    qg = q.reshape(b, t, kv, g, hd).float()
    s = torch.einsum("btkgd,bckd->btkgc", qg, k.float()) * scale
    valid = _visible(k_pos, qp, window)                  # (B, T, W)
    s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p * valid.any(dim=-1)[:, :, None, None, None]
    o = torch.einsum("btkgc,bckd->btkgd", p, v.float())
    return o.reshape(b, t, h, hd).to(q.dtype)


def _lib():
    lib = build.load("decode_attention")
    for fn in (lib.decode_attention_bf16, lib.decode_attention_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_len(b: int, t: int, h: int, kv: int, w: int, sms: int) -> int:
    """Keys per split of the scalar body (the f32 ring and paged kernels):
    enough splits that the grid has ~4 CTAs per SM, each split a whole
    number of 32-key tiles."""
    ctas = b * kv * _cdiv(t * (h // kv), _ROWS_PER_CTA)
    splits = max(1, min(_cdiv(w, _TILE_K), _cdiv(4 * sms, ctas)))
    return _cdiv(_cdiv(w, splits), _TILE_K) * _TILE_K


def ring_tile_k(hd: int) -> int:
    """Keys per warp tile of the bf16 ring kernel: 32, or 16 above hd 128
    (a stage of four warp tiles then fits twice in shared memory)."""
    return 32 if hd <= 128 else 16


def ring_split_len(b: int, t: int, h: int, kv: int, w: int, hd: int,
                   sms: int) -> int:
    """Keys per split of the bf16 ring kernel: each split walks at least
    ``_SPLIT_MIN_KEYS`` keys (two stages of four warp tiles at hd <= 128,
    four above) where W has them, so a CTA streams several stages with the
    next one in flight, and the grid of (B * KV, row tiles, splits) CTAs
    stays within two waves of ``sms``; at most ``_SPLIT_MAX_KEYS`` keys
    (the CTA stages their positions in shared memory); a whole number of
    warp tiles."""
    kt = ring_tile_k(hd)
    ctas = b * kv * _cdiv(t * (h // kv), _ROWS_PER_CTA)
    tiles = _cdiv(w, kt)
    splits = max(1, min(_cdiv(tiles, _cdiv(_SPLIT_MIN_KEYS, kt)),
                        2 * sms // ctas), _cdiv(w, _SPLIT_MAX_KEYS))
    return _cdiv(tiles, splits) * kt


def paged_split_len(b: int, t: int, h: int, kv: int, m: int, bs: int,
                    hd: int, sms: int) -> int:
    """Keys per split of the bf16 paged kernel over the logical key axis of
    a (B, M) table of ``bs``-token blocks: ``ring_split_len``'s rule (at
    least 256 keys where M * bs has them, at most two waves, at most 2048
    staged keys, whole warp tiles) at W = M * bs. That axis counts the
    table's trailing holes, which cost a CTA one table read a key and no
    K/V. A split need not align with pool blocks: the CTA stages each key's
    offset, so a warp tile may span several blocks."""
    return ring_split_len(b, t, h, kv, m * bs, hd, sms)


def _split_scratch(q, w: int, chunk: int):
    """The f32 partials that the ``ceil(w / chunk)`` splits of a ``w``-key
    axis write for the combine kernel: (m_part, l_part, acc_part)."""
    b, t, h, hd = q.shape
    nsplit = _cdiv(w, chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b * t * h, nsplit), **f32),
            torch.empty((b * t * h, nsplit), **f32),
            torch.empty((b * t * h, nsplit, hd), **f32))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, k, v, qp, kp, window: Optional[int], scale: float,
            kv_range=None):
    b, t, h, hd = q.shape
    w, row = k.shape[1], k.shape[2]
    kv0, kv = (0, row) if kv_range is None else kv_range
    check_cuda_inputs("decode_attention", {"q": q, "k": k, "v": v},
                      {"q_pos": qp, "k_pos": kp}, hd)
    if misaligned(q):       # the bf16 kernel stages q by 16-byte copies
        q = q.clone()
    if k.shape != (b, w, row, hd) or v.shape != k.shape or h % kv \
            or not 0 <= kv0 < kv0 + kv <= row \
            or qp.shape != (b, t) or kp.shape != (b, w):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
            f", v {tuple(v.shape)}, q_pos {tuple(qp.shape)}, k_pos "
            f"{tuple(kp.shape)}, kv_range {kv_range} do not form a "
            f"(B,T,H,hd)/(B,W,KV,hd) ring")
    out = torch.empty_like(q)
    if out.numel() == 0 or w == 0:
        return out.zero_()
    if is_fake(q):
        return traced("decode_attention", out,
                      decode_attention_flops(b, t, h, w, hd))
    lib = _lib()
    if q.dtype == torch.bfloat16:
        fn = lib.decode_attention_bf16
        chunk = ring_split_len(b, t, h, kv, w, hd, _sms(q.device))
    else:
        fn = lib.decode_attention_f32
        chunk = split_len(b, t, h, kv, w, _sms(q.device))
    m_part, l_part, acc_part = _split_scratch(q, w, chunk)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), out.data_ptr(), m_part.data_ptr(),
                 l_part.data_ptr(), acc_part.data_ptr(), b, t, h, kv, row,
                 kv0, w, hd, chunk, window if window is not None else 0,
                 scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    FLOPS["decode_attention"] += decode_attention_flops(b, t, h, w, hd)
    return out


def decode_attention(q, k, v, q_pos, k_pos, *, window: Optional[int] = None,
                     scale: Optional[float] = None,
                     kv_range=None) -> torch.Tensor:
    """Launch the CUDA kernel for CUDA tensors, run the plain version for
    CPU tensors. Returns attention output shaped like q."""
    no_time = q.dim() == 3
    if no_time:
        q = q[:, None]
    t, hd = q.shape[1], q.shape[3]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None (got {window})")
    scale = scale if scale is not None else hd ** -0.5
    qp = query_positions(q_pos, t)
    if q.device.type == "cpu":
        out = decode_attention_plain(q, k, v, qp, k_pos, window=window,
                                     scale=scale, kv_range=kv_range)
    elif q.is_cuda:
        out = _launch(q.contiguous(), k, v, qp.contiguous(),
                      k_pos.contiguous(), window, scale, kv_range)
    else:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return out[:, 0] if no_time else out


# -- paged pool ----------------------------------------------------------------

def gather_paged_kv(pool, pos, block_tables):
    """Flatten a paged pool into per-slot contiguous context
    (``repro.kernels.ref.gather_paged_kv``). pool (N, bs, ...), pos (N, bs),
    block_tables (B, M) (-1 = hole) -> (ctx (B, M*bs, ...), ctx_pos
    (B, M*bs)); a hole's tokens carry position -1."""
    bt = block_tables.long()
    b, m = bt.shape
    bs = pool.shape[1]
    safe = bt.clamp(min=0)
    ctx = pool[safe].reshape((b, m * bs) + tuple(pool.shape[2:]))
    ctx_pos = torch.where(bt[:, :, None] >= 0, pos[safe],
                          torch.full_like(pos[safe], -1))
    return ctx, ctx_pos.reshape(b, m * bs)


def paged_decode_attention_plain(q, k, v, q_pos, k_pos, block_tables, *,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None,
                                 kv_range=None) -> torch.Tensor:
    """``repro.kernels.ref.paged_decode_attention_ref``'s arithmetic: gather
    each slot's blocks, then the ring plain version (a row that sees no key
    is 0). q: (B, T, H, hd)."""
    k, v = _kv_heads(k, v, kv_range)
    kc, pc = gather_paged_kv(k, k_pos, block_tables)
    vc, _ = gather_paged_kv(v, k_pos, block_tables)
    return decode_attention_plain(q, kc, vc, q_pos, pc, window=window,
                                  scale=scale)


def _paged_lib():
    lib = build.load("paged_decode_attention")
    for fn in (lib.paged_decode_attention_bf16,
               lib.paged_decode_attention_f32):
        fn.argtypes = _PAGED_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch_paged(q, k, v, qp, kp, bt, window: Optional[int], scale: float,
                  kv_range=None):
    b, t, h, hd = q.shape
    n, bs, row = k.shape[0], k.shape[1], k.shape[2]
    kv0, kv = (0, row) if kv_range is None else kv_range
    m = bt.shape[-1]
    check_cuda_inputs("paged_decode_attention", {"q": q, "k": k, "v": v},
                      {"q_pos": qp, "k_pos": kp, "block_tables": bt}, hd)
    if k.shape != (n, bs, row, hd) or v.shape != k.shape or h % kv \
            or not 0 <= kv0 < kv0 + kv <= row \
            or qp.shape != (b, t) or kp.shape != (n, bs) \
            or bt.shape != (b, m):
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, q_pos {tuple(qp.shape)}"
            f", k_pos {tuple(kp.shape)}, block_tables {tuple(bt.shape)}, "
            f"kv_range {kv_range} do not form (B,T,H,hd)/(N,bs,KV,hd)/(B,M)")
    if misaligned(q):       # the bf16 kernel stages q by 16-byte copies
        q = q.clone()
    out = torch.empty_like(q)
    if out.numel() == 0 or m * bs == 0:
        return out.zero_()
    if is_fake(q):
        return traced("paged_decode_attention", out,
                      decode_attention_flops(b, t, h, m * bs, hd))
    lib = _paged_lib()
    if q.dtype == torch.bfloat16:
        fn = lib.paged_decode_attention_bf16
        chunk = paged_split_len(b, t, h, kv, m, bs, hd, _sms(q.device))
    else:
        fn = lib.paged_decode_attention_f32
        chunk = split_len(b, t, h, kv, m * bs, _sms(q.device))
    m_part, l_part, acc_part = _split_scratch(q, m * bs, chunk)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), bt.data_ptr(), out.data_ptr(),
                 m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                 b, t, h, kv, row, kv0, bs, m, hd, chunk,
                 window if window is not None else 0, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("paged_decode_attention", err)
    LAUNCHES["paged_decode_attention"] += 1
    FLOPS["paged_decode_attention"] += decode_attention_flops(b, t, h,
                                                              m * bs, hd)
    return out


def paged_decode_attention(q, k, v, q_pos, k_pos, block_tables, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           kv_range=None) -> torch.Tensor:
    """Launch the paged CUDA kernel for CUDA tensors, run the plain version
    for CPU tensors. Returns attention output shaped like q."""
    no_time = q.dim() == 3
    if no_time:
        q = q[:, None]
    t, hd = q.shape[1], q.shape[3]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None (got {window})")
    scale = scale if scale is not None else hd ** -0.5
    qp = query_positions(q_pos, t)
    if q.device.type == "cpu":
        out = paged_decode_attention_plain(q, k, v, qp, k_pos, block_tables,
                                           window=window, scale=scale,
                                           kv_range=kv_range)
    elif q.is_cuda:
        out = _launch_paged(q.contiguous(), k, v, qp.contiguous(),
                            k_pos.contiguous(), block_tables.contiguous(),
                            window, scale, kv_range)
    else:
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    return out[:, 0] if no_time else out
