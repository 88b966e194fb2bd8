"""Token sampling: greedy, and keyed sampling bit-exact to JAX's threefry.

Port of ``repro.serving.sampler`` together with the part of JAX's PRNG it
stands on: the ``threefry2x32`` key schedule (``PRNGKey``, ``fold_in``,
``split``), ``random_bits`` in the partitionable layout
(``jax_threefry_partitionable=True``), ``uniform``, ``gumbel`` in mode
"low" and ``categorical`` (Gumbel-max). A key is a ``(..., 2)`` int64
tensor holding two uint32 words; all 32-bit arithmetic runs in int64 and
is masked to 32 bits, the same on CPU and CUDA tensors. The bits and the
uniforms equal JAX's bit for bit; the Gumbel noise may differ from XLA's
by an ulp of ``log``, so a sampled token equals ``repro``'s wherever the
perturbed top-2 margin is wider than that.
"""
from __future__ import annotations

from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000                    # 1.0f
_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or int -> int64 tensor of its uint32 value (two's
    complement for negatives, as JAX's conversion to uint32 gives)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=device)
    return x.to(torch.int64) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds, key injection every 4):
    key (..., 2) and counter words x0, x1 broadcast together; returns the
    two output words as int64 tensors of uint32 values."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) words [0, seed mod 2**32] (JAX
    without x64 keeps the seed's low 32 bits)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter (0, data) under
    ``key``. ``data`` is an int or an integer tensor taken as uint32; key
    (..., 2) broadcasts against it. Returns (broadcast shape, 2)."""
    d = _u32(data, key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key (..., 2) -> (..., n, 2),
    key i being threefry of the counter (0, i)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits, partitionable layout: element e of
    ``shape`` (flat row-major index) is ``bits1 ^ bits2`` of threefry of the
    counter (e >> 32, e & 0xFFFFFFFF). key (..., 2) gives (..., *shape),
    one independent draw per leading key (``jax.vmap`` over keys)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    flat = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    kk = key.reshape(*lead, *([1] * len(shape)), 2)
    b1, b2 = threefry2x32(kk, (flat >> 32).reshape(shape),
                          (flat & _M32).reshape(shape))
    return b1 ^ b2


def _bits_to_unit(bits) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1. The word fits a positive int32, so the view
    is exact."""
    word = (bits >> 9) | _ONE_BITS
    return word.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: ``max(minval, u * (maxval - minval)
    + minval)`` with ``u`` from ``_bits_to_unit``. XLA fuses the scale and
    shift into one multiply-add, rounded once; the port computes them in
    f64, where the product of two f32 values is exact and so is the sum
    for bounds of comparable size, and rounds once to f32."""
    u = _bits_to_unit(random_bits(key, shape))
    # filled on the device: a host-to-device copy cannot be captured in a
    # CUDA graph, and the engine's decode graphs sample
    lo = torch.full((), minval, dtype=torch.float32, device=u.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=u.device)
    x = (u.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, x)


def gumbel(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in mode "low" (JAX's default), f32."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits) -> torch.Tensor:
    """``jax.random.categorical`` along the last axis (Gumbel-max). A (2,)
    key draws noise over the whole of ``logits`` (one draw for a batch); a
    (B, 2) key for (B, V) logits draws each row with its own key."""
    shape = logits.shape if key.dim() == 1 else logits.shape[-1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)


def _top_k_mask(logits, top_k: int):
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, -1e30), logits)
    return logits


def _scaled(logits, temperature, top_k: int):
    logits = _top_k_mask(logits.float(), top_k)
    return logits / torch.clamp(temperature, min=1e-6)[:, None]


def sample_logits(key, logits, *, temperature: float = 0.0,
                  top_k: int = 0) -> torch.Tensor:
    """One stream's sampling: logits (..., V) -> token ids, temperature 0
    = greedy (the key is not used)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _top_k_mask(logits.float(), top_k)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, other bits than JAX's division
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return categorical(key, logits / t).to(torch.int32)


def request_keys(base, request_ids, steps) -> torch.Tensor:
    """Per-row keys ``fold_in(fold_in(base, request_id), step)``: (B, 2).
    Sampling then is a pure function of the request and its decode depth,
    whatever it is batched with; K fused steps fold the carried steps, so
    they draw exactly the keys K single steps would."""
    return fold_in(fold_in(base, request_ids), steps)


def sample_logits_keyed(keys, logits, temperature, *,
                        top_k: int = 0) -> torch.Tensor:
    """Per-row keyed sampling: keys (B, 2), logits (B, V), temperature
    (B,) with 0 = greedy. Row b draws ``categorical(keys[b], logits[b] /
    T_b)``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = categorical(keys, _scaled(logits, temperature, top_k))
    return torch.where(temperature > 0.0, sampled.to(torch.int32), greedy)


def sample_logits_batch(key, logits, temperature, *,
                        top_k: int = 0) -> torch.Tensor:
    """Batched sampling with one key for the whole (B, V) draw and
    per-row temperature (0 = greedy), as ``repro``'s drain batcher
    samples."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = categorical(key, _scaled(logits, temperature, top_k))
    return torch.where(temperature > 0.0, sampled.to(torch.int32), greedy)


def accepted_prefix_length(proposed, target):
    """Longest agreeing prefix of (B, k) proposals and target samples:
    (B,) int32 in [0, k]."""
    match = (proposed == target).to(torch.int32)
    return torch.cumprod(match, dim=-1).sum(dim=-1).to(torch.int32)
