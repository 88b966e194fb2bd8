"""Token sampling: greedy, and keyed sampling that is a pure function of
(seed, request id, step).

Port of ``repro.serving.sampler``. Greedy is the same argmax. Keyed
sampling draws Gumbel noise from a counter-based hash of (seed, request id,
step, vocab index) computed on the device, so a request's stream does not
depend on its neighbours in the batch, and K fused decode steps consume
exactly the noise K single steps would. The bits differ from JAX's
threefry: sampled streams are compared within the port, not across.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, in
    16-bit halves so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """murmur3's 32-bit finalizer (a bijection with full avalanche)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def request_keys(seed: int, request_ids, steps):
    """Per-row 32-bit keys from (seed, request_id, step): (B,) int64."""
    k = _mix32(torch.full_like(request_ids, seed & _M32, dtype=torch.int64)
               ^ 0x9E3779B9)
    k = _mix32(k ^ (request_ids.to(torch.int64) & _M32))
    return _mix32(k ^ _mix32(steps.to(torch.int64) & _M32))


def _uniform(keys, n: int):
    """(B, n) uniforms in (0, 1) from per-row keys and column indices."""
    col = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    h = _mix32(_mix32(keys[:, None] ^ _mul32(col, 0x27D4EB2F)) ^ 0x165667B1)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_logits_keyed(keys, logits, temperature):
    """Per-row keyed sampling (see ``request_keys``). logits (B, V);
    temperature (B,) with 0 = greedy. Gumbel-max: argmax(logits / T + g)
    with g = -log(-log(u))."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    gumbel = -torch.log(-torch.log(_uniform(keys, logits.shape[-1])))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def accepted_prefix_length(proposed, target):
    """Longest agreeing prefix of (B, k) proposals and target samples:
    (B,) int32 in [0, k]."""
    match = (proposed == target).to(torch.int32)
    return torch.cumprod(match, dim=-1).sum(dim=-1).to(torch.int32)
