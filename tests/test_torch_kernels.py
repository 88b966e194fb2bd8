"""The port's attention kernels against ``repro``'s Pallas kernels.

On the CPU the port's wrappers run their plain versions; those are held
against ``repro.kernels.ref`` on every case below and against ``repro``'s
Pallas kernels in interpret mode on the cases marked ``PALLAS`` (one call
costs about a second on the CPU; ``repro``'s own tests already hold the
Pallas kernels to the same oracle on every case), all on the same numpy
inputs. ``tests/test_torch_gpu.py`` holds the CUDA kernels against the
plain versions on the card.

Tolerances: f32 1e-4, as ``tests/test_decode_attention.py`` holds the
Pallas kernel to its oracle (streaming vs dense softmax sum in another
order); bf16 2e-2 (bf16 output rounding, and the Pallas kernel rounds P to
bf16 where the plain version keeps it in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as _pallas_decode)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as _pallas_flash)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

# jitted once per shape: eager jnp compiles every op on first use
pallas_decode = jax.jit(_pallas_decode, static_argnames=(
    "window", "scale", "block_k", "interpret"))
pallas_flash = jax.jit(_pallas_flash, static_argnames=(
    "causal", "window", "scale", "block_q", "block_k", "interpret"))
decode_ref = jax.jit(ref.decode_attention_ref,
                     static_argnames=("window", "scale"))
flash_ref = jax.jit(ref.flash_attention_ref,
                    static_argnames=("causal", "window", "scale"))

# (b, w, h, kv, hd, window, filled, total_pos, t): the decode cases of
# tests/test_decode_attention.py (t = 1) plus chunk queries (t > 1)
DECODE_CASES = [
    (1, 64, 4, 4, 32, None, 64, 64, 1),       # full cache, MHA
    (2, 96, 4, 2, 32, None, 96, 96, 1),       # GQA g=2
    (1, 96, 3, 1, 32, None, 96, 96, 1),       # MQA
    (2, 64, 4, 4, 32, 24, 64, 64, 1),         # sliding window
    (2, 96, 8, 2, 64, 16, 96, 96, 1),         # window + GQA g=4
    (1, 100, 4, 2, 16, None, 100, 100, 1),    # ragged width
    (2, 64, 4, 2, 32, None, 40, 40, 1),       # partially-empty cache
    (2, 64, 4, 2, 32, None, 64, 130, 1),      # ring-wrapped cache
    (1, 48, 4, 2, 32, 24, 48, 130, 1),        # ring-wrapped + window
    (2, 64, 4, 2, 32, None, 40, 40, 8),       # chunk mid-prefill
    (2, 64, 8, 2, 64, 16, 48, 48, 8),         # chunk + window + g=4
    (1, 96, 3, 1, 32, None, 70, 70, 16),      # MQA, bigger chunk
]


def _ring_np(seed, b, w, h, kv, hd, filled, total_pos, t):
    """A ring as the engine leaves it: positions [total-filled, total) at
    slot pos % w, the rest empty; a t-token chunk ending at total-1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, w, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, kv, hd)).astype(np.float32)
    tok = np.arange(total_pos - filled, total_pos)
    k_pos = np.full((b, w), -1, np.int32)
    k_pos[:, tok % w] = tok
    start = total_pos if t == 1 else total_pos - t
    q_pos = np.full((b,), start, np.int32)
    return q, k, v, q_pos, k_pos


def _any_visible(q_pos, k_pos, t, window):
    qp = q_pos[:, None] + np.arange(t)[None, :]
    kp = k_pos[:, None, :]
    ok = (kp >= 0) & (kp <= qp[:, :, None])
    if window is not None:
        ok &= kp > qp[:, :, None] - window
    return ok.any(-1)                                   # (B, T)


def _decode_case(case):
    b, w, h, kv, hd, window, filled, total_pos, t = case
    q, k, v, q_pos, k_pos = _ring_np(0, b, w, h, kv, hd, filled, total_pos, t)
    ours = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(q_pos),
                            torch.from_numpy(k_pos), window=window).numpy()
    rows = _any_visible(q_pos, k_pos, t, window)        # compare these only
    assert rows.any()
    return ours, tuple(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), rows


@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_plain_matches_oracle(case):
    ours, args, rows = _decode_case(case)
    oracle = np.asarray(decode_ref(*args, window=case[5]))
    assert np.max(np.abs(ours - oracle)[rows]) < 1e-4


DECODE_PALLAS = [DECODE_CASES[5], DECODE_CASES[8], DECODE_CASES[10]]


@pytest.mark.parametrize("case", DECODE_PALLAS, ids=[str(c) for c in DECODE_PALLAS])
def test_decode_plain_matches_pallas_interpret(case):
    ours, args, rows = _decode_case(case)
    pallas = np.asarray(pallas_decode(*args, window=case[5], block_k=32,
                                      interpret=True))
    assert np.max(np.abs(ours - pallas)[rows]) < 1e-4


def test_decode_plain_explicit_positions_and_empty_rows():
    """(B, T) per-token positions are honored, and a slot with an empty
    ring outputs exactly 0 (the kernel's contract; the dense oracle
    returns the mean of V there)."""
    b, w, h, kv, hd, t = 3, 64, 4, 2, 32, 4
    q, k, v, _, k_pos = _ring_np(1, b, w, h, kv, hd, 50, 50, t)
    k_pos[2] = -1
    q_pos = np.asarray([[10, 11, 12, 13], [40, 41, 42, 43], [5, 6, 7, 8]],
                       np.int32)
    ours = decode_attention(*(torch.from_numpy(a) for a in
                              (q, k, v, q_pos, k_pos))).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos))
    pallas = np.asarray(pallas_decode(*args, block_k=32, interpret=True))
    assert np.max(np.abs(ours[:2] - pallas[:2])) < 1e-4
    assert not ours[2].any()


def test_decode_bf16_matches_pallas():
    q, k, v, q_pos, k_pos = _ring_np(2, 2, 64, 4, 2, 32, 64, 64, 1)
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    ours = decode_attention(*tq, torch.from_numpy(q_pos),
                            torch.from_numpy(k_pos))
    assert ours.dtype == torch.bfloat16
    jq = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in tq]
    pallas = pallas_decode(*jq, jnp.asarray(q_pos), jnp.asarray(k_pos),
                           block_k=32, interpret=True)
    diff = np.abs(ours.float().numpy()
                  - np.asarray(pallas.astype(jnp.float32)))
    assert diff.max() < 2e-2


# (b, sq, sk, h, kv, hd, window, bf16): cases of tests/test_kernels.py
FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, None, False),
    (2, 64, 64, 4, 2, 64, None, False),
    (1, 100, 100, 3, 1, 32, None, False),     # MQA, ragged seq
    (2, 64, 64, 4, 4, 32, 24, False),         # sliding window
    (1, 1, 96, 4, 2, 32, None, False),        # decode shape (right-aligned)
    (1, 1, 96, 4, 2, 32, 16, False),          # windowed decode
    (1, 48, 48, 2, 2, 128, None, True),       # bf16
]


def _flash_case(case):
    b, sq, sk, h, kv, hd, window, bf16 = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32,
                                                            jnp.float32)
    ours = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           window=window).float().numpy()
    jargs = tuple(jnp.asarray(a).astype(jdt) for a in (q, k, v))
    return ours, jargs, (2e-2 if bf16 else 1e-4)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_plain_matches_oracle(case):
    ours, jargs, tol = _flash_case(case)
    oracle = np.asarray(flash_ref(*jargs, window=case[6])
                        .astype(jnp.float32))
    assert np.max(np.abs(ours - oracle)) < tol


FLASH_PALLAS = [FLASH_CASES[3], FLASH_CASES[5], FLASH_CASES[6]]


@pytest.mark.parametrize("case", FLASH_PALLAS, ids=[str(c) for c in FLASH_PALLAS])
def test_flash_plain_matches_pallas_interpret(case):
    ours, jargs, tol = _flash_case(case)
    pallas = np.asarray(pallas_flash(*jargs, window=case[6], block_q=32,
                                     block_k=32, interpret=True)
                        .astype(jnp.float32))
    assert np.max(np.abs(ours - pallas)) < tol


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    before = dict(LAUNCHES)
    q, k, v, q_pos, k_pos = _ring_np(4, 1, 32, 2, 1, 16, 20, 20, 1)
    tq = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    assert torch.equal(decode_attention(*tq), decode_attention_plain(*tq))
    x = torch.randn(1, 16, 2, 16)
    y = torch.randn(1, 16, 1, 16)
    assert torch.equal(flash_attention(x, y, y),
                       flash_attention_plain(x, y, y))
    assert LAUNCHES == before


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 1, 2, 16), device="meta")
    kv = torch.empty((1, 8, 1, 16), device="meta")
    pos = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(meta, kv, kv, torch.zeros((1,), dtype=torch.int32,
                                                   device="meta"), pos)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(meta, kv, kv)
