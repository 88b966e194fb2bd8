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

The launch rules of the bf16 kernels (the ring kernel's key splits, flash's
query tile and key groups) and the gate's vocab splits are plain
functions, held here to what the kernels need from them; a plain model of
the gate kernel's rank-order merge over its splits is held against the
f64 value of the same formula (1e-6 relative) and against the gate's
plain version (1e-6 relative on f32 logits, 2e-6 on bf16 logits, where the
plain version's softmax is itself up to 1.2e-6 off the f64 value).
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
    decode_attention, decode_attention_plain, paged_split_len,
    query_positions, ring_split_len, ring_tile_k)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain, flash_launch_shape)
from repro_torch.kernels.cascade_gate import (  # noqa: E402
    cascade_gate_plain, gate_splits)
from repro_torch.kernels.rglru_scan import chunk_len  # noqa: E402

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


# -- launch rules of the bf16 kernels --------------------------------------------

H100_SMS = 132

# (b, t, h, kv, w, hd): smollm's decode (hd 64) and chunk, recurrentgemma's
# local attention (hd 256), a ring shorter than one split, a long ring, a
# grid already past two waves, a ragged width
RING_SPLIT_CASES = [
    (8, 1, 9, 3, 1024, 64), (8, 16, 9, 3, 1024, 64),
    (8, 1, 16, 1, 2048, 256), (2, 1, 4, 2, 40, 32),
    (1, 1, 4, 2, 32768, 128), (64, 1, 64, 8, 4096, 128),
    (3, 1, 6, 3, 100, 128)]


@pytest.mark.parametrize("case", RING_SPLIT_CASES,
                         ids=[str(c) for c in RING_SPLIT_CASES])
def test_ring_split_rule(case):
    """Splits cover W with whole warp tiles and none left empty; each split
    walks at least 256 keys where W has them and at most the 2048 whose
    positions a CTA stages; the grid stays within two waves unless one
    split per (slot, KV head, row tile) already exceeds them."""
    b, t, h, kv, w, hd = case
    kt = ring_tile_k(hd)
    chunk = ring_split_len(b, t, h, kv, w, hd, H100_SMS)
    nsplit = -(-w // chunk)
    assert chunk % kt == 0
    assert (nsplit - 1) * chunk < w <= nsplit * chunk
    assert min(256, -(-w // kt) * kt) <= chunk <= 2048
    ctas = b * kv * -(-(t * (h // kv)) // 64)
    assert ctas * nsplit <= max(2 * H100_SMS, ctas * -(-w // 2048))


def test_ring_split_partials_at_hd256():
    """recurrentgemma-9b's decode (8 slots, 16 heads over one KV head, a
    2048-wide ring): the f32 partials (max, sum and P V per row and split)
    stay within 2 MB, against 8.4 MB under the scalar body's split rule."""
    b, t, h, kv, w, hd = 8, 1, 16, 1, 2048, 256
    nsplit = -(-w // ring_split_len(b, t, h, kv, w, hd, H100_SMS))
    assert b * t * h * nsplit * (hd + 2) * 4 <= 2e6


# (b, t, h, kv, m, bs, hd): smollm's paged decode (64 blocks of 16) and its
# 128-token chunk over a table cut to 32 blocks, hd 128, hd 256 with 16
# heads over one KV head, hd 24 (not a multiple of 16), a table of one
# block, a table wider than 2048 keys, a grid already past two waves
PAGED_SPLIT_CASES = [
    (8, 1, 9, 3, 64, 16, 64), (1, 128, 9, 3, 32, 16, 64),
    (8, 1, 32, 8, 64, 16, 128), (8, 1, 16, 1, 128, 16, 256),
    (2, 1, 9, 3, 25, 8, 24), (2, 1, 4, 2, 1, 16, 32),
    (1, 1, 4, 2, 400, 16, 64), (64, 1, 64, 8, 256, 16, 128)]


@pytest.mark.parametrize("case", PAGED_SPLIT_CASES,
                         ids=[str(c) for c in PAGED_SPLIT_CASES])
def test_paged_split_rule(case):
    """The bf16 paged kernel's splits cover the logical key axis (M * bs,
    trailing holes included) with whole warp tiles and none left empty;
    each split walks at least 256 keys where M * bs has them and at most
    the 2048 whose positions and offsets a CTA stages; the grid stays
    within two waves unless one split per (slot, KV head, row tile)
    already exceeds them."""
    b, t, h, kv, m, bs, hd = case
    w, kt = m * bs, ring_tile_k(hd)
    chunk = paged_split_len(b, t, h, kv, m, bs, hd, H100_SMS)
    nsplit = -(-w // chunk)
    assert chunk % kt == 0
    assert (nsplit - 1) * chunk < w <= nsplit * chunk
    assert min(256, -(-w // kt) * kt) <= chunk <= 2048
    ctas = b * kv * -(-(t * (h // kv)) // 64)
    assert ctas * nsplit <= max(2 * H100_SMS, ctas * -(-w // 2048))


def test_paged_split_at_smollm_decode():
    """smollm-135m's paged decode (8 slots, 3 KV heads, 64 blocks of 16):
    4 splits of 256 keys, 96 CTAs on 132 SMs, not the scalar rule's
    32-key splits."""
    assert paged_split_len(8, 1, 9, 3, 64, 16, 64, H100_SMS) == 256


# (b, s, w): the hybrid's prefill at 512 and 4096 tokens, many chunks on
# one chain, B > 1 with a ragged channel tile, one step, a short prompt,
# many chains
SCAN_CHUNK_CASES = [(1, 512, 4096), (1, 4096, 4096), (1, 65536, 128),
                    (4, 1000, 257), (3, 1, 129), (1, 13, 4096),
                    (8, 4096, 4096)]


@pytest.mark.parametrize("case", SCAN_CHUNK_CASES,
                         ids=[str(c) for c in SCAN_CHUNK_CASES])
def test_scan_chunk_rule(case):
    """Every chunk of the one-pass scan is non-empty and the chunks cover
    S; a CTA's chunk of a and b fits its shared memory (at most 32 steps x
    128 channels x 8 B = 32 KB); chunks are 32 steps wherever that gives
    every SM a CTA, and otherwise the grid gives every SM one (within the
    rounding of the chunk length) where chunks of 8 steps can."""
    b, s, w = case
    chunk = chunk_len(b, s, w, H100_SMS)
    n = -(-s // chunk)
    assert 1 <= chunk <= 32 and (n - 1) * chunk < s <= n * chunk
    assert chunk * 128 * 8 <= 32 * 1024
    chains = b * -(-w // 128)
    if chains * -(-s // 32) >= H100_SMS:
        assert chunk == min(s, 32)
    assert 9 * chains * n >= 8 * min(H100_SMS, chains * -(-s // 8))


# (b, sq, h, hd): smollm's prefill at 512 and 128 tokens, recurrentgemma's
# 4096-token prefill and a short one, hd 128, a prompt of one token
FLASH_SHAPE_CASES = [(1, 512, 9, 64), (1, 128, 9, 64), (1, 4096, 16, 256),
                     (1, 200, 16, 256), (2, 300, 8, 128), (1, 1, 4, 32)]


@pytest.mark.parametrize("case", FLASH_SHAPE_CASES,
                         ids=[str(c) for c in FLASH_SHAPE_CASES])
def test_flash_launch_shape(case):
    """Four warps at most, as row tiles x key groups the kernel accepts
    (groups <= 2 above 64 dims: shared memory); the grid has at least one
    CTA per SM wherever 16-row tiles can give it, and takes the largest
    query tile that does."""
    b, sq, h, hd = case
    rows, groups = flash_launch_shape(b, sq, h, hd, H100_SMS)
    assert rows in (16, 32, 64) and groups in (1, 2, 4)
    assert rows // 16 * groups <= 4
    assert groups <= (4 if hd <= 64 else 2)
    grid = b * h * -(-sq // rows)
    if b * h * -(-sq // 16) >= H100_SMS:
        assert grid >= H100_SMS
        assert rows == 64 or b * h * -(-sq // (2 * rows)) < H100_SMS


def test_flash_launch_shape_at_smollm_prefill():
    """smollm-135m's 512-token prefill (9 heads): 144 CTAs of 32 rows with
    two key groups, not 72 CTAs of 64 rows on 132 SMs."""
    assert flash_launch_shape(1, 512, 9, 64, H100_SMS) == (32, 2)


def test_query_positions_at_one_token_is_a_view():
    """A decode step's (B,) positions reach the kernel as a (B, 1) view,
    with no device op; chunks get per-token positions."""
    starts = torch.tensor([3, 7], dtype=torch.int32)
    qp = query_positions(starts, 1)
    assert qp.shape == (2, 1) and qp.data_ptr() == starts.data_ptr()
    assert query_positions(starts, 3).tolist() == [[3, 4, 5], [7, 8, 9]]


# (t, v, elem_bytes): the serving gate and the one-shot batch at smollm's
# vocab in bf16 and f32, qwen3-4b's and recurrentgemma's vocabs, the
# reference's bulk shape, T either side of two waves, repro's ragged sweep
# shapes and a V below one vector
GATE_SPLIT_CASES = [(1, 49152, 2), (1, 49152, 4), (64, 49152, 2),
                    (64, 49152, 4), (1, 151936, 2), (1, 256000, 4),
                    (4096, 32768, 4), (263, 49152, 2), (264, 49152, 2),
                    (100, 500, 4), (7, 8000, 4), (3, 501, 2), (1, 3, 4)]


@pytest.mark.parametrize("case", GATE_SPLIT_CASES,
                         ids=[str(c) for c in GATE_SPLIT_CASES])
def test_gate_split_rule(case):
    """The splits cover V with none empty, every split but the last holds a
    whole number of 16-byte vectors, there are at most 8 (the portable
    cluster), a split needs one round of 4 loads a thread unless the cap
    forced a longer one, and a row takes one CTA once T fills two waves."""
    t, v, eb = case
    splits, split_len = gate_splits(t, v, eb, H100_SMS)
    vec = 16 // eb
    assert 1 <= splits <= 8 and split_len % vec == 0
    assert (splits - 1) * split_len < v <= splits * split_len
    assert split_len <= 256 * 4 * vec or splits == 8 or t >= 2 * H100_SMS
    if t >= 2 * H100_SMS:
        assert splits == 1


def test_gate_splits_at_the_serving_and_bulk_shapes():
    """smollm's serving row: 6 splits of 8,192 bf16 entries (one 16 KB
    round each), 8 of 6,144 in f32 (the cap: 8 loads a thread); the
    one-shot batch: 6 x 64 = 384 CTAs; the bulk shape: one CTA a row."""
    assert gate_splits(1, 49152, 2, H100_SMS) == (6, 8192)
    assert gate_splits(1, 49152, 4, H100_SMS) == (8, 6144)
    assert gate_splits(64, 49152, 2, H100_SMS)[0] * 64 == 384
    assert gate_splits(4096, 32768, 4, H100_SMS)[0] == 1


def _exp_f32(x):
    """exp of f32 values, correctly rounded to f32. On the CPU build with
    MKL, the first multithreaded f32 ``torch.exp`` in a process can return
    elements off by ~1e-4 relative (``kernels.cascade_gate
    .max_softmax_conf``), which once put ``_rank_order_gate`` 3.5e-6 off
    the plain version; exp in f64 is free of it."""
    return torch.exp(x.double()).float()


def _rank_order_gate(x, splits, split_len):
    """The kernel's arithmetic across its splits, in plain torch: each split
    reduces to (m, s) from (-1e30, 0), rank 0 folds ranks 1.. in order."""
    t, v = x.shape
    x = x.float()
    neg = torch.full((t,), -1e30)
    m, s = neg.clone(), torch.zeros(t)
    for r in range(splits):
        part = x[:, r * split_len:min(v, (r + 1) * split_len)]
        pm = torch.maximum(neg, part.amax(dim=1)) if part.shape[1] else neg
        ps = (_exp_f32(part - pm[:, None]).sum(dim=1) if part.shape[1]
              else torch.zeros(t))
        mn = torch.maximum(m, pm)
        s = s * _exp_f32(m - mn) + ps * _exp_f32(pm - mn)
        m = mn
    return 1.0 / s.clamp_min(1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "neg_inf_split",
                                     "split_past_v"])
def test_gate_rank_order_merge_matches_plain(variant, dtype):
    rng = np.random.default_rng(3)
    t, v = 4, 49152
    x = torch.from_numpy(rng.standard_normal((t, v)).astype(np.float32) * 3)
    x = x.to(getattr(torch, dtype))
    splits, split_len = gate_splits(t, v, x.element_size(), H100_SMS)
    assert splits > 1
    if variant == "neg_inf_split":
        x[0, :split_len] = float("-inf")              # a whole split
        x[1, split_len:2 * split_len] = float("-inf")
        x[2, rng.random(v) < 0.3] = float("-inf")     # scattered
    elif variant == "split_past_v":
        splits += 1                                   # reads nothing
    conf = _rank_order_gate(x, splits, split_len)
    xd = x.double()
    exact = 1.0 / torch.exp(xd - xd.amax(dim=1, keepdim=True)).sum(dim=1)
    assert torch.all((conf - exact).abs() <= 1e-6 * exact)
    # the plain version's softmax is itself up to 1.2e-6 off the f64 value
    # on bf16 logits (few distinct values: exp's rounding repeats, not
    # averages), 1e-7 on f32 logits
    tol = 1e-6 if dtype == "float32" else 2e-6
    ref = cascade_gate_plain(x, 0.8, 0.1)[0]
    assert torch.all((conf - ref).abs() <= tol * ref)
