"""The port on the card: each CUDA kernel against its plain version, and
the engine's paths through the kernels. Marked ``gpu``; every test skips
without a CUDA device. This file imports neither JAX nor ``repro``, so it
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 1e-4 (summation order), bf16 2e-2 (bf16 output rounding,
and the kernel rounds P to bf16 before P V where the plain version keeps
f32). The three attention kernels are held in bf16 per query row as
well: |kernel - plain| / |plain| over the row's heads and dims below 1e-2,
where one bf16 rounding is ~2^-9 and a missed key tile or a wrong fragment
moves a row by far more, though a row that averages hundreds of keys can
hide either under 2e-2 absolute; a row that sees no key is exactly 0. TF32
is off for the f32 comparisons. The cascade gate's confidence:
1e-5 relative in f32 and in bf16 (both sides read the same bf16 values,
which f32 holds exactly, and sum in f32; only the order differs), routes
and counts equal on rows away from the thresholds, and equal bits on a
repeated call (the cluster merges in rank order). The RG-LRU scan (f32
only): 1e-5 * max(1, |h|) per element (the chunked scan composes the same
steps in another order: one chunk's map composed onto another's state).
The engines replay their programs (decode rounds, admissions, chunks,
draft fills, the gate, the drain batcher's prefill, sample and step) as CUDA
graphs; the launch counts follow from the programs run
(``_count_programs``), and graphed streams and states are held to eager
ones (graphs off): equal, or parted at a near-tie. The video-query
classifiers (cuDNN convolutions, TF32 off inside each call whatever the
global flags say) against their CPU forward: 1e-4 relative to the largest
logit, f32 (cuDNN's algorithms sum in other orders than oneDNN's). The
backward kernels against their plain backward versions on the same
inputs (both compute in f32): flash's dq, dk, dv 1e-4 of max(1, |plain|)
in f32 and 1e-2 per row in bf16 (the output's rounding, ~2^-9; a row's
norm floored at 1e-3 of the median row's, since the first query's dq
cancels to 0 in exact arithmetic), the
forward's log-sum-exp 1e-3 absolute; the scan's da, db, dh0 1e-5 *
max(1, |plain|), as its forward (da_t = g_t h_{t-1}: 1e-5 * max(1,
|h_{t-1}|) * max(1, |db_t|)). A train step's loss (1e-5 relative) and
gradients (1e-4 of each leaf's max |g|) on the card against the CPU in
f32.
``PartitionedLM``'s two halves equal ``LM.forward`` bit for bit: the same
kernels run in the same order.
The tensor-parallel path: the ring and paged kernels read a rank's
``kv_range`` of the cache in place, equal bit for bit to the kernel on a
copy of the range; a one-rank NCCL mesh serves the ``mesh=None`` streams
bit for bit with its all-reduces captured in the graphs, and a gloo mesh
serves eager and refuses a capture. A full-width MoE layer and MLA on a
one-rank NCCL mesh are bit-equal to ``mesh=None`` with the router's
all-gather and the all-reduces captured in a graph; the sharded
``LM.init`` equals ``place_params`` of the whole init on the card. The
data axis on a one-rank mesh of the card: the joined projection, the world
all-reduce, the data gather and reduce-scatter; a data-parallel train
step against the one-device step (f32: the loss 1e-5 relative, each param
1e-5 of its leaf's max |p| plus 1e-4 lr).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.cascade_gate import (  # noqa: E402
    cascade_gate, cascade_gate_plain)
from repro_torch.kernels.cascade_gate import _launch as _gate_launch  # noqa: E402
from repro_torch.kernels.cascade_gate import gate_splits  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd_plain, flash_attention_plain)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_bwd, rglru_scan_bwd_plain, rglru_scan_plain)
from repro_torch.launch.mesh import tally  # noqa: E402

pytestmark = pytest.mark.gpu

# the backward kernels' counts on a path that computes no gradient
NO_BACKWARD = {"flash_attention_bwd": 0, "rglru_scan_bwd": 0}

# (b, w, h, kv, hd, window, filled, total_pos, t)
DECODE_CASES = [
    (1, 64, 4, 4, 32, None, 64, 64, 1),       # full cache, MHA
    (2, 96, 8, 2, 64, 16, 96, 96, 1),         # window + GQA g=4
    (2, 64, 4, 2, 32, None, 40, 40, 1),       # partially-empty cache
    (2, 64, 4, 2, 32, None, 64, 130, 1),      # ring-wrapped cache
    (1, 48, 4, 2, 32, 24, 48, 130, 1),        # ring-wrapped + window
    (2, 100, 6, 3, 128, None, 100, 100, 1),   # ragged width, hd 128
    (2, 64, 8, 2, 64, 16, 48, 48, 8),         # chunk + window + g=4
    (1, 96, 3, 1, 32, None, 70, 70, 16),      # MQA, bigger chunk
    (1, 64, 48, 1, 64, None, 64, 64, 2),      # 96 rows: two row tiles
    # recurrentgemma-9b's local attention: hd 256, 16 query heads over one
    # KV head, window 2048 on a 2048-wide ring, partly filled and wrapped
    (2, 2048, 16, 1, 256, 2048, 700, 700, 1),
    (2, 2048, 16, 1, 256, 2048, 2048, 2900, 1),
    # the tensor-core body's edges: head_dim a multiple of 8 but not of 16,
    # a 16-token chunk at hd 256 (256 rows: four row-tile CTAs), and 24 rows
    # at G = 3 (two row tiles, two key groups)
    (2, 200, 9, 3, 24, None, 180, 180, 1),
    (2, 200, 9, 3, 40, 50, 180, 180, 8),
    (2, 512, 16, 1, 256, 2048, 400, 400, 16),
    (2, 200, 9, 3, 64, None, 180, 180, 8),
    # the dense hd-128 zoo: glm4-9b's 32 heads over 2 KV heads (G = 16;
    # a 128-token chunk is 2048 rows a KV head, 32 row tiles) and
    # starcoder2-7b's 36 over 4 (G = 9, not a power of two; its 4096 window
    # on a wrapped 4096-wide ring; a chunk is 1152 rows, 18 tiles)
    (2, 1024, 32, 2, 128, None, 700, 700, 1),
    (1, 1024, 32, 2, 128, None, 600, 600, 128),
    (2, 4096, 36, 4, 128, 4096, 4096, 5000, 1),
    (1, 1024, 36, 4, 128, None, 600, 600, 128),
    # the speculative verify chunk (k = 4: T = 5 tokens a slot, B = 8):
    # smollm-135m's G = 3 at hd 64 (15 rows a KV head), qwen3-4b's G = 4
    # and glm4-9b's G = 16 at hd 128 (20 and 80 rows)
    (8, 1024, 9, 3, 64, None, 600, 600, 5),
    (8, 1024, 32, 8, 128, None, 600, 600, 5),
    (8, 1024, 32, 2, 128, None, 600, 600, 5),
    # mixtral-8x22b's G = 6 (48 heads over 8) under its 4096 window on a
    # 1024-wide ring: a step, and a 128-token chunk (768 rows a KV head)
    (2, 1024, 48, 8, 128, 4096, 700, 700, 1),
    (1, 1024, 48, 8, 128, 4096, 600, 600, 128),
    # musicgen-medium's MHA at hd 64 (G = 1: one query row a KV head),
    # partly filled and wrapped; internvl2-2b's G = 2 at hd 128 behind its
    # 256-token image prefix
    (2, 1024, 24, 24, 64, None, 700, 700, 1),
    (2, 1024, 24, 24, 64, None, 1024, 1500, 1),
    (2, 1024, 16, 8, 128, None, 389, 389, 1),
]

# (h, kv, hd, bs, window, fills, t): the block sizes and cases of
# tests/test_paged_decode_attention.py, chunk queries (t > 1, including one
# of more than 64 rows) and a pool with a freed slot; then every hd class
# of the bf16 kernel (hd 128; 256 with 16 heads over one KV head; 24 and
# 40, multiples of 8 but not of 16) at t = 1 and t > 1, and a table wider
# than the 2048 keys one split stages. Tables of up to 64 keys take one
# split (the CTA writes the output); _pool punches holes mid-table.
PAGED_CASES = [
    (4, 4, 32, 16, None, (64, 64), 1),
    (4, 2, 32, 16, None, (26, 64), 1),
    (3, 1, 32, 16, None, (48, 5), 1),
    (4, 4, 32, 16, 24, (64, 64), 1),
    (8, 2, 64, 32, 16, (96, 40), 1),
    (4, 2, 16, 8, None, (1, 63), 1),
    (4, 2, 32, 16, None, (40, 64), 8),
    (8, 2, 64, 32, 16, (96, 40), 8),
    (9, 3, 64, 16, None, (200, 0, 17), 40),   # 120 rows, a freed slot
    (9, 3, 64, 8, None, (300, 33), 1),
    (8, 2, 128, 16, None, (300, 77), 1),
    (8, 2, 128, 16, 100, (300, 77), 8),
    (16, 1, 256, 16, 2048, (700, 0, 33), 1),
    (16, 1, 256, 16, None, (700, 40), 16),    # 256 rows: four CTAs
    (9, 3, 24, 16, None, (180, 50), 1),
    (9, 3, 24, 16, None, (180, 50), 8),
    (9, 3, 40, 8, 50, (180, 50), 1),
    (9, 3, 40, 8, None, (180, 50), 8),
    (9, 3, 64, 16, None, (2500, 100), 1),     # 157 blocks: 2512 keys
    (9, 3, 64, 16, 700, (2500, 100), 4),
    # the hd-128 zoo: G = 16 (glm4-9b) and G = 9 (starcoder2-7b, windowed)
    # at T = 1 and a 128-token chunk (2048 and 1152 rows a KV head)
    (32, 2, 128, 16, None, (700, 0, 33), 1),
    (32, 2, 128, 16, None, (600, 200), 128),
    (36, 4, 128, 16, 4096, (700, 33), 1),
    (36, 4, 128, 16, 4096, (600, 200), 128),
    # the speculative verify chunk over 8 slots (a freed one, and one whose
    # chunk starts at 0): T = 5 at G = 3 (hd 64), 4 and 16 (hd 128)
    (9, 3, 64, 16, None, (600, 33, 0, 5, 1000, 17, 200, 480), 5),
    (32, 8, 128, 16, None, (600, 33, 0, 5, 1000, 17, 200, 480), 5),
    (32, 2, 128, 16, None, (600, 33, 0, 5, 1000, 17, 200, 480), 5),
]

# (t, v, misaligned): the serving gate (t = 1) and the one-shot batch at
# smollm's padded vocab, repro's ragged sweep shapes, and the scalar path
# (V not a multiple of the 16-byte vector, or a row start off 16 bytes);
# then qwen3-4b's and recurrentgemma's vocabs at t = 1 (8 splits, each
# longer than one round of loads), two rows of clusters, the reference's
# bulk shape (one CTA a row) and a misaligned serving row (split scalar
# path)
GATE_CASES = [(1, 49152, False), (64, 49152, False), (100, 500, False),
              (7, 8000, False), (3, 501, False), (5, 1024, True),
              (1, 151936, False), (1, 256000, False), (2, 49152, False),
              (4096, 32768, False), (1, 49152, True),
              # internvl2-2b's padded vocab: a query batch and one row
              (16, 92672, False), (1, 92672, False)]

# (b, sq, sk, h, kv, hd, window)
FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, None),
    (2, 64, 64, 4, 2, 64, None),
    (1, 100, 100, 3, 1, 32, None),            # ragged tail
    (2, 200, 200, 4, 4, 32, 24),              # sliding window
    (1, 1, 96, 4, 2, 32, None),               # right-aligned single query
    (1, 70, 90, 4, 2, 64, 16),                # right-aligned, windowed
    (1, 48, 48, 2, 2, 256, None),             # hd 256
    (1, 2300, 2300, 16, 1, 256, 2048),        # recurrentgemma's window
    (1, 100, 100, 4, 2, 24, None),            # hd not a multiple of 16
    (1, 100, 100, 4, 2, 40, 30),
    (1, 70, 150, 4, 2, 128, None),            # Sq < Sk, ragged query tile
    (1, 90, 60, 4, 2, 64, None),              # Sq > Sk: rows that see nothing
    (1, 300, 300, 32, 2, 128, None),          # glm4-9b's G = 16 at hd 128
    (1, 300, 300, 36, 4, 128, 200),           # starcoder2-7b's G = 9, banded
    (1, 300, 300, 48, 8, 128, 200),           # mixtral-8x22b's G = 6, banded
    # deepseek-v3-671b's MLA prefill: hd 192 (the 256 template), G = 1
    (1, 300, 300, 16, 16, 192, None),
    (2, 130, 130, 8, 8, 192, 50),
    # musicgen-medium's MHA at hd 64 (G = 1); internvl2-2b's G = 2 at hd
    # 128 over its 256-token image prefix and 100 text tokens
    (2, 300, 300, 24, 24, 64, None),
    (1, 356, 356, 16, 8, 128, None),
]

# (b, s, w): the serving shape, odd S and W with B > 1, one step, one
# chunk, a ragged channel tile, many chunks on one chain (2048 CTAs of one
# look-back chain) and many chains with B > 1
RGLRU_CASES = [(1, 512, 4096), (2, 77, 4000), (3, 1, 129), (2, 16, 128),
               (4, 1000, 257), (1, 4096, 4096), (1, 65536, 128),
               (8, 2048, 1024)]


def _assert_attention(out, plain, dt, rows: int = 2):
    """The kernel's output against its plain version: 1e-4 absolute in f32;
    2e-2 absolute and 1e-2 per query row (the first ``rows`` dims index
    rows, each over its heads and dims) in bf16; a row that sees no key is
    exactly 0 in both."""
    diff = (out.float() - plain.float()).flatten(rows)
    ref = plain.float().flatten(rows)
    den = ref.norm(dim=-1)
    seen = den > 0
    assert not out.float().flatten(rows)[~seen].any()
    if dt == torch.float32:
        assert diff.abs().max().item() < 1e-4
        return
    assert diff.abs().max().item() < 2e-2
    rel = diff.norm(dim=-1)[seen] / den[seen]
    assert rel.max().item() < 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ring(dev, dt, b, w, h, kv, hd, filled, total_pos, t):
    gen = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((b, t, h, hd), generator=gen)
    k = torch.randn((b, w, kv, hd), generator=gen)
    v = torch.randn((b, w, kv, hd), generator=gen)
    tok = torch.arange(total_pos - filled, total_pos, dtype=torch.int32)
    k_pos = torch.full((b, w), -1, dtype=torch.int32)
    k_pos[:, tok % w] = tok
    start = total_pos if t == 1 else total_pos - t
    q_pos = torch.full((b,), start, dtype=torch.int32)
    return (q.to(dev, dt), k.to(dev, dt), v.to(dev, dt), q_pos.to(dev),
            k_pos.to(dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, w, h, kv, hd, window, filled, total_pos, t = case
    dt = getattr(torch, dtype)
    q, k, v, q_pos, k_pos = _ring(cuda, dt, b, w, h, kv, hd, filled,
                                  total_pos, t)
    n = LAUNCHES["decode_attention"]
    out = decode_attention(q, k, v, q_pos, k_pos, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == n + 1
    plain = decode_attention_plain(q, k, v, q_pos, k_pos, window=window)
    _assert_attention(out, plain, dt)


def test_decode_kernel_empty_rows_are_zero(cuda):
    q, k, v, q_pos, k_pos = _ring(cuda, torch.bfloat16, 2, 64, 4, 2, 32, 40,
                                  40, 1)
    k_pos[1] = -1
    out = decode_attention(q, k, v, q_pos, k_pos)
    assert out[0].abs().sum() > 0 and not out[1].any()


def _pool(dev, dt, h, kv, hd, bs, fills, t):
    """A shuffled pool as the engine leaves it (block 0 is trash, a slot's
    token p at (table[p // bs], p % bs)); a fill of 0 is a freed slot (its
    row all -1); a slot of at least four blocks loses its second (a hole:
    -1 mid-table). The t-token chunk of each slot ends at its last
    token."""
    rng = np.random.default_rng(7)
    m = max(-(-f // bs) for f in fills)
    n = sum(-(-f // bs) for f in fills) + 2
    order = rng.permutation(np.arange(1, n))
    pos = np.full((n, bs), -1, np.int32)
    bt = np.full((len(fills), m), -1, np.int32)
    it = iter(order)
    for s, fill in enumerate(fills):
        for j in range(-(-fill // bs)):
            blk = next(it)
            bt[s, j] = blk
            tok = np.arange(j * bs, min(fill, (j + 1) * bs))
            pos[blk, tok - j * bs] = tok
        if fill >= 4 * bs:
            bt[s, 1] = -1
    q = rng.standard_normal((len(fills), t, h, hd))
    k, v = (rng.standard_normal((n, bs, kv, hd)) for _ in range(2))
    q_pos = np.asarray([max(f - t, 0) for f in fills], np.int32)
    return (*(torch.from_numpy(a).to(dev, dt) for a in (q, k, v)),
            *(torch.from_numpy(a).to(dev) for a in (q_pos, pos, bt)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[str(c) for c in PAGED_CASES])
def test_paged_kernel_matches_plain(cuda, case, dtype):
    h, kv, hd, bs, window, fills, t = case
    dt = getattr(torch, dtype)
    q, k, v, q_pos, pos, bt = _pool(cuda, dt, h, kv, hd, bs, fills, t)
    n = LAUNCHES["paged_decode_attention"]
    out = paged_decode_attention(q, k, v, q_pos, pos, bt, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention"] == n + 1
    plain = paged_decode_attention_plain(q, k, v, q_pos, pos, bt,
                                         window=window)
    _assert_attention(out, plain, dt)
    for s, fill in enumerate(fills):
        if fill == 0:
            assert not out[s].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, sk, h, kv, hd, window = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cpu").manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dt) for shape in
               ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    n = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n + 1
    plain = flash_attention_plain(q, k, v, window=window)
    _assert_attention(out, plain, dt)


# (hd, rows, groups): every launch shape the bf16 flash kernel takes (four
# key groups only up to 64 dims: shared memory)
FLASH_LAUNCH_SHAPES = [(hd, rows, groups) for hd in (64, 256)
                       for rows, groups in ((64, 1), (32, 1), (32, 2),
                                            (16, 1), (16, 2), (16, 4))
                       if groups <= (4 if hd <= 64 else 2)]


@pytest.mark.parametrize("case", FLASH_LAUNCH_SHAPES,
                         ids=[str(c) for c in FLASH_LAUNCH_SHAPES])
def test_flash_kernel_every_launch_shape(cuda, monkeypatch, case):
    """Each (query rows, key groups) the bf16 kernel accepts, on a causal,
    windowed prefill whose query tiles see from one to eight key tiles."""
    import repro_torch.kernels.flash_attention as fa
    hd, rows, groups = case
    monkeypatch.setattr(fa, "flash_launch_shape", lambda *a: (rows, groups))
    gen = torch.Generator(device="cpu").manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen).to(cuda, torch.bfloat16)
               for s in ((2, 300, 4, hd), (2, 300, 2, hd), (2, 300, 2, hd)))
    out = flash_attention(q, k, v, window=200)
    torch.cuda.synchronize()
    _assert_attention(out, flash_attention_plain(q, k, v, window=200),
                      torch.bfloat16)


@pytest.mark.parametrize("keys", [None, 32, 64, 256])
@pytest.mark.parametrize("hd", [64, 256])
def test_decode_kernel_every_split(cuda, monkeypatch, keys, hd):
    """The bf16 ring kernel at several keys per split, one split (no
    combine kernel: the CTA writes the output) included, on a wrapped
    ring with a window and an empty slot."""
    import repro_torch.kernels.decode_attention as da
    if keys is not None:
        monkeypatch.setattr(da, "ring_split_len",
                            lambda *a: max(keys, da.ring_tile_k(hd)))
    else:
        monkeypatch.setattr(da, "ring_split_len", lambda *a: a[4])
    q, k, v, q_pos, k_pos = _ring(cuda, torch.bfloat16, 3, 512, 8, 2, hd,
                                  512, 900, 1)
    k_pos[1] = -1
    out = decode_attention(q, k, v, q_pos, k_pos, window=300)
    torch.cuda.synchronize()
    _assert_attention(out, decode_attention_plain(q, k, v, q_pos, k_pos,
                                                  window=300),
                      torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATE_CASES, ids=[str(c) for c in GATE_CASES])
def test_cascade_gate_kernel_matches_plain(cuda, case, dtype):
    t, v, misaligned = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cpu").manual_seed(t + v)
    x = (torch.randn((t, v), generator=gen) * 3).to(cuda, dt)
    if misaligned:
        buf = torch.empty(t * v + 1, dtype=dt, device=cuda)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(t, v)
    conf0 = cascade_gate_plain(x, 1.0, 0.0)[0]
    srt = conf0.sort().values
    hi = float(srt[(2 * t) // 3]) * (1 + 1e-3) if t > 1 else 2.0
    lo = float(srt[t // 3]) * (1 - 1e-3) if t > 1 else 0.0
    n = LAUNCHES["cascade_gate"]
    conf, routes, counts = cascade_gate(x, hi=hi, lo=lo)
    torch.cuda.synchronize()
    assert LAUNCHES["cascade_gate"] == n + 1
    pconf, proutes, pcounts = cascade_gate_plain(x, hi, lo)
    assert ((conf - pconf).abs() / pconf).max().item() < 1e-5
    assert int(counts.sum()) == t
    assert counts.tolist() == [int((routes == r).sum()) for r in range(3)]
    near = (((pconf - hi).abs() < 1e-5 * hi)
            | ((pconf - lo).abs() < 1e-5 * max(lo, 1e-30)))
    assert torch.equal(routes[~near], proutes[~near])
    if not near.any():
        assert torch.equal(counts, pcounts)


def _gate_inputs(dev, dt, t, v, seed):
    """Logits as phase 2 makes them and thresholds at the confidences'
    widest gaps near the tertiles (none for t < 3), so no row sits near a
    threshold: routes and counts must then equal the plain version's."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((t, v), generator=gen) * 3).to(dev, dt)
    if t < 3:
        return x, 2.0, 0.0
    srt = cascade_gate_plain(x, 1.0, 0.0)[0].sort().values.cpu().double()
    gap = srt[1:] / srt[:-1]

    def cut(k):
        span = max(2, t // 8)
        lo_, hi_ = max(0, k - span), min(t - 1, k + span)
        j = lo_ + int(gap[lo_:hi_].argmax())
        return float((srt[j] + srt[j + 1]) / 2)

    return x, cut(2 * t // 3), cut(t // 3)


def _assert_gate(x, got, hi, lo):
    conf, routes, counts = got
    pconf, proutes, pcounts = cascade_gate_plain(x, hi, lo)
    assert ((conf - pconf).abs() / pconf).max().item() < 1e-5
    assert torch.equal(routes, proutes)
    assert torch.equal(counts, pcounts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cascade_gate_repeated_call_equal_bits(cuda, dtype):
    """The cluster's pairs merge in rank order: a second call on the same
    logits gives the same bits, at every split count the rule picks."""
    dt = getattr(torch, dtype)
    for t, v in ((1, 49152), (1, 256000), (64, 49152), (300, 8000)):
        x, hi, lo = _gate_inputs(cuda, dt, t, v, seed=t + v)
        first = [o.clone() for o in cascade_gate(x, hi=hi, lo=lo)]
        again = cascade_gate(x, hi=hi, lo=lo)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_cascade_gate_workspace_left_clean(cuda):
    """T = 64, then T = 1, then T = 64 and the bulk shape, queued with no
    synchronisation between them: each call's counts are its own rows'
    (the last row's CTA leaves the accumulators and the ticket at zero)."""
    calls = []
    for i, (t, v) in enumerate(((64, 49152), (1, 49152), (64, 49152),
                                (4096, 32768), (64, 49152))):
        x, hi, lo = _gate_inputs(cuda, torch.float32, t, v, seed=i)
        calls.append((x, cascade_gate(x, hi=hi, lo=lo), hi, lo))
    torch.cuda.synchronize()
    for x, got, hi, lo in calls:
        _assert_gate(x, got, hi, lo)
        assert int(got[2].sum()) == x.shape[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cascade_gate_neg_inf_columns(cuda, dtype):
    """Rows with scattered -inf columns, and rows whose whole first split
    is -inf (that split holds (-1e30, 0) and adds nothing to the merge)."""
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for t, v in ((1, 49152), (5, 49152), (3, 151936)):
        x, hi, lo = _gate_inputs(cuda, dt, t, v, seed=v - t)
        gen = torch.Generator(device="cpu").manual_seed(t)
        x[torch.rand((t, v), generator=gen).to(cuda) < 0.3] = float("-inf")
        splits, split_len = gate_splits(t, v, x.element_size(), sms)
        assert splits > 1
        x[0, :split_len] = float("-inf")
        _assert_gate(x, cascade_gate(x, hi=2.0, lo=0.0), 2.0, 0.0)


def test_cascade_gate_one_kernel_no_memset(cuda):
    """One call at the serving shape is one device operation: the gate
    kernel, with no memset before it (the workspace is made on the first
    call on a stream, which this test makes before it profiles)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for t in (1, 64):
        x = torch.randn((t, 49152), device=cuda).bfloat16()
        cascade_gate(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cascade_gate(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "cascade_gate_kernel" in names[0], names


@pytest.mark.parametrize("case", RGLRU_CASES, ids=[str(c) for c in RGLRU_CASES])
def test_rglru_scan_kernel_matches_plain(cuda, case):
    b, s, w = case
    gen = torch.Generator(device="cpu").manual_seed(s + w)
    a = (0.8 + 0.1999 * torch.rand((b, s, w), generator=gen)).to(cuda)
    x = torch.randn((b, s, w), generator=gen).to(cuda)
    h0 = torch.randn((b, w), generator=gen).to(cuda)
    n = LAUNCHES["rglru_scan"]
    h, h_last = rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == n + 1
    ph, ph_last = rglru_scan_plain(a, x, h0)
    for out, ref in ((h, ph), (h_last, ph_last)):
        assert torch.all((out - ref).abs() <= 1e-5 * ref.abs().clamp_min(1))
    assert torch.equal(h[:, -1], h_last)


def test_rglru_scan_back_to_back_calls(cuda):
    """Calls queued with no synchronisation between them, the same grid
    twice on other values and another grid between: each reads only its
    own launch's look-back flags (a flag left by the call before would
    hand a chunk that call's state); a fourth call on the first's inputs
    gives the same bits (the engine's streams depend on it)."""
    gen = torch.Generator(device="cpu").manual_seed(9)
    calls = []
    for b, s, w in ((1, 4096, 256), (2, 300, 1000), (1, 4096, 256)):
        a = (0.8 + 0.1999 * torch.rand((b, s, w), generator=gen)).to(cuda)
        x = torch.randn((b, s, w), generator=gen).to(cuda)
        h0 = torch.randn((b, w), generator=gen).to(cuda)
        calls.append(((a, x, h0), rglru_scan(a, x, h0)))
    again = rglru_scan(*calls[0][0])
    torch.cuda.synchronize()
    for args, (h, h_last) in calls:
        ph, ph_last = rglru_scan_plain(*args)
        for out, ref in ((h, ph), (h_last, ph_last)):
            assert torch.all((out - ref).abs()
                             <= 1e-5 * ref.abs().clamp_min(1))
    assert torch.equal(again[0], calls[0][1][0])
    assert torch.equal(again[1], calls[0][1][1])


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn((1, 8, 2, 12), device=cuda)        # head_dim 12
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x, x[:, :, :1], x[:, :, :1])
    q = torch.randn((1, 1, 2, 16), device=cuda)
    k = torch.randn((1, 8, 1, 16), device=cuda, dtype=torch.float16)
    pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q, k, k, torch.zeros((1,), dtype=torch.int32,
                                              device=cuda), pos)
    with pytest.raises(TypeError, match="dtype"):
        cascade_gate(torch.zeros((2, 8), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        _gate_launch(torch.zeros((2, 8)), 0.8, 0.1)
    a = torch.rand((1, 4, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.bfloat16(), a.bfloat16(), a[:, 0].bfloat16())
    with pytest.raises(ValueError, match="one CUDA device"):
        rglru_scan(a, a, a[:, 0].cpu())
    with pytest.raises(ValueError, match="shapes"):
        rglru_scan(a, a[:, :3], a[:, 0])


def test_engine_on_gpu_goes_through_the_kernels(cuda):
    """A tiny model served on the card: K=4 streams equal K=1 streams, and
    every prefill and decode attention was a kernel launch."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = tcfg.ModelConfig(
        name="tiny", family="dense", source="t", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=96,
        stages=tcfg.dense_stages(3), param_dtype="float32")
    lm = LM(cfg, device=cuda)
    params = lm.init(0)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9))]
    outs = []
    for k in (1, 4):
        eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                            max_decode_steps=k)
        ids = [eng.submit(p, max_new_tokens=6, temperature=0.7 * (i % 2))
               for i, p in enumerate(prompts)]
        reset_launches()
        done = eng.run()
        assert LAUNCHES == {"flash_attention": 3 * eng.admissions,
                            "decode_attention": 3 * eng.decode_steps,
                            "paged_decode_attention": 0, "cascade_gate": 0,
                            "rglru_scan": 0, **NO_BACKWARD}
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _tiny(cuda, layers=3, dtype="float32"):
    from repro_torch.models.model import LM

    cfg = tcfg.ModelConfig(
        name="tiny", family="dense", source="t", num_layers=layers,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=96, stages=tcfg.dense_stages(layers),
        param_dtype=dtype)
    return LM(cfg, device=cuda)


def test_drain_engine_on_gpu_matches_the_continuous_engine(cuda):
    """The drain-batch baseline on the card: its greedy streams equal the
    continuous engine's; its sampled streams (one threefry key split a
    token, the batch drawn from it) equal the same drain engine's on the
    CPU up to a near-tie of the perturbed logits; it prefills each batch
    through the flash kernel and decodes through the ring kernel, one host
    sync a token."""
    from repro_torch.kernels import reset_launches
    from repro_torch.serving import DrainBatchEngine, ServingEngine
    from repro_torch.serving.sampler import gumbel, prng_key, split

    lm = _tiny(cuda)
    params = lm.init(0)
    reqs = [(np.random.default_rng(i).integers(0, 96, n).astype(np.int32), m)
            for i, (n, m) in enumerate(((5, 6), (12, 3), (20, 8), (9, 4),
                                        (3, 7)))]
    cpu_lm, cpu_params = _tiny("cpu"), _to(params, "cpu")
    outs = []
    for cls, model, weights in ((ServingEngine, lm, params),
                                (DrainBatchEngine, lm, params),
                                (DrainBatchEngine, cpu_lm, cpu_params)):
        eng = cls(model, weights, batch_slots=2, max_seq_len=64)
        ids = [eng.submit(p, max_new_tokens=m, temperature=0.7 * (i % 2))
               for i, (p, m) in enumerate(reqs)]
        reset_launches()
        done = eng.run()
        if cls is DrainBatchEngine and model is lm:
            launches, syncs = dict(LAUNCHES), eng.host_syncs
        outs.append([done[i].output for i in ids])
    steps = sum(max(m for _, m in reqs[i:i + 2]) for i in range(0, 5, 2))
    assert syncs == steps
    assert launches == {"flash_attention": 3 * 3,
                        "decode_attention": 3 * steps,
                        "paged_decode_attention": 0, "cascade_gate": 0,
                        "rglru_scan": 0, **NO_BACKWARD}
    cont, card, host = outs
    keys, rng = [], prng_key(0)
    for i in range(0, 5, 2):                  # the drain's key schedule
        keys.append([])
        for _ in range(max(m for _, m in reqs[i:i + 2])):
            rng, k = split(rng)
            keys[-1].append(k)
    for i, (a, b, c) in enumerate(zip(cont, card, host)):
        if i % 2 == 0:
            np.testing.assert_array_equal(a, b)
        diff = np.flatnonzero(b != c)
        if len(diff):
            t = int(diff[0])
            ctx = torch.from_numpy(np.concatenate(
                [reqs[i][0], c[:t]]).astype(np.int32))[None]
            x = cpu_lm.forward(cpu_params, {"tokens": ctx},
                               last_only=True)[0][0, 0]
            if i % 2:
                x = x / 0.7 + gumbel(keys[i // 2][t], (2, x.shape[0]))[i % 2]
            top = torch.topk(x, 2).values
            assert (top[0] - top[1]).item() < 1e-4 / 0.7, (i, t)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_sampler_on_the_card_equals_the_cpu(cuda):
    """The keyed sampler (threefry2x32 in int64 words) gives the same key
    schedule, bits and uniforms on the card as on the CPU, bit for bit, at
    smollm-135m's and qwen3-4b's padded vocabularies; the Gumbel noise
    within 2 ulp at unit scale (the devices' ``log`` may differ by one)."""
    from repro_torch.serving.sampler import (gumbel, prng_key, random_bits,
                                             request_keys, split, uniform)

    rids = torch.arange(8, dtype=torch.int64) * 977 + 3
    steps = torch.arange(8, dtype=torch.int64) * 31
    for seed in (0, 2 ** 31 + 5):
        keys = {d: request_keys(prng_key(seed, device=d), rids.to(d),
                                steps.to(d)) for d in ("cpu", cuda)}
        assert torch.equal(keys[cuda].cpu(), keys["cpu"])
        assert torch.equal(split(keys[cuda], 3).cpu(), split(keys["cpu"], 3))
        for v in (49152, 152064):
            assert torch.equal(random_bits(keys[cuda], (v,)).cpu(),
                               random_bits(keys["cpu"], (v,)))
            assert torch.equal(uniform(keys[cuda], (v,)).cpu().view(
                torch.int32), uniform(keys["cpu"], (v,)).view(torch.int32))
            g, ref = gumbel(keys[cuda], (v,)).cpu(), gumbel(keys["cpu"], (v,))
            ulp = torch.clamp(ref.abs(), min=1.0) * 2.0 ** -23
            assert bool(((g - ref).abs() <= 2 * ulp).all())


@pytest.mark.parametrize("backend", ["ring", "paged"])
def test_speculative_engine_on_gpu_matches_its_baseline(cuda, backend):
    """A tiny target (3 layers) and a 1-layer draft on the card, k = 4
    forced on, greedy and sampled: the streams equal the plain K = 1
    engine's, and the launches are the target's layers per plain step,
    verify chunk and prompt chunk, and the draft's per draft step (its
    ring) and per fill (flash)."""
    from repro_torch.kernels import reset_launches
    from repro_torch.serving import ServingEngine

    lm, draft = _tiny(cuda), _tiny(cuda, layers=1)
    params, dparams = lm.init(0), draft.init(7)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9, 17, 3))]
    kw = dict(batch_slots=4, max_seq_len=64)
    if backend == "paged":
        kw.update(cache_backend="paged", block_size=8, chunk_tokens=8)
    outs = []
    for spec in ({}, dict(draft_model=draft, draft_params=dparams,
                          speculative_tokens=4)):
        eng = ServingEngine(lm, params, **kw, **spec)
        eng.scheduler.spec_min_commit = 0.0
        n = _count_programs(eng)
        ids = [eng.submit(p, max_new_tokens=12, temperature=0.7 * (i % 2))
               for i, p in enumerate(prompts)]
        reset_launches()
        done = eng.run()
        target = 3 * (n["steps"] + n["rounds"] + n["chunks"])
        paged = backend == "paged"
        assert LAUNCHES == {
            "flash_attention": n["fills"] + 3 * n["admits"],
            "decode_attention": n["draft_steps"] + (0 if paged else target),
            "paged_decode_attention": target if paged else 0,
            "cascade_gate": 0, "rglru_scan": 0, **NO_BACKWARD}
        if spec:
            assert n["rounds"] > 0 and n["fills"] >= len(prompts)
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _count_programs(eng):
    """Wrap ``eng``'s program runner with counters: plain decode steps (a
    K-step program adds K, whether it replays a graph or runs eagerly),
    speculative rounds and their draft steps (k + 1 a round), admissions,
    prompt chunks and draft fills."""
    n = dict(steps=0, rounds=0, draft_steps=0, admits=0, fills=0, chunks=0)
    run = eng._run_program

    def counted_run(key):
        kind = key[0]
        if kind == "decode":
            n["steps"] += key[1]
        elif kind == "spec":
            n["rounds"] += 1
            n["draft_steps"] += key[1] + 1
        else:
            n[{"admit": "admits", "chunk": "chunks",
               "draft_fill": "fills"}[kind]] += 1
        return run(key)

    eng._run_program = counted_run
    return n


GRAPH_MODES = {"K=1": dict(max_decode_steps=1),
               "K=2": dict(max_decode_steps=2),
               "K=4": dict(max_decode_steps=4),
               "spec k=2": dict(speculative_tokens=2)}


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
@pytest.mark.parametrize("backend", ["ring", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_engine_matches_the_eager_engine(cuda, dtype, backend, mode):
    """``warm_compile`` captures every decode program as a CUDA graph; a
    graphed engine then serves greedy and sampled traffic with no further
    capture, its launches equal the counted programs' (a replay adds its
    capture's launches), and its streams equal an eager engine's (graphs
    off) or part first at a near-tie of the teacher-forced logits: top-2
    margin within 1e-4 (f32) or 2e-2 (bf16), at T > 0 of logits / T plus
    the step's keyed Gumbel noise."""
    from repro_torch.kernels import reset_launches
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.sampler import gumbel, prng_key, request_keys

    lm, draft = _tiny(cuda, dtype=dtype), _tiny(cuda, 1, dtype)
    params, dparams = lm.init(0), draft.init(7)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9, 17, 3))]
    kw = dict(batch_slots=4, max_seq_len=64, **GRAPH_MODES[mode])
    if mode.startswith("spec"):
        kw.update(draft_model=draft, draft_params=dparams)
    if backend == "paged":
        kw.update(cache_backend="paged", block_size=8, chunk_tokens=8)
    temps = [0.7 * (i % 2) for i in range(len(prompts))]
    outs = {}
    for graphed in (False, True):
        eng = ServingEngine(lm, params, **kw)
        eng._use_graphs = graphed
        eng.scheduler.spec_min_commit = 0.0
        eng.warm_compile()
        warmed = dict(eng._programs)
        assert eng.graphs() == (len(warmed) if graphed else 0)
        assert (eng.graph_pool_bytes() > 0) == graphed
        n = _count_programs(eng)
        ids = [eng.submit(p, max_new_tokens=12, temperature=t)
               for p, t in zip(prompts, temps)]
        reset_launches()
        done = eng.run()
        torch.cuda.synchronize()
        assert eng._programs == warmed, "a program was captured in traffic"
        target = 3 * (n["steps"] + n["rounds"] + n["chunks"])
        paged = backend == "paged"
        assert LAUNCHES == {
            "flash_attention": n["fills"] + 3 * n["admits"],
            "decode_attention": n["draft_steps"] + (0 if paged else target),
            "paged_decode_attention": target if paged else 0,
            "cascade_gate": 0, "rglru_scan": 0, **NO_BACKWARD}
        assert n["steps"] + n["rounds"] > 0
        if mode.startswith("spec"):
            assert n["rounds"] > 0
        outs[graphed] = [done[i].output for i in ids]
    tol = 1e-4 if dtype == "float32" else 2e-2
    for rid, (p, t, a, b) in enumerate(zip(prompts, temps, outs[True],
                                           outs[False])):
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        at = int(diff[0])
        ctx = torch.from_numpy(np.concatenate([p, b[:at]]).astype(
            np.int32))[None].to(cuda)
        x = lm.forward(params, {"tokens": ctx},
                       last_only=True)[0][0, 0].float()
        if t > 0:
            key = request_keys(prng_key(0, device=cuda),
                               torch.tensor([rid], device=cuda),
                               torch.tensor([at], device=cuda))
            x = x / t + gumbel(key, x.shape)[0]
        top = torch.topk(x, 2).values
        assert (top[0] - top[1]).item() <= tol / (t or 1.0), (rid, at)


def test_a_failed_capture_raises(cuda):
    """A decode program that syncs the host cannot be captured: the engine
    raises and registers no decode program, and the next round raises
    again rather than running the eager round. Run in a child process, so
    the failed capture cannot touch the other tests' CUDA context."""
    import os
    import subprocess
    import sys

    import repro_torch

    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    script = """
import numpy as np, pytest, torch
from repro_torch import configs as tcfg
from repro_torch.models.model import LM
from repro_torch.serving import ServingEngine

cfg = tcfg.ModelConfig(
    name="tiny", family="dense", source="t", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=96,
    stages=tcfg.dense_stages(2), param_dtype="float32")
lm = LM(cfg, device="cuda")
eng = ServingEngine(lm, lm.init(0), batch_slots=2, max_seq_len=32)
step = eng._step_impl

def syncing(sampled=True):
    step(sampled)
    eng._state["steps"].sum().item()        # a host sync

eng._step_impl = syncing
with pytest.raises(RuntimeError, match="capturing the program .'decode'"):
    eng.warm_compile()
assert eng._programs == {} and eng.warm_compile_s is None
eng.submit(np.arange(5), max_new_tokens=3)
with pytest.raises(RuntimeError, match="capturing the program .'decode'"):
    eng.run()
assert not any(key[0] == "decode" for key in eng._programs)
print("raised")
"""
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "raised" in proc.stdout, \
        proc.stdout + proc.stderr


def test_hybrid_engine_on_gpu_goes_through_the_kernels(cuda):
    """A tiny hybrid model (rglru, rglru, attn window 8; GeGLU) served on
    the card: K=4 streams equal K=1 streams, every RG-LRU prefill scan
    and every prefill and decode attention was a kernel launch."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    base = tcfg.base
    rec = base.BlockDef(mixer=base.RGLRU, mlp=base.GELU_MLP)
    att = base.BlockDef(mixer=base.ATTN, mlp=base.GELU_MLP, window=8)
    cfg = tcfg.ModelConfig(
        name="tiny-hybrid", family="hybrid", source="t", num_layers=3,
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=96, stages=(base.Stage(blocks=(rec, rec, att),
                                          repeat=1),),
        param_dtype="float32", logit_softcap=30.0)
    lm = LM(cfg, device=cuda)
    params = lm.init(0)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 2, 16))]
    outs = []
    for k in (1, 4):
        eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                            max_decode_steps=k)
        ids = [eng.submit(p, max_new_tokens=6, temperature=0.7 * (i % 2))
               for i, p in enumerate(prompts)]
        reset_launches()
        done = eng.run()
        assert LAUNCHES == {"flash_attention": eng.admissions,
                            "decode_attention": eng.decode_steps,
                            "rglru_scan": 2 * eng.admissions,
                            "paged_decode_attention": 0, "cascade_gate": 0,
                            **NO_BACKWARD}
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_paged_engine_on_gpu_goes_through_the_paged_kernel(cuda):
    """A tiny model served on the card with the paged backend and chunked
    prefill (prefixes shared): K=4 streams equal K=1 streams, and every
    decode step and every chunk launched the paged kernel once per layer,
    nothing else."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = tcfg.ModelConfig(
        name="tiny", family="dense", source="t", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=96,
        stages=tcfg.dense_stages(3), param_dtype="float32")
    lm = LM(cfg, device=cuda)
    params = lm.init(0)
    rng = np.random.default_rng(1)
    pre = rng.integers(0, 96, 16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, 96, n)]).astype(np.int32)
               for n in (3, 9, 0)] + [rng.integers(0, 96, 20).astype(np.int32)]
    outs = []
    for k in (1, 4):
        eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                            max_decode_steps=k, cache_backend="paged",
                            block_size=8, chunk_tokens=8)
        chunks = [0]
        run_chunk = eng._run_chunk

        def counted(c, *args, run_chunk=run_chunk, chunks=chunks):
            chunks[0] += 1
            return run_chunk(c, *args)

        eng._run_chunk = counted
        ids = [eng.submit(p, max_new_tokens=6, temperature=0.7 * (i % 2))
               for i, p in enumerate(prompts)]
        reset_launches()
        done = eng.run()
        assert LAUNCHES == {"flash_attention": 0, "decode_attention": 0,
                            "paged_decode_attention":
                            3 * (eng.decode_steps + chunks[0]),
                            "cascade_gate": 0, "rglru_scan": 0, **NO_BACKWARD}
        eng.assert_invariants()
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_cascade_on_gpu_gates_through_the_kernel(cuda):
    """A tiny cascade served on the card: one ``cascade_gate`` launch per
    gated request and per one-shot batch; accepted and escalated streams
    equal standalone edge (seed 0) and cloud (seed 1) engines'."""
    from repro_torch.cascade import CascadeLM, edge_variant
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import (CascadeEngine, CascadeServingEngine,
                                     ServingEngine)

    cloud_cfg = tcfg.ModelConfig(
        name="tiny", family="dense", source="t", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=96,
        stages=tcfg.dense_stages(2), param_dtype="float32")
    edge, cloud = (LM(edge_variant(cloud_cfg, layers=1), device=cuda),
                   LM(cloud_cfg, device=cuda))
    ep, cp = edge.init(1), cloud.init(0)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9, 17, 4, 14, 7, 11))]
    kw = dict(batch_slots=2, max_seq_len=32)
    probe = CascadeServingEngine(CascadeLM(edge, cloud), ep, cp, **kw)
    conf = sorted(probe._gate(p)[0] for p in prompts)
    th = make_thresholds(hi=(conf[5] + conf[6]) / 2, lo=(conf[2] + conf[3]) / 2)
    cas = CascadeLM(edge, cloud, thresholds=th)
    eng = CascadeServingEngine(cas, ep, cp, **kw)
    ids = [eng.submit(p, max_new_tokens=4, temperature=0.7 * (i % 2))
           for i, p in enumerate(prompts)]
    reset_launches()
    done = eng.run()
    assert LAUNCHES["cascade_gate"] == len(prompts)
    assert LAUNCHES["flash_attention"] == (
        1 * (len(prompts) + eng.edge_engine.admissions)
        + 2 * eng.cloud_engine.admissions)
    for route, lm, params, seed in (("accept", edge, ep, 0),
                                    ("escalate", cloud, cp, 1)):
        mine = [(i, p) for i, p in zip(ids, prompts)
                if done[i].route == route]
        assert mine
        ref = ServingEngine(lm, params, seed=seed, **kw)
        rids = [ref.submit(p, max_new_tokens=4,
                           temperature=0.7 * (ids.index(i) % 2))
                for i, p in mine]
        out = ref.run()
        for (i, _), r in zip(mine, rids):
            np.testing.assert_array_equal(done[i].output, out[r].output)
    reset_launches()
    one = CascadeEngine(cas, ep, cp).query(
        np.random.default_rng(9).integers(0, 96, (8, 10)))
    assert LAUNCHES["cascade_gate"] == 1
    assert int(one["accept"] + one["drop"] + one["escalate"]) == 8


# -- prefill, gate and drain programs as CUDA graphs ----------------------------

def _tree_equal(a, b, skip_trash=False):
    """Two cache trees (lists and tuples of dicts of tensors) hold equal
    tensors; with ``skip_trash``, (L, N, bs, ...) pools outside block 0,
    where pad writes park in no fixed order."""
    if isinstance(a, dict):
        cut = slice(1, None) if skip_trash else slice(None)
        return all(torch.equal(a[k][:, cut], b[k][:, cut]) for k in a)
    return all(_tree_equal(x, y, skip_trash) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["admit", "chunk", "draft_fill"])
def test_a_prefill_graph_replays_for_any_request(cuda, kind):
    """One captured admission (ring), prompt chunk (paged) and draft fill
    (ring, reading two requests' generated tokens from ``out``), replayed
    for two requests of different slot, length and request id, leaves the
    slot state, the caches and the draft caches equal, bit for bit, to an
    eager engine's (graphs off) after the same calls; each replay counts
    its capture's launches."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.scheduler import bucket_for

    lm, draft = _tiny(cuda), _tiny(cuda, layers=1)
    params, dparams = lm.init(0), draft.init(7)
    kw = dict(batch_slots=4, max_seq_len=64)
    if kind == "chunk":
        kw.update(cache_backend="paged", block_size=8, chunk_tokens=16)
    if kind == "draft_fill":
        kw.update(draft_model=draft, draft_params=dparams,
                  speculative_tokens=2)
    engines = []
    for graphed in (False, True):
        eng = ServingEngine(lm, params, **kw)
        eng._use_graphs = graphed
        eng.warm_compile()
        engines.append(eng)
    warmed = dict(engines[1]._programs)
    rng = np.random.default_rng(4)
    for slot, length, rid in ((2, 5, 3), (0, 13, 11)):
        tokens = rng.integers(0, 96, length)
        launches = []
        for eng in engines:
            if kind == "admit":
                eng._args.put(slot=slot, length=length, max_new=4, temp=0.7,
                              rid=rid, row=[0], tokens=tokens)
                key = ("admit", 16)
            elif kind == "chunk":
                row = np.full(8, -1, np.int32)
                row[:2] = (1 + 2 * slot, 2 + 2 * slot)
                eng._cache_state = eng.backend.begin_slots(
                    eng._cache_state, [slot], [row], [0])
                eng._args.put(slot=slot, start=0, length=length,
                              prompt_len=length, max_new=4, temp=0.7,
                              rid=rid, final=1, tokens=tokens)
                key = ("chunk", 16, 16)
            else:
                eng._state["out"][slot, :2] = torch.tensor([rid, 2 * rid])
                eng._args.put(slot=slot, prompt_len=length,
                              length=length + 2, tokens=tokens)
                key = ("draft_fill", bucket_for(length + 2, eng.buckets))
            before = dict(LAUNCHES)
            eng._run_program(key)
            torch.cuda.synchronize()
            launches.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        eager, graphed = engines
        assert launches[0] == launches[1] and sum(launches[1].values()) > 0
        for name, t in eager._state.items():
            assert torch.equal(t, graphed._state[name]), name
        assert _tree_equal(eager._cache_state["caches"],
                           graphed._cache_state["caches"],
                           skip_trash=kind == "chunk")
        if kind == "chunk":
            assert torch.equal(eager._cache_state["tables"],
                               graphed._cache_state["tables"])
        if kind == "draft_fill":
            assert _tree_equal(eager._draft_state["caches"],
                               graphed._draft_state["caches"])
    assert engines[1]._programs == warmed
    assert engines[1].graphs() == len(warmed)


def test_rglru_scan_in_two_graphs_interleaved_with_eager(cuda):
    """The scan captured into two graphs (other shapes: other CTA counts
    on the one look-back state of the capture stream), each replayed twice
    on new inputs with an eager launch between: every result equals the
    plain version within 1e-5 of max(1, |h|)."""
    from repro_torch.serving.engine import _Program, capture_stream

    gen = torch.Generator(device=cuda).manual_seed(2)
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for i, (b, s, w) in enumerate(((2, 70, 300), (1, 300, 130))):
        ins = [torch.zeros((b, s, w), device=cuda),
               torch.zeros((b, s, w), device=cuda),
               torch.zeros((b, w), device=cuda)]
        res = [torch.zeros((b, s, w), device=cuda),
               torch.zeros((b, w), device=cuda)]

        def body(ins=ins, res=res):
            for r, x in zip(res, rglru_scan(*ins)):
                r.copy_(x)

        graphs.append((_Program(("scan", i), pool, capture_stream(cuda),
                                body), ins, res))

    def fresh(ins):
        ins[0].copy_(0.8 + 0.2 * torch.rand(ins[0].shape, generator=gen,
                                            device=cuda))
        for x in ins[1:]:
            x.copy_(torch.randn(x.shape, generator=gen, device=cuda))

    def assert_plain(ins, got):
        for r, p in zip(got, rglru_scan_plain(*ins)):
            assert ((r - p).abs() <= 1e-5 * p.abs().clamp_min(1)).all()

    for _ in range(2):
        for i, (prog, ins, res) in enumerate(graphs):
            fresh(ins)
            before = LAUNCHES["rglru_scan"]
            prog.replay(("scan", i))
            assert LAUNCHES["rglru_scan"] == before + 1
            assert_plain(ins, res)
            other = graphs[1 - i][1]
            fresh(other)
            assert_plain(other, rglru_scan(*other))


def test_rglru_scan_graph_outlives_a_state_growth(cuda):
    """A scan graph captured on the capture stream, then an eager launch
    on that stream with more CTAs than its look-back state holds flags
    for (the state grows): the graph, replayed twice on new inputs with
    an eager launch on the grown state between, still equals the plain
    version within 1e-5 of max(1, |h|), as does the large launch."""
    from repro_torch.kernels import rglru_scan as scan
    from repro_torch.serving.engine import _Program, capture_stream

    gen = torch.Generator(device=cuda).manual_seed(3)
    stream = capture_stream(cuda)

    def fresh(ins):
        ins[0].copy_(0.8 + 0.2 * torch.rand(ins[0].shape, generator=gen,
                                            device=cuda))
        for x in ins[1:]:
            x.copy_(torch.randn(x.shape, generator=gen, device=cuda))

    def assert_plain(ins, got):
        for r, p in zip(got, rglru_scan_plain(*ins)):
            assert ((r - p).abs() <= 1e-5 * p.abs().clamp_min(1)).all()

    def on_stream(fn):
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            got = fn()
        torch.cuda.current_stream(cuda).wait_stream(stream)
        return got

    ins = [torch.zeros((2, 70, 300), device=cuda),
           torch.zeros((2, 70, 300), device=cuda),
           torch.zeros((2, 300), device=cuda)]
    res = [torch.zeros((2, 70, 300), device=cuda),
           torch.zeros((2, 300), device=cuda)]

    def body():
        for r, x in zip(res, rglru_scan(*ins)):
            r.copy_(x)

    prog = _Program(("scan",), torch.cuda.graph_pool_handle(), stream, body)
    key = (ins[0].device.index, stream.cuda_stream)
    held = scan._STATE[key]
    n = held[1].numel()
    w, s = 64 * scan._THREADS, scan._MAX_CHUNK * (n // 64 + 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 64 * -(-s // scan.chunk_len(1, s, w, sms)) > n
    big = [torch.zeros((1, s, w), device=cuda),
           torch.zeros((1, s, w), device=cuda),
           torch.zeros((1, w), device=cuda)]
    fresh(big)
    assert_plain(big, on_stream(lambda: rglru_scan(*big)))
    assert scan._STATE[key][1].numel() > n
    assert any(old is held for old in scan._RETIRED)
    for _ in range(2):
        fresh(ins)
        prog.replay(("scan",))
        assert_plain(ins, res)
        small = [x.clone() for x in ins]
        fresh(small)
        assert_plain(small, on_stream(lambda: rglru_scan(*small)))
    del big


def test_gate_program_equals_the_plain_gate(cuda):
    """The cascade's gate program (edge prefill at the prompt's bucket and
    ``cascade_gate`` on the last real row), captured by ``warm_compile``:
    for prompts of several lengths its confidence, route and counts equal
    ``cascade_gate_plain`` on the same edge logits, one gate launch a
    replay, and no program is captured while gating."""
    from repro_torch.cascade import CascadeLM, edge_variant
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.models.model import LM
    from repro_torch.serving import CascadeServingEngine
    from repro_torch.serving.scheduler import bucket_for

    cloud = _tiny(cuda, layers=2)
    edge = LM(edge_variant(cloud.cfg, layers=1), device=cuda)
    ep, cp = edge.init(1), cloud.init(0)
    eng = CascadeServingEngine(
        CascadeLM(edge, cloud, thresholds=make_thresholds(0.02, 0.012)),
        ep, cp, batch_slots=2, max_seq_len=64)
    eng.warm_compile()
    warmed = dict(eng._programs)
    assert eng.graphs() == len(warmed) == len(eng.edge_engine.buckets)
    th = eng.cascade.thresholds
    for n in (3, 16, 17, 40):
        prompt = np.random.default_rng(n).integers(0, 96, n).astype(np.int32)
        before = LAUNCHES["cascade_gate"]
        conf, route = eng._gate(prompt)
        assert LAUNCHES["cascade_gate"] == before + 1
        tokens = np.zeros((1, bucket_for(n, eng.edge_engine.buckets)),
                          np.int32)
        tokens[0, :n] = prompt
        logits, _ = edge.forward(ep, {"tokens": torch.from_numpy(
            tokens).to(cuda)}, logits_index=n - 1)
        pc, pr, pn = cascade_gate_plain(logits[:, 0], th.hi, th.lo)
        assert abs(conf - pc.item()) <= 1e-5 * pc.item()
        assert route == pr.item()
        assert torch.equal(eng._gate_out["counts"], pn)
    assert eng._programs == warmed


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_graphed_drain_engine_equals_the_eager_one(cuda, temperature):
    """``DrainBatchEngine`` with every prefill bucket, both samples and the
    decode step captured by ``warm_compile`` serves two waves (a batch of
    3, then 2) with the streams of a drain engine whose graphs are off,
    token for token; its launches are flash per batch and the ring kernel per token,
    and traffic captures nothing."""
    from repro_torch.kernels import reset_launches
    from repro_torch.serving import DrainBatchEngine

    lm = _tiny(cuda)
    params = lm.init(0)
    reqs = [(np.random.default_rng(i).integers(0, 96, n).astype(np.int32), m)
            for i, (n, m) in enumerate(((5, 6), (12, 3), (20, 8), (9, 4),
                                        (33, 7)))]
    outs = []
    for graphed in (False, True):
        eng = DrainBatchEngine(lm, params, batch_slots=3, max_seq_len=64)
        eng._use_graphs = graphed
        eng.warm_compile()
        warmed = dict(eng._programs)
        assert eng.graphs() == (len(warmed) if graphed else 0)
        ids = [eng.submit(p, max_new_tokens=m, temperature=temperature)
               for p, m in reqs]
        reset_launches()
        done = eng.run()
        assert eng._programs == warmed
        steps = max(m for _, m in reqs[:3]) + max(m for _, m in reqs[3:])
        assert eng.host_syncs == steps
        assert LAUNCHES == {"flash_attention": 3 * 2,
                            "decode_attention": 3 * steps,
                            "paged_decode_attention": 0, "cascade_gate": 0,
                            "rglru_scan": 0, **NO_BACKWARD}
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# -- faults and durability on graphed engines -----------------------------------

def _greedy_near_tie(cuda, lm, params, prompts, outs, base, tol=1e-4):
    """Greedy streams equal, or part first where the teacher-forced f32
    logits' top-2 margin is within ``tol`` (a recompute-resume rebuilds the
    K/V through the prefill GEMMs instead of the decode ones)."""
    for p, a, b in zip(prompts, outs, base):
        assert len(a) == len(b)
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        at = int(diff[0])
        ctx = torch.from_numpy(np.concatenate([p, b[:at]]).astype(
            np.int32))[None].to(cuda)
        x = lm.forward(params, {"tokens": ctx},
                       last_only=True)[0][0, 0].float()
        top = torch.topk(x, 2).values
        assert (top[0] - top[1]).item() <= tol, at


def _state_ptrs(eng):
    """data_ptr of the slot state, every cache leaf and the tables."""
    ptrs = {f"state/{k}": t.data_ptr() for k, t in eng._state.items()}

    def leaves(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                leaves(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                leaves(v, f"{path}/{i}")
        elif tree is not None:
            ptrs[path] = tree.data_ptr()

    leaves(eng._cache_state, "cache")
    return ptrs


@pytest.mark.parametrize("backend", ["ring", "paged"])
def test_storage_is_stable_across_a_fault_rollback_and_a_restore(cuda,
                                                                 backend):
    """On a graphed engine (f32, K = 4) a fault schedule (a poisoned step
    and scan, a failed swap-out) rolls slots back mid-traffic, and a
    snapshot taken mid-flight restores into a second warmed engine: both
    keep the storage of their state, caches and tables (the graphs' fixed
    addresses), capture nothing in traffic, and their streams equal a
    fault-free graphed engine's or part first at a near-tie."""
    from repro_torch.serving import FaultPlan, ServingEngine

    lm = _tiny(cuda)
    params = lm.init(0)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9, 17, 3))]
    kw = dict(batch_slots=4, max_seq_len=64, max_decode_steps=4)
    if backend == "paged":
        kw.update(cache_backend="paged", block_size=8)

    def serve(eng, steps=None):
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        if steps is None:
            done = eng.run()
            return [done[i].output for i in ids]
        for _ in range(steps):
            eng.step()
        return ids

    base = ServingEngine(lm, params, **kw)
    base.warm_compile()
    ref = serve(base)
    plan = FaultPlan(seed=5, step=[1], scan=[2], swap_out=[0])
    eng = ServingEngine(lm, params, fault_plan=plan, max_retries=6, **kw)
    eng.warm_compile()
    ptrs, warmed = _state_ptrs(eng), dict(eng._programs)
    assert eng.graphs() == len(warmed)
    serve(eng, steps=5)
    assert eng.fault_recoveries >= 1
    assert _state_ptrs(eng) == ptrs and eng._programs == warmed
    fresh = ServingEngine(lm, params, **kw)
    fresh.warm_compile()
    fresh_ptrs, fresh_warmed = _state_ptrs(fresh), dict(fresh._programs)
    fresh.restore(eng.snapshot())
    done = fresh.run()
    torch.cuda.synchronize()
    assert _state_ptrs(fresh) == fresh_ptrs
    assert fresh._programs == fresh_warmed, "a restore captured a program"
    assert sorted(done) == list(range(len(prompts)))
    _greedy_near_tie(cuda, lm, params, prompts,
                     [done[i].output for i in sorted(done)], ref)
    if backend == "paged":
        assert fresh.backend.swap_ins >= 1    # K/V restored, not recomputed


def test_a_draft_fallback_and_a_recompute_resume_capture_nothing(cuda):
    """A ``draft`` fault serves a speculative round as a plain round at the
    plan's horizon, and a ``swap_out`` fault resumes a preempted slot by
    re-prefilling prompt + tokens at a larger bucket: both replay programs
    that ``warm_compile`` captured (no capture in traffic), with each
    kernel launched as the counted programs say."""
    from repro_torch.kernels import reset_launches
    from repro_torch.serving import FaultPlan, ServingEngine

    lm, draft = _tiny(cuda), _tiny(cuda, 1)
    params, dparams = lm.init(0), draft.init(7)
    prompts = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9, 17, 3))]
    plan = FaultPlan(seed=3, draft={"prob": 0.5}, swap_out=[0])
    eng = ServingEngine(lm, params, batch_slots=4, max_seq_len=64,
                        cache_backend="paged", block_size=8,
                        draft_model=draft, draft_params=dparams,
                        speculative_tokens=2, fault_plan=plan)
    eng.scheduler.spec_min_commit = 0.0
    eng.warm_compile()
    warmed = dict(eng._programs)
    n = _count_programs(eng)
    ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    reset_launches()
    for _ in range(4):
        eng.step()
    eng.preempt(next(iter(eng._slots)))      # the swap-out fails: recompute
    done = eng.run()
    torch.cuda.synchronize()
    assert eng._programs == warmed, "a program was captured in traffic"
    assert eng.spec_fallbacks > 0 and eng.spec_rounds > 0
    assert plan.fired("swap_out") == 1 and eng.backend.swap_ins == 0
    assert all(done[i].status == "done" for i in ids)
    target = 3 * (n["steps"] + n["rounds"] + n["chunks"])
    assert LAUNCHES == {"flash_attention": n["fills"] + 3 * n["admits"],
                        "decode_attention": n["draft_steps"],
                        "paged_decode_attention": target,
                        "cascade_gate": 0, "rglru_scan": 0, **NO_BACKWARD}


def _video_classifiers(dev):
    from repro_torch.configs.ace_video_query import config
    from repro_torch.models.cnn import Classifier

    vq = config()
    return [Classifier(c, device=dev) for c in (vq.eoc, vq.coc)]


def _tree_to(tree, dev):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def test_classifier_forward_on_gpu_matches_the_cpu(cuda):
    """EOC and COC at the application's widths on 64 crops: the card's
    logits against the CPU's on the same weights, with TF32 switched on
    globally around the call (the classifier turns it off for itself and
    restores it)."""
    from repro_torch.data.synthetic import synth_crops

    x, _ = synth_crops(64, seed=3)
    for gpu_model, cpu_model in zip(_video_classifiers(cuda),
                                    _video_classifiers("cpu")):
        params = cpu_model.init(1)
        want = cpu_model.apply(params, torch.from_numpy(x))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = gpu_model.apply(_tree_to(params, cuda),
                                  torch.from_numpy(x).to(cuda)).cpu()
            assert torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        err = float(torch.max(torch.abs(got - want)))
        assert err <= 1e-4 * float(torch.max(torch.abs(want))), err


def test_classifier_trains_and_banks_on_gpu(cuda):
    """A few ``train_classifier`` steps on the card lower the loss, and the
    bank pass on the trained weights equals the CPU's (confidences 1e-4,
    booleans away from near-ties)."""
    from repro_torch.data import video
    from repro_torch.data.synthetic import synth_crops

    eoc, coc = _video_classifiers(cuda)
    imgs, lbls = synth_crops(1024, seed=0)
    # the first step's batch: default_rng(seed)'s first draw
    idx = np.random.default_rng(0).integers(0, 1024, size=64)
    with torch.no_grad():
        loss0, _ = coc.loss(coc.init(0), torch.from_numpy(imgs[idx]).to(cuda),
                            torch.from_numpy(lbls[idx].astype(np.int64))
                            .to(cuda))
    coc_p, rep = video.train_classifier(coc, imgs, lbls, steps=30, batch=64)
    assert np.isfinite(rep["loss"]) and rep["loss"] < float(loss0)
    eoc_p, _ = video.train_classifier(
        eoc, imgs, (lbls == video.TARGET_CLASS).astype(np.int32), steps=10,
        batch=64, seed=2)
    bank, _ = synth_crops(256, seed=1)
    got = [t.cpu() for t in video.bank_pass(eoc, coc, eoc_p, coc_p,
                                            torch.from_numpy(bank).to(cuda))]
    eoc_c, coc_c = _video_classifiers("cpu")
    eoc_pc, coc_pc = _tree_to(eoc_p, "cpu"), _tree_to(coc_p, "cpu")
    want = video.bank_pass(eoc_c, coc_c, eoc_pc, coc_pc,
                           torch.from_numpy(bank))
    assert float(torch.max(torch.abs(got[0] - want[0]))) < 1e-4
    with torch.no_grad():
        ties = video.bank_near_ties(want[0], coc_c.apply(
            coc_pc, torch.from_numpy(bank)), 1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[~ties], b[~ties])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partitioned_lm_on_gpu_matches_forward(cuda, dtype):
    """Edge then cloud at every split equals ``LM.forward`` bit for bit,
    each full pass launching flash once per layer."""
    from repro_torch.core.patterns.inference import PartitionedLM
    from repro_torch.kernels import reset_launches

    lm = _tiny(cuda, layers=3, dtype=dtype)
    params = lm.init(0)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, 96, (2, 40)).astype(np.int32)).to(cuda)
    reset_launches()
    full, _ = lm.forward(params, {"tokens": tok})
    assert LAUNCHES["flash_attention"] == 3
    for split in range(4):
        part = PartitionedLM(lm, split)
        reset_launches()
        hidden, pos = part.edge_forward(params, {"tokens": tok})
        assert LAUNCHES["flash_attention"] == split
        logits = part.cloud_forward(params, hidden, pos)
        assert LAUNCHES["flash_attention"] == 3
        assert torch.equal(logits, full), split


# -- MoE and MLA -------------------------------------------------------------------

def _moe_model(cuda, name, dtype="float32"):
    """``name``'s reduced config (4 experts, top-2; deepseek's MLA and
    shared expert) on the CPU in f32, params from seed 0."""
    from repro_torch.models.model import LM

    cfg = tcfg.get_config(name).reduced()
    import dataclasses
    cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return cfg, LM(cfg, device="cpu").init(0)


def _moe_params(cfg, params):
    """The first MoE layer's MLP params of a stacked tree."""
    for st_cfg, st in zip(cfg.stages, params["stages"]):
        for i, bdef in enumerate(st_cfg.blocks):
            if bdef.mlp == "moe":
                return {k: (v[0] if not isinstance(v, dict)
                            else {kk: vv[0] for kk, vv in v.items()})
                        for k, v in st[f"b{i}"]["mlp"].items()}
    raise AssertionError("no MoE layer")


@pytest.mark.parametrize("factor", [1.25, 2.0])
@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_forward_on_gpu_matches_the_cpu(cuda, name, factor):
    """``moe_forward`` at reduced width, f32 (TF32 off), on the card and
    on the CPU, at ``repro``'s 1.25 and dropless (E / k = 2): the same
    routes and drops, outputs and aux within 1e-5 (summation order)."""
    from repro_torch.models import moe as moe_lib

    cfg, params = _moe_model(cuda, name)
    mp = _moe_params(cfg, params)
    x = torch.randn((3, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    idx, _, _ = moe_lib.route(mp, cfg, x.reshape(-1, cfg.d_model))
    gidx, _, _ = moe_lib.route(_to(mp, cuda), cfg,
                               x.reshape(-1, cfg.d_model).to(cuda))
    assert torch.equal(idx, gidx.cpu())
    y, aux = moe_lib.moe_forward(mp, cfg, x, capacity_factor=factor)
    gy, gaux = moe_lib.moe_forward(_to(mp, cuda), cfg, x.to(cuda),
                                   capacity_factor=factor)
    assert (gy.cpu() - y).abs().max().item() < 1e-5
    assert abs(gaux.item() - aux.item()) < 1e-5
    assert int(moe_lib.dropped_pairs(_to(mp, cuda), cfg, x.to(cuda),
                                     capacity_factor=factor)) == int(
        moe_lib.dropped_pairs(mp, cfg, x, capacity_factor=factor))


def test_captured_moe_forward_and_mla_decode_replay_on_new_inputs(cuda):
    """``moe_forward`` and an MLA decode step over a ring, each captured
    into a CUDA graph once and replayed on two new inputs: each replay
    equals the eager call on the same inputs (output and cache) bit for
    bit (the same kernels on the same shapes)."""
    from repro_torch.models import attention as att
    from repro_torch.models import moe as moe_lib

    cfg, params = _moe_model(cuda, "deepseek-v3-671b")
    params = _to(params, cuda)
    mp = _moe_params(cfg, params)
    mla = {k: v[0] for k, v in params["stages"][0]["b0"]["mixer"].items()}
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, w = 4, 32
    x = torch.zeros((b, 5, cfg.d_model), device=cuda)
    x1 = torch.zeros((b, 1, cfg.d_model), device=cuda)
    pos = torch.zeros((b,), dtype=torch.int32, device=cuda)
    cache = att.init_mla_cache(cfg, b, w, torch.float32, cuda)
    res = {}

    def body():
        res["moe"] = moe_lib.moe_forward(mp, cfg, x)[0]
        res["mla"] = att.mla_decode(mla, cfg, x1, cache, pos, window=None)[0]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()                                   # warm-up off the graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for step in range(2):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
        x1.copy_(torch.randn(x1.shape, generator=gen, device=cuda))
        pos.copy_(torch.tensor([3, 10, 0, 31], device=cuda) + step)
        before = {k: v.clone() for k, v in cache.items()}
        graph.replay()
        torch.cuda.synchronize()
        after = {k: v.clone() for k, v in cache.items()}
        want_moe = moe_lib.moe_forward(mp, cfg, x)[0]
        again = {k: v.clone() for k, v in before.items()}
        want_mla = att.mla_decode(mla, cfg, x1, again, pos, window=None)[0]
        assert torch.equal(res["moe"], want_moe)
        assert torch.equal(res["mla"], want_mla)
        for key in cache:
            assert torch.equal(after[key], again[key])


@pytest.mark.parametrize("backend", ["ring", "paged"])
@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_engine_on_gpu_graphed_equals_eager(cuda, name, backend):
    """Reduced mixtral and deepseek (f32, dropless) through a graphed
    engine (K = 2; the paged one with 8-token chunks) and an eager one:
    no program captured in traffic, equal streams, and the attention
    kernels launched as counted (MLA layers launch flash at admission on
    the ring and nothing else)."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg, params = _moe_model(cuda, name)
    lm = LM(cfg, device=cuda, capacity_factor=2.0)
    params = _to(params, cuda)
    prompts = [np.random.default_rng(i).integers(0, 500, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 9, 17))]
    kw = dict(batch_slots=4, max_seq_len=64, max_decode_steps=2)
    if backend == "paged":
        kw.update(cache_backend="paged", block_size=8, chunk_tokens=8)
    outs = {}
    for graphed in (False, True):
        eng = ServingEngine(lm, params, **kw)
        eng._use_graphs = graphed
        eng.warm_compile()
        warmed = dict(eng._programs)
        n = _count_programs(eng)
        ids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        reset_launches()
        done = eng.run()
        torch.cuda.synchronize()
        assert eng._programs == warmed
        attn = sum(st.repeat for st in cfg.stages for bd in st.blocks
                   if bd.mixer == "attn")
        layers = sum(st.repeat for st in cfg.stages)
        paged = backend == "paged"
        assert LAUNCHES == {
            "flash_attention": 0 if paged else layers * n["admits"],
            "decode_attention": 0 if paged else attn * n["steps"],
            "paged_decode_attention": (attn * (n["steps"] + n["chunks"])
                                       if paged else 0),
            "cascade_gate": 0, "rglru_scan": 0, **NO_BACKWARD}
        outs[graphed] = [done[i].output for i in ids]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


# -- xLSTM and the modality frontends ---------------------------------------------

def _cut(name, layers, dtype="float32"):
    """``name`` at full width with its stage repeated to ``layers`` layers,
    in ``dtype``."""
    import dataclasses
    cfg = tcfg.get_config(name)
    st = cfg.stages[0]
    return dataclasses.replace(
        cfg, param_dtype=dtype, num_layers=layers,
        stages=(dataclasses.replace(st, repeat=layers // len(st.blocks)),))


def test_xlstm_forward_on_gpu_matches_the_cpu(cuda):
    """xlstm-125m at full width cut to 4 layers (two mLSTM, two sLSTM), f32
    (TF32 off): the card's forward, and a prefill + decode step, equal the
    CPU's within 1e-4 (summation order)."""
    from repro_torch.models.model import LM

    cfg = _cut("xlstm-125m", 4)
    cpu = LM(cfg, device="cpu")
    params = cpu.init(0)
    gparams = _to(params, cuda)
    lm = LM(cfg, device=cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 70),
                        generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    want, _ = cpu.forward(params, {"tokens": tok})
    got, _ = lm.forward(gparams, {"tokens": tok.to(cuda)})
    assert (got.cpu() - want).abs().max().item() < 1e-4
    _, caches = lm.prefill(gparams, {"tokens": tok[:, :69].to(cuda)},
                           cache_width=70)
    step, _ = lm.decode_step(gparams, caches, tok[:, 69:].to(cuda), 69)
    assert (step[:, 0].cpu() - want[:, 69]).abs().max().item() < 1e-4


@pytest.mark.parametrize("name", ["internvl2-2b", "musicgen-medium"])
def test_modal_decode_step_on_gpu_goes_through_the_kernels(cuda, name):
    """A reduced internvl2-2b (its image prefix) and musicgen-medium (a
    (B, S, 4) grid), f32: the prefill runs flash once a layer, each decode
    step the ring kernel once a layer, and the logits equal the CPU's
    within 1e-4."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.frontend import make_batch
    from repro_torch.models.model import LM

    cfg = tcfg.get_config(name).reduced()
    cpu, lm = LM(cfg, device="cpu"), LM(cfg, device=cuda)
    params = cpu.init(0)
    gparams = _to(params, cuda)
    batch = make_batch(torch.Generator().manual_seed(3), cfg, 2, 20)
    batch.pop("labels")
    # make_batch's 20 positions hold the image prefix and the text
    text = batch["tokens"].shape[1]
    prefix = cfg.frontend.num_prefix_tokens if "image_embeds" in batch \
        else 0
    width = prefix + text + 3
    want, caches = cpu.prefill(params, batch, cache_width=width)
    reset_launches()
    got, gcaches = lm.prefill(gparams, _to(batch, cuda), cache_width=width)
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    assert (got.cpu() - want).abs().max().item() < 1e-4
    tok = batch["tokens"][:, -1:]
    for t in range(3):
        pos = prefix + text + t
        want, caches = cpu.decode_step(params, caches, tok, pos)
        got, gcaches = lm.decode_step(gparams, gcaches, tok.to(cuda), pos)
        assert (got.cpu() - want).abs().max().item() < 1e-4
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == 3 * cfg.num_layers
    assert LAUNCHES["flash_attention"] == cfg.num_layers


def test_xlstm_engine_on_gpu_graphed_equals_eager(cuda):
    """A reduced xlstm-125m (f32) on the ring engine, K = 4: the graphed
    engine (its admissions capture the sLSTM's sequential steps) gives the
    eager engine's streams, captures nothing in traffic and launches none
    of the five kernels (``repro``'s mLSTM and sLSTM are jnp)."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = tcfg.get_config("xlstm-125m").reduced()
    lm = LM(cfg, device=cuda)
    params = lm.init(0)
    prompts = [np.random.default_rng(i).integers(0, 500, n).astype(np.int32)
               for i, n in enumerate((5, 12, 20, 2, 16, 33))]
    outs = []
    for graphs in (False, True):
        eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                            max_decode_steps=4, seed=1)
        eng._use_graphs = graphs
        eng.warm_compile()
        keys = dict(eng._programs)
        assert eng.graphs() == (len(keys) if graphs else 0)
        ids = [eng.submit(p, max_new_tokens=6, temperature=0.7 * (i % 2))
               for i, p in enumerate(prompts)]
        reset_launches()
        done = eng.run()
        assert not any(LAUNCHES.values())
        assert dict(eng._programs) == keys
        outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# (b, sq, sk, h, kv, hd, window): the backward's edges (ragged tiles, Sq <
# Sk, Sq > Sk with rows that see nothing, windows, hd 8 to 256) and the
# training layouts of chip_smoke.py's phase 18: smollm-135m, qwen3-4b,
# deepseek-v3-671b's MLA and recurrentgemma-9b
FLASH_BWD_CASES = [
    (1, 64, 64, 4, 4, 32, None),
    (2, 100, 100, 6, 2, 64, None),
    (1, 70, 150, 4, 2, 128, None),
    (1, 90, 60, 4, 2, 64, None),
    (2, 200, 200, 4, 4, 8, 24),
    (1, 70, 90, 4, 1, 40, 16),
    (2, 130, 130, 8, 8, 192, 50),
    (1, 300, 300, 16, 1, 256, 100),
    (8, 512, 512, 9, 3, 64, None),
    (1, 512, 512, 32, 8, 128, None),
    (1, 512, 512, 128, 128, 192, None),
    (1, 4096, 4096, 16, 1, 256, 2048),
    # a rank's heads when training on a model axis: glm4-9b's 32 over 2 KV
    # heads on 4 ranks (8 over 1), qwen3-4b's on 2 (16 over 4)
    (1, 4096, 4096, 8, 1, 128, None),
    (2, 256, 256, 16, 4, 128, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=[str(c) for c in FLASH_BWD_CASES])
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    """The forward kernel's log-sum-exp against the plain one, then the
    backward kernels' dq, dk, dv against ``flash_attention_bwd_plain`` on
    the same (q, k, v, out, lse, dout); a row that sees no key gets 0."""
    import repro_torch.kernels.flash_attention as fa
    b, sq, sk, h, kv, hd, window = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cpu").manual_seed(11)
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda, dt)
                   for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                                 (b, sk, kv, hd), (b, sq, h, hd)))
    out, lse = fa._launch(q, k, v, True, window, hd ** -0.5, with_lse=True)
    _, lse_ref = flash_attention_fwd_plain(q, k, v, window=window)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() < 1e-3
    n = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == n + 1
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, window=window)
    for g, r in zip(got, ref):
        assert g.dtype == dt and g.shape == r.shape
        diff = (g.float() - r.float()).flatten(2)
        if dt == torch.float32:
            scale = max(1.0, r.abs().max().item())
            assert diff.abs().max().item() <= 1e-4 * scale
        else:
            # a row's norm floored at 1e-3 of the median row's: the first
            # query's dq cancels to 0 (one key seen: P = 1, dP = D)
            den = r.float().flatten(2).norm(dim=-1)
            den = den.clamp_min(1e-3 * den[den > 0].median())
            assert (diff.norm(dim=-1) / den).max().item() < 1e-2
    if sq > sk:          # rows that see no key: zero gradients
        assert not got[0][:, :sq - sk].any()


def test_flash_autograd_counts_launches_and_serving_writes_no_lse(
        cuda, monkeypatch):
    """Under autograd ``flash_attention`` launches the forward kernel with
    the log-sum-exp once and the backward once, and equals the serving
    launch's output; without a gradient it takes the serving launch, which
    writes no log-sum-exp."""
    import repro_torch.kernels.flash_attention as fa
    asked = []
    launch = fa._launch

    def recording(*a, with_lse=False, **kw):
        asked.append(with_lse)
        return launch(*a, with_lse=with_lse, **kw)

    monkeypatch.setattr(fa, "_launch", recording)
    gen = torch.Generator(device="cpu").manual_seed(12)
    q, k, v = (torch.randn(s, generator=gen).to(cuda, torch.bfloat16)
               for s in ((2, 80, 6, 64), (2, 80, 2, 64), (2, 80, 2, 64)))
    with torch.no_grad():
        served = flash_attention(q, k, v, window=32)
    assert asked == [False]
    before = dict(LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, window=32)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    torch.cuda.synchronize()
    assert asked == [False, True]
    assert torch.equal(out.detach(), served)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "flash_attention": 1, "flash_attention_bwd": 1, "decode_attention": 0,
        "paged_decode_attention": 0, "cascade_gate": 0, "rglru_scan": 0,
        "rglru_scan_bwd": 0}
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


# the last two: recurrentgemma-9b's width on a 2- and a 4-way model axis
RGLRU_BWD_CASES = [(1, 512, 4096), (1, 4096, 4096), (2, 77, 4000),
                   (2, 77, 1001), (3, 1, 129), (1, 33, 128), (1, 65536, 128),
                   (8, 2048, 1024), (1, 4096, 2048), (1, 4096, 1024)]


@pytest.mark.parametrize("case", RGLRU_BWD_CASES,
                         ids=[str(c) for c in RGLRU_BWD_CASES])
def test_rglru_scan_bwd_kernel_matches_plain(cuda, case):
    """The reverse mode's da, db, dh0 against the plain reverse loop from
    the forward kernel's states (h0 != 0, both output gradients), and a
    repeated call, with a forward launch between, gives equal bits."""
    b, s, w = case
    gen = torch.Generator(device="cpu").manual_seed(s + w + 1)
    a = (0.8 + 0.1999 * torch.rand((b, s, w), generator=gen)).to(cuda)
    x, dh = (torch.randn((b, s, w), generator=gen).to(cuda) for _ in "xy")
    h0, dl = (torch.randn((b, w), generator=gen).to(cuda) for _ in "xy")
    h, _ = rglru_scan(a, x, h0)
    n = LAUNCHES["rglru_scan_bwd"]
    got = rglru_scan_bwd(a, h, h0, dh, dl)
    rglru_scan(a, dh, h0)
    again = rglru_scan_bwd(a, h, h0, dh, dl)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan_bwd"] == n + 2
    ref = rglru_scan_bwd_plain(a, h, h0, dh, dl)
    # da_t = g_t h_{t-1} carries g's error (db's) times h_{t-1}
    prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    scales = (prev.abs().clamp_min(1) * ref[1].abs().clamp_min(1),
              ref[1].abs().clamp_min(1), ref[2].abs().clamp_min(1))
    for g, r, sc, g2 in zip(got, ref, scales, again):
        assert torch.all((g - r).abs() <= 1e-5 * sc)
        assert torch.equal(g, g2)


def test_rglru_autograd_counts_launches(cuda):
    """Under autograd ``rglru_scan`` launches the forward once and the
    reverse mode once, and its gradients equal the plain reverse loop's."""
    gen = torch.Generator(device="cpu").manual_seed(13)
    a = (0.8 + 0.1999 * torch.rand((2, 300, 512), generator=gen)).to(cuda)
    x = torch.randn((2, 300, 512), generator=gen).to(cuda)
    h0 = torch.randn((2, 512), generator=gen).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (a, x, h0)]
    before = dict(LAUNCHES)
    h, last = rglru_scan(*leaves)
    grads = torch.autograd.grad(h.sum() + 2 * last.sum(), leaves)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "rglru_scan": 1, "rglru_scan_bwd": 1, "flash_attention": 0,
        "flash_attention_bwd": 0, "decode_attention": 0,
        "paged_decode_attention": 0, "cascade_gate": 0}
    dl = torch.full_like(h0, 2.0)
    ref = rglru_scan_bwd_plain(a, h.detach(), h0, torch.ones_like(h), dl)
    prev = torch.cat([h0[:, None], h.detach()[:, :-1]], dim=1)
    scales = (prev.abs().clamp_min(1) * ref[1].abs().clamp_min(1),
              ref[1].abs().clamp_min(1), ref[2].abs().clamp_min(1))
    for g, r, sc in zip(grads, ref, scales):
        assert torch.all((g - r).abs() <= 1e-5 * sc)


@pytest.mark.parametrize("name", ["smollm-135m", "recurrentgemma-9b",
                                  "deepseek-v3-671b"])
def test_train_step_on_gpu_matches_the_cpu(cuda, name):
    """``loss_and_grads`` of a ``.reduced()`` config in f32 on the card
    (through both backward kernels where the config has their layers)
    against the CPU on the same weights and batch."""
    from repro_torch.models.model import LM
    from repro_torch.training import loss_and_grads
    from repro_torch.utils.tree import flat_paths, tree_map

    cfg = tcfg.get_config(name).reduced()
    params = LM(cfg, device="cpu").init(0)
    rng = np.random.default_rng(14)
    tokens = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    ref = loss_and_grads(LM(cfg, device="cpu"), params, batch)
    got = loss_and_grads(LM(cfg, device=cuda),
                         tree_map(lambda t: t.to(cuda), params),
                         {k: t.to(cuda) for k, t in batch.items()})
    assert abs(float(got[0]) - float(ref[0])) <= 1e-5 * abs(float(ref[0]))
    want = flat_paths(ref[2])
    for key, g in flat_paths(got[2]).items():
        scale = want[key].abs().max().item()
        assert (g.cpu() - want[key]).abs().max().item() <= 1e-4 * scale, key


# -- tensor-parallel serving ---------------------------------------------------
# (h, row, kv_range, hd, t): a rank's query heads over the KV heads of its
# cache row: glm4-9b on 4 ranks (8 query heads a rank over both KV heads,
# which every rank keeps whole; each rank reads one) at T = 1 and the verify
# chunk T = 5, and the same at 2 query heads a rank; the whole row
# (qwen3-4b on 2 ranks: 16 heads over its own 4 KV heads) as the identity
KV_RANGE_CASES = [(8, 2, (0, 1), 128, 1), (8, 2, (1, 1), 128, 5),
                  (2, 2, (1, 1), 64, 1), (16, 4, (0, 4), 128, 1),
                  (6, 4, (1, 3), 32, 8)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KV_RANGE_CASES,
                         ids=[str(c) for c in KV_RANGE_CASES])
def test_decode_kernels_read_a_kv_range_in_place(cuda, case, dtype, paged):
    """The ring and paged kernels at a tensor-parallel rank's shapes, their
    ``kv_range`` read in place: against the plain version on the same
    range, and bit for bit against the kernel on a copy of the range."""
    h, row, (first, count), hd, t = case
    dt = getattr(torch, dtype)
    if paged:
        q, k, v, q_pos, pos, bt = _pool(cuda, dt, h, row, hd, 16, (300, 77),
                                        t)

        def run(kk, vv, rng=None):
            return paged_decode_attention(q, kk, vv, q_pos, pos, bt,
                                          kv_range=rng)

        def plain(rng):
            return paged_decode_attention_plain(q, k, v, q_pos, pos, bt,
                                                kv_range=rng)
        name = "paged_decode_attention"
    else:
        q, k, v, q_pos, k_pos = _ring(cuda, dt, 2, 512, h, row, hd, 300,
                                      300, t)

        def run(kk, vv, rng=None):
            return decode_attention(q, kk, vv, q_pos, k_pos, kv_range=rng)

        def plain(rng):
            return decode_attention_plain(q, k, v, q_pos, k_pos,
                                          kv_range=rng)
        name = "decode_attention"
    n = LAUNCHES[name]
    out = run(k, v, (first, count))
    torch.cuda.synchronize()
    assert LAUNCHES[name] == n + 1
    _assert_attention(out, plain((first, count)), dt)
    copy = run(k[..., first:first + count, :].contiguous(),
               v[..., first:first + count, :].contiguous())
    assert torch.equal(out, copy)


# (b, s, h, kv, hd): a rank's prefill: glm4-9b on 4 ranks (8 query heads
# over the one KV head they read, copied out of both), qwen3-4b on 2 (16
# over 4) and starcoder2-7b on 4 (9 over 1)
TP_FLASH_CASES = [(1, 300, 8, 1, 128), (2, 200, 16, 4, 128),
                  (1, 300, 9, 1, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TP_FLASH_CASES,
                         ids=[str(c) for c in TP_FLASH_CASES])
def test_flash_kernel_at_per_rank_shapes(cuda, case, dtype):
    b, s, h, kv, hd = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cpu").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dt) for shape in
               ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    n = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n + 1
    _assert_attention(out, flash_attention_plain(q, k, v), dt)


@contextlib.contextmanager
def _process_group(backend):
    """A one-rank process group in this process, and its mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_host_mesh
    dist.init_process_group(backend, rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        yield make_host_mesh(1, device="cuda:0")
    finally:
        dist.destroy_process_group()


def _mesh_model(cuda):
    from repro_torch.models.model import LM
    cfg = tcfg.ModelConfig(
        name="tp-tiny", family="dense", source="t", num_layers=2,
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=500, stages=tcfg.dense_stages(2), param_dtype="bfloat16")
    return LM(cfg, device=cuda)


def _mesh_trace():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 500, 4 + 3 * i).astype(np.int32), 6,
             0.7 * (i % 2)) for i in range(5)]


@pytest.mark.parametrize("backend", ["ring", "paged"])
def test_nccl_mesh_of_one_equals_mesh_none_with_collectives_captured(
        cuda, backend):
    """A one-rank NCCL mesh: every split is the whole, every collective the
    identity, so the graphed streams equal the ``mesh=None`` engine's bit
    for bit; each decode program's graph holds its collectives (all-reduces:
    one for the embedding and two a layer; one all-gather of the logits, a
    step)."""
    from repro_torch.serving import ServingEngine
    lm = _mesh_model(cuda)
    params = lm.init(0)
    outs = []
    with _process_group("nccl") as mesh:
        for m in (None, mesh):
            eng = ServingEngine(lm, params, batch_slots=3, max_seq_len=64,
                                cache_backend=backend, max_decode_steps=2,
                                mesh=m)
            eng.warm_compile()
            ids = [eng.submit(p, max_new_tokens=n, temperature=t)
                   for p, n, t in _mesh_trace()]
            done = eng.run()
            eng.assert_invariants()
            outs.append([done[i].output for i in ids])
            progs = eng._programs
            assert eng.graphs() == len(progs)
            per_step = 1 + 2 * lm.cfg.num_layers
            for key, prog in progs.items():
                got, gathers = (tally(prog.collectives)[k]
                                for k in ("all_reduce", "all_gather"))
                if m is None:
                    assert got == 0 and gathers == 0, key
                elif key[0] == "decode":
                    assert got == per_step * key[1], (key, got)
                    assert gathers == key[1], (key, gathers)
                else:
                    assert got > 0 and gathers > 0, key
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_gloo_mesh_on_the_card_serves_eager_and_refuses_capture(cuda):
    """gloo's collectives run on the host: an engine on a gloo mesh on the
    card captures nothing, ``warm_compile`` raises and says why, and its
    eager streams equal the eager ``mesh=None`` engine's."""
    from repro_torch.serving import ServingEngine
    lm = _mesh_model(cuda)
    params = lm.init(0)
    outs = []
    with _process_group("gloo") as mesh:
        for m in (None, mesh):
            eng = ServingEngine(lm, params, batch_slots=3, max_seq_len=64,
                                cache_backend="paged", mesh=m)
            if m is None:
                eng._use_graphs = False
            else:
                with pytest.raises(RuntimeError, match="cannot be captured"):
                    eng.warm_compile()
            ids = [eng.submit(p, max_new_tokens=n, temperature=t)
                   for p, n, t in _mesh_trace()]
            done = eng.run()
            eng.assert_invariants()
            assert eng.graphs() == 0
            outs.append([done[i].output for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _one_moe_layer(name):
    """``name`` at full width cut to one layer of its MoE stage (MLA for
    deepseek-v3-671b), without the MTP head."""
    import dataclasses
    base = tcfg.get_config(name)
    stage = dataclasses.replace(base.stages[-1], repeat=1)
    return dataclasses.replace(base, num_layers=1, stages=(stage,),
                               mtp_depth=0)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_and_mla_on_an_nccl_mesh_of_one_bit_equal_and_captured(
        cuda, name):
    """One full-width MoE layer (and deepseek's MLA) on a one-rank NCCL
    mesh: ``moe_forward`` at 1.25 and dropless, MLA prefill and a decode
    step over a ring are bit-equal to ``mesh=None`` with the same drops
    (every split the whole, every collective the identity); captured into
    a CUDA graph, the router's all-gather and the MoE (and MLA) all-reduce
    are inside it, and a replay on new inputs equals the eager
    ``mesh=None`` call bit for bit."""
    from repro_torch.models import attention as att
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import _Program, capture_stream
    from repro_torch.serving.sharding import place_params
    from repro_torch.sharding import tensor_parallel

    cfg = _one_moe_layer(name)
    lm = LM(cfg, device=cuda)
    params = lm.init(0, on_device=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dt = lm.dtype
    x = torch.randn((2, 16, cfg.d_model), generator=gen, device=cuda).to(dt)
    x1 = torch.randn((2, 1, cfg.d_model), generator=gen, device=cuda).to(dt)
    pos = torch.tensor([16, 9], dtype=torch.int32, device=cuda)
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    mla = cfg.mla is not None
    with _process_group("nccl") as mesh:
        tp = tensor_parallel(cfg, mesh)
        local = place_params(mesh, lm, params)
        full_mlp, mesh_mlp = (_moe_params(cfg, p) for p in (params, local))
        for cf in (1.25, e / k):
            y, aux = moe_lib.moe_forward(full_mlp, cfg, x, capacity_factor=cf)
            ym, auxm = moe_lib.moe_forward(mesh_mlp, cfg, x,
                                           capacity_factor=cf, tp=tp)
            assert torch.equal(y, ym) and torch.equal(aux, auxm)
            assert int(moe_lib.dropped_pairs(
                mesh_mlp, cfg, x, capacity_factor=cf, tp=tp)) == int(
                moe_lib.dropped_pairs(full_mlp, cfg, x, capacity_factor=cf))
        if mla:
            full_att, mesh_att = ({n: v[0] for n, v in
                                   p["stages"][0]["b0"]["mixer"].items()}
                                  for p in (params, local))
            positions = torch.arange(16, dtype=torch.int32,
                                     device=cuda)[None].expand(2, 16)
            caches = []
            for p, t in ((full_att, None), (mesh_att, tp)):
                got, (ckv, krope) = att.mla_forward(p, cfg, x, positions,
                                                    window=None, tp=t)
                cache = att.init_mla_cache(cfg, 2, 32, dt, cuda)
                att.mla_cache_fill(cache, ckv, krope, 16)
                step, cache = att.mla_decode(p, cfg, x1, cache, pos,
                                             window=None, tp=t)
                caches.append((got, step, cache))
            (a, sa, ca), (b, sb, cb) = caches
            assert torch.equal(a, b) and torch.equal(sa, sb)
            for key in ca:
                assert torch.equal(ca[key], cb[key])
        res = {}

        def body():
            res["moe"] = moe_lib.moe_forward(mesh_mlp, cfg, x, tp=tp)[0]
            if mla:
                res["mla"] = att.mla_decode(mesh_att, cfg, x1, cb, pos,
                                            window=None, tp=tp)[0]

        body()                                   # eager collectives first
        prog = _Program(("moe",), torch.cuda.graph_pool_handle(),
                        capture_stream(cuda), body, meshed=True)
        assert tally(prog.collectives) == {
            "all_reduce": 1 + mla, "all_gather": 1, "broadcast": 0,
            "reduce_scatter": 0}, prog.collectives
        for step in range(2):
            x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
            x1.copy_(torch.randn(x1.shape, generator=gen, device=cuda))
            pos.add_(1)
            if mla:
                before = {n: v.clone() for n, v in cb.items()}
            prog.replay(("moe",))
            torch.cuda.synchronize()
            assert torch.equal(res["moe"], moe_lib.moe_forward(
                full_mlp, cfg, x)[0])
            if mla:
                want, again = att.mla_decode(full_att, cfg, x1, before, pos,
                                             window=None)
                assert torch.equal(res["mla"], want)
                for key in cb:
                    assert torch.equal(cb[key], again[key])


class _StandInMesh:
    """A mesh's shape, rank, ``axis_rank`` and ``shard``, without a process
    group: what placement and the sharded init read."""

    def __init__(self, n, rank):
        self.shape, self.rank = {"data": 1, "model": n}, rank

    def axis_rank(self, axis):
        return self.rank if axis in ("model", "world") else 0

    def shard(self, x, dim):
        w = x.shape[dim] // self.shape["model"]
        return x.narrow(dim, self.rank * w, w)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "xlstm-125m"])
def test_sharded_init_on_the_card_equals_placed_whole_init(cuda, name):
    """``LM.init(seed, on_device=True, mesh=)`` draws each stacked leaf a
    layer at a time on the card, cuts this rank's slice and frees the
    rest: bit for bit ``place_params`` of the whole on-card init, for
    every rank of 2 and 4 (the reduced configs, two layers a stage: MoE
    layers; the RG-LRU's ``lam`` and the xLSTM's constant leaves)."""
    import dataclasses

    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import place_params
    from repro_torch.utils.tree import flat_paths

    cfg = tcfg.get_config(name).reduced()
    stages = tuple(dataclasses.replace(st, repeat=2) for st in cfg.stages)
    cfg = dataclasses.replace(cfg, stages=stages, num_layers=sum(
        2 * len(st.blocks) for st in stages))
    lm = LM(cfg, device=cuda)
    whole = lm.init(4, on_device=True)
    for n in (2, 4):
        for rank in range(n):
            mesh = _StandInMesh(n, rank)
            want = flat_paths(place_params(mesh, lm, whole))
            got = flat_paths(lm.init(4, on_device=True, mesh=mesh))
            assert sorted(got) == sorted(want)
            for key, t in want.items():
                assert torch.equal(got[key], t), (n, rank, key)


@pytest.mark.parametrize("w", [2048, 1024])
def test_rglru_scan_at_the_mesh_rank_widths(cuda, w):
    """The scan at the width a rank of recurrentgemma-9b's 4,096 channels
    scans on a 2- and a 4-way mesh, at its longest prefill (S = 4096):
    within 1e-5 of max(1, |h|) of the plain version, one launch."""
    test_rglru_scan_kernel_matches_plain(cuda, (1, 4096, w))


def _rec_mesh_model(cuda, name):
    """The reduced ``name`` in bf16 on the card."""
    import dataclasses

    from repro_torch.models.model import LM
    cfg = dataclasses.replace(tcfg.get_config(name).reduced(),
                              param_dtype="bfloat16")
    return LM(cfg, device=cuda)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-125m"])
def test_recurrent_nccl_mesh_of_one_equals_mesh_none_with_collectives(
        cuda, name):
    """The reduced hybrid and xlstm on a one-rank NCCL mesh, the ring
    engine graphed: streams bit-equal to the ``mesh=None`` engine's (every
    split the whole, every collective the identity, the gates' partials
    rounded where ``mesh=None``'s GEMM rounds); each decode program's graph
    holds its collectives: the embedding's all-reduce, two an RG-LRU
    block, one an attention, mLSTM or sLSTM mixer and one a GeGLU MLP, an
    all-gather an sLSTM block and one of the logits, a step."""
    from repro_torch.serving import ServingEngine
    lm = _rec_mesh_model(cuda, name)
    params = lm.init(0, on_device=True)
    reduces = gathers = 1
    for st in lm.cfg.stages:
        for b in st.blocks:
            reduces += st.repeat * ((2 if b.mixer == "rglru" else 1)
                                    + (b.mlp != "none"))
            gathers += st.repeat * (b.mixer == "slstm")
    outs, launches = [], []
    with _process_group("nccl") as mesh:
        for m in (None, mesh):
            eng = ServingEngine(lm, params, batch_slots=3, max_seq_len=64,
                                max_decode_steps=2, mesh=m)
            eng.warm_compile()
            before = dict(LAUNCHES)
            ids = [eng.submit(p, max_new_tokens=n, temperature=t)
                   for p, n, t in _mesh_trace()]
            done = eng.run()
            eng.assert_invariants()
            launches.append({k: LAUNCHES[k] - before[k] for k in before})
            outs.append([done[i].output for i in ids])
            progs = eng._programs
            assert eng.graphs() == len(progs)
            for key, prog in progs.items():
                got, gat = (tally(prog.collectives)[k]
                            for k in ("all_reduce", "all_gather"))
                if m is None:
                    assert got == 0 and gat == 0, key
                elif key[0] == "decode":
                    assert (got, gat) == (reduces * key[1],
                                          gathers * key[1]), (key, got, gat)
                else:
                    assert got > 0 and gat > 0, key
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert launches[0] == launches[1]
    if name == "recurrentgemma-9b":
        assert launches[1]["rglru_scan"] > 0


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_data_helper_and_world_reduce_on_a_one_rank_card_mesh(cuda,
                                                              backend):
    """On a one-rank mesh of the card every axis is the whole group: the
    data axis' joined projection (``TensorParallel.project``) equals the
    plain products bit for bit (one bf16 product, summed in f32 over one
    rank and cast back), and the world all-reduce, the data gather and the
    data reduce-scatter return what they were given."""
    from repro_torch.sharding import tensor_parallel
    lm = _mesh_model(cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(3, 5, 128, device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn(128, n, device=cuda, generator=g).to(torch.bfloat16)
          for n in (64, 32)]
    with _process_group(backend) as mesh:
        tp = tensor_parallel(lm.cfg, mesh)
        got = tp.project(x, ws, True)
        for a, w in zip(got, ws):
            assert torch.equal(a, x @ w)
        y = torch.randn(4, 6, device=cuda, generator=g)
        assert torch.equal(mesh.all_reduce(y.clone(), axis="world"), y)
        assert torch.equal(mesh.gather(y, -1, axis="data"), y)
        assert torch.equal(mesh.reduce_scatter(y[None], axis="data"), y)
        mesh.barrier()


def test_data_parallel_step_on_the_card_equals_the_one_device_step(cuda):
    """The data-parallel train step on a one-rank NCCL mesh of the card
    (f32): its loss equals the one-device step's within 1e-5, and each
    param within 1e-5 of its leaf's max |p| plus 1e-4 lr (the clip's norm
    sums the split and the whole leaves apart: another order)."""
    import dataclasses

    from repro_torch.optim import adamw_init
    from repro_torch.training.train_loop import (make_train_step,
                                                 place_train_params)
    lm = _mesh_model(cuda)
    lm = type(lm)(dataclasses.replace(lm.cfg, param_dtype="float32"),
                  device=cuda)
    params = lm.init(0)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 500, (4, 24))).to(cuda)
    labels = torch.roll(toks, -1, 1)
    labels[0, 5:] = -1
    batch = {"tokens": toks, "labels": labels}
    lr = 1e-3

    def sched(step):
        return torch.full((), lr, device=step.device)

    want, _, wm = make_train_step(lm, sched)(params, adamw_init(params),
                                             batch)
    with _process_group("nccl") as mesh:
        local = place_train_params(mesh, lm, params)
        got, _, gm = make_train_step(lm, sched, mesh=mesh)(
            local, adamw_init(local), batch)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-5 * float(
        wm["loss"])
    from repro_torch.utils.tree import flat_paths
    a, b = flat_paths(got), flat_paths(want)
    for k in b:
        tol = 1e-5 * float(b[k].abs().max()) + 1e-4 * lr
        assert float((a[k] - b[k]).abs().max()) <= tol, k


@pytest.mark.parametrize("name", ["quickstart", "serve_stream",
                                  "serve_cascade", "train_lm",
                                  "federated_training", "video_query"])
def test_examples_run_on_the_card(cuda, name):
    """Each ``examples/torch`` script at its small flags with the default
    ``--device`` (the card; NCCL for the federated one's ranks) runs to
    its end (``tests/test_torch_examples.py`` runs them on the CPU)."""
    import os
    import subprocess
    import sys

    from test_torch_examples import EXAMPLES, ROOT, RUNS

    argv, last = RUNS[name]
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES,
                                                       f"{name}.py"), *argv],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert last in out.stdout, out.stdout[-3000:]


def test_step_record_counts_the_same_flops_on_the_card_and_the_cpu(cuda):
    """A prefill through flash and a decode through the ring and the paged
    kernels: the wrappers add on the card what ``FlopCounterMode`` counts
    over the plain versions on the CPU."""
    from repro_torch.analysis import step_record

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 64, h, 64, generator=gen, dtype=torch.float32)
               .to(torch.bfloat16) for h in (8, 2, 2))
    qd = q[:, -1:].contiguous()
    pos = torch.arange(64, dtype=torch.int32).repeat(2, 1)
    qp = torch.full((2, 1), 63, dtype=torch.int32)
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    pool_k, pool_v = (t.reshape(8, 16, 2, 64) for t in (k, v))

    def record(dev):
        a = [t.to(dev) for t in (q, k, v, qd, pos, qp, tables, pool_k,
                                 pool_v)]

        def step():
            flash_attention(a[0], a[1], a[2])
            decode_attention(a[3], a[1], a[2], a[5], a[4])
            paged_decode_attention(a[3], a[7], a[8], a[5],
                                   a[4].reshape(8, 16), a[6])
        return step_record(step, arch="smollm-135m", mode="prefill",
                           seq_len=64, global_batch=2, params={}, device=dev)

    got, want = record(cuda), record("cpu")
    assert got["cost"] == want["cost"] and got["cost"]["flops"] > 0


def test_gateway_warms_an_engine_on_the_card_before_its_first_step(cuda):
    """A gateway with no watchdog over an engine nobody warmed: it captures
    every program before its first step (a capture at first use, in an
    executor thread that has made no cuBLAS handle yet, fails), and the
    streams equal a warmed engine's ``run()``."""
    import asyncio

    from repro_torch.serving import ServingEngine, ServingGateway

    lm = _mesh_model(cuda)
    params = lm.init(0)
    trace = _mesh_trace()
    ref = ServingEngine(lm, params, batch_slots=3, max_seq_len=64)
    ref.warm_compile()
    ids = [ref.submit(p, max_new_tokens=n, temperature=t)
           for p, n, t in trace]
    want = ref.run()
    eng = ServingEngine(lm, params, batch_slots=3, max_seq_len=64)

    async def main():
        async with ServingGateway(eng) as gw:
            hs = [await gw.submit(p, max_new_tokens=n, temperature=t)
                  for p, n, t in trace]
            return [await h.result() for h in hs]

    got = asyncio.run(main())
    assert eng.warm_compile_s is not None
    assert eng.graphs() == len(eng.program_keys())
    for i, r in zip(ids, got):
        assert r.status == "done"
        np.testing.assert_array_equal(r.output, want[i].output)


# -- the kernels' fake (shape) rules against real launches ---------------------

def _fake_rule_inputs(name, shape, dev):
    """Valid inputs of the wrapper ``name`` at ``shape``, on ``dev``, and the
    call: positions in range, tables over the pool, f32 where the kernel
    takes only f32."""
    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.rglru_scan as rs

    gen = torch.Generator().manual_seed(7)
    bf = torch.bfloat16

    def randn(*s, dtype=bf):
        return torch.randn(*s, generator=gen).to(dtype).to(dev)

    if name == "decode_attention":
        b, t, h, kv, w, hd = shape
        pos = torch.arange(w, dtype=torch.int32).repeat(b, 1).to(dev)
        qp = torch.full((b,), w - t, dtype=torch.int32, device=dev)
        args = (randn(b, t, h, hd), randn(b, w, kv, hd), randn(b, w, kv, hd),
                qp, pos)
        return decode_attention, args
    if name == "paged_decode_attention":
        b, t, h, kv, n, bs, m, hd = shape
        pos = torch.arange(n * bs, dtype=torch.int32).reshape(n, bs).to(dev)
        tables = torch.arange(b * m, dtype=torch.int32).reshape(b, m) % n
        qp = torch.full((b,), m * bs - t, dtype=torch.int32, device=dev)
        args = (randn(b, t, h, hd), randn(n, bs, kv, hd), randn(n, bs, kv, hd),
                qp, pos, tables.to(dev))
        return paged_decode_attention, args
    if name in ("flash_attention", "flash_attention_lse"):
        b, sq, sk, h, kv, hd = shape
        args = (randn(b, sq, h, hd), randn(b, sk, kv, hd), randn(b, sk, kv, hd))
        if name == "flash_attention":
            return flash_attention, args
        return (lambda q, k, v: fa._forward(q, k, v, True, None, hd ** -0.5,
                                            with_lse=True)), args
    if name == "flash_attention_bwd":
        b, sq, sk, h, kv, hd = shape
        q, k, v = (randn(b, sq, h, hd), randn(b, sk, kv, hd),
                   randn(b, sk, kv, hd))
        out, lse = fa._forward(q, k, v, True, None, hd ** -0.5, with_lse=True)
        return flash_attention_bwd, (q, k, v, out, lse, randn(b, sq, h, hd))
    if name in ("rglru_scan", "rglru_scan_bwd"):
        b, s, w = shape
        f32 = torch.float32
        a = torch.rand(b, s, w, generator=gen).mul(0.5).add(0.4).to(dev)
        x, h0 = randn(b, s, w, dtype=f32), randn(b, w, dtype=f32)
        if name == "rglru_scan":
            return rglru_scan, (a, x, h0)
        h, _ = rs._forward(a, x, h0)
        return rglru_scan_bwd, (a, h, h0, randn(b, s, w, dtype=f32),
                                randn(b, w, dtype=f32))
    t, v, dtype = shape
    return (lambda x: cascade_gate(x, 0.5, 0.1)), (randn(t, v, dtype=dtype),)


FAKE_RULE_CASES = [
    ("decode_attention", (2, 1, 8, 2, 256, 64)),
    ("decode_attention", (1, 4, 32, 2, 1024, 128)),
    ("paged_decode_attention", (2, 1, 8, 2, 32, 16, 8, 64)),
    ("paged_decode_attention", (1, 5, 16, 1, 64, 16, 16, 256)),
    ("flash_attention", (2, 128, 128, 8, 2, 64)),
    ("flash_attention", (1, 64, 300, 16, 1, 256)),
    ("flash_attention_lse", (2, 128, 128, 8, 2, 64)),
    ("flash_attention_lse", (1, 4096, 4096, 8, 1, 128)),
    ("flash_attention_bwd", (2, 128, 128, 8, 2, 64)),
    ("flash_attention_bwd", (1, 70, 150, 4, 2, 128)),
    ("rglru_scan", (2, 100, 512)),
    ("rglru_scan", (1, 4096, 1024)),
    ("rglru_scan_bwd", (2, 77, 1001)),
    ("rglru_scan_bwd", (1, 4096, 2048)),
    ("cascade_gate", (5, 1000, torch.bfloat16)),
    ("cascade_gate", (64, 32768, torch.float32)),
]


@pytest.mark.parametrize("name, shape", FAKE_RULE_CASES,
                         ids=[f"{n}-{s}" for n, s in FAKE_RULE_CASES])
def test_fake_rule_matches_a_real_launch(cuda, name, shape):
    """A wrapper on fake copies of real CUDA inputs returns what its launch
    returns in shape, dtype, stride and device, adds the launch's FLOPs to
    ``FLOPS``, counts the call in ``TRACED`` and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels

    fn, args = _fake_rule_inputs(name, shape, cuda)
    kernel = "flash_attention" if name == "flash_attention_lse" else name
    flops = dict(kernels.FLOPS)
    launches = dict(LAUNCHES)
    real = fn(*args)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == launches[kernel] + 1
    real_flops = kernels.FLOPS.get(kernel, 0) - flops.get(kernel, 0)
    real = real if isinstance(real, tuple) else (real,)
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(t) for t in args]
        launches, traced = dict(LAUNCHES), dict(kernels.TRACED)
        flops = dict(kernels.FLOPS)
        got = fn(*fakes)
    got = got if isinstance(got, tuple) else (got,)
    assert LAUNCHES == launches
    assert kernels.TRACED[kernel] == traced[kernel] + 1
    assert kernels.FLOPS.get(kernel, 0) - flops.get(kernel, 0) == real_flops
    assert [(t.shape, t.dtype, t.stride(), t.device) for t in got] == \
        [(t.shape, t.dtype, t.stride(), t.device) for t in real]


def test_a_fake_cuda_train_trace_counts_the_fake_cpu_ones(cuda):
    """A tiny train step traced on a fake (2, 2) mesh: on fake CUDA tensors
    (the kernels' fake rules, forward and backward) it counts the FLOPs and
    collectives of the same trace on fake CPU tensors (the plain
    versions)."""
    import dataclasses

    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.fake import fake_mode, fake_world
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.specs import make_step_fn
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(tcfg.get_config("qwen3-4b").reduced(),
                              param_dtype="float32")
    shape = InputShape("tiny_train", 64, 8, "train")
    recs = {}
    with fake_world(4):
        for dev in ("cpu", "cuda"):
            mesh = HostMesh(2, device=dev)
            with fake_mode(dev):
                lm = LM(cfg, device=dev)
                step, inputs = make_step_fn(lm, shape, mesh, dev)
                recs[dev], _ = trace_step(step, inputs, params=inputs[0],
                                          read=inputs[0], device=dev)
    assert recs["cuda"]["kernels"]["flash_attention_bwd"] > 0
    assert recs["cuda"]["weighted"]["dot_flops"] == \
        recs["cpu"]["weighted"]["dot_flops"]
    assert recs["cuda"]["collectives"] == recs["cpu"]["collectives"]
