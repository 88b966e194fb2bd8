"""The port on the card: each CUDA kernel against its plain version, and
the engine's paths through the kernels. Marked ``gpu``; every test skips
without a CUDA device. This file imports neither JAX nor ``repro``, so it
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 1e-4 (summation order), bf16 2e-2 (bf16 output rounding,
and the kernel rounds P to bf16 before P V where the plain version keeps
f32). TF32 is off for the f32 comparisons. The cascade gate's confidence:
1e-5 relative in f32 and in bf16 (both sides read the same bf16 values,
which f32 holds exactly, and sum in f32; only the order differs), routes
and counts equal on rows away from the thresholds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.cascade_gate import (  # noqa: E402
    cascade_gate, cascade_gate_plain)
from repro_torch.kernels.cascade_gate import _launch as _gate_launch  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

pytestmark = pytest.mark.gpu

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
]

# (h, kv, hd, bs, window, fills, t): the block sizes and cases of
# tests/test_paged_decode_attention.py, chunk queries (t > 1, including one
# of more than 64 rows) and a pool with a freed slot
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
]

# (t, v, misaligned): the serving gate (t = 1) and the one-shot batch at
# smollm's padded vocab, repro's ragged sweep shapes, and the scalar path
# (V not a multiple of the 16-byte vector, or a row start off 16 bytes)
GATE_CASES = [(1, 49152, False), (64, 49152, False), (100, 500, False),
              (7, 8000, False), (3, 501, False), (5, 1024, True)]

# (b, sq, sk, h, kv, hd, window)
FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, None),
    (2, 64, 64, 4, 2, 64, None),
    (1, 100, 100, 3, 1, 32, None),            # ragged tail
    (2, 200, 200, 4, 4, 32, 24),              # sliding window
    (1, 1, 96, 4, 2, 32, None),               # right-aligned single query
    (1, 70, 90, 4, 2, 64, 16),                # right-aligned, windowed
    (1, 48, 48, 2, 2, 256, None),             # hd 256
]


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
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert (out.float() - plain.float()).abs().max().item() < tol


def test_decode_kernel_empty_rows_are_zero(cuda):
    q, k, v, q_pos, k_pos = _ring(cuda, torch.bfloat16, 2, 64, 4, 2, 32, 40,
                                  40, 1)
    k_pos[1] = -1
    out = decode_attention(q, k, v, q_pos, k_pos)
    assert out[0].abs().sum() > 0 and not out[1].any()


def _pool(dev, dt, h, kv, hd, bs, fills, t):
    """A shuffled pool as the engine leaves it (block 0 is trash, a slot's
    token p at (table[p // bs], p % bs)); a fill of 0 is a freed slot (its
    row all -1). The t-token chunk of each slot ends at its last token."""
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
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert (out.float() - plain.float()).abs().max().item() < tol
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
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert (out.float() - plain.float()).abs().max().item() < tol


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
                            "paged_decode_attention": 0, "cascade_gate": 0}
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
                            "cascade_gate": 0}
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
