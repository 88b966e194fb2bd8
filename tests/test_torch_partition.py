"""Intra-model ECC inference on the port (``core.patterns.inference``):
``PartitionedLM`` against the monolithic ``LM.forward`` and against
``repro``'s ``PartitionedLM`` on bridged weights, ``LM``'s split of
``forward`` into embedding, layer range and head, and the napkin math of
``layer_flops`` / ``best_partition`` against ``repro``'s for every
assigned architecture.

Tolerances: the port's partition and the port's forward run the same
ops in the same order, so they are equal bit for bit (f32 and bf16);
against ``repro`` 1e-4 on f32 logits of order 1 (summation order, as in
``tests/test_torch_model.py``); the napkin math exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import base as jb  # noqa: E402
from repro.core.patterns import inference as jinf  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.patterns import inference as tinf  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(pkg, which, dtype="float32"):
    """A dense tiny config (3 layers) or a tiny hybrid: 2 repeats of
    (rglru, rglru, attn window 8), GeGLU."""
    if which == "dense":
        return pkg.ModelConfig(
            name="tiny", family="dense", source="t", num_layers=3,
            d_model=48, num_heads=4, num_kv_heads=2, head_dim=12, d_ff=96,
            vocab_size=128, stages=pkg.dense_stages(3), param_dtype=dtype)
    rec = pkg.BlockDef(mixer=pkg.RGLRU, mlp=pkg.GELU_MLP)
    att = pkg.BlockDef(mixer=pkg.ATTN, mlp=pkg.GELU_MLP, window=8)
    return pkg.ModelConfig(
        name="tiny-hybrid", family="hybrid", source="t", num_layers=6,
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=96, stages=(pkg.Stage(blocks=(rec, rec, att), repeat=2),),
        param_dtype=dtype, logit_softcap=30.0)


@functools.lru_cache(maxsize=None)
def _pair(which):
    """(repro LM, its params, port LM, bridged params); read, never
    written."""
    jlm = JaxLM(_fields(jb, which), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tc = _fields(tcfg.base, which)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _tokens(vocab, b=2, s=9, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("which", ["dense", "hybrid"])
@pytest.mark.parametrize("split", ["0", "1", "L"])
def test_partitioned_lm_matches_full(which, split):
    """Edge bottom + cloud top == the monolith (the port's forward, bit for
    bit) == ``repro``'s partition at the same split."""
    jlm, jp, lm, tp = _pair(which)
    k = lm.num_scanned_layers if split == "L" else int(split)
    tok = _tokens(lm.cfg.vocab_size)
    full, _ = lm.forward(tp, {"tokens": torch.from_numpy(tok)})
    part = tinf.PartitionedLM(lm, split=k)
    hidden, positions = part.edge_forward(tp, {"tokens": torch.from_numpy(
        tok)})
    assert tuple(hidden.shape) == (2, 9, lm.cfg.d_model)
    logits = part.cloud_forward(tp, hidden, positions)
    assert torch.equal(logits, full)
    jpart = jinf.PartitionedLM(jlm, split=k)
    jh, jpos = jpart.edge_forward(jp, {"tokens": tok})
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), atol=TOL)
    theirs = np.asarray(jpart.cloud_forward(jp, jh, jpos))
    assert np.max(np.abs(logits.numpy() - theirs)) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["dense", "hybrid"])
def test_forward_is_embedding_range_head(which, dtype):
    """``LM.forward`` is the embedding, the layer range [0, k), then [k,
    L), then the head, bit for bit at every split k; with caches, the
    range fills the same caches as ``prefill``."""
    lm = LM(_fields(tcfg.base, which, dtype), device="cpu")
    params = lm.init(0)
    tok = torch.from_numpy(_tokens(lm.cfg.vocab_size, s=11, seed=2))
    full, _ = lm.forward(params, {"tokens": tok})
    n = lm.num_scanned_layers
    assert n == sum(st.repeat for st in lm.cfg.stages)
    for k in range(n + 1):
        x, pos = lm._embed_inputs(params, {"tokens": tok})
        x = lm._layer_range(params, x, pos, 0, k)
        x = lm._layer_range(params, x, pos, k, n)
        assert torch.equal(lm._head(params, x, False, None), full), k
    logits, caches = lm.prefill(params, {"tokens": tok}, cache_width=16)
    assert torch.equal(logits, full)
    fresh = lm.init_cache(2, 16)
    x, pos = lm._embed_inputs(params, {"tokens": tok})
    lm._layer_range(params, x, pos, caches=fresh)
    for stage, again in zip(caches, fresh):
        for blk, blk2 in zip(stage, again):
            for key in blk:
                assert torch.equal(blk[key], blk2[key]), key


@pytest.mark.parametrize("split", [0, 2, 3])
def test_boundary_bytes_match_repro(split):
    for name in ("smollm-135m", "qwen3-4b"):
        jc, tc = jax_get_config(name), tcfg.get_config(name)
        ours = tinf.PartitionedLM(LM(tc, device="cpu"), split)
        theirs = jinf.PartitionedLM(JaxLM(jc), split)
        assert ours.boundary_bytes(2, 256) == theirs.boundary_bytes(2, 256)
    assert tinf.PartitionedLM(LM(tcfg.get_config("smollm-135m"),
                                 device="cpu"), 15).boundary_bytes(
        2, 256) == 589_824


# benchmarks/bench_partition.py's scenarios:
# (name, edge FLOP/s, cloud FLOP/s, uplink Mbps, delay s)
SCENARIOS = [("lan", 5e10, 5e12, 1000.0, 0.001),
             ("campus", 5e10, 5e12, 20.0, 0.05),
             ("cellular", 5e10, 5e12, 2.0, 0.10),
             ("edge-strong", 5e11, 5e12, 2.0, 0.10),
             ("free-wan", 1e9, 5e13, 1e6, 0.0)]


@pytest.mark.parametrize("name", tcfg.ASSIGNED_ARCHS)
def test_napkin_math_matches_repro(name):
    """``layer_flops`` and ``best_partition`` for every assigned
    architecture (the math reads the config only: MoE, MLA and frontends
    included), at two sequence lengths and batches."""
    jc, tc = jax_get_config(name), tcfg.get_config(name)
    for seq in (128, 256):
        assert tinf.layer_flops(tc, seq) == jinf.layer_flops(jc, seq)
        for batch in (1, 4):
            for _, ef, cf, up, delay in SCENARIOS:
                kw = dict(batch=batch, seq_len=seq, edge_flops_s=ef,
                          cloud_flops_s=cf, uplink_mbps=up, delay_s=delay)
                assert tinf.best_partition(tc, **kw) == \
                    jinf.best_partition(jc, **kw)


def test_best_partition_tradeoffs():
    cfg = tcfg.get_config("smollm-135m")
    total = sum(s.repeat for s in cfg.stages)
    # slow WAN -> all-edge or all-cloud beats mid-split (boundary is big)
    k_slow, _ = tinf.best_partition(cfg, batch=1, seq_len=128,
                                    edge_flops_s=5e10, cloud_flops_s=5e12,
                                    uplink_mbps=1.0, delay_s=0.05)
    assert k_slow in (0, total)
    # free WAN + slow edge -> everything to the cloud
    k_fast, _ = tinf.best_partition(cfg, batch=1, seq_len=128,
                                    edge_flops_s=1e9, cloud_flops_s=5e13,
                                    uplink_mbps=1e6, delay_s=0.0)
    assert k_fast == 0
