"""Mixtral-style MoE (GQA + MoE, softmax top-2 of 4 experts, windowed on
the paged legs) through the serving engine, f32 on the CPU, on weights
bridged from ``repro``'s ``LM.init``: at ``repro``'s capacity factor 1.25
the port's greedy streams equal ``repro``'s engine's on the ring, the
paged backend, chunked prefill and the K-step scan. At the dropless
factor E / k (both routings: this model and a deepseek-style MLA + MoE
one with a shared expert) chunked prefill equals monolithic and a
speculative engine equals the plain one.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(base, which, window=None):
    mla = base.MLAConfig(q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                         qk_rope_head_dim=8, v_head_dim=8)
    moe = base.MoEConfig(num_experts=4, num_experts_per_tok=2,
                         d_ff_expert=32,
                         num_shared_experts=int(which == "deepseek"),
                         d_ff_shared=32)
    if which == "mla":
        stages = (base.Stage(blocks=(base.BlockDef(mixer=base.MLA,
                                                   mlp=base.SWIGLU),),
                             repeat=2),)
    elif which == "deepseek":
        stages = (base.Stage(blocks=(base.BlockDef(mixer=base.MLA,
                                                   mlp=base.SWIGLU),),
                             repeat=1),
                  base.Stage(blocks=(base.BlockDef(mixer=base.MLA,
                                                   mlp=base.MOE),),
                             repeat=1))
    else:
        stages = (base.Stage(blocks=(base.BlockDef(
            mixer=base.ATTN, mlp=base.MOE, window=window),), repeat=2),)
    return base.ModelConfig(
        name=f"tiny-{which}", family="moe", source="t", num_layers=2,
        d_model=32, num_heads=4, num_kv_heads=4 if which != "mixtral" else 2,
        head_dim=8, d_ff=64, vocab_size=64, stages=stages,
        param_dtype="float32",
        mla=mla if which != "mixtral" else None,
        moe=moe if which != "mla" else None)


@functools.lru_cache(maxsize=None)
def _models(which, window=None):
    """(repro LM, its params, bridged port params)."""
    jlm = JaxLM(_cfg(jbase, which, window), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           _cfg(tbase, which, window), "cpu")
    return jlm, jp, tp


def _port(which, window=None, capacity_factor=1.25):
    _, _, tp = _models(which, window)
    return LM(_cfg(tbase, which, window), device="cpu",
              capacity_factor=capacity_factor), tp


def _trace(n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 60, size=int(rng.integers(3, 14))),
             int(rng.integers(3, 9))) for _ in range(n)]


def _run(engine, lm, params, trace, **kw):
    eng = engine(lm, params, **dict(dict(batch_slots=2, max_seq_len=32,
                                         min_bucket=4), **kw))
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new)
    done = eng.run()
    assert all(r.status == "done" for r in done.values())
    return {rid: r.output for rid, r in done.items()}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=str(rid))


PAGED = dict(cache_backend="paged", block_size=8)
# ring, paged, chunked (on the paged pool) and the K-step scan
LEGS = {"ring": {}, "paged": PAGED,
        "chunked": dict(PAGED, chunk_tokens=4),
        "kstep": dict(PAGED, max_decode_steps=4)}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_streams_match_repro_at_the_default_factor(leg):
    """Capacity factor 1.25 in both packages: greedy streams equal (the
    paged legs with a 6-token window, narrower than the prompts)."""
    window = None if leg == "ring" else 6
    jlm, jp, _ = _models("mixtral", window)
    lm, tp = _port("mixtral", window)
    trace = _trace()
    _same(_run(ServingEngine, lm, tp, trace, **LEGS[leg]),
          _run(JaxEngine, jlm, jp, trace, **LEGS[leg]))


@pytest.mark.parametrize("which", ["deepseek", "mixtral"])
def test_dropless_chunked_equals_unchunked_and_speculative_equals_plain(
        which):
    """At capacity factor E / k = 2 no call drops: chunked prefill equals
    monolithic, and a speculative engine (a 1-layer dense draft, k = 3)
    equals the plain one."""
    lm, tp = _port(which, capacity_factor=2.0)
    trace = _trace(n=6, seed=5)
    base = _run(ServingEngine, lm, tp, trace, **PAGED)
    _same(base, _run(ServingEngine, lm, tp, trace, chunk_tokens=4, **PAGED))
    dcfg = tbase.ModelConfig(
        name="drf", family="dense", source="t", num_layers=1, d_model=32,
        num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
        stages=tbase.dense_stages(1), param_dtype="float32")
    draft = LM(dcfg, device="cpu")
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32, min_bucket=4,
                        draft_model=draft, draft_params=draft.init(7),
                        speculative_tokens=3)
    eng.scheduler.spec_min_commit = 0.0
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new)
    done = eng.run()
    assert eng.spec_rounds > 0
    _same(base, {rid: r.output for rid, r in done.items()})
