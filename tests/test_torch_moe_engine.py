"""The serving engine over MLA and MoE models, in the port and against
``repro``'s engine, f32 on the CPU (``test_torch_moe_streams.py`` holds
mixtral's streams, ``test_torch_moe_durability.py`` snapshots and
``repro``'s chunked divergence).

Tiny models on weights bridged from ``repro``'s ``LM.init``: ``mla`` (two
MLA + SwiGLU layers, ``tests/test_kv_cache.py``'s) and ``deepseek`` (an
MLA + SwiGLU layer, then MLA + MoE with sigmoid top-2 of 4 experts and a
shared one). At ``repro``'s capacity factor 1.25 the port's greedy streams
equal ``repro``'s engine's on the ring, the paged backend, chunked prefill
and the K-step scan (token for token: both packages route the same
chunks, so they drop the same pairs). Within the port, as ``repro``'s
tests hold (``test_kv_cache.py::test_paged_engine_matches_ring_mla``,
``test_scheduler.py::test_chunked_matches_unchunked_mla``,
``test_multi_step_decode.py``'s ``"mla"`` case): paged equals ring,
chunked equals unchunked and K = 4 equals K = 1 on MLA; and a
swap-preempted stream equals its uncontended self.
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
    """Capacity factor 1.25 in both packages: greedy streams equal."""
    jlm, jp, _ = _models("deepseek")
    lm, tp = _port("deepseek")
    trace = _trace()
    _same(_run(ServingEngine, lm, tp, trace, **LEGS[leg]),
          _run(JaxEngine, jlm, jp, trace, **LEGS[leg]))


def test_paged_engine_matches_ring_mla():
    lm, tp = _port("mla")
    trace = _trace()
    _same(_run(ServingEngine, lm, tp, trace),
          _run(ServingEngine, lm, tp, trace, **PAGED))


def test_chunked_matches_unchunked_and_k_steps_match_one_mla():
    lm, tp = _port("mla")
    trace = _trace()
    base = _run(ServingEngine, lm, tp, trace)
    _same(base, _run(ServingEngine, lm, tp, trace, chunk_tokens=4, **PAGED))
    _same(base, _run(ServingEngine, lm, tp, trace, max_decode_steps=4,
                     **PAGED))


def test_swap_preemption_keeps_an_mla_stream():
    """A small pool and a higher-class arrival force swap preemption on
    the paged MLA engine: every stream equals its uncontended self."""
    lm, tp = _port("deepseek")
    trace = _trace(n=5, seed=6)
    quiet = _run(ServingEngine, lm, tp, trace, batch_slots=4, **PAGED)
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32, min_bucket=4,
                        num_pool_blocks=6, preempt_mode="swap", **PAGED)
    ids = [eng.submit(p, max_new_tokens=n) for p, n in trace[:4]]
    eng.step()
    eng.step()
    ids.append(eng.submit(trace[4][0], max_new_tokens=trace[4][1],
                          priority=1))
    done = eng.run()
    assert eng.backend.swap_outs > 0 and eng.backend.swap_ins > 0
    eng.assert_invariants()
    for rid, want in zip(ids, [quiet[i] for i in sorted(quiet)]):
        np.testing.assert_array_equal(done[rid].output, want)
