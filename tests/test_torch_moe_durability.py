"""MoE and MLA engines across packages, f32 on the CPU: ``repro``'s own
chunk-versus-monolithic divergence at capacity factor 1.25 (the property
that makes the port's exactness checks on MoE models run dropless), and a
paged MLA snapshot (each decoding slot's latent K/V in ``repro``'s wire
format) restored from ``repro`` into the port and from the port into
``repro``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import load_snapshot as jax_load_snapshot  # noqa: E402
from repro.serving import save_snapshot as jax_save_snapshot  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (ServingEngine, load_snapshot,  # noqa: E402
                                 save_snapshot)


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


def test_repro_chunked_differs_from_unchunked_at_the_default_factor():
    """``repro``'s own property at 1.25: a 4-token chunk gives each of 4
    experts a capacity of 2 per row, below a busy expert's load, so its
    dropped pairs change the prompt's cache, and some greedy stream
    parts from the monolithic prefill's."""
    jlm, jp, _ = _models("mixtral")
    trace = _trace(n=6, seed=5)
    mono = _run(JaxEngine, jlm, jp, trace, **PAGED)
    chunked = _run(JaxEngine, jlm, jp, trace, chunk_tokens=4, **PAGED)
    assert any(not np.array_equal(mono[r], chunked[r]) for r in mono)


def _stepped(engine, lm, params, trace, steps=3, **kw):
    eng = engine(lm, params, batch_slots=2, max_seq_len=32, min_bucket=4,
                 **dict(PAGED, **kw))
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new)
    for _ in range(steps):
        eng.step()
    assert eng._slots
    return eng


def _drained(eng):
    while eng.pending:
        eng.step()
    return {rid: r.output for rid, r in eng._done.items()}


def test_paged_mla_snapshots_cross_between_the_packages(tmp_path):
    """``repro``'s paged MLA snapshot (latent K/V of each decoding slot)
    restores into the port through ``swap_in``, and the port's into
    ``repro``; both finish equal to the uninterrupted streams."""
    jlm, jp, _ = _models("mla")
    lm, tp = _port("mla")
    trace = _trace(n=4, seed=7)
    base = _run(JaxEngine, jlm, jp, trace, **PAGED)
    jeng = _stepped(JaxEngine, jlm, jp, trace)
    jax_save_snapshot(str(tmp_path / "j"), jeng.snapshot(), step=3)
    snap, _ = load_snapshot(str(tmp_path / "j"))
    assert any("kv" in rec for rec in snap["requests"].values())
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32, min_bucket=4,
                        **PAGED)
    eng.restore(snap)
    _same(_drained(eng), base)
    assert eng.backend.swap_ins >= 1
    teng = _stepped(ServingEngine, lm, tp, trace)
    save_snapshot(str(tmp_path / "t"), teng.snapshot(), step=3)
    snap, _ = jax_load_snapshot(str(tmp_path / "t"))
    jeng = JaxEngine(jlm, jp, batch_slots=2, max_seq_len=32, min_bucket=4,
                     **PAGED)
    jeng.restore(snap)
    _same(_drained(jeng), base)
