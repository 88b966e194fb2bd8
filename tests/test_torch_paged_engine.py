"""The port's ServingEngine with the paged backend and chunked prefill.

Across packages, on bridged weights and one trace (shared prompt prefixes,
a prompt that is exactly a shared prefix, a second wave that revives
retained blocks, and a higher-class arrival that forces swap preemption):
greedy streams equal ``repro.serving.ServingEngine``'s wherever
``repro``'s top-2 logit margin at a step exceeds 1e-4 (as in
``tests/test_torch_engine.py``), and the host counters equal ``repro``'s
exactly: the schedule is a function of the trace, not of the numbers.

Within the port, ``repro``'s invariants: chunked equals unchunked (ring
and paged), paged equals ring, K-step equals 1-step, a preempted stream
equals its uncontended self (swap and recompute, greedy and sampled), a
reused slot sees no stale positions, and a request larger than the pool is
rejected. These are exact (token for token).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers (two orders
    of magnitude slower under ``pytest -n``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = dict(name="tiny", family="dense", source="t", num_layers=2,
              d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=96, param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _models():
    jlm = JaxLM(ModelConfig(**FIELDS, stages=dense_stages(2)), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(3))
    tc = tcfg.ModelConfig(**FIELDS, stages=tcfg.dense_stages(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _trace(seed=0):
    """Wave 1: three prompts sharing a 16-token prefix (two block-size-8
    blocks, a multiple of the 8-token chunk), two unique prompts, and one
    prompt that is exactly the prefix (copy-on-write once the prefix is
    registered). A higher-class request arrives mid-wave. Wave 2 revives
    the retained prefix blocks."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 96, 16).astype(np.int32)

    def tail(n):
        return np.concatenate([pre, rng.integers(0, 96, n)]).astype(np.int32)

    wave1 = [(tail(5), 6), (rng.integers(0, 96, 11).astype(np.int32), 5),
             (tail(9), 7), (rng.integers(0, 96, 20).astype(np.int32), 4),
             (tail(3), 5), (pre.copy(), 6)]
    hi = (rng.integers(0, 96, 7).astype(np.int32), 4)
    wave2 = [(pre.copy(), 5), (tail(6), 4)]
    return wave1, hi, wave2


def _drive(engine, trace, temperature=0.0, arrive_after=6):
    """Submit wave 1, step ``arrive_after`` times, submit the high-class
    request, drain, then serve wave 2. Returns outputs by request id."""
    wave1, hi, wave2 = trace
    for p, n in wave1:
        engine.submit(p, max_new_tokens=n, temperature=temperature)
    for _ in range(arrive_after):
        engine.step()
    engine.submit(hi[0], max_new_tokens=hi[1], temperature=temperature,
                  priority=1)
    done = engine.run()
    for p, n in wave2:
        engine.submit(p, max_new_tokens=n, temperature=temperature)
    done.update(engine.run())
    assert all(r.status == "done" for r in done.values())
    assert len(done) == len(wave1) + 1 + len(wave2)
    return {rid: r.output for rid, r in done.items()}


PAGED = dict(batch_slots=2, max_seq_len=64, min_bucket=8,
             cache_backend="paged", block_size=8, chunk_tokens=8)


def test_paged_chunked_engine_matches_repro_streams_and_counters():
    jlm, jp, lm, tp = _models()
    trace = _trace()
    ours_eng = ServingEngine(lm, tp, **PAGED)
    theirs_eng = JaxEngine(jlm, jp, **PAGED)
    ours = _drive(ours_eng, trace)
    theirs = _drive(theirs_eng, trace)
    ob, tb = ours_eng.backend, theirs_eng.backend
    counters = {
        "admissions": (ob.admitted, tb.admitted),
        "preemptions": (ours_eng.preemptions, theirs_eng.preemptions),
        "prefill_tokens_skipped": (ours_eng.prefill_tokens_skipped,
                                   theirs_eng.prefill_tokens_skipped),
        "lookahead_dispatches": (ours_eng.lookahead_dispatches,
                                 theirs_eng.lookahead_dispatches),
    }
    for name in ("cow_copies", "retained_block_hits", "swap_outs",
                 "swap_ins", "peak_blocks_in_use", "lookahead_topups"):
        counters[name] = (getattr(ob, name), getattr(tb, name))
    for name, (a, b) in counters.items():
        assert a == b, (name, a, b)
    # the trace reached every path it is meant to compare
    for name in ("preemptions", "prefill_tokens_skipped", "cow_copies",
                 "retained_block_hits", "swap_ins", "lookahead_dispatches"):
        assert counters[name][0] > 0, name
    ours_eng.assert_invariants()
    theirs_eng.assert_invariants()

    assert _margin_rule(jlm, jp, trace, ours, theirs) >= 30


def _margin_rule(jlm, jp, trace, ours, theirs):
    """Greedy streams by request id agree up to their first difference,
    which must sit on a near-tie (top-2 margin <= TOL) of ``repro``'s
    logits. Returns the number of tokens compared."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for rid, (prompt, _) in enumerate(_flat(trace)):
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b)
        diff = np.flatnonzero(a != b)
        upto = diff[0] if len(diff) else len(a)
        compared += upto
        if len(diff):
            ctx = np.concatenate([prompt, b[:upto]])[None]
            logits = np.sort(np.asarray(fwd(jp, ctx))[0, -1])
            assert logits[-1] - logits[-2] <= TOL, (rid, upto, a, b)
    return compared


def head_faithful(cfg, window=None):
    """``cfg`` cut to 2 layers, d_model 64, d_ff 128, vocab 512, f32, with
    its head layout kept (as ``tests/test_torch_engine.py`` cuts it)."""
    stage = cfg.stages[0]
    blocks = tuple(dataclasses.replace(b, window=window or b.window)
                   for b in stage.blocks)
    return dataclasses.replace(
        cfg, name=cfg.name + "-heads", num_layers=2, d_model=64, d_ff=128,
        vocab_size=512, param_dtype="float32",
        stages=(dataclasses.replace(stage, blocks=blocks, repeat=2),))


@pytest.mark.parametrize("name,window", [("glm4-9b", None),
                                         ("starcoder2-7b", 8)])
def test_zoo_greedy_streams_match_repro_paged_chunked(name, window):
    """Head-faithful glm4 (G = 16) and starcoder2 (G = 9, window cut to 8)
    at hd 128 through the paged chunked engine on the preempting trace:
    greedy streams equal ``repro``'s under the margin rule, and the
    schedule's counters are equal."""
    from repro.configs import get_config as jax_get_config

    jlm = JaxLM(head_faithful(jax_get_config(name), window), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(5))
    tc = head_faithful(tcfg.get_config(name), window)
    lm = LM(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    trace = _trace(5)
    ours_eng = ServingEngine(lm, tp, max_decode_steps=2, **PAGED)
    theirs_eng = JaxEngine(jlm, jp, max_decode_steps=2, **PAGED)
    ours, theirs = _drive(ours_eng, trace), _drive(theirs_eng, trace)
    for attr in ("preemptions", "prefill_tokens_skipped", "host_syncs"):
        assert getattr(ours_eng, attr) == getattr(theirs_eng, attr), attr
    assert ours_eng.preemptions > 0
    ours_eng.assert_invariants()
    assert _margin_rule(jlm, jp, trace, ours, theirs) >= 30


def _serve(engine, reqs, temperature=0.0):
    ids = [engine.submit(p, max_new_tokens=n, temperature=temperature)
           for p, n in reqs]
    done = engine.run()
    assert all(done[i].status == "done" for i in ids)
    return [done[i].output for i in ids]


def _flat(trace):
    wave1, hi, wave2 = trace
    return wave1 + [hi] + wave2


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend", ["ring", "paged"])
def test_chunked_equals_unchunked(backend):
    _, _, lm, tp = _models()
    reqs = _flat(_trace(1))
    kw = dict(batch_slots=3, max_seq_len=64, min_bucket=8,
              cache_backend=backend, block_size=8)
    base = _serve(ServingEngine(lm, tp, **kw), reqs)
    for chunk in (4, 8):
        eng = ServingEngine(lm, tp, chunk_tokens=chunk, **kw)
        _same(base, _serve(eng, reqs))
        assert eng.metrics()["prefill_tokens_total"] > 0


def test_paged_equals_ring_and_k_step_equals_one_step():
    _, _, lm, tp = _models()
    reqs = _flat(_trace(2))
    kw = dict(batch_slots=3, max_seq_len=64, min_bucket=8)
    ring = _serve(ServingEngine(lm, tp, **kw), reqs, temperature=0.9)
    for extra in (dict(), dict(chunk_tokens=8), dict(max_decode_steps=4),
                  dict(chunk_tokens=8, max_decode_steps=4,
                       num_pool_blocks=14)):
        eng = ServingEngine(lm, tp, cache_backend="paged", block_size=8,
                            **kw, **extra)
        _same(ring, _serve(eng, reqs, temperature=0.9))
        eng.assert_invariants()
        be = eng.backend
        assert sorted(be._free) == list(range(1, be.num_blocks))
        assert be._gap_total == 0 and be._ref == {}
    assert eng.host_syncs < eng.decode_steps      # the K-step rounds ran


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempted_streams_equal_uncontended(mode, temperature):
    """Random forced preempt/resume schedules (and the SLO preemption of
    the trace) against an engine with room for everyone."""
    _, _, lm, tp = _models()
    trace = _trace(3)
    reqs = _flat(trace)
    base = _serve(ServingEngine(lm, tp, batch_slots=len(reqs),
                                max_seq_len=64, min_bucket=8), reqs,
                  temperature)
    rng = np.random.default_rng(0)
    eng = ServingEngine(lm, tp, max_decode_steps=2, preempt_mode=mode,
                        **PAGED)
    ids = [eng.submit(p, max_new_tokens=n, temperature=temperature)
           for p, n in reqs]
    while eng.pending:
        eng.step()
        if eng._slots and rng.random() < 0.4:
            eng.preempt(int(rng.choice(list(eng._slots))))
        eng.assert_invariants()
    done = eng.take_done()
    _same(base, [done[i].output for i in ids])
    assert eng.preemptions > 0
    be = eng.backend
    assert (be.swap_ins > 0) == (mode == "swap")
    assert sorted(be._free) == list(range(1, be.num_blocks))


@pytest.mark.parametrize("chunk", [None, 8])
def test_reused_blocks_show_no_stale_positions(chunk):
    """A long request leaves positions in its blocks; a shorter one reusing
    them (in another logical order) must see only its own. Every block of
    its row holds positions of that logical block or -1, at every step,
    and its stream equals the one served on a fresh engine."""
    _, _, lm, tp = _models()
    rng = np.random.default_rng(4)
    long_p = rng.integers(0, 96, 30).astype(np.int32)
    short_p = rng.integers(0, 96, 10).astype(np.int32)
    kw = dict(batch_slots=1, max_seq_len=64, min_bucket=8,
              cache_backend="paged", block_size=8, num_pool_blocks=6,
              prefix_sharing=False, chunk_tokens=chunk)
    fresh = _serve(ServingEngine(lm, tp, **kw), [(short_p, 20)])
    eng = ServingEngine(lm, tp, **kw)
    _serve(eng, [(long_p, 10)])
    rid = eng.submit(short_p, max_new_tokens=20)
    pos = eng._cache_state["caches"][0][0]["pos"]
    while eng.pending:
        eng.step()
        blocks = eng.backend._slot_blocks.get(0, [])
        for i, blk in enumerate(blocks):
            p = pos[:, blk]
            assert bool(((p == -1) | ((p >= 8 * i) & (p < 8 * i + 8))).all())
    np.testing.assert_array_equal(eng.take_done()[rid].output, fresh[0])


def test_request_larger_than_the_pool_is_rejected():
    _, _, lm, tp = _models()
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=64, min_bucket=8,
                        cache_backend="paged", block_size=8,
                        num_pool_blocks=4, chunk_tokens=8)   # 3 usable
    big = eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=8)
    ok = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
    done = eng.run()
    assert done[big].status == "rejected"
    assert done[big].failure_reason.startswith("exceeds_pool_capacity")
    assert done[ok].status == "done" and len(done[ok].output) == 4
    assert eng.metrics()["terminal"] == {"rejected": 1, "done": 1}
