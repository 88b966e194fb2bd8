"""``warm_compile`` and the engine's decode programs in the port, on the CPU.

It mirrors ``tests/test_multi_step_decode.py::
test_warm_compile_covers_scan_horizons`` and ``tests/test_speculative.py::
test_warm_compile_covers_speculative_and_sampled``. Where ``repro`` counts
the executables each jitted program compiled (``_cache_size``), the port
counts its registry of programs (``ServingEngine._programs``: decode
rounds per (kind, horizon, greedy or sampled), and admissions, chunks and
draft fills per shape; ``tests/test_torch_graphed_prefill.py`` holds the
latter against ``repro``'s counts). On the card each program is a
CUDA graph; on the CPU it is the eager call, so these tests hold what the
graphs stand on: ``warm_compile`` closes the set of programs (traffic
builds none), it changes no stream, and the engine's state, caches, block
tables and draft caches keep their storage (``data_ptr``) through
preemption by swap and by recompute, copy-on-write and draft re-syncs, so
a graph's fixed addresses stay the engine's. Models are tiny and their
weights bridged from ``repro``'s ``LM.init``.
"""
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
from repro_torch.cascade import CascadeLM, edge_variant  # noqa: E402
from repro_torch.cascade.gate import make_thresholds  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (CascadeServingEngine,  # noqa: E402
                                 ServingEngine)

TOL = 1e-4      # f32 logits across packages (tests/test_torch_engine.py)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers sharing the
    cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(layers, name, seed):
    """(repro LM, params, port LM, bridged params): the tiny config of
    ``tests/test_multi_step_decode.py`` and ``tests/test_speculative.py``."""
    fields = dict(name=name, family="dense", source="t", num_layers=layers,
                  d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                  d_ff=64, vocab_size=64, param_dtype="float32")
    jlm = JaxLM(ModelConfig(**fields, stages=dense_stages(layers)),
                kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(seed))
    tc = tcfg.ModelConfig(**fields, stages=tcfg.dense_stages(layers))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _trace(n=8, seed=2, budgets=(3, 24), span=(3, 20)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 60, size=int(rng.integers(*span))),
             int(rng.integers(*budgets))) for _ in range(n)]


def _serve(eng, trace, temperature=0.0):
    """Submit ``trace`` (request i sampled when ``temperature`` is a
    sequence: its i-th entry) and drain; {request id: output}."""
    temps = (temperature if isinstance(temperature, (list, tuple))
             else [temperature] * len(trace))
    for (prompt, max_new), t in zip(trace, temps):
        eng.submit(prompt, max_new_tokens=max_new, temperature=t)
    return {rid: r.output for rid, r in eng.run().items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


def _variants(eng):
    """The programs ``warm_compile`` must build: every horizon of the K
    schedule and every depth of the speculative schedule, greedy and
    sampled; the admission at every prompt bucket (monolithic prefill) or
    the chunk at every (chunk bucket, context bound) pair that ``repro``'s
    ``warm_compile`` runs (chunked prefill); with a draft, the draft fill
    at every prompt bucket."""
    s = eng.scheduler
    keys = {("decode", k, x) for k in s.k_schedule for x in (False, True)}
    if eng.speculative:
        keys |= {("spec", k, x) for k in s.spec_schedule
                 for x in (False, True)}
        keys |= {("draft_fill", b) for b in eng.buckets}
    if s.chunked:
        for b in s.buckets:
            ctx = 1 << max(b - 1, 1).bit_length()
            while ctx < eng.max_seq_len:
                keys.add(("chunk", b, ctx))
                ctx *= 2
            keys.add(("chunk", b, eng.max_seq_len))
    else:
        keys |= {("admit", b) for b in eng.buckets}
    return keys


def _greedy_margin_rule(jlm, jp, trace, ours, theirs):
    """Greedy streams of the two packages agree up to their first
    difference, which must sit on a near-tie (top-2 margin <= TOL) of
    ``repro``'s teacher-forced logits. Returns the tokens compared."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for rid, (prompt, _) in enumerate(trace):
        a, b = ours[rid], theirs[rid]
        diff = np.flatnonzero(a[:len(b)] != b[:len(a)])
        upto = diff[0] if len(diff) else min(len(a), len(b))
        compared += upto
        if not len(diff):
            assert len(a) == len(b), (rid, a, b)
            continue
        ctx = np.concatenate([prompt, b[:upto]])[None].astype(np.int32)
        top = np.sort(np.asarray(fwd(jp, ctx))[0, -1].astype(np.float64))
        assert top[-1] - top[-2] <= TOL, (rid, upto, a, b)
    return compared


# -- the mirrored tests --------------------------------------------------------

def test_warm_compile_covers_scan_horizons():
    """``warm_compile`` builds the single step and every horizon of the K
    schedule (paged, chunked prefill, K = 8, two slots) without observable
    effect: the trace then gives the streams of an engine that never
    warmed, and ``repro``'s, and traffic builds no further program."""
    jlm, jp, lm, params = _pair(2, "tiny", 0)
    trace = _trace(n=4, seed=6, budgets=(3, 12), span=(3, 12))
    kw = dict(max_seq_len=32, min_bucket=4, batch_slots=2,
              max_decode_steps=8)
    base = _serve(ServingEngine(lm, params, **kw), trace)
    paged = dict(kw, cache_backend="paged", block_size=8, chunk_tokens=8)
    eng = ServingEngine(lm, params, **paged)
    assert eng._programs == {}
    eng.warm_compile()
    assert set(eng._programs) == _variants(eng)
    assert eng.scheduler.k_schedule == [1, 2, 4, 8]
    out = _serve(eng, trace)
    _assert_same(base, out)
    assert set(eng._programs) == _variants(eng)
    eng.assert_invariants()
    jeng = JaxEngine(jlm, jp, **paged)
    jeng.warm_compile()
    theirs = _serve(jeng, trace)
    assert _greedy_margin_rule(jlm, jp, trace, out, theirs) >= 20


def test_warm_compile_covers_speculative_and_sampled():
    """With a draft, ``warm_compile`` builds the decode programs and the
    speculative round at every depth, greedy and sampled; sampled traffic
    through every decode path builds none after it. On the CPU every
    program is the eager call: no graph, no pool."""
    _, _, tgt, tp = _pair(2, "tgt", 0)
    _, _, drf, dp = _pair(1, "drf", 7)
    kw = dict(max_seq_len=64, min_bucket=4, batch_slots=4, eos_id=5,
              chunk_tokens=8, max_decode_steps=4, draft_model=drf,
              draft_params=dp, speculative_tokens=4)
    trace = _trace(seed=11)
    cold = ServingEngine(tgt, tp, **kw)
    cold.scheduler.spec_min_commit = 0.0
    base = _serve(cold, trace, 0.9)
    eng = ServingEngine(tgt, tp, **kw)
    eng.scheduler.spec_min_commit = 0.0
    assert eng.metrics()["warm_compile_s"] is None
    eng.warm_compile()
    expected = _variants(eng)
    assert len([k for k in expected if k[0] in ("decode", "spec")]) == 12
    assert set(eng._programs) == expected
    m = eng.metrics()
    assert m["warm_compile_s"] > 0.0 and m["graphs"] == 0
    assert eng.graph_pool_bytes() == 0 and not eng._use_graphs
    out = _serve(eng, trace, 0.9)
    assert set(eng._programs) == expected, "built a program post-warm"
    assert eng.spec_rounds > 0 and eng.decode_steps > eng.spec_rounds
    _assert_same(base, out)


# -- warm_compile changes no stream ------------------------------------------------

@pytest.mark.parametrize("backend", ["ring", "paged"])
@pytest.mark.parametrize("mode", ["K=4", "spec k=4"])
def test_warm_compile_changes_no_stream(backend, mode):
    """The same greedy and sampled trace through an engine that warmed and
    one that did not, on the ring and the paged backend, at K = 4 and with
    speculation at k = 4: equal streams token for token."""
    _, _, tgt, tp = _pair(2, "tgt", 0)
    _, _, drf, dp = _pair(1, "drf", 7)
    kw = dict(max_seq_len=64, min_bucket=4, batch_slots=4, eos_id=5)
    if backend == "paged":
        kw.update(cache_backend="paged", block_size=8)
    if mode == "K=4":
        kw.update(max_decode_steps=4)
    else:
        kw.update(draft_model=drf, draft_params=dp, speculative_tokens=4)
    trace = _trace(seed=13)
    temps = [0.8 * (i % 2) for i in range(len(trace))]
    outs = []
    for warm in (False, True):
        eng = ServingEngine(tgt, tp, **kw)
        eng.scheduler.spec_min_commit = 0.0
        if warm:
            eng.warm_compile()
        outs.append(_serve(eng, trace, temps))
        assert eng.decode_steps > 0
        if mode != "K=4":
            assert eng.spec_rounds > 0
    _assert_same(*outs)


# -- the storage a graph reads and writes stays put ---------------------------

def _storage(eng):
    """data_ptr of every tensor a decode program touches: the slot state,
    every cache leaf, the block tables and the draft's cache leaves."""
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
    if eng.speculative:
        leaves(eng._draft_state, "draft")
    return ptrs


@pytest.mark.parametrize("preempt_mode", ["swap", "recompute"])
def test_state_storage_is_stable(preempt_mode):
    """A paged speculative engine (chunked prefill, prefix sharing, K = 4,
    k = 2) serves two waves: a 16-token prefix shared by three prompts,
    one request preempted mid-decode (swapped out to the host and back, or
    freed and re-prefilled), then the prefix alone (copy-on-write of its
    last shared block). Plain rounds while prompts prefill leave the draft
    behind, so speculative rounds re-sync it. Through all of it the slot
    state, the pool, the tables and the draft ring keep their storage, and
    the streams equal a plain K = 1 engine's."""
    _, _, tgt, tp = _pair(2, "tgt", 0)
    _, _, drf, dp = _pair(1, "drf", 7)
    rng = np.random.default_rng(21)
    pre = rng.integers(0, 60, 16).astype(np.int32)
    wave1 = [np.concatenate([pre, rng.integers(0, 60, n)]).astype(np.int32)
             for n in (3, 9, 5)] + [rng.integers(0, 60, 11).astype(np.int32)]
    wave2 = [pre.copy(), rng.integers(0, 60, 7).astype(np.int32)]
    kw = dict(max_seq_len=64, min_bucket=4, batch_slots=3,
              cache_backend="paged", block_size=8, chunk_tokens=8,
              preempt_mode=preempt_mode)
    temps = [0.0, 0.8, 0.0, 0.8]

    def serve(eng, preempt):
        ids = [eng.submit(p, max_new_tokens=14, temperature=t)
               for p, t in zip(wave1, temps)]
        if preempt:
            while len(eng._slots) < 2 or not eng.spec_rounds:
                eng.step()
            eng.preempt(max(eng._slots))
        done = eng.run()
        ids += [eng.submit(p, max_new_tokens=10) for p in wave2]
        done.update(eng.run())
        eng.assert_invariants()
        return [done[i].output for i in ids]

    base = serve(ServingEngine(tgt, tp, **kw), preempt=False)
    eng = ServingEngine(tgt, tp, max_decode_steps=4, draft_model=drf,
                        draft_params=dp, speculative_tokens=2, **kw)
    eng.scheduler.spec_min_commit = 0.0
    resynced = [0]
    resync = eng._resync_draft

    def counted(slots):
        resynced[0] += sum(s in eng._draft_dirty for s in slots)
        return resync(slots)

    eng._resync_draft = counted
    ptrs = _storage(eng)
    eng.warm_compile()
    assert _storage(eng) == ptrs
    out = serve(eng, preempt=True)
    assert _storage(eng) == ptrs
    be = eng.backend
    assert eng.preemptions == 1 and be.cow_copies >= 1 and resynced[0] >= 1
    assert (be.swap_outs == be.swap_ins == 1) == (preempt_mode == "swap")
    assert eng.spec_rounds > 0
    for a, b in zip(out, base):
        np.testing.assert_array_equal(a, b)


# -- the cascade, and a live engine ---------------------------------------------

def test_cascade_warm_compile_warms_both_legs():
    """``CascadeServingEngine.warm_compile`` warms the edge engine and the
    cloud engine (whose speculative rounds draft with the edge); the
    cascade's streams then equal a cold cascade's, and traffic builds no
    further program on either leg."""
    _, _, cloud, cp = _pair(2, "cloud", 0)
    edge = LM(edge_variant(cloud.cfg, layers=1), device="cpu")
    ep = edge.init(1)
    trace = _trace(n=8, seed=5, budgets=(4, 12))
    temps = [0.8 * (i % 2) for i in range(len(trace))]
    kw = dict(batch_slots=4, max_seq_len=64, max_decode_steps=2,
              speculative_tokens=2)
    probe = CascadeServingEngine(CascadeLM(edge, cloud), ep, cp, **kw)
    conf = sorted(probe._gate(p)[0] for p, _ in trace)
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(
        hi=(conf[5] + conf[6]) / 2, lo=(conf[1] + conf[2]) / 2))
    outs = []
    for warm in (False, True):
        eng = CascadeServingEngine(cas, ep, cp, **kw)
        eng.cloud_engine.scheduler.spec_min_commit = 0.0
        if warm:
            eng.warm_compile()
            legs = (eng.edge_engine, eng.cloud_engine)
            for leg in legs:
                assert leg.warm_compile_s is not None
                assert set(leg._programs) == _variants(leg)
            assert any(k[0] == "spec" for k in eng.cloud_engine._programs)
            m = eng.engine_metrics()
            assert m["edge"]["warm_compile_s"] is not None
            assert m["cloud"]["warm_compile_s"] is not None
        outs.append(_serve(eng, trace, temps))
        if warm:
            for leg in legs:
                assert set(leg._programs) == _variants(leg)
    m = eng.metrics
    assert m.accepted and m.escalated and m.dropped
    assert eng.cloud_engine.spec_rounds > 0
    _assert_same(*outs)


def test_warm_compile_refuses_a_live_engine():
    """Its warm-up runs would advance live slots: ``warm_compile`` raises
    once a slot holds a request, and works again once the engine drains."""
    _, _, lm, params = _pair(2, "tiny", 0)
    eng = ServingEngine(lm, params, max_seq_len=32, min_bucket=4,
                        batch_slots=2)
    eng.submit(np.arange(5), max_new_tokens=4)
    eng.step()
    with pytest.raises(RuntimeError, match="idle"):
        eng.warm_compile()
    eng.run()
    eng.warm_compile()
    assert set(eng._programs) == _variants(eng)
