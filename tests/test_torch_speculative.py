"""Speculative decoding in the port (``ServingEngine`` with a draft model,
and ``CascadeServingEngine(speculative_tokens=k)``) on the CPU.

It mirrors ``tests/test_speculative.py``: verification is key-coupled (a
proposal is accepted iff it equals the token the target samples with the
same folded key), so speculative streams equal the non-speculative K = 1
engine's token for token, at every temperature, on every cache
configuration and at any acceptance rate, and under chaos at the draft
fault seam (a failed speculative round is served plain). ``warm_compile``
is held by ``tests/test_torch_warm_compile.py``.

Across packages, on weights bridged from ``repro``'s ``LM.init``: the
port's speculative streams equal ``repro``'s, greedy and sampled, wherever
the top-2 margin at a step (of the logits, or at T > 0 of the scaled
logits plus that step's Gumbel noise) exceeds the logits tolerance, 1e-4
(``tests/test_torch_engine.py``'s rule). The windowed ring: ``repro``
speculates over a ring narrower than ``max_seq_len`` and its streams go
wrong there; the port refuses it and serves the paged backend instead.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.cascade.ecc_infer import CascadeLM as JaxCascadeLM  # noqa: E402
from repro.cascade.ecc_infer import edge_variant as jax_edge_variant  # noqa: E402
from repro.cascade.gate import make_thresholds as jax_thresholds  # noqa: E402
from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import CascadeServingEngine as JaxCascade  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.sampler import request_keys as jax_request_keys  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cascade import CascadeLM, edge_variant  # noqa: E402
from repro_torch.cascade.gate import make_thresholds  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (CascadeServingEngine,  # noqa: E402
                                 ServingEngine)
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

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


def _fields(layers, name, vocab=64, window=None):
    return dict(name=name, family="dense", source="t", num_layers=layers,
                d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                d_ff=64, vocab_size=vocab, param_dtype="float32"), \
        dict(n_layers=layers, window=window)


def _pair(layers, name, seed, vocab=64, window=None):
    """(repro LM, params, port LM, bridged params) of ``tests/
    test_speculative.py``'s tiny config."""
    fields, st = _fields(layers, name, vocab, window)
    jlm = JaxLM(ModelConfig(**fields, stages=dense_stages(**st)), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(seed))
    tc = tcfg.ModelConfig(**fields, stages=tcfg.dense_stages(**st))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


@functools.lru_cache(maxsize=None)
def _models():
    """``tests/test_speculative.py``'s models: a 2-layer target from
    PRNGKey(0) and a 1-layer draft from PRNGKey(7)."""
    return _pair(2, "tgt", 0), _pair(1, "drf", 7)


@pytest.fixture(scope="module")
def models():
    (_, _, tgt, tp), (_, _, drf, dp) = _models()
    return tgt, tp, drf, dp


def _trace(n=8, seed=2, budgets=(3, 24), span=(3, 20)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 60, size=int(rng.integers(*span))),
             int(rng.integers(*budgets))) for _ in range(n)]


def _run(lm, params, trace, temperature=0.0, force_spec=False, eos_id=5,
         engine=ServingEngine, **kw):
    eng = engine(lm, params, max_seq_len=64, min_bucket=4, batch_slots=4,
                 eos_id=eos_id, **kw)
    if force_spec:
        # keep speculating at any acceptance rate: the exactness tests
        # must run the rejection-heavy paths that the EWMA policy would
        # rightly turn off for a random draft
        eng.scheduler.spec_min_commit = 0.0
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new, temperature=temperature)
    return eng, {rid: r.output for rid, r in eng.run().items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


CONFIGS = {
    "ring": {},
    "paged": dict(cache_backend="paged", block_size=8),
    "chunked": dict(chunk_tokens=8),
    "paged_chunked_multistep": dict(cache_backend="paged", block_size=8,
                                    chunk_tokens=8, max_decode_steps=4),
}


def _keyed_margin_rule(jlm, jp, seed, trace, temperature, ours, theirs):
    """Streams agree up to their first difference, which must sit on a
    near-tie of ``repro``'s teacher-forced logits: top-2 margin <= TOL, or
    at T > 0 the margin of logits / T plus the step's Gumbel noise (the
    key ``fold_in(fold_in(PRNGKey(seed), rid), step)``) <= TOL / T + 1e-5
    (the noise's own ulps). Returns the number of tokens compared."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for rid, (prompt, _) in enumerate(trace):
        a, b = ours[rid], theirs[rid]
        diff = np.flatnonzero(a[:len(b)] != b[:len(a)])
        upto = diff[0] if len(diff) else min(len(a), len(b))
        compared += upto
        if not len(diff):
            # an EOS parted earlier only if its step was a near-tie too
            assert len(a) == len(b), (rid, a, b)
            continue
        ctx = np.concatenate([prompt, b[:upto]])[None].astype(np.int32)
        logits = np.asarray(fwd(jp, ctx))[0, -1].astype(np.float64)
        tol = TOL
        if temperature > 0:
            key = jax_request_keys(jax.random.PRNGKey(seed),
                                   np.asarray([rid]), np.asarray([upto]))[0]
            noise = np.asarray(jax.random.gumbel(key, logits.shape))
            logits = logits / temperature + noise
            tol = TOL / temperature + 1e-5
        top = np.sort(logits)
        assert top[-1] - top[-2] <= tol, (rid, upto, a, b)
    return compared


# -- stream equality: greedy and sampled, every configuration ----------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_matches_baseline(models, name, temperature):
    tgt, tp, drf, dp = models
    kw = CONFIGS[name]
    trace = _trace()
    _, base = _run(tgt, tp, trace, temperature, **kw)
    eng, spec = _run(tgt, tp, trace, temperature, force_spec=True,
                     draft_model=drf, draft_params=dp,
                     speculative_tokens=4, **kw)
    _assert_same(base, spec)
    m = eng.speculative_metrics()
    assert m["enabled"] and m["rounds"] > 0 and m["drafted_tokens"] > 0
    # anchors always commit: a speculative dispatch never banks < 1 token
    assert m["committed_per_dispatch"] >= 1.0


def test_spec_exact_under_heavy_rejection(models):
    tgt, tp, drf, dp = models
    trace = _trace(seed=9)
    _, base = _run(tgt, tp, trace, 0.0)
    eng, spec = _run(tgt, tp, trace, 0.0, force_spec=True,
                     draft_model=drf, draft_params=dp, speculative_tokens=4)
    _assert_same(base, spec)
    assert eng.spec_rounds > 5


def test_draft_seam_chaos_exact_and_drains(models):
    """``tests/test_speculative.py``'s draft-seam chaos: half the
    speculative rounds fail at the draft seam and are served as plain
    rounds; the streams stay the non-speculative engine's, the engine
    drains, and the fallbacks are counted where ``repro`` counts them."""
    from repro_torch.serving import FaultPlan
    tgt, tp, drf, dp = models
    trace = _trace(seed=6)
    _, base = _run(tgt, tp, trace, 0.7)
    plan = FaultPlan(seed=3, draft={"prob": 0.5})
    eng, spec = _run(tgt, tp, trace, 0.7, force_spec=True,
                     draft_model=drf, draft_params=dp, speculative_tokens=4,
                     fault_plan=plan)
    _assert_same(base, spec)
    assert eng.spec_fallbacks > 0 and eng.spec_rounds > 0
    assert not eng.pending
    m = eng.metrics()
    assert m["terminal"] == {"done": len(trace)}
    assert m["faults_injected"].get("draft", 0) == eng.spec_fallbacks
    assert m["speculative"]["fallbacks"] == eng.spec_fallbacks


def test_self_draft_accepts_everything(models):
    """A draft equal to the target proposes the baseline's tokens, so every
    proposal is accepted. EOS is off: an EOS in the chunk cuts the commit
    and turns matched proposals past it into drafted-not-accepted."""
    tgt, tp, _, _ = models
    trace = _trace(budgets=(16, 25))
    _, base = _run(tgt, tp, trace, 0.0, eos_id=None)
    eng, spec = _run(tgt, tp, trace, 0.0, eos_id=None, draft_model=tgt,
                     draft_params=tp, speculative_tokens=4)
    _assert_same(base, spec)
    m = eng.speculative_metrics()
    assert m["acceptance_rate"] == 1.0
    assert m["committed_per_dispatch"] > 2.0


# -- sampled streams: co-scheduling invariance and distribution sanity -------

def test_sampled_spec_invariant_to_coscheduling(models):
    tgt, tp, drf, dp = models
    trace = _trace(seed=4)
    kw = dict(force_spec=True, draft_model=drf, draft_params=dp,
              speculative_tokens=4)
    _, together = _run(tgt, tp, trace, 0.8, **kw)
    eng = ServingEngine(tgt, tp, max_seq_len=64, min_bucket=4,
                        batch_slots=4, eos_id=5, draft_model=drf,
                        draft_params=dp, speculative_tokens=4)
    eng.scheduler.spec_min_commit = 0.0
    trickled = {}
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new, temperature=0.8)
        eng.step()            # staggered admission: other co-batching
    trickled.update({rid: r.output for rid, r in eng.run().items()})
    _assert_same(together, trickled)


def test_sampled_spec_first_token_distribution(models):
    """Over many request ids, speculative first tokens off one prompt
    follow the target's softmax (chi-square over 8 equal-mass bins, as in
    ``tests/test_speculative.py``)."""
    tgt, tp, drf, dp = models
    prompt = np.array([3, 11, 7], np.int32)
    eng = ServingEngine(tgt, tp, max_seq_len=64, min_bucket=4,
                        batch_slots=4, draft_model=drf, draft_params=dp,
                        speculative_tokens=4)
    eng.scheduler.spec_min_commit = 0.0
    n = 256
    for _ in range(n):
        eng.submit(prompt, max_new_tokens=2, temperature=1.0)
    firsts = np.array([r.output[0] for r in eng.run().values()])
    logits, _ = tgt.prefill(tp, {"tokens": torch.from_numpy(prompt[None])},
                            cache_width=64)
    p = torch.softmax(logits[0, -1].double(), dim=-1).numpy()
    order = np.argsort(-p)
    left = np.cumsum(p[order]) - p[order]
    tok_bin = np.empty(len(p), np.int64)
    tok_bin[order] = np.minimum((left * 8).astype(np.int64), 7)
    obs = np.bincount(tok_bin[firsts], minlength=8).astype(np.float64)
    exp = np.bincount(tok_bin, weights=p, minlength=8) * n
    chi2 = float(((obs - exp) ** 2 / np.maximum(exp, 1e-9)).sum())
    assert chi2 < 40.0, chi2


# -- non-speculative engines and validation ----------------------------------

def test_non_speculative_metrics_shape(models):
    tgt, tp, _, _ = models
    eng = ServingEngine(tgt, tp, max_seq_len=64, min_bucket=4)
    m = eng.metrics()["speculative"]
    assert m["enabled"] is False and m["rounds"] == 0
    assert m["acceptance_rate"] == 0.0 and m["per_class"] == {}


def test_speculative_validation(models):
    tgt, tp, drf, dp = models
    with pytest.raises(ValueError, match="needs a draft_model"):
        ServingEngine(tgt, tp, max_seq_len=64, speculative_tokens=2)
    with pytest.raises(ValueError, match="draft_params"):
        ServingEngine(tgt, tp, max_seq_len=64, draft_model=drf,
                      speculative_tokens=2)
    # padded_vocab rounds to a multiple of 256: 300 -> 512 against 256
    _, _, big, bp = _pair(1, "bigvocab", 1, vocab=300)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tgt, tp, max_seq_len=64, draft_model=big,
                      draft_params=bp, speculative_tokens=2)


# -- scheduler policy ----------------------------------------------------------

def test_spec_schedule_shape():
    s = Scheduler(batch_slots=4, speculative_tokens=6)
    assert s.spec_schedule == [1, 2, 4, 6]
    assert Scheduler(batch_slots=4).spec_schedule == []


def test_spec_horizon_collapses_for_prefill_and_headroom():
    s = Scheduler(batch_slots=4, speculative_tokens=4)
    assert s._spec_horizon(False, 16) == 4
    assert s._spec_horizon(True, 16) == 0
    assert s._spec_horizon(False, 3) == 2
    assert s._spec_horizon(False, 1) == 0
    assert s._spec_horizon(False, None) == 4


def test_spec_ewma_suppression_and_probe():
    s = Scheduler(batch_slots=4, speculative_tokens=4, spec_probe_every=5)
    for _ in range(8):
        s.observe_speculation(4, 16, 0)
    picks = [s._spec_horizon(False, 16) for _ in range(10)]
    assert picks.count(0) == 8
    assert picks.count(4) == 2
    for _ in range(8):
        s.observe_speculation(4, 16, 14)
    assert s._spec_horizon(False, 16) == 4
    assert s.speculative_acceptance() > 1.0


# -- against repro ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["ring", "paged_chunked_multistep"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_streams_match_repro(name, temperature):
    """The same speculative engine in both packages on bridged weights:
    equal streams up to a near-tie, and the same speculative accounting
    wherever the streams agree throughout."""
    (jt, jtp, tgt, tp), (jd, jdp, drf, dp) = _models()
    kw = dict(CONFIGS[name], force_spec=True, speculative_tokens=4)
    trace = _trace(seed=3)
    eng, ours = _run(tgt, tp, trace, temperature, draft_model=drf,
                     draft_params=dp, **kw)
    jeng, theirs = _run(jt, jtp, trace, temperature, engine=JaxEngine,
                        draft_model=jd, draft_params=jdp, **kw)
    compared = _keyed_margin_rule(jt, jtp, 0, trace, temperature, ours,
                                  theirs)
    assert compared >= 60
    if all(np.array_equal(ours[r], theirs[r]) for r in ours):
        assert eng.speculative_metrics() == jeng.speculative_metrics()


# -- the windowed ring ---------------------------------------------------------

def _window_trace():
    """6 requests, prompts of 9-18 tokens, 10-29 new tokens each."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 60, int(rng.integers(9, 19))),
             int(rng.integers(10, 30))) for _ in range(6)]


@functools.lru_cache(maxsize=None)
def _windowed(window):
    return _pair(2, "tgt-window", 0, window=window)


def test_spec_refuses_a_wrapping_window_ring_and_serves_paged():
    """A windowed layer's ring narrower than ``max_seq_len`` cannot take
    the verify chunk: the port raises and names the paged backend, which
    serves the same model with streams equal to the plain engine's. A
    window as wide as ``max_seq_len`` never wraps and is served."""
    _, (_, _, drf, dp) = _models()
    _, _, tgt, tp = _windowed(8)
    spec = dict(draft_model=drf, draft_params=dp, speculative_tokens=4)
    with pytest.raises(NotImplementedError, match="paged backend"):
        ServingEngine(tgt, tp, max_seq_len=64, **spec)
    trace = _window_trace()
    paged = dict(cache_backend="paged", block_size=8)
    for kw in (paged, dict(paged, chunk_tokens=8)):
        _, base = _run(tgt, tp, trace, eos_id=None, **kw)
        _, out = _run(tgt, tp, trace, eos_id=None, force_spec=True,
                      **spec, **kw)
        _assert_same(base, out)
    _, _, wide, wp = _windowed(64)
    _, base = _run(wide, wp, trace, eos_id=None)
    _, out = _run(wide, wp, trace, eos_id=None, force_spec=True, **spec)
    _assert_same(base, out)


def test_reference_speculation_over_a_wrapping_window_ring_diverges():
    """The fault the port refuses, shown in ``repro``: on a window-8 ring
    its speculative streams leave its own non-speculative ones (even with
    the target as its own draft), while its paged backend keeps them; and
    the port's paged speculative streams equal ``repro``'s paged ones."""
    jt, jtp, tgt, tp = _windowed(8)
    jd, jdp, drf, dp = _models()[1]
    trace = _window_trace()
    _, base = _run(jt, jtp, trace, eos_id=None, engine=JaxEngine)
    for draft, dparams in ((jd, jdp), (jt, jtp)):
        _, ring = _run(jt, jtp, trace, eos_id=None, engine=JaxEngine,
                       force_spec=True, draft_model=draft,
                       draft_params=dparams, speculative_tokens=4)
        parted = [r for r in base if not np.array_equal(base[r], ring[r])]
        assert len(parted) == len(trace), parted
    paged = dict(cache_backend="paged", block_size=8, force_spec=True,
                 draft_model=jd, draft_params=jdp, speculative_tokens=4)
    _, theirs = _run(jt, jtp, trace, eos_id=None, engine=JaxEngine, **paged)
    _assert_same(base, theirs)
    paged.update(draft_model=drf, draft_params=dp)
    _, ours = _run(tgt, tp, trace, eos_id=None, **paged)
    assert _keyed_margin_rule(jt, jtp, 0, trace, 0.0, ours, theirs) >= 60


# -- the cascade's edge model as the cloud's draft ----------------------------

@functools.lru_cache(maxsize=None)
def _cascades():
    """A 2-layer cloud from PRNGKey(0) and its 1-layer ``edge_variant``
    from PRNGKey(1), in both packages, with thresholds that escalate every
    prompt (``make_thresholds(hi=2.0, lo=0.0)``), so every request drafts."""
    fields, st = _fields(2, "cloud")
    jc = ModelConfig(**fields, stages=dense_stages(**st))
    tc = tcfg.ModelConfig(**fields, stages=tcfg.dense_stages(**st))
    jcloud = JaxLM(jc, kv_chunk=8)
    jedge = JaxLM(jax_edge_variant(jc, layers=1), kv_chunk=8)
    jcp = jax.jit(lambda k: jcloud.init(k)[0])(jax.random.PRNGKey(0))
    jep = jax.jit(lambda k: jedge.init(k)[0])(jax.random.PRNGKey(1))
    cloud, edge = LM(tc, device="cpu"), LM(edge_variant(tc, layers=1),
                                           device="cpu")
    cp = params_from_numpy(jax.tree.map(np.asarray, jcp), cloud.cfg, "cpu")
    ep = params_from_numpy(jax.tree.map(np.asarray, jep), edge.cfg, "cpu")
    jcas = JaxCascadeLM(jedge, jcloud, thresholds=jax_thresholds(hi=2.0,
                                                                 lo=0.0))
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(hi=2.0, lo=0.0))
    return (jcas, jep, jcp), (cas, ep, cp)


def _cascade_run(cls, cas, ep, cp, trace, temperature, **kw):
    eng = cls(cas, ep, cp, batch_slots=4, max_seq_len=64, **kw)
    if kw.get("speculative_tokens"):
        eng.cloud_engine.scheduler.spec_min_commit = 0.0
    ids = [eng.submit(p, max_new_tokens=n, temperature=temperature)
           for p, n in trace]
    done = eng.run()
    assert all(done[i].route == "escalate" for i in ids)
    return eng, {i: done[i].output for i in ids}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cascade_speculative_cloud_matches_plain_and_repro(temperature):
    """``CascadeServingEngine(speculative_tokens=2)``: the cloud engine
    drafts with the edge model; its streams equal the plain cascade's
    token for token and ``repro``'s speculative cascade's under the margin
    rule (the cloud samples with seed + 1)."""
    (jcas, jep, jcp), (cas, ep, cp) = _cascades()
    trace = _trace(n=6, seed=5, budgets=(4, 16))
    _, plain = _cascade_run(CascadeServingEngine, cas, ep, cp, trace,
                            temperature)
    eng, spec = _cascade_run(CascadeServingEngine, cas, ep, cp, trace,
                             temperature, speculative_tokens=2)
    _assert_same(plain, spec)
    m = eng.cloud_engine.speculative_metrics()
    assert m["enabled"] and m["rounds"] > 0
    assert not eng.edge_engine.speculative
    _, theirs = _cascade_run(JaxCascade, jcas, jep, jcp, trace, temperature,
                             speculative_tokens=2)
    jcloud = jcas.cloud
    assert _keyed_margin_rule(jcloud, jcp, 1, trace, temperature, spec,
                              theirs) >= 30
