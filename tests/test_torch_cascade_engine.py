"""The port's cascade engines against ``repro``'s, and their own invariants.

Across packages, on weights bridged from ``repro``'s ``LM.init`` (cloud
from PRNGKey(0), edge from PRNGKey(1)) and one trace, with thresholds set
between the edge confidences' tertiles so that all three routes occur and
no prompt sits near a threshold:
- ``CascadeServingEngine`` on the ring and the paged backend, chunked and
  not, and paged with a small pool under a token budget: the same route
  per request, ``CascadeMetrics`` equal (``agreement`` aside, which follows
  the predictions), and greedy streams equal wherever ``repro``'s top-2
  logit margin at a step exceeds 1e-4 (as in ``tests/test_torch_engine.py``);
- the same under deadline admission ("reject" and "downgrade": the same
  refusals and ``downgraded`` flags) and with ``truncate_prompts``;
- ``CascadeEngine``, compact and lockstep: routes and metrics equal.

Within the port, exactly: accepted streams equal a standalone edge
``ServingEngine`` (seed 0) and escalated streams a standalone cloud one
(seed 1) on the same prompts in the same order, greedy and sampled;
dropped requests return empty outputs; the circuit breaker's state machine
and the edge outage that trips it, fails over to the cloud (token-exact
against a direct cloud run) and closes on the half-open probe; the copied
``FaultPlan`` fires on ``repro``'s schedule.
"""
import dataclasses
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
from repro.serving import CascadeEngine as JaxCascadeEngine  # noqa: E402
from repro.serving import CascadeServingEngine as JaxCascadeServing  # noqa: E402
from repro.serving import CircuitBreaker as JaxBreaker  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cascade import CascadeLM, edge_variant  # noqa: E402
from repro_torch.cascade.gate import make_thresholds  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (CascadeEngine,  # noqa: E402
                                 CascadeServingEngine, CircuitBreaker,
                                 FaultError, FaultPlan, ServingEngine)

MARGIN = 1e-4
FIELDS = dict(name="tiny", family="dense", source="t", num_layers=2,
              d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=96, param_dtype="float32")
KW = dict(batch_slots=2, max_seq_len=32)
BACKENDS = {"ring": {}, "ring_chunked": dict(chunk_tokens=8),
            "paged": dict(cache_backend="paged", block_size=8),
            "paged_chunked": dict(cache_backend="paged", block_size=8,
                                  chunk_tokens=8),
            # 4 usable blocks (the default pool holds 8) under a 12-token
            # budget: admissions wait on blocks, chunks on the budget
            "paged_pool_budget": dict(cache_backend="paged", block_size=8,
                                      chunk_tokens=8, num_pool_blocks=5,
                                      token_budget=12)}
PROMPTS = [np.random.default_rng(10 + i).integers(0, 96, n).astype(np.int32)
           for i, n in enumerate((5, 12, 20, 9, 17, 4, 14, 7, 11))]
MAX_NEW = 4


@functools.lru_cache(maxsize=None)
def _models():
    """(repro edge, cloud, params), (port edge, cloud, params)."""
    jc = ModelConfig(**FIELDS, stages=dense_stages(2))
    je = jax_edge_variant(jc, layers=1)
    tc = tcfg.ModelConfig(**FIELDS, stages=tcfg.dense_stages(2))
    te = edge_variant(tc, layers=1)
    jcloud, jedge = JaxLM(jc, kv_chunk=8), JaxLM(je, kv_chunk=8)
    jcp = jax.jit(lambda k: jcloud.init(k)[0])(jax.random.PRNGKey(0))
    jep = jax.jit(lambda k: jedge.init(k)[0])(jax.random.PRNGKey(1))
    tcp = params_from_numpy(jax.tree.map(np.asarray, jcp), tc, "cpu")
    tep = params_from_numpy(jax.tree.map(np.asarray, jep), te, "cpu")
    return ((jedge, jcloud, jep, jcp),
            (LM(te, device="cpu"), LM(tc, device="cpu"), tep, tcp))


def _split(conf):
    """hi/lo between neighbouring sorted confidences near the tertiles,
    where the gap is widest, so no prompt sits near a threshold."""
    srt = np.sort(np.asarray(conf, np.float64))
    n = len(srt)

    def cut(k):
        i = max(range(max(1, k - 1), min(n - 1, k + 1) + 1),
                key=lambda j: srt[j] - srt[j - 1])
        return float((srt[i] + srt[i - 1]) / 2)

    return cut(2 * n // 3), cut(n // 3)


@functools.lru_cache(maxsize=None)
def _thresholds():
    """Tertile thresholds of the port's gate confidences on PROMPTS."""
    _, (edge, cloud, tep, tcp) = _models()
    probe = CascadeServingEngine(CascadeLM(edge, cloud), tep, tcp, **KW)
    return _split([probe._gate(p)[0] for p in PROMPTS])


def _cascades():
    (jedge, jcloud, jep, jcp), (edge, cloud, tep, tcp) = _models()
    hi, lo = _thresholds()
    return ((JaxCascadeLM(jedge, jcloud, thresholds=jax_thresholds(hi, lo)),
             jep, jcp),
            (CascadeLM(edge, cloud, thresholds=make_thresholds(hi, lo)),
             tep, tcp))


def _serve(engine, reqs):
    ids = [engine.submit(p, max_new_tokens=n, temperature=t)
           for p, n, t in reqs]
    done = engine.run()
    assert sorted(done) == sorted(ids)
    assert all(done[i].status == "done" for i in ids)
    return [done[i] for i in ids]


def _metrics(m):
    d = dataclasses.asdict(m)
    d.pop("agreement")
    return d


def _assert_streams_match(jcas, jep, jcp, prompts, ours, theirs):
    """Greedy streams equal up to the first step where ``repro``'s top-2
    logit margin is within MARGIN; dropped and refused requests are empty
    on both sides. Returns the tokens compared."""
    fwd = {
        "accept": jax.jit(lambda t: jcas.edge.forward(jep, {"tokens": t})[0]),
        "escalate": jax.jit(lambda t: jcas.cloud.forward(jcp,
                                                         {"tokens": t})[0])}
    compared = 0
    for prompt, a, b in zip(prompts, ours, theirs):
        if b.route == "drop" or b.status != "done":
            assert a.output.size == 0 and b.output.size == 0
            continue
        assert len(a.output) == len(b.output)
        diff = np.flatnonzero(a.output != b.output)
        upto = diff[0] if len(diff) else len(b.output)
        compared += upto
        if len(diff):
            # the first disagreement must sit on a near-tie of repro's logits
            ctx = np.concatenate([prompt, b.output[:upto]])[None]
            logits = np.sort(np.asarray(fwd[b.route](ctx))[0, -1])
            assert logits[-1] - logits[-2] <= MARGIN, (upto, a, b)
    return compared


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_cascade_serving_matches_repro(backend):
    (jcas, jep, jcp), (cas, tep, tcp) = _cascades()
    kw = dict(KW, **BACKENDS[backend])
    reqs = [(p, MAX_NEW, 0.0) for p in PROMPTS]
    eng = CascadeServingEngine(cas, tep, tcp, **kw)
    jeng = JaxCascadeServing(jcas, jep, jcp, **kw)
    ours, theirs = _serve(eng, reqs), _serve(jeng, reqs)
    assert _metrics(eng.metrics) == _metrics(jeng.metrics)
    a, b = eng.engine_metrics(), jeng.engine_metrics()
    for key in ("queries", "accepted", "escalated", "dropped", "rerouted",
                "edge_failures", "wan_bytes", "breaker"):
        assert a[key] == b[key], key
    for leg in ("edge", "cloud"):
        for key in ("live", "terminal", "preemptions", "generated_tokens",
                    "host_syncs", "occupancy"):
            assert a[leg][key] == b[leg][key], (leg, key)
    routes = [r.route for r in theirs]
    assert [r.route for r in ours] == routes
    assert {"accept", "escalate", "drop"} <= set(routes)
    np.testing.assert_allclose([r.conf for r in ours],
                               [r.conf for r in theirs], rtol=0, atol=1e-5)
    for a in ours:
        assert len(a.output) == (0 if a.route == "drop" else MAX_NEW)
    assert _assert_streams_match(jcas, jep, jcp, PROMPTS, ours,
                                 theirs) >= 3 * MAX_NEW


def _tap_inner(engine):
    """Record every request the cascade's legs hand back (their
    ``downgraded`` flags live there), in completion order per leg."""
    seen = {"edge": [], "cloud": []}
    for leg in seen:
        inner = getattr(engine, f"{leg}_engine")

        def take_done(inner=inner, out=seen[leg],
                      orig=inner.take_done):
            done = orig()
            out.extend(done[k] for k in sorted(done))
            return done

        inner.take_done = take_done
    return seen


@pytest.mark.parametrize("policy", ["reject", "downgrade"])
def test_cascade_admission_matches_repro(policy):
    """``admission_policy`` reaches both legs, as in ``repro``. A first
    wave without deadlines gives each leg a measured service rate; in the
    second, every other request carries a deadline no leg can meet
    (1 us): "reject" refuses it with ``deadline_infeasible``, "downgrade"
    serves it best-effort with ``downgraded`` set; the rest carry a
    generous one. Routes, statuses, failure reasons, the legs' flags and
    greedy streams equal ``repro``'s."""
    (jcas, jep, jcp), (cas, tep, tcp) = _cascades()
    kw = dict(KW, admission_policy=policy)
    engines = (CascadeServingEngine(cas, tep, tcp, **kw),
               JaxCascadeServing(jcas, jep, jcp, **kw))
    waves = []
    for eng in engines:
        _serve(eng, [(p, MAX_NEW, 0.0) for p in PROMPTS])
        taps = _tap_inner(eng)
        ids = [eng.submit(p, max_new_tokens=MAX_NEW,
                          deadline_s=1e-6 if i % 2 else 1e3)
               for i, p in enumerate(PROMPTS)]
        done = eng.run()
        waves.append(([done[i] for i in ids], taps))
    (ours, our_taps), (theirs, their_taps) = waves
    assert [r.route for r in ours] == [r.route for r in theirs]
    assert [r.status for r in ours] == [r.status for r in theirs]
    reasons = [[(r.failure_reason or "").split(":")[0] for r in rs]
               for rs in (ours, theirs)]
    assert reasons[0] == reasons[1]
    tight = [r for i, r in enumerate(ours) if i % 2 and r.route != "drop"]
    assert tight
    if policy == "reject":
        assert all(r.status == "rejected" for r in tight)
        assert {"deadline_infeasible", ""} == set(reasons[0])
    else:
        assert all(r.status == "done" for r in ours)
    for leg in ("edge", "cloud"):
        flags = [[r.downgraded for r in taps[leg]]
                 for taps in (our_taps, their_taps)]
        assert flags[0] == flags[1], leg
        assert any(flags[0]) == (policy == "downgrade"), leg
    assert _assert_streams_match(jcas, jep, jcp, PROMPTS, ours,
                                 theirs) >= MAX_NEW


def test_cascade_truncate_prompts_matches_repro():
    """With ``truncate_prompts`` an over-long prompt keeps its tail (the
    last max_seq_len - max_new_tokens tokens) and is gated and served on
    it, as in ``repro``; without it the prompt is refused at submit."""
    (jcas, jep, jcp), (cas, tep, tcp) = _cascades()
    kw = dict(batch_slots=2, max_seq_len=16)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 96, n).astype(np.int32)
               for n in (30, 13, 25, 12, 40)]
    reqs = [(p, MAX_NEW, 0.0) for p in prompts]
    ours = _serve(CascadeServingEngine(cas, tep, tcp, truncate_prompts=True,
                                       **kw), reqs)
    theirs = _serve(JaxCascadeServing(jcas, jep, jcp, truncate_prompts=True,
                                      **kw), reqs)
    for p, a, b in zip(prompts, ours, theirs):
        np.testing.assert_array_equal(a.prompt, p[-(16 - MAX_NEW):])
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert [r.route for r in ours] == [r.route for r in theirs]
    np.testing.assert_allclose([r.conf for r in ours],
                               [r.conf for r in theirs], rtol=0, atol=1e-5)
    _assert_streams_match(jcas, jep, jcp, [r.prompt for r in theirs], ours,
                          theirs)
    with pytest.raises(ValueError, match="truncate_prompts=True"):
        CascadeServingEngine(cas, tep, tcp, **kw).submit(prompts[0],
                                                         max_new_tokens=4)


@pytest.mark.parametrize("backend", ["ring", "paged_chunked"])
def test_cascade_streams_equal_standalone_engines(backend):
    """Accepted requests generate on the edge engine (seed 0), escalated
    ones on the cloud engine (seed 1): token for token what standalone
    engines give on the same prompts in the same order, greedy and
    sampled. Dropped requests are answered at the gate, empty."""
    _, (cas, tep, tcp) = _cascades()
    kw = dict(KW, **BACKENDS[backend])
    reqs = [(p, MAX_NEW + i % 3, 1.2 if i % 3 == 1 else 0.0)
            for i, p in enumerate(PROMPTS)]
    out = _serve(CascadeServingEngine(cas, tep, tcp, **kw), reqs)
    for route, lm, params, seed in (("accept", cas.edge, tep, 0),
                                    ("escalate", cas.cloud, tcp, 1)):
        mine = [(r, q) for r, q in zip(out, reqs) if r.route == route]
        assert mine, route
        ref = _serve(ServingEngine(lm, params, seed=seed, **kw),
                     [q for _, q in mine])
        for (r, _), s in zip(mine, ref):
            np.testing.assert_array_equal(r.output, s.output)
    assert any(t > 0 and r.route != "drop" for r, (_, _, t) in zip(out, reqs))
    for r, (_, n, _) in zip(out, reqs):
        assert len(r.output) == (0 if r.route == "drop" else n)


@pytest.mark.parametrize("compact", [True, False])
def test_cascade_engine_matches_repro(compact):
    (jcas, jep, jcp), (cas, tep, tcp) = _cascades()
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 96, (8, 10)).astype(np.int32)
               for _ in range(2)]
    ours = CascadeEngine(cas, tep, tcp, compact=compact)
    theirs = JaxCascadeEngine(jcas, jep, jcp, compact=compact)
    for tokens in batches:
        a, b = ours.query(tokens), theirs.query(tokens)
        np.testing.assert_allclose(a["conf"], b["conf"], rtol=0, atol=1e-5)
        for key in ("routes", "accept", "drop", "escalate", "wan_bytes"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["pred"].shape == (8,)
    assert _metrics(ours.metrics) == _metrics(theirs.metrics)
    m = ours.metrics
    assert m.queries == 16 and m.accepted + m.dropped + m.escalated == 16


def test_cascade_submit_validates_and_later_slices_raise():
    _, (cas, tep, tcp) = _cascades()
    eng = CascadeServingEngine(cas, tep, tcp, batch_slots=2, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.arange(30), max_new_tokens=4)
    # a mesh must be a HostMesh (both legs check it); rules (repro's
    # activation hints) are accepted and dropped
    with pytest.raises(TypeError, match="HostMesh"):
        CascadeServingEngine(cas, tep, tcp, **KW, mesh=object())
    quiet = CascadeServingEngine(cas, tep, tcp, **KW, rules=object())
    assert quiet.edge_engine.mesh is None and quiet.cloud_engine.mesh is None
    # the durability protocol is ported now (tests/test_torch_crash_restart
    # .py and tests/test_torch_gateway.py hold it); the tap starts unset
    for name in ("snapshot", "restore", "note_hang",
                 "requeue_lost", "known_request_ids"):
        assert callable(getattr(eng, name)), name
    assert eng.on_tokens is None
    assert eng.known_request_ids() == set()


def test_cascade_serving_engine_routes_and_generates():
    _, (cas, tep, tcp) = _cascades()
    eng = CascadeServingEngine(cas, tep, tcp, **KW)
    ids = [eng.submit(p, max_new_tokens=3) for p in PROMPTS]
    assert eng.queue_depth() == len(PROMPTS)
    done = eng.run()
    assert set(done) == set(ids) and eng.queue_depth() == 0
    m = eng.metrics
    assert m.queries == len(PROMPTS)
    assert m.accepted + m.dropped + m.escalated == len(PROMPTS)
    assert min(m.accepted, m.dropped, m.escalated) > 0
    # token ids up + generated ids down, per escalation
    assert m.wan_bytes == sum(len(done[i].prompt) * 4 + 3 * 4 for i in ids
                              if done[i].route == "escalate")
    for r in done.values():
        assert r.route in ("accept", "escalate", "drop")
        assert r.status == "done"
        assert len(r.output) == (0 if r.route == "drop" else 3)
        assert r.latency_s >= 0.0
    snap = eng.engine_metrics()
    assert snap["queries"] == len(PROMPTS)
    assert snap["breaker"]["state"] == "closed"
    assert snap["edge"]["admissions"] == m.accepted
    assert snap["cloud"]["admissions"] == m.escalated


def test_cascade_cancel_at_the_gate_and_in_flight():
    _, (cas, tep, tcp) = _cascades()
    eng = CascadeServingEngine(cas, tep, tcp, **KW)
    ids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[:5]]
    assert eng.cancel(ids[0])                  # still awaiting the gate
    eng.step()                                 # the rest are routed
    routed = sorted(r.request_id for r in list(eng._edge_map.values())
                    + list(eng._cloud_map.values()))
    assert routed
    victim = routed[0]
    assert eng.cancel(victim) and not eng.cancel(999)
    done = eng.run()
    assert done[ids[0]].status == "cancelled"
    assert done[ids[0]].failure_reason == "cancelled: awaiting gate"
    assert done[victim].status == "cancelled"
    for i in set(ids) - {ids[0], victim}:
        assert done[i].status == "done"


def test_circuit_breaker_state_machine():
    ours = CircuitBreaker(failure_threshold=2, cooldown=2)
    theirs = JaxBreaker(failure_threshold=2, cooldown=2)

    def same():
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)

    assert ours.allow() and theirs.allow() and ours.state == "closed"
    ours.failure(), theirs.failure()
    assert ours.state == "closed"               # one failure: still closed
    ours.failure(), theirs.failure()
    assert ours.state == "open" and ours.trips == 1
    same()
    assert not ours.allow() and not theirs.allow()   # cooldown tick 1
    assert ours.allow() and theirs.allow()          # tick 2: the probe
    assert ours.state == "half_open"
    ours.failure(), theirs.failure()                # probe failed: re-open
    assert ours.state == "open" and ours.trips == 2
    same()
    assert not ours.allow() and not theirs.allow()
    assert ours.allow() and theirs.allow() and ours.state == "half_open"
    ours.success(), theirs.success()                # probe succeeded
    assert ours.state == "closed" and ours.consecutive_failures == 0
    ours.failure(), theirs.failure()
    ours.success(), theirs.success()                # success resets
    ours.failure(), theirs.failure()
    assert ours.state == "closed"
    same()


def test_cascade_breaker_reroutes_edge_to_cloud():
    """Edge outage mid-cascade: consecutive gate failures trip the breaker
    open, requests fail over to the cloud engine (route "failover"), and a
    successful half-open probe closes the breaker once the outage ends.
    Failover streams equal a direct cloud run token for token."""
    _, (cas, tep, tcp) = _cascades()
    plan = FaultPlan(seed=0, edge=[0, 1, 2])      # outage spans 3 attempts
    eng = CascadeServingEngine(cas, tep, tcp, batch_slots=2, max_seq_len=32,
                               fault_plan=plan, breaker_failure_threshold=2,
                               breaker_cooldown=2)
    ids = [eng.submit(p, max_new_tokens=3, deadline_s=30.0)
           for p in PROMPTS[:8]]
    done = eng.run()
    m = eng.metrics
    assert m.edge_failures >= 2 and plan.fired("edge") == 3
    assert m.rerouted >= 1
    assert eng.breaker.trips >= 1
    assert eng.breaker.state == "closed"     # the probe closed it
    routes = [done[rid].route for rid in ids]
    assert "failover" in routes
    assert set(routes) & {"accept", "escalate", "drop"}   # edge recovered
    for rid in ids:
        r = done[rid]
        assert r.status == "done"
        assert len(r.output) == (0 if r.route == "drop" else 3)
    ref = ServingEngine(cas.cloud, tcp, batch_slots=2, max_seq_len=32,
                        seed=1)
    for rid in ids:
        if done[rid].route != "failover":
            continue
        rr = ref.submit(done[rid].prompt, 3)
        np.testing.assert_array_equal(ref.run()[rr].output, done[rid].output)
    snap = eng.engine_metrics()
    assert snap["breaker"]["trips"] == eng.breaker.trips
    assert snap["rerouted"] == m.rerouted
    assert snap["degradation_s"] >= 0.0


def test_fault_plan_copy_fires_on_repros_schedule():
    specs = dict(edge=[0, 3], step={"prob": 0.3, "max_fires": 4},
                 swap_in=0.5)
    ours, theirs = FaultPlan(seed=5, **specs), JaxFaultPlan(seed=5, **specs)
    for seam in ("edge", "step", "swap_in", "cancel") * 6:
        assert ours.fire(seam) == theirs.fire(seam)
    assert ours.log == theirs.log and ours.fired() == theirs.fired()
    items = list(range(10))
    assert [ours.pick("cancel", items) for _ in range(8)] == \
        [theirs.pick("cancel", items) for _ in range(8)]
    with pytest.raises(FaultError, match="edge"):
        FaultPlan(edge=[0]).check("edge", "gate")
