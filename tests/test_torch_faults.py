"""Chaos recovery in the port (``ServingEngine(fault_plan=...)``) on the CPU.

It mirrors ``tests/test_faults.py``'s engine tests: with a seeded
``FaultPlan`` tripping the engine's seams (poisoned decode dispatches,
failed K/V swaps, transient pool exhaustion, chaos cancellation), every
request that survives finishes token for token as in the fault-free run,
the paged allocator's invariants hold after every step, the drain leaves
no block behind, and the retry budget quarantines instead of livelocking.

Across packages, on weights bridged from ``repro``'s ``LM.init``: one plan
and one greedy trace through ``repro``'s engine and the port's fire the
same seams the same number of times, give every request the same retries
and terminal status, and give greedy streams that agree under
``tests/test_torch_engine.py``'s margin rule (they part only where
``repro``'s top-2 logit margin is within 1e-4).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.monitoring import MonitoringService  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import FaultPlan, ServingEngine  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = dict(name="tiny", family="dense", source="t", num_layers=2,
              d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
              vocab_size=64, param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _tiny():
    """``tests/test_faults.py``'s tiny model in the port, its own seed."""
    lm = LM(tcfg.ModelConfig(**FIELDS, stages=tcfg.dense_stages(2)),
            device="cpu")
    return lm, lm.init(0)


@functools.lru_cache(maxsize=None)
def _bridged():
    """(repro LM, params, port LM, bridged params)."""
    jlm = JaxLM(ModelConfig(**FIELDS, stages=dense_stages(2)), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tc = tcfg.ModelConfig(**FIELDS, stages=tcfg.dense_stages(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _mixed_trace(n=6, seed=1, budgets=(3, 12)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 60, size=int(rng.integers(3, 12))),
             int(rng.integers(*budgets))) for _ in range(n)]


# the chaos sweep's engine configurations (``tests/test_faults.py``'s)
CONFIGS = {
    "ring_recompute": dict(cache_backend="ring"),
    "paged_swap": dict(cache_backend="paged", block_size=8,
                       num_pool_blocks=28),
    "paged_recompute": dict(cache_backend="paged", block_size=8,
                            num_pool_blocks=28, preempt_mode="recompute"),
    "paged_multistep": dict(cache_backend="paged", block_size=8,
                            num_pool_blocks=28, max_decode_steps=4),
    "paged_chunked": dict(cache_backend="paged", block_size=8,
                          num_pool_blocks=28, chunk_tokens=8),
}
BASE = dict(batch_slots=3, max_seq_len=64, min_bucket=4)


def _serve(model, *, fault_plan=None, trace=None, temperature=0.7,
           max_steps=2000, engine=ServingEngine, **kw):
    """Run a trace to completion, checking the allocator after every step
    and bounding the step count (the no-livelock guard)."""
    lm, params = model
    eng = engine(lm, params, fault_plan=fault_plan, **BASE, **kw)
    for prompt, budget in (trace or _mixed_trace()):
        eng.submit(prompt, budget, temperature=temperature)
    steps = 0
    while eng.pending:
        eng.step()
        steps += 1
        assert steps <= max_steps, "engine livelocked under chaos"
        if hasattr(eng.backend, "assert_invariants"):
            eng.backend.assert_invariants()
    done = eng._done.copy()
    eng._done.clear()
    return eng, done


def _assert_drained_clean(eng):
    assert sorted(eng._free) == list(range(eng.batch_slots))
    be = eng.backend
    if hasattr(be, "_gap_total"):
        be.assert_invariants()
        assert be._gap_total == 0 and be._ref == {}


def _assert_survivors_exact(done, baseline):
    survivors = {rid: r for rid, r in done.items() if r.status == "done"}
    assert survivors, "chaos killed every request"
    for rid, r in survivors.items():
        np.testing.assert_array_equal(r.output, baseline[rid].output)
    return survivors


def test_step_fault_rolls_back_and_stays_exact():
    """A poisoned decode dispatch rolls every decoding slot back to a host
    checkpoint and requeues it; survivors finish as in the fault-free run,
    with no block leaked."""
    _, base = _serve(_tiny(), **CONFIGS["paged_swap"])
    plan = FaultPlan(seed=3, step=[2, 5, 9])
    eng, done = _serve(_tiny(), fault_plan=plan, max_retries=5,
                       **CONFIGS["paged_swap"])
    assert plan.fired("step") == 3
    assert eng.fault_recoveries == 3 and eng.retries_total > 0
    assert all(r.status == "done" for r in done.values())
    _assert_survivors_exact(done, base)
    _assert_drained_clean(eng)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chaos_schedule_survivors_exact(name):
    """The mixed schedule (step and scan faults, swap_out and swap_in
    faults, transient pool exhaustion) on every configuration: survivors
    exact, invariants after every step, a clean drain."""
    kw = CONFIGS[name]
    trace = _mixed_trace(8, seed=2)
    _, base = _serve(_tiny(), trace=trace, **kw)
    plan = FaultPlan(seed=11,
                     step={"prob": 0.15, "max_fires": 4},
                     scan={"prob": 0.3, "max_fires": 2},
                     swap_out={"prob": 0.4, "max_fires": 2},
                     swap_in={"prob": 0.4, "max_fires": 2},
                     pool={"prob": 0.1, "max_fires": 3})
    eng, done = _serve(_tiny(), fault_plan=plan, trace=trace, max_retries=6,
                       **kw)
    assert plan.total_fired() > 0
    assert len(done) == 8                    # nobody wedged or lost
    _assert_survivors_exact(done, base)
    _assert_drained_clean(eng)


def _preempted_once(plan):
    """One sampled request on a two-slot paged engine, preempted after two
    steps; returns (engine, request id, the queued request)."""
    lm, params = _tiny()
    eng = ServingEngine(lm, params, fault_plan=plan, batch_slots=2,
                        max_seq_len=64, min_bucket=4, cache_backend="paged",
                        block_size=8, num_pool_blocks=24)
    rid = eng.submit(np.arange(6), 10, temperature=0.5)
    eng.step()
    eng.step()
    eng.preempt(next(iter(eng._slots)))
    return eng, rid, eng._queue[0]


def _expected():
    lm, params = _tiny()
    base = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                         min_bucket=4, cache_backend="paged", block_size=8,
                         num_pool_blocks=24)
    rid = base.submit(np.arange(6), 10, temperature=0.5)
    return base.run()[rid].output


def test_swap_in_fault_falls_back_to_recompute():
    """A failed swap-in drops the K/V checkpoint and resumes by recompute:
    the same tokens, one retry recorded."""
    plan = FaultPlan(seed=0, swap_in=[0])    # the first swap-in fails
    eng, rid, r = _preempted_once(plan)
    assert r.resume is not None and r.resume.kv is not None
    done = eng.run()
    assert plan.fired("swap_in") == 1
    assert done[rid].status == "done"
    assert done[rid].retries == 1 and done[rid].last_fault == "swap_in"
    np.testing.assert_array_equal(done[rid].output, _expected())
    _assert_drained_clean(eng)


def test_swap_out_fault_degrades_to_recompute():
    """A failed swap-out keeps the host checkpoint and frees the blocks:
    the resume recomputes, the output is unchanged."""
    plan = FaultPlan(seed=0, swap_out=[0])
    eng, rid, r = _preempted_once(plan)
    assert r.resume is not None and r.resume.kv is None   # degraded path
    assert r.last_fault == "swap_out"
    done = eng.run()
    assert done[rid].status == "done"
    np.testing.assert_array_equal(done[rid].output, _expected())
    _assert_drained_clean(eng)


def test_transient_pool_exhaustion_only_delays():
    _, base = _serve(_tiny(), **CONFIGS["paged_swap"])
    plan = FaultPlan(seed=0, pool=[0, 1, 2, 3])
    eng, done = _serve(_tiny(), fault_plan=plan, **CONFIGS["paged_swap"])
    assert plan.fired("pool") == 4
    assert all(r.status == "done" for r in done.values())
    _assert_survivors_exact(done, base)
    _assert_drained_clean(eng)


def test_retry_budget_quarantines_instead_of_wedging():
    """Every decode round poisoned: each request exhausts its retry budget
    and ends "failed" with a machine-readable reason; the drain ends and
    the pool comes back whole."""
    plan = FaultPlan(seed=0, step=1.0)
    eng, done = _serve(_tiny(), fault_plan=plan, max_retries=2,
                       **CONFIGS["paged_swap"])
    assert done and all(r.status == "failed" for r in done.values())
    for r in done.values():
        assert r.failure_reason.startswith("retry_budget_exhausted")
        assert r.retries == 3 and r.last_fault == "step"
    assert eng.metrics()["quarantined"] == len(done)
    _assert_drained_clean(eng)


def test_cancellation_mid_prefill_and_mid_decode():
    """cancel() frees the victim's slot and blocks wherever it is; everyone
    else finishes as in the undisturbed run."""
    lm, params = _tiny()
    kw = dict(batch_slots=3, max_seq_len=64, min_bucket=4,
              cache_backend="paged", block_size=8, num_pool_blocks=28,
              chunk_tokens=4, token_budget=7)
    trace = _mixed_trace(5, seed=4, budgets=(6, 12))
    base = ServingEngine(lm, params, **kw)
    for p, b in trace:
        base.submit(p, b, temperature=0.3)
    base_done = base.run()
    eng = ServingEngine(lm, params, **kw)
    ids = [eng.submit(p, b, temperature=0.3) for p, b in trace]
    eng.step()
    pf = list(eng._prefilling.values())
    mid_prefill = pf[0].request.request_id if pf else None
    if mid_prefill is not None:
        assert eng.cancel(mid_prefill)
    for _ in range(3):
        eng.step()
    mid_decode = next((r.request_id for r in eng._slots.values()), None)
    if mid_decode is not None:
        assert eng.cancel(mid_decode)
    done = eng.run()
    assert not eng.cancel(12345)
    cancelled = {rid for rid, r in done.items() if r.status == "cancelled"}
    assert cancelled == {x for x in (mid_prefill, mid_decode)
                         if x is not None}
    assert mid_decode is not None
    for rid in ids:
        if rid not in cancelled:
            assert done[rid].status == "done"
            np.testing.assert_array_equal(done[rid].output,
                                          base_done[rid].output)
    _assert_drained_clean(eng)


def test_injected_cancellation_is_deterministic():
    """The cancel seam picks the same victims for the same seed."""
    def victims(seed):
        plan = FaultPlan(seed=seed, cancel=[1, 3])
        _, done = _serve(_tiny(), fault_plan=plan, **CONFIGS["paged_swap"])
        return sorted(rid for rid, r in done.items()
                      if r.status == "cancelled")

    v = victims(9)
    assert v == victims(9) and len(v) == 2


def test_oversized_request_is_rejected_not_fatal():
    lm, params = _tiny()
    eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=64,
                        min_bucket=4, cache_backend="paged", block_size=8,
                        num_pool_blocks=6)           # 5 usable
    ok1 = eng.submit(np.arange(5), 5)
    big = eng.submit(np.arange(30), 20, priority=9)  # 7 blocks > 5: never
    ok2 = eng.submit(np.arange(4), 4)
    done = eng.run()
    assert done[big].status == "rejected"
    assert done[big].failure_reason.startswith("exceeds_pool_capacity")
    assert len(done[big].output) == 0
    assert done[ok1].status == "done" and done[ok2].status == "done"
    _assert_drained_clean(eng)


def test_metrics_snapshot_and_monitoring_wiring():
    """metrics() sums up dispositions and faults; the port's
    MonitoringService ingests it and returns the latest per component."""
    plan = FaultPlan(seed=3, step=[1])
    eng, done = _serve(_tiny(), fault_plan=plan, **CONFIGS["paged_swap"])
    snap = eng.metrics()
    assert snap["terminal"]["done"] == len(done)
    assert snap["faults_injected"] == {"step": 1}
    assert snap["fault_recoveries"] == 1
    assert snap["recovery"]["count"] >= 1
    assert snap["recovery"]["p99_s"] >= snap["recovery"]["p50_s"] >= 0.0
    assert snap["live"] == {"queued": 0, "prefilling": 0, "decoding": 0}
    mon = MonitoringService()
    mon.record_serving("edge-engine", snap)
    assert mon.serving_snapshot("edge-engine") == snap
    assert mon.serving_snapshot("nope") is None
    assert mon.deadline_hit_rates("edge-engine") == snap["deadline_hits"]


def test_mid_prefill_cancel_keeps_a_resumed_requests_tokens():
    """A request preempted mid-decode (recompute) and cancelled while its
    prompt + tokens prefill again: the port keeps the tokens it generated
    before the preemption, as for a cancel while queued or mid-decode;
    ``repro``'s ``cancel`` drops them on this one path (ROADMAP Queue 3)."""
    jlm, jp, lm, tp = _bridged()
    kw = dict(batch_slots=2, max_seq_len=64, min_bucket=4,
              cache_backend="paged", block_size=8, chunk_tokens=4,
              preempt_mode="recompute")
    outs = {}
    for pkg, (m, p), engine in (("repro", (jlm, jp), JaxEngine),
                                ("port", (lm, tp), ServingEngine)):
        eng = engine(m, p, **kw)
        rid = eng.submit(np.arange(1, 11), 8)
        while not eng._slots or eng.metrics()["live"]["decoding"] == 0 \
                or int(np.asarray(eng._state["steps"])[
                    next(iter(eng._slots))]) < 3:
            eng.step()
        eng.preempt(next(iter(eng._slots)))
        before = eng._queue[0].resume.tokens.copy()
        eng.step()
        assert eng.metrics()["live"]["prefilling"] == 1
        assert eng.cancel(rid)
        r = eng.run()[rid]
        assert r.status == "cancelled"
        assert r.failure_reason == "cancelled: mid-prefill"
        outs[pkg] = (before, r.output)
    before, out = outs["port"]
    assert len(before) >= 3
    np.testing.assert_array_equal(out, before)
    assert outs["repro"][1].size == 0


def _storage(eng):
    """data_ptr of every tensor a program touches (state, cache leaves,
    tables)."""
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


@pytest.mark.parametrize("name", ["ring_recompute", "paged_swap"])
def test_storage_is_stable_across_rollback_and_restore(name):
    """A warmed engine keeps the storage of its state, caches and tables
    through fault rollbacks (swap-out, recompute) and through a restore and
    the resumes after it: what a captured CUDA graph needs."""
    kw = dict(CONFIGS[name], max_decode_steps=4)
    trace = _mixed_trace(6, seed=3)
    _, base = _serve(_tiny(), trace=trace, **kw)
    plan = FaultPlan(seed=5, step=[1], scan=[2], swap_out=[0])
    lm, params = _tiny()
    eng = ServingEngine(lm, params, fault_plan=plan, max_retries=6, **BASE,
                        **kw)
    eng.warm_compile()
    ptrs = _storage(eng)
    for prompt, budget in trace:
        eng.submit(prompt, budget, temperature=0.7)
    for _ in range(6):
        eng.step()
    assert eng.fault_recoveries >= 1 and _storage(eng) == ptrs
    fresh = ServingEngine(lm, params, **BASE, **kw)
    fresh.warm_compile()
    fresh_ptrs = _storage(fresh)
    fresh.restore(eng.snapshot())
    done = fresh.run()
    assert _storage(fresh) == fresh_ptrs
    assert len(done) == len(trace)
    _assert_survivors_exact(done, base)
    _assert_drained_clean(fresh)


def _margin_rule(jlm, jp, prompts, ours, theirs):
    """Greedy streams agree up to their first difference, which must sit
    on a near-tie (top-2 margin <= TOL) of ``repro``'s logits. Returns the
    tokens compared."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for prompt, a, b in zip(prompts, ours, theirs):
        n = min(len(a), len(b))
        diff = np.flatnonzero(a[:n] != b[:n])
        upto = diff[0] if len(diff) else n
        compared += upto
        if len(diff):
            ctx = np.concatenate([prompt, b[:upto]])[None]
            logits = np.sort(np.asarray(fwd(jp, ctx))[0, -1])
            assert logits[-1] - logits[-2] <= TOL, (upto, a, b)
    return compared


@pytest.mark.parametrize("name", ["paged_multistep", "ring_recompute"])
def test_fault_plan_fires_alike_in_both_packages(name):
    """One plan, one greedy trace, through ``repro``'s engine and the
    port's on bridged weights: the same seams fire the same number of
    times, every request ends with the same retries, last fault and
    status, and the streams agree under the margin rule."""
    jlm, jp, lm, tp = _bridged()
    kw = CONFIGS[name]
    trace = _mixed_trace(8, seed=2)
    seams = dict(seed=11, step={"prob": 0.2, "max_fires": 3},
                 scan={"prob": 0.4, "max_fires": 2},
                 swap_out={"prob": 0.5, "max_fires": 2},
                 swap_in={"prob": 0.5, "max_fires": 2},
                 pool={"prob": 0.1, "max_fires": 3}, cancel=[4])
    runs = {}
    for pkg, model, engine, plan_cls in (
            ("repro", (jlm, jp), JaxEngine, JaxFaultPlan),
            ("port", (lm, tp), ServingEngine, FaultPlan)):
        plan = plan_cls(**seams)
        eng, done = _serve(model, fault_plan=plan, trace=trace,
                           temperature=0.0, max_retries=6, engine=engine,
                           **kw)
        runs[pkg] = (plan, eng, done)
    (jplan, jeng, jdone), (plan, eng, done) = runs["repro"], runs["port"]
    assert plan.fired() == jplan.fired() and plan.total_fired() >= 3
    assert plan.log == jplan.log
    assert eng.retries_total == jeng.retries_total
    assert eng.fault_recoveries == jeng.fault_recoveries
    assert sorted(done) == sorted(jdone) == list(range(len(trace)))
    for rid in done:
        a, b = done[rid], jdone[rid]
        assert (a.status, a.retries, a.last_fault, a.failure_reason) == \
            (b.status, b.retries, b.last_fault, b.failure_reason), rid
        assert len(a.output) == len(b.output)
    compared = _margin_rule(jlm, jp, [p for p, _ in trace],
                            [done[i].output for i in sorted(done)],
                            [jdone[i].output for i in sorted(done)])
    assert compared >= 20
    _assert_drained_clean(eng)
