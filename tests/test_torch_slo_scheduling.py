"""SLO-aware scheduling with preemption in the port:
``tests/test_slo_scheduling.py`` test for test against the port's
``Scheduler`` and ``ServingEngine`` on the CPU, asserting what each of
those asserts.

Policy unit tests (rank arithmetic, the chunk budget by class, the preempt
seam), the engine's policy (admission by class then deadline, no
preemption within a class, sticky timing, prefill-only peaks, coalesced
look-ahead, no eviction storm, no vain eviction) and the acceptance
contract: preemption is output-exact. Random preempt/resume schedules give
token for token the streams of an uncontended engine, greedy and keyed
sampling, on the ring (recompute), paged (swap and recompute) and windowed
paged backends, with the allocator's invariants after every step.

Three tests also run ``repro``'s engine on the same trace and bridged
weights (admission order, no preemption within a class, and a random
preemption schedule): the same request order and preemption counts, and
greedy streams equal wherever ``repro``'s top-2 logit margin exceeds 1e-4
(``tests/test_torch_engine.py``'s rule).
"""
import collections
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
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import (PrefillProgress,  # noqa: E402
                                           Scheduler, request_rank)

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


def _fields():
    return dict(name="tiny", family="dense", source="t", num_layers=2,
                d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                d_ff=64, vocab_size=64, param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _models(window=None):
    """(repro LM, params, port LM, bridged params) of the tiny config of
    ``tests/test_slo_scheduling.py``."""
    jlm = JaxLM(ModelConfig(**_fields(),
                            stages=dense_stages(2, window=window)),
                kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tc = tcfg.ModelConfig(**_fields(),
                          stages=tcfg.dense_stages(2, window=window))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _tiny():
    return _models()[2:]


def _mixed_trace(n=6, seed=1, budgets=(3, 12)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 60, size=int(rng.integers(3, 12))),
             int(rng.integers(*budgets))) for _ in range(n)]


def _assert_same(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


def _margin_rule(jlm, jp, prompts, ours, theirs):
    """Greedy streams by request id agree up to their first difference,
    which must sit on a near-tie of ``repro``'s logits. Returns the number
    of tokens compared."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for rid, prompt in prompts.items():
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b)
        diff = np.flatnonzero(a != b)
        upto = diff[0] if len(diff) else len(a)
        compared += upto
        if len(diff):
            ctx = np.concatenate([prompt, b[:upto]])[None].astype(np.int32)
            logits = np.sort(np.asarray(fwd(jp, ctx))[0, -1])
            assert logits[-1] - logits[-2] <= TOL, (rid, upto, a, b)
    return compared


# -- rank arithmetic (no engine) -----------------------------------------------

def _req(rid, *, priority=0, deadline_s=None, submit_s=0.0):
    r = Request(rid, np.arange(4), 4, priority=priority,
                deadline_s=deadline_s)
    r.submit_s = submit_s
    return r


def test_request_rank_class_then_deadline_then_fifo():
    lo = _req(0, priority=0, submit_s=1.0)
    hi = _req(1, priority=2, submit_s=5.0)
    assert request_rank(hi) < request_rank(lo)         # class beats arrival
    slack = _req(2, priority=1, deadline_s=9.0, submit_s=1.0)   # abs 10
    tight = _req(3, priority=1, deadline_s=2.0, submit_s=3.0)   # abs 5
    assert request_rank(tight) < request_rank(slack)   # EDF within a class
    none = _req(4, priority=1, submit_s=0.0)
    assert request_rank(slack) < request_rank(none)    # deadline first
    a, b = _req(5, submit_s=1.0), _req(6, submit_s=2.0)
    assert request_rank(a) < request_rank(b)           # untagged: FIFO
    assert request_rank(None) == request_rank(None)


def test_chunk_budget_ordered_by_class():
    """A higher-class in-flight prefill takes the step's chunk budget
    ahead of an earlier-admitted bulk prefill."""
    s = Scheduler(batch_slots=2, chunk_tokens=8, token_budget=10)
    bulk = PrefillProgress(request=_req(0, priority=0), slot=0, next=0,
                           total=20)
    crit = PrefillProgress(request=_req(1, priority=3), slot=1, next=0,
                           total=6)
    prefilling = collections.OrderedDict([(0, bulk), (1, crit)])
    plan = s.plan_step(n_active=2, prefilling=prefilling,
                       try_admit=lambda: None)
    assert [(c.slot, c.length, c.final) for c in plan.chunks] == \
        [(1, 6, True)]


def test_plan_retries_admission_after_preempt():
    s = Scheduler(batch_slots=2, chunk_tokens=8)
    granted = []
    state = {"preempted": False}

    def try_admit():
        if not state["preempted"] or granted:
            return None
        pp = PrefillProgress(request=_req(9, priority=5), slot=0, next=0,
                             total=4)
        granted.append(pp)
        return pp

    def try_preempt():
        if state["preempted"]:
            return False
        state["preempted"] = True
        return True

    plan = s.plan_step(n_active=1, prefilling=collections.OrderedDict(),
                       try_admit=try_admit, try_preempt=try_preempt)
    assert state["preempted"] and plan.admitted == 1
    assert [c.slot for c in plan.chunks] == [0]


def test_plan_stops_when_preempt_refuses():
    s = Scheduler(batch_slots=2, chunk_tokens=8)
    calls = {"preempt": 0}

    def try_preempt():
        calls["preempt"] += 1
        return False

    plan = s.plan_step(n_active=1, prefilling=collections.OrderedDict(),
                       try_admit=lambda: None, try_preempt=try_preempt)
    assert plan.admitted == 0 and calls["preempt"] == 1


# -- the engine's policy -------------------------------------------------------

def _admission_order(eng):
    eng.submit(np.arange(4), max_new_tokens=2)                 # rid 0, FIFO
    eng.submit(np.arange(5), max_new_tokens=2, priority=1,
               deadline_s=60.0)                                # rid 1
    eng.submit(np.arange(6), max_new_tokens=2, priority=1,
               deadline_s=1.0)                                 # rid 2, EDF
    eng.submit(np.arange(7), max_new_tokens=2, priority=2)     # rid 3
    done = eng.run()
    return sorted(done, key=lambda rid: done[rid].finish_s), done


def test_admission_order_is_class_then_deadline():
    """A 1-slot engine serialises service, so completion order is admission
    order: classes first, EDF within a class. ``repro``'s engine on the
    same trace and weights finishes in the same order with the same
    streams."""
    jlm, jp, lm, tp = _models()
    kw = dict(batch_slots=1, max_seq_len=32, min_bucket=4)
    eng = ServingEngine(lm, tp, **kw)
    order, done = _admission_order(eng)
    assert order == [3, 2, 1, 0]
    assert eng.preemptions == 0
    ref = JaxEngine(jlm, jp, **kw)
    ref_order, ref_done = _admission_order(ref)
    assert ref_order == order and ref.preemptions == eng.preemptions
    prompts = {rid: np.arange(4 + rid) for rid in done}
    assert _margin_rule(jlm, jp, prompts,
                        {r: d.output for r, d in done.items()},
                        {r: d.output for r, d in ref_done.items()}) >= 6


def _same_class(eng):
    eng.submit(np.arange(4), max_new_tokens=8)
    eng.step()                                   # rid 0 holds the slot
    eng.submit(np.arange(4), max_new_tokens=2, deadline_s=0.001)
    return eng.run()


def test_no_preemption_within_a_class():
    """Equal-class pressure never preempts: deadlines order service, they
    do not justify eviction. ``repro``'s engine does the same on the same
    trace and gives the same streams."""
    jlm, jp, lm, tp = _models()
    kw = dict(batch_slots=1, max_seq_len=32, min_bucket=4,
              cache_backend="paged", block_size=8, num_pool_blocks=5)
    eng = ServingEngine(lm, tp, **kw)
    done = _same_class(eng)
    assert eng.preemptions == 0
    assert done[0].finish_s < done[1].finish_s   # FIFO preserved
    ref = JaxEngine(jlm, jp, **kw)
    ref_done = _same_class(ref)
    assert ref.preemptions == 0
    assert ref_done[0].finish_s < ref_done[1].finish_s
    assert _margin_rule(jlm, jp, {0: np.arange(4), 1: np.arange(4)},
                        {r: d.output for r, d in done.items()},
                        {r: d.output for r, d in ref_done.items()}) >= 6


def test_preemption_timing_sticky_and_counted():
    """A preempted-then-resumed request keeps its first admission stamp
    and its TTFT, and counts its preemptions."""
    lm, tp = _tiny()
    eng = ServingEngine(lm, tp, batch_slots=1, max_seq_len=32, min_bucket=4,
                        cache_backend="paged", block_size=8)
    eng.submit(np.arange(4), max_new_tokens=6)
    eng.step()                                   # admit (arming round)
    eng.step()                                   # first token exists
    r = eng._slots[0]
    admit0, ttft0 = r.admit_s, r.ttft_s
    assert admit0 > 0 and ttft0 > 0
    eng.preempt(0)
    assert r.preemptions == 1 and eng.preemptions == 1
    done = eng.run()
    assert done[0].admit_s == admit0
    assert done[0].ttft_s == ttft0
    assert done[0].preemptions == 1


def test_peak_active_slots_counts_prefill_only_steps():
    lm, tp = _tiny()
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32, min_bucket=4,
                        chunk_tokens=4, token_budget=6)
    eng.submit(np.arange(20), max_new_tokens=2)  # several chunks
    eng.step()                                   # a prefill-only step
    assert not eng._slots and eng._prefilling
    assert eng.peak_active_slots == 1
    eng.run()


def test_batched_lookahead_coalesces_dispatches():
    """Slots crossing a block boundary in the same plan share one table
    update: dispatches < per-slot top-ups."""
    lm, tp = _tiny()
    eng = ServingEngine(lm, tp, batch_slots=3, max_seq_len=32, min_bucket=4,
                        cache_backend="paged", block_size=8,
                        max_decode_steps=8)
    for _ in range(3):
        eng.submit(np.arange(6), max_new_tokens=20)
    eng.run()
    assert eng.backend.lookahead_topups > eng.lookahead_dispatches >= 1


def test_infeasible_request_never_triggers_eviction_storm():
    """A high-class request larger than the whole pool evicts nobody: it
    is rejected with a machine-readable reason and the rest completes."""
    lm, tp = _tiny()
    eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32, min_bucket=4,
                        cache_backend="paged", block_size=8,
                        num_pool_blocks=4)          # 3 usable blocks
    ok = eng.submit(np.arange(4), max_new_tokens=8)  # 2 blocks
    eng.step()
    big = eng.submit(np.arange(8), max_new_tokens=24, priority=5)  # 4 > 3
    done = eng.run()
    assert eng.preemptions == 0
    assert done[ok].status == "done" and len(done[ok].output) == 8
    assert done[big].status == "rejected"
    assert done[big].failure_reason.startswith("exceeds_pool_capacity")
    eng.assert_invariants()


def test_preempt_refused_when_recovery_cannot_cover_demand():
    """No eviction when the free list plus every lower-class slot's blocks
    cannot cover the blocked request."""
    lm, tp = _tiny()
    eng = ServingEngine(lm, tp, batch_slots=3, max_seq_len=32, min_bucket=4,
                        cache_backend="paged", block_size=8,
                        num_pool_blocks=7)          # 6 usable
    eng.submit(np.arange(4), max_new_tokens=8)               # pri 0: 2 blk
    eng.submit(np.arange(8), max_new_tokens=20, priority=2)  # pri 2: 4 blk
    eng.step()                                      # pool fully committed
    # pri 1 needs 4 blocks; recoverable = 0 free + 2 (the pri-0 slot) < 4
    eng.submit(np.arange(8), max_new_tokens=20, priority=1)
    done = eng.run()
    assert eng.preemptions == 0
    assert len(done) == 3 and all(r.output is not None
                                  for r in done.values())
    eng.assert_invariants()


def test_preempt_mode_validation():
    lm, tp = _tiny()
    with pytest.raises(ValueError, match="preempt_mode"):
        ServingEngine(lm, tp, batch_slots=1, max_seq_len=32,
                      preempt_mode="bogus")
    with pytest.raises(ValueError, match="swap"):
        ServingEngine(lm, tp, batch_slots=1, max_seq_len=32,
                      preempt_mode="swap")      # the ring has no swap


# -- preemption exactness: the acceptance contract ----------------------------

CONFIGS = {
    "ring_recompute": (None, {}),
    "paged_swap": (None, dict(cache_backend="paged", block_size=8)),
    "paged_recompute": (None, dict(cache_backend="paged", block_size=8,
                                   chunk_tokens=4, preempt_mode="recompute")),
    "windowed_paged_swap": (8, dict(cache_backend="paged", block_size=8)),
}


def _run_with_random_preemptions(cls, lm, params, trace, *, seed,
                                 temperature=0.0, **kw):
    """Drive ``step()`` and between steps preempt a random decoding slot
    with probability 0.4: a random preempt/resume schedule."""
    rng = np.random.default_rng(seed)
    eng = cls(lm, params, max_seq_len=32, min_bucket=4, batch_slots=2, **kw)
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new, temperature=temperature)
    while eng.pending:
        eng.step()
        if eng._slots and rng.random() < 0.4:
            eng.preempt(int(rng.choice(list(eng._slots))))
        eng.backend.assert_invariants()          # holds after every swap
    done = eng.run()
    return eng, {rid: r.output for rid, r in done.items()}


def _uncontended(lm, params, trace, temperature=0.0):
    eng = ServingEngine(lm, params, max_seq_len=32, min_bucket=4,
                        batch_slots=len(trace))
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new, temperature=temperature)
    return {rid: r.output for rid, r in eng.run().items()}


def _assert_drained(be):
    be.assert_invariants()
    assert sorted(be._free) == list(range(1, be.num_blocks))
    assert be._gap_total == 0 and be._ref == {}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("temperature", (0.0, 0.8))
def test_random_preemption_schedules_are_exact(name, temperature):
    """Token for token against the uncontended engine under random forced
    preempt/resume schedules, greedy and keyed sampling, every backend."""
    window, kw = CONFIGS[name]
    _, _, lm, tp = _models(window)
    trace = _mixed_trace(n=6, seed=2)
    base = _uncontended(lm, tp, trace, temperature)
    for seed in (0, 1):
        eng, out = _run_with_random_preemptions(
            ServingEngine, lm, tp, trace, seed=seed, temperature=temperature,
            **kw)
        _assert_same(base, out)
        assert eng.preemptions > 0, "schedule never preempted"
        if kw:
            _assert_drained(eng.backend)


def test_random_preemption_schedule_matches_repro():
    """One random schedule (paged, swap) through ``repro``'s engine and the
    port's: the same preemptions and swaps, and greedy streams equal under
    the margin rule."""
    jlm, jp, lm, tp = _models()
    trace = _mixed_trace(n=6, seed=2)
    kw = CONFIGS["paged_swap"][1]
    eng, ours = _run_with_random_preemptions(ServingEngine, lm, tp, trace,
                                             seed=0, **kw)
    ref, theirs = _run_with_random_preemptions(JaxEngine, jlm, jp, trace,
                                               seed=0, **kw)
    assert eng.preemptions == ref.preemptions > 0
    assert eng.backend.swap_outs == ref.backend.swap_outs
    assert eng.backend.swap_ins == ref.backend.swap_ins
    prompts = {rid: np.asarray(p) for rid, (p, _) in enumerate(trace)}
    assert _margin_rule(jlm, jp, prompts, ours, theirs) >= 30


def test_random_preemption_with_multi_step_decode():
    """Preemption composes with K-step rounds: checkpoints are taken at
    host syncs, where the host's step mirror is exact."""
    lm, tp = _tiny()
    trace = _mixed_trace(n=6, seed=3)
    base = _uncontended(lm, tp, trace)
    for kw in (dict(cache_backend="paged", block_size=8, max_decode_steps=8),
               dict(max_decode_steps=4, chunk_tokens=8)):
        eng, out = _run_with_random_preemptions(ServingEngine, lm, tp, trace,
                                                seed=4, **kw)
        _assert_same(base, out)
        assert eng.preemptions > 0


def test_blocked_high_priority_preempts_and_wins():
    """A high-class arrival on a starved pool evicts a bulk request's
    blocks, is served at once, and the bulk request resumes exactly."""
    lm, tp = _tiny()
    low = [(np.arange(6), 20), (np.arange(8), 20)]
    hi = (np.arange(4), 4)
    base = _uncontended(lm, tp, low + [hi])
    eng = ServingEngine(lm, tp, max_seq_len=32, min_bucket=4, batch_slots=3,
                        cache_backend="paged", block_size=8,
                        num_pool_blocks=9, max_decode_steps=4)
    for p, mn in low:
        eng.submit(p, max_new_tokens=mn)
    for _ in range(3):
        eng.step()                            # bulk fills the pool
    eng.submit(hi[0], max_new_tokens=hi[1], priority=5)
    while eng.pending:
        eng.step()
        eng.assert_invariants()
    done = eng._done
    _assert_same(base, {rid: r.output for rid, r in done.items()})
    assert eng.preemptions >= 1
    assert eng.backend.swap_outs >= 1 and eng.backend.swap_ins >= 1
    assert done[2].finish_s < min(done[0].finish_s, done[1].finish_s)
    assert done[2].preemptions == 0
    assert max(done[0].preemptions, done[1].preemptions) >= 1
    _assert_drained(eng.backend)
