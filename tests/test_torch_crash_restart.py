"""Durable serving in the port: snapshot/restore, the journal, the watchdog.

It mirrors ``tests/test_crash_restart.py`` on the CPU: a serving process may
die at any step, or hang mid-dispatch, and the recovered incarnation
finishes every acknowledged request, survivors token for token as in the
crash-free run. ``ServingEngine.snapshot``/``restore`` resume live requests
in a cold engine of the same seed, the ``RequestJournal`` replays
acknowledged submissions the snapshot missed, and the gateway's watchdog
rolls a late step back in process (``note_hang``) or declares a stuck one
wedged (``EngineWedgedError``) for a restart from snapshot + journal.

The watchdog tests are not load-sensitive: torch on the CPU compiles
nothing, the gateway warms the engine before the watchdog arms, the step
deadline (2 s) is far above a warmed tiny step's time, and the stall alone
(``hang_s``) decides hang against wedge. A wedge test lasts its ``hang_s``
(``asyncio.run`` joins the sleeping step's thread).

Across packages, on weights bridged from ``repro``'s ``LM.init``: a
snapshot that ``repro`` saved (ring, and paged with its K/V) restores into
the port, and a port snapshot restores into ``repro``'s engine on the
recompute path; both finish equal to ``repro``'s uninterrupted greedy
streams under ``tests/test_torch_engine.py``'s margin rule (they part only
at a top-2 logit margin within 1e-4). ``flat_paths`` and
``save_checkpoint`` give ``repro``'s keys, order, dtypes and bytes.
"""
import asyncio
import functools
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import save_checkpoint as jax_save  # noqa: E402
from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import load_snapshot as jax_load_snapshot  # noqa: E402
from repro.serving import save_snapshot as jax_save_snapshot  # noqa: E402
from repro.utils.tree import flat_paths as jax_flat_paths  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cascade import CascadeLM, edge_variant  # noqa: E402
from repro_torch.cascade.gate import make_thresholds  # noqa: E402
from repro_torch.checkpoint.io import save_checkpoint  # noqa: E402
from repro_torch.core.monitoring import MonitoringService  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (CascadeServingEngine,  # noqa: E402
                                 EngineWedgedError, FaultPlan,
                                 RequestJournal, ServingEngine,
                                 ServingGateway, load_snapshot,
                                 recover_engine, save_snapshot)
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.utils.tree import flat_paths  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(layers=2, name="tiny"):
    return dict(name=name, family="dense", source="t", num_layers=layers,
                d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                d_ff=64, vocab_size=64, param_dtype="float32")


def _tcfg(layers=2, name="tiny"):
    return tcfg.ModelConfig(**_fields(layers, name),
                            stages=tcfg.dense_stages(layers))


@functools.lru_cache(maxsize=None)
def _tiny():
    lm = LM(_tcfg(), device="cpu")
    return lm, lm.init(0)


@functools.lru_cache(maxsize=None)
def _draft():
    lm = LM(_tcfg(1, "drf"), device="cpu")
    return lm, lm.init(7)


@functools.lru_cache(maxsize=None)
def _bridged():
    """(repro LM, params, port LM, bridged params)."""
    jlm = JaxLM(ModelConfig(**_fields(), stages=dense_stages(2)), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(), "cpu")
    return jlm, jp, LM(_tcfg(), device="cpu"), tp


def _trace(n=6, seed=1, budgets=(3, 12)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 60, size=int(rng.integers(3, 12))),
             int(rng.integers(*budgets))) for _ in range(n)]


# ``tests/test_crash_restart.py``'s matrix: recompute resume on the ring,
# swap resume on the paged pool, the K-step round and chunked prefill
CONFIGS = {
    "ring": dict(cache_backend="ring"),
    "paged": dict(cache_backend="paged", block_size=8, num_pool_blocks=28),
    "paged_multistep": dict(cache_backend="paged", block_size=8,
                            num_pool_blocks=28, max_decode_steps=4),
    "paged_chunked": dict(cache_backend="paged", block_size=8,
                          num_pool_blocks=28, chunk_tokens=8),
}
BASE_KW = dict(batch_slots=3, max_seq_len=64, min_bucket=4)


def _engine(model=None, engine=ServingEngine, **kw):
    lm, params = model or _tiny()
    return engine(lm, params, **dict(BASE_KW, **kw))


def _baseline(trace, temperature, model=None, engine=ServingEngine, **kw):
    eng = _engine(model, engine, **kw)
    for prompt, budget in trace:
        eng.submit(prompt, budget, temperature=temperature)
    return eng.run()


def _drain(eng, max_steps=2000):
    steps = 0
    while eng.pending:
        eng.step()
        steps += 1
        assert steps <= max_steps, "engine livelocked after restore"
        if hasattr(eng.backend, "_gap_total"):
            eng.backend.assert_invariants()
    return eng._done


def _assert_drained_clean(eng):
    assert sorted(eng._free) == list(range(eng.batch_slots))
    be = eng.backend
    if hasattr(be, "_gap_total"):
        be.assert_invariants()
        assert be._gap_total == 0 and be._ref == {}


def _crash_then_restore(trace, crash_step, temperature, fault_plan=None,
                        snapshot_dir=None, **kw):
    """Step engine 1 to ``crash_step``, snapshot, abandon it, restore into
    a cold engine 2 of the same construction and drain."""
    eng1 = _engine(fault_plan=fault_plan, **kw)
    for prompt, budget in trace:
        eng1.submit(prompt, budget, temperature=temperature)
    for _ in range(crash_step):
        if not eng1.pending:
            break
        eng1.step()
    snap = eng1.snapshot()
    if snapshot_dir is not None:             # through the .npz envelope
        save_snapshot(snapshot_dir, snap, step=crash_step)
        snap, _ = load_snapshot(snapshot_dir)
    kw.pop("max_retries", None)
    eng2 = _engine(**kw)
    info = eng2.restore(snap)
    assert info["live"] + info["terminal"] == len(trace)
    return eng2, _drain(eng2)


def test_restore_mid_flight_is_token_exact(tmp_path):
    """Crash at a random step, restore through the on-disk envelope: every
    request (terminal, decoding, queued) finishes with the crash-free
    run's tokens."""
    trace = _trace(6, seed=1)
    base = _baseline(trace, 0.7, **CONFIGS["paged"])
    rng = np.random.default_rng(42)
    for crash_step in rng.integers(1, 14, size=3):
        eng2, done = _crash_then_restore(
            trace, int(crash_step), 0.7,
            snapshot_dir=str(tmp_path / f"s{crash_step}"),
            **CONFIGS["paged"])
        assert eng2.restores == 1
        assert len(done) == len(trace)
        for rid, r in done.items():
            assert r.status == "done"
            np.testing.assert_array_equal(r.output, base[rid].output)
        _assert_drained_clean(eng2)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("temperature", [0.0, 0.7],
                         ids=["greedy", "sampled"])
def test_restore_matrix_under_chaos(name, temperature):
    """The matrix with a chaos schedule running across the crash: faults
    before the snapshot leave retry state behind, faults after it hit
    restored requests; survivors stay exact either way."""
    kw = CONFIGS[name]
    trace = _trace(7, seed=2)
    base = _baseline(trace, temperature, **kw)
    rng = np.random.default_rng(7)
    for crash_step in rng.integers(2, 18, size=2):
        plan = FaultPlan(seed=13, step={"prob": 0.1, "max_fires": 2},
                         swap_in={"prob": 0.3, "max_fires": 2})
        eng2, done = _crash_then_restore(trace, int(crash_step),
                                         temperature, fault_plan=plan,
                                         max_retries=6, **kw)
        assert len(done) == len(trace)
        survivors = {rid: r for rid, r in done.items()
                     if r.status == "done"}
        assert survivors
        for rid, r in survivors.items():
            np.testing.assert_array_equal(r.output, base[rid].output)
        _assert_drained_clean(eng2)


def test_restore_speculative_is_token_exact():
    """Crash mid-speculation: acceptance is key-coupled, so a restored
    engine (its draft controller cold again) commits the same stream."""
    dlm, dparams = _draft()
    kw = dict(cache_backend="paged", block_size=8, num_pool_blocks=28,
              draft_model=dlm, draft_params=dparams, speculative_tokens=4)
    trace = _trace(5, seed=3, budgets=(4, 10))

    def spec_engine():
        eng = _engine(**kw)
        eng.scheduler.spec_min_commit = 0.0
        return eng

    ref = spec_engine()
    for prompt, budget in trace:
        ref.submit(prompt, budget, temperature=0.7)
    base = ref.run()
    eng1 = spec_engine()
    for prompt, budget in trace:
        eng1.submit(prompt, budget, temperature=0.7)
    for _ in range(5):
        eng1.step()
    assert eng1.spec_rounds > 0
    eng2 = spec_engine()
    eng2.restore(eng1.snapshot())
    done = _drain(eng2)
    assert len(done) == len(trace)
    for rid, r in done.items():
        assert r.status == "done"
        np.testing.assert_array_equal(r.output, base[rid].output)
    _assert_drained_clean(eng2)


def test_restore_refuses_warm_engine():
    eng1 = _engine()
    eng1.submit(np.arange(5), 4)
    snap = eng1.snapshot()
    eng2 = _engine()
    eng2.submit(np.arange(4), 3)
    with pytest.raises(RuntimeError, match="cold"):
        eng2.restore(snap)


def test_snapshot_directory_rotation(tmp_path):
    """save_snapshot keeps the newest ``keep`` envelopes; load_snapshot
    picks the latest by default, an explicit step on request."""
    eng = _engine()
    eng.submit(np.arange(5), 4)
    snap = eng.snapshot()
    for step in (1, 2, 3, 4):
        save_snapshot(str(tmp_path), snap, step=step, keep=3)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 3 and "step_1.npz" not in files
    latest, step = load_snapshot(str(tmp_path))
    assert step == 4
    explicit, step = load_snapshot(str(tmp_path), step=2)
    assert step == 2
    for loaded in (latest, explicit):
        eng2 = _engine()
        assert eng2.restore(loaded)["live"] == 1
        done = _drain(eng2)
        assert done and all(r.status == "done" for r in done.values())
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path / "nope"))


# -- the write-ahead journal ---------------------------------------------------

def _submit_rec(rid, prompt, max_new=5, temperature=0.7):
    return types.SimpleNamespace(
        request_id=rid, prompt=np.asarray(prompt, np.int32),
        max_new_tokens=max_new, temperature=temperature, priority=0,
        deadline_s=None)


def test_journal_replay_is_exact_and_refuses_duplicates(tmp_path):
    """Replay re-queues unfinished submissions under their original ids
    (so their sampling keys, and tokens, match the crash-free run), and a
    duplicate of a journaled id is refused."""
    trace = _trace(4, seed=5)
    base = _baseline(trace, 0.7)
    path = str(tmp_path / "journal.jsonl")
    with RequestJournal(path) as j:
        for rid, (prompt, budget) in enumerate(trace):
            assert j.record_submit(_submit_rec(rid, prompt, budget))
        assert not j.record_submit(_submit_rec(1, trace[1][0]))  # dup
        assert j.duplicates_refused == 1
        j.record_first_token(0)
        j.record_terminal(3, "cancelled", reason="client")
        assert sorted(j.unfinished()) == [0, 1, 2]
    j2 = RequestJournal(path)
    eng = _engine()
    assert j2.replay(eng) == {"replayed": 3, "covered": 0, "duplicates": 0}
    assert not j2.record_submit(_submit_rec(2, trace[2][0]))
    done = _drain(eng)
    assert sorted(done) == [0, 1, 2]
    for rid, r in done.items():
        assert r.status == "done"
        np.testing.assert_array_equal(r.output, base[rid].output)
    j2.close()


def test_journal_replay_skips_snapshot_covered_ids(tmp_path):
    trace = _trace(4, seed=6)
    eng1 = _engine()
    for prompt, budget in trace:
        eng1.submit(prompt, budget, temperature=0.5)
    for _ in range(3):
        eng1.step()
    with RequestJournal(str(tmp_path / "j.jsonl")) as j:
        for rid, (prompt, budget) in enumerate(trace):
            j.record_submit(_submit_rec(rid, prompt, budget))
        j.record_submit(_submit_rec(99, np.arange(4), 3))  # snapshot missed
        eng2 = _engine()
        eng2.restore(eng1.snapshot())
        counts = j.replay(eng2)
        assert counts["covered"] == len(trace) and counts["replayed"] == 1
    done = _drain(eng2)
    assert sorted(done) == [0, 1, 2, 3, 99]
    assert all(r.status == "done" for r in done.values())


def test_journal_compaction_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with RequestJournal(path) as j:
        for rid in range(4):
            j.record_submit(_submit_rec(rid, np.arange(3)))
        j.record_terminal(0, "done")
        assert j.compact(covered_rids={0, 1}) == {"kept": 2, "dropped": 3}
        assert j.compactions == 1
        assert sorted(j.unfinished()) == [2, 3]
        assert j.stats()["appended"] == 5
    with open(path, "a", encoding="utf-8") as f:   # a crash mid-append
        f.write('{"kind": "terminal", "rid": 2, "sta')
    j2 = RequestJournal(path)
    assert sorted(j2.unfinished()) == [2, 3]
    assert j2.seen(2) and not j2.seen(0)
    j2.close()


# -- the watchdog: a late hang recovers in process, a wedge restarts ----------

STEP_TIMEOUT_S = 2.0


def _gw_trace(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, 60, size=int(rng.integers(3, 10))),
                 max_new=int(rng.integers(3, 8))) for _ in range(n)]


async def _gw_clients(gw, trace, out):
    async def client(item):
        h = await gw.submit(item["prompt"], max_new_tokens=item["max_new"],
                            temperature=0.7)
        toks = [t async for t in h.stream()]
        r = await h.result()
        out[r.request_id] = (r, toks)

    await asyncio.gather(*(client(it) for it in trace))
    return out


def _gw_ref(trace):
    return _baseline([(it["prompt"], it["max_new"]) for it in trace], 0.7,
                     **CONFIGS["paged"])


def test_watchdog_hang_recovers_in_process():
    """A step that ends late (past the deadline, inside the grace window)
    is rolled back through the retry path and service goes on in the same
    process, streams exact."""
    trace = _gw_trace(5, seed=8)
    ref = _gw_ref(trace)
    plan = FaultPlan(seed=0, hang=[2], hang_s=1.5 * STEP_TIMEOUT_S)
    eng = _engine(fault_plan=plan, **CONFIGS["paged"])

    async def main():
        async with ServingGateway(eng, step_timeout_s=STEP_TIMEOUT_S,
                                  hang_grace=3.0) as gw:
            out = await _gw_clients(gw, trace, {})
            return out, gw.stats()

    out, stats = asyncio.run(main())
    assert stats["watchdog_timeouts"] >= 1
    assert stats["engine"]["hang_recoveries"] >= 1
    assert stats["engine"]["retries_total"] > 0
    assert eng.warm_compile_s is not None     # warmed before it armed
    assert len(out) == len(trace)
    for rid, (r, toks) in out.items():
        assert r.status == "done"
        np.testing.assert_array_equal(r.output, ref[rid].output)
        np.testing.assert_array_equal(toks, ref[rid].output)
    _assert_drained_clean(eng)


def test_wedge_supervised_restart_loses_nothing(tmp_path):
    """A step stalls past grace: the driver raises EngineWedgedError, the
    open handles fail fast, and a fresh engine recovered from snapshot +
    journal finishes every acknowledged request token-exact."""
    trace = _gw_trace(6, seed=9)
    ref = _gw_ref(trace)
    snap_dir = str(tmp_path / "snapshots")
    journal = RequestJournal(str(tmp_path / "journal.jsonl"))
    grace = 0.5
    plan = FaultPlan(seed=0, hang=[4],
                     hang_s=STEP_TIMEOUT_S * (1 + grace) + 1.5)
    eng = _engine(fault_plan=plan, **CONFIGS["paged"])

    async def main():
        out = {}
        gw = ServingGateway(eng, journal=journal, snapshot_dir=snap_dir,
                            snapshot_every=2, step_timeout_s=STEP_TIMEOUT_S,
                            hang_grace=grace)
        try:
            async with gw:
                await _gw_clients(gw, trace, out)
            return out, gw.stats(), True
        except EngineWedgedError:
            return out, gw.stats(), False

    out, stats, clean = asyncio.run(main())
    assert not clean, "the hang seam never wedged the engine"
    assert len(out) == len(trace)             # every handle resolved
    assert stats["watchdog_timeouts"] >= 1
    assert stats["snapshots_taken"] >= 1
    assert stats["journal"]["appended"] >= len(trace)
    eng2 = _engine(**CONFIGS["paged"])
    eng2.warm_compile()
    info = recover_engine(eng2, snapshot_dir=snap_dir, journal=journal)
    assert info["restored"]["live"] + info["replayed"]["replayed"] > 0
    done = _drain(eng2)
    _assert_drained_clean(eng2)
    journal.close()
    resolved = set()
    for rid, (r, _) in out.items():
        if r.status in ("done", "cancelled"):
            resolved.add(rid)
            if r.status == "done":
                np.testing.assert_array_equal(r.output, ref[rid].output)
    for rid in range(len(trace)):
        assert journal.seen(rid)
        assert rid in resolved or rid in done, f"request {rid} lost"
        if rid in done:
            assert done[rid].status == "done"
            np.testing.assert_array_equal(done[rid].output,
                                          ref[rid].output)


# -- the cascade --------------------------------------------------------------

def _cascade_pair():
    cloud = LM(_tcfg(), device="cpu")
    edge = LM(edge_variant(cloud.cfg, layers=1), device="cpu")
    return edge, cloud, edge.init(1), cloud.init(0)


def test_cascade_snapshot_restore_completes():
    """Pending and routed requests (and both legs) survive the crash; the
    restored cascade finishes every request on its original route with
    the crash-free run's tokens. Thresholds at the edge confidences'
    tertiles send prompts every way (accept, escalate, drop)."""
    edge, cloud, ep, cp = _cascade_pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 60, size=4 + i) for i in range(9)]
    probe = CascadeServingEngine(CascadeLM(edge, cloud), ep, cp,
                                 batch_slots=2, max_seq_len=32)
    conf = sorted(probe._gate(p)[0] for p in prompts)
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(
        hi=(conf[5] + conf[6]) / 2, lo=(conf[1] + conf[2]) / 2))

    def build():
        return CascadeServingEngine(cas, ep, cp, batch_slots=2,
                                    max_seq_len=32)

    ref = build()
    rids = [ref.submit(p, max_new_tokens=3, temperature=0.5)
            for p in prompts]
    base = ref.run()
    assert {r.route for r in base.values()} == {"accept", "escalate",
                                                "drop"}
    eng1 = build()
    for p in prompts:
        eng1.submit(p, max_new_tokens=3, temperature=0.5)
    for _ in range(3):
        eng1.step()
    snap = eng1.snapshot()
    eng2 = build()
    info = eng2.restore(snap)
    assert info["live"] + info["terminal"] == len(prompts)
    assert eng2.restores == 1
    assert eng2.known_request_ids() == set(rids)
    done = eng2.run()
    assert sorted(done) == sorted(rids)
    for rid in rids:
        r = done[rid]
        assert r.status == "done" and r.route == base[rid].route
        np.testing.assert_array_equal(r.output, base[rid].output)
    assert eng2.engine_metrics()["restores"] == 1


def test_deadline_hit_feedback_widens_admission_margin():
    sch = Scheduler(batch_slots=2, admission_policy="reject")
    assert sch.deadline_safety_margin(1) == 1.0
    mon = MonitoringService()
    mon.record_serving("eng", {"deadline_hits": {
        1: {"hits": 2, "total": 8, "rate": 0.25},
        0: {"hits": 8, "total": 8, "rate": 1.0}}})
    assert mon.feed_deadline_admission("eng", sch)
    assert sch.deadline_safety_margin(0) == 1.0
    m = sch.deadline_safety_margin(1)
    assert 1.0 < m <= sch.deadline_margin_cap
    assert m == pytest.approx(sch.deadline_margin_target / 0.25)
    sch.absorb_deadline_hits({2: {"hits": 0, "total": 2}})
    assert sch.deadline_safety_margin(2) == 1.0
    sch.reset_estimates()
    assert sch.deadline_safety_margin(1) == 1.0
    assert not mon.feed_deadline_admission("nope", sch)
    mon.record_restart("serve", {"restored": {"live": 1}})
    mon.record_hang("serve")
    assert mon.durability_counters() == {"restarts": 1, "hangs": 1,
                                         "journal_replays": 0}


# -- across packages ------------------------------------------------------------

def _margin_rule(jlm, jp, prompts, ours, theirs):
    """Greedy streams agree up to their first difference, which must sit
    on a near-tie (top-2 margin <= TOL) of ``repro``'s logits. Returns the
    tokens compared."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for prompt, a, b in zip(prompts, ours, theirs):
        assert len(a) == len(b)
        diff = np.flatnonzero(a != b)
        upto = diff[0] if len(diff) else len(a)
        compared += upto
        if len(diff):
            ctx = np.concatenate([prompt, b[:upto]])[None]
            logits = np.sort(np.asarray(fwd(jp, ctx))[0, -1])
            assert logits[-1] - logits[-2] <= TOL, (upto, a, b)
    return compared


@pytest.mark.parametrize("name", ["ring", "paged"])
def test_a_repro_snapshot_restores_into_the_port(name, tmp_path):
    """``repro`` serves a greedy trace for a few steps and saves a snapshot
    (the paged one with each decoding slot's K/V); the port loads it with
    its own envelope, restores it into a cold engine (the K/V through
    ``swap_in``) and finishes equal to ``repro``'s uninterrupted streams
    under the margin rule."""
    jlm, jp, lm, tp = _bridged()
    kw = CONFIGS[name]
    trace = _trace(6, seed=4, budgets=(6, 14))
    base = _baseline(trace, 0.0, model=(jlm, jp), engine=JaxEngine, **kw)
    jeng = _engine((jlm, jp), JaxEngine, **kw)
    for prompt, budget in trace:
        jeng.submit(prompt, budget)
    for _ in range(4):
        jeng.step()
    assert jeng._slots
    jax_save_snapshot(str(tmp_path), jeng.snapshot(), step=4)
    snap, step = load_snapshot(str(tmp_path))
    if name == "paged":
        assert any("kv" in rec for rec in snap["requests"].values())
    eng = _engine((lm, tp), **kw)
    eng.restore(snap)
    done = _drain(eng)
    assert sorted(done) == sorted(base)
    if name == "paged":
        assert eng.backend.swap_ins >= 1      # the K/V went in, not a prefill
    compared = _margin_rule(jlm, jp, [p for p, _ in trace],
                            [done[i].output for i in sorted(done)],
                            [base[i].output for i in sorted(done)])
    assert compared >= 30
    _assert_drained_clean(eng)


def test_a_port_snapshot_restores_into_repro(tmp_path):
    """The reverse, on the recompute path: the port's ring snapshot, saved
    with the port's envelope, is read by ``repro``'s
    ``load_checkpoint_tree`` and restored into ``repro``'s engine, which
    finishes equal to its own uninterrupted streams under the margin rule;
    a paged port snapshot's K/V rebuilds into ``repro``'s pool structure
    too."""
    jlm, jp, lm, tp = _bridged()
    trace = _trace(6, seed=4, budgets=(6, 14))
    base = _baseline(trace, 0.0, model=(jlm, jp), engine=JaxEngine,
                     **CONFIGS["ring"])
    for name in ("ring", "paged"):
        eng = _engine((lm, tp), **CONFIGS[name])
        for prompt, budget in trace:
            eng.submit(prompt, budget)
        for _ in range(4):
            eng.step()
        save_snapshot(str(tmp_path / name), eng.snapshot(), step=4)
        snap, _ = jax_load_snapshot(str(tmp_path / name))
        jeng = _engine((jlm, jp), JaxEngine, **CONFIGS["ring"])
        info = jeng.restore(snap)
        assert info["live"] + info["terminal"] == len(trace)
        done = _drain(jeng)
        compared = _margin_rule(jlm, jp, [p for p, _ in trace],
                                [done[i].output for i in sorted(done)],
                                [base[i].output for i in sorted(done)])
        assert compared >= 30


def test_snapshot_kv_is_repro_padded_row():
    """A paged snapshot's K/V is ``repro``'s wire format: the same key
    paths, each leaf (L, blocks_per_slot, block_size, ...) with the slot's
    table-row blocks first; it equals the pool's blocks bit for bit, and
    ``repro``'s snapshot of the same trace has the same paths and
    shapes."""
    jlm, jp, lm, tp = _bridged()
    trace = _trace(4, seed=4, budgets=(6, 14))
    snaps = {}
    for pkg, model, engine in (("repro", (jlm, jp), JaxEngine),
                               ("port", (lm, tp), ServingEngine)):
        eng = _engine(model, engine, **CONFIGS["paged"])
        for prompt, budget in trace:
            eng.submit(prompt, budget)
        for _ in range(3):
            eng.step()
        snaps[pkg] = (eng, eng.snapshot())
    eng, snap = snaps["port"]
    slot, r = next(iter(eng._slots.items()))
    rec = snap["requests"][f"r{r.request_id:08d}"]
    blocks = eng.backend._slot_blocks[slot]
    assert int(rec["kv"]["n_blocks"]) == len(blocks)
    kv = flat_paths(rec["kv"]["caches"])
    pool = flat_paths(eng._cache_state["caches"])
    m = eng.backend.blocks_per_slot
    for path, leaf in kv.items():
        assert leaf.shape[1] == m
        np.testing.assert_array_equal(
            leaf[:, :len(blocks)], pool[path][:, blocks].numpy())
    jrec = snaps["repro"][1]["requests"][f"r{r.request_id:08d}"]
    jkv = jax_flat_paths(jrec["kv"]["caches"])
    assert list(jkv) == list(kv)
    assert all(np.asarray(jkv[p]).shape == kv[p].shape for p in kv)


def test_flat_paths_and_save_checkpoint_match_repro(tmp_path):
    """The numpy ``flat_paths`` spells and orders keys as ``repro``'s (JAX
    sorts dict keys; ``None`` is an empty subtree), and ``save_checkpoint``
    stores the same arrays: names, dtypes and bytes, bf16 words
    included."""
    rng = np.random.default_rng(0)
    tree = {"zeta": [np.arange(3, dtype=np.int32),
                     (rng.normal(size=(2, 2)).astype(np.float32), None)],
            "alpha": {"b": np.uint8(7), "a": rng.normal(size=4)},
            "mid": [{"k": np.asarray(jax.numpy.ones((2, 3),
                                                    jax.numpy.bfloat16))}]}
    ours, theirs = flat_paths(tree), jax_flat_paths(tree)
    assert list(ours) == list(theirs)
    assert all(ours[k] is theirs[k] for k in ours)
    save_checkpoint(str(tmp_path / "port"), 1, tree)
    jax_save(str(tmp_path / "repro"), 1, tree)
    with np.load(tmp_path / "port" / "step_1.npz") as a, \
            np.load(tmp_path / "repro" / "step_1.npz") as b:
        assert a.files == b.files == list(theirs)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_serve_cli_flags_against_repro(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve`` keeps ``repro``'s flags but
    ``--compile-cache``, and its ``--reduced`` can be turned off where ``repro``'s cannot
    (``store_true`` with ``default=True``: ``--no-reduced`` is an error
    there). ``--mesh N --supervise`` goes to the mesh launcher
    (``serve_mesh``; the mesh itself is
    ``tests/test_torch_sharded_serving.py``'s, ``tests/test_torch_moe_mesh
    .py``'s, ``tests/test_torch_recurrent_mesh.py``'s and
    ``tests/test_torch_mesh_supervise.py``'s); a short run on the CPU
    serves every arrival through the gateway."""
    import sys

    import repro.launch.serve as jserve
    from repro_torch.launch import serve as tserve

    seen = []

    async def fake(args):
        seen.append(args)

    monkeypatch.setattr(jserve, "_serve", fake)
    monkeypatch.setattr(sys, "argv", ["serve"])
    jserve.main()
    assert seen[-1].reduced is True and seen[-1].compile_cache is False
    monkeypatch.setattr(sys, "argv", ["serve", "--no-reduced"])
    with pytest.raises(SystemExit):
        jserve.main()
    got = []
    monkeypatch.setattr(tserve, "serve", got.append)
    tserve.main([])
    tserve.main(["--no-reduced", "--device", "cpu"])
    assert [a.reduced for a in got] == [True, False]
    assert got[0].device == "cuda" and not hasattr(got[0], "compile_cache")
    with pytest.raises(SystemExit):
        tserve.main(["--compile-cache"])
    meshed = []
    monkeypatch.setattr(tserve, "serve_mesh", meshed.append)
    tserve.main(["--mesh", "2", "--device", "cpu", "--supervise"])
    assert [(a.mesh, a.supervise) for a in meshed] == [(2, True)]
    monkeypatch.undo()
    tserve.main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                 "--quiet", "--rate", "1000"])
    assert "served 3 arrivals at 1000 req/s: {'done': 3}" in \
        capsys.readouterr().out
