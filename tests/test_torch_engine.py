"""The port's ServingEngine (ring backend) on the CPU.

Across packages: greedy streams equal ``repro.serving.ServingEngine``'s on
the same trace and bridged weights, wherever ``repro``'s top-2 logit margin
at a step exceeds the logits tolerance (1e-4, as in
``tests/test_torch_model.py``); at a smaller margin the two may rightly
pick different tokens, and the comparison stops there. The ring append
equals ``repro``'s bit for bit; the drain batcher's sampled streams
equal ``repro``'s (one threefry key split per token, as there). Within the
port: K-step decode equals 1-step, and sampled streams do not depend on
co-scheduling (keyed sampling with JAX's threefry;
``tests/test_torch_sampler.py`` holds its bits to ``jax.random``'s).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig, dense_stages  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import DrainBatchEngine as JaxDrainEngine  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import accepted_prefix_length as jax_accepted  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import DrainBatchEngine, ServingEngine  # noqa: E402
from repro_torch.serving.sampler import (accepted_prefix_length,  # noqa: E402
                                         prng_key, request_keys,
                                         sample_logits_keyed)

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


FIELDS = dict(name="tiny", family="dense", source="t", num_layers=4,
              d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=96, param_dtype="float32")
PROMPTS = [np.random.default_rng(i).integers(0, 96, n).astype(np.int32)
           for i, n in enumerate((5, 12, 20, 9, 17))]


@functools.lru_cache(maxsize=None)
def _models():
    jlm = JaxLM(ModelConfig(**FIELDS, stages=dense_stages(4)), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(3))
    tc = tcfg.ModelConfig(**FIELDS, stages=tcfg.dense_stages(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


def _serve(engine, reqs):
    ids = [engine.submit(p, max_new_tokens=n, temperature=t)
           for p, n, t in reqs]
    done = engine.run()
    assert sorted(done) == sorted(ids)
    assert all(done[i].status == "done" for i in ids)
    return [done[i].output for i in ids]


def _margin_rule(jlm, jp, prompts, ours, theirs):
    """Greedy streams agree up to their first difference, which must sit
    on a near-tie (top-2 margin <= TOL) of ``repro``'s logits. Returns the
    number of tokens compared."""
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


def test_greedy_streams_match_repro_within_the_margin_rule():
    jlm, jp, lm, tp = _models()
    reqs = [(p, 6, 0.0) for p in PROMPTS]
    kw = dict(batch_slots=2, max_seq_len=64)
    ours = _serve(ServingEngine(lm, tp, **kw), reqs)
    theirs = _serve(JaxEngine(jlm, jp, **kw), reqs)
    assert all(len(a) == 6 for a in ours)
    assert _margin_rule(jlm, jp, PROMPTS, ours, theirs) >= 25


def head_faithful(cfg, window=None):
    """``cfg`` cut to 2 layers, d_model 64, d_ff 128, vocab 512, f32, with
    its head layout kept (heads, KV heads, head_dim, qk-norm, tying);
    ``window`` replaces a window so that short prompts wrap the ring."""
    stage = cfg.stages[0]
    blocks = tuple(dataclasses.replace(b, window=window or b.window)
                   for b in stage.blocks)
    return dataclasses.replace(
        cfg, name=cfg.name + "-heads", num_layers=2, d_model=64, d_ff=128,
        vocab_size=512, param_dtype="float32",
        stages=(dataclasses.replace(stage, blocks=blocks, repeat=2),))


@functools.lru_cache(maxsize=None)
def zoo_models(name, window=None):
    """(repro LM, params, port LM, bridged params) of a head-faithful zoo
    model (``tests/test_torch_model.py``'s cut)."""
    from repro.configs import get_config as jax_get_config

    jlm = JaxLM(head_faithful(jax_get_config(name), window), kv_chunk=8)
    jp = jax.jit(lambda k: jlm.init(k)[0])(jax.random.PRNGKey(5))
    tc = head_faithful(tcfg.get_config(name), window)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jlm, jp, LM(tc, device="cpu"), tp


@pytest.mark.parametrize("name,window", [("glm4-9b", None),
                                         ("starcoder2-7b", 8)])
def test_zoo_greedy_streams_match_repro_on_the_ring(name, window):
    """glm4's 32 heads over 2 KV heads (G = 16) and starcoder2's 36 over 4
    (G = 9, GeGLU) at hd 128, through the ring engine; starcoder2's window
    cut to 8, so the ring is 8 wide and every stream wraps it."""
    jlm, jp, lm, tp = zoo_models(name, window)
    assert (lm.cfg.num_heads, lm.cfg.num_kv_heads, lm.cfg.head_dim) == {
        "glm4-9b": (32, 2, 128), "starcoder2-7b": (36, 4, 128)}[name]
    reqs = [(p, 6, 0.0) for p in PROMPTS]
    kw = dict(batch_slots=2, max_seq_len=64, max_decode_steps=2)
    ours = _serve(ServingEngine(lm, tp, **kw), reqs)
    theirs = _serve(JaxEngine(jlm, jp, **kw), reqs)
    assert _margin_rule(jlm, jp, PROMPTS, ours, theirs) >= 25


@pytest.mark.parametrize("k", [2, 4])
def test_k_step_decode_equals_one_step(k):
    _, _, lm, tp = _models()
    reqs = [(p, 3 + 2 * i, 0.0 if i % 2 else 1.5)
            for i, p in enumerate(PROMPTS)]
    kw = dict(batch_slots=3, max_seq_len=64, seed=7)
    one = ServingEngine(lm, tp, **kw)
    many = ServingEngine(lm, tp, max_decode_steps=k, **kw)
    for a, b in zip(_serve(one, reqs), _serve(many, reqs)):
        np.testing.assert_array_equal(a, b)
    assert many.host_syncs < one.host_syncs
    assert many.decode_steps >= one.decode_steps


def test_sampled_streams_do_not_depend_on_coscheduling():
    _, _, lm, tp = _models()
    reqs = [(p, 8, 1.5) for p in PROMPTS[:3]]
    together = _serve(ServingEngine(lm, tp, batch_slots=3, max_seq_len=64),
                      reqs)
    alone = ServingEngine(lm, tp, batch_slots=1, max_seq_len=64)
    seq = _serve(alone, reqs)          # one at a time, same request ids
    for a, b in zip(together, seq):
        np.testing.assert_array_equal(a, b)
    # and the sampler really samples: not every stream is its greedy one
    greedy = _serve(ServingEngine(lm, tp, batch_slots=3, max_seq_len=64),
                    [(p, 8, 0.0) for p, _, _ in reqs])
    assert any((a != g).any() for a, g in zip(together, greedy))


@pytest.mark.parametrize("t", [1, 4, 8])
def test_ring_append_matches_repro(t):
    """The masked in-place append equals repro's out-of-bounds-dropping
    scatter: decode (T=1), a chunk within the ring, and a chunk longer
    than the ring (only each slot's newest token kept); rows with a
    partial and an empty write mask."""
    import jax.numpy as jnp
    from repro.serving.kv_cache import RING as JAX_RING
    from repro_torch.serving.kv_cache import RING

    rng = np.random.default_rng(t)
    b, width, kv, hd = 3, 6, 2, 4
    k0 = rng.standard_normal((b, width, kv, hd)).astype(np.float32)
    pos0 = rng.integers(-1, 20, (b, width)).astype(np.int32)
    upd = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    start = np.asarray([3, 17, 0], np.int32)
    valid = np.arange(t)[None, :] < np.asarray([t, max(t - 2, 1), 0])[:, None]
    theirs = jax.jit(lambda c, u, s, v: JAX_RING.append(c, u, s, valid=v))(
        {"k": jnp.asarray(k0), "pos": jnp.asarray(pos0)},
        {"k": jnp.asarray(upd)}, jnp.asarray(start), jnp.asarray(valid))
    ours = RING.append({"k": torch.from_numpy(k0.copy()),
                        "pos": torch.from_numpy(pos0.copy())},
                       {"k": torch.from_numpy(upd)}, torch.from_numpy(start),
                       valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ours["pos"].numpy(),
                                  np.asarray(theirs["pos"]))
    np.testing.assert_array_equal(ours["k"].numpy(), np.asarray(theirs["k"]))


def test_keyed_sampler_is_a_pure_function_of_its_key():
    logits = torch.randn(4, 50)
    temp = torch.tensor([0.0, 1.0, 1.0, 2.0])
    keys = request_keys(prng_key(0), torch.tensor([1, 2, 2, 3]),
                        torch.tensor([0, 5, 5, 9]))
    assert keys.shape == (4, 2)
    a = sample_logits_keyed(keys, logits, temp)
    b = sample_logits_keyed(keys.flip(0), logits.flip(0), temp.flip(0))
    assert torch.equal(a, b.flip(0))
    assert a[0] == logits[0].argmax()
    assert torch.equal(keys[1], keys[2]) and not torch.equal(keys[0], keys[1])
    prop = np.asarray([[1, 2, 3], [1, 5, 3], [4, 4, 4]], np.int32)
    targ = np.asarray([[1, 2, 3], [1, 2, 3], [0, 4, 4]], np.int32)
    ours = accepted_prefix_length(torch.from_numpy(prop),
                                  torch.from_numpy(targ)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_accepted(prop, targ)))


def test_engine_edges_and_later_slices():
    """Oversized prompts, cancel (queued, and mid-prefill on the chunked
    paged engine), max_new_tokens=0 and an EOS stop, on the ring and the
    paged backend; a mesh that is not a ``HostMesh`` raises, and ``rules``
    (``repro``'s activation hints) are accepted and dropped (the mesh is
    ``tests/test_torch_sharded_serving.py``'s, faults are
    ``tests/test_torch_faults.py``'s)."""
    _, _, lm, tp = _models()
    for backend in (dict(), dict(cache_backend="paged", block_size=8,
                                 chunk_tokens=8)):
        eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32,
                            eos_id=None, **backend)
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            eng.submit(np.zeros(30, np.int32), max_new_tokens=8)
        r0 = eng.submit(PROMPTS[0], max_new_tokens=0)
        r1 = eng.submit(PROMPTS[1], max_new_tokens=4)
        r2 = eng.submit(PROMPTS[2], max_new_tokens=4)
        r3 = eng.submit(PROMPTS[3], max_new_tokens=4)
        assert eng.cancel(r3) and not eng.cancel(999)
        done = eng.run()
        assert done[r0].output.size == 0 and done[r0].status == "done"
        assert done[r2].status == "done" and len(done[r2].output) == 4
        assert done[r3].status == "cancelled"
        first = int(done[r1].output[0])
        stop = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32,
                             eos_id=first, **backend)
        rid = stop.submit(PROMPTS[1], max_new_tokens=4)
        assert stop.run()[rid].output.tolist() == [first]
        m = eng.metrics()
        assert m["terminal"] == {"done": 3, "cancelled": 1}
        assert 0 < m["occupancy"] <= 1
        if backend:
            # 17 new tokens in 8-token chunks: mid-prefill after one step
            r4 = eng.submit(PROMPTS[4], max_new_tokens=4)
            eng.step()
            assert eng.metrics()["live"]["prefilling"] == 1
            assert eng.cancel(r4)
            assert eng.run()[r4].failure_reason == "cancelled: mid-prefill"
            eng.assert_invariants()
            assert eng.backend.blocks_in_use == 0
    with pytest.raises(TypeError, match="HostMesh"):
        ServingEngine(lm, tp, mesh=object())
    eng = ServingEngine(lm, tp, rules=object())
    assert eng.mesh is None


def _admission(engine):
    """``tests/test_faults.py::test_deadline_admission_reject_and_downgrade``
    on one engine: train the service estimate, saturate, then submit a
    hopeless deadline and a loose one. Returns (tight, loose) as the engine
    leaves them after ``run()``, and the tight request as queued."""
    for _ in range(3):                    # train the estimator
        engine.submit(np.arange(6), 6)
    engine.run()
    est = engine.scheduler.service_estimate(0)
    assert est is not None and est > 0
    for _ in range(4):                    # saturation
        engine.submit(np.arange(6), 6)
    tight = engine.submit(np.arange(6), 6, deadline_s=est * 1e-3)
    loose = engine.submit(np.arange(6), 6, deadline_s=600.0)
    queued = next((q for q in engine._queue if q.request_id == tight), None)
    if queued is not None:                # a snapshot: run() moves it on
        queued = (queued.downgraded, queued.deadline_s)
    done = engine.run()
    return done[tight], done[loose], queued


@pytest.mark.parametrize("policy", ["reject", "downgrade"])
def test_deadline_admission_matches_repro(policy):
    """Submit-time feasibility on the same trace through ``repro``'s engine
    and the port's, on bridged weights: "reject" refuses the hopeless
    deadline, "downgrade" strips it and flags the request, and the loose
    deadline is served untouched, in both."""
    jlm, jp, lm, tp = _models()
    kw = dict(batch_slots=2, max_seq_len=64, min_bucket=4,
              admission_policy=policy)
    for engine in (JaxEngine(jlm, jp, **kw), ServingEngine(lm, tp, **kw)):
        tight, loose, queued = _admission(engine)
        if policy == "reject":
            assert tight.status == "rejected"
            assert tight.failure_reason.startswith("deadline_infeasible")
            assert queued is None
        else:
            assert queued == (True, None)
            assert tight.status == "done" and tight.downgraded
            assert tight.deadline_s is None
        assert loose.status == "done" and not loose.downgraded
        assert loose.deadline_s == 600.0


# -- the drain-batch baseline and mid-scan completion -------------------------


def _mixed(n, seed, budgets=(3, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 96, int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(*budgets))) for _ in range(n)]


def _drain_noise(jlm, seed, reqs, batch_slots):
    """The Gumbel noise ``repro``'s drain batcher draws for request ``rid``
    at token ``t``: one key split off ``PRNGKey(seed)`` per token of each
    FIFO batch's longest budget, one (batch_slots, V) draw per key."""
    rng, keys = jax.random.PRNGKey(seed), []
    for i in range(0, len(reqs), batch_slots):
        keys.append([])
        for _ in range(max(n for _, n in reqs[i:i + batch_slots])):
            rng, k = jax.random.split(rng)
            keys[-1].append(k)

    def noise(rid, t):
        k = keys[rid // batch_slots][t]
        shape = (batch_slots, jlm.cfg.padded_vocab)
        return np.asarray(jax.random.gumbel(k, shape))[rid % batch_slots]
    return noise


def _sampled_margin_rule(jlm, jp, prompts, ours, theirs, temperature,
                         noise):
    """``_margin_rule`` for sampled streams: the first difference must sit
    where logits / T plus that step's noise ``noise(rid, t)`` have a top-2
    margin <= TOL / T + 1e-5 (the noise's own ulps)."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})[0])
    compared = 0
    for rid, (prompt, a, b) in enumerate(zip(prompts, ours, theirs)):
        assert len(a) == len(b)
        diff = np.flatnonzero(a != b)
        upto = diff[0] if len(diff) else len(a)
        compared += upto
        if len(diff):
            ctx = np.concatenate([prompt, b[:upto]])[None]
            logits = np.asarray(fwd(jp, ctx))[0, -1].astype(np.float64)
            pert = np.sort(logits / temperature + noise(rid, upto))
            assert pert[-1] - pert[-2] <= TOL / temperature + 1e-5, \
                (upto, a, b)
    return compared


def test_continuous_matches_drain_batch():
    """``tests/test_serving.py::test_continuous_matches_drain_batch`` in the
    port: mixed prompts and budgets give the continuous engine's greedy
    tokens on the drain batcher (bucketing and right-padding are exact),
    the drain batcher syncs once per token of each batch's longest budget,
    and its streams equal ``repro``'s ``DrainBatchEngine``'s under the
    margin rule, greedy and sampled: both split one threefry key per token
    and draw the whole batch from it (so a sampled drain stream is not the
    continuous engine's, which keys by request and step)."""
    jlm, jp, lm, tp = _models()
    reqs = _mixed(7, seed=1)
    for temp in (0.0, 1.5):
        cont = ServingEngine(lm, tp, batch_slots=3, max_seq_len=32,
                             min_bucket=4)
        drain = DrainBatchEngine(lm, tp, batch_slots=3, max_seq_len=32)
        for prompt, max_new in reqs:
            cont.submit(prompt, max_new_tokens=max_new, temperature=temp)
            drain.submit(prompt, max_new_tokens=max_new, temperature=temp)
        dc, dd = cont.run(), drain.run()
        assert set(dc) == set(dd) == set(range(len(reqs)))
        for rid in dc:
            assert dc[rid].output.shape == (reqs[rid][1],)
            assert dd[rid].status == "done"
            if temp == 0.0:
                np.testing.assert_array_equal(dc[rid].output,
                                              dd[rid].output)
        assert cont.decode_steps < sum(mn for _, mn in reqs)
        assert 0.0 < cont.occupancy() <= 1.0
        assert drain.host_syncs == sum(
            max(mn for _, mn in reqs[i:i + 3]) for i in range(0, 7, 3))
        assert drain.generated_tokens == sum(mn for _, mn in reqs)
        theirs = JaxDrainEngine(jlm, jp, batch_slots=3, max_seq_len=32)
        for prompt, max_new in reqs:
            theirs.submit(prompt, max_new_tokens=max_new, temperature=temp)
        dj = theirs.run()
        prompts = [p for p, _ in reqs]
        ours = [dd[i].output for i in range(7)]
        ref = [dj[i].output for i in range(7)]
        if temp == 0.0:
            compared = _margin_rule(jlm, jp, prompts, ours, ref)
        else:
            compared = _sampled_margin_rule(
                jlm, jp, prompts, ours, ref, temp,
                _drain_noise(jlm, 0, reqs, 3))
            assert any((dd[i].output != dc[i].output).any()
                       for i in range(7))
        assert compared >= 30


@pytest.mark.parametrize("engine", ["continuous", "drain"])
def test_submit_rejects_overlong_prompts(engine):
    """Every engine refuses at submit a prompt that with its budget would
    not fit ``max_seq_len``; an exact fit is taken."""
    _, _, lm, tp = _models()
    cls = ServingEngine if engine == "continuous" else DrainBatchEngine
    eng = cls(lm, tp, batch_slots=2, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.arange(20), max_new_tokens=4)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.arange(14), max_new_tokens=4)       # prompt+budget > 16
    with pytest.raises(ValueError, match="no room"):
        eng.submit(np.arange(4), max_new_tokens=16)
    rid = eng.submit(np.arange(12), max_new_tokens=4)     # exactly fits
    assert eng.run()[rid].output.shape == (4,)


@pytest.mark.parametrize("engine", ["ring", "chunked", "drain"])
def test_ttft_and_admit_recorded(engine):
    _, _, lm, tp = _models()
    if engine == "drain":
        eng = DrainBatchEngine(lm, tp, batch_slots=2, max_seq_len=32)
    else:
        eng = ServingEngine(lm, tp, batch_slots=2, max_seq_len=32,
                            min_bucket=4,
                            chunk_tokens=4 if engine == "chunked" else None)
    for prompt, max_new in _mixed(3, seed=9, budgets=(3, 14)):
        eng.submit(prompt, max_new_tokens=max_new)
    for r in eng.run().values():
        assert r.admit_s >= r.submit_s > 0
        assert 0 < r.ttft_s <= r.latency_s


@pytest.mark.parametrize("backend", ["ring", "paged"])
def test_eos_mid_scan_stops_exactly(backend):
    """A request that hits EOS inside a K-step round goes inactive on the
    device and no-ops through the rest: its output ends at the EOS token
    and its slot frees at the round's sync."""
    _, _, lm, tp = _models()
    probe = ServingEngine(lm, tp, batch_slots=1, max_seq_len=32,
                          min_bucket=4)
    probe.submit(np.arange(5), max_new_tokens=8)
    greedy = probe.run()[0].output
    # EOS = the third greedy token: the first round after admission is a
    # collapsed k=1, so this EOS lands inside the second round's steps
    eos = int(greedy[2])
    expect = list(greedy[:list(greedy).index(eos) + 1])
    kw = dict(cache_backend="paged", block_size=8) if backend == "paged" \
        else {}
    eng = ServingEngine(lm, tp, batch_slots=1, max_seq_len=32, min_bucket=4,
                        eos_id=eos, max_decode_steps=8, **kw)
    eng.submit(np.arange(5), max_new_tokens=8)
    assert list(eng.run()[0].output) == expect
    assert eng.host_syncs <= 2           # k=1 arming round + one K round


def test_budget_exhaustion_mid_scan():
    """Mixed budgets in one round: the horizon is capped by the smallest
    headroom, so small budgets finish exactly and the larger ones go on
    across rounds."""
    _, _, lm, tp = _models()
    eng = ServingEngine(lm, tp, batch_slots=3, max_seq_len=32, min_bucket=4,
                        max_decode_steps=8)
    base = ServingEngine(lm, tp, batch_slots=3, max_seq_len=32, min_bucket=4)
    for e in (eng, base):
        e.submit(np.arange(4), max_new_tokens=3)
        e.submit(np.arange(6), max_new_tokens=8)
        e.submit(np.arange(2), max_new_tokens=5)
    done, ref = eng.run(), base.run()
    for rid, r in ref.items():
        assert len(done[rid].output) == len(r.output)
        np.testing.assert_array_equal(done[rid].output, r.output)
    assert eng.host_syncs < base.host_syncs
