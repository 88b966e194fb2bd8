"""The async gateway over the port's engines (``repro_torch.serving
.ServingGateway``) on the CPU: streaming, cancellation, backpressure.

It mirrors ``tests/test_gateway.py``: tokens streamed through the gateway
equal the closed-loop engine's outputs for the same submission order
(greedy and sampled, ring and paged); an abandoned or cancelled stream
frees its slot and blocks; the bounded inbox's block/reject/shed policies
engage under a saturating burst; TTFT and latency are stamped at the
stream boundary; under a seeded ``FaultPlan`` every stream reaches a
terminal state and survivors stream exactly. And over
``CascadeServingEngine``: the legs' taps, their request ids translated to
the cascade's, stream the closed-loop cascade's outputs.
"""
import asyncio
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.cascade import CascadeLM, edge_variant  # noqa: E402
from repro_torch.cascade.gate import make_thresholds  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import (CascadeServingEngine,  # noqa: E402
                                 FaultPlan, ServingEngine, ServingGateway)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    return tcfg.ModelConfig(
        name="tiny", family="dense", source="t", num_layers=2, d_model=32,
        num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
        stages=tcfg.dense_stages(2), param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _model():
    lm = LM(_tiny_cfg(), device="cpu")
    return lm, lm.init(0)


@pytest.fixture
def tiny():
    return _model()


PAGED = dict(cache_backend="paged", block_size=8, num_pool_blocks=24)


def _engine(tiny, **kw):
    lm, params = tiny
    base = dict(batch_slots=2, max_seq_len=48, min_bucket=4)
    base.update(kw)
    return ServingEngine(lm, params, **base)


def _trace(n=6, seed=3, sampled=False):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, 60, size=int(rng.integers(3, 12))),
                 max_new=int(rng.integers(3, 9)),
                 temperature=0.7 if sampled and i % 2 else 0.0)
            for i in range(n)]


def _reference(tiny, trace, **kw):
    """Closed-loop ground truth; request ids land in submission order,
    the same order the gateway allocates them."""
    eng = _engine(tiny, **kw)
    for it in trace:
        eng.submit(it["prompt"], max_new_tokens=it["max_new"],
                   temperature=it["temperature"])
    return eng.run()


async def _gw_run(eng, trace, **gw_kw):
    """Every trace item as a concurrent streaming client; returns
    {rid: (terminal request, streamed tokens)}."""
    out = {}

    async def client(item):
        h = await gw.submit(item["prompt"], max_new_tokens=item["max_new"],
                            temperature=item["temperature"])
        toks = [t async for t in h.stream()]
        r = await h.result()
        out[r.request_id] = (r, np.asarray(toks, np.int32))

    async with ServingGateway(eng, **gw_kw) as gw:
        await asyncio.gather(*(client(it) for it in trace))
    return out


def _assert_drained_clean(eng):
    assert sorted(eng._free) == list(range(eng.batch_slots))
    be = eng.backend
    if hasattr(be, "_gap_total"):            # the paged allocator
        be.assert_invariants()
        assert be._gap_total == 0 and be._ref == {}


# ---------------------------------------------------------------------------
# streaming exactness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend_kw", [dict(), PAGED],
                         ids=["ring", "paged"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_stream_matches_closed_loop(tiny, backend_kw, sampled):
    """The gateway is a transport, not a scheduler of its own: every
    stream must deliver exactly the closed-loop output for its rid —
    sampled decoding included (keys fold (request_id, step), so outputs
    are co-scheduling-independent)."""
    trace = _trace(6, sampled=sampled)
    ref = _reference(tiny, trace, **backend_kw)
    eng = _engine(tiny, **backend_kw)
    out = asyncio.run(_gw_run(eng, trace))
    assert set(out) == set(ref)
    for rid, (r, toks) in out.items():
        assert r.status == "done"
        np.testing.assert_array_equal(toks, ref[rid].output)
        np.testing.assert_array_equal(r.output, toks)
        assert r.ttft_s > 0 and r.latency_s >= r.ttft_s
    _assert_drained_clean(eng)


# ---------------------------------------------------------------------------
# cancellation / disconnect
# ---------------------------------------------------------------------------

def test_disconnect_and_cancel_free_slots_and_blocks(tiny):
    """Breaking out of a stream (client disconnect) and explicit
    ``gateway.cancel`` must reach the engine's cancel path in every
    phase — mid-decode, and still queued in the gateway inbox — and
    leave the paged pool clean."""
    eng = _engine(tiny, **PAGED)

    async def main():
        async with ServingGateway(eng, forward_depth=1) as gw:
            # disconnect mid-decode: abandon the iterator after 2 tokens
            h1 = await gw.submit(np.arange(5), max_new_tokens=12)
            got = []
            async for t in h1.stream():
                got.append(t)
                if len(got) == 2:
                    break
            r1 = await h1.result()
            assert r1.status == "cancelled"
            assert len(got) == 2

            # explicit cancel mid-decode
            h2 = await gw.submit(np.arange(4), max_new_tokens=12)
            agen = h2.stream()
            await agen.__anext__()
            assert await gw.cancel(h2.request_id)
            r2 = await h2.result()
            assert r2.status == "cancelled"
            await agen.aclose()

            # cancel while still in the gateway inbox: submits in one
            # coroutine never yield to the driver, so the tail request
            # is still queued gateway-side when the cancel lands
            hs = [await gw.submit(np.arange(4), max_new_tokens=4)
                  for _ in range(4)]
            assert await gw.cancel(hs[-1].request_id)
            r3 = await hs[-1].result()
            assert r3.status == "cancelled"
            assert r3.failure_reason == "cancelled: in gateway queue"
            assert r3.output.shape == (0,)
            for h in hs[:-1]:
                assert (await h.result()).status == "done"
            # cancelling a terminal request is a no-op
            assert not await gw.cancel(hs[-1].request_id)

    asyncio.run(main())
    _assert_drained_clean(eng)


# ---------------------------------------------------------------------------
# backpressure under a saturating burst
# ---------------------------------------------------------------------------

def test_reject_policy_refuses_newcomers_when_full(tiny):
    eng = _engine(tiny)

    async def main():
        # sequential submits never yield to the driver: the burst is
        # guaranteed to hit a full inbox, not race the drain
        async with ServingGateway(eng, max_queue=2, forward_depth=1,
                                  policy="reject") as gw:
            hs = [await gw.submit(np.arange(4), max_new_tokens=3)
                  for _ in range(5)]
            return gw, [await h.result() for h in hs]

    gw, rs = asyncio.run(main())
    statuses = [r.status for r in rs]
    assert statuses == ["done", "done", "rejected", "rejected", "rejected"]
    for r in rs[2:]:
        assert r.failure_reason.startswith("gateway_overload")
    assert gw.reject_count == 3 and gw.shed_count == 0
    _assert_drained_clean(eng)


def test_shed_policy_evicts_worst_ranked_only(tiny):
    eng = _engine(tiny)

    async def main():
        async with ServingGateway(eng, max_queue=2, forward_depth=1,
                                  policy="shed") as gw:
            lo = [await gw.submit(np.arange(4), max_new_tokens=3, priority=0)
                  for _ in range(2)]
            # high-class arrivals displace the queued low-class work...
            hi = [await gw.submit(np.arange(4), max_new_tokens=3, priority=2)
                  for _ in range(2)]
            # ...but a low-class newcomer cannot displace high-class work
            late = await gw.submit(np.arange(4), max_new_tokens=3, priority=0)
            rs = {"lo": [await h.result() for h in lo],
                  "hi": [await h.result() for h in hi],
                  "late": await late.result()}
            return gw, rs

    gw, rs = asyncio.run(main())
    assert [r.status for r in rs["hi"]] == ["done", "done"]
    assert [r.status for r in rs["lo"]] == ["rejected", "rejected"]
    for r in rs["lo"]:
        assert r.failure_reason.startswith("shed_overload")
    assert rs["late"].status == "rejected"
    assert rs["late"].failure_reason.startswith("gateway_overload")
    assert gw.shed_count == 2 and gw.reject_count == 1
    _assert_drained_clean(eng)


def test_block_policy_serves_every_arrival(tiny):
    eng = _engine(tiny)

    async def main():
        async with ServingGateway(eng, max_queue=1, forward_depth=1,
                                  policy="block") as gw:
            async def client(i):
                h = await gw.submit(np.arange(3 + i % 4), max_new_tokens=3)
                return await h.result()
            rs = await asyncio.gather(*(client(i) for i in range(6)))
            return gw, rs

    gw, rs = asyncio.run(main())
    assert all(r.status == "done" for r in rs)
    assert gw.shed_count == 0 and gw.reject_count == 0
    _assert_drained_clean(eng)


def test_drain_finishes_accepted_and_refuses_new(tiny):
    eng = _engine(tiny)

    async def main():
        gw = ServingGateway(eng)
        h = await gw.submit(np.arange(5), max_new_tokens=6)
        await gw.drain()
        r = await h.result()
        assert r.status == "done" and r.output.shape == (6,)
        h2 = await gw.submit(np.arange(5), max_new_tokens=4)
        r2 = await h2.result()
        assert r2.status == "rejected"
        assert r2.failure_reason.startswith("gateway_draining")

    asyncio.run(main())
    _assert_drained_clean(eng)


# ---------------------------------------------------------------------------
# latency accounting at the gateway boundary
# ---------------------------------------------------------------------------

def test_latency_and_ttft_stamped_at_stream_boundary(tiny):
    """Regression (stale-latency accounting): the client-visible TTFT
    and latency are stamped when tokens surface on the loop, strictly
    after the engine's internal host-sync stamps — and queue wait counts:
    on a one-slot engine the queued request's TTFT covers its
    predecessor's whole service time."""
    eng = _engine(tiny, batch_slots=1)
    inner = {}
    orig = eng.take_done

    def spy():
        done = orig()
        for rid, r in done.items():
            inner[rid] = (r.ttft_s, r.latency_s)
        return done

    eng.take_done = spy

    async def main():
        async with ServingGateway(eng, forward_depth=1) as gw:
            ha = await gw.submit(np.arange(6), max_new_tokens=10)
            hb = await gw.submit(np.arange(4), max_new_tokens=4)
            return await ha.result(), await hb.result()

    ra, rb = asyncio.run(main())
    assert ra.status == "done" and rb.status == "done"
    for r in (ra, rb):
        eng_ttft, eng_latency = inner[r.request_id]
        assert r.ttft_s > eng_ttft
        assert r.latency_s > eng_latency
    # one slot: B's first token cannot surface before A fully finishes
    assert rb.ttft_s > ra.latency_s
    _assert_drained_clean(eng)


# ---------------------------------------------------------------------------
# chaos: FaultPlan under the gateway
# ---------------------------------------------------------------------------

def test_gateway_streams_survive_fault_plan(tiny):
    """With seeded faults tripping decode and swap seams, every stream
    still reaches a terminal state (no wedged clients), failures carry a
    machine-readable reason, survivors stream token-for-token the
    fault-free closed-loop outputs, and the pool drains clean."""
    trace = _trace(6, seed=5, sampled=True)
    baseline = _reference(tiny, trace, **PAGED)
    plan = FaultPlan(seed=11, step={"prob": 0.2, "max_fires": 3},
                     swap_out={"prob": 0.3, "max_fires": 2})
    eng = _engine(tiny, fault_plan=plan, **PAGED)
    out = asyncio.run(_gw_run(eng, trace))

    assert set(out) == set(baseline)
    assert {r.status for r, _ in out.values()} <= {"done", "failed"}
    survivors = {rid for rid, (r, _) in out.items() if r.status == "done"}
    assert survivors, "chaos killed every request — schedule too harsh"
    for rid, (r, toks) in out.items():
        if rid in survivors:
            np.testing.assert_array_equal(toks, baseline[rid].output)
            np.testing.assert_array_equal(r.output, toks)
        else:
            assert r.failure_reason
    _assert_drained_clean(eng)


# ---------------------------------------------------------------------------
# the cascade behind the gateway
# ---------------------------------------------------------------------------

def test_cascade_streams_match_closed_loop():
    """Over ``CascadeServingEngine`` the gateway streams through both
    legs' taps, inner request ids translated to cascade ids: every stream
    equals the closed-loop cascade's output, on every route."""
    lm, _ = _model()
    cloud = LM(_tiny_cfg(), device="cpu")
    edge = LM(edge_variant(cloud.cfg, layers=1), device="cpu")
    ep, cp = edge.init(1), cloud.init(0)
    trace = _trace(8, seed=7, sampled=True)
    probe = CascadeServingEngine(CascadeLM(edge, cloud), ep, cp,
                                 batch_slots=2, max_seq_len=48)
    conf = sorted(probe._gate(it["prompt"])[0] for it in trace)
    cas = CascadeLM(edge, cloud, thresholds=make_thresholds(
        hi=(conf[4] + conf[5]) / 2, lo=(conf[1] + conf[2]) / 2))

    def build():
        return CascadeServingEngine(cas, ep, cp, batch_slots=2,
                                    max_seq_len=48, max_decode_steps=2)

    ref = build()
    for it in trace:
        ref.submit(it["prompt"], max_new_tokens=it["max_new"],
                   temperature=it["temperature"])
    base = ref.run()
    assert {r.route for r in base.values()} == {"accept", "escalate",
                                                "drop"}
    eng = build()
    out = asyncio.run(_gw_run(eng, trace))
    assert set(out) == set(base)
    for rid, (r, toks) in out.items():
        assert r.status == "done" and r.route == base[rid].route
        np.testing.assert_array_equal(toks, base[rid].output)
        np.testing.assert_array_equal(r.output, toks)
    assert not eng.pending
