"""A supervised restart on a mesh: a wedged step, every rank's engine
written off and rebuilt on the same mesh, and recovery from rank 0's
snapshot and journal.

Two gloo worlds are spawned once each for the module: a (1, 2) mesh on
the paged backend and a (2, 2) mesh of four ranks on the ring backend,
both serving the reduced qwen3-4b in f32. Each rank first serves the trace
uninterrupted on the mesh (every rank making the same calls), then again
through rank 0's ``ServingGateway`` over a ``MeshLeader``, with a journal,
a snapshot every step and a 3 s watchdog, while every rank's fault plan
stalls step 2 past the grace window. After ``EngineWedgedError``,
``MeshLeader.rebuild`` and ``follow``'s ``rebuild`` callable replace each
rank's engine; each callable first checks that a weak reference to the
written-off engine is dead. ``recover_engine`` over the leader restores
the newest snapshot on every rank and replays the journal through the
logged ``requeue_lost``, and ``MeshLeader.run`` drains. The parent holds
the one-device rule of ``tests/test_torch_crash_restart.py::
test_wedge_supervised_restart_loses_nothing``: no acknowledged request
lost, every stream token-exact against the same mesh's uninterrupted run,
and equal to ``mesh=None``'s or parted first at a near-tie.

The watchdog's count depends on the host's load, so it is held at one or
more, never at an exact number; the drain after the restart runs without
a watchdog, so at most one wedge occurs. The rank workers import only
torch, numpy and ``repro_torch``.
"""
import asyncio
import pickle
import weakref

import pytest
import torch
from test_torch_data_mesh import _dump, _near_tie, _reduced, _spawn, _trace

STEP_TIMEOUT_S = 3.0
GRACE = 0.5
HANG_S = STEP_TIMEOUT_S * (1 + GRACE) + 1.0
MESHES = {"1x2": (2, 2, "paged"), "2x2": (2, 4, "ring")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the other mesh tests run their parents."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_factory(mesh, backend):
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    lm = LM(_reduced("qwen3-4b"), device="cpu")
    full = lm.init(0)
    kw = (dict(cache_backend="paged", block_size=8, chunk_tokens=8)
          if backend == "paged" else {})

    def build(plan=None, on=mesh):
        return ServingEngine(lm, full, batch_slots=3, max_seq_len=48,
                             min_bucket=8, seed=0, mesh=on,
                             max_decode_steps=4, fault_plan=plan, **kw)
    return build


def _checked(build, ref, released):
    """``build``, once the engine ``ref`` points at is gone."""
    def rebuild():
        released.append(ref() is None)
        return build()
    return rebuild


async def _gateway_run(gw, reqs, out):
    """Submit the trace in order, then read every stream into ``out``:
    {rid: (status, streamed tokens)}."""
    handles = [await gw.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]

    async def read(h):
        toks = [int(x) async for x in h.stream()]
        out[str(h.request_id)] = ((await h.result()).status, toks)

    await asyncio.gather(*(read(h) for h in handles))


def _leader_side(mesh, build, reqs, state_dir):
    """Rank 0: the gateway run that wedges, then the restart."""
    from repro_torch.serving import (EngineWedgedError, FaultPlan,
                                     MeshLeader, RequestJournal,
                                     ServingGateway, recover_engine)

    journal = RequestJournal(f"{state_dir}/journal.jsonl")
    snaps = f"{state_dir}/snapshots"
    eng = build(FaultPlan(seed=0, hang=[2], hang_s=HANG_S))
    ref = weakref.ref(eng)
    leader = MeshLeader(eng, mesh)
    del eng
    leader.warm_compile()
    gw = ServingGateway(leader, journal=journal, snapshot_dir=snaps,
                        snapshot_every=1, step_timeout_s=STEP_TIMEOUT_S,
                        hang_grace=GRACE)
    before, wedged = {}, False

    async def main():
        async with gw:
            await _gateway_run(gw, reqs, before)

    try:
        asyncio.run(main())
    except EngineWedgedError:
        wedged = True
    stats = gw.stats()
    released = []
    leader.rebuild(_checked(build, ref, released))
    leader.warm_compile()
    info = recover_engine(leader, snapshot_dir=snaps, journal=journal)
    done = leader.run()
    leader.assert_invariants()
    leader.stop()
    journal.close()
    return dict(wedged=wedged, released=released,
                watchdog_timeouts=stats["watchdog_timeouts"],
                snapshots_taken=stats["snapshots_taken"],
                restored=info["restored"], replayed=info["replayed"],
                before=before,
                after={str(rid): [r.status, r.output.tolist()]
                       for rid, r in done.items()})


def sup_worker(rank, out_dir, model, backend, reqs):
    """This rank of a (world / model, model) mesh: the uninterrupted run,
    ``mesh=None``'s on rank 0, then the wedge and the restart."""
    import tempfile

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import FaultPlan, follow

    torch.set_num_threads(1)
    mesh = make_host_mesh(model)
    build = _engine_factory(mesh, backend)
    rec = {}
    for side, on in (("mesh", mesh), ("none", None)):
        if on is None and mesh.rank:
            continue
        eng = build(on=on)
        ids = [eng.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]
        done = eng.run()
        eng.assert_invariants()
        rec[side] = {str(i): done[i].output.tolist() for i in ids}
    if mesh.rank == 0:
        with tempfile.TemporaryDirectory() as state_dir:
            rec.update(_leader_side(mesh, build, reqs, state_dir))
    else:
        box = [build(FaultPlan(seed=0, hang=[2], hang_s=HANG_S))]
        released = []
        ref = weakref.ref(box[0])
        follow(box.pop(), mesh, rebuild=_checked(build, ref, released))
        rec["released"] = released
    _dump(out_dir, rank, rec)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    reqs = _trace(_reduced("qwen3-4b").vocab_size, seed=5)
    return {name: (_spawn(tmp_path_factory.mktemp(name), sup_worker,
                          (model, backend, reqs), ranks), reqs)
            for name, (model, ranks, backend) in MESHES.items()}


@pytest.mark.parametrize("name", list(MESHES))
def test_wedged_mesh_restarts_and_loses_nothing(worlds, name):
    """The watchdog declared the engine wedged; the restart recovered it
    from a snapshot; every acknowledged request finished, each stream
    token-exact against the same mesh's uninterrupted run and equal to
    ``mesh=None``'s or parted first at a near-tie."""
    from repro_torch.models.model import LM

    recs, reqs = worlds[name]
    lead = recs[0]
    assert lead["wedged"], "the hang seam never wedged the engine"
    assert lead["watchdog_timeouts"] >= 1
    assert lead["snapshots_taken"] >= 1
    assert lead["restored"]["live"] > 0 and lead["after"]
    for rec in recs[1:]:
        assert rec["mesh"] == lead["mesh"]
    got = {}
    for rid, (status, toks) in lead["before"].items():
        if status == "done":
            got[rid] = toks
    for rid, (status, out) in lead["after"].items():
        assert status == "done", (rid, status)
        assert rid not in got, rid
        got[rid] = out
    assert sorted(got, key=int) == [str(i) for i in range(len(reqs))]
    assert got == lead["mesh"]
    lm = LM(_reduced("qwen3-4b"), device="cpu")
    _near_tie(lm, lm.init(0), reqs, got, lead["none"])


@pytest.mark.parametrize("name", list(MESHES))
def test_every_rank_releases_its_wedged_engine_before_the_rebuild(worlds,
                                                                   name):
    """Each rank built its fresh engine once, and only after a weak
    reference to its written-off engine had died."""
    recs, _ = worlds[name]
    assert [rec["released"] for rec in recs] == [[True]] * len(recs)


class _StubMesh:
    """A mesh of two ranks seen from one, replaying a given message
    queue (``follow``) or recording what rank 0 sends (``MeshLeader``)."""

    rank = 1
    device = torch.device("cpu")

    def __init__(self, inbox=()):
        self.inbox, self.sent = list(inbox), []

    def broadcast_object(self, obj=None):
        if obj is not None:
            self.sent.append([pickle.loads(b)[0] for b in obj])
            return obj
        return self.inbox.pop(0)


def _records(*names):
    return [pickle.dumps((n, (), {})) for n in names]


def test_follow_without_a_rebuild_callable_raises():
    """A rebuild record never goes unanswered: ``follow`` with no callable
    raises and says why."""
    from repro_torch.serving import follow

    class Engine:
        steps = 0

        def step(self):
            self.steps += 1

    eng = Engine()
    mesh = _StubMesh([_records("step"), _records("rebuild")])
    with pytest.raises(RuntimeError, match="no rebuild callable"):
        follow(eng, mesh)
    assert eng.steps == 1


def test_follow_rebuilds_and_follows_the_fresh_engine():
    """After a rebuild record, the calls go to the engine the callable
    built, and the old one is gone before that call."""
    from repro_torch.serving import follow

    class Engine:
        def __init__(self):
            self.calls = []

        def step(self):
            self.calls.append("step")

    built, seen = [], []
    box = [Engine()]
    ref = weakref.ref(box[0])

    def rebuild():
        seen.append(ref() is None)
        built.append(Engine())
        return built[-1]

    mesh = _StubMesh([_records("step", "rebuild", "step"),
                      _records("step", "stop")])
    follow(box.pop(), mesh, rebuild=rebuild)
    assert seen == [True] and built[0].calls == ["step", "step"]


def test_leader_logs_requeue_lost_runs_by_broadcast_and_rebuilds():
    """``requeue_lost`` reaches the followers with the next broadcast;
    ``run`` broadcasts a step until nothing is pending; ``rebuild`` sends
    the rebuild record alone (calls logged for the old engine are dropped)
    and releases the old engine before ``build``."""
    from repro_torch.serving import MeshLeader

    class Engine:
        def __init__(self, steps):
            self.left, self.queued = steps, []

        @property
        def pending(self):
            return self.left > 0

        def requeue_lost(self, rid, prompt, **kw):
            self.queued.append(rid)

        def step(self):
            self.left -= 1

        def take_done(self):
            return {}

        def cancel(self, rid):
            return True

    mesh = _StubMesh()
    leader = MeshLeader(Engine(2), mesh)
    leader.requeue_lost(7, [1, 2], max_new_tokens=3)
    assert leader.run() == {}
    assert mesh.sent == [["requeue_lost", "step"], ["step"]]
    ref = weakref.ref(leader._engine)
    seen = []
    leader.cancel(7)

    def build():
        seen.append(ref() is None)
        return Engine(1)

    leader.rebuild(build)
    assert mesh.sent[-1] == ["rebuild"] and seen == [True]
    leader.run()
    assert mesh.sent[-1] == ["step"] and not leader.pending
