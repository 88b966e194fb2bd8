"""Tensor-parallel serving of the port on a CPU mesh (gloo, one process a
rank), against the port's own one-device engine.

``tests/test_sharded_serving.py`` holds ``repro``'s engine on a forced
4-device host mesh against its single-device engine; that matrix fails in
this container, so the oracle here is the port's ``mesh=None`` path, and
the weights are ``repro``'s ``LM.init`` carried over by
``bridge.params_from_numpy`` (this rank's shards with ``mesh=``), so the
model is also held against ``repro``'s at the logits. Each rank runs both
engines on the same trace; the parent checks that every rank committed the
same tokens, bit for bit, and that the mesh streams equal the one-device
streams or part first at a near-tie of the teacher-forced logits (within
the f32 tolerance). ``assert_invariants`` after every run checks the cache
placement and the ranks' lockstep.

The rank workers import only torch, numpy and ``repro_torch``; JAX runs in
the parent alone.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TOL = 1e-4           # f32: top-2 margin below which two paths may part
VOCAB = 256


def _cfg(heads: int, kv: int, layers: int, name: str = "shard-test"):
    from repro_torch.configs.base import ModelConfig, dense_stages
    return ModelConfig(name=name, family="dense", source="test",
                       num_layers=layers, d_model=64, num_heads=heads,
                       num_kv_heads=kv, head_dim=16, d_ff=128,
                       vocab_size=VOCAB, stages=dense_stages(layers),
                       param_dtype="float32")


def _repro_tree(cfg, seed: int):
    """``repro``'s ``LM.init`` for ``cfg`` (the port's config copy) as a
    numpy tree."""
    import dataclasses

    import jax
    from repro.configs.base import ModelConfig, Stage
    from repro.configs.base import BlockDef as RBlockDef
    from repro.models.model import LM as RLM

    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["stages"] = tuple(
        Stage(blocks=tuple(RBlockDef(**dataclasses.asdict(b))
                           for b in st.blocks), repeat=st.repeat)
        for st in cfg.stages)
    for key in ("mla", "moe", "frontend"):
        fields.pop(key, None)
    rcfg = ModelConfig(**fields)
    params, _ = RLM(rcfg, kv_chunk=32).init(jax.random.PRNGKey(seed))
    return rcfg, jax.tree.map(np.asarray, params)


def _trace(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, size=4 + i % 7).astype(np.int32),
             5 + i % 4, 0.0 if i % 2 else 0.8) for i in range(6)]


# -- rank workers (spawned: module-level, no JAX) ------------------------------

def _setup(rank, tree, cfg):
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM

    mesh = make_host_mesh(torch.distributed.get_world_size())
    lm = LM(cfg, device="cpu")
    full = params_from_numpy(tree, cfg, device="cpu")
    local = params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
    return mesh, lm, full, local


def _serve(eng, reqs):
    ids = [eng.submit(p, max_new_tokens=m, temperature=t)
           for p, m, t in reqs]
    done = eng.run()
    eng.assert_invariants()
    return {str(i): done[i].output.tolist() for i in ids
            if done[i].status == "done"}


def _dump(out_dir, rank, rec) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def matrix_worker(rank, out_dir, tree, dtree, cfg, dcfg, reqs):
    """``tests/test_sharded_serving.py``'s matrix on this rank."""
    from repro_torch.models.model import LM
    from repro_torch.serving import FaultPlan, ServingEngine

    mesh, lm, full, local = _setup(rank, tree, cfg)
    dlm = LM(dcfg, device="cpu")
    from repro_torch.bridge import params_from_numpy
    dfull = params_from_numpy(dtree, dcfg, device="cpu")

    def mk(m, backend, *, spec=False, k=1, faults=None, params=None):
        kw = dict(draft_model=dlm, draft_params=dfull,
                  speculative_tokens=3) if spec else {}
        p = params if params is not None else (full if m is None else local)
        return ServingEngine(lm, p, batch_slots=3, max_seq_len=64,
                             cache_backend=backend, mesh=m, seed=0,
                             max_decode_steps=k, fault_plan=faults, **kw)

    rec = {"mesh": {}, "none": {}}
    for backend in ("ring", "paged"):
        for k in (1, 4):
            key = f"{backend}_k{k}"
            rec["none"][key] = _serve(mk(None, backend, k=k), reqs)
            # the ring leg hands the engine the whole params to place
            rec["mesh"][key] = _serve(mk(mesh, backend, k=k, params=full
                                         if backend == "ring" else None),
                                      reqs)
    rec["none"]["speculative"] = _serve(mk(None, "paged", spec=True), reqs)
    rec["mesh"]["speculative"] = _serve(mk(mesh, "paged", spec=True), reqs)
    for m, side in ((None, "none"), (mesh, "mesh")):
        rec[side]["faults"] = _serve(mk(m, "paged", faults=FaultPlan(
            seed=3, step=[1], swap_out=[0])), reqs)
    # a snapshot taken on the mesh restores onto the mesh and onto
    # mesh=None, token-exact against the uninterrupted run
    base = _serve(mk(None, "paged"), reqs)
    donor = mk(mesh, "paged")
    for p, m, t in reqs:
        donor.submit(p, max_new_tokens=m, temperature=t)
    for _ in range(4):
        donor.step()
    snap = donor.snapshot()
    for name, tmesh in (("restore_on_mesh", mesh), ("restore_on_none", None)):
        cold = mk(tmesh, "paged")
        cold.restore(snap)
        done = cold.run()
        cold.assert_invariants()
        got = {str(r.request_id): r.output.tolist() for r in done.values()}
        rec[name] = got == base
    rec["kv_bytes"] = _kv_bytes(mk(mesh, "paged"))
    rec["kv_bytes_ring"] = _kv_bytes(mk(mesh, "ring"))
    _dump(out_dir, rank, rec)


def _kv_bytes(eng):
    """(this rank's K/V bytes, its position bytes, the global pool bytes,
    ``hbm_bytes_per_device()``, ``mesh_devices``)."""
    from repro_torch.serving.kv_cache import _leaves
    kv = pos = 0
    for key, t in _leaves(eng._cache_state["caches"]):
        n = t.numel() * t.element_size()
        if key in ("k", "v"):
            kv += n
        else:
            pos += n
    return [kv, pos, eng.hbm_bytes(), eng.hbm_bytes_per_device(),
            eng.metrics()["mesh_devices"]]


def replicated_worker(rank, out_dir, tree, cfg, etree, ecfg, reqs):
    """8 query heads over 2 KV heads on 4 ranks (each rank's 2 query heads
    read one KV head of a pool every rank keeps whole), on both backends,
    and the generative cascade on the same mesh; then what the mesh
    refuses by architecture (nothing: every assigned architecture's plan,
    and ring engines of the reduced recurrent models)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.cascade.ecc_infer import CascadeLM
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.models.model import LM
    from repro_torch.serving import CascadeServingEngine, ServingEngine
    from repro_torch.sharding import tensor_parallel

    mesh, lm, full, local = _setup(rank, tree, cfg)
    rec = {"mesh": {}, "none": {}, "kv_range":
           list(tensor_parallel(cfg, mesh).kv_range)}
    for backend in ("ring", "paged"):
        for k in (1, 4):
            key = f"{backend}_k{k}"
            for m, side, p in ((None, "none", full), (mesh, "mesh", local)):
                eng = ServingEngine(lm, p, batch_slots=3, max_seq_len=64,
                                    cache_backend=backend, mesh=m, seed=0,
                                    max_decode_steps=k)
                rec[side][key] = _serve(eng, reqs)
    rec["kv_bytes"] = _kv_bytes(eng)
    edge = LM(ecfg, device="cpu")
    efull = params_from_numpy(etree, ecfg, device="cpu")
    # random weights are not calibrated: accept at the median of the
    # edge's own confidences, so both legs serve
    probe = CascadeServingEngine(CascadeLM(edge, lm), efull, full,
                                 batch_slots=3, max_seq_len=64)
    hi = float(np.median([probe._gate(p)[0] for p, _, _ in reqs]))
    for m, side in ((None, "none"), (mesh, "mesh")):
        cas = CascadeLM(edge, lm, thresholds=make_thresholds(hi=hi, lo=0.0))
        eng = CascadeServingEngine(cas, efull, full, batch_slots=3,
                                   max_seq_len=64, cache_backend="paged",
                                   mesh=m)
        ids = [eng.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]
        done = eng.run()
        for leg in (eng.edge_engine, eng.cloud_engine):
            leg.assert_invariants()
        rec[side]["cascade"] = {str(i): [done[i].route,
                                         done[i].output.tolist()]
                                for i in ids}
    refused = {}
    for name in ASSIGNED_ARCHS:
        for c in (get_config(name), get_config(name).reduced()):
            try:
                tensor_parallel(c, mesh)
            except NotImplementedError as e:
                refused[c.name] = str(e)
    for name in ("recurrentgemma-9b", "xlstm-125m"):
        big = LM(get_config(name).reduced(), device="cpu")
        try:
            ServingEngine(big, big.init(0, mesh=mesh), batch_slots=2,
                          max_seq_len=32, mesh=mesh).assert_invariants()
        except NotImplementedError as e:
            refused[name] = str(e)
    rec["refused"] = refused
    _dump(out_dir, rank, rec)


def gather_worker(rank, out_dir):
    """``HostMesh.gather`` by both of its forms (NCCL's all-gather runs on
    gloo's CPU tensors too, so the backend name picks the form here) and
    ``broadcast_object`` on its own host group."""
    from repro_torch.launch.mesh import COLLECTIVES, make_host_mesh, tally

    mesh = make_host_mesh(4)
    rec = {"host_group_own": mesh._host is not mesh.group}
    for backend in ("gloo", "nccl"):
        mesh.backend = backend
        before = dict(COLLECTIVES)
        got = []
        for shape, dim in (((3, 1, 5), -1), ((3, 1, 5), 0), ((2, 3), 1)):
            x = torch.arange(int(np.prod(shape)), dtype=torch.float32)
            x = (x.reshape(shape) + 20 * rank).to(torch.bfloat16)
            y = mesh.gather(x, dim)
            got.append([str(y.dtype), y.float().tolist()])
        got.append(mesh.gather(torch.tensor([7 + rank]), 0).tolist())
        rec[backend] = {"got": got,
                        "counts": tally(COLLECTIVES, before=before)}
    rec["broadcast"] = mesh.broadcast_object(
        {"stop": True} if rank == 0 else None)
    _dump(out_dir, rank, rec)


# -- the parent ----------------------------------------------------------------

def _spawn(tmp_path, fn, args, nprocs=4, timeout_s=150.0):
    """Run ``fn`` on ``nprocs`` gloo ranks; returns the ranks' records."""
    from repro_torch.launch.mesh import spawn
    out = tmp_path / "out"
    out.mkdir()
    spawn(fn, nprocs, args=(str(out),) + tuple(args),
          rendezvous=f"file://{tmp_path / 'rendezvous'}",
          timeout_s=timeout_s)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nprocs)]


def _ranks_agree(recs):
    """Every rank committed the same tokens (and saw the same results)."""
    for r, rec in enumerate(recs[1:], 1):
        assert rec == recs[0], f"rank {r} differs from rank 0"


def _near_tie_streams(lm, params, reqs, mesh_out, base, seed=0):
    """Each mesh stream equals the one-device stream, or parts first where
    the teacher-forced one-device logits' top-2 margin is within ``TOL``
    (of logits / T plus that step's Gumbel noise for a sampled request).
    Returns the count that parted."""
    from repro_torch.serving.sampler import gumbel, prng_key, request_keys
    parted = 0
    assert set(mesh_out) == set(base)
    for rid, got in mesh_out.items():
        want = base[rid]
        if got == want:
            continue
        p = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        prompt, _, temp = reqs[int(rid)]
        ctx = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(want[:p], np.int32)]).astype(np.int32))[None]
        last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
        x, tol = last[0, 0].float(), TOL
        if temp > 0:
            i32 = dict(dtype=torch.int32)
            key = request_keys(prng_key(seed), torch.tensor([int(rid)], **i32),
                               torch.tensor([p], **i32))
            x, tol = x / temp + gumbel(key, x.shape)[0], TOL / temp
        top2 = torch.topk(x, 2).values
        assert (top2[0] - top2[1]).item() <= tol, (
            f"request {rid}: the mesh stream parts from mesh=None at token "
            f"{p}, top-2 margin {(top2[0] - top2[1]).item():.3g} > {tol}")
        parted += 1
    return parted


def _port(cfg, tree):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.model import LM
    return LM(cfg, device="cpu"), params_from_numpy(tree, cfg, device="cpu")


def test_sharded_serving_matrix_on_four_ranks(tmp_path):
    """Ring and paged at K = 1 and 4, speculative, faults, a mesh snapshot
    restored onto the mesh and onto ``mesh=None``, and the per-device K/V
    bytes, on a 4-way mesh of d 64, 4 heads, 4 KV heads (each rank one
    head, one KV head)."""
    cfg, dcfg = _cfg(4, 4, 2), _cfg(4, 4, 1, "shard-draft")
    rcfg, tree = _repro_tree(cfg, 0)
    _, dtree = _repro_tree(dcfg, 1)
    reqs = _trace()
    # the bridged model is repro's at the logits
    import jax
    import jax.numpy as jnp
    from repro.models.model import LM as RLM
    lm, params = _port(cfg, tree)
    tokens = np.stack([np.resize(p, 12) for p, _, _ in reqs[:3]])
    ref, _, _, _ = RLM(rcfg, kv_chunk=32).forward(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    ours, _ = lm.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)

    recs = _spawn(tmp_path, matrix_worker, (tree, dtree, cfg, dcfg, reqs))
    _ranks_agree(recs)
    rec = recs[0]
    for key, got in rec["mesh"].items():
        _near_tie_streams(lm, params, reqs, got, rec["none"][key])
    assert rec["restore_on_mesh"] and rec["restore_on_none"]
    kv, pos, whole, per_dev, devices = rec["kv_bytes"]
    assert devices == 4 and per_dev == kv + pos
    assert kv * 4 + pos == whole          # K/V 1/4 a device, positions whole
    kv, pos, whole, per_dev, _ = rec["kv_bytes_ring"]
    assert per_dev == kv + pos and kv * 4 + pos == whole


def test_replicated_kv_and_cascade_on_four_ranks(tmp_path):
    """8 heads over 2 KV heads on 4 ranks: the KV heads do not divide, so
    every rank keeps both and its 2 query heads attend one of them
    (``kv_range``); the pool is whole on every rank. Then the generative
    cascade with both legs on the mesh, and no refusal by architecture:
    every assigned architecture's plan, whole and reduced, and the
    reduced recurrent models' ring engines on the mesh."""
    cfg, ecfg = _cfg(8, 2, 2), _cfg(8, 2, 1, "shard-edge")
    _, tree = _repro_tree(cfg, 0)
    _, etree = _repro_tree(ecfg, 1)
    reqs = _trace(1)
    recs = _spawn(tmp_path, replicated_worker, (tree, cfg, etree, ecfg,
                                                reqs))
    assert [r["kv_range"] for r in recs] == [[0, 1], [0, 1], [1, 1], [1, 1]]
    for r in recs:
        del r["kv_range"]
    _ranks_agree(recs)
    rec = recs[0]
    lm, params = _port(cfg, tree)
    for key, got in rec["mesh"].items():
        if key == "cascade":
            continue
        _near_tie_streams(lm, params, reqs, got, rec["none"][key])
    assert rec["mesh"]["cascade"] == rec["none"]["cascade"]
    routes = {route for route, _ in rec["mesh"]["cascade"].values()}
    assert routes == {"accept", "escalate"}, routes
    kv, pos, whole, per_dev, devices = rec["kv_bytes"]
    assert devices == 4 and per_dev == whole == kv + pos  # nothing splits
    assert rec["refused"] == {}


def test_gather_forms_join_rank_slices_in_order(tmp_path):
    """Both forms of ``HostMesh.gather`` (the all-gather the card's NCCL
    meshes capture, the zero-filled all-reduce gloo takes) give every rank
    the slices joined in rank order, exact and in the input's dtype;
    ``broadcast_object`` travels on a group of its own."""
    recs = _spawn(tmp_path, gather_worker, (), timeout_s=60.0)
    want = []
    for shape, dim in (((3, 1, 5), -1), ((3, 1, 5), 0), ((2, 3), 1)):
        base = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(
            shape)
        want.append(["torch.bfloat16", np.concatenate(
            [base + 20 * r for r in range(4)], dim).tolist()])
    want.append([7, 8, 9, 10])
    for rec in recs:
        assert rec["host_group_own"] and rec["broadcast"] == {"stop": True}
        assert rec["gloo"]["got"] == want and rec["nccl"]["got"] == want
        assert rec["gloo"]["counts"] == {"all_reduce": 4, "all_gather": 0,
                                         "broadcast": 0, "reduce_scatter": 0}
        assert rec["nccl"]["counts"] == {"all_reduce": 0, "all_gather": 4,
                                         "broadcast": 0, "reduce_scatter": 0}


def test_mesh_none_is_unchanged():
    """``mesh=None`` launches no collective and registers the same
    programs; ``mesh_devices`` is 1 and the per-device bytes are the
    global bytes."""
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine

    cfg = _cfg(2, 2, 1, "shard-nomesh")
    lm = LM(cfg, device="cpu")
    params = lm.init(0)
    eng = ServingEngine(lm, params, batch_slots=2, max_seq_len=32,
                        min_bucket=8, cache_backend="paged", block_size=8,
                        max_decode_steps=4)
    assert eng.mesh is None
    before = dict(COLLECTIVES)
    eng.warm_compile()
    keys = set(eng._programs)
    assert keys == set(eng.program_keys())
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(rng.integers(0, 128, size=4 + i), max_new_tokens=4,
                   temperature=0.5 * i)
    done = eng.run()
    assert all(r.status == "done" for r in done.values())
    assert set(eng._programs) == keys and eng.graphs() == 0
    assert COLLECTIVES == before
    m = eng.metrics()
    assert m["mesh_devices"] == 1
    assert eng.hbm_bytes_per_device() == eng.hbm_bytes()
    assert eng.backend.kv_shards == 1
    eng.assert_invariants()


def test_serve_launcher_mesh_two_on_cpu():
    """``launch/serve.py --mesh 2 --device cpu --hang-demo``: two gloo
    ranks, rank 0's gateway, journal and watchdog; the stall rolls back
    in-process, snapshots gather the KV heads every step, all done. With
    ``--wedge-demo`` the stall outlasts the grace window: both ranks
    rebuild their engines, the restart recovers from the snapshot and the
    journal, and its drain finishes every request."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mesh", "2",
         "--device", "cpu", "--requests", "4", "--max-new", "4", "--quiet",
         "--hang-demo", "--step-timeout", "1", "--snapshot-every", "1"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'watchdog_timeouts': 1" in out.stdout, out.stdout
    assert "'hang_recoveries': 1" in out.stdout, out.stdout
    assert "{'done': 4}" in out.stdout, out.stdout
    assert "'snapshots_taken': 0" not in out.stdout, out.stdout
    wedged = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mesh", "2",
         "--device", "cpu", "--requests", "4", "--max-new", "4", "--quiet",
         "--wedge-demo", "--step-timeout", "3", "--hang-grace", "0.5",
         "--snapshot-every", "1"],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert wedged.returncode == 0, wedged.stderr[-3000:]
    assert "engine wedged" in wedged.stdout, wedged.stdout
    assert "post-restart drain: {'done': 4}" in wedged.stdout, wedged.stdout
    assert "'restarts': 1" in wedged.stdout, wedged.stdout
