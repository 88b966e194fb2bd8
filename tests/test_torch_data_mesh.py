"""The data axis of the port's mesh: placement against ``repro``'s rules,
the rank grid, and serving on (data, model) meshes over gloo.

Placement is spec-only: at (2, 1), (2, 2), (4, 1) and (2, 4) the port's
per-leaf split under the decode and the train rules equals ``repro``'s
``param_pspecs`` on ``jax.sharding.AbstractMesh((D, M), ("data",
"model"))`` for every assigned architecture, and ``opt_pspecs`` and
``batch_pspecs`` equal ``repro``'s; ``TensorParallel``'s data fields
follow the resolved specs. Two gloo worlds are spawned once for the
module (4 ranks as (2, 2), 2 ranks as (2, 1)) and shared by its cases:
the rank layout and each axis' group; the collectives by axis; the
sharded ``LM.init`` equal to ``place_params`` of the whole init, bit for
bit; every mixer family (GQA, MLA, MoE, RG-LRU, mLSTM, sLSTM) and both
frontends through ``LM`` (a right-padded prefill, then a decode step)
against the port's ``mesh=None`` within ``TOL`` (f32: the same sums in
another order); and on (2, 2) the ring, paged and cascade engines, whose
four ranks commit equal streams that equal ``mesh=None``'s or part first
at a near-tie (also with a draft on the mesh and with a fault plan), and
snapshots crossing between (2, 2) and ``mesh=None`` both ways.

The rank workers import only torch, numpy and ``repro_torch``; JAX runs in
the parent alone.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

TOL = 1e-5           # f32, relative to the output's largest magnitude
TIE = 1e-4           # f32: a top-2 margin below which two paths may part
ARCHS = ("recurrentgemma-9b", "qwen3-4b", "smollm-135m", "xlstm-125m",
         "mixtral-8x22b", "starcoder2-7b", "deepseek-v3-671b",
         "musicgen-medium", "glm4-9b", "internvl2-2b")
SHAPES = ((2, 1), (2, 2), (4, 1), (2, 4))
# one model of each mixer family and frontend
FAMILIES = {"gqa": "qwen3-4b", "mla": "deepseek-v3-671b",
            "moe": "mixtral-8x22b", "rglru": "recurrentgemma-9b",
            "xlstm": "xlstm-125m", "vision": "internvl2-2b",
            "audio": "musicgen-medium"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(name: str):
    """The port's reduced config of ``name`` in f32."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(),
                               param_dtype="float32")


def _dropless(cfg) -> float:
    return (cfg.moe.num_experts / cfg.moe.num_experts_per_tok
            if cfg.moe else 1.25)


def _trace(vocab: int, seed: int = 0, n: int = 6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=3 + 3 * i % 13).astype(np.int32),
             4 + i % 3, 0.0 if i % 3 else 0.7) for i in range(n)]


# -- placement (spec-only) ----------------------------------------------------

def _flat(tree, pre=""):
    """{path: leaf} over nested dicts and lists, paths spelled as
    ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}[{i}]"))
        return out
    return {pre: tree}


@functools.lru_cache(maxsize=None)
def _abstract(name):
    from repro.configs import get_config as repro_config
    from repro.models.model import LM as RLM
    return RLM(repro_config(name)).abstract()


def _repro_specs(name, data, model, mode):
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.launch.sharding_rules import param_pspecs

    abstract, axes = _abstract(name)
    ref = param_pspecs(AbstractMesh((data, model), ("data", "model")),
                       abstract, axes, mode=mode)
    return {jax.tree_util.keystr(p): tuple(v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


@pytest.mark.parametrize("mode", ["decode", "train"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_param_pspecs_match_repro_on_a_data_axis(name, shape, mode):
    """Every leaf's spec at (D, M) under ``mode``'s rules is ``repro``'s;
    in decode ``TensorParallel``'s data fields say what the specs cut on
    'data': d_model's contraction side of the norms, the tables and every
    input projection, the routed experts over ("data", "model") (their
    range the rank's place in the mesh), and none of them on a data-1
    mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import param_shardings
    from repro_torch.sharding import tensor_parallel

    data, model = shape
    cfg = get_config(name)
    got = _flat(param_shardings(AbstractMesh(model, data),
                                LM(cfg, device="cpu"), mode))
    assert got == _repro_specs(name, data, model, mode)
    if mode == "train":
        return
    tp = tensor_parallel(cfg, AbstractMesh(model, data))
    assert (tp.data_ways, tp.data_rank, tp.ways) == (data, 0, model)
    assert tp.data_norm == (got["['final_norm']['scale']"] == ("data",))
    assert tp.data_table == (got["['embed']['table']"][-1] == "data")
    firsts = {v[1] for k, v in got.items() if k.startswith("['stages']")
              and k.split("]")[-2] in ("['wq'", "['w_dq'", "['w_in_x'",
                                       "['wx'")
              and "['mixer']" in k}
    assert firsts == {"data"} and tp.data_proj
    if cfg.moe is not None:
        w_gate = {v for k, v in got.items() if k.endswith(
            "['mlp']['w_gate']") and "shared" not in k and len(v) == 4}
        assert tp.data_experts == ({v[1] for v in w_gate}
                                   == {("data", "model")})
        assert tp.expert_data_in == ({v[2] for v in w_gate} == {"data"})
        per = cfg.moe.num_experts // (data * model)
        assert tp.expert_range == ((0, per) if tp.experts
                                   else (0, cfg.moe.num_experts))
    if cfg.frontend.kind == "vision":
        assert tp.data_vision == (got["['vision_proj']['w1']"][1] == "data")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_opt_and_batch_pspecs_match_repro(shape):
    """``opt_pspecs`` shards AdamW's moments like their params (ZeRO) and
    keeps the step whole; ``batch_pspecs`` splits a leading dim over
    'data' when it divides."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.launch import sharding_rules as rsr
    from repro.optim import adamw_init as r_adamw_init
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding_rules as tsr

    data, model = shape
    rmesh = AbstractMesh((data, model), ("data", "model"))
    specs = {"a": PartitionSpec("data", None), "b": PartitionSpec()}
    params = {"a": jnp.zeros((4, 2)), "b": jnp.zeros(3)}
    ropt = rsr.opt_pspecs(rmesh, specs, r_adamw_init(params))
    tspecs = {"a": ("data", None), "b": ()}
    topt = tsr.opt_pspecs(tmesh.AbstractMesh(model, data), tspecs)
    assert tuple(ropt.step) == topt.step == ()
    assert {k: tuple(v) for k, v in ropt.mu.items()} == topt.mu == topt.nu
    shapes = {"tokens": (8, 16), "labels": (8, 16), "odd": (3, 5),
              "scalar": ()}
    rb = rsr.batch_pspecs(rmesh, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                  for k, s in shapes.items()})
    tb = tsr.batch_pspecs(tmesh.AbstractMesh(model, data),
                          {k: np.zeros(s, np.int32)
                           for k, s in shapes.items()})
    assert set(tb) == set(rb)
    for k in shapes:
        want = tuple(rb[k]) + (None,) * (len(shapes[k]) - len(rb[k]))
        assert tb[k] == want, k


@pytest.mark.parametrize("argv, world", [
    (["--mesh", "2", "--device", "cpu"], 2),
    (["--mesh", "2", "--world", "4", "--device", "cpu"], 4),
    (["--mesh", "4", "--world", "8", "--device", "cpu"], 8),
    (["--mesh", "2", "--world", "3", "--device", "cpu"], "does not divide"),
    (["--mesh", "2", "--world", "4"], "under NCCL the world is the visible"),
    (["--world", "4", "--device", "cpu"], "--mesh 1 serves on one device"),
])
def test_serve_mesh_world(monkeypatch, argv, world):
    """``serve --mesh N``'s world: on gloo ``--world`` ranks (default N),
    under NCCL the visible cards (``--world`` refused), and N must divide
    it; the mesh is (world / N, N). ``--mesh 1`` serves on one device, as
    ``repro``'s does, so ``--world`` there is refused."""
    from repro_torch.launch import serve as tserve

    spawned = []
    monkeypatch.setattr(tserve, "spawn", lambda fn, n, args, backend:
                        spawned.append((n, backend)))
    if isinstance(world, str):
        with pytest.raises(SystemExit, match=world):
            tserve.main(argv)
        assert spawned == []
    else:
        tserve.main(argv)
        assert spawned == [(world, "gloo")]


# -- rank workers (spawned: module-level, no JAX) -----------------------------

def _dump(out_dir, rank, rec) -> None:
    import os
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _layout(mesh):
    """Each axis' sum, gather and shard of the ranks' numbers, and the
    collectives they issue, by axis."""
    from repro_torch.launch.mesh import COLLECTIVES, tally

    me = torch.tensor([float(mesh.rank)])
    before = dict(COLLECTIVES)
    out = {"place": [mesh.rank, mesh.data_rank, mesh.model_rank],
           "shape": dict(mesh.shape)}
    for axis in ("model", "data", "world"):
        out[f"sum_{axis}"] = mesh.all_reduce(me.clone(), axis=axis).item()
        out[f"gather_{axis}"] = mesh.gather(me, 0, axis=axis).tolist()
        rows = torch.arange(mesh.axis_size(axis) * 2.0).reshape(-1, 2)
        out[f"shard_{axis}"] = mesh.shard(rows, 0, axis=axis).tolist()
    out["reduce_scatter"] = mesh.reduce_scatter(
        torch.ones(mesh.axis_size("data"), 3) * (mesh.rank + 1),
        axis="data").tolist()
    out["counts"] = tally(COLLECTIVES, "axis", before)
    return out


def _families(mesh):
    """Per family: a right-padded prefill and one decode step of the
    reduced model on this rank's shards against ``mesh=None``'s, the
    decode step's collectives by axis; the sharded init against
    ``place_params`` of the whole init."""
    from repro_torch.launch.mesh import COLLECTIVES, tally
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import place_params
    from repro_torch.utils.tree import flat_paths

    out = {}
    for fam, name in FAMILIES.items():
        cfg = _reduced(name)
        lm = LM(cfg, device="cpu", capacity_factor=_dropless(cfg))
        full = lm.init(3)
        local = lm.init(3, mesh=mesh)
        a = flat_paths(place_params(mesh, lm, full))
        b = flat_paths(local)
        g = torch.Generator().manual_seed(7)
        fe = cfg.frontend
        shape = (2, 6, fe.num_codebooks) if fe.kind == "audio" else (2, 6)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                         generator=g)}
        prefix = 0
        if fe.kind == "vision":
            prefix = fe.num_prefix_tokens
            batch["image_embeds"] = torch.randn(
                2, prefix, fe.embed_dim, generator=g)
        lengths = None if fe.kind != "none" or cfg.mla is not None \
            else torch.tensor([6, 4])
        ref, rc = lm.prefill(full, batch, 16, lengths=lengths)
        got, gc = lm.prefill(local, batch, 16, lengths=lengths, mesh=mesh)
        step = batch["tokens"][:, :1]
        pos = torch.tensor([6 + prefix, (4 if lengths is not None else 6)
                            + prefix])
        r2, _ = lm.decode_step(full, rc, step, pos)
        before = dict(COLLECTIVES)
        g2, _ = lm.decode_step(local, gc, step, pos, mesh=mesh)
        out[fam] = dict(
            init=sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                                for k in a),
            local=sum(t.numel() for t in b.values()),
            whole=sum(t.numel() for t in flat_paths(full).values()),
            prefill=_rel(got, ref), decode=_rel(g2, r2),
            counts=tally(COLLECTIVES, "axis", before),
            layers=lm.num_scanned_layers)
    return out


def _serve(eng, reqs):
    ids = [eng.submit(p, max_new_tokens=m, temperature=t)
           for p, m, t in reqs]
    done = eng.run()
    eng.assert_invariants()
    return {str(i): done[i].output.tolist() for i in ids
            if done[i].status == "done"}


def _engines(mesh, reqs):
    """The ring and paged engines (qwen3 and mixtral, reduced), the
    generative cascade on the paged backend, and snapshots across the
    mesh and ``mesh=None``, each on the mesh and off it."""
    from repro_torch.cascade.ecc_infer import CascadeLM, edge_variant
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.models.model import LM
    from repro_torch.serving import (CascadeServingEngine, FaultPlan,
                                     ServingEngine)
    from repro_torch.serving.kv_cache import _leaves

    out = {}
    for name in ("qwen3-4b", "mixtral-8x22b"):
        cfg = _reduced(name)
        lm = LM(cfg, device="cpu", capacity_factor=_dropless(cfg))
        full = lm.init(0)
        for backend in ("ring", "paged"):
            kw = (dict(cache_backend="paged", block_size=8, chunk_tokens=8)
                  if backend == "paged" else {})
            for m, side in ((None, "none"), (mesh, "mesh")):
                eng = ServingEngine(lm, full, batch_slots=3, max_seq_len=48,
                                    min_bucket=8, seed=0, mesh=m,
                                    max_decode_steps=4, **kw)
                out[f"{name}/{backend}/{side}"] = _serve(eng, reqs)
                if m is not None:
                    held = sum(t.numel() * t.element_size() for _, t in
                               _leaves(eng._cache_state["caches"]))
                    out[f"{name}/{backend}/bytes"] = [
                        eng.hbm_bytes(), eng.hbm_bytes_per_device(), held]
        if name != "qwen3-4b":
            continue
        # a draft of one layer on the same mesh, and a fault plan
        dlm = LM(edge_variant(cfg, layers=1), device="cpu")
        dfull = dlm.init(1)
        for m, side in ((None, "none"), (mesh, "mesh")):
            eng = ServingEngine(lm, full, batch_slots=3, max_seq_len=48,
                                min_bucket=8, seed=0, mesh=m,
                                cache_backend="paged", block_size=8,
                                draft_model=dlm, draft_params=dfull,
                                speculative_tokens=3)
            eng.scheduler.spec_min_commit = 0.0
            out[f"{name}/speculative/{side}"] = _serve(eng, reqs)
            out[f"{name}/drafted/{side}"] = \
                eng.speculative_metrics()["rounds"] > 0
            eng = ServingEngine(lm, full, batch_slots=3, max_seq_len=48,
                                min_bucket=8, seed=0, mesh=m,
                                cache_backend="paged", block_size=8,
                                fault_plan=FaultPlan(seed=3, step=[1],
                                                     swap_out=[0]))
            out[f"{name}/faults/{side}"] = _serve(eng, reqs)
        for src, dst, label in ((mesh, None, "mesh_to_none"),
                                (None, mesh, "none_to_mesh")):
            donor = ServingEngine(lm, full, batch_slots=3, max_seq_len=48,
                                  min_bucket=8, seed=0, mesh=src,
                                  max_decode_steps=4)
            for p, n, t in reqs:
                donor.submit(p, max_new_tokens=n, temperature=t)
            for _ in range(3):
                donor.step()
            cold = ServingEngine(lm, full, batch_slots=3, max_seq_len=48,
                                 min_bucket=8, seed=0, mesh=dst,
                                 max_decode_steps=4)
            cold.restore(donor.snapshot())
            done = cold.run()
            cold.assert_invariants()
            out[f"{name}/{label}"] = {str(r.request_id): r.output.tolist()
                                      for r in done.values()}
    cfg = _reduced("qwen3-4b")
    ecfg = edge_variant(cfg, layers=1)
    cloud, edge = LM(cfg, device="cpu"), LM(ecfg, device="cpu")
    full, efull = cloud.init(0), edge.init(1)
    probe = CascadeServingEngine(CascadeLM(edge, cloud), efull, full,
                                 batch_slots=3, max_seq_len=48)
    hi = float(np.median([probe._gate(p)[0] for p, _, _ in reqs]))
    for m, side in ((None, "none"), (mesh, "mesh")):
        cas = CascadeLM(edge, cloud, thresholds=make_thresholds(hi=hi,
                                                                lo=0.0))
        eng = CascadeServingEngine(cas, efull, full, batch_slots=3,
                                   max_seq_len=48, cache_backend="paged",
                                   mesh=m)
        ids = [eng.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]
        done = eng.run()
        for leg in (eng.edge_engine, eng.cloud_engine):
            leg.assert_invariants()
        out[f"cascade/{side}"] = {str(i): [done[i].route,
                                           done[i].output.tolist()]
                                  for i in ids}
    return out


def mesh_worker(rank, out_dir, model, reqs):
    """This rank of a (world / model, model) mesh: the layout, the
    families and, with ``reqs``, the engines."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model)
    rec = {"layout": _layout(mesh), "families": _families(mesh)}
    if reqs is not None:
        rec["engines"] = _engines(mesh, reqs)
    _dump(out_dir, rank, rec)


# -- the parent --------------------------------------------------------------

def _spawn(tmp_path, fn, args, nprocs, timeout_s=300.0):
    """Run ``fn`` on ``nprocs`` gloo ranks; returns the ranks' records."""
    from repro_torch.launch.mesh import spawn
    out = tmp_path / "out"
    out.mkdir()
    spawn(fn, nprocs, args=(str(out),) + tuple(args),
          rendezvous=f"file://{tmp_path / 'rendezvous'}",
          timeout_s=timeout_s)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nprocs)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(D, M): the ranks' records}: 4 gloo ranks as (2, 2), with the
    engines, and 2 as (2, 1), each spawned once."""
    reqs = _trace(_reduced("qwen3-4b").vocab_size, seed=4)
    return {
        (2, 2): (_spawn(tmp_path_factory.mktemp("w22"), mesh_worker,
                        (2, reqs), 4), reqs),
        (2, 1): (_spawn(tmp_path_factory.mktemp("w21"), mesh_worker,
                        (1, None), 2), None)}


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_layout_and_axis_groups(worlds, shape):
    """Rank r sits at (r // M, r % M); its model group is its data row,
    its data group its model column, 'world' every rank, each in rank
    order; a shard takes the rank's index on the axis; the reduce-scatter
    hands each data rank its row of the sum; an axis of size 1 issues no
    collective."""
    recs, _ = worlds[shape]
    data, model = shape
    world = data * model
    for r, rec in enumerate(recs):
        lay = rec["layout"]
        d, m = r // model, r % model
        assert lay["place"] == [r, d, m]
        assert lay["shape"] == {"data": data, "model": model}
        row = [d * model + j for j in range(model)]
        col = [i * model + m for i in range(data)]
        assert lay["sum_model"] == sum(row)
        assert lay["sum_data"] == sum(col)
        assert lay["sum_world"] == sum(range(world))
        assert lay["gather_model"] == row
        assert lay["gather_data"] == col
        assert lay["gather_world"] == list(range(world))
        assert lay["shard_model"] == [[2.0 * m, 2.0 * m + 1]]
        assert lay["shard_data"] == [[2.0 * d, 2.0 * d + 1]]
        assert lay["shard_world"] == [[2.0 * r, 2.0 * r + 1]]
        assert lay["reduce_scatter"] == [float(sum(c + 1 for c in col))] * 3
        per = 0 if model == 1 else 2
        assert lay["counts"] == {"model": per, "data": 3, "world": 2}


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("shape", [(2, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mixer_families_on_a_data_axis_equal_mesh_none(worlds, shape, fam):
    """Each family's prefill and decode on the rank's 2-D shards equal
    ``mesh=None``'s within ``TOL``, every rank alike; the sharded init is
    ``place_params`` of the whole init, bit for bit, and smaller than it;
    the decode step reduces over 'data' (and, for the embedding's join,
    the whole mesh)."""
    recs, _ = worlds[shape]
    for r, rec in enumerate(recs):
        got = rec["families"][fam]
        assert got["init"] and got["local"] < got["whole"], (r, fam)
        assert got["prefill"] <= TOL and got["decode"] <= TOL, (r, fam, got)
        assert got["counts"]["data"] > 0 and got["counts"]["world"] >= 1
        assert got == recs[0]["families"][fam]


def test_dense_decode_collectives_follow_the_design(worlds):
    """A dense GQA decode step at (2, 2): per layer the model axis reduces
    ``wo`` and ``w_down`` (the 1-D mesh's two) and the data axis the joined
    q/k/v and gate/up projections (two); once a step the unembedding's
    partial logits over 'data' and its vocab gather over 'model', the
    embedding's join over the whole mesh (in place of the vocab
    all-reduce), and one gather of every norm scale over 'data'."""
    recs, _ = worlds[(2, 2)]
    got = recs[0]["families"]["gqa"]
    n = got["layers"]
    assert got["counts"] == {"model": 2 * n + 1, "data": 2 * n + 2,
                             "world": 1}


def _near_tie(lm, params, reqs, got, base, seed=0):
    """Each stream of ``got`` equals ``base``'s, or parts first where the
    teacher-forced ``mesh=None`` forward has a top-2 margin within ``TIE``
    (of logits / T plus that step's Gumbel noise when sampled)."""
    from repro_torch.serving.sampler import gumbel, prng_key, request_keys

    assert set(got) == set(base)
    for rid, stream in got.items():
        want = base[rid]
        if stream == want:
            continue
        p = next((i for i, (a, b) in enumerate(zip(stream, want))
                  if a != b), min(len(stream), len(want)))
        prompt, _, temp = reqs[int(rid)]
        ctx = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(want[:p], np.int32)]).astype(np.int32))[None]
        last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
        x, tol = last[0, 0].float(), TIE
        if temp > 0:
            i32 = dict(dtype=torch.int32)
            key = request_keys(prng_key(seed), torch.tensor([int(rid)], **i32),
                               torch.tensor([p], **i32))
            x, tol = x / temp + gumbel(key, x.shape)[0], TIE / temp
        top2 = torch.topk(x, 2).values
        assert (top2[0] - top2[1]).item() <= tol, (rid, p)


@pytest.mark.parametrize("name", ["qwen3-4b", "mixtral-8x22b"])
@pytest.mark.parametrize("backend", ["ring", "paged"])
def test_engines_on_a_2x2_mesh(worlds, name, backend):
    """The four ranks commit equal streams, which equal ``mesh=None``'s or
    part first at a near-tie; the pools are whole over 'data': a rank
    holds what the per-device walker counts, the model axis' share of the
    KV heads, the same on every rank of a model column."""
    from repro_torch.models.model import LM

    recs, reqs = worlds[(2, 2)]
    key = f"{name}/{backend}"
    for rec in recs[1:]:
        assert rec["engines"][f"{key}/mesh"] == \
            recs[0]["engines"][f"{key}/mesh"]
    eng = recs[0]["engines"]
    assert all(len(s) > 0 for s in eng[f"{key}/mesh"].values())
    cfg = _reduced(name)
    lm = LM(cfg, device="cpu", capacity_factor=_dropless(cfg))
    _near_tie(lm, lm.init(0), reqs, eng[f"{key}/mesh"], eng[f"{key}/none"])
    whole, per_device, held = eng[f"{key}/bytes"]
    assert per_device == held
    assert (per_device < whole) == (cfg.num_kv_heads % 2 == 0)
    for r, rec in enumerate(recs):
        assert rec["engines"][f"{key}/bytes"] == eng[f"{key}/bytes"], r


@pytest.mark.parametrize("leg", ["speculative", "faults"])
def test_drafts_and_faults_on_a_2x2_mesh(worlds, leg):
    """A one-layer draft on the same (2, 2) mesh (paged, k = 3, drafting
    forced on) and a fault plan (a step fault, a swap-out fault): the four
    ranks commit equal streams, equal to ``mesh=None``'s or parted first
    at a near-tie."""
    from repro_torch.models.model import LM

    recs, reqs = worlds[(2, 2)]
    key = f"qwen3-4b/{leg}"
    for rec in recs[1:]:
        assert rec["engines"][f"{key}/mesh"] == \
            recs[0]["engines"][f"{key}/mesh"]
    eng = recs[0]["engines"]
    if leg == "speculative":
        assert eng["qwen3-4b/drafted/mesh"]
    lm = LM(_reduced("qwen3-4b"), device="cpu")
    _near_tie(lm, lm.init(0), reqs, eng[f"{key}/mesh"], eng[f"{key}/none"])


def test_snapshots_cross_between_2x2_and_mesh_none(worlds):
    """A snapshot taken on (2, 2) restores into ``mesh=None`` and one
    taken off the mesh into (2, 2): both finish the uninterrupted
    streams."""
    from repro_torch.models.model import LM

    recs, reqs = worlds[(2, 2)]
    eng = recs[0]["engines"]
    for rec in recs[1:]:
        assert rec["engines"]["qwen3-4b/none_to_mesh"] == \
            eng["qwen3-4b/none_to_mesh"]
    lm = LM(_reduced("qwen3-4b"), device="cpu")
    base = eng["qwen3-4b/ring/none"]
    for label in ("mesh_to_none", "none_to_mesh"):
        _near_tie(lm, lm.init(0), reqs, eng[f"qwen3-4b/{label}"], base)


def test_cascade_on_a_2x2_mesh(worlds):
    """The generative cascade, both legs on (2, 2): the ranks agree, and
    the routes and streams equal ``mesh=None``'s."""
    recs, _ = worlds[(2, 2)]
    for rec in recs[1:]:
        assert rec["engines"]["cascade/mesh"] == \
            recs[0]["engines"]["cascade/mesh"]
    eng = recs[0]["engines"]
    assert eng["cascade/mesh"] == eng["cascade/none"]
    assert {route for route, _ in eng["cascade/mesh"].values()} == \
        {"accept", "escalate"}
