"""MoE expert parallelism and MLA on a CPU mesh (gloo, one process a rank),
against the port's own ``mesh=None`` path.

The MoE layer splits its routed experts by expert (or, where they do not
divide, d_ff inside every expert), its router's columns and its shared
expert's d_ff; MLA splits its heads and keeps its latents whole. Each rank
runs the layer on its shards and on the whole weights: the two agree
within ``TOL`` (f32, the same sums in another order) and every rank drops
the same pairs as ``mesh=None``. The reduced mixtral-8x22b and
deepseek-v3-671b, on ``repro``'s ``LM.init`` weights carried by
``bridge.params_from_numpy(..., mesh=)``, serve through the ring and paged
engines: every rank commits the same tokens, bit for bit, and the mesh
streams equal ``mesh=None``'s or part first at a near-tie (of the
teacher-forced logits' top 2, or of a router's k-th and (k+1)-th logit).
The sharded ``LM.init`` equals ``place_params`` of the whole init.

The rank workers import only torch, numpy and ``repro_torch``; JAX runs in
the parent alone.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5           # f32 layer outputs of order 1: summation order only
TIE = 1e-4           # f32: a top-2 or router margin below which paths part
MODELS = ("mixtral-8x22b", "deepseek-v3-671b")


def _moe_cfg(e: int, shared: int):
    """One attention + MoE layer, d 32, top-2 of ``e`` experts of d_ff 32
    (and a shared expert of d_ff 32), f32."""
    from repro_torch.configs import base as b
    return b.ModelConfig(
        name=f"moe-e{e}-s{shared}", family="moe", source="test",
        num_layers=1, d_model=32, num_heads=4, num_kv_heads=4, head_dim=8,
        d_ff=64, vocab_size=64,
        stages=(b.Stage(blocks=(b.BlockDef(mixer=b.ATTN, mlp=b.MOE),),
                        repeat=1),),
        moe=b.MoEConfig(num_experts=e, num_experts_per_tok=2,
                        d_ff_expert=32, num_shared_experts=shared,
                        d_ff_shared=32 * shared),
        param_dtype="float32")


def _reduced(name: str):
    """The port's reduced config of ``name`` in f32."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(),
                               param_dtype="float32")


def _trace(vocab: int, seed: int = 0, n: int = 6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=4 + 3 * i % 11).astype(np.int32),
             4 + i % 3, 0.0 if i % 3 else 0.7) for i in range(n)]


# -- rank workers (spawned: module-level, no JAX) ----------------------------

def _dump(out_dir, rank, rec) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _err(a, b) -> float:
    return float((a - b).abs().max())


def _layer0(tree, key):
    return {k: v[0] if not isinstance(v, dict) else
            {kk: vv[0] for kk, vv in v.items()}
            for k, v in tree["stages"][-1]["b0"][key].items()}


def layers_worker(rank, out_dir):
    """The MoE layer for E = 4 and 6, with and without a shared expert, at
    1.25 and dropless, at S = 12 and 1; MLA prefill and chunk decode; the
    sharded ``LM.init`` of both reduced MoE models."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as att
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import place_params
    from repro_torch.sharding import tensor_parallel
    from repro_torch.utils.tree import flat_paths

    n = torch.distributed.get_world_size()
    mesh = make_host_mesh(n)
    rec = {"moe": {}, "mla": {}, "init": {}}
    g = torch.Generator().manual_seed(7)
    for e in (4, 6):
        for shared in (0, 1):
            cfg = _moe_cfg(e, shared)
            lm = LM(cfg, device="cpu")
            tp = tensor_parallel(cfg, mesh)
            full = _layer0(lm.init(e + shared), "mlp")
            local = _layer0(place_params(mesh, lm, lm.init(e + shared)),
                            "mlp")
            for s in (12, 1):
                x = torch.randn(2, s, 32, generator=g)
                for cf in (1.25, e / 2):
                    want, aux = moe_lib.moe_forward(full, cfg, x,
                                                    capacity_factor=cf)
                    got, aux_m = moe_lib.moe_forward(local, cfg, x,
                                                     capacity_factor=cf,
                                                     tp=tp)
                    rec["moe"][f"e{e}_s{shared}_t{s}_f{cf:g}"] = dict(
                        err=_err(got, want), aux=_err(aux_m, aux),
                        drops=int(moe_lib.dropped_pairs(
                            local, cfg, x, capacity_factor=cf, tp=tp)),
                        drops_none=int(moe_lib.dropped_pairs(
                            full, cfg, x, capacity_factor=cf)),
                        experts=tp.experts, expert_mlp=tp.expert_mlp,
                        expert_range=list(tp.expert_range),
                        local_experts=local["w_gate"].shape[0])
    # MLA: prefill, then a 3-token chunk and single tokens over a ring
    cfg = _reduced("deepseek-v3-671b")
    lm = LM(cfg, device="cpu")
    tp = tensor_parallel(cfg, mesh)
    full = _layer0(lm.init(3), "mixer")
    local = _layer0(lm.init(3, mesh=mesh), "mixer")
    rec["mla"]["local_heads"] = local["w_uq"].shape[1]
    x = torch.randn(2, 10, cfg.d_model, generator=g)
    pos = torch.arange(10, dtype=torch.int32)[None].expand(2, 10)
    outs = {}
    for side, p, t in (("none", full, None), ("mesh", local, tp)):
        y, (ckv, krope) = att.mla_forward(p, cfg, x[:, :6], pos[:, :6],
                                          window=None, tp=t)
        cache = att.init_mla_cache(cfg, 2, 16, torch.float32, "cpu")
        att.mla_cache_fill(cache, ckv, krope, 6)
        steps = [y]
        y, cache = att.mla_decode(p, cfg, x[:, 6:9], cache, 6, window=None,
                                  tp=t)
        steps.append(y)
        y, cache = att.mla_decode(p, cfg, x[:, 9:10], cache, 9, window=None,
                                  tp=t)
        steps.append(y)
        outs[side] = (torch.cat(steps, 1), cache)
    rec["mla"]["err"] = _err(outs["mesh"][0], outs["none"][0])
    rec["mla"]["latents_equal"] = all(
        torch.equal(outs["mesh"][1][k], outs["none"][1][k])
        for k in ("ckv", "krope", "pos"))
    for name in MODELS:
        lm = LM(_reduced(name), device="cpu")
        a = flat_paths(place_params(mesh, lm, lm.init(5)))
        b = flat_paths(lm.init(5, mesh=mesh))
        rec["init"][name] = dict(
            same_keys=sorted(a) == sorted(b),
            equal=all(torch.equal(a[k], b[k]) for k in a),
            local=sum(t.numel() for t in b.values()),
            whole=sum(t.numel() for t in flat_paths(lm.init(5)).values()))
    _dump(out_dir, rank, rec)


def _serve(eng, reqs):
    ids = [eng.submit(p, max_new_tokens=m, temperature=t)
           for p, m, t in reqs]
    done = eng.run()
    eng.assert_invariants()
    return {str(i): done[i].output.tolist() for i in ids
            if done[i].status == "done"}


def _serve_preempting(eng, reqs):
    """Serve ``reqs``, preempting the lowest busy slot after every other
    step (the same slots on every rank)."""
    ids = [eng.submit(p, max_new_tokens=m, temperature=t)
           for p, m, t in reqs]
    n = 0
    while eng.pending:
        eng.step()
        n += 1
        if eng._slots and n % 2:
            eng.preempt(min(eng._slots))
        eng.assert_invariants()
    done = eng.take_done()
    return {str(i): done[i].output.tolist() for i in ids
            if done[i].status == "done"}


def engines_worker(rank, out_dir, trees, reqs):
    """Both reduced MoE models on this rank: ring K = 1 and 4, paged with
    chunked prefill, paged with swap preemption, and snapshots across the
    mesh and ``mesh=None`` both ways; each leg on the mesh and off it."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine
    from repro_torch.utils.tree import tree_leaves

    mesh = make_host_mesh(torch.distributed.get_world_size())
    rec = {}
    for name in MODELS:
        cfg = _reduced(name)
        lm = LM(cfg, device="cpu")
        full = params_from_numpy(trees[name], cfg, device="cpu")
        local = params_from_numpy(trees[name], cfg, device="cpu", mesh=mesh)
        legs = {"ring_k1": dict(max_decode_steps=1),
                "ring_k4": dict(max_decode_steps=4),
                "paged_chunked": dict(cache_backend="paged", block_size=8,
                                      chunk_tokens=8, max_decode_steps=4),
                "paged_swap": dict(cache_backend="paged", block_size=8,
                                   preempt_mode="swap",
                                   max_decode_steps=2)}

        def mk(m, kw):
            return ServingEngine(lm, full if m is None else local,
                                 batch_slots=3, max_seq_len=48,
                                 min_bucket=8, seed=0, mesh=m, **kw)

        out = rec[name] = {"mesh": {}, "none": {}, "swaps": {}}
        for leg, kw in legs.items():
            for m, side in ((None, "none"), (mesh, "mesh")):
                eng = mk(m, kw)
                if leg == "paged_swap":
                    out[side][leg] = _serve_preempting(eng, reqs)
                    out["swaps"][side] = eng.backend.swap_ins
                else:
                    out[side][leg] = _serve(eng, reqs)
        # snapshots: taken mid-run on one side, restored on the other
        paged = legs["paged_chunked"]
        for src, dst, label in ((mesh, None, "mesh_to_none"),
                                (None, mesh, "none_to_mesh"),
                                (mesh, mesh, "mesh_to_mesh")):
            donor = mk(src, paged)
            for p, n, t in reqs:
                donor.submit(p, max_new_tokens=n, temperature=t)
            for _ in range(3):
                donor.step()
            cold = mk(dst, paged)
            cold.restore(donor.snapshot())
            done = cold.run()
            cold.assert_invariants()
            out["mesh" if dst is not None else "none"][label] = {
                str(r.request_id): r.output.tolist() for r in done.values()}
        out["weight_values"] = sum(t.numel() for t in tree_leaves(local))
    _dump(out_dir, rank, rec)


def cascade_worker(rank, out_dir, tree, etree, reqs):
    """A generative cascade whose cloud is the reduced mixtral, both legs
    on the mesh and off it."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.cascade.ecc_infer import CascadeLM, edge_variant
    from repro_torch.cascade.gate import make_thresholds
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.serving import CascadeServingEngine

    mesh = make_host_mesh(torch.distributed.get_world_size())
    cfg = _reduced("mixtral-8x22b")
    ecfg = edge_variant(cfg, layers=1)
    cloud, edge = LM(cfg, device="cpu"), LM(ecfg, device="cpu")
    full = params_from_numpy(tree, cfg, device="cpu")
    efull = params_from_numpy(etree, ecfg, device="cpu")
    probe = CascadeServingEngine(CascadeLM(edge, cloud), efull, full,
                                 batch_slots=3, max_seq_len=48)
    hi = float(np.median([probe._gate(p)[0] for p, _, _ in reqs]))
    rec = {}
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
        rec[side] = {str(i): [done[i].route, done[i].output.tolist()]
                     for i in ids}
    _dump(out_dir, rank, rec)


# -- the parent --------------------------------------------------------------

def _spawn(tmp_path, fn, args, nprocs, timeout_s=240.0):
    """Run ``fn`` on ``nprocs`` gloo ranks; returns the ranks' records."""
    from repro_torch.launch.mesh import spawn
    out = tmp_path / "out"
    out.mkdir()
    spawn(fn, nprocs, args=(str(out),) + tuple(args),
          rendezvous=f"file://{tmp_path / 'rendezvous'}",
          timeout_s=timeout_s)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nprocs)]


def _ranks_agree(recs, drop=()):
    for r, rec in enumerate(recs[1:], 1):
        a = {k: v for k, v in rec.items() if k not in drop}
        b = {k: v for k, v in recs[0].items() if k not in drop}
        assert a == b, f"rank {r} differs from rank 0"


def _repro_tree(cfg, seed: int):
    """``repro``'s ``LM.init`` of ``repro``'s copy of the reduced ``cfg``
    (f32), as a numpy tree."""
    import jax
    from repro.configs import get_config as repro_config
    from repro.models.model import LM as RLM

    rcfg = dataclasses.replace(repro_config(cfg.name[:-len("-reduced")])
                               .reduced(), param_dtype="float32")
    assert rcfg.name == cfg.name
    params, _ = RLM(rcfg, kv_chunk=16).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _near_tie_streams(lm, params, reqs, got_streams, base, seed=0):
    """Each stream of ``got_streams`` equals ``base``'s, or parts first
    where the teacher-forced ``mesh=None`` forward has a top-2 margin
    within ``TIE`` (of logits / T plus that step's Gumbel noise for a
    sampled request) or some MoE layer's router gap between its k-th and
    (k+1)-th logit within ``TIE`` at a position up to it. Returns the
    count that parted."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.sampler import gumbel, prng_key, request_keys

    parted = 0
    assert set(got_streams) == set(base)
    for rid, got in got_streams.items():
        want = base[rid]
        if got == want:
            continue
        p = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        prompt, _, temp = reqs[int(rid)]
        ctx = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(want[:p], np.int32)]).astype(np.int32))[None]
        gaps = []
        orig = moe_lib.route

        def recording(params, cfg, x_flat, tp=None, over_data=None):
            logits = moe_lib.router_logits(params, x_flat, tp)
            top = torch.topk(logits, cfg.moe.num_experts_per_tok + 1, -1)[0]
            gaps.append(float((top[:, -2] - top[:, -1]).min()))
            return orig(params, cfg, x_flat, tp, over_data)

        moe_lib.route = recording
        try:
            last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
        finally:
            moe_lib.route = orig
        x, tol = last[0, 0].float(), TIE
        if temp > 0:
            i32 = dict(dtype=torch.int32)
            key = request_keys(prng_key(seed), torch.tensor([int(rid)], **i32),
                               torch.tensor([p], **i32))
            x, tol = x / temp + gumbel(key, x.shape)[0], TIE / temp
        top2 = torch.topk(x, 2).values
        margin = (top2[0] - top2[1]).item()
        assert margin <= tol or min(gaps) <= TIE, (
            f"request {rid}: the mesh stream parts from mesh=None at token "
            f"{p}, top-2 margin {margin:.3g} > {tol}, router gaps >= "
            f"{min(gaps):.3g}")
        parted += 1
    return parted


def _check_layers(recs, n):
    _ranks_agree(recs, drop=("moe",))
    for r, rec in enumerate(recs):
        for case, c in rec["moe"].items():
            assert c["err"] <= TOL and c["aux"] <= TOL, (r, case, c)
            assert c["drops"] == c["drops_none"], (r, case, c)
            assert c["drops"] == recs[0]["moe"][case]["drops"], (r, case)
            e = int(case[1])
            if e % n == 0:
                assert c["experts"] and c["expert_range"] == \
                    [r * e // n, e // n] and c["local_experts"] == e // n
            else:
                assert c["expert_mlp"] and c["local_experts"] == e
        assert rec["mla"]["err"] <= TOL and rec["mla"]["latents_equal"]
        assert rec["mla"]["local_heads"] == 4 // n
        for name, got in rec["init"].items():
            assert got["same_keys"] and got["equal"], (r, name)
            assert got["local"] < got["whole"], (r, name)
    # 1.25 dropped pairs somewhere at S = 12 (so the drop check bites)
    assert any(c["drops"] for case, c in recs[0]["moe"].items()
               if "_f1.25" in case and "_t12_" in case)


def test_moe_and_mla_layers_on_two_ranks(tmp_path):
    """2 ranks: E = 4 and E = 6 split by expert (2 and 3 a rank), with and
    without a shared expert (d_ff split), at 1.25 (with drops) and
    dropless; MLA's 4 heads 2 a rank; the sharded init."""
    _check_layers(_spawn(tmp_path, layers_worker, (), 2), 2)


def test_moe_and_mla_layers_on_four_ranks(tmp_path):
    """4 ranks: E = 4 split by expert (1 a rank); E = 6 does not divide,
    so d_ff splits inside every expert; MLA's heads 1 a rank."""
    _check_layers(_spawn(tmp_path, layers_worker, (), 4), 4)


@pytest.fixture(scope="module")
def engine_records(tmp_path_factory):
    """The engines worker on 2 ranks, once for the module's tests: (the
    ranks' records, the requests, {name: (lm, whole params)})."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.model import LM

    trees, ports = {}, {}
    for i, name in enumerate(MODELS):
        cfg = _reduced(name)
        trees[name] = _repro_tree(cfg, i)
        ports[name] = (LM(cfg, device="cpu"),
                       params_from_numpy(trees[name], cfg, device="cpu"))
    reqs = _trace(ports[MODELS[0]][0].cfg.vocab_size, seed=3)
    recs = _spawn(tmp_path_factory.mktemp("engines"), engines_worker,
                  (trees, reqs), 2)
    return recs, reqs, ports


def test_reduced_moe_models_ranks_agree_bit_for_bit(engine_records):
    recs, _, _ = engine_records
    _ranks_agree(recs)
    for name in MODELS:
        rec = recs[0][name]
        assert set(rec["mesh"]) == {"ring_k1", "ring_k4", "paged_chunked",
                                    "paged_swap", "none_to_mesh",
                                    "mesh_to_mesh"}
        assert all(len(s) == 6 for s in rec["mesh"].values())
        assert rec["swaps"]["mesh"] >= 1 and rec["swaps"]["none"] >= 1


@pytest.mark.parametrize("name", MODELS)
def test_reduced_moe_model_streams_against_mesh_none(engine_records, name):
    """Every leg's mesh streams against the same leg's ``mesh=None``
    streams (the snapshots against the uninterrupted chunked paged run):
    equal, or parted first at a near-tie."""
    recs, reqs, ports = engine_records
    lm, params = ports[name]
    rec = recs[0][name]
    base = rec["none"]
    for leg, got in rec["mesh"].items():
        want = base.get(leg, base["paged_chunked"])
        _near_tie_streams(lm, params, reqs, got, want)
    _near_tie_streams(lm, params, reqs, base["mesh_to_none"],
                      base["paged_chunked"])
    # a mesh snapshot restored on the mesh resumes its own run exactly
    assert rec["mesh"]["mesh_to_mesh"] == rec["mesh"]["paged_chunked"]
    from repro_torch.utils.tree import tree_leaves
    assert rec["weight_values"] < sum(t.numel() for t in tree_leaves(params))


def test_cascade_with_a_reduced_mixtral_cloud_on_two_ranks(tmp_path):
    """The generative cascade, both legs on a 2-way mesh, its cloud the
    reduced mixtral: the ranks agree, and the mesh's routes and streams
    equal ``mesh=None``'s."""
    import jax
    from repro.cascade.ecc_infer import edge_variant as repro_edge
    from repro.configs import get_config as repro_config
    from repro.models.model import LM as RLM

    cfg = _reduced("mixtral-8x22b")
    tree = _repro_tree(cfg, 0)
    rcfg = repro_edge(dataclasses.replace(
        repro_config("mixtral-8x22b").reduced(), param_dtype="float32"),
        layers=1)
    etree = jax.tree.map(np.asarray, RLM(rcfg, kv_chunk=16).init(
        jax.random.PRNGKey(1))[0])
    reqs = _trace(cfg.vocab_size, seed=5)
    recs = _spawn(tmp_path, cascade_worker, (tree, etree, reqs), 2)
    _ranks_agree(recs)
    rec = recs[0]
    assert rec["mesh"] == rec["none"]
    routes = {route for route, _ in rec["mesh"].values()}
    assert routes == {"accept", "escalate"}, routes


def test_serve_launcher_mixtral_mesh_two_on_cpu():
    """``launch/serve.py --arch mixtral-8x22b --mesh 2 --device cpu``: two
    gloo ranks build their shards with the sharded ``LM.init`` and serve
    every request."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x22b", "--mesh", "2", "--device", "cpu", "--requests",
         "4", "--max-new", "4", "--quiet"],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "{'done': 4}" in out.stdout, out.stdout
