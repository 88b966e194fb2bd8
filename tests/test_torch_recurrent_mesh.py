"""The recurrent mixers on a CPU mesh (gloo, one process a rank), against
the port's own ``mesh=None`` path.

The RG-LRU block splits its width (the gates' rows as partial products
summed in one all-reduce), the mLSTM and sLSTM their heads (the sLSTM's
time loop on the rank's heads, its normed outputs joined by one gather,
its GeGLU split by column). On 1, 2 and 4 ranks each block's forward and
decodes equal ``mesh=None``'s within ``TOL`` (f32, the same sums in
another order), and the state shards, joined on their split dims, equal
``mesh=None``'s state. The reduced recurrentgemma-9b and xlstm-125m, on
``repro``'s ``LM.init`` weights carried by ``bridge.params_from_numpy(...,
mesh=)``, serve through the ring engine on 2 ranks: every rank commits the
same tokens, bit for bit, and the streams equal ``mesh=None``'s or part
first at a near-tie; snapshots cross between the mesh and ``mesh=None``
both ways. The sharded ``LM.init`` equals ``place_params`` of the whole
init. The RG-LRU state splits where ``repro``'s decode cache specs split
it; ``repro`` keeps the xLSTM states whole, the port its heads.

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
TOL = 1e-5           # f32, relative to the output's largest magnitude
TIE = 1e-4           # f32: a top-2 margin below which two paths may part
MODELS = ("recurrentgemma-9b", "xlstm-125m")
# the dim each recurrent state leaf of one layer (B, ...) splits on
STATE_DIMS = {"rglru": {"h": 1, "conv": 2},
              "mlstm": {"C": 1, "n": 1, "m": 1},
              "slstm": {"c": 1, "n": 1, "h": 1, "m": 1}}


def _reduced(name: str):
    """The port's reduced config of ``name`` in f32."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(),
                               param_dtype="float32")


def _trace(vocab: int, seed: int = 0, n: int = 6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=3 + 3 * i % 13).astype(np.int32),
             4 + i % 3, 0.0 if i % 3 else 0.7) for i in range(n)]


# -- rank workers (spawned: module-level, no JAX) ----------------------------

def _dump(out_dir, rank, rec) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _mixer_layer(params, cfg, kind):
    """Layer 0 of the first block whose mixer is ``kind``: its mixer's
    leaves."""
    for stage, sp in zip(cfg.stages, params["stages"]):
        for i, bdef in enumerate(stage.blocks):
            if bdef.mixer == kind:
                tree = sp[f"b{i}"]["mixer"]
                return {k: v[0] if not isinstance(v, dict) else
                        {kk: vv[0] for kk, vv in v.items()}
                        for k, v in tree.items()}
    raise KeyError(kind)


def blocks_worker(rank, out_dir, trees):
    """Every recurrent block of both reduced models on this rank's shards
    and on the whole weights: a right-padded forward from a zero state,
    then three decodes (one with a row not valid); the sharded init."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recurrent as rec_lib
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import place_params
    from repro_torch.sharding import tensor_parallel
    from repro_torch.utils.tree import flat_paths

    n = torch.distributed.get_world_size()
    mesh = make_host_mesh(n)
    fwd = {"rglru": rec_lib.rglru_block_forward,
           "mlstm": rec_lib.mlstm_block_forward,
           "slstm": rec_lib.slstm_block_forward}
    dec = {"rglru": rec_lib.rglru_block_decode,
           "mlstm": rec_lib.mlstm_block_decode,
           "slstm": rec_lib.slstm_block_decode}
    rec = {"blocks": {}, "init": {}, "state_width": {}}
    g = torch.Generator().manual_seed(11)
    for name in MODELS:
        cfg = _reduced(name)
        tp = tensor_parallel(cfg, mesh)
        full = params_from_numpy(trees[name], cfg, device="cpu")
        local = params_from_numpy(trees[name], cfg, device="cpu", mesh=mesh)
        kinds = {b.mixer for st in cfg.stages for b in st.blocks}
        for kind in sorted(kinds & set(fwd)):
            pf, pl = _mixer_layer(full, cfg, kind), _mixer_layer(local, cfg,
                                                                 kind)
            x = torch.randn(2, 10, cfg.d_model, generator=g)
            steps = torch.randn(3, 2, 1, cfg.d_model, generator=g)
            lengths = torch.tensor([10, 7])
            errs, states = [], []
            for p, t in ((pf, None), (pl, tp)):
                y, st = fwd[kind](p, cfg, x, lengths, tp=t)
                outs = [y]
                for i in range(3):
                    valid = torch.tensor([[True], [i != 1]])
                    y, st = dec[kind](p, cfg, steps[i], st, valid, tp=t)
                    outs.append(y)
                states.append(st)
                errs.append(outs)
            joined = {key: (mesh.gather(v, STATE_DIMS[kind][key])
                            if v.shape != states[0][key].shape else v)
                      for key, v in states[1].items()}
            rec["blocks"][f"{name}/{kind}"] = dict(
                out=[_rel(a, b) for a, b in zip(errs[1], errs[0])],
                state={key: _rel(joined[key], states[0][key])
                       for key in joined},
                local={key: list(v.shape) for key, v in states[1].items()},
                whole={key: list(v.shape) for key, v in states[0].items()})
        lm = LM(cfg, device="cpu")
        a = flat_paths(place_params(mesh, lm, lm.init(5)))
        b = flat_paths(lm.init(5, mesh=mesh))
        rec["init"][name] = dict(
            same_keys=sorted(a) == sorted(b),
            equal=all(torch.equal(a[k], b[k]) for k in a),
            local=sum(t.numel() for t in b.values()),
            whole=sum(t.numel() for t in flat_paths(lm.init(5)).values()))
        rec["state_width"][name] = dict(lru=tp.lru, rec_heads=tp.rec_heads,
                                        rec_mlp=tp.rec_mlp, mlp=tp.mlp)
    _dump(out_dir, rank, rec)


def _serve(eng, reqs):
    ids = [eng.submit(p, max_new_tokens=m, temperature=t)
           for p, m, t in reqs]
    done = eng.run()
    eng.assert_invariants()
    return {str(i): done[i].output.tolist() for i in ids
            if done[i].status == "done"}


def engines_worker(rank, out_dir, trees, reqs):
    """Both reduced models on this rank: the ring engine (K = 4) on the
    mesh and off it, and snapshots across the mesh and ``mesh=None`` both
    ways; the state bytes a rank holds."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.kv_cache import _leaves

    mesh = make_host_mesh(torch.distributed.get_world_size())
    rec = {}
    for name in MODELS:
        cfg = _reduced(name)
        lm = LM(cfg, device="cpu")
        full = params_from_numpy(trees[name], cfg, device="cpu")
        local = params_from_numpy(trees[name], cfg, device="cpu", mesh=mesh)

        def mk(m):
            return ServingEngine(lm, full if m is None else local,
                                 batch_slots=3, max_seq_len=48,
                                 min_bucket=8, seed=0, mesh=m,
                                 max_decode_steps=4)

        out = rec[name] = {"mesh": {}, "none": {}}
        for m, side in ((None, "none"), (mesh, "mesh")):
            eng = mk(m)
            out[side]["ring"] = _serve(eng, reqs)
            state = sum(t.numel() * t.element_size() for key, t in
                        _leaves(eng._cache_state["caches"])
                        if key not in ("k", "v", "pos"))
            out[side]["bytes"] = [state, eng.hbm_bytes(),
                                  eng.hbm_bytes_per_device()]
        for src, dst, label in ((mesh, None, "mesh_to_none"),
                                (None, mesh, "none_to_mesh")):
            donor = mk(src)
            for p, n, t in reqs:
                donor.submit(p, max_new_tokens=n, temperature=t)
            for _ in range(3):
                donor.step()
            cold = mk(dst)
            cold.restore(donor.snapshot())
            done = cold.run()
            cold.assert_invariants()
            out["mesh" if dst is not None else "none"][label] = {
                str(r.request_id): r.output.tolist() for r in done.values()}
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


@pytest.fixture(scope="module")
def trees():
    return {name: _repro_tree(_reduced(name), i)
            for i, name in enumerate(MODELS)}


def _near_tie_streams(lm, params, reqs, got_streams, base, seed=0):
    """Each stream of ``got_streams`` equals ``base``'s, or parts first
    where the teacher-forced ``mesh=None`` forward has a top-2 margin
    within ``TIE`` (of logits / T plus that step's Gumbel noise for a
    sampled request). Returns the count that parted."""
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
        last, _ = lm.forward(params, {"tokens": ctx}, last_only=True)
        x, tol = last[0, 0].float(), TIE
        if temp > 0:
            i32 = dict(dtype=torch.int32)
            key = request_keys(prng_key(seed), torch.tensor([int(rid)], **i32),
                               torch.tensor([p], **i32))
            x, tol = x / temp + gumbel(key, x.shape)[0], TIE / temp
        top2 = torch.topk(x, 2).values
        margin = (top2[0] - top2[1]).item()
        assert margin <= tol, (
            f"request {rid}: the mesh stream parts from mesh=None at token "
            f"{p}, top-2 margin {margin:.3g} > {tol}")
        parted += 1
    return parted


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_recurrent_blocks_on_the_mesh_equal_mesh_none(tmp_path, trees,
                                                      ranks):
    """Each RG-LRU, mLSTM and sLSTM block: a padded forward and three
    decodes on the rank's shards equal ``mesh=None``'s within ``TOL``; the
    rank holds its 1/N of the state where the width or heads divide (the
    reduced models' 256 channels and 4 heads divide 1, 2 and 4), and the
    shards joined equal ``mesh=None``'s state; the sharded init equals
    ``place_params`` of the whole init."""
    recs = _spawn(tmp_path, blocks_worker, (trees,), ranks)
    for r, rec in enumerate(recs):
        assert set(rec["blocks"]) == {"recurrentgemma-9b/rglru",
                                      "xlstm-125m/mlstm", "xlstm-125m/slstm"}
        for case, c in rec["blocks"].items():
            assert max(c["out"]) <= TOL, (r, case, c["out"])
            assert max(c["state"].values()) <= TOL, (r, case, c["state"])
            kind = case.split("/")[1]
            for key, dim in STATE_DIMS[kind].items():
                want = list(c["whole"][key])
                want[dim] //= ranks
                assert c["local"][key] == want, (r, case, key)
        for name, got in rec["init"].items():
            assert got["same_keys"] and got["equal"], (r, name)
            assert (got["local"] < got["whole"]) == (ranks > 1), (r, name)
        assert rec["state_width"]["recurrentgemma-9b"]["lru"]
        xl = rec["state_width"]["xlstm-125m"]
        assert xl["rec_heads"] and xl["rec_mlp"] and not xl["mlp"]


@pytest.fixture(scope="module")
def engine_records(tmp_path_factory, trees):
    """The engines worker on 2 ranks, once for the module's tests: (the
    ranks' records, the requests, {name: (lm, whole params)})."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.model import LM

    ports = {name: (LM(_reduced(name), device="cpu"),
                    params_from_numpy(trees[name], _reduced(name),
                                      device="cpu"))
             for name in MODELS}
    reqs = _trace(_reduced(MODELS[0]).vocab_size, seed=4)
    recs = _spawn(tmp_path_factory.mktemp("engines"), engines_worker,
                  (trees, reqs), 2)
    return recs, reqs, ports


def test_reduced_recurrent_engines_ranks_agree_bit_for_bit(engine_records):
    """Both ranks commit the same tokens on every leg; each holds half the
    recurrent state bytes, which the per-device walker counts."""
    recs, _, _ = engine_records
    assert recs[1] == recs[0]
    for name in MODELS:
        rec = recs[0][name]
        assert set(rec["mesh"]) == {"ring", "bytes", "none_to_mesh"}
        assert all(len(s) == 6 for k, s in rec["mesh"].items()
                   if k != "bytes")
        state, whole, per_dev = rec["mesh"]["bytes"]
        none_state, none_whole, none_dev = rec["none"]["bytes"]
        assert state * 2 == none_state, name
        assert whole == none_whole == none_dev
        assert per_dev == whole - none_state // 2, name


@pytest.mark.parametrize("name", MODELS)
def test_reduced_recurrent_streams_against_mesh_none(engine_records, name):
    """The mesh's ring streams, and the snapshots' resumed streams in both
    directions, against the uninterrupted ``mesh=None`` run: equal, or
    parted first at a near-tie (a recompute resume re-prefills what decode
    stepped)."""
    recs, reqs, ports = engine_records
    lm, params = ports[name]
    rec = recs[0][name]
    base = rec["none"]["ring"]
    for got in (rec["mesh"]["ring"], rec["mesh"]["none_to_mesh"],
                rec["none"]["mesh_to_none"]):
        _near_tie_streams(lm, params, reqs, got, base)


def test_rglru_state_splits_as_repros_decode_cache_specs():
    """The port's cache specs split the RG-LRU state where ``repro``'s
    ``launch.sharding_rules.cache_pspecs`` does (``h`` dim 2, ``conv`` dim
    3 of the stacked (L, B, ...) leaves) at 2 and 4 ways; ``repro`` keeps
    the xLSTM states whole on 'model', where the port splits their heads
    (dim 2)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as repro_config
    from repro.launch.sharding_rules import cache_pspecs as repro_specs
    from repro.models.model import LM as RLM
    from repro_torch.launch.mesh import AbstractMesh as TMesh
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import cache_pspecs

    for name in MODELS:
        cfg = _reduced(name)
        rlm = RLM(dataclasses.replace(repro_config(name).reduced(),
                                      param_dtype="float32"), kv_chunk=16)
        rcache = jax.eval_shape(lambda: rlm.init_cache(2, 32))
        for ways in (2, 4):
            ref = repro_specs(AbstractMesh((1, ways), ("data", "model")),
                              rlm.cfg, rcache)
            got = cache_pspecs(TMesh(ways), {
                "caches": LM(cfg, device="cpu").init_cache(2, 32),
                "tables": None})["caches"]
            for si, stage in enumerate(cfg.stages):
                for bi, bdef in enumerate(stage.blocks):
                    mine, theirs = got[si][bi], ref[si][bi]
                    for key, spec in mine.items():
                        model = [d for d, a in enumerate(theirs[key])
                                 if a == "model"]
                        split = [d for d, a in enumerate(spec)
                                 if a == "model"]
                        if bdef.mixer == "rglru":
                            assert split == model == [
                                {"h": 2, "conv": 3}[key]], (name, key)
                        elif bdef.mixer in ("mlstm", "slstm"):
                            assert model == [] and split == [2], (name, key)


@pytest.mark.parametrize("name", MODELS)
def test_serve_launcher_recurrent_mesh_two_on_cpu(name):
    """``launch/serve.py --arch NAME --mesh 2 --device cpu``: two gloo
    ranks build their shards with the sharded ``LM.init`` and serve every
    request."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", name,
         "--mesh", "2", "--device", "cpu", "--requests", "4", "--max-new",
         "4", "--quiet"],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "{'done': 4}" in out.stdout, out.stdout
