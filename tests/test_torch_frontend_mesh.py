"""The modality frontends on a CPU mesh (gloo, one process a rank), against
the port's own ``mesh=None`` path.

internvl2-2b's vision projector stays whole on every rank (its leaves'
EMBED axes resolve to the data axis, of size 1) in front of a dense GQA
text model; musicgen-medium's per-codebook embedding and unembedding
tables split their vocab (a masked lookup in every codebook, summed, then
one all-reduce; the (B, S, C, V/N) logits gathered on V). The reduced
models, on ``repro``'s ``LM.init`` weights carried by
``bridge.params_from_numpy(..., mesh=)``, run ``LM.forward``,
``LM.prefill`` and ``LM.decode_step`` on 2 and 4 ranks: every rank's
logits are equal, and equal ``mesh=None``'s within ``TOL`` (f32, the same
sums in another order). ``mesh=None`` is held against ``repro``'s forward
in ``tests/test_torch_frontend.py``.

The rank workers import only torch, numpy and ``repro_torch``; JAX runs in
the parent alone.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

TOL = 1e-5           # f32, relative to the logits' largest magnitude
MODELS = ("internvl2-2b", "musicgen-medium")
SEQ = 14             # internvl2's reduced prefix is 8 of these positions
DECODE_STEPS = 3


def _reduced(name: str):
    """The port's reduced config of ``name`` in f32."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(),
                               param_dtype="float32")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def frontends_worker(rank, out_dir, trees):
    """Both reduced models on this rank's shards and on the whole weights:
    a forward, a prefill into a ring and ``DECODE_STEPS`` decodes (a
    vision model's decode positions count its prefix)."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.frontend import make_batch
    from repro_torch.models.model import LM
    from repro_torch.sharding import tensor_parallel
    from repro_torch.utils.tree import tree_leaves

    n = torch.distributed.get_world_size()
    mesh = make_host_mesh(n)
    rec = {}
    for name in MODELS:
        cfg = _reduced(name)
        lm = LM(cfg, device="cpu")
        tp = tensor_parallel(cfg, mesh)
        full = params_from_numpy(trees[name], cfg, device="cpu")
        local = params_from_numpy(trees[name], cfg, device="cpu", mesh=mesh)
        g = torch.Generator().manual_seed(3)
        batch = make_batch(g, cfg, 2, SEQ)
        steps = make_batch(g, cfg, 2, DECODE_STEPS + (
            cfg.frontend.num_prefix_tokens if cfg.frontend.kind == "vision"
            else 0))["tokens"]
        got = {}
        for m, side, p in ((None, "none", full), (mesh, "mesh", local)):
            fwd, _ = lm.forward(p, batch, mesh=m)
            logits, caches = lm.prefill(p, batch, cache_width=32, mesh=m)
            outs = [fwd, logits]
            pos = fwd.shape[1]
            for i in range(DECODE_STEPS):
                y, caches = lm.decode_step(p, caches, steps[:, i:i + 1],
                                           pos + i, mesh=m)
                outs.append(y)
            got[side] = outs
        rec[name] = dict(
            err=[_rel(a, b) for a, b in zip(got["mesh"], got["none"])],
            logits=[t.flatten()[:64].tolist() for t in got["mesh"]],
            shapes=[list(t.shape) for t in got["mesh"]],
            vocab=tp.vocab,
            local=sum(t.numel() for t in tree_leaves(local)),
            whole=sum(t.numel() for t in tree_leaves(full)),
            table=list(local["embed"]["table"].shape),
            proj=None if "vision_proj" not in local else
            [list(local["vision_proj"][k].shape) for k in ("w1", "w2")])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


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
    return {name: _repro_tree(_reduced(name), i + 2)
            for i, name in enumerate(MODELS)}


@pytest.mark.parametrize("ranks", [2, 4])
def test_frontends_on_the_mesh_equal_mesh_none(tmp_path, trees, ranks):
    """``LM.forward``, ``prefill`` and ``decode_step`` of the reduced
    internvl2-2b and musicgen-medium on ``ranks`` gloo ranks: every rank's
    logits equal, all of them within ``TOL`` of ``mesh=None``'s; the
    projector whole on every rank, musicgen's tables cut to V/N rows of
    every codebook."""
    recs = _spawn(tmp_path, frontends_worker, (trees,), ranks)
    for r, rec in enumerate(recs[1:], 1):
        for name in MODELS:
            assert rec[name]["logits"] == recs[0][name]["logits"], (r, name)
    for name in MODELS:
        cfg = _reduced(name)
        rec = recs[0][name]
        assert max(rec["err"]) <= TOL, (name, rec["err"])
        assert rec["vocab"] and rec["local"] < rec["whole"]
        if name == "musicgen-medium":
            c = cfg.frontend.num_codebooks
            assert rec["table"] == [c, cfg.padded_vocab // ranks,
                                    cfg.d_model]
            assert rec["shapes"][0] == [2, SEQ, c, cfg.padded_vocab]
            assert rec["shapes"][2] == [2, 1, c, cfg.padded_vocab]
        else:
            e, d = cfg.frontend.embed_dim, cfg.d_model
            assert rec["proj"] == [[e, d], [d, d]]
            assert rec["shapes"][0] == [2, SEQ, cfg.padded_vocab]
