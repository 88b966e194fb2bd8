"""Data-parallel training on a (D, 1) gloo mesh against the port's
one-device step on the global batch.

``repro``'s host leg of ``launch/train.py`` shards params (FSDP) and AdamW
moments (ZeRO) over 'data' by the train rules and splits the batch's
rows; the port's ``make_train_step(..., mesh=)`` gathers the params
whole, takes this rank's share of the global loss, reduce-scatters the
gradients and steps its shards. On 2 and 4 ranks (each world spawned once
for the module) and for a dense, an MoE (the aux loss over the global
token fractions) and an RG-LRU reduced config, in f32: the loss equals the
one-device loss within ``LOSS_TOL``, the reduced gradient every leaf's
within ``GRAD_TOL`` of that leaf's max |g|, and the params after one step
the one-device step's within ``PARAM_TOL`` of the leaf's max |p| plus
``STEP_TOL`` lr (AdamW's
first step is ~lr·sign(g), so an element whose gradient is within
``GRAD_TOL`` of zero may move by up to 2 lr the other way).
A batch whose rows differ in their label counts, which a mean of per-rank
means gets wrong; the clip at a norm that binds (``eps`` large enough that
AdamW's step depends on the gradient's scale); ``ShardedLoader``'s rows
against ``repro``'s ``batch_pspecs``; a checkpoint written by 2 ranks
restored on one device and on 2 ranks.

The rank workers import only torch, numpy and ``repro_torch``.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5
STEP_TOL = 1e-4      # of lr: AdamW's step of a gradient near eps in size
LR = 1e-3
MODELS = {"dense": "smollm-135m", "moe": "mixtral-8x22b",
          "rglru": "recurrentgemma-9b"}
B, S = 8, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops are tiny, and test workers that share
    the cores otherwise wait on each other's OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(name: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(),
                               param_dtype="float32")


def _lm(name):
    from repro_torch.models.model import LM
    cfg = _reduced(name)
    factor = (cfg.moe.num_experts / cfg.moe.num_experts_per_tok
              if cfg.moe else 1.25)
    return LM(cfg, device="cpu", capacity_factor=factor)


def _batch(cfg, seed=0, uneven=False):
    """A global (B, S) batch from a seed; with ``uneven`` the rows' label
    counts differ (rows of rank 0 mostly masked)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int64)
    labels = np.roll(toks, -1, 1).copy()
    labels[:, -1] = -1
    if uneven:
        labels[0, 2:] = -1
        labels[1, 5:] = -1
        labels[B - 1, 11:] = -1
    return {"tokens": toks, "labels": labels}


def _schedule(step):
    return torch.full((), LR, dtype=torch.float32)


# -- rank workers (spawned: module-level, no JAX) -----------------------------

def _whole(mesh, lm, tree):
    from repro_torch.training.train_loop import (gather_whole, rebuild,
                                                 train_splits)
    from repro_torch.utils.tree import tree_leaves
    return rebuild(tree, gather_whole(mesh, tree_leaves(tree), tree_leaves(
        train_splits(mesh, lm))))


def _grads(mesh, lm, params, batch):
    """The global loss and this rank's reduced gradient shards."""
    from repro_torch.training.train_loop import mesh_loss_and_grads
    loss, _, grads = mesh_loss_and_grads(lm, mesh, params, batch)
    return loss, grads


def dp_worker(rank, out_dir, batches, ckpt_dir):
    torch.set_num_threads(1)
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.training.train_loop import (Trainer, clip_axes,
                                                 make_train_step,
                                                 place_train_params)

    mesh = make_host_mesh(1)
    rec = {}
    for fam, name in MODELS.items():
        lm = _lm(name)
        params = place_train_params(mesh, lm, lm.init(0))
        for label, batch in batches[fam].items():
            rows = next(ShardedLoader(iter([batch]), mesh=mesh))
            loss, grads = _grads(mesh, lm, params, rows)
            step = make_train_step(lm, _schedule, grad_clip=1.0, mesh=mesh)
            new, opt, metrics = step(params, adamw_init(params), rows)
            rec[f"{fam}/{label}"] = dict(
                loss=loss, metric=metrics["loss"],
                grads=_whole(mesh, lm, grads),
                params=_whole(mesh, lm, new))
    # the clip at a binding norm, with eps = 1: AdamW's step then scales
    # with the clipped gradient
    lm = _lm(MODELS["dense"])
    params = place_train_params(mesh, lm, lm.init(0))
    rows = next(ShardedLoader(iter([batches["dense"]["even"]]), mesh=mesh))
    _, grads = _grads(mesh, lm, params, rows)
    new, _ = adamw_update(params, grads, adamw_init(params), lr=1.0,
                          eps=1.0, grad_clip=1e-2, mesh=mesh,
                          split=clip_axes(mesh, lm))
    rec["clip"] = _whole(mesh, lm, new)
    # a checkpoint written by the ranks, then restored on them
    trainer = Trainer(lm, _schedule, ckpt_dir=ckpt_dir, ckpt_every=2,
                      mesh=mesh)
    p, o = trainer.init_state(0)
    loader = ShardedLoader(iter([batches["dense"]["even"]] * 2), mesh=mesh)
    p, o = trainer.fit(p, o, loader, 2, echo=False)
    again = Trainer(lm, _schedule, ckpt_dir=ckpt_dir, mesh=mesh)
    p2, o2 = again.restore_or_init(5)
    rec["ckpt"] = dict(
        params=_whole(mesh, lm, p),
        same=all(torch.equal(a, b) for a, b in zip(
            *(list(_flat(t)) for t in ((p, o), (p2, o2))))),
        history=[h["loss"] for h in trainer.history])
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))


def _flat(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


# -- the parent --------------------------------------------------------------

def _spawn(tmp_path, nprocs, batches):
    from repro_torch.launch.mesh import spawn
    out = tmp_path / "out"
    out.mkdir()
    ckpt = tmp_path / "ckpt"
    spawn(dp_worker, nprocs, args=(str(out), batches, str(ckpt)),
          rendezvous=f"file://{tmp_path / 'rendezvous'}", timeout_s=300.0)
    return [torch.load(out / f"rank{r}.pt") for r in range(nprocs)], ckpt


# each family's batches: (seed, uneven)
_SEEDS = {(fam, label): (i + 10 * (label == "uneven"), label == "uneven")
          for i, fam in enumerate(MODELS) for label in ("even", "uneven")}


@pytest.fixture(scope="module")
def batches():
    return {fam: {label: _batch(_reduced(name), *_SEEDS[fam, label])
                  for label in ("even", "uneven")}
            for fam, name in MODELS.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, batches):
    return {n: _spawn(tmp_path_factory.mktemp(f"dp{n}"), n, batches)
            for n in (2, 4)}


@functools.lru_cache(maxsize=None)
def _one_device(fam, label):
    """The one-device loss, gradient and step of family ``fam``'s model on
    its ``label`` global batch (the same for every world)."""
    from repro_torch.optim import adamw_init
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)

    lm = _lm(MODELS[fam])
    params = lm.init(0)
    t = {k: torch.as_tensor(v) for k, v in _batch(
        _reduced(MODELS[fam]), *_SEEDS[fam, label]).items()}
    loss, _, grads = loss_and_grads(lm, params, t)
    new, _, _ = make_train_step(lm, _schedule, grad_clip=1.0)(
        params, adamw_init(params), t)
    return loss, grads, new


def _close_params(got, want, grads):
    """Each leaf within ``PARAM_TOL`` of its max |p| plus ``STEP_TOL`` lr
    (a gradient near AdamW's eps in size moves its step with its last
    bits), but where the
    one-device gradient is within ``GRAD_TOL`` of zero (of the leaf's max
    |g|: the gradients' own agreement), whose AdamW step may go either way
    (at most 2 lr)."""
    from repro_torch.utils.tree import flat_paths
    a, b, g = flat_paths(got), flat_paths(want), flat_paths(grads)
    assert set(a) == set(b)
    for k in b:
        tol = PARAM_TOL * float(b[k].abs().max()) + STEP_TOL * LR
        off = (a[k] - b[k]).abs()
        assert float(off.max()) <= 2.5 * LR, k
        tiny = g[k].abs() <= GRAD_TOL * float(g[k].abs().max())
        bad = (off > tol) & ~tiny
        assert not bool(bad.any()), (k, float(off[bad].max()), float(
            (g[k].abs()[bad] / g[k].abs().max()).min()))


@pytest.mark.parametrize("label", ["even", "uneven"])
@pytest.mark.parametrize("fam", list(MODELS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_a_data_parallel_step_equals_the_one_device_step(worlds, batches,
                                                         ranks, fam, label):
    """The loss (each rank's share summed over 'data'), every reduced
    gradient leaf and the params after one AdamW step equal the one-device
    step's on the global batch, on every rank; the step's ``loss`` metric
    is the global loss."""
    from repro_torch.utils.tree import flat_paths

    recs, _ = worlds[ranks]
    loss, grads, new = _one_device(fam, label)
    for r, rec in enumerate(recs):
        got = rec[f"{fam}/{label}"]
        for value in (got["loss"], got["metric"]):
            assert abs(float(value) - float(loss)) <= LOSS_TOL * abs(
                float(loss)), (r, float(value), float(loss))
        a, b = flat_paths(got["grads"]), flat_paths(grads)
        for k in b:
            scale = float(b[k].abs().max())
            assert float((a[k] - b[k]).abs().max()) <= GRAD_TOL * max(
                scale, 1e-30), (r, k)
        _close_params(got["params"], new, grads)


def test_uneven_masks_need_the_global_count(batches):
    """The uneven batch's global loss differs from a mean of per-rank
    means, which the data-parallel step therefore must not take."""
    from repro_torch.training.train_loop import loss_and_grads

    lm = _lm(MODELS["dense"])
    params = lm.init(0)
    batch = {k: torch.as_tensor(v) for k, v in batches["dense"][
        "uneven"].items()}
    whole, _, _ = loss_and_grads(lm, params, batch)
    for n in (2, 4):
        parts = [loss_and_grads(lm, params, {k: v[i * B // n:(i + 1) * B // n]
                                             for k, v in batch.items()})[0]
                 for i in range(n)]
        naive = float(sum(parts)) / n
        assert abs(naive - float(whole)) > 100 * LOSS_TOL * float(whole)


@pytest.mark.parametrize("ranks", [2, 4])
def test_the_clip_at_a_binding_norm_is_global(worlds, batches, ranks):
    """At a clip of 1e-2 (far below the gradient's norm), eps = 1 and lr =
    1, an AdamW step of the ranks' shards moves each leaf as the
    one-device step does, within 1e-3 of the move (and f32's rounding of
    the param): the norm sums every shard's squares over 'data' and the
    whole leaves' once."""
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.utils.tree import flat_paths, tree_leaves

    lm = _lm(MODELS["dense"])
    params = lm.init(0)
    batch = {k: torch.as_tensor(v) for k, v in batches["dense"][
        "even"].items()}
    _, _, grads = loss_and_grads(lm, params, batch)
    norm = float(torch.sqrt(sum(torch.sum(g * g)
                                for g in tree_leaves(grads))))
    assert norm > 10 * 1e-2
    want, _ = adamw_update(params, grads, adamw_init(params), lr=1.0,
                           eps=1.0, grad_clip=1e-2)
    recs, _ = worlds[ranks]
    start = flat_paths(params)
    for rec in recs:
        a, b = flat_paths(rec["clip"]), flat_paths(want)
        for k in b:
            moved = float((b[k] - start[k]).abs().max())
            ulp = 1e-7 * float(start[k].abs().max())
            assert float((a[k] - b[k]).abs().max()) <= 1e-3 * moved + ulp, k


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_loader_rows_follow_repro_batch_pspecs(ranks):
    """Each data rank's rows are the contiguous block ``repro``'s
    ``batch_pspecs`` gives it where the leading dim divides, the whole
    leaf elsewhere; on the rank's device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from repro.launch.sharding_rules import batch_pspecs
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.launch.mesh import AbstractMesh as TMesh

    host = {"tokens": np.arange(8 * 3).reshape(8, 3),
            "odd": np.arange(3 * 2).reshape(3, 2)}
    specs = batch_pspecs(AbstractMesh((ranks, 1), ("data", "model")),
                         {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
                          for k, v in host.items()})

    class Rank(TMesh):
        def __init__(self, d):
            super().__init__(1, ranks)
            self.d, self.device = d, torch.device("cpu")

        def axis_rank(self, axis):
            return self.d if axis == "data" else 0

    for d in range(ranks):
        got = next(ShardedLoader(iter([host]), mesh=Rank(d)))
        for k, v in host.items():
            split = len(specs[k]) > 0 and specs[k][0] == "data"
            want = np.split(v, ranks)[d] if split else v
            assert got[k].device.type == "cpu"
            assert np.array_equal(got[k].numpy(), want), (k, d)


@pytest.mark.parametrize("ranks", [2, 4])
def test_a_checkpoint_from_the_ranks_restores_on_one_device(worlds, ranks):
    """Two steps of ``Trainer`` on the ranks, checkpointed by rank 0 with
    whole leaves in ``repro``'s key paths: restored on one device it is the
    ranks' state gathered whole, and restored on the ranks their shards."""
    from repro_torch.optim import linear_warmup_cosine
    from repro_torch.training import Trainer
    from repro_torch.utils.tree import flat_paths

    recs, ckpt = worlds[ranks]
    for rec in recs:
        assert rec["ckpt"]["same"]
        assert rec["ckpt"]["history"] == recs[0]["ckpt"]["history"]
    lm = _lm(MODELS["dense"])
    trainer = Trainer(lm, linear_warmup_cosine(1e-3, 1, 4),
                      ckpt_dir=str(ckpt))
    params, opt = trainer.restore_or_init(3)
    assert int(opt.step) == 2
    a, b = flat_paths(params), flat_paths(recs[0]["ckpt"]["params"])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
