"""Training on a model axis above 1 against the port's one-device step.

``make_train_step(..., mesh=)`` on a (D, M) gloo mesh with M > 1: params
and AdamW moments cut by the train rules on both axes, the loss run
tensor-parallel on each model group (``launch.mesh``'s collectives under
autograd, the cross entropy vocab-parallel), the gradients of the whole
leaves that a rank reads in part summed over 'model', the clip's norm over
both axes. On a (1, 2) mesh for every family (GQA with and without
qk-norm, tied and untied tables, SwiGLU and GeGLU, a depth-1 MTP head, the
RG-LRU hybrid, MoE, MLA with MoE and MTP, xLSTM, the vision and audio
frontends) and on a (2, 2) mesh for dense GQA and MoE, from the same seed
and
global batches as ``mesh=None``, in f32, each of 2 steps against the
one-device step from the state the mesh's step began from (as phase
22(c) holds data-parallel steps: AdamW's step of a gradient near its eps
turns on the last bits, so states compared after several steps part
where no step did): the loss within ``LOSS_TOL``, the first step's
gradient every leaf's within ``GRAD_TOL`` of its max |g|, the moments
within ``GRAD_TOL`` of each leaf's max and the params within
``PARAM_TOL`` max |p| + ``STEP_TOL`` lr (an element whose gradient or
first moment is within ``GRAD_TOL`` of zero may step the other way, at
most 2 lr); a step's collectives equal the design's count. A model with 2 KV heads on 4 ranks: its whole
wk/wv read in part need the sum over 'model' (each rank's own gradient is
wrong) and its norm scales must not get it (summed, they are wrong by the
factor 4). ``Trainer`` on the mesh checkpoints whole leaves that one
device restores; ``launch/train.py --mesh-model 2`` logs the losses of
``--mesh-model 1``.

The rank workers import only torch, numpy and ``repro_torch``. Alone
(``-p xdist -n 1``) the file takes ~35 s, the collectives' file ~15 s.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
STEP_TOL = 1e-4      # of lr
LR = 1e-3
STEPS = 2
B, S = 4, 16
# (1, 2): every family; (2, 2): dense GQA and MoE
FAMILIES = {"qwen3": ("qwen3-4b", {}), "glm4": ("glm4-9b", {}),
            "starcoder2": ("starcoder2-7b", {}),
            "mtp": ("smollm-135m", {"mtp_depth": 1}),
            "hybrid": ("recurrentgemma-9b", {}),
            "moe": ("mixtral-8x22b", {}), "mla": ("deepseek-v3-671b", {}),
            "xlstm": ("xlstm-125m", {}), "vision": ("internvl2-2b", {}),
            "audio": ("musicgen-medium", {})}
GRID = {"qwen3": ("qwen3-4b", {}), "starcoder2": ("starcoder2-7b", {}),
        "moe": ("mixtral-8x22b", {})}
# 2 KV heads under 8 query heads (qk-norm on) on 4 ranks: every rank holds
# wk/wv whole and reads one KV head of them
KV2 = ("qwen3-4b", {"num_heads": 8, "num_kv_heads": 2})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(),
                               param_dtype="float32", **kw)


def _batch(cfg, seed):
    """A global batch: text (B, S), audio (B, S, C) codebook tokens, or
    text behind a vision model's unit-norm image embeddings; some labels
    masked."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    shape = (B, S, fe.num_codebooks) if fe.kind == "audio" else (B, S)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int64)
    labels = np.roll(toks, -1, 1).copy()
    labels[:, -1] = -1
    labels[0, 5:] = -1
    batch = {"tokens": toks, "labels": labels}
    if fe.kind == "vision":
        img = rng.standard_normal((B, fe.num_prefix_tokens, fe.embed_dim))
        batch["image_embeds"] = (img / np.linalg.norm(
            img, axis=-1, keepdims=True)).astype(np.float32)
    return batch


def _schedule(step):
    return torch.full((), LR, dtype=torch.float32)


# -- rank workers (spawned: module-level, no JAX) -----------------------------

def _whole(mesh, lm, tree):
    from repro_torch.training.train_loop import (gather_whole, rebuild,
                                                 train_splits)
    from repro_torch.utils.tree import tree_leaves
    leaves = tree_leaves(tree)
    for axis in ("data", "model"):
        leaves = gather_whole(mesh, leaves, tree_leaves(
            train_splits(mesh, lm, axis)), axis)
    return rebuild(tree, leaves)


def _train(mesh, name, kw):
    """``STEPS`` steps of ``make_train_step(mesh=)`` on the family's
    batches: the losses, the first step's gradient, the params and moments
    after each step, whole, and each step's collectives."""
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw_init
    from repro_torch.training.train_loop import (make_train_step,
                                                 mesh_loss_and_grads)

    cfg = _cfg(name, kw)
    lm = LM(cfg, device="cpu")
    params = lm.init(0, mesh=mesh, mode="train")
    opt = adamw_init(params)
    step = make_train_step(lm, _schedule, mesh=mesh)
    rec = dict(losses=[], counts=[], states=[])
    for i in range(STEPS):
        rows = next(ShardedLoader(iter([_batch(cfg, i)]), mesh=mesh))
        if i == 0:
            _, _, g = mesh_loss_and_grads(lm, mesh, params, rows)
            rec["grads"] = _whole(mesh, lm, g)
        before = dict(COLLECTIVES)
        params, opt, m = step(params, opt, rows)
        rec["counts"].append({k: v - before.get(k, 0)
                              for k, v in COLLECTIVES.items()
                              if v != before.get(k, 0)})
        rec["losses"].append(float(m["loss"]))
        rec["states"].append(tuple(_whole(mesh, lm, t)
                                   for t in (params, opt.mu, opt.nu)))
    return rec


def _kv2(mesh):
    """The 2-KV-head model's gradient as a rank has it before the sum over
    'model' (``loss_and_grads`` on the mesh) and after it."""
    from repro_torch.models.model import LM
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 mesh_loss_and_grads)

    cfg = _cfg(*KV2)
    lm = LM(cfg, device="cpu")
    params = lm.init(0, mesh=mesh, mode="train")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    _, _, own = loss_and_grads(lm, params, batch, mesh=mesh)
    loss, _, summed = mesh_loss_and_grads(lm, mesh, params, batch)
    return dict(loss=float(loss), own=own, summed=summed,
                kv_range=mesh.model_rank * 2 // 4)


def tp_worker(rank, out_dir, ckpt_dir):
    torch.set_num_threads(1)
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.training import Trainer

    world = torch.distributed.get_world_size()
    rec = {}
    if world == 2:
        mesh = make_host_mesh(2)
        for fam, (name, kw) in FAMILIES.items():
            rec[fam] = _train(mesh, name, kw)
        # Trainer: 2 steps, a checkpoint of whole leaves by rank 0
        name, kw = FAMILIES["glm4"]
        cfg = _cfg(name, kw)
        trainer = Trainer(LM(cfg, device="cpu"), _schedule,
                          ckpt_dir=ckpt_dir, ckpt_every=2, mesh=mesh)
        p, o = trainer.init_state(0)
        loader = ShardedLoader(iter([_batch(cfg, 0), _batch(cfg, 1)]),
                               mesh=mesh)
        p, o = trainer.fit(p, o, loader, 2, echo=False)
        rec["trainer"] = dict(params=_whole(mesh, trainer.lm, p),
                              history=[h["loss"] for h in trainer.history])
    else:
        mesh = make_host_mesh(2)
        for fam, (name, kw) in GRID.items():
            rec[fam] = _train(mesh, name, kw)
        rec["kv2"] = _kv2(make_host_mesh(4))
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))


# -- the parent ----------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"tp{n}")
        spawn(tp_worker, n, args=(str(tmp), str(tmp / "ckpt")),
              rendezvous=f"file://{tmp / 'rendezvous'}", timeout_s=300.0)
        out[n] = ([torch.load(tmp / f"rank{r}.pt") for r in range(n)],
                  tmp / "ckpt")
    return out


def _one_device(name, kw, states):
    """The one-device steps of ``_train``, each from the state the mesh's
    step began from (the init, then ``states[i - 1]``): per step (loss,
    gradient, params, mu, nu)."""
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)

    cfg = _cfg(name, kw)
    lm = LM(cfg, device="cpu")
    params = lm.init(0)
    opt = adamw_init(params)
    step = make_train_step(lm, _schedule)
    out = []
    for i in range(STEPS):
        if i:
            params, mu, nu = states[i - 1]
            opt = AdamWState(step=torch.tensor(i, dtype=torch.int32), mu=mu,
                             nu=nu)
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, i).items()}
        _, _, grads = loss_and_grads(lm, params, batch)
        new, o, m = step(params, opt, batch)
        out.append((float(m["loss"]), grads, new, o.mu, o.nu))
    return out


def _close(got, want, tol):
    from repro_torch.utils.tree import flat_paths
    a, b = flat_paths(got), flat_paths(want)
    assert set(a) == set(b)
    for k in b:
        scale = float(b[k].abs().max())
        assert float((a[k] - b[k]).abs().max()) <= tol * max(scale, 1e-30), k


def _close_params(got, want, grads, mu):
    from repro_torch.utils.tree import flat_paths
    a, b = flat_paths(got), flat_paths(want)
    g, mu = flat_paths(grads), flat_paths(mu)
    for k in b:
        off = (a[k] - b[k]).abs()
        assert float(off.max()) <= 2.5 * LR, k
        tol = PARAM_TOL * float(b[k].abs().max()) + STEP_TOL * LR
        tiny = ((g[k].abs() <= GRAD_TOL * float(g[k].abs().max()))
                | (mu[k].abs() <= GRAD_TOL * float(mu[k].abs().max())))
        assert not bool(((off > tol) & ~tiny).any()), k


def _regions(tp, bdef):
    """A block's collectives over 'model': (its forward's, its backward's,
    whether its last op is one)."""
    i = int
    if bdef.mixer in ("attn", "mla"):
        on = i(tp.heads if bdef.mixer == "attn" else tp.mla_heads)
        f, b, last = on, on, on
    elif bdef.mixer == "rglru":
        f, b, last = 2 * i(tp.lru), 2 * i(tp.lru), i(tp.lru)
    elif bdef.mixer == "mlstm":
        f, b, last = i(tp.rec_heads), i(tp.rec_heads), i(tp.rec_heads)
    else:       # sLSTM: the gather after its loop; its GeGLU
        f = b = i(tp.rec_heads) + i(tp.rec_mlp)
        last = i(tp.rec_mlp)
    if bdef.mlp == "moe":
        routed = i(tp.experts or tp.expert_mlp)
        entry = i(bool(routed or tp.router or tp.shared_mlp))
        f, b, last = f + i(tp.router) + entry, b + entry + routed, entry
    elif bdef.mlp != "none":
        f, b, last = f + i(tp.mlp), b + i(tp.mlp), i(tp.mlp)
    return f, b, last


def _design_counts(cfg, ranks, data):
    """The collectives of one step on a (data, ranks) mesh by the design
    (``PERF.md`` §6). Over 'model': a scanned layer's forward ends
    each split region with its collective (an all-reduce of partial sums,
    two for the RG-LRU's gates and ``w_out``; the router's and the sLSTM's
    gathers), its remat runs them again but for the layer's last op (the
    checkpoint stops once it has what the backward needs), its backward
    sums the gradient at each region's entry (the RG-LRU's gates' cut and
    MoE's combine weights one more each); the MTP block, outside the
    checkpoint, once each way; then, with the vocab split, the embedding's
    reduce, the loss's max and its joined sums and the unembedding's entry
    (again for the MTP head); one sum of the partial leaves (when any);
    the clip's model norm. Over 'data' (above 1): one gather of the params
    (one dtype), the label counts, a reduce-scatter of the cut leaves'
    gradients and an all-reduce of the whole ones' (where there are any),
    the metrics and the clip's norm, and a MoE layer's global routing
    counts for its aux loss (forward and remat). gloo counts every one as
    an all-reduce."""
    from repro_torch.configs.base import ATTN, MLA, SWIGLU, BlockDef
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding import tensor_parallel

    tp = tensor_parallel(cfg, AbstractMesh(ranks), mode="train")
    head = 4 * int(tp.vocab)
    model = 0
    for stage in cfg.stages:
        parts = [_regions(tp, bdef) for bdef in stage.blocks]
        model += stage.repeat * (2 * sum(p[0] for p in parts)
                                 - parts[-1][2] + sum(p[1] for p in parts))
    mixers = {b.mixer for st in cfg.stages for b in st.blocks}
    if cfg.mtp_depth:
        f, b, _ = _regions(tp, BlockDef(mixer=MLA if cfg.mla else ATTN,
                                        mlp=SWIGLU))
        model += f + b + head
    partial = (("attn" in mixers and tp.heads
                and (cfg.use_qk_norm or not tp.kv))
               or ("mla" in mixers and tp.mla_heads))
    model += head + int(bool(partial)) + 1
    counts = {"all_reduce/model": model}
    if data > 1:
        from repro_torch.models.model import LM
        from repro_torch.training.train_loop import train_splits
        from repro_torch.utils.tree import tree_leaves
        dims = tree_leaves(train_splits(AbstractMesh(ranks, data),
                                        LM(cfg, device="cpu")))
        moe = sum(st.repeat for st in cfg.stages for b in st.blocks
                  if b.mlp == "moe")
        counts["all_reduce/data"] = (1 + 1 + int(min(dims) < 0)
                                     + int(max(dims) >= 0) + 1 + 1
                                     + 2 * moe)
    return counts


def _fam_cases():
    return [(2, f) for f in FAMILIES] + [(4, f) for f in GRID]


@pytest.mark.parametrize("ranks,fam", _fam_cases(),
                         ids=lambda x: str(x))
def test_a_tensor_parallel_step_equals_the_one_device_step(worlds, ranks,
                                                           fam):
    """Each step's loss, the first gradient (every leaf joined from its
    shards), the moments and the params after each AdamW step equal the
    one-device step's from the same state on the same global batch, on
    every rank; each step issues the design's collectives."""
    name, kw = (FAMILIES if ranks == 2 else GRID)[fam]
    recs, _ = worlds[ranks]
    want = _one_device(name, kw, recs[0][fam]["states"])
    data = ranks // 2
    for r, rec in enumerate(recs):
        got = rec[fam]
        assert got["losses"] == recs[0][fam]["losses"]
        _close(got["grads"], want[0][1], GRAD_TOL)
        for i, (loss, grads, params, mu, nu) in enumerate(want):
            assert abs(got["losses"][i] - loss) <= LOSS_TOL * abs(loss), (
                r, i, got["losses"], loss)
            p, m, v = got["states"][i]
            _close(m, mu, GRAD_TOL)
            _close(v, nu, GRAD_TOL)
            _close_params(p, params, grads, mu)
        design = _design_counts(_cfg(name, kw), 2, data)
        for c in got["counts"]:
            assert c == design, (r, c, design)


def test_kv2_on_4_ranks_sums_what_is_read_in_part(worlds):
    """2 KV heads on 4 ranks: each rank's own gradient of wk/wv (and of
    the q/k norm scales) holds only its query heads' part, so it is wrong
    unsummed; summed over 'model' it is the one-device gradient. A norm
    scale that every rank reads alike is whole on each rank, and a sum
    over 'model' would make it 4 times too large."""
    from repro_torch.models.model import LM
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.utils.tree import flat_paths

    cfg = _cfg(*KV2)
    lm = LM(cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    loss, _, grads = loss_and_grads(lm, lm.init(0), batch)
    want = flat_paths(grads)
    recs, _ = worlds[4]
    for r, rec in enumerate(recs):
        got = rec["kv2"]
        assert abs(got["loss"] - float(loss)) <= LOSS_TOL * float(loss)
        own, summed = flat_paths(got["own"]), flat_paths(got["summed"])
        for key in ("stages/0/b0/mixer/wk", "stages/0/b0/mixer/wv",
                    "stages/0/b0/mixer/k_scale", "stages/0/b0/mixer/q_scale"):
            scale = float(want[key].abs().max())
            assert float((summed[key] - want[key]).abs().max()) <= \
                GRAD_TOL * scale, (r, key)
            assert float((own[key] - want[key]).abs().max()) > \
                100 * GRAD_TOL * scale, (r, key)
        for key in ("stages/0/b0/norm1/scale", "final_norm/scale"):
            scale = float(want[key].abs().max())
            assert float((summed[key] - want[key]).abs().max()) <= \
                GRAD_TOL * scale, (r, key)
            assert float((4 * own[key] - want[key]).abs().max()) > \
                100 * GRAD_TOL * scale, (r, key)


def _spec_leaves(tree):
    """A spec tree's leaves (tuples) in ``flat_paths``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def test_a_rank_holds_its_train_spec_shard():
    """What ``LM.init(..., mesh=, mode="train")`` gives a rank (the steps'
    start) is the slice of the whole init that the train rules' specs name
    (``cut_leaf``), on a (1, 2) and a (2, 2) mesh."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import cut_leaf, param_shardings
    from repro_torch.utils.tree import flat_paths

    class Rank(AbstractMesh):
        def __init__(self, model, data, r):
            super().__init__(model, data)
            self.rank, self.model_rank, self.data_rank = r, r % model, \
                r // model

        def axis_rank(self, axis):
            return {"model": self.model_rank, "data": self.data_rank}[axis]

    for name, kw in (FAMILIES["glm4"], FAMILIES["hybrid"]):
        lm = LM(_cfg(name, kw), device="cpu")
        whole = flat_paths(lm.init(0))
        for model, data in ((2, 1), (2, 2)):
            for r in range(model * data):
                mesh = Rank(model, data, r)
                specs = dict(zip(whole, _spec_leaves(
                    param_shardings(mesh, lm, "train"))))
                got = flat_paths(lm.init(0, mesh=mesh, mode="train"))
                for k, w in whole.items():
                    want = cut_leaf(mesh, w, specs[k], tuple(w.shape))
                    assert torch.equal(got[k], want), (name, model, data, k)


def test_train_mode_reads_the_train_specs():
    """``TensorParallel``'s model fields in train mode come from the train
    rules' specs: mixtral's routed experts split on 'model' alone (chunk m
    of them), where decode on a data axis spreads them over ("data",
    "model")."""
    from repro_torch.configs import get_config
    from repro_torch.sharding import _leaf_splits

    cfg = get_config("mixtral-8x22b")
    train = _leaf_splits(cfg, 4, 1, "train")
    decode = _leaf_splits(cfg, 4, 2, "decode")
    assert train["experts"] and train["router"] and not train["expert_mlp"]
    assert decode["data_experts"] and not train["data_experts"]


def test_trainer_checkpoint_restores_on_one_device(worlds):
    """``Trainer`` on a (1, 2) mesh checkpoints whole leaves (gathered over
    'model' too), which one device restores as the ranks' state."""
    from repro_torch.models.model import LM
    from repro_torch.training import Trainer
    from repro_torch.utils.tree import flat_paths

    recs, ckpt = worlds[2]
    assert recs[0]["trainer"]["history"] == recs[1]["trainer"]["history"]
    name, kw = FAMILIES["glm4"]
    trainer = Trainer(LM(_cfg(name, kw), device="cpu"), _schedule,
                      ckpt_dir=str(ckpt))
    params, opt = trainer.restore_or_init(3)
    assert int(opt.step) == 2
    a, b = flat_paths(params), flat_paths(recs[0]["trainer"]["params"])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _cli_losses(*flags):
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--steps", "3", "--batch", "4", "--seq", "16", *flags],
        capture_output=True, text=True, env=env, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    return [(int(line.split()[1]), float(line.split()[-1]))
            for line in out.stdout.splitlines() if line.startswith("step")]


def test_train_cli_on_a_model_axis_logs_the_one_device_losses():
    """``launch/train.py --device cpu --mesh-model 2`` (two gloo ranks,
    tensor-parallel) logs the losses of ``--mesh-model 1`` (one process),
    f32, steps 0 and 2, to the 4 decimals it prints (the steps' own parity
    is the test above's)."""
    one, two = _cli_losses(), _cli_losses("--mesh-model", "2")
    assert [s for s, _ in one] == [s for s, _ in two] == [0, 2]
    for (_, a), (_, b) in zip(two, one):
        assert abs(a - b) <= 1e-4, (two, one)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_in_chunks_equals_one_pass(monkeypatch, state_dtype):
    """``adamw_update`` takes a large leaf a chunk of rows at a time (the
    train step's transient memory on a card is a chunk's): with a chunk
    of 7 elements its params and moments equal one pass's bit for bit,
    clip binding, weight decay on, on a tree of leaves from 0-dim to 3-D
    whose rows do and do not divide the chunk."""
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_leaves

    gen = torch.Generator().manual_seed(5)
    dt = getattr(torch, state_dtype)
    params = {"a": torch.randn((5, 3, 4), generator=gen),
              "b": torch.randn((9, 2), generator=gen).bfloat16(),
              "c": torch.randn((), generator=gen), "d": torch.randn(
                  (33,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in params.items()}
    state = adamw.adamw_init(params, dt)
    state = state._replace(mu={k: torch.randn(v.shape, generator=gen).to(dt)
                               for k, v in params.items()},
                           nu={k: torch.rand(v.shape, generator=gen).to(dt)
                               for k, v in params.items()})
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    whole = adamw.adamw_update(params, grads, state, **kw)
    monkeypatch.setattr(adamw, "_CHUNK", 7)
    chunked = adamw.adamw_update(params, grads, state, **kw)
    for a, b in zip(tree_leaves(whole), tree_leaves(chunked)):
        assert a.dtype == b.dtype and torch.equal(a, b)
