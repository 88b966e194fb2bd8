"""Training: the train-step factory (gradients of ``LM.loss`` through the
rematerialised layers, then AdamW), on one device or data-parallel over a
mesh's ``data`` axis, and a host-side ``Trainer`` with checkpointing and
metric logging.

The port of ``repro.training.train_loop``. ``repro`` jits the step; the
port runs it eagerly (no graph capture): ``torch.autograd.grad`` of
``lm.loss(params, batch, train=True)`` over every parameter leaf, whose
backward goes through the hand-written backward kernels on the card
(``kernels.flash_attention``'s and ``kernels.rglru_scan``'s autograd
Functions), then ``optim.adamw_update`` with its global-norm clip. Params
and optimizer state are the same trees as ``repro``'s, and a checkpoint of
``(params, opt)`` has ``repro``'s key paths, so either package restores
the other's.

On a mesh (``mesh=``, a ``launch.mesh.HostMesh``) a rank holds its
shards under ``repro``'s train rules, FSDP params and ZeRO moments
(``launch.sharding_rules``), and its rows of the global batch
(``data.loader.ShardedLoader``). A step gathers the params whole over
'data' (one collective a dtype), takes this rank's share of the global
loss (``LM.loss``'s ``denoms``: the cross entropies over the global label
counts; the MoE aux loss over the global token fractions,
``models.moe.route``), so the shares' gradients add up to the global
batch's, reduce-scatters the gradients of the split leaves and
all-reduces those of the leaves the rules keep whole (one collective
each), then runs AdamW on the rank's shards, whose clip takes the global
norm. Whole leaves are checkpointed, gathered and written by rank 0.

On a model axis above 1 (``repro``'s production meshes) the leaves the
train rules split on 'model' stay cut after the gather over 'data', and
the loss runs tensor-parallel on the rank's model group
(``sharding.tensor_parallel(..., mode="train")``: Megatron's conjugate
collectives of ``launch.mesh`` inside autograd, the cross entropy
vocab-parallel). Every rank of a model group then holds its shards'
whole gradients, except where a leaf is whole on every rank but read in
part (``partial_leaves``: inside a region split on 'model', such as GQA's
wk/wv over KV heads that do not divide and its q/k norm scales): their
gradients are partial sums, added over 'model' in one f32 all-reduce. A
whole leaf that every rank reads alike (the norm scales before a split
region, a mixer whose dims do not divide) already has its whole
gradient and is not summed. Every family trains so: GQA, MLA, dense
and MoE MLPs (the router's (T, E) logits gathered before the top-k, each
rank weighing its experts' part), the RG-LRU, mLSTM and sLSTM, the
vision and audio frontends and DeepSeek's MTP head.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.models.model import LM
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.tree import (flat_paths, tree_leaves, tree_map,
                                    tree_map_with_path)


def loss_and_grads(lm: LM, params, batch, denoms=None, over_data=None,
                   mesh=None):
    """``lm.loss(params, batch, train=True, denoms=, over_data=, mesh=)``,
    its metrics and its gradient (a tree like ``params``; zeros for a leaf
    the loss does not read), all detached."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, metrics = lm.loss(params, batch, train=True, denoms=denoms,
                                over_data=over_data, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], params))


def train_splits(mesh, lm: LM, axis: str = "data"):
    """The dim each leaf of ``lm``'s params is cut on over ``axis`` ("data"
    or "model") under the train rules (-1: whole), a tree like the
    params."""
    from repro_torch.serving.sharding import param_shardings

    def walk(spec):
        if isinstance(spec, dict):
            return {k: walk(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [walk(v) for v in spec]
        for dim, ax in enumerate(spec):
            if ax == axis or (isinstance(ax, tuple) and axis in ax):
                return dim
        return -1

    return walk(param_shardings(mesh, lm, mode="train"))


def partial_leaves(mesh, lm: LM):
    """A tree like the params: True for a leaf whose gradient on a rank is
    a partial sum over the mesh's model ranks. Such a leaf is whole on
    every rank (the train rules do not split it on 'model') but lies inside
    a region split on 'model', where each rank reads its part of it: the
    mixer and MLP modules name the leaves they read inside their regions
    (``LM.region_reads``), such as GQA's wk/wv over KV heads that do not
    divide and its q/k norm scales. Every other whole leaf (the norm scales
    before a region, a mixer or MLP whose dims do not divide) is read
    alike on every rank from replicated activations, and its gradient is
    already whole. All False on a 1-way model axis."""
    from repro_torch.configs.base import ATTN, MLA, SWIGLU, BlockDef
    from repro_torch.sharding import tensor_parallel

    dims = train_splits(mesh, lm, "model")
    out = tree_map(lambda _: False, dims)
    if int(mesh.shape["model"]) == 1:
        return out
    tp = tensor_parallel(lm.cfg, mesh, mode="train")

    def block(d, bdef):
        reads = lm.region_reads(bdef, d, tp)
        return {part: {k: tree_map(lambda x: x < 0 and k in reads[part], v)
                       for k, v in sub.items()} if part in reads
                else tree_map(lambda _: False, sub)
                for part, sub in d.items()}

    out["stages"] = [
        {f"b{i}": block(sd[f"b{i}"], bdef)
         for i, bdef in enumerate(stage.blocks)}
        for stage, sd in zip(lm.cfg.stages, dims["stages"])]
    if "mtp" in dims:
        mixer = MLA if lm.cfg.mla is not None else ATTN
        out["mtp"]["block"] = block(dims["mtp"]["block"],
                                    BlockDef(mixer=mixer, mlp=SWIGLU))
    return out


def sum_partials(mesh, grads, partial):
    """``grads`` (leaves) with each ``partial`` leaf's gradient summed over
    'model': one f32 all-reduce of them all, each back in its dtype."""
    idx = [i for i, p in enumerate(partial) if p]
    if not idx:
        return list(grads)
    out = list(grads)
    flat = mesh.all_reduce(torch.cat([grads[i].float().reshape(-1)
                                      for i in idx]), axis="model")
    off = 0
    for i in idx:
        g = grads[i]
        out[i] = flat[off:off + g.numel()].reshape(g.shape).to(g.dtype)
        off += g.numel()
    return out


def clip_axes(mesh, lm: LM):
    """A tree like the params: the mesh axes (of more than one rank) each
    leaf is cut over under the train rules ("data", "model", "data,model"
    or ""), which the clip's global norm sums its squares over
    (``optim.adamw``)."""
    wide = {a: int(mesh.shape[a]) > 1 for a in ("data", "model")}
    return tree_map(lambda d, m: ",".join(
        a for a, cut in (("data", d >= 0), ("model", m >= 0))
        if cut and wide[a]),
        train_splits(mesh, lm), train_splits(mesh, lm, "model"))


def place_train_params(mesh, lm: LM, params):
    """This rank's FSDP shards of whole ``params`` (the train rules)."""
    from repro_torch.serving.sharding import place_params
    return place_params(mesh, lm, params, mode="train")


def rebuild(tree, leaves):
    """A tree like ``tree`` whose leaves are ``leaves``, in
    ``tree_leaves``' order."""
    by_key = dict(zip(flat_paths(tree), leaves))
    return tree_map_with_path(lambda key, _: by_key[key], tree)


def _by_dtype(tensors):
    """Indices of ``tensors`` grouped by dtype, in first-seen order."""
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def gather_whole(mesh, leaves, dims, axis: str = "data"):
    """Each leaf of ``leaves`` whole over ``axis``: a leaf cut on
    ``dims[i]`` (>= 0) is joined from every rank's shard on the axis, one
    gather of the flat shards a dtype; a whole leaf (-1) is returned as it
    is."""
    out = list(leaves)
    n = mesh.shape[axis]
    cut = [i for i, d in enumerate(dims) if d >= 0]
    for idx in _by_dtype([leaves[i] for i in cut]):
        ts = [leaves[cut[j]] for j in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        every = mesh.gather(flat[None], 0, axis=axis)      # (n, total)
        off = 0
        for j, t in zip(idx, ts):
            k = dims[cut[j]]
            part = every[:, off:off + t.numel()].reshape((n,) + t.shape)
            shape = list(t.shape)
            shape[k] *= n
            out[cut[j]] = part.movedim(0, k).reshape(shape)
            off += t.numel()
    return out


def reduce_grads(mesh, grads, dims):
    """The global gradient's shard of each leaf: a leaf cut on ``dims[i]``
    gets its rows of the sum over the data ranks (one reduce-scatter of
    every such leaf, f32), a whole leaf the whole sum (one all-reduce),
    each back in its own dtype."""
    n = mesh.shape["data"]
    out = list(grads)
    cut = [i for i, d in enumerate(dims) if d >= 0]
    whole = [i for i, d in enumerate(dims) if d < 0]
    if cut:
        rows = []
        for i in cut:
            g, k = grads[i], dims[i]
            shape = list(g.shape)
            shape[k:k + 1] = [n, shape[k] // n]
            rows.append(g.float().reshape(shape).movedim(k, 0).reshape(n, -1))
        mine = mesh.reduce_scatter(torch.cat(rows, 1), axis="data")
        off = 0
        for i in cut:
            g, k = grads[i], dims[i]
            shape = list(g.shape)
            shape[k] //= n
            size = g.numel() // n
            out[i] = mine[off:off + size].reshape(shape).to(g.dtype)
            off += size
    if whole:
        flat = torch.cat([grads[i].float().reshape(-1) for i in whole])
        flat = mesh.all_reduce(flat, axis="data")
        off = 0
        for i in whole:
            g = grads[i]
            out[i] = flat[off:off + g.numel()].reshape(g.shape).to(g.dtype)
            off += g.numel()
    return out


def make_train_step(lm: LM, lr_schedule: Callable,
                    weight_decay: float = 0.01,
                    grad_clip: float = 1.0, mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): forward (+ MoE aux, + MTP) with every layer rematerialised,
    backward, global grad-norm clip, AdamW. ``metrics`` holds 0-dim
    tensors ``loss``, ``lr``, ``ce``, ``aux`` (and ``mtp``) on the model's
    device; reading them syncs the host, so the step itself never does.
    On a ``mesh`` the params and moments are this rank's shards, the batch
    its rows, and the step equals the one-device step on the global batch
    (module docstring); ``metrics`` are the global batch's."""
    if mesh is not None:
        return _mesh_train_step(lm, lr_schedule, weight_decay, grad_clip,
                                mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(lm, params, batch)
        lr = lr_schedule(opt_state.step)
        params_new, opt_new = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            grad_clip=grad_clip)
        return params_new, opt_new, {"loss": loss, "lr": lr, **metrics}

    return train_step


def mesh_loss_and_grads(lm: LM, mesh, params, batch, dims=None,
                        partial=None):
    """On a (data, model) mesh: the global batch's loss and metrics (every
    rank's share summed over 'data') and this rank's shards of its
    gradient, from this rank's param shards and batch rows. ``dims``: the
    leaves' split dims over 'data' (``train_splits``' leaves);
    ``partial``: ``partial_leaves``' leaves."""
    if dims is None:
        dims = tree_leaves(train_splits(mesh, lm))
    if partial is None:
        partial = tree_leaves(partial_leaves(mesh, lm))
    tensor = int(mesh.shape["model"]) > 1
    # on a 1-way data axis every leaf is whole over it already
    data = int(mesh.shape["data"]) > 1

    def over_data(t):
        return mesh.all_reduce(t, axis="data")

    whole = (rebuild(params, gather_whole(mesh, tree_leaves(params), dims))
             if data else params)
    counts = over_data(lm.label_counts(batch))
    denoms = {"ce": counts[0]}
    if counts.numel() > 1:
        denoms["mtp"] = counts[1]
    loss, metrics, grads = loss_and_grads(lm, whole, batch, denoms,
                                          over_data,
                                          mesh if tensor else None)
    del whole
    grads = tree_leaves(grads)
    if data:
        grads = reduce_grads(mesh, grads, dims)
    grads = rebuild(params, sum_partials(mesh, grads, partial))
    names = list(metrics)
    shares = over_data(torch.stack([loss] + [metrics[k].float()
                                             for k in names]))
    return shares[0], {k: shares[i + 1] for i, k in enumerate(names)}, grads


def _mesh_train_step(lm, lr_schedule, weight_decay, grad_clip, mesh):
    dims = tree_leaves(train_splits(mesh, lm))
    partial = tree_leaves(partial_leaves(mesh, lm))
    split = clip_axes(mesh, lm)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = mesh_loss_and_grads(lm, mesh, params, batch,
                                                   dims, partial)
        lr = lr_schedule(opt_state.step)
        params_new, opt_new = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            grad_clip=grad_clip, mesh=mesh, split=split)
        return params_new, opt_new, {"loss": loss, "lr": lr, **metrics}

    return train_step


def make_eval_step(lm: LM) -> Callable:
    """eval_step(params, batch) -> {"loss", "ce", "aux"}: the loss without
    remat or MTP, no gradient."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = lm.loss(params, batch, train=False)
        return {"loss": loss, **metrics}
    return eval_step


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    """Host loop: iterate batches (moved to the model's device), step,
    checkpoint every ``ckpt_every`` steps, log every ``log_every`` (and
    the last) step into ``history``. On a ``mesh`` (data-parallel, module
    docstring) every rank runs the loop on its rows and shards; a
    checkpoint holds the whole leaves, which rank 0 writes, and restores
    on any number of ranks."""

    def __init__(self, lm: LM, lr_schedule, *, ckpt_dir: Optional[str] = None,
                 opt_state_dtype=torch.float32, weight_decay: float = 0.01,
                 log_every: int = 10, ckpt_every: int = 100, mesh=None):
        self.lm = lm
        self.mesh = mesh
        self.ckpt_dir = ckpt_dir
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.opt_state_dtype = opt_state_dtype
        self.train_step = make_train_step(lm, lr_schedule, weight_decay,
                                          mesh=mesh)
        self._dims = None if mesh is None else {
            axis: tree_leaves(train_splits(mesh, lm, axis))
            for axis in ("data", "model")}
        self.history: list = []

    def init_state(self, seed: int):
        """Random params from ``seed`` (``LM.init``, drawn on the model's
        device; on a mesh this rank's shards of them) and a fresh AdamW
        state."""
        params = self.lm.init(seed, on_device=True, mesh=self.mesh,
                              mode="train")
        return params, adamw_init(params, self.opt_state_dtype)

    def whole_state(self, params, opt):
        """(params, opt) with every leaf whole: on a mesh each split leaf
        gathered over the data ranks, then the model ranks (every rank
        takes part)."""
        if self.mesh is None:
            return params, opt

        def join(tree):
            leaves = tree_leaves(tree)
            for axis in ("data", "model"):
                leaves = gather_whole(self.mesh, leaves, self._dims[axis],
                                      axis)
            return rebuild(tree, leaves)

        return join(params), opt._replace(mu=join(opt.mu), nu=join(opt.nu))

    def save(self, step: int, params, opt) -> None:
        """Checkpoint the whole (params, opt) at ``step`` in ``repro``'s key
        paths (on a mesh rank 0 writes)."""
        params, opt = self.whole_state(params, opt)
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(self.ckpt_dir, step, (params, opt))
        if self.mesh is not None:
            self.mesh.barrier()     # every rank sees the checkpoint

    def restore_or_init(self, seed: int):
        """The newest checkpoint in ``ckpt_dir`` (into the structure,
        dtypes and device of a fresh state; on a mesh cut to this rank's
        shards), or the fresh state."""
        params, opt = self.init_state(seed)
        if self.ckpt_dir and latest_step(self.ckpt_dir) is not None:
            (params, opt), step = load_checkpoint(
                self.ckpt_dir, self.whole_state(params, opt))
            if self.mesh is not None:
                params = place_train_params(self.mesh, self.lm, params)
                opt = opt._replace(
                    mu=place_train_params(self.mesh, self.lm, opt.mu),
                    nu=place_train_params(self.mesh, self.lm, opt.nu))
            print(f"[trainer] restored step {step} from {self.ckpt_dir}")
        return params, opt

    def fit(self, params, opt, batches: Iterator[Dict[str, Any]],
            num_steps: int, echo: bool = True):
        t0 = time.time()
        for i in range(num_steps):
            batch = to_device(next(batches), self.lm.device)
            params, opt, metrics = self.train_step(params, opt, batch)
            if i % self.log_every == 0 or i == num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = round(time.time() - t0, 2)
                self.history.append(m)
                if echo and (self.mesh is None or self.mesh.rank == 0):
                    print(f"[trainer] step {i:5d} loss {m['loss']:.4f} "
                          f"lr {m['lr']:.2e} ({m['wall_s']}s)")
            if (self.ckpt_dir and self.ckpt_every
                    and (i + 1) % self.ckpt_every == 0):
                self.save(i + 1, params, opt)
        return params, opt
