"""Logical activation axes and the rule resolver of tensor-parallel serving.

A copy of ``repro.sharding``'s names and of its ``resolve``. ``repro`` is
single-controller GSPMD: model code annotates activations with logical
axes (``hint``) and XLA partitions the program. The port is SPMD with one
process per rank and explicit collectives (``models.layers`` and
``models.attention`` reduce and gather where a split dimension ends), so
it has no activation hints. ``resolve`` is what placement uses: it maps a
leaf's logical axes to mesh axes, dropping a split whose dimension does
not divide.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch import mesh as mcoll

# logical activation axes
BATCH = "act_batch"
SEQ = "act_seq"
EMBED = "act_embed"
HEADS = "act_heads"
KV = "act_kv"
VOCAB = "act_vocab"
EXPERT = "act_expert"
EXP_SLOT = "act_exp_slot"
MLP = "act_mlp"

Spec = Tuple[object, ...]


def resolve(rules: Dict[str, object], axes: Sequence[Optional[str]],
            shape: Optional[Tuple[int, ...]] = None,
            mesh_shape: Optional[Dict[str, int]] = None) -> Spec:
    """Map logical axes to a spec: a tuple with, per dimension, a mesh-axis
    name, a tuple of them, or None (replicated). As ``repro``'s: a split is
    dropped when the dimension does not divide by the mesh axes' product,
    and a mesh axis is used at most once per spec, in logical-axis order.
    ``mesh_shape`` maps mesh-axis names to sizes."""
    spec = []
    used = set()
    for i, ax in enumerate(axes):
        mesh_axes = rules.get(ax) if ax is not None else None
        if mesh_axes is None:
            spec.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(m for m in mesh_axes if m not in used)
        if not mesh_axes:
            spec.append(None)
            continue
        if shape is not None and mesh_shape is not None:
            size = 1
            for m in mesh_axes:
                size *= mesh_shape[m]
            if shape[i] % size != 0:
                spec.append(None)
                continue
        used.update(mesh_axes)
        spec.append(tuple(mesh_axes) if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """How one rank runs a model on a (data, model) mesh: which dimensions
    its shards split (each exactly when the decode-mode placement rules
    split the leaves that hold it) and the KV heads its query heads read.

    On ``model`` (``ways`` ranks; ``rank`` is this rank's index inside its
    model group): ``kv_range`` is (first, count) in the KV-head dim of
    this rank's K/V (its own heads when they split, all of them when they
    are replicated). An MoE layer's routed experts split by expert
    (``experts``: this rank holds ``expert_range``, (first, count), of
    them) or, where the experts do not divide, by d_ff inside every expert
    (``expert_mlp``); the router's columns split with the experts
    (``router``); the shared expert by its d_ff (``shared_mlp``). MLA
    splits its heads (``mla_heads``: ``w_uq``, ``w_uk``, ``w_uv``, ``wo``)
    and keeps its down-projections and latents whole. The recurrent
    mixers split their width (``lru``: the RG-LRU's channels) or their
    heads (``rec_heads``: mLSTM and sLSTM), and the sLSTM's internal GeGLU
    its columns (``rec_mlp``). ``mlp`` is the dense MLP's d_ff; a model
    with no dense MLP (xLSTM, an all-MoE stack) has it False.

    On ``data`` (``data_ways`` ranks, this one ``data_rank``), the decode
    rules put d_model's contraction side (``EMBED``): ``data_proj`` for
    every input projection (attention's and MLA's, the dense and shared
    MLPs' ``w_gate``/``w_up``, the recurrent mixers' inputs, the vision
    projector's ``w2``), ``data_norm`` for the norm scales, ``data_table``
    for the embedding and unembedding tables' D, ``data_router`` for the
    router's rows, ``expert_data_in`` for the routed experts' D where
    they do not split by expert, and ``data_vision`` for ``vision_proj.
    w1``'s output dim. ``data_experts``: the routed experts split over
    ("data", "model"), each rank holding E/(D·M) of them by its place in
    the mesh. Every data field is False on a data-1 mesh."""
    mesh: object
    ways: int
    rank: int
    heads: bool           # query heads (wq, wo) split
    kv: bool              # KV heads (wk, wv, the K/V pools) split
    mlp: bool             # d_ff (w_gate, w_up, w_down) split
    vocab: bool           # the embedding and unembedding tables split
    kv_range: Tuple[int, int]
    experts: bool = False             # routed experts split by expert
    expert_range: Tuple[int, int] = (0, 0)
    expert_mlp: bool = False          # d_ff split inside every expert
    shared_mlp: bool = False          # the shared expert's d_ff split
    router: bool = False              # the router's expert columns split
    mla_heads: bool = False           # MLA's heads split
    lru: bool = False                 # the RG-LRU width split
    rec_heads: bool = False           # mLSTM / sLSTM heads split
    rec_mlp: bool = False             # the sLSTM GeGLU's columns split
    data_ways: int = 1
    data_rank: int = 0
    data_proj: bool = False           # input projections' D on data
    data_norm: bool = False           # norm scales on data
    data_table: bool = False          # the tables' D on data
    data_router: bool = False         # the router's D on data
    data_experts: bool = False        # routed experts on (data, model)
    expert_data_in: bool = False      # the routed experts' D on data
    data_vision: bool = False         # vision_proj.w1's output D on data

    def reduce(self, x, split: bool, axis: str = "model"):
        """Sum a row-parallel partial over the ranks of ``axis`` when
        ``split`` (``launch.mesh.reduce``: under autograd its gradient
        goes to every partial as it is)."""
        return mcoll.reduce(self.mesh, x, axis) if split else x

    def enter(self, x, split: bool):
        """``x``, a replicated activation, entering a region split over
        'model' when ``split`` (``launch.mesh.copy``: the identity, whose
        backward sums the ranks' partial gradients of ``x``)."""
        return mcoll.copy(self.mesh, x) if split else x

    def gather(self, x, dim: int, axis: str = "model"):
        """The ranks' slices of ``x`` joined along ``dim`` (``launch.mesh.
        gather``)."""
        return mcoll.gather(self.mesh, x, dim, axis)

    def scatter(self, x, dim: int, axis: str = "model"):
        """This rank's slice of the replicated ``x`` along ``dim``
        (``launch.mesh.scatter``)."""
        return mcoll.scatter(self.mesh, x, dim, axis)

    def project(self, x, ws, split: bool):
        """``[x @ w for w in ws]`` for a replicated activation ``x``
        (..., D) and 2-D weights. Where ``split`` (the weights' rows are
        this rank's D/data_ways of d_model), each product is a partial of
        ``x``'s matching columns: the partials are joined into one f32
        all-reduce over ``data`` and cast back, as a whole product's GEMM
        rounds once. Under autograd the cut of ``x`` gathers its gradient
        over 'data' and the reduction passes it on to every partial."""
        if not split:
            return [x @ w for w in ws]
        xs = self.scatter(x, -1, axis="data")
        parts = [xs @ w for w in ws]
        sizes = [p.shape[-1] for p in parts]
        both = self.reduce(torch.cat(parts, -1), True, axis="data")
        return list(both.split(sizes, -1))


def _split(spec, dim: int, axis: str = "model") -> bool:
    return spec[dim] == axis


def _has(spec, dim: int, axis: str) -> bool:
    ax = spec[dim]
    return ax == axis or (isinstance(ax, tuple) and axis in ax)


@functools.lru_cache(maxsize=64)
def _leaf_splits(cfg, n: int, data: int = 1,
                 mode: str = "decode") -> Dict[str, bool]:
    """Which dimensions an (``data``, ``n``) mesh splits, read off the
    resolved spec under ``mode``'s rules ("decode", or "train", where the
    routed experts split on 'model' alone) of a leaf that holds each
    (``serving.sharding.param_shardings``), False where no leaf holds it:
    on ``model`` the dense MLP's d_ff, the RG-LRU width, the recurrent
    heads, the sLSTM GeGLU's columns and the routed experts (by expert,
    or their d_ff); on ``data`` (above 1) d_model in every place the
    decode rules name it (``TensorParallel``'s data fields)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import param_shardings

    out = dict(mlp=False, lru=False, rec_heads=False, rec_mlp=False)
    dd = dict(data_proj=False, data_norm=False, data_table=False,
              data_router=False, data_experts=False, expert_data_in=False,
              data_vision=False)
    moe = {}
    specs = param_shardings(AbstractMesh(n, data), LM(cfg, device="cpu"),
                            mode)
    dd["data_norm"] = _split(specs["final_norm"]["scale"], 0, "data")
    dd["data_table"] = _split(specs["embed"]["table"], -1, "data")
    if "vision_proj" in specs:
        dd["data_vision"] = _split(specs["vision_proj"]["w1"], 1, "data")
    for stage in specs["stages"]:
        for block in stage.values():
            mixer, mlp = block["mixer"], block.get("mlp", {})
            if "w_gate" in mlp and "router" not in mlp:
                # a dense MLP's w_down (L, MLP, D)
                out["mlp"] = _split(mlp["w_down"], 1)
            if "router" in mlp:
                # the router (L, D, E); the routed experts' w_gate
                # (L, E, D, MLP); the shared expert's w_down (L, MLP, D)
                moe = dict(
                    experts=mlp["w_gate"][1] is not None,
                    expert_mlp=_split(mlp["w_gate"], 3),
                    router=_has(mlp["router"], 2, "model"),
                    shared_mlp="shared" in mlp
                    and _split(mlp["shared"]["w_down"], 1))
                dd["data_router"] = _split(mlp["router"], 1, "data")
                dd["data_experts"] = _has(mlp["w_gate"], 1, "data")
                dd["expert_data_in"] = _split(mlp["w_gate"], 2, "data")
            if "lam" in mixer:
                # the RG-LRU's w_in_x (L, D, LRU)
                out["lru"] = _split(mixer["w_in_x"], 2)
            elif "w_if" in mixer:
                # the mLSTM's wq (L, D, H, hd)
                out["rec_heads"] = _split(mixer["wq"], 2)
            elif "rh" in mixer:
                # the sLSTM's wx (L, D, 4, H, hd) and w_up1 (L, H hd, 2 D)
                out["rec_heads"] = _split(mixer["wx"], 3)
                out["rec_mlp"] = _split(mixer["w_up1"], 2)
            # every mixer's first input projection: (L, D, ...)
            first = next(iter(k for k in ("wq", "w_dq", "w_in_x", "wx")
                              if k in mixer))
            dd["data_proj"] = _split(mixer[first], 1, "data")
    if data == 1:
        dd = {k: False for k in dd}
    return {**out, **moe, **dd}


def tensor_parallel(cfg, mesh, mode: str = "decode"
                    ) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of ``cfg`` on ``mesh`` (None without one).
    Raises ``NotImplementedError`` for a split whose ranks' query heads
    straddle KV groups unevenly. ``mode="train"``: the model splits of the
    train rules, on params that a training step has gathered whole over
    'data' (every data field False, ``data_ways`` 1)."""
    if mesh is None:
        return None
    n = int(mesh.shape["model"])
    train = mode == "train"
    data = 1 if train else int(mesh.shape.get("data", 1))
    if cfg.d_model % data:
        # d_model's contraction side would stay whole, and the decode
        # rules then put the router's columns on ("data", "model")
        raise NotImplementedError(
            f"{cfg.name}: d_model {cfg.d_model} does not divide by a "
            f"{data}-way data axis")
    h, kv = cfg.num_heads, cfg.num_kv_heads
    heads, kvs = h % n == 0, kv % n == 0
    # this rank's place in the mesh, and its index in its model group
    place = int(getattr(mesh, "rank", 0))
    rank = int(getattr(mesh, "model_rank", place % n))
    if heads and not kvs:
        # each rank's local = h/n query heads read one shared KV head
        # when they lie inside one group of h/kv heads (local/group = kv/n
        # is never whole here, so a rank cannot hold whole groups)
        local, group = h // n, h // kv
        if group % local == 0:
            kv_range = (rank * local // group, 1)
        else:
            raise NotImplementedError(
                f"{cfg.name}: a {n}-way split gives each rank {local} query "
                f"heads, which straddle the KV groups of {group} heads "
                f"unevenly; serve it on a mesh whose size divides "
                f"{kv} KV heads or whose rank share divides a group")
    else:
        kv_range = (0, kv // n if kvs else kv)
    splits = dict(_leaf_splits(cfg, n, data, mode))
    if cfg.moe is not None:
        # EXPERT takes ("data", "model") in decode: chunk d·M + m of the
        # experts is rank (d, m)'s, which is its place in the mesh; where
        # the experts do not divide by D·M they stay whole, and d_ff
        # splits inside every expert instead (a mesh axis splits one
        # dimension of a leaf). In train 'model' alone: chunk m
        e = cfg.moe.num_experts
        per = e // (n * data)
        splits["expert_range"] = (((rank if train else place) * per, per)
                                  if splits["experts"] else (0, e))
    return TensorParallel(mesh=mesh, ways=n, rank=rank, heads=heads, kv=kvs,
                          vocab=cfg.padded_vocab % n == 0, kv_range=kv_range,
                          mla_heads=cfg.mla is not None and h % n == 0,
                          data_ways=data,
                          data_rank=0 if train
                          else int(getattr(mesh, "data_rank", 0)),
                          **splits)
