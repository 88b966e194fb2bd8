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
    """How one rank runs a model on a mesh's ``model`` axis: which
    dimensions its shards split (each exactly when the decode-mode
    placement rules split the leaves that hold it) and the KV heads its
    query heads read. ``kv_range`` is (first, count) in the KV-head dim of
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
    with no dense MLP (xLSTM, an all-MoE stack) has it False."""
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

    def reduce(self, x, split: bool):
        """Sum a row-parallel partial over the ranks when ``split``."""
        return self.mesh.all_reduce(x) if split else x


def _split(spec, dim: int) -> bool:
    return spec[dim] == "model"


@functools.lru_cache(maxsize=64)
def _leaf_splits(cfg, n: int) -> Dict[str, bool]:
    """Which of the dense MLP's d_ff, the RG-LRU width, the recurrent heads
    and the sLSTM GeGLU's columns an ``n``-way mesh splits: read off the
    resolved decode-mode spec of a stacked leaf that holds each dimension
    (``serving.sharding.param_shardings``), False where no leaf holds it."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM
    from repro_torch.serving.sharding import param_shardings

    out = dict(mlp=False, lru=False, rec_heads=False, rec_mlp=False)
    specs = param_shardings(AbstractMesh(n), LM(cfg, device="cpu"))
    for stage in specs["stages"]:
        for block in stage.values():
            mixer, mlp = block["mixer"], block.get("mlp", {})
            if "w_gate" in mlp and "router" not in mlp:
                # a dense MLP's w_down (L, MLP, D)
                out["mlp"] = _split(mlp["w_down"], 1)
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
    return out


def tensor_parallel(cfg, mesh) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of ``cfg`` on ``mesh`` (None without one).
    Raises ``NotImplementedError`` for a split whose ranks' query heads
    straddle KV groups unevenly."""
    if mesh is None:
        return None
    n = int(mesh.shape["model"])
    h, kv = cfg.num_heads, cfg.num_kv_heads
    heads, kvs = h % n == 0, kv % n == 0
    rank = int(getattr(mesh, "rank", 0))
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
    moe, routed = cfg.moe, {}
    if moe is not None:
        # EXPERT takes ("data", "model") in decode; with data = 1 the
        # experts split exactly when they divide by N, and then the MLP
        # axis of w_gate/w_up/w_down is left whole (a mesh axis splits one
        # dimension of a leaf); else d_ff splits inside every expert
        e = moe.num_experts
        experts = e % n == 0
        routed = dict(
            experts=experts,
            expert_range=(rank * (e // n), e // n) if experts else (0, e),
            expert_mlp=not experts and moe.d_ff_expert % n == 0,
            shared_mlp=moe.num_shared_experts > 0
            and moe.d_ff_shared % n == 0,
            router=e % n == 0)
    return TensorParallel(mesh=mesh, ways=n, rank=rank, heads=heads, kv=kvs,
                          vocab=cfg.padded_vocab % n == 0, kv_range=kv_range,
                          mla_heads=cfg.mla is not None and h % n == 0,
                          **_leaf_splits(cfg, n), **routed)
