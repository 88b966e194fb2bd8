"""Mesh placement for the serving stack (tensor-parallel decode).

The port of ``repro.serving.sharding``. What splits and what stays
host-global is ``repro``'s: parameters split by the decode-mode rules of
``launch.sharding_rules`` (attention and KV heads, MLP and vocab on the
mesh's ``model`` axis); the K/V pools, ring lines (L, B, W, KV, hd) and
paged pools (L, N, bs, KV, hd), split their KV-head dim (dim 3) when it
divides. Recurrent states split where their mixer's weights do, on a dim
chosen by the block's mixer (``SPLIT_DIMS``): the RG-LRU's width (``h``
dim 2, ``conv`` dim 3, as ``repro``'s ``launch.sharding_rules.
cache_pspecs``), and the mLSTM's and sLSTM's heads (dim 2 of every leaf).
The xLSTM states are a departure: ``repro`` keeps them whole on 'model'
and lets GSPMD move the data to the sharded heads, while the port's
explicit SPMD keeps each rank's heads. Block tables, position slots, MLA
latents (no head dim: every rank computes them whole from the replicated
down-projections), the free list and the commitment ledger stay
replicated. MoE experts split by expert over ("data", "model") or by
d_ff inside every expert, as the rules resolve. On a mesh with a data
axis above 1 the decode rules also cut d_model's contraction side
(``EMBED``) on 'data'; every cache stays whole over 'data' (``repro``'s
serving cache specs split on 'model' alone), so the ranks of a model
column hold equal caches. Where ``repro``
commits arrays to ``NamedSharding``s, a rank here holds its shard of each
leaf: "placing" slices it, and a spec is a tuple of mesh axes per
dimension.
"""
from __future__ import annotations

import math

from repro_torch.launch import sharding_rules as sr


def model_axis_size(mesh) -> int:
    """Ways the mesh's 'model' axis splits (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get("model", 1))


def param_shardings(mesh, lm, mode: str = "decode"):
    """The spec tree of ``lm``'s params under the decode-mode rules (or
    ``mode``'s: "train" for FSDP training)."""
    return sr.param_pspecs(mesh, lm.param_spec(), lm.param_axes(),
                           mode=mode)


def shard_shape(mesh, shape, spec):
    """A leaf's per-rank shape under ``spec``."""
    out = []
    for n, ax in zip(shape, spec):
        ways = 1
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            ways *= mesh.shape[a]
        out.append(n // ways)
    return tuple(out)


def cut_leaf(mesh, leaf, spec, glob):
    """This rank's slice of a whole leaf of shape ``glob`` under ``spec``
    (a view): every dimension its spec splits is narrowed to this rank's
    part. A dimension split over a tuple of axes is cut into the product
    of their sizes, chunk ``i`` for the rank whose indices on them, read
    as one number in the tuple's order, make ``i`` (("data", "model"):
    chunk ``d·M + m``, the rank's place in the mesh)."""
    local = shard_shape(mesh, glob, spec)
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is None or glob[dim] == local[dim]:
            continue
        chunk = 0
        for a in ((ax,) if isinstance(ax, str) else tuple(ax)):
            chunk = chunk * mesh.shape[a] + mesh.axis_rank(a)
        out = out.narrow(dim, chunk * local[dim], local[dim])
    return out


def place_params(mesh, lm, params, mode: str = "decode"):
    """This rank's shards of ``params``: each leaf cut to its slice of
    every dimension its spec (under ``mode``'s rules) splits (a contiguous
    copy). A leaf that is not split, or is already this rank's shard, is
    kept as it is."""
    specs = param_shardings(mesh, lm, mode)

    def place(leaf, spec, shape):
        if isinstance(leaf, dict):
            return {k: place(leaf[k], spec[k], shape[k]) for k in leaf}
        if isinstance(leaf, list):
            return [place(*x) for x in zip(leaf, spec, shape)]
        glob = tuple(shape[0])
        local = shard_shape(mesh, glob, spec)
        if tuple(leaf.shape) == local:
            return leaf
        if tuple(leaf.shape) != glob:
            raise ValueError(f"a parameter of shape {tuple(leaf.shape)} is "
                             f"neither {glob} nor its shard {local}")
        return cut_leaf(mesh, leaf, spec, glob).contiguous()

    return place(params, specs, lm.param_spec())


# a cache block's mixer, told by its leaves' names together: ``h`` and ``n``
# belong to two mixers each, with their split on different dims
_BLOCK_MIXER = {frozenset(("k", "v", "pos")): "attn",
                frozenset(("ckv", "krope", "pos")): "mla",
                frozenset(("h", "conv")): "rglru",
                frozenset(("C", "n", "m")): "mlstm",
                frozenset(("c", "n", "h", "m")): "slstm"}

# per mixer, the dim of each cache leaf that splits on 'model' when it
# divides (a leaf not named stays whole): the KV heads of the K/V lines
# (L, B, W, KV, hd) and pools (L, N, bs, KV, hd); the RG-LRU width of
# ``h`` (L, B, W) and ``conv`` (L, B, cw-1, W); the heads of the mLSTM's
# ``C`` (L, B, H, hd, hd), ``n`` (L, B, H, hd), ``m`` (L, B, H) and of the
# sLSTM's (L, B, H, hd) leaves. MLA latents and positions stay whole
SPLIT_DIMS = {"attn": {"k": 3, "v": 3},
              "mla": {},
              "rglru": {"h": 2, "conv": 3},
              "mlstm": {"C": 2, "n": 2, "m": 2},
              "slstm": {"c": 2, "n": 2, "h": 2, "m": 2}}


def block_mixer(block: dict) -> str:
    """The mixer of a cache block dict, by its leaves."""
    return _BLOCK_MIXER[frozenset(block)]


def split_dims(block: dict) -> dict:
    """{leaf name: the dim it may split on, or None} of a cache block."""
    dims = SPLIT_DIMS[block_mixer(block)]
    return {key: dims.get(key) for key in block}


def shard_divisor(dim, shape, ways: int) -> int:
    """Ways a cache leaf of global ``shape`` splits over ``ways`` ranks on
    ``dim`` (None: whole): ``ways`` when that dim divides, else 1."""
    ways = max(ways, 1)
    if dim is not None and shape[dim] % ways == 0:
        return ways
    return 1


def _shape(leaf):
    """A tensor's shape, or a proto leaf's ((shape, dtype))."""
    return tuple(leaf[0]) if isinstance(leaf, tuple) else tuple(leaf.shape)


def cache_pspecs(mesh, cache_state):
    """The spec of each leaf of a cache state at its global shapes
    ({"caches": ..., "tables": ...}, tensors or a backend's (shape, dtype)
    proto leaves): each leaf's ``SPLIT_DIMS`` dim on 'model' when it
    divides, everything else (tables, positions, latents) replicated."""
    from repro_torch.serving.kv_cache import _map_block_dicts
    msize = model_axis_size(mesh)

    def spec(d):
        out = {}
        for key, dim in split_dims(d).items():
            shape = _shape(d[key])
            dims = [None] * len(shape)
            if dim is not None and shape[dim] % msize == 0:
                dims[dim] = "model"
            out[key] = tuple(dims)
        return out

    tables = cache_state.get("tables")
    return {"caches": _map_block_dicts(spec, cache_state["caches"]),
            "tables": None if tables is None
            else (None,) * len(_shape(tables))}


def assert_cache_placement(mesh, cache_state, proto) -> None:
    """Placement sweep of this rank's ``cache_state`` against the global
    per-request ``proto`` of its backend ((L, 1, W, ...) leaves): each
    leaf's dims past the layer, slot and (for attention and MLA) window or
    block dims must be the shard its spec prescribes (its split dim cut
    ``shard_divisor`` ways, everything else whole), so its bytes times the
    ways rebuild the global leaf's."""
    from repro_torch.serving.kv_cache import _map_block_dicts
    msize = model_axis_size(mesh)

    def check(d, want):
        assert set(d) == set(want), "cache tree differs"
        fixed = 3 if block_mixer(want) in ("attn", "mla") else 2
        for key, dim in split_dims(want).items():
            leaf, (gshape, dtype) = d[key], want[key]
            div = shard_divisor(dim, gshape, msize)
            tail = list(gshape[fixed:])
            if div > 1:
                tail[dim - fixed] //= div
            assert tuple(leaf.shape[fixed:]) == tuple(tail) \
                and leaf.dtype == dtype, (
                    f"cache leaf {key}: shard {tuple(leaf.shape)} "
                    f"{leaf.dtype} is not the {div}-way split of {gshape} "
                    f"{dtype}")
            local = leaf.numel() * leaf.element_size()
            whole = math.prod(tuple(leaf.shape[:fixed]) + tuple(
                gshape[fixed:])) * leaf.element_size()
            assert local * div == whole, (key, local, div, whole)
        return d

    _map_block_dicts(check, cache_state["caches"], proto)
