"""Mesh placement for the serving stack (tensor-parallel decode).

The port of ``repro.serving.sharding``. What splits and what stays
host-global is ``repro``'s: parameters split by the decode-mode rules of
``launch.sharding_rules`` (attention and KV heads, MLP and vocab on the
mesh's ``model`` axis); the K/V pools, ring lines (L, B, W, KV, hd) and
paged pools (L, N, bs, KV, hd), split their KV-head dim (dim 3) when it
divides. Block tables, position slots, MLA latents (no head dim: every rank
computes them whole from the replicated down-projections), the free list
and the commitment ledger stay replicated. MoE experts split by expert
(the expert dim's ("data", "model") cuts like ``model`` on a data-1
mesh) or by d_ff inside every expert, as the rules resolve. Where ``repro``
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


def param_shardings(mesh, lm):
    """The spec tree of ``lm``'s params under the decode-mode rules."""
    return sr.param_pspecs(mesh, lm.param_spec(), lm.param_axes(),
                           mode="decode")


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
    part. A tuple of mesh axes cuts like ``model`` when its other axes
    have size 1 (the expert dim's ("data", "model") on a data-1 mesh)."""
    local = shard_shape(mesh, glob, spec)
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is not None and glob[dim] != local[dim]:
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            if any(a != "model" and mesh.shape[a] != 1 for a in axes):
                raise NotImplementedError(f"placement on {ax!r}")
            out = mesh.shard(out, dim)
    return out


def place_params(mesh, lm, params):
    """This rank's shards of ``params``: each leaf cut to its slice of
    every dimension its spec splits (a contiguous copy). A leaf that is
    not split, or is already this rank's shard, is kept as it is."""
    specs = param_shardings(mesh, lm)

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


def _kv_pool_leaf(key: str, shape) -> bool:
    """The K/V leaves of both backends, ring lines (L, B, W, KV, hd) and
    paged pools (L, N, bs, KV, hd); MLA latents and ``pos`` are not."""
    return key in ("k", "v") and len(shape) == 5


def kv_shard_divisor(key: str, shape, kv_shards: int) -> int:
    """Ways a cache leaf's bytes split over the ranks (``repro``'s
    ``_kv_shard_divisor``): a K/V leaf whose KV-head dim divides splits
    ``kv_shards`` ways, everything else is replicated. ``shape`` is the
    global shape."""
    if _kv_pool_leaf(key, shape) and shape[3] % max(kv_shards, 1) == 0:
        return max(kv_shards, 1)
    return 1


def _shape(leaf):
    """A tensor's shape, or a proto leaf's ((shape, dtype))."""
    return tuple(leaf[0]) if isinstance(leaf, tuple) else tuple(leaf.shape)


def cache_pspecs(mesh, cache_state):
    """The spec of each leaf of a cache state at its global shapes
    ({"caches": ..., "tables": ...}, tensors or a backend's (shape, dtype)
    proto leaves): K/V split dim 3 on 'model' when it divides, everything
    else (tables, positions, latents) replicated."""
    from repro_torch.serving.kv_cache import _map_block_dicts
    msize = model_axis_size(mesh)

    def spec(d):
        out = {}
        for key, leaf in d.items():
            shape = _shape(leaf)
            dims = [None] * len(shape)
            if _kv_pool_leaf(key, shape) and shape[3] % msize == 0:
                dims[3] = "model"
            out[key] = tuple(dims)
        return out

    tables = cache_state.get("tables")
    return {"caches": _map_block_dicts(spec, cache_state["caches"]),
            "tables": None if tables is None
            else (None,) * len(_shape(tables))}


def assert_cache_placement(mesh, cache_state, proto) -> None:
    """Placement sweep of this rank's ``cache_state`` against the global
    per-request ``proto`` of its backend ((L, 1, W, ...) leaves): each
    leaf's trailing dims must be the shard its spec prescribes (the K/V
    head dim cut ``kv_shard_divisor`` ways, everything else whole), so its
    bytes times the ways rebuild the global leaf's."""
    from repro_torch.serving.kv_cache import _leaves
    msize = model_axis_size(mesh)
    got, want = _leaves(cache_state["caches"]), _leaves(proto)
    assert [k for k, _ in got] == [k for k, _ in want], "cache tree differs"
    for (key, leaf), (_, (gshape, dtype)) in zip(got, want):
        div = kv_shard_divisor(key, gshape, msize)
        tail = list(gshape[3:])
        if div > 1:
            tail[0] //= div
        assert tuple(leaf.shape[3:]) == tuple(tail) \
            and leaf.dtype == dtype, (
                f"cache leaf {key}: shard {tuple(leaf.shape)} "
                f"{leaf.dtype} is not the {div}-way split of {gshape} "
                f"{dtype}")
        local = leaf.numel() * leaf.element_size()
        whole = math.prod(tuple(leaf.shape[:3]) + tuple(gshape[3:])) \
            * leaf.element_size()
        assert local * div == whole, (key, local, div, whole)
