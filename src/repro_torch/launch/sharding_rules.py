"""Mesh rules: logical parameter axes -> mesh axes, and the spec of every
parameter leaf.

A copy of ``repro.launch.sharding_rules``' ``param_rules``,
``param_pspecs``, ``opt_pspecs`` and ``batch_pspecs``. A spec is a plain
tuple (one entry per dimension: a mesh axis name, a tuple of them, or
None), ``repro``'s ``PartitionSpec`` entries; a replicated leaf's spec is
all None (``repro``'s ``PartitionSpec()``). The serving path uses
``mode="decode"``, training ``mode="train"``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch import sharding as sh
from repro_torch.models import param as P


def param_rules(mesh, mode: str = "train") -> Dict[str, object]:
    """FSDP on the batch axes, tensor and expert parallel on 'model'. In
    decode the output-side embed dims (``EMBED_OUT``) are replicated and
    the expert axis spreads over both mesh axes, as in ``repro``."""
    fsdp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    decode = mode == "decode"
    return {
        P.EMBED: fsdp,
        P.EMBED_OUT: None if decode else fsdp,
        P.VOCAB: "model",
        P.HEADS: "model",
        P.KV_HEADS: "model",
        P.MLP: "model",
        P.EXPERT: fsdp + ("model",) if decode else "model",
        P.LRU: "model",
        P.LORA: None,
        P.HEAD_DIM: None,
        P.STACK: None,
    }


def param_pspecs(mesh, spec_tree, axes_tree, mode: str = "train"):
    """The spec tree of the parameters: ``spec_tree`` is ``LM.param_spec()``
    ((shape, dtype, init) leaves), ``axes_tree`` ``LM.param_axes()``."""
    rules = param_rules(mesh, mode)

    def walk(spec, axes):
        if isinstance(spec, dict):
            return {k: walk(spec[k], axes[k]) for k in spec}
        if isinstance(spec, list):
            return [walk(s, a) for s, a in zip(spec, axes)]
        return sh.resolve(rules, axes, shape=spec[0], mesh_shape=mesh.shape)

    return walk(spec_tree, axes_tree)


def opt_pspecs(mesh, param_specs, opt_state=None):
    """Optimizer states shard exactly like their parameters (ZeRO): an
    ``AdamWState`` of specs, the step replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=(), mu=param_specs, nu=param_specs)


def batch_pspecs(mesh, batch):
    """Input batches: each leaf's leading dim split over the batch axes
    when it divides, else replicated (``batch``: a dict of arrays or
    tensors)."""
    batch_axes = ("pod", "data") if "pod" in mesh.shape else ("data",)
    size = 1
    for a in batch_axes:
        size *= mesh.shape[a]

    def spec(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or shape[0] % size != 0:
            return (None,) * len(shape)
        ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        return (ba,) + (None,) * (len(shape) - 1)

    return {k: spec(v) for k, v in batch.items()}
