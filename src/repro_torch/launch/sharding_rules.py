"""Mesh rules: logical parameter axes -> mesh axes, and the spec of every
parameter leaf.

A copy of ``repro.launch.sharding_rules``' ``param_rules`` and
``param_pspecs``. A spec is a plain tuple (one entry per dimension: a mesh
axis name, a tuple of them, or None), ``repro``'s ``PartitionSpec``
entries. The serving path uses ``mode="decode"``.
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
