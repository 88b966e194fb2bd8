"""Stand-ins for every input of the dry run's steps, per (architecture x
input shape), and the step functions it traces: the port of
``repro.launch.specs``.

``repro`` builds ``ShapeDtypeStruct``s of the whole arrays and lets its
compiler cut them by the sharding rules. The port traces one rank of the
mesh, so ``make_step_fn`` makes that rank's inputs as empty tensors (fake
ones inside ``launch.fake.fake_mode``: no storage, no random draw), each
cut by the port's own placement:

  * ``train``: the params by the train rules (FSDP over 'data', tensor
    and expert parallel over 'model'; ``training.train_loop.
    place_train_params``' shards), the AdamW moments alike (bf16 for
    deepseek, f32 otherwise, as ``repro``'s), the rank's B / D rows of
    the global batch; the step is ``make_train_step(..., mesh=)``.
  * ``prefill`` and ``decode``: the params by the serving placement that
    ``LM.prefill`` / ``LM.decode_step`` run on a mesh (the decode rules:
    ``serving.sharding.param_shardings``), the whole batch on every rank
    (the activations are replicated, as ``repro``'s decode rules
    replicate them), the caches this rank's shard of ``LM.init_cache(...,
    mesh=)``: split on 'model' where their heads divide, whole over
    'data'.

The serving placement is a departure from ``repro``'s rules in two
places, which ``PLACEMENT_NOTES`` states for the record: ``repro``
prefills under its train-like rules (FSDP on 'data', the batch split over
'data'), and it splits the decode caches' batch over 'data'.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, apply_long_context
from repro_torch.configs.shapes import InputShape

PLACEMENT_NOTES = {
    "prefill": "prefill runs the port's serving placement (decode rules: "
               "the batch whole on every rank, d_model's contraction side "
               "cut on 'data'); repro prefills under its train-like rules "
               "with the batch split over 'data'",
    "decode": "the caches are whole over 'data' and split on 'model' where "
              "their heads divide (the port's serving placement); repro "
              "splits their batch over 'data'",
}


class Spec(NamedTuple):
    """An input's shape and dtype (``repro``'s ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def resolved_config(arch: str, shape_name: str) -> ModelConfig:
    """``arch``'s config for the input shape ``shape_name``: the long-context
    variant for ``long_500k`` (``repro.launch.specs.resolved_config``)."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        cfg = apply_long_context(cfg)
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Spec]:
    """The whole inputs of the step ``shape`` traces (``repro``'s
    ``input_specs``): the tokens, (B, S) or audio's (B, S, C) codebooks,
    a vision model's text after its prefix and its ``image_embeds``,
    ``labels`` for training; for decode one token a row and ``cur_pos``."""
    b, s = shape.global_batch, shape.seq_len
    fe = cfg.frontend
    if fe.kind == "audio":
        tok, tok1 = (b, s, fe.num_codebooks), (b, 1, fe.num_codebooks)
    else:
        tok = (b, s - (fe.num_prefix_tokens if fe.kind == "vision" else 0))
        tok1 = (b, 1)
    if shape.mode == "decode":
        return {"tokens": Spec(tok1, torch.int32),
                "cur_pos": Spec((), torch.int32)}
    batch = {"tokens": Spec(tok, torch.int32)}
    if shape.mode == "train":
        batch["labels"] = Spec(tok, torch.int32)
    if fe.kind == "vision":
        batch["image_embeds"] = Spec((b, fe.num_prefix_tokens,
                                      fe.embed_dim),
                                     getattr(torch, cfg.param_dtype))
    return batch


def _empty(spec: Spec, device) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def rank_params(lm, mesh, mode: str, device):
    """This rank's params as empty tensors: ``lm.param_spec()``'s shapes
    cut by ``mode``'s placement ("train", or "decode" for serving)."""
    from repro_torch.serving.sharding import param_shardings, shard_shape

    def make(leaf, spec):
        if isinstance(leaf, dict):
            return {k: make(leaf[k], spec[k]) for k in leaf}
        if isinstance(leaf, list):
            return [make(*x) for x in zip(leaf, spec)]
        shape, dtype, _ = leaf
        return torch.empty(shard_shape(mesh, tuple(shape), spec),
                           dtype=dtype, device=device)

    return make(lm.param_spec(), param_shardings(mesh, lm, mode))


def rank_rows(mesh, spec: Spec) -> Spec:
    """This rank's rows of a batch leaf (``data.loader.ShardedLoader``'s
    rule: B / D rows where the data axis divides B, else all of them)."""
    d = mesh.shape["data"]
    if not spec.shape or spec.shape[0] % d:
        return spec
    return Spec((spec.shape[0] // d,) + spec.shape[1:], spec.dtype)


def abstract_cache(lm, shape: InputShape, mesh=None):
    """The decode caches of ``shape`` (``repro``'s ``abstract_cache``): this
    rank's shard on ``mesh``, the whole caches without; empty tensors on
    the model's device (call inside ``launch.fake.fake_mode``)."""
    return lm.init_cache(shape.global_batch, shape.seq_len, mesh=mesh)


def opt_dtype(cfg: ModelConfig) -> torch.dtype:
    """The AdamW moments' dtype: bf16 for the XXL MoE archs, as
    ``repro``'s dry run keeps them."""
    return torch.bfloat16 if cfg.name.startswith("deepseek") \
        else torch.float32


def make_step_fn(lm, shape: InputShape, mesh, device, lr_schedule=None):
    """The step the dry run traces and this rank's inputs (module
    docstring), as ``(step, inputs)``: ``step(*inputs)`` runs it. Call
    inside ``launch.fake.fake_mode``."""
    cfg = lm.cfg
    specs = input_specs(cfg, shape)
    if shape.mode == "train":
        from repro_torch.optim import adamw_init, linear_warmup_cosine
        from repro_torch.training.train_loop import make_train_step
        sched = lr_schedule or linear_warmup_cosine(3e-4, 100, 10_000)
        params = rank_params(lm, mesh, "train", device)
        opt = adamw_init(params, opt_dtype(cfg))
        batch = {k: _empty(rank_rows(mesh, v), device)
                 for k, v in specs.items()}
        return make_train_step(lm, sched, mesh=mesh), (params, opt, batch)

    params = rank_params(lm, mesh, "decode", device)
    if shape.mode == "prefill":
        def prefill_step(params, batch):
            logits, caches = lm.prefill(params, batch,
                                        cache_width=shape.seq_len,
                                        last_only=True, mesh=mesh)
            return logits[:, -1], caches

        batch = {k: _empty(v, device) for k, v in specs.items()}
        return prefill_step, (params, batch)

    if shape.mode != "decode":
        raise ValueError(f"unknown step mode {shape.mode!r} (train, prefill "
                         f"or decode)")

    def serve_step(params, caches, tokens, cur_pos):
        return lm.decode_step(params, caches, tokens, cur_pos, mesh=mesh)

    caches = abstract_cache(lm, shape, mesh)
    return serve_step, (params, caches, _empty(specs["tokens"], device),
                        torch.zeros((), dtype=torch.int32, device=device))


def tree_bytes(tree: Any) -> int:
    """The bytes of a tree's tensors, each storage once."""
    from repro_torch.utils.tree import tree_leaves
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


__all__ = ["PLACEMENT_NOTES", "Spec", "abstract_cache", "input_specs",
           "make_step_fn", "opt_dtype", "rank_params", "rank_rows",
           "resolved_config", "tree_bytes"]
