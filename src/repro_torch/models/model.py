"""The LM: stages of attention and RG-LRU blocks, full-sequence forward /
prefill, chunked prefill and one-token decode over a KV-cache layout (ring
or paged, from ``serving.kv_cache``).

Port of ``repro.models.model.LM`` for text-only models whose blocks mix
with GQA attention or the RG-LRU recurrence and whose MLPs are SwiGLU or
GeGLU: the dense configs (``smollm-135m`` among them) and the hybrid
``recurrentgemma-9b``. Parameters are the same nested dicts as
``repro``'s, with per-stage leaves stacked on a leading layer axis, so
``repro_torch.bridge`` maps one onto the other by name. ``repro``'s
``lax.scan`` over stacked layers is a Python loop over the layer index
here; caches keep the same stacked (L, B, ...) layout (K/V rings for
attention, ``h`` and ``conv`` state for RG-LRU) and are updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, GELU_MLP, RGLRU, SWIGLU,
                                      ModelConfig)
from repro_torch.models import attention as att
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (embed, gelu_mlp, rmsnorm, softcap,
                                       swiglu, unembed)

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _layer(tree, i: int):
    """Layer ``i``'s view of a stacked dict tree (leaves indexed [i])."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _attn_width(window: Optional[int], cache_width: int) -> int:
    return min(cache_width, window) if window else cache_width


class LM:
    """A text-only language model of GQA-attention and RG-LRU blocks on one
    device (default "cuda")."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.frontend.kind != "none" or cfg.moe is not None \
                or cfg.mla is not None or cfg.mtp_depth:
            raise NotImplementedError(
                f"{cfg.name}: the port serves text-only models; frontends, "
                "MoE, MLA and MTP are later slices")
        for stage in cfg.stages:
            for bdef in stage.blocks:
                if bdef.mixer not in (ATTN, RGLRU) \
                        or bdef.mlp not in (SWIGLU, GELU_MLP):
                    raise NotImplementedError(
                        f"{cfg.name}: block ({bdef.mixer}, {bdef.mlp}) is a "
                        "later slice; the port runs attention or RG-LRU "
                        "mixers with SwiGLU or GeGLU MLPs")
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.param_dtype]

    # -- parameters -----------------------------------------------------------
    def param_spec(self) -> Params:
        """The parameter tree as (shape, dtype, init) leaves — the same
        names, shapes and stacking as ``repro``'s ``LM.init``. init is a
        normal std (0 means zeros) or ``recurrent.LAMBDA_INIT``."""
        cfg, dt, f32 = self.cfg, self.dtype, torch.float32
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd, ff, vocab = cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab
        spec: Params = {"embed": {"table": ((vocab, d), dt, 1.0)}}
        stages = []
        for stage in cfg.stages:
            n = stage.repeat

            def block(bdef):
                if bdef.mixer == RGLRU:
                    mixer = rec.param_spec(cfg, n, dt)
                else:
                    mixer = {
                        "wq": ((n, d, h, hd), dt, d ** -0.5),
                        "wk": ((n, d, kv, hd), dt, d ** -0.5),
                        "wv": ((n, d, kv, hd), dt, d ** -0.5),
                        "wo": ((n, h, hd, d), dt, (h * hd) ** -0.5),
                    }
                    if cfg.use_qk_norm:
                        mixer["q_scale"] = ((n, hd), f32, 0.0)
                        mixer["k_scale"] = ((n, hd), f32, 0.0)
                # SwiGLU and GeGLU have the same three leaves
                return {
                    "norm1": {"scale": ((n, d), f32, 0.0)},
                    "mixer": mixer,
                    "norm2": {"scale": ((n, d), f32, 0.0)},
                    "mlp": {"w_gate": ((n, d, ff), dt, d ** -0.5),
                            "w_up": ((n, d, ff), dt, d ** -0.5),
                            "w_down": ((n, ff, d), dt, ff ** -0.5)},
                }

            stages.append({f"b{i}": block(bdef)
                           for i, bdef in enumerate(stage.blocks)})
        spec["stages"] = stages
        spec["final_norm"] = {"scale": ((d,), f32, 0.0)}
        if not cfg.tie_embeddings:
            spec["unembed"] = {"table": ((vocab, d), dt, d ** -0.5)}
        return spec

    def init(self, seed: int, on_device: bool = False) -> Params:
        """Random parameters, normal(0, std) in float32 and then cast, as
        ``repro`` does. By default from a CPU ``torch.Generator`` seeded
        with ``seed`` (the same values on every device), moved to the
        model's device; with ``on_device`` from a generator on the model's
        device (much faster at billions of parameters, other values)."""
        gen_dev = self.device if on_device else torch.device("cpu")
        gen = torch.Generator(device=gen_dev).manual_seed(seed)

        def make(leaf):
            if isinstance(leaf, dict):
                return {k: make(v) for k, v in leaf.items()}
            if isinstance(leaf, list):
                return [make(v) for v in leaf]
            shape, dtype, std = leaf
            if std == rec.LAMBDA_INIT:
                x = rec.init_lambda(shape, gen, gen_dev)
            elif std == 0.0:
                x = torch.zeros(shape, dtype=torch.float32, device=gen_dev)
            else:
                x = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen_dev).mul_(std)
            return x.to(dtype).to(self.device)

        return make(self.param_spec())

    # -- pieces ---------------------------------------------------------------
    def _logits(self, params, x):
        cfg = self.cfg
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["unembed"]["table"])
        logits = unembed(table, x)
        if cfg.tie_embeddings:
            # the tied table is unit-std (embedding-scaled); rescale
            logits = logits * (cfg.d_model ** -0.5)
        return softcap(logits, cfg.logit_softcap)

    def _mlp(self, bdef, p, x):
        mlp = swiglu if bdef.mlp == SWIGLU else gelu_mlp
        return x + mlp(p["mlp"], rmsnorm(p["norm2"], x, self.cfg.rms_eps))

    def _head(self, params, x, last_only: bool, logits_index):
        x = rmsnorm(params["final_norm"], x, self.cfg.rms_eps)
        if logits_index is not None:
            idx = att.positions_1d(logits_index, x.shape[0], x.device).long()
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        elif last_only:
            x = x[:, -1:]
        return self._logits(params, x)

    # -- full-sequence forward ----------------------------------------------
    def _embed_inputs(self, params, batch):
        """Token embeddings (B, S, D) and their positions (B, S) int32."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed(params["embed"], tokens)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :].expand(b, s)
        return x, positions

    @property
    def num_scanned_layers(self) -> int:
        """Layers in stage-repeat units (``repro``'s scanned layers)."""
        return sum(stage.repeat for stage in self.cfg.stages)

    def _layer_range(self, params, x, positions, lo: int = 0,
                     hi: Optional[int] = None, *, caches=None,
                     lengths=None):
        """Scanned layers [lo, hi) (stage-repeat units, every block of a
        repeat) over the full sequence ``x``; with ``caches`` each layer
        also fills its cache. The one layer loop of ``forward`` and of
        ``core.patterns.inference.PartitionedLM``."""
        cfg = self.cfg
        hi = self.num_scanned_layers if hi is None else hi
        s = x.shape[1]
        first = 0                       # this stage's first scanned layer
        for si, (stage, sp) in enumerate(zip(cfg.stages, params["stages"])):
            for li in range(max(lo - first, 0),
                            min(hi - first, stage.repeat)):
                for bi, bdef in enumerate(stage.blocks):
                    p = _layer(sp[f"b{bi}"], li)
                    h = rmsnorm(p["norm1"], x, cfg.rms_eps)
                    if bdef.mixer == RGLRU:
                        y, state = rec.rglru_block_forward(
                            p["mixer"], cfg, h, lengths)
                        if caches is not None:
                            _store(_layer(caches[si][bi], li), state)
                    else:
                        y, (k, v) = att.attn_forward(p["mixer"], cfg, h,
                                                     positions,
                                                     window=bdef.window)
                        if caches is not None:
                            att.cache_fill(_layer(caches[si][bi], li), k, v,
                                           s, lengths)
                    x = self._mlp(bdef, p, x + y)
            first += stage.repeat
        return x

    def forward(self, params, batch, *, want_cache: bool = False,
                cache_width: Optional[int] = None, last_only: bool = False,
                lengths=None, logits_index=None):
        """Returns (logits, caches or None). ``last_only`` unembeds only
        the final position, ``logits_index`` (B,) only the given one;
        ``lengths`` (B,) keeps right-pad rows out of the ring at install
        (see ``attention._fill_slots``) and out of the recurrent state
        (identity steps past each row's length)."""
        x, positions = self._embed_inputs(params, batch)
        caches = (self.init_cache(x.shape[0], cache_width) if want_cache
                  else None)
        x = self._layer_range(params, x, positions, caches=caches,
                              lengths=lengths)
        return self._head(params, x, last_only, logits_index), caches

    def prefill(self, params, batch, cache_width: int,
                last_only: bool = False, lengths=None, logits_index=None):
        """Full forward that also returns populated caches."""
        return self.forward(params, batch, want_cache=True,
                            cache_width=cache_width, last_only=last_only,
                            lengths=lengths, logits_index=logits_index)

    # -- decode -------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> List[Any]:
        """Per stage, a tuple over blocks of dicts of stacked (L, B, ...)
        tensors: K/V rings (positions start at -1, empty) for attention,
        a zero ``h`` and ``conv`` state for RG-LRU."""
        cfg = self.cfg
        caches = []
        for stage in cfg.stages:
            blocks = []
            for bdef in stage.blocks:
                if bdef.mixer == RGLRU:
                    one = rec.rglru_state_spec(cfg, batch, self.dtype,
                                               self.device)
                else:
                    one = att.init_kv_cache(
                        batch, _attn_width(bdef.window, seq_len),
                        cfg.num_kv_heads, cfg.resolved_head_dim, self.dtype,
                        self.device)
                blocks.append({k: v[None].repeat(
                    (stage.repeat,) + (1,) * v.dim()) for k, v in one.items()})
            caches.append(tuple(blocks))
        return caches

    def chunk_incompatible_mixer(self) -> Optional[str]:
        """The first mixer kind that cannot take multi-token prompt chunks
        (recurrent state folds tokens strictly in sequence), or None when
        every block is attention. One-token decode works for every mixer."""
        for stage in self.cfg.stages:
            for bdef in stage.blocks:
                if bdef.mixer != ATTN:
                    return bdef.mixer
        return None

    def decode_step(self, params, caches, tokens, cur_pos, *,
                    layout=None, block_tables=None, valid=None):
        """One-token decode. tokens (B, 1); ``cur_pos`` scalar or (B,);
        ``valid`` (B, 1): False rows compute logits but leave the cache
        (and the recurrent state) untouched. Returns (logits (B, 1, V),
        caches), the caches updated in place."""
        return self.prefill_chunk(params, caches, tokens, cur_pos,
                                  layout=layout, block_tables=block_tables,
                                  valid=valid)

    def prefill_chunk(self, params, caches, tokens, start_pos, *,
                      layout=None, block_tables=None, valid=None,
                      logits_index=None):
        """Resume prefill with a T-token chunk per slot starting at
        ``start_pos`` (T = 1 is ``decode_step``). ``valid`` (B, T) masks
        right-pad tokens out of the cache; ``logits_index`` (B,) unembeds
        one chunk position per row. Chunks longer than one token need
        attention mixers. Returns (logits, caches)."""
        cfg = self.cfg
        b, t = tokens.shape
        if t > 1:
            bad = self.chunk_incompatible_mixer()
            if bad is not None:
                raise NotImplementedError(
                    f"prefill_chunk needs attention mixers "
                    f"(got {bad!r}); chunk length must be 1")
        start = att.positions_1d(start_pos, b, tokens.device)
        x = embed(params["embed"], tokens)
        for stage, sp, sc in zip(cfg.stages, params["stages"], caches):
            for li in range(stage.repeat):
                for bi, bdef in enumerate(stage.blocks):
                    p = _layer(sp[f"b{bi}"], li)
                    c = _layer(sc[bi], li)
                    h = rmsnorm(p["norm1"], x, cfg.rms_eps)
                    if bdef.mixer == RGLRU:
                        y, state = rec.rglru_block_decode(p["mixer"], cfg, h,
                                                          c, valid)
                        _store(c, state)
                    else:
                        y, _ = att.attn_decode(
                            p["mixer"], cfg, h, c, start,
                            window=bdef.window, layout=layout,
                            block_tables=block_tables, valid=valid)
                    x = self._mlp(bdef, p, x + y)
        return self._head(params, x, False, logits_index), caches


def _store(cache: dict, state: dict) -> None:
    """Write a block's new recurrent state into its cache views, in place."""
    for key, value in state.items():
        cache[key].copy_(value)
