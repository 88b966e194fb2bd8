"""The LM: stages of attention, MLA, RG-LRU, mLSTM and sLSTM blocks,
full-sequence forward / prefill, chunked prefill and one-token decode over
a KV-cache layout (ring or paged, from ``serving.kv_cache``).

Port of ``repro.models.model.LM``, every assigned architecture: blocks
that mix with GQA attention, DeepSeek's latent attention (MLA), the RG-LRU
recurrence or xLSTM's mLSTM and sLSTM (which norm their own input and
have no separate MLP), and MLPs that are SwiGLU, GeGLU or a mixture of
SwiGLU experts; text tokens, or ``repro``'s two modality frontends: a
vision prefix (stubbed ViT patch embeddings through a 2-layer projector,
in front of the text) and audio (a (B, S, C) grid of EnCodec codebook
tokens, their embeddings summed, one LM head per codebook). Parameters
are the same nested dicts as ``repro``'s, with per-stage leaves stacked
on a leading layer axis, so ``repro_torch.bridge`` maps one onto the other
by name (deepseek-v3's multi-token-prediction params too, which only the
training loss reads). ``repro``'s ``lax.scan`` over stacked
layers is a Python loop over the layer index here; caches keep the same
stacked (L, B, ...) layout (K/V rings for attention, ``ckv``/``krope``
latent rings for MLA, ``h`` and ``conv`` for RG-LRU, ``C``, ``n`` and
``m`` for mLSTM, ``c``, ``n``, ``h`` and ``m`` for sLSTM) and are updated
in place.

``forward``, ``prefill``, ``prefill_chunk`` and ``decode_step`` take
``mesh=None`` as ``repro``'s do. With a mesh (a
``launch.mesh.HostMesh``) the params are this rank's shards
(``serving.sharding.place_params``, or ``init(..., mesh=)``) and every
layer runs tensor-parallel with explicit collectives (``models.layers``,
``models.attention``, ``models.moe``, ``models.recurrent``): GQA, MLA,
dense, MoE, RG-LRU, mLSTM and sLSTM; the recurrent states hold the rank's
channels or heads. The vision projector is whole on every rank; audio's
per-codebook tables split their vocab (a masked lookup in each codebook,
the codebooks summed, one all-reduce; the logits gathered on V). Every
rank ends each call with the same full logits. ``repro``'s ``rules``
(activation hints) have no counterpart: explicit collectives make them
moot. On a mesh with a data axis above 1 the decode rules also split
d_model's contraction side on 'data' (norm scales, the tables' D, every
input projection's rows, ``vision_proj``): the activations stay
replicated on every rank, each call first gathers every norm scale over
'data' in one collective (``_whole_norms``), and the projections reduce
their partials over 'data' (``layers.project``). ``mesh=None`` runs the
one-device code unchanged.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, MLA, MLSTM, MOE, NONE, RGLRU,
                                      SLSTM, SWIGLU, BlockDef, ModelConfig)
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_lib
from repro_torch.models import param as P
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (embed, gelu_mlp, join_rows,
                                       mlp_region_reads, project, rmsnorm,
                                       softcap, swiglu, unembed)
from repro_torch.sharding import tensor_parallel

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _layer(tree, i: int):
    """Layer ``i``'s view of a stacked dict tree (leaves indexed [i])."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _attn_width(window: Optional[int], cache_width: int) -> int:
    return min(cache_width, window) if window else cache_width


# mixers that norm their own input (no ``norm1``)
_SELF_NORMED = (MLSTM, SLSTM)


class LM:
    """A language model of attention, MLA, RG-LRU, mLSTM and sLSTM blocks
    with dense, MoE or no MLPs, over text, a vision prefix or audio
    codebooks, on one device (default "cuda"). ``capacity_factor`` is
    ``repro``'s MoE capacity factor (1.25 there); E / k makes every MoE
    call dropless."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 capacity_factor: float = 1.25):
        if cfg.frontend.kind not in ("none", "vision", "audio"):
            raise ValueError(f"{cfg.name}: unknown frontend "
                             f"{cfg.frontend.kind!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity_factor = capacity_factor

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.param_dtype]

    # -- parameters -----------------------------------------------------------
    def param_spec(self) -> Params:
        """The parameter tree as (shape, dtype, init) leaves — the same
        names, shapes and stacking as ``repro``'s ``LM.init``. init is a
        normal std (0 means zeros), ``recurrent.LAMBDA_INIT`` or a
        ``recurrent.Constant``. Audio has one embedding and one unembedding
        table per codebook, (C, V, D)."""
        cfg, dt = self.cfg, self.dtype
        d, vocab = cfg.d_model, cfg.padded_vocab
        fe = cfg.frontend
        table = (vocab, d) if fe.kind != "audio" else (fe.num_codebooks,
                                                       vocab, d)
        spec: Params = {"embed": {"table": (table, dt, 1.0)}}
        if fe.kind == "vision":
            e = fe.embed_dim
            spec["vision_proj"] = {"w1": ((e, d), dt, e ** -0.5),
                                   "w2": ((d, d), dt, d ** -0.5)}
        spec["stages"] = [
            {f"b{i}": self._block_spec(bdef, (stage.repeat,))
             for i, bdef in enumerate(stage.blocks)}
            for stage in cfg.stages]
        spec["final_norm"] = {"scale": ((d,), torch.float32, 0.0)}
        if not cfg.tie_embeddings:
            spec["unembed"] = {"table": (table, dt, d ** -0.5)}
        if cfg.mtp_depth > 0:
            # DeepSeek-V3's depth-1 prediction head: one unstacked block
            spec["mtp"] = {
                "proj": ((2 * d, d), dt, (2 * d) ** -0.5),
                "norm": {"scale": ((d,), torch.float32, 0.0)},
                "block": self._block_spec(
                    BlockDef(mixer=ATTN if cfg.mla is None else MLA,
                             mlp=SWIGLU), ())}
        return spec

    def param_axes(self) -> Params:
        """The logical axes of every leaf of ``param_spec`` (tuples of
        ``models.param`` names, the stacked layer axis first): the tree
        ``repro``'s ``LM.abstract()[1]`` returns, which
        ``launch.sharding_rules`` maps onto a mesh."""
        spec = self.param_spec()
        table = ((None, P.VOCAB, P.EMBED) if self.cfg.frontend.kind == "audio"
                 else (P.VOCAB, P.EMBED))
        axes: Params = {"embed": {"table": table}}
        if "vision_proj" in spec:
            axes["vision_proj"] = {"w1": (None, P.EMBED),
                                   "w2": (P.EMBED, P.EMBED)}
        axes["stages"] = [
            {f"b{i}": self._block_axes(bdef, sp[f"b{i}"], (P.STACK,))
             for i, bdef in enumerate(stage.blocks)}
            for stage, sp in zip(self.cfg.stages, spec["stages"])]
        axes["final_norm"] = P.NORM
        if "unembed" in spec:
            axes["unembed"] = {"table": table}
        if "mtp" in spec:
            bdef = BlockDef(mixer=ATTN if self.cfg.mla is None else MLA,
                            mlp=SWIGLU)
            axes["mtp"] = {"proj": (P.EMBED, P.EMBED), "norm": P.NORM,
                           "block": self._block_axes(
                               bdef, spec["mtp"]["block"], ())}
        return axes

    @staticmethod
    def _block_axes(bdef, spec, lead: tuple) -> Params:
        return P.axes_like(spec, {
            "norm1": P.NORM, "mixer": P.MIXER[bdef.mixer], "norm2": P.NORM,
            "mlp": P.MOE_MLP if bdef.mlp == MOE else P.DENSE_MLP}, lead)

    @staticmethod
    def region_reads(bdef, block, tp) -> Dict[str, set]:
        """For the mixer and the MLP of a block (``block``: a tree of its
        leaves), the names of the leaves a rank reads inside a region split
        over 'model' on the mesh of ``tp`` (each module's
        ``region_reads``); the block's norms are read before any region."""
        if bdef.mixer in (ATTN, MLA):
            mixer = att.region_reads(block["mixer"], tp, bdef.mixer == MLA)
        else:
            mixer = rec.region_reads(bdef.mixer, block["mixer"], tp)
        out = {"mixer": mixer}
        if "mlp" in block:
            out["mlp"] = (moe_lib.region_reads if bdef.mlp == MOE
                          else mlp_region_reads)(block["mlp"], tp)
        return out

    def _block_spec(self, bdef, lead: tuple) -> Params:
        """One block's leaves, each shape prefixed by ``lead`` (the
        stage's layer axis, or nothing for the MTP block)."""
        cfg, dt, f32 = self.cfg, self.dtype, torch.float32
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd, ff = cfg.resolved_head_dim, cfg.d_ff

        def leaf(shape, dtype, std):
            return (lead + shape, dtype, std)

        if bdef.mixer == RGLRU:
            mixer = rec.rglru_param_spec(cfg, lead[0], dt)
        elif bdef.mixer == MLSTM:
            mixer = rec.mlstm_param_spec(cfg, lead[0], dt)
        elif bdef.mixer == SLSTM:
            mixer = rec.slstm_param_spec(cfg, lead[0], dt)
        elif bdef.mixer == MLA:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            rq, rkv = m.q_lora_rank, m.kv_lora_rank
            mixer = {
                "w_dq": leaf((d, rq), dt, d ** -0.5),
                "q_norm": leaf((rq,), f32, 0.0),
                "w_uq": leaf((rq, h, qk), dt, rq ** -0.5),
                "w_dkv": leaf((d, rkv), dt, d ** -0.5),
                "kv_norm": leaf((rkv,), f32, 0.0),
                "w_krope": leaf((d, m.qk_rope_head_dim), dt, d ** -0.5),
                "w_uk": leaf((rkv, h, m.qk_nope_head_dim), dt, rkv ** -0.5),
                "w_uv": leaf((rkv, h, m.v_head_dim), dt, rkv ** -0.5),
                "wo": leaf((h, m.v_head_dim, d), dt,
                           (h * m.v_head_dim) ** -0.5),
            }
        else:
            mixer = {
                "wq": leaf((d, h, hd), dt, d ** -0.5),
                "wk": leaf((d, kv, hd), dt, d ** -0.5),
                "wv": leaf((d, kv, hd), dt, d ** -0.5),
                "wo": leaf((h, hd, d), dt, (h * hd) ** -0.5),
            }
            if cfg.use_qk_norm:
                mixer["q_scale"] = leaf((hd,), f32, 0.0)
                mixer["k_scale"] = leaf((hd,), f32, 0.0)
        block: Params = {}
        if bdef.mixer not in _SELF_NORMED:
            block["norm1"] = {"scale": leaf((d,), f32, 0.0)}
        block["mixer"] = mixer
        if bdef.mlp == NONE:
            return block
        if bdef.mlp == MOE:
            m = cfg.moe
            e, fe = m.num_experts, m.d_ff_expert
            mlp = {"router": leaf((d, e), f32, d ** -0.5),
                   "w_gate": leaf((e, d, fe), dt, d ** -0.5),
                   "w_up": leaf((e, d, fe), dt, d ** -0.5),
                   "w_down": leaf((e, fe, d), dt, fe ** -0.5)}
            if m.num_shared_experts > 0:
                fs = m.d_ff_shared
                mlp["shared"] = {"w_gate": leaf((d, fs), dt, d ** -0.5),
                                 "w_up": leaf((d, fs), dt, d ** -0.5),
                                 "w_down": leaf((fs, d), dt, fs ** -0.5)}
        else:
            # SwiGLU and GeGLU have the same three leaves
            mlp = {"w_gate": leaf((d, ff), dt, d ** -0.5),
                   "w_up": leaf((d, ff), dt, d ** -0.5),
                   "w_down": leaf((ff, d), dt, ff ** -0.5)}
        block["norm2"] = {"scale": leaf((d,), f32, 0.0)}
        block["mlp"] = mlp
        return block

    def init(self, seed: int, on_device: bool = False,
             mesh=None, mode: str = "decode") -> Params:
        """Random parameters, normal(0, std) in float32 and then cast, as
        ``repro`` does. By default from a CPU ``torch.Generator`` seeded
        with ``seed`` (the same values on every device), each leaf drawn
        whole, moved to the model's device; with ``on_device`` from a
        generator on the model's device (much faster at billions of
        parameters, other values), where on a card a stacked leaf is drawn
        one layer at a time, so that at most one layer of one leaf is ever
        held in f32.
        With ``mesh`` (a ``launch.mesh.HostMesh``) this rank's shards
        (``serving.sharding.place_params`` of the whole init, bit for bit):
        each leaf, or each layer of a stacked leaf on the device, is drawn
        whole from the same generator in the same order, cut to this
        rank's slice and freed, so a rank never holds the whole model;
        ``mode`` names the rules ("train": ``training.train_loop.
        place_train_params``' shards)."""
        gen_dev = self.device if on_device else torch.device("cpu")
        gen = torch.Generator(device=gen_dev).manual_seed(seed)
        layerwise = on_device and gen_dev.type != "cpu"
        specs = None
        if mesh is not None:
            from repro_torch.serving.sharding import (cut_leaf,
                                                      param_shardings,
                                                      shard_shape)
            specs = param_shardings(mesh, self, mode)

        def draw(shape, std):
            if isinstance(std, rec.Constant):
                return std.make(shape, gen_dev)
            if std == rec.LAMBDA_INIT:
                return rec.init_lambda(shape, gen, gen_dev)
            if std == 0.0:
                return torch.zeros(shape, dtype=torch.float32,
                                   device=gen_dev)
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen_dev).mul_(std)

        def cut(x, spec, shape):
            return x if spec is None else cut_leaf(mesh, x, spec, shape)

        def make(leaf, spec, stacked):
            if isinstance(leaf, dict):
                return {k: make(v, None if spec is None else spec[k],
                                stacked or k == "stages")
                        for k, v in leaf.items()}
            if isinstance(leaf, list):
                return [make(v, None if spec is None else spec[i], stacked)
                        for i, v in enumerate(leaf)]
            shape, dtype, std = leaf
            if not (layerwise and stacked):
                x = cut(draw(shape, std), spec, shape)
                return x.to(dtype).contiguous().to(self.device)
            local = (shape if spec is None
                     else shard_shape(mesh, shape, spec))
            out = torch.empty(local, dtype=dtype, device=self.device)
            for i in range(shape[0]):
                out[i] = cut(draw(shape[1:], std),
                             None if spec is None else spec[1:], shape[1:])
            return out

        return make(self.param_spec(), specs, False)

    # -- pieces ---------------------------------------------------------------
    def _logits(self, params, x, tp=None, local: bool = False):
        """The logits of the final hidden state ``x``; on a mesh every
        rank's whole logits, or with ``local`` this rank's vocab slice of
        them (the vocab-parallel loss's input)."""
        cfg = self.cfg
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["unembed"]["table"])
        if cfg.frontend.kind == "audio":
            # one head per codebook: (B, S, C, V) (on a mesh each rank's
            # V/N columns of every codebook, gathered unless ``local``)
            if tp is not None:
                x = tp.enter(x, tp.vocab)
            if tp is not None and tp.data_table:
                logits = tp.mesh.all_reduce(torch.einsum(
                    "bsd,cvd->bscv", tp.mesh.shard(x, -1, axis="data"),
                    table), axis="data")
            else:
                logits = torch.einsum("bsd,cvd->bscv", x, table)
            if tp is not None and tp.vocab and not local:
                logits = tp.gather(logits, -1)
        else:
            logits = unembed(table, x, tp, local)
        if cfg.tie_embeddings:
            # the tied table is unit-std (embedding-scaled); rescale
            logits = logits * (cfg.d_model ** -0.5)
        return softcap(logits, cfg.logit_softcap)

    def _mlp(self, bdef, p, x, auxes=None, tp=None, over_data=None):
        """The block's residual MLP (none for an xLSTM block). An MoE layer
        appends its load-balance loss (a 0-dim f32 tensor, ``over_data``
        as ``moe.route``'s) to the list ``auxes`` when given: nothing is
        updated in place, so a rematerialised layer recomputes it without
        side effects."""
        if bdef.mlp == NONE:
            return x
        h = rmsnorm(p["norm2"], x, self.cfg.rms_eps)
        if bdef.mlp == MOE:
            y, a = moe_lib.moe_forward(p["mlp"], self.cfg, h,
                                       capacity_factor=self.capacity_factor,
                                       tp=tp, over_data=over_data)
            if auxes is not None:
                auxes.append(a)
            return x + y
        mlp = swiglu if bdef.mlp == SWIGLU else gelu_mlp
        return x + mlp(p["mlp"], h, tp)

    def _head(self, params, x, last_only: bool, logits_index, tp=None,
              local: bool = False):
        x = rmsnorm(params["final_norm"], x, self.cfg.rms_eps)
        if logits_index is not None:
            idx = att.positions_1d(logits_index, x.shape[0], x.device).long()
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        elif last_only:
            x = x[:, -1:]
        return self._logits(params, x, tp, local)

    # -- full-sequence forward ----------------------------------------------
    def _embed_tokens(self, params, tokens, tp=None):
        """Token embeddings (B, S, D) of text tokens (B, S), or of audio
        tokens (B, S, C): the sum of the C codebooks' embeddings (on a
        mesh each rank looks up its V/N rows of every codebook, masked as
        ``layers.embed`` does, sums the codebooks and all-reduces once)."""
        table = params["embed"]["table"]
        if self.cfg.frontend.kind != "audio":
            return embed(params["embed"], tokens, tp)
        books = torch.arange(table.shape[0], device=tokens.device)
        if tp is None or not (tp.vocab or tp.data_table):
            return table[books, tokens.long()].sum(dim=2)
        if not tp.vocab:
            return join_rows(table[books, tokens.long()].sum(dim=2), tp)
        rows = table.shape[1]
        local = tokens.long() - tp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = table[books, local.clamp(0, rows - 1)]
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        return join_rows(x.sum(dim=2), tp)

    def _embed_inputs(self, params, batch, tp=None):
        """Input embeddings (B, S, D) and their positions (B, S) int32.
        A vision model puts its projected ``batch["image_embeds"]``
        (B, P, E) in front of the text: P + S positions."""
        x = self._embed_tokens(params, batch["tokens"], tp)
        if self.cfg.frontend.kind == "vision":
            img = batch["image_embeds"]
            vp = params["vision_proj"]
            # einsum's type promotion: f32 embeddings project in f32
            dt = torch.promote_types(img.dtype, vp["w1"].dtype)
            h = F.gelu((img.to(dt) @ vp["w1"].to(dt)).float(),
                       approximate="tanh").to(x.dtype)
            if tp is not None and tp.data_vision:
                # w1's output D is this rank's columns: join them
                h = tp.mesh.gather(h, -1, axis="data")
            v, = project(h, [vp["w2"]], tp, tp is not None and tp.data_proj)
            x = torch.cat([v, x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :].expand(b, s)
        return x, positions

    @property
    def num_scanned_layers(self) -> int:
        """Layers in stage-repeat units (``repro``'s scanned layers)."""
        return sum(stage.repeat for stage in self.cfg.stages)

    def _block(self, bdef, p, x, positions, cache=None, lengths=None,
               auxes=None, tp=None, over_data=None):
        """One block over the full sequence ``x``: its mixer (filling
        ``cache`` when given) and its MLP, both residual."""
        cfg = self.cfg
        h = (x if bdef.mixer in _SELF_NORMED
             else rmsnorm(p["norm1"], x, cfg.rms_eps))
        if bdef.mixer in _RECURRENT_FORWARD:
            y, state = _RECURRENT_FORWARD[bdef.mixer](p["mixer"], cfg, h,
                                                      lengths, tp=tp)
            if cache is not None:
                _store(cache, state)
        elif bdef.mixer == MLA:
            y, (ckv, krope) = att.mla_forward(p["mixer"], cfg, h, positions,
                                              window=bdef.window, tp=tp)
            if cache is not None:
                att.mla_cache_fill(cache, ckv, krope, x.shape[1], lengths)
        else:
            y, (k, v) = att.attn_forward(p["mixer"], cfg, h, positions,
                                         window=bdef.window, tp=tp)
            if cache is not None:
                att.cache_fill(cache, k, v, x.shape[1], lengths)
        return self._mlp(bdef, p, x + y, auxes, tp, over_data)

    def _repeat(self, stage, layer, x, positions, caches=None,
                lengths=None, tp=None, over_data=None):
        """One scanned layer: every block of a stage repeat, each filling
        its cache in ``caches`` when given. Returns (x, the MoE blocks'
        load-balance losses, a list), so that a rematerialised layer
        recomputes them without side effects."""
        auxes = []
        for bi, bdef in enumerate(stage.blocks):
            x = self._block(bdef, layer[bi], x, positions,
                            None if caches is None else caches[bi], lengths,
                            auxes, tp, over_data)
        return x, auxes

    def _layer_range(self, params, x, positions, lo: int = 0,
                     hi: Optional[int] = None, *, caches=None,
                     lengths=None, auxes=None, train: bool = False,
                     tp=None, over_data=None):
        """Scanned layers [lo, hi) (stage-repeat units, every block of a
        repeat) over the full sequence ``x``; with ``caches`` each layer
        also fills its cache, with ``auxes`` (a list) each MoE block
        appends its load-balance loss. ``train`` rematerialises every layer
        in the backward pass (``repro``'s ``jax.checkpoint`` around its
        scanned body): one ``torch.utils.checkpoint`` call per layer. The
        one layer loop of ``forward``, of ``loss`` and of
        ``core.patterns.inference.PartitionedLM``."""
        cfg = self.cfg
        hi = self.num_scanned_layers if hi is None else hi
        body = (partial(checkpoint, self._repeat, use_reentrant=False)
                if train else self._repeat)
        first = 0                       # this stage's first scanned layer
        for si, (stage, sp) in enumerate(zip(cfg.stages, params["stages"])):
            lis = range(max(lo - first, 0), min(hi - first, stage.repeat))
            nb = range(len(stage.blocks))
            if train:
                # one unbind per leaf: its backward stacks the layers'
                # gradients once, where indexing would add a stage-sized
                # gradient per layer
                blocks = [_unstack(sp[f"b{bi}"]) for bi in nb]
            for li in lis:
                layer = ([blk[li] for blk in blocks] if train
                         else [_layer(sp[f"b{bi}"], li) for bi in nb])
                cache = (None if caches is None
                         else [_layer(caches[si][bi], li) for bi in nb])
                x, got = body(stage, layer, x, positions, cache, lengths, tp,
                              over_data)
                if auxes is not None:
                    auxes.extend(got)
            first += stage.repeat
        return x

    def forward(self, params, batch, *, want_cache: bool = False,
                cache_width: Optional[int] = None, last_only: bool = False,
                lengths=None, logits_index=None, with_aux: bool = False,
                train: bool = False, with_hidden: bool = False,
                mesh=None, over_data=None):
        """Returns (logits, caches or None), and with ``with_aux`` the MoE
        layers' summed load-balance loss next (0 without MoE), as
        ``repro``'s ``forward`` sums it, and with ``with_hidden`` the final
        normed hidden state (B, S, D) last (``repro``'s ``h_final``).
        ``last_only`` unembeds only the final position, ``logits_index``
        (B,) only the given one; ``lengths`` (B,) keeps right-pad rows out
        of the ring at install (see ``attention._fill_slots``) and out of
        the recurrent state (identity steps past each row's length).
        ``train`` rematerialises each layer in the backward pass (no
        caches). ``mesh``: this rank's shards on a mesh (module
        docstring); the caches are its shards too. ``over_data`` sums the
        MoE layers' routing counts over a data-parallel step's ranks
        (``moe.route``)."""
        return self._forward(params, batch, tensor_parallel(self.cfg, mesh),
                             want_cache=want_cache, cache_width=cache_width,
                             last_only=last_only, lengths=lengths,
                             logits_index=logits_index, with_aux=with_aux,
                             train=train, with_hidden=with_hidden,
                             over_data=over_data)

    def _forward(self, params, batch, tp, *, want_cache=False,
                 cache_width=None, last_only=False, lengths=None,
                 logits_index=None, with_aux=False, train=False,
                 with_hidden=False, over_data=None, local=False):
        """``forward`` on the ``TensorParallel`` ``tp`` (None: one
        device); ``local`` keeps each rank's vocab slice of the logits."""
        if train and want_cache:
            raise ValueError("forward: train=True keeps no caches")
        params = _whole_norms(params, tp)
        x, positions = self._embed_inputs(params, batch, tp)
        caches = (self.init_cache(x.shape[0], cache_width,
                                  mesh=None if tp is None else tp.mesh)
                  if want_cache else None)
        auxes = []
        x = self._layer_range(params, x, positions, caches=caches,
                              lengths=lengths, auxes=auxes, train=train,
                              tp=tp, over_data=over_data)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in auxes:
            aux = aux + a
        out = (self._head(params, x, last_only, logits_index, tp, local),
               caches)
        if with_aux:
            out += (aux,)
        if with_hidden:
            out += (rmsnorm(params["final_norm"], x, self.cfg.rms_eps),)
        return out

    # -- losses ---------------------------------------------------------------
    def loss(self, params, batch, train: bool = True, denoms=None,
             over_data=None, mesh=None):
        """Next-token cross entropy, plus ``router_aux_loss`` times the MoE
        load-balance loss, plus 0.1 times the depth-1 MTP loss when
        ``mtp_depth > 0`` and ``train``; a vision model counts only its
        text positions. Returns (loss, {"ce", "aux"[, "mtp"]}), as
        ``repro``'s ``LM.loss``. ``train`` also rematerialises each layer
        in the backward pass. ``denoms`` ({"ce": n[, "mtp": n]}, counts of
        the labels >= 0 over a global batch that this batch is a part of)
        makes each cross entropy this batch's share of the global one, its
        summed losses over that count (``label_counts``), so that the
        shares of the parts add up to the loss of the whole; with
        ``over_data``, which sums a tensor over a data-parallel step's
        ranks, so does the MoE aux loss (``moe.route``). ``mesh``: a mesh
        whose model axis (above 1) splits ``params`` by the train rules,
        whole over 'data' (``training.train_loop``'s step); the layers run
        tensor-parallel and each cross entropy is vocab-parallel on each
        rank's slice of the logits (``_xent``), never gathered."""
        cfg = self.cfg
        denoms = denoms or {}
        tp = tensor_parallel(cfg, mesh, mode="train")
        logits, _, aux, h_final = self._forward(
            params, batch, tp, train=train, with_aux=True, with_hidden=True,
            over_data=over_data, local=True)
        if cfg.frontend.kind == "vision":
            logits = logits[:, cfg.frontend.num_prefix_tokens:]
        ce = _xent(logits, batch["labels"], denoms.get("ce"), tp)
        total = ce + (cfg.moe.router_aux_loss * aux if cfg.moe else 0.0)
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth > 0 and train:
            mtp = self._mtp_loss(params, batch, h_final, denoms.get("mtp"),
                                 tp)
            total = total + 0.1 * mtp
            metrics["mtp"] = mtp
        return total, metrics

    def label_counts(self, batch, train: bool = True) -> torch.Tensor:
        """The labels >= 0 that ``loss`` averages over: (ce[, mtp]) int64,
        the MTP count when ``loss`` computes the MTP loss."""
        labels = batch["labels"]
        counts = [(labels >= 0).sum()]
        if self.cfg.mtp_depth > 0 and train:
            counts.append((labels[:, 1:] >= 0).sum())
        return torch.stack(counts)

    def _mtp_loss(self, params, batch, h_final, denom=None, tp=None):
        """DeepSeek-V3's multi-token prediction: a depth-1 head predicts
        token t + 2 from [h_t ; embed(token_{t+1})] through ``proj``, one
        unstacked attention (or MLA) + SwiGLU block and its own norm,
        against ``labels[:, 1:]`` (on a mesh ``tp``, tensor-parallel and
        vocab-parallel as ``loss``)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        if cfg.frontend.kind == "vision":
            h_final = h_final[:, cfg.frontend.num_prefix_tokens:]
        emb_next = embed(params["embed"], tokens[:, 1:], tp)
        h = torch.cat([h_final[:, :-1], emb_next], dim=-1)
        h = h @ params["mtp"]["proj"]
        b, s = h.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device)[None, :].expand(b, s)
        bdef = BlockDef(mixer=ATTN if cfg.mla is None else MLA, mlp=SWIGLU)
        h = self._block(bdef, params["mtp"]["block"], h, positions, tp=tp)
        h = rmsnorm(params["mtp"]["norm"], h, cfg.rms_eps)
        return _xent(self._logits(params, h, tp, local=True), labels[:, 1:],
                     denom, tp)

    def prefill(self, params, batch, cache_width: int,
                last_only: bool = False, lengths=None, logits_index=None,
                mesh=None):
        """Full forward that also returns populated caches."""
        return self.forward(params, batch, want_cache=True,
                            cache_width=cache_width, last_only=last_only,
                            lengths=lengths, logits_index=logits_index,
                            mesh=mesh)

    # -- decode -------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, mesh=None) -> List[Any]:
        """Per stage, a tuple over blocks of dicts of stacked (L, B, ...)
        tensors: K/V rings (positions start at -1, empty) for attention,
        ``ckv``/``krope`` latent rings for MLA, zero recurrent state for
        RG-LRU (``h``, ``conv``), mLSTM (``C``, ``n``, ``m``) and sLSTM
        (``c``, ``n``, ``h``, ``m``). On a mesh, this rank's shard: the
        K/V rings hold its KV heads when they split, the RG-LRU state its
        channels and the xLSTM states its heads."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        tp = tensor_parallel(cfg, mesh)
        h = rec.rec_heads(cfg, tp)
        kv = (cfg.num_kv_heads // tp.ways if tp is not None and tp.kv
              else cfg.num_kv_heads)
        caches = []
        for stage in cfg.stages:
            blocks = []
            for bdef in stage.blocks:
                if bdef.mixer == RGLRU:
                    one = rec.rglru_state_spec(cfg, batch, self.dtype,
                                               self.device, tp)
                elif bdef.mixer == MLSTM:
                    one = rec.mlstm_state_init(batch, h, hd, self.device)
                elif bdef.mixer == SLSTM:
                    one = rec.slstm_state_init(batch, h, hd, self.device)
                elif bdef.mixer == MLA:
                    one = att.init_mla_cache(
                        cfg, batch, _attn_width(bdef.window, seq_len),
                        self.dtype, self.device)
                else:
                    one = att.init_kv_cache(
                        batch, _attn_width(bdef.window, seq_len), kv,
                        cfg.resolved_head_dim, self.dtype, self.device)
                blocks.append({k: v[None].repeat(
                    (stage.repeat,) + (1,) * v.dim()) for k, v in one.items()})
            caches.append(tuple(blocks))
        return caches

    def chunk_incompatible_mixer(self) -> Optional[str]:
        """The first mixer kind that cannot take multi-token prompt chunks
        (recurrent state folds tokens strictly in sequence), or None when
        every block is attention or MLA. One-token decode works for every
        mixer."""
        for stage in self.cfg.stages:
            for bdef in stage.blocks:
                if bdef.mixer not in (ATTN, MLA):
                    return bdef.mixer
        return None

    def decode_step(self, params, caches, tokens, cur_pos, *,
                    layout=None, block_tables=None, valid=None,
                    mesh=None):
        """One-token decode. tokens (B, 1) (audio: (B, 1, C)); ``cur_pos``
        scalar or (B,) (a vision model's positions count its prefix);
        ``valid`` (B, 1): False rows compute logits but leave the cache
        (and the recurrent state) untouched. Returns (logits (B, 1, V),
        caches), the caches updated in place."""
        return self.prefill_chunk(params, caches, tokens, cur_pos,
                                  layout=layout, block_tables=block_tables,
                                  valid=valid, mesh=mesh)

    def prefill_chunk(self, params, caches, tokens, start_pos, *,
                      layout=None, block_tables=None, valid=None,
                      logits_index=None, mesh=None):
        """Resume prefill with a T-token chunk per slot starting at
        ``start_pos`` (T = 1 is ``decode_step``). tokens (B, T), audio
        (B, T, C); a vision model's chunk is plain text (its image prefix
        already lives in the cache). ``valid`` (B, T) masks right-pad
        tokens out of the cache; ``logits_index`` (B,) unembeds one chunk
        position per row. Chunks longer than one token need attention or
        MLA mixers. ``mesh``: as in ``forward``. Returns (logits,
        caches)."""
        cfg = self.cfg
        tp = tensor_parallel(cfg, mesh)
        b, t = tokens.shape[:2]
        if t > 1:
            bad = self.chunk_incompatible_mixer()
            if bad is not None:
                raise NotImplementedError(
                    f"prefill_chunk needs attention mixers "
                    f"(got {bad!r}); chunk length must be 1")
        start = att.positions_1d(start_pos, b, tokens.device)
        params = _whole_norms(params, tp)
        x = self._embed_tokens(params, tokens, tp)
        for stage, sp, sc in zip(cfg.stages, params["stages"], caches):
            for li in range(stage.repeat):
                for bi, bdef in enumerate(stage.blocks):
                    p = _layer(sp[f"b{bi}"], li)
                    c = _layer(sc[bi], li)
                    h = (x if bdef.mixer in _SELF_NORMED
                         else rmsnorm(p["norm1"], x, cfg.rms_eps))
                    if bdef.mixer in _RECURRENT_DECODE:
                        y, state = _RECURRENT_DECODE[bdef.mixer](
                            p["mixer"], cfg, h, c, valid, tp=tp)
                        _store(c, state)
                    elif bdef.mixer == MLA:
                        y, _ = att.mla_decode(
                            p["mixer"], cfg, h, c, start,
                            window=bdef.window, layout=layout,
                            block_tables=block_tables, valid=valid, tp=tp)
                    else:
                        y, _ = att.attn_decode(
                            p["mixer"], cfg, h, c, start,
                            window=bdef.window, layout=layout,
                            block_tables=block_tables, valid=valid, tp=tp)
                    x = self._mlp(bdef, p, x + y, tp=tp)
        return self._head(params, x, False, logits_index, tp), caches


# the recurrent mixers' full-sequence forward (params, cfg, x, lengths, tp=)
# and one-token decode (params, cfg, x1, state, valid, tp=)
_RECURRENT_FORWARD = {RGLRU: rec.rglru_block_forward,
                      MLSTM: rec.mlstm_block_forward,
                      SLSTM: rec.slstm_block_forward}
_RECURRENT_DECODE = {RGLRU: rec.rglru_block_decode,
                     MLSTM: rec.mlstm_block_decode,
                     SLSTM: rec.slstm_block_decode}


def _xent(logits, labels, denom=None, tp=None):
    """Masked softmax cross entropy in f32, averaged over the labels >= 0
    (at least one; or summed over ``denom``, a global count); labels < 0
    are ignored. Logits (..., V), labels the leading shape (audio:
    (B, S, C)). Where the mesh ``tp`` splits the vocab, ``logits`` are
    this rank's V/M slice and the loss is vocab-parallel (``_vocab_nll``):
    every rank returns the same loss, and the whole logits never exist."""
    mask = labels >= 0
    if tp is not None and tp.vocab:
        nll = _vocab_nll(logits, labels, mask, tp)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp_min(0).long()[
            ..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp_min(mask.sum() if denom is None
                                       else denom, 1)


def _vocab_nll(logits, labels, mask, tp):
    """-log softmax at each label from this rank's vocab slice ``logits``
    (..., V/M) of the whole (..., V): the row max (one f32 max-reduce over
    'model', outside autograd: the log-sum-exp does not depend on it),
    then the sum of exps and the label's logit (on the rank that holds
    it, else 0), both summed over 'model' in one f32 all-reduce
    (``tp.reduce``: under autograd each rank's slice gets the replicated
    gradient). log_softmax's own formula, max + log(sum exp(z - max)) -
    z_label, with the vocab's sums split by rank."""
    z = logits.float()
    v = z.shape[-1]
    top = tp.mesh.all_reduce(z.detach().amax(-1), op="max")
    local = labels.long() - tp.rank * v
    mine = mask & (local >= 0) & (local < v)
    zt = torch.gather(z, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    zt = torch.where(mine, zt, torch.zeros_like(zt))
    se = torch.exp(z - top[..., None]).sum(-1)
    se, zt = tp.reduce(torch.stack([se, zt]), True).unbind(0)
    return torch.log(se) + top - zt


def _whole_norms(params, tp):
    """``params`` with every norm scale (a ``scale`` leaf: the blocks'
    ``norm1``/``norm2``, the xLSTM mixers' ``norm``, ``final_norm``) whole
    over 'data' where the mesh ``tp`` splits it there: this rank's D/data
    columns of every one joined into one gather. Other leaves are the
    same tensors; without a data split, ``params`` itself."""
    if tp is None or not tp.data_norm:
        return params
    found = []

    def collect(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "scale" and not isinstance(v, (dict, list)):
                    found.append(v)
                else:
                    collect(v)
        elif isinstance(tree, list):
            for v in tree:
                collect(v)

    collect(params)
    w = found[0].shape[-1]
    rows = [t.reshape(-1, w) for t in found]
    whole = iter(tp.gather(torch.cat(rows, 0), -1, axis="data").split(
        [r.shape[0] for r in rows], 0))
    done = {id(t): next(whole).reshape(*t.shape[:-1], w * tp.data_ways)
            for t in found}

    def swap(tree):
        if isinstance(tree, dict):
            return {k: (done[id(v)] if k == "scale" and id(v) in done
                        else swap(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [swap(v) for v in tree]
        return tree

    return swap(params)


def _unstack(tree):
    """A stacked dict tree as a list of per-layer trees (``torch.unbind``
    of every leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _store(cache: dict, state: dict) -> None:
    """Write a block's new recurrent state into its cache views, in place."""
    for key, value in state.items():
        cache[key].copy_(value)
