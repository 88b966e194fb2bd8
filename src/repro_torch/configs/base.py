"""Architecture configuration schema (a copy of ``repro.configs.base``; the
two must stay field-equal, which ``tests/test_torch_configs.py`` pins).

Every assigned architecture is expressed as a :class:`ModelConfig` composed of
*stages*: a stage is a short sequence of block definitions repeated ``repeat``
times, with parameters stacked on a leading layer axis.  A block pairs a
temporal mixer (attention / RG-LRU / sLSTM / mLSTM / MLA) with a channel
mixer (SwiGLU / GELU-MLP / MoE / none).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block / stage definitions
# ---------------------------------------------------------------------------

# temporal mixer kinds
ATTN = "attn"          # (GQA/MHA) softmax attention, optional sliding window
MLA = "mla"            # DeepSeek multi-head latent attention
RGLRU = "rglru"        # RecurrentGemma real-gated linear recurrent unit
SLSTM = "slstm"        # xLSTM scalar-memory LSTM
MLSTM = "mlstm"        # xLSTM matrix-memory LSTM

# channel mixer kinds
SWIGLU = "swiglu"
GELU_MLP = "gelu_mlp"
MOE = "moe"
NONE = "none"          # block has no separate MLP (xLSTM blocks)


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: str = ATTN
    mlp: str = SWIGLU
    window: Optional[int] = None   # sliding-window size for ATTN (None = full)

    def __post_init__(self):
        assert self.mixer in (ATTN, MLA, RGLRU, SLSTM, MLSTM), self.mixer
        assert self.mlp in (SWIGLU, GELU_MLP, MOE, NONE), self.mlp


@dataclasses.dataclass(frozen=True)
class Stage:
    """``blocks`` repeated ``repeat`` times (scanned when repeat > 1)."""
    blocks: Tuple[BlockDef, ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_loss: float = 0.01   # load-balance loss coefficient


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub (the one allowed carve-out).

    kind="vision": ``input_specs`` provides patch embeddings
    ``(B, num_prefix_tokens, embed_dim)`` from a stubbed ViT; a learned
    projector maps them to d_model and they prefix the text tokens.
    kind="audio": tokens carry ``num_codebooks`` parallel EnCodec streams;
    the conv codec producing them is the stub.
    """
    kind: str = "none"              # none | vision | audio
    embed_dim: int = 0              # vision encoder output dim
    num_prefix_tokens: int = 0      # vision tokens prepended to the sequence
    num_codebooks: int = 1          # audio codebook streams


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    source: str                     # citation for the config
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    head_dim: int = 0               # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    use_qk_norm: bool = False
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0      # 0 = disabled (recurrentgemma uses 30)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    frontend: FrontendConfig = FrontendConfig()
    # recurrent hyper-params
    rglru_conv_width: int = 4       # temporal conv1d preceding the RG-LRU
    lru_width: int = 0              # 0 -> d_model
    # decode behaviour
    sub_quadratic: bool = False     # True if decode state is bounded (SSM/SWA)
    long_context_window: int = 0    # >0: window override used for long_500k
    # multi-token prediction (DeepSeek-V3); extra depth-1 MTP head when > 0
    mtp_depth: int = 0
    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        n = sum(len(s.blocks) * s.repeat for s in self.stages)
        assert n == self.num_layers, (
            f"{self.name}: stages define {n} blocks != num_layers={self.num_layers}")
        assert self.num_heads % self.num_kv_heads == 0 or self.mla is not None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 for MXU alignment / sharding."""
        return ((self.vocab_size + 255) // 256) * 256

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers worth of stages, d_model ≤ 512,
        ≤4 experts — same family, runnable on one CPU device."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        ratio = max(1, self.num_heads // self.num_kv_heads)
        n_kv = max(1, n_heads // min(ratio, n_heads))
        head_dim = 64
        stages = _reduce_stages(self.stages)
        n_layers = sum(len(s.blocks) * s.repeat for s in stages)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                num_experts_per_tok=min(self.moe.num_experts_per_tok, 2),
                d_ff_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_shared=128 * max(1, min(self.moe.num_shared_experts, 1)),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
        frontend = self.frontend
        if frontend.kind == "vision":
            frontend = dataclasses.replace(frontend, embed_dim=64,
                                           num_prefix_tokens=8)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            stages=stages,
            moe=moe,
            mla=mla,
            lru_width=0,
            frontend=frontend,
            param_dtype="float32",
        )


def _reduce_stages(stages: Tuple[Stage, ...]) -> Tuple[Stage, ...]:
    """Keep one repetition of each distinct stage (window shrunk)."""
    out = []
    for s in stages:
        blocks = tuple(
            dataclasses.replace(b, window=min(b.window, 16) if b.window else None)
            for b in s.blocks)
        out.append(Stage(blocks=blocks, repeat=1))
    return tuple(out)


def dense_stages(n_layers: int, mlp: str = SWIGLU,
                 window: Optional[int] = None) -> Tuple[Stage, ...]:
    return (Stage(blocks=(BlockDef(mixer=ATTN, mlp=mlp, window=window),),
                  repeat=n_layers),)


def apply_long_context(cfg: ModelConfig) -> ModelConfig:
    """Variant used for ``long_500k`` on otherwise-quadratic archs: every
    full-attention block gets the config's sliding-window override. Archs
    that are already sub-quadratic are returned unchanged (DESIGN.md §5)."""
    if cfg.sub_quadratic:
        return cfg
    assert cfg.long_context_window > 0, (
        f"{cfg.name}: long_500k needs sub_quadratic or long_context_window")
    w = cfg.long_context_window
    stages = tuple(
        Stage(blocks=tuple(
            dataclasses.replace(
                b, window=min(b.window, w) if b.window else w)
            if b.mixer in (ATTN, MLA) else b
            for b in s.blocks), repeat=s.repeat)
        for s in cfg.stages)
    return dataclasses.replace(cfg, name=cfg.name + "-swa",
                               stages=stages, sub_quadratic=True)
