"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), expert d_ff 16384,
vocab 32768. SWA window 4096 -> sub-quadratic decode, ``long_500k`` native.
"""
from repro_torch.configs import base as b

SWA_WINDOW = 4096


def config() -> b.ModelConfig:
    blk = b.BlockDef(mixer=b.ATTN, mlp=b.MOE, window=SWA_WINDOW)
    return b.ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        source="arXiv:2401.04088 (Mixtral of Experts)",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        stages=(b.Stage(blocks=(blk,), repeat=56),),
        rope_theta=1_000_000.0,
        moe=b.MoEConfig(num_experts=8, num_experts_per_tok=2,
                        d_ff_expert=16384),
        sub_quadratic=True,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("mixtral-8x22b", config)


register()
