"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 recurrent:attn
pattern [arXiv:2402.19427].

38 layers = 12 × (rec, rec, local-attn) + 2 trailing recurrent blocks.
Local attention window 2048; GQA kv=1 (MQA); GeGLU MLP; logit soft-cap 30.
Sub-quadratic by construction (bounded recurrent state + windowed cache), so
``long_500k`` runs natively.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    rec = b.BlockDef(mixer=b.RGLRU, mlp=b.GELU_MLP)
    attn = b.BlockDef(mixer=b.ATTN, mlp=b.GELU_MLP, window=2048)
    return b.ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        stages=(
            b.Stage(blocks=(rec, rec, attn), repeat=12),
            b.Stage(blocks=(rec,), repeat=2),
        ),
        rope_theta=10000.0,
        logit_softcap=30.0,
        rglru_conv_width=4,
        sub_quadratic=True,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("recurrentgemma-9b", config)


register()
