"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437].

61L, d_model 7168, 128 heads (MLA: kv_lora 512 + rope 64 compressed cache),
first 3 layers dense (d_ff 18432), remaining 58 MoE (expert d_ff 2048,
256 routed top-8 + 1 shared). vocab 129280. MTP implemented as an optional
depth-1 extra prediction head (mtp_depth=1).

``long_500k`` uses the sliding-window override (MLA cache is compressed but
attention itself is full) — recorded per DESIGN.md §Arch-applicability.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    dense = b.BlockDef(mixer=b.MLA, mlp=b.SWIGLU)
    moe = b.BlockDef(mixer=b.MLA, mlp=b.MOE)
    return b.ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        source="arXiv:2412.19437 (DeepSeek-V3)",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=18432,                      # dense layers
        vocab_size=129280,
        stages=(
            b.Stage(blocks=(dense,), repeat=3),
            b.Stage(blocks=(moe,), repeat=58),
        ),
        rope_theta=10000.0,
        moe=b.MoEConfig(num_experts=256, num_experts_per_tok=8,
                        d_ff_expert=2048, num_shared_experts=1,
                        d_ff_shared=2048, router_aux_loss=0.001),
        mla=b.MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                        qk_nope_head_dim=128, qk_rope_head_dim=64,
                        v_head_dim=128),
        long_context_window=8192,
        mtp_depth=1,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("deepseek-v3-671b", config)


register()
