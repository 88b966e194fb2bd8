"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

12L, d_model 768, 4 heads, d_ff=0 (xLSTM blocks carry their own up/down
projections; no separate MLP). Recurrent state is bounded -> native
``long_500k``. vocab 50304 (GPT-NeoX tokenizer, already 256-aligned).
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    slstm = b.BlockDef(mixer=b.SLSTM, mlp=b.NONE)
    mlstm = b.BlockDef(mixer=b.MLSTM, mlp=b.NONE)
    return b.ModelConfig(
        name="xlstm-125m",
        family="ssm",
        source="arXiv:2405.04517 (xLSTM)",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        stages=(b.Stage(blocks=(mlstm, slstm), repeat=6),),
        sub_quadratic=True,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("xlstm-125m", config)


register()
