"""starcoder2-7b [dense] — GQA, RoPE, sliding-window 4096
[arXiv:2402.19173].

32L, d_model 4608, 36 heads (GQA kv=4, head_dim 128), gelu MLP d_ff 18432,
vocab 49152. StarCoder2 trains with SWA-4096 -> ``long_500k`` native.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    return b.ModelConfig(
        name="starcoder2-7b",
        family="dense",
        source="arXiv:2402.19173 (StarCoder2)",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        stages=b.dense_stages(32, mlp=b.GELU_MLP, window=4096),
        rope_theta=100_000.0,
        sub_quadratic=True,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("starcoder2-7b", config)


register()
