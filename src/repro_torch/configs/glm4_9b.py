"""glm4-9b [dense] — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b].

40L, d_model 4096, 32 heads (head_dim 128), GQA kv=2, SwiGLU d_ff 13696,
vocab 151552. Full attention; ``long_500k`` uses the sliding-window override.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    return b.ModelConfig(
        name="glm4-9b",
        family="dense",
        source="hf:THUDM/glm-4-9b",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=151552,
        stages=b.dense_stages(40, mlp=b.SWIGLU),
        rope_theta=10000.0,
        long_context_window=8192,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("glm4-9b", config)


register()
