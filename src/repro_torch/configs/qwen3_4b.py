"""qwen3-4b [dense] — qk-norm, GQA kv=8 [hf:Qwen/Qwen3-8B family].

36L, d_model 2560, 32 heads (head_dim 128, decoupled from d_model), GQA kv=8,
SwiGLU d_ff 9728, vocab 151936. Full attention; ``long_500k`` uses the
sliding-window override (window 8192) recorded here.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    return b.ModelConfig(
        name="qwen3-4b",
        family="dense",
        source="hf:Qwen/Qwen3-8B (4B sibling config)",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        stages=b.dense_stages(36, mlp=b.SWIGLU),
        rope_theta=1_000_000.0,
        use_qk_norm=True,
        tie_embeddings=True,
        long_context_window=8192,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("qwen3-4b", config)


register()
