"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens
[arXiv:2306.05284].

48L, d_model 1536, 24 heads (MHA, kv=24, head_dim 64), gelu MLP d_ff 6144,
vocab 2048 per codebook, 4 codebooks with the MusicGen delay pattern
(embeddings summed, one LM head per codebook).

Frontend carve-out: the EnCodec conv codec producing the token streams is a
stub — ``input_specs`` provides the (B, S, 4) token grid directly.
``long_500k`` uses the sliding-window override.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    return b.ModelConfig(
        name="musicgen-medium",
        family="audio",
        source="arXiv:2306.05284 (MusicGen)",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        stages=b.dense_stages(48, mlp=b.GELU_MLP),
        rope_theta=10000.0,
        frontend=b.FrontendConfig(kind="audio", num_codebooks=4),
        long_context_window=8192,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("musicgen-medium", config)


register()
