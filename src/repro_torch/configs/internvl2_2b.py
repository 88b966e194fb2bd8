"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The implemented model is the InternLM2-1.8B language decoder: 24L, d_model
2048, 16 heads (GQA kv=8, head_dim 128), SwiGLU d_ff 8192, vocab 92553
(padded to 92672 for sharding).

Frontend carve-out: the InternViT-300M vision encoder is a stub —
``input_specs`` provides (B, 256, 1024) patch embeddings; a learned 2-layer
projector maps them to d_model and they prefix the text sequence.
``long_500k`` uses the sliding-window override.
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    return b.ModelConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821 (InternVL2; InternLM2-1.8B LM)",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        stages=b.dense_stages(24, mlp=b.SWIGLU),
        rope_theta=1_000_000.0,
        frontend=b.FrontendConfig(kind="vision", embed_dim=1024,
                                  num_prefix_tokens=256),
        long_context_window=8192,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("internvl2-2b", config)


register()
