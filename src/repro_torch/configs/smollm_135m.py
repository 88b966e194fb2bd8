"""smollm-135m [dense] — llama-arch small model
[hf:HuggingFaceTB/SmolLM-135M].

30L, d_model 576, 9 heads (GQA kv=3), SwiGLU d_ff 1536, vocab 49152.
Also the default *edge* model of the ACE inter-model cascade (the
MobileNetV2-role of the paper's video query, transposed to LM serving).
"""
from repro_torch.configs import base as b


def config() -> b.ModelConfig:
    return b.ModelConfig(
        name="smollm-135m",
        family="dense",
        source="hf:HuggingFaceTB/SmolLM-135M",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        stages=b.dense_stages(30, mlp=b.SWIGLU),
        rope_theta=10000.0,
        tie_embeddings=True,
        long_context_window=8192,
    )


def register():
    from repro_torch.configs import ARCHS
    ARCHS.register("smollm-135m", config)


register()
