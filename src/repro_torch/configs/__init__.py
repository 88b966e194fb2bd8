"""Architecture configs (``get_config(<id>)``) and input-shape registry.

The same schema and architecture files as ``repro.configs``, registered
in the port's copy of ``repro.utils.registry`` (whose package imports
JAX)."""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, GELU_MLP, MLA, MLSTM, MOE, NONE,
                                      RGLRU, SLSTM, SWIGLU, BlockDef,
                                      FrontendConfig, MLAConfig, ModelConfig,
                                      MoEConfig, Stage, dense_stages)
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape
from repro_torch.utils.registry import Registry


ARCHS = Registry("architecture")

# import side-effect registration
from repro_torch.configs import (ace_video_query, deepseek_v3_671b,  # noqa: E402,F401
                                 glm4_9b, internvl2_2b, mixtral_8x22b,
                                 musicgen_medium, qwen3_4b,
                                 recurrentgemma_9b, smollm_135m,
                                 starcoder2_7b, xlstm_125m)

ASSIGNED_ARCHS = (
    "recurrentgemma-9b", "qwen3-4b", "smollm-135m", "xlstm-125m",
    "mixtral-8x22b", "starcoder2-7b", "deepseek-v3-671b", "musicgen-medium",
    "glm4-9b", "internvl2-2b",
)


def get_config(name: str):
    return ARCHS.get(name)()


__all__ = [
    "ARCHS", "ASSIGNED_ARCHS", "get_config", "ModelConfig", "MoEConfig",
    "MLAConfig", "FrontendConfig", "Stage", "BlockDef", "INPUT_SHAPES",
    "InputShape", "get_shape", "dense_stages", "ATTN", "MLA", "RGLRU",
    "SLSTM", "MLSTM", "SWIGLU", "GELU_MLP", "MOE", "NONE",
]
