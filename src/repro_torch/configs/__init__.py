"""Architecture configs (``get_config(<id>)``) and input-shape registry.

The same schema and architecture files as ``repro.configs``, with a plain
dict registry in place of ``repro.utils.registry`` (whose package imports
JAX)."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import (ATTN, GELU_MLP, MLA, MLSTM, MOE, NONE,
                                      RGLRU, SLSTM, SWIGLU, BlockDef,
                                      FrontendConfig, MLAConfig, ModelConfig,
                                      MoEConfig, Stage, dense_stages)
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape


class _Registry:
    """Name -> config factory, filled by each architecture module."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable] = {}

    def register(self, name: str, factory: Callable) -> Callable:
        if name in self._items:
            raise KeyError(f"{self.kind} {name!r} already registered")
        self._items[name] = factory
        return factory

    def get(self, name: str) -> Callable:
        if name not in self._items:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}")
        return self._items[name]

    def names(self) -> list:
        return sorted(self._items)


ARCHS = _Registry("architecture")

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
