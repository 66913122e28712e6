"""Architecture configs (the port's copy of ``repro.configs``)."""

from .base import SHAPES, ModelConfig, MoECfg, SSMCfg, ShapeCfg
from .registry import ARCHS, LONG_CONTEXT_OK, SKIPPED_CELLS, all_cells, get_arch, get_shape

__all__ = [
    "ARCHS", "LONG_CONTEXT_OK", "SHAPES", "SKIPPED_CELLS", "ModelConfig",
    "MoECfg", "SSMCfg", "ShapeCfg", "all_cells", "get_arch", "get_shape",
]
