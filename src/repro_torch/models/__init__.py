from .config import (ALL_SHAPES, ATTN, ATTN_LOCAL, MLSTM, RGLRU, SLSTM,
                     SHAPES_BY_NAME, ModelConfig, ShapeConfig)
from .transformer import cast_params, forward, init_params

__all__ = ["ALL_SHAPES", "ATTN", "ATTN_LOCAL", "MLSTM", "RGLRU", "SLSTM",
           "SHAPES_BY_NAME", "ModelConfig", "ShapeConfig", "cast_params",
           "forward", "init_params"]
