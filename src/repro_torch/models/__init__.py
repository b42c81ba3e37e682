from .api import Batch, Model, build_model
from .config import ModelConfig, ShapeConfig, SHAPES, cells_for, long_context_ok
from .blocks import BlockPlan, build_plan

__all__ = [
    "Batch", "BlockPlan", "Model", "ModelConfig", "SHAPES", "ShapeConfig",
    "build_model", "build_plan", "cells_for", "long_context_ok",
]
