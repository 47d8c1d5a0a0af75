"""Model substrate on PyTorch: configs, layers, the attention families'
assemblies (``Model`` takes the place of the reference's ``ModelApi``)."""
from .config import LONG_CTX_ARCHS, SHAPES, ModelConfig, ShapeCell, cells_for, torch_dtype
from .model import Model, build_model

__all__ = [
    "LONG_CTX_ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeCell",
    "cells_for",
    "torch_dtype",
    "Model",
    "build_model",
]
