"""Model substrate on PyTorch: configs, layers, the state-space blocks
(``ssm``) and every family's assembly (``Model`` takes the place of the
reference's ``ModelApi``)."""
from . import ssm
from .config import LONG_CTX_ARCHS, SHAPES, ModelConfig, ShapeCell, cells_for, torch_dtype
from .model import Hybrid, Model, Ssm, build_model

__all__ = [
    "LONG_CTX_ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeCell",
    "cells_for",
    "torch_dtype",
    "Model",
    "Ssm",
    "Hybrid",
    "ssm",
    "build_model",
]
