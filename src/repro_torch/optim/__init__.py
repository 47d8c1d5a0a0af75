"""Optimizer substrate on PyTorch: AdamW, schedules, gradient compression
(the counterpart of ``repro.optim``)."""
from .adamw import AdamW, clip_by_global_norm
from .schedule import constant, cosine_warmup

__all__ = ["AdamW", "clip_by_global_norm", "constant", "cosine_warmup"]
