"""Runtime on PyTorch: the fault-tolerant training loop, straggler
detection and failure injection (the counterpart of ``repro.runtime``)."""
from .trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
