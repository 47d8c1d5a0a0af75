"""The port's kernels: hand-written CUDA for Hopper, with plain PyTorch versions.

``ops`` is the entry point (kernel for CUDA tensors, plain version for CPU
tensors); ``ref`` holds the plain versions; ``triple_match`` and
``merge_join`` wrap the CUDA sources in ``csrc/``, built by ``build``.
"""
from typing import Dict

from . import merge_join, ops, ref, triple_match

_COUNTED = {"triple_match": triple_match, "merge_probe": merge_join}


def launch_counts() -> Dict[str, int]:
    """Kernel launches of this process, by kernel name."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0


__all__ = ["launch_counts", "merge_join", "ops", "ref", "reset_launch_counts", "triple_match"]
