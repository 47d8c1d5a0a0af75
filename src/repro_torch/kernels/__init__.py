"""The port's kernels: hand-written CUDA for Hopper, with plain PyTorch versions.

``ops`` is the entry point (kernel for CUDA tensors, plain version for CPU
tensors); ``ref`` holds the plain versions; ``triple_match`` (K1),
``merge_join`` (K2/K3), ``triple_match_words`` (K4),
``triple_match_lanes`` (K5), ``triple_match_words_segmented`` (K6) and
``lane_refine`` (K7) wrap the CUDA sources in ``csrc/``, built by ``build``.
"""
from typing import Dict

from . import (
    lane_refine,
    merge_join,
    ops,
    ref,
    triple_match,
    triple_match_lanes,
    triple_match_words,
    triple_match_words_segmented,
)

_COUNTED = {
    "triple_match": triple_match,
    "merge_probe": merge_join,
    "triple_match_words": triple_match_words,
    "triple_match_lanes": triple_match_lanes,
    "triple_match_words_segmented": triple_match_words_segmented,
    "lane_refine": lane_refine,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches of this process, by kernel name."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0


__all__ = [
    "lane_refine", "launch_counts", "merge_join", "ops", "ref", "reset_launch_counts", "triple_match",
    "triple_match_lanes", "triple_match_words", "triple_match_words_segmented",
]
