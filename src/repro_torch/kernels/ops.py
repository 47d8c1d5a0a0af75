"""Entry points of the port's kernels: the kernel on the card, the plain version on the CPU.

The choice follows the device of the tensors given (the reference chose by
backend, ``_on_tpu()``). A CUDA tensor always goes to the CUDA kernel, which
runs or raises; a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. Any other device is refused. Unlike the
reference there is no padding to 4096-row tiles and no host-side skew check.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import merge_join, ref, triple_match


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def pattern_bitmask(spo: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """int32[N] bitset of pattern matches per triple row (uint32 bits)."""
    if _on_card(spo):
        return triple_match.triple_match_cuda(spo, patterns)
    return ref.pattern_bitmask_ref(spo, patterns)


def merge_probe(
    store: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """(idx, found) of each query row in a lex-sorted store, in query order.

    ``idx`` is the searchsorted position on ``side``; ``found`` (bool, left
    side only, else None) marks rows equal to the store row at ``idx``.
    """
    if _on_card(queries):
        return merge_join.merge_probe_cuda(store, queries, side)
    if side == "left":
        return ref.merge_probe_ref(store, queries)
    if side == "right":
        return ref.merge_probe_right_ref(store, queries), None
    raise ValueError(f"side must be 'left' or 'right', got {side!r}")
