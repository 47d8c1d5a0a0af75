"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

They define what each kernel computes. The ops layer runs them for tensors
on the CPU; the tests hold them against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

Bitsets are ``int32`` words carrying the bits of ``uint32`` (torch on the CPU
has no shifts or comparisons for ``uint32``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PAD = int(np.iinfo(np.int32).max)
WILDCARD = -1


def bit_word(j: int) -> int:
    """The int32 value whose two's-complement bits are ``1 << j`` (j < 32)."""
    return (1 << j) - (1 << 32) if j == 31 else 1 << j


def pattern_bitmask_ref(spo: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """int32[N] bitset: bit j set iff row i matches ``patterns[j]``.

    ``patterns``: int32[P <= 32, 3] with -1 as wildcard. PAD rows match nothing.
    """
    pats = patterns.cpu().tolist()
    if len(pats) > 32:
        raise ValueError("at most 32 patterns per bitset")
    valid = spo[:, 0] != PAD
    acc = torch.zeros(spo.shape[0], dtype=torch.int32, device=spo.device)
    for j, pat in enumerate(pats):
        m = valid
        for k in range(3):
            if pat[k] != WILDCARD:
                m = m & (spo[:, k] == pat[k])
        acc = torch.where(m, acc | bit_word(j), acc)
    return acc


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s_lt = a[..., 0] < b[..., 0]
    s_eq = a[..., 0] == b[..., 0]
    p_lt = a[..., 1] < b[..., 1]
    p_eq = a[..., 1] == b[..., 1]
    o_lt = a[..., 2] < b[..., 2]
    return s_lt | (s_eq & (p_lt | (p_eq & o_lt)))


def _search(store: torch.Tensor, queries: torch.Tensor, side: str) -> torch.Tensor:
    """Vectorised lexicographic binary search (``triples.searchsorted_rows``)."""
    c = store.shape[0]
    q = queries.shape[0]
    lo = torch.zeros(q, dtype=torch.int64, device=queries.device)
    hi = torch.full((q,), c, dtype=torch.int64, device=queries.device)
    if c == 0:
        return lo.to(torch.int32)
    iters = max(1, int(np.ceil(np.log2(c + 1))) + 1)
    for _ in range(iters):
        mid = (lo + hi) // 2
        row = store[torch.clamp(mid, max=c - 1)]
        if side == "left":
            go_right = _lex_less(row, queries)
        else:
            go_right = ~_lex_less(queries, row)
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def merge_probe_ref(store: torch.Tensor, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic searchsorted-left + membership of queries in a sorted store.

    Returns (idx int32[Q], found bool[Q]). ``store``: int32[S, 3] lex-sorted
    with PAD tail; ``queries``: int32[Q, 3] (any order). As in the reference
    oracle, a PAD query is "found" when the store has a PAD row.
    """
    idx = _search(store, queries, "left")
    c = store.shape[0]
    if c == 0:
        return idx, torch.zeros(queries.shape[0], dtype=torch.bool, device=queries.device)
    rows = store[torch.clamp(idx, max=c - 1).long()]
    found = (idx < c) & torch.all(rows == queries, dim=-1)
    return idx, found


def merge_probe_right_ref(store: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """int32[Q] lexicographic searchsorted-right (the upper bound of ``prefix_range``)."""
    return _search(store, queries, "right")
