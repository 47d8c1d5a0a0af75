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


def or_bit(acc: torch.Tensor, cond: torch.Tensor, j: int) -> torch.Tensor:
    """``acc | (cond << j)`` on int32 words (bit 31 included)."""
    return torch.where(cond, acc | bit_word(j), acc)


def pattern_bitmask_words_ref(spo: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """int32[N, W] bank bitset, ``W = ceil(P / 32)`` (min 1): word ``w``
    carries the match bits of ``patterns[32w : 32w + 32]``.

    Plain version of the words kernel (``triple_match_words_cuda``): one
    :func:`pattern_bitmask_ref` pass per 32-pattern chunk.
    """
    n_words = max(1, -(-patterns.shape[0] // 32))
    return torch.stack(
        [pattern_bitmask_ref(spo, patterns[32 * w: 32 * w + 32]) for w in range(n_words)], dim=1
    )


def pattern_bitmask_words_segmented_ref(
    spo: torch.Tensor, patterns: torch.Tensor, seg: torch.Tensor, n_seg: int
) -> torch.Tensor:
    """int32[n_seg, N, W] segment-masked bank bitset.

    ``seg``: int32[N] membership bitmap, bit ``f`` set iff row ``i`` belongs
    to segment ``f`` (bits at or above ``n_seg`` ignored, ``1 <= n_seg <=
    32``). Plane ``f`` is :func:`pattern_bitmask_words_ref` with the rows
    outside segment ``f`` zeroed: the match runs once, the planes are masks.
    Plain version of the segmented words kernel
    (``triple_match_words_segmented_cuda``).
    """
    return segment_planes(pattern_bitmask_words_ref(spo, patterns), seg, n_seg)


def segment_planes(words: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """int32[n_seg, N, W]: plane ``f`` is ``words`` (int32[N, W]) with the
    rows whose ``seg`` bit ``f`` is clear zeroed (``1 <= n_seg <= 32``)."""
    if not 1 <= n_seg <= 32:
        raise ValueError(f"n_seg must be in [1, 32], got {n_seg}")
    shifts = torch.arange(n_seg, dtype=torch.int32, device=words.device)
    member = ((seg.to(words.device)[None, :] >> shifts[:, None]) & 1) == 1
    return torch.where(member[:, :, None], words[None], torch.zeros_like(words[None]))


def lane_refine_ref(
    spo: torch.Tensor, words: torch.Tensor, parents: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """int32[..., N, Wv] virtual-lane words refined from real-bank words.

    ``words``: int32[..., N, W] real-bank words (a leading axis holds
    planes); ``spo``: the rows, int32[N, 3] shared by every plane or
    int32[..., N, 3] one set a plane; ``parents``: int32[Vp], the parent bank
    lane of each virtual slot; ``residual``: int32[Vp, 3], the child's
    constants in the slots its parent leaves variable (-1 elsewhere). Bit
    ``v % 32`` of word ``v // 32`` is the parent lane's bit AND the residual
    compare; a parent of -1, or one outside the words' ``32 W`` lanes, is a
    dead slot (0). ``Wv = max(1, ceil(Vp / 32))``. Plain version of the
    lane-refine kernel (``lane_refine_cuda``).
    """
    vp = parents.shape[0]
    n_bits = 32 * words.shape[-1]
    out = torch.zeros((*words.shape[:-1], max(1, -(-vp // 32))), dtype=torch.int32, device=words.device)
    pars = parents.cpu().tolist()
    res = residual.cpu().tolist()
    spo = spo.to(words.device)
    for v, par in enumerate(pars):
        if not 0 <= par < n_bits:
            continue
        m = ((words[..., par // 32] >> (par % 32)) & 1) == 1
        for k in range(3):
            if res[v][k] != WILDCARD:
                m = m & (spo[..., k] == res[v][k])
        out[..., v // 32] = or_bit(out[..., v // 32], m, v % 32)
    return out


def pattern_lane_bits_ref(
    spo_b: torch.Tensor,
    patterns: torch.Tensor,
    lanes: torch.Tensor,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """int32[R, N] bank match + lane routing + member mask.

    ``spo_b``: int32[R, N, 3] member-stacked rows; ``patterns``: the bank,
    int32[32W, 3]; ``lanes``: int32[R, nt]; ``active`` (optional): bool[R].
    Member k's local bit ``j`` is the match bit of bank row ``lanes[k, j]``
    over ``spo_b[k]`` (a lane past the bank's rows matches nothing);
    inactive members give 0. Plain version of the lanes kernel
    (``triple_match_lanes_cuda``). Lane ``L``'s bank bit is exactly the
    match against bank row ``L``, so only the routed rows are compared.
    """
    r, n, _ = spo_b.shape
    dev = spo_b.device
    lanes = lanes.to(dev).long()
    n_pat = patterns.shape[0]
    inside = (lanes >= 0) & (lanes < n_pat)
    pats = patterns.to(dev)[lanes.clamp(0, max(n_pat - 1, 0))] if n_pat else torch.zeros(
        (r, lanes.shape[1], 3), dtype=torch.int32, device=dev)
    valid = spo_b[..., 0] != PAD
    if active is not None:
        valid = valid & active.to(dev, torch.bool)[:, None]
    acc = torch.zeros((r, n), dtype=torch.int32, device=dev)
    for j in range(lanes.shape[1]):
        m = valid & inside[:, j, None]
        for k in range(3):
            pk = pats[:, j, k, None]
            m = m & ((pk == WILDCARD) | (spo_b[..., k] == pk))
        acc = or_bit(acc, m, j)
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


def merge_probe_range_ref(
    store: torch.Tensor, lo_queries: torch.Tensor, hi_queries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end), int32[Q] each: searchsorted-left of ``lo_queries`` and
    searchsorted-right of ``hi_queries`` (``prefix_range``'s bounds)."""
    return _search(store, lo_queries, "left"), _search(store, hi_queries, "right")
