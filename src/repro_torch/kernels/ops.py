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

from . import lane_refine as lane_refine_kernel
from . import merge_join, ref, triple_match, triple_match_lanes, triple_match_words, triple_match_words_segmented


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


def pattern_bitmask_words(spo: torch.Tensor, patterns: torch.Tensor, *, matcher=None) -> torch.Tensor:
    """int32[N, W] bank bitset over an arbitrary-size pattern bank,
    ``W = max(1, ceil(P / 32))``: word ``w`` holds the match bits of
    ``patterns[32w : 32w + 32]``, all W words from one pass over ``spo``.

    ``matcher`` (optional, the :func:`pattern_bitmask` signature) is the
    broker's testing hook: with it the bank is matched in one ``matcher``
    pass per 32-lane word.
    """
    if matcher is not None:
        n_words = max(1, -(-patterns.shape[0] // 32))
        words = []
        for w in range(n_words):
            chunk = patterns[w * 32: (w + 1) * 32]
            if chunk.shape[0] == 0:
                words.append(torch.zeros(spo.shape[0], dtype=torch.int32, device=spo.device))
            else:
                words.append(matcher(spo, chunk))
        return torch.stack(words, dim=1)
    if _on_card(spo):
        return triple_match_words.triple_match_words_cuda(spo, patterns)
    return ref.pattern_bitmask_words_ref(spo, patterns)


def pattern_bitmask_words_segmented(
    spo: torch.Tensor, patterns: torch.Tensor, seg: torch.Tensor, n_seg: int, *, matcher=None
) -> torch.Tensor:
    """int32[n_seg, N, W] segment-masked bank bitsets from one match pass.

    ``seg``: int32[N] membership bitmap, bit ``f`` set iff row ``i`` belongs
    to segment ``f`` (bits at or above ``n_seg`` ignored, ``1 <= n_seg <=
    32``). Plane ``f`` holds :func:`pattern_bitmask_words` for the rows of
    segment ``f`` and 0 for the others: the delta frontier chain's deleted
    side, each distinct row of several frontiers matched once.

    With a custom ``matcher`` the words come from the chunked
    :func:`pattern_bitmask_words` pass and are masked after it, so the hook
    sees one pass per 32-lane word, never one per segment.
    """
    if matcher is not None:
        return ref.segment_planes(pattern_bitmask_words(spo, patterns, matcher=matcher), seg, n_seg)
    if _on_card(spo):
        return triple_match_words_segmented.triple_match_words_segmented_cuda(spo, patterns, seg, n_seg)
    return ref.pattern_bitmask_words_segmented_ref(spo, patterns, seg, n_seg)


def lane_refine(
    spo: torch.Tensor, words: torch.Tensor, parents: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """int32[..., N, Wv] virtual-lane words of the subsumption lattice.

    Virtual slot ``v`` holds a pattern strictly contained by real bank lane
    ``parents[v]`` (the child is the parent AND ``residual[v]``); its bit is
    the parent lane's bit in ``words`` (int32[..., N, W], the real-bank words
    of ``spo``) AND the residual compare, the same bits the words pass would
    give for the child patterns. ``parents[v] == -1`` is a dead slot.
    ``words`` may carry a leading plane axis; ``spo`` is then one row set
    shared by every plane (int32[N, 3]) or one a plane (int32[F, N, 3]), and
    all planes take one launch on the card.
    """
    if _on_card(words):
        return lane_refine_kernel.lane_refine_cuda(spo, words, parents, residual)
    return ref.lane_refine_ref(spo, words, parents, residual)


def pattern_lane_bits_batched(
    spo_b: torch.Tensor,
    patterns: torch.Tensor,
    lanes: torch.Tensor,
    active: torch.Tensor | None = None,
    *,
    matcher=None,
) -> torch.Tensor:
    """int32[R, N] bank match + lane routing for a member-stacked cohort:
    member ``k``'s local pattern ``j`` reads bank lane ``lanes[k, j]`` over
    its own rows ``spo_b[k]``; inactive (padding) members give 0.

    With a custom ``matcher`` the composed path runs instead (bank words per
    member through :func:`pattern_bitmask_words`, then
    :func:`lane_bits_batched`), so the hook sees every bank pass.
    """
    if matcher is not None:
        words = torch.stack([pattern_bitmask_words(s, patterns, matcher=matcher) for s in spo_b])
        return lane_bits_batched(words, lanes, active=active)
    if _on_card(spo_b):
        if active is None:
            active = torch.ones(spo_b.shape[0], dtype=torch.int32, device=spo_b.device)
        return triple_match_lanes.triple_match_lanes_cuda(spo_b, patterns, lanes, active)
    return ref.pattern_lane_bits_ref(spo_b, patterns, lanes, active)


def lane_bits(words: torch.Tensor, lanes) -> torch.Tensor:
    """int32[N] bitset in one plan's local numbering: bit ``j`` is bank lane
    ``lanes[j]`` of ``words`` (int32[N, W]), i.e. what ``pattern_bitmask``
    gives for the plan's own patterns. Plain PyTorch on every device."""
    acc = torch.zeros(words.shape[0], dtype=torch.int32, device=words.device)
    for j, lane in enumerate(lanes):
        lane = int(lane)
        acc = ref.or_bit(acc, ((words[:, lane // 32] >> (lane % 32)) & 1) == 1, j)
    return acc


def lane_bits_batched(
    words: torch.Tensor,
    lanes_arr: torch.Tensor,
    active: torch.Tensor | None = None,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """int32[R, N] lane routing for a cohort: member ``k``'s bit ``j`` is bank
    lane ``lanes_arr[k, j]`` of ``words[k]`` (int32[R, N, W]); members with
    ``active`` False (cohort padding) give 0. ``row_mask`` (bool[R, N]), the
    sharded broker's row ownership, zeroes the bits of the rows a shard does
    not own, so they yield no candidates, signatures or outputs there.
    Plain PyTorch on every device."""
    r, n, _ = words.shape
    lanes = lanes_arr.to(words.device).long()
    acc = torch.zeros((r, n), dtype=torch.int32, device=words.device)
    for j in range(lanes.shape[1]):
        w = torch.gather(words, 2, (lanes[:, j] // 32)[:, None, None].expand(r, n, 1))[..., 0]
        acc = ref.or_bit(acc, ((w >> (lanes[:, j] % 32).to(torch.int32)[:, None]) & 1) == 1, j)
    if active is not None:
        acc = torch.where(active.to(words.device, torch.bool)[:, None], acc, torch.zeros_like(acc))
    if row_mask is not None:
        acc = torch.where(row_mask.to(words.device, torch.bool), acc, torch.zeros_like(acc))
    return acc


def merge_probe(
    store: torch.Tensor, queries: torch.Tensor, side: str = "left", hi_queries: torch.Tensor | None = None
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Probe each query row in a lex-sorted store, in query order.

    ``side="left"``: (idx, found), the searchsorted-left position and
    whether the store row there equals the query (bool). ``"right"``: (idx,
    None), the searchsorted-right position. ``"range"``: (start, end), the
    left position of each ``queries`` row and the right position of the
    ``hi_queries`` row beside it, in one launch on the card.
    """
    if side not in ("left", "right", "range"):
        raise ValueError(f"side must be 'left', 'right' or 'range', got {side!r}")
    if (side == "range") != (hi_queries is not None):
        raise ValueError("hi_queries is given with side='range' and only then")
    if _on_card(queries):
        if side == "range":
            return merge_join.merge_probe_range_cuda(store, queries, hi_queries)
        return merge_join.merge_probe_cuda(store, queries, side)
    if side == "left":
        return ref.merge_probe_ref(store, queries)
    if side == "right":
        return ref.merge_probe_right_ref(store, queries), None
    return ref.merge_probe_range_ref(store, queries, hi_queries)
