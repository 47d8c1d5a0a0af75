"""Columnar, fixed-capacity RDF triple-set algebra (port of ``repro.core.triples``).

A triple store is a lexicographically sorted ``int32[C, 3]`` tensor (subject,
predicate, object ids) padded at the tail with ``PAD`` rows, plus a
valid-count scalar tensor. Every operation keeps its output shape fixed by
the capacities it is given and reports overflow through a flag tensor, so
the host loop decides when to grow a store; nothing here syncs with the
device.

Functions never write into a tensor they were given: JAX arrays were
immutable, and stores are shared (an output of one changeset is the input of
the next). Lexicographic searches go through the probe kernel
(:func:`repro_torch.kernels.ops.merge_probe`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels import ops as kops

PAD = int(np.iinfo(np.int32).max)
WILDCARD = -1
INT32_MIN = int(np.iinfo(np.int32).min)


@dataclasses.dataclass(frozen=True)
class TripleStore:
    """A sorted, deduplicated, fixed-capacity set of RDF triples."""

    spo: torch.Tensor  # int32[C, 3], lex-sorted, PAD rows at the tail
    n: torch.Tensor  # int32[] number of valid rows

    @property
    def capacity(self) -> int:
        return self.spo.shape[0]

    @property
    def device(self) -> torch.device:
        return self.spo.device

    def valid_mask(self) -> torch.Tensor:
        return self.spo[:, 0] != PAD


def pad_rows(n: int, device) -> torch.Tensor:
    return torch.full((n, 3), PAD, dtype=torch.int32, device=device)


def empty(capacity: int, device) -> TripleStore:
    return TripleStore(
        spo=pad_rows(capacity, device),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# lexicographic helpers
# ---------------------------------------------------------------------------

def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise (s, p, o) < comparison; broadcasts over leading dims."""
    s_lt = a[..., 0] < b[..., 0]
    s_eq = a[..., 0] == b[..., 0]
    p_lt = a[..., 1] < b[..., 1]
    p_eq = a[..., 1] == b[..., 1]
    o_lt = a[..., 2] < b[..., 2]
    return s_lt | (s_eq & (p_lt | (p_eq & o_lt)))


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def lex_sort(spo: torch.Tensor) -> torch.Tensor:
    """Return ``spo`` sorted lexicographically by (s, p, o).

    torch has no ``lexsort``: three stable sorts, least significant column
    first, give the same order.
    """
    perm = torch.argsort(spo[:, 2], stable=True)
    for k in (1, 0):
        perm = perm[torch.argsort(spo[perm, k], stable=True)]
    return spo[perm]


def _dedup_sorted_mask(spo: torch.Tensor) -> torch.Tensor:
    """Keep-mask for the first occurrence of each row in a sorted array."""
    first = torch.ones(spo.shape[0], dtype=torch.bool, device=spo.device)
    first[1:] = ~rows_equal(spo[1:], spo[:-1])
    return first & (spo[:, 0] != PAD)


def compact(spo: torch.Tensor, keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition kept rows to the front; pad the rest. Returns (rows, count)."""
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    rows = spo[order]
    count = keep.sum(dtype=torch.int32)
    idx = torch.arange(spo.shape[0], dtype=torch.int32, device=spo.device)
    rows = torch.where((idx < count)[:, None], rows, PAD)
    return rows, count


def _fit(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pad with PAD rows or cut to exactly ``capacity`` rows."""
    c = rows.shape[0]
    if c < capacity:
        return torch.cat([rows, pad_rows(capacity - c, rows.device)], dim=0)
    return rows[:capacity]


def from_array(spo: torch.Tensor, capacity: int) -> Tuple[TripleStore, torch.Tensor]:
    """Build a store from an unsorted (possibly duplicated) triple tensor.

    Returns (store, overflowed): ``overflowed`` is True when the distinct
    triples exceed ``capacity`` (the store then holds the first ``capacity``).
    """
    if spo.ndim != 2 or spo.shape[1] != 3:
        raise ValueError(f"expected (N, 3) triples, got {tuple(spo.shape)}")
    spo = spo.to(torch.int32)
    srt = lex_sort(spo)
    rows, count = compact(srt, _dedup_sorted_mask(srt))
    store = TripleStore(spo=_fit(rows, capacity), n=torch.clamp(count, max=capacity))
    return store, count > capacity


def from_numpy(triples: np.ndarray, capacity: int, device) -> TripleStore:
    store, overflow = from_array(
        torch.as_tensor(np.asarray(triples, np.int32).reshape(-1, 3), device=device),
        capacity,
    )
    if bool(overflow):
        raise ValueError(
            f"{triples.shape[0]} distinct triples exceed capacity {capacity}"
        )
    return store


# ---------------------------------------------------------------------------
# binary search over sorted rows
# ---------------------------------------------------------------------------

def searchsorted_rows(sorted_spo: torch.Tensor, queries: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Vectorized lexicographic searchsorted. ``queries``: int32[Q, 3]."""
    idx, _ = kops.merge_probe(sorted_spo, queries, side=side)
    return idx


def member(store: TripleStore, queries: torch.Tensor) -> torch.Tensor:
    """Boolean membership of each query row in the store."""
    _, found = kops.merge_probe(store.spo, queries, side="left")
    return found


def prefix_range(store: TripleStore, prefix: torch.Tensor, depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[start, end) of rows matching the first ``depth`` columns of ``prefix``.

    ``prefix``: int32[Q, 3] (columns past ``depth`` ignored); ``depth``:
    int32[Q] in {1, 2, 3}. Works on any store sorted in the column order the
    prefix refers to. Both bounds come from one probe (one launch on the card).
    """
    col = torch.arange(3, dtype=torch.int32, device=prefix.device)[None, :]
    inside = col < depth[:, None]
    lo_q = torch.where(inside, prefix, INT32_MIN).to(torch.int32)
    hi_q = torch.where(inside, prefix, PAD).to(torch.int32)
    return kops.merge_probe(store.spo, lo_q, side="range", hi_queries=hi_q)


# ---------------------------------------------------------------------------
# set algebra
# ---------------------------------------------------------------------------

def difference(a: TripleStore, b: TripleStore) -> TripleStore:
    """a \\ b, keeping a's capacity."""
    keep = a.valid_mask() & ~member(b, a.spo)
    rows, count = compact(a.spo, keep)
    return TripleStore(spo=rows, n=count)


def intersection(a: TripleStore, b: TripleStore) -> TripleStore:
    keep = a.valid_mask() & member(b, a.spo)
    rows, count = compact(a.spo, keep)
    return TripleStore(spo=rows, n=count)


def union(a: TripleStore, b: TripleStore, capacity: int | None = None) -> Tuple[TripleStore, torch.Tensor]:
    """a ∪ b with the given output capacity (defaults to a's). Returns (store, overflowed)."""
    capacity = a.capacity if capacity is None else capacity
    return from_array(torch.cat([a.spo, b.spo], dim=0), capacity)


def apply_changeset(store: TripleStore, removed: TripleStore, added: TripleStore) -> Tuple[TripleStore, torch.Tensor]:
    """υ(V, Δ) = (V \\ D) ∪ A  — Definition 6 (delete-first ordering)."""
    return union(difference(store, removed), added, store.capacity)


def rehome(store: TripleStore, capacity: int) -> TripleStore:
    """Move a store to a new capacity without re-sorting.

    Valid rows are already lex-sorted at the front with a PAD tail, so
    growing pads more PAD rows and shrinking slices the front. Shrinking
    requires ``store.n <= capacity``.
    """
    if store.capacity == capacity:
        return store
    return TripleStore(spo=_fit(store.spo, capacity), n=store.n)


def to_numpy(store: TripleStore) -> np.ndarray:
    spo = store.spo.cpu().numpy()
    return spo[spo[:, 0] != PAD]


def to_set(store: TripleStore) -> set:
    return {tuple(int(x) for x in row) for row in to_numpy(store)}
