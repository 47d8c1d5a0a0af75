"""Interest expressions (Definition 7) and their compilation to static plans.

The compile half and the pattern banks of ``repro.core.interest``, copied
(numpy only): an interest expression ``i_g = <τ, b, op>`` is compiled into a
``CompiledInterest`` holding dictionary-encoded pattern constants (numpy) and
a static query plan (root variable, child stars, edge patterns) that the
evaluator in :mod:`repro_torch.core.evaluation` closes over; the broker
deduplicates the patterns of many plans into one ``IncrementalPatternBank``.
Plans, lanes and banks are equal to the reference's field for field.

Supported BGP shape: connected patterns whose join graph is a tree of depth
<= 2 (one root variable + any number of child variables each linked to the
root by one or more edge patterns). Join variables in predicate position and
cyclic join graphs are rejected at compile time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dictionary import Dictionary
from .triples import WILDCARD

SLOT_NAMES = ("subject", "predicate", "object")


def is_var(term: str) -> bool:
    return term.startswith("?")


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    s: str
    p: str
    o: str

    def slots(self) -> Tuple[str, str, str]:
        return (self.s, self.p, self.o)


@dataclasses.dataclass(frozen=True)
class InterestExpr:
    """i_g = <source g, target τ, BGP b, OGP op> (Definition 7)."""

    source: str
    target: str
    bgp: Tuple[TriplePattern, ...]
    ogp: Tuple[TriplePattern, ...] = ()

    @staticmethod
    def parse(source: str, target: str, bgp: Sequence[Tuple[str, str, str]],
              ogp: Sequence[Tuple[str, str, str]] = ()) -> "InterestExpr":
        return InterestExpr(
            source=source,
            target=target,
            bgp=tuple(TriplePattern(*t) for t in bgp),
            ogp=tuple(TriplePattern(*t) for t in ogp),
        )


@dataclasses.dataclass(frozen=True)
class CompiledInterest:
    """Static evaluation plan for one interest expression.

    Pattern order: BGP patterns first, then OGP patterns. Per-pattern kind:
    ``root``  — anchored at the root variable (star pattern, incl. const-root)
    ``edge``  — links root variable to a child variable
    ``child`` — anchored at a child variable (subtree star)
    """

    patterns: np.ndarray  # (n_total, 3) int32; -1 where the slot is a variable
    n_bgp: int
    n_ogp: int
    kinds: Tuple[str, ...]
    anchor_slot: Tuple[int, ...]  # grouping slot (root-side slot for edges)
    child_slot: Tuple[int, ...]  # edge: slot of the child var; else -1
    child_var: Tuple[int, ...]  # edge/child patterns: child var index; else -1
    eq_pairs: Tuple[Optional[Tuple[int, int]], ...]  # repeated-var-in-pattern
    root_var: str
    child_vars: Tuple[str, ...]
    source: str
    target: str

    @property
    def n_total(self) -> int:
        return self.n_bgp + self.n_ogp

    @property
    def n_children(self) -> int:
        return len(self.child_vars)

    def bgp_ids(self) -> range:
        return range(self.n_bgp)

    def child_bgp_patterns(self, cvar: int) -> List[int]:
        return [
            j for j in range(self.n_bgp)
            if self.kinds[j] == "child" and self.child_var[j] == cvar
        ]

    def child_edges(self, cvar: int) -> List[int]:
        return [
            j for j in range(self.n_bgp)
            if self.kinds[j] == "edge" and self.child_var[j] == cvar
        ]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1): the rule capacities grow by."""
    return 1 << max(0, n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class PatternBank:
    """Consolidated triple-pattern bank shared by many compiled interests.

    Distinct (s, p, o) pattern rows across all registered interests are
    deduplicated into one bank; each plan keeps a static lane map from its
    local pattern index to the bank lane carrying that pattern's match bit.
    A pattern shared by K interests is evaluated once per changeset pass and
    its bit fanned out K ways (kernels.ops.lane_bits). Per-pattern
    constraints that are *not* functions of the raw (s, p, o) row alone —
    the repeated-variable ``eq_pairs`` masks — stay per-plan downstream, so
    dedup by row is exact.
    """

    patterns: np.ndarray  # (n_lanes, 3) int32; -1 where the slot is a variable
    lanes: Tuple[Tuple[int, ...], ...]  # per plan: local pattern j -> bank lane

    @property
    def n_lanes(self) -> int:
        return int(self.patterns.shape[0])

    @property
    def n_words(self) -> int:
        """uint32 bitset words needed to carry every lane (chunking unit)."""
        return max(1, -(-self.n_lanes // 32))


def build_pattern_bank(plans: Sequence[CompiledInterest]) -> PatternBank:
    """Dedup the patterns of many plans into one bank with lane maps."""
    table: Dict[Tuple[int, int, int], int] = {}
    rows: List[Tuple[int, int, int]] = []
    lanes: List[Tuple[int, ...]] = []
    for plan in plans:
        local: List[int] = []
        for j in range(plan.n_total):
            key = (
                int(plan.patterns[j, 0]),
                int(plan.patterns[j, 1]),
                int(plan.patterns[j, 2]),
            )
            if key not in table:
                table[key] = len(rows)
                rows.append(key)
            local.append(table[key])
        lanes.append(tuple(local))
    pat = np.asarray(rows, dtype=np.int32).reshape(len(rows), 3)
    return PatternBank(patterns=pat, lanes=tuple(lanes))


# A bank row that matches nothing: every slot is the PAD sentinel, which no
# dictionary-encoded triple can carry (ids are dense and < 2**31 - 1) and
# which the matchers additionally exclude via the valid-row mask. Used for
# tombstoned lanes and for padding the bank to a stable device shape.
_DEAD_ROW = (int(np.iinfo(np.int32).max),) * 3


class IncrementalPatternBank:
    """Mutable pattern bank with *stable* lane numbering under churn.

    :func:`build_pattern_bank` assigns lanes by rebuilding the whole table,
    so any subscription change renumbers every plan's lane map and — because
    lane maps and the bank array feed the broker's compiled cohort steps —
    invalidates executables that had nothing to do with the change. This
    class makes the bank an incremental structure instead:

    * ``add_plan`` dedups against the live table and extends the bank only
      with genuinely new rows; existing lanes are never renumbered.
    * ``remove_plan`` decrements per-lane refcounts; lanes that drop to zero
      are *tombstoned* (their row becomes the never-matching ``_DEAD_ROW``)
      rather than removed, so every other plan's lane map stays valid.
      Tombstoned lanes are reused first by later ``add_plan`` calls, which
      keeps re-subscription churn from growing the bank at all.
    * ``maybe_compact`` renumbers only when doing so would actually shrink
      the padded device bank shape (the padded-word boundary) — the caller
      applies the returned remap to all live lane maps. Tombstone *count*
      is irrelevant on its own: the bank array is padded to a power of two
      and executables key on that padded shape, so a compaction that lands
      in the same padded bucket would churn every live lane map (and every
      cached static-array signature) for zero executable-shape benefit.

    ``patterns_padded`` pads the lane count to a power of two (min 32, i.e.
    whole uint32 bitset words) so the bank's *device shape* — part of every
    cohort executable's input signature — changes only when the bank crosses
    a power-of-two boundary, not on every subscription.

    ``version`` increments whenever the padded array contents change; the
    broker uses it to refresh its device copy cheaply.
    """

    def __init__(self):
        self._table: Dict[Tuple[int, int, int], int] = {}
        self._rows: List[Optional[Tuple[int, int, int]]] = []
        self._refs: List[int] = []
        self._free: List[int] = []  # tombstoned lanes, reused LIFO
        self.version = 0

    @classmethod
    def restore(
        cls,
        rows: Sequence[Optional[Tuple[int, int, int]]],
        refs: Sequence[int],
        free: Sequence[int],
    ) -> "IncrementalPatternBank":
        """A bank in a given state: lane ``l`` holds ``rows[l]`` (None for a
        tombstone) with ``refs[l]`` references; ``free`` lists the
        tombstones in reuse order (the last is reused first)."""
        if len(rows) != len(refs) or sorted(free) != [l for l, r in enumerate(rows) if r is None]:
            raise ValueError("rows, refs and free do not describe one bank")
        bank = cls()
        bank._rows = [None if r is None else tuple(int(x) for x in r) for r in rows]
        bank._refs = [int(x) for x in refs]
        bank._free = [int(x) for x in free]
        bank._table = {row: lane for lane, row in enumerate(bank._rows) if row is not None}
        if len(bank._table) != len(rows) - len(free) or any(
            (r is None) != (c == 0) for r, c in zip(bank._rows, bank._refs)
        ):
            raise ValueError("live lanes must hold distinct rows with references")
        return bank

    @property
    def n_lanes(self) -> int:
        """Allocated lanes, including tombstones (what sets the padded shape)."""
        return len(self._rows)

    @property
    def n_live(self) -> int:
        return len(self._rows) - len(self._free)

    @property
    def n_words(self) -> int:
        return max(1, -(-len(self._rows) // 32))

    @property
    def n_lanes_padded(self) -> int:
        """Power-of-two (>= 32) lane count of :meth:`patterns_padded`."""
        return next_pow2(max(32, len(self._rows)))

    def acquire_row(self, key: Tuple[int, int, int]) -> int:
        """Refcount-acquire one pattern row, allocating a lane if new."""
        lane = self._table.get(key)
        if lane is None:
            if self._free:
                lane = self._free.pop()
                self._rows[lane] = key
                self._refs[lane] = 0
            else:
                lane = len(self._rows)
                self._rows.append(key)
                self._refs.append(0)
            self._table[key] = lane
            self.version += 1
        self._refs[lane] += 1
        return lane

    def retain_lane(self, lane: int) -> None:
        """Extra reference on an already-live lane (no key lookup)."""
        if self._rows[lane] is None:
            raise ValueError(f"lane {lane} is tombstoned")
        self._refs[lane] += 1

    def release_row(self, lane: int) -> None:
        """Drop one reference; tombstone the lane when it hits zero."""
        self._refs[lane] -= 1
        if self._refs[lane] == 0:
            del self._table[self._rows[lane]]
            self._rows[lane] = None
            self._free.append(lane)
            self.version += 1
        elif self._refs[lane] < 0:
            raise ValueError(f"lane {lane} released more than acquired")

    def lane_of(self, key: Tuple[int, int, int]) -> Optional[int]:
        return self._table.get(key)

    def row_of(self, lane: int) -> Optional[Tuple[int, int, int]]:
        return self._rows[lane]

    def live_lanes(self) -> List[int]:
        return sorted(self._table.values())

    def add_plan(self, plan: CompiledInterest) -> Tuple[int, ...]:
        """Register one plan's patterns; returns its (stable) lane map."""
        return tuple(
            self.acquire_row(
                (
                    int(plan.patterns[j, 0]),
                    int(plan.patterns[j, 1]),
                    int(plan.patterns[j, 2]),
                )
            )
            for j in range(plan.n_total)
        )

    def remove_plan(self, lanes: Sequence[int]) -> None:
        """Release one plan's lanes (symmetric with :meth:`add_plan`)."""
        for lane in lanes:
            self.release_row(lane)

    def maybe_compact(self, force: bool = False) -> Optional[Dict[int, int]]:
        """Renumber away tombstones when that shrinks the padded bank shape.

        Compaction is driven by the padded-word boundary, not the raw
        tombstone fraction: it runs exactly when the live lanes would pad
        to a strictly smaller power-of-two than the current allocation —
        i.e. when it can actually shrink the executables' padded bank-word
        input shapes (and therefore pays for invalidating lane maps).
        ``force=True`` compacts whenever any tombstone exists.

        Returns the ``{old lane: new lane}`` remap (the caller must rewrite
        every live plan's lane map), or None when no compaction happened.
        """
        if not self._free:
            return None
        if not force and (
            next_pow2(max(32, self.n_live)) >= self.n_lanes_padded
        ):
            return None
        remap: Dict[int, int] = {}
        rows: List[Optional[Tuple[int, int, int]]] = []
        refs: List[int] = []
        for lane, row in enumerate(self._rows):
            if row is None:
                continue
            remap[lane] = len(rows)
            rows.append(row)
            refs.append(self._refs[lane])
        self._rows, self._refs, self._free = rows, refs, []
        self._table = {row: lane for lane, row in enumerate(rows)}
        self.version += 1
        return remap

    def patterns_padded(self) -> np.ndarray:
        """int32[n_lanes_padded, 3] bank; tombstones/padding never match."""
        out = np.full((self.n_lanes_padded, 3), np.int32(_DEAD_ROW[0]), np.int32)
        for lane, row in enumerate(self._rows):
            if row is not None:
                out[lane] = row
        return out


class InterestCompileError(ValueError):
    pass


def _pattern_vars(p: TriplePattern) -> List[Tuple[str, int]]:
    return [(t, i) for i, t in enumerate(p.slots()) if is_var(t)]


def compile_interest(expr: InterestExpr, dictionary: Dictionary) -> CompiledInterest:
    all_patterns = list(expr.bgp) + list(expr.ogp)
    n_bgp, n_ogp = len(expr.bgp), len(expr.ogp)
    if n_bgp == 0:
        raise InterestCompileError("BGP must contain at least one triple pattern")
    if n_bgp + n_ogp > 32:
        raise InterestCompileError("at most 32 triple patterns per interest")

    # variable occurrence census over BGP + OGP
    occ: Dict[str, List[Tuple[int, int]]] = {}
    for j, p in enumerate(all_patterns):
        for v, slot in _pattern_vars(p):
            occ.setdefault(v, []).append((j, slot))

    join_vars = {v for v, sites in occ.items() if len(sites) >= 2}
    for v in join_vars:
        for j, slot in occ[v]:
            if slot == 1:
                raise InterestCompileError(
                    f"join variable {v} in predicate position of pattern {j} "
                    "is unsupported"
                )

    # connectivity of the BGP via shared variables (Definition 3)
    if n_bgp > 1:
        adj = {i: set() for i in range(n_bgp)}
        for v, sites in occ.items():
            bgp_sites = [j for j, _ in sites if j < n_bgp]
            for a in bgp_sites:
                for b in bgp_sites:
                    if a != b:
                        adj[a].add(b)
        seen = {0}
        stack = [0]
        while stack:
            for nb in adj[stack.pop()]:
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        if len(seen) != n_bgp:
            raise InterestCompileError("BGP is disjoint (Definition 3 violated)")

    # root selection: most-connected join variable in the BGP
    def bgp_degree(v: str) -> int:
        return sum(1 for j, _ in occ[v] if j < n_bgp)

    if join_vars:
        root = max(sorted(join_vars), key=bgp_degree)
    else:
        # single-pattern (or variable-free) BGP: group by the subject slot
        root = expr.bgp[0].s if is_var(expr.bgp[0].s) else ""

    kinds: List[str] = []
    anchor_slot: List[int] = []
    child_slot: List[int] = []
    child_var_of: List[int] = []
    eq_pairs: List[Optional[Tuple[int, int]]] = []
    child_vars: List[str] = []

    def child_index(v: str) -> int:
        if v not in child_vars:
            child_vars.append(v)
        return child_vars.index(v)

    for j, p in enumerate(all_patterns):
        pvars = _pattern_vars(p)
        jvars = [(v, slot) for v, slot in pvars if v in join_vars]
        pv_names = [v for v, _ in pvars]
        eq: Optional[Tuple[int, int]] = None
        for v in set(pv_names):
            sites = [slot for name, slot in pvars if name == v]
            if len(sites) == 2:
                eq = (sites[0], sites[1])
            elif len(sites) > 2:
                raise InterestCompileError("variable repeated 3x in one pattern")
        eq_pairs.append(eq)

        root_sites = [slot for v, slot in jvars if v == root]
        other = [(v, slot) for v, slot in jvars if v != root]
        if root_sites and other:
            if len(other) > 1:
                raise InterestCompileError(
                    f"pattern {j} links three join variables (not a tree)"
                )
            cv, cslot = other[0]
            kinds.append("edge")
            anchor_slot.append(root_sites[0])
            child_slot.append(cslot)
            child_var_of.append(child_index(cv))
        elif root_sites:
            kinds.append("root")
            anchor_slot.append(root_sites[0])
            child_slot.append(-1)
            child_var_of.append(-1)
        elif other:
            if len({v for v, _ in other}) > 1:
                raise InterestCompileError(
                    f"pattern {j} joins two non-root variables: query tree "
                    "depth > 2 is unsupported"
                )
            cv, cslot = other[0]
            kinds.append("child")
            anchor_slot.append(cslot)
            child_slot.append(-1)
            child_var_of.append(child_index(cv))
        else:
            # no join variable: only legal for a single-pattern BGP or
            # OGP patterns anchored at the (constant) root subject
            if root == "" or (j >= n_bgp and not join_vars) or n_bgp == 1:
                kinds.append("root")
                anchor_slot.append(0)
                child_slot.append(-1)
                child_var_of.append(-1)
            else:
                raise InterestCompileError(
                    f"pattern {j} shares no join variable with the BGP root"
                )

    # every child variable must carry at least one edge to the root
    for ci, cv in enumerate(child_vars):
        edges = [j for j in range(len(all_patterns))
                 if kinds[j] == "edge" and child_var_of[j] == ci]
        if not edges:
            raise InterestCompileError(
                f"child variable {cv} is not linked to root {root}"
            )

    # encode constants
    pat = np.full((len(all_patterns), 3), WILDCARD, dtype=np.int32)
    for j, p in enumerate(all_patterns):
        for k, term in enumerate(p.slots()):
            if not is_var(term):
                pat[j, k] = dictionary.encode_term(term)

    return CompiledInterest(
        patterns=pat,
        n_bgp=n_bgp,
        n_ogp=n_ogp,
        kinds=tuple(kinds),
        anchor_slot=tuple(anchor_slot),
        child_slot=tuple(child_slot),
        child_var=tuple(child_var_of),
        eq_pairs=tuple(eq_pairs),
        root_var=root,
        child_vars=tuple(child_vars),
        source=expr.source,
        target=expr.target,
    )
