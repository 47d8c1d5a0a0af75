"""Interest expressions (Definition 7) and their compilation to static plans.

The compile half, the canonical form and the pattern banks of
``repro.core.interest``, copied (numpy only): an interest expression
``i_g = <τ, b, op>`` is compiled into a ``CompiledInterest`` holding
dictionary-encoded pattern constants (numpy) and a static query plan (root
variable, child stars, edge patterns) that the evaluator in
:mod:`repro_torch.core.evaluation` closes over; the broker canonicalizes
expressions (:func:`canonicalize_expr`) and deduplicates the patterns of many
plans into one ``IncrementalPatternBank``, or a ``SubsumptionBank`` whose
contained patterns ride virtual lanes. Plans, keys, lanes and banks are equal
to the reference's field for field.

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


def canonicalize_expr(expr: InterestExpr) -> Tuple[InterestExpr, tuple]:
    """Canonical form of an interest expression; returns ``(expr', key)``.

    **Canonical-form contract.** A BGP/OGP is a *set* of triple patterns and
    variable names are bound positions, not identities (Definitions 2-4), so
    two expressions that differ only in pattern order and/or a bijective
    variable renaming denote the same interest. This function maps every
    member of such an equivalence class that it can recognize onto one
    representative:

    1. patterns are ordered by their *constant skeleton* (each variable slot
       replaced by ``"?"``) — a key independent of variable naming;
    2. variables are renamed ``?v0, ?v1, ...`` in order of first occurrence
       over the skeleton-sorted BGP then OGP;
    3. patterns are re-sorted by their full (renamed) term tuples, making
       the order independent of the input order even among patterns with
       equal skeletons.

    Guarantees: **equal keys imply equivalent interests** — the key embeds
    the source/target names and the complete renamed pattern lists, and the
    canonical expression is reconstructed from the input by a permutation
    plus a bijective renaming only, so any two expressions with the same
    key are permutations/renamings of the same canonical expression and
    evaluate identically (bit-identically: evaluation outputs are canonical
    lex-sorted stores, which erase pattern order). The converse does NOT
    hold: expressions whose equivalence needs a non-trivial automorphism
    argument may land on different keys — that costs a missed collapse in
    the broker's subsumption lattice, never a wrong one.

    The broker compiles and evaluates the *canonical* expression for every
    subscription in a lane group, so equal keys also share compiled plans,
    bank lanes, and cohort slots.
    """

    def skeleton(p: TriplePattern) -> Tuple[str, str, str]:
        return tuple("?" if is_var(t) else t for t in p.slots())

    bgp = sorted(expr.bgp, key=skeleton)
    ogp = sorted(expr.ogp, key=skeleton)
    renames: Dict[str, str] = {}

    def rename(t: str) -> str:
        if not is_var(t):
            return t
        if t not in renames:
            renames[t] = f"?v{len(renames)}"
        return renames[t]

    bgp = [TriplePattern(*(rename(t) for t in p.slots())) for p in bgp]
    ogp = [TriplePattern(*(rename(t) for t in p.slots())) for p in ogp]
    bgp = tuple(sorted(bgp, key=lambda p: p.slots()))
    ogp = tuple(sorted(ogp, key=lambda p: p.slots()))
    canon = InterestExpr(
        source=expr.source, target=expr.target, bgp=bgp, ogp=ogp
    )
    key = (
        expr.source,
        expr.target,
        tuple(p.slots() for p in bgp),
        tuple(p.slots() for p in ogp),
    )
    return canon, key


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


# encoded lane-id space: real bank lanes are < REFINE_BASE, virtual refined
# lanes are REFINE_BASE + slot (resolved to a dense index only at device
# assembly time, when the current padded real-lane count is known)
REFINE_BASE = 1 << 24

_WC = int(WILDCARD)


def row_subsumes(parent: Tuple[int, int, int], child: Tuple[int, int, int]) -> bool:
    """Pattern-wise term subsumption (the Fedra containment test, per row):
    ``parent`` matches a superset of ``child`` iff every parent slot is
    either a variable (-1) or the same constant as the child's slot.
    Strict (``parent != child``) subsumption additionally needs at least
    one variable-over-constant slot."""
    return all(p == _WC or p == c for p, c in zip(parent, child))


def residual_of(
    parent: Tuple[int, int, int], child: Tuple[int, int, int]
) -> Tuple[int, int, int]:
    """The residual predicate turning parent match bits into child match
    bits: the child's constants in exactly the slots the parent leaves
    variable (wildcard everywhere else). ``child`` ≡ ``parent`` AND
    residual, which is what :func:`repro_torch.kernels.ops.lane_refine`
    evaluates."""
    return tuple(
        c if (p == _WC and c != _WC) else _WC for p, c in zip(parent, child)
    )


class SubsumptionBank:
    """Containment-DAG view over an :class:`IncrementalPatternBank`.

    The plain bank dedups *identical* pattern rows; this wrapper
    additionally recognizes rows that an existing bank row strictly
    subsumes (constant where the parent has a variable, equal elsewhere)
    and registers them as **virtual refined lanes** instead of new bank
    rows: a virtual lane's match bits are its parent lane's bits ANDed
    with a cheap residual predicate over the newly-bound slots
    (:func:`repro_torch.kernels.ops.lane_refine`), so contained interests ride
    the parent's one bank compare instead of widening the shared bank
    pass. Resolution order for each registered row:

    1. exact match against a live bank row  -> shared real lane;
    2. exact match against a live virtual row -> shared virtual lane;
    3. a live bank row strictly subsumes it -> NEW virtual lane (parent =
       the subsuming row with the most bound slots, lowest lane on ties);
    4. otherwise -> new real bank lane.

    The parent edges form a depth-1 containment DAG (virtual rows refine
    real rows only; transitive chains are not built). Every
    virtual row holds a reference on its parent lane, so the parent can
    never be tombstoned from under it. Encoded lane ids returned by
    :meth:`add_plan`: real ids ``< REFINE_BASE``, virtual ids
    ``REFINE_BASE + slot``; :meth:`resolve_lanes` maps them into the
    extended device row space ``[real padded | virtual padded]`` that
    :meth:`patterns_padded` materializes (virtual rows appear there as
    their full child patterns, so the added-side fused match kernel needs
    no refine support — only the shared deleted-side words pass exploits
    the DAG).
    """

    def __init__(self):
        self.bank = IncrementalPatternBank()
        # slot -> (child row, parent real lane, residual row) | None
        self._vrows: List[Optional[tuple]] = []
        self._vrefs: List[int] = []
        self._vfree: List[int] = []
        self._vtable: Dict[Tuple[int, int, int], int] = {}
        self._vversion = 0

    @classmethod
    def restore(
        cls,
        rows: Sequence[Optional[Tuple[int, int, int]]],
        refs: Sequence[int],
        free: Sequence[int],
        virtual_rows: Sequence[Optional[tuple]] = (),
        virtual_refs: Sequence[int] = (),
        virtual_free: Sequence[int] = (),
    ) -> "SubsumptionBank":
        """A bank in a given state. ``rows`` / ``refs`` / ``free`` are the
        real lanes, as for :meth:`IncrementalPatternBank.restore`. Virtual
        slot ``v`` holds ``virtual_rows[v]`` = (child row, parent real lane,
        residual row), or None for a free slot, with ``virtual_refs[v]``
        references; ``virtual_free`` lists the free slots in reuse order (the
        last is reused first). Every live slot's parent must be a live real
        lane that strictly subsumes the child with that residual."""
        if len(virtual_rows) != len(virtual_refs) or sorted(virtual_free) != [
            v for v, ent in enumerate(virtual_rows) if ent is None
        ]:
            raise ValueError("virtual rows, refs and free do not describe one lane space")
        out = cls()
        out.bank = IncrementalPatternBank.restore(rows, refs, free)
        vrows: List[Optional[tuple]] = []
        for ent, ref in zip(virtual_rows, virtual_refs):
            if ent is None:
                if int(ref) != 0:
                    raise ValueError("a free virtual slot holds references")
                vrows.append(None)
                continue
            key, parent, residual = ent
            key = tuple(int(x) for x in key)
            residual = tuple(int(x) for x in residual)
            parent = int(parent)
            prow = out.bank.row_of(parent) if 0 <= parent < out.bank.n_lanes else None
            if (
                prow is None
                or prow == key
                or not row_subsumes(prow, key)
                or residual_of(prow, key) != residual
                or int(ref) <= 0
                or out.bank.lane_of(key) is not None
            ):
                raise ValueError(f"virtual row {key} is not a live refinement of real lane {parent}")
            vrows.append((key, parent, residual))
        out._vrows = vrows
        out._vrefs = [int(x) for x in virtual_refs]
        out._vfree = [int(x) for x in virtual_free]
        out._vtable = {ent[0]: v for v, ent in enumerate(vrows) if ent is not None}
        if len(out._vtable) != len(vrows) - len(out._vfree):
            raise ValueError("live virtual slots must hold distinct rows")
        return out

    # -- shape/version surface (IncrementalPatternBank-compatible) ----------

    @property
    def version(self) -> int:
        return self.bank.version + self._vversion

    @property
    def n_lanes(self) -> int:
        return self.bank.n_lanes + len(self._vrows)

    @property
    def n_live(self) -> int:
        return self.bank.n_live + len(self._vrows) - len(self._vfree)

    @property
    def n_real(self) -> int:
        return self.bank.n_live

    @property
    def n_virtual(self) -> int:
        return len(self._vrows) - len(self._vfree)

    @property
    def n_real_padded(self) -> int:
        return self.bank.n_lanes_padded

    @property
    def n_virt_padded(self) -> int:
        if not self._vrows:
            return 0
        return next_pow2(max(32, len(self._vrows)))

    @property
    def n_lanes_padded(self) -> int:
        return self.n_real_padded + self.n_virt_padded

    @property
    def n_words(self) -> int:
        return self.n_lanes_padded // 32

    def patterns_padded(self) -> np.ndarray:
        """Extended padded bank: real rows, then virtual rows materialized
        as their full child patterns (dead slots never match)."""
        real = self.bank.patterns_padded()
        if not self._vrows:
            return real
        virt = np.full(
            (self.n_virt_padded, 3), np.int32(_DEAD_ROW[0]), np.int32
        )
        for v, ent in enumerate(self._vrows):
            if ent is not None:
                virt[v] = ent[0]
        return np.concatenate([real, virt], axis=0)

    def real_padded(self) -> np.ndarray:
        """The real-rows-only padded bank (the deleted-side words pass)."""
        return self.bank.patterns_padded()

    def refine_arrays(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(parents int32[Vp], residual int32[Vp, 3]) for
        :func:`repro_torch.kernels.ops.lane_refine`, or None with no virtual
        rows. Dead slots carry parent -1 (bits forced to zero)."""
        if not self._vrows:
            return None
        vp = self.n_virt_padded
        parents = np.full((vp,), -1, np.int32)
        residual = np.full((vp, 3), np.int32(_DEAD_ROW[0]), np.int32)
        for v, ent in enumerate(self._vrows):
            if ent is not None:
                parents[v] = ent[1]
                residual[v] = ent[2]
        return parents, residual

    def resolve_lanes(self, lanes: Sequence[int]) -> Tuple[int, ...]:
        """Encoded lane ids -> dense extended row indices (valid until the
        next version bump — the padded real-lane count is baked in)."""
        base = self.n_real_padded
        return tuple(
            l if l < REFINE_BASE else base + (l - REFINE_BASE) for l in lanes
        )

    # -- registration --------------------------------------------------------

    def _find_parent(self, key: Tuple[int, int, int]) -> Optional[int]:
        best, best_bound = None, -1
        for lane in range(self.bank.n_lanes):
            row = self.bank.row_of(lane)
            if row is None or row == key:
                continue
            if not row_subsumes(row, key):
                continue
            bound = sum(1 for t in row if t != _WC)
            if bound > best_bound:
                best, best_bound = lane, bound
        return best

    def add_plan(self, plan: CompiledInterest) -> Tuple[int, ...]:
        """Register one plan's rows; returns its encoded lane map."""
        local: List[int] = []
        for j in range(plan.n_total):
            key = (
                int(plan.patterns[j, 0]),
                int(plan.patterns[j, 1]),
                int(plan.patterns[j, 2]),
            )
            if self.bank.lane_of(key) is not None:
                local.append(self.bank.acquire_row(key))
                continue
            v = self._vtable.get(key)
            if v is not None:
                self._vrefs[v] += 1
                local.append(REFINE_BASE + v)
                continue
            parent = self._find_parent(key)
            if parent is None:
                local.append(self.bank.acquire_row(key))
                continue
            self.bank.retain_lane(parent)
            ent = (key, parent, residual_of(self.bank.row_of(parent), key))
            if self._vfree:
                v = self._vfree.pop()
                self._vrows[v] = ent
                self._vrefs[v] = 1
            else:
                v = len(self._vrows)
                self._vrows.append(ent)
                self._vrefs.append(1)
            self._vtable[key] = v
            self._vversion += 1
            local.append(REFINE_BASE + v)
        return tuple(local)

    def remove_plan(self, lanes: Sequence[int]) -> None:
        for lane in lanes:
            if lane < REFINE_BASE:
                self.bank.release_row(lane)
                continue
            v = lane - REFINE_BASE
            self._vrefs[v] -= 1
            if self._vrefs[v] == 0:
                key, parent, _ = self._vrows[v]
                del self._vtable[key]
                self._vrows[v] = None
                self._vfree.append(v)
                self.bank.release_row(parent)
                self._vversion += 1
            elif self._vrefs[v] < 0:
                raise ValueError(
                    f"virtual lane {v} released more than acquired"
                )

    def maybe_compact(self, force: bool = False) -> Optional[Dict[int, int]]:
        """Compact real and virtual lane spaces when that shrinks their
        padded device shapes (same rule as the plain bank). Returns a
        TOTAL encoded remap over every live lane id (identity entries
        included), or None when nothing moved."""
        live_real_old = self.bank.live_lanes()
        remap_r = self.bank.maybe_compact(force)
        if remap_r is not None:
            for v, ent in enumerate(self._vrows):
                if ent is not None:
                    key, parent, residual = ent
                    self._vrows[v] = (key, remap_r[parent], residual)
            self._vversion += 1
        remap_v = None
        if self._vfree:
            live = len(self._vrows) - len(self._vfree)
            new_pad = next_pow2(max(32, live)) if live else 0
            if force or new_pad < self.n_virt_padded:
                remap_v = {}
                rows, refs = [], []
                for v, ent in enumerate(self._vrows):
                    if ent is None:
                        continue
                    remap_v[v] = len(rows)
                    rows.append(ent)
                    refs.append(self._vrefs[v])
                self._vrows, self._vrefs, self._vfree = rows, refs, []
                self._vtable = {
                    ent[0]: v for v, ent in enumerate(rows)
                }
                self._vversion += 1
        if remap_r is None and remap_v is None:
            return None
        out: Dict[int, int] = (
            dict(remap_r)
            if remap_r is not None
            else {lane: lane for lane in live_real_old}
        )
        if remap_v is not None:
            for old, new in remap_v.items():
                out[REFINE_BASE + old] = REFINE_BASE + new
        else:
            for key in self._vtable:
                v = self._vtable[key]
                out[REFINE_BASE + v] = REFINE_BASE + v
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
