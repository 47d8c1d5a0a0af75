"""Interest expressions (Definition 7) and their compilation to static plans.

The compile half of ``repro.core.interest``, copied: an interest expression
``i_g = <τ, b, op>`` is compiled into a ``CompiledInterest`` holding
dictionary-encoded pattern constants (numpy) and a static query plan (root
variable, child stars, edge patterns) that the evaluator in
:mod:`repro_torch.core.evaluation` closes over. The plans are equal to the
reference's field for field.

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
