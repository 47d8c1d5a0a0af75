"""Pure-Python reference implementation of the iRap semantics (sets + loops).

A copy of ``repro.core.oracle``, so the port checks itself without importing
the JAX package.

The oracle mirrors DESIGN.md §1 exactly — the same root/child/edge tree
semantics, the same interesting / potential / pull rules — but with unbounded
sets and exhaustive enumeration. Property tests drive random changesets
through both the oracle and the jitted evaluator and require identical sets
(fan-out-capped data).
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from .interest import CompiledInterest

Triple = Tuple[int, int, int]


def _matches(pattern, eq, triple: Triple) -> bool:
    for k in range(3):
        c = int(pattern[k])
        if c >= 0 and triple[k] != c:
            return False
    if eq is not None and triple[eq[0]] != triple[eq[1]]:
        return False
    return True


class OracleEvaluator:
    """Reference one-side evaluation + full changeset step."""

    def __init__(self, plan: CompiledInterest):
        self.plan = plan
        p = plan
        self.root_js = [j for j in range(p.n_total) if p.kinds[j] == "root"]
        self.edge_js = [j for j in range(p.n_total) if p.kinds[j] == "edge"]
        self.child_js = [j for j in range(p.n_total) if p.kinds[j] == "child"]
        self.bgp_root = [j for j in self.root_js if j < p.n_bgp]
        self.bgp_edge = [j for j in self.edge_js if j < p.n_bgp]
        self.child_bgp_stars = {
            cv: [j for j in self.child_js if p.child_var[j] == cv and j < p.n_bgp]
            for cv in range(p.n_children)
        }
        self.child_all_stars = {
            cv: [j for j in self.child_js if p.child_var[j] == cv]
            for cv in range(p.n_children)
        }
        self.edges_of = {
            cv: [e for e in self.edge_js if p.child_var[e] == cv]
            for cv in range(p.n_children)
        }

    # -- helpers ----------------------------------------------------------
    def _match_j(self, j: int, t: Triple) -> bool:
        return _matches(self.plan.patterns[j], self.plan.eq_pairs[j], t)

    def _probe(self, tgt: Set[Triple], j: int, slot: int, val: int) -> List[Triple]:
        return sorted(
            t for t in tgt if self._match_j(j, t) and t[slot] == val
        )

    # -- one-side evaluation ------------------------------------------------
    def evaluate_side(self, m: Set[Triple], tgt: Set[Triple]):
        p = self.plan
        anchor, cslot, cvar = p.anchor_slot, p.child_slot, p.child_var

        def m_bits(t: Triple) -> List[int]:
            return [j for j in range(p.n_total) if self._match_j(j, t)]

        # generation signature
        sat_gen: Dict[Tuple[int, int], bool] = {}
        for t in m:
            for j in self.root_js + self.child_js:
                if self._match_j(j, t):
                    sat_gen[(t[anchor[j]], j)] = True

        # candidate pools
        root_cand: Set[int] = set()
        for t in m:
            for j in self.root_js:
                if self._match_j(j, t):
                    root_cand.add(t[anchor[j]])
            for e in self.edge_js:
                if self._match_j(e, t):
                    root_cand.add(t[anchor[e]])

        # edge pools: edge id -> list of (b, c, triple, is_pull)
        edge_pool: Dict[int, List[Tuple[int, int, Triple, bool]]] = {
            e: [] for e in self.edge_js
        }
        for e in self.edge_js:
            for t in m:
                if self._match_j(e, t):
                    edge_pool[e].append((t[anchor[e]], t[cslot[e]], t, False))
            # upward probes from child-star M bindings
            for j in self.child_all_stars[cvar[e]]:
                for t in m:
                    if self._match_j(j, t):
                        c = t[anchor[j]]
                        for row in self._probe(tgt, e, cslot[e], c):
                            edge_pool[e].append(
                                (row[anchor[e]], row[cslot[e]], row, True)
                            )
                            root_cand.add(row[anchor[e]])
        # downward probes
        for e in self.edge_js:
            for b in sorted(root_cand):
                for row in self._probe(tgt, e, anchor[e], b):
                    edge_pool[e].append((row[anchor[e]], row[cslot[e]], row, True))

        child_cand: Dict[int, Set[int]] = {cv: set() for cv in range(p.n_children)}
        for cv in range(p.n_children):
            for j in self.child_all_stars[cv]:
                for t in m:
                    if self._match_j(j, t):
                        child_cand[cv].add(t[anchor[j]])
            for e in self.edges_of[cv]:
                for b, c, row, is_pull in edge_pool[e]:
                    child_cand[cv].add(c)

        # assertion probes
        sat_tgt: Dict[Tuple[int, int], bool] = {}
        pull_entries = []  # (kind, j, cv, binding, rows)
        for j in self.child_js:
            cv = cvar[j]
            for c in sorted(child_cand[cv]):
                rows = self._probe(tgt, j, anchor[j], c)
                if rows:
                    sat_tgt[(c, j)] = True
                pull_entries.append(("child", j, cv, c, rows))
        for j in self.root_js:
            for b in sorted(root_cand):
                rows = self._probe(tgt, j, anchor[j], b)
                if rows:
                    sat_tgt[(b, j)] = True
                pull_entries.append(("root", j, -1, b, rows))

        def sat(b: int, j: int) -> bool:
            return sat_gen.get((b, j), False) or sat_tgt.get((b, j), False)

        def child_ok(cv: int, c: int) -> bool:
            return all(sat(c, j) for j in self.child_bgp_stars[cv])

        def edge_ok(e: int, b: int) -> bool:
            return any(
                bb == b and child_ok(cvar[e], c)
                for bb, c, row, is_pull in edge_pool[e]
            )

        def full(b: int) -> bool:
            if not self.bgp_root and not self.bgp_edge:
                return False
            return all(sat(b, j) for j in self.bgp_root) and all(
                edge_ok(e, b) for e in self.bgp_edge
            )

        def linked_full(cv: int, c: int) -> bool:
            return any(
                cc == c and full(b)
                for e in self.edges_of[cv]
                for b, cc, row, is_pull in edge_pool[e]
            )

        interesting: Set[Triple] = set()
        potential: Set[Triple] = set()
        for t in m:
            bits = m_bits(t)
            inter = False
            for j in bits:
                if p.kinds[j] == "root":
                    inter |= full(t[anchor[j]])
                elif p.kinds[j] == "edge":
                    inter |= full(t[anchor[j]]) and child_ok(cvar[j], t[cslot[j]])
                else:
                    c = t[anchor[j]]
                    inter |= child_ok(cvar[j], c) and linked_full(cvar[j], c)
            if inter:
                interesting.add(t)
            elif bits:
                potential.add(t)

        pulls: Set[Triple] = set()
        for kind, j, cv, b, rows in pull_entries:
            if sat_gen.get((b, j), False):
                continue  # only missing patterns are pulled (Def 12)
            if kind == "root":
                gate = full(b)
            else:
                gate = child_ok(cv, b) and linked_full(cv, b)
            if gate:
                pulls.update(rows)
        for e in self.edge_js:
            for b, c, row, is_pull in edge_pool[e]:
                if is_pull and full(b) and child_ok(cvar[e], c):
                    pulls.add(row)

        return interesting, potential, pulls

    # -- full changeset step (Defs 13-18) -----------------------------------
    def step(
        self,
        d_set: Set[Triple],
        a_set: Set[Triple],
        tau: Set[Triple],
        rho: Set[Triple],
    ):
        r, r_i, r_prime = self.evaluate_side(set(d_set), set(tau))
        i_set = set(a_set) | set(rho)
        a_int, a_i, a_pulls = self.evaluate_side(i_set, set(tau))
        a = a_int | a_pulls
        tau1 = (tau - (r | r_prime)) | a
        rho1 = ((rho - r_i) | a_i | r_prime) - a
        return {
            "r": r,
            "r_i": r_i,
            "r_prime": r_prime,
            "a": a,
            "a_i": a_i,
            "tau1": tau1,
            "rho1": rho1,
        }
