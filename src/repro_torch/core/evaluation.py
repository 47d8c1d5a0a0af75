"""Interest evaluation over changesets (Definitions 11-15), port of ``repro.core.evaluation``.

:func:`make_side_evaluator` builds, per ``CompiledInterest``, the function
that classifies one side of a changeset (the removed set D, or I = A ∪ ρ for
the added side) into

  * interesting triples  (full BGP match over M ∪ τ with >= 1 triple from M),
  * potentially interesting triples (partial match),
  * pulls — the π' candidate-assertion retrievals from the target dataset τ.

Dataflow, all at shapes fixed by the capacities (eager PyTorch, no host sync):
  1. pattern bitset over M            (triple_match kernel, or bits the
                                      broker routes out of its bank pass)
  2. generation signature table       (scatter bits per binding  — π, Def 11)
  3. candidate pools + τ probes       (lexicographic probe kernel — π', Def 12)
  4. tree semijoin gating             (child_ok / edge_ok / full / linked_full)
  5. per-triple classification + fixed-capacity compaction

The reference's out-of-range scatters (``.at[idx].max(True, mode="drop")``)
and fills (``jnp.take(mode="fill")``) become a scatter into one spare row
that is dropped, and a clamped gather that is masked: an out-of-range index
on the card would be a device-side assert. Negative ids wrap, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .interest import CompiledInterest
from .triples import PAD, TripleStore, from_array, lex_sort, prefix_range


@dataclasses.dataclass(frozen=True)
class TripleIndex:
    """Two sort orders over the same triple set (the SPO / OPS indexes)."""

    spo: TripleStore  # rows (s, p, o), lex-sorted
    ops: TripleStore  # rows permuted to (o, p, s), lex-sorted in that order


def build_index(store: TripleStore) -> TripleIndex:
    ops_rows = lex_sort(store.spo[:, [2, 1, 0]])
    return TripleIndex(spo=store, ops=TripleStore(spo=ops_rows, n=store.n))


@dataclasses.dataclass(frozen=True)
class SideResult:
    interesting: TripleStore
    potential: TripleStore
    pulls: TripleStore
    overflow: torch.Tensor  # bool — any output capacity exceeded


# ---------------------------------------------------------------------------
# index helpers with the reference's out-of-range semantics
# ---------------------------------------------------------------------------

def _wrap(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX index normalisation: negative indices count from the end."""
    return torch.where(idx < 0, idx + size, idx)


def gather_bool(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(vec, idx, mode="fill", fill_value=False)``."""
    size = vec.shape[0]
    idx = _wrap(idx.long(), size)
    inside = (idx >= 0) & (idx < size)
    return vec[idx.clamp(0, size - 1)] & inside


def scatter_true(size: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """bool[size] with True at ``idx`` where ``mask``: the reference's
    ``zeros(size).at[where(mask, idx, size)].max(True, mode="drop")``."""
    idx = _wrap(idx.long(), size)
    keep = mask & (idx >= 0) & (idx < size)
    out = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    out[torch.where(keep, idx, size)] = True
    return out[:size]


# ---------------------------------------------------------------------------
# target-dataset probe (candidate assertion primitive)
# ---------------------------------------------------------------------------

def probe(
    index: TripleIndex,
    pattern: np.ndarray,  # (3,) int32 host constants, -1 for variable slots
    bound_slot: int,
    bound_vals: torch.Tensor,  # int32[B]; PAD entries are masked out
    fanout: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieve up to ``fanout`` τ rows matching ``pattern`` with one slot bound.

    Returns (rows int32[B, K, 3] in (s, p, o) order, valid bool[B, K]).
    Probes use the SPO index for subject-bound patterns and the OPS index for
    object-bound ones; non-prefix constant slots are post-filtered.
    """
    pattern_dev = torch.as_tensor(np.asarray(pattern, np.int32), device=bound_vals.device)
    return probe_dyn(index, pattern, pattern_dev, bound_slot, bound_vals, fanout)


def probe_dyn(
    index: TripleIndex,
    pattern_host: np.ndarray,  # (3,) int32 host row: which slots are constant
    pattern_dev: torch.Tensor,  # (3,) int32 device row: the constants' values
    bound_slot: int,
    bound_vals: torch.Tensor,
    fanout: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`probe` with the pattern's values as a device tensor.

    Which slots are constant (probe depth, index choice, post-filter set)
    comes from the host row and is shared by a broker cohort; the values
    differ per member and are read from ``pattern_dev``. Gives exactly the
    values of :func:`probe` for equal inputs.
    """
    if bound_slot == 1:
        raise ValueError("predicate-bound probes are unsupported (compile-time)")
    const = [int(pattern_host[k]) >= 0 for k in range(3)]
    vals = [pattern_dev[k] for k in range(3)]
    if bound_slot == 0:
        store = index.spo
        (c1_const, c1_val), (c2_const, c2_val) = (const[1], vals[1]), (const[2], vals[2])
    else:
        store = index.ops
        (c1_const, c1_val), (c2_const, c2_val) = (const[1], vals[1]), (const[0], vals[0])
    depth = 1 + (1 if c1_const else 0) + (1 if (c1_const and c2_const) else 0)

    b = bound_vals.shape[0]
    dev = bound_vals.device
    cap = store.capacity
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    prefix = torch.stack(
        [
            bound_vals,
            (c1_val if c1_const else zero).expand(b),
            (c2_val if c2_const else zero).expand(b),
        ],
        dim=1,
    )
    start, end = prefix_range(store, prefix, torch.full((b,), depth, dtype=torch.int32, device=dev))
    offs = torch.arange(fanout, dtype=torch.int32, device=dev)
    idx = start[:, None] + offs[None, :]
    rows = store.spo[idx.clamp(0, cap - 1).long()]
    valid = (idx < end[:, None]) & (bound_vals != PAD)[:, None]
    if bound_slot == 2:
        rows = rows[..., [2, 1, 0]]
    for k in range(3):
        if const[k]:
            valid = valid & (rows[..., k] == vals[k])
    valid = valid & (rows[..., bound_slot] == bound_vals[:, None])
    return rows, valid


# ---------------------------------------------------------------------------
# side evaluator factory
# ---------------------------------------------------------------------------

def _eq_clear_mask(j: int) -> int:
    """int32 bit pattern of ``~(1 << j) & 0xFFFFFFFF`` (bit 31 gives 0x7FFFFFFF)."""
    m = ~(1 << j) & 0xFFFFFFFF
    return m - (1 << 32) if m >= 1 << 31 else m


def make_side_evaluator(
    plan: CompiledInterest,
    *,
    id_capacity: int,
    fanout: int = 4,
    out_capacity: int,
    pull_capacity: int,
    matcher: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    probe_impl: Callable | None = None,
    table_reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
    dedup_candidates: int = 0,
    dynamic_patterns: bool = False,
) -> Callable[..., SideResult]:
    """Build the one-side evaluator for a compiled interest.

    ``matcher`` (default :func:`repro_torch.kernels.ops.pattern_bitmask`)
    maps (spo int32[N, 3], patterns int32[P, 3]) to the int32[N] bitset.
    ``dedup_candidates > 0`` sort-uniques each candidate pool to that many
    slots before it is probed, reporting overflow when it does not fit.

    ``dynamic_patterns=True`` builds the evaluator for the broker's cohort
    path: the pattern *values* arrive per call as the ``patterns`` argument
    (int32[n_total, 3] on the device) and the probes read them through
    :func:`probe_dyn`; ``plan`` then supplies only the static structure
    (kinds, slots, which slots are constant), shared by the cohort.

    ``probe_impl`` and ``table_reduce`` are the distribution hooks
    (:mod:`repro_torch.core.distributed`): the sharded evaluator routes each
    probe to the shard owning its binding and OR-reduces the signature
    tables and edge vectors across the shards. The probe hook takes
    :func:`probe`'s arguments, ``(index, pattern, bound_slot, bound_vals,
    fanout)``, or with ``dynamic_patterns`` :func:`probe_dyn`'s,
    ``(index, pattern_host, pattern_dev, bound_slot, bound_vals, fanout)``;
    ``table_reduce`` sees boolean tables (the generation and target
    signature columns stacked into one bool[R, k] table, then each edge and
    linked-full vector). Without them the evaluator probes its own index
    and reduces nothing.
    """
    matcher = matcher or kops.pattern_bitmask
    dedup_cap = dedup_candidates

    def maybe_dedup(vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sort-unique a candidate vector to ``dedup_cap`` slots; returns (vec', overflowed)."""
        if not dedup_cap:
            return vec, torch.zeros((), dtype=torch.bool, device=vec.device)
        s, _ = torch.sort(vec)
        first = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
        first[1:] = s[1:] != s[:-1]
        first = first & (s != PAD)
        order = torch.argsort((~first).to(torch.int8), stable=True)
        uniq = s[order]
        count = first.sum(dtype=torch.int32)
        idx = torch.arange(s.shape[0], dtype=torch.int32, device=s.device)
        uniq = torch.where(idx < count, uniq, PAD)
        return uniq[:dedup_cap], count > dedup_cap

    R = id_capacity
    K = fanout
    nt = plan.n_total
    kinds = plan.kinds
    anchor = plan.anchor_slot
    cslot = plan.child_slot
    cvar = plan.child_var
    n_children = plan.n_children

    root_js = [j for j in range(nt) if kinds[j] == "root"]
    edge_js = [j for j in range(nt) if kinds[j] == "edge"]
    child_js = [j for j in range(nt) if kinds[j] == "child"]
    bgp_root_js = [j for j in root_js if j < plan.n_bgp]
    bgp_edge_js = [j for j in edge_js if j < plan.n_bgp]
    child_bgp_stars = {
        cv: [j for j in child_js if cvar[j] == cv and j < plan.n_bgp]
        for cv in range(n_children)
    }
    child_all_stars = {cv: [j for j in child_js if cvar[j] == cv] for cv in range(n_children)}
    edges_of = {cv: [e for e in edge_js if cvar[e] == cv] for cv in range(n_children)}
    patterns_host = torch.as_tensor(plan.patterns, dtype=torch.int32)
    patterns_dev: Dict[torch.device, torch.Tensor] = {}

    def evaluate(
        m: TripleStore,
        tgt: TripleIndex,
        bits: torch.Tensor | None = None,
        patterns: torch.Tensor | None = None,
    ) -> SideResult:
        """Classify one changeset side ``m`` against the target index ``tgt``.

        ``bits`` (optional) is a precomputed int32[N] pattern bitset of
        ``m``'s rows in this plan's local numbering (the broker routes it out
        of one bank pass); it must equal ``matcher(m.spo, patterns)``.
        ``patterns`` carries the pattern values in dynamic-patterns mode.
        """
        spo = m.spo
        dev = spo.device
        n = m.capacity
        if dynamic_patterns:
            if patterns is None:
                raise ValueError("a dynamic-patterns evaluator takes the patterns per call")
            pats = patterns
        else:
            pats = patterns_dev.get(dev)
            if pats is None:
                pats = patterns_dev[dev] = patterns_host.to(dev)

        def run_probe(j: int, bound_slot: int, bound_vals: torch.Tensor):
            if probe_impl is None:
                # the values come from the device copy either way: no upload per probe
                return probe_dyn(tgt, plan.patterns[j], pats[j], bound_slot, bound_vals, K)
            if dynamic_patterns:
                return probe_impl(tgt, plan.patterns[j], pats[j], bound_slot, bound_vals, K)
            return probe_impl(tgt, plan.patterns[j], bound_slot, bound_vals, K)

        def reduce_columns(cols: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
            """The reference's ``table_reduce(sat)`` over the (R, nt) table:
            every column this side sets, in one reduction."""
            if table_reduce is None or not cols:
                return cols
            js = list(cols)
            red = table_reduce(torch.stack([cols[j] for j in js], dim=1))
            return {j: red[:, i] for i, j in enumerate(js)}

        def reduce_vec(vec: torch.Tensor) -> torch.Tensor:
            return vec if table_reduce is None else table_reduce(vec)

        def pad_vec(length: int) -> torch.Tensor:
            return torch.full((length,), PAD, dtype=torch.int32, device=dev)

        valid_row = spo[:, 0] != PAD
        if bits is None:
            bits = matcher(spo, pats)
        # repeated-variable-in-pattern equality constraints
        for j, eq in enumerate(plan.eq_pairs):
            if eq is not None:
                ok = spo[:, eq[0]] == spo[:, eq[1]]
                bits = torch.where(ok, bits, bits & _eq_clear_mask(j))

        bit_cache: Dict[int, torch.Tensor] = {}

        def bit(j: int) -> torch.Tensor:
            if j not in bit_cache:
                bit_cache[j] = ((bits >> j) & 1).to(torch.bool)
            return bit_cache[j]

        # -- generation signature table (π), one column per pattern ---------
        sat_gen: Dict[int, torch.Tensor] = {}
        for j in root_js + child_js:
            sat_gen[j] = scatter_true(R, spo[:, anchor[j]], bit(j))
        sat_gen = reduce_columns(sat_gen)

        # -- candidate pools + upward edge discovery -----------------------
        edge_pool: Dict[int, List[Tuple]] = {e: [] for e in edge_js}
        root_cand_parts = [torch.where(bit(j), spo[:, anchor[j]], PAD) for j in root_js]
        for e in edge_js:
            root_cand_parts.append(torch.where(bit(e), spo[:, anchor[e]], PAD))
            edge_pool[e].append((spo[:, anchor[e]], spo[:, cslot[e]], bit(e), spo, False))
            for j in child_all_stars[cvar[e]]:
                c_vec = torch.where(bit(j), spo[:, anchor[j]], PAD)
                rows, val = run_probe(e, cslot[e], c_vec)
                rows_f = rows.reshape(-1, 3)
                val_f = val.reshape(-1)
                b_f = rows_f[:, anchor[e]]
                c_f = rows_f[:, cslot[e]]
                edge_pool[e].append((b_f, c_f, val_f, rows_f, True))
                root_cand_parts.append(torch.where(val_f, b_f, PAD))
        root_cand = torch.cat(root_cand_parts) if root_cand_parts else pad_vec(n)
        root_cand, ovf_d1 = maybe_dedup(root_cand)

        # -- downward edge probes (per edge, for every root candidate) -----
        for e in edge_js:
            rows, val = run_probe(e, anchor[e], root_cand)
            rows_f = rows.reshape(-1, 3)
            edge_pool[e].append(
                (rows_f[:, anchor[e]], rows_f[:, cslot[e]], val.reshape(-1), rows_f, True)
            )

        # -- child candidate pools ------------------------------------------
        child_cand: Dict[int, torch.Tensor] = {}
        for cv in range(n_children):
            parts = [torch.where(bit(j), spo[:, anchor[j]], PAD) for j in child_all_stars[cv]]
            for e in edges_of[cv]:
                for b_f, c_f, val_f, rows_f, is_pull in edge_pool[e]:
                    parts.append(torch.where(val_f, c_f, PAD))
            cc, ovf_dc = maybe_dedup(torch.cat(parts))
            child_cand[cv] = cc
            ovf_d1 = ovf_d1 | ovf_dc

        # -- assertion probes (π') -----------------------------------------
        sat_tgt: Dict[int, torch.Tensor] = {}
        pull_entries = []  # (kind, j, cv, bound, rows, valid)
        for j in child_js:
            cv = cvar[j]
            bound = child_cand[cv]
            rows, val = run_probe(j, anchor[j], bound)
            pull_entries.append(("child", j, cv, bound, rows, val))
            sat_tgt[j] = scatter_true(R, bound, val.any(dim=1))
        for j in root_js:
            rows, val = run_probe(j, anchor[j], root_cand)
            pull_entries.append(("root", j, -1, root_cand, rows, val))
            sat_tgt[j] = scatter_true(R, root_cand, val.any(dim=1))
        sat_tgt = reduce_columns(sat_tgt)

        def sat(j: int) -> torch.Tensor:
            return sat_gen[j] | sat_tgt[j]

        # -- tree gating -----------------------------------------------------
        child_ok: Dict[int, torch.Tensor] = {}
        for cv in range(n_children):
            ok = torch.ones(R, dtype=torch.bool, device=dev)
            for j in child_bgp_stars[cv]:
                ok = ok & sat(j)
            child_ok[cv] = ok

        edge_ok: Dict[int, torch.Tensor] = {}
        for e in edge_js:
            acc = torch.zeros(R, dtype=torch.bool, device=dev)
            for b_f, c_f, val_f, rows_f, is_pull in edge_pool[e]:
                v = val_f & gather_bool(child_ok[cvar[e]], c_f)
                acc = acc | scatter_true(R, b_f, v)
            edge_ok[e] = reduce_vec(acc)

        full = torch.ones(R, dtype=torch.bool, device=dev)
        for j in bgp_root_js:
            full = full & sat(j)
        for e in bgp_edge_js:
            full = full & edge_ok[e]
        if not bgp_root_js and not bgp_edge_js:
            full = torch.zeros(R, dtype=torch.bool, device=dev)

        linked_full: Dict[int, torch.Tensor] = {}
        for cv in range(n_children):
            acc = torch.zeros(R, dtype=torch.bool, device=dev)
            for e in edges_of[cv]:
                for b_f, c_f, val_f, rows_f, is_pull in edge_pool[e]:
                    v = val_f & gather_bool(full, b_f)
                    acc = acc | scatter_true(R, c_f, v)
            linked_full[cv] = reduce_vec(acc)

        # -- per-triple classification (Defs 8-10) ---------------------------
        inter = torch.zeros(n, dtype=torch.bool, device=dev)
        for j in range(nt):
            if kinds[j] == "root":
                g = gather_bool(full, spo[:, anchor[j]])
            elif kinds[j] == "edge":
                g = gather_bool(full, spo[:, anchor[j]]) & gather_bool(
                    child_ok[cvar[j]], spo[:, cslot[j]]
                )
            else:
                c = spo[:, anchor[j]]
                g = gather_bool(child_ok[cvar[j]], c) & gather_bool(linked_full[cvar[j]], c)
            inter = inter | (bit(j) & g)
        potential = valid_row & (bits != 0) & ~inter

        # -- pull inclusion (π' outputs) --------------------------------------
        pull_rows_parts = []
        pull_mask_parts = []
        for kind, j, cv, bound, rows, val in pull_entries:
            gen_bit_at = gather_bool(sat_gen[j], bound)
            if kind == "root":
                gate = gather_bool(full, bound) & ~gen_bit_at
            else:
                gate = (
                    gather_bool(child_ok[cv], bound)
                    & gather_bool(linked_full[cv], bound)
                    & ~gen_bit_at
                )
            pull_rows_parts.append(rows.reshape(-1, 3))
            pull_mask_parts.append((val & gate[:, None]).reshape(-1))
        for e in edge_js:
            for b_f, c_f, val_f, rows_f, is_pull in edge_pool[e]:
                if not is_pull:
                    continue
                inc = val_f & gather_bool(full, b_f) & gather_bool(child_ok[cvar[e]], c_f)
                pull_rows_parts.append(rows_f)
                pull_mask_parts.append(inc)

        if pull_rows_parts:
            pr = torch.cat(pull_rows_parts, dim=0)
            pm = torch.cat(pull_mask_parts, dim=0)
            pr = torch.where(pm[:, None], pr, PAD)
        else:
            pr = torch.full((1, 3), PAD, dtype=torch.int32, device=dev)
        pulls, ovf_p = from_array(pr, pull_capacity)

        inter_store, ovf_i = from_array(torch.where(inter[:, None], spo, PAD), out_capacity)
        pot_store, ovf_q = from_array(torch.where(potential[:, None], spo, PAD), out_capacity)

        return SideResult(
            interesting=inter_store,
            potential=pot_store,
            pulls=pulls,
            overflow=ovf_p | ovf_i | ovf_q | ovf_d1,
        )

    return evaluate
