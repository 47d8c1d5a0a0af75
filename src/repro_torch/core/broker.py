"""Multi-subscriber interest broker (port of ``repro.core.broker``, one device).

The paper's deployment (§1, §3) is many long-lived applications, each with
an interest ``i_g = <τ, b, op>`` (Definition 7) over one evolving source.
The broker evaluates all of them per changeset through shared passes:

1. **Pattern bank.** Every subscription's patterns dedup into one bank:
   lanes are never renumbered on subscribe, tombstoned on unsubscribe (and
   reused), and compacted only when that shrinks the padded bank. The
   device bank is padded to a power of two (>= 32) rows, so W = rows / 32
   bitset words.

2. **Subsumption lattice** (the default; ``subsume_interests=False`` gives
   one cohort slot per subscriber and a plain
   :class:`~repro_torch.core.interest.IncrementalPatternBank`). Each
   expression is canonicalized
   (:func:`~repro_torch.core.interest.canonicalize_expr`), and a new
   subscription whose canonical interest, capacities, policy, frontier and
   τ/ρ equal an existing lane group's joins it: the group takes one cohort
   slot per fire and its result fans out to every member at commit
   (``BrokerStats.distinct_interests`` vs ``fanout_copies``). A pattern
   strictly contained by a real bank row rides a virtual lane of the
   :class:`~repro_torch.core.interest.SubsumptionBank`: the deleted-side
   words pass runs over the real rows only, and the virtual words are the
   parent lane's bits AND a residual compare (:func:`kops.lane_refine`, the
   K7 kernel on the card), placed after the real words.

3. **Cohorts.** Subscriptions with the same static plan shape, capacities and
   id capacity form a cohort, padded to a power-of-two member count with
   inactive members. One cohort pass launches each bank kernel once over
   all its members and frontier slots:

   * the deleted side: one words pass (:func:`kops.pattern_bitmask_words`,
     the K4 kernel on the card) over every fired frontier's D store,
     stacked and flattened into one launch, shared by all cohorts; each
     member's words are routed to its local pattern numbering by
     :func:`kops.lane_bits_batched`;
   * the added side: the fused match + lane routing + member mask
     (:func:`kops.pattern_lane_bits_batched`, the K5 kernel) over the
     stacked ``I_k = A_f(k) ∪ ρ_k`` rows ``[Ncp, n_i, 3]`` (Definition 14).

   ``build_index(τ)`` runs once per unique target replica (subscribers of
   one replica share it). The side evaluation
   (:func:`~repro_torch.core.evaluation.make_side_evaluator` in
   dynamic-patterns mode, with the routed bits) and
   :func:`~repro_torch.core.propagation.combine_side_results` run per
   active member in a Python loop; padding members compute nothing.

   Built cohort steps sit in an LRU cache under the reference's keys, and
   the membership-static device inputs (pattern values, lane maps, member
   mask, frontier and target maps) in a second one, so a subscription
   change rebuilds at most its own cohort; ``rejit_count``,
   ``cohort_compiles`` and ``words_compiles`` count the builds.

4. **Push scheduler and delta frontier chains.** Each subscription has a
   :class:`PushPolicy` (every k changesets, priority lane, or maximum
   staleness). Pending changesets compose per consumption frontier into a
   device-resident :class:`~repro_torch.core.propagation.ChangesetBatch`
   (Definition 6), a subscriber's cohort runs only when its policy fires,
   and :meth:`Broker.flush` drains the rest. Frontiers that fire together
   run in one pass: the frontier is one more padded axis folded into each
   cohort's member axis (``f_map``). Their D sides overlap (each composes a
   suffix of one stream), so by default (``delta_frontiers=True``) the
   pass is delta-encoded: a
   :class:`~repro_torch.core.propagation.FrontierChain` holds the distinct
   D rows and each frontier's membership bits, one segmented words pass
   (:func:`kops.pattern_bitmask_words_segmented`, the K6 kernel) matches
   each distinct row once, and every cohort evaluates the one union store,
   homed at the union's own power-of-two row count, with each member's
   frontier words selecting its rows. Where the chain cannot prove that it
   holds every frontier's rows, the stacked pass runs instead, as it does
   always with ``delta_frontiers=False``. Capacities grow on overflow: the
   whole fire re-runs with the overflowing subscribers' capacities doubled,
   and past ``max_fire_retries`` those subscribers go through the
   per-interest step.

5. **Durability and delivery** (both opt-in; without a journal and a
   channel the broker behaves as without this layer). A
   :class:`~repro_torch.core.journal.ChangesetJournal`
   (``Broker(journal=...)``) logs every state-changing event ahead of its
   effect: ``subscribe`` and ``unsubscribe`` records carry the call's
   arguments, an ``ingest`` record the raw changeset (appended before any
   batch sees it), and a ``fire`` record the acked subscribers' new
   frontiers (appended after delivery, before the commit), so the journal's
   durable prefix always ends at a consistent boundary. :meth:`Broker.snapshot`
   saves every subscriber's τ/ρ and frontier into a
   :class:`~repro_torch.checkpoint.CheckpointStore`,
   :meth:`Broker.compact_journal` drops the segments that replay no longer
   needs, and :meth:`Broker.recover` rebuilds the broker from the newest
   usable snapshot plus the journal's tail, replaying each recorded fire
   through the normal fire path (the kernels, on the card): the same τ/ρ,
   frontiers, pending batches and sequence clock. A
   :class:`~repro_torch.core.delivery.DeliveryChannel` (``channel=``) hands
   each fired subscriber's outputs to its transport before anything
   commits: a failed delivery leaves the subscriber where it was (frontier
   pinned, batch composing), with retry, backoff, quarantine and ingest
   backpressure on the channel's injected clock.

6. **Devices** (opt-in, ``Broker(mesh=...)`` with a
   :class:`~repro_torch.core.distributed.DeviceMesh`). By default each
   cohort is placed on one mesh device by a
   :class:`~repro_torch.core.distributed.CohortPlacement` (round robin,
   load-balanced by padded member count, or pinned; sticky), and the
   frontier pass runs the cohorts grouped by device, each with its inputs
   and statics on its device. ``shard_cohorts=True`` instead spreads every
   cohort pass over the whole mesh (:func:`make_sharded_cohort_step`, one
   thread a shard): τ replicas hash-partition across the shards (cached
   per subscription, τ version and capacity), the bank passes are
   block-split and stitched, and probes route to their owner shard.

Every output equals what the per-interest engine gives for the same composed
changeset, and every store and statistic equals the reference ``Broker``'s
under the same ``subsume_interests`` and ``delta_frontiers``, with a mesh or
without; a journal and a snapshot written by either package recover in the
other.

One unified sequence clock (``_seq``) orders the broker's events: a
subscribe, an unsubscribe, an ingested changeset and a committed fire each
consume one tick, with or without a journal, which names frontiers
(``since``), journal records and ``BrokerStats.seq``.

Paper name -> code name (Definitions 13-18): ``d(i, D) = <r, r_i, r'>`` and
``α(i, A ∪ ρ) = <a, a_i>`` are ``EvalOutputs`` fields; ``Δ(τ)`` and ``Δ(ρ)``
are applied to ``BrokerSubscription.tau`` / ``.rho``; ``Υ`` is
``combine_side_results``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .delivery import DeliveryChannel
from .dictionary import Dictionary
from .distributed import (
    CohortPlacement,
    DeviceMesh,
    _count_valid,
    all_gather,
    axis_index,
    make_or_reduce,
    make_routed_probe_batched,
    run_spmd,
    shard_target_store,
)
from .evaluation import SideResult, TripleIndex, build_index, make_side_evaluator
from .interest import (
    CompiledInterest,
    IncrementalPatternBank,
    InterestExpr,
    PatternBank,
    SubsumptionBank,
    canonicalize_expr,
    compile_interest,
    next_pow2,
)
from .journal import ChangesetJournal, JournalRecord
from .propagation import (
    ChangesetBatch,
    EvalOutputs,
    StepCapacities,
    build_frontier_chain,
    combine_side_results,
    make_interest_step,
    resolve_device,
)
from .triples import PAD, TripleStore, empty, from_array, rehome, to_numpy, union


def _plan_shape_key(plan: CompiledInterest):
    """Static evaluation structure of a plan: everything a cohort step
    specializes on except the pattern *values* (which slots are constant
    matters; what constant they hold does not)."""
    const_mask = tuple(tuple(int(x) >= 0 for x in row) for row in plan.patterns)
    return (
        plan.n_bgp,
        plan.n_ogp,
        plan.kinds,
        plan.anchor_slot,
        plan.child_slot,
        plan.child_var,
        plan.eq_pairs,
        plan.n_children,
        const_mask,
    )


# ---------------------------------------------------------------------------
# durability: subscription arguments in journal records and snapshots
# ---------------------------------------------------------------------------

def _expr_to_json(expr: InterestExpr) -> dict:
    return {
        "source": expr.source,
        "target": expr.target,
        "bgp": [list(p.slots()) for p in expr.bgp],
        "ogp": [list(p.slots()) for p in expr.ogp],
    }


def _expr_from_json(d: dict) -> InterestExpr:
    return InterestExpr.parse(
        d["source"], d["target"],
        bgp=[tuple(p) for p in d["bgp"]],
        ogp=[tuple(p) for p in d.get("ogp", [])],
    )


def _caps_to_json(caps: StepCapacities) -> dict:
    return dataclasses.asdict(caps)


def _caps_from_json(d: dict) -> StepCapacities:
    return StepCapacities(**d)


def _policy_to_json(policy: "PushPolicy | None") -> dict | None:
    return None if policy is None else dataclasses.asdict(policy)


def _policy_from_json(d: dict | None) -> "PushPolicy | None":
    return None if d is None else PushPolicy(**d)


# ---------------------------------------------------------------------------
# push scheduling policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PushPolicy:
    """When a subscriber's pending batch goes through the broker's pass.

    ``every_k``           fire once k changesets are pending (1 = eager;
                          None disables count-based firing).
    ``max_staleness_s``   fire once this many seconds have passed since the
                          subscriber's last push (None disables).
    ``priority``          priority lane: fire at every changeset and run
                          before non-priority work in the pass order.

    A subscriber with nothing pending never fires; :meth:`Broker.flush`
    drains pending batches regardless of policy.
    """

    every_k: Optional[int] = 1
    max_staleness_s: Optional[float] = None
    priority: bool = False

    @staticmethod
    def every(k: int) -> "PushPolicy":
        """Batch k changesets between pushes (slow-consumer cadence)."""
        return PushPolicy(every_k=k)

    @staticmethod
    def priority_lane() -> "PushPolicy":
        """Evaluate at every changeset, ahead of non-priority subscribers."""
        return PushPolicy(every_k=1, priority=True)

    @staticmethod
    def max_staleness(seconds: float) -> "PushPolicy":
        """Fire only when the replica's staleness bound is reached."""
        return PushPolicy(every_k=None, max_staleness_s=seconds)

    def fires(self, pending: int, staleness_s: float) -> bool:
        if pending <= 0:
            return False
        if self.priority:
            return True
        if self.every_k is not None and pending >= self.every_k:
            return True
        return self.max_staleness_s is not None and staleness_s >= self.max_staleness_s


# ---------------------------------------------------------------------------
# per-cohort step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CohortStatics:
    """Membership-static inputs of one padded cohort pass.

    The device tensors feed the bank kernels and the evaluators; the host
    tuples drive the per-member loop without reading the device.
    """

    f_map: torch.Tensor  # int32[Ncp] member -> frontier slot
    tgt_map: torch.Tensor  # int32[Ncp] member -> unique replica slot
    pats: torch.Tensor  # int32[Ncp, nt, 3] pattern values per member
    lanes: torch.Tensor  # int32[Ncp, nt] bank lane per local pattern
    active: torch.Tensor  # bool[Ncp] member mask (False = padding)
    f_host: Tuple[int, ...]
    tgt_host: Tuple[int, ...]
    active_host: Tuple[bool, ...]


def _assemble_cohort_statics(
    pat_rows: Sequence[np.ndarray],
    lane_rows: Sequence[Sequence[int]],
    tgt: Sequence[int],
    fmap: Sequence[int],
    ncp: int,
    nt: int,
    bank_rows: int,
    device,
) -> CohortStatics:
    """The inputs of one padded cohort: the single definition of the padding
    encoding (zeros, ``active`` False), shared by the broker and
    :func:`make_broker_step`. Every lane must lie in the padded bank's rows
    ``[0, bank_rows)``; this is where that is checked, once per membership,
    not per launch."""
    nm = len(pat_rows)
    f_map = np.zeros((ncp,), np.int32)
    tgt_map = np.zeros((ncp,), np.int32)
    pats = np.zeros((ncp, nt, 3), np.int32)
    lanes = np.zeros((ncp, nt), np.int32)
    active = np.zeros((ncp,), bool)
    for pos in range(nm):
        f_map[pos] = fmap[pos]
        tgt_map[pos] = tgt[pos]
        pats[pos] = pat_rows[pos]
        lanes[pos] = np.asarray(lane_rows[pos], np.int32)
        active[pos] = True
    if lanes.size and (lanes.min() < 0 or lanes.max() >= bank_rows):
        raise ValueError(f"a lane lies outside the padded bank's {bank_rows} rows")

    def put(a):
        return torch.as_tensor(a, device=device)

    return CohortStatics(
        f_map=put(f_map),
        tgt_map=put(tgt_map),
        pats=put(pats),
        lanes=put(lanes),
        active=put(active),
        f_host=tuple(int(x) for x in f_map),
        tgt_host=tuple(int(x) for x in tgt_map),
        active_host=tuple(bool(x) for x in active),
    )


def make_cohort_step(
    plan: CompiledInterest,
    caps: StepCapacities,
    id_capacity: int,
    matcher: Optional[Callable] = None,
    delta: bool = False,
) -> Callable:
    """The step for ONE shape-homogeneous cohort, spanning every frontier
    that fires in the same call.

    ``plan`` supplies only static structure (kinds, slots, which slots are
    constant); pattern values, lane maps, the bank, targets, changesets and
    the member mask are inputs, so one step serves any cohort of this shape.
    Signature (``Ncp`` padded members, ``Nu`` padded unique targets, ``Fp``
    padded frontier slots, ``W`` padded bank words)::

        step(d_sets,     # Fp-tuple of TripleStore, D per frontier slot
             d_words,    # Fp-tuple of int32[|D|, W] bank words of d_sets
             a_sets,     # Fp-tuple of TripleStore, A per frontier slot
             bank_dev,   # int32[32 W, 3] padded pattern bank
             uniq_taus,  # Nu-tuple of TripleStore, unique replicas
             rhos,       # Ncp-tuple of TripleStore
             statics,    # CohortStatics
        ) -> (tau1s, rho1s, outs)   # Ncp-tuples; None for padding members

    The added side is one launch of the fused bank kernel over the stacked
    ``I_k = A_f(k) ∪ ρ_k``; the deleted side routes each member's frontier
    words. ``build_index`` runs once per unique target that an active
    member reads.

    ``delta=True`` is the delta-chain step: ``d_sets`` is ONE store, the
    distinct D rows of every fired frontier
    (:class:`~repro_torch.core.propagation.FrontierChain`), shared by every
    member, and ``d_words[f]`` are frontier ``f``'s membership-masked words
    over those rows. A row outside a member's frontier has zero bits, so it
    yields no candidates and no outputs, and the outputs equal the stacked
    step's.
    """
    eval_kw = dict(
        id_capacity=id_capacity,
        fanout=caps.fanout,
        pull_capacity=caps.pulls,
        matcher=matcher,
        dedup_candidates=caps.dedup_candidates,
        dynamic_patterns=True,
    )
    eval_d = make_side_evaluator(plan, out_capacity=caps.n_removed, **eval_kw)
    eval_a = make_side_evaluator(plan, out_capacity=caps.n_i, **eval_kw)

    def step(
        d_sets,
        d_words: Tuple[torch.Tensor, ...],
        a_sets: Tuple[TripleStore, ...],
        bank_dev: torch.Tensor,
        uniq_taus: Tuple[TripleStore, ...],
        rhos: Tuple[TripleStore, ...],
        st: CohortStatics,
    ):
        ncp = len(st.active_host)
        live = [pos for pos in range(ncp) if st.active_host[pos]]
        # I_k = A_f(k) ∪ ρ_k (Def 14), stacked for one fused bank pass;
        # padding members' rows are never read
        i_sets = {}
        spo_b = torch.full((ncp, caps.n_i, 3), PAD, dtype=torch.int32, device=bank_dev.device)
        for pos in live:
            i_sets[pos] = union(a_sets[st.f_host[pos]], rhos[pos], caps.n_i)
            spo_b[pos] = i_sets[pos][0].spo
        a_bits = kops.pattern_lane_bits_batched(spo_b, bank_dev, st.lanes, st.active, matcher=matcher)
        d_bits = kops.lane_bits_batched(torch.stack(d_words)[st.f_map.long()], st.lanes, st.active)

        tgts: Dict[int, object] = {}
        tau1s: List[Optional[TripleStore]] = [None] * ncp
        rho1s: List[Optional[TripleStore]] = [None] * ncp
        outs: List[Optional[EvalOutputs]] = [None] * ncp
        for pos in live:
            t = st.tgt_host[pos]
            if t not in tgts:  # one build_index(τ) per unique replica
                tgts[t] = build_index(uniq_taus[t])
            i_set, ovf_i = i_sets[pos]
            d_set = d_sets if delta else d_sets[st.f_host[pos]]
            d_res = eval_d(d_set, tgts[t], d_bits[pos], st.pats[pos])
            a_res = eval_a(i_set, tgts[t], a_bits[pos], st.pats[pos])
            tau1s[pos], rho1s[pos], outs[pos] = combine_side_results(
                d_res, a_res, uniq_taus[t], rhos[pos], caps, ovf_i
            )
        return tuple(tau1s), tuple(rho1s), tuple(outs)

    return step


def _blocks(cap: int, n_shards: int) -> Tuple[int, List[int]]:
    """Row blocks of a block-split pass: each shard's block length and
    start. The tail blocks are clamped to end at ``cap`` (the reference's
    ``dynamic_slice`` at ``my * blk``), so the last overlaps the one before
    it; overlapping rows carry equal words, so stitching by overwrite is
    exact."""
    blk = -(-cap // n_shards)
    return blk, [min(i * blk, cap - blk) for i in range(n_shards)]


def _stitch(gathered: torch.Tensor, cap: int, blk: int, starts: List[int], dim: int) -> torch.Tensor:
    """Every shard's block (``gathered[i]``) written back at its start along ``dim``."""
    shape = list(gathered.shape[1:])
    shape[dim] = cap
    out = torch.zeros(shape, dtype=gathered.dtype, device=gathered.device)
    for i, start in enumerate(starts):
        out.narrow(dim, start, blk).copy_(gathered[i])
    return out


def make_sharded_cohort_step(
    plan: CompiledInterest,
    caps: StepCapacities,
    id_capacity: int,
    mesh: DeviceMesh,
    *,
    matcher: Optional[Callable] = None,
    delta: bool = False,
    n_frontiers: int = 1,
) -> Callable:
    """:func:`make_cohort_step` with the member evaluations spread over a
    :class:`~repro_torch.core.distributed.DeviceMesh`, one thread a shard,
    equal to the single-device step:

    * each member's τ replica is hash-partitioned across the shards (SPO by
      subject, OPS by object; the broker caches the partitions per
      subscription and τ version), and candidate probes route to the owner
      shard (:func:`~repro_torch.core.distributed.make_routed_probe_batched`):
      the partition key is the probe's bound slot, so the owner holds the
      whole prefix range and even the ``fanout`` truncation order matches
      the unpartitioned index;
    * the changeset rows stay replicated, but each shard owns the rows whose
      subject hashes to it: the bank passes are block-split across the shards
      (the K4/K6 words pass and the K5 lanes pass each over one row block),
      the blocks all-gathered and stitched back at their starts, and then
      each shard zeroes the bits of the rows it does not own (``row_mask``
      of :func:`kops.lane_bits_batched`). Zero bits give no candidates, no
      signatures and no outputs, so the masks split the evaluation, and
      each shard evaluates only its rows with bits (:func:`_rows_with_bits`):
      its pools and probe answers hold its share of the rows, not all of
      them;
    * signature tables and edge vectors OR-reduce across the shards (the
      ``table_reduce`` hook), so gating is global while candidates and
      classification stay on their shard;
    * each member's per-shard outputs go through one ``from_array`` (sort,
      dedup, compact), which erases the decomposition: the stores, Δ/Υ and
      overflow flags equal the single-device step's.

    The deleted-side words are computed in the step over the whole extended
    bank (virtual lanes as materialized rows, no lane refinement), as the
    reference's sharded step does. Signature::

        step(d_sets,        # Fp-tuple of TripleStore, D per frontier slot
             a_sets,        # Fp-tuple of TripleStore, A per frontier slot
             bank_dev,      # int32[32 W, 3] padded extended bank
             uniq_taus,     # Nu-tuple of TripleStore, unique replicas
             uniq_tau_spo,  # Nu-tuple of int32[n_shards, t_cap, 3], by subject
             uniq_tau_ops,  # Nu-tuple of int32[n_shards, t_cap, 3], (o, p, s) by object
             rhos,          # Ncp-tuple of TripleStore
             statics,       # CohortStatics
        ) -> (tau1s, rho1s, outs)

    ``delta=True`` takes the delta chain's union store and its int32
    membership bitmap (bit = local frontier slot, ``n_frontiers`` of them)
    in place of ``d_sets``: ``step(d_union, d_seg, a_sets, ...)``; each
    shard runs one segmented words pass over its block of union rows.

    Candidate dedup (``caps.dedup_candidates``) is refused, as in the
    reference: a shard counts pool overflow over its own candidates only, so
    a global overflow no shard sees would skip the capacity retry.
    """
    if caps.dedup_candidates:
        raise ValueError(
            "sharded cohort evaluation requires dedup_candidates == 0 "
            "(per-shard pools cannot detect global dedup overflow)"
        )
    axis, n_shards = mesh.axis_name, mesh.size
    eval_kw = dict(
        id_capacity=id_capacity,
        fanout=caps.fanout,
        pull_capacity=caps.pulls,
        matcher=matcher,
        dedup_candidates=caps.dedup_candidates,
        dynamic_patterns=True,
        probe_impl=make_routed_probe_batched(axis, n_shards),
        table_reduce=make_or_reduce(axis),
    )
    eval_d = make_side_evaluator(plan, out_capacity=caps.n_removed, **eval_kw)
    eval_a = make_side_evaluator(plan, out_capacity=caps.n_i, **eval_kw)

    def added_side_bits(my: int, i_spo, bank, lanes, active) -> torch.Tensor:
        """Block-split fused match + route over the I rows, block-gathered,
        stitched, then masked to the rows this shard owns."""
        n_i_cap = i_spo.shape[1]
        blk, starts = _blocks(n_i_cap, n_shards)
        a_loc = kops.pattern_lane_bits_batched(
            i_spo[:, starts[my]: starts[my] + blk], bank, lanes, active, matcher=matcher
        )
        a_full = _stitch(all_gather(a_loc, axis), n_i_cap, blk, starts, dim=1)
        own = (i_spo[:, :, 0] != PAD) & (i_spo[:, :, 0] % n_shards == my)
        return torch.where(own, a_full, torch.zeros_like(a_full))

    def merge_side(per_shard: List[SideResult], out_cap: int, pull_cap: int, home) -> SideResult:
        """One member's per-shard results back into canonical form."""

        def merge(field: str, cap: int):
            rows = torch.cat([getattr(r, field).spo.to(home) for r in per_shard])
            return from_array(rows, cap)

        inter, ovf_i = merge("interesting", out_cap)
        pot, ovf_q = merge("potential", out_cap)
        pulls, ovf_p = merge("pulls", pull_cap)
        overflow = torch.stack([r.overflow.to(home) for r in per_shard]).any() | ovf_i | ovf_q | ovf_p
        return SideResult(interesting=inter, potential=pot, pulls=pulls, overflow=overflow)

    def run(d_in, d_seg, a_sets, bank_dev, uniq_taus, uniq_tau_spo, uniq_tau_ops, rhos, st: CohortStatics):
        home = bank_dev.device
        ncp = len(st.active_host)
        live = [pos for pos in range(ncp) if st.active_host[pos]]
        # I_k = A_f(k) ∪ ρ_k (Def 14), replicated on every shard
        i_sets = {}
        spo_b = torch.full((ncp, caps.n_i, 3), PAD, dtype=torch.int32, device=home)
        for pos in live:
            i_sets[pos] = union(a_sets[st.f_host[pos]], rhos[pos], caps.n_i)
            spo_b[pos] = i_sets[pos][0].spo

        def shard(parts_spo, parts_ops):
            my = axis_index(axis)
            dev = mesh.devices[my]

            bank, lanes, active = _to_device((bank_dev, st.lanes, st.active), dev)
            f_map = _to_device(st.f_map, dev).long()
            if delta:
                # one segmented words pass over this shard's block of union rows
                rows = _to_device(d_in.spo, dev)
                cap = rows.shape[0]
                blk, starts = _blocks(cap, n_shards)
                sl = slice(starts[my], starts[my] + blk)
                w_loc = kops.pattern_bitmask_words_segmented(
                    rows[sl], bank, _to_device(d_seg, dev)[sl], n_frontiers, matcher=matcher
                )  # (F, blk, W)
                d_words = _stitch(all_gather(w_loc, axis), cap, blk, starts, dim=1)
                own = (rows[:, 0] != PAD) & (rows[:, 0] % n_shards == my)
                own_d = own[None].expand(ncp, cap)
                d_store = _to_device(d_in, dev)
            else:
                # one words pass over this shard's block of every frontier's D
                spo = torch.stack([_to_device(x.spo, dev) for x in d_in])
                nfp, cap = spo.shape[0], spo.shape[1]
                blk, starts = _blocks(cap, n_shards)
                d_loc = spo[:, starts[my]: starts[my] + blk]
                w_loc = kops.pattern_bitmask_words(d_loc.reshape(-1, 3), bank, matcher=matcher)
                d_words = _stitch(all_gather(w_loc.reshape(nfp, blk, -1), axis), cap, blk, starts, dim=1)
                d_mem = spo[f_map]
                own_d = (d_mem[:, :, 0] != PAD) & (d_mem[:, :, 0] % n_shards == my)
            d_bits = kops.lane_bits_batched(d_words[f_map], lanes, active, row_mask=own_d)
            a_bits = added_side_bits(my, _to_device(spo_b, dev), bank, lanes, active)

            tgts: Dict[int, TripleIndex] = {}
            out = {}
            for pos in live:
                t = st.tgt_host[pos]
                if t not in tgts:  # this shard's partitions of each replica read
                    s_rows, o_rows = _to_device(parts_spo[t], dev), _to_device(parts_ops[t], dev)
                    tgts[t] = TripleIndex(
                        spo=TripleStore(spo=s_rows, n=_count_valid(s_rows)),
                        ops=TripleStore(spo=o_rows, n=_count_valid(o_rows)),
                    )
                d_set = d_store if delta else _to_device(d_in[st.f_host[pos]], dev)
                pats = _to_device(st.pats[pos], dev)
                d_rows, d_pos_bits = _rows_with_bits(d_set, d_bits[pos])
                a_rows, a_pos_bits = _rows_with_bits(_to_device(i_sets[pos][0], dev), a_bits[pos])
                out[pos] = (
                    eval_d(d_rows, tgts[t], d_pos_bits, pats),
                    eval_a(a_rows, tgts[t], a_pos_bits, pats),
                )
            return out

        per_shard = run_spmd(
            mesh,
            shard,
            [tuple(p[i] for p in uniq_tau_spo) for i in range(n_shards)],
            [tuple(p[i] for p in uniq_tau_ops) for i in range(n_shards)],
        )
        tau1s: List[Optional[TripleStore]] = [None] * ncp
        rho1s: List[Optional[TripleStore]] = [None] * ncp
        outs: List[Optional[EvalOutputs]] = [None] * ncp
        for pos in live:
            d_res = merge_side([r[pos][0] for r in per_shard], caps.n_removed, caps.pulls, home)
            a_res = merge_side([r[pos][1] for r in per_shard], caps.n_i, caps.pulls, home)
            t = st.tgt_host[pos]
            tau1s[pos], rho1s[pos], outs[pos] = combine_side_results(
                d_res, a_res, uniq_taus[t], rhos[pos], caps, i_sets[pos][1]
            )
        return tuple(tau1s), tuple(rho1s), tuple(outs)

    if delta:

        def step_delta(d_union, d_seg, a_sets, bank_dev, uniq_taus, uniq_tau_spo, uniq_tau_ops, rhos, st):
            return run(d_union, d_seg, a_sets, bank_dev, uniq_taus, uniq_tau_spo, uniq_tau_ops, rhos, st)

        return step_delta

    def step(d_sets, a_sets, bank_dev, uniq_taus, uniq_tau_spo, uniq_tau_ops, rhos, st):
        return run(d_sets, None, a_sets, bank_dev, uniq_taus, uniq_tau_spo, uniq_tau_ops, rhos, st)

    return step


def _rows_with_bits(m: TripleStore, bits: torch.Tensor) -> Tuple[TripleStore, torch.Tensor]:
    """The rows of ``m`` whose routed bits are not all zero, in order, and
    their bits: the only rows that give a side evaluation candidates,
    signatures or outputs (at least one row, PAD if none has bits)."""
    keep = torch.nonzero(bits != 0).squeeze(1)
    if keep.numel() == 0:
        spo = torch.full((1, 3), PAD, dtype=torch.int32, device=bits.device)
        return TripleStore(spo=spo, n=_count_valid(spo)), torch.zeros_like(bits[:1])
    spo = m.spo[keep]
    return TripleStore(spo=spo, n=_count_valid(spo)), bits[keep]


def _seg_local_bits(seg: torch.Tensor, slots: Tuple[int, ...]) -> torch.Tensor:
    """Remap a frontier chain's membership bitmap from global frontier
    indices to a cohort's dense local slots: output bit ``l`` is input bit
    ``slots[l]`` (the sharded delta step's segmented pass reads local slots,
    which key ``f_map``)."""
    out = torch.zeros_like(seg)
    for l, fi in enumerate(slots):
        out = out | (((seg >> fi) & 1) << l)
    return out


_EMPTY_STORES: Dict[tuple, TripleStore] = {}


def _empty_cached(capacity: int, device) -> TripleStore:
    """Shared immutable empty store per (capacity, device): cohort padding."""
    key = (capacity, torch.device(device))
    store = _EMPTY_STORES.get(key)
    if store is None:
        store = _EMPTY_STORES.setdefault(key, empty(capacity, device))
    return store


_EMPTY_OUTPUTS: Dict[tuple, EvalOutputs] = {}


def _empty_outputs(caps: StepCapacities, device) -> EvalOutputs:
    """All-empty :class:`EvalOutputs` at one capacity family and device.

    A fired frontier whose composed changeset has no rows on either side
    propagates nothing; its subscribers get these, at the capacities a full
    evaluation would give (``r``/``r_i`` at ``n_removed``, ``r'`` at
    ``pulls``, ``a`` at ``n_i + pulls``, ``a_i`` at ``n_i``).
    """
    key = (caps, torch.device(device))
    out = _EMPTY_OUTPUTS.get(key)
    if out is None:
        out = _EMPTY_OUTPUTS.setdefault(
            key,
            EvalOutputs(
                r=_empty_cached(caps.n_removed, device),
                r_i=_empty_cached(caps.n_removed, device),
                r_prime=_empty_cached(caps.pulls, device),
                a=_empty_cached(caps.n_i + caps.pulls, device),
                a_i=_empty_cached(caps.n_i, device),
                overflow=torch.zeros((), dtype=torch.bool, device=device),
            ),
        )
    return out


def _padded_bank_dev(patterns: np.ndarray, device) -> torch.Tensor:
    """The bank padded to a power-of-two (>= 32) row count with all-PAD rows,
    which never match a valid triple."""
    n_pad = max(32, next_pow2(patterns.shape[0]))
    out = np.full((n_pad, 3), PAD, np.int32)
    out[: patterns.shape[0]] = patterns
    return torch.as_tensor(out, device=device)


def make_broker_step(
    bank: PatternBank,
    plans: Sequence[CompiledInterest],
    caps_list: Sequence[StepCapacities],
    id_capacities: Sequence[int],
    matcher: Optional[Callable] = None,
    device=None,
) -> Callable:
    """(D, A, (τ_k,), (ρ_k,)) -> ((τ'_k,), (ρ'_k,), (out_k,)) for a frozen
    subscriber set: one words pass over D, then one cohort step per shape.

    For one-shot uses and tests; :class:`Broker` manages the same cohort
    steps through its caches. ``device`` defaults to the CUDA card.
    """
    device = resolve_device(device)
    n_subs = len(plans)
    if not n_subs == len(caps_list) == len(id_capacities) == len(bank.lanes):
        raise ValueError("one plan, capacity set, id capacity and lane map per subscriber")
    bank_dev = _padded_bank_dev(np.asarray(bank.patterns, np.int32), device)

    groups: Dict[tuple, List[int]] = {}
    for k, (plan, caps, id_cap) in enumerate(zip(plans, caps_list, id_capacities)):
        groups.setdefault((_plan_shape_key(plan), caps, id_cap), []).append(k)
    cohorts = [
        (tuple(idxs), plans[idxs[0]], caps_list[idxs[0]], id_capacities[idxs[0]])
        for idxs in groups.values()
    ]
    steps = [make_cohort_step(plan, caps, id_cap, matcher=matcher) for _, plan, caps, id_cap in cohorts]
    # membership is frozen: no shared replicas, one frontier slot
    statics = [
        _assemble_cohort_statics(
            [plans[k].patterns for k in idxs],
            [bank.lanes[k] for k in idxs],
            list(range(len(idxs))),
            [0] * len(idxs),
            next_pow2(len(idxs)),
            plan.n_total,
            bank_dev.shape[0],
            device,
        )
        for idxs, plan, _, _ in cohorts
    ]

    def step(d_set: TripleStore, a_set: TripleStore, taus, rhos):
        d_words = kops.pattern_bitmask_words(d_set.spo, bank_dev, matcher=matcher)
        tau1s: List[Optional[TripleStore]] = [None] * n_subs
        rho1s: List[Optional[TripleStore]] = [None] * n_subs
        outs: List[Optional[EvalOutputs]] = [None] * n_subs
        for (idxs, _, caps, _), fn, st in zip(cohorts, steps, statics):
            nm = len(idxs)
            ncp = next_pow2(nm)
            taus_c = tuple(taus[k] for k in idxs) + (_empty_cached(caps.tau, device),) * (ncp - nm)
            rhos_c = tuple(rhos[k] for k in idxs) + (_empty_cached(caps.rho, device),) * (ncp - nm)
            tau1_c, rho1_c, out_c = fn((d_set,), (d_words,), (a_set,), bank_dev, taus_c, rhos_c, st)
            for pos, k in enumerate(idxs):
                tau1s[k], rho1s[k], outs[k] = tau1_c[pos], rho1_c[pos], out_c[pos]
        return tuple(tau1s), tuple(rho1s), tuple(outs)

    return step


# ---------------------------------------------------------------------------
# host-side state
# ---------------------------------------------------------------------------

class BrokerSubscription:
    """One registered interest inside the broker: plan, caps, policy, τ, ρ."""

    _serial_counter = itertools.count()

    def __init__(
        self,
        expr: InterestExpr,
        dictionary: Dictionary,
        caps: StepCapacities,
        device: torch.device,
        policy: PushPolicy | None = None,
    ):
        self.expr = expr
        self.dictionary = dictionary
        self.caps = caps
        self.device = device
        self.policy = policy if policy is not None else PushPolicy()
        # monotonic identity for cache keys (unlike id(), never reused);
        # plan_version tracks recompiles the same way
        self.serial = next(BrokerSubscription._serial_counter)
        self.plan_version = 0
        self.plan = compile_interest(expr, dictionary)
        self.shape_key = _plan_shape_key(self.plan)  # cohort key, cached
        self.id_capacity = dictionary.id_capacity * caps.id_headroom
        self.tau = empty(caps.tau, device)
        self.rho = empty(caps.rho, device)
        # bumped on every τ assignment; keys the broker's τ-partition cache,
        # so only replicas whose τ changed are partitioned again
        self.tau_version = 0
        self.lanes: Tuple[int, ...] = ()  # bank lane map (broker-managed)
        self.since = 1  # first unconsumed changeset id (broker-managed)
        self.last_push_t = time.perf_counter()
        # shared-τ lineage: subscriptions attached to one replica share
        # `share_tag`; `epoch` names the consumption history, so two of them
        # share a build_index(τ) exactly when their replica state is equal
        self.share_tag: object = self
        self.epoch: int = 0
        # lane-group signature (canonical key, caps, policy): the broker's
        # index of exact canonical duplicates; None with the lattice off
        self.canon_sig: Optional[tuple] = None
        # durable identity: assigned by the broker, journaled, the same after
        # recovery (unlike `serial`, which is process-local)
        self.jid: int = -1
        # the subscriber's own delivery callback (overrides the channel's);
        # not journaled: re-attach it after recover()
        self.transport: Optional[Callable] = None

    def recompile(self, caps: StepCapacities | None = None) -> None:
        """Refresh plan and capacities after dictionary or capacity growth."""
        if caps is not None:
            self.caps = caps
        self.plan_version += 1
        self.plan = compile_interest(self.expr, self.dictionary)
        self.shape_key = _plan_shape_key(self.plan)
        self.id_capacity = self.dictionary.id_capacity * self.caps.id_headroom
        # on the device τ/ρ live on (a placed cohort's)
        self.tau, _ = union(empty(self.caps.tau, self.tau.device), self.tau, self.caps.tau)
        self.rho, _ = union(empty(self.caps.rho, self.rho.device), self.rho, self.caps.rho)
        self.tau_version += 1

    def init_target(self, triples: np.ndarray) -> bool:
        """Load the initial RDFSlice-style subset into τ. True if caps grew."""
        rows = torch.as_tensor(np.asarray(triples, np.int32).reshape(-1, 3), device=self.device)
        grew = False
        while True:
            store, overflow = from_array(rows, self.caps.tau)
            if not bool(overflow):
                self.tau = store
                self.tau_version += 1
                return grew
            self.recompile(self.caps.doubled())
            grew = True


@dataclasses.dataclass
class BrokerStats:
    """Per-call accounting of the broker's pass (all evaluated subscribers)."""

    changeset_id: int
    n_subscribers: int
    n_lanes: int  # allocated bank lanes (incl. tombstones)
    n_lanes_raw: int  # sum of per-interest pattern counts
    total_removed: int
    total_added: int
    interesting_removed: int  # Σ_k |r_k| over evaluated subscribers
    interesting_added: int  # Σ_k |a_k| over evaluated subscribers
    elapsed_s: float  # wall time incl. rejit_s
    rejit_s: float = 0.0  # step build time
    n_evaluated: int = 0  # subscribers whose policy fired
    n_deferred: int = 0  # subscribers whose batch kept accumulating
    n_cohort_passes: int = 0  # cohort steps invoked
    batch_grows: int = 0  # cumulative ChangesetBatch pow2 doublings
    batch_shrinks: int = 0  # cumulative ChangesetBatch decay re-homes
    # D-side bank-match volume this call: rows run through the words pass
    # vs the distinct rows across the fired frontiers (the stacked pass
    # re-matches rows shared by frontiers, the delta chain matches each
    # once); counts repeat on overflow re-runs
    rows_matched: int = 0
    rows_distinct: int = 0
    # cohort slots evaluated vs subscriber deliveries fanned out from them
    # (equal with the lattice off: one slot per subscriber); counts repeat
    # on overflow re-runs
    distinct_interests: int = 0
    fanout_copies: int = 0
    seq: int = 0  # unified sequence clock after this call
    # fires that went through the per-interest step after the bounded
    # overflow re-runs
    degraded_fires: int = 0


@dataclasses.dataclass
class _FrontierInput:
    """One fired consumption frontier, whatever its residency.

    ``d_store`` / ``a_store`` give the composed (D, A) at a requested
    capacity; ``d_rows`` / ``a_rows`` bound their valid rows for the
    capacity guards; ``since`` is the frontier's first changeset id (the
    delta chain's union is the oldest fired frontier's D); ``d_native``
    gives the composed D at the batch's own capacity for the chain's
    membership probes (None on the host round-trip path, which never
    chains).
    """

    idxs: List[int]
    d_rows: int
    a_rows: int
    d_store: Callable[[int], TripleStore]
    a_store: Callable[[int], TripleStore]
    since: int = 0
    d_native: Optional[Callable[[], TripleStore]] = None


def _stores_equal(a: TripleStore, b: TripleStore) -> bool:
    """Equality of two canonical stores' valid rows, whatever their capacity."""
    if a is b:
        return True
    na, nb = int(a.n), int(b.n)
    if na != nb:
        return False
    if na == 0:
        return True
    return bool(np.array_equal(to_numpy(a), to_numpy(b)))


def _as_rows(arr) -> np.ndarray:
    """A changeset side as int32 (N, 3); empty input gives (0, 3)."""
    out = np.asarray(arr, dtype=np.int32)
    if out.size == 0:
        return np.zeros((0, 3), np.int32)
    if out.ndim != 2 or out.shape[1] != 3:
        raise ValueError(f"expected (N, 3) triples, got {out.shape}")
    return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(x, device: torch.device):
    """Stores, tensors and tuples of them on ``device`` (a no-op where they are)."""
    if isinstance(x, TripleStore):
        return TripleStore(spo=x.spo.to(device), n=x.n.to(device))
    if isinstance(x, tuple):
        return tuple(_to_device(y, device) for y in x)
    return x.to(device)


class Broker:
    """Host orchestrator running every registered interest through shared passes.

    The many-subscriber counterpart of
    :class:`~repro_torch.core.propagation.IrapEngine`: ``subscribe``
    registers an interest and ``process_changeset`` evaluates every subscriber
    whose :class:`PushPolicy` fires, through cached cohort steps.

    ``device`` defaults to the CUDA card; ``device="cpu"`` runs the plain
    PyTorch versions of the kernels on the CPU. ``subsume_interests=False``
    turns the subsumption lattice off (raw expressions, ``share_target``
    only, one cohort slot per subscriber, no virtual lanes), and
    ``delta_frontiers=False`` the delta frontier chain (one stacked words
    pass over every fired frontier's D). ``matcher`` (the
    ``ops.pattern_bitmask`` signature) is a testing hook that produces the
    bank words one 32-lane word at a time. ``cache_executables=False``
    drops every built step at each membership change.
    ``deferred_device_resident=False`` pulls each fired batch to the host and
    uploads it again, one pass per frontier. ``decay_patience`` is the
    number of under-filled drain checks before a pending batch shrinks, and
    ``max_fire_retries`` bounds the overflow re-runs of one fire.
    ``journal`` (a :class:`~repro_torch.core.journal.ChangesetJournal`) and
    ``channel`` (a :class:`~repro_torch.core.delivery.DeliveryChannel`) turn
    on the durability layer (module docstring, layer 5).

    ``mesh`` (a :class:`~repro_torch.core.distributed.DeviceMesh`) turns on
    multi-device evaluation (module docstring, layer 6): cohorts placed on
    mesh devices by ``placement`` (default round robin), or with
    ``shard_cohorts=True`` every cohort pass spread over the whole mesh.
    ``device`` then defaults to the mesh's first device and must be of the
    mesh's type. ``device_passes`` counts the cohort passes per mesh device
    index.
    """

    def __init__(
        self,
        dictionary: Dictionary | None = None,
        matcher: Optional[Callable] = None,
        cache_executables: bool = True,
        deferred_device_resident: bool = True,
        delta_frontiers: bool = True,
        subsume_interests: bool = True,
        mesh: DeviceMesh | None = None,
        placement: CohortPlacement | None = None,
        shard_cohorts: bool = False,
        decay_patience: int = 2,
        journal: ChangesetJournal | None = None,
        channel: DeliveryChannel | None = None,
        max_fire_retries: int = 8,
        device=None,
    ):
        # `dictionary or Dictionary()` would discard an *empty* dictionary
        self.dictionary = dictionary if dictionary is not None else Dictionary()
        self.mesh = mesh
        self.shard_cohorts = shard_cohorts
        if mesh is not None:
            self._n_shards = mesh.size
            self._devices = list(mesh.devices)
            if device is None:
                device = mesh.devices[0]
        else:
            self._n_shards = 1
            self._devices = []
        self.device = resolve_device(device)
        if any(d.type != self.device.type for d in self._devices):
            raise ValueError(f"the broker's device {self.device} and the mesh's {self._devices} differ in type")
        self.placement = placement if placement is not None else CohortPlacement()
        self.device_passes: Dict[int, int] = {}  # device index -> cohort passes
        # τ partitions per (sub serial, τ version, cap, n_shards); the all-PAD
        # block of padding slots; the bank per (version, device index)
        self._tau_parts_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._empty_parts_cache: Dict[tuple, torch.Tensor] = {}
        self._bank_dev_for: Dict[tuple, torch.Tensor] = {}
        self.matcher = matcher
        self.subs: List[BrokerSubscription] = []
        self.stats: List[BrokerStats] = []
        self.subsume_interests = subsume_interests
        self.bank = self._new_bank()
        # lane-group signature -> the group's root (auto-join index)
        self._share_index: Dict[tuple, BrokerSubscription] = {}
        self.cache_executables = cache_executables
        self.deferred_device_resident = deferred_device_resident
        self.delta_frontiers = delta_frontiers
        self.decay_patience = decay_patience
        self.max_fire_retries = max_fire_retries
        self.batch_grows = 0  # ChangesetBatch pow2 doublings (cumulative)
        self.batch_shrinks = 0  # ChangesetBatch decay re-homes (cumulative)
        # cumulative D-side match volume and cohort slots vs deliveries
        self.rows_matched = 0
        self.rows_distinct = 0
        self._rows_matched_acc = 0
        self._rows_distinct_acc = 0
        self.distinct_interests = 0
        self.fanout_copies = 0
        self._distinct_acc = 0
        self._fanout_acc = 0
        self._lanes_raw = 0  # Σ plan.n_total over live subscriptions
        self._grow_seen: Dict[int, int] = {}  # frontier id -> folded grows
        # LRU-bounded: superseded keys fall out; evicting a live key only
        # costs a rebuild
        self._exec_cache: "OrderedDict[tuple, Callable]" = OrderedDict()
        self.exec_cache_max = 128
        # membership-static cohort inputs per (cohort, membership signature)
        self._static_arrays_cache: "OrderedDict[tuple, CohortStatics]" = OrderedDict()
        # exact consumption-history interning: (epoch, first, last) -> epoch,
        # so equal histories (and only those) share an epoch; ids are
        # monotonic and unreachable entries are pruned past a size threshold
        self._epoch_intern: Dict[tuple, int] = {}
        self._epoch_next = 0
        self.epoch_intern_max = 4096
        self._bank_dev: torch.Tensor | None = None
        # the real rows only, padded, and the (parents, residual) refine
        # operands, for the deleted-side words pass (the whole bank and None
        # without virtual lanes); refreshed with _bank_dev
        self._bank_real_dev: torch.Tensor | None = None
        self._refine_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._bank_version = -1
        self._batches: Dict[int, ChangesetBatch] = {}
        # the unified sequence clock: subscribe, unsubscribe, ingest and a
        # committed fire each consume one tick, with or without a journal,
        # so journal-on and journal-off brokers assign the same ids
        self.journal = journal
        self.channel = channel
        self._seq = journal.last_seq if journal is not None else 0
        self._last_cid = 0  # seq of the last ingested changeset
        self._jid_next = 0  # durable subscriber ids (journaled)
        self._last_snapshot_seq = 0
        self._snapshot_keep_from = 1  # compaction floor (advanced by snapshot)
        self._replaying = False  # recovery replay: no journal, no delivery
        self.degraded_fires = 0  # cumulative per-interest fallback fires
        self._degraded_acc = 0
        self._rejit_acc = 0.0
        self.rejit_count = 0  # step builds (cohort + words + per-interest)
        self.cohort_compiles: Dict[tuple, int] = {}  # per cohort key
        self.words_compiles = 0  # shared D-side words-pass builds

    # -- interest manager ---------------------------------------------------

    def _new_bank(self):
        return SubsumptionBank() if self.subsume_interests else IncrementalPatternBank()

    def subscribe(
        self,
        expr: InterestExpr,
        caps: StepCapacities = StepCapacities(),
        initial_target: np.ndarray | None = None,
        policy: PushPolicy | None = None,
        share_target: bool = False,
        transport: Optional[Callable] = None,
        _jid: int | None = None,
    ) -> BrokerSubscription:
        """Register an interest; only its own cohort will be rebuilt.

        With the lattice on, the expression is replaced by its canonical
        form before it compiles, and the subscription joins an existing lane
        group when its canonical interest, capacities, policy, frontier and
        τ/ρ are all equal to the group root's (the join skips only
        evaluations that would give equal results).

        ``share_target=True`` adopts an existing identical subscription's
        current τ/ρ state and frontier (the many-readers-of-one-replica
        case); without a compatible one the subscription is independent.

        ``transport`` is the subscriber's own delivery callback (it overrides
        the channel's). With a journal, the call's arguments are journaled
        before any state changes, so that replay lands on the same state.
        """
        if self.shard_cohorts and caps.dedup_candidates:
            raise ValueError(
                "shard_cohorts=True requires caps.dedup_candidates == 0 (see make_sharded_cohort_step)"
            )
        jid = self._jid_next if _jid is None else _jid
        self._seq += 1
        if self.journal is not None and not self._replaying:
            arrays = {}
            if initial_target is not None and np.asarray(initial_target).size:
                arrays["initial_target"] = np.asarray(initial_target, np.int32)
            self.journal.append(
                "subscribe",
                meta={
                    "jid": jid,
                    "expr": _expr_to_json(expr),
                    "caps": _caps_to_json(caps),
                    "policy": _policy_to_json(policy),
                    "share_target": bool(share_target),
                },
                arrays=arrays,
                seq=self._seq,
            )
        self._jid_next = max(self._jid_next, jid + 1)
        canon_key = None
        if self.subsume_interests:
            expr, canon_key = canonicalize_expr(expr)
        sub = BrokerSubscription(expr, self.dictionary, caps, self.device, policy=policy)
        sub.jid = jid
        sub.transport = transport
        sub.since = self._seq + 1
        root = self._find_share_root(sub) if share_target else None
        if root is not None:
            sub.tau, sub.rho = root.tau, root.rho
            sub.share_tag, sub.epoch = root.share_tag, root.epoch
            sub.since, sub.last_push_t = root.since, root.last_push_t
        elif initial_target is not None and initial_target.size:
            sub.init_target(initial_target)
        if canon_key is not None:
            # read after init_target, which may have doubled the capacities
            sub.canon_sig = (canon_key, sub.caps, sub.policy)
            if root is None:
                auto = self._auto_join_root(sub)
                if auto is not None:
                    sub.tau, sub.rho = auto.tau, auto.rho
                    sub.share_tag, sub.epoch = auto.share_tag, auto.epoch
            self._share_index.setdefault(sub.canon_sig, sub)
        sub.lanes = self.bank.add_plan(sub.plan)
        self.subs.append(sub)
        self._lanes_raw += sub.plan.n_total
        if not self.cache_executables:
            self._exec_cache.clear()
        return sub

    def _auto_join_root(self, sub: BrokerSubscription) -> BrokerSubscription | None:
        """The lane-group root ``sub`` may join: same signature (canonical
        interest, capacities, policy), frontier and τ/ρ; anything less keeps
        it independent, a missed collapse and never a wrong one."""
        root = self._share_index.get(sub.canon_sig)
        if (
            root is None
            or root.caps != sub.caps  # the root may have outgrown the signature
            or not self._frontier_equal(root.since, sub.since)
            or not _stores_equal(root.tau, sub.tau)
            or not _stores_equal(root.rho, sub.rho)
        ):
            return None
        return root

    def _frontier_equal(self, a: int, b: int) -> bool:
        """Do two consumption frontiers name the same pending suffix? Equal
        ones do, and so do two past the last ingested changeset: both
        suffixes are empty (the next ingest re-keys them onto its id)."""
        return a == b or min(a, b) > self._last_cid

    def _find_share_root(self, sub: BrokerSubscription) -> BrokerSubscription | None:
        for s in self.subs:
            if (
                s.expr == sub.expr
                and s.caps == sub.caps
                and s.policy == sub.policy
                and np.array_equal(s.plan.patterns, sub.plan.patterns)
            ):
                return s
        return None

    def unsubscribe(self, sub: BrokerSubscription) -> None:
        """Remove one subscription; unrelated cohorts keep their steps."""
        self._seq += 1
        if self.journal is not None and not self._replaying:
            self.journal.append("unsubscribe", meta={"jid": sub.jid}, seq=self._seq)
        if self.channel is not None:
            self.channel.forget(sub)
        self.subs.remove(sub)
        self.bank.remove_plan(sub.lanes)
        sub.lanes = ()
        self._lanes_raw -= sub.plan.n_total
        sig = sub.canon_sig
        if sig is not None and self._share_index.get(sig) is sub:
            # another member of the lane group, if any, becomes the root
            repl = next((s for s in self.subs if s.canon_sig == sig), None)
            if repl is None:
                del self._share_index[sig]
            else:
                self._share_index[sig] = repl
        if not self.subs:
            # no lane map references the bank: start the next one fresh
            self.bank = self._new_bank()
            self._bank_version = -1
            self._batches.clear()
        else:
            remap = self.bank.maybe_compact()
            if remap is not None:
                for s in self.subs:
                    s.lanes = tuple(remap[lane] for lane in s.lanes)
            self._sweep_batches(drained=False)
        if not self.cache_executables:
            self._exec_cache.clear()

    # -- step cache ---------------------------------------------------------

    def _ensure_bank_dev(self, dev: int | None = None) -> torch.Tensor:
        """The padded device bank; with ``dev``, its copy on mesh device
        ``dev`` (one per bank version and device)."""
        if self._bank_dev is None or self._bank_version != self.bank.version:
            self._bank_dev = torch.as_tensor(self.bank.patterns_padded(), device=self.device)
            self._bank_real_dev = self._bank_dev
            self._refine_dev = None
            if isinstance(self.bank, SubsumptionBank):
                ra = self.bank.refine_arrays()
                if ra is not None:
                    self._bank_real_dev = torch.as_tensor(self.bank.real_padded(), device=self.device)
                    self._refine_dev = (torch.as_tensor(ra[0], device=self.device),
                                        torch.as_tensor(ra[1], device=self.device))
            self._bank_version = self.bank.version
            self._bank_dev_for.clear()
        if dev is None:
            return self._bank_dev
        key = (self._bank_version, dev)
        placed = self._bank_dev_for.get(key)
        if placed is None:
            placed = self._bank_dev_for.setdefault(key, self._bank_dev.to(self._devices[dev]))
        return placed

    def _tau_partitions(self, sub: BrokerSubscription, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hash-partitioned (SPO, OPS) shards of one subscription's τ,
        int32[n_shards, c, 3] each, made on the device.

        Cached per (subscription serial, τ version, capacity, mesh size):
        churn and fires of other subscriptions leave the key alone, so only
        replicas whose τ changed (or whose capacity grew) are partitioned
        again. A τ version only grows, so a new version evicts its
        subscription's older ones. The reference gives every shard the
        replica's capacity ``cap``, so that a partition never overflows; on
        one card that is ``n_shards`` replicas' memory. Here ``c`` is the
        least power of two that holds the fullest shard (at most ``cap``):
        no partition overflows either, and a probe's answer does not depend
        on the PAD rows after a partition's last row.
        """
        key = (sub.serial, sub.tau_version, cap, self._n_shards)
        hit = self._tau_parts_cache.get(key)
        if hit is not None:
            self._tau_parts_cache.move_to_end(key)
            return hit
        for old in [k for k in self._tau_parts_cache if k[0] == sub.serial]:
            del self._tau_parts_cache[old]
        rows = sub.tau.spo[sub.tau.spo[:, 0] != PAD]
        per_shard = torch.stack([torch.bincount(rows[:, col] % self._n_shards, minlength=self._n_shards)
                                 for col in (0, 2)])  # by subject (SPO), by object (OPS)
        fullest = max(int(per_shard.max()), 1)
        spo, ops, _ = shard_target_store(sub.tau, self._n_shards, min(cap, next_pow2(fullest)))
        parts = (spo, ops)
        self._tau_parts_cache[key] = parts
        while len(self._tau_parts_cache) > self.exec_cache_max:
            self._tau_parts_cache.popitem(last=False)
        return parts

    def _empty_parts(self, cap: int) -> torch.Tensor:
        """All-PAD τ partition block for padded unique-target slots."""
        key = (cap, self._n_shards)
        block = self._empty_parts_cache.get(key)
        if block is None:
            block = self._empty_parts_cache.setdefault(
                key, torch.full((self._n_shards, cap, 3), PAD, dtype=torch.int32, device=self.device)
            )
        return block

    def _build_exec(self, key: tuple, builder: Callable) -> Callable:
        """Fetch or build one step; build time goes to ``rejit_s``."""
        fn = self._exec_cache.get(key)
        if fn is not None:
            self._exec_cache.move_to_end(key)
            return fn
        t0 = time.perf_counter()
        fn = builder()
        self._exec_cache[key] = fn
        while len(self._exec_cache) > self.exec_cache_max:
            self._exec_cache.popitem(last=False)
        self._rejit_acc += time.perf_counter() - t0
        self.rejit_count += 1
        return fn

    def _words_step(self, nfp: int, cap: int, segmented: bool) -> Callable:
        """The deleted-side pass, int32[nfp, cap, W]: frontier ``f``'s bank
        words over ``cap`` rows.

        Stacked (``segmented=False``): ``rows`` are ``nfp`` D stores' rows,
        flattened into one words launch. Segmented: ``rows`` is the chain's
        union, matched once, and ``seg`` its membership bitmap. With
        ``refine`` (parents, residual) the pass runs over the real bank rows
        and the virtual words of every frontier follow from one lane-refine
        launch, after the real words: the extended bank's layout."""

        def words(rows, seg: Optional[torch.Tensor], bank: torch.Tensor, refine) -> torch.Tensor:
            if segmented:
                w = kops.pattern_bitmask_words_segmented(rows, bank, seg, nfp, matcher=self.matcher)
            else:
                rows = torch.stack(list(rows))
                w = kops.pattern_bitmask_words(rows.reshape(-1, 3), bank, matcher=self.matcher)
                w = w.reshape(nfp, cap, -1)
            if refine is None:
                return w
            # a row outside frontier f has zero real bits in plane f, so its
            # virtual bits are zero too: the planes keep their masks
            return torch.cat([w, kops.lane_refine(rows, w, *refine)], dim=-1)

        return words

    # -- changeset manager + scheduler --------------------------------------

    def process_changeset(self, removed: np.ndarray, added: np.ndarray) -> List[Optional[EvalOutputs]]:
        """Ingest one changeset; evaluate every subscriber whose policy fires.

        Returns one entry per subscriber, in subscription order: the
        :class:`EvalOutputs` of its (possibly batched) evaluation, or None
        when its policy deferred it. A fired frontier whose composed batch
        is empty on both sides gets empty outputs without any pass. With a
        channel, due retries are pumped first, and a subscriber that is
        quarantined or backing off does not fire.
        """
        removed, added = _as_rows(removed), _as_rows(added)
        if self.channel is not None and not self._replaying:
            self._service_channel()
        self._seq += 1
        cid = self._seq
        if self.journal is not None and not self._replaying:
            # write-ahead: the changeset is durable before any batch sees it
            self.journal.append("ingest", arrays={"removed": removed, "added": added}, seq=cid)
        if not self.subs:
            self._last_cid = cid
            return []
        t0 = time.perf_counter()
        self._reset_call_accounting()
        self._apply_ingest(removed, added, cid)
        now = time.perf_counter()
        fired = []
        for k, s in enumerate(self.subs):
            batch = self._batches.get(s.since)
            if batch is not None and s.policy.fires(batch.n_changesets, now - s.last_push_t):
                if self.channel is not None and not self.channel.eligible(s):
                    continue  # quarantined or backing off: the frontier pins
                fired.append(k)
        results, n_passes = self._fire(fired)
        self._sweep_batches(drained=bool(fired))
        self._record_stats(cid, removed, added, results, fired, n_passes, t0)
        return results

    def _reset_call_accounting(self) -> None:
        self._rejit_acc = 0.0
        self._rows_matched_acc = self._rows_distinct_acc = 0
        self._distinct_acc = self._fanout_acc = 0
        self._degraded_acc = 0

    def _apply_ingest(self, removed: np.ndarray, added: np.ndarray, cid: int) -> None:
        """Accumulate one changeset into every pending frontier.

        A frontier pointing at a tick that was no changeset (a fresh
        subscription, or a drained subscriber) has an empty pending suffix,
        so it re-keys onto the first changeset that arrives.
        """
        for batch in self._batches.values():
            batch.extend(removed, added, cid)
        waiting = [s for s in self.subs if s.since not in self._batches and s.since <= cid]
        if waiting:
            self._batches[cid] = ChangesetBatch.fresh(removed, added, cid, self.device)
            for s in waiting:
                s.since = cid
        self._last_cid = cid

    def _service_channel(self) -> None:
        """Pump due delivery retries; block (on the channel's clock) while
        the retry queue is full. Each pumped retry either acks or moves its
        subscriber toward quarantine, so the loop ends."""
        ch = self.channel
        due = [s for s in self.subs if ch.retry_due(s)]
        if due:
            self.flush(due)
        if ch.max_in_flight is None:
            return
        while ch.in_flight() >= ch.max_in_flight:
            ch.wait_for_retry()
            due = [s for s in self.subs if ch.retry_due(s)]
            if not due:
                break
            self.flush(due)

    def flush(self, subs: Sequence[BrokerSubscription] | None = None) -> List[Optional[EvalOutputs]]:
        """Drain pending batches now, regardless of policy.

        Evaluates every given subscription (default: all) with at least one
        pending changeset; returns one entry per subscriber in subscription
        order (None where nothing was pending). Handles of unsubscribed
        subscriptions are skipped.
        """
        if subs is None:
            targets = list(range(len(self.subs)))
        else:
            wanted = {id(s) for s in subs}
            targets = [k for k, s in enumerate(self.subs) if id(s) in wanted]
        t0 = time.perf_counter()
        self._reset_call_accounting()
        fired = [k for k in targets if self.subs[k].since in self._batches]
        if self.channel is not None and not self._replaying:
            fired = [k for k in fired if self.channel.eligible(self.subs[k])]
        results, n_passes = self._fire(fired)
        self._sweep_batches(drained=bool(fired))
        if fired:
            z = np.zeros((0, 3), np.int32)
            self._record_stats(self._seq, z, z, results, fired, n_passes, t0)
        return results

    def _fire(self, fired: List[int]) -> Tuple[List[Optional[EvalOutputs]], int]:
        results: List[Optional[EvalOutputs]] = [None] * len(self.subs)
        if not fired:
            return results, 0
        groups: Dict[int, List[int]] = {}
        for k in fired:
            groups.setdefault(self.subs[k].since, []).append(k)

        def group_order(since: int):
            # priority lanes drain first, then the oldest frontier
            has_priority = any(self.subs[k].policy.priority for k in groups[since])
            return (not has_priority, since)

        ordered = sorted(groups, key=group_order)
        # a composed batch without rows delivers nothing: no pass, empty
        # outputs, τ/ρ untouched
        outs: Dict[int, EvalOutputs] = {}
        fronts = []
        for since in ordered:
            batch = self._batches[since]
            d_rows, a_rows = batch.row_bounds()
            if d_rows == 0 and a_rows == 0:
                for k in groups[since]:
                    outs[k] = _empty_outputs(self.subs[k].caps, self.device)
                continue
            fronts.append(self._frontier_input(groups[since], batch))
        staged: Dict[int, Tuple[TripleStore, TripleStore]] = {}
        if not fronts:
            n_passes = 0
        elif self.deferred_device_resident:
            # every fired frontier in one evaluation
            outs_f, staged, n_passes = self._evaluate_frontiers(fronts)
            outs.update(outs_f)
        else:
            n_passes = 0
            for fr in fronts:
                outs_f, staged_f, passes = self._evaluate_frontiers([fr])
                outs.update(outs_f)
                staged.update(staged_f)
                n_passes += passes
        # the delivery gate: outputs go to the channel before any state
        # commits, so a failed delivery needs no rollback: the subscriber's
        # τ/ρ stay, its frontier pins and its batch keeps composing. Without a
        # channel, and in replay, every fired subscriber acks.
        deliver = self.channel is not None and not self._replaying
        acked: List[int] = []
        for since in ordered:
            for k in groups[since]:
                if not deliver or self.channel.deliver(self.subs[k], outs[k]):
                    acked.append(k)
        if acked:
            # the commit point consumes one tick; the journal records exactly
            # the acked frontier advances (a crash before this append fires
            # again, one after it replays without delivering)
            self._seq += 1
            if self.journal is not None and not self._replaying:
                fires = [[self.subs[k].jid, self._batches[self.subs[k].since].last_id + 1] for k in acked]
                self.journal.append("fire", meta={"fires": fires}, seq=self._seq)
        acked_set = set(acked)
        self._commit_staged({k: staged[k] for k in acked if k in staged})
        now = time.perf_counter()
        tag_refs: Dict[int, int] = {}
        for s in self.subs:
            tag_refs[id(s.share_tag)] = tag_refs.get(id(s.share_tag), 0) + 1
        for since in ordered:
            batch = self._batches[since]
            for k in groups[since]:
                if k not in acked_set:
                    continue
                results[k] = outs[k]
                s = self.subs[k]
                s.since = batch.last_id + 1
                s.last_push_t = now
                if tag_refs[id(s.share_tag)] > 1:
                    hist = (s.epoch, batch.first_id, batch.last_id)
                    epoch = self._epoch_intern.get(hist)
                    if epoch is None:
                        self._epoch_next += 1
                        epoch = self._epoch_intern[hist] = self._epoch_next
                    s.epoch = epoch
        if len(self._epoch_intern) > self.epoch_intern_max:
            # entries whose parent epoch no subscriber holds are unreachable
            held = {s.epoch for s in self.subs}
            self._epoch_intern = {h: e for h, e in self._epoch_intern.items() if h[0] in held}
        return results, n_passes

    def _frontier_input(self, idxs: List[int], batch: ChangesetBatch) -> _FrontierInput:
        """One fired frontier as evaluator input: the batch's sorted device
        stores re-homed (a slice or pad, no sort, no transfer), or with
        ``deferred_device_resident=False`` its host arrays uploaded again."""
        if self.deferred_device_resident:
            d_rows, a_rows = batch.row_bounds()
            return _FrontierInput(
                idxs=idxs,
                d_rows=d_rows,
                a_rows=a_rows,
                d_store=lambda cap: rehome(batch.device_stores()[0], cap),
                a_store=lambda cap: rehome(batch.device_stores()[1], cap),
                since=batch.first_id,
                d_native=lambda: batch.device_stores()[0],
            )
        d_np, a_np = batch.arrays()

        def upload(rows: np.ndarray, cap: int) -> TripleStore:
            return from_array(torch.as_tensor(rows.reshape(-1, 3), device=self.device), cap)[0]

        return _FrontierInput(
            idxs=idxs,
            d_rows=int(d_np.shape[0]),
            a_rows=int(a_np.shape[0]),
            d_store=lambda cap: upload(d_np, cap),
            a_store=lambda cap: upload(a_np, cap),
            since=batch.first_id,
        )

    def _sweep_batches(self, drained: bool) -> None:
        """Fold batch growth into the totals, drop batches no subscriber
        references, and (only when this call drained something) let the
        surviving batches decay."""
        for since, b in self._batches.items():
            seen = self._grow_seen.get(since, 0)
            if b.grow_count > seen:
                self.batch_grows += b.grow_count - seen
                self._grow_seen[since] = b.grow_count
        live = {s.since for s in self.subs}
        self._batches = {since: b for since, b in self._batches.items() if since in live}
        self._grow_seen = {since: g for since, g in self._grow_seen.items() if since in self._batches}
        if drained:
            for b in self._batches.values():
                if b.maybe_decay(self.decay_patience):
                    self.batch_shrinks += 1

    # -- evaluator ----------------------------------------------------------

    def _static_arrays(
        self,
        ckey: tuple,
        fk: List[Tuple[int, int]],
        f_list: List[int],
        upos: Dict[int, int],
        ncp: int,
        nt: int,
        bank_rows: int,
        device=None,
    ) -> CohortStatics:
        """Membership-static inputs of one cohort pass, on ``device`` (default
        the broker's), cached under the full membership signature (members,
        plan versions, replica grouping, frontier slots, bank version); the
        cohort key names the device."""
        subs = self.subs
        key = (
            ckey,
            tuple(subs[k].serial for _, k in fk),
            tuple(subs[k].plan_version for _, k in fk),
            tuple(upos[k] for _, k in fk),
            tuple(f_list),
            self.bank.version,
        )
        cached = self._static_arrays_cache.get(key)
        if cached is not None:
            self._static_arrays_cache.move_to_end(key)
            return cached
        if isinstance(self.bank, SubsumptionBank):
            # encoded lane ids (virtual ones from REFINE_BASE) -> rows of
            # the extended bank; the key's bank version covers the mapping
            lane_rows = [self.bank.resolve_lanes(subs[k].lanes) for _, k in fk]
        else:
            lane_rows = [subs[k].lanes for _, k in fk]
        statics = _assemble_cohort_statics(
            [subs[k].plan.patterns for _, k in fk],
            lane_rows,
            [upos[k] for _, k in fk],
            f_list,
            ncp,
            nt,
            bank_rows,
            self.device if device is None else device,
        )
        self._static_arrays_cache[key] = statics
        while len(self._static_arrays_cache) > self.exec_cache_max:
            self._static_arrays_cache.popitem(last=False)
        return statics

    def _evaluate_frontiers(
        self, fronts: List[_FrontierInput]
    ) -> Tuple[Dict[int, EvalOutputs], Dict[int, Tuple[TripleStore, TripleStore]], int]:
        """Every fired frontier through every due cohort; nothing committed.

        Returns (per-subscriber outputs, staged (τ', ρ'), cohort passes).
        One words pass covers every frontier's deleted side (the segmented
        pass over the delta chain's union, or the stacked pass); each shape
        cohort runs one step over all the frontiers it fires from (members
        read their frontier's slices through ``f_map``), with one slot per
        lane group when the lattice is on.
        """
        subs = self.subs
        dev = self.device
        # the matcher is built into the steps, so it is part of every key
        mkey = id(self.matcher) if self.matcher is not None else None
        sharded = self.mesh is not None and self.shard_cohorts
        placed = self.mesh is not None and not self.shard_cohorts
        # the chain needs >= 2 frontiers on the device-resident path, and
        # its int32 membership bitmap holds at most 32 frontier slots
        delta_ok = (
            self.delta_frontiers
            and self.deferred_device_resident
            and len(fronts) >= 2
            and next_pow2(len(fronts)) <= 32
            and all(fr.d_native is not None for fr in fronts)
        )
        n_passes = 0  # includes the passes of abandoned overflow attempts
        n_retries = 0
        front_of = {k: fr for fr in fronts for k in fr.idxs}
        while True:
            for fr in fronts:
                for k in fr.idxs:  # host-side capacity guard
                    s = subs[k]
                    while fr.d_rows > s.caps.n_removed or fr.a_rows > s.caps.n_added:
                        s.recompile(s.caps.doubled())
                for k in fr.idxs:  # dictionary growth guard
                    if self.dictionary.id_capacity > subs[k].id_capacity:
                        subs[k].recompile()
            bank_dev = self._ensure_bank_dev()
            n_words_p = bank_dev.shape[0] // 32
            # with virtual lanes the words pass runs over the real rows and
            # lane_refine gives the virtual words (see _words_step)
            bank_real, refine = self._bank_real_dev, self._refine_dev
            n_words_r = bank_real.shape[0] // 32

            all_idx = [k for fr in fronts for k in fr.idxs]
            d_cap = max(subs[k].caps.n_removed for k in all_idx)
            nf = len(fronts)
            nfp = next_pow2(nf)

            # the delta chain: the union of the fired D sides (the oldest
            # frontier's D) with per-frontier membership bits, each row
            # matched once; the stacked pass when it cannot prove that it
            # holds every frontier's rows. The union is homed at its own
            # power-of-two row count, so the whole D side of every cohort
            # runs at distinct-row shapes
            chain = None
            u_cap = d_cap
            if delta_ok:
                base_fi = min(range(nf), key=lambda i: fronts[i].since)
                u_cap = max(64, next_pow2(fronts[base_fi].d_rows))
                c = build_frontier_chain([fr.d_native() for fr in fronts], base_fi, u_cap)
                if c.covered:
                    chain = c
                else:
                    u_cap = d_cap
            if chain is not None:
                matched = distinct = fronts[base_fi].d_rows
            else:
                matched = sum(fr.d_rows for fr in fronts)
                distinct = max((fr.d_rows for fr in fronts), default=0)
            self._rows_matched_acc += matched
            self._rows_distinct_acc += distinct
            self.rows_matched += matched
            self.rows_distinct += distinct

            # the deleted side: the segmented pass over the chain's union, or
            # one stacked pass over every frontier's D store (padding slots
            # carry empty stores). The sharded step computes its own words,
            # block-split across the shards, so it skips this pass.
            d_stores = None if chain is not None else [fr.d_store(d_cap) for fr in fronts]
            d_words_all = None
            if not sharded:
                if chain is not None:
                    wkey = ("words-seg", u_cap, n_words_p, n_words_r, nfp, mkey)
                    words_args = (chain.union.spo, chain.seg, bank_real, refine)
                else:
                    d_spos = [st.spo for st in d_stores] + [_empty_cached(d_cap, dev).spo] * (nfp - nf)
                    wkey = ("words", d_cap, n_words_p, n_words_r, nfp, mkey)
                    words_args = (d_spos, None, bank_real, refine)
                miss = wkey not in self._exec_cache
                words_fn = self._build_exec(
                    wkey, lambda: self._words_step(nfp, u_cap if chain is not None else d_cap, chain is not None)
                )
                if miss:
                    self.words_compiles += 1
                d_words_all = words_fn(*words_args)  # (nfp, u_cap or d_cap, W)

            a_cache: Dict[Tuple[int, int], TripleStore] = {}

            def a_of(fi: int, cap: int) -> TripleStore:
                if (fi, cap) not in a_cache:
                    a_cache[(fi, cap)] = fronts[fi].a_store(cap)
                return a_cache[(fi, cap)]

            cohorts: Dict[tuple, List[Tuple[int, int]]] = {}
            for fi, fr in enumerate(fronts):
                for k in fr.idxs:
                    s = subs[k]
                    cohorts.setdefault((s.shape_key, s.caps, s.id_capacity), []).append((fi, k))

            # placement: a sticky cohort -> device assignment, the cohorts run
            # grouped by device; the sharded step spans every device
            cohort_items = list(cohorts.items())
            cohort_dev: Dict[tuple, Optional[int]] = {
                key: self.placement.assign(key, next_pow2(len(fk)), len(self._devices)) if placed else None
                for key, fk in cohort_items
            }
            if placed:
                cohort_items.sort(key=lambda kv: cohort_dev[kv[0]])

            staged: Dict[int, Tuple[TripleStore, TripleStore]] = {}
            outs: Dict[int, EvalOutputs] = {}
            overflowed: List[int] = []
            for (skey, caps, id_cap), fk in cohort_items:
                didx = cohort_dev[(skey, caps, id_cap)]
                cdev = self._devices[didx] if didx is not None else dev
                rep = subs[fk[0][1]]
                nt = rep.plan.n_total
                # frontier slots this cohort uses -> dense local slots
                fs_used = sorted({fi for fi, _ in fk})
                fslot = {fi: i for i, fi in enumerate(fs_used)}
                nfc = len(fs_used)
                nfcp = next_pow2(nfc)
                # unique target replicas (shared-τ and lane groups); rep_fk
                # holds each group's first (frontier, subscriber), whose
                # result is the group's
                ugroups: List[List[int]] = []
                rep_fk: List[Tuple[int, int]] = []
                upos: Dict[int, int] = {}
                seen: Dict[tuple, int] = {}
                for fi, k in fk:
                    s = subs[k]
                    gk = (fi, id(s.share_tag), s.epoch)
                    if gk not in seen:
                        seen[gk] = len(ugroups)
                        ugroups.append([])
                        rep_fk.append((fi, k))
                    upos[k] = seen[gk]
                    ugroups[seen[gk]].append(k)
                if self.subsume_interests:
                    # one slot per lane group: its members share plan values,
                    # lanes, capacities, τ, ρ and frontier (what the lineage
                    # certifies), so their slots would give equal results;
                    # the outputs fan out to every member below
                    eval_fk = rep_fk
                    eval_upos = {k: i for i, (_, k) in enumerate(rep_fk)}
                else:
                    eval_fk, eval_upos = fk, upos
                members = [k for _, k in eval_fk]
                f_list = [fslot[fi] for fi, _ in eval_fk]
                nm, nu = len(members), len(ugroups)
                ncp, nup = next_pow2(nm), next_pow2(nu)
                self._distinct_acc += nm
                self._fanout_acc += len(fk)
                self.distinct_interests += nm
                self.fanout_copies += len(fk)

                pad_f = nfcp - nfc
                d_sets = None
                if chain is None:
                    d_sets = tuple(
                        TripleStore(spo=d_stores[fi].spo[: caps.n_removed], n=d_stores[fi].n)
                        for fi in fs_used
                    ) + (_empty_cached(caps.n_removed, cdev),) * pad_f
                a_sets = tuple(a_of(fi, caps.n_added) for fi in fs_used) + (
                    _empty_cached(caps.n_added, cdev),
                ) * pad_f
                uniq_taus = tuple(subs[g[0]].tau for g in ugroups) + (
                    _empty_cached(caps.tau, cdev),
                ) * (nup - nu)
                rhos_c = tuple(subs[k].rho for k in members) + (_empty_cached(caps.rho, cdev),) * (ncp - nm)
                if sharded:
                    if chain is not None:
                        ckey = ("cohort-sh-delta", skey, caps, id_cap, ncp, nup, nfcp, n_words_p, u_cap,
                                self._n_shards, mkey)
                    else:
                        ckey = ("cohort-sh", skey, caps, id_cap, ncp, nup, nfcp, n_words_p, self._n_shards, mkey)
                    statics = self._static_arrays(ckey, eval_fk, f_list, eval_upos, ncp, nt, bank_dev.shape[0])
                    parts = [self._tau_partitions(subs[g[0]], caps.tau) for g in ugroups]
                    pad_part = (self._empty_parts(1),) * (nup - nu)  # padding slots are never read
                    uniq_spo = tuple(p[0] for p in parts) + pad_part
                    uniq_ops = tuple(p[1] for p in parts) + pad_part
                    if chain is not None:
                        # membership bits at the cohort's dense frontier slots (they key f_map)
                        d_args = (chain.union, _seg_local_bits(chain.seg, tuple(fs_used)))
                    else:
                        d_args = (d_sets,)
                    args = (*d_args, a_sets, bank_dev, uniq_taus, uniq_spo, uniq_ops, rhos_c, statics)

                    def builder(rep=rep, caps=caps, id_cap=id_cap, nfcp=nfcp, delta=chain is not None):
                        return make_sharded_cohort_step(
                            rep.plan, caps, id_cap, self.mesh, matcher=self.matcher, delta=delta, n_frontiers=nfcp,
                        )
                else:
                    if chain is not None:
                        # one union store for the whole cohort; each frontier's
                        # masked words select its rows
                        d_in = chain.union
                        w_rows = u_cap
                        d_words = tuple(d_words_all[fi] for fi in fs_used)
                        ckey = ("cohort-delta", skey, caps, id_cap, ncp, nup, nfcp, n_words_p, u_cap, mkey, didx)
                    else:
                        d_in = d_sets
                        w_rows = caps.n_removed
                        d_words = tuple(d_words_all[fi, : caps.n_removed] for fi in fs_used)
                        ckey = ("cohort", skey, caps, id_cap, ncp, nup, nfcp, n_words_p, mkey, didx)
                    if pad_f:
                        zero_w = torch.zeros((w_rows, n_words_p), dtype=torch.int32, device=dev)
                        d_words = d_words + (zero_w,) * pad_f
                    statics = self._static_arrays(ckey, eval_fk, f_list, eval_upos, ncp, nt, bank_dev.shape[0],
                                                  device=cdev)
                    args = (d_in, d_words, a_sets, bank_dev, uniq_taus, rhos_c)
                    if placed:
                        # every operand on the cohort's device: resident state
                        # and the bank's copy are there, the frontier's slices move
                        args = _to_device(args[:3], cdev) + (self._ensure_bank_dev(didx),) + _to_device(args[4:], cdev)
                    args = args + (statics,)

                    def builder(rep=rep, caps=caps, id_cap=id_cap, delta=chain is not None):
                        return make_cohort_step(rep.plan, caps, id_cap, matcher=self.matcher, delta=delta)
                miss = ckey not in self._exec_cache
                fn = self._build_exec(ckey, builder)
                if miss:
                    self.cohort_compiles[ckey] = self.cohort_compiles.get(ckey, 0) + 1
                tau1_c, rho1_c, out_c = fn(*args)
                n_passes += 1
                for i in range(len(self._devices)) if sharded else (didx or 0,):
                    self.device_passes[i] = self.device_passes.get(i, 0) + 1
                for g in ugroups:
                    pos0 = members.index(g[0])
                    out = out_c[pos0]
                    if bool(out.overflow):
                        overflowed.extend(g)
                        continue
                    for k in g:  # group members adopt one state object
                        outs[k] = out
                        staged[k] = (tau1_c[pos0], rho1_c[pos0])

            if overflowed:
                n_retries += 1
                if n_retries > self.max_fire_retries:
                    # past the ceiling, the still-overflowing subscribers go
                    # through the per-interest step (same outputs, slower)
                    degraded = sorted(set(overflowed))
                    for k in degraded:
                        tau1, rho1, out = self._degraded_eval(k, front_of[k], mkey)
                        outs[k] = out
                        staged[k] = (tau1, rho1)
                        n_passes += 1
                    self.degraded_fires += len(degraded)
                    self._degraded_acc += len(degraded)
                    return outs, staged, n_passes
                # grow only the overflowing subscribers, then re-run the
                # whole fire (staged updates are dropped: atomic commit)
                for k in sorted(set(overflowed)):
                    subs[k].recompile(subs[k].caps.doubled())
                continue
            return outs, staged, n_passes

    def _degraded_eval(
        self, k: int, fr: _FrontierInput, mkey
    ) -> Tuple[TripleStore, TripleStore, EvalOutputs]:
        """Per-interest fallback for one subscriber whose cohort fire kept
        overflowing past ``max_fire_retries``: its composed frontier through
        :func:`~repro_torch.core.propagation.make_interest_step`, doubling
        only its own capacities until the outputs fit."""
        s = self.subs[k]
        while fr.d_rows > s.caps.n_removed or fr.a_rows > s.caps.n_added:
            s.recompile(s.caps.doubled())
        if self.dictionary.id_capacity > s.id_capacity:
            s.recompile()
        for _ in range(64):
            d = fr.d_store(s.caps.n_removed)
            a = fr.a_store(s.caps.n_added)
            key = ("seed", s.serial, s.plan_version, s.caps, mkey)
            fn = self._build_exec(
                key,
                lambda: make_interest_step(
                    s.plan, id_capacity=s.id_capacity, caps=s.caps, matcher=self.matcher
                ),
            )
            tau1, rho1, out = fn(d, a, s.tau, s.rho)
            if not bool(out.overflow):
                return tau1, rho1, out
            s.recompile(s.caps.doubled())
        raise RuntimeError("per-interest fallback fire failed to converge after 64 doublings")

    def _commit_staged(self, staged: Dict[int, Tuple[TripleStore, TripleStore]]) -> None:
        """Commit the staged (τ', ρ'); wait for every device written so that
        ``elapsed_s`` covers the work.

        Only the sharded path reads the τ-partition cache, and only a τ that
        changed should invalidate it: a fire that missed an interest commits
        an equal τ, and partitioning it again would redo the work the cache
        saves. Comparisons are memoized on the (old, new) pair, so a shared
        replica is compared once.
        """
        sharded = self.mesh is not None and self.shard_cohorts
        unchanged_cache: Dict[Tuple[int, int], bool] = {}
        for k, (tau1, rho1) in staged.items():
            s = self.subs[k]
            unchanged = False
            if sharded:
                pair = (id(s.tau.spo), id(tau1.spo))
                unchanged = unchanged_cache.get(pair)
                if unchanged is None:
                    unchanged = s.tau.spo.shape == tau1.spo.shape and torch.equal(s.tau.spo, tau1.spo)
                    unchanged_cache[pair] = unchanged
            if not unchanged:
                s.tau_version += 1
            s.tau, s.rho = tau1, rho1
        for device in {tau1.spo.device for tau1, _ in staged.values()}:
            _synchronize(device)

    # -- durability: snapshot, compaction, recovery --------------------------

    def snapshot(self, store) -> int:
        """Save the whole broker state into a
        :class:`~repro_torch.checkpoint.CheckpointStore` at the current
        sequence number; returns it.

        Replay after a restore then needs only the journal past this seq,
        plus the earlier ingest records still pending on some frontier,
        which is what :meth:`compact_journal` keeps. τ/ρ are saved as their
        valid rows, lex-sorted, so ``from_array`` restores them bit for bit.
        """
        state = {"subs": {str(s.jid): {"tau": to_numpy(s.tau), "rho": to_numpy(s.rho)} for s in self.subs}}
        extra = {
            "seq": self._seq,
            "jid_next": self._jid_next,
            "last_cid": self._last_cid,
            "subs": [
                {
                    "jid": s.jid,
                    "expr": _expr_to_json(s.expr),
                    "caps": _caps_to_json(s.caps),
                    "policy": _policy_to_json(s.policy),
                    "since": s.since,
                }
                for s in self.subs
            ],
        }
        store.save(self._seq, state, extra)
        self._last_snapshot_seq = self._seq
        self._snapshot_keep_from = min([s.since for s in self.subs] + [self._seq + 1])
        return self._seq

    def compact_journal(self) -> int:
        """Drop the journal segments replay can no longer need; returns how
        many. Without a snapshot replay needs everything from seq 1, so
        nothing is dropped."""
        if self.journal is None:
            return 0
        return self.journal.compact(self._snapshot_keep_from)

    @classmethod
    def recover(
        cls,
        journal: ChangesetJournal,
        store=None,
        dictionary: Dictionary | None = None,
        **broker_kwargs,
    ) -> "Broker":
        """Rebuild a broker from its journal and, optionally, its snapshots.

        Takes the newest snapshot whose seq is at most the journal's durable
        ``last_seq`` (a newer one holds state that was never journaled),
        restores every subscriber's τ/ρ and frontier from it, then replays
        the journal: ingest records before the snapshot rebuild the pending
        batches (only changesets at or past a restored frontier land in
        one), and the records after it re-run their operations with the
        journal and delivery off. A fire re-runs, through the broker's
        normal fire path, for exactly the subscribers it recorded, so a
        delivery that failed before the crash stays uncommitted. The result
        has the crashed broker's τ/ρ rows, frontiers, pending batches and
        sequence clock.

        ``dictionary`` must be the one the crashed broker encoded with (it
        is not journaled), and ``broker_kwargs`` its constructor options
        (``device`` among them). Transports and the channel's retry state
        are not journaled; a restored subscriber joins no lane group (a
        missed collapse, the values are the same).
        """
        broker = cls(dictionary=dictionary, journal=journal, **broker_kwargs)
        broker._seq = 0
        snap_step = 0
        extra: Dict = {}
        if store is not None:
            usable = [s for s in store.steps() if s <= journal.last_seq]
            if usable:
                snap_step = usable[-1]
                arrays, extra = store.load_raw(snap_step)
                broker._replaying = True
                try:
                    for meta in extra["subs"]:
                        broker._restore_sub(meta, arrays)
                finally:
                    broker._replaying = False
                broker._seq = int(extra["seq"])
                broker._jid_next = int(extra["jid_next"])
                broker._last_snapshot_seq = snap_step
        min_since = min([s.since for s in broker.subs] + [snap_step + 1])
        records = list(journal.records())
        if records and records[0].seq > min(min_since, snap_step + 1):
            raise RuntimeError(
                f"journal starts at seq {records[0].seq} but replay needs seq "
                f"{min(min_since, snap_step + 1)}: a needed segment was compacted away or lost"
            )
        broker._replaying = True
        try:
            for rec in records:
                if rec.seq <= snap_step:
                    # before the snapshot only the ingests still pending on a
                    # restored frontier matter; the rest is in the snapshot
                    if rec.kind == "ingest" and rec.seq >= min_since:
                        broker._apply_ingest(rec.arrays["removed"], rec.arrays["added"], rec.seq)
                    continue
                broker._seq = rec.seq - 1
                if rec.kind == "ingest":
                    broker._seq = rec.seq
                    broker._apply_ingest(rec.arrays["removed"], rec.arrays["added"], rec.seq)
                elif rec.kind == "subscribe":
                    broker.subscribe(
                        _expr_from_json(rec.meta["expr"]),
                        caps=_caps_from_json(rec.meta["caps"]),
                        initial_target=rec.arrays.get("initial_target"),
                        policy=_policy_from_json(rec.meta["policy"]),
                        share_target=bool(rec.meta["share_target"]),
                        _jid=int(rec.meta["jid"]),
                    )
                elif rec.kind == "unsubscribe":
                    broker.unsubscribe(broker._sub_by_jid(int(rec.meta["jid"])))
                elif rec.kind == "fire":
                    broker._replay_fire(rec)
                else:
                    raise RuntimeError(f"unknown journal record kind {rec.kind!r}")
        finally:
            broker._replaying = False
        if extra:
            broker._last_cid = max(broker._last_cid, int(extra["last_cid"]))
        broker._seq = max(broker._seq, journal.last_seq)
        broker._sweep_batches(drained=False)
        return broker

    def _restore_sub(self, meta: Dict, arrays: Dict) -> None:
        """One snapshot subscriber back to life (not journaled)."""
        sub = BrokerSubscription(
            _expr_from_json(meta["expr"]),
            self.dictionary,
            _caps_from_json(meta["caps"]),
            self.device,
            policy=_policy_from_json(meta["policy"]),
        )
        sub.jid = int(meta["jid"])
        sub.since = int(meta["since"])
        prefix = f"subs/{sub.jid}/"
        tau_rows = arrays[prefix + "tau"]
        rho_rows = arrays[prefix + "rho"]
        if tau_rows.size:
            sub.tau, _ = from_array(torch.as_tensor(np.asarray(tau_rows, np.int32), device=self.device), sub.caps.tau)
        if rho_rows.size:
            sub.rho, _ = from_array(torch.as_tensor(np.asarray(rho_rows, np.int32), device=self.device), sub.caps.rho)
        sub.lanes = self.bank.add_plan(sub.plan)
        self.subs.append(sub)
        self._lanes_raw += sub.plan.n_total

    def _sub_by_jid(self, jid: int) -> BrokerSubscription:
        for s in self.subs:
            if s.jid == jid:
                return s
        raise RuntimeError(f"journal references unknown subscriber {jid}")

    def _replay_fire(self, rec: JournalRecord) -> None:
        """Re-run one committed fire for exactly the recorded subscribers
        (no delivery: the receivers have these outputs) and commit it; the
        recorded new frontiers are checked."""
        by_jid = {int(j): int(ns) for j, ns in rec.meta["fires"]}
        ks = [k for k, s in enumerate(self.subs) if s.jid in by_jid]
        if len(ks) != len(by_jid):
            missing = set(by_jid) - {self.subs[k].jid for k in ks}
            raise RuntimeError(f"fire record {rec.seq} references unknown subscribers {sorted(missing)}")
        self._fire(ks)
        for k in ks:
            s = self.subs[k]
            if s.since != by_jid[s.jid]:
                raise RuntimeError(
                    f"replayed fire {rec.seq} advanced subscriber {s.jid} to {s.since}, "
                    f"journal recorded {by_jid[s.jid]}"
                )

    # -- accounting ---------------------------------------------------------

    def _record_stats(
        self,
        changeset_id: int,
        removed: np.ndarray,
        added: np.ndarray,
        results: List[Optional[EvalOutputs]],
        fired: List[int],
        n_passes: int,
        t0: float,
    ) -> None:
        # shared-τ members share one EvalOutputs: read each distinct result
        # once and weight it by its member count
        uniq: Dict[int, Tuple[EvalOutputs, int]] = {}
        for k in fired:
            o = results[k]
            if o is None:
                continue
            ent = uniq.get(id(o))
            uniq[id(o)] = (o, 1 if ent is None else ent[1] + 1)
        self.stats.append(
            BrokerStats(
                changeset_id=changeset_id,
                n_subscribers=len(self.subs),
                n_lanes=self.bank.n_lanes,
                n_lanes_raw=self._lanes_raw,
                total_removed=int(removed.shape[0]),
                total_added=int(added.shape[0]),
                interesting_removed=sum(int(o.r.n) * c for o, c in uniq.values()),
                interesting_added=sum(int(o.a.n) * c for o, c in uniq.values()),
                elapsed_s=time.perf_counter() - t0,
                rejit_s=self._rejit_acc,
                n_evaluated=len(fired),
                n_deferred=len(self.subs) - len(fired),
                n_cohort_passes=n_passes,
                batch_grows=self.batch_grows,
                batch_shrinks=self.batch_shrinks,
                rows_matched=self._rows_matched_acc,
                rows_distinct=self._rows_distinct_acc,
                distinct_interests=self._distinct_acc,
                fanout_copies=self._fanout_acc,
                seq=self._seq,
                degraded_fires=self._degraded_acc,
            )
        )
