"""Interest evaluation combination and update propagation (Defs 6, 13-18).

Port of ``repro.core.propagation``. :func:`make_interest_step` builds the per-changeset step for one interest:

    d(i, D)        -> <r, r_i, r'>          (Def 13, over deleted triples)
    α(i, A ∪ ρ)    -> <a, a_i, a'>          (Def 14, over added ∪ potential)
    Δ(τ) = <r ∪ r', a>                      (Def 16)
    Δ(ρ) = <r_i, a_i ∪ r'>                  (Def 17)
    Υ: τ' = (τ \\ (r ∪ r')) ∪ a             (Def 18)
       ρ' = ((ρ \\ r_i) ∪ a_i ∪ r') \\ a    (Def 17 + promotion fix)

The host-side :class:`IrapEngine` owns the capacities and the device. Where
the reference re-jits at doubled capacities on overflow, the port
reallocates at doubled capacities and runs the changeset again; the one
host sync per changeset is that overflow flag.

For the broker, :func:`compose_changesets` composes two changesets under
Definition 6, :class:`ChangesetBatch` accumulates the pending changesets
of one consumption frontier on the broker's device, and
:func:`build_frontier_chain` delta-encodes the deleted sides of several
frontiers that fire together (:class:`FrontierChain`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .dictionary import Dictionary
from .evaluation import SideResult, build_index, make_side_evaluator
from .interest import CompiledInterest, InterestExpr, compile_interest, next_pow2
from ..kernels.ref import or_bit
from .triples import PAD, TripleStore, difference, empty, from_array, member, rehome, to_numpy, union


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@dataclasses.dataclass(frozen=True)
class EvalOutputs:
    """The named sets of Definitions 13-17 for one changeset."""

    r: TripleStore  # interesting removed
    r_i: TripleStore  # potentially interesting removed
    r_prime: TripleStore  # τ triples that become potentially interesting
    a: TripleStore  # interesting added (incl. τ completions)
    a_i: TripleStore  # potentially interesting added
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepCapacities:
    n_removed: int = 1024  # D capacity
    n_added: int = 1024  # A capacity
    tau: int = 4096
    rho: int = 4096
    pulls: int = 2048
    fanout: int = 4
    # candidate-dedup probe pool cap (0 = paper-faithful naive pools)
    dedup_candidates: int = 0
    # signature tables are sized to headroom x dictionary size
    id_headroom: int = 4

    @property
    def n_i(self) -> int:  # I = A ∪ ρ
        return self.n_added + self.rho

    def doubled(self) -> "StepCapacities":
        return dataclasses.replace(
            self,
            n_removed=self.n_removed * 2,
            n_added=self.n_added * 2,
            tau=self.tau * 2,
            rho=self.rho * 2,
            pulls=self.pulls * 2,
            dedup_candidates=self.dedup_candidates * 2,
        )


def combine_side_results(
    d_res: SideResult,
    a_res: SideResult,
    tau: TripleStore,
    rho: TripleStore,
    caps: StepCapacities,
    extra_overflow: torch.Tensor,
) -> Tuple[TripleStore, TripleStore, EvalOutputs]:
    """Combine the two side evaluations into Δ(τ), Δ(ρ), Υ (Defs 16-18)."""
    a_cap = caps.n_i + caps.pulls
    r, r_i, r_prime = d_res.interesting, d_res.potential, d_res.pulls
    a, ovf_a = union(a_res.interesting, a_res.pulls, a_cap)
    a_i = a_res.potential

    # Υ (Def 18): target first removes r ∪ r', then adds a
    tau1 = difference(difference(tau, r), r_prime)
    tau1, ovf_t = union(tau1, a, caps.tau)

    # ρ' = ((ρ \ r_i) ∪ a_i ∪ r') \ a   (promotion fix)
    rho1 = difference(rho, r_i)
    rho1, ovf_r1 = union(rho1, a_i, caps.rho)
    rho1, ovf_r2 = union(rho1, r_prime, caps.rho)
    rho1 = difference(rho1, a)

    overflow = (
        d_res.overflow | a_res.overflow | extra_overflow | ovf_a | ovf_t | ovf_r1 | ovf_r2
    )
    out = EvalOutputs(r=r, r_i=r_i, r_prime=r_prime, a=a, a_i=a_i, overflow=overflow)
    return tau1, rho1, out


def compose_changesets(
    d1: TripleStore,
    a1: TripleStore,
    d2: TripleStore,
    a2: TripleStore,
    capacity: int,
) -> Tuple[TripleStore, TripleStore, torch.Tensor]:
    """Sequential composition of two changesets under Definition 6.

    Applying ``<D1, A1>`` then ``<D2, A2>`` to any store equals applying the
    single changeset ``<D1 ∪ D2, (A1 \\ D2) ∪ A2>`` (delete-first ordering:
    late adds win over early deletes, late deletes cancel early adds).
    Returns ``(d, a, overflowed)`` at the given output capacity.
    """
    d, ovf_d = union(d1, d2, capacity)
    a, ovf_a = union(difference(a1, d2), a2, capacity)
    return d, a, ovf_d | ovf_a


@dataclasses.dataclass(frozen=True)
class FrontierChain:
    """Delta-encoded view of the deleted sides of several fired frontiers.

    Every pending :class:`ChangesetBatch` composes a suffix of the changeset
    stream, so a row deleted once lies in the composed D of every frontier
    whose suffix covers it. The chain factors that out:

    ``union``
        the lex-sorted store of the distinct D rows across the frontiers
        (under Definition 6 D sides compose by union, so this is the oldest
        frontier's composed D, re-homed, never re-sorted);
    ``seg``
        int32 membership bitmap over the union rows: bit ``f`` set iff union
        row ``i`` lies in frontier ``f``'s composed D, found by probing the
        union rows into each frontier's own store (not assumed from the
        nesting: the A sides compose non-monotonically);
    ``covered``
        host bool, True iff every frontier's store lies wholly in the union;
        the broker falls back to the stacked pass when it is False, so a
        chain never drops rows.

    One segmented bank pass over ``union``
    (:func:`repro_torch.kernels.ops.pattern_bitmask_words_segmented`) then
    gives every frontier's words, each distinct row matched once; a row
    outside a frontier has zero words, which the evaluator turns into no
    candidates and no outputs.
    """

    union: TripleStore
    seg: torch.Tensor  # int32[capacity], bit f = frontier f
    covered: bool
    n_frontiers: int


def _chain_membership(union: TripleStore, stores: Sequence[TripleStore]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(membership bitmap over the union rows, all-covered flag on the device)."""
    valid = union.spo[:, 0] != PAD
    seg = torch.zeros(union.spo.shape[0], dtype=torch.int32, device=union.spo.device)
    covered = torch.ones((), dtype=torch.bool, device=union.spo.device)
    for f, st in enumerate(stores):
        m = member(st, union.spo) & valid
        seg = or_bit(seg, m, f)
        covered = covered & (m.sum(dtype=torch.int32) == st.n)
    return seg, covered


def build_frontier_chain(d_stores: Sequence[TripleStore], base: int, capacity: int) -> FrontierChain:
    """Chain the deleted sides of the fired frontiers for one segmented pass.

    ``d_stores`` are the frontiers' composed device stores (any capacities;
    index ``f`` becomes membership bit ``f``, at most 32); ``base`` names
    the frontier whose store is the distinct-row union (the oldest under
    Definition 6). Every store is re-homed to ``capacity`` (the caller sizes
    it to the base's rows), and membership is probed per frontier (K2 on the
    card), so the chain is right, or reports ``covered=False``, for stores
    that are not suffix-nested too. Reads one bool from the device.
    """
    if not 1 <= len(d_stores) <= 32:
        raise ValueError(f"a chain holds 1 to 32 frontiers, got {len(d_stores)}")
    union = rehome(d_stores[base], capacity)
    homed = [rehome(st, capacity) for st in d_stores]
    seg, covered = _chain_membership(union, homed)
    return FrontierChain(union=union, seg=seg, covered=bool(covered), n_frontiers=len(d_stores))


@dataclasses.dataclass
class ChangesetBatch:
    """Accumulator of the composed, not yet delivered changesets of one
    consumption frontier (``first_id``), on the broker's device.

    Every subscriber whose policy deferred the same suffix of the stream
    shares the batch. A batch of one changeset keeps the raw host arrays;
    from the second on it holds two lex-sorted, deduplicated device stores
    (D, A) at a power-of-two ``capacity``, which doubles on overflow
    (``grow_count``) and decays back at drain points (:meth:`maybe_decay`).
    The valid-row counts behind :meth:`row_bounds` are read from the device
    lazily, once per fire, never on the ingest path. A fire takes the stores
    as they are (:meth:`device_stores`); ``arrays()`` is the host copy for
    the round-trip path.
    """

    removed: TripleStore | None  # composed D (device); None while n == 1
    added: TripleStore | None  # composed A (device); None while n == 1
    removed_np: np.ndarray  # raw first changeset (fast path for n == 1)
    added_np: np.ndarray
    n_changesets: int
    first_id: int
    last_id: int
    capacity: int
    device: torch.device
    # valid rows of the composed stores, synced lazily by row_bounds()
    # (None = stale)
    d_rows: int | None = None
    a_rows: int | None = None
    grow_count: int = 0  # pow2 doublings since creation
    _decay_streak: int = 0

    @staticmethod
    def fresh(removed: np.ndarray, added: np.ndarray, changeset_id: int, device) -> "ChangesetBatch":
        cap = max(64, int(removed.shape[0]), int(added.shape[0]))
        return ChangesetBatch(
            removed=None,
            added=None,
            # copy: the batch may outlive the caller's (reusable) buffers
            removed_np=np.array(removed, np.int32, copy=True),
            added_np=np.array(added, np.int32, copy=True),
            n_changesets=1,
            first_id=changeset_id,
            last_id=changeset_id,
            capacity=next_pow2(cap),
            device=torch.device(device),
        )

    def _upload(self, rows: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int32).reshape(-1, 3), device=self.device)

    def _materialize(self) -> None:
        while True:
            d, ovf_d = from_array(self._upload(self.removed_np), self.capacity)
            a, ovf_a = from_array(self._upload(self.added_np), self.capacity)
            if not bool(ovf_d | ovf_a):
                self.removed, self.added = d, a
                self.d_rows = self.a_rows = None
                return
            self.capacity *= 2
            self.grow_count += 1

    def extend(self, removed: np.ndarray, added: np.ndarray, changeset_id: int) -> None:
        """Fold one more raw changeset into the composed batch."""
        if self.removed is None:
            self._materialize()
        need = max(int(removed.shape[0]), int(added.shape[0]))
        while self.capacity < need:
            self.capacity *= 2
            self.grow_count += 1
        d2, _ = from_array(self._upload(removed), self.capacity)
        a2, _ = from_array(self._upload(added), self.capacity)
        while True:
            d, a, overflow = compose_changesets(self.removed, self.added, d2, a2, self.capacity)
            if not bool(overflow):
                break
            self.capacity *= 2
            self.grow_count += 1
        self.removed, self.added = d, a
        self.d_rows = self.a_rows = None  # synced lazily at fire time
        self.n_changesets += 1
        self.last_id = changeset_id

    def row_bounds(self) -> Tuple[int, int]:
        """(D rows, A rows) of the composed batch, for capacity guards: exact
        once composed, the raw row counts while it holds one changeset."""
        if self.removed is None:
            return int(self.removed_np.shape[0]), int(self.added_np.shape[0])
        if self.d_rows is None:
            self.d_rows = int(self.removed.n)
            self.a_rows = int(self.added.n)
        return self.d_rows, self.a_rows

    def maybe_decay(self, patience: int = 2, floor: int = 64) -> bool:
        """Re-home to a smaller power-of-two bucket after sustained under-fill.

        When the composed live rows would pad to at most half the current
        allocation for ``patience`` consecutive checks, both stores re-home
        (a slice, no re-sort) to that bucket. Returns True when it shrank.
        """
        if self.removed is None:
            return False
        d_rows, a_rows = self.row_bounds()
        want = max(floor, next_pow2(max(d_rows, a_rows, 1)))
        if want > self.capacity // 2:
            self._decay_streak = 0
            return False
        self._decay_streak += 1
        if self._decay_streak < patience:
            return False
        self.removed = rehome(self.removed, want)
        self.added = rehome(self.added, want)
        self.capacity = want
        self._decay_streak = 0
        return True

    def device_stores(self) -> Tuple[TripleStore, TripleStore]:
        """The composed batch as device stores (D, A)."""
        if self.removed is None:
            self._materialize()
        return self.removed, self.added

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """The composed batch as dense host arrays (D, A)."""
        if self.removed is None:
            return self.removed_np, self.added_np
        return to_numpy(self.removed), to_numpy(self.added)


def make_interest_step(
    plan: CompiledInterest,
    *,
    id_capacity: int,
    caps: StepCapacities,
    matcher=None,
) -> Callable:
    """(D, A, τ, ρ) -> (τ', ρ', EvalOutputs) for one interest."""
    common = dict(
        id_capacity=id_capacity,
        fanout=caps.fanout,
        pull_capacity=caps.pulls,
        matcher=matcher,
        dedup_candidates=caps.dedup_candidates,
    )
    eval_d = make_side_evaluator(plan, out_capacity=caps.n_removed, **common)
    eval_a = make_side_evaluator(plan, out_capacity=caps.n_i, **common)

    def step(d_set: TripleStore, a_set: TripleStore, tau: TripleStore, rho: TripleStore):
        tgt = build_index(tau)
        d_res = eval_d(d_set, tgt)
        i_set, ovf_i = union(a_set, rho, caps.n_i)
        a_res = eval_a(i_set, tgt)
        return combine_side_results(d_res, a_res, tau, rho, caps, ovf_i)

    return step


@dataclasses.dataclass
class ChangesetStats:
    changeset_id: int
    total_removed: int
    total_added: int
    interesting_removed: int
    interesting_added: int
    potential_size: int
    target_size: int
    elapsed_s: float


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class InterestSubscription:
    """One registered interest: its plan, τ, ρ, and step, on one device."""

    def __init__(
        self,
        expr: InterestExpr,
        dictionary: Dictionary,
        caps: StepCapacities,
        device: torch.device,
        matcher=None,
    ):
        self.expr = expr
        self.dictionary = dictionary
        self.caps = caps
        self.device = device
        self.matcher = matcher
        self.plan = compile_interest(expr, dictionary)
        self.id_capacity = dictionary.id_capacity * caps.id_headroom
        self.tau = empty(caps.tau, device)
        self.rho = empty(caps.rho, device)
        self.rebuilds = 0  # reallocations at doubled capacity (or a grown dictionary)
        self.last_outputs: EvalOutputs | None = None
        self._step = make_interest_step(
            self.plan, id_capacity=self.id_capacity, caps=caps, matcher=matcher
        )

    def _rebuild(self, caps: StepCapacities | None = None):
        if caps is not None:
            self.caps = caps
        self.rebuilds += 1
        # recompile the plan so late-registered dictionary constants resolve
        self.plan = compile_interest(self.expr, self.dictionary)
        self.id_capacity = self.dictionary.id_capacity * self.caps.id_headroom
        self._step = make_interest_step(
            self.plan, id_capacity=self.id_capacity, caps=self.caps, matcher=self.matcher
        )
        # re-home stores into (possibly) larger capacities
        self.tau, _ = union(empty(self.caps.tau, self.device), self.tau, self.caps.tau)
        self.rho, _ = union(empty(self.caps.rho, self.device), self.rho, self.caps.rho)

    def _upload(self, triples: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(triples, dtype=np.int32).reshape(-1, 3), device=self.device
        )

    def init_target(self, triples: np.ndarray):
        """Load the initial RDFSlice-style subset into τ (paper §2)."""
        rows = self._upload(triples)
        while True:
            store, overflow = from_array(rows, self.caps.tau)
            if not bool(overflow):
                self.tau = store
                return
            self._rebuild(self.caps.doubled())

    def apply(self, d_np: np.ndarray, a_np: np.ndarray) -> EvalOutputs:
        if self.dictionary.id_capacity > self.id_capacity:
            self._rebuild()
        d_rows, a_rows = self._upload(d_np), self._upload(a_np)
        while True:
            caps = self.caps
            if d_rows.shape[0] > caps.n_removed or a_rows.shape[0] > caps.n_added:
                self._rebuild(caps.doubled())
                continue
            d_store, _ = from_array(d_rows, caps.n_removed)
            a_store, _ = from_array(a_rows, caps.n_added)
            tau1, rho1, out = self._step(d_store, a_store, self.tau, self.rho)
            if bool(out.overflow):
                self._rebuild(caps.doubled())
                continue
            self.tau, self.rho = tau1, rho1
            self.last_outputs = out
            return out


class IrapEngine:
    """Host orchestrator: Interest Manager + Changeset Manager + Evaluator.

    Mirrors the iRap architecture (paper §3): interests are registered, then
    changesets stream through ``process_changeset`` and every subscription's
    τ / ρ stores are updated; per-changeset stats are collected. ``device``
    defaults to the CUDA card; ``device="cpu"`` runs the plain versions.
    """

    def __init__(self, dictionary: Dictionary | None = None, device=None):
        # `dictionary or Dictionary()` would discard an *empty* dictionary
        # (Dictionary defines __len__), silently splitting the id space.
        self.dictionary = dictionary if dictionary is not None else Dictionary()
        self.device = resolve_device(device)
        self.subs: List[InterestSubscription] = []
        self.stats: List[ChangesetStats] = []
        self._counter = 0

    def register_interest(
        self,
        expr: InterestExpr,
        caps: StepCapacities = StepCapacities(),
        initial_target: np.ndarray | None = None,
        matcher=None,
    ) -> InterestSubscription:
        sub = InterestSubscription(expr, self.dictionary, caps, self.device, matcher=matcher)
        if initial_target is not None and initial_target.size:
            sub.init_target(initial_target)
        self.subs.append(sub)
        return sub

    def process_changeset(self, removed: np.ndarray, added: np.ndarray) -> List[ChangesetStats]:
        self._counter += 1
        out_stats = []
        for sub in self.subs:
            t0 = time.perf_counter()
            out = sub.apply(removed, added)
            _synchronize(self.device)
            elapsed = time.perf_counter() - t0
            st = ChangesetStats(
                changeset_id=self._counter,
                total_removed=int(removed.shape[0]),
                total_added=int(added.shape[0]),
                interesting_removed=int(out.r.n),
                interesting_added=int(out.a.n),
                potential_size=int(sub.rho.n),
                target_size=int(sub.tau.n),
                elapsed_s=elapsed,
            )
            out_stats.append(st)
            self.stats.append(st)
        return out_stats
