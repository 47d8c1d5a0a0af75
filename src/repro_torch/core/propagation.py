"""Interest evaluation combination and update propagation (Defs 6, 13-18).

Port of the per-interest half of ``repro.core.propagation``.
:func:`make_interest_step` builds the per-changeset step for one interest:

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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from .dictionary import Dictionary
from .evaluation import SideResult, build_index, make_side_evaluator
from .interest import CompiledInterest, InterestExpr, compile_interest
from .triples import TripleStore, difference, empty, from_array, union


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
