"""Carry an engine's or a broker's state from the reference package into the port.

The port keeps no weights; its state is the dictionary and, per
subscription, the target replica τ and the potential set ρ; a broker adds
its pattern bank (with the subsumption lattice: the virtual lanes too), each
subscriber's lanes, policy, frontier and replica lineage (lane groups and
their index), and its sequence clock. These functions take that state as plain Python and numpy
values, as ``repro.core`` holds it (``Dictionary`` term list,
``TripleStore.spo`` and ``.n`` as arrays, the bank's rows, references and
free lanes), and rebuild it on a given device, so that both packages
continue from the same state and produce the same stores.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .broker import Broker, BrokerSubscription, PushPolicy
from .dictionary import Dictionary
from .interest import IncrementalPatternBank, InterestExpr, SubsumptionBank
from .propagation import InterestSubscription, IrapEngine, StepCapacities
from .triples import PAD, TripleStore

StoreArrays = Tuple[np.ndarray, int]  # (spo int32[C, 3] lex-sorted with PAD tail, n)


def load_dictionary(terms: Sequence[str]) -> Dictionary:
    """The port's dictionary with the reference's ids (term ``i`` has id ``i``)."""
    return Dictionary.from_terms(terms)


def load_store(arrays: StoreArrays, device) -> TripleStore:
    """A reference store's arrays as a port store on ``device``, checked."""
    spo, n = arrays
    spo = np.asarray(spo, dtype=np.int32)
    n = int(n)
    if spo.ndim != 2 or spo.shape[1] != 3 or not 0 <= n <= spo.shape[0]:
        raise ValueError(f"not a store: spo {spo.shape}, n {n}")
    if (spo[n:] != PAD).any() or (spo[:n, 0] == PAD).any():
        raise ValueError("store rows must be n valid rows followed by PAD rows")
    valid = spo[:n]
    if n > 1:
        order = np.lexsort((valid[:, 2], valid[:, 1], valid[:, 0]))
        if (order != np.arange(n)).any() or (valid[1:] == valid[:-1]).all(axis=1).any():
            raise ValueError("store rows must be lex-sorted and distinct")
    return TripleStore(
        spo=torch.as_tensor(spo, device=device),
        n=torch.tensor(n, dtype=torch.int32, device=device),
    )


def carry_subscription(
    engine: IrapEngine,
    expr: InterestExpr,
    caps: StepCapacities,
    tau: StoreArrays,
    rho: StoreArrays,
) -> InterestSubscription:
    """Register ``expr`` on ``engine`` and set its τ and ρ to the given state.

    ``caps`` are the subscription's capacities at the time of the carry
    (the reference doubles them on overflow); τ and ρ must have exactly the
    capacities ``caps.tau`` and ``caps.rho``.
    """
    if np.asarray(tau[0]).shape[0] != caps.tau or np.asarray(rho[0]).shape[0] != caps.rho:
        raise ValueError("τ and ρ capacities must equal caps.tau and caps.rho")
    sub = engine.register_interest(expr, caps)
    sub.tau = load_store(tau, engine.device)
    sub.rho = load_store(rho, engine.device)
    return sub


@dataclasses.dataclass(frozen=True)
class SubscriberState:
    """One broker subscriber as the reference holds it."""

    expr: InterestExpr
    caps: StepCapacities  # the subscriber's capacities at the carry
    policy: PushPolicy
    tau: StoreArrays  # capacity caps.tau
    rho: StoreArrays  # capacity caps.rho
    lanes: Tuple[int, ...]  # bank lane of each local pattern (encoded ids with the lattice)
    since: int  # first unconsumed changeset id
    # lane-group signature (canonical key, caps and policy at subscribe),
    # with the lattice on
    canon_sig: Optional[tuple] = None
    # subscribers with one lineage share one replica lineage (share_tag)
    lineage: Optional[int] = None
    epoch: int = 0


def carry_broker(
    terms: Sequence[str],
    bank_rows: Sequence[Optional[Tuple[int, int, int]]],
    bank_refs: Sequence[int],
    bank_free: Sequence[int],
    subscribers: Sequence[SubscriberState],
    seq: int,
    last_cid: int,
    device=None,
    *,
    subsume_interests: bool = True,
    delta_frontiers: bool = True,
    virtual_rows: Sequence[Optional[tuple]] = (),
    virtual_refs: Sequence[int] = (),
    virtual_free: Sequence[int] = (),
    share_roots: Sequence[int] = (),
    epoch_intern: Optional[Dict[tuple, int]] = None,
    epoch_next: int = 0,
) -> Broker:
    """A port :class:`Broker` in a reference broker's state.

    ``bank_rows`` / ``bank_refs`` / ``bank_free`` are the bank's real lanes
    (None for a tombstone), reference counts and free list in reuse order;
    ``seq`` is the sequence clock and ``last_cid`` the id of the last
    ingested changeset. Pending changesets are not carried: every subscriber
    must have consumed the stream (``since > last_cid``, as after a
    ``flush()``). ``device``, ``subsume_interests`` and ``delta_frontiers``
    are the :class:`Broker`'s, as the reference broker had them.

    With the lattice on the bank is a
    :class:`~repro_torch.core.interest.SubsumptionBank`: ``virtual_rows`` /
    ``virtual_refs`` / ``virtual_free`` are its virtual slots (as for
    :meth:`~repro_torch.core.interest.SubsumptionBank.restore`),
    ``share_roots`` the positions in ``subscribers`` of the lane-group
    index's roots, and ``epoch_intern`` / ``epoch_next`` the broker's
    consumption-history table, ``(epoch, first id, last id) -> epoch``.
    """
    broker = Broker(load_dictionary(terms), device=device, subsume_interests=subsume_interests,
                    delta_frontiers=delta_frontiers)
    if subsume_interests:
        broker.bank = SubsumptionBank.restore(bank_rows, bank_refs, bank_free,
                                              virtual_rows, virtual_refs, virtual_free)
        bank = broker.bank.patterns_padded()
        resolve = broker.bank.resolve_lanes
    else:
        if virtual_rows or share_roots:
            raise ValueError("virtual lanes and lane groups need subsume_interests=True")
        broker.bank = IncrementalPatternBank.restore(bank_rows, bank_refs, bank_free)
        bank = broker.bank.patterns_padded()
        resolve = tuple
    tags: Dict[int, object] = {}
    for st in subscribers:
        if st.since <= last_cid:
            raise ValueError("a subscriber has pending changesets; flush before the carry")
        if np.asarray(st.tau[0]).shape[0] != st.caps.tau or np.asarray(st.rho[0]).shape[0] != st.caps.rho:
            raise ValueError("τ and ρ capacities must equal caps.tau and caps.rho")
        if (st.canon_sig is not None) != subsume_interests:
            raise ValueError("a subscriber carries a lane-group signature exactly when the lattice is on")
        sub = BrokerSubscription(st.expr, broker.dictionary, st.caps, broker.device, policy=st.policy)
        rows = list(resolve(tuple(int(x) for x in st.lanes)))
        if (len(rows) != sub.plan.n_total or min(rows, default=0) < 0 or max(rows, default=0) >= bank.shape[0]
                or not np.array_equal(bank[rows], sub.plan.patterns)):
            raise ValueError(f"the lanes of {st.expr.target} do not hold its patterns in the bank")
        sub.lanes = tuple(int(x) for x in st.lanes)
        sub.since = int(st.since)
        sub.tau = load_store(st.tau, broker.device)
        sub.rho = load_store(st.rho, broker.device)
        sub.canon_sig = st.canon_sig
        if st.lineage is not None:
            sub.share_tag = tags.setdefault(st.lineage, sub)
        sub.epoch = int(st.epoch)
        broker.subs.append(sub)
        broker._lanes_raw += sub.plan.n_total
    for pos in share_roots:
        root = broker.subs[pos]
        if root.canon_sig is None or root.canon_sig in broker._share_index:
            raise ValueError("each lane-group root needs its own signature")
        broker._share_index[root.canon_sig] = root
    broker._epoch_intern = dict(epoch_intern or {})
    broker._epoch_next = int(epoch_next)
    broker._seq = int(seq)
    broker._last_cid = int(last_cid)
    return broker
