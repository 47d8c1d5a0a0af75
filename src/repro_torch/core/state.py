"""Carry an engine's state from the reference package into the port.

The port keeps no weights; its state is the dictionary and, per
subscription, the target replica τ and the potential set ρ. These functions
take that state as plain Python and numpy values, as
``repro.core`` holds it (``Dictionary`` term list, ``TripleStore.spo`` and
``.n`` as arrays), and rebuild it on a given device, so that both packages
continue from the same state and produce the same stores.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .dictionary import Dictionary
from .interest import InterestExpr
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
