"""Delivery robustness tier between ``Broker._fire`` and subscribers.

A copy of ``repro.core.delivery`` (standard library only); the same seed
on the same clock gives the same backoff schedule in both packages.

A :class:`DeliveryChannel` sits at the broker's commit point: a fired
subscriber's :class:`~repro_torch.core.propagation.EvalOutputs` are handed to a
transport callback *before* the broker advances that subscriber's
consumption frontier or commits its τ/ρ, so a failed delivery simply
leaves the subscriber un-committed — its pending
:class:`~repro_torch.core.propagation.ChangesetBatch` keeps composing (Def-6)
and the next eligible fire re-delivers the *composed* window. Composition
makes that retry idempotent for the receiver (see the broker module
docstring's durability contract), so the channel only has to provide
at-least-once delivery with bounded, deterministic failure handling:

* **retry + exponential backoff with jitter** — each failed delivery
  schedules the subscriber's next attempt at ``base_backoff_s *
  backoff_factor**(failures-1)`` seconds (capped at ``max_backoff_s``),
  scaled by a seeded jitter factor so retries are reproducible under a
  fake clock yet de-synchronized in production;
* **timeout** — a transport call that raises *or* takes longer than
  ``timeout_s`` (measured on the injected clock, so fakes can simulate
  slow transports) counts as a failed delivery;
* **poison quarantine** — after ``quarantine_after`` consecutive failed
  deliveries the subscriber is quarantined: excluded from fires entirely
  (its frontier pins, its batch keeps composing under its capacity cap)
  until :meth:`readmit`, so one poisonous consumer cannot stall the
  broker or burn retry work forever;
* **bounded in-flight queue** — subscribers awaiting retry count as
  in-flight; when ``max_in_flight`` is reached the broker's ingest path
  backpressures (``Broker._service_channel``): it sleeps to the next
  retry deadline and pumps retries until each in-flight subscriber either
  acks or progresses to quarantine, both of which shrink the queue — so
  the pump terminates and ingest never deadlocks.

``clock`` / ``sleep`` / the jitter RNG are injectable, which is what makes
the fault-injection harness (:mod:`repro_torch.testing.faults`) fully
deterministic: goldens pin exact backoff schedules against a fake clock.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, Optional

Transport = Callable[[object, object], object]


@dataclasses.dataclass
class DeliveryStats:
    """Cumulative channel accounting."""

    attempts: int = 0  # transport invocations (incl. in-call retries)
    successes: int = 0  # delivered fires
    failures: int = 0  # failed deliveries (all in-call attempts exhausted)
    timeouts: int = 0  # attempts that exceeded timeout_s
    quarantines: int = 0  # subscribers moved to quarantine


@dataclasses.dataclass
class _SubState:
    failures: int = 0  # consecutive failed deliveries
    next_retry: float = 0.0
    quarantined: bool = False


class DeliveryChannel:
    """Per-subscriber retry/backoff/timeout/quarantine around a transport.

    ``transport(sub, outputs)`` is the channel-level default delivery
    callback; a subscriber with its own ``sub.transport`` overrides it.
    With neither, delivery trivially succeeds (the channel is then pure
    bookkeeping). Raising — or exceeding ``timeout_s`` on the injected
    clock — marks the attempt failed.
    """

    def __init__(
        self,
        transport: Optional[Transport] = None,
        *,
        max_attempts: int = 3,
        base_backoff_s: float = 0.05,
        backoff_factor: float = 2.0,
        max_backoff_s: float = 5.0,
        jitter: float = 0.1,
        timeout_s: Optional[float] = None,
        quarantine_after: int = 5,
        max_in_flight: Optional[int] = 64,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        seed: int = 0,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.transport = transport
        self.max_attempts = max_attempts
        self.base_backoff_s = base_backoff_s
        self.backoff_factor = backoff_factor
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.timeout_s = timeout_s
        self.quarantine_after = quarantine_after
        self.max_in_flight = max_in_flight
        self.clock = clock
        self.sleep = sleep
        self.stats = DeliveryStats()
        self._rng = random.Random(seed)
        self._state: Dict[int, _SubState] = {}  # sub.serial -> state

    # -- schedule queries (used by the broker's fire selection) -------------

    def eligible(self, sub) -> bool:
        """May this subscriber fire now? (not quarantined, backoff elapsed)"""
        st = self._state.get(sub.serial)
        if st is None:
            return True
        if st.quarantined:
            return False
        return self.clock() >= st.next_retry

    def retry_due(self, sub) -> bool:
        """Has a *failed* subscriber's backoff elapsed?"""
        st = self._state.get(sub.serial)
        return (
            st is not None
            and not st.quarantined
            and self.clock() >= st.next_retry
        )

    def is_quarantined(self, sub) -> bool:
        st = self._state.get(sub.serial)
        return st is not None and st.quarantined

    def failures(self, sub) -> int:
        st = self._state.get(sub.serial)
        return 0 if st is None else st.failures

    def next_retry_at(self, sub) -> Optional[float]:
        st = self._state.get(sub.serial)
        if st is None or st.quarantined:
            return None
        return st.next_retry

    def in_flight(self) -> int:
        """Subscribers with a failed delivery awaiting retry (not poison)."""
        return sum(1 for st in self._state.values() if not st.quarantined)

    def readmit(self, sub) -> None:
        """Clear a subscriber's failure/quarantine state; it may fire again."""
        self._state.pop(sub.serial, None)

    def forget(self, sub) -> None:
        self._state.pop(sub.serial, None)

    def wait_for_retry(self) -> None:
        """Sleep (injected) until the earliest pending retry deadline."""
        deadlines = [
            st.next_retry
            for st in self._state.values()
            if not st.quarantined
        ]
        if not deadlines:
            return
        dt = min(deadlines) - self.clock()
        if dt > 0:
            self.sleep(dt)

    # -- delivery -----------------------------------------------------------

    def _backoff(self, failures: int) -> float:
        base = min(
            self.max_backoff_s,
            self.base_backoff_s * self.backoff_factor ** max(0, failures - 1),
        )
        return base * (1.0 + self.jitter * self._rng.random())

    def _attempt(self, fn: Transport, sub, outputs) -> bool:
        self.stats.attempts += 1
        t0 = self.clock()
        try:
            fn(sub, outputs)
        except Exception:
            return False
        if (
            self.timeout_s is not None
            and self.clock() - t0 > self.timeout_s
        ):
            self.stats.timeouts += 1
            return False
        return True

    def deliver(self, sub, outputs) -> bool:
        """One delivery: up to ``max_attempts`` transport calls with in-call
        backoff. True advances the subscriber (the broker commits); False
        leaves it pinned with its retry schedule updated."""
        fn = getattr(sub, "transport", None) or self.transport
        ok = True
        if fn is not None:
            for attempt in range(self.max_attempts):
                ok = self._attempt(fn, sub, outputs)
                if ok:
                    break
                if attempt + 1 < self.max_attempts:
                    self.sleep(self._backoff(attempt + 1))
        if ok:
            self.stats.successes += 1
            self._state.pop(sub.serial, None)
            return True
        self.stats.failures += 1
        st = self._state.setdefault(sub.serial, _SubState())
        st.failures += 1
        if st.failures >= self.quarantine_after:
            st.quarantined = True
            self.stats.quarantines += 1
        else:
            st.next_retry = self.clock() + self._backoff(st.failures)
        return False
