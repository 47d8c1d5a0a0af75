"""Deterministic, seedable fault-injection harness for broker durability.

A copy of ``repro.testing.faults`` over the port's journal, capacities
and stores.

Everything here is driven by explicit seeds and injected clocks — no wall
time, no ambient randomness — so every failure schedule is reproducible
and the recovery goldens can pin exact backoff sequences and crash
points. The harness covers the four fault families the durable broker
must survive (tests/test_torch_recovery.py):

* **crash at a record boundary** — :func:`crash_at_record` copies a
  journal directory truncated to its first k records (whole frames, via
  :func:`repro_torch.core.journal.scan_segment`), simulating a process killed
  between appends; :class:`CapturingJournal` invokes a callback *before*
  each append, which is where the crash-at-every-boundary property
  captures the pre-append broker state each record must reproduce;
* **torn / corrupt tails** — :func:`tear_tail` chops bytes off the last
  segment (a partially-flushed frame), :func:`corrupt_tail` flips seeded
  bytes inside the last frame (bit rot / garbled flush); both must
  truncate on open, never crash recovery;
* **delivery faults** — :class:`ScriptedTransport` plays per-subscriber
  outcome scripts (``"ok"`` / ``"fail"`` / ``"timeout"``, the latter
  advancing an injected :class:`FakeClock` past the channel's
  ``timeout_s``), driving retry/backoff/quarantine schedules
  deterministically;
* **forced overflow** — :func:`tiny_caps` returns deliberately tiny
  :class:`~repro_torch.core.propagation.StepCapacities` so capacity-overflow
  retry paths (and the bounded degraded-fire ceiling) trigger on small
  inputs.

:func:`broker_state` / :func:`assert_state_equal` capture a broker's
complete observable state (sequence clock, frontiers, pending composed
batches, per-subscriber τ/ρ rows) as host arrays for the bit-identity
assertions the recovery contract is stated in.
"""
from __future__ import annotations

import random
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.journal import (
    ChangesetJournal,
    _HEADER,
    scan_segment,
)
from ..core.propagation import StepCapacities
from ..core.triples import to_numpy


class FakeClock:
    """Injectable monotonic clock: ``clock()`` reads, ``sleep``/``advance``
    move time forward. Passing the same instance as a channel's ``clock``
    and ``sleep`` makes backoff schedules pure arithmetic."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += float(dt)

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self.now += float(dt)


class ScriptedTransport:
    """Delivery callback that plays per-subscriber outcome scripts.

    ``scripts`` maps a subscriber ``jid`` to a list of outcomes consumed
    one per transport *attempt*: ``"ok"`` succeeds, ``"fail"`` raises,
    ``"timeout"`` advances ``clock`` by ``timeout_advance`` and succeeds
    (so only a channel with ``timeout_s < timeout_advance`` counts it as
    failed — a slow call, not a dead one). A subscriber past the end of
    its script (or absent) gets ``default``. Every attempt is recorded in
    ``log`` as ``(jid, outcome)`` and successful deliveries keep their
    outputs in ``delivered[jid]``.
    """

    def __init__(
        self,
        scripts: Optional[Dict[int, List[str]]] = None,
        default: str = "ok",
        clock: Optional[FakeClock] = None,
        timeout_advance: float = 1.0,
    ):
        self.scripts = {j: list(s) for j, s in (scripts or {}).items()}
        self.default = default
        self.clock = clock
        self.timeout_advance = timeout_advance
        self.log: List[tuple] = []
        self.delivered: Dict[int, List[object]] = {}

    def __call__(self, sub, outputs) -> None:
        script = self.scripts.get(sub.jid)
        outcome = script.pop(0) if script else self.default
        self.log.append((sub.jid, outcome))
        if outcome == "fail":
            raise RuntimeError(f"scripted delivery failure for {sub.jid}")
        if outcome == "timeout" and self.clock is not None:
            self.clock.advance(self.timeout_advance)
        self.delivered.setdefault(sub.jid, []).append(outputs)


class CapturingJournal(ChangesetJournal):
    """Journal that reports each record's seq *before* writing its frame.

    ``on_append(seq)`` fires with the broker state exactly as it stands at
    the boundary *before* record ``seq`` becomes durable — which is the
    state a crash-at-``seq - 1`` recovery must reproduce. The
    crash-at-every-boundary property snapshots :func:`broker_state` here.
    """

    def __init__(self, *args, on_append: Optional[Callable] = None, **kw):
        super().__init__(*args, **kw)
        self.on_append = on_append

    def append(self, kind, meta=None, arrays=None, seq=None):
        if self.on_append is not None:
            self.on_append(
                self.last_seq + 1 if seq is None else seq, kind
            )
        return super().append(kind, meta=meta, arrays=arrays, seq=seq)


# ---------------------------------------------------------------------------
# journal fault injection
# ---------------------------------------------------------------------------

def _ordered_segments(directory: Path) -> List[Path]:
    return sorted(
        Path(directory).glob("wal_*.seg"),
        key=lambda p: int(p.name.split("_")[1].split(".")[0]),
    )


def crash_at_record(src: Path, dst: Path, k: int) -> int:
    """Copy journal ``src`` to ``dst`` keeping only its first ``k`` records.

    Truncation happens on whole-frame boundaries, simulating a process
    killed between append ``k`` and append ``k + 1`` (every prior fsync
    completed, nothing after exists). Returns how many records survived
    (``min(k, total)``).
    """
    src, dst = Path(src), Path(dst)
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    kept = 0
    for seg in _ordered_segments(src):
        entries, _, _ = scan_segment(seg)
        if kept >= k:
            break
        take = entries[: k - kept]
        if not take:
            break
        data = seg.read_bytes()[: take[-1][1]]
        (dst / seg.name).write_bytes(data)
        kept += len(take)
    if kept == 0:
        # crash before the first record: an empty journal directory
        segs = _ordered_segments(src)
        if segs:
            (dst / segs[0].name).write_bytes(_HEADER)
    return kept


def tear_tail(directory: Path, n_bytes: int) -> int:
    """Chop ``n_bytes`` off the newest segment (a partially-flushed frame).

    Returns how many bytes were actually removed (the segment is never
    torn past its 8-byte header, mirroring what an O_APPEND crash can
    produce)."""
    segs = _ordered_segments(directory)
    if not segs:
        return 0
    seg = segs[-1]
    size = seg.stat().st_size
    cut = min(int(n_bytes), max(0, size - len(_HEADER)))
    with open(seg, "r+b") as f:
        f.truncate(size - cut)
    return cut


def corrupt_tail(directory: Path, seed: int = 0, n_flips: int = 4) -> int:
    """Flip seeded bytes inside the newest segment's last frame (bit rot).

    The CRC must catch this: opening the journal afterwards truncates the
    corrupted frame instead of decoding garbage. Returns the number of
    bytes flipped (0 when there is no frame to corrupt)."""
    segs = _ordered_segments(directory)
    if not segs:
        return 0
    seg = segs[-1]
    entries, good_end, _ = scan_segment(seg)
    if not entries:
        return 0
    start, end = entries[-1][0], entries[-1][1]
    data = bytearray(seg.read_bytes())
    rng = random.Random(seed)
    # corrupt payload bytes only (past the 8-byte frame prefix), so the
    # frame still *parses* and the CRC check is what must reject it
    lo = start + 8
    flips = min(n_flips, end - lo)
    for off in rng.sample(range(lo, end), flips):
        data[off] ^= 0xFF
    seg.write_bytes(bytes(data))
    return flips


def tiny_caps(**overrides) -> StepCapacities:
    """Deliberately tiny capacities: overflow-retry paths on small inputs."""
    base = dict(
        n_removed=4, n_added=4, tau=16, rho=16, pulls=8, fanout=4
    )
    base.update(overrides)
    return StepCapacities(**base)


# ---------------------------------------------------------------------------
# bit-exact broker state capture
# ---------------------------------------------------------------------------

def _canon_rows(rows: np.ndarray) -> np.ndarray:
    """Lex-sorted deduped rows — the canonical form ``from_array`` settles
    on, so a still-raw single-changeset batch and its materialized sorted
    store compare equal (materialization is a fire-time representation
    change, not a state change)."""
    rows = np.asarray(rows, np.int32).reshape(-1, 3)
    return np.unique(rows, axis=0) if rows.size else rows


def broker_state(broker) -> Dict:
    """A broker's observable durable state as comparable host values.

    Captures the unified sequence clock, each subscription (by durable
    jid) with its capacities, consumption frontier, and canonical τ/ρ
    rows, and each pending batch's composed changeset window. Two brokers
    with equal captures are indistinguishable to every future flush —
    this is the bit-identity the recovery contract is stated in.
    """
    subs = {}
    for s in sorted(broker.subs, key=lambda s: s.jid):
        batch = broker._batches.get(s.since)
        if batch is not None:
            d_np, a_np = batch.arrays()
            pending = {
                "first_id": batch.first_id,
                "last_id": batch.last_id,
                "n_changesets": batch.n_changesets,
                "removed": _canon_rows(d_np),
                "added": _canon_rows(a_np),
            }
        else:
            pending = None
        subs[s.jid] = {
            "expr": s.expr,
            "caps": s.caps,
            "since": s.since,
            "tau": to_numpy(s.tau),
            "rho": to_numpy(s.rho),
            "pending": pending,
        }
    return {
        "seq": broker._seq,
        "last_cid": broker._last_cid,
        "jid_next": broker._jid_next,
        "subs": subs,
    }


def assert_state_equal(a: Dict, b: Dict) -> None:
    """Bit-exact comparison of two :func:`broker_state` captures."""
    assert a["seq"] == b["seq"], (a["seq"], b["seq"])
    assert a["last_cid"] == b["last_cid"], (a["last_cid"], b["last_cid"])
    assert a["jid_next"] == b["jid_next"]
    assert sorted(a["subs"]) == sorted(b["subs"]), (
        sorted(a["subs"]), sorted(b["subs"]),
    )
    for jid, sa in a["subs"].items():
        sb = b["subs"][jid]
        assert sa["expr"] == sb["expr"], jid
        assert sa["caps"] == sb["caps"], (jid, sa["caps"], sb["caps"])
        assert sa["since"] == sb["since"], (jid, sa["since"], sb["since"])
        np.testing.assert_array_equal(sa["tau"], sb["tau"], err_msg=f"τ {jid}")
        np.testing.assert_array_equal(sa["rho"], sb["rho"], err_msg=f"ρ {jid}")
        pa, pb = sa["pending"], sb["pending"]
        assert (pa is None) == (pb is None), (jid, pa, pb)
        if pa is not None:
            for key in ("first_id", "last_id", "n_changesets"):
                assert pa[key] == pb[key], (jid, key, pa[key], pb[key])
            np.testing.assert_array_equal(pa["removed"], pb["removed"])
            np.testing.assert_array_equal(pa["added"], pb["added"])
