"""repro_torch's durable broker: journal, crash recovery, delivery (CPU, exact).

The recovery contract: a broker rebuilt by ``Broker.recover(journal,
store)`` is bit-identical to the crashed broker at every journal-record
boundary: the same τ/ρ rows, consumption frontiers, pending composed
batches and sequence clock (``repro_torch.testing.broker_state``). Delivery
faults degrade (retry, back off, quarantine with the frontier pinned and
the batch composing) and never halt ingest or touch a healthy subscriber.

* The goldens of ``tests/test_broker_recovery.py`` on the port alone, in
  the default configuration and with the lattice and the delta chain off,
  with the data of ``tests/test_broker_deferred.py`` and the reference's
  pinned literals: the port's recovered broker against the port's own
  uninterrupted one. The reference's random crash schedules become fixed,
  seeded ones.
* One module-scoped run of both packages, default configuration: a journal
  with small segments, a channel on a ``FakeClock`` with one failed
  delivery that backs off and catches up, a snapshot and a compaction.
  The journal segments are byte-identical, the snapshots equal, the
  states, statistics and delivery logs equal at every boundary; each
  package recovers the other's journal and snapshot to the other's state,
  and the port's run recovers at every boundary.

Every path comes from ``tmp_path`` / ``tmp_path_factory``; every channel
runs on a ``FakeClock``.
"""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro import testing as jtesting  # noqa: E402
from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import testing as ttesting  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.core.broker import _expr_to_json  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    CapturingJournal,
    FakeClock,
    ScriptedTransport,
    assert_state_equal,
    broker_state,
    corrupt_tail,
    crash_at_record,
    tear_tail,
    tiny_caps,
)
from test_broker_deferred import (  # noqa: E402
    CAPS as J_CAPS,
    _exprs,
    _stream,
    _universe,
    assert_results_identical,
)
from test_broker_recovery import _goal_stream  # noqa: E402
from test_torch_broker import LATTICE_OFF, TIMES  # noqa: E402

CONFIGS = {"default": {}, "lattice_off": LATTICE_OFF}
CAPS = tcore.StepCapacities(**dataclasses.asdict(J_CAPS))
# the boundary goldens stay free of capacity overflow: a fire that grows
# capacities before its record is appended would be captured with growth a
# recovery that never sees the record cannot reproduce
RCAPS = tcore.StepCapacities(n_removed=32, n_added=32, tau=128, rho=128, pulls=64)


def port_exprs():
    return [tcore.InterestExpr.parse(e.source, e.target, [p.slots() for p in e.bgp], [p.slots() for p in e.ogp])
            for e in _exprs()]


def universe():
    """``test_broker_deferred``'s universe as a port dictionary (same ids)."""
    d, tau0 = _universe()
    return tcore.load_dictionary([d.decode(i) for i in range(len(d))]), tau0


def new_broker(d, config, **kw):
    return tcore.Broker(d, device="cpu", **CONFIGS[config], **kw)


def recover(journal, store, d, config):
    return tcore.Broker.recover(journal, store, dictionary=d, device="cpu", **CONFIGS[config])


def reopen(directory):
    return tcore.ChangesetJournal(directory, fsync=False)


def capturing(path, captures, holder, **kw):
    """A journal that captures the broker's state before every append."""
    return CapturingJournal(path, fsync=False, **kw,
                            on_append=lambda seq, kind: captures.__setitem__(seq, broker_state(holder[0])))


# ---------------------------------------------------------------------------
# crash recovery goldens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def journaled_run(request, tmp_path_factory):
    """One journaled run with a mid-stream snapshot: three cadences, the
    state before every record, and the final state."""
    config = request.param
    tmp = tmp_path_factory.mktemp(f"durable-{config}")
    d, tau0 = universe()
    captures, holder = {}, []
    j = capturing(tmp / "wal", captures, holder)
    b = new_broker(d, config, journal=j)
    holder.append(b)
    exprs = port_exprs()
    policies = [tcore.PushPolicy(), tcore.PushPolicy.every(2), tcore.PushPolicy.every(3)]
    for i in range(3):
        b.subscribe(exprs[i], RCAPS, initial_target=tau0, policy=policies[i])
    store = CheckpointStore(tmp / "ckpt")
    for i, (rm, ad) in enumerate(_stream(d, 4, seed=3)):
        b.process_changeset(rm, ad)
        if i == 1:
            b.snapshot(store)  # mid-stream: pending batches straddle it
    b.flush()
    final = broker_state(b)
    j.sync()
    j.close()
    return dict(config=config, tmp=tmp, d=d, jdir=tmp / "wal", store=store, captures=captures, final=final,
                n=max(captures))


def test_crash_at_every_boundary_recovers_bit_identical(journaled_run):
    """Killed between any two appends, the broker recovers from the
    surviving prefix to the state captured before the next append (whose
    sequence tick it had already taken)."""
    run = journaled_run
    n, captures = run["n"], run["captures"]
    assert n >= 8 and run["store"].steps()
    for k in range(n + 1):
        cdst = run["tmp"] / f"crash{k}"
        assert crash_at_record(run["jdir"], cdst, k) == k
        j2 = reopen(cdst)
        assert j2.last_seq == k
        r = recover(j2, run["store"], run["d"], run["config"])
        want = run["final"] if k == n else {**captures[k + 1], "seq": k}
        assert_state_equal(want, broker_state(r))


@pytest.mark.parametrize("fault", ["tear1", "tear5", "tear17", "corrupt"])
def test_torn_or_corrupt_tail_recovers_to_previous_boundary(journaled_run, fault):
    run = journaled_run
    n = run["n"]
    cdst = run["tmp"] / fault
    shutil.copytree(run["jdir"], cdst)
    if fault == "corrupt":
        assert corrupt_tail(cdst, seed=7) > 0
    else:
        tear_tail(cdst, int(fault[4:]))
    j = reopen(cdst)
    assert j.torn and j.last_seq == n - 1 and j.dropped_bytes > 0
    r = recover(j, run["store"], run["d"], run["config"])
    assert_state_equal({**run["captures"][n], "seq": n - 1}, broker_state(r))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_recovery_from_journal_alone(tmp_path, config):
    """No snapshot: replaying the whole journal rebuilds the broker."""
    d, tau0 = universe()
    j = tcore.ChangesetJournal(tmp_path / "wal", fsync=False)
    b = new_broker(d, config, journal=j)
    exprs = port_exprs()
    b.subscribe(exprs[0], RCAPS, initial_target=tau0)
    b.subscribe(exprs[2], RCAPS, initial_target=tau0, policy=tcore.PushPolicy.every(2))
    for rm, ad in _stream(d, 3, seed=9):
        b.process_changeset(rm, ad)
    b.flush()
    j.sync()
    r = recover(reopen(tmp_path / "wal"), None, d, config)
    assert_state_equal(broker_state(b), broker_state(r))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_snapshot_compaction_preserves_recovery(tmp_path, config):
    """Snapshot, drop the segments replay no longer needs, keep streaming:
    recovery over the compacted journal is bit-identical."""
    d, tau0 = universe()
    j = tcore.ChangesetJournal(tmp_path / "wal", fsync=False, segment_bytes=256)
    b = new_broker(d, config, journal=j)
    exprs = port_exprs()
    for i in range(3):
        b.subscribe(exprs[i], CAPS, initial_target=tau0, policy=tcore.PushPolicy.every(2))
    store = CheckpointStore(tmp_path / "ckpt")
    removed = 0
    for i, (rm, ad) in enumerate(_stream(d, 10, seed=5)):
        b.process_changeset(rm, ad)
        if i == 6:
            b.snapshot(store)
            removed = b.compact_journal()
    b.flush()
    j.sync()
    assert removed > 0, "segment rotation + snapshot must free segments"
    r = recover(reopen(tmp_path / "wal"), store, d, config)
    assert_state_equal(broker_state(b), broker_state(r))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_recovery_refuses_overcompacted_journal(tmp_path, config):
    """A journal that starts past what replay needs fails loudly."""
    d, tau0 = universe()
    j = tcore.ChangesetJournal(tmp_path / "wal", fsync=False, segment_bytes=128)
    b = new_broker(d, config, journal=j)
    b.subscribe(port_exprs()[0], CAPS, initial_target=tau0)
    for rm, ad in _stream(d, 6, seed=4):
        b.process_changeset(rm, ad)
    j.sync()
    assert b.compact_journal() == 0  # no snapshot: replay needs seq 1
    assert j.compact(keep_from_seq=j.last_seq) > 0
    with pytest.raises(RuntimeError, match="compacted away or lost"):
        recover(reopen(tmp_path / "wal"), None, d, config)


# the reference's random schedules (cadences, stream seed, steps, crash
# point), drawn once from a fixed seed
_rng = np.random.default_rng(20261018)
SCHEDULES = [(int(_rng.integers(0, 2**16)), [int(k) for k in _rng.integers(1, 4, int(_rng.integers(1, 3)))],
              int(_rng.integers(2, 4)), float(_rng.random())) for _ in range(3)] + [(7, [1, 3], 3, 1.0), (8, [2], 2, 0.0)]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed,ks,n_steps,crash_frac", SCHEDULES)
def test_crash_boundary_seeded_schedules(tmp_path, config, seed, ks, n_steps, crash_frac):
    d, tau0 = universe()
    captures, holder = {}, []
    j = capturing(tmp_path / "wal", captures, holder)
    b = new_broker(d, config, journal=j)
    holder.append(b)
    exprs = port_exprs()
    for i, kk in enumerate(ks):
        b.subscribe(exprs[i % len(exprs)], RCAPS, initial_target=tau0, policy=tcore.PushPolicy.every(kk))
    for rm, ad in _stream(d, n_steps, seed=seed):
        b.process_changeset(rm, ad)
    b.flush()
    final = broker_state(b)
    j.close()
    n = max(captures)
    k = min(n, int(round(crash_frac * n)))
    assert crash_at_record(tmp_path / "wal", tmp_path / "crash", k) == k
    r = recover(reopen(tmp_path / "crash"), None, d, config)
    assert_state_equal(final if k == n else {**captures[k + 1], "seq": k}, broker_state(r))


# ---------------------------------------------------------------------------
# delivery: retry, backoff, quarantine, backpressure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
def test_quarantine_pins_frontier_and_composed_catchup(config):
    """A poisonous subscriber quarantines after three failed deliveries; its
    frontier pins while its batch composes, the healthy one is unaffected,
    and readmission delivers the composed window once. The catch-up oracle is
    a fault-free twin on the same schedule (deferred, one flush)."""
    clk = FakeClock()
    tr = ScriptedTransport(scripts={0: ["fail"] * 10}, clock=clk)
    ch = tcore.DeliveryChannel(tr, max_attempts=1, base_backoff_s=1.0, backoff_factor=2.0, jitter=0.0,
                               quarantine_after=3, clock=clk, sleep=clk.sleep)
    d, tau0 = universe()
    exprs = port_exprs()
    b = new_broker(d, config, channel=ch)
    s0 = b.subscribe(exprs[0], CAPS, initial_target=tau0)  # poisoned
    s1 = b.subscribe(exprs[2], CAPS, initial_target=tau0)  # healthy
    d2, tau0b = universe()
    twin = new_broker(d2, config)
    t0 = twin.subscribe(exprs[0], CAPS, initial_target=tau0b, policy=tcore.PushPolicy(every_k=None))
    t1 = twin.subscribe(exprs[2], CAPS, initial_target=tau0b)
    for i, ((rm, ad), (rm2, ad2)) in enumerate(zip(_stream(d, 6, seed=11), _stream(d2, 6, seed=11))):
        outs = b.process_changeset(rm, ad)
        outs_t = twin.process_changeset(rm2, ad2)
        assert_results_identical([outs[1]], [outs_t[1]], ("healthy", i))
        clk.advance(10.0)  # each backoff elapses between changesets
    assert ch.is_quarantined(s0) and ch.stats.quarantines == 1
    assert not ch.eligible(s0) and ch.eligible(s1)
    assert s0.since < s1.since
    assert b._batches[s0.since].n_changesets > 1  # the pinned window kept composing
    ch.readmit(s0)
    tr.scripts[0] = []
    b.flush([s0])
    assert s0.since > b._last_cid
    assert len(tr.delivered.get(0, [])) == 1
    twin.flush([t0])
    for got, want in ((s0, t0), (s1, t1)):
        np.testing.assert_array_equal(tcore.to_numpy(got.tau), tcore.to_numpy(want.tau))
        np.testing.assert_array_equal(tcore.to_numpy(got.rho), tcore.to_numpy(want.rho))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_backoff_schedule_golden(config):
    """jitter 0: a failed delivery at t=0 retries at 1.0, a second failure at
    t=1 retries at 3.0, the third attempt delivers and clears the state."""
    clk = FakeClock()
    tr = ScriptedTransport(scripts={0: ["fail"] * 2}, clock=clk)
    ch = tcore.DeliveryChannel(tr, max_attempts=1, base_backoff_s=1.0, backoff_factor=2.0, jitter=0.0,
                               quarantine_after=5, clock=clk, sleep=clk.sleep)
    d, tau0 = universe()
    b = new_broker(d, config, channel=ch)
    u0 = b.subscribe(port_exprs()[0], CAPS, initial_target=tau0)
    rm, ad = _stream(d, 1, seed=2)[0]
    b.process_changeset(rm, ad)  # attempt 1 fails at t=0
    assert ch.failures(u0) == 1 and ch.next_retry_at(u0) == 1.0
    assert not ch.retry_due(u0)
    clk.advance(1.0)
    assert ch.retry_due(u0)
    b.flush([u0])  # attempt 2 fails at t=1
    assert ch.failures(u0) == 2 and ch.next_retry_at(u0) == 3.0
    clk.advance(2.0)
    b.flush([u0])  # attempt 3 succeeds
    assert ch.failures(u0) == 0 and u0.since > b._last_cid
    assert tr.log == [(0, "fail"), (0, "fail"), (0, "ok")]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_backpressure_pump_terminates_into_quarantine(config):
    """A full retry queue blocks ingest on the fake clock and pumps retries
    until the poisonous subscriber quarantines; ingest never deadlocks."""
    clk = FakeClock()
    tr = ScriptedTransport(scripts={0: ["fail"] * 10}, clock=clk)
    ch = tcore.DeliveryChannel(tr, max_attempts=1, base_backoff_s=1.0, jitter=0.0, quarantine_after=2,
                               max_in_flight=1, clock=clk, sleep=clk.sleep)
    d, tau0 = universe()
    exprs = port_exprs()
    b = new_broker(d, config, channel=ch)
    s0 = b.subscribe(exprs[0], CAPS, initial_target=tau0)
    s1 = b.subscribe(exprs[2], CAPS, initial_target=tau0)
    for rm, ad in _stream(d, 4, seed=13):
        b.process_changeset(rm, ad)
    assert b._last_cid > 0 and ch.is_quarantined(s0)
    assert ch.in_flight() == 0
    assert s1.since > s0.since
    assert len(tr.delivered.get(1, [])) >= 1
    assert clk() == 1.0  # one backoff slept through, on the fake clock


@pytest.mark.parametrize("config", list(CONFIGS))
def test_timeout_counts_as_failed_delivery(config):
    clk = FakeClock()
    tr = ScriptedTransport(scripts={0: ["timeout"]}, clock=clk, timeout_advance=5.0)
    ch = tcore.DeliveryChannel(tr, max_attempts=1, timeout_s=1.0, jitter=0.0, base_backoff_s=1.0, clock=clk,
                               sleep=clk.sleep)
    d, tau0 = universe()
    b = new_broker(d, config, channel=ch)
    u0 = b.subscribe(port_exprs()[0], CAPS, initial_target=tau0)
    rm, ad = _stream(d, 1, seed=2)[0]
    b.process_changeset(rm, ad)
    assert ch.stats.timeouts == 1 and ch.failures(u0) == 1
    assert u0.since <= b._last_cid  # not committed


@pytest.mark.parametrize("config", list(CONFIGS))
def test_degraded_fire_ceiling_falls_back_bit_identical(config):
    """``max_fire_retries=0``: an overflowing fire goes through the
    per-interest step, with the same outputs and τ as the re-run path."""
    d, tau0 = universe()
    exprs = port_exprs()
    b_deg = new_broker(d, config, max_fire_retries=0)
    g0 = b_deg.subscribe(exprs[2], tiny_caps(), initial_target=tau0)
    d2, tau0b = universe()
    b_ret = new_broker(d2, config)
    g1 = b_ret.subscribe(exprs[2], tiny_caps(), initial_target=tau0b)
    for (rm, ad), (rm2, ad2) in zip(_goal_stream(d, 6), _goal_stream(d2, 6)):
        assert_results_identical(b_deg.process_changeset(rm, ad), b_ret.process_changeset(rm2, ad2), "degraded")
    np.testing.assert_array_equal(tcore.to_numpy(g0.tau), tcore.to_numpy(g1.tau))
    assert b_deg.degraded_fires > 0 and b_ret.degraded_fires == 0
    assert any(st.degraded_fires > 0 for st in b_deg.stats)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_unified_clock_journal_on_off_identical(tmp_path, config):
    """With or without a journal, subscribe, ingest and a committed fire
    each take one tick: the same ids, frontiers and statistics."""
    d, tau0 = universe()
    exprs = port_exprs()
    j = tcore.ChangesetJournal(tmp_path / "wal", fsync=False)
    bj = new_broker(d, config, journal=j)
    bn = new_broker(d, config)
    for b in (bj, bn):
        b.subscribe(exprs[0], CAPS, initial_target=tau0)
        b.subscribe(exprs[1], CAPS, initial_target=tau0, policy=tcore.PushPolicy.every(2))
    stream = _stream(d, 4, seed=17)
    for i, (rm, ad) in enumerate(stream):
        assert_results_identical(bj.process_changeset(rm, ad), bn.process_changeset(rm, ad), ("step", i))
        assert bj._seq == bn._seq and bj._last_cid == bn._last_cid
        assert [s.since for s in bj.subs] == [s.since for s in bn.subs]
    assert_results_identical(bj.flush(), bn.flush(), "flush")
    assert bj.stats[-1].seq == bn.stats[-1].seq == bj._seq
    assert stats_of(bj) == stats_of(bn)
    kinds = [r.kind for r in j.records()]
    assert kinds.count("subscribe") == 2 and kinds.count("ingest") == len(stream)
    assert kinds.count("fire") >= 1 and kinds[-1] == "fire"
    assert j.last_seq == bj._seq


# ---------------------------------------------------------------------------
# both packages, one run each: the same files, each recovers the other's
# ---------------------------------------------------------------------------

def stats_of(broker):
    return [{k: v for k, v in dataclasses.asdict(st).items() if k not in TIMES} for st in broker.stats]


def portable(state):
    """A ``broker_state`` capture with expressions and capacities as plain
    values, so that the two packages' captures compare."""
    subs = {jid: {**s, "expr": _expr_to_json(s["expr"]), "caps": dataclasses.asdict(s["caps"])}
            for jid, s in state["subs"].items()}
    return {**state, "subs": subs}


def cross_run(mod, testing, store_cls, tmp, d, tau0, exprs, caps, **broker_kw):
    """Three subscribers; the every(2) one fails its first delivery, backs
    off and catches up at the next ingest; a snapshot and a compaction after
    the third changeset; a closing flush."""
    clk = testing.FakeClock()
    tr = testing.ScriptedTransport(scripts={1: ["fail"]}, clock=clk)
    ch = mod.DeliveryChannel(tr, max_attempts=1, base_backoff_s=1.0, jitter=0.0, quarantine_after=3, clock=clk,
                             sleep=clk.sleep)
    captures, holder = {}, []
    j = testing.CapturingJournal(tmp / "wal", fsync=False, segment_bytes=512,
                                 on_append=lambda seq, kind: captures.__setitem__(seq, testing.broker_state(holder[0])))
    b = mod.Broker(d, journal=j, channel=ch, **broker_kw)
    holder.append(b)
    for i, pol in enumerate([mod.PushPolicy(), mod.PushPolicy.every(2), mod.PushPolicy()]):
        b.subscribe(exprs[(0, 2, 1)[i]], caps, initial_target=tau0, policy=pol)
    store = store_cls(tmp / "ckpt")
    removed = None
    for i, (rm, ad) in enumerate(_stream(d, 5, seed=21)):
        b.process_changeset(rm, ad)
        if i == 2:
            b.snapshot(store)
            removed = b.compact_journal()
        clk.advance(2.0)
    b.flush()
    j.sync()
    j.close()
    return dict(d=d, tmp=tmp, captures=captures, final=testing.broker_state(b), log=list(tr.log),
                delivery=dataclasses.asdict(ch.stats), stats=stats_of(b), removed=removed, n=max(captures),
                seq=b._seq)


@pytest.fixture(scope="module")
def cross_runs(tmp_path_factory):
    jd, tau0 = _universe()
    ref = cross_run(jcore, jtesting, JStore, tmp_path_factory.mktemp("ref"), jd, tau0, _exprs(), J_CAPS)
    td, tau0 = universe()
    port = cross_run(tcore, ttesting, CheckpointStore, tmp_path_factory.mktemp("port"), td, tau0, port_exprs(), CAPS,
                     device="cpu")
    return ref, port


def segments(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.glob("wal_*.seg"))}


def test_cross_run_journals_snapshots_and_states_are_identical(cross_runs):
    ref, port = cross_runs
    assert ref["log"] == port["log"]
    fails = [i for i, entry in enumerate(port["log"]) if entry == (1, "fail")]
    assert len(fails) == 1 and (1, "ok") in port["log"][fails[0]:]  # it backed off and caught up
    assert ref["delivery"] == port["delivery"] and port["delivery"]["failures"] == 1
    assert ref["removed"] == port["removed"] > 0
    wal = segments(port["tmp"] / "wal")
    assert segments(ref["tmp"] / "wal") == wal and len(wal) > 1
    step = CheckpointStore(port["tmp"] / "ckpt").steps()
    assert JStore(ref["tmp"] / "ckpt").steps() == step and len(step) == 1
    manifests = [(run["tmp"] / "ckpt" / f"step_{step[0]:09d}" / "manifest.json").read_text() for run in (ref, port)]
    assert manifests[0] == manifests[1]
    r_arrays, r_extra = JStore(ref["tmp"] / "ckpt").load_raw(step[0])
    p_arrays, p_extra = CheckpointStore(port["tmp"] / "ckpt").load_raw(step[0])
    assert list(r_arrays) == list(p_arrays) and r_extra == p_extra
    for k in r_arrays:
        np.testing.assert_array_equal(r_arrays[k], p_arrays[k])
    assert ref["stats"] == port["stats"] and ref["n"] == port["n"] == ref["seq"]
    assert sorted(ref["captures"]) == sorted(port["captures"])
    for seq in ref["captures"]:
        assert_state_equal(portable(ref["captures"][seq]), portable(port["captures"][seq]))
    assert_state_equal(portable(ref["final"]), portable(port["final"]))


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_each_package_recovers_the_others_journal_and_snapshot(cross_runs, tmp_path, reader):
    ref, port = cross_runs
    writer = port if reader == "ref" else ref
    shutil.copytree(writer["tmp"] / "wal", tmp_path / "wal")
    shutil.copytree(writer["tmp"] / "ckpt", tmp_path / "ckpt")
    if reader == "port":
        got = tcore.Broker.recover(reopen(tmp_path / "wal"), CheckpointStore(tmp_path / "ckpt"),
                                   dictionary=port["d"], device="cpu")
        state = broker_state(got)
    else:
        got = jcore.Broker.recover(jcore.ChangesetJournal(tmp_path / "wal", fsync=False), JStore(tmp_path / "ckpt"),
                                   dictionary=ref["d"])
        state = jtesting.broker_state(got)
    assert_state_equal(portable(writer["final"]), portable(state))


def test_cross_run_recovers_at_every_boundary_on_the_port(cross_runs, tmp_path):
    """The port's channel run (a failed delivery, its retry, a compacted
    journal): every boundary from the snapshot on recovers to its capture;
    a crash before the snapshot finds its records compacted away."""
    _, run = cross_runs
    store = CheckpointStore(run["tmp"] / "ckpt")
    snap = store.steps()[-1]
    first = next(iter(reopen(run["tmp"] / "wal").records())).seq
    assert first > 1
    for k in range(first, run["n"] + 1):
        cdst = tmp_path / f"crash{k}"
        assert crash_at_record(run["tmp"] / "wal", cdst, k - first + 1) == k - first + 1
        j = reopen(cdst)
        assert j.last_seq == k
        if k < snap:
            with pytest.raises(RuntimeError, match="compacted away or lost"):
                tcore.Broker.recover(j, store, dictionary=run["d"], device="cpu")
            continue
        r = tcore.Broker.recover(j, store, dictionary=run["d"], device="cpu")
        want = run["final"] if k == run["n"] else {**run["captures"][k + 1], "seq": k}
        assert_state_equal(want, broker_state(r))
