"""repro_torch's journal, delivery channel, checkpoint store and fault
harness against repro's (CPU, exact, no broker).

* The same appends give byte-identical segment files, which each package
  reads back; rotation and compaction drop the same segments; torn and
  corrupt tails (each package's own ``tear_tail`` / ``corrupt_tail``)
  truncate to the same boundary on open, and ``crash_at_record`` keeps the
  same prefix.
* The delivery channel's retry, backoff (with seeded jitter), timeout and
  quarantine schedule on a ``FakeClock`` is the reference's, call for call;
  with jitter 0 it is the exact exponential schedule.
* Each package's ``CheckpointStore.load_raw`` reads the other's snapshot:
  the same keys in the same order (sorted dict keys, so ``"10"`` before
  ``"2"``), the same arrays and the same manifest.

Every path comes from ``tmp_path``; every clock is a ``FakeClock``.
"""
import json
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.core.delivery import DeliveryChannel as JChannel  # noqa: E402
from repro.core.journal import ChangesetJournal as JJournal  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.checkpoint import CheckpointStore as TStore  # noqa: E402
from repro_torch.core import ChangesetJournal as TJournal  # noqa: E402
from repro_torch.core import DeliveryChannel as TChannel  # noqa: E402
from repro_torch.core import DeliveryStats  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402

PACKAGES = {"ref": (JJournal, jfaults), "port": (TJournal, tfaults)}


def fill(journal, n, seed=0):
    """``n`` ingest-like records with seeded arrays of 0-3 and 1-4 rows, a
    metadata dict and, every fifth, an empty record."""
    rng = np.random.default_rng(seed)
    for i in range(1, n + 1):
        if i % 5 == 0:
            journal.append("fire", meta={"fires": [[i % 3, i + 1]]})
            continue
        journal.append(
            "ingest",
            meta={"i": i},
            arrays={
                "removed": rng.integers(0, 99, (i % 3, 3)).astype(np.int32),
                "added": rng.integers(0, 99, (1 + i % 4, 3)).astype(np.int32),
            },
        )


def segment_bytes_of(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.glob("wal_*.seg"))}


def records_of(journal):
    return [(r.seq, r.kind, r.meta, {k: v.tolist() for k, v in r.arrays.items()}) for r in journal.records()]


def filled_pair(tmp_path, n, **kw):
    out = {}
    for name, (journal_cls, _) in PACKAGES.items():
        j = journal_cls(tmp_path / name, fsync=False, **kw)
        fill(j, n)
        j.close()
        out[name] = tmp_path / name
    return out


@pytest.mark.parametrize("segment_bytes", [4 << 20, 256])
def test_same_appends_give_byte_identical_segments(tmp_path, segment_bytes):
    dirs = filled_pair(tmp_path, 12, segment_bytes=segment_bytes)
    ref, port = segment_bytes_of(dirs["ref"]), segment_bytes_of(dirs["port"])
    assert ref == port
    assert (len(port) > 3) == (segment_bytes == 256)
    # each package reads the other's files, and appends continue the sequence
    read = {}
    for reader, (journal_cls, _) in PACKAGES.items():
        for writer, d in dirs.items():
            j = journal_cls(d, fsync=False)
            assert j.last_seq == 12 and not j.torn and j.dropped_bytes == 0
            read[reader, writer] = records_of(j)
    assert len({json.dumps(v) for v in read.values()}) == 1
    assert [r[0] for r in read["port", "port"]] == list(range(1, 13))
    j = TJournal(dirs["port"], fsync=False)
    assert j.append("ingest", meta={"i": 13}) == 13
    assert [r.seq for r in j.records(start_seq=12)] == [12, 13]


def test_rotation_and_compaction_drop_the_same_segments(tmp_path):
    dirs = filled_pair(tmp_path, 20, segment_bytes=256)
    kept = {}
    for name, (journal_cls, _) in PACKAGES.items():
        j = journal_cls(dirs[name], fsync=False, segment_bytes=256)
        removed = j.compact(keep_from_seq=12)
        seqs = [r.seq for r in j.records()]
        assert removed > 0 and seqs[0] <= 12 and seqs[-1] == 20
        assert set(seqs) >= set(range(12, 21))
        assert j.compact(keep_from_seq=1) == 0
        assert j.append("ingest", meta={"i": 21}) == 21
        j.close()
        kept[name] = (removed, segment_bytes_of(dirs[name]))
    assert kept["ref"] == kept["port"]


@pytest.mark.parametrize("fault", ["tear1", "tear5", "tear17", "corrupt"])
def test_torn_and_corrupt_tails_truncate_to_the_same_boundary(tmp_path, fault):
    src = filled_pair(tmp_path, 5)["ref"]
    after = {}
    for name, (journal_cls, faults) in PACKAGES.items():
        d = tmp_path / f"{fault}-{name}"
        shutil.copytree(src, d)
        if fault == "corrupt":
            assert faults.corrupt_tail(d, seed=7) > 0
        else:
            cut = int(fault[4:])
            assert faults.tear_tail(d, cut) == cut
        faulty = segment_bytes_of(d)
        j = journal_cls(d, fsync=False)
        assert j.torn and j.last_seq == 4 and j.dropped_bytes > 0
        assert [r.seq for r in j.records()] == [1, 2, 3, 4]
        assert j.append("ingest", meta={"i": 5}) == 5  # the torn slot is reused
        j.close()
        after[name] = (faulty, j.dropped_bytes, segment_bytes_of(d))
    assert after["ref"] == after["port"]


@pytest.mark.parametrize("k", [0, 3, 7, 20, 25])
def test_crash_at_record_keeps_the_same_prefix(tmp_path, k):
    src = filled_pair(tmp_path, 20, segment_bytes=256)["port"]
    copies = {}
    for name, (journal_cls, faults) in PACKAGES.items():
        d = tmp_path / f"crash-{name}"
        assert faults.crash_at_record(src, d, k) == min(k, 20)
        assert journal_cls(d, fsync=False).last_seq == min(k, 20)
        copies[name] = segment_bytes_of(d)
    assert copies["ref"] == copies["port"]


class Sub:
    """The two attributes a channel reads of a subscriber."""

    def __init__(self, serial, jid):
        self.serial, self.jid, self.transport = serial, jid, None


def channel_schedule(channel_cls, faults, jitter):
    """Three subscribers on one channel of two attempts a delivery: one
    fails its first delivery and acks its second, one is slower than the
    timeout once, one fails until quarantined; the clock waits for the next
    retry between rounds."""
    clk = faults.FakeClock()
    tr = faults.ScriptedTransport(scripts={0: ["fail", "fail", "fail", "ok"], 1: ["timeout"], 2: ["fail"] * 20},
                                  clock=clk, timeout_advance=5.0)
    ch = channel_cls(tr, max_attempts=2, base_backoff_s=0.5, backoff_factor=3.0, max_backoff_s=4.0, jitter=jitter,
                     timeout_s=1.0, quarantine_after=4, max_in_flight=2, clock=clk, sleep=clk.sleep, seed=3)
    subs = [Sub(10 + j, j) for j in range(3)]
    trace = []
    for _ in range(8):
        for s in subs:
            if ch.eligible(s):
                ok = ch.deliver(s, ("outputs", s.jid))
                trace.append((s.jid, ok, clk(), ch.failures(s), ch.next_retry_at(s), ch.is_quarantined(s)))
        trace.append(("in flight", ch.in_flight()))
        ch.wait_for_retry()
        trace.append(("clock", clk()))
    return trace, tr.log, vars(ch.stats)


@pytest.mark.parametrize("jitter", [0.0, 0.25])
def test_backoff_schedule_on_a_fake_clock_equals_the_reference(jitter):
    ref = channel_schedule(JChannel, jfaults, jitter)
    port = channel_schedule(TChannel, tfaults, jitter)
    assert port == ref
    trace, log, stats = port
    assert stats == vars(DeliveryStats(**stats))
    assert stats["quarantines"] == 1 and stats["timeouts"] == 1
    assert (0, "ok") in log and log.count((2, "fail")) == 8  # 4 deliveries of 2 attempts, then quarantine
    if jitter == 0.0:
        # exact exponential backoff: an in-call sleep of 0.5 between the two
        # attempts, then the next retry 0.5 x 3^(failures - 1) later, capped
        # at 4.0; the fourth failed delivery quarantines
        assert [t for t in trace if t[0] == 0][:2] == [(0, False, 0.5, 1, 1.0, False), (0, True, 7.0, 0, None, False)]
        assert [t for t in trace if t[0] == 2] == [(2, False, 6.5, 1, 7.0, False), (2, False, 7.5, 2, 9.0, False),
                                                   (2, False, 9.5, 3, 13.5, False), (2, False, 14.0, 4, None, True)]


def test_checkpoint_stores_read_each_other(tmp_path):
    rng = np.random.default_rng(5)
    state = {
        "subs": {
            str(j): {"tau": rng.integers(0, 50, (j % 4, 3)).astype(np.int32),
                     "rho": rng.integers(0, 50, (2, 3)).astype(np.int32)}
            for j in (0, 1, 2, 10, 11)
        },
        "other": {"b": np.arange(5, dtype=np.int64), "a": [np.float32(1.5), np.zeros((2, 2), np.float64)]},
    }
    extra = {"seq": 7, "subs": [{"jid": 10, "since": 3}]}
    stores = {"ref": JStore(tmp_path / "ref"), "port": TStore(tmp_path / "port")}
    for step in (3, 7):
        for store in stores.values():
            store.save(step, state, {**extra, "seq": step})
    for name, store in stores.items():
        assert store.steps() == [3, 7] and store.latest_step() == 7
    manifests = {name: (tmp_path / name / "step_000000007" / "manifest.json").read_text() for name in stores}
    assert manifests["ref"] == manifests["port"]
    keys = json.loads(manifests["port"])["keys"]
    assert keys.index("subs/10/rho") < keys.index("subs/2/rho")
    loads = {(reader, writer): stores[reader].__class__(tmp_path / writer).load_raw(7)
             for reader in stores for writer in stores}
    want_arrays, want_extra = loads["ref", "ref"]
    for (reader, writer), (arrays, got_extra) in loads.items():
        assert list(arrays) == list(want_arrays), (reader, writer)
        for k, v in want_arrays.items():
            assert arrays[k].dtype == v.dtype and arrays[k].shape == v.shape, (reader, writer, k)
            np.testing.assert_array_equal(arrays[k], v)
        assert got_extra == want_extra == {**extra, "seq": 7}
    np.testing.assert_array_equal(want_arrays["subs/10/tau"], state["subs"]["10"]["tau"])


def test_package_exports_the_durable_broker_and_make_cohort_step():
    import repro_torch
    from repro_torch import core
    from repro_torch.core import broker, delivery, journal

    assert core.make_cohort_step is repro_torch.make_cohort_step is broker.make_cohort_step
    for name in ("ChangesetJournal", "JournalRecord", "DeliveryChannel", "DeliveryStats", "make_cohort_step"):
        assert name in core.__all__ and name in repro_torch.__all__, name
    assert core.ChangesetJournal is journal.ChangesetJournal and core.DeliveryStats is delivery.DeliveryStats
    assert repro_torch.checkpoint.CheckpointStore is TStore and repro_torch.testing.faults is tfaults
