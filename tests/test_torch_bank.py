"""repro_torch's pattern banks against repro's (numpy only, exact).

``PatternBank`` / ``build_pattern_bank`` and ``IncrementalPatternBank`` are
copies; these tests hold lane numbering, tombstone reuse, compaction remaps
and ``patterns_padded`` equal to the reference's under the same churn, and
check ``IncrementalPatternBank.restore`` (the broker state carry).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402

A = "rdf:type"


def star2(mod, target, cls, pred):
    return mod.InterestExpr.parse("g", target, bgp=[("?a", A, cls), ("?a", pred, "?v")])


def plan_pair(d_ref, d_port, target, cls, pred):
    """The same interest compiled by both packages over equal dictionaries."""
    p_ref = jcore.compile_interest(star2(jcore, target, cls, pred), d_ref)
    p_port = tcore.compile_interest(star2(tcore, target, cls, pred), d_port)
    np.testing.assert_array_equal(p_port.patterns, p_ref.patterns)
    return p_ref, p_port


def dictionaries():
    return jcore.Dictionary(), tcore.Dictionary()


def assert_banks_equal(port, ref):
    assert port.n_lanes == ref.n_lanes
    assert port.n_live == ref.n_live
    assert port.n_words == ref.n_words
    assert port.n_lanes_padded == ref.n_lanes_padded
    assert port.version == ref.version
    assert port.live_lanes() == ref.live_lanes()
    np.testing.assert_array_equal(port.patterns_padded(), ref.patterns_padded())


def test_pattern_bank_dedup_matches_reference():
    d_ref, d_port = dictionaries()
    pairs = [
        plan_pair(d_ref, d_port, "t1", "dbo:Athlete", "dbp:goals"),
        plan_pair(d_ref, d_port, "t2", "dbo:Athlete", "foaf:name"),
        plan_pair(d_ref, d_port, "t3", "dbo:Team", "dbp:goals"),
    ]
    ref = jcore.build_pattern_bank([r for r, _ in pairs])
    port = tcore.build_pattern_bank([p for _, p in pairs])
    # "?x rdf:type dbo:Athlete" and "?x dbp:goals ?v" are shared
    assert port.n_lanes == ref.n_lanes == 4 and port.n_words == ref.n_words == 1
    assert port.lanes == ref.lanes == ((0, 1), (0, 2), (3, 1))
    np.testing.assert_array_equal(port.patterns, ref.patterns)
    for lanes, (_, plan) in zip(port.lanes, pairs):
        np.testing.assert_array_equal(port.patterns[list(lanes)], plan.patterns)


def test_incremental_bank_stable_lanes_and_tombstones():
    d_ref, d_port = dictionaries()
    ref, port = jcore.IncrementalPatternBank(), tcore.IncrementalPatternBank()
    pairs = [plan_pair(d_ref, d_port, f"t{i}", "c:A", f"p:{x}") for i, x in enumerate("xyz")]
    l1 = port.add_plan(pairs[0][1])
    l2 = port.add_plan(pairs[1][1])
    assert (l1, l2) == (ref.add_plan(pairs[0][0]), ref.add_plan(pairs[1][0])) == ((0, 1), (0, 2))
    port.remove_plan(l2)
    ref.remove_plan(l2)
    assert port.n_live == 2 and port.n_lanes == 3  # the shared lane survives
    assert_banks_equal(port, ref)
    assert port.patterns_padded().shape == (32, 3)
    # the tombstoned lane is reused by the next registration: no growth
    l3 = port.add_plan(pairs[2][1])
    assert l3 == ref.add_plan(pairs[2][0]) and set(l3) == {0, 2} and port.n_lanes == 3
    assert_banks_equal(port, ref)


def test_incremental_bank_compaction_remap():
    d_ref, d_port = dictionaries()
    ref, port = jcore.IncrementalPatternBank(), tcore.IncrementalPatternBank()
    pairs = [plan_pair(d_ref, d_port, f"t{i}", f"c:{i}", f"p:{i}") for i in range(4)]
    lanes = [port.add_plan(p) for _, p in pairs]
    assert lanes == [ref.add_plan(r) for r, _ in pairs]
    for ln in lanes[:3]:
        port.remove_plan(ln)
        ref.remove_plan(ln)
    # below the 32-lane padded floor compaction cannot shrink the device bank
    assert port.maybe_compact() is None and ref.maybe_compact() is None
    remap = port.maybe_compact(force=True)
    assert remap == ref.maybe_compact(force=True)
    assert {remap[lane] for lane in lanes[3]} == {0, 1}
    assert_banks_equal(port, ref)
    assert port.maybe_compact(force=True) is None  # idempotent


def test_compaction_fires_only_on_padded_boundary_shrink():
    d_ref, d_port = dictionaries()
    ref, port = jcore.IncrementalPatternBank(), tcore.IncrementalPatternBank()
    pairs = [plan_pair(d_ref, d_port, f"t{i}", f"c:{i}", f"p:{i}") for i in range(17)]
    lanes = [port.add_plan(p) for _, p in pairs]
    assert lanes == [ref.add_plan(r) for r, _ in pairs]
    assert port.n_lanes == 34 and port.n_lanes_padded == 64
    port.remove_plan(lanes[0])
    ref.remove_plan(lanes[0])
    remap = port.maybe_compact()
    assert remap is not None and remap == ref.maybe_compact()
    assert port.n_lanes == 32 and port.n_lanes_padded == 32
    assert_banks_equal(port, ref)
    moved = tuple(remap[lane] for lane in lanes[1])
    port.remove_plan(moved)
    ref.remove_plan(moved)
    assert port.maybe_compact() is None and ref.maybe_compact() is None


def test_incremental_bank_matches_batch_build():
    d_ref, d_port = dictionaries()
    pairs = [plan_pair(d_ref, d_port, f"t{i}", f"c:{i % 2}", f"p:{i}") for i in range(5)]
    bank = tcore.IncrementalPatternBank()
    lanes = [bank.add_plan(p) for _, p in pairs]
    batch = tcore.build_pattern_bank([p for _, p in pairs])
    assert tuple(lanes) == batch.lanes == jcore.build_pattern_bank([r for r, _ in pairs]).lanes
    np.testing.assert_array_equal(bank.patterns_padded()[: batch.n_lanes], batch.patterns)


def churn(seed, n_steps, pairs, banks, on_step=None):
    """A seeded subscribe/unsubscribe/compact sequence applied to every bank;
    returns the live lane maps (equal across banks)."""
    rng = np.random.default_rng(seed)
    live = []  # (plan index, lanes)
    for step in range(n_steps):
        op = rng.random()
        if op < 0.55 or not live:
            i = int(rng.integers(0, len(pairs)))
            got = [b.add_plan(pairs[i][bi]) for bi, b in enumerate(banks)]
            assert all(g == got[0] for g in got), step
            live.append((i, got[0]))
        elif op < 0.9:
            i, lanes = live.pop(int(rng.integers(0, len(live))))
            for b in banks:
                b.remove_plan(lanes)
        else:
            force = bool(rng.random() < 0.5)
            remaps = [b.maybe_compact(force=force) for b in banks]
            assert all(r == remaps[0] for r in remaps), step
            if remaps[0] is not None:
                live = [(i, tuple(remaps[0][lane] for lane in lanes)) for i, lanes in live]
        if on_step is not None:
            on_step(step, live)
    return live


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_churn_keeps_banks_equal(seed):
    d_ref, d_port = dictionaries()
    pairs = [
        plan_pair(d_ref, d_port, f"t{i}", f"c:{i % 3}", f"p:{i % 11}")[::-1] for i in range(24)
    ]  # (port plan, reference plan)
    port, ref = tcore.IncrementalPatternBank(), jcore.IncrementalPatternBank()

    def check(step, live):
        assert_banks_equal(port, ref)
        for i, lanes in live:
            np.testing.assert_array_equal(port.patterns_padded()[list(lanes)], pairs[i][0].patterns)

    churn(seed, 120, pairs, [port, ref], check)


def test_restore_continues_like_the_reference():
    d_ref, d_port = dictionaries()
    pairs = [
        plan_pair(d_ref, d_port, f"t{i}", f"c:{i % 3}", f"p:{i % 7}")[::-1] for i in range(20)
    ]
    ref = jcore.IncrementalPatternBank()
    live = churn(5, 60, pairs, [ref])
    for _, lanes in live[: len(live) // 2]:
        ref.remove_plan(lanes)
    assert ref._free  # the carried state holds tombstones
    port = tcore.IncrementalPatternBank.restore(ref._rows, ref._refs, ref._free)
    assert port.n_lanes == ref.n_lanes and port.n_live == ref.n_live
    np.testing.assert_array_equal(port.patterns_padded(), ref.patterns_padded())
    churn(6, 60, pairs, [port, ref])
    np.testing.assert_array_equal(port.patterns_padded(), ref.patterns_padded())
    assert port.live_lanes() == ref.live_lanes()


def test_restore_refuses_inconsistent_states():
    row = (1, 2, 3)
    tcore.IncrementalPatternBank.restore([row, None], [1, 0], [1])
    for rows, refs, free in (
        ([row, None], [1, 0], []),  # a tombstone missing from the free list
        ([row, row], [1, 1], []),  # two live lanes with one row
        ([row], [0], []),  # a live lane without references
        ([row, None], [1], [1]),  # one count per lane
    ):
        with pytest.raises(ValueError):
            tcore.IncrementalPatternBank.restore(rows, refs, free)
