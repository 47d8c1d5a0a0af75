"""repro_torch's default Broker against repro's default Broker, over a stream (CPU, exact).

Both packages' ``Broker(d)``: the subsumption lattice with delta frontier
chains, driven by ``tests/test_torch_broker.py``'s runner with no options.

* A fixed-seed stream of seven subscribers drawn from a pool with
  duplicates, a renaming, contained interests (virtual lanes) and a pattern
  reorder, under four policies, with unsubscribes (one of them a lane
  group's root) and partial flushes; every step equals the reference, and
  every fire the port's ``IrapEngine`` on the subscriber's original
  expression.
* The reference broker of that stream, flushed, carried into the port
  (virtual lanes, lane groups, share index, history table); both continue
  equal.
* A fire whose composed batch is empty: both brokers, lattice on and off,
  return empty outputs and leave τ and ρ as they are, while the
  per-interest engine and the oracle re-evaluate ``I = A ∪ ρ`` and report
  the potential rows of ρ again in ``a_i``. The port follows the reference
  broker; the difference is pinned here. Such fires also run no pass, so a
  new cohort's step is built at the next changeset with rows, in both
  packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro.core.oracle import OracleEvaluator as JOracle  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.oracle import OracleEvaluator  # noqa: E402
from test_torch_broker import (  # noqa: E402
    EMPTY,
    LATTICE_OFF,
    OUT_FIELDS,
    assert_runs_equal,
    check_against_engine,
    run_script,
    store_np,
)


# ---------------------------------------------------------------------------
# a fixed-seed stream with churn, four policies
# ---------------------------------------------------------------------------

STREAM_TERMS = ["type", "goals", "rank", "Athlete", "Team"] + [f"e{i}" for i in range(6)] + [f"o{i}" for i in range(4)]
STREAM_CAPS = dict(n_removed=8, n_added=8, tau=64, rho=32, pulls=64, fanout=4)
# duplicates (0, 2), a renaming (0, 5), containment (1 and 4 under 0), a
# pattern reorder (3, 6)
POOL = [
    ([("?a", "goals", "?v")], []),
    ([("e0", "goals", "?v")], []),
    ([("?a", "goals", "?v")], []),
    ([("?a", "type", "Athlete"), ("?a", "goals", "?v")], []),
    ([("e1", "goals", "?v")], []),
    ([("?z", "goals", "?w")], []),
    ([("?q", "goals", "?r"), ("?q", "type", "Athlete")], [("?q", "rank", "?k")]),
]


def stream_rows(rng, k):
    ids = {t: i for i, t in enumerate(STREAM_TERMS)}
    subj = [ids[f"e{i}"] for i in range(6)]
    pred = [ids[x] for x in ("type", "goals", "rank")]
    obj = [ids[x] for x in ("Athlete", "Team", "o0", "o1")]
    rows = {(subj[rng.integers(6)], pred[rng.integers(3)], obj[rng.integers(4)]) for _ in range(k)}
    return np.asarray(sorted(rows), np.int32).reshape(-1, 3)


def stream_script():
    rng = np.random.default_rng(11)
    cs = [(stream_rows(rng, 3), stream_rows(rng, 5)) for _ in range(7)]
    tau0 = stream_rows(rng, 6)

    def sub(name, i, pol, init=tau0):
        return ("sub", name, POOL[i], STREAM_CAPS, pol, init, False)

    return [
        sub("t#a", 0, ("eager",)),
        sub("t#b", 2, ("eager",)),  # joins t#a
        sub("t#c", 1, ("every", 2)),  # a virtual lane under (?a goals ?v)
        sub("t#d", 3, ("stale",)),
        sub("t#e", 6, ("priority",)),
        ("cs", *cs[0]),
        sub("t#f", 4, ("every", 2), None),  # a second virtual lane, its own frontier
        ("cs", *cs[1]),
        ("cs", *cs[2]),
        ("unsub", "t#a"),  # t#b stays, the root moves to it
        sub("t#g", 5, ("stale",)),
        ("cs", *cs[3]),
        ("cs", *cs[4]),
        ("flush", ["t#d"]),
        ("cs", *cs[5]),
        ("unsub", "t#c"),
        ("cs", *cs[6]),
        ("flush",),  # several frontiers through the chain, with refined words
    ]


@pytest.fixture(scope="module")
def stream_reference():
    return run_script(jcore, STREAM_TERMS, stream_script())


def test_stream_with_churn_equals_reference(stream_reference):
    port = run_script(tcore, STREAM_TERMS, stream_script())
    assert_runs_equal(port, stream_reference)
    broker = port[0]
    flush = broker.stats[-1]
    assert flush.n_evaluated >= 2 and flush.rows_matched == flush.rows_distinct
    assert any(k[0] == "words-seg" and k[2] > k[3] for k in broker._exec_cache)  # chain + virtual words
    assert sum(st.fanout_copies - st.distinct_interests for st in broker.stats) > 0


def test_stream_with_churn_equals_port_engine():
    assert check_against_engine(STREAM_TERMS, stream_script()) > 20


def test_state_carry_of_a_default_broker_continues_equal(stream_reference):
    """The stream's reference broker, flushed, moves into a port broker with
    its virtual lanes, lane groups, share index and history table; both then
    take more changesets and a subscription that joins a carried group."""
    r_broker = stream_reference[0]
    order = list(r_broker.subs)
    lineages = {}
    states = []
    for s in order:
        sig = s.canon_sig
        states.append(tcore.state.SubscriberState(
            expr=tcore.InterestExpr.parse(s.expr.source, s.expr.target, [p.slots() for p in s.expr.bgp],
                                          [p.slots() for p in s.expr.ogp]),
            caps=tcore.StepCapacities(**dataclasses.asdict(s.caps)),
            policy=tcore.PushPolicy(**dataclasses.asdict(s.policy)),
            tau=store_np(s.tau), rho=store_np(s.rho), lanes=s.lanes, since=s.since,
            canon_sig=(sig[0], tcore.StepCapacities(**dataclasses.asdict(sig[1])),
                       tcore.PushPolicy(**dataclasses.asdict(sig[2]))),
            lineage=lineages.setdefault(id(s.share_tag), len(lineages)), epoch=s.epoch,
        ))
    bank = r_broker.bank
    roots = [order.index(root) for root in r_broker._share_index.values()]
    port = tcore.carry_broker(
        STREAM_TERMS, bank.bank._rows, bank.bank._refs, bank.bank._free, states, seq=r_broker._seq,
        last_cid=r_broker._last_cid, device="cpu", virtual_rows=bank._vrows, virtual_refs=bank._vrefs,
        virtual_free=bank._vfree, share_roots=roots, epoch_intern=r_broker._epoch_intern,
        epoch_next=r_broker._epoch_next,
    )
    assert port.bank.n_virtual == bank.n_virtual > 0
    np.testing.assert_array_equal(port.bank.patterns_padded(), bank.patterns_padded())
    rng = np.random.default_rng(12)
    cs = [(stream_rows(rng, 3), stream_rows(rng, 5)) for _ in range(3)]
    more = [("cs", *cs[0]), ("sub", "late", POOL[2], STREAM_CAPS, ("eager",), None, False),
            ("cs", *cs[1]), ("cs", *cs[2]), ("flush",)]
    ref_more = run_script(jcore, STREAM_TERMS, more, broker=r_broker)
    port_more = run_script(tcore, STREAM_TERMS, more, broker=port)
    for p, r in zip(port_more[2], ref_more[2]):
        assert p["seq"] == r["seq"] and (p["outs"] is None) == (r["outs"] is None)
        for name, ((pt, ptn), (pr, prn), psince) in p["states"].items():
            (rt, rtn), (rr, rrn), rsince = r["states"][name]
            np.testing.assert_array_equal(pt, rt)
            np.testing.assert_array_equal(pr, rr)
            assert (ptn, prn, psince) == (rtn, rrn, rsince)
        if r["outs"] is not None:
            for po, ro in zip(p["outs"], r["outs"]):
                assert (po is None) == (ro is None)
                if ro is not None:
                    for f in ("r", "r_i", "r_prime", "a", "a_i"):
                        np.testing.assert_array_equal(po[f][0], ro[f][0])
    assert port_more[3] == ref_more[3][-len(port_more[3]):]
    assert lane_groups(port) == lane_groups(r_broker)


def lane_groups(broker):
    """Each subscriber's lane group, as the position of its first member."""
    first = {}
    return [first.setdefault(id(s.share_tag), k) for k, s in enumerate(broker.subs)]


# ---------------------------------------------------------------------------
# a fire whose composed batch is empty
# ---------------------------------------------------------------------------

EMPTY_CAPS = dict(n_removed=6, n_added=6, tau=64, rho=32, pulls=64, fanout=4)
GOALS = ([("?a", "goals", "?v")], [])
ATHLETE_GOALS = ([("?a", "type", "Athlete"), ("?a", "goals", "?v")], [])


def empty_fire_script():
    """Subscribe (?a goals ?v); an empty changeset; subscribe (?a type
    Athlete)(?a goals ?v); a changeset adding (e0 type Athlete), which goes to
    the second subscriber's ρ; unsubscribe the first; an empty changeset."""
    ids = {t: i for i, t in enumerate(STREAM_TERMS)}
    athlete = np.asarray([[ids["e0"], ids["type"], ids["Athlete"]]], np.int32)
    script = [
        ("sub", "t#0", GOALS, EMPTY_CAPS, ("eager",), None, False),
        ("cs", EMPTY, EMPTY),
        ("sub", "t#1", ATHLETE_GOALS, EMPTY_CAPS, ("eager",), None, False),
        ("cs", EMPTY, athlete),
        ("unsub", "t#0"),
        ("cs", EMPTY, EMPTY),
    ]
    return script, athlete


@pytest.mark.parametrize("lattice", [True, False])
def test_empty_batch_fire_equals_reference_broker_not_the_engine(lattice):
    options = {} if lattice else LATTICE_OFF
    script, athlete = empty_fire_script()
    ref = run_script(jcore, STREAM_TERMS, script, options=options)
    port = run_script(tcore, STREAM_TERMS, script, options=options)
    assert_runs_equal(port, ref)
    last = port[2][-1]
    assert last["names"] == ["t#1"] and port[0].stats[-1].n_cohort_passes == 0
    assert all(last["outs"][0][f][1] == 0 for f in OUT_FIELDS)  # a_i included: empty
    (tau, tau_n), (rho, rho_n), _ = last["states"]["t#1"]
    np.testing.assert_array_equal(rho[:rho_n], athlete)  # ρ kept

    # the per-interest engine re-evaluates I = A ∪ ρ on the same fire
    engine = tcore.IrapEngine(tcore.load_dictionary(STREAM_TERMS), device="cpu")
    expr = tcore.InterestExpr.parse("g", "t:t", *ATHLETE_GOALS)
    sub = engine.register_interest(expr, tcore.StepCapacities(**EMPTY_CAPS))
    sub.apply(EMPTY, athlete)
    out = sub.apply(EMPTY, EMPTY)
    np.testing.assert_array_equal(tcore.to_numpy(out.a_i), athlete)
    np.testing.assert_array_equal(tcore.to_numpy(sub.tau), tau[:tau_n])
    np.testing.assert_array_equal(tcore.to_numpy(sub.rho), rho[:rho_n])
    # and so do both packages' oracles
    row = tuple(int(x) for x in athlete[0])
    for oracle, plan in ((OracleEvaluator, sub.plan),
                         (JOracle, jcore.compile_interest(jcore.InterestExpr.parse("g", "t:t", *ATHLETE_GOALS),
                                                          port[0].dictionary))):
        want = oracle(plan).step(set(), set(), set(), {row})
        assert want["a_i"] == {row} and want["tau1"] == set() and want["rho1"] == {row}
        assert {f: want[f] for f in OUT_FIELDS if f != "a_i"} == {f: set() for f in OUT_FIELDS if f != "a_i"}


def test_empty_batch_defers_the_cohort_build_as_the_reference():
    """A subscribe followed by empty changesets builds no cohort step: the
    empty-batch fast path runs no pass, so the new cohort's build lands on
    the next changeset with rows, in both packages (the reference property
    test ``test_churn_recompile_bound`` charges that build to a changeset
    without a membership change when hypothesis draws this order)."""
    ids = {t: i for i, t in enumerate(STREAM_TERMS)}
    rows = np.asarray([[ids["e0"], ids["goals"], ids["o0"]], [ids["e1"], ids["type"], ids["Team"]]], np.int32)
    builds = {}
    for mod in (jcore, tcore):
        d = mod.Dictionary() if mod is jcore else tcore.load_dictionary(STREAM_TERMS)
        if mod is jcore:
            for t in STREAM_TERMS:
                d.encode_term(t)
        broker = mod.Broker(d) if mod is jcore else mod.Broker(d, device="cpu")
        caps = mod.StepCapacities(**EMPTY_CAPS)
        steps = []
        for expr, (rm, ad) in [(GOALS, (rows, rows)), (ATHLETE_GOALS, (EMPTY, EMPTY)), (None, (EMPTY, EMPTY)),
                               (None, (rows[:1], rows[1:]))]:
            if expr is not None:
                broker.subscribe(mod.InterestExpr.parse("g", "t:t", *expr), caps)
            before = sum(broker.cohort_compiles.values())
            broker.process_changeset(rm, ad)
            steps.append((sum(broker.cohort_compiles.values()) - before, broker.stats[-1].n_cohort_passes))
        builds[mod.__name__] = steps
    assert builds["repro_torch.core"] == builds["repro.core"]
    assert [b for b, _ in builds["repro.core"]] == [1, 0, 0, 1]  # the second cohort's build waits for rows
