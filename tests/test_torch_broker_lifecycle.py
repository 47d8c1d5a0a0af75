"""repro_torch's Broker against repro's through subscription churn (CPU, exact).

Against the reference ``Broker(d, subsume_interests=False,
delta_frontiers=False)``, with the same options, step by step (``tests/test_torch_broker.py``'s
script runner): an empty broker and empty changesets, subscribe midstream,
unsubscribe with lane reuse and a bank started afresh; ``share_target``
with one ``build_index`` for the pair; a bank wider than 32 lanes (W = 2).
Also: a membership change rebuilds at most its own cohort's step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import broker as tbroker  # noqa: E402
from test_torch_broker import A, EMPTY, LATTICE_OFF, assert_runs_equal, run_script  # noqa: E402

# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

CAPS = dict(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)


def star2(cls, pred):
    return ([("?a", A, cls), ("?a", pred, "?v")], [])


def star2_ogp(cls, pred):
    return ([("?a", A, cls), ("?a", pred, "?v")], [("?a", "p:page", "?w")])


def lifecycle_data():
    d = jcore.Dictionary()
    enc = d.encode_triples
    for t in ("c:Athlete", "c:Team", "p:goals", "p:rank", "p:other", "p:page"):
        d.encode_term(t)
    tau0 = enc([("e:1", A, "c:Athlete"), ("e:2", A, "c:Athlete"), ("e:2", "p:goals", "96"), ("e:3", A, "c:Team")])
    changesets = [
        (enc([("e:2", "p:goals", "96")]), enc([("e:2", "p:goals", "216"), ("e:4", A, "c:Athlete")])),
        (EMPTY, enc([("e:4", "p:goals", "3"), ("e:3", "p:rank", "1")])),
        (enc([("e:4", "p:goals", "3")]), enc([("e:1", "p:goals", "7")])),
    ]
    return [d.decode(i) for i in range(len(d))], tau0, changesets


def lifecycle_script():
    terms, tau0, cs = lifecycle_data()
    script = [
        ("cs", EMPTY, EMPTY),  # an empty broker
        ("sub", "a0", star2("c:Athlete", "p:goals"), CAPS, ("eager",), tau0, False),
        ("sub", "t1", star2_ogp("c:Team", "p:rank"), CAPS, ("eager",), tau0, False),
        ("cs", *cs[0]),
        ("sub", "a2", star2("c:Athlete", "p:other"), CAPS, ("eager",), None, False),  # midstream
        ("cs", *cs[1]),
        ("unsub", "a0"),  # its lanes: the type lane stays shared, p:goals is tombstoned
        ("cs", *cs[2]),
        ("sub", "a3", star2("c:Athlete", "p:goals"), CAPS, ("eager",), None, False),  # reuses it
        ("cs", *cs[0]),
        ("cs", EMPTY, EMPTY),  # empty changeset sides with live subscribers
        ("unsub", "a2"), ("unsub", "t1"), ("unsub", "a3"),  # the bank starts afresh
        ("cs", *cs[1]),
        ("sub", "t4", star2("c:Team", "p:rank"), CAPS, ("eager",), tau0, False),
        ("cs", *cs[1]),
    ]
    return terms, script


@pytest.fixture(scope="module")
def lifecycle_reference():
    terms, script = lifecycle_script()
    return run_script(jcore, terms, script, options=LATTICE_OFF)


def test_lifecycle_equals_reference(lifecycle_reference):
    terms, script = lifecycle_script()
    port = run_script(tcore, terms, script, options=LATTICE_OFF)
    assert_runs_equal(port, lifecycle_reference)
    assert port[2][0]["outs"] == []  # the empty broker


def test_membership_change_rebuilds_at_most_own_cohort():
    """Per subscribe/unsubscribe at most one cohort step is built on the next
    pass; re-subscribing a shape at a padded size seen before builds none."""
    terms, tau0, cs = lifecycle_data()
    broker = tcore.Broker(tcore.load_dictionary(terms), device="cpu", **LATTICE_OFF)

    def sub(name, shape):
        expr = tcore.InterestExpr.parse("g", f"t:{name}", *shape)
        return broker.subscribe(expr, tcore.StepCapacities(**CAPS), initial_target=tau0)

    a0 = sub("a0", star2("c:Athlete", "p:goals"))
    sub("t1", star2_ogp("c:Team", "p:rank"))
    broker.process_changeset(*cs[0])
    base = sum(broker.cohort_compiles.values())
    assert base == 2  # one step per shape cohort
    sub("a2", star2("c:Athlete", "p:other"))
    broker.process_changeset(*cs[1])
    assert sum(broker.cohort_compiles.values()) - base == 1
    broker.unsubscribe(a0)
    broker.process_changeset(*cs[2])
    assert sum(broker.cohort_compiles.values()) - base == 1
    sub("a3", star2("c:Athlete", "p:goals"))
    broker.process_changeset(*cs[0])
    assert sum(broker.cohort_compiles.values()) - base == 1
    assert all(st.rejit_s <= st.elapsed_s for st in broker.stats)
    # without the cache every membership change drops every built step
    nocache = tcore.Broker(tcore.load_dictionary(terms), device="cpu", cache_executables=False, **LATTICE_OFF)
    for name in ("b0", "b1"):
        nocache.subscribe(tcore.InterestExpr.parse("g", name, *star2("c:Athlete", "p:goals")),
                          tcore.StepCapacities(**CAPS), initial_target=tau0)
        nocache.process_changeset(*cs[0])
    assert nocache.rejit_count == 4  # words + cohort, twice


def test_membership_change_rebuilds_at_most_own_cohort_default():
    """The same build counts in the default configuration, whose
    canonicalized plans keep the shapes (and whose lane groups need equal
    targets, which these subscriptions do not have)."""
    terms, tau0, cs = lifecycle_data()
    broker = tcore.Broker(tcore.load_dictionary(terms), device="cpu")

    def sub(name, shape):
        expr = tcore.InterestExpr.parse("g", f"t:{name}", *shape)
        return broker.subscribe(expr, tcore.StepCapacities(**CAPS), initial_target=tau0)

    a0 = sub("a0", star2("c:Athlete", "p:goals"))
    sub("t1", star2_ogp("c:Team", "p:rank"))
    broker.process_changeset(*cs[0])
    base = sum(broker.cohort_compiles.values())
    assert base == 2
    sub("a2", star2("c:Athlete", "p:other"))
    broker.process_changeset(*cs[1])
    assert sum(broker.cohort_compiles.values()) - base == 1
    broker.unsubscribe(a0)
    broker.process_changeset(*cs[2])
    assert sum(broker.cohort_compiles.values()) - base == 1
    sub("a3", star2("c:Athlete", "p:goals"))
    broker.process_changeset(*cs[0])
    assert sum(broker.cohort_compiles.values()) - base == 1
    assert all(st.distinct_interests == st.fanout_copies for st in broker.stats)  # no lane groups
    nocache = tcore.Broker(tcore.load_dictionary(terms), device="cpu", cache_executables=False)
    for name in ("b0", "b1"):
        nocache.subscribe(tcore.InterestExpr.parse("g", name, *star2("c:Athlete", "p:goals")),
                          tcore.StepCapacities(**CAPS), initial_target=tau0)
        nocache.process_changeset(*cs[0])
    assert nocache.rejit_count == 4


def test_share_target_builds_one_index(monkeypatch):
    terms, tau0, cs = lifecycle_data()
    expr_args = star2("c:Athlete", "p:goals")
    script = [
        ("sub", "s", expr_args, CAPS, ("eager",), tau0, False),
        ("sub", "s#2", expr_args, CAPS, ("eager",), None, True),
        *(("cs", *c) for c in cs),
    ]
    ref = run_script(jcore, terms, script, options=LATTICE_OFF)
    calls = []
    real = tbroker.build_index
    monkeypatch.setattr(tbroker, "build_index", lambda store: calls.append(1) or real(store))
    port = run_script(tcore, terms, script, options=LATTICE_OFF)
    assert_runs_equal(port, ref)
    s1, s2 = port[1]["s"], port[1]["s#2"]
    assert s2.tau is s1.tau and s2.share_tag is s1
    assert len(calls) == len(cs)  # one build_index(τ) per pass for the pair
    # both members take cohort slots but share one replica: (Ncp, Nu) = (2, 1)
    assert any(k[4] == 2 and k[5] == 1 for k in port[0].cohort_compiles)


def test_bank_wider_than_32_lanes_equals_reference():
    d = jcore.Dictionary()
    shapes = [([("?a", A, f"cls:{i}"), ("?a", f"p:{i}", "?v")], [("?a", f"q:{i}", "?w")]) for i in range(12)]
    tau0 = d.encode_triples([(f"e:{i}", A, f"cls:{i}") for i in range(12)]
                            + [(f"e:{i}", f"q:{i}", f"w:{i}") for i in range(12)])
    removed = d.encode_triples([(f"e:{i}", f"p:{i}", "x") for i in range(0, 12, 2)])
    added = d.encode_triples([(f"e:{i}", f"p:{i}", "y") for i in range(12)] + [("e:junk", "p:junk", "z")])
    terms = [d.decode(i) for i in range(len(d))]
    caps = dict(n_removed=16, n_added=32, tau=64, rho=64, pulls=64)
    script = [("sub", f"s{i}", shape, caps, ("eager",), tau0, False) for i, shape in enumerate(shapes)]
    script += [("cs", removed, added), ("cs", added[:5], removed)]
    ref = run_script(jcore, terms, script, options=LATTICE_OFF)
    port = run_script(tcore, terms, script, options=LATTICE_OFF)
    assert port[0].bank.n_lanes == 36 and port[0].bank.n_words == 2
    assert port[0]._ensure_bank_dev().shape == (64, 3)  # W = 2 padded words
    assert_runs_equal(port, ref)
