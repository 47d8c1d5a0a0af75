"""repro_torch's default Broker against repro's default Broker (CPU, exact).

``Broker(d)`` in both packages is the subsumption lattice (canonical lane
groups, virtual lanes refined by ``lane_refine``) with delta frontier chains
(one segmented words pass over the distinct rows of a multi-frontier flush).
Each script runs through ``tests/test_torch_broker.py``'s runner with no
constructor options on either side; after every step the outputs, τ, ρ,
frontiers, every ``BrokerStats`` field but the times (``distinct_interests``,
``fanout_copies``, ``rows_matched``, ``rows_distinct`` included) and the
build counters must be equal. Scenarios:

* the paper's running example under three policies (a multi-frontier flush
  through the chain, a subscriber that overflows);
* a triple added, removed and re-added across two frontiers flushed
  together (the non-monotone composition case);
* the lattice goldens of the reference's ``tests/test_subsumption.py``:
  duplicates and a contained interest over six changesets, auto-join and
  independence, the share index through root churn.

A fixed-seed stream with churn, the state carry of a default broker and the
empty-batch fires are in ``test_torch_broker_default_stream.py``.

Fires are also held against the port's ``IrapEngine`` on each subscriber's
original (not canonicalized) expression and composed changeset; every such
fire has rows (on a fire whose composed batch is empty both brokers return
empty outputs, which the per-interest engine does not: see
``test_torch_broker_default_stream.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_broker import (  # noqa: E402
    A,
    EMPTY,
    assert_runs_equal,
    check_against_engine,
    paper_script,
    run_script,
)
from test_subsumption import CAPS as GOLDEN_CAPS  # noqa: E402
from test_subsumption import GOLDEN_EXPRS, TERMS, _golden_changesets  # noqa: E402

GCAPS = dataclasses.asdict(GOLDEN_CAPS)


def shape(expr):
    """(bgp, ogp) of a reference expression, as the script runner takes it."""
    return [p.slots() for p in expr.bgp], [p.slots() for p in expr.ogp]


@pytest.fixture()
def refine_calls(monkeypatch):
    """Counts the port's lane_refine calls (the virtual lanes' words)."""
    calls = []
    real = tops.lane_refine
    monkeypatch.setattr(tops, "lane_refine", lambda *a: calls.append(a[1].shape) or real(*a))
    return calls


# ---------------------------------------------------------------------------
# the paper's example, and add -> remove -> re-add across frontiers
# ---------------------------------------------------------------------------

def test_paper_example_default_equals_reference():
    terms, script, _, _ = paper_script()
    ref = run_script(jcore, terms, script)
    port = run_script(tcore, terms, script)
    assert_runs_equal(port, ref)
    broker, flush = port[0], port[3][-1]
    assert broker.subsume_interests and broker.delta_frontiers
    # the flush fired two frontiers through the chain: each row matched once
    assert flush["n_evaluated"] == 2 and flush["rows_matched"] == flush["rows_distinct"] > 0
    assert any(k[0] == "cohort-delta" for k in broker.cohort_compiles)
    assert port[1]["athlete#tiny"].caps.tau > 4  # overflow doubled its capacities
    assert check_against_engine(terms, script) == 3 + 2 + 1 + 3


def readd_script():
    d = jcore.Dictionary()
    tau0 = d.encode_triples([("e:1", A, "c:Athlete"), ("e:1", "p:goals", "10"), ("e:2", A, "c:Team")])
    t_add = d.encode_triples([("e:7", "p:goals", "99")])
    noise = d.encode_triples([("e:8", "p:noise", "o1")])
    d1 = d.encode_triples([("e:1", "p:goals", "10")])
    terms = [d.decode(i) for i in range(len(d))]
    caps = dict(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
    goals = ([("?a", "p:goals", "?v")], [])
    # cs1 adds T, cs2 removes it, cs3 adds it again: frontier [2..3] composes
    # to <{T}, {T}>, frontier [1..3] to <{T, D1}, {T}>
    return terms, [
        ("sub", "x", goals, caps, ("stale",), tau0, False),
        ("sub", "x#2", goals, caps, ("stale",), tau0, False),  # joins x's lane group
        ("cs", d1, t_add),
        ("flush", ["x"]),  # x's frontier moves past cs1
        ("cs", t_add, noise),
        ("cs", EMPTY, t_add),
        ("flush",),  # two overlapping frontiers at once
    ]


def test_add_remove_readd_across_frontiers_equals_reference():
    terms, script = readd_script()
    ref = run_script(jcore, terms, script)
    port = run_script(tcore, terms, script)
    assert_runs_equal(port, ref)
    assert port[1]["x#2"].share_tag is port[1]["x"].share_tag
    flush = port[3][-1]
    assert flush["n_evaluated"] == 2 and flush["rows_matched"] == flush["rows_distinct"] == 2
    assert check_against_engine(terms, script) == 3


# ---------------------------------------------------------------------------
# the lattice goldens
# ---------------------------------------------------------------------------

def test_lattice_golden_equals_reference(refine_calls):
    """Six subscribers, three distinct interests: renamed and exact
    duplicates collapse, the contained (s0 goals ?g) rides a virtual lane."""
    script = [("sub", f"t#{k}", shape(e), GCAPS, ("eager",), None, False) for k, e in enumerate(GOLDEN_EXPRS)]
    script += [("cs", rm, ad) for rm, ad in _golden_changesets(6)]
    ref = run_script(jcore, TERMS, script)
    port = run_script(tcore, TERMS, script)
    assert_runs_equal(port, ref)
    broker = port[0]
    assert broker.stats[-1].distinct_interests == 3 and broker.stats[-1].fanout_copies == 6
    assert broker.bank.n_real == 2 and broker.bank.n_virtual == 1
    assert broker._refine_dev is not None and refine_calls  # the virtual words came from lane_refine
    assert check_against_engine(TERMS, script) == 6 * 6


def test_auto_join_and_independence_equals_reference():
    csets = _golden_changesets(3)
    wide = {**GCAPS, "tau": 128}
    script = [
        ("sub", "t#0", shape(GOLDEN_EXPRS[0]), GCAPS, ("eager",), None, False),
        ("sub", "t#1", shape(GOLDEN_EXPRS[2]), GCAPS, ("eager",), None, False),  # renamed: joins t#0
        ("cs", *csets[0]),
        ("cs", *csets[1]),
        ("sub", "t#2", shape(GOLDEN_EXPRS[0]), GCAPS, ("eager",), None, False),  # state differs: alone
        ("sub", "t#3", shape(GOLDEN_EXPRS[0]), wide, ("eager",), None, False),  # other caps: alone
        ("sub", "t#4", shape(GOLDEN_EXPRS[0]), GCAPS, ("every", 2), None, False),  # other policy: alone
        ("cs", *csets[2]),
        ("flush",),
    ]
    ref = run_script(jcore, TERMS, script)
    port = run_script(tcore, TERMS, script)
    assert_runs_equal(port, ref)
    subs = port[1]
    assert subs["t#1"].share_tag is subs["t#0"].share_tag
    assert subs["t#1"].canon_sig == subs["t#0"].canon_sig
    for name in ("t#2", "t#3", "t#4"):
        assert subs[name].share_tag is not subs["t#0"].share_tag
    assert check_against_engine(TERMS, script) == 2 * 3 + 2 + 1


def test_share_index_survives_root_churn_equals_reference():
    csets = _golden_changesets(3)
    script = [
        ("sub", "t#0", shape(GOLDEN_EXPRS[0]), GCAPS, ("eager",), None, False),
        ("sub", "t#1", shape(GOLDEN_EXPRS[2]), GCAPS, ("eager",), None, False),  # joins t#0
        ("unsub", "t#0"),  # t#1 becomes the root
        ("sub", "t#2", shape(GOLDEN_EXPRS[5]), GCAPS, ("eager",), None, False),  # joins t#1's lineage
        ("cs", *csets[0]),
        ("cs", *csets[1]),
        ("unsub", "t#1"),
        ("unsub", "t#2"),  # the index empties, the bank starts afresh
        ("sub", "t#3", shape(GOLDEN_EXPRS[0]), GCAPS, ("eager",), None, False),
        ("cs", *csets[2]),
    ]
    ref = run_script(jcore, TERMS, script)
    port = run_script(tcore, TERMS, script)
    assert_runs_equal(port, ref)
    broker, subs = port[0], port[1]
    assert list(broker._share_index.values()) == [subs["t#3"]]
    assert broker.bank.n_live == subs["t#3"].plan.n_total
    assert [(st.distinct_interests, st.fanout_copies) for st in broker.stats[:2]] == [(1, 2), (1, 2)]
