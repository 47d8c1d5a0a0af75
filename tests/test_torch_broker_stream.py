"""repro_torch's Broker against repro's over a generator stream (CPU, exact).

Football and Location interests under mixed policies (eager, every 2,
priority lane, max staleness) over a DBpedia-like generator stream, ending
in a flush that fires two frontiers in one stacked pass; every step's
stores and statistics equal the reference
``Broker(d, subsume_interests=False, delta_frontiers=False)``'s (the same
options on both sides), and every
fire equals the port's ``IrapEngine`` on the composed changeset. The
script runner is ``tests/test_torch_broker.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro.data import DBpediaLikeGenerator, GeneratorConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from test_torch_broker import A, LATTICE_OFF, assert_runs_equal, check_against_engine, run_script  # noqa: E402

GEN = dict(n_athletes=30, n_places=40, n_other=120, n_teams=6, seed=5,
           adds_per_changeset=80, removes_per_changeset=40)
FOOTBALL = ([("?f", A, "dbo:SoccerPlayer"), ("?f", "foaf:name", "?n"), ("?f", "dbo:team", "?t"),
             ("?t", "rdfs:label", "?tn")], [])
LOCATION = ([("?l", A, "?type"), ("?l", "wgs:long", "?long"), ("?l", "wgs:lat", "?lat"),
             ("?l", "rdfs:label", "?label")], [("?l", "dcterms:subject", "?s")])
# one capacity set, large enough for five composed changesets: two shape
# cohorts, so the reference compiles few steps
STREAM_CAPS = dict(n_removed=256, n_added=512, tau=1024, rho=512, pulls=512, fanout=8, dedup_candidates=512)
N_STREAM = 5


def stream_script():
    gen = DBpediaLikeGenerator(GeneratorConfig(**GEN))
    gen.initial_dump()
    football0 = gen.slice_for(lambda t: t[0].startswith(("dbr:Athlete", "dbr:Team")))
    location0 = gen.slice_for(lambda t: t[0].startswith("dbr:Place"))
    changesets = [gen.changeset() for _ in range(N_STREAM)]
    terms = [gen.dict.decode(i) for i in range(len(gen.dict))]
    d = jcore.Dictionary()
    for t in terms:
        d.encode_term(t)
    for bgp, ogp in (FOOTBALL, LOCATION):
        jcore.compile_interest(jcore.InterestExpr.parse("g", "t", bgp, ogp), d)
    terms = [d.decode(i) for i in range(len(d))]
    script = [
        ("sub", "f_eager", FOOTBALL, STREAM_CAPS, ("eager",), football0, False),
        ("sub", "f_every2", FOOTBALL, STREAM_CAPS, ("every", 2), football0, False),
        ("sub", "l_priority", LOCATION, STREAM_CAPS, ("priority",), location0, False),
        ("sub", "l_stale", LOCATION, STREAM_CAPS, ("stale",), location0, False),
        *(("cs", dd, aa) for dd, aa in changesets),
        ("flush",),
    ]
    return terms, script


@pytest.fixture(scope="module")
def stream_reference():
    terms, script = stream_script()
    return run_script(jcore, terms, script, options=LATTICE_OFF)


def test_stream_with_mixed_policies_equals_reference(stream_reference):
    terms, script = stream_script()
    port = run_script(tcore, terms, script, options=LATTICE_OFF)
    assert_runs_equal(port, stream_reference)
    flush = port[3][-1]
    # two frontiers in one stacked pass: every(2) on changeset 5, stale on 1-5
    assert flush["n_evaluated"] == 2 and flush["rows_matched"] > flush["rows_distinct"]


def test_stream_equals_port_engine():
    terms, script = stream_script()
    assert check_against_engine(terms, script, options=LATTICE_OFF) > 10
