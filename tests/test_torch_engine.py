"""repro_torch's IrapEngine against repro's (CPU, exact), and the paper's example on the port.

* the assertions of ``tests/test_paper_example.py``, re-stated on the port;
* a stream of generator changesets through both engines with the Football
  and Location interests: every ``EvalOutputs`` store, τ and ρ equal;
* the state carry: the reference runs k changesets, its dictionary, τ and ρ
  move into the port, and both continue to the same stores;
* ``IrapEngine()`` without a device targets CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro.data import DBpediaLikeGenerator, GeneratorConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.oracle import OracleEvaluator  # noqa: E402
from repro_torch.data import DBpediaLikeGenerator as TGenerator  # noqa: E402
from repro_torch.data import GeneratorConfig as TGeneratorConfig  # noqa: E402

A = "rdf:type"
OUT_FIELDS = ("r", "r_i", "r_prime", "a", "a_i")


# ---------------------------------------------------------------------------
# the paper's running example (Examples 1-9) on the port
# ---------------------------------------------------------------------------

@pytest.fixture()
def setup():
    d = tcore.Dictionary()
    expr = tcore.InterestExpr.parse(
        source="http://live.dbpedia.org/changesets",
        target="http://localhost:3030/target/sparql",
        bgp=[("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?goals")],
        ogp=[("?a", "foaf:homepage", "?page")],
    )
    tau0 = [
        ("dbr:Marcel", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
        ("dbr:Cristiano_Ronaldo", "foaf:homepage", '"http://cristianoronaldo.com"'),
    ]
    removed = [
        ("dbr:Marcel", "dbp:goals", "1"),
        ("dbr:Marcel", "dbo:team", "dbr:FNFT"),
        ("dbr:Tim%02", "foaf:name", '"Tim Berners-Lee"'),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
    ]
    added = [
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "216"),
        ("dbr:Barack_Obama", "foaf:name", '"Barack Obama"'),
        ("dbr:Barack_Obama", "foaf:homepage", '"http://www.barackobama.com/"'),
        ("dbr:Rio_Ferdinand", A, "foaf:Person"),
        ("dbr:Rio_Ferdinand", A, "dbo:Athlete"),
        ("dbr:Rio_Ferdinand", "dbp:goals", "10"),
        ("dbr:Arvid_Smit", A, "dbo:Athlete"),
    ]
    return d, expr, tau0, removed, added


def sets_of(d, rows):
    return {tuple(int(x) for x in r) for r in d.encode_triples(rows)}


RONALDO_HOMEPAGE = ("dbr:Cristiano_Ronaldo", "foaf:homepage", '"http://cristianoronaldo.com"')
OBAMA_HOMEPAGE = ("dbr:Barack_Obama", "foaf:homepage", '"http://www.barackobama.com/"')
TAU_AFTER = [
    ("dbr:Cristiano_Ronaldo", "dbp:goals", "216"),
    ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"),
    RONALDO_HOMEPAGE,
    ("dbr:Rio_Ferdinand", A, "dbo:Athlete"),
    ("dbr:Rio_Ferdinand", "dbp:goals", "10"),
]
RHO_AFTER = [("dbr:Arvid_Smit", A, "dbo:Athlete"), OBAMA_HOMEPAGE, ("dbr:Marcel", A, "dbo:Athlete")]
PAPER_CAPS = tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)


def test_running_example_engine(setup):
    d, expr, tau0, removed, added = setup
    engine = tcore.IrapEngine(d, device="cpu")
    sub = engine.register_interest(expr, PAPER_CAPS, initial_target=d.encode_triples(tau0))
    out = sub.apply(d.encode_triples(removed), d.encode_triples(added))

    # Example 5 — d(i, D)
    assert tcore.to_set(out.r) == sets_of(
        d, [("dbr:Marcel", "dbp:goals", "1"), ("dbr:Cristiano_Ronaldo", "dbp:goals", "96")]
    )
    assert tcore.to_set(out.r_i) == set()
    assert tcore.to_set(out.r_prime) == sets_of(
        d, [("dbr:Marcel", A, "dbo:Athlete"), ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"), RONALDO_HOMEPAGE]
    )
    # Example 6 — α(i, A ∪ ρ)
    assert tcore.to_set(out.a) == sets_of(d, TAU_AFTER)
    assert tcore.to_set(out.a_i) == sets_of(d, [("dbr:Arvid_Smit", A, "dbo:Athlete"), OBAMA_HOMEPAGE])
    # Example 9 / Listings 1.3 and 1.4 — resulting τ and ρ
    assert tcore.to_set(sub.tau) == sets_of(d, TAU_AFTER)
    assert tcore.to_set(sub.rho) == sets_of(d, RHO_AFTER)
    assert sub.last_outputs is out


def test_running_example_oracle_agrees(setup):
    d, expr, tau0, removed, added = setup
    tau_np, d_np, a_np = (d.encode_triples(x) for x in (tau0, removed, added))
    orc = OracleEvaluator(tcore.compile_interest(expr, d))
    res = orc.step(
        {tuple(map(int, r)) for r in d_np},
        {tuple(map(int, r)) for r in a_np},
        {tuple(map(int, r)) for r in tau_np},
        set(),
    )
    assert res["r"] == sets_of(
        d, [("dbr:Marcel", "dbp:goals", "1"), ("dbr:Cristiano_Ronaldo", "dbp:goals", "96")]
    )
    assert res["rho1"] == sets_of(d, RHO_AFTER)
    assert res["tau1"] == sets_of(d, TAU_AFTER)


def test_second_changeset_promotes_from_rho(setup):
    d, expr, tau0, removed, added = setup
    engine = tcore.IrapEngine(d, device="cpu")
    sub = engine.register_interest(expr, PAPER_CAPS, initial_target=d.encode_triples(tau0))
    sub.apply(d.encode_triples(removed), d.encode_triples(added))
    out2 = sub.apply(
        np.zeros((0, 3), np.int32), d.encode_triples([("dbr:Arvid_Smit", "dbp:goals", "3")])
    )
    assert tcore.to_set(out2.a) == sets_of(
        d, [("dbr:Arvid_Smit", "dbp:goals", "3"), ("dbr:Arvid_Smit", A, "dbo:Athlete")]
    )
    assert tcore.to_set(sub.rho) == sets_of(d, [OBAMA_HOMEPAGE, ("dbr:Marcel", A, "dbo:Athlete")])
    assert sets_of(d, [("dbr:Arvid_Smit", A, "dbo:Athlete")]) <= tcore.to_set(sub.tau)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tcore.IrapEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.IrapEngine()
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.IrapEngine(device="cuda")
    assert tcore.IrapEngine(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# generator streams through both engines
# ---------------------------------------------------------------------------

GEN = dict(
    n_athletes=40, n_places=60, n_other=200, n_teams=8, seed=3,
    adds_per_changeset=120, removes_per_changeset=60,
)
# small enough that ρ outgrows its first capacity: both engines double it
CAPS = dict(n_removed=128, n_added=256, tau=2048, rho=256, pulls=1024, fanout=8, dedup_candidates=512)
N_CHANGESETS = 4
CARRY_AT = 2
INTERESTS = {
    "football": (
        [
            ("?footballer", A, "dbo:SoccerPlayer"),
            ("?footballer", "foaf:name", "?name"),
            ("?footballer", "dbo:team", "?team"),
            ("?team", "rdfs:label", "?teamName"),
        ],
        [],
        lambda t: t[0].startswith(("dbr:Athlete", "dbr:Team")),
    ),
    "location": (
        [
            ("?location", A, "?type"),
            ("?location", "wgs:long", "?long"),
            ("?location", "wgs:lat", "?lat"),
            ("?location", "rdfs:label", "?label"),
            ("?location", "dbo:abstract", "?abstract"),
        ],
        [("?location", "dcterms:subject", "?subject")],
        lambda t: t[0].startswith("dbr:Place"),
    ),
}


def store_np(store):
    return np.asarray(store.spo).copy(), int(store.n)


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine over the stream, recorded as numpy, with its full
    state (terms, τ, ρ, capacities) after ``CARRY_AT`` changesets."""
    gen = DBpediaLikeGenerator(GeneratorConfig(**GEN))
    gen.initial_dump()
    engine = jcore.IrapEngine(gen.dict)
    inits, subs = {}, {}
    for name, (bgp, ogp, keep) in INTERESTS.items():
        inits[name] = gen.slice_for(keep)
        subs[name] = engine.register_interest(
            jcore.InterestExpr.parse("synthetic://dbpedia-live", f"local://{name}", bgp, ogp),
            jcore.StepCapacities(**CAPS),
            initial_target=inits[name],
        )
    changesets, outputs, states, dict_len, carry = [], [], [], [], None
    for i in range(N_CHANGESETS):
        if i == CARRY_AT:
            carry = {
                "terms": [gen.dict.decode(k) for k in range(len(gen.dict))],
                "subs": {
                    n: (s.caps, store_np(s.tau), store_np(s.rho)) for n, s in subs.items()
                },
            }
        d_np, a_np = gen.changeset()
        changesets.append((d_np, a_np))
        dict_len.append(len(gen.dict))
        outs = {n: s.apply(d_np, a_np) for n, s in subs.items()}
        outputs.append({n: {f: store_np(getattr(o, f)) for f in OUT_FIELDS} for n, o in outs.items()})
        states.append({n: (store_np(s.tau), store_np(s.rho)) for n, s in subs.items()})
    terms = [gen.dict.decode(k) for k in range(len(gen.dict))]
    caps_end = {n: s.caps for n, s in subs.items()}
    return dict(
        inits=inits, changesets=changesets, outputs=outputs, states=states,
        dict_len=dict_len, carry=carry, terms=terms, caps_end=caps_end,
    )


def assert_step_equal(ref, i, name, out, sub):
    for f in OUT_FIELDS:
        spo, n = ref["outputs"][i][name][f]
        np.testing.assert_array_equal(getattr(out, f).spo.numpy(), spo, err_msg=f"{name} {f} @ {i}")
        assert int(getattr(out, f).n) == n
    (tau, tau_n), (rho, rho_n) = ref["states"][i][name]
    np.testing.assert_array_equal(sub.tau.spo.numpy(), tau, err_msg=f"{name} tau @ {i}")
    np.testing.assert_array_equal(sub.rho.spo.numpy(), rho, err_msg=f"{name} rho @ {i}")
    assert (int(sub.tau.n), int(sub.rho.n)) == (tau_n, rho_n)


def port_expr(name):
    bgp, ogp, _ = INTERESTS[name]
    return tcore.InterestExpr.parse("synthetic://dbpedia-live", f"local://{name}", bgp, ogp)


def test_stream_matches_reference(reference_run):
    """The port's copy of the generator feeds the port's engine, as the
    reference's feeds the reference's: same ids, same stores at every step."""
    ref = reference_run
    gen = TGenerator(TGeneratorConfig(**GEN))
    gen.initial_dump()
    engine = tcore.IrapEngine(gen.dict, device="cpu")
    subs = {}
    for name, (_, _, keep) in INTERESTS.items():
        init = gen.slice_for(keep)
        np.testing.assert_array_equal(init, ref["inits"][name])
        subs[name] = engine.register_interest(
            port_expr(name), tcore.StepCapacities(**CAPS), initial_target=init
        )
    for i, (d_ref, a_ref) in enumerate(ref["changesets"]):
        d_np, a_np = gen.changeset()
        np.testing.assert_array_equal(d_np, d_ref)
        np.testing.assert_array_equal(a_np, a_ref)
        stats = engine.process_changeset(d_np, a_np)
        for st, (name, sub) in zip(stats, subs.items()):
            assert_step_equal(ref, i, name, sub.last_outputs, sub)
            assert st.target_size == int(sub.tau.n) and st.potential_size == int(sub.rho.n)
    assert gen.dict.terms == ref["terms"]
    for name, sub in subs.items():
        assert sub.caps == tcore.StepCapacities(**vars(ref["caps_end"][name]))
    assert subs["location"].rebuilds > 0  # the stream exercised reallocation


def grow_dictionary(d, terms, length):
    """Encode the reference's next terms, as one generator feeding both engines would."""
    for term in terms[len(d):length]:
        d.encode_term(term)


def test_state_carry_continues_bit_identically(reference_run):
    ref = reference_run
    carry = ref["carry"]
    d = tcore.load_dictionary(carry["terms"])
    engine = tcore.IrapEngine(d, device="cpu")
    subs = {}
    for name in INTERESTS:
        caps, tau, rho = carry["subs"][name]
        subs[name] = tcore.carry_subscription(
            engine, port_expr(name), tcore.StepCapacities(**vars(caps)), tau, rho
        )
        np.testing.assert_array_equal(subs[name].tau.spo.numpy(), tau[0])
    for i in range(CARRY_AT, N_CHANGESETS):
        grow_dictionary(d, ref["terms"], ref["dict_len"][i])
        engine.process_changeset(*ref["changesets"][i])
        for name, sub in subs.items():
            assert_step_equal(ref, i, name, sub.last_outputs, sub)


def test_state_carry_refuses_malformed_stores():
    good = np.full((8, 3), np.iinfo(np.int32).max, np.int32)
    good[:2] = [[0, 1, 2], [0, 1, 3]]
    tcore.load_store((good, 2), "cpu")
    unsorted = good.copy()
    unsorted[:2] = unsorted[[1, 0]]
    for bad in ((good, 3), (good, 1), (unsorted, 2)):
        with pytest.raises(ValueError):
            tcore.load_store(bad, "cpu")
