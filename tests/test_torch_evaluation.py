"""repro_torch.core.evaluation against repro.core.evaluation (CPU, exact).

The D side and the A side of a changeset go through ``make_side_evaluator``
of both packages for the paper's interest and for Football and Location
(the expressions of ``benchmarks/common.py``); every store of the
``SideResult`` and its overflow flag must be equal, and the sets must equal
the port's copy of the pure-Python oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Dictionary as JDict  # noqa: E402
from repro.core import evaluation as jev  # noqa: E402
from repro.core import interest as ji  # noqa: E402
from repro.core import triples as jt  # noqa: E402
from repro.data import DBpediaLikeGenerator, GeneratorConfig  # noqa: E402
from repro_torch.core import evaluation as tev  # noqa: E402
from repro_torch.core import interest as ti  # noqa: E402
from repro_torch.core import triples as tt  # noqa: E402
from repro_torch.core.dictionary import Dictionary as TDict  # noqa: E402
from repro_torch.core.oracle import OracleEvaluator  # noqa: E402

A = "rdf:type"
PAPER = (
    [("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?goals")],
    [("?a", "foaf:homepage", "?page")],
)
FOOTBALL = (
    [
        ("?footballer", A, "dbo:SoccerPlayer"),
        ("?footballer", "foaf:name", "?name"),
        ("?footballer", "dbo:team", "?team"),
        ("?team", "rdfs:label", "?teamName"),
    ],
    [],
)
LOCATION = (
    [
        ("?location", A, "?type"),
        ("?location", "wgs:long", "?long"),
        ("?location", "wgs:lat", "?lat"),
        ("?location", "rdfs:label", "?label"),
        ("?location", "dbo:abstract", "?abstract"),
    ],
    [("?location", "dcterms:subject", "?subject")],
)
# fanout 16 covers every binding of this data, so the capped probes see what
# the unbounded oracle sees
SIZES = dict(out_capacity=512, pull_capacity=512, fanout=16)
TINY = dict(out_capacity=4, pull_capacity=4, fanout=2)


def paper_data():
    d = JDict()
    tau = d.encode_triples([
        ("dbr:Marcel", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", A, "dbo:Athlete"),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
        ("dbr:Cristiano_Ronaldo", "foaf:homepage", '"http://cristianoronaldo.com"'),
    ])
    removed = d.encode_triples([
        ("dbr:Marcel", "dbp:goals", "1"),
        ("dbr:Marcel", "dbo:team", "dbr:FNFT"),
        ("dbr:Tim%02", "foaf:name", '"Tim Berners-Lee"'),
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "96"),
    ])
    added = d.encode_triples([
        ("dbr:Cristiano_Ronaldo", "dbp:goals", "216"),
        ("dbr:Barack_Obama", "foaf:name", '"Barack Obama"'),
        ("dbr:Barack_Obama", "foaf:homepage", '"http://www.barackobama.com/"'),
        ("dbr:Rio_Ferdinand", A, "foaf:Person"),
        ("dbr:Rio_Ferdinand", A, "dbo:Athlete"),
        ("dbr:Rio_Ferdinand", "dbp:goals", "10"),
        ("dbr:Arvid_Smit", A, "dbo:Athlete"),
    ])
    return d, tau, removed, added


def generator_data(seed):
    gen = DBpediaLikeGenerator(GeneratorConfig(
        n_athletes=30, n_places=40, n_other=120, n_teams=6, seed=seed,
        adds_per_changeset=150, removes_per_changeset=80,
    ))
    dump = gen.initial_dump()
    removed, added = gen.changeset()
    rng = np.random.default_rng(seed)
    tau = dump[rng.random(dump.shape[0]) < 0.7]  # a replica that misses some rows
    # the A side evaluates I = A ∪ ρ; stand in some dump rows for ρ
    added = np.concatenate([added, dump[rng.integers(0, dump.shape[0], 40)]])
    return gen.dict, tau, removed, added


CASES = [
    ("paper", PAPER, None, 0, SIZES),
    ("football_dedup", FOOTBALL, 1, 64, SIZES),
    ("location", LOCATION, 2, 0, SIZES),
    ("location_overflow", LOCATION, 4, 8, TINY),
]


@pytest.mark.parametrize("name,expr,seed,dedup,sizes", CASES, ids=[c[0] for c in CASES])
def test_side_results_equal_reference_and_oracle(name, expr, seed, dedup, sizes):
    jd, tau, removed, added = paper_data() if seed is None else generator_data(seed)
    jplan = ji.compile_interest(ji.InterestExpr.parse("s", "t", *expr), jd)
    td = TDict.from_terms([jd.decode(i) for i in range(len(jd))])
    tplan = ti.compile_interest(ti.InterestExpr.parse("s", "t", *expr), td)
    kw = dict(id_capacity=jd.id_capacity * 4, dedup_candidates=dedup, **sizes)
    j_eval = jax.jit(jev.make_side_evaluator(jplan, **kw))
    t_eval = tev.make_side_evaluator(tplan, **kw)

    j_tau = jt.from_numpy(tau, 1024)
    t_tau = tt.from_numpy(tau, 1024, "cpu")
    j_idx, t_idx = jev.build_index(j_tau), tev.build_index(t_tau)
    np.testing.assert_array_equal(np.asarray(j_idx.ops.spo), t_idx.ops.spo.numpy())
    oracle = OracleEvaluator(tplan)
    tau_set = tt.to_set(t_tau)
    overflow = sizes is TINY

    for side_rows in (removed, added):  # the D side, then the A side
        j_res = j_eval(jt.from_numpy(side_rows, 256), j_idx)
        m = tt.from_numpy(side_rows, 256, "cpu")
        t_res = t_eval(m, t_idx)
        for field in ("interesting", "potential", "pulls"):
            j_store, t_store = getattr(j_res, field), getattr(t_res, field)
            np.testing.assert_array_equal(np.asarray(j_store.spo), t_store.spo.numpy(), err_msg=field)
            assert int(j_store.n) == int(t_store.n), field
        assert bool(j_res.overflow) == bool(t_res.overflow)
        if overflow:
            continue
        assert not bool(t_res.overflow)
        inter, pot, pulls = oracle.evaluate_side(tt.to_set(m), tau_set)
        assert tt.to_set(t_res.interesting) == inter
        assert tt.to_set(t_res.potential) == pot
        assert tt.to_set(t_res.pulls) == pulls
    if overflow:
        assert bool(t_res.overflow)


@pytest.mark.parametrize("bound_slot", [0, 2])
def test_probe_equal(bound_slot):
    rng = np.random.default_rng(bound_slot)
    rows = rng.integers(0, 6, size=(300, 3)).astype(np.int32)
    j_idx = jev.build_index(jt.from_numpy(rows, 512))
    t_idx = tev.build_index(tt.from_numpy(rows, 512, "cpu"))
    bound = rng.integers(0, 7, size=40).astype(np.int32)
    bound[::5] = np.iinfo(np.int32).max
    for pattern in ([-1, 2, -1], [-1, 3, 4], [1, -1, -1], [-1, -1, -1], [5, 0, 1]):
        pat = np.asarray(pattern, np.int32)
        j_rows, j_val = jev.probe(j_idx, pat, bound_slot, jnp.asarray(bound), 3)
        t_rows, t_val = tev.probe(t_idx, pat, bound_slot, torch.as_tensor(bound), 3)
        np.testing.assert_array_equal(np.asarray(j_rows), t_rows.numpy())
        np.testing.assert_array_equal(np.asarray(j_val), t_val.numpy())


def test_out_of_range_index_helpers_follow_jax():
    vec = np.array([True, False, True, True])
    idx = np.array([-1, -4, -5, 3, 4, 2**31 - 1, 0], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(vec), jnp.asarray(idx), mode="fill", fill_value=False))
    np.testing.assert_array_equal(tev.gather_bool(torch.as_tensor(vec), torch.as_tensor(idx)).numpy(), want)
    mask = np.array([True, True, True, False, True, True, True])
    jidx = jnp.where(jnp.asarray(mask), jnp.asarray(idx), 4)
    want = np.asarray(jnp.zeros(4, bool).at[jidx].max(True, mode="drop"))
    got = tev.scatter_true(4, torch.as_tensor(idx), torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("j", [0, 5, 30, 31])
def test_eq_clear_mask_bit_pattern(j):
    m = np.array([tev._eq_clear_mask(j)], np.int32).view(np.uint32)[0]
    assert m == np.uint32(~(1 << j) & 0xFFFFFFFF)
