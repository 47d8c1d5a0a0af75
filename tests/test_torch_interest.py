"""repro_torch.core.interest (compile half) against repro.core.interest (exact).

Every plan field must come out equal, the constants must get the same ids
(compilation encodes them into the dictionary), and unsupported expressions
must be refused with the same message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dictionary as jdict  # noqa: E402
from repro.core import interest as ji  # noqa: E402
from repro_torch.core import dictionary as tdict  # noqa: E402
from repro_torch.core import interest as ti  # noqa: E402

A = "rdf:type"
EXPRS = {
    "paper": (
        [("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?goals")],
        [("?a", "foaf:homepage", "?page")],
    ),
    "football": (
        [
            ("?footballer", A, "dbo:SoccerPlayer"),
            ("?footballer", "foaf:name", "?name"),
            ("?footballer", "dbo:team", "?team"),
            ("?team", "rdfs:label", "?teamName"),
        ],
        [],
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
    ),
    "two_children_ogp_child": (
        [
            ("?p", A, "ex:Person"),
            ("?p", "ex:team", "?t"),
            ("?p", "ex:city", "?c"),
            ("?t", A, "ex:Team"),
            ("?c", A, "ex:City"),
        ],
        [("?t", "ex:label", "?l")],
    ),
    "object_root_edge": (
        [("?x", "ex:knows", "?y"), ("?z", "ex:likes", "?y"), ("?y", A, "ex:P")],
        [],
    ),
    "repeated_variable": ([("?x", "ex:same", "?x"), ("?x", A, "ex:C")], []),
    "single_constant_pattern": ([("ex:s", "ex:p", "?o")], []),
    "constant_root_ogp": ([("ex:s", "ex:p", "ex:o")], [("ex:s", "ex:q", "?v")]),
    "thirty_two_patterns": ([("?x", f"ex:p{i}", f"?v{i}") for i in range(32)], []),
}
BAD = {
    "empty_bgp": ([], []),
    "too_many_patterns": ([("?x", f"ex:p{i}", f"?v{i}") for i in range(33)], []),
    "join_var_in_predicate": ([("?x", "?p", "?y"), ("?y", "?p", "ex:o")], []),
    "disjoint": ([("?x", "ex:p", "?y"), ("?z", "ex:q", "?w")], []),
    "depth_three": ([("?a", "ex:p", "?b"), ("?b", "ex:q", "?c"), ("?c", "ex:r", "?d"), ("?a", "ex:s", "?e"), ("?a", "ex:t", "?f")], []),
    "variable_thrice": ([("?x", "?x", "?x")], []),
}
FIELDS = [
    "n_bgp", "n_ogp", "kinds", "anchor_slot", "child_slot", "child_var",
    "eq_pairs", "root_var", "child_vars", "source", "target",
]


def compile_both(bgp, ogp):
    jd, td = jdict.Dictionary(), tdict.Dictionary()
    for d in (jd, td):
        d.encode_triples([("ex:seed", A, "ex:Thing")])  # ids already in use
    jplan = ji.compile_interest(ji.InterestExpr.parse("src", "tgt", bgp, ogp), jd)
    tplan = ti.compile_interest(ti.InterestExpr.parse("src", "tgt", bgp, ogp), td)
    return jplan, tplan, jd, td


@pytest.mark.parametrize("name", list(EXPRS))
def test_compile_interest_plan_fields_equal(name):
    jplan, tplan, jd, td = compile_both(*EXPRS[name])
    for f in FIELDS:
        assert getattr(jplan, f) == getattr(tplan, f), f
    assert tplan.patterns.dtype == np.int32
    np.testing.assert_array_equal(jplan.patterns, tplan.patterns)
    assert [jd.decode(i) for i in range(len(jd))] == td.terms
    assert tplan.n_total == jplan.n_total and tplan.n_children == jplan.n_children
    for cv in range(tplan.n_children):
        assert tplan.child_bgp_patterns(cv) == jplan.child_bgp_patterns(cv)
        assert tplan.child_edges(cv) == jplan.child_edges(cv)


@pytest.mark.parametrize("name", list(BAD))
def test_compile_interest_refusals_equal(name):
    bgp, ogp = BAD[name]
    with pytest.raises(ji.InterestCompileError) as jerr:
        ji.compile_interest(ji.InterestExpr.parse("s", "t", bgp, ogp), jdict.Dictionary())
    with pytest.raises(ti.InterestCompileError) as terr:
        ti.compile_interest(ti.InterestExpr.parse("s", "t", bgp, ogp), tdict.Dictionary())
    assert str(jerr.value) == str(terr.value)


def test_dictionary_from_reference_terms_keeps_ids():
    jd = jdict.Dictionary()
    rows = jd.encode_triples([("a", "p", "b"), ("b", "p", "c"), ("c", "q", '"lit x"')])
    terms = [jd.decode(i) for i in range(len(jd))]
    td = tdict.Dictionary.from_terms(terms)
    np.testing.assert_array_equal(td.encode_triples([("a", "p", "b"), ("b", "p", "c"), ("c", "q", '"lit x"')]), rows)
    assert td.id_capacity == jd.id_capacity and len(td) == len(jd)
    with pytest.raises(ValueError):
        tdict.Dictionary.from_terms(["a", "a"])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 1024, 1025])
def test_next_pow2(n):
    assert ti.next_pow2(n) == ji.next_pow2(n)
