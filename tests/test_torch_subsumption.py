"""repro_torch's subsumption lattice pieces against repro's (CPU, exact).

* ``canonicalize_expr``: equal canonical expressions and keys on the
  expressions of the reference's ``tests/test_subsumption.py`` and the pool
  of ``benchmarks/broker_fanout.py`` (renamings, reorders, OGPs).
* ``row_subsumes`` / ``residual_of`` over every pair of a small row space.
* ``SubsumptionBank`` driven step for step beside the reference's (add,
  duplicate, contained, depth-1 chain, release, ``maybe_compact`` remap):
  after every step the lane maps, ``patterns_padded``, ``real_padded``,
  ``refine_arrays`` and ``resolve_lanes`` are equal; and ``restore``.
* K7's plain version (``ref.lane_refine_ref``) against the reference's
  oracle and its Pallas kernel in interpret mode at Vp of 1, 31, 32, 33 and
  64, dead slots, parents in the first and last word, wildcard residuals and
  PAD rows; with a plane axis (rows shared or per plane); and against the
  words of the materialized child patterns.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from benchmarks.broker_fanout import _pool as fanout_pool  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.core import interest as jinterest  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import interest as tinterest  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_subsumption import GOLDEN_EXPRS  # noqa: E402

PAD = int(np.iinfo(np.int32).max)
WC = -1
E = jcore.InterestExpr.parse


def as_port(expr):
    return tcore.InterestExpr.parse(expr.source, expr.target, [p.slots() for p in expr.bgp],
                                    [p.slots() for p in expr.ogp])


def expression_pool():
    pool = list(GOLDEN_EXPRS) + fanout_pool()
    pool += [
        E("g", "t", bgp=[("?a", "type", "Athlete"), ("?a", "goals", "?g")]),
        E("g", "t", bgp=[("?x", "type", "Athlete"), ("?x", "goals", "?y")]),
        E("g", "t", bgp=[("?q", "goals", "?r"), ("?q", "type", "Athlete")]),
        E("g", "t", bgp=[("?a", "p", "?a")]),
        E("g", "t", bgp=[("?a", "p", "?b")]),
        E("g", "t", bgp=[("?a", "goals", "?g")], ogp=[("?a", "label", "?l")]),
        E("g", "t", bgp=[("?z", "goals", "?q")], ogp=[("?z", "label", "?w")]),
        E("g2", "t2", bgp=[("s0", "goals", "?g"), ("s0", "type", "?c")], ogp=[("?c", "label", "?l")]),
        E("g2", "t2", bgp=[("s0", "type", "?k"), ("s0", "goals", "?h")], ogp=[("?k", "label", "?m")]),
    ]
    return pool


def test_canonical_form_equals_reference():
    keys = set()
    for expr in expression_pool():
        r_expr, r_key = jinterest.canonicalize_expr(expr)
        p_expr, p_key = tinterest.canonicalize_expr(as_port(expr))
        assert p_key == r_key
        assert [p.slots() for p in p_expr.bgp] == [p.slots() for p in r_expr.bgp]
        assert [p.slots() for p in p_expr.ogp] == [p.slots() for p in r_expr.ogp]
        assert (p_expr.source, p_expr.target) == (r_expr.source, r_expr.target)
        keys.add(p_key)
    # the fanout pool's 4 variants of 16 families collapse to 32 interests
    assert len({tinterest.canonicalize_expr(as_port(e))[1] for e in fanout_pool()}) == 32
    assert len(keys) < len(expression_pool())


def test_row_subsumes_and_residual_equal_reference():
    space = list(itertools.product((WC, 0, 1), repeat=3))
    for parent, child in itertools.product(space, space):
        assert tinterest.row_subsumes(parent, child) == jinterest.row_subsumes(parent, child)
        assert tinterest.residual_of(parent, child) == jinterest.residual_of(parent, child)


# ---------------------------------------------------------------------------
# SubsumptionBank, step for step
# ---------------------------------------------------------------------------

BANK_TERMS = ("goals", "type", "Athlete", "label", "s0", "s1", "o0")
BANK_EXPRS = {
    "parent": ([("?a", "goals", "?g")], []),
    "child": ([("s0", "goals", "?g")], []),  # contained: a virtual lane
    "child_dup": ([("s0", "goals", "?x")], []),  # the same row after compile
    "parent_dup": ([("?z", "goals", "?w")], []),
    "typed": ([("?a", "type", "Athlete"), ("?a", "goals", "?g")], []),
    "any": ([("?a", "?p", "?g")], []),  # subsumes everything registered after it
    "pred": ([("?a", "label", "?g")], []),  # under "any": virtual
    "deep": ([("s1", "label", "o0")], []),  # refines the real root directly (depth 1)
    "obj": ([("?a", "?p", "o0")], []),
    "both": ([("s0", "goals", "o0")], []),
}
BANK_STEPS = [
    ("add", "parent"), ("add", "child"), ("add", "child_dup"), ("add", "parent_dup"),
    ("add", "typed"), ("add", "any"), ("add", "pred"), ("add", "deep"), ("add", "obj"),
    ("add", "both"), ("remove", "child"), ("remove", "parent"), ("compact", False),
    ("remove", "typed"), ("remove", "child_dup"), ("compact", True), ("add", "child"),
    ("remove", "pred"), ("remove", "deep"), ("remove", "obj"), ("compact", False),
]


def assert_subsumption_banks_equal(port, ref, lane_maps):
    for attr in ("version", "n_lanes", "n_live", "n_real", "n_virtual", "n_real_padded", "n_virt_padded",
                 "n_lanes_padded", "n_words"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(port.patterns_padded(), ref.patterns_padded())
    np.testing.assert_array_equal(port.real_padded(), ref.real_padded())
    p_ra, r_ra = port.refine_arrays(), ref.refine_arrays()
    assert (p_ra is None) == (r_ra is None)
    if r_ra is not None:
        np.testing.assert_array_equal(p_ra[0], r_ra[0])
        np.testing.assert_array_equal(p_ra[1], r_ra[1])
    for lanes in lane_maps.values():
        assert port.resolve_lanes(lanes) == ref.resolve_lanes(lanes)


def test_subsumption_bank_lifecycle_equals_reference():
    d_ref, d_port = jcore.Dictionary(), tcore.Dictionary()
    for t in BANK_TERMS:
        d_ref.encode_term(t), d_port.encode_term(t)
    ref, port = jinterest.SubsumptionBank(), tinterest.SubsumptionBank()
    lane_maps = {}
    saw_virtual = saw_remap = False
    for op, arg in BANK_STEPS:
        if op == "add":
            bgp, ogp = BANK_EXPRS[arg]
            r_lanes = ref.add_plan(jcore.compile_interest(E("g", "t", bgp, ogp), d_ref))
            p_lanes = port.add_plan(tcore.compile_interest(tcore.InterestExpr.parse("g", "t", bgp, ogp), d_port))
            assert p_lanes == r_lanes, arg
            lane_maps[arg] = p_lanes
            saw_virtual |= any(lane >= tinterest.REFINE_BASE for lane in p_lanes)
        elif op == "remove":
            lanes = lane_maps.pop(arg)
            ref.remove_plan(lanes)
            port.remove_plan(lanes)
        else:
            r_remap, p_remap = ref.maybe_compact(force=arg), port.maybe_compact(force=arg)
            assert p_remap == r_remap
            if p_remap is not None:
                saw_remap = True
                lane_maps = {k: tuple(p_remap[lane] for lane in v) for k, v in lane_maps.items()}
        assert_subsumption_banks_equal(port, ref, lane_maps)
        if op == "add":
            np.testing.assert_array_equal(port.patterns_padded()[list(port.resolve_lanes(lane_maps[arg]))],
                                          tcore.compile_interest(tcore.InterestExpr.parse("g", "t", *BANK_EXPRS[arg]),
                                                                 d_port).patterns)
        restored = tinterest.SubsumptionBank.restore(ref.bank._rows, ref.bank._refs, ref.bank._free,
                                                     ref._vrows, ref._vrefs, ref._vfree)
        for attr in ("n_lanes", "n_live", "n_real", "n_virtual", "n_words"):
            assert getattr(restored, attr) == getattr(ref, attr)
        np.testing.assert_array_equal(restored.patterns_padded(), ref.patterns_padded())
    assert saw_virtual and saw_remap
    # a freed virtual lane released again is an error, as in the reference
    with pytest.raises(ValueError):
        port.remove_plan(lane_maps["child"] * 2)


def test_subsumption_bank_restore_refuses_inconsistent_state():
    row, child = (WC, 3, WC), (5, 3, WC)
    ok = tinterest.SubsumptionBank.restore([row], [2], [], [(child, 0, (5, WC, WC))], [1], [])
    assert ok.n_virtual == 1 and ok.refine_arrays()[0][0] == 0
    bad = [
        ([(child, 0, (5, 3, WC))], [1], []),  # wrong residual
        ([(row, 0, (WC, WC, WC))], [1], []),  # not strictly contained
        ([(child, 1, (5, WC, WC))], [1], []),  # no such parent lane
        ([(child, 0, (5, WC, WC))], [0], []),  # a live slot without references
        ([None], [0], []),  # a free slot missing from the free list
    ]
    for rows, refs, free in bad:
        with pytest.raises(ValueError):
            tinterest.SubsumptionBank.restore([row], [2], [], rows, refs, free)


# ---------------------------------------------------------------------------
# K7's plain version: lane_refine_ref
# ---------------------------------------------------------------------------

def refine_case(seed, n_rows, n_pat, vp, n_virt, parents_at=()):
    """Rows with PAD rows, a bank, and ``n_virt`` live virtual slots of ``vp``
    (the others dead), residuals binding only slots the parent leaves open."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(-1, 5, size=(n_pat, 3)).astype(np.int32)
    pats[rng.random(n_pat) < 0.1] = PAD  # tombstones
    spo = rng.integers(0, 5, size=(n_rows, 3)).astype(np.int32)
    spo[rng.random(n_rows) < 0.1] = PAD
    parents = np.full((vp,), -1, np.int32)
    residual = np.full((vp, 3), PAD, np.int32)
    for i, v in enumerate(rng.choice(vp, size=n_virt, replace=False)):
        p = parents_at[i] if i < len(parents_at) else int(rng.integers(0, n_pat))
        parents[v] = p
        residual[v] = [rng.integers(0, 5) if pats[p, k] == WC and rng.random() < 0.7 else WC for k in range(3)]
    return spo, pats, parents, residual


# (vp, live slots, parents forced into the first and the last word)
REFINE_CASES = [(1, 1, (0,)), (31, 20, (0, 63)), (32, 32, (31, 32)), (33, 9, (0, 63)), (64, 40, (63, 1))]


@pytest.mark.parametrize("vp,n_virt,parents_at", REFINE_CASES)
def test_lane_refine_plain_equals_reference_and_pallas(vp, n_virt, parents_at):
    spo, pats, parents, residual = refine_case(vp, 300, 64, vp, n_virt, parents_at)
    j_words = jref.pattern_bitmask_words_ref(jnp.asarray(spo), jnp.asarray(pats))
    want = np.asarray(jref.lane_refine_ref(jnp.asarray(spo), j_words, jnp.asarray(parents), jnp.asarray(residual)))
    pallas = np.asarray(jops.lane_refine(jnp.asarray(spo), j_words, jnp.asarray(parents), jnp.asarray(residual),
                                         use_kernel=True))
    np.testing.assert_array_equal(pallas, want)
    t_spo, t_words = torch.as_tensor(spo), ref.pattern_bitmask_words_ref(torch.as_tensor(spo), torch.as_tensor(pats))
    np.testing.assert_array_equal(t_words.numpy().view(np.uint32), np.asarray(j_words))
    got = ops.lane_refine(t_spo, t_words, torch.as_tensor(parents), torch.as_tensor(residual))
    assert tuple(got.shape) == (300, max(1, -(-vp // 32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_lane_refine_with_planes_equals_per_plane_reference():
    """A plane axis: rows shared by every plane (the delta chain) or one row
    set a plane (the stacked pass), each plane as the reference computes it."""
    spo, pats, parents, residual = refine_case(5, 200, 40, 64, 30, (0, 39))
    rng = np.random.default_rng(6)
    planes = rng.integers(0, 5, size=(3, 200, 3)).astype(np.int32)
    planes[0] = spo
    t_pats = torch.as_tensor(pats)
    args = (torch.as_tensor(parents), torch.as_tensor(residual))
    for shared in (True, False):
        rows = [spo] * 3 if shared else list(planes)
        words = torch.stack([ref.pattern_bitmask_words_ref(torch.as_tensor(r), t_pats) for r in rows])
        seg = torch.as_tensor(rng.integers(0, 2, size=(3, 200)).astype(bool))
        words = torch.where(seg[..., None], words, torch.zeros_like(words))  # masked planes, as K6 gives
        got = ops.lane_refine(torch.as_tensor(spo) if shared else torch.as_tensor(planes), words, *args)
        assert tuple(got.shape) == (3, 200, 2)
        for f, r in enumerate(rows):
            want = jref.lane_refine_ref(jnp.asarray(r), jnp.asarray(words[f].numpy().view(np.uint32)),
                                        jnp.asarray(parents), jnp.asarray(residual))
            np.testing.assert_array_equal(got[f].numpy().view(np.uint32), np.asarray(want))


def test_lane_refine_equals_materialized_children():
    """The refined words equal the words pass over the child patterns
    (the parent's row with the residual's bound slots written in)."""
    spo, pats, parents, residual = refine_case(8, 400, 50, 64, 45, (0, 49))
    words = ref.pattern_bitmask_words_ref(torch.as_tensor(spo), torch.as_tensor(pats))
    got = ref.lane_refine_ref(torch.as_tensor(spo), words, torch.as_tensor(parents), torch.as_tensor(residual))
    children = np.full((64, 3), PAD, np.int32)
    for v, p in enumerate(parents):
        if p >= 0:
            children[v] = np.where(residual[v] != WC, residual[v], pats[p])
    want = ref.pattern_bitmask_words_ref(torch.as_tensor(spo), torch.as_tensor(children))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_lane_refine_empty_virtual_space_and_dead_parents():
    spo, pats, _, _ = refine_case(9, 40, 8, 1, 1)
    words = ref.pattern_bitmask_words_ref(torch.as_tensor(spo), torch.as_tensor(pats))
    out = ops.lane_refine(torch.as_tensor(spo), words, torch.zeros(0, dtype=torch.int32),
                          torch.zeros((0, 3), dtype=torch.int32))
    assert tuple(out.shape) == (40, 1) and not out.any()
    # a parent outside the words' lanes is a dead slot, like -1
    out = ops.lane_refine(torch.as_tensor(spo), words, torch.tensor([-1, 32, 7], dtype=torch.int32),
                          torch.full((3, 3), WC, dtype=torch.int32))
    np.testing.assert_array_equal((out[:, 0] & 3).numpy(), np.zeros(40, np.int32))
    np.testing.assert_array_equal(((out[:, 0] >> 2) & 1).numpy(), ((words[:, 0] >> 7) & 1).numpy())
