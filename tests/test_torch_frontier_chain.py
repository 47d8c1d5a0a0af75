"""repro_torch's delta frontier chain against repro's (CPU, exact).

* K6's plain version (``ref.pattern_bitmask_words_segmented_ref``) and the
  ops entry point against the reference's oracle and its Pallas kernel in
  interpret mode: n_seg of 1, 2, 3 and 32, seg bits above n_seg, W of 1, 2
  and 5 (banks of 33 and 160 patterns), an all-tombstone word, PAD rows,
  row counts that are not multiples of a block; and with a custom matcher,
  one pass per 32-lane word.
* ``build_frontier_chain``: union, membership bits and ``covered`` equal the
  reference's for suffix-nested composed stores, and for stores that are
  not nested (``covered=False``).
* The delta cohort step (one union store, masked words) equals the stacked
  step on the same frontiers, subscriber by subscriber.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import propagation as jprop  # noqa: E402
from repro.core import triples as jtriples  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import broker as tbroker  # noqa: E402
from repro_torch.core import propagation as tprop  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

PAD = int(np.iinfo(np.int32).max)
A = "rdf:type"


def rows(rng, n, vocab=5, pad_frac=0.1):
    spo = rng.integers(0, vocab, size=(n, 3)).astype(np.int32)
    spo[rng.random(n) < pad_frac] = PAD
    return spo


def bank(rng, n_pat, vocab=5, dead=()):
    pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
    if n_pat:
        pats[-1] = -1  # wildcard-only: bit 31 of a full last word
    pats[list(dead)] = PAD  # tombstones and padding
    return pats


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# (n rows, bank size, dead bank rows, n_seg, seg bits drawn)
SEG_CASES = [
    (1, 7, (), 1, 2),
    (300, 33, (0,), 2, 5),  # W = 2, bits above n_seg
    (4097, 32, (), 3, 3),  # past a block boundary, bit 31 set
    (777, 160, (31, 100), 32, 32),  # W = 5, every segment
    (500, 64, tuple(range(32, 64)), 2, 2),  # an all-tombstone word
]


@pytest.mark.parametrize("n,n_pat,dead,n_seg,bits", SEG_CASES)
def test_segmented_plain_equals_reference_and_pallas(n, n_pat, dead, n_seg, bits):
    rng = np.random.default_rng(n + n_pat)
    spo, pats = rows(rng, n), bank(rng, n_pat, dead=dead)
    seg = rng.integers(-(1 << 31), (1 << 31) - 1, size=n).astype(np.int32)
    if bits < 32:
        seg &= (1 << bits) - 1
    j_args = (jnp.asarray(spo), jnp.asarray(pats), jnp.asarray(seg), n_seg)
    want = np.asarray(jref.pattern_bitmask_words_segmented_ref(*j_args))
    if n_pat <= 64:  # the interpret-mode kernel is slow for wide banks
        np.testing.assert_array_equal(np.asarray(jops.pattern_bitmask_words_segmented(*j_args, use_kernel=True)), want)
    t_args = (torch.as_tensor(spo), torch.as_tensor(pats), torch.as_tensor(seg), n_seg)
    got = ops.pattern_bitmask_words_segmented(*t_args)
    assert tuple(got.shape) == (n_seg, n, max(1, -(-n_pat // 32)))
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(as_u32(ref.pattern_bitmask_words_segmented_ref(*t_args)), want)


def test_segmented_matcher_hook_one_pass_and_bad_n_seg():
    rng = np.random.default_rng(3)
    spo, pats = torch.as_tensor(rows(rng, 64)), torch.as_tensor(bank(rng, 40))
    seg = torch.as_tensor(rng.integers(0, 16, size=64).astype(np.int32))
    calls = []

    def spy(s, chunk):
        calls.append(int(chunk.shape[0]))
        return ref.pattern_bitmask_ref(s, chunk)

    got = ops.pattern_bitmask_words_segmented(spo, pats, seg, 4, matcher=spy)
    assert calls == [32, 8]  # one pass per 32-lane word, not one per segment
    np.testing.assert_array_equal(got.numpy(), ref.pattern_bitmask_words_segmented_ref(spo, pats, seg, 4).numpy())
    for bad in (0, 33):
        with pytest.raises(ValueError):
            ops.pattern_bitmask_words_segmented(spo, pats, seg, bad)


# ---------------------------------------------------------------------------
# build_frontier_chain
# ---------------------------------------------------------------------------

def chain_stores(nested: bool):
    """Three composed D stores: suffixes of one stream (nested) or not."""
    rng = np.random.default_rng(7)
    cs = [np.unique(rng.integers(0, 9, size=(k, 3)).astype(np.int32), axis=0) for k in (30, 20, 25)]
    if nested:  # frontier f composes changesets f.. of the stream: D_0 ⊇ D_1 ⊇ D_2
        stores = [np.unique(np.concatenate(cs[f:]), axis=0) for f in range(3)]
    else:
        stores = [cs[0], cs[1], np.unique(np.concatenate([cs[2], [[50, 50, 50]]]), axis=0)]
    return stores, [128, 64, 256]


@pytest.mark.parametrize("nested", [True, False])
def test_build_frontier_chain_equals_reference(nested):
    stores, caps = chain_stores(nested)
    j_stores = [jtriples.from_numpy(s, c) for s, c in zip(stores, caps)]
    t_stores = [tcore.from_numpy(s, c, "cpu") for s, c in zip(stores, caps)]
    cap = 128
    want = jprop.build_frontier_chain(j_stores, 0, cap)
    got = tprop.build_frontier_chain(t_stores, 0, cap)
    assert got.covered == want.covered == nested
    assert got.n_frontiers == want.n_frontiers == 3
    np.testing.assert_array_equal(got.union.spo.numpy(), np.asarray(want.union.spo))
    assert int(got.union.n) == int(want.union.n)
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
    if nested:  # every union row lies in frontier 0, rows of later changesets in later ones
        n = int(got.union.n)
        assert (got.seg[:n] & 1).all() and not got.seg[n:].any()


def test_build_frontier_chain_refuses_more_than_32_frontiers():
    st = tcore.from_numpy(np.zeros((0, 3), np.int32), 64, "cpu")
    with pytest.raises(ValueError):
        tprop.build_frontier_chain([st] * 33, 0, 64)


# ---------------------------------------------------------------------------
# the delta cohort step against the stacked one
# ---------------------------------------------------------------------------

def test_delta_cohort_step_equals_stacked_step():
    """Two frontiers of one stream (changesets 0-2 and 2), two members on
    each, through make_cohort_step stacked (a D store and words per frontier)
    and delta (the chain's union and its masked words)."""
    d = tcore.Dictionary()
    tau0 = d.encode_triples([("e:1", A, "c:Athlete"), ("e:1", "p:goals", "10"), ("e:2", A, "c:Athlete")])
    enc = d.encode_triples
    stream = [
        (enc([("e:1", "p:goals", "10")]), enc([("e:3", A, "c:Athlete"), ("e:3", "p:goals", "4")])),
        (enc([("e:3", "p:goals", "4"), ("e:9", "p:x", "y")]), enc([("e:2", "p:goals", "7")])),
        (enc([("e:2", "p:goals", "7"), ("e:3", A, "c:Athlete")]), enc([("e:1", "p:goals", "11")])),
    ]
    shapes = [([("?a", A, "c:Athlete"), ("?a", "p:goals", "?v")], []), ([("?b", A, "c:Athlete"), ("?b", "p:goals", "?w")], [])]
    caps = tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32)
    plans = [tcore.compile_interest(tcore.InterestExpr.parse("g", "t", *s), d) for s in shapes]
    batches = []
    for first in (0, 2):
        b = tcore.ChangesetBatch.fresh(*stream[first], first + 1, "cpu")
        for i in range(first + 1, 3):
            b.extend(*stream[i], i + 1)
        batches.append(b)
    d_native = [b.device_stores()[0] for b in batches]
    a_sets = tuple(tcore.rehome(b.device_stores()[1], caps.n_added) for b in batches)
    bank_rows = tcore.IncrementalPatternBank()
    lanes = [bank_rows.add_plan(p) for p in plans]
    bank_dev = torch.as_tensor(bank_rows.patterns_padded())
    # members: plan 0 and plan 1 on frontier 0, plan 0 and plan 1 on frontier 1
    statics = tbroker._assemble_cohort_statics([plans[k % 2].patterns for k in range(4)],
                                               [lanes[k % 2] for k in range(4)], [0, 1, 2, 3], [0, 0, 1, 1],
                                               4, plans[0].n_total, bank_dev.shape[0], "cpu")
    taus = tuple(tcore.from_numpy(tau0, caps.tau, "cpu") for _ in range(4))
    rhos = tuple(tcore.from_numpy(np.zeros((0, 3), np.int32), caps.rho, "cpu") for _ in range(4))

    d_sets = tuple(tcore.rehome(st, caps.n_removed) for st in d_native)
    stacked_words = tuple(ops.pattern_bitmask_words(st.spo, bank_dev) for st in d_sets)
    stacked = tbroker.make_cohort_step(plans[0], caps, d.id_capacity * caps.id_headroom)(
        d_sets, stacked_words, a_sets, bank_dev, taus, rhos, statics)

    chain = tprop.build_frontier_chain(d_native, 0, 64)
    assert chain.covered and int(chain.union.n) == int(d_native[0].n)
    words = ops.pattern_bitmask_words_segmented(chain.union.spo, bank_dev, chain.seg, 2)
    delta = tbroker.make_cohort_step(plans[0], caps, d.id_capacity * caps.id_headroom, delta=True)(
        chain.union, tuple(words), a_sets, bank_dev, taus, rhos, statics)

    fired = 0
    for k in range(4):
        for got, want in ((delta[0][k], stacked[0][k]), (delta[1][k], stacked[1][k])):
            np.testing.assert_array_equal(tcore.to_numpy(got), tcore.to_numpy(want))
        for f in ("r", "r_i", "r_prime", "a", "a_i"):
            np.testing.assert_array_equal(tcore.to_numpy(getattr(delta[2][k], f)),
                                          tcore.to_numpy(getattr(stacked[2][k], f)), err_msg=f"{k} {f}")
        fired += int(delta[2][k].r.n) + int(delta[2][k].a.n)
        assert not bool(delta[2][k].overflow)
    assert fired > 0
