"""repro_torch.core.triples against repro.core.triples on random stores (CPU, exact).

Inputs are made with numpy from a seed and go through both packages; every
output array and flag must be equal. The tests change no process-wide JAX or
environment setting.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import triples as jt  # noqa: E402
from repro_torch.core import triples as tt  # noqa: E402

PAD = int(np.iinfo(np.int32).max)
SEEDS = [0, 1, 2, 3]
CAP = 64  # one capacity for every case, so the JAX side compiles once


def rand_rows(rng, n, vocab=6):
    return rng.integers(0, vocab, size=(n, 3)).astype(np.int32)


def store_arrays(rng, n_rows, cap=CAP, vocab=6):
    rows = np.unique(rand_rows(rng, n_rows, vocab), axis=0)[:cap]
    spo = np.full((cap, 3), PAD, np.int32)
    spo[: rows.shape[0]] = rows  # np.unique sorts rows lexicographically
    return spo, rows.shape[0]


def both(spo, n):
    return (
        jt.TripleStore(spo=jnp.asarray(spo), n=jnp.asarray(n, jnp.int32)),
        tt.TripleStore(spo=torch.as_tensor(spo), n=torch.tensor(n, dtype=torch.int32)),
    )


def assert_store_equal(j, t):
    np.testing.assert_array_equal(np.asarray(j.spo), t.spo.numpy())
    assert int(j.n) == int(t.n)
    assert t.spo.dtype == torch.int32 and t.n.dtype == torch.int32


@pytest.mark.parametrize("seed", SEEDS)
def test_lex_sort(seed):
    rng = np.random.default_rng(seed)
    rows = rand_rows(rng, 50, vocab=4)
    rows[rng.random(50) < 0.2] = PAD
    rows[::7, 1] = -5  # negative ids sort first, as in the reference
    np.testing.assert_array_equal(
        np.asarray(jt.lex_sort(jnp.asarray(rows))), tt.lex_sort(torch.as_tensor(rows)).numpy()
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("capacity", [8, CAP, 128])
def test_from_array_with_overflow_flag(seed, capacity):
    rng = np.random.default_rng(seed)
    rows = rand_rows(rng, 40, vocab=4)
    rows[rng.random(40) < 0.1] = PAD
    js, jo = jt.from_array(jnp.asarray(rows), capacity)
    ts, to = tt.from_array(torch.as_tensor(rows), capacity)
    assert_store_equal(js, ts)
    assert bool(jo) == bool(to)
    assert bool(to) == (capacity == 8)  # 40 rows over 4**3 ids: more than 8 distinct


@pytest.mark.parametrize("seed", SEEDS)
def test_member_and_searchsorted(seed):
    rng = np.random.default_rng(seed)
    js, ts = both(*store_arrays(rng, 30))
    queries = rand_rows(rng, 48)
    queries[:3] = PAD  # PAD queries meet the PAD tail
    jq, tq = jnp.asarray(queries), torch.as_tensor(queries)
    np.testing.assert_array_equal(np.asarray(jt.member(js, jq)), tt.member(ts, tq).numpy())
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            np.asarray(jt.searchsorted_rows(js.spo, jq, side=side)),
            tt.searchsorted_rows(ts.spo, tq, side=side).numpy(),
        )


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_range(seed):
    rng = np.random.default_rng(seed)
    js, ts = both(*store_arrays(rng, 40, vocab=4))
    prefix = rand_rows(rng, 48, vocab=5)
    depth = rng.integers(1, 4, size=48).astype(np.int32)
    j_start, j_end = jt.prefix_range(js, jnp.asarray(prefix), jnp.asarray(depth))
    t_start, t_end = tt.prefix_range(ts, torch.as_tensor(prefix), torch.as_tensor(depth))
    np.testing.assert_array_equal(np.asarray(j_start), t_start.numpy())
    np.testing.assert_array_equal(np.asarray(j_end), t_end.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_set_algebra(seed):
    rng = np.random.default_rng(seed)
    ja, ta = both(*store_arrays(rng, 40))
    jb, tb = both(*store_arrays(rng, 40))
    jd, td = both(*store_arrays(rng, 20))
    assert_store_equal(jt.difference(ja, jb), tt.difference(ta, tb))
    assert_store_equal(jt.intersection(ja, jb), tt.intersection(ta, tb))
    for capacity in (None, 16, 2 * CAP):
        ju, jo = jt.union(ja, jb, capacity)
        tu, to = tt.union(ta, tb, capacity)
        assert_store_equal(ju, tu)
        assert bool(jo) == bool(to)
    jv, jo = jt.apply_changeset(ja, jd, jb)
    tv, to = tt.apply_changeset(ta, td, tb)
    assert_store_equal(jv, tv)
    assert bool(jo) == bool(to)


@pytest.mark.parametrize("seed", SEEDS)
def test_rehome_grow_and_shrink(seed):
    rng = np.random.default_rng(seed)
    js, ts = both(*store_arrays(rng, 12))
    n = int(ts.n)
    for capacity in (CAP, 2 * CAP, max(n, 1)):
        assert_store_equal(jt.rehome(js, capacity), tt.rehome(ts, capacity))


def test_store_helpers_roundtrip():
    rng = np.random.default_rng(7)
    rows = rand_rows(rng, 30)
    ts = tt.from_numpy(rows, CAP, "cpu")
    js = jt.from_numpy(rows, CAP)
    assert tt.to_set(ts) == jt.to_set(js)
    np.testing.assert_array_equal(tt.to_numpy(ts), jt.to_numpy(js))
    assert_store_equal(jt.empty(CAP), tt.empty(CAP, "cpu"))
    with pytest.raises(ValueError):
        tt.from_numpy(rows, 4, "cpu")
