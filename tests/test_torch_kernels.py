"""Plain versions of the port's kernels against the JAX package (CPU, exact).

K1 (triple_match) against ``triple_match_pallas`` in interpret mode and the
``pattern_bitmask_ref`` oracle; K2/K3 (merge_probe) left and right against
``merge_probe_ref``, ``ops.merge_probe(use_kernel=True)`` and
``searchsorted_rows``, and its range mode against ``triples.prefix_range``;
K4 and K6 (bank words, plain and segmented) against
``triple_match_words_pallas`` and ``triple_match_words_segmented_pallas`` in
interpret mode on the card tests' edge banks; K5 (lane bits) against
``triple_match_lanes_pallas`` in interpret mode and ``pattern_lane_bits_ref``
on the card tests' edge cohorts.
The CUDA kernels themselves are held against these plain versions on the
card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import triples as jt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.triple_match import BLOCK_ROWS, triple_match_lanes_pallas, triple_match_pallas  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import triples as tcore_triples  # noqa: E402
from repro_torch.kernels import build, merge_join, ops, ref, triple_match  # noqa: E402
from test_torch_cuda import bank_case, lanes_case  # noqa: E402

PAD = int(np.iinfo(np.int32).max)
TILE = 128 * BLOCK_ROWS  # the TPU kernel's 4096-row tile


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# K1: triple_match
# ---------------------------------------------------------------------------

def k1_case(name):
    rng = np.random.default_rng(len(name))
    if name == "tile":
        spo = rng.integers(0, 9, size=(TILE, 3))
        pats = np.array([[1, -1, 2], [-1, -1, -1], [3, 4, -1]])
    elif name == "two_tiles_pad_rows":
        spo = rng.integers(0, 9, size=(2 * TILE, 3))
        spo[rng.random(2 * TILE) < 0.2] = PAD
        pats = rng.integers(-1, 9, size=(7, 3))
    elif name == "wildcard_only":
        spo = rng.integers(0, 5, size=(TILE, 3))
        spo[::5] = PAD
        pats = np.full((1, 3), -1)
    elif name == "bit31":
        spo = rng.integers(0, 4, size=(TILE, 3))
        spo[::9] = PAD
        pats = rng.integers(-1, 4, size=(32, 3))
        pats[31] = [-1, -1, -1]  # bit 31 set on every valid row
    else:
        raise KeyError(name)
    return spo.astype(np.int32), pats.astype(np.int32)


@pytest.mark.parametrize("name", ["tile", "two_tiles_pad_rows", "wildcard_only", "bit31"])
def test_triple_match_plain_equals_pallas_interpret(name):
    spo, pats = k1_case(name)
    want = np.asarray(triple_match_pallas(jnp.asarray(spo), jnp.asarray(pats), interpret=True))
    oracle = np.asarray(jref.pattern_bitmask_ref(jnp.asarray(spo), jnp.asarray(pats)))
    got = ref.pattern_bitmask_ref(torch.as_tensor(spo), torch.as_tensor(pats))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(as_u32(got), oracle)
    if name == "bit31":
        valid = spo[:, 0] != PAD
        assert (as_u32(got)[valid] >> 31 == 1).all() and (got.numpy()[valid] < 0).all()
        assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("n", [TILE - 1, TILE + 1, 37])
def test_triple_match_plain_across_tile_boundary(n):
    rng = np.random.default_rng(n)
    spo = rng.integers(0, 9, size=(n, 3)).astype(np.int32)
    pats = np.array([[1, -1, 2], [-1, -1, -1], [-1, 3, -1]], np.int32)
    want = np.asarray(jops.pattern_bitmask(jnp.asarray(spo), jnp.asarray(pats), use_kernel=True))
    got = ops.pattern_bitmask(torch.as_tensor(spo), torch.as_tensor(pats))
    np.testing.assert_array_equal(as_u32(got), want)


def test_triple_match_rejects_more_than_32_patterns():
    spo = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.pattern_bitmask(spo, torch.full((33, 3), -1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K2/K3: merge_probe
# ---------------------------------------------------------------------------

def sorted_store(rows: np.ndarray, capacity: int) -> np.ndarray:
    rows = np.unique(rows.astype(np.int32), axis=0)[:capacity]
    out = np.full((capacity, 3), PAD, np.int32)
    out[: rows.shape[0]] = rows
    return out


def k2_case(name):
    """A store of 4096 rows and 2048 queries in every case (one JAX compile)."""
    rng = np.random.default_rng(len(name))
    if name == "random_with_pad_tail":
        store = sorted_store(rng.integers(0, 30, size=(3000, 3)), 4096)
        queries = rng.integers(0, 30, size=(2048, 3))
    elif name == "duplicates_and_absent":
        store = sorted_store(rng.integers(0, 12, size=(2600, 3)), 4096)
        hits = store[rng.integers(0, 1000, size=1500)]
        queries = np.concatenate([hits, hits[:348], rng.integers(12, 20, size=(200, 3))])
    elif name == "skewed":
        store = sorted_store(rng.integers(0, 40, size=(6000, 3)), 4096)
        queries = np.repeat(store[100:104], 512, axis=0)  # one hot region
    elif name == "full_store":
        store = sorted_store(rng.integers(0, 20, size=(8000, 3)), 4096)
        queries = rng.integers(0, 21, size=(2048, 3))
    else:
        raise KeyError(name)
    return store, queries.astype(np.int32)


K2_CASES = ["random_with_pad_tail", "duplicates_and_absent", "skewed", "full_store"]


@pytest.mark.parametrize("name", K2_CASES)
def test_merge_probe_plain_equals_reference(name):
    store, queries = k2_case(name)
    js, jq = jnp.asarray(store), jnp.asarray(queries)
    ts, tq = torch.as_tensor(store), torch.as_tensor(queries)

    idx, found = ops.merge_probe(ts, tq, side="left")
    right, none = ops.merge_probe(ts, tq, side="right")
    assert none is None and idx.dtype == torch.int32 and found.dtype == torch.bool

    o_idx, o_found = jref.merge_probe_ref(js, jq)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(o_idx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(o_found))
    k_idx, k_found = jops.merge_probe(js, jq, use_kernel=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(k_idx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(k_found))
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jt.searchsorted_rows(js, jq, side="left"))
    )
    np.testing.assert_array_equal(
        right.numpy(), np.asarray(jt.searchsorted_rows(js, jq, side="right"))
    )
    assert found.any() and (right >= idx).all()


def test_merge_probe_pad_queries_follow_the_oracle():
    """A PAD query is "found" in a store with a PAD tail, as in merge_probe_ref
    (and triples.member); set algebra masks PAD rows out before it asks."""
    store = sorted_store(np.arange(30).reshape(10, 3), 16)
    queries = np.array([[PAD] * 3, [0, 1, 2], [PAD] * 3], np.int32)
    o_idx, o_found = jref.merge_probe_ref(jnp.asarray(store), jnp.asarray(queries))
    idx, found = ops.merge_probe(torch.as_tensor(store), torch.as_tensor(queries))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(o_idx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(o_found))


def prefix_case(name):
    """(store, prefix, depth): prefixes of mixed depths over a store with a
    PAD tail, present, absent and PAD prefixes, INT32_MIN columns."""
    rng = np.random.default_rng(len(name) + 11)
    rows = rng.integers(0, 12, size=(2600, 3))
    rows[::9, 1] = np.iinfo(np.int32).min  # INT32_MIN columns in the store
    store = sorted_store(rows, 4096)
    valid = int((store[:, 0] != PAD).sum())
    prefix = np.concatenate([store[rng.integers(0, valid, 1500)], rng.integers(-1, 14, size=(540, 3)),
                             np.full((8, 3), PAD)]).astype(np.int32)
    prefix[::13, 2] = np.iinfo(np.int32).min
    if name == "sorted_subjects":
        prefix = prefix[np.lexsort((prefix[:, 2], prefix[:, 1], prefix[:, 0]))]
        depth = np.ones(prefix.shape[0], np.int32)
    else:
        depth = rng.integers(1, 4, prefix.shape[0]).astype(np.int32)
    return store, prefix, depth


@pytest.mark.parametrize("name", ["mixed_depths", "sorted_subjects"])
def test_merge_probe_range_equals_reference_prefix_range(name):
    store, prefix, depth = prefix_case(name)
    j_start, j_end = jt.prefix_range(jt.TripleStore(spo=jnp.asarray(store), n=jnp.int32((store[:, 0] != PAD).sum())),
                                     jnp.asarray(prefix), jnp.asarray(depth))
    col = np.arange(3)[None, :]
    lo_q = np.where(col < depth[:, None], prefix, np.iinfo(np.int32).min).astype(np.int32)
    hi_q = np.where(col < depth[:, None], prefix, PAD).astype(np.int32)
    ts, tlo, thi = (torch.as_tensor(a) for a in (store, lo_q, hi_q))
    start, end = ref.merge_probe_range_ref(ts, tlo, thi)
    o_start, o_end = ops.merge_probe(ts, tlo, side="range", hi_queries=thi)
    assert start.dtype == end.dtype == torch.int32
    for got in (start, o_start):
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_start))
    for got in (end, o_end):
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_end))
    assert (end >= start).all() and (end > start).any()
    t_start, t_end = tcore_triples.prefix_range(
        tcore_triples.TripleStore(spo=ts, n=torch.tensor(int((store[:, 0] != PAD).sum()), dtype=torch.int32)),
        torch.as_tensor(prefix), torch.as_tensor(depth))
    np.testing.assert_array_equal(t_start.numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(t_end.numpy(), np.asarray(j_end))


def test_prefix_range_is_one_probe(monkeypatch):
    """The port's prefix_range asks the probe once, in range mode (one
    launch on the card), where the reference searches twice."""
    calls = []
    real = ops.merge_probe
    monkeypatch.setattr(ops, "merge_probe", lambda *a, **k: calls.append(k.get("side")) or real(*a, **k))
    store, prefix, depth = prefix_case("mixed_depths")
    st = tcore_triples.TripleStore(spo=torch.as_tensor(store), n=torch.tensor(2600, dtype=torch.int32))
    tcore_triples.prefix_range(st, torch.as_tensor(prefix), torch.as_tensor(depth))
    assert calls == ["range"]


def test_merge_probe_range_takes_hi_queries_only_in_range_mode():
    spo = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.merge_probe(spo, spo, side="range")
    with pytest.raises(ValueError):
        ops.merge_probe(spo, spo, side="left", hi_queries=spo)
    with pytest.raises(ValueError):
        ops.merge_probe(spo, spo, side="middle")


def test_merge_probe_tile_constants_match_the_source():
    src = (build.CSRC_DIR / build.SOURCES["merge_probe"]).read_text()
    assert f"constexpr int kTile = {merge_join.TILE};" in src
    assert f"constexpr int kWindowRows = {merge_join.WINDOW_ROWS};" in src
    assert len(merge_join.TILE_PATHS) == 3


# ---------------------------------------------------------------------------
# K4 and K6: bank words, plain and segmented
# ---------------------------------------------------------------------------

# (bank kind, P): many slots sharing one constant, wildcard-only slots,
# all-PAD slots and slots PAD at one position (of rows PAD there too); W = 1
# and 2, at most 64 bank rows (the interpret-mode kernels are slow for wider
# banks)
@pytest.mark.parametrize("kind,n_pat", [("shared", 12), ("pad", 7), ("wild", 33), ("pad", 36)])
def test_bank_words_plain_equal_pallas_interpret_on_edge_banks(kind, n_pat):
    rng = np.random.default_rng(n_pat)
    spo, pats = bank_case(rng, 1001, n_pat, kind)
    seg = rng.integers(0, 1 << 3, size=1001).astype(np.int32)
    got = ops.pattern_bitmask_words(torch.as_tensor(spo), torch.as_tensor(pats))
    want = np.asarray(jops.pattern_bitmask_words(jnp.asarray(spo), jnp.asarray(pats), use_kernel=True))
    np.testing.assert_array_equal(as_u32(got), want)
    got = ops.pattern_bitmask_words_segmented(torch.as_tensor(spo), torch.as_tensor(pats), torch.as_tensor(seg), 2)
    want = np.asarray(jops.pattern_bitmask_words_segmented(jnp.asarray(spo), jnp.asarray(pats), jnp.asarray(seg), 2,
                                                           use_kernel=True))
    np.testing.assert_array_equal(as_u32(got), want)



# ---------------------------------------------------------------------------
# K5: bank match + lane routing + member mask
# ---------------------------------------------------------------------------

# (members, rows, bank rows, nt, inactive members, rows kind, held against):
# one TPU tile of lex-sorted PAD-tailed members (one all PAD) with nt = 32
# across W = 2 and an inactive member, and random rows over all-wildcard and
# PAD bank rows, against the TPU kernel in interpret mode; N % 4 = 1 and
# N < 4, which the TPU kernel does not take, against the JAX oracle
LANES_PALLAS_CASES = [(3, TILE, 64, 32, (1,), "sorted", "pallas"), (2, TILE, 45, 6, (), "random", "pallas"),
                      (5, 4097, 64, 3, (1,), "sorted", "oracle"), (3, 3, 32, 4, (0,), "random", "oracle")]


@pytest.mark.parametrize("r,n,n_pat,nt,inactive,kind,against", LANES_PALLAS_CASES)
def test_lane_bits_plain_equal_pallas_interpret_on_edge_cohorts(r, n, n_pat, nt, inactive, kind, against):
    rows, pats, lanes, active = lanes_case(np.random.default_rng(r * n + nt), r, n, n_pat, nt, 0, inactive, kind)
    spo_b = rows.reshape(r, n, 3)
    got = ops.pattern_lane_bits_batched(*(torch.as_tensor(x) for x in (spo_b, pats, lanes, active)))
    if against == "pallas":
        want = triple_match_lanes_pallas(jnp.asarray(spo_b), jnp.asarray(pats), jnp.asarray(lanes),
                                         jnp.asarray(active.astype(np.int32).reshape(r, 1)), interpret=True)
    else:
        want = jref.pattern_lane_bits_ref(jnp.asarray(spo_b), jnp.asarray(pats), jnp.asarray(lanes),
                                          jnp.asarray(active))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    assert (got.numpy()[~active] == 0).all() and (got.numpy()[spo_b[..., 0] == PAD] == 0).all()

# ---------------------------------------------------------------------------
# dispatch, counters and the build, without a card
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launch_counts()
    spo = torch.zeros((8, 3), dtype=torch.int32)
    ops.pattern_bitmask(spo, torch.full((2, 3), -1, dtype=torch.int32))
    ops.merge_probe(spo, spo, side="left")
    ops.merge_probe(spo, spo, side="right")
    ops.pattern_bitmask_words(spo, torch.full((40, 3), -1, dtype=torch.int32))
    ops.pattern_lane_bits_batched(spo[None], torch.full((32, 3), -1, dtype=torch.int32),
                                  torch.zeros((1, 2), dtype=torch.int32))
    words = ops.pattern_bitmask_words_segmented(spo, torch.full((40, 3), -1, dtype=torch.int32),
                                                torch.ones(8, dtype=torch.int32), 2)
    ops.lane_refine(spo, words, torch.zeros(1, dtype=torch.int32), torch.full((1, 3), -1, dtype=torch.int32))
    assert kernels.launch_counts() == {
        "triple_match": 0, "merge_probe": 0, "triple_match_words": 0, "triple_match_lanes": 0,
        "triple_match_words_segmented": 0, "lane_refine": 0,
    }


def test_kernel_wrappers_refuse_cpu_and_other_devices():
    spo = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        triple_match.triple_match_cuda(spo, spo[:1])
    with pytest.raises(ValueError):
        merge_join.merge_probe_cuda(spo, spo)
    with pytest.raises(ValueError):
        merge_join.merge_probe_range_cuda(spo, spo, spo)
    meta = torch.zeros((8, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.pattern_bitmask(meta, meta[:1])
    with pytest.raises(ValueError):
        ops.merge_probe(meta, meta)


def test_build_digest_covers_the_headers(tmp_path, monkeypatch):
    """Editing the header the bank-words kernels share rebuilds both."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = ("triple_match_words", "triple_match_words_segmented")
    before = {name: build.library_path(name) for name in names}
    header = csrc / "bank_slot_masks.cuh"
    header.write_text(header.read_text() + "// edited\n")
    for name in names:
        assert build.library_path(name) != before[name]


def test_build_targets_hopper_from_repo_sources():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name, src in build.SOURCES.items():
        assert (build.CSRC_DIR / src).is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path == build.library_path(name)
