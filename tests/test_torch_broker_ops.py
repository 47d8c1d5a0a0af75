"""The broker's operations in repro_torch against repro's (CPU, exact).

* bank words (K4) and fused lane bits (K5): the plain versions against the
  reference's oracles, its ops on the CPU and, for one case each, its Pallas
  kernels in interpret mode; W = 1, 2 and 5, banks of P not a multiple of
  32 with bit 31 set, all-PAD bank rows, PAD rows, 1/4095/4097 rows,
  inactive members, nt = 1 and 32, lanes in the last word;
* ``lane_bits`` / ``lane_bits_batched`` and the ``matcher`` hook paths;
* ``compose_changesets`` and ``ChangesetBatch`` (extend, growth, decay,
  ``row_bounds``) driven in step with the reference's;
* ``probe_dyn`` against the reference's.

The CUDA kernels are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import evaluation as jev  # noqa: E402
from repro.core import propagation as jprop  # noqa: E402
from repro.core import triples as jt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import evaluation as tev  # noqa: E402
from repro_torch.core import propagation as tprop  # noqa: E402
from repro_torch.core import triples as tt  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

PAD = int(np.iinfo(np.int32).max)


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def bank_case(n, n_pat, vocab, seed, dead=()):
    """Rows with PAD rows; a bank whose last pattern is all-wildcard (it sets
    the top bit of its word on every valid row) and whose ``dead`` rows are
    all-PAD (tombstones)."""
    rng = np.random.default_rng(seed)
    spo = rng.integers(0, vocab, size=(n, 3)).astype(np.int32)
    spo[rng.random(n) < 0.1] = PAD
    pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
    if n_pat:
        pats[-1] = -1
    for j in dead:
        pats[j] = PAD
    return spo, pats


WORDS_CASES = {
    # name: (n, P, vocab, dead rows)
    "one_row_W1": (1, 7, 3, ()),
    "W1_bit31": (4095, 32, 4, (3,)),
    "W2_partial": (4097, 45, 5, (0, 40)),
    "W5": (700, 160, 6, (31, 63, 100)),
    "W2_all_dead_word": (300, 64, 4, tuple(range(32, 63))),
    "empty_bank": (9, 0, 3, ()),
}


@pytest.mark.parametrize("name", sorted(WORDS_CASES))
def test_bank_words_plain_equal_reference(name):
    n, n_pat, vocab, dead = WORDS_CASES[name]
    spo, pats = bank_case(n, n_pat, vocab, n + n_pat, dead)
    want = np.asarray(jref.pattern_bitmask_words_ref(jnp.asarray(spo), jnp.asarray(pats.reshape(-1, 3))))
    got = ref.pattern_bitmask_words_ref(torch.as_tensor(spo), torch.as_tensor(pats.reshape(-1, 3)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, max(1, -(-n_pat // 32)))
    np.testing.assert_array_equal(as_u32(got), want)
    via_ops = ops.pattern_bitmask_words(torch.as_tensor(spo), torch.as_tensor(pats.reshape(-1, 3)))
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())
    valid = spo[:, 0] != PAD
    assert (got.numpy()[~valid] == 0).all()
    if n_pat % 32 == 0 and n_pat:
        # the all-wildcard last pattern sets bit 31 of the last word
        assert (got.numpy()[valid, -1] < 0).all()


def test_bank_words_plain_equal_pallas_interpret():
    spo, pats = bank_case(4097, 45, 5, 11, dead=(2,))
    want = np.asarray(jops.pattern_bitmask_words(jnp.asarray(spo), jnp.asarray(pats), use_kernel=True))
    got = ops.pattern_bitmask_words(torch.as_tensor(spo), torch.as_tensor(pats))
    np.testing.assert_array_equal(as_u32(got), want)


def lanes_case(r, n, n_pat, nt, seed, inactive=()):
    rng = np.random.default_rng(seed)
    spo_b = rng.integers(0, 4, size=(r, n, 3)).astype(np.int32)
    spo_b[rng.random((r, n)) < 0.1] = PAD
    pats = rng.integers(-1, 4, size=(n_pat, 3)).astype(np.int32)
    pats[-1] = -1
    pats[n_pat // 2] = PAD  # a tombstone
    lanes = rng.integers(0, n_pat, size=(r, nt)).astype(np.int32)
    lanes[:, -1] = n_pat - 1  # a lane in the last word: the all-wildcard row
    active = np.ones(r, bool)
    active[list(inactive)] = False
    return spo_b, pats, lanes, active


LANES_CASES = {
    # name: (members, rows, bank rows, nt, inactive members)
    "nt1": (2, 33, 32, 1, ()),
    "nt32_W2": (3, 100, 64, 32, (1,)),
    "W5_last_word": (4, 257, 160, 6, (0, 3)),
    "all_inactive": (2, 17, 32, 4, (0, 1)),
}


@pytest.mark.parametrize("name", sorted(LANES_CASES))
def test_lane_bits_plain_equal_reference(name):
    r, n, n_pat, nt, inactive = LANES_CASES[name]
    spo_b, pats, lanes, active = lanes_case(r, n, n_pat, nt, n + nt, inactive)
    want = np.asarray(jref.pattern_lane_bits_ref(
        jnp.asarray(spo_b), jnp.asarray(pats), jnp.asarray(lanes), jnp.asarray(active)))
    args = (torch.as_tensor(spo_b), torch.as_tensor(pats), torch.as_tensor(lanes), torch.as_tensor(active))
    got = ref.pattern_lane_bits_ref(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == (r, n)
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(ops.pattern_lane_bits_batched(*args).numpy(), got.numpy())
    assert (got.numpy()[~active] == 0).all()
    # without a member mask every member counts
    full = ref.pattern_lane_bits_ref(*args[:3])
    np.testing.assert_array_equal(
        as_u32(full),
        np.asarray(jref.pattern_lane_bits_ref(jnp.asarray(spo_b), jnp.asarray(pats), jnp.asarray(lanes))),
    )
    if nt == 32:
        valid = (spo_b[..., 0] != PAD) & active[:, None]
        assert (got.numpy()[valid] < 0).all()  # bit 31: the all-wildcard lane


def test_lane_bits_plain_equal_pallas_interpret():
    spo_b, pats, lanes, active = lanes_case(2, 4097, 64, 5, 3, inactive=(1,))
    want = np.asarray(jops.pattern_lane_bits_batched(
        jnp.asarray(spo_b), jnp.asarray(pats), jnp.asarray(lanes), jnp.asarray(active), use_kernel=True))
    got = ops.pattern_lane_bits_batched(
        torch.as_tensor(spo_b), torch.as_tensor(pats), torch.as_tensor(lanes), torch.as_tensor(active))
    np.testing.assert_array_equal(as_u32(got), want)


def test_lane_routing_equals_reference():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(3, 50, 2), dtype=np.uint64).astype(np.uint32)
    lanes_arr = rng.integers(0, 64, size=(3, 7)).astype(np.int32)
    lanes_arr[0, 0] = 63  # bit 31 of the last word
    active = np.array([True, False, True])
    t_words = torch.as_tensor(words.view(np.int32))
    got = ops.lane_bits_batched(t_words, torch.as_tensor(lanes_arr), torch.as_tensor(active))
    want = np.asarray(jops.lane_bits_batched(jnp.asarray(words), jnp.asarray(lanes_arr), active=jnp.asarray(active)))
    np.testing.assert_array_equal(as_u32(got), want)
    for lanes in ((0, 37, 5, 33, 12, 39), (63,), tuple(range(31, -1, -1))):
        got1 = ops.lane_bits(t_words[0], lanes)
        np.testing.assert_array_equal(as_u32(got1), np.asarray(jops.lane_bits(jnp.asarray(words[0]), lanes)))


def test_words_then_lane_bits_equal_per_plan_bitmask():
    """Bank words routed by lane equal each plan's own bitmask (two words,
    lanes out of order), as the broker relies on."""
    rng = np.random.default_rng(0)
    spo = torch.as_tensor(rng.integers(0, 6, size=(64, 3)).astype(np.int32))
    pats = np.full((40, 3), -1, np.int32)
    pats[:, 1] = np.arange(40) % 6
    pats[::3, 2] = np.arange(len(pats[::3])) % 6
    words = ops.pattern_bitmask_words(spo, torch.as_tensor(pats))
    lanes = (0, 37, 5, 33, 12, 39)
    want = ref.pattern_bitmask_ref(spo, torch.as_tensor(pats[list(lanes)]))
    np.testing.assert_array_equal(ops.lane_bits(words, lanes).numpy(), want.numpy())


class CountingMatcher:
    def __init__(self):
        self.calls = []

    def __call__(self, spo, patterns):
        self.calls.append(patterns.shape[0])
        return ref.pattern_bitmask_ref(spo, patterns)


def test_matcher_hook_runs_one_pass_per_word():
    spo, pats = bank_case(200, 70, 5, 4, dead=(33,))
    spo_t, pats_t = torch.as_tensor(spo), torch.as_tensor(pats)
    hook = CountingMatcher()
    got = ops.pattern_bitmask_words(spo_t, pats_t, matcher=hook)
    assert hook.calls == [32, 32, 6]
    np.testing.assert_array_equal(got.numpy(), ops.pattern_bitmask_words(spo_t, pats_t).numpy())
    # the lane path composes words + routing under a hook: every bank pass shows
    spo_b, bank, lanes, active = lanes_case(3, 40, 64, 5, 8, inactive=(2,))
    hook = CountingMatcher()
    args = (torch.as_tensor(spo_b), torch.as_tensor(bank), torch.as_tensor(lanes), torch.as_tensor(active))
    got = ops.pattern_lane_bits_batched(*args, matcher=hook)
    assert hook.calls == [32, 32] * 3
    np.testing.assert_array_equal(got.numpy(), ops.pattern_lane_bits_batched(*args).numpy())
    assert kernels.launch_counts()["triple_match_lanes"] == 0


# ---------------------------------------------------------------------------
# composition under Definition 6, and the pending-batch accumulator
# ---------------------------------------------------------------------------

def store_pair(rows, cap):
    return jt.from_numpy(rows, cap), tt.from_numpy(rows, cap, "cpu")


def assert_store_equal(j, t):
    np.testing.assert_array_equal(np.asarray(j.spo), t.spo.numpy())
    assert int(j.n) == int(t.n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_changesets_equal_reference_and_def6(seed):
    rng = np.random.default_rng(seed)
    sides = [np.unique(rng.integers(0, 4, size=(30, 3)).astype(np.int32), axis=0) for _ in range(4)]
    cap = 64
    (jd1, td1), (ja1, ta1), (jd2, td2), (ja2, ta2) = (store_pair(s, cap) for s in sides)
    jd, ja, jovf = jprop.compose_changesets(jd1, ja1, jd2, ja2, cap)
    td, ta, tovf = tprop.compose_changesets(td1, ta1, td2, ta2, cap)
    assert_store_equal(jd, td)
    assert_store_equal(ja, ta)
    assert bool(jovf) == bool(tovf)
    # applying the composed changeset equals applying both in order
    base = {tuple(r) for r in rng.integers(0, 4, size=(40, 3)).tolist()}
    d1, a1, d2, a2 = ({tuple(map(int, r)) for r in s} for s in sides)
    assert ((((base - d1) | a1) - d2) | a2) == (base - tt.to_set(td)) | tt.to_set(ta)
    # a capacity too small for the union reports overflow, as the reference does
    _, _, jsmall = jprop.compose_changesets(jd1, ja1, jd2, ja2, 8)
    _, _, tsmall = tprop.compose_changesets(td1, ta1, td2, ta2, 8)
    assert bool(jsmall) == bool(tsmall) is True


def test_changeset_batch_follows_the_reference():
    """Extend (overflow growth and raw-size growth), row bounds, decay and
    the host/device views, driven in step on both packages."""
    rng = np.random.default_rng(7)

    def cs(n=40, vocab=5):
        return (rng.integers(0, vocab, size=(n, 3)).astype(np.int32),
                rng.integers(0, vocab, size=(n, 3)).astype(np.int32))

    first = cs()
    jb = jprop.ChangesetBatch.fresh(*first, 3)
    tb = tprop.ChangesetBatch.fresh(*first, 3, "cpu")

    def same():
        for f in ("n_changesets", "first_id", "last_id", "capacity", "grow_count"):
            assert getattr(tb, f) == getattr(jb, f), f
        assert tb.row_bounds() == jb.row_bounds()
        for j_arr, t_arr in zip(jb.arrays(), tb.arrays()):
            np.testing.assert_array_equal(np.asarray(j_arr), np.asarray(t_arr))
        if tb.removed is not None:
            for js, ts in zip(jb.device_stores(), tb.device_stores()):
                assert_store_equal(js, ts)

    def extend(d, a, cid):
        jb.extend(d, a, cid)
        tb.extend(d, a, cid)
        same()

    same()
    assert tb.row_bounds() == (40, 40)  # raw counts while one changeset is held
    assert tb.maybe_decay() is False  # nothing composed yet
    for cid in (5, 6, 7):  # the composed D outgrows 64 rows: overflow doubling
        extend(*cs(), cid)
    assert tb.grow_count > 0 and tb.capacity == 128
    assert tb.removed.spo.device.type == "cpu"
    # 300 raw rows of few distinct triples: the capacity follows the raw size
    # while the composed rows stay few, so the batch decays at drain checks
    dup = np.repeat(cs(n=3, vocab=5)[0], 100, axis=0)
    extend(dup, dup[:40], 8)
    assert tb.capacity == 512
    for _ in range(3):
        assert tb.maybe_decay(patience=2) == jb.maybe_decay(patience=2)
        same()
    assert tb.capacity == 128


@pytest.mark.parametrize("bound_slot", [0, 2])
def test_probe_dyn_equal_reference(bound_slot):
    rng = np.random.default_rng(bound_slot + 10)
    rows = rng.integers(0, 6, size=(300, 3)).astype(np.int32)
    j_idx = jev.build_index(jt.from_numpy(rows, 512))
    t_idx = tev.build_index(tt.from_numpy(rows, 512, "cpu"))
    bound = rng.integers(0, 7, size=40).astype(np.int32)
    bound[::5] = PAD
    # the host row says which slots are constant; the device row gives values
    for host, values in (([-1, 2, -1], [-1, 3, -1]), ([-1, 3, 4], [-1, 1, 2]),
                         ([1, -1, -1], [4, -1, -1]), ([5, 0, 1], [2, 2, 2])):
        host, values = np.asarray(host, np.int32), np.asarray(values, np.int32)
        j_rows, j_val = jev.probe_dyn(j_idx, host, jnp.asarray(values), bound_slot, jnp.asarray(bound), 3)
        t_rows, t_val = tev.probe_dyn(t_idx, host, torch.as_tensor(values), bound_slot, torch.as_tensor(bound), 3)
        np.testing.assert_array_equal(np.asarray(j_rows), t_rows.numpy())
        np.testing.assert_array_equal(np.asarray(j_val), t_val.numpy())
        # probe is probe_dyn with the host row's own values
        p_rows, p_val = tev.probe(t_idx, values, bound_slot, torch.as_tensor(bound), 3)
        d_rows, d_val = tev.probe_dyn(t_idx, values, torch.as_tensor(values), bound_slot,
                                      torch.as_tensor(bound), 3)
        assert torch.equal(p_rows, d_rows) and torch.equal(p_val, d_val)
