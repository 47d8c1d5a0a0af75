"""repro_torch.core.distributed against repro.core.distributed (CPU, exact).

The port's mesh is one process: a ``DeviceMesh`` of logical CPU shards, one
thread a shard inside ``run_spmd``, collectives at a barrier; no process
group, no subprocess, no environment write.

* The host partitions (``partition_rows``, ``prepare_target_shards``) equal
  the reference's arrays and flags on its overflow case and on seeded rows
  at 1-4 shards, and so does ``shard_target_store``, the same partition of a
  store on its device.
* ``CohortPlacement`` gives the reference's literal sequences and agrees
  with the reference on a seeded sequence of assignments.
* The collectives: both branches of ``make_or_reduce`` on the reference's
  overlapping-words case, held to the plain words over every row, and
  ``all_to_all`` / ``all_gather`` by shard order.
* Routed probes at 1-4 shards, with a fanout below the bindings' true
  fanout, equal the port's unrouted ``probe`` and ``probe_dyn``.
* ``make_distributed_evaluator`` at 2 and 4 shards equals the reference's
  single-device ``make_side_evaluator`` on the paper's running example and
  on one seeded plan (the reference runs once for the module).
* A body that raises on one shard makes ``run_spmd`` raise, and no thread
  is left.
* ``CheckpointStore.restore`` places leaves on mesh devices and equals the
  reference's restore.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import evaluation as jev  # noqa: E402
from repro.core import interest as ji  # noqa: E402
from repro.core import triples as jt  # noqa: E402
from repro.core.dictionary import Dictionary as JDict  # noqa: E402
from repro_torch.checkpoint import CheckpointStore as TStore  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import evaluation as tev  # noqa: E402
from repro_torch.core import interest as ti  # noqa: E402
from repro_torch.core import triples as tt  # noqa: E402
from repro_torch.core.dictionary import Dictionary as TDict  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from test_torch_evaluation import PAPER, paper_data  # noqa: E402

PAD = tt.PAD
AXIS = "shard"


def overflow_rows():
    """The reference's overflow case: 8 rows, all even subjects."""
    return np.stack([np.arange(8, dtype=np.int32) * 2, np.ones(8, np.int32), np.arange(8, dtype=np.int32)], axis=1)


def seeded_rows(seed, n=60):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 23, size=(n, 3)).astype(np.int32)
    return np.unique(rows, axis=0)


def assert_partitions_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# host parts
# ---------------------------------------------------------------------------

def test_partition_overflow_case_equals_reference():
    rows = overflow_rows()
    for cap in (4, 8):
        assert_partitions_equal(tdist.partition_rows(rows, 2, 0, cap), jdist.partition_rows(rows, 2, 0, cap))
        assert_partitions_equal(tdist.prepare_target_shards(rows, 2, cap), jdist.prepare_target_shards(rows, 2, cap))
        store = tt.from_numpy(rows, 16, "cpu")
        got = tdist.shard_target_store(store, 2, cap)
        assert_partitions_equal([x.numpy() for x in got], jdist.prepare_target_shards(tt.to_numpy(store), 2, cap))
    shards, overflow = tdist.partition_rows(rows, 2, 0, 4)
    assert overflow.tolist() == [True, False]
    assert (shards[0, :, 0] != PAD).sum() == 4 and (shards[1, :, 0] == PAD).all()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_partitions_equal_reference(n_shards):
    rows = seeded_rows(n_shards)
    store = tt.from_numpy(rows, 128, "cpu")
    for cap in (8, 64):  # the first overflows some shard, the second none
        for key_col in (0, 2):
            assert_partitions_equal(
                tdist.partition_rows(rows, n_shards, key_col, cap), jdist.partition_rows(rows, n_shards, key_col, cap)
            )
        want = jdist.prepare_target_shards(rows, n_shards, cap)
        assert_partitions_equal(tdist.prepare_target_shards(rows, n_shards, cap), want)
        got = tdist.shard_target_store(store, n_shards, cap)
        assert_partitions_equal([x.numpy() for x in got], want)
        assert bool(want[2].any()) == (cap == 8)


@pytest.mark.parametrize("mod", [jdist, tdist], ids=["reference", "port"])
def test_cohort_placement_literal_sequences(mod):
    rr = mod.CohortPlacement()
    assert [rr.assign(f"c{i}", 4, 3) for i in range(5)] == [0, 1, 2, 0, 1]
    assert rr.assign("c0", 4, 3) == 0
    lb = mod.CohortPlacement(mode="load_balanced")
    assert [lb.assign(sig, size, 2) for sig, size in
            [("big", 16), ("s1", 2), ("s2", 2), ("s3", 16), ("s4", 2), ("s1", 8)]] == [0, 1, 1, 1, 0, 1]
    pin = mod.CohortPlacement(mode="pinned", pins={"a": 7}, default=1)
    assert (pin.assign("a", 4, 4), pin.assign("b", 4, 4)) == (3, 1)
    with pytest.raises(ValueError):
        mod.CohortPlacement(mode="nope")


@pytest.mark.parametrize("mode", ["round_robin", "load_balanced", "pinned"])
def test_cohort_placement_seeded_sequence_equals_reference(mode):
    rng = np.random.default_rng(7)
    pins = {f"c{i}": int(rng.integers(0, 9)) for i in range(0, 12, 2)}
    calls = [(f"c{int(rng.integers(0, 12))}", int(2 ** rng.integers(0, 6)), int(rng.integers(1, 5)))
             for _ in range(80)]
    placements = [mod.CohortPlacement(mode=mode, pins=dict(pins), default=2) for mod in (jdist, tdist)]
    want, got = ([p.assign(*c) for c in calls] for p in placements)
    assert got == want
    assert len(set(got)) > 1


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_mesh_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.DeviceMesh.on_card(4)
    mesh = tdist.DeviceMesh.on_cpu(3)
    assert mesh.size == 3 and mesh.axis_name == AXIS and mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        tdist.DeviceMesh(())


def test_or_reduce_both_branches_and_exchanges():
    """The reference's overlapping-words case: every row owned by two
    shards; the int32 words OR-fold and the boolean coverage both
    reassemble the whole, equal to the plain words over every row."""
    n = 4
    mesh = tdist.DeviceMesh.on_cpu(n)
    rng = np.random.default_rng(0)
    spo = torch.as_tensor(rng.integers(0, 40, (32, 3)).astype(np.int32))
    bank = torch.as_tensor(np.array([[-1, 7, -1], [5, -1, -1], [-1, -1, 3], [2, 9, -1]], np.int32))
    or_reduce = tdist.make_or_reduce(AXIS)

    def body(tag):
        my = tdist.axis_index(AXIS)
        idx = torch.arange(spo.shape[0])
        mine = (idx % n == my) | (idx % n == (my + 1) % n)
        words = or_reduce(kops.pattern_bitmask_words(torch.where(mine[:, None], spo, PAD), bank))
        covered = or_reduce(mine)
        sent = torch.arange(n, dtype=torch.int32) * 10 + my  # row j goes to shard j
        routed = tdist.route_rows_by_key(torch.where(mine[:, None], spo, PAD), AXIS, n)
        return (tag, words, covered, tdist.all_to_all(sent, AXIS), tdist.all_gather(torch.tensor([my]), AXIS),
                routed)

    want = kops.pattern_bitmask_words(spo, bank)
    assert int((want != 0).sum()) > 0
    for my, (tag, words, covered, got_a2a, gathered, routed) in enumerate(
            tdist.run_spmd(mesh, body, [f"t{i}" for i in range(n)])):
        assert tag == f"t{my}" and words.dtype == torch.int32
        assert torch.equal(words, want) and bool(covered.all())
        assert got_a2a.tolist() == [10 * my + src for src in range(n)]
        assert gathered.reshape(-1).tolist() == list(range(n))
        # every row whose subject this shard owns, once from each of its two holders
        held = routed[routed[:, 0] != PAD]
        owned = spo[spo[:, 0] % n == my]
        assert routed.shape == (n * spo.shape[0], 3) and held.shape[0] == 2 * owned.shape[0]
        assert sorted(map(tuple, held.tolist())) == sorted(map(tuple, owned.tolist() * 2))
    with pytest.raises(RuntimeError, match="inside run_spmd"):
        or_reduce(want)


def test_run_spmd_failure_raises_and_leaves_no_thread():
    mesh = tdist.DeviceMesh.on_cpu(4)
    before = threading.active_count()

    def body(my):
        if my == 2:
            raise KeyError("shard 2 fails")
        return tdist.all_gather(torch.tensor([my]), AXIS)

    with pytest.raises(KeyError, match="shard 2 fails"):
        tdist.run_spmd(mesh, body, range(4))
    assert threading.active_count() == before

    def mismatched(my):  # shards that call different collectives fail
        x = torch.zeros(4, dtype=torch.int32)
        return tdist.all_gather(x, AXIS) if my else tdist.all_to_all(x, AXIS)

    with pytest.raises(RuntimeError, match="different collectives"):
        tdist.run_spmd(mesh, mismatched, range(4))
    assert threading.active_count() == before
    assert tdist.run_spmd(mesh, lambda my: my * 2, range(4)) == [0, 2, 4, 6]


@pytest.mark.parametrize("extra", [0, 3])
def test_run_spmd_one_shard_calling_more_collectives_raises(extra):
    """One shard makes one all_gather more than the others, which return:
    the group breaks, whether the extra call comes from the first shard
    (the others return while it waits) or the last (the others have
    returned when it deposits), and no shard reads a stale slot."""
    mesh = tdist.DeviceMesh.on_cpu(4)
    before = threading.active_count()

    def body(my):
        first = tdist.all_gather(torch.tensor([my]), AXIS)
        second = tdist.all_gather(torch.tensor([my + 10]), AXIS)
        if my == extra:
            return tdist.all_gather(torch.tensor([my + 20]), AXIS)
        return first, second

    with pytest.raises(RuntimeError, match="different collectives"):
        tdist.run_spmd(mesh, body, range(4))
    assert threading.active_count() == before


def test_collectives_under_thread_switching_stress():
    """More shards than cores, the interpreter switching threads as often as
    it can: every shard's every collective sees every other shard's part of
    that same collective, and the traffic counter loses no update."""
    import sys

    n, rounds = 16, 40
    mesh = tdist.DeviceMesh.on_cpu(n)
    before = dict(tdist.traffic)

    def body(my):
        seen = []
        for r in range(rounds):
            got = tdist.all_gather(torch.tensor([my * 1000 + r]), AXIS)
            seen.append(got.reshape(-1).tolist() == [k * 1000 + r for k in range(n)])
            parts = [torch.full((k % 3,), my * 100 + k, dtype=torch.int32) for k in range(n)]
            back = tdist.all_to_all_ragged(parts, AXIS)
            seen.append(all(b.tolist() == [src * 100 + my] * (my % 3) for src, b in enumerate(back)))
        return all(seen)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert tdist.run_spmd(mesh, body, range(n)) == [True] * n
    finally:
        sys.setswitchinterval(old)
    assert tdist.traffic["collectives"] - before["collectives"] == 2 * rounds


# ---------------------------------------------------------------------------
# routed probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_routed_probes_equal_unrouted(n_shards):
    """Each shard asks its own bindings (PAD, absent and heavy ones among
    them) through the routed hooks; every answer, the fanout truncation
    included, equals the unrouted probe of the whole index."""
    rng = np.random.default_rng(10 + n_shards)
    rows = np.unique(np.concatenate([
        rng.integers(0, 9, size=(120, 3)),
        np.stack([np.full(12, 3), rng.integers(0, 3, 12), rng.integers(0, 30, 12)], axis=1),  # subject 3: heavy
    ]).astype(np.int32), axis=0)
    tau = tt.from_numpy(rows, 256, "cpu")
    full = tev.build_index(tau)
    spo, ops, ovf = tdist.shard_target_store(tau, n_shards, 256)
    assert not bool(ovf.any())
    bound = [torch.as_tensor(rng.integers(0, 11, size=17).astype(np.int32)) for _ in range(n_shards)]
    for b in bound:
        b[::4] = PAD
    cases = [(pat, slot, k) for pat in ([-1, 1, -1], [-1, 2, 4], [-1, -1, -1], [3, 0, -1]) for slot in (0, 2)
             for k in (2, 8) if pat[slot] < 0]
    static = tdist.make_routed_probe(AXIS, n_shards)
    dynamic = tdist.make_routed_probe_batched(AXIS, n_shards)

    def body(s_rows, o_rows, b):
        idx = tev.TripleIndex(spo=tt.TripleStore(spo=s_rows, n=(s_rows[:, 0] != PAD).sum(dtype=torch.int32)),
                              ops=tt.TripleStore(spo=o_rows, n=(o_rows[:, 0] != PAD).sum(dtype=torch.int32)))
        out = []
        for pat, slot, k in cases:
            p = np.asarray(pat, np.int32)
            out.append(static(idx, p, slot, b, k))
            out.append(dynamic(idx, p, torch.as_tensor(p), slot, b, k))
        return out

    per_shard = tdist.run_spmd(tdist.DeviceMesh.on_cpu(n_shards), body, list(spo), list(ops), bound)
    truncated = 0
    for my, got in enumerate(per_shard):
        for c, (pat, slot, k) in enumerate(cases):
            p = np.asarray(pat, np.int32)
            for want in (tev.probe(full, p, slot, bound[my], k),
                         tev.probe_dyn(full, p, torch.as_tensor(p), slot, bound[my], k)):
                for rows_got, val_got in got[2 * c: 2 * c + 2]:
                    assert torch.equal(val_got, want[1]), (my, pat, slot, k)
                    assert torch.equal(torch.where(val_got[..., None], rows_got, PAD),
                                       torch.where(want[1][..., None], want[0], PAD)), (my, pat, slot, k)
            truncated += int(want[1].all(dim=1).sum()) if k == 2 else 0
    assert truncated > 0  # some bindings hold more rows than the fanout


# ---------------------------------------------------------------------------
# the distributed evaluator against the reference's single-device one
# ---------------------------------------------------------------------------

M_CAP, T_CAP, K = 32, 64, 8
SEEDED_TERMS = [f"s{i}" for i in range(12)] + ["type", "p0", "p1", "goals", "label", "Athlete"] + [f"o{i}" for i in
                                                                                                   range(8)]
SEEDED = ([("?f", "type", "Athlete"), ("?f", "p1", "?t"), ("?t", "label", "?n")], [])


def evaluator_cases():
    """(name, terms, expr, [(m_rows, tau_rows)]): the paper's example (its
    removed and added sides against its τ) and a seeded plan over random
    rows, as the reference's distributed test draws them."""
    d, tau, removed, added = paper_data()
    cases = [("paper", [d.decode(i) for i in range(len(d))], PAPER, [(removed, tau), (added, tau)])]
    d = JDict()
    for t in SEEDED_TERMS:
        d.encode_term(t)
    subj = [d.lookup(f"s{i}") for i in range(12)]
    pred = [d.lookup(x) for x in ("type", "p0", "p1", "goals", "label")]
    obj = [d.lookup(x) for x in ("Athlete", "o0", "o1")] + subj[:6]
    rng = np.random.default_rng(0)

    def rand_rows(n):
        return np.unique(np.stack([rng.choice(subj, n), rng.choice(pred, n), rng.choice(obj, n)],
                                  axis=1).astype(np.int32), axis=0)

    cases.append(("seeded", SEEDED_TERMS, SEEDED,
                  [(rand_rows(int(rng.integers(4, 24))), rand_rows(int(rng.integers(8, 40)))) for _ in range(4)]))
    return cases


@pytest.fixture(scope="module")
def evaluator_reference():
    out = {}
    for name, terms, expr, pairs in evaluator_cases():
        d = JDict()
        for t in terms:
            d.encode_term(t)
        plan = ji.compile_interest(ji.InterestExpr.parse("g", "t", *expr), d)
        ev = jax.jit(jev.make_side_evaluator(plan, id_capacity=d.id_capacity, fanout=K, out_capacity=4 * M_CAP,
                                             pull_capacity=4096))
        res = []
        for m_rows, tau_rows in pairs:
            r = ev(jt.from_numpy(m_rows, 4 * M_CAP), jev.build_index(jt.from_numpy(tau_rows, T_CAP)))
            res.append((jt.to_set(r.interesting), jt.to_set(r.potential), jt.to_set(r.pulls), bool(r.overflow)))
        out[name] = res
    return out


@pytest.mark.parametrize("n_shards", [2, 4])
def test_distributed_evaluator_equals_reference(evaluator_reference, n_shards):
    mesh = tdist.DeviceMesh.on_cpu(n_shards)
    n_nonempty = 0
    for name, terms, expr, pairs in evaluator_cases():
        d = TDict.from_terms(terms)
        plan = ti.compile_interest(ti.InterestExpr.parse("g", "t", *expr), d)
        ev = tdist.make_distributed_evaluator(plan, mesh, id_capacity=d.id_capacity, fanout=K,
                                              out_capacity=4 * M_CAP, pull_capacity=4096)
        for (m_rows, tau_rows), want in zip(pairs, evaluator_reference[name]):
            m_sh, m_ovf = tdist.partition_rows(m_rows, n_shards, key_col=0, cap=M_CAP)
            spo_sh, ops_sh, t_ovf = tdist.prepare_target_shards(tau_rows, n_shards, T_CAP)
            assert not m_ovf.any() and not t_ovf.any()
            res = ev(torch.as_tensor(m_sh), torch.as_tensor(spo_sh), torch.as_tensor(ops_sh))
            assert res.interesting.spo.shape[0] == n_shards
            got = tdist.gather_result_sets(res, partition_overflow=m_ovf | t_ovf)
            assert got == want, (name, n_shards)
            n_nonempty += bool(want[0]) + bool(want[2])
    assert n_nonempty >= 4


# ---------------------------------------------------------------------------
# checkpoint restore onto mesh devices
# ---------------------------------------------------------------------------

def test_restore_places_leaves_and_equals_reference(tmp_path):
    rng = np.random.default_rng(3)
    state = {"tables": {"10": rng.integers(0, 9, (4, 3)).astype(np.int32), "2": rng.random(5).astype(np.float32)},
             "rows": [rng.integers(0, 5, (2, 3)).astype(np.int32), np.arange(3, dtype=np.int64)]}
    TStore(tmp_path).save(5, state, {"seq": 5})
    template = {"tables": {"10": np.zeros((4, 3), np.int64), "2": torch.zeros(5)},
                "rows": [np.zeros((2, 3), np.int32), np.zeros(3, np.int64)]}
    want, step = JStore(tmp_path).restore({"tables": {"10": np.zeros((4, 3), np.int64), "2": np.zeros(5, np.float32)},
                                           "rows": template["rows"]})
    mesh = tdist.DeviceMesh.on_cpu(2)
    got, got_step = TStore(tmp_path).restore(template, shardings={"tables": {"10": mesh.devices[0], "2": None},
                                                                  "rows": mesh.devices[1]})
    assert got_step == step == 5
    assert isinstance(got["tables"]["10"], torch.Tensor) and got["tables"]["10"].dtype == torch.int64
    assert isinstance(got["tables"]["2"], np.ndarray) and got["tables"]["2"].dtype == np.float32
    assert all(isinstance(x, torch.Tensor) for x in got["rows"])
    for g, w in ((got["tables"]["10"], want["tables"]["10"]), (got["tables"]["2"], want["tables"]["2"]),
                 (got["rows"][0], want["rows"][0]), (got["rows"][1], want["rows"][1])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    plain, _ = TStore(tmp_path).restore(template)
    assert isinstance(plain["rows"][0], np.ndarray)
