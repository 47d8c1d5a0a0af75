"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc; on a machine without a card
they skip. Run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as tcore  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    lane_refine,
    merge_join,
    ref,
    triple_match,
    triple_match_lanes,
    triple_match_words,
    triple_match_words_segmented,
)

PAD = int(np.iinfo(np.int32).max)
A = "rdf:type"


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def k1_inputs(n, n_pat, vocab, seed):
    rng = np.random.default_rng(seed)
    spo = rng.integers(0, vocab, size=(n, 3)).astype(np.int32)
    spo[rng.random(n) < 0.1] = PAD
    pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
    if n_pat:
        pats[-1] = -1  # wildcard-only: the top bit set on every valid row
    return spo, pats


@pytest.mark.parametrize("n,n_pat", [(1, 1), (4095, 3), (4097, 32), (100_003, 6), (5, 0)])
def test_triple_match_kernel_equals_plain(card, n, n_pat):
    spo, pats = k1_inputs(n, n_pat, 9, n)
    got = triple_match.triple_match_cuda(torch.as_tensor(spo, device=card), torch.as_tensor(pats, device=card))
    want = ref.pattern_bitmask_ref(torch.as_tensor(spo), torch.as_tensor(pats))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# N % 4 of 1, 2 and 3 (the scalar tail), bases offset by 1, 2 and 3 rows (the
# scalar head, unaligned output stores), P of 0, 1 and 32, all-PAD rows
@pytest.mark.parametrize("n,n_pat,offset,all_pad", [(4097, 1, 0, False), (4098, 32, 1, False), (4099, 0, 0, False),
                                                    (1026, 32, 2, False), (100_001, 6, 3, False),
                                                    (4096, 5, 0, True), (3, 32, 1, False), (2, 1, 2, False)])
def test_triple_match_row_stream_edges_equal_plain(card, n, n_pat, offset, all_pad):
    spo, pats = k1_inputs(n + offset, n_pat, 5, n + offset + n_pat)
    if all_pad:
        spo[:] = PAD
    t_spo = torch.as_tensor(spo, device=card)[offset:]  # contiguous, its base offset by whole rows
    got = triple_match.triple_match_cuda(t_spo, torch.as_tensor(pats, device=card))
    want = ref.pattern_bitmask_ref(torch.as_tensor(spo[offset:]), torch.as_tensor(pats))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("s_rows,q_rows,vocab", [(1, 7, 3), (3000, 5000, 30), (70_000, 20_000, 60)])
def test_merge_probe_kernel_equals_plain(card, side, s_rows, q_rows, vocab):
    rng = np.random.default_rng(s_rows)
    rows = np.unique(rng.integers(0, vocab, size=(s_rows, 3)).astype(np.int32), axis=0)
    store = np.full((max(1, 2 * rows.shape[0]), 3), PAD, np.int32)
    store[: rows.shape[0]] = rows
    queries = np.concatenate([
        rows[rng.integers(0, rows.shape[0], q_rows // 2)],
        rng.integers(0, vocab + 2, size=(q_rows - q_rows // 2, 3)).astype(np.int32),
        np.full((3, 3), PAD, np.int32),
    ])
    idx, found = merge_join.merge_probe_cuda(
        torch.as_tensor(store, device=card), torch.as_tensor(queries, device=card), side
    )
    if side == "left":
        w_idx, w_found = ref.merge_probe_ref(torch.as_tensor(store), torch.as_tensor(queries))
        np.testing.assert_array_equal(found.cpu().numpy(), w_found.numpy())
    else:
        w_idx = ref.merge_probe_right_ref(torch.as_tensor(store), torch.as_tensor(queries))
        assert found is None
    np.testing.assert_array_equal(idx.cpu().numpy(), w_idx.numpy())


def k2_path_case(name, rng):
    """(store, lo queries, hi queries, the tile paths the left side takes)
    for one of the kernel's tile paths; hi queries are the lo ones with PAD
    in the columns past a prefix depth, as prefix_range builds them."""
    tile, w_max = merge_join.TILE, merge_join.WINDOW_ROWS
    n = 20_000
    rows = np.stack([np.arange(n) // 100, np.arange(n) % 100, np.zeros(n, int)], 1).astype(np.int32)
    store = np.full((n + 4096, 3), PAD, np.int32)
    store[:n] = rows
    paths = {"window"}
    if name == "sorted":  # a PAD tail, Q not a multiple of the tile
        q = np.sort(rng.integers(0, 3000, 3 * tile + 77))
        q = np.concatenate([store[q], np.full((tile + 5, 3), PAD, np.int32)])
        paths = {"window", "oversized"}  # the tile across the PAD boundary spans the store's rest
    elif name == "all_equal":
        q = np.repeat(store[n + 7: n + 8], 2 * tile + 3, axis=0)
    elif name.startswith("window_"):  # the rows [left(first), left(last)] and one more
        w = w_max + int(name.split("_")[1])
        q = store[np.sort(np.concatenate([[5000, 5000 + w - 1], rng.integers(5000, 5000 + w, tile - 2)]))]
        paths = {"window" if w <= w_max else "oversized"}
    elif name == "oversized":
        q = store[np.sort(rng.integers(0, n, 4 * tile))]
        q[::3, 2] = 1  # absent rows
        q = q[np.lexsort((q[:, 2], q[:, 1], q[:, 0]))]
        paths = {"oversized"}
    elif name == "unsorted":
        q = rng.integers(-2, 210, size=(3 * tile + 9, 3)).astype(np.int32)
        q[::11] = PAD
        paths = {"unsorted"}
    elif name == "mixed":  # sorted tiles with a shuffled one between them
        q = store[np.sort(rng.integers(0, 1500, 3 * tile))]
        q[tile: 2 * tile] = q[tile: 2 * tile][rng.permutation(tile)]
        paths = {"window", "unsorted"}
    elif name == "int32_min":  # a subject prefix: the window holds the subjects' rows
        q = store[np.sort(rng.integers(0, 1500, 2 * tile))]
        q[:, 1:] = np.iinfo(np.int32).min
    elif name == "s0":
        store, q = store[:0], rng.integers(0, 5, size=(9, 3)).astype(np.int32)
        paths = {"unsorted"}
    elif name == "s1":
        store, q = store[:1], np.concatenate([store[:1], rng.integers(-1, 3, size=(9, 3)).astype(np.int32)])
        paths = {"unsorted"}
    else:
        raise KeyError(name)
    depth = rng.integers(1, 4, q.shape[0])[:, None] if name == "unsorted" else 3 - (name == "int32_min") * 2
    hi = np.where(np.arange(3)[None, :] < depth, q, PAD).astype(np.int32)
    return store, q.astype(np.int32), hi, paths


K2_PATH_CASES = ["sorted", "all_equal", "window_-1", "window_0", "window_1", "oversized", "unsorted", "mixed",
                 "int32_min", "s0", "s1"]


@pytest.mark.parametrize("side", ["left", "right", "range"])
@pytest.mark.parametrize("name", K2_PATH_CASES)
def test_merge_probe_tile_paths_equal_plain(card, name, side):
    store, lo, hi, paths = k2_path_case(name, np.random.default_rng(len(name)))
    t_store, t_lo, t_hi = (torch.as_tensor(a) for a in (store, lo, hi))
    counts = torch.zeros(3, dtype=torch.int32, device=card)
    if side == "range":
        start, end = merge_join.merge_probe_range_cuda(t_store.to(card), t_lo.to(card), t_hi.to(card),
                                                       tile_counts=counts)
        w_start, w_end = ref.merge_probe_range_ref(t_store, t_lo, t_hi)
        np.testing.assert_array_equal(start.cpu().numpy(), w_start.numpy())
        np.testing.assert_array_equal(end.cpu().numpy(), w_end.numpy())
    else:
        idx, found = merge_join.merge_probe_cuda(t_store.to(card), t_lo.to(card), side, tile_counts=counts)
        if side == "left":
            w_idx, w_found = ref.merge_probe_ref(t_store, t_lo)
            np.testing.assert_array_equal(found.cpu().numpy(), w_found.numpy())
        else:
            w_idx = ref.merge_probe_right_ref(t_store, t_lo)
        np.testing.assert_array_equal(idx.cpu().numpy(), w_idx.numpy())
    counts = counts.cpu().tolist()
    assert sum(counts) == -(-lo.shape[0] // merge_join.TILE)
    if side == "left":
        assert {p for p, c in zip(merge_join.TILE_PATHS, counts) if c} == paths, counts


def test_merge_probe_refuses_rows_that_are_not_contiguous(card):
    store = torch.zeros((8, 3), dtype=torch.int32, device=card)
    wide = torch.zeros((8, 6), dtype=torch.int32, device=card)
    for bad in (store[::2], wide[:, :3]):
        with pytest.raises(ValueError):
            merge_join.merge_probe_cuda(store, bad)
        with pytest.raises(ValueError):
            merge_join.merge_probe_range_cuda(bad, store, store)


def test_prefix_range_on_the_card_is_one_launch(card):
    store, lo, _, _ = k2_path_case("sorted", np.random.default_rng(3))
    st = tcore.TripleStore(spo=torch.as_tensor(store, device=card), n=torch.tensor(20_000, device=card))
    depth = torch.full((lo.shape[0],), 2, dtype=torch.int32, device=card)
    kernels.reset_launch_counts()
    start, end = tcore.prefix_range(st, torch.as_tensor(lo, device=card), depth)
    assert kernels.launch_counts()["merge_probe"] == 1
    cpu = tcore.TripleStore(spo=torch.as_tensor(store), n=torch.tensor(20_000))
    w_start, w_end = tcore.prefix_range(cpu, torch.as_tensor(lo), depth.cpu())
    np.testing.assert_array_equal(start.cpu().numpy(), w_start.numpy())
    np.testing.assert_array_equal(end.cpu().numpy(), w_end.numpy())


@pytest.mark.parametrize("n,n_pat,dead", [(1, 7, ()), (4095, 32, (3,)), (4097, 45, (0, 40)),
                                           (100_003, 160, (31, 63, 100)), (4097, 64, tuple(range(32, 63))),
                                           (9, 0, ())])
def test_triple_match_words_kernel_equals_plain(card, n, n_pat, dead):
    spo, pats = k1_inputs(n, n_pat, 6, n + n_pat)
    pats = pats.reshape(-1, 3)
    pats[list(dead)] = PAD  # tombstoned and padding bank rows
    got = triple_match_words.triple_match_words_cuda(torch.as_tensor(spo, device=card),
                                                     torch.as_tensor(pats, device=card))
    want = ref.pattern_bitmask_words_ref(torch.as_tensor(spo), torch.as_tensor(pats))
    assert tuple(got.shape) == (n, max(1, -(-n_pat // 32)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("r,n,n_pat,nt,inactive", [(2, 1, 32, 1, ()), (3, 4095, 64, 32, (1,)),
                                                   (4, 4097, 160, 6, (0, 3)), (5, 100_003, 64, 3, (2, 4)),
                                                   (2, 17, 32, 4, (0, 1))])
def test_triple_match_lanes_kernel_equals_plain(card, r, n, n_pat, nt, inactive):
    rng = np.random.default_rng(r * n)
    spo_b = rng.integers(0, 4, size=(r, n, 3)).astype(np.int32)
    spo_b[rng.random((r, n)) < 0.1] = PAD
    pats = rng.integers(-1, 4, size=(n_pat, 3)).astype(np.int32)
    pats[-1] = -1
    pats[n_pat // 2] = PAD
    lanes = rng.integers(0, n_pat, size=(r, nt)).astype(np.int32)
    lanes[:, -1] = n_pat - 1  # a lane in the last word
    active = np.ones(r, bool)
    active[list(inactive)] = False
    args = [torch.as_tensor(x) for x in (spo_b, pats, lanes, active)]
    got = triple_match_lanes.triple_match_lanes_cuda(*(a.to(card) for a in args))
    want = ref.pattern_lane_bits_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("n,n_pat,dead,n_seg,bits", [(1, 7, (), 1, 2), (4095, 33, (0,), 2, 5), (4097, 32, (), 3, 3),
                                                    (100_003, 160, (31, 100), 32, 32),
                                                    (4097, 64, tuple(range(32, 64)), 2, 2), (9, 0, (), 3, 3)])
def test_triple_match_words_segmented_kernel_equals_plain(card, n, n_pat, dead, n_seg, bits):
    spo, pats = k1_inputs(n, n_pat, 5, n + n_pat)
    pats = pats.reshape(-1, 3)
    pats[list(dead)] = PAD
    rng = np.random.default_rng(n_seg)
    seg = rng.integers(-(1 << 31), (1 << 31) - 1, size=n).astype(np.int32)
    if bits < 32:
        seg &= (1 << bits) - 1  # bits above n_seg are ignored
    args = [torch.as_tensor(x) for x in (spo, pats, seg)]
    got = triple_match_words_segmented.triple_match_words_segmented_cuda(*(a.to(card) for a in args), n_seg)
    want = ref.pattern_bitmask_words_segmented_ref(*args, n_seg)
    assert tuple(got.shape) == (n_seg, n, max(1, -(-n_pat // 32)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def bank_case(rng, n, n_pat, kind):
    """Rows and a bank for the bank-words kernels' slot-mask paths. ``kind``:
    "shared" (every slot's p is one constant), "distinct" (wildcards but for
    distinct o-constants from a vocabulary of 10^6: more than one table of
    128 slots holds once P > 128), "wild" (every third slot wildcard-only),
    "pad" (every fourth slot all-PAD, the next one PAD at one position) or
    "mixed" (random terms); half of the rows carry some slot's constants, so
    that rows PAD at p or o meet the slots PAD there, and a tenth are PAD."""
    vocab = 10 ** 6 if kind == "distinct" else 6
    pats = rng.integers(-1, vocab, size=(n_pat, 3)).astype(np.int32)
    if kind == "shared":
        pats[:, 1] = 3
    elif kind == "distinct":
        pats[:, :2] = -1
        pats[:, 2] = rng.choice(vocab, size=n_pat, replace=False)
    elif kind == "wild":
        pats[::3] = -1
    elif kind == "pad":
        pats[::4] = PAD
        for j in range(1, n_pat, 4):
            pats[j, rng.integers(0, 3)] = PAD
    spo = rng.integers(0, vocab, size=(n, 3)).astype(np.int32)
    if n_pat:
        hit = rng.random(n) < 0.5
        src = pats[rng.integers(0, n_pat, size=int(hit.sum()))]
        spo[hit] = np.where(src == -1, spo[hit], src)
    spo[rng.random(n) < 0.1] = PAD
    return spo, pats


# (n, P, base offset in rows, bank kind, all-PAD rows): W = 1, 2, 5 and 10;
# 320 distinct constants at one position (three chunks of tables); bases
# offset by 1-3 rows and N % 4 of 1-3 (the scalar head and tail, unaligned
# stores); N below one group of 4 rows; an all-PAD row set
BANK_CASES = [(4097, 32, 0, "shared", False), (4098, 64, 1, "wild", False), (4099, 160, 2, "pad", False),
              (20_001, 320, 3, "distinct", False), (3, 7, 1, "mixed", False), (4096, 45, 0, "mixed", True),
              (2, 1, 2, "wild", False), (100_003, 9, 0, "pad", False), (1001, 300, 1, "shared", False)]


@pytest.mark.parametrize("n,n_pat,offset,kind,all_pad", BANK_CASES)
def test_triple_match_words_slot_masks_equal_plain(card, n, n_pat, offset, kind, all_pad):
    spo, pats = bank_case(np.random.default_rng(n + n_pat), n + offset, n_pat, kind)
    if all_pad:
        spo[:] = PAD
    t_spo = torch.as_tensor(spo, device=card)[offset:]  # contiguous, its base offset by whole rows
    got = triple_match_words.triple_match_words_cuda(t_spo, torch.as_tensor(pats, device=card))
    want = ref.pattern_bitmask_words_ref(torch.as_tensor(spo[offset:]), torch.as_tensor(pats))
    assert tuple(got.shape) == (n, max(1, -(-n_pat // 32)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# BANK_CASES with (n_seg, seg bits drawn): 1, 2, 3 and 32 segments, bits above
# n_seg, a fifth of the rows in no segment, seg's base offset otherwise than
# the rows' (its scalar loads)
SEG_BANK_CASES = [case + seg for case, seg in zip(BANK_CASES, [(1, 3), (2, 2), (32, 32), (2, 5), (32, 30), (3, 3),
                                                               (1, 1), (2, 2), (3, 32)])]


@pytest.mark.parametrize("n,n_pat,offset,kind,all_pad,n_seg,bits", SEG_BANK_CASES)
def test_triple_match_words_segmented_slot_masks_equal_plain(card, n, n_pat, offset, kind, all_pad, n_seg, bits):
    rng = np.random.default_rng(n + n_pat + n_seg)
    spo, pats = bank_case(rng, n + offset, n_pat, kind)
    if all_pad:
        spo[:] = PAD
    seg = rng.integers(-(1 << 31), (1 << 31) - 1, size=n + 4).astype(np.int32)
    if bits < 32:
        seg &= (1 << bits) - 1  # bits above n_seg are ignored
    seg[rng.random(n + 4) < 0.2] = 0
    seg_offset = (offset + 1) % 4
    args = [torch.as_tensor(spo[offset:]), torch.as_tensor(pats), torch.as_tensor(seg[seg_offset:seg_offset + n])]
    dev = [torch.as_tensor(spo, device=card)[offset:], args[1].to(card),
           torch.as_tensor(seg, device=card)[seg_offset:seg_offset + n]]
    got = triple_match_words_segmented.triple_match_words_segmented_cuda(*dev, n_seg)
    want = ref.pattern_bitmask_words_segmented_ref(*args, n_seg)
    assert tuple(got.shape) == (n_seg, n, max(1, -(-n_pat // 32)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("n,n_pat,vp,n_virt,planes,shared", [(1, 7, 1, 1, 1, True), (4097, 64, 31, 20, 2, True),
                                                             (4095, 64, 32, 32, 3, False),
                                                             (100_003, 160, 33, 9, 2, True),
                                                             (4097, 32, 64, 40, 4, False), (17, 40, 64, 0, 1, True),
                                                             (4097, 300, 64, 30, 2, True)])
def test_lane_refine_kernel_equals_plain(card, n, n_pat, vp, n_virt, planes, shared):
    rng = np.random.default_rng(n + vp)
    spo = rng.integers(0, 5, size=(n, 3) if shared else (planes, n, 3)).astype(np.int32)
    spo[rng.random(spo.shape[:-1]) < 0.1] = PAD
    pats = rng.integers(-1, 5, size=(n_pat, 3)).astype(np.int32)
    pats[-1] = -1
    t_spo, t_pats = torch.as_tensor(spo), torch.as_tensor(pats)
    words = torch.stack([ref.pattern_bitmask_words_ref(t_spo if shared else t_spo[f], t_pats) for f in range(planes)])
    parents = np.full(vp, -1, np.int32)
    residual = np.full((vp, 3), PAD, np.int32)
    for i, v in enumerate(rng.choice(vp, size=n_virt, replace=False)):
        par = (0, n_pat - 1)[i] if i < 2 else int(rng.integers(0, n_pat))  # first and last word
        parents[v] = par
        residual[v] = [rng.integers(0, 5) if pats[par, k] == -1 and rng.random() < 0.7 else -1 for k in range(3)]
    args = [t_spo, words if planes > 1 else words[0], torch.as_tensor(parents), torch.as_tensor(residual)]
    if planes == 1 and not shared:
        args[0] = t_spo[0]
    got = lane_refine.lane_refine_cuda(*(a.to(card) for a in args))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.lane_refine_ref(*args).numpy())


def refine_case(rng, n, w, vp, planes, shared, n_const, vocab, positions=(0, 1, 2)):
    """Random lane_refine inputs: int32[F, N, W] real words of random bits
    (a fifth of the rows zeroed), a fifth of the slots dead (parents -1, -5,
    32 W and beyond), ``n_const`` residual constants a slot at ``positions``
    (random 0-3 when None), and half of the rows carrying some slot's
    constants so that the compares hit."""
    spo = rng.integers(0, vocab, size=((n,) if shared else (planes, n)) + (3,)).astype(np.int32)
    parents = rng.integers(0, 32 * w, size=vp).astype(np.int32)
    dead = rng.random(vp) < 0.2
    parents[dead] = rng.choice(np.array([-1, -5, 32 * w, 32 * w + 7], np.int32), size=int(dead.sum()))
    residual = np.full((vp, 3), -1, np.int32)
    for v in range(vp):
        c = int(rng.integers(0, len(positions) + 1)) if n_const is None else n_const
        residual[v, rng.choice(positions, size=c, replace=False)] = rng.integers(0, vocab, size=c)
    flat = spo.reshape(-1, 3)
    if vp:
        hit = rng.random(flat.shape[0]) < 0.5
        src = residual[rng.integers(0, vp, size=int(hit.sum()))]
        flat[hit] = np.where(src == -1, flat[hit], src)
    flat[rng.random(flat.shape[0]) < 0.1] = PAD
    words = rng.integers(-(1 << 31), 1 << 31, size=(planes, n, w), dtype=np.int64).astype(np.int32)
    words[rng.random((planes, n)) < 0.2] = 0
    return spo, words, parents, residual


# (n, W, Vp, planes, shared rows, constants a slot, vocabulary, residual positions):
# two and three constants; 600 distinct o-constants from a vocabulary of 10^6
# (more than one table holds); Vp of 129-256, several chunks of output words
# (vector and scalar stores); W = 10; F = 1, 2 and 32, shared and per-plane
# rows; N below one block; Vp = 0
REFINE_CASES = [(4097, 1, 64, 2, True, 2, 5, (0, 1, 2)), (4097, 2, 64, 2, False, 3, 5, (0, 1, 2)),
                (20_000, 10, 600, 2, True, 1, 10 ** 6, (2,)), (4097, 3, 200, 3, True, None, 7, (0, 1, 2)),
                (4097, 2, 256, 2, False, None, 4, (0, 1, 2)), (4097, 2, 192, 2, True, 2, 4, (0, 1, 2)),
                (4097, 10, 40, 2, False, None, 5, (0, 1, 2)), (1000, 1, 33, 32, True, None, 5, (0, 1, 2)),
                (1000, 1, 33, 32, False, None, 5, (0, 1, 2)), (100, 2, 31, 1, False, None, 5, (0, 1, 2)),
                (100, 2, 31, 1, True, None, 5, (0, 1, 2)), (17, 1, 0, 2, True, None, 5, (0, 1, 2))]


@pytest.mark.parametrize("n,w,vp,planes,shared,n_const,vocab,positions", REFINE_CASES)
def test_lane_refine_slot_masks_equal_plain(card, n, w, vp, planes, shared, n_const, vocab, positions):
    rng = np.random.default_rng(n * 7 + vp)
    args = [torch.as_tensor(x) for x in refine_case(rng, n, w, vp, planes, shared, n_const, vocab, positions)]
    got = lane_refine.lane_refine_cuda(*(a.to(card) for a in args))
    assert tuple(got.shape) == (planes, n, max(1, -(-vp // 32)))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.lane_refine_ref(*args).numpy())


def lanes_case(rng, r, n, n_pat, nt, offset, inactive, kind):
    """A cohort for the lanes kernel's row stream: rows int32[offset + r n, 3]
    (the cohort is ``rows[offset:]`` seen as [r, n, 3]), a bank with
    all-wildcard rows and all-PAD rows (tombstones, padding), lanes and a
    member mask. Half of the rows carry a routed bank row's constants and a
    tenth are PAD. ``kind``: "random" rows; "sorted" (each member's rows a
    lex-sorted set with a PAD tail, as the broker stacks its stores; member 0
    all PAD); "lanes_out" (a third of the lanes below 0, or at and past
    n_pat, where they match nothing)."""
    pats = rng.integers(-1, 6, size=(n_pat, 3)).astype(np.int32)
    pats[::5] = -1
    pats[1::7] = PAD
    lanes = rng.integers(0, n_pat, size=(r, nt)).astype(np.int32)
    if kind == "lanes_out":
        out = rng.random((r, nt)) < 1 / 3
        far = np.array([-(1 << 31), -33, -1, n_pat, n_pat + 1, 32 * -(-n_pat // 32), 1 << 30], np.int32)
        lanes[out] = rng.choice(far, size=int(out.sum()))
    spo = rng.integers(0, 1000, size=(r, n, 3)).astype(np.int32)
    if n_pat and nt:
        hit = rng.random((r, n)) < 0.5
        src = pats[np.clip(lanes[np.nonzero(hit)[0], rng.integers(0, nt, size=int(hit.sum()))], 0, n_pat - 1)]
        spo[hit] = np.where(src == -1, spo[hit], src)
    spo[rng.random((r, n)) < 0.1] = PAD
    if kind == "sorted":
        for k in range(r):
            rows = np.unique(spo[k][(spo[k] != PAD).all(axis=1)], axis=0)
            n_valid = 0 if k == 0 else int(rng.integers(rows.shape[0] // 2, rows.shape[0] + 1))
            spo[k, :n_valid] = rows[:n_valid]
            spo[k, n_valid:] = PAD
    rows = np.concatenate([rng.integers(0, 1000, size=(offset, 3)).astype(np.int32), spo.reshape(-1, 3)])
    active = np.ones(r, bool)
    active[list(inactive)] = False
    return rows, pats, lanes, active


# The lanes kernel's row-stream paths, (members, rows, bank rows, nt, base
# offset in rows, inactive members, kind): N % 4 of 1, 2 and 3 (each member
# its own alignment: scalar heads and tails, unaligned stores); N < 4 (scalar
# rows only); bases offset by a row, and a cohort sliced along R (spo_b[1:]
# of one more member); nt = 0 and 32; lanes outside the bank; every member
# inactive; more members than the grid holds blocks, in six staging chunks;
# R nt = 1,280 (two chunks of routed rows)
LANES_EDGE_CASES = [(5, 4097, 64, 3, 0, (1,), "sorted"), (4, 4098, 32, 6, 0, (), "random"),
                    (6, 4099, 45, 32, 0, (0, 5), "sorted"), (3, 3, 32, 4, 0, (), "random"),
                    (2, 1, 7, 2, 1, (), "random"), (5, 4096, 64, 3, 1, (2,), "sorted"),
                    (4, 4097, 40, 5, 4097, (3,), "random"), (3, 1000, 32, 0, 0, (), "random"),
                    (4, 4096, 40, 8, 0, (), "lanes_out"), (4, 2048, 32, 32, 0, (0, 1, 2, 3), "random"),
                    (2000, 1001, 32, 3, 0, tuple(range(1, 2000, 3)), "random"),
                    (40, 1001, 64, 32, 2, (3, 39), "sorted")]


@pytest.mark.parametrize("r,n,n_pat,nt,offset,inactive,kind", LANES_EDGE_CASES)
def test_triple_match_lanes_row_stream_edges_equal_plain(card, r, n, n_pat, nt, offset, inactive, kind):
    rows, pats, lanes, active = lanes_case(np.random.default_rng(r * n + nt), r, n, n_pat, nt, offset, inactive,
                                           kind)
    args = [torch.as_tensor(rows[offset:]).view(r, n, 3)] + [torch.as_tensor(x) for x in (pats, lanes, active)]
    spo_b = torch.as_tensor(rows, device=card)[offset:].view(r, n, 3)  # contiguous, its base offset by whole rows
    got = triple_match_lanes.triple_match_lanes_cuda(spo_b, *(a.to(card) for a in args[1:]))
    want = ref.pattern_lane_bits_ref(*args)
    assert tuple(got.shape) == (r, n)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want.numpy()[~active] == 0).all()


def test_broker_on_the_card_equals_the_cpu(card):
    """Three subscribers, two of them deferred, through Broker on both devices."""
    d = tcore.Dictionary()
    tau0 = d.encode_triples([("dbr:M", A, "dbo:Athlete"), ("dbr:C", A, "dbo:Athlete"), ("dbr:C", "dbp:goals", "96")])
    changesets = [
        (d.encode_triples([("dbr:C", "dbp:goals", "96")]),
         d.encode_triples([("dbr:C", "dbp:goals", "216"), ("dbr:R", A, "dbo:Athlete"), ("dbr:F", A, "dbo:Team")])),
        (np.zeros((0, 3), np.int32), d.encode_triples([("dbr:R", "dbp:goals", "10"), ("dbr:X", "dbo:team", "dbr:F")])),
    ]
    interests = [
        (([("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?g")], [("?a", "foaf:homepage", "?p")]), None),
        (([("?a", A, "dbo:Athlete")], []), tcore.PushPolicy.every(2)),
        (([("?x", "dbo:team", "?t"), ("?t", A, "dbo:Team")], []), tcore.PushPolicy.max_staleness(1e9)),
    ]
    runs = {}
    for device in ("cpu", card):
        kernels.reset_launch_counts()
        broker = tcore.Broker(d, device=device)
        for (bgp, ogp), pol in interests:
            broker.subscribe(tcore.InterestExpr.parse("s", "t", bgp, ogp),
                             tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32),
                             initial_target=tau0, policy=pol)
        outs = [broker.process_changeset(*c) for c in changesets] + [broker.flush()]
        stores = [None if o is None else getattr(o, f) for call in outs for o in call
                  for f in ("r", "r_i", "r_prime", "a", "a_i")]
        stores += [st for s in broker.subs for st in (s.tau, s.rho)]
        runs[str(device)] = ([None if st is None else tcore.to_numpy(st) for st in stores], kernels.launch_counts())
    (cpu_sets, cpu_counts), (gpu_sets, gpu_counts) = runs["cpu"], runs[str(card)]
    assert len(cpu_sets) == len(gpu_sets)
    for a, b in zip(cpu_sets, gpu_sets):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert all(n == 0 for n in cpu_counts.values())
    for name in ("triple_match_words", "triple_match_lanes", "merge_probe"):
        assert gpu_counts[name] > 0


@pytest.mark.parametrize("options", [{}, {"subsume_interests": False, "delta_frontiers": False}])
def test_default_broker_with_virtual_lanes_on_the_card_equals_the_cpu(card, options):
    """Lane groups, a contained interest on a virtual lane and a flush of two
    frontiers: the default Broker (K6 and K7 on the card) and, for
    comparison, the same with the lattice and the chain off."""
    d = tcore.Dictionary()
    tau0 = d.encode_triples([("dbr:M", A, "dbo:Athlete"), ("dbr:C", A, "dbo:Athlete"), ("dbr:C", "dbp:goals", "96")])
    changesets = [
        (d.encode_triples([("dbr:C", "dbp:goals", "96")]),
         d.encode_triples([("dbr:C", "dbp:goals", "216"), ("dbr:R", A, "dbo:Athlete"), ("dbr:R", "dbp:goals", "3")])),
        (d.encode_triples([("dbr:R", "dbp:goals", "3")]), d.encode_triples([("dbr:M", "dbp:goals", "10")])),
        (d.encode_triples([("dbr:C", "dbp:goals", "216")]), d.encode_triples([("dbr:C", "dbp:goals", "217")])),
    ]
    interests = [
        ([("?a", "dbp:goals", "?g")], None),
        ([("?x", "dbp:goals", "?y")], None),  # a renaming: joins the first's lane group
        ([("dbr:C", "dbp:goals", "?g")], tcore.PushPolicy.every(2)),  # contained: a virtual lane
        ([("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?g")], tcore.PushPolicy.max_staleness(1e9)),
    ]
    runs = {}
    for device in ("cpu", card):
        kernels.reset_launch_counts()
        broker = tcore.Broker(d, device=device, **options)
        for bgp, pol in interests:
            broker.subscribe(tcore.InterestExpr.parse("s", "t", bgp),
                             tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32),
                             initial_target=tau0, policy=pol)
        outs = [broker.process_changeset(*c) for c in changesets] + [broker.flush()]
        stores = [None if o is None else getattr(o, f) for call in outs for o in call
                  for f in ("r", "r_i", "r_prime", "a", "a_i")]
        stores += [st for s in broker.subs for st in (s.tau, s.rho)]
        runs[str(device)] = ([None if st is None else tcore.to_numpy(st) for st in stores], kernels.launch_counts(),
                             [(st.distinct_interests, st.fanout_copies, st.rows_matched) for st in broker.stats])
    (cpu_sets, cpu_counts, cpu_stats), (gpu_sets, gpu_counts, gpu_stats) = runs["cpu"], runs[str(card)]
    assert len(cpu_sets) == len(gpu_sets) and cpu_stats == gpu_stats
    for a, b in zip(cpu_sets, gpu_sets):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert all(n == 0 for n in cpu_counts.values())
    chain = ("triple_match_words_segmented", "lane_refine")
    for name in ("triple_match_words", "triple_match_lanes", "merge_probe") + (chain if not options else ()):
        assert gpu_counts[name] > 0, name
    if options:
        assert all(gpu_counts[name] == 0 for name in chain)


def test_paper_example_on_the_card_equals_the_cpu(card):
    runs = {}
    for device in ("cpu", card):
        d = tcore.Dictionary()
        expr = tcore.InterestExpr.parse(
            "s", "t", bgp=[("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?g")],
            ogp=[("?a", "foaf:homepage", "?p")],
        )
        tau0 = d.encode_triples([("dbr:M", A, "dbo:Athlete"), ("dbr:C", A, "dbo:Athlete"), ("dbr:C", "dbp:goals", "96")])
        removed = d.encode_triples([("dbr:C", "dbp:goals", "96"), ("dbr:M", "dbp:goals", "1")])
        added = d.encode_triples([("dbr:C", "dbp:goals", "216"), ("dbr:R", A, "dbo:Athlete"), ("dbr:R", "dbp:goals", "10")])
        kernels.reset_launch_counts()
        engine = tcore.IrapEngine(d, device=device)
        sub = engine.register_interest(
            expr, tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32), initial_target=tau0
        )
        out = sub.apply(removed, added)
        runs[str(device)] = ([tcore.to_numpy(getattr(out, f)) for f in ("r", "r_i", "r_prime", "a", "a_i")]
                             + [tcore.to_numpy(sub.tau), tcore.to_numpy(sub.rho)], kernels.launch_counts())
    (cpu_sets, cpu_counts), (gpu_sets, gpu_counts) = runs["cpu"], runs[str(card)]
    for a, b in zip(cpu_sets, gpu_sets):
        np.testing.assert_array_equal(a, b)
    assert cpu_counts == {"triple_match": 0, "merge_probe": 0, "triple_match_words": 0, "triple_match_lanes": 0,
                          "triple_match_words_segmented": 0, "lane_refine": 0}
    assert gpu_counts["triple_match"] > 0 and gpu_counts["merge_probe"] > 0


def test_journaled_broker_recovers_on_the_card_as_on_the_cpu(card, tmp_path):
    """A journaled broker with a delivery channel (one failed delivery that
    backs off and catches up), a snapshot and a flush, crashed before the
    snapshot, after it and at the last record: each recovery on the card
    equals its capture and the same recovery on the CPU, store for store,
    and replays through the kernels."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.testing import (CapturingJournal, FakeClock, ScriptedTransport, assert_state_equal,
                                     broker_state, crash_at_record)

    runs = {}
    for device in ("cpu", card):
        tmp = tmp_path / str(device).replace(":", "")
        d = tcore.Dictionary()
        tau0 = d.encode_triples([("dbr:M", A, "dbo:Athlete"), ("dbr:C", A, "dbo:Athlete"),
                                 ("dbr:C", "dbp:goals", "96")])
        changesets = [
            (d.encode_triples([("dbr:C", "dbp:goals", "96")]),
             d.encode_triples([("dbr:C", "dbp:goals", "216"), ("dbr:R", A, "dbo:Athlete"), ("dbr:R", "dbp:goals", "3")])),
            (d.encode_triples([("dbr:R", "dbp:goals", "3")]), d.encode_triples([("dbr:M", "dbp:goals", "10")])),
            (d.encode_triples([("dbr:C", "dbp:goals", "216")]), d.encode_triples([("dbr:C", "dbp:goals", "217")])),
            (np.zeros((0, 3), np.int32), d.encode_triples([("dbr:X", "dbp:goals", "1"), ("dbr:X", A, "dbo:Athlete")])),
        ]
        clk = FakeClock()
        ch = tcore.DeliveryChannel(ScriptedTransport(scripts={2: ["fail"]}, clock=clk), max_attempts=1,
                                   base_backoff_s=1.0, jitter=0.0, clock=clk, sleep=clk.sleep)
        captures, holder = {}, []
        j = CapturingJournal(tmp / "wal", fsync=False,
                             on_append=lambda seq, kind: captures.__setitem__(seq, broker_state(holder[0])))
        broker = tcore.Broker(d, device=device, journal=j, channel=ch)
        holder.append(broker)
        for bgp, pol in [([("?a", "dbp:goals", "?g")], None), ([("?x", "dbp:goals", "?y")], None),
                         ([("dbr:C", "dbp:goals", "?g")], tcore.PushPolicy.every(2)),
                         ([("?a", A, "dbo:Athlete"), ("?a", "dbp:goals", "?g")], tcore.PushPolicy.max_staleness(1e9))]:
            broker.subscribe(tcore.InterestExpr.parse("s", "t", bgp),
                             tcore.StepCapacities(n_removed=16, n_added=16, tau=64, rho=64, pulls=32),
                             initial_target=tau0, policy=pol)
        store = CheckpointStore(tmp / "ckpt")
        for i, c in enumerate(changesets):
            broker.process_changeset(*c)
            if i == 1:
                snap = broker.snapshot(store)
            clk.advance(2.0)
        broker.flush()
        j.close()
        n = max(captures)
        final = broker_state(broker)
        states = []
        kernels.reset_launch_counts()
        for k in (snap - 1, snap + 1, n):
            crash_at_record(tmp / "wal", tmp / f"crash{k}", k)
            got = broker_state(tcore.Broker.recover(tcore.ChangesetJournal(tmp / f"crash{k}", fsync=False), store,
                                                    dictionary=d, device=device))
            assert_state_equal(final if k == n else {**captures[k + 1], "seq": k}, got)
            states.append(got)
        runs[str(device)] = (states, kernels.launch_counts(), ch.stats)
    (cpu_states, cpu_counts, cpu_stats), (gpu_states, gpu_counts, gpu_stats) = runs["cpu"], runs[str(card)]
    assert cpu_stats == gpu_stats and cpu_stats.failures == 1
    for a, b in zip(cpu_states, gpu_states):
        assert_state_equal(a, b)
    assert all(n == 0 for n in cpu_counts.values())
    for name in ("triple_match_words", "triple_match_lanes", "merge_probe", "triple_match_words_segmented",
                 "lane_refine"):
        assert gpu_counts[name] > 0, name
