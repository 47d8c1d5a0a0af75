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
from repro_torch.kernels import merge_join, ref, triple_match  # noqa: E402

PAD = int(np.iinfo(np.int32).max)


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


def test_paper_example_on_the_card_equals_the_cpu(card):
    A = "rdf:type"
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
    assert cpu_counts == {"triple_match": 0, "merge_probe": 0}
    assert gpu_counts["triple_match"] > 0 and gpu_counts["merge_probe"] > 0
