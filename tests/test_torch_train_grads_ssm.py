"""Gradients of the port's ``train_loss`` against ``jax.grad`` of the
reference's: the cross-attention and state-space families, on the CPU.

whisper (encoder-decoder), llama-3.2-vision (cross blocks, gates set to
0.7 in both packages), falcon-mamba (Mamba-1) and zamba2 (Mamba-2 groups
with one shared attention block), smoke configurations in float32, the
method of ``test_torch_train_grads.py``: B = 2 and S = 16, so each scan
runs two chunks of 8 and its state crosses a chunk boundary, every
gradient leaf at rtol = atol = 1e-4 relative to the leaf's largest
magnitude. Measured largest gaps: whisper 1.4e-6, llama-vision 9.6e-7,
falcon-mamba 4.8e-7, zamba2 2.1e-6.

What autograd sees here that serving does not: the Hillis-Steele doubling
and the chunk loop that carries the Mamba-1 state (``.clone()`` of the last
position), the SSD's ``-inf`` above the diagonal of ``_segsum`` (an
``exp`` of it has zero gradient), and zamba2's ``shared_attn``, one set of
weights applied after each of its two groups: its gradient is the sum
over both uses, which the reference's unstacked leaf holds too.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_train_grads import check_train_loss_gradients, reference_grads  # noqa: E402

CASES = {
    "whisper": "whisper-medium",
    "llama-vision": "llama-3.2-vision-90b",
    "falcon-mamba": "falcon-mamba-7b",
    "zamba2": "zamba2-7b",
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = reference_grads(CASES[case], {})
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_gradients_equal_jax_grad(runs, case):
    check_train_loss_gradients(CASES[case], {}, runs(case))


def test_shared_block_gradient_sums_its_uses(runs, monkeypatch):
    """zamba2's shared block runs after each of its 2 groups. Its gradient
    with one use's weights held constant (a detached copy of them) is that
    use's partial; the two partials add up to the full gradient, which the
    reference's holds."""
    from types import SimpleNamespace

    from repro_torch.models import layers as L

    ref = runs("zamba2")
    model = check_train_loss_gradients(CASES["zamba2"], {}, ref)
    assert model.n_groups == 2
    attn = model.shared_attn.attn
    weights = [attn.wq, attn.wk, attn.wv, attn.wo]
    full = torch.autograd.grad(model.train_loss(ref["batch"])[0], weights)

    attention = L.attention
    partials = []
    for use in range(2):
        calls = []

        def one_use(p, x, cfg, _use=use, _calls=calls, **kw):
            _calls.append(p)
            if p is attn and len(_calls) - 1 != _use:
                p = SimpleNamespace(**{k: getattr(p, k).detach() for k in ("wq", "wk", "wv", "wo")})
            return attention(p, x, cfg, **kw)

        monkeypatch.setattr(L, "attention", one_use)
        partials.append(torch.autograd.grad(model.train_loss(ref["batch"])[0], weights))
        monkeypatch.setattr(L, "attention", attention)
        assert len(calls) == 2 and all(p is attn for p in calls)
    for a, b, whole in zip(*partials, full):
        assert a.abs().max() > 0 and b.abs().max() > 0
        torch.testing.assert_close(a + b, whole, rtol=1e-5, atol=1e-6 * float(whole.abs().max()))
