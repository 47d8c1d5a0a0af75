"""The port's int8 gradient compression against the reference's, on the CPU.

* ``quantize_int8``: ``q`` and ``scale`` bit for bit, values exactly on .5
  among them. ``ErrorFeedbackInt8``'s residuals after 10 steps at 1e-6.
* The reference's two compression tests (``tests/test_substrate.py``) on the
  port, the quadratic's gradient from autograd.
* ``compressed_psum`` on ``DeviceMesh.on_cpu(2)`` and ``on_cpu(4)`` against
  the reference's formula applied to the reference's ``quantize_int8`` of
  each shard, in numpy, at rtol 1e-6.

Helpers from ``test_torch_optim.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import cosine_warmup as ref_cosine  # noqa: E402
from repro.optim.compression import ErrorFeedbackInt8 as RefEF  # noqa: E402
from repro.optim.compression import quantize_int8 as ref_quantize  # noqa: E402
from repro_torch.core.distributed import DeviceMesh, run_spmd  # noqa: E402
from repro_torch.optim import AdamW, cosine_warmup  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    ErrorFeedbackInt8,
    compressed_psum,
    dequantize_int8,
    quantize_int8,
)
from test_torch_optim import RTOL, SHAPES, as_jax, as_torch, leaves, one_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------
def ties():
    """Values whose quotient by the scale is exactly k + 0.5: the scale is a
    power of two (127 * 2^-3 / 127), so g / scale is exact."""
    s = np.float32(2.0 ** -3)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5, 64.5], np.float32)
    return np.concatenate([[127 * s, -127 * s], halves * s, [0.0]]).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny"])
def test_quantize_int8_bit_for_bit(case):
    g = {
        "normal": np.random.default_rng(0).normal(size=(257,)).astype(np.float32) * 3,
        "ties": ties(),
        "zeros": np.zeros((9,), np.float32),
        "tiny": np.random.default_rng(1).normal(size=(33,)).astype(np.float32) * 1e-14,
    }[case]
    r_q, r_scale = ref_quantize(jnp.asarray(g))
    p_q, p_scale = quantize_int8(torch.tensor(g))
    assert p_q.dtype == torch.int8 and p_scale.dtype == torch.float32
    np.testing.assert_array_equal(p_q.numpy(), np.asarray(r_q))
    assert p_scale.numpy().tobytes() == np.asarray(r_scale).tobytes()
    if case == "ties":  # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126, 3.5 -> 4, 64.5 -> 64
        np.testing.assert_array_equal(p_q.numpy()[2:12], [0, 2, 2, 0, -2, -2, 126, -126, 4, 64])


def test_quantize_roundtrip_error_bounded():
    g = torch.tensor(np.random.default_rng(0).normal(size=(257,)).astype(np.float32) * 3.0)
    q, scale = quantize_int8(g)
    err = (dequantize_int8(q, scale) - g).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_residuals_after_10_steps_equal_reference():
    ref = RefEF(RefAdamW(learning_rate=ref_cosine(1e-2, 3, 10), weight_decay=0.01, max_grad_norm=1.0))
    port = ErrorFeedbackInt8(AdamW(learning_rate=cosine_warmup(1e-2, 3, 10), weight_decay=0.01,
                                   max_grad_norm=1.0))
    rp, pp = as_jax(leaves(0)), as_torch(leaves(0))
    rs, ps = ref.init(rp), port.init(pp)
    assert sorted(ps) == sorted(rs) == ["inner", "residual"]
    for i in range(10):
        g = leaves(200 + i, scale=0.5 + i)
        rp, rs, _ = ref.update(as_jax(g), rs, rp)
        pp, ps, _ = port.update(as_torch(g), ps, pp)
    for k in SHAPES:
        r_res = np.asarray(rs["residual"][k])
        assert np.abs(r_res).max() > 0
        np.testing.assert_allclose(ps["residual"][k].numpy(), r_res, rtol=RTOL, atol=RTOL * np.abs(r_res).max())
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(rp[k])).max())
    assert int(ps["inner"]["step"]) == 10


def test_error_feedback_converges_like_uncompressed():
    """EF-int8 AdamW reaches (almost) the same optimum on a quadratic."""
    target = torch.tensor(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))

    def loss_fn(p):
        return torch.sum(torch.square(p["w"] - target))

    def run(opt):
        params = {"w": torch.zeros(64, dtype=torch.float32, requires_grad=True)}
        state = opt.init(params)
        for _ in range(300):
            (g,) = torch.autograd.grad(loss_fn(params), [params["w"]])
            params, state, _ = opt.update({"w": g}, state, params)
        return float(loss_fn(params).detach())

    base = run(AdamW(learning_rate=3e-2))
    comp = run(ErrorFeedbackInt8(AdamW(learning_rate=3e-2)))
    assert comp < max(base * 3, 1e-2), (base, comp)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_compressed_psum_matches_the_formula_on_the_mesh(n_shards):
    mesh = DeviceMesh.on_cpu(n_shards)
    rng = np.random.default_rng(n_shards)
    shards = [(rng.normal(size=(6, 5)) * (k + 1)).astype(np.float32) for k in range(n_shards)]

    out = run_spmd(mesh, lambda g: compressed_psum(g, mesh.axis_name), [torch.tensor(g) for g in shards])

    parts = [ref_quantize(jnp.asarray(g)) for g in shards]
    total = sum(np.asarray(q).astype(np.int32) for q, _ in parts)
    scale_sum = np.float32(0)
    for _, s in parts:
        scale_sum = np.float32(scale_sum + np.float32(s))
    n = np.float32(n_shards)
    want = total.astype(np.float32) * (scale_sum / n) / n
    for got in out:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    for got in out[1:]:
        assert torch.equal(got, out[0])
