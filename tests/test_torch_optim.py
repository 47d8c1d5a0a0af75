"""The port's optimizer substrate against the reference's, on the CPU:
the schedules and clipping here, ``AdamW`` in ``test_torch_optim_adamw.py``,
int8 compression in ``test_torch_optim_compression.py``.

* Schedules: ``constant`` and ``cosine_warmup`` at steps 0-40, the step an
  int and a 0-d int32 tensor. The warm-up and the constant are equal bit
  for bit; the cosine is taken in float64 and rounded to float32, which
  XLA's float32 ``cos`` matches at most arguments: ``launch/train``'s
  schedules are equal at every step, the others within one ulp (measured:
  one step of 41 differs, for ``cosine_warmup(3e-3, 5, 40, 1e-4)``).
* ``clip_by_global_norm`` at rtol 1e-6, clipping and not.

The optimizer files hold at most 9 tests each: ``--dist loadfile`` queues
files with more tests first, and files of fewer tests than
``tests/test_substrate.py`` leave the queue before it, and so the timing
of its ``test_straggler_detection``, as they were.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import clip_by_global_norm as ref_clip  # noqa: E402
from repro.optim import constant as ref_constant  # noqa: E402
from repro.optim import cosine_warmup as ref_cosine  # noqa: E402
from repro_torch.optim import clip_by_global_norm, constant, cosine_warmup  # noqa: E402

SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 6)}
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def as_torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def as_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
EXACT_SCHEDULES = [(1e-3, 10, 30), (1e-3, 10, 50), (1e-3, 10, 10), (2e-2, 0, 40)]
ULP_SCHEDULES = [(3e-3, 5, 40, 1e-4), (1e-2, 3, 25, 1e-3)]


def schedule_values(ref, port):
    got = np.array([port(s).numpy() for s in range(41)])
    as_tensor = np.array([port(torch.tensor(s, dtype=torch.int32)).numpy() for s in range(41)])
    want = np.array([np.float32(ref(jnp.int32(s))) for s in range(41)])
    assert got.dtype == np.float32 and as_tensor.dtype == np.float32
    np.testing.assert_array_equal(got, as_tensor)
    return got, want


@pytest.mark.parametrize("args", EXACT_SCHEDULES)
def test_cosine_warmup_equals_reference_bit_for_bit(args):
    got, want = schedule_values(ref_cosine(*args), cosine_warmup(*args))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", ULP_SCHEDULES)
def test_cosine_warmup_within_one_ulp_of_reference(args):
    got, want = schedule_values(ref_cosine(*args), cosine_warmup(*args))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    warm = np.arange(41) < args[1]
    np.testing.assert_array_equal(got[warm], want[warm])


def test_constant_equals_reference():
    got, want = schedule_values(ref_constant(3e-4), constant(3e-4))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# AdamW and clipping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_clip_by_global_norm_equals_reference(clip):
    g = leaves(3, scale=2.0)
    max_norm = clip or 1e6  # 1e6: the norm is below it, nothing is scaled
    r_out, r_gn = ref_clip(as_jax(g), max_norm)
    p_out, p_gn = clip_by_global_norm(as_torch(g), max_norm)
    np.testing.assert_allclose(float(p_gn), float(r_gn), rtol=RTOL)
    for k in SHAPES:
        np.testing.assert_allclose(p_out[k].numpy(), np.asarray(r_out[k]), rtol=RTOL, atol=0)
    if not clip:
        for k in SHAPES:
            np.testing.assert_array_equal(p_out[k].numpy(), g[k])


