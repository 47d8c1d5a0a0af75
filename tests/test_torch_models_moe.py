"""The port's MoE families against the reference's, on the CPU: the routed
experts (granite) and routed plus shared experts (kimi), through the same
checks as ``test_torch_models.py`` (see its docstring for the tolerances);
and ``apply_moe`` where the capacity overflows and where the router ties.
The families are split over three files so that none is the suite's long
pole when files are spread over workers whole.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_models import (  # noqa: E402
    TOL,
    Runs,
    check_bf16,
    check_greedy,
    check_loss,
    check_prefill,
    check_round_trip,
)

ARCHS = {"moe": "granite-moe-3b-a800m", "moe+shared": "kimi-k2-1t-a32b"}


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("family", ARCHS)
def test_prefill_logits_and_cache_equal_reference(runs, family):
    check_prefill(runs, ARCHS[family])


@pytest.mark.parametrize("family", ARCHS)
def test_greedy_decode_equals_reference(runs, family):
    check_greedy(runs, ARCHS[family])


@pytest.mark.parametrize("family", ARCHS)
def test_train_loss_equals_reference(runs, family):
    check_loss(runs, ARCHS[family])


@pytest.mark.parametrize("family", ARCHS)
def test_bfloat16_logits_within_measured_tolerance(runs, family):
    check_bf16(runs, ARCHS[family])


@pytest.mark.parametrize("family", ARCHS)
def test_carried_weights_round_trip(runs, family):
    check_round_trip(runs, ARCHS[family])


@pytest.mark.parametrize("case", ["overflow", "router_ties", "shared"])
def test_apply_moe_equals_reference(case):
    """``apply_moe`` alone, in float32, with 64 (token, choice) pairs over 4
    experts of capacity 8: half the pairs overflow and are dropped. With a
    zero router every expert ties, so top-k must pick experts 0 and 1 for
    every token (the lower indices) and most pairs overflow."""
    from repro.configs import get_smoke_config
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    arch = "kimi-k2-1t-a32b" if case == "shared" else "granite-moe-3b-a800m"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", capacity_factor=0.5)
    params = jax.jit(ref_layers.init_moe, static_argnums=1)(jax.random.key(5), cfg)
    if case == "router_ties":
        params["router"] = jnp.zeros_like(params["router"])
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(ref_layers.apply_moe, static_argnums=2)(params, jnp.asarray(x), cfg)

    moe = layers.Moe(cfg, "cpu")
    state = {k: torch.tensor(np.asarray(v)) for k, v in params.items() if k != "shared"}
    state.update({f"shared.{k}": torch.tensor(np.asarray(v)) for k, v in params.get("shared", {}).items()})
    moe.load_state_dict(state)
    got, got_aux = layers.apply_moe(moe, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), **TOL)

    # the case is what it says: pairs overflowed (their outputs dropped)
    t, k, e = x.shape[0] * x.shape[1], cfg.top_k, cfg.n_experts
    cap = layers.moe_capacity(cfg, t)
    assert cap == ref_layers.moe_capacity(cfg, t) == 8
    probs = torch.softmax(torch.from_numpy(x).reshape(t, -1) @ moe.router, -1)
    eidx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k].reshape(-1)
    load = torch.bincount(eidx, minlength=e)
    assert int(torch.clamp(load - cap, min=0).sum()) > 0
    if case == "router_ties":
        assert set(eidx.tolist()) == {0, 1}
