"""The port's cross-attending families against the reference's, on the CPU:
the encoder-decoder (whisper: non-causal encoder self-attention with rope,
tanh-form gelu, LayerNorm) and the vision model (llama-3.2-vision: gated
cross blocks, the gate carried nonzero), through the same checks as
``test_torch_models.py`` (see its docstring for the tolerances).
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_models import (  # noqa: E402
    GATE,
    Runs,
    check_bf16,
    check_greedy,
    check_loss,
    check_prefill,
    check_round_trip,
)

ARCHS = {"encdec": "whisper-medium", "vlm": "llama-3.2-vision-90b"}


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


def test_vlm_gate_is_carried_nonzero(runs):
    """The comparison above runs the cross-attention path: every cross
    block's gate is the nonzero value set in the reference's weights."""
    _, port = runs.float32(ARCHS["vlm"])
    gates = [float(p) for name, p in port["model"].named_parameters() if name.endswith(".gate")]
    assert gates and all(g == pytest.approx(GATE) for g in gates)
