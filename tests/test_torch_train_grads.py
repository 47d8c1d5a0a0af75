"""Gradients of the port's ``train_loss`` against ``jax.grad`` of the
reference's: the attention families, on the CPU.

Each family's smoke configuration in float32, the reference's ``init``
weights carried by ``params_from_jax`` (the vlm's zero-initialised cross
gates set to 0.7 first), B = 2 and S = 16 with three labels masked. The
port's gradients come from autograd (``torch.autograd.grad`` over the
parameters that ``make_train_step`` turns on); ``tree_to_jax`` stacks them
into the reference's pytree, and every leaf is held to the reference's
``jax.value_and_grad`` at rtol = atol = 1e-4 relative to the leaf's
largest magnitude. The loss and ``train_loss``'s metrics are held to
1e-4. Measured largest gaps (relative to each leaf's largest magnitude):
internlm2 6.5e-7, nemotron 6.1e-7, granite-moe 7.0e-7, kimi-k2 8.2e-7,
gemma3 1.7e-6; the state-space and cross-attention families in
``test_torch_train_grads_ssm.py``.

granite-moe runs twice: as configured, and with ``capacity_factor`` 0.25,
where its 4 experts hold 8 (token, choice) pairs each, 32 slots for 64
pairs, so at least 32 overflow in every MoE layer, and the dispatch's
dropped writes and the zeroed gathers carry no gradient, as the
reference's dropping scatter. One ``make_train_step`` step's metrics
(``loss``, ``grad_norm``, ``xent``, ``aux``) equal the reference's.

Each reference gradient is compiled once (``jax.jit``) and computed once
per module (``Grads``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_to_jax  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

B, S = 2, 16
TOL = 1e-4
GATE = 0.7
CASES = {
    "internlm2": ("internlm2-1.8b", {}),
    "nemotron": ("nemotron-4-15b", {}),
    "granite-moe": ("granite-moe-3b-a800m", {}),
    "granite-moe-overflow": ("granite-moe-3b-a800m", {"capacity_factor": 0.25}),
    "kimi-k2": ("kimi-k2-1t-a32b", {}),
    "gemma3": ("gemma3-4b", {}),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    batch["labels"][0, :3] = -1
    if cfg.family == "encdec":
        batch["enc_embed"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embed"] = rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def reference_grads(arch, overrides):
    """The reference's config, weights, batch, and ``jax.value_and_grad`` of
    its ``train_loss`` (float32)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    api = ref_build_model(cfg)
    params = jax.jit(api.init)(jax.random.key(0))
    if cfg.family == "vlm":
        params["cross_blocks"]["gate"] = jnp.full_like(params["cross_blocks"]["gate"], GATE)
    batch = make_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(api.train_loss, has_aux=True))(params, jb)
    return {"cfg": cfg, "api": api, "params": params, "batch": batch, "loss": np.asarray(loss),
            "metrics": jax.tree.map(np.asarray, metrics), "grads": jax.tree.map(np.asarray, grads)}


def port_model(arch, overrides, ref):
    cfg = dataclasses.replace(port_smoke_config(arch), dtype="float32", **overrides)
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, ref["params"])))
    return model


def port_grads(model, batch):
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = model.train_loss(batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_to_jax(model.cfg, dict(zip(named, grads)))


def leaf_gaps(ref_tree, port_tree):
    """{path: max |port - ref| / max |ref|} over the reference's leaves;
    the two trees hold the same paths and shapes."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    assert [p for p, _ in ref_leaves] == [p for p, _ in port_leaves]
    gaps = {}
    for (path, r), (_, p) in zip(ref_leaves, port_leaves):
        assert r.shape == p.shape, jax.tree_util.keystr(path)
        scale = float(np.abs(r).max()) or 1.0
        np.testing.assert_allclose(p / scale, r / scale, rtol=TOL, atol=TOL, err_msg=jax.tree_util.keystr(path))
        gaps[jax.tree_util.keystr(path)] = float(np.abs(p - r).max()) / scale
    return gaps


class Grads:
    """Each case's reference gradient, computed once per module."""

    def __init__(self):
        self.runs = {}

    def __call__(self, case):
        if case not in self.runs:
            self.runs[case] = reference_grads(*CASES[case])
        return self.runs[case]


@pytest.fixture(scope="module")
def grads():
    return Grads()


def check_train_loss_gradients(arch, overrides, ref):
    model = port_model(arch, overrides, ref)
    loss, metrics, got = port_grads(model, ref["batch"])
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=TOL, atol=TOL)
    assert sorted(metrics) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=TOL, atol=TOL)
    gaps = leaf_gaps(ref["grads"], got)
    assert max(gaps.values()) < TOL
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_gradients_equal_jax_grad(grads, case):
    arch, overrides = CASES[case]
    check_train_loss_gradients(arch, overrides, grads(case))


def test_moe_overflow_case_drops_pairs():
    """The overflow case's 4 experts hold 8 pairs each: 32 slots for the 64
    (token, choice) pairs of every MoE layer, so at least 32 are dropped."""
    from repro_torch.models.layers import moe_capacity

    arch, overrides = CASES["granite-moe-overflow"]
    cfg = dataclasses.replace(port_smoke_config(arch), **overrides)
    assert moe_capacity(cfg, B * S) == 8
    assert B * S * cfg.top_k - moe_capacity(cfg, B * S) * cfg.n_experts >= 32


def test_train_step_metrics_equal_reference(grads):
    """One step of each package's ``make_train_step`` (AdamW with clipping):
    the same loss, gradient norm and metrics; the served model's parameters
    stay without gradients."""
    ref = grads("granite-moe")
    r_opt = RefAdamW(learning_rate=1e-3, max_grad_norm=1.0)
    r_step = jax.jit(ref_make_train_step(ref["api"], r_opt))
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    _, _, r_metrics = r_step(ref["params"], r_opt.init(ref["params"]), jb)

    model = port_model("granite-moe-3b-a800m", {}, ref)
    assert not any(p.requires_grad for p in model.parameters())
    opt = AdamW(learning_rate=1e-3, max_grad_norm=1.0)
    step = make_train_step(model, opt)
    assert all(p.requires_grad for p in model.parameters())
    state, metrics = step(opt.init(dict(model.named_parameters())), ref["batch"])
    assert sorted(metrics) == sorted(r_metrics) == ["aux", "grad_norm", "loss", "xent"]
    for k, v in r_metrics.items():
        assert not metrics[k].requires_grad
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=TOL, atol=TOL)
    assert int(state["step"]) == 1
    served = build_model(model.cfg, "cpu")
    assert not any(p.requires_grad for p in served.parameters())
