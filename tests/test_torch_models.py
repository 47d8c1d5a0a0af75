"""The port's attention families against the reference's, on the CPU.

Each family's smoke configuration (``get_smoke_config``) is built in both
packages; the reference's ``init`` weights are carried across with
``params_from_jax`` (the vlm's zero-initialised cross gates set to a nonzero
value in both first, or the cross-attention path would be multiplied by
``tanh(0)``). In float32 the prefill logits, every cache leaf, the logits of
a 4-step greedy decode, the final cache and ``train_loss``'s loss and
metrics agree at ``rtol=atol=1e-4`` (the reference's own teacher-forcing
tolerance, ``tests/test_arch_smoke.py``), and the greedy ids are equal.

In bfloat16 (the configs' own compute dtype) the two differ by more than
float32 noise: XLA keeps float32 precision inside its fused elementwise
chains, while torch rounds every operation's output to bfloat16. Measured
over the seven families here: logits differ by at most 0.047 (prefill and a
teacher-forced decode step; logits are of order 1-4), losses by at most
0.0035. The bfloat16 checks hold logits to ``atol=0.1`` and losses to
``atol=0.01``, about twice the measured differences.

Each reference model is built and run once per module (a fixture shared by
the checks); its decode steps run under one ``jax.jit``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402

B, S, STEPS = 2, 8, 4
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS_ATOL = 0.1
BF16_LOSS_ATOL = 0.01
GATE = 0.7
ARCHS = {
    "dense": "internlm2-1.8b",
    "dense+squared_relu": "nemotron-4-15b",
    "local_global": "gemma3-4b",
}


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    if cfg.family == "encdec":
        batch["enc_embed"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embed"] = rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def reference_params(arch, dtype, params=None):
    """The reference's config, model and ``init`` weights (float32 whatever
    the compute dtype: pass one dtype's weights to reuse them for another)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    api = ref_build_model(cfg)
    if params is None:
        params = jax.jit(api.init)(jax.random.key(0))
        if cfg.family == "vlm":
            params["cross_blocks"]["gate"] = jnp.full_like(params["cross_blocks"]["gate"], GATE)
    return cfg, api, params


def port_model(arch, dtype, params):
    cfg = dataclasses.replace(port_smoke_config(arch), dtype=dtype)
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    return model


def run_reference(arch, dtype, seed=1):
    """Prefill, a greedy decode of STEPS steps and the loss, in the reference."""
    cfg, api, params = reference_params(arch, dtype)
    batch = make_batch(cfg, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache = api.prefill(params, dict(jb, max_seq=S + STEPS))
    out = {"params": jax.tree.map(np.asarray, params), "batch": batch,
           "prefill": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache)}
    decode = jax.jit(api.decode_step)
    tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1).astype(jnp.int32)
    out["ids"], out["decode"] = [np.asarray(tok)], []
    for i in range(STEPS):
        logits, cache = decode(params, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1).astype(jnp.int32)
        out["decode"].append(np.asarray(logits))
        out["ids"].append(np.asarray(tok))
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    loss, metrics = api.train_loss(params, jb)
    out["loss"], out["metrics"] = np.asarray(loss), jax.tree.map(np.asarray, metrics)
    return out


def run_port(arch, dtype, ref):
    model = port_model(arch, dtype, ref["params"])
    vocab = model.cfg.vocab
    batch = ref["batch"]
    logits, cache = model.prefill(dict(batch, max_seq=S + STEPS))
    out = {"model": model, "prefill": logits, "cache": cache}
    tok = logits[:, :vocab].argmax(-1)
    out["ids"], out["decode"] = [tok.numpy()], []
    for i in range(STEPS):
        logits, cache = model.decode_step(cache, tok, S + i)
        tok = logits[:, :vocab].argmax(-1)
        out["decode"].append(logits)
        out["ids"].append(tok.numpy())
    out["final_cache"] = cache
    out["loss"], out["metrics"] = model.train_loss(batch)
    return out


def run_bf16(arch, params):
    """bfloat16 prefill logits, one decode step teacher-forced with the same
    token in both packages, and the loss."""
    cfg, api, params = reference_params(arch, "bfloat16", params)
    model = port_model(arch, "bfloat16", params)
    batch = make_batch(cfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    r_logits, r_cache = api.prefill(params, dict(jb, max_seq=S + 1))
    p_logits, p_cache = model.prefill(dict(batch, max_seq=S + 1))
    tok = np.asarray(jnp.argmax(r_logits[:, :cfg.vocab], axis=-1)).astype(np.int32)
    r_step, _ = api.decode_step(params, r_cache, jnp.asarray(tok), jnp.int32(S))
    p_step, _ = model.decode_step(p_cache, torch.from_numpy(tok), S)
    r_loss, _ = api.train_loss(params, jb)
    p_loss, _ = model.train_loss(batch)
    return {"prefill": (r_logits, p_logits), "decode": (r_step, p_step), "loss": (r_loss, p_loss)}


class Runs:
    """Each family's reference and port runs, computed once when first asked for."""

    def __init__(self):
        self.f32, self.bf16 = {}, {}

    def float32(self, arch):
        if arch not in self.f32:
            ref = run_reference(arch, "float32")
            self.f32[arch] = (ref, run_port(arch, "float32", ref))
        return self.f32[arch]

    def bfloat16(self, arch):
        if arch not in self.bf16:
            params = jax.tree.map(jnp.asarray, self.float32(arch)[0]["params"])
            self.bf16[arch] = run_bf16(arch, params)
        return self.bf16[arch]


def assert_caches_close(ref_cache, port_cache):
    assert sorted(ref_cache) == sorted(port_cache)
    for name, leaf in ref_cache.items():
        assert tuple(port_cache[name].shape) == leaf.shape, name
        np.testing.assert_allclose(as_np(port_cache[name]), leaf, err_msg=name, **TOL)


def check_prefill(runs, arch):
    ref, port = runs.float32(arch)
    assert tuple(port["prefill"].shape) == ref["prefill"].shape
    np.testing.assert_allclose(as_np(port["prefill"]), ref["prefill"], **TOL)
    assert_caches_close(ref["cache"], port["cache"])


def check_greedy(runs, arch):
    ref, port = runs.float32(arch)
    for step, (r_ids, p_ids) in enumerate(zip(ref["ids"], port["ids"])):
        np.testing.assert_array_equal(p_ids, r_ids, err_msg=f"greedy step {step}")
    for step, (r, p) in enumerate(zip(ref["decode"], port["decode"])):
        np.testing.assert_allclose(as_np(p), r, err_msg=f"decode step {step}", **TOL)
    assert_caches_close(ref["final_cache"], port["final_cache"])


def check_loss(runs, arch):
    ref, port = runs.float32(arch)
    np.testing.assert_allclose(as_np(port["loss"]), ref["loss"], **TOL)
    assert sorted(port["metrics"]) == sorted(ref["metrics"])
    for name, value in ref["metrics"].items():
        np.testing.assert_allclose(as_np(port["metrics"][name]), value, err_msg=name, **TOL)


def check_bf16(runs, arch):
    got = runs.bfloat16(arch)
    for what in ("prefill", "decode"):
        r, p = got[what]
        assert p.dtype == torch.float32
        np.testing.assert_allclose(as_np(p), as_np(r), rtol=0, atol=BF16_LOGITS_ATOL, err_msg=what)
    r, p = got["loss"]
    np.testing.assert_allclose(as_np(p), as_np(r), rtol=0, atol=BF16_LOSS_ATOL)


def check_round_trip(runs, arch):
    ref, port = runs.float32(arch)
    back = params_to_jax(port["model"].cfg, port["model"])
    assert jax.tree.structure(back) == jax.tree.structure(ref["params"])
    for (path, leaf), got in zip(jax.tree_util.tree_leaves_with_path(ref["params"]), jax.tree.leaves(back)):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, leaf, err_msg=str(path))


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


def test_ring_buffer_wraps_in_the_decode():
    """The local/global smoke config's window (8) equals the prompt length,
    so every decode step above overwrites a ring slot: the greedy test
    compares a wrapped ring."""
    cfg = get_smoke_config(ARCHS["local_global"])
    assert cfg.window == S and cfg.n_layers % cfg.global_every == 2


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_rope_equals_reference_at_gemma3_theta(positions):
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.array([0, 1, 7, 1023, 1100], np.int32)
    if positions == "2d":
        pos = np.stack([pos, pos[::-1]])
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
