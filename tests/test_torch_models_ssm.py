"""The port's state-space families against the reference's, on the CPU.

* ``repro_torch.models.ssm`` on its own: the reference's
  ``tests/test_ssm.py`` checks run on the port (the chunked Mamba-1 and
  Mamba-2 forwards equal their step-by-step recurrences at chunks 4, 8 and
  16, rtol = atol = 2e-3 as there; the SSD output and final state do not
  depend on the chunk size, 1e-4), and each function against the
  reference's on the same seeded inputs in float32 at 1e-4.
* falcon-mamba-7b (Mamba-1, ``Ssm``) and zamba2-7b (Mamba-2 groups with one
  shared attention block, ``Hybrid``), smoke configs, the reference's
  ``init`` weights carried by ``params_from_jax``, B = 2 and S = 16 with
  chunk 8, so the inter-chunk recurrence runs. In float32 at
  rtol = atol = 1e-4: the prefill logits and every cache leaf (zamba2's
  shared keys and values padded to ``max_seq`` = S + 4 > S), teacher
  forcing from 15 tokens (a single chunk: 15 is no multiple of 8), a 4-step
  greedy decode (logits, equal ids, final cache), ``train_loss`` and the
  weights' round trip.

In bfloat16 torch rounds every operation's output where XLA keeps float32
inside its fusions. Measured over ten batch seeds (2-11; logits are of
order 1-4) by ``experiments/torch_ssm_gaps.py``: falcon-mamba's logits differ by at most 0.023 (prefill) and
0.017 (a decode step), its losses by 0.0015; zamba2's logits by at most
0.156 (prefill) and 0.088 (decode), its losses by 0.0055. zamba2's gap is
the larger: its 5 Mamba-2 blocks each end in a gated RMSNorm and its shared
attention block adds a bfloat16 softmax, each rounded once more than in
XLA. The bfloat16 checks hold falcon-mamba's logits to ``atol=0.1`` and
losses to ``atol=0.01``, as ``test_torch_models.py`` does for the attention
families; zamba2's to 0.3 and 0.02, about twice its measured differences.

Each reference model is built and run once per module (``Runs``); its
decode steps run under one ``jax.jit``.
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
from repro.models import ssm as RS  # noqa: E402
from repro.models.config import ModelConfig as RefConfig  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402

B, S_LEN, STEPS = 2, 16, 4
MAX_SEQ = S_LEN + STEPS
TOL = dict(rtol=1e-4, atol=1e-4)
STEPWISE_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_ATOL = {"ssm": (0.1, 0.01), "hybrid": (0.3, 0.02)}  # (logits, loss): module docstring
ARCHS = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-7b"}


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def flat(tree, path=""):
    """A nested cache dict -> {"a/b": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def assert_caches_close(ref_cache, port_cache, **tol):
    ref, port = flat(ref_cache), flat(port_cache)
    assert sorted(ref) == sorted(port)
    for name, leaf in ref.items():
        assert tuple(port[name].shape) == leaf.shape, name
        np.testing.assert_allclose(as_np(port[name]), leaf, err_msg=name, **(tol or TOL))


# ---------------------------------------------------------------------------
# the two families, end to end
# ---------------------------------------------------------------------------

def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32)}


def reference_params(arch, dtype, params=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    api = ref_build_model(cfg)
    if params is None:
        params = jax.jit(api.init)(jax.random.key(0))
    return cfg, api, params


def port_model(arch, dtype, params):
    cfg = dataclasses.replace(port_smoke_config(arch), dtype=dtype)
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    return model


def run_reference(arch, seed=1):
    """Prefill, teacher forcing from S - 1 tokens, a greedy decode and the
    loss, in float32; one jitted decode step serves every call."""
    cfg, api, params = reference_params(arch, "float32")
    batch = make_batch(cfg, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    decode = jax.jit(api.decode_step)
    logits, cache = api.prefill(params, dict(jb, max_seq=MAX_SEQ))
    out = {"params": jax.tree.map(np.asarray, params), "batch": batch,
           "prefill": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache)}
    _, short = api.prefill(params, {"tokens": jb["tokens"][:, :-1], "max_seq": MAX_SEQ})
    out["forced"] = np.asarray(decode(params, short, jb["tokens"][:, -1], jnp.int32(S_LEN - 1))[0])
    tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1).astype(jnp.int32)
    out["ids"], out["decode"] = [np.asarray(tok)], []
    for i in range(STEPS):
        logits, cache = decode(params, cache, tok, jnp.int32(S_LEN + i))
        tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1).astype(jnp.int32)
        out["decode"].append(np.asarray(logits))
        out["ids"].append(np.asarray(tok))
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    loss, metrics = api.train_loss(params, jb)
    out["loss"], out["metrics"] = np.asarray(loss), jax.tree.map(np.asarray, metrics)
    return out


def run_port(arch, ref):
    model = port_model(arch, "float32", ref["params"])
    vocab = model.cfg.vocab
    tokens = ref["batch"]["tokens"]
    logits, cache = model.prefill(dict(ref["batch"], max_seq=MAX_SEQ))
    out = {"model": model, "prefill": logits, "cache": cache}
    _, short = model.prefill({"tokens": tokens[:, :-1], "max_seq": MAX_SEQ})
    out["forced"] = model.decode_step(short, torch.from_numpy(tokens[:, -1]), S_LEN - 1)[0]
    tok = logits[:, :vocab].argmax(-1)
    out["ids"], out["decode"] = [tok.numpy()], []
    for i in range(STEPS):
        logits, cache = model.decode_step(cache, tok, S_LEN + i)
        tok = logits[:, :vocab].argmax(-1)
        out["decode"].append(logits)
        out["ids"].append(tok.numpy())
    out["final_cache"] = cache
    out["loss"], out["metrics"] = model.train_loss(ref["batch"])
    return out


def run_bf16(arch, params):
    """bfloat16 prefill logits, one decode step teacher-forced with the same
    token in both packages, and the loss."""
    cfg, api, params = reference_params(arch, "bfloat16", params)
    model = port_model(arch, "bfloat16", params)
    batch = make_batch(cfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    r_logits, r_cache = api.prefill(params, dict(jb, max_seq=S_LEN + 1))
    p_logits, p_cache = model.prefill(dict(batch, max_seq=S_LEN + 1))
    tok = np.asarray(jnp.argmax(r_logits[:, :cfg.vocab], axis=-1)).astype(np.int32)
    r_step, _ = api.decode_step(params, r_cache, jnp.asarray(tok), jnp.int32(S_LEN))
    p_step, _ = model.decode_step(p_cache, torch.from_numpy(tok), S_LEN)
    r_loss, _ = api.train_loss(params, jb)
    p_loss, _ = model.train_loss(batch)
    return {"prefill": (r_logits, p_logits), "decode": (r_step, p_step), "loss": (r_loss, p_loss)}


class Runs:
    """Each family's reference and port runs, computed once when first asked for."""

    def __init__(self):
        self.f32, self.bf16 = {}, {}

    def float32(self, arch):
        if arch not in self.f32:
            ref = run_reference(arch)
            self.f32[arch] = (ref, run_port(arch, ref))
        return self.f32[arch]

    def bfloat16(self, arch):
        if arch not in self.bf16:
            params = jax.tree.map(jnp.asarray, self.float32(arch)[0]["params"])
            self.bf16[arch] = run_bf16(arch, params)
        return self.bf16[arch]


@pytest.fixture(scope="module")
def runs():
    return Runs()


def test_smoke_configs_run_two_chunks_and_a_padded_shared_cache():
    """S = 16 is two chunks of 8 (and 15 tokens one chunk); zamba2's smoke
    config has two groups, so its shared block is reached twice, and a tail."""
    m1, m2 = get_smoke_config(ARCHS["ssm"]), get_smoke_config(ARCHS["hybrid"])
    assert m1.ssm_kind == "mamba1" and S_LEN // m1.scan_chunk == 2 and (S_LEN - 1) % m1.scan_chunk
    assert m2.ssm_kind == "mamba2" and S_LEN // m2.ssm_chunk == 2 and (S_LEN - 1) % m2.ssm_chunk
    assert m2.n_layers // m2.shared_attn_every == 2 and m2.n_layers % m2.shared_attn_every == 1
    assert MAX_SEQ > S_LEN


@pytest.mark.parametrize("family", ARCHS)
def test_prefill_logits_and_cache_equal_reference(runs, family):
    ref, port = runs.float32(ARCHS[family])
    assert tuple(port["prefill"].shape) == ref["prefill"].shape
    np.testing.assert_allclose(as_np(port["prefill"]), ref["prefill"], **TOL)
    assert_caches_close(ref["cache"], port["cache"])
    if family == "hybrid":  # the shared keys and values past S are the padding
        assert port["cache"]["shared_k"].shape[2] == MAX_SEQ
        assert not port["cache"]["shared_k"][:, :, S_LEN:].any()
        assert not port["cache"]["shared_v"][:, :, S_LEN:].any()


@pytest.mark.parametrize("family", ARCHS)
def test_teacher_forcing_from_one_chunk_equals_reference_and_prefill(runs, family):
    """A prefill of 15 tokens (one chunk) and a decode step with the 16th:
    equal to the reference's, and to the two-chunk prefill's logits."""
    ref, port = runs.float32(ARCHS[family])
    np.testing.assert_allclose(as_np(port["forced"]), ref["forced"], **TOL)
    np.testing.assert_allclose(as_np(port["forced"]), as_np(port["prefill"]), **TOL)


@pytest.mark.parametrize("family", ARCHS)
def test_greedy_decode_equals_reference(runs, family):
    ref, port = runs.float32(ARCHS[family])
    for step, (r_ids, p_ids) in enumerate(zip(ref["ids"], port["ids"])):
        np.testing.assert_array_equal(p_ids, r_ids, err_msg=f"greedy step {step}")
    for step, (r, p) in enumerate(zip(ref["decode"], port["decode"])):
        np.testing.assert_allclose(as_np(p), r, err_msg=f"decode step {step}", **TOL)
    assert_caches_close(ref["final_cache"], port["final_cache"])


@pytest.mark.parametrize("family", ARCHS)
def test_train_loss_equals_reference(runs, family):
    ref, port = runs.float32(ARCHS[family])
    np.testing.assert_allclose(as_np(port["loss"]), ref["loss"], **TOL)
    assert sorted(port["metrics"]) == sorted(ref["metrics"]) == ["xent"]
    np.testing.assert_allclose(as_np(port["metrics"]["xent"]), ref["metrics"]["xent"], **TOL)


@pytest.mark.parametrize("family", ARCHS)
def test_bfloat16_logits_within_measured_tolerance(runs, family):
    logits_atol, loss_atol = BF16_ATOL[family]
    got = runs.bfloat16(ARCHS[family])
    for what in ("prefill", "decode"):
        r, p = got[what]
        assert p.dtype == torch.float32
        np.testing.assert_allclose(as_np(p), as_np(r), rtol=0, atol=logits_atol, err_msg=what)
    r, p = got["loss"]
    np.testing.assert_allclose(as_np(p), as_np(r), rtol=0, atol=loss_atol)


@pytest.mark.parametrize("family", ARCHS)
def test_carried_weights_round_trip(runs, family):
    ref, port = runs.float32(ARCHS[family])
    back = params_to_jax(port["model"].cfg, port["model"])
    assert jax.tree.structure(back) == jax.tree.structure(ref["params"])
    for (path, leaf), got in zip(jax.tree_util.tree_leaves_with_path(ref["params"]), jax.tree.leaves(back)):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, leaf, err_msg=str(path))


def test_the_shared_attention_block_is_one_module():
    """zamba2's shared block has one set of weights: one module, reached
    after every group, and one leaf per weight in the carried tree."""
    model = build_model(port_smoke_config(ARCHS["hybrid"]), "meta")
    names = [n for n, _ in model.named_parameters() if "shared_attn" in n]
    assert names == ["shared_attn.ln.scale", "shared_attn.attn.wq", "shared_attn.attn.wk",
                     "shared_attn.attn.wv", "shared_attn.attn.wo"]
    assert sum(1 for m in model.modules() if m is model.shared_attn) == 1


# ---------------------------------------------------------------------------
# the state-space blocks: the reference's tests/test_ssm.py on the port
# ---------------------------------------------------------------------------

def mamba_cfg(cls, kind, chunk):
    """``tests/test_ssm.py``'s configs, in float32: the reference's test
    feeds float32 inputs to a bfloat16 config, and ``jnp.einsum`` promotes
    the bfloat16-cast weights to float32, where torch's matmul promotes
    nothing."""
    common = dict(n_layers=1, d_model=16, n_heads=1, n_kv_heads=1, d_head=8, d_ff=0, vocab=7, ssm_kind=kind,
                  d_state=4, expand=2, conv_dim=3, dtype="float32")
    if kind == "mamba1":
        return cls(name="m1", family="ssm", scan_chunk=chunk, **common)
    return cls(name="m2", family="hybrid", ssm_head_dim=8, ssm_chunk=chunk, **common)


MIXERS = {"mamba1": (S.Mamba1, S.mamba1_forward, S.mamba1_step, S.mamba1_init_state),
          "mamba2": (S.Mamba2, S.mamba2_forward, S.mamba2_step, S.mamba2_init_state)}


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_forward_equals_stepwise(kind, chunk):
    cls, forward, step, init_state = MIXERS[kind]
    cfg = mamba_cfg(ModelConfig, kind, chunk)
    p = cls(cfg, "cpu")
    p.draw(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    y_full, state_full = forward(p, x, cfg, return_state=True)
    state = init_state(cfg, 2)
    ys = []
    for t in range(16):
        y_t, state = step(p, x[:, t], state, cfg)
        ys.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.stack(ys, 1).numpy(), **STEPWISE_TOL)
    for leaf in ("ssm", "conv"):
        np.testing.assert_allclose(state_full[leaf].numpy(), state[leaf].numpy(), err_msg=leaf, **STEPWISE_TOL)


def ssd_inputs(seed=3, b=2, s=32, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"x": f(b, s, h, p), "dt": np.log1p(np.exp(f(b, s, h))), "a": -np.exp(f(h)),
            "b_t": f(b, s, n), "c_t": f(b, s, n)}


def test_ssd_chunk_invariance():
    """SSD output must not depend on the chunk size."""
    t = {k: torch.from_numpy(v) for k, v in ssd_inputs().items()}
    y8, h8 = S.ssd_chunked(**t, chunk=8)
    y32, h32 = S.ssd_chunked(**t, chunk=32)
    np.testing.assert_allclose(y8.numpy(), y32.numpy(), **TOL)
    np.testing.assert_allclose(h8.numpy(), h32.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the state-space blocks against the reference's functions
# ---------------------------------------------------------------------------

def both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.array(arr, copy=True))


def test_causal_conv1d_and_conv_step_equal_reference():
    rng = np.random.default_rng(4)
    (jx, tx), (jw, tw), (jb, tb) = (both(rng.normal(size=shape).astype(np.float32))
                                    for shape in ((2, 11, 6), (4, 6), (6,)))
    np.testing.assert_allclose(S.causal_conv1d(tx, tw, tb).numpy(), np.asarray(RS.causal_conv1d(jx, jw, jb)), **TOL)
    js, ts = both(rng.normal(size=(2, 3, 6)).astype(np.float32))
    want = RS.conv_step(js, jx[:, 0], jw, jb)
    got = S.conv_step(ts, tx[:, 0], tw, tb)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def carried_mixer(kind, chunk, seed=0):
    """The reference's ``init_mamba*`` weights and the port's module holding them."""
    cfg_r, cfg_p = mamba_cfg(RefConfig, kind, chunk), mamba_cfg(ModelConfig, kind, chunk)
    init = RS.init_mamba1 if kind == "mamba1" else RS.init_mamba2
    params = init(jax.random.key(seed), cfg_r)
    module = MIXERS[kind][0](cfg_p, "cpu")
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return cfg_r, params, cfg_p, module


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_mixer_forward_with_state_and_step_equal_reference(kind):
    """Four chunks of 4 in the forward; a step from a nonzero state."""
    cfg_r, params, cfg_p, module = carried_mixer(kind, 4)
    ref_fwd, ref_step = ((RS.mamba1_forward, RS.mamba1_step) if kind == "mamba1"
                         else (RS.mamba2_forward, RS.mamba2_step))
    _, fwd, step, _ = MIXERS[kind]
    jx, tx = both(np.random.default_rng(5).normal(size=(2, 16, cfg_p.d_model)).astype(np.float32))
    want_y, want_st = ref_fwd(params, jx, cfg_r, return_state=True)
    got_y, got_st = fwd(module, tx, cfg_p, return_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    assert_caches_close(jax.tree.map(np.asarray, want_st), got_st)
    want_y, want_st = ref_step(params, jx[:, -1], want_st, cfg_r)
    got_y, got_st = step(module, tx[:, -1], got_st, cfg_p)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    assert_caches_close(jax.tree.map(np.asarray, want_st), got_st)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_equals_reference(chunk):
    inputs = ssd_inputs(seed=6)
    want = RS.ssd_chunked(**{k: jnp.asarray(v) for k, v in inputs.items()}, chunk=chunk)
    got = S.ssd_chunked(**{k: torch.from_numpy(v) for k, v in inputs.items()}, chunk=chunk)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_hillis_steele_scan_equals_the_recurrence():
    """``_scan_linear`` over a chunk that is no power of two, against the
    plain loop h_t = a_t h_{t-1} + b_t, in float64."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3)))
    b = torch.from_numpy(rng.normal(size=(2, 13, 3)))
    a_cum, h = S._scan_linear(a, b)
    want_h, want_a = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64)
    for t in range(13):
        want_h = a[:, t] * want_h + b[:, t]
        want_a = want_a * a[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), want_h.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(a_cum[:, t].numpy(), want_a.numpy(), rtol=1e-12, atol=1e-12)


def test_short_prompt_conv_state_as_reference(runs):
    """A prompt shorter than ``conv_dim - 1`` leaves a short conv state in
    both packages (``x_in[:, s-kc+1:]``), and the next decode step raises in
    both: a caveat of the reference that the port copies."""
    arch = ARCHS["ssm"]
    ref, port = runs.float32(arch)
    cfg, api, params = reference_params(arch, "float32", jax.tree.map(jnp.asarray, ref["params"]))
    model = port["model"]
    tokens = np.array([[3, 5]], np.int32)
    _, r_cache = api.prefill(params, {"tokens": jnp.asarray(tokens)})
    _, p_cache = model.prefill({"tokens": tokens})
    assert r_cache["states"]["conv"].shape == tuple(p_cache["states"]["conv"].shape) == (2, 1, 1, cfg.d_inner)
    assert_caches_close(jax.tree.map(np.asarray, r_cache), p_cache)
    with pytest.raises(ValueError):
        api.decode_step(params, r_cache, jnp.array([1], jnp.int32), jnp.int32(2))
    with pytest.raises(RuntimeError):
        model.decode_step(p_cache, torch.tensor([1]), 2)
