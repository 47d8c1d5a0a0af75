"""The port's model plane around the models, against the reference, on the CPU.

* Every full configuration of the ten builds on the meta device, and its
  parameter names and shapes map one to one onto the leaves of the
  reference's ``jax.eval_shape(api.init)`` (no memory either side).
* ``build_model`` builds the state-space families' smoke configs on the CPU
  and on the meta device.
* ``core/param_sync``: the reference's four ``tests/test_param_sync.py``
  scenarios on both packages, with equal rows, values, byte counts and
  savings.
* ``Verbalizer`` and ``ReplicaTokenPipeline``: the same τ from the port's
  ``IrapEngine`` and the reference's on a small ``DBpediaLikeGenerator``
  stream gives the same tokens and the same batches.
* ``launch/serve``: ``main`` on the CPU equals the port's own prefill and
  greedy decode loop, for a dense, an encoder-decoder and both state-space
  families.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import param_sync as ref_sync  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import param_sync  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import iter_port_leaves  # noqa: E402

ATTENTION_ARCHS = [a for a in configs.ARCH_NAMES
                   if configs.get_config(a).family not in ("ssm", "hybrid")]
STATE_SPACE_ARCHS = [a for a in configs.ARCH_NAMES if a not in ATTENTION_ARCHS]


def test_the_registry_is_a_copy_of_the_reference():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert len(ATTENTION_ARCHS) == 8 and len(STATE_SPACE_ARCHS) == 2
    for arch in configs.ARCH_NAMES:
        for get, ref_get in ((configs.get_config, ref_configs.get_config),
                             (configs.get_smoke_config, ref_configs.get_smoke_config)):
            assert vars(get(arch)) == vars(ref_get(arch)), arch


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_full_config_builds_on_meta_and_maps_onto_reference_leaves(arch):
    cfg = configs.get_config(arch)
    model = build_model(cfg, device="meta")
    port = {name: (tuple(t.shape), t.dtype) for name, t in model.state_dict().items()}
    assert all(t.is_meta for t in model.state_dict().values())

    api = ref_build_model(ref_configs.get_config(arch))
    shapes = jax.eval_shape(lambda: api.init(jax.random.key(0)))
    # zero-stride views stand in for the leaves: their slices have the shapes
    views = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    mapped = {}
    for name, view in iter_port_leaves(cfg, views):
        assert name not in mapped, name
        mapped[name] = (tuple(view.shape), getattr(torch, view.dtype.name))
    assert mapped == port
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(t.numel() for t in model.state_dict().values()) == n_ref


@pytest.mark.parametrize("arch", STATE_SPACE_ARCHS)
def test_build_model_builds_the_state_space_families(arch):
    from repro_torch.models import Hybrid, Ssm

    cfg = configs.get_smoke_config(arch)
    want = Ssm if cfg.family == "ssm" else Hybrid
    on_meta = build_model(cfg, device="meta")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert type(on_meta) is type(model) is want
    assert all(t.is_meta for t in on_meta.state_dict().values())
    assert {n: t.shape for n, t in on_meta.state_dict().items()} == {n: t.shape for n, t in model.state_dict().items()}
    assert not any(p.requires_grad for p in model.parameters())
    logits, cache = model.prefill({"tokens": np.zeros((1, 4), np.int32), "max_seq": 6})
    assert tuple(logits.shape) == (1, cfg.padded_vocab) and bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    assert sorted(cache) == sorted(model.init_cache(1, 6))


def test_build_model_targets_the_card_by_default():
    cfg = configs.get_smoke_config("internlm2-1.8b")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_model(cfg)


# ---------------------------------------------------------------------------
# param_sync: the reference's four scenarios, in both packages
# ---------------------------------------------------------------------------

def scenario_roundtrip(m, xp):
    old = xp.zeros((16, 8))
    new = xp.put_rows(old, [3, 7, 11], 1.5)
    cs = m.diff_bank("experts", old, new)
    return {"cs": [cs], "rebuilt": m.apply_changeset(old, cs), "want": new}


def scenario_interest(m, xp):
    rng = np.random.default_rng(0)
    source = xp.array(rng.normal(size=(32, 16)))
    replica = m.ParamReplica(banks={"experts": source}, interests={"experts": xp.arange(0, 32, 2)})
    new = xp.add_rows(source, [2, 3, 4, 5], 1.0)
    cs = m.diff_bank("experts", source, new)
    replica.receive(cs)
    return {"cs": [cs], "replicas": [replica], "source": source, "new": new}


def scenario_mirror(m, xp):
    source = xp.zeros((4, 4))
    replica = m.ParamReplica(banks={"w": source}, interests={"w": None})
    new = source + 2.0
    cs = m.diff_bank("w", source, new)
    replica.receive(cs)
    return {"cs": [cs], "replicas": [replica], "new": new}


def scenario_moe(m, xp):
    rng = np.random.default_rng(1)
    e, d = 8, 4
    bank = xp.array(rng.normal(size=(e, d)))
    r1 = m.ParamReplica({"experts": bank}, {"experts": xp.arange(0, 4)})
    r2 = m.ParamReplica({"experts": bank}, {"experts": xp.arange(4, 8)})
    cur, sent = bank, []
    for _ in range(5):
        upd = xp.array(rng.normal(size=(e, d)) * (rng.random((e, 1)) < 0.4))
        new = cur + upd
        cs = m.diff_bank("experts", cur, new)
        r1.receive(cs)
        r2.receive(cs)
        sent.append(cs)
        cur = new
    return {"cs": sent, "replicas": [r1, r2], "cur": cur}


class Jx:
    zeros = staticmethod(lambda shape: jnp.zeros(shape))
    array = staticmethod(lambda a: jnp.asarray(a, jnp.float32))
    arange = staticmethod(jnp.arange)
    put_rows = staticmethod(lambda x, rows, v: x.at[jnp.array(rows)].set(v))
    add_rows = staticmethod(lambda x, rows, v: x.at[jnp.array(rows)].add(v))


class Tx:
    zeros = staticmethod(lambda shape: torch.zeros(shape))
    array = staticmethod(lambda a: torch.as_tensor(a, dtype=torch.float32))
    arange = staticmethod(torch.arange)

    @staticmethod
    def put_rows(x, rows, v):
        x = x.clone()
        x[rows] = v
        return x

    @staticmethod
    def add_rows(x, rows, v):
        x = x.clone()
        x[rows] += v
        return x


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


SCENARIOS = {"roundtrip": scenario_roundtrip, "interest": scenario_interest,
             "mirror": scenario_mirror, "moe": scenario_moe}


@pytest.mark.parametrize("name", SCENARIOS)
def test_param_sync_scenario_equals_reference(name):
    want = SCENARIOS[name](ref_sync, Jx)
    got = SCENARIOS[name](param_sync, Tx)
    for w, g in zip(want["cs"], got["cs"], strict=True):
        assert g.bank == w.bank
        assert g.rows.dtype == torch.int32
        np.testing.assert_array_equal(host(g.rows), host(w.rows))
        np.testing.assert_array_equal(host(g.values), host(w.values))
        assert g.nbytes == w.nbytes
    for w, g in zip(want.get("replicas", []), got.get("replicas", []), strict=True):
        assert (g.bytes_offered, g.bytes_received, g.savings) == (w.bytes_offered, w.bytes_received, w.savings)
        for bank in w.banks:
            np.testing.assert_array_equal(host(g.banks[bank]), host(w.banks[bank]))
    # and the reference test's own assertions, on the port
    if name == "roundtrip":
        assert sorted(host(got["cs"][0].rows).tolist()) == [3, 7, 11]
        np.testing.assert_array_equal(host(got["rebuilt"]), host(got["want"]))
    elif name == "interest":
        bank = host(got["replicas"][0].banks["experts"])
        source, new = host(got["source"]), host(got["new"])
        for e in range(32):
            np.testing.assert_array_equal(bank[e], new[e] if e in (2, 4) else source[e])
        assert 0.4 < got["replicas"][0].savings < 0.6
    elif name == "mirror":
        np.testing.assert_array_equal(host(got["replicas"][0].banks["w"]), host(got["new"]))
        assert got["replicas"][0].savings == 0.0
    else:
        r1, r2 = got["replicas"]
        cur = host(got["cur"])
        np.testing.assert_array_equal(host(r1.banks["experts"])[:4], cur[:4])
        np.testing.assert_array_equal(host(r2.banks["experts"])[4:], cur[4:])


# ---------------------------------------------------------------------------
# replica -> verbalizer -> batches
# ---------------------------------------------------------------------------

FOOTBALL = [("?f", "rdf:type", "dbo:SoccerPlayer"), ("?f", "foaf:name", "?n"),
            ("?f", "dbo:team", "?t"), ("?t", "rdfs:label", "?tn")]


def replica_batches(core, data, **engine_kw):
    """test_substrate.py's replica pipeline: a generator stream through a
    Football subscription, verbalized into three batches."""
    gen = data.DBpediaLikeGenerator(data.GeneratorConfig(
        n_athletes=30, n_places=10, n_other=40, n_teams=6,
        adds_per_changeset=30, removes_per_changeset=10, seed=1))
    gen.initial_dump()
    engine = core.IrapEngine(gen.dict, **engine_kw)
    caps = core.StepCapacities(n_removed=64, n_added=64, tau=512, rho=512, pulls=1024, fanout=8)
    init = gen.slice_for(lambda t: t[0].startswith("dbr:Athlete") or t[0].startswith("dbr:Team"))
    sub = engine.register_interest(core.InterestExpr.parse("g", "t", bgp=FOOTBALL), caps,
                                   initial_target=init)
    for d_np, a_np in gen.stream(2):
        sub.apply(d_np, a_np)
    verb = data.Verbalizer(vocab=997, dictionary=gen.dict)
    pipe = data.ReplicaTokenPipeline(verb, batch_size=4, seq_len=32, seed=3, worker=1, n_workers=2)
    pipe.refresh(sub.tau)
    return core.to_numpy(sub.tau), verb.triples_to_tokens(core.to_numpy(sub.tau)), [next(pipe) for _ in range(3)]


def test_replica_tokens_and_batches_equal_reference():
    from repro import core as ref_core
    from repro import data as ref_data
    from repro_torch import core
    from repro_torch import data

    r_tau, r_tokens, r_batches = replica_batches(ref_core, ref_data)
    p_tau, p_tokens, p_batches = replica_batches(core, data, device="cpu")
    assert r_tau.shape[0] > 50
    np.testing.assert_array_equal(p_tau, r_tau)
    assert p_tokens.dtype == r_tokens.dtype == np.int32
    np.testing.assert_array_equal(p_tokens, r_tokens)
    for r, p in zip(r_batches, p_batches, strict=True):
        assert sorted(p) == sorted(r) == ["labels", "tokens"]
        for k in r:
            assert p[k].shape == (4, 32) and p[k].dtype == r[k].dtype
            np.testing.assert_array_equal(p[k], r[k])
        assert p["tokens"].max() < 997


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-medium", "falcon-mamba-7b", "zamba2-7b"])
def test_serve_main_equals_the_ports_own_loop(arch, capsys):
    from repro_torch.launch import serve

    b, s, gen = 2, 8, 5
    got = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", str(b),
                      "--prompt-len", str(s), "--gen", str(gen)])
    printed = capsys.readouterr().out
    assert f"generated token ids (first sequence): {got[0].tolist()}" in printed

    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "max_seq": s + gen}
    if cfg.family == "encdec":
        batch["enc_embed"] = np.zeros((b, cfg.enc_seq, cfg.d_model), np.float32)
    logits, cache = model.prefill(batch)
    ids = [logits[:, :cfg.vocab].argmax(-1)]
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, ids[-1], s + i)
        ids.append(logits[:, :cfg.vocab].argmax(-1))
    assert got.shape == (b, gen)
    np.testing.assert_array_equal(got, torch.stack(ids, 1).numpy())
