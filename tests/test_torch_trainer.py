"""The port's training loop against the reference's, on the CPU.

* The reference's ``tests/test_substrate.py`` trainer checks on the port,
  with its ``_toy_setup`` (internlm2's smoke config, one memorisable 4 x 16
  batch, AdamW at 3e-3 with clipping, a snapshot every 5 steps): the loss
  falls, a failure injected at step 17 resumes at 15, and straggler
  detection runs on a scripted clock (no sleep, no wall clock): a step of
  1 s among steps of 10 ms is the first and only straggler, and none is
  flagged before the window holds 5 steps.
* Cross-package resume: ``test_torch_trainer_cross.py``.
* ``tests/test_system.py``'s flow on the port: a stream through an
  ``IrapEngine`` subscription checked against the oracle, the replica
  verbalized into a batch, one train step and a checkpoint round trip.
* ``launch/train.main`` on the CPU with ``--smoke`` and a ``tmp_path``
  checkpoint directory: a failure injected at step 7, then a run that
  resumes at the step-5 snapshot; ``build_data``'s first 10 batches equal
  the reference's ``build_data``'s. The 50th batch, which applies a
  changeset to the subscription first, is left to ``chip_smoke.py``'s
  training phase on the card: the plain versions take ~25 s of one CPU
  core for it. The reference's ``main`` is never called: it reads
  ``sys.argv`` and writes outside ``tmp_path``.

Paths come from ``tmp_path`` only. The trainer files hold at most 8 tests
each: ``--dist loadfile`` queues files with more tests first, and files of
fewer tests than ``tests/test_substrate.py`` leave the queue before it, and
so the timing of its ``test_straggler_detection``, as they were.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch.train import build_data as ref_build_data  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke_config  # noqa: E402
from repro_torch.core import InterestExpr, IrapEngine, StepCapacities, to_set  # noqa: E402
from repro_torch.core.interest import compile_interest  # noqa: E402
from repro_torch.core.oracle import OracleEvaluator  # noqa: E402
from repro_torch.data import DBpediaLikeGenerator, GeneratorConfig, ReplicaTokenPipeline, Verbalizer  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.compression import ErrorFeedbackInt8  # noqa: E402
from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig  # noqa: E402

ARCH = "internlm2-1.8b"
TOL = dict(rtol=1e-4, atol=1e-4)
OPTS = {  # the port's optimizers of the toy setup
    "adamw": lambda: AdamW(learning_rate=3e-3, max_grad_norm=1.0),
    "ef-int8": lambda: ErrorFeedbackInt8(AdamW(learning_rate=3e-3, max_grad_norm=1.0)),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def fixed_batch(cfg):
    rng = np.random.default_rng(0)
    return {
        "tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def weights():
    """The reference's ``init`` weights of the toy model (seed 0), as numpy."""
    api = ref_build_model(get_smoke_config(ARCH))
    return jax.tree.map(np.asarray, jax.jit(api.init)(jax.random.key(0)))


def port_setup(ckpt_dir, weights, opt_kind="adamw", ckpt_every=5, dtype=None):
    """The reference's ``_toy_setup`` on the port: (step, init_state, data, cfg)."""
    cfg = port_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
    model = build_model(cfg, "cpu")
    opt = OPTS[opt_kind]()

    def init_state():
        model.load_state_dict(params_from_jax(cfg, weights))
        return model, opt.init(dict(model.named_parameters()))

    tc = TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every)
    return make_train_step(model, opt), init_state, itertools.repeat(fixed_batch(cfg)), tc


class ScriptedClock:
    """A clock the test advances: each step takes ``dt`` of it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# the reference's trainer checks on the port
# ---------------------------------------------------------------------------
def test_trainer_loss_decreases(tmp_path, weights):
    tr = Trainer(*port_setup(tmp_path / "ckpt", weights))
    hist = tr.run(25)
    assert [h["step"] for h in hist] == list(range(1, 26))
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.9


def test_failure_injection_and_restart(tmp_path, weights):
    tr = Trainer(*port_setup(tmp_path / "ckpt", weights))
    with pytest.raises(SimulatedFailure):
        tr.run(30, inject_failure_at=17)
    loss_at_fail = tr.history[-1]["loss"]
    assert CheckpointStore(tmp_path / "ckpt").steps() == [5, 10, 15]

    # a new trainer process: resumes from step 15 (the last snapshot), not 0
    tr2 = Trainer(*port_setup(tmp_path / "ckpt", weights))
    assert tr2.step == 15
    hist = tr2.run(10)
    assert hist[0]["step"] == 16
    assert hist[-1]["loss"] < loss_at_fail * 1.1


@pytest.mark.parametrize("slow_after, first_event", [(14, 15), (3, None)])
def test_straggler_detection_on_a_scripted_clock(tmp_path, weights, slow_after, first_event):
    """A 1 s step after step ``slow_after`` among 10 ms steps: a straggler
    once the window holds 5 steps, never before."""
    clock = ScriptedClock()
    events = []
    tr = Trainer(*port_setup(tmp_path / "ckpt", weights), on_straggler=lambda s, dt: events.append((s, dt)),
                 clock=clock)
    inner = tr.step_fn

    def timed_step(opt_state, batch):
        clock.t += 1.0 if tr.step == slow_after else 0.01
        return inner(opt_state, batch)

    tr.step_fn = timed_step
    hist = tr.run(20)
    dts = [h["dt"] for h in hist]
    np.testing.assert_allclose(dts, [1.0 if h["step"] == slow_after + 1 else 0.01 for h in hist], rtol=1e-9)
    if first_event is None:
        assert tr.straggler_events == [] and events == []
    else:
        assert [e["step"] for e in tr.straggler_events] == [first_event]
        assert tr.straggler_events[0]["median"] == pytest.approx(0.01)
        assert [s for s, _ in events] == [first_event]


# ---------------------------------------------------------------------------
# the system's flow on the port (tests/test_system.py)
# ---------------------------------------------------------------------------
def test_end_to_end_system_on_the_port(tmp_path):
    gen = DBpediaLikeGenerator(GeneratorConfig(
        n_athletes=40, n_places=15, n_other=60, n_teams=8,
        adds_per_changeset=50, removes_per_changeset=20, seed=42))
    gen.initial_dump()
    engine = IrapEngine(gen.dict, device="cpu")
    expr = InterestExpr.parse(
        "g", "t",
        bgp=[("?f", "rdf:type", "dbo:SoccerPlayer"),
             ("?f", "foaf:name", "?n"),
             ("?f", "dbo:team", "?t"),
             ("?t", "rdfs:label", "?tn")],
    )
    caps = StepCapacities(n_removed=256, n_added=512, tau=8192, rho=8192,
                          pulls=8192, fanout=8, dedup_candidates=1024)
    sub = engine.register_interest(
        expr, caps,
        initial_target=gen.slice_for(lambda t: t[0].startswith(("dbr:Athlete", "dbr:Team"))),
    )
    orc = OracleEvaluator(compile_interest(expr, gen.dict))
    for i, (d_np, a_np) in enumerate(gen.stream(3)):
        tau_before, rho_before = to_set(sub.tau), to_set(sub.rho)
        sub.apply(d_np, a_np)
        o = orc.step({tuple(map(int, r)) for r in d_np}, {tuple(map(int, r)) for r in a_np},
                     tau_before, rho_before)
        assert to_set(sub.tau) == o["tau1"], f"changeset {i} τ mismatch"
        assert to_set(sub.rho) == o["rho1"], f"changeset {i} ρ mismatch"
    assert int(sub.tau.n) > 50

    verb = Verbalizer(vocab=97, dictionary=gen.dict)
    pipe = ReplicaTokenPipeline(verb, batch_size=2, seq_len=16)
    pipe.refresh(sub.tau)
    batch = next(pipe)

    cfg = port_smoke_config(ARCH)
    model = build_model(cfg, "cpu").init(torch.Generator("cpu").manual_seed(0))
    opt = AdamW(learning_rate=1e-3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = make_train_step(model, opt)(opt.init(dict(model.named_parameters())), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())

    tr = Trainer(lambda s, b: (s, {}), lambda: (model, state), iter(()), TrainerConfig(ckpt_dir=str(tmp_path)))
    tr.step = 1
    tr.save()
    fresh = build_model(cfg, "cpu")
    restored = Trainer(lambda s, b: (s, {}), lambda: (fresh, opt.init(dict(fresh.named_parameters()))),
                       iter(()), TrainerConfig(ckpt_dir=str(tmp_path)))
    assert restored.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v)
        assert bool(torch.isfinite(v).all())
    assert int(restored.opt_state["step"]) == 1


# ---------------------------------------------------------------------------
# launch/train
# ---------------------------------------------------------------------------
def test_launch_train_main_fails_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    with pytest.raises(SimulatedFailure):
        port_train.main(argv + ["--steps", "12", "--inject-failure-at", "7"])
    assert CheckpointStore(tmp_path).steps() == [5]
    hist = port_train.main(argv + ["--steps", "5"])
    assert [h["step"] for h in hist] == [6, 7, 8, 9, 10]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "resume_step=5" in capsys.readouterr().out


def test_build_data_batches_equal_reference():
    ref_cfg, cfg = get_smoke_config(ARCH), port_smoke_config(ARCH)
    ref_it, port_it = ref_build_data(ref_cfg, 4, 64), port_train.build_data(cfg, 4, 64, device="cpu")
    for _ in range(10):
        want, got = next(ref_it), next(port_it)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got["tokens"].shape == (4, 64) and got["tokens"].max() < cfg.vocab
