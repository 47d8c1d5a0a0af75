"""Each package's training loop resumes from the other's snapshots, on the CPU.

From the reference's ``init`` weights of the toy setup of
``test_torch_trainer.py`` (carried by ``params_from_jax``), in float32 (in
bfloat16 the two packages' losses differ by up to 3.5e-3,
``test_torch_models.py``), with AdamW and with
``ErrorFeedbackInt8(AdamW)``: 10 steps of each package's Trainer give
equal losses at rtol = atol = 1e-4; the reference's Trainer resumes from
the port's snapshot at step 10, and the port's from the reference's, and
each continues the writer's own run over steps 11-15 at 1e-4. The resumed
weights equal the snapshot's bit for bit, and the port's snapshot has the
reference's keys, shapes and dtypes. The reference's train step is
compiled once per optimizer (``jax.jit``) and shared by its Trainers;
paths come from ``tmp_path_factory`` and ``tmp_path``.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim.compression import ErrorFeedbackInt8 as RefEF  # noqa: E402
from repro.runtime import Trainer as RefTrainer  # noqa: E402
from repro.runtime import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402
from test_torch_trainer import ARCH, TOL, fixed_batch, one_thread, port_setup, weights  # noqa: E402,F401

REF_OPTS = {  # the reference's counterparts of test_torch_trainer.OPTS
    "adamw": lambda: RefAdamW(learning_rate=3e-3, max_grad_norm=1.0),
    "ef-int8": lambda: RefEF(RefAdamW(learning_rate=3e-3, max_grad_norm=1.0)),
}


def ref_trainer(ckpt_dir, weights, step_fn, opt, ckpt_every=5):
    batch = fixed_batch(get_smoke_config(ARCH))

    def init_state():
        params = jax.tree.map(jnp.asarray, weights)
        return params, opt.init(params)

    return RefTrainer(step_fn, init_state, itertools.repeat(batch),
                      RefTrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every))


def losses(hist):
    return np.array([h["loss"] for h in hist])


@pytest.fixture(scope="module", params=list(REF_OPTS))
def cross(request, weights, tmp_path_factory):
    """Both packages' runs with one optimizer: 15 steps each uninterrupted;
    10 steps of one, then 5 of the other resumed from its snapshot."""
    kind = request.param
    root = tmp_path_factory.mktemp(f"cross-{kind}")
    opt = REF_OPTS[kind]()
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    step_fn = jax.jit(ref_make_train_step(ref_build_model(cfg), opt))
    out = {"kind": kind}

    out["ref"] = losses(ref_trainer(root / "ref", weights, step_fn, opt).run(15))
    out["port"] = losses(Trainer(*port_setup(root / "port", weights, kind, dtype="float32")).run(15))

    ref_first = ref_trainer(root / "ref_then_port", weights, step_fn, opt)
    ref_first.run(10)
    port_next = Trainer(*port_setup(root / "ref_then_port", weights, kind, dtype="float32"))
    out["port_resumed_at"] = port_next.step
    out["port_resumed_params"] = {k: v.clone() for k, v in port_next.model.state_dict().items()}
    out["port_resumed_opt_step"] = int((port_next.opt_state.get("inner") or port_next.opt_state)["step"])
    out["ref_snapshot"] = CheckpointStore(root / "ref_then_port").load_raw(10)[0]
    out["port_after_ref"] = losses(port_next.run(5))

    port_first = Trainer(*port_setup(root / "port_then_ref", weights, kind, dtype="float32"))
    port_first.run(10)
    ref_next = ref_trainer(root / "port_then_ref", weights, step_fn, opt)
    out["ref_resumed_at"] = ref_next.step
    out["ref_after_port"] = losses(ref_next.run(5))
    return out


def test_both_trainers_give_equal_losses_for_10_steps(cross):
    assert len(cross["ref"]) == len(cross["port"]) == 15
    np.testing.assert_allclose(cross["port"][:10], cross["ref"][:10], **TOL)
    assert cross["port"][9] < cross["port"][0]


def test_reference_trainer_resumes_from_a_port_snapshot(cross):
    assert cross["ref_resumed_at"] == 10
    np.testing.assert_allclose(cross["ref_after_port"], cross["port"][10:], **TOL)


def test_port_trainer_resumes_from_a_reference_snapshot(cross):
    assert cross["port_resumed_at"] == 10 and cross["port_resumed_opt_step"] == 10
    cfg = port_smoke_config(ARCH)
    snap = cross["ref_snapshot"]
    tree = {}
    for key, arr in snap.items():
        if key.startswith("params/"):
            node = tree
            *path, last = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[last] = arr
    want = params_from_jax(cfg, tree)
    assert sorted(want) == sorted(cross["port_resumed_params"])
    for name, t in want.items():
        assert torch.equal(cross["port_resumed_params"][name], t), name
    np.testing.assert_allclose(cross["port_after_ref"], cross["ref"][10:], **TOL)


def test_port_snapshot_holds_the_reference_layout(cross, tmp_path, weights):
    """The port's snapshot has the reference's keys, shapes and dtypes."""
    opt = REF_OPTS[cross["kind"]]()
    params = jax.tree.map(jnp.asarray, weights)
    want = jax.tree_util.tree_flatten_with_path({"params": params, "opt": opt.init(params)})[0]
    want = {"/".join(str(p.key) for p in path): (tuple(x.shape), np.dtype(x.dtype)) for path, x in want}
    tr = Trainer(*port_setup(tmp_path / "ckpt", weights, cross["kind"]))
    tr.save()
    got, _ = CheckpointStore(tmp_path / "ckpt").load_raw(0)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == want
