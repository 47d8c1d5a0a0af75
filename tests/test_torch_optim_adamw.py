"""The port's ``AdamW`` against the reference's, on the CPU.

20 steps with clipping, weight decay and a schedule (and without) against
the reference's ``update`` on the same gradients, run eagerly, one XLA
operation at a time: parameters, ``m``, ``v`` and the gradient norm at
rtol 1e-6 (measured gap 1.2e-7: XLA's and torch's float32 ``pow`` and
reductions differ in the last bit); the update writes the parameters and
moments in place. Helpers from ``test_torch_optim.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import cosine_warmup as ref_cosine  # noqa: E402
from repro_torch.optim import AdamW, cosine_warmup  # noqa: E402
from test_torch_optim import RTOL, SHAPES, as_jax, as_torch, leaves, one_thread  # noqa: E402,F401


def run_adamw(ref_opt, port_opt, steps, grad_scale=lambda i: i + 1.0):
    p0 = leaves(0)
    rp, pp = as_jax(p0), as_torch(p0)
    rs, ps = ref_opt.init(rp), port_opt.init(pp)
    gns = []
    for i in range(steps):
        g = leaves(100 + i, scale=grad_scale(i))
        rp, rs, r_gn = ref_opt.update(as_jax(g), rs, rp)
        pp, ps, p_gn = port_opt.update(as_torch(g), ps, pp)
        gns.append((float(r_gn), float(p_gn)))
    return rp, rs, pp, ps, gns


@pytest.mark.parametrize(
    "kw",
    [dict(weight_decay=0.1, max_grad_norm=1.0, sched=(1e-2, 5, 20)),
     dict(weight_decay=0.0, max_grad_norm=0.0, lr=3e-3),
     dict(weight_decay=0.01, max_grad_norm=50.0, sched=(1e-3, 10, 30), b2=0.999)],
    ids=["clip-decay-schedule", "plain-constant", "loose-clip-b2"],
)
def test_adamw_20_steps_equal_reference(kw):
    kw = dict(kw)
    sched = kw.pop("sched", None)
    lr = kw.pop("lr", None)
    ref = RefAdamW(learning_rate=ref_cosine(*sched) if sched else lr, **kw)
    port = AdamW(learning_rate=cosine_warmup(*sched) if sched else lr, **kw)
    p0 = leaves(0)
    rp, rs, pp, ps, gns = run_adamw(ref, port, 20)
    for k in SHAPES:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=RTOL, atol=RTOL * np.abs(p0[k]).max())
        np.testing.assert_allclose(ps["m"][k].numpy(), np.asarray(rs["m"][k]), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(rs["m"][k])).max())
        np.testing.assert_allclose(ps["v"][k].numpy(), np.asarray(rs["v"][k]), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(rs["v"][k])).max())
        assert ps["m"][k].dtype == torch.float32 and ps["v"][k].dtype == torch.float32
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == int(rs["step"]) == 20
    for r_gn, p_gn in gns:
        np.testing.assert_allclose(p_gn, r_gn, rtol=RTOL)
    if not kw["max_grad_norm"]:
        assert all(p_gn == 0.0 for _, p_gn in gns)


def test_adamw_updates_parameters_in_place():
    params = as_torch(leaves(0))
    before = {k: (t.data_ptr(), t.clone()) for k, t in params.items()}
    opt = AdamW(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=1.0)
    state = opt.init(params)
    m_ptrs = {k: t.data_ptr() for k, t in state["m"].items()}
    new_p, new_state, _ = opt.update(as_torch(leaves(1)), state, params)
    assert new_p is params
    for k, (ptr, old) in before.items():
        assert params[k].data_ptr() == ptr and not torch.equal(params[k], old)
        assert new_state["m"][k].data_ptr() == m_ptrs[k]
