"""Learning-rate schedules (the counterpart of ``repro.optim.schedule``).

A schedule maps the optimizer's step, a Python int or a 0-d tensor, to a
0-d float32 tensor on the step's device (the CPU for an int). The
arithmetic is the reference's, in float32 and in its order: Python floats
enter each operation as float32 scalars, as ``jnp`` takes weakly typed
ones. Every divisor is a tensor on the step's device, so that a card
divides as the CPU does (torch multiplies by the reciprocal of a host
scalar on CUDA). The cosine is taken in float64 and rounded to float32: XLA's float32
``cos`` differs from that value by one ulp at 1.4% of arguments in
[0, pi], torch's float32 ``cos`` at 4.8%, so the learning rates equal the
reference's at almost every step and are one ulp away at the others.
"""
from __future__ import annotations

import math

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr, _step(step))


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = _step(step)
        warm = _f32(peak, s) * s / _f32(max(warmup, 1), s)
        prog = torch.clamp((s - _f32(warmup, s)) / _f32(max(total - warmup, 1), s), 0.0, 1.0)
        cos_pi = torch.cos((_f32(math.pi, s) * prog).double()).float()
        cos = _f32(floor, s) + _f32(0.5 * (peak - floor), s) * (1 + cos_pi)
        return torch.where(s < warmup, warm, cos)

    return f
