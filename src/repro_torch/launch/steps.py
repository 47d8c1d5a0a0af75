"""Step builders (the counterpart of ``repro.launch.steps``).

The port's model holds its own parameters, so a step takes no ``params``:
``train_step(opt_state, batch) -> (opt_state, metrics)`` updates the
model's parameters in place, and the serving steps read them.
``batch_struct``, ``abstract_state``, ``abstract_cache`` and
``decode_inputs`` belong to the TPU launch tooling and wait for ROADMAP A15.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import Model


def make_train_step(model: Model, opt) -> Callable:
    """One optimizer step of ``opt`` (``AdamW``, or a wrapper with its
    ``init``/``update``) on ``model.train_loss``; its gradients come from
    autograd. Turns gradients on for the model's parameters (they are made
    without), once, here. ``metrics`` holds ``loss``, ``grad_norm`` and
    ``train_loss``'s own entries, detached, on the model's device."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(opt_state, batch):
        loss, metrics = model.train_loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        _, opt_state, gn = opt.update(dict(zip(params, grads)), opt_state, params)
        out = {"loss": loss.detach(), "grad_norm": gn}
        out.update({k: v.detach() for k, v in metrics.items()})
        return opt_state, out

    return train_step


def make_prefill_step(model: Model, max_seq: int) -> Callable:
    def prefill_step(batch):
        return model.prefill(dict(batch, max_seq=max_seq))

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return decode_step
