"""Serving step builders (the counterpart of ``repro.launch.steps``).

The port's model holds its own parameters, so a step takes no ``params``.
``make_train_step``, ``batch_struct``, ``abstract_state``, ``abstract_cache``
and ``decode_inputs`` belong to training and to the TPU launch tooling, and
wait for ROADMAP A14c and A15.
"""
from __future__ import annotations

from typing import Callable

from ..models import Model


def make_prefill_step(model: Model, max_seq: int) -> Callable:
    def prefill_step(batch):
        return model.prefill(dict(batch, max_seq=max_seq))

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return decode_step
