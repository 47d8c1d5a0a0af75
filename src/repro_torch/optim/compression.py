"""Gradient compression: error-feedback int8 quantization (the counterpart of
``repro.optim.compression``).

Two entry points:
  * :class:`ErrorFeedbackInt8` — a wrapper around any optimizer with the
    ``init``/``update`` of :class:`~repro_torch.optim.AdamW`: gradients are
    quantized to int8 (one scale a leaf) before the update, and the
    quantization residual is carried to the next step (Karimireddy et al.,
    "EF-SGD"). What the update sees is what a decompress-after-reduce would
    give.
  * :func:`compressed_psum` — the collective form inside
    :func:`~repro_torch.core.distributed.run_spmd`: quantize, sum the int8
    payloads as int32 and the scales in float32 across the mesh, dequantize
    with the mean scale. The mesh has no sum of its own: every shard
    gathers every shard's part and adds them in shard order.

``torch.round`` rounds half to even, as ``jnp.round`` does; the scale is
divided by device tensors, so ``q`` and ``scale`` are the same on the card
and on the CPU for the same float32 input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..core.distributed import all_gather
from .schedule import _f32


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / _f32(127.0, g32)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, axis_name: str) -> torch.Tensor:
    """int8-compressed mean-reduce of ``g`` across the mesh axis ``axis_name``
    (inside ``run_spmd``). Payloads move as int8, widened to int32 for the
    sum; each shard contributed about ``q * scale``, and the sum is
    approximated with the mean scale."""
    q, scale = quantize_int8(g)
    qs = all_gather(q, axis_name)
    n = qs.shape[0]
    total = qs.to(torch.int32).sum(0, dtype=torch.int32)
    scale_sum = all_gather(scale, axis_name).sum(0)
    nf = _f32(n, scale)
    return total.float() * (scale_sum / nf) / nf


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackInt8:
    """opt wrapper: grads -> EF-int8 -> inner optimizer."""

    inner: Any  # AdamW-like: init/update

    def init(self, params):
        return {
            "inner": self.inner.init(params),
            "residual": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        deq, resid = {}, {}
        for k, g in grads.items():
            corrected = g.float() + state["residual"][k]
            q, scale = quantize_int8(corrected)
            deq[k] = dequantize_int8(q, scale)
            resid[k] = corrected.sub_(deq[k])
        new_p, inner_state, gn = self.inner.update(deq, state["inner"], params)
        return new_p, {"inner": inner_state, "residual": resid}, gn
