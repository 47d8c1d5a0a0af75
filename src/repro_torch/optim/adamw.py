"""AdamW with decoupled weight decay and global-norm clipping (the
counterpart of ``repro.optim.adamw``).

Parameters, gradients and the moments are flat dicts keyed by the port's
parameter names (``dict(model.named_parameters())``); ``models/convert.py``
maps such a dict to the reference's stacked pytree and back, so the state
checkpoints in the reference's layout. The state is the reference's:
``{"m": float32 moments, "v": float32 moments, "step": int32}``, on the
parameters' device.

The arithmetic is the reference's, operation by operation: ``delta`` adds
``weight_decay * p`` to the Adam direction (``torch.optim.AdamW`` instead
scales ``p`` by ``1 - lr * weight_decay`` first). ``update`` runs under
``torch.no_grad()`` and writes the parameters and the moments in place, one
parameter at a time, so that no whole copy of the model's gradients or
moments is made.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch

from .schedule import _f32

Tensors = Mapping[str, torch.Tensor]


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(gn, 1e-9)), as a float32 0-d tensor."""
    return torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9), max=1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """``g`` times ``scale`` in float32, rounded to ``g``'s dtype; float32 out."""
    if scale is None:
        return g.float()
    return (g.float() * scale).to(g.dtype).float()


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 0.0  # 0 = no clipping

    def init(self, params: Tensors):
        device = next(iter(params.values())).device if params else torch.device("cpu")
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return _f32(self.learning_rate, step)

    @torch.no_grad()
    def update(self, grads: Tensors, state, params: Tensors):
        """Returns (params, new_state, grad_norm); ``params`` and the moments
        are the same tensors, updated in place."""
        step = state["step"] + 1
        gn = torch.zeros((), dtype=torch.float32, device=step.device)
        scale = None
        if self.max_grad_norm:
            gn = global_norm(grads)
            scale = clip_scale(gn, self.max_grad_norm)
        lr = self._lr(step)
        s = step.float()
        c1 = 1.0 - _f32(self.b1, s) ** s
        c2 = 1.0 - _f32(self.b2, s) ** s
        m_all, v_all = state["m"], state["v"]
        for k, p in params.items():
            g32 = _scaled(grads[k], scale)
            m, v = m_all[k], v_all[k]
            m.mul_(self.b1).add_(g32 * (1 - self.b1))
            v.mul_(self.b2).add_(torch.square(g32) * (1 - self.b2))
            del g32
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            if p.dtype == torch.float32:
                p.sub_(lr * delta)
            else:
                p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, {"m": m_all, "v": v_all, "step": step}, gn
