"""Carry weights between the reference's parameter pytree and the port's modules.

The reference (``repro.models.model``) keeps each family's layers stacked on
leading axes (``blocks`` (L, ...); ``local_groups`` (G, per-1, ...),
``global_blocks`` (G, ...) and ``tail`` (T, ...) for local/global;
``enc_blocks``/``dec_blocks``; ``self_groups`` (G, per-1, ...) and
``cross_blocks`` (G, ...) for vlm; ``blocks`` for ssm; ``groups`` (G, per,
...) and ``tail`` (T, ...) for hybrid, whose one ``shared_attn`` block is
unstacked). The port keeps one module per layer in
layer order. A leaf at path ``(stack, *keys)`` and leading index ``idx`` is
the port's parameter ``<prefix of stack and idx>.<keys joined by dots>``;
an unstacked leaf's name is its path joined by dots. The mapping holds for
any tree with one leaf per parameter: the weights, their gradients,
AdamW's moments ``m`` and ``v`` and the error-feedback ``residual``
(``tree_to_jax``, ``params_from_jax``). ``state_to_jax`` and
``state_from_jax`` carry a whole optimizer state: its per-parameter dicts
map so, and its other leaves (``step``) stay arrays. numpy and
torch only.
"""
from __future__ import annotations

from typing import Any, Callable, Collection, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from .config import ModelConfig


def _stacks(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Callable[..., str]]]:
    """The reference's stacked top-level keys: their leading shape, and the
    port's module prefix of each leading index."""
    if cfg.family in ("dense", "moe"):
        if cfg.attn_pattern != "local_global":
            return {"blocks": ((cfg.n_layers,), lambda j: f"layers.{j}")}
        per = cfg.global_every
        ng = cfg.n_layers // per
        nt = cfg.n_layers - ng * per
        out = {
            "local_groups": ((ng, per - 1), lambda g, i: f"layers.{g * per + i}"),
            "global_blocks": ((ng,), lambda g: f"layers.{g * per + per - 1}"),
        }
        if nt:
            out["tail"] = ((nt,), lambda t: f"layers.{ng * per + t}")
        return out
    if cfg.family == "encdec":
        return {"enc_blocks": ((cfg.n_enc_layers,), lambda i: f"enc_blocks.{i}"),
                "dec_blocks": ((cfg.n_layers,), lambda i: f"dec_blocks.{i}")}
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        ng = cfg.n_layers // per
        return {"self_groups": ((ng, per - 1), lambda g, i: f"layers.{g * per + i}"),
                "cross_blocks": ((ng,), lambda g: f"layers.{g * per + per - 1}")}
    if cfg.family == "ssm":
        return {"blocks": ((cfg.n_layers,), lambda j: f"layers.{j}")}
    if cfg.family == "hybrid":
        per = cfg.shared_attn_every
        ng = cfg.n_layers // per
        nt = cfg.n_layers - ng * per
        out = {"groups": ((ng, per), lambda g, i: f"layers.{g * per + i}")}
        if nt:
            out["tail"] = ((nt,), lambda t: f"layers.{ng * per + t}")
        return out
    raise ValueError(f"unknown family {cfg.family}")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def iter_port_leaves(cfg: ModelConfig, tree) -> Iterator[Tuple[str, np.ndarray]]:
    """(port parameter name, the reference leaf's slice for it) for every
    leaf of ``tree``, a nested dict of arrays; the slices are views."""
    stacks = _stacks(cfg)
    for path, arr in _leaves(tree):
        if path[0] not in stacks:
            yield ".".join(path), arr
            continue
        lead, prefix = stacks[path[0]]
        rest = ".".join(path[1:])
        for idx in np.ndindex(*lead):
            yield f"{prefix(*idx)}.{rest}", arr[idx]


def params_from_jax(cfg: ModelConfig, tree) -> Dict[str, torch.Tensor]:
    """A reference per-parameter pytree (``init``'s weights, or their
    gradients, moments or residuals), as numpy arrays, as the port's dict of
    CPU tensors keyed by parameter name (for the weights: a state dict)."""
    return {name: torch.from_numpy(np.array(arr, copy=True))
            for name, arr in iter_port_leaves(cfg, tree)}


def tree_to_jax(cfg: ModelConfig, named: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_jax``: a dict keyed by the port's
    parameter names as the reference's pytree of (stacked) numpy arrays."""
    owner = {}
    for stack, (lead, prefix) in _stacks(cfg).items():
        for idx in np.ndindex(*lead):
            owner[prefix(*idx)] = (stack, lead, idx)
    tree: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        at = owner.get(".".join(parts[:2]))
        if at is None:
            keys, lead, idx = parts, (), ()
        else:
            stack, lead, idx = at
            keys = [stack] + parts[2:]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] not in node:
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            node[keys[-1]] = np.empty(lead + tuple(t.shape), dtype)
        # straight from the tensor's device into the stacked array (a view)
        torch.from_numpy(node[keys[-1]][idx + (...,)]).copy_(t.detach())
    return tree


def params_to_jax(cfg: ModelConfig, model) -> dict:
    """The model's parameters as the reference's pytree of (stacked) numpy arrays."""
    return tree_to_jax(cfg, model.state_dict())


def _per_parameter(node, names: Collection[str]) -> bool:
    return isinstance(node, dict) and bool(node) and node.keys() == set(names)


def state_to_jax(cfg: ModelConfig, state, names: Collection[str]) -> Any:
    """An optimizer state (nested dicts) in the reference's layout: each dict
    keyed by exactly the parameter ``names`` through ``tree_to_jax``, every
    other tensor as a numpy array."""
    if _per_parameter(state, names):
        return tree_to_jax(cfg, state)
    if isinstance(state, dict):
        return {k: state_to_jax(cfg, v, names) for k, v in state.items()}
    return state.detach().cpu().numpy()


def state_from_jax(cfg: ModelConfig, tree, like, names: Collection[str]) -> Any:
    """The inverse of ``state_to_jax``: ``tree`` (the reference's layout,
    numpy leaves) in the structure of the port's state ``like``, each leaf
    a tensor of ``like``'s leaf's dtype on its device."""
    if _per_parameter(like, names):
        flat = params_from_jax(cfg, tree)
        return {k: flat[k].to(t.device, t.dtype) for k, t in like.items()}
    if isinstance(like, dict):
        return {k: state_from_jax(cfg, tree[k], v, names) for k, v in like.items()}
    return torch.as_tensor(np.asarray(tree), dtype=like.dtype, device=like.device)
