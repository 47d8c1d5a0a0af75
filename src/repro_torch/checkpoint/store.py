"""Checkpoint store: atomic step snapshots of nested dicts of arrays.

Layout (per step), the reference's (``repro.checkpoint.store``)::

    <dir>/step_000000123/
        manifest.json      # step, flat key list, shapes/dtypes, extra
        arrays.npz         # one entry per leaf

Writes are atomic (tmp dir + rename), so a crash mid-save never corrupts
the latest complete snapshot. A state is a dict of trees; a tree is a
nested dict (or list / tuple) whose leaves are arrays. Leaf keys are the
``/``-joined path from the state's name down, with dict keys in sorted
order (``"10"`` before ``"2"``) and sequence positions as indices: the
order and strings that ``jax.tree_util.tree_flatten_with_path`` gives, so
each package's ``load_raw`` reads the other's snapshots. :meth:`restore`
reads a snapshot into a template's structure and, given ``shardings``,
places each leaf on a device (of a :class:`~repro_torch.core.distributed.DeviceMesh`,
say), whatever devices wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for idx, item in enumerate(tree):
            yield from _leaves(item, path + (str(idx),))
    else:
        yield path, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _host(leaf) for path, leaf in _leaves(tree)}


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _rebuild(tree, path: Tuple[str, ...], leaf_of):
    """``tree``'s structure with each leaf replaced by ``leaf_of(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], path + (str(key),), leaf_of) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, path + (str(idx),), leaf_of) for idx, item in enumerate(tree))
    return leaf_of(path, tree)


def _placement(shardings, path: Tuple[str, ...]):
    """The device ``shardings`` names for the leaf at ``path``: one device
    for a whole tree, or a tree of devices (None: stay on the host)."""
    for key in path:
        if shardings is None or isinstance(shardings, (str, torch.device)):
            break
        shardings = shardings[int(key)] if isinstance(shardings, (list, tuple)) else shardings[key]
    return shardings


class CheckpointStore:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, state: Dict[str, Any], extra: Dict | None = None):
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat: Dict[str, np.ndarray] = {}
        for name, tree in state.items():
            for k, v in _flatten(tree).items():
                flat[f"{name}/{k}"] = v
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc(keep=3)

    def _gc(self, keep: int):
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[:-keep]:
            shutil.rmtree(old)

    def steps(self) -> list:
        """All complete snapshot steps, ascending."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(
        self,
        template: Dict[str, Any],
        step: int | None = None,
        shardings: Dict[str, Any] | None = None,
    ) -> Tuple[Dict[str, Any], int]:
        """Restore into the template's structure (default: the newest step).

        Each leaf takes the template leaf's dtype. ``shardings`` has the
        template's outer keys; a value is None (the leaves stay numpy
        arrays), one device for the whole tree, or a tree of devices shaped
        like the template's (None leaves stay on the host). A leaf with a
        device becomes a tensor there, whatever devices wrote it.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        data = np.load(self.dir / f"step_{step:09d}" / "arrays.npz")
        out = {}
        for name, tree in template.items():
            where = (shardings or {}).get(name)

            def leaf_of(path, leaf, name=name, where=where):
                arr = data["/".join((name,) + path)]
                if isinstance(leaf, torch.Tensor):
                    arr = arr.astype(_host(leaf.new_empty(0)).dtype)
                elif hasattr(leaf, "dtype"):
                    arr = arr.astype(leaf.dtype)
                device = _placement(where, path)
                return arr if device is None else torch.as_tensor(arr, device=device)

            out[name] = _rebuild(tree, (), leaf_of)
        return out, step

    def load_raw(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """One snapshot's flat arrays and its ``extra`` metadata; the caller
        rebuilds its own structure from them (broker recovery)."""
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "arrays.npz")
        return {k: data[k] for k in data.files}, manifest.get("extra", {})
