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
each package's ``load_raw`` reads the other's snapshots. Restoring into a
template on a device mesh comes with the port's multi-device layer.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


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
    return {"/".join(path): np.asarray(leaf) for path, leaf in _leaves(tree)}


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

    def load_raw(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """One snapshot's flat arrays and its ``extra`` metadata; the caller
        rebuilds its own structure from them (broker recovery)."""
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "arrays.npz")
        return {k: data[k] for k in data.files}, manifest.get("extra", {})
