"""Lexicographic probe of a sorted store on Hopper (port of ``merge_join.py``).

Replaces ``repro/kernels/merge_join.py::merge_probe_pallas`` (K2) and
``::merge_probe_windowed`` (K3): for each query row, its searchsorted
position in a lex-sorted ``int32[S, 3]`` store, left or right, and for the
left side whether the row there equals the query; and, in range mode, the
left position of one query sequence with the right position of another in
one launch (``triples.prefix_range``). On the TPU the wrapper sorted the
queries into 1024-row blocks, each searched inside a 2048-row store window,
with a host-side check that fell back to XLA when a window did not fit. The
CUDA source ``csrc/merge_probe.cu`` keeps the queries' order and sorts
nothing: persistent blocks take tiles of 1024 queries by double-buffered
TMA copies, test each tile for sortedness, and search a sorted tile inside
its store window (in shared memory when it fits, through staged splitters
when it does not) and an unsorted tile through splitters of the whole
store (or a global search when a block takes a single tile). Every tile
takes one of the kernel's three paths; none falls back.
The plain versions are :func:`repro_torch.kernels.ref.merge_probe_ref`
(left), :func:`~repro_torch.kernels.ref.merge_probe_right_ref` and
:func:`~repro_torch.kernels.ref.merge_probe_range_ref`.

``launches`` counts the kernel launches of this process. ``TILE_PATHS``
names the entries of the optional ``tile_counts`` tensor, which a launch
increments by its tiles on each path.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

launches = 0
TILE = 1024  # queries a tile (kTile in the source)
WINDOW_ROWS = 1024  # store rows of the shared-memory window path (kWindowRows)
TILE_PATHS = ("window", "oversized", "unsorted")
_MODES = {"left": 0, "right": 1, "range": 2}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("merge_probe").merge_probe_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError("merge_probe_cuda takes CUDA tensors")
    if t.dtype != torch.int32 or t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"{name} must be int32[N, 3], got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (the kernel copies its rows as bytes)")


def _launch(store, q0, q1, mode: str, tile_counts: Optional[torch.Tensor]):
    """Check the inputs and launch one mode; returns (out0, out1)."""
    global launches
    _rows("store", store)
    _rows("queries", q0)
    tensors = [store, q0]
    if q1 is not None:
        _rows("hi_queries", q1)
        if q1.shape[0] != q0.shape[0]:
            raise ValueError(f"lo and hi queries differ in rows: {q0.shape[0]} and {q1.shape[0]}")
        tensors.append(q1)
    if tile_counts is not None:
        if not tile_counts.is_cuda or tile_counts.dtype != torch.int32 or tuple(tile_counts.shape) != (3,):
            raise ValueError("tile_counts must be a CUDA int32[3] tensor")
        if not tile_counts.is_contiguous():
            raise ValueError("tile_counts must be contiguous")
        tensors.append(tile_counts)
    if any(t.device != store.device for t in tensors):
        raise ValueError("all tensors must lie on the same device")
    if store.shape[0] >= 2 ** 31:
        raise ValueError(f"the store has {store.shape[0]} rows; int32 positions hold fewer than 2^31")
    q = q0.shape[0]
    dev = q0.device
    out0 = torch.empty(q, dtype=torch.int32, device=dev)
    out1 = (
        torch.empty(q, dtype=torch.bool, device=dev) if mode == "left"
        else torch.empty(q, dtype=torch.int32, device=dev) if mode == "range" else None
    )
    if q == 0:
        return out0, out1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(
            store.data_ptr(), store.shape[0], q0.data_ptr(), q1.data_ptr() if q1 is not None else None, q,
            _MODES[mode], out0.data_ptr(), out1.data_ptr() if out1 is not None else None,
            tile_counts.data_ptr() if tile_counts is not None else None, stream,
        )
    build.check(status, "merge_probe launch")
    with build.count_lock:
        launches += 1
    return out0, out1


def merge_probe_cuda(
    store: torch.Tensor, queries: torch.Tensor, side: str = "left", *,
    tile_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel: (idx int32[Q], found bool[Q] or None for ``side="right"``)."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return _launch(store, queries, None, side, tile_counts)


def merge_probe_range_cuda(
    store: torch.Tensor, lo_queries: torch.Tensor, hi_queries: torch.Tensor, *,
    tile_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range mode in one launch: (start, end), int32[Q] each, the left
    position of each ``lo_queries`` row and the right position of the
    ``hi_queries`` row beside it."""
    return _launch(store, lo_queries, hi_queries, "range", tile_counts)
