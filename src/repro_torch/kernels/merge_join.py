"""Lexicographic probe of a sorted store on Hopper (port of ``merge_join.py``).

Replaces ``repro/kernels/merge_join.py::merge_probe_pallas`` (K2) and
``::merge_probe_windowed`` (K3): for each query row, its searchsorted
position in a lex-sorted ``int32[S, 3]`` store, left or right, and for the
left side whether the row there equals the query. On the TPU the queries
were sorted into 1024-row blocks, each searched inside a 2048-row store
window, with a host-side check that fell back when a block's window did not
fit. The CUDA source ``csrc/merge_probe.cu`` runs one global binary search
per query instead, in the queries' own order, so no case needs a fallback.
Its bound on an H100 is the chain of dependent loads, ``ceil(log2(S + 1))``
per query, the upper levels served from L2. The plain versions are
:func:`repro_torch.kernels.ref.merge_probe_ref` (left) and
:func:`~repro_torch.kernels.ref.merge_probe_right_ref`.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

launches = 0
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("merge_probe").merge_probe_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def merge_probe_cuda(
    store: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel: (idx int32[Q], found bool[Q] or None for ``side="right"``)."""
    global launches
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    for name, t in (("store", store), ("queries", queries)):
        if not t.is_cuda:
            raise ValueError("merge_probe_cuda takes CUDA tensors")
        if t.dtype != torch.int32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be int32[N, 3], got {t.dtype} {tuple(t.shape)}")
    if store.device != queries.device:
        raise ValueError("store and queries must lie on the same device")
    store = store.contiguous()
    queries = queries.contiguous()
    q = queries.shape[0]
    idx = torch.empty(q, dtype=torch.int32, device=queries.device)
    found = (
        torch.empty(q, dtype=torch.bool, device=queries.device) if side == "left" else None
    )
    if q == 0:
        return idx, found
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(
            store.data_ptr(), store.shape[0], queries.data_ptr(), q,
            0 if side == "left" else 1, idx.data_ptr(),
            found.data_ptr() if found is not None else None, stream,
        )
    build.check(status, "merge_probe launch")
    launches += 1
    return idx, found
