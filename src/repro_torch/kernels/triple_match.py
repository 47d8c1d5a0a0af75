"""Multi-pattern triple match on Hopper (port of ``triple_match_pallas``).

Replaces ``repro/kernels/triple_match.py::triple_match_pallas`` (the TPU
kernel K1): an int32[N] bitset whose bit j is set iff row i matches
``patterns[j]`` (``-1`` is a wildcard, PAD rows match nothing, at most 32
patterns). The CUDA source is ``csrc/triple_match.cu``, a vectorised row
stream over the row-major ``int32[N, 3]`` store: a thread takes 4 rows as
three 16-byte loads and stores their 4 words as one, with its next 4 rows in
flight, in a persistent grid that stages the patterns in shared memory once
a block (a base off 16-byte alignment or N % 4 != 0 takes a few rows on a
scalar path). Its bound on an H100 is bytes: 16 a row (12 read, 4 written)
at 3.35 TB/s. The plain version is
:func:`repro_torch.kernels.ref.pattern_bitmask_ref`.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("triple_match").triple_match_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def triple_match_cuda(spo: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: int32[N] bitset of ``spo`` (int32[N, 3], CUDA) against
    ``patterns`` (int32[P <= 32, 3], on the same card)."""
    global launches
    if not spo.is_cuda:
        raise ValueError("triple_match_cuda takes CUDA tensors")
    if spo.dtype != torch.int32 or spo.ndim != 2 or spo.shape[1] != 3:
        raise ValueError(f"spo must be int32[N, 3], got {spo.dtype} {tuple(spo.shape)}")
    if patterns.dtype != torch.int32 or patterns.ndim != 2 or patterns.shape[1] != 3:
        raise ValueError(f"patterns must be int32[P, 3], got {patterns.dtype} {tuple(patterns.shape)}")
    if patterns.shape[0] > 32:
        raise ValueError("at most 32 patterns per bitset")
    if patterns.device != spo.device:
        raise ValueError("patterns and spo must lie on the same device")
    spo = spo.contiguous()
    patterns = patterns.contiguous()
    n = spo.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=spo.device)
    if n == 0:
        return out
    with torch.cuda.device(spo.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(
            spo.data_ptr(), n, patterns.data_ptr(), patterns.shape[0], out.data_ptr(), stream
        )
    build.check(status, "triple_match launch")
    with build.count_lock:
        launches += 1
    return out
