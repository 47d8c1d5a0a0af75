"""Segment-masked bank bitset on Hopper (port of ``triple_match_words_segmented_pallas``).

Replaces ``repro/kernels/triple_match.py::triple_match_words_segmented_pallas``
(the TPU kernel K6): the deleted-side pass of a flush that fires several
frontiers, under the broker's delta frontier chain. The rows are the
distinct-row union of the frontiers' deleted sides and ``seg`` their
membership bitmap (bit ``f`` set iff the row is in frontier ``f``). Plane
``f`` of the output holds a member row's bank words (word ``w`` carries the
match bits of ``bank[32w : 32w + 32]``) and 0 for any other row; seg bits at
or above ``n_seg`` are ignored. The CUDA source is
``csrc/triple_match_words_segmented.cu``: K4's design
(``csrc/bank_slot_masks.cuh``: per-position slot masks in shared memory,
three lookups a row, 4 rows a thread in a persistent grid), the rows' seg
words read as one 16-byte load, each word matched once and stored to every
plane, as ``int32[n_seg, N, W]`` row-major. Its bound on an H100 is memory,
``16 + 4 n_seg W`` bytes a row at 3.35 TB/s. The plain version is
:func:`repro_torch.kernels.ref.pattern_bitmask_words_segmented_ref`.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_fn = None
MAX_SEGMENTS = 32


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("triple_match_words_segmented").triple_match_words_segmented_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def triple_match_words_segmented_cuda(
    spo: torch.Tensor, bank: torch.Tensor, seg: torch.Tensor, n_seg: int
) -> torch.Tensor:
    """Launch the kernel: int32[n_seg, N, W] planes of ``spo`` (int32[N, 3],
    CUDA) against ``bank`` (int32[P, 3]) masked by ``seg`` (int32[N]), all on
    one card; ``W = max(1, ceil(P / 32))`` and ``1 <= n_seg <= 32``."""
    global launches
    if not spo.is_cuda:
        raise ValueError("triple_match_words_segmented_cuda takes CUDA tensors")
    for name, t in (("spo", spo), ("bank", bank)):
        if t.dtype != torch.int32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be int32[N, 3], got {t.dtype} {tuple(t.shape)}")
    n = spo.shape[0]
    if seg.dtype != torch.int32 or tuple(seg.shape) != (n,):
        raise ValueError(f"seg must be int32[{n}], got {seg.dtype} {tuple(seg.shape)}")
    if not 1 <= n_seg <= MAX_SEGMENTS:
        raise ValueError(f"n_seg must be in [1, {MAX_SEGMENTS}], got {n_seg}")
    if bank.device != spo.device or seg.device != spo.device:
        raise ValueError("spo, bank and seg must lie on the same device")
    spo, bank, seg = spo.contiguous(), bank.contiguous(), seg.contiguous()
    n_pat = bank.shape[0]
    n_words = max(1, -(-n_pat // 32))
    out = torch.empty((n_seg, n, n_words), dtype=torch.int32, device=spo.device)
    if n == 0:
        return out
    with torch.cuda.device(spo.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(spo.data_ptr(), seg.data_ptr(), n, bank.data_ptr(), n_pat, n_words, n_seg,
                          out.data_ptr(), stream)
    build.check(status, "triple_match_words_segmented launch")
    with build.count_lock:
        launches += 1
    return out
