"""Multi-word bank bitset on Hopper (port of ``triple_match_words_pallas``).

Replaces ``repro/kernels/triple_match.py::triple_match_words_pallas`` (the
TPU kernel K4): the broker's deleted-side pass, every word of an
arbitrary-width pattern bank for every row in one launch. Word ``w`` of row
``i`` carries the match bits of ``bank[32w : 32w + 32]``; PAD rows give 0
and all-PAD bank rows never match. The CUDA source is
``csrc/triple_match_words.cu`` over ``csrc/bank_slot_masks.cuh`` (shared
with K6). It loops over no bank rows: each block builds, in shared memory,
per-position slot masks (the wildcard slots, and a hash table of the bank's
constants with each one's slots), so a row costs three table lookups; a
persistent grid streams 4 rows a thread by 16-byte loads and stores, the
words row-major as ``int32[N, W]`` (the TPU kernel's ``[W, N]`` and the
transpose after it are gone). Its bound on an H100 is memory, ``12 + 4W``
bytes a row at 3.35 TB/s. The plain version is
:func:`repro_torch.kernels.ref.pattern_bitmask_words_ref`.

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
        fn = build.library("triple_match_words").triple_match_words_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def triple_match_words_cuda(spo: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: int32[N, W] bank words of ``spo`` (int32[N, 3], CUDA)
    against ``bank`` (int32[P, 3] on the same card), ``W = max(1, ceil(P / 32))``."""
    global launches
    if not spo.is_cuda:
        raise ValueError("triple_match_words_cuda takes CUDA tensors")
    for name, t in (("spo", spo), ("bank", bank)):
        if t.dtype != torch.int32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be int32[N, 3], got {t.dtype} {tuple(t.shape)}")
    if bank.device != spo.device:
        raise ValueError("bank and spo must lie on the same device")
    spo = spo.contiguous()
    bank = bank.contiguous()
    n, n_pat = spo.shape[0], bank.shape[0]
    n_words = max(1, -(-n_pat // 32))
    out = torch.empty((n, n_words), dtype=torch.int32, device=spo.device)
    if n == 0:
        return out
    with torch.cuda.device(spo.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(spo.data_ptr(), n, bank.data_ptr(), n_pat, n_words, out.data_ptr(), stream)
    build.check(status, "triple_match_words launch")
    with build.count_lock:
        launches += 1
    return out
