"""Virtual-lane refinement on Hopper (port of ``lane_refine_pallas``).

Replaces ``repro/kernels/triple_match.py::lane_refine_pallas`` (the TPU
kernel K7): the words of the subsumption lattice's virtual lanes. Virtual
slot ``v``'s bit is its parent real lane's bit, read out of the real-bank
words, AND the residual compare of the slot's three terms; a parent of -1 (or
one outside the words) is a dead slot. The CUDA source is
``csrc/lane_refine.cu``. It loops over no slots: each block builds, in shared
memory, per-position slot masks (the wildcard slots, and a hash table of the
residual constants with each one's slots) and each parent lane's child mask,
so a row costs three table lookups and, per plane, an OR of the child masks
of its set parent bits, ANDed with the three position masks. The grid is
persistent, so a block builds its tables once for many rows; rows shared by
every plane are read once, and every frontier plane of a fire takes one
launch (the TPU kernel refined one plane a call, under a vmap). Its bound on
an H100 is bytes: ``12 + 4 W + 4 Wv`` a row and plane (the rows once when
shared) at 3.35 TB/s; its operations, three lookups a row and ``Wv`` ORs a
set parent bit and ``Wv`` ANDs a plane, are far below the int32 rate. The
plain version is :func:`repro_torch.kernels.ref.lane_refine_ref`.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_fn = None
MAX_PLANES = 65535  # the grid's second dimension


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("lane_refine").lane_refine_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lane_refine_cuda(
    spo: torch.Tensor, words: torch.Tensor, parents: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel: int32[..., N, Wv] virtual words, ``Wv = max(1,
    ceil(Vp / 32))``, from ``words`` (int32[N, W] or int32[F, N, W], CUDA),
    the rows ``spo`` (int32[N, 3], shared by every plane, or int32[F, N, 3]),
    ``parents`` (int32[Vp]) and ``residual`` (int32[Vp, 3]), all on one card."""
    global launches
    if not words.is_cuda:
        raise ValueError("lane_refine_cuda takes CUDA tensors")
    if words.dtype != torch.int32 or words.ndim not in (2, 3):
        raise ValueError(f"words must be int32[N, W] or int32[F, N, W], got {words.dtype} {tuple(words.shape)}")
    planes = words if words.ndim == 3 else words[None]
    f, n, n_words = planes.shape
    if spo.dtype != torch.int32 or spo.shape[-2:] != (n, 3) or spo.ndim not in (2, words.ndim):
        raise ValueError(f"spo must be int32[N, 3] or int32[F, N, 3] for words {tuple(words.shape)}, "
                         f"got {spo.dtype} {tuple(spo.shape)}")
    if spo.ndim == 3 and spo.shape[0] != f:
        raise ValueError(f"spo has {spo.shape[0]} planes, words {f}")
    vp = parents.shape[0]
    if parents.dtype != torch.int32 or parents.ndim != 1:
        raise ValueError(f"parents must be int32[Vp], got {parents.dtype} {tuple(parents.shape)}")
    if residual.dtype != torch.int32 or tuple(residual.shape) != (vp, 3):
        raise ValueError(f"residual must be int32[{vp}, 3], got {residual.dtype} {tuple(residual.shape)}")
    if n_words < 1 or f > MAX_PLANES:
        raise ValueError(f"words need W >= 1 and at most {MAX_PLANES} planes")
    for t in (spo, parents, residual):
        if t.device != words.device:
            raise ValueError("all operands must lie on the same device")
    spo, planes = spo.contiguous(), planes.contiguous()
    parents, residual = parents.contiguous(), residual.contiguous()
    n_out = max(1, -(-vp // 32))
    out = torch.empty((f, n, n_out), dtype=torch.int32, device=words.device)
    if n > 0 and f > 0:
        stride = n if spo.ndim == 3 else 0
        with torch.cuda.device(words.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _entry()(spo.data_ptr(), stride, planes.data_ptr(), f, n, n_words, parents.data_ptr(),
                              residual.data_ptr(), vp, n_out, out.data_ptr(), stream)
        build.check(status, "lane_refine launch")
        with build.count_lock:
            launches += 1
    return out if words.ndim == 3 else out[0]
