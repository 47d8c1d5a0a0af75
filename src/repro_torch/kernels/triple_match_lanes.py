"""Fused bank match + lane routing + member mask on Hopper (port of
``triple_match_lanes_pallas``).

Replaces ``repro/kernels/triple_match.py::triple_match_lanes_pallas`` (the
TPU kernel K5): the broker's added-side pass over a member-stacked cohort.
Bit ``j`` of ``out[k, i]`` is set iff row ``spo_b[k, i]`` matches bank row
``lanes[k, j]``; inactive members (cohort padding) give 0. The CUDA source
is ``csrc/triple_match_lanes.cu``: a persistent grid whose blocks stage
every member's ``nt <= 32`` routed bank rows in shared memory once, and
whose threads stream (member, 4-row group) items: three 16-byte loads (the
next group's in flight), ``nt`` compares a row instead of the TPU kernel's
``32W`` plus routing, one 16-byte store; inactive members take zero stores
and no loads. Its bound on an H100 is memory: 12 bytes a row of every
active member read, 4 bytes a row of every member written. The plain
version is :func:`repro_torch.kernels.ref.pattern_lane_bits_ref`.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_fn = None
MAX_TARGETS = 32
MAX_MEMBERS = 65535  # members a launch takes


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("triple_match_lanes").triple_match_lanes_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def triple_match_lanes_cuda(
    spo_b: torch.Tensor, bank: torch.Tensor, lanes: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel: int32[R, N] local bitsets of ``spo_b`` (int32[R, N, 3],
    CUDA) for bank ``bank`` (int32[P, 3]), lane maps ``lanes`` (int32[R, nt],
    nt <= 32) and member mask ``active`` (bool or int32[R]), all on one card."""
    global launches
    if not spo_b.is_cuda:
        raise ValueError("triple_match_lanes_cuda takes CUDA tensors")
    if spo_b.dtype != torch.int32 or spo_b.ndim != 3 or spo_b.shape[2] != 3:
        raise ValueError(f"spo_b must be int32[R, N, 3], got {spo_b.dtype} {tuple(spo_b.shape)}")
    if bank.dtype != torch.int32 or bank.ndim != 2 or bank.shape[1] != 3:
        raise ValueError(f"bank must be int32[P, 3], got {bank.dtype} {tuple(bank.shape)}")
    r, n = spo_b.shape[0], spo_b.shape[1]
    if lanes.dtype != torch.int32 or lanes.ndim != 2 or lanes.shape[0] != r:
        raise ValueError(f"lanes must be int32[{r}, nt], got {lanes.dtype} {tuple(lanes.shape)}")
    if lanes.shape[1] > MAX_TARGETS:
        raise ValueError("at most 32 local patterns per member")
    if active.ndim != 1 or active.shape[0] != r:
        raise ValueError(f"active must have shape ({r},), got {tuple(active.shape)}")
    if r > MAX_MEMBERS:
        raise ValueError(f"at most {MAX_MEMBERS} members per launch")
    for t in (bank, lanes, active):
        if t.device != spo_b.device:
            raise ValueError("all operands must lie on the same device")
    spo_b = spo_b.contiguous()
    bank = bank.contiguous()
    lanes = lanes.contiguous()
    active = active.to(torch.int32).contiguous()
    out = torch.empty((r, n), dtype=torch.int32, device=spo_b.device)
    if r == 0 or n == 0:
        return out
    with torch.cuda.device(spo_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(
            spo_b.data_ptr(), r, n, bank.data_ptr(), bank.shape[0], lanes.data_ptr(),
            lanes.shape[1], active.data_ptr(), out.data_ptr(), stream,
        )
    build.check(status, "triple_match_lanes launch")
    with build.count_lock:
        launches += 1
    return out
