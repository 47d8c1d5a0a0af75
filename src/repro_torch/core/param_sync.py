"""Interest-based parameter-update propagation for the model plane, on torch
tensors (the counterpart of ``repro.core.param_sync``).

A trainer publishes per-step *parameter changesets* (row indices + new
values for rows whose update exceeded a threshold); each serving replica
registers a row-set interest (the experts it hosts, its hot vocab rows) and
applies only the interesting slice — the iRap split of interesting /
uninteresting applied to weights. ``interest=None`` mirrors a bank whole.
The wire format mirrors the RDF changeset: ⟨removed, added⟩ becomes ⟨rows,
values⟩ (updates are total per row, so no remove side is needed).

Everything runs on the device of the tensors given.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamChangeset:
    """Row-sparse update to one parameter bank (rows indexed on axis 0)."""

    bank: str
    rows: torch.Tensor  # int32[K] row indices, ascending (PAD-free)
    values: torch.Tensor  # [K, ...] new row contents

    @property
    def nbytes(self) -> int:
        return int(self.values.numel() * self.values.element_size() + self.rows.numel() * 4)


def diff_bank(bank: str, old: torch.Tensor, new: torch.Tensor, *, atol: float = 0.0) -> ParamChangeset:
    """Publish the rows of ``new`` that changed (per-row max-abs > atol)."""
    flat_old = old.reshape(old.shape[0], -1)
    flat_new = new.reshape(new.shape[0], -1)
    changed = torch.amax(torch.abs(flat_new - flat_old), dim=1) > atol
    idx = torch.nonzero(changed)[:, 0].to(torch.int32)  # host-side sync point
    return ParamChangeset(bank=bank, rows=idx, values=new[idx])


def filter_changeset(cs: ParamChangeset, interest_rows: Optional[torch.Tensor]) -> ParamChangeset:
    """Keep only rows the replica subscribed to (None = mirror everything)."""
    if interest_rows is None:
        return cs
    wanted = torch.as_tensor(interest_rows, device=cs.rows.device).to(cs.rows.dtype)
    keep = torch.nonzero(torch.isin(cs.rows, wanted))[:, 0]
    return ParamChangeset(bank=cs.bank, rows=cs.rows[keep], values=cs.values[keep])


def apply_changeset(bank_value: torch.Tensor, cs: ParamChangeset) -> torch.Tensor:
    """A new bank with the changeset's rows set (the bank given is unchanged)."""
    return bank_value.index_put((cs.rows.long(),), cs.values.to(bank_value.dtype))


class ParamReplica:
    """A serving replica holding interest-filtered parameter banks."""

    def __init__(self, banks: Dict[str, torch.Tensor], interests: Dict[str, Optional[torch.Tensor]]):
        self.banks = dict(banks)
        self.interests = interests
        self.bytes_received = 0
        self.bytes_offered = 0

    def receive(self, cs: ParamChangeset) -> None:
        self.bytes_offered += cs.nbytes
        mine = filter_changeset(cs, self.interests.get(cs.bank))
        self.bytes_received += mine.nbytes
        self.banks[cs.bank] = apply_changeset(self.banks[cs.bank], mine)

    @property
    def savings(self) -> float:
        return 1.0 - self.bytes_received / max(self.bytes_offered, 1)
