"""Append-only write-ahead changeset journal: CRC-framed segment files.

A copy of ``repro.core.journal`` (numpy and the standard library only):
the framing, header, CRC, segment names and rotation are the same, so
either package reads the other's journal.

The broker's durability substrate (module docstring of
:mod:`repro_torch.core.broker`, durability layer): every state-changing broker
event — ingested changeset, subscribe/unsubscribe, committed fire — is one
sequence-numbered record appended *before* (ingest/subscribe) or *at the
commit point of* (fire) the in-memory effect, so
:meth:`repro_torch.core.broker.Broker.recover` can rebuild the exact broker
state by snapshot-plus-tail-replay.

**Record framing.** A journal is a directory of segment files named
``wal_<first-seq>.seg``. Each segment starts with an 8-byte header
(``RJNL`` magic + little-endian u32 format version) followed by frames::

    [u32 payload_len][u32 crc32(payload)][payload]

    payload = [u32 header_len][header JSON][array blobs...]

The header JSON carries ``seq`` (monotonically increasing, globally unique
across segments), ``kind`` (``subscribe`` / ``unsubscribe`` / ``ingest`` /
``fire``), any record metadata, and an ``arrays`` manifest of
``[name, dtype, shape]`` entries; the blobs are the named arrays'
C-contiguous bytes concatenated in manifest order. Everything needed to
decode a record is inside its own frame — a reader never needs a side
index.

**Truncation rules (torn-tail recovery).** A crash can leave at most a
*suffix* of the byte stream unwritten or garbled, so on open the journal
scans segments in sequence order and stops at the first bad frame: a
partial length/CRC prefix, a frame extending past end-of-file, a CRC
mismatch, or an undecodable payload. The bad frame and everything after it
— including all later segments — are *physically discarded* (the torn
segment is truncated at the last good frame; later segments are unlinked),
never reinterpreted: a record is durable if and only if its complete frame
checksums, and ``last_seq`` reflects exactly the durable prefix.
``dropped_bytes`` reports how much tail was discarded, so recovery can
surface torn writes without failing.

**fsync-on-commit.** With ``fsync=True`` (the default) every
:meth:`append` flushes and fsyncs before returning — an acknowledged
append survives process death. ``fsync=False`` trades that for ingest
throughput (the OS page cache decides); the broker's recovery discipline
is unchanged either way, only the durable prefix may be shorter.

**Rotation + compaction.** A segment that has grown past
``segment_bytes`` is closed and a new one named by the next record's seq
is started, so old records age out in whole-file units:
:meth:`compact` unlinks every segment whose records all precede
``keep_from_seq`` (the broker passes ``min(min live subscriber frontier,
last snapshot seq + 1)`` — see
:meth:`repro_torch.core.broker.Broker.compact_journal`), which is safe because
replay needs only (a) records after the last snapshot and (b) ingest
records at or after the oldest live consumption frontier.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = b"RJNL"
_VERSION = 1
_HEADER = _MAGIC + struct.pack("<I", _VERSION)
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)


def _segment_name(first_seq: int) -> str:
    return f"wal_{first_seq:012d}.seg"


def _segment_first_seq(path: Path) -> int:
    return int(path.name.split("_")[1].split(".")[0])


@dataclass
class JournalRecord:
    """One decoded journal record."""

    seq: int
    kind: str
    meta: Dict
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)


def encode_record(
    seq: int,
    kind: str,
    meta: Optional[Dict] = None,
    arrays: Optional[Dict[str, np.ndarray]] = None,
) -> bytes:
    """One record as a complete frame (length + CRC + payload)."""
    manifest = []
    blobs = []
    for name in sorted(arrays or {}):
        a = np.ascontiguousarray(arrays[name])
        manifest.append([name, a.dtype.str, list(a.shape)])
        blobs.append(a.tobytes())
    head = dict(meta or {})
    head["seq"] = int(seq)
    head["kind"] = str(kind)
    head["arrays"] = manifest
    hb = json.dumps(head, separators=(",", ":")).encode()
    payload = struct.pack("<I", len(hb)) + hb + b"".join(blobs)
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> JournalRecord:
    (hlen,) = struct.unpack_from("<I", payload, 0)
    head = json.loads(payload[4 : 4 + hlen].decode())
    off = 4 + hlen
    arrays: Dict[str, np.ndarray] = {}
    for name, dt, shape in head.pop("arrays", []):
        dtype = np.dtype(dt)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        arr = np.frombuffer(payload, dtype=dtype, count=count, offset=off)
        arrays[name] = arr.reshape(shape).copy()
        off += count * dtype.itemsize
    if off != len(payload):
        raise ValueError("payload length does not match array manifest")
    return JournalRecord(
        seq=int(head.pop("seq")), kind=head.pop("kind"), meta=head,
        arrays=arrays,
    )


def scan_segment(path: Path) -> Tuple[List[Tuple[int, int, int, str]], int, int]:
    """Validate one segment: ``(entries, good_end, total_bytes)``.

    ``entries`` is ``[(offset, end_offset, seq, kind)]`` for every intact
    frame in order; ``good_end`` is the byte offset of the first bad frame
    (== ``total_bytes`` when the segment is clean). A bad header yields
    ``good_end == 0``: the whole segment is unusable.
    """
    data = Path(path).read_bytes()
    total = len(data)
    if total < len(_HEADER) or data[: len(_HEADER)] != _HEADER:
        return [], 0, total
    entries: List[Tuple[int, int, int, str]] = []
    off = len(_HEADER)
    while off + _FRAME.size <= total:
        length, crc = _FRAME.unpack_from(data, off)
        end = off + _FRAME.size + length
        if length < 4 or end > total:
            break
        payload = data[off + _FRAME.size : end]
        if zlib.crc32(payload) != crc:
            break
        try:
            rec = decode_payload(payload)
        except Exception:
            break
        entries.append((off, end, rec.seq, rec.kind))
        off = end
    return entries, off, total


class ChangesetJournal:
    """Segmented append-only WAL with torn-tail truncation on open.

    ``last_seq`` is the highest durable sequence number (0 when empty).
    Appends must carry strictly increasing seqs; the broker owns the clock
    and passes its unified sequence explicitly, while standalone use may
    omit ``seq`` to auto-increment.
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        fsync: bool = True,
        segment_bytes: int = 4 << 20,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.segment_bytes = int(segment_bytes)
        self.last_seq = 0
        self.dropped_bytes = 0  # torn/corrupt tail discarded on open
        self.torn = False
        self._fh = None
        self._segments: List[Path] = sorted(
            self.dir.glob("wal_*.seg"), key=_segment_first_seq
        )
        self._open_scan()

    # -- open-time recovery -------------------------------------------------

    def _open_scan(self) -> None:
        kept: List[Path] = []
        truncated = False
        for seg in self._segments:
            if truncated:
                # nothing after a torn point is reachable: the seq chain is
                # broken, so later segments are discarded wholesale
                self.dropped_bytes += seg.stat().st_size
                seg.unlink()
                continue
            entries, good_end, total = scan_segment(seg)
            if good_end == 0:
                # unusable header — treat like a fully torn segment
                truncated = True
                self.torn = True
                self.dropped_bytes += total
                seg.unlink()
                continue
            if good_end < total:
                truncated = True
                self.torn = True
                self.dropped_bytes += total - good_end
                with open(seg, "r+b") as f:
                    f.truncate(good_end)
            if entries:
                self.last_seq = entries[-1][2]
            kept.append(seg)
        self._segments = kept

    # -- append path --------------------------------------------------------

    def _writer(self, seq: int):
        if self._fh is not None and self._fh.tell() >= self.segment_bytes:
            self._fh.close()
            self._fh = None
        if self._fh is None:
            if (
                self._segments
                and self._segments[-1].stat().st_size < self.segment_bytes
            ):
                self._fh = open(self._segments[-1], "ab")
            else:
                path = self.dir / _segment_name(seq)
                self._fh = open(path, "ab")
                if self._fh.tell() == 0:
                    self._fh.write(_HEADER)
                self._segments.append(path)
        return self._fh

    def append(
        self,
        kind: str,
        meta: Optional[Dict] = None,
        arrays: Optional[Dict[str, np.ndarray]] = None,
        seq: Optional[int] = None,
    ) -> int:
        """Append one record durably; returns its seq."""
        if seq is None:
            seq = self.last_seq + 1
        if seq <= self.last_seq:
            raise ValueError(
                f"journal seq must increase: got {seq}, last {self.last_seq}"
            )
        frame = encode_record(seq, kind, meta, arrays)
        fh = self._writer(seq)
        fh.write(frame)
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())
        self.last_seq = seq
        return seq

    def sync(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- read path ----------------------------------------------------------

    @property
    def segments(self) -> List[Path]:
        return list(self._segments)

    def records(self, start_seq: int = 1) -> Iterator[JournalRecord]:
        """Decoded records with ``seq >= start_seq``, in seq order."""
        self.close()  # flush buffered writes before re-reading files
        for seg in list(self._segments):
            data = seg.read_bytes()
            off = len(_HEADER)
            total = len(data)
            while off + _FRAME.size <= total:
                length, _ = _FRAME.unpack_from(data, off)
                end = off + _FRAME.size + length
                rec = decode_payload(data[off + _FRAME.size : end])
                if rec.seq >= start_seq:
                    yield rec
                off = end

    def compact(self, keep_from_seq: int) -> int:
        """Unlink whole segments whose records all precede ``keep_from_seq``.

        A segment is droppable exactly when the *next* segment's first seq
        is <= ``keep_from_seq`` (segments hold contiguous seq ranges named
        by their first record); the newest segment is always kept. Returns
        the number of segments removed.
        """
        removed = 0
        while len(self._segments) >= 2:
            if _segment_first_seq(self._segments[1]) <= keep_from_seq:
                seg = self._segments.pop(0)
                seg.unlink()
                removed += 1
            else:
                break
        return removed
