"""Host-side RDF term dictionary (IRI/literal string <-> dense int32 id).

A copy of ``repro.core.dictionary``: ids follow insertion order, so a
dictionary rebuilt from the reference's term list (:meth:`Dictionary.from_terms`)
assigns every term the id it had there. Dense ids keep signature tables
dense. The dictionary lives on the host; device code only sees int32 ids.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


class Dictionary:
    """Bidirectional term <-> id map with dense, append-only ids."""

    def __init__(self, capacity_hint: int = 1024):
        self._term_to_id: dict[str, int] = {}
        self._id_to_term: List[str] = []
        self.capacity_hint = capacity_hint

    @classmethod
    def from_terms(cls, terms: Sequence[str]) -> "Dictionary":
        """A dictionary whose id ``i`` is ``terms[i]`` (the reference's order)."""
        d = cls()
        for t in terms:
            d.encode_term(t)
        if len(d) != len(terms):
            raise ValueError("term list holds duplicates")
        return d

    @property
    def terms(self) -> List[str]:
        """Every term in id order (what :meth:`from_terms` takes back)."""
        return list(self._id_to_term)

    def __len__(self) -> int:
        return len(self._id_to_term)

    def encode_term(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._id_to_term)
            self._term_to_id[term] = tid
            self._id_to_term.append(term)
        return tid

    def lookup(self, term: str) -> int | None:
        return self._term_to_id.get(term)

    def decode(self, tid: int) -> str:
        return self._id_to_term[tid]

    def encode_triples(self, triples: Iterable[Tuple[str, str, str]]) -> np.ndarray:
        rows = [
            (self.encode_term(s), self.encode_term(p), self.encode_term(o))
            for s, p, o in triples
        ]
        if not rows:
            return np.zeros((0, 3), dtype=np.int32)
        return np.asarray(rows, dtype=np.int32)

    def decode_triples(self, spo: np.ndarray) -> List[Tuple[str, str, str]]:
        return [
            (self.decode(int(s)), self.decode(int(p)), self.decode(int(o)))
            for s, p, o in np.asarray(spo)
        ]

    @property
    def id_capacity(self) -> int:
        """Smallest power of two >= current size (signature table extent)."""
        n = max(len(self._id_to_term), 2)
        return 1 << (n - 1).bit_length()


def parse_triple_line(line: str) -> Tuple[str, str, str] | None:
    """Parse one simplified N-Triples-ish line: ``subj pred obj .``

    Terms are whitespace-separated; a quoted literal (possibly containing
    spaces) is kept intact as the object. Returns None for blank/comment
    lines.
    """
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if line.endswith("."):
        line = line[:-1].rstrip()
    # split subject and predicate, keep the rest (possibly quoted) as object
    parts = line.split(None, 2)
    if len(parts) != 3:
        raise ValueError(f"cannot parse triple line: {line!r}")
    return parts[0], parts[1], parts[2]


def parse_triples(text: str) -> List[Tuple[str, str, str]]:
    out = []
    for line in text.splitlines():
        t = parse_triple_line(line)
        if t is not None:
            out.append(t)
    return out
