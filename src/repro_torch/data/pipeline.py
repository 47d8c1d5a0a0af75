"""Training-data pipeline fed by an interest-filtered replica (the counterpart
of ``repro.data.pipeline``, over the port's ``TripleStore``).

The full loop (DESIGN.md §4): an evolving source publishes changesets; the
iRap subscription keeps the replica (τ) current; this pipeline re-tokenizes
replica content into fixed-shape LM batches. Data-parallel workers each own
a deterministic shard of the token stream (seeded; elastically recomputable
after scale-up/down, which is what makes the pipeline restart-safe).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..core import TripleStore, to_numpy
from .verbalizer import Verbalizer


class ReplicaTokenPipeline:
    def __init__(
        self,
        verbalizer: Verbalizer,
        batch_size: int,
        seq_len: int,
        seed: int = 0,
        worker: int = 0,
        n_workers: int = 1,
    ):
        self.verb = verbalizer
        self.b, self.s = batch_size, seq_len
        self.seed = seed
        self.worker = worker
        self.n_workers = n_workers
        self._tokens = np.zeros((0,), np.int32)
        self._epoch = 0

    def refresh(self, replica: TripleStore) -> None:
        """Re-tokenize after the subscription applied a changeset."""
        spo = to_numpy(replica)
        self._tokens = self.verb.triples_to_tokens(spo)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.b * (self.s + 1)
        toks = self._tokens
        if toks.shape[0] < max(need, 8):
            raise StopIteration("replica too small — refresh() first")
        rng = np.random.default_rng(
            (self.seed, self._epoch, self.worker)
        )
        self._epoch += 1
        starts = rng.integers(0, toks.shape[0] - self.s - 1, size=self.b)
        rows = np.stack([toks[st : st + self.s + 1] for st in starts])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }
