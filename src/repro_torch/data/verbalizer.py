"""KG-triple verbalizer: interest-filtered replica triples -> token streams
(a copy of ``repro.data.verbalizer`` over the port's ``Dictionary``).

The training examples (examples/train_kg_lm.py) learn language-model
structure over verbalized triples. Terms hash into disjoint vocab bands so
the mapping is deterministic, collision-bounded, and dictionary-free on the
consumer side.
"""
from __future__ import annotations

import numpy as np

from ..core.dictionary import Dictionary

BOS, EOS, SEP = 0, 1, 2
N_SPECIAL = 3


class Verbalizer:
    def __init__(self, vocab: int, dictionary: Dictionary):
        assert vocab > 64
        self.vocab = vocab
        self.dict = dictionary
        self.band = (vocab - N_SPECIAL) // 3

    def term_token(self, term_id: int, slot: int) -> int:
        return N_SPECIAL + slot * self.band + (term_id % self.band)

    def triples_to_tokens(self, spo: np.ndarray) -> np.ndarray:
        """(N, 3) int32 triple ids -> flat token stream [s p o SEP ...]."""
        n = spo.shape[0]
        if n == 0:
            return np.zeros((0,), np.int32)
        out = np.empty((n, 4), np.int32)
        for k in range(3):
            out[:, k] = N_SPECIAL + k * self.band + (spo[:, k] % self.band)
        out[:, 3] = SEP
        return out.reshape(-1)
