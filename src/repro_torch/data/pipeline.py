"""Deterministic synthetic language-model data, numpy only.

Every (step, sample) is a pure function of the dataset seed, so resuming
after a failure is exact (skipping to a step costs nothing and there is
no iterator state to checkpoint beyond the step counter).  Tokens follow
a fixed random bigram (Markov) table, so cross-entropy has structure to
learn and training loss falls below the uniform level.  The stream is
the reference's, number for number.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 8  # candidate successors per token (entropy knob)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v, k = self.vocab_size, self.branching
        self._succ = rng.integers(0, v, size=(v, k), dtype=np.int64)

    def _sample_rows(self, step: int, row0: int, rows: int) -> np.ndarray:
        """Rows [row0, row0+rows) of the global batch at ``step``."""
        out = np.empty((rows, self.seq_len + 1), dtype=np.int32)
        for i in range(rows):
            r = np.random.default_rng(
                (self.seed, step, row0 + i))  # counter-based: O(1) skip
            tok = r.integers(0, self.vocab_size)
            choices = r.integers(0, self.branching, size=self.seq_len + 1)
            for t in range(self.seq_len + 1):
                out[i, t] = tok
                tok = self._succ[tok, choices[t]]
        return out

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The full batch at ``step`` on the host: int32 ``tokens`` and
        ``labels`` (the tokens shifted by one), each (batch, seq)."""
        toks = self._sample_rows(step, 0, self.global_batch)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def unigram_floor_nats(self) -> float:
        """Entropy of the stationary next-token distribution ~ log(branching)."""
        return float(np.log(self.branching))
