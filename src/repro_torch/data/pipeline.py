"""Synthetic-but-structured data pipeline (no external datasets): the JAX
package's own source, copied so that the port imports nothing of it.
It produces deterministic numpy batches for LM training and the EE
calibration traces T-Tamer fits on; callers make tensors of them.

The token stream is a Zipf-distributed Markov source with embedded
"pattern" n-grams of varying difficulty — easy spans are highly
predictable (small models / early ramps nail them), hard spans are
near-uniform.  This gives early-exit workloads a real difficulty spread,
the property the paper's trade-off lives on.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    easy_frac: float = 0.6       # fraction of easy (predictable) spans
    span: int = 64               # pattern span length


class SyntheticLM:
    """Deterministic synthetic LM corpus."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # Zipf unigram over vocab + a bank of deterministic patterns.
        ranks = np.arange(1, v + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        n_pat = max(8, min(256, v // 8))
        self.patterns = rng.integers(0, v, size=(n_pat, cfg.span))

    def sample_batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(b, s), p=self.unigram)
        # overwrite easy spans with repeated patterns
        n_spans = s // cfg.span
        for r in range(b):
            for sp in range(n_spans):
                if rng.uniform() < cfg.easy_frac:
                    pat = self.patterns[rng.integers(len(self.patterns))]
                    toks[r, sp * cfg.span:(sp + 1) * cfg.span] = pat
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield ds.sample_batch(step)
        step += 1
