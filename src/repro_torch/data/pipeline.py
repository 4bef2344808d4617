"""Token data pipeline: the synthetic stream.

Copy of the numpy part of ``repro.data.pipeline``: ``SyntheticTokens``
(deterministic zipf-ish LM batches from a seed) and ``batch_for``, which
give the reference's batches for the same seed.  ``local_batch`` is this
rank's slice of a global batch (the reference shards it over the dp
axis with a ``NamedSharding``).  Frontend extras and ``MemmapCorpus``
come with the rest of the zoo.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_for(cfg: ModelConfig, tokens: np.ndarray,
              rng: Optional[np.random.Generator] = None) -> dict:
    """tokens (B, L+1) -> training batch with next-token labels."""
    if cfg.frontend != "text" or cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: frontend batches are not "
                                  f"ported yet (ROADMAP queue 1, item 8)")
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        zipf_p = 1.0 / np.arange(1, self.cfg.vocab_size + 1) ** 1.1
        zipf_p /= zipf_p.sum()
        while True:
            toks = rng.choice(self.cfg.vocab_size,
                              size=(self.batch, self.seq + 1), p=zipf_p)
            yield batch_for(self.cfg, toks, rng)


def local_batch(batch: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s rows of a global batch split over ``n`` ranks."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"over {n} ranks")
        rows = v.shape[0] // n
        out[k] = v[rank * rows:(rank + 1) * rows]
    return out
