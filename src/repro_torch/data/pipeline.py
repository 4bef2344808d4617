"""Token data pipeline.

Copy of the numpy part of ``repro.data.pipeline``, which gives the
reference's batches for the same seed and file:

* ``SyntheticTokens`` - deterministic zipf-ish LM batches from a seed;
* ``MemmapCorpus`` - a flat binary token file sampled in windows (the
  "one big .bin" pretraining layout), written by ``write_corpus``;
* ``batch_for`` - tokens (B, L+1) -> a training batch.

``local_batch`` is this rank's slice of a global batch (the reference
shards it over the dp axis with a ``NamedSharding``), extras included.
The reference's ``make_batch_specs`` makes JAX ``PartitionSpec``s and has
no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_for(cfg: ModelConfig, tokens: np.ndarray,
              rng: Optional[np.random.Generator] = None) -> dict:
    """tokens (B, L+1) -> training batch with next-token labels and the
    frontend extras (random stub embeddings, f32, drawn from ``rng``
    after the tokens): ``frontend`` (B, frontend_tokens, frontend_dim)
    for a vision prefix, ``source`` (B, source_len, frontend_dim) for an
    encoder."""
    rng = rng or np.random.default_rng(0)
    b = {"tokens": tokens[:, :-1].astype(np.int32),
         "labels": tokens[:, 1:].astype(np.int32)}
    n = tokens.shape[0]
    if cfg.frontend == "vision_stub" and cfg.encoder is None:
        b["frontend"] = rng.standard_normal(
            (n, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder is not None:
        b["source"] = rng.standard_normal(
            (n, cfg.encoder.source_len,
             cfg.frontend_dim or cfg.d_model)).astype(np.float32)
    return b


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


@dataclasses.dataclass
class MemmapCorpus:
    cfg: ModelConfig
    path: str
    batch: int
    seq: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self.tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
        if len(self.tokens) < self.seq + 1:
            raise ValueError("corpus shorter than one sample window")

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        n = len(self.tokens) - self.seq - 1
        while True:
            starts = rng.integers(0, n, size=self.batch)
            toks = np.stack([np.asarray(
                self.tokens[s:s + self.seq + 1]) for s in starts])
            toks = np.minimum(toks.astype(np.int64),
                              self.cfg.vocab_size - 1)
            yield batch_for(self.cfg, toks, rng)


def write_corpus(path: str, tokens: np.ndarray,
                 dtype: str = "uint16") -> None:
    np.asarray(tokens, dtype=dtype).tofile(path)


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
