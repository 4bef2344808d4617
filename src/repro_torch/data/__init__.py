from repro_torch.data.pipeline import (MemmapCorpus, SyntheticTokens,
                                       batch_for, local_batch, write_corpus)

__all__ = ["SyntheticTokens", "MemmapCorpus", "batch_for", "local_batch",
           "write_corpus"]
