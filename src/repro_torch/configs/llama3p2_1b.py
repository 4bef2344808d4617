"""Llama-3.2-1B: small llama3 dense GQA, tied embeddings
[hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=128256,
    layer_pattern=dense_pattern(16),
    rope_theta=500_000.0, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    tie_embeddings=True,
    source="reduced llama3 family",
)
