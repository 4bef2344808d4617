"""Llama-3-8B: the paper's FSDP training case-study model (Sec. 5.5)."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256,
    layer_pattern=dense_pattern(32),
    rope_theta=500_000.0,
    source="paper Sec. 5.5 / hf:meta-llama/Meta-Llama-3-8B",
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    source="reduced llama3 family",
)
