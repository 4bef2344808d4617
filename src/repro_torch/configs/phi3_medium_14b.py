"""Phi-3-medium-14B: RoPE SwiGLU GQA dense [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab_size=100352,
    layer_pattern=dense_pattern(40),
    source="arXiv:2404.14219",
)

SMOKE = ModelConfig(
    name="phi3-medium-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    source="reduced phi3 family",
)
