"""DeepSeek-Coder-33B: llama-arch dense GQA [arXiv:2401.14196]."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab_size=32256,
    layer_pattern=dense_pattern(62),
    rope_theta=100_000.0,
    source="arXiv:2401.14196",
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    source="reduced deepseek family",
)
