"""Yi-6B: llama-arch dense with aggressive GQA (kv=4) [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000,
    layer_pattern=dense_pattern(32),
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    source="reduced yi family",
)
