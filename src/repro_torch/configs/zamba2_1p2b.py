"""Zamba2-1.2B: Mamba-2 backbone with shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.models.config import (ModelConfig, SSMConfig, hybrid_pattern)

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000,
    layer_pattern=hybrid_pattern(38, attn_every=6, offset=5),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, version=2),
    shared_attention=True,
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512,
    layer_pattern="22a2",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=64, version=2),
    shared_attention=True,
    source="reduced zamba2 family",
)
