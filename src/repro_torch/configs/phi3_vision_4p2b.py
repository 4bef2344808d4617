"""Phi-3-vision-128k-instruct: phi3-mini decoder + CLIP ViT-L/14-336
vision tower (stubbed: 576 patch embeddings of dim 1024)
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064,
    layer_pattern=dense_pattern(32),
    frontend="vision_stub", frontend_tokens=576, frontend_dim=1024,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ModelConfig(
    name="phi3-vision-smoke", family="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    frontend="vision_stub", frontend_tokens=16, frontend_dim=64,
    source="reduced phi3-vision family",
)
