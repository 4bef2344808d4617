"""Whisper-tiny: 4-layer encoder-decoder; the mel-spectrogram + conv
frontend is a stub supplying 1500 frame embeddings [arXiv:2212.04356].
RoPE replaces whisper's learned positions (documented adaptation)."""
from repro_torch.models.config import (EncoderConfig, ModelConfig,
                                       dense_pattern)

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865,
    layer_pattern=dense_pattern(4),
    encoder=EncoderConfig(n_layers=4, source_len=1500),
    frontend="audio_stub", frontend_tokens=1500, frontend_dim=384,
    source="arXiv:2212.04356",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512,
    layer_pattern=dense_pattern(2),
    encoder=EncoderConfig(n_layers=2, source_len=64),
    frontend="audio_stub", frontend_tokens=64, frontend_dim=128,
    source="reduced whisper family",
)
