"""Falcon-Mamba-7B: pure Mamba-1, attention-free [arXiv:2410.05355].

The rows follow the JAX package's Mamba-1 block (``models/ssm.py``:
in_x/in_z, depthwise causal conv, x_proj -> dt/B/C, selective scan,
out_proj), not Hugging Face's checkpoint layout: the published
checkpoint adds RMS norms on B, C and dt inside the mixer, which this
block (like the reference's) does not have.  The widths are the
published ones.
"""
from repro_torch.models.config import ModelConfig, SSMConfig, ssm_pattern

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024,
    layer_pattern=ssm_pattern(64, version=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    source="arXiv:2410.05355",
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    n_layers=2, d_model=256, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=512,
    layer_pattern=ssm_pattern(2, version=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    source="reduced falcon-mamba family",
)
