"""IBM Granite 3.0 MoE 3B (active 800M): 40 experts top-8, small expert
FFNs [hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155,
    layer_pattern="e" * 32,
    moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512,
    layer_pattern="ee",
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128),
    source="reduced granite family",
)
