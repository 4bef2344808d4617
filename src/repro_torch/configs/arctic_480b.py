"""Snowflake Arctic (480B): dense-MoE hybrid - 128 experts top-2 routed in
parallel with a dense residual MLP [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000,
    layer_pattern="e" * 35,
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual_d_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512,
    layer_pattern="ee",
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128,
                  dense_residual_d_ff=128),
    source="reduced arctic family",
)
