"""arctic-480b [moe] — 128 experts top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    expert_d_ff=4864,
    moe_dense_residual=True,
    capacity_factor=1.25,
)
