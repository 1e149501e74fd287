"""deepseek-v3 [moe] -- multi-head latent attention and group-limited experts.
[hf:deepseek-ai/DeepSeek-V3]

Every layer attends through MLA: q through a rank-1536 bottleneck, k and v
from a 512-value latent and one 64-dim rotary key shared by the 128 heads
(q/k heads of 128 + 64, v heads of 128), YaRN RoPE (factor 40 over 4096
original positions, beta 32 / 1, mscale 1 / 1, theta 1e4); 3 dense layers
of 18432, then 256 experts of 2048 (top-8 of sigmoid scores plus a
selection-only bias, from the best 4 of 8 groups, weights normalised and
scaled by 2.5) plus one shared expert.  Cut to the first pipeline stage of
DeepSeek-V3's 32-card prefill unit: layers 0-30 of 61; this card holds the
8 experts of rank 0 of each expert layer (EP32).  The multi-token-
prediction layer is left out.
"""

from repro_torch.models.config import ModelConfig, RopeScaling

CONFIG = ModelConfig(
    name="deepseek-v3",
    family="moe",
    n_layers=31,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,
    d_ff=18432,
    vocab_size=129280,
    rope_theta=1e4,
    rms_norm_eps=1e-6,
    n_experts=256,
    top_k=8,
    expert_d_ff=2048,
    first_dense_layers=3,
    routed_scale=2.5,
    n_shared_experts=1,
    experts_held=8,
    n_group=8,
    topk_group=4,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling=RopeScaling(factor=40.0, original_max_position_embeddings=4096, beta_fast=32.0,
                             beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
)
