"""k-exaone-236b-a23b [moe] -- EXAONE 4.0 layers with DeepSeek-V3 routing.
[hf:LGAI-EXAONE/K-EXAONE-236B-A23B]

48 layers in periods of "LLLG": 36 layers of 128-key sliding-window
attention with RoPE, 12 global layers without positions (NoPE); QK-norm
and post-norms after the attention and the MLP; a dense SwiGLU of 18432 in
layer 0, then 128 experts of 2048 (top-8, sigmoid scores, the chosen
weights normalised and scaled by 2.5) plus one shared expert.  Held here:
the 8 experts of rank 0 of a 16-card expert-parallel pool (EP16); the
multi-token-prediction layer is left out.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="k-exaone-236b-a23b",
    family="moe",
    n_layers=48,
    d_model=6144,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,
    vocab_size=153600,
    qk_norm=True,
    rope_theta=1e6,
    rms_norm_eps=1e-5,
    window=128,
    window_pattern="LLLG",
    post_norm=True,
    n_experts=128,
    top_k=8,
    expert_d_ff=2048,
    first_dense_layers=1,
    routed_scale=2.5,
    n_shared_experts=1,
    experts_held=8,
)
