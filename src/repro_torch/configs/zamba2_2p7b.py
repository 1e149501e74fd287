"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks. [arXiv:2411.15242]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,  # shared attention block heads (MHA: kv = 32)
    n_kv_heads=32,
    d_ff=10240,  # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=64,
    attn_every=9,  # shared block invoked every 9 mamba layers (6x)
)
