"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attn-free. [arXiv:2404.05892]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads (head_dim 64)
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ssm_chunk=512,  # §Perf B7: recursive block scores make big chunks HBM-cheap
)
