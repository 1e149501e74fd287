"""Model zoo of the port: the dense, MoE and VLM transformer family, rwkv6,
zamba2 and whisper."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.api import (
    Model,
    build_model,
    exact_n_active_params,
    exact_n_params,
    init_cache,
)
