"""Model zoo of the port: the dense and VLM transformer family and whisper."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.api import Model, build_model, exact_n_params, init_cache
