"""Model zoo of the port: the dense transformer family so far."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.api import Model, build_model, exact_n_params
