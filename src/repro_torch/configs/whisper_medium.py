"""whisper-medium [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

The conv/mel frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (B, T, d_model) in [0,1); the
paper's PrunedQuantFrontend digitises the frame channels (the audio
analogue of the paper's sensor ADCs).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder depth
    encoder_layers=24,    # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    max_target_len=448,
    use_pruned_frontend=True,
)
